"""Window geometry and sentence encoding (own copy of
``glint_word2vec_tpu/corpus/batching.py``, trimmed to what the
device-resident training path needs: ``context_width`` (:38),
``packed_pair_batch`` (:49), ``window_offsets`` (:79),
``encode_sentences`` (:87) and ``chunk_sentences`` (:137)).

Window semantics are the reference's: for center position ``i`` draw
``b ~ U[0, window)`` and take context positions ``[max(0, i-b),
min(i+b, len))`` without ``i``. The upper bound is half-open, so offsets
span ``[-(W-1), W-2]`` and a position has ``2W - 3`` context lanes.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np

from glint_word2vec_torch.corpus.vocab import Vocabulary


def context_width(window: int) -> int:
    """Context lanes per center position: ``2*window - 3``, at least one
    (``window=1`` trains nothing; its one lane is never valid)."""
    return max(1, 2 * int(window) - 3)


def packed_pair_batch(batch_size: int, window: int, multiple: int = 1) -> int:
    """Dense pair slots covering ~``batch_size`` center positions.

    ``E[pairs per position] = E[max(2b - 1, 0)] = (W-1)^2 / W`` for the
    shrink draw ``b ~ U[0, W)``, so ``batch_size`` times that keeps a
    packed step's synchronous batch at the grid step's position
    coverage. Floored at the lane count (the forward-progress guarantee
    of ``pack_window_pairs``) and rounded up to ``multiple``."""
    W = int(window)
    exp_pairs = max((W - 1) ** 2 / W, 1.0)
    P = max(
        int(np.ceil(batch_size * exp_pairs)),
        context_width(W),
        int(multiple),
    )
    return -(-P // int(multiple)) * int(multiple)


def window_offsets(window: int) -> np.ndarray:
    """The lane -> relative-offset map matching :func:`context_width`."""
    W = int(window)
    if W == 1:
        return np.array([1], dtype=np.int64)  # never valid; see context_width
    return np.concatenate([np.arange(-(W - 1), 0), np.arange(1, W - 1)])


def encode_sentences(
    sentences: Iterable[Sequence[str]], vocab: Vocabulary
) -> List[np.ndarray]:
    """Words -> int32 index arrays, OOV dropped, empty results removed."""
    out = []
    for s in sentences:
        ids = vocab.encode(s)
        if ids.size:
            out.append(ids)
    return out


def chunk_sentences(
    sentences: Iterable[np.ndarray], max_sentence_length: int
) -> List[np.ndarray]:
    """Split long sentences into chunks of at most ``max_sentence_length``."""
    if max_sentence_length <= 0:
        raise ValueError("max_sentence_length must be > 0")
    out = []
    for ids in sentences:
        for start in range(0, len(ids), max_sentence_length):
            out.append(ids[start : start + max_sentence_length])
    return out
