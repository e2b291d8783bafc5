"""Window geometry, sentence encoding and the host batcher (own copy of
``glint_word2vec_tpu/corpus/batching.py``, trimmed): ``context_width``
(:38), ``packed_pair_batch`` (:49), ``window_offsets`` (:79),
``encode_sentences`` (:87), ``chunk_sentences`` (:137), and the host
batcher's ``subsample_sentence`` (:153), ``window_batch`` (:171),
``Batch`` (:202), ``BatchGroup`` (:212), ``group_batches`` (:229) and
``SkipGramBatcher`` (:288) with its numpy epoch pass (:475-507).

Window semantics are the reference's: for center position ``i`` draw
``b ~ U[0, window)`` and take context positions ``[max(0, i-b),
min(i+b, len))`` without ``i``. The upper bound is half-open, so offsets
span ``[-(W-1), W-2]`` and a position has ``2W - 3`` context lanes.

The host batcher's batches equal the JAX package's numpy pass bitwise:
the same ``np.random.default_rng((seed, epoch))`` stream, drawn in the
same order. (The JAX package prefers a native C++ pass when a compiler is
present, which draws another stream; the port has no native pass yet.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

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


def subsample_sentence(
    ids: np.ndarray, keep_prob: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """Frequency subsampling: keep word ``w`` with probability
    ``keep_prob[w]`` (:meth:`Vocabulary.keep_probabilities`), one draw of
    ``rng`` per word."""
    if ids.size == 0:
        return ids
    keep = rng.random(ids.size) <= keep_prob[ids]
    return ids[keep]


#: Rows a windowing block of :meth:`SkipGramBatcher.epoch` gathers before
#: it builds their windows at once (bounds its temporaries to some MB).
_BLOCK_ROWS = 1 << 16


def _window_rows(
    kept: List[np.ndarray], shrink: List[np.ndarray], window: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The (center, padded-context, mask) rows of consecutive sentences at
    once: sentence ``s`` has the ids ``kept[s]`` and one window draw
    ``shrink[s][i] = b`` in ``[0, window)`` per position ``i``, whose
    contexts are the positions ``[max(0, i-b), min(i+b, len))`` minus
    ``i``. Masked lanes hold id 0."""
    C = context_width(window)
    if not kept:
        return (np.zeros(0, np.int32), np.zeros((0, C), np.int32),
                np.zeros((0, C), np.float32))
    ids = np.concatenate(kept).astype(np.int32, copy=False)
    b = np.concatenate(shrink)
    lens = np.fromiter((k.size for k in kept), np.int64, len(kept))
    end = np.repeat(np.cumsum(lens), lens)
    start = end - np.repeat(lens, lens)
    offsets = window_offsets(window)
    pos = np.arange(ids.size)[:, None] + offsets[None, :]
    valid = (
        (offsets[None, :] >= -b[:, None])
        & (offsets[None, :] <= b[:, None] - 1)
        & (pos >= start[:, None])
        & (pos < end[:, None])
    )
    contexts = np.where(valid, ids[np.clip(pos, 0, ids.size - 1)], 0)
    return ids, contexts.astype(np.int32), valid.astype(np.float32)


def window_batch(
    ids: np.ndarray, window: int, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All (center, padded-context, mask) rows of one sentence: one draw
    ``b = rng.integers(0, window)`` per position (none for an empty
    sentence), then :func:`_window_rows`. Returns ``centers (L,)``,
    ``contexts (L, C)`` and ``mask (L, C)`` with ``C =
    context_width(window)``."""
    if ids.size == 0:
        return _window_rows([], [], window)
    return _window_rows([ids], [rng.integers(0, int(window), size=ids.size)],
                        window)


@dataclass
class Batch:
    """One fixed-shape skip-gram minibatch and its progress count."""

    centers: np.ndarray  # (B,) int32
    contexts: np.ndarray  # (B, C) int32, C = context_width(window)
    mask: np.ndarray  # (B, C) float32
    words_done: int  # cumulative pre-subsampling words (drives the LR)


@dataclass
class BatchGroup:
    """``group_size`` minibatches stacked to the engine's ``(K, ...)``
    shape, the tail padded with zero-mask batches."""

    centers: np.ndarray  # (K, B) int32
    contexts: np.ndarray  # (K, B, C) int32
    mask: np.ndarray  # (K, B, C) float32
    words_done: List[int]  # per slot (padding repeats the last)
    n_real: int  # live minibatches; slots [n_real, K) are padding

    def __len__(self) -> int:
        return int(self.centers.shape[0])


def group_batches(
    batches: Iterator[Batch], group_size: int
) -> Iterator[BatchGroup]:
    """Collect ``group_size`` minibatches at a time into one
    :class:`BatchGroup`; the epoch's last group is padded with zero-mask
    batches that carry the last live ``words_done``. A generator, so that
    ``utils.prefetch`` can run the windowing and stacking on its producer
    thread."""
    K = int(group_size)
    if K <= 0:
        raise ValueError("group_size must be > 0")
    while True:
        group: List[Batch] = []
        for batch in batches:
            group.append(batch)
            if len(group) == K:
                break
        if not group:
            return
        n_real = len(group)
        if n_real < K:
            proto = group[0]
            pad = Batch(
                centers=np.zeros_like(proto.centers),
                contexts=np.zeros_like(proto.contexts),
                mask=np.zeros_like(proto.mask),
                words_done=group[-1].words_done,
            )
            group.extend([pad] * (K - n_real))
        yield BatchGroup(
            centers=np.stack([b.centers for b in group]),
            contexts=np.stack([b.contexts for b in group]),
            mask=np.stack([b.mask for b in group]),
            words_done=[b.words_done for b in group],
            n_real=n_real,
        )


class SkipGramBatcher:
    """Streams fixed-shape minibatches from an encoded corpus.

    :meth:`epoch` runs one epoch's subsample and window passes, sentence
    by sentence under ``np.random.default_rng((seed, epoch))``, and yields
    :class:`Batch` es of exactly ``batch_size`` center positions; the
    last one is zero-padded with mask-0 rows. ``words_done`` counts
    pre-subsampling words: the LR anneal divides by ``num_iterations *
    train_words_count``, so counting kept words would stall it."""

    def __init__(
        self,
        sentences: Optional[List[np.ndarray]],
        vocab: Vocabulary,
        batch_size: int,
        window: int,
        subsample_ratio: float = 0.0,
        seed: int = 1,
    ):
        if batch_size <= 0:
            raise ValueError("batch_size must be > 0")
        if window <= 0:
            raise ValueError("window must be > 0")
        self.sentences = sentences
        self.vocab = vocab
        self.batch_size = int(batch_size)
        self.window = int(window)
        self.seed = int(seed)
        self.keep_prob = vocab.keep_probabilities(subsample_ratio)
        self.words_done = 0
        self._flat: Optional[tuple] = None

    @classmethod
    def from_flat(
        cls,
        ids: np.ndarray,
        offsets: np.ndarray,
        vocab: Vocabulary,
        *,
        batch_size: int,
        window: int,
        subsample_ratio: float = 0.0,
        seed: int = 1,
    ) -> "SkipGramBatcher":
        """Over the flat ``(ids, offsets)`` corpus: no per-sentence Python
        objects, about 4 bytes of host memory a word."""
        b = cls(
            None, vocab, batch_size=batch_size, window=window,
            subsample_ratio=subsample_ratio, seed=seed,
        )
        b._flat = (
            np.ascontiguousarray(ids, dtype=np.int32),
            np.ascontiguousarray(offsets, dtype=np.int64),
        )
        return b

    def _n_sentences(self) -> int:
        if self.sentences is not None:
            return len(self.sentences)
        return len(self._flat[1]) - 1

    def _sentence(self, i: int) -> np.ndarray:
        if self.sentences is not None:
            return self.sentences[i]
        ids, offsets = self._flat
        return ids[offsets[i] : offsets[i + 1]]

    def epoch(self, epoch_index: int) -> Iterator[Batch]:
        """Yield every minibatch of one pass over the corpus. The draws are
        made sentence by sentence, in the order of the JAX package's numpy
        pass (:func:`subsample_sentence`, then the window draws of
        :func:`window_batch`); the windows of ``_BLOCK_ROWS`` rows are then
        built at once, which keeps the producer thread's hold on the
        interpreter short. A batch's ``words_done`` is the count after the
        sentence of its last row (after the epoch, for the padded last
        batch)."""
        B, W = self.batch_size, self.window
        rng = np.random.default_rng((self.seed, epoch_index))
        pend = (*_window_rows([], [], W), np.zeros(0, np.int64))
        kept: List[np.ndarray] = []
        shrink: List[np.ndarray] = []
        words: List[int] = []
        n_rows = 0
        last = self._n_sentences() - 1
        for si in range(last + 1):
            sent = self._sentence(si)
            self.words_done += int(sent.size)
            ids = subsample_sentence(sent, self.keep_prob, rng)
            if ids.size:
                kept.append(ids)
                shrink.append(rng.integers(0, W, size=ids.size))
                words.append(self.words_done)
                n_rows += ids.size
            if n_rows < _BLOCK_ROWS and si < last:
                continue
            wd = np.repeat(np.asarray(words, np.int64), [k.size for k in kept])
            rows = (*_window_rows(kept, shrink, W), wd)
            kept, shrink, words, n_rows = [], [], [], 0
            c, x, m, wd = (np.concatenate(p) for p in zip(pend, rows))
            full = c.shape[0] - c.shape[0] % B
            for s in range(0, full, B):
                yield Batch(c[s : s + B], x[s : s + B], m[s : s + B],
                            int(wd[s + B - 1]))
            pend = (c[full:], x[full:], m[full:], wd[full:])
        c, x, m, _ = pend
        if c.shape[0]:
            pad = B - c.shape[0]
            yield Batch(np.pad(c, (0, pad)), np.pad(x, ((0, pad), (0, 0))),
                        np.pad(m, ((0, pad), (0, 0))), self.words_done)
