"""Window geometry, sentence encoding and the host batcher (own copy of
``glint_word2vec_tpu/corpus/batching.py``, trimmed): ``context_width``
(:38), ``packed_pair_batch`` (:49), ``window_offsets`` (:79),
``encode_sentences`` (:87), ``pack_query_block`` (:102), ``chunk_sentences``
(:137), and the host
batcher's ``subsample_sentence`` (:153), ``window_batch`` (:171),
``Batch`` (:202), ``BatchGroup`` (:212), ``group_batches`` (:229) and
``SkipGramBatcher`` (:288) with its native epoch pass (:385-473) and its
numpy epoch pass (:475-507).

Window semantics are the reference's: for center position ``i`` draw
``b ~ U[0, window)`` and take context positions ``[max(0, i-b),
min(i+b, len))`` without ``i``. The upper bound is half-open, so offsets
span ``[-(W-1), W-2]`` and a position has ``2W - 3`` context lanes.

The host batcher takes the native C++ pass (``native/host_ops.cpp``)
whenever it is built, as the JAX package does, and its batches then equal
the JAX package's native pass bitwise: the same per-block seeds and the
same C++ draws. Without it the numpy pass runs, whose batches equal the
JAX package's numpy pass bitwise: the same ``np.random.default_rng((seed,
epoch))`` stream, drawn in the same order. The two passes draw different
streams.
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


def pack_query_block(
    encoded: Sequence[np.ndarray], rows: Optional[int] = None
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], int]:
    """Pack encoded sentences into one dense ``(rows, len)`` index and mask
    pair, ``len`` the power of two at or above the longest sentence: the
    padding of :meth:`Word2VecModel.transform_sentences` factored out for
    the bulk transform (``batch/transform.py``). ``rows`` fixes the row
    bucket; None takes ``next_pow2(len(encoded))``. Mask-0 padding keeps
    the means exact: padded rows come back as zero vectors, padded columns
    add exact +0.0 terms to each masked mean.

    Returns ``(idx, mask, n)``, ``n`` the real row count. A block whose
    sentences are all empty returns ``(None, None, n)``: nothing to
    dispatch, every row is the zero vector."""
    from glint_word2vec_torch.utils import next_pow2

    n = len(encoded)
    max_len = max((len(x) for x in encoded), default=0)
    if max_len == 0:
        return None, None, n
    r = int(rows) if rows is not None else next_pow2(n)
    if n > r:
        raise ValueError(f"{n} sentences exceed the {r}-row bucket")
    idx = np.zeros((r, next_pow2(max_len)), np.int32)
    mask = np.zeros(idx.shape, np.float32)
    for i, x in enumerate(encoded):
        if len(x):
            idx[i, : len(x)] = x
            mask[i, : len(x)] = 1.0
    return idx, mask, n


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
    thread. Each group fires the fault point ``producer.batch`` and is
    recorded as a ``batch_prefetch`` span (on the producer thread's tid)
    when observability is on, as in the JAX package."""
    from glint_word2vec_torch.obs import events as obs_events
    from glint_word2vec_torch.utils import faults

    K = int(group_size)
    if K <= 0:
        raise ValueError("group_size must be > 0")
    g = 0
    while True:
        # On the producer thread: an injected exception reaches the fit
        # through the prefetch pipeline, a hang through its stall.
        faults.fire("producer.batch")
        with obs_events.span("batch_prefetch", group=g):
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
            out = BatchGroup(
                centers=np.stack([b.centers for b in group]),
                contexts=np.stack([b.contexts for b in group]),
                mask=np.stack([b.mask for b in group]),
                words_done=[b.words_done for b in group],
                n_real=n_real,
            )
        yield out
        g += 1


class SkipGramBatcher:
    """Streams fixed-shape minibatches from an encoded corpus.

    :meth:`epoch` runs one epoch's subsample and window passes, sentence
    by sentence under ``np.random.default_rng((seed, epoch))``, and yields
    :class:`Batch` es of exactly ``batch_size`` center positions; the
    last one is zero-padded with mask-0 rows. ``words_done`` counts
    pre-subsampling words: the LR anneal divides by ``num_iterations *
    train_words_count``, so counting kept words would stall it. With
    ``shuffle`` each epoch visits the sentences in an order drawn from
    that same generator first, on the numpy pass."""

    def __init__(
        self,
        sentences: Optional[List[np.ndarray]],
        vocab: Vocabulary,
        batch_size: int,
        window: int,
        subsample_ratio: float = 0.0,
        seed: int = 1,
        shuffle: bool = False,
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
        self.shuffle = bool(shuffle)
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
        shuffle: bool = False,
    ) -> "SkipGramBatcher":
        """Over the flat ``(ids, offsets)`` corpus: no per-sentence Python
        objects, about 4 bytes of host memory a word."""
        b = cls(
            None, vocab, batch_size=batch_size, window=window,
            subsample_ratio=subsample_ratio, seed=seed, shuffle=shuffle,
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
        """Yield every minibatch of one pass over the corpus: the native
        pass (:meth:`_epoch_native`) when the library is available and the
        order is not shuffled, else the numpy pass (:meth:`_epoch_python`).
        Each is deterministic per seed and epoch; the two draw different
        streams."""
        native = None if self.shuffle else self._epoch_native(epoch_index)
        if native is not None:
            return native
        return self._epoch_python(epoch_index)

    #: Words a native call windows at once: bounds the host memory of a
    #: block to about 60 bytes a word times this (about 250 MB) whatever
    #: the corpus size. An epoch is one native call a block of sentences.
    NATIVE_BLOCK_WORDS = 4_000_000

    def _epoch_native(self, epoch_index: int) -> Optional[Iterator[Batch]]:
        """The native epoch pass, or None without the library."""
        from glint_word2vec_torch.native import get_lib

        if get_lib() is None:
            return None
        if self._flat is None:
            if self.sentences:
                ids = np.concatenate(self.sentences).astype(np.int32)
                lens = np.array([len(s) for s in self.sentences], np.int64)
            else:
                ids = np.zeros(0, np.int32)
                lens = np.zeros(0, np.int64)
            offsets = np.zeros(len(lens) + 1, np.int64)
            np.cumsum(lens, out=offsets[1:])
            self._flat = (ids, offsets)
        return self._native_batches(epoch_index)

    def _native_batches(self, epoch_index: int) -> Iterator[Batch]:
        """Blocks of about ``NATIVE_BLOCK_WORDS`` words, each one
        ``window_batch_epoch_native`` call under the seed of ``(seed,
        epoch, block)``, cut into batches of ``batch_size`` rows (a batch
        may span blocks; the last one is zero-padded). A block's words are
        credited to its batches in proportion to the rows they take, so
        the learning rate anneals smoothly within a block."""
        from glint_word2vec_torch.native import window_batch_epoch_native

        ids, offsets = self._flat
        kp = self.keep_prob.astype(np.float32)
        n_sent = len(offsets) - 1
        B = self.batch_size
        C = context_width(self.window)
        buf_c = np.zeros(B, np.int32)
        buf_x = np.zeros((B, C), np.int32)
        buf_m = np.zeros((B, C), np.float32)
        fill = 0
        s = 0
        block = 0
        while s < n_sent:
            e = int(np.searchsorted(
                offsets, offsets[s] + self.NATIVE_BLOCK_WORDS, side="left"
            ))
            e = min(max(e, s + 1), n_sent)
            seed = int(np.random.SeedSequence(
                (self.seed, epoch_index, block)
            ).generate_state(1, np.uint64)[0])
            centers, contexts, mask, block_words = window_batch_epoch_native(
                ids[offsets[s] : offsets[e]], offsets[s : e + 1] - offsets[s],
                kp, self.window, seed,
            )
            wd_base = self.words_done
            self.words_done += block_words
            n = centers.shape[0]
            start = 0
            while n - start > 0:
                take = min(B - fill, n - start)
                buf_c[fill : fill + take] = centers[start : start + take]
                buf_x[fill : fill + take] = contexts[start : start + take]
                buf_m[fill : fill + take] = mask[start : start + take]
                fill += take
                start += take
                if fill == B:
                    wd = wd_base + int(round(block_words * (start / n)))
                    yield Batch(buf_c.copy(), buf_x.copy(), buf_m.copy(), wd)
                    fill = 0
            s = e
            block += 1
        if fill > 0:
            buf_c[fill:] = 0
            buf_x[fill:] = 0
            buf_m[fill:] = 0.0
            yield Batch(buf_c.copy(), buf_x.copy(), buf_m.copy(), self.words_done)

    def _epoch_python(self, epoch_index: int) -> Iterator[Batch]:
        """The numpy epoch pass. The draws are made sentence by sentence,
        in the order of the JAX package's numpy pass
        (:func:`subsample_sentence`, then the window draws of
        :func:`window_batch`); the windows of ``_BLOCK_ROWS`` rows are then
        built at once, which keeps the producer thread's hold on the
        interpreter short. A batch's ``words_done`` is the count after the
        sentence of its last row (after the epoch, for the padded last
        batch). With ``shuffle`` the sentence order is a permutation drawn
        from the epoch's generator before any other draw, as the JAX
        package's pass draws it."""
        B, W = self.batch_size, self.window
        rng = np.random.default_rng((self.seed, epoch_index))
        order = np.arange(self._n_sentences())
        if self.shuffle:
            rng.shuffle(order)
        pend = (*_window_rows([], [], W), np.zeros(0, np.int64))
        kept: List[np.ndarray] = []
        shrink: List[np.ndarray] = []
        words: List[int] = []
        n_rows = 0
        last = order.size - 1
        for i, si in enumerate(order):
            sent = self._sentence(si)
            self.words_done += int(sent.size)
            ids = subsample_sentence(sent, self.keep_prob, rng)
            if ids.size:
                kept.append(ids)
                shrink.append(rng.integers(0, W, size=ids.size))
                words.append(self.words_done)
                n_rows += ids.size
            if n_rows < _BLOCK_ROWS and i < last:
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
