"""Streaming vocabulary (own copy of
``glint_word2vec_tpu/corpus/stream_vocab.py``): approximate counts over an
unbounded sentence stream plus online vocabulary growth, the ISGNS
construction (arXiv:1704.03956) the streaming trainer builds on.

Batch training scans the corpus twice: once for exact counts
(:func:`corpus.vocab.build_vocab`), once to encode. A stream gets one look
at each sentence and has no end, so three things change:

- **Admitted words keep exact counts.** The adaptive subsample and
  negative-sampling distributions are recomputed from these live counts
  on a cadence (``EmbeddingEngine.set_noise_counts`` keeps the alias
  tables' shapes fixed).
- **Candidate (out-of-vocabulary) words go through a space-saving
  sketch** (:class:`SpaceSavingSketch`, Misra-Gries family): bounded
  memory however many distinct tokens the stream carries; any word seen
  more than ``stream_words / capacity`` times since the sketch started is
  present, and every estimate carries its own error bound.
- **Promotion assigns new words to the engine's spare extra rows**
  (``EmbeddingEngine.assign_extra_rows``): a candidate whose guaranteed
  count (estimate minus error) clears ``min_count`` joins the vocabulary
  at the next free row, so the grown word list stays aligned with the
  table by construction and the serving top-k mask widens by a value.

The vocabulary's index order therefore differs from a batch build (batch
ranks by frequency; streaming appends in promotion order). Everything
downstream keys on words, not ranks.
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from glint_word2vec_torch.corpus.vocab import Vocabulary


class SpaceSavingSketch:
    """Space-saving heavy-hitter counter over a bounded ``capacity`` of
    tracked items (Metwally et al.; the Misra-Gries family ISGNS uses
    for its candidate vocabulary).

    Semantics: while under capacity, counts are exact (``error == 0``).
    At capacity, a new item evicts the currently-smallest tracked item
    and inherits its count as overestimation ``error``. Guarantees:

    - ``estimate(w) >= true_count(w)`` for every tracked ``w``, and
      ``estimate(w) - error(w) <= true_count(w)`` (the guaranteed lower
      bound promotion thresholds use);
    - any item with ``true_count > items_seen / capacity`` is tracked;
    - ``error(w) <= items_seen / capacity`` for every tracked item.

    Eviction uses a lazy min-heap over (count, item) snapshots: stale
    heap entries (the item's count moved on, or it was evicted) are
    skipped on pop, and the heap is rebuilt when it outgrows
    ``4 * capacity`` entries — amortized O(log capacity) per add,
    bounded memory.
    """

    __slots__ = ("capacity", "items_seen", "_counts", "_errors", "_heap")

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        #: Total items ever added (the N in the error bound N/capacity).
        self.items_seen = 0
        self._counts: Dict[str, int] = {}
        self._errors: Dict[str, int] = {}
        self._heap: List[Tuple[int, str]] = []

    def __len__(self) -> int:
        return len(self._counts)

    def __contains__(self, item: str) -> bool:
        return item in self._counts

    def add(self, item: str, n: int = 1) -> None:
        self.items_seen += n
        c = self._counts.get(item)
        if c is not None:
            self._counts[item] = c + n
            heapq.heappush(self._heap, (c + n, item))
        elif len(self._counts) < self.capacity:
            self._counts[item] = n
            self._errors[item] = 0
            heapq.heappush(self._heap, (n, item))
        else:
            m, victim = self._pop_min()
            del self._counts[victim]
            del self._errors[victim]
            self._counts[item] = m + n
            self._errors[item] = m
            heapq.heappush(self._heap, (m + n, item))
        if len(self._heap) > 4 * self.capacity:
            self._heap = [(c, w) for w, c in self._counts.items()]
            heapq.heapify(self._heap)

    def _pop_min(self) -> Tuple[int, str]:
        """Current (count, item) minimum among tracked items, popping
        stale heap snapshots on the way."""
        while self._heap:
            c, w = heapq.heappop(self._heap)
            if self._counts.get(w) == c:
                return c, w
        # Heap drained of live entries (all stale): rebuild and retry.
        self._heap = [(c, w) for w, c in self._counts.items()]
        heapq.heapify(self._heap)
        return heapq.heappop(self._heap)

    def estimate(self, item: str) -> Tuple[int, int]:
        """(count_estimate, error) for a tracked item — the estimate
        overcounts by at most ``error``. Raises ``KeyError`` when the
        item is not tracked (its true count is then bounded by
        ``items_seen / capacity``)."""
        return self._counts[item], self._errors[item]

    def pop(self, item: str) -> Tuple[int, int]:
        """Remove a tracked item (promotion took it), returning its
        final (estimate, error)."""
        c = self._counts.pop(item)
        e = self._errors.pop(item)
        return c, e

    def over_threshold(self, threshold: int) -> List[Tuple[str, int, int]]:
        """Tracked items whose GUARANTEED count clears ``threshold``,
        as (item, estimate, error), largest estimates first — the
        promotion candidate scan."""
        out = [
            (w, c, self._errors[w])
            for w, c in self._counts.items()
            if c - self._errors[w] >= threshold
        ]
        out.sort(key=lambda t: (-t[1], t[0]))
        return out


class StreamVocab:
    """A vocabulary that grows while a stream is consumed.

    Wraps a bootstrap :class:`~glint_word2vec_torch.corpus.vocab
    .Vocabulary` (exact counts from the bootstrap window) and maintains:
    exact live counts for every admitted word, the candidate sketch for
    everything else, and the word -> row mapping that mirrors the
    engine's row assignment (base vocab rows first, promoted words
    appended in promotion order at ``vocab_size + j``).
    """

    def __init__(self, base: Vocabulary, *, sketch_capacity: int = 65536,
                 max_size: Optional[int] = None):
        self.words: List[str] = list(base.words)
        self.word_index: Dict[str, int] = dict(base.word_index)
        self._counts: List[int] = [int(c) for c in base.counts]
        #: Engine ``vocab_size``: rows below this came from the
        #: bootstrap scan; rows at or above it are promoted words on
        #: extra rows.
        self.base_size = base.size
        #: Total KEPT (in-vocabulary) word occurrences observed,
        #: bootstrap included — the ``train_words_count`` analogue the
        #: adaptive subsample distribution normalizes by.
        self.train_words_count = int(base.train_words_count)
        #: Out-of-vocabulary occurrences routed to the sketch.
        self.oov_words_seen = 0
        self.promoted = 0
        self.sketch = SpaceSavingSketch(sketch_capacity)
        #: Hard cap on len(words) (base + promotable); None = unbounded
        #: here (the engine's spare-row pool still bounds promotion).
        self.max_size = max_size

    @property
    def size(self) -> int:
        return len(self.words)

    def __contains__(self, word: str) -> bool:
        return word in self.word_index

    def counts_array(self) -> np.ndarray:
        """Live counts snapshot aligned with ``words`` (int64)."""
        return np.asarray(self._counts, dtype=np.int64)

    def observe(self, sentence: Sequence[str]) -> List[int]:
        """Count one sentence and encode its in-vocabulary words.

        Admitted words get an exact count increment and their row index
        in the output; OOV words feed the candidate sketch (and are
        dropped from the encoding, exactly as batch training drops OOV
        — until promotion admits them, from which point on they train).
        """
        ids: List[int] = []
        wi = self.word_index
        counts = self._counts
        kept = 0
        for w in sentence:
            i = wi.get(w)
            if i is None:
                self.sketch.add(w)
                self.oov_words_seen += 1
            else:
                counts[i] += 1
                kept += 1
                ids.append(i)
        self.train_words_count += kept
        return ids

    def encode(self, sentence: Sequence[str]) -> List[int]:
        """Encode WITHOUT counting — for replaying sentences whose
        occurrences are already in the counts (the bootstrap window,
        whose exact counts seeded the base vocabulary and the sketch).
        OOV words are dropped, not sketched."""
        wi = self.word_index
        return [i for w in sentence if (i := wi.get(w)) is not None]

    def promotable(self, min_count: int,
                   limit: Optional[int] = None) -> List[Tuple[str, int]]:
        """Candidates whose guaranteed sketch count clears
        ``min_count``, as (word, estimated_count), most frequent first,
        at most ``limit`` of them. Respects ``max_size``."""
        room = None
        if self.max_size is not None:
            room = max(0, self.max_size - self.size)
        out = [
            (w, est)
            for w, est, _err in self.sketch.over_threshold(min_count)
        ]
        if room is not None:
            out = out[:room]
        if limit is not None:
            out = out[:limit]
        return out

    def promote(self, word: str, count: Optional[int] = None) -> int:
        """Admit a candidate: append it to the vocabulary at the next
        row index (which the caller pairs with
        ``engine.assign_extra_row`` — both count assignments in the
        same order, so the indices agree by construction). ``count``
        defaults to the sketch estimate; the word leaves the sketch.
        Returns the new index."""
        if word in self.word_index:
            raise ValueError(f"word {word!r} already in vocabulary")
        if self.max_size is not None and self.size >= self.max_size:
            raise ValueError(
                f"vocabulary at max_size ({self.max_size}); cannot "
                f"promote {word!r}"
            )
        if count is None:
            count = self.sketch.estimate(word)[0]
        if word in self.sketch:
            self.sketch.pop(word)
        idx = len(self.words)
        self.words.append(word)
        self.word_index[word] = idx
        self._counts.append(int(count))
        # A promoted word's pre-promotion occurrences were counted by
        # the sketch, not train_words_count; fold the estimate in so
        # the subsample normalizer reflects what the counts claim.
        self.train_words_count += int(count)
        self.promoted += 1
        return idx

    # -- adaptive distributions ----------------------------------------

    def keep_probabilities(self, subsample_ratio: float) -> np.ndarray:
        """Per-word keep probability over the GROWN vocabulary — the
        exact :meth:`Vocabulary.keep_probabilities` formula evaluated
        on the live counts (the ISGNS adaptive subsample
        distribution). The streaming trainer applies these host-side
        while filling each round's buffer."""
        if subsample_ratio <= 0:
            return np.ones(self.size, dtype=np.float64)
        counts = self.counts_array()
        pcn = counts.astype(np.float64) / float(
            max(self.train_words_count, 1)
        )
        with np.errstate(divide="ignore", invalid="ignore"):
            ran = (np.sqrt(pcn / subsample_ratio) + 1.0) * (
                subsample_ratio / pcn
            )
        ran = np.where(counts > 0, ran, 0.0)
        return np.clip(ran, 0.0, 1.0)

    def noise_counts(self) -> np.ndarray:
        """Live counts over the BASE vocabulary only — the adaptive
        negative-sampling distribution (``engine.set_noise_counts``
        keeps the alias shapes fixed at vocab_size; promoted words are
        never negative-sampled, like fastText bucket rows)."""
        return np.asarray(self._counts[: self.base_size], dtype=np.int64)

    def noise_weights(self, power: float = 0.75) -> np.ndarray:
        """Normalized ``count^power`` noise distribution over the base
        vocab — what :meth:`noise_counts` induces; used for the
        distribution-drift gauge."""
        w = np.power(self.noise_counts().astype(np.float64), power)
        s = w.sum()
        return w / s if s > 0 else w

    def snapshot_vocabulary(self) -> Vocabulary:
        """Immutable :class:`Vocabulary` of the current grown state —
        what a published model generation carries (words.txt order ==
        row order)."""
        return Vocabulary(
            words=list(self.words),
            counts=self.counts_array(),
            word_index=dict(self.word_index),
            train_words_count=int(self.train_words_count),
        )


def bootstrap_stream_vocab(
    sentences: Iterable[Sequence[str]],
    *,
    min_count: int = 5,
    sketch_capacity: int = 65536,
    max_size: Optional[int] = None,
) -> StreamVocab:
    """Build a :class:`StreamVocab` from a bootstrap window of the
    stream: exact batch-style counts (``build_vocab`` semantics —
    frequency-ranked indices, first-seen ties) seed the base
    vocabulary, and every bootstrap word that fell below ``min_count``
    seeds the candidate sketch with its exact count, so a word that
    was warming up during bootstrap is not forgotten."""
    import collections

    from glint_word2vec_torch.corpus.vocab import build_vocab

    counter: collections.Counter = collections.Counter()
    materialized = []
    for s in sentences:
        counter.update(s)
        materialized.append(s)
    base = build_vocab(materialized, min_count=min_count)
    sv = StreamVocab(
        base, sketch_capacity=sketch_capacity, max_size=max_size
    )
    for w, c in counter.items():
        if w not in base.word_index:
            sv.sketch.add(w, c)
            sv.oov_words_seen += c
    return sv
