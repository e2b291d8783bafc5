"""Vocabulary construction and corpus encoding (own copy of
``glint_word2vec_tpu/corpus/vocab.py``, with its native scanner).

Index == frequency rank, most frequent word first, ties broken by first
occurrence, as the JAX package builds it; a saved model directory lists
the words in that order in ``words.txt``. The scan produces the flat
corpus the training path uploads: ``ids`` (int32, OOV dropped) and
``offsets`` (int64 sentence starts, sentences chunked at
``max_sentence_length``). Words, counts, ids and offsets equal the JAX
package's for the same input.
"""

from __future__ import annotations

import collections
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Vocabulary:
    """Words, their counts and the word -> row map."""

    words: List[str]
    counts: np.ndarray
    word_index: Dict[str, int] = field(repr=False)
    train_words_count: int

    @property
    def size(self) -> int:
        return len(self.words)

    @classmethod
    def from_sorted(
        cls, words: List[str], counts: np.ndarray,
        min_count: Optional[int] = None,
    ) -> "Vocabulary":
        """Assemble a Vocabulary from an already-sorted word/count listing.
        Raises ValueError on an empty vocab (``min_count`` only improves
        the message)."""
        if not words:
            hint = f" (={min_count})" if min_count is not None else ""
            raise ValueError(
                "The vocabulary size should be > 0. "
                f"Lower min_count{hint} or supply a larger corpus."
            )
        counts = np.asarray(counts, dtype=np.int64)
        return cls(
            words=list(words),
            counts=counts,
            word_index={w: i for i, w in enumerate(words)},
            train_words_count=int(counts.sum()),
        )

    def __contains__(self, word: str) -> bool:
        return word in self.word_index

    def keep_probabilities(self, subsample_ratio: float) -> np.ndarray:
        """Per-word keep probability for frequency subsampling: with
        ``f = count / train_words_count`` and ratio ``s``,
        ``keep = (sqrt(f/s) + 1) * (s/f)`` clipped to [0, 1]. A ratio of 0
        keeps every word."""
        if subsample_ratio <= 0:
            return np.ones(self.size, dtype=np.float64)
        pcn = self.counts.astype(np.float64) / float(self.train_words_count)
        with np.errstate(divide="ignore", invalid="ignore"):
            ran = (np.sqrt(pcn / subsample_ratio) + 1.0) * (subsample_ratio / pcn)
        ran = np.where(self.counts > 0, ran, 0.0)
        return np.clip(ran, 0.0, 1.0)

    def device_keep_probabilities(self, subsample_ratio: float) -> np.ndarray:
        """:meth:`keep_probabilities` as float32, one entry per row: the
        table the device subsampling pass indexes by corpus id."""
        return self.keep_probabilities(subsample_ratio).astype(np.float32)

    def encode(self, sentence: Sequence[str]) -> np.ndarray:
        """Map words to indices, silently dropping OOV words."""
        ids = [self.word_index[w] for w in sentence if w in self.word_index]
        return np.asarray(ids, dtype=np.int32)

    def encode_strict(self, words: Sequence[str]) -> np.ndarray:
        """Map words to indices, raising KeyError on OOV."""
        try:
            return np.asarray([self.word_index[w] for w in words], dtype=np.int32)
        except KeyError as e:
            raise KeyError(f"word {e.args[0]!r} not in vocabulary") from None


def build_vocab(
    sentences: Iterable[Sequence[str]], min_count: int = 5
) -> Vocabulary:
    """Scan tokenized sentences into a :class:`Vocabulary`: words seen at
    least ``min_count`` times, most frequent first, ties by first
    occurrence (``Counter`` keeps first-seen order and the sort is
    stable)."""
    counter: collections.Counter = collections.Counter()
    for sentence in sentences:
        counter.update(sentence)
    items = [(w, c) for w, c in counter.items() if c >= min_count]
    items.sort(key=lambda wc: -wc[1])
    return Vocabulary.from_sorted(
        [w for w, _ in items],
        np.asarray([c for _, c in items], dtype=np.int64),
        min_count=min_count,
    )


def saved_model_vocabulary(
    model_dir: str, counts: np.ndarray, expected_rows: int
) -> Vocabulary:
    """Vocabulary for a saved model directory: read ``words.txt``, check
    its entry count against the matrix's queryable rows, and zero-pad the
    counts for words promoted onto extra rows."""
    with open(os.path.join(model_dir, "words.txt"), encoding="utf-8") as f:
        words = [line.rstrip("\n") for line in f if line.rstrip("\n")]
    if len(words) != expected_rows:
        raise ValueError(
            f"corrupt model dir at {model_dir}: words.txt has "
            f"{len(words)} entries, the matrix claims {expected_rows} "
            "queryable rows"
        )
    counts = np.asarray(counts, dtype=np.int64)
    if len(words) > counts.shape[0]:
        counts = np.concatenate(
            [counts, np.zeros(len(words) - counts.shape[0], np.int64)]
        )
    return Vocabulary(
        words=words,
        counts=counts[: len(words)],
        word_index={w: i for i, w in enumerate(words)},
        train_words_count=int(counts.sum()),
    )


def iter_text_file(path: str, lowercase: bool = False) -> Iterator[List[str]]:
    """Stream whitespace-tokenized sentences from a text file, one per line."""
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            toks = line.lower().split() if lowercase else line.split()
            if toks:
                yield toks


#: Tokens a flat id buffer collects before it becomes one numpy block.
_BLOCK = 1 << 20


def encode_file(
    path: str,
    vocab: Vocabulary,
    max_sentence_length: int = 1000,
    lowercase: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Encode a text file into the flat corpus ``(ids int32[total],
    offsets int64[n_sentences+1])``: OOV dropped, empty lines skipped,
    sentences chunked at ``max_sentence_length``. Host memory is ~4 bytes
    per kept word."""
    if max_sentence_length <= 0:
        raise ValueError("max_sentence_length must be > 0")
    wi = vocab.word_index
    id_blocks: List[np.ndarray] = []
    lengths: List[int] = []
    buf: List[int] = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            toks = line.lower().split() if lowercase else line.split()
            ids = [wi[t] for t in toks if t in wi]
            if not ids:
                continue
            for s in range(0, len(ids), max_sentence_length):
                chunk = ids[s : s + max_sentence_length]
                lengths.append(len(chunk))
                buf.extend(chunk)
            if len(buf) >= _BLOCK:
                id_blocks.append(np.asarray(buf, dtype=np.int32))
                buf = []
    if buf:
        id_blocks.append(np.asarray(buf, dtype=np.int32))
    flat = np.concatenate(id_blocks) if id_blocks else np.zeros(0, np.int32)
    offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(np.asarray(lengths, dtype=np.int64), out=offsets[1:])
    return flat, offsets


def scan_and_encode_stream(
    sentences: Iterable[Sequence[str]],
    min_count: int = 5,
    max_sentence_length: int = 1000,
) -> Tuple[Vocabulary, np.ndarray, np.ndarray]:
    """Single-pass scan and encode of a sentence iterable that cannot be
    read twice.

    One pass gives every word a provisional first-seen id and counts it,
    keeping only a flat int32 token buffer and the sentence lengths; a
    vectorized remap onto the frequency-ranked vocabulary then drops
    words under ``min_count`` and emptied sentences and chunks at
    ``max_sentence_length``. The result equals :func:`build_vocab` plus
    :func:`~glint_word2vec_torch.corpus.batching.encode_sentences` and
    ``chunk_sentences`` over the same sentences."""
    if max_sentence_length <= 0:
        raise ValueError("max_sentence_length must be > 0")
    prov: Dict[str, int] = {}
    counts_l: List[int] = []
    id_blocks: List[np.ndarray] = []
    buf: List[int] = []
    sent_lens: List[int] = []
    for sentence in sentences:
        n = 0
        for w in sentence:
            i = prov.get(w)
            if i is None:
                i = len(prov)
                prov[w] = i
                counts_l.append(1)
            else:
                counts_l[i] += 1
            buf.append(i)
            n += 1
        if n:
            sent_lens.append(n)
        if len(buf) >= _BLOCK:
            id_blocks.append(np.asarray(buf, dtype=np.int32))
            buf = []
    if buf:
        id_blocks.append(np.asarray(buf, dtype=np.int32))
    flat = np.concatenate(id_blocks) if id_blocks else np.zeros(0, np.int32)
    counts = np.asarray(counts_l, dtype=np.int64)

    # Final ranks: count desc, ties by provisional (= first-seen) id.
    order = np.argsort(-counts, kind="stable")
    kept = order[counts[order] >= min_count]
    words_by_prov = list(prov)  # dict preserves insertion order
    vocab = Vocabulary.from_sorted(
        [words_by_prov[i] for i in kept], counts[kept], min_count=min_count
    )

    remap = np.full(len(counts_l) + 1, -1, dtype=np.int64)
    remap[kept] = np.arange(kept.size, dtype=np.int64)
    mapped = remap[flat]
    keep_mask = mapped >= 0
    ids = mapped[keep_mask].astype(np.int32)

    # Kept length per original sentence -> drop emptied, chunk the rest.
    prov_offsets = np.zeros(len(sent_lens) + 1, dtype=np.int64)
    np.cumsum(np.asarray(sent_lens, dtype=np.int64), out=prov_offsets[1:])
    kept_counts = np.add.reduceat(
        keep_mask.astype(np.int64), prov_offsets[:-1]
    ) if len(sent_lens) else np.zeros(0, np.int64)
    L = kept_counts[kept_counts > 0]
    n_chunks = (L + max_sentence_length - 1) // max_sentence_length
    lengths = np.full(int(n_chunks.sum()), max_sentence_length, np.int64)
    ends = np.cumsum(n_chunks) - 1
    lengths[ends] = L - (n_chunks - 1) * max_sentence_length
    offsets = np.zeros(lengths.size + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return vocab, ids, offsets


def scan_and_encode_file(
    path: str,
    min_count: int = 5,
    max_sentence_length: int = 1000,
    lowercase: bool = False,
) -> Tuple[Vocabulary, np.ndarray, np.ndarray]:
    """Both ingestion passes over a text file: through the native scanner
    (``native/host_ops.cpp``) when it is available, else the vocabulary
    scan (:func:`build_vocab` over :func:`iter_text_file`), then the flat
    encode (:func:`encode_file`). The native scanner gives the Python
    passes' output for valid UTF-8 and declines, leaving the file to
    them, on invalid UTF-8 or ``lowercase=True``, as the JAX package's
    does. Returns ``(vocab, ids, offsets)``."""
    from glint_word2vec_torch.native import corpus_scan_native

    res = corpus_scan_native(
        path, min_count, max_sentence_length, lowercase=lowercase
    )
    if res is not None:
        words, counts, ids, offsets = res
        vocab = Vocabulary.from_sorted(words, counts, min_count=min_count)
        return vocab, ids, offsets
    vocab = build_vocab(
        iter_text_file(path, lowercase=lowercase), min_count=min_count
    )
    ids, offsets = encode_file(
        path, vocab, max_sentence_length=max_sentence_length,
        lowercase=lowercase,
    )
    return vocab, ids, offsets
