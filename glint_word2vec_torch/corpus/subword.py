"""Character n-gram subwords for the fastText family (own copy of
``glint_word2vec_tpu/corpus/subword.py``).

fastText's conventions: a word is wrapped in ``<``/``>``, its character
n-grams of lengths ``[min_n, max_n]`` (the whole wrapped token excluded)
are hashed with FNV-1a (32 bits, over the UTF-8 bytes) into ``bucket``
rows after the vocabulary, and the word's input vector is the mean of its
own row and its n-gram rows. An out-of-vocabulary word composes from its
n-gram rows alone.

:func:`build_subword_table` computes the same ids as the per-word
functions, for a whole vocabulary at once: the n-grams' byte ranges come
from the UTF-8 character starts of the concatenated words, and FNV-1a runs
over all of them in numpy, one byte position at a time.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

FNV_OFFSET = 2166136261
FNV_PRIME = 16777619
MASK32 = 0xFFFFFFFF

#: Words per vectorised block of :func:`build_subword_table` (bounds its
#: temporaries to some hundreds of MB at fastText's default geometry).
_TABLE_BLOCK = 1 << 17


def fnv1a_32(data: bytes) -> int:
    """FNV-1a 32-bit hash (the fastText n-gram hash)."""
    h = FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * FNV_PRIME) & MASK32
    return h


def word_ngrams(word: str, min_n: int = 3, max_n: int = 6) -> List[str]:
    """Character n-grams of ``<word>`` with lengths in ``[min_n, max_n]``,
    shorter ones first; the whole wrapped token is left out."""
    if min_n <= 0 or max_n < min_n:
        raise ValueError("need 0 < min_n <= max_n")
    wrapped = f"<{word}>"
    L = len(wrapped)
    return [
        wrapped[i : i + n]
        for n in range(min_n, min(max_n, L - 1) + 1)
        for i in range(L - n + 1)
    ]


def ngram_bucket_ids(
    word: str, vocab_size: int, bucket: int, min_n: int, max_n: int
) -> List[int]:
    """Bucket-row ids (offset by ``vocab_size``) of a word's n-grams."""
    return [
        vocab_size + (fnv1a_32(g.encode("utf-8")) % bucket)
        for g in word_ngrams(word, min_n, max_n)
    ]


def subword_group(
    word: str,
    word_id: Optional[int],
    vocab_size: int,
    bucket: int,
    min_n: int,
    max_n: int,
    max_subwords: int,
) -> List[int]:
    """The ids whose mean represents ``word``: its own row (if in the
    vocabulary) followed by its n-gram rows, cut to ``max_subwords``."""
    ids = [] if word_id is None else [word_id]
    ids += ngram_bucket_ids(word, vocab_size, bucket, min_n, max_n)
    return ids[:max_subwords]


def _block_ngram_ids(words: Sequence[str], bucket: int, min_n: int,
                     max_n: int, keep: int):
    """``(word, rank, bucket)`` of the first ``keep`` n-grams of each word
    of a block, in :func:`word_ngrams` order: n ascending, then start."""
    wrapped = "".join(f"<{w}>" for w in words)
    raw = np.frombuffer(wrapped.encode("utf-8"), dtype=np.uint8)
    # Byte offset of every character start, plus the end.
    starts = np.flatnonzero((raw & 0xC0) != 0x80)
    starts = np.append(starts, raw.size).astype(np.int64)
    L = np.fromiter((len(w) + 2 for w in words), np.int64, len(words))
    first_char = np.zeros(len(words), np.int64)
    np.cumsum(L[:-1], out=first_char[1:])
    wid, pos, ln = [], [], []
    for n in range(min_n, max_n + 1):
        ok = np.flatnonzero(L - 1 >= n)  # n <= L - 1
        if ok.size == 0:
            continue
        cnt = L[ok] - n + 1
        w = np.repeat(ok, cnt)
        within = np.arange(w.size) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        wid.append(w)
        pos.append(first_char[w] + within)
        ln.append(np.full(w.size, n, np.int64))
    if not wid:
        z = np.zeros(0, np.int64)
        return z, z, z
    wid = np.concatenate(wid)
    pos = np.concatenate(pos)
    ln = np.concatenate(ln)
    # Per word: n ascending (concatenation order), then start position.
    order = np.argsort(wid, kind="stable")
    wid, pos, ln = wid[order], pos[order], ln[order]
    word_first = np.searchsorted(wid, np.arange(len(words)))
    rank = np.arange(wid.size) - word_first[wid]
    sel = rank < keep
    wid, pos, ln, rank = wid[sel], pos[sel], ln[sel], rank[sel]
    b0 = starts[pos]
    nbytes = starts[pos + ln] - b0
    h = np.full(wid.size, FNV_OFFSET, np.uint64)
    for t in range(int(nbytes.max(initial=0))):
        live = t < nbytes
        byte = raw[np.where(live, b0 + t, 0)].astype(np.uint64)
        nh = ((h ^ byte) * np.uint64(FNV_PRIME)) & np.uint64(MASK32)
        h = np.where(live, nh, h)
    return wid, rank, (h % np.uint64(bucket)).astype(np.int64)


def build_subword_table(
    words: Sequence[str],
    vocab_size: int,
    bucket: int,
    min_n: int = 3,
    max_n: int = 6,
    max_subwords: int = 32,
) -> Tuple[np.ndarray, np.ndarray]:
    """The ``(V, max_subwords)`` id and mask arrays of every vocabulary
    word's subword group (:func:`subword_group` with the word's own id),
    used on the host to expand minibatch centers."""
    if min_n <= 0 or max_n < min_n:
        raise ValueError("need 0 < min_n <= max_n")
    V = len(words)
    ids = np.zeros((V, max_subwords), np.int32)
    mask = np.zeros((V, max_subwords), np.float32)
    ids[:, 0] = np.arange(V, dtype=np.int32)
    mask[:, 0] = 1.0
    for s in range(0, V, _TABLE_BLOCK):
        block = words[s : s + _TABLE_BLOCK]
        wid, rank, b = _block_ngram_ids(
            block, bucket, min_n, max_n, max_subwords - 1
        )
        ids[s + wid, 1 + rank] = (vocab_size + b).astype(np.int32)
        mask[s + wid, 1 + rank] = 1.0
    return ids, mask
