"""The fitted word2vec model of the port (counterpart of
``glint_word2vec_tpu/models/word2vec.py:1651-2013``): the query surface
over an :class:`~glint_word2vec_torch.parallel.engine.EmbeddingEngine`,
plus the host-only :class:`LocalWord2VecModel`. Training arrives with a
later slice of the port.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

import numpy as np

from glint_word2vec_torch.corpus.vocab import Vocabulary, saved_model_vocabulary
from glint_word2vec_torch.device import DeviceLike
from glint_word2vec_torch.utils import (
    atomic_write_json,
    atomic_write_npy,
    atomic_write_text,
    next_pow2,
)
from glint_word2vec_torch.utils.params import Word2VecParams

#: Rows one query dispatch may pull (the JAX package's bound on a
#: request's device-memory spike).
MAX_QUERY_ROWS = 10_000


class Word2VecModel:
    """Fitted model: query and serving surface over the engine's tables."""

    def __init__(self, vocab: Vocabulary, engine, params: Word2VecParams):
        self.vocab = vocab
        self.engine = engine
        self.params = params

    @property
    def vector_size(self) -> int:
        return self.engine.cols

    # ------------------------------------------------------------------
    # transform
    # ------------------------------------------------------------------

    def transform(self, word: str) -> np.ndarray:
        """Single word -> vector. Raises KeyError on OOV."""
        idx = self.vocab.word_index.get(word)
        if idx is None:
            raise KeyError(f"word {word!r} not in vocabulary")
        return self.engine.pull(np.array([idx], np.int32)).cpu().numpy()[0]

    def transform_words(self, words: Sequence[str]) -> np.ndarray:
        """Batch of words -> ``(N, d)``. Raises on OOV; pulls
        ``MAX_QUERY_ROWS`` at a time."""
        idx = self.vocab.encode_strict(words)
        out = np.empty((len(idx), self.vector_size), np.float32)
        for s in range(0, len(idx), MAX_QUERY_ROWS):
            out[s : s + MAX_QUERY_ROWS] = (
                self.engine.pull(idx[s : s + MAX_QUERY_ROWS]).cpu().numpy()
            )
        return out

    def transform_sentences(
        self, sentences: Iterable[Sequence[str]]
    ) -> np.ndarray:
        """Sentences -> ``(S, d)`` mean vectors, computed on the device.

        OOV words are dropped; empty or all-OOV sentences give zero
        vectors. Sentences go ``MAX_QUERY_ROWS`` at a time, each block
        padded to power-of-two rows and length with mask-0 entries, which
        add exact zeros to every masked mean."""
        sents = [self.vocab.encode(s) for s in sentences]
        out = np.zeros((len(sents), self.vector_size), np.float32)
        for s in range(0, len(sents), MAX_QUERY_ROWS):
            block = sents[s : s + MAX_QUERY_ROWS]
            L = max((len(x) for x in block), default=0)
            if L == 0:
                continue
            idx = np.zeros((next_pow2(len(block)), next_pow2(L)), np.int32)
            m = np.zeros(idx.shape, np.float32)
            for i, x in enumerate(block):
                idx[i, : len(x)] = x
                m[i, : len(x)] = 1.0
            out[s : s + len(block)] = (
                self.engine.pull_average(idx, m).cpu().numpy()[: len(block)]
            )
        return out

    # ------------------------------------------------------------------
    # Similarity and analogy
    # ------------------------------------------------------------------

    def find_synonyms(self, word: str, num: int) -> List[Tuple[str, float]]:
        """Top-``num`` most similar words, the query word excluded (fetch
        num+1, drop the word itself)."""
        vec = self.transform(word)
        results = self.find_synonyms_vector(vec, num + 1)
        return [(w, s) for w, s in results if w != word][:num]

    def _decode_hits(self, sims, idx) -> List[Tuple[str, float]]:
        # Masked rows score -inf and are filler, never results.
        return [
            (self.vocab.words[int(i)], float(s))
            for s, i in zip(sims, idx)
            if int(i) < self.vocab.size and np.isfinite(s)
        ]

    def find_synonyms_vector(
        self, vector: np.ndarray, num: int
    ) -> List[Tuple[str, float]]:
        """Top-``num`` words by cosine similarity to an arbitrary vector."""
        if num <= 0:
            raise ValueError("num must be > 0")
        num = min(num, self.vocab.size)
        sims, idx = self.engine.top_k_cosine(np.asarray(vector, np.float32), num)
        return self._decode_hits(sims, idx)

    def find_synonyms_batch(
        self, vectors: np.ndarray, num: int
    ) -> List[List[Tuple[str, float]]]:
        """Top-``num`` neighbours for a whole ``(Q, d)`` query batch in one
        matrix product and one ``topk`` (the exact path)."""
        if num <= 0:
            raise ValueError("num must be > 0")
        num = min(num, self.vocab.size)
        sims, idx = self.engine.top_k_cosine_batch(
            np.asarray(vectors, np.float32), num
        )
        return [self._decode_hits(s, i) for s, i in zip(sims, idx)]

    def analogy(
        self, positive: Sequence[str], negative: Sequence[str], num: int
    ) -> List[Tuple[str, float]]:
        """king - man + woman style queries: sum(positive) - sum(negative),
        the query words excluded from the results."""
        vec = np.zeros(self.vector_size, np.float32)
        for w in positive:
            vec += self.transform(w)
        for w in negative:
            vec -= self.transform(w)
        exclude = set(positive) | set(negative)
        res = self.find_synonyms_vector(vec, num + len(exclude))
        return [(w, s) for w, s in res if w not in exclude][:num]

    # ------------------------------------------------------------------
    # Export
    # ------------------------------------------------------------------

    def get_vectors(self) -> Iterator[Tuple[str, np.ndarray]]:
        """Stream (word, vector) pairs, pulled ``MAX_QUERY_ROWS`` at a
        time."""
        for s in range(0, self.vocab.size, MAX_QUERY_ROWS):
            idx = np.arange(s, min(s + MAX_QUERY_ROWS, self.vocab.size), dtype=np.int32)
            rows = self.engine.pull(idx).cpu().numpy()
            for i, r in zip(idx, rows):
                yield self.vocab.words[int(i)], r

    def to_local(self) -> "LocalWord2VecModel":
        """Materialise a host-side numpy model."""
        vecs = np.empty((self.vocab.size, self.vector_size), np.float32)
        for s in range(0, self.vocab.size, MAX_QUERY_ROWS):
            idx = np.arange(s, min(s + MAX_QUERY_ROWS, self.vocab.size), dtype=np.int32)
            vecs[s : s + len(idx)] = self.engine.pull(idx).cpu().numpy()
        return LocalWord2VecModel(list(self.vocab.words), vecs)

    # ------------------------------------------------------------------
    # Persistence and lifecycle
    # ------------------------------------------------------------------

    def save(self, path: str) -> None:
        """Matrix (``matrix/``), ``words.txt`` and ``params.json``: the JAX
        package's model directory. Every file lands through
        write-temp-then-rename."""
        for w in self.vocab.words:
            if "\n" in w or "\r" in w:
                raise ValueError(
                    f"vocab word {w!r} contains a newline and cannot be "
                    "saved to the line-oriented words file"
                )
        os.makedirs(path, exist_ok=True)
        self.engine.save(os.path.join(path, "matrix"))
        atomic_write_text(
            os.path.join(path, "words.txt"),
            "".join(w + "\n" for w in self.vocab.words),
        )
        atomic_write_json(
            os.path.join(path, "params.json"),
            json.loads(self.params.to_json()),
        )

    @classmethod
    def load(cls, path: str, device: DeviceLike = None) -> "Word2VecModel":
        """Rebuild from a model directory saved by either package."""
        from glint_word2vec_torch.parallel.engine import EmbeddingEngine

        with open(os.path.join(path, "params.json")) as f:
            try:
                params = Word2VecParams.from_json(f.read())
            except TypeError as e:
                raise ValueError(
                    f"params.json at {path} does not describe a "
                    f"Word2VecParams model: {e}"
                )
        engine = EmbeddingEngine.load(os.path.join(path, "matrix"), device)
        vocab = saved_model_vocabulary(
            path, engine._counts,
            engine.vocab_size + engine.extra_rows_assigned,
        )
        return cls(vocab, engine, params)

    def stop(self) -> None:
        """Release the tables' device memory."""
        self.engine.destroy()


class LocalWord2VecModel:
    """Host-only numpy model: the ``to_local`` result. Same query surface,
    no device."""

    def __init__(self, words: List[str], vectors: np.ndarray):
        if vectors.shape[0] != len(words):
            raise ValueError("words/vectors length mismatch")
        self.words = words
        self.vectors = vectors.astype(np.float32)
        self.word_index = {w: i for i, w in enumerate(words)}
        self._norms = np.linalg.norm(self.vectors, axis=1)

    @property
    def vector_size(self) -> int:
        return self.vectors.shape[1]

    def transform(self, word: str) -> np.ndarray:
        idx = self.word_index.get(word)
        if idx is None:
            raise KeyError(f"word {word!r} not in vocabulary")
        return self.vectors[idx]

    def find_synonyms_vector(self, vector, num: int) -> List[Tuple[str, float]]:
        v = np.asarray(vector, np.float32)
        nv = np.linalg.norm(v)
        if nv > 0:
            v = v / nv
        safe = np.where(self._norms > 0, self._norms, 1.0)
        cos = np.where(self._norms > 0, (self.vectors @ v) / safe, 0.0)
        top = np.argsort(-cos)[:num]
        return [(self.words[i], float(cos[i])) for i in top]

    def find_synonyms(self, word: str, num: int) -> List[Tuple[str, float]]:
        res = self.find_synonyms_vector(self.transform(word), num + 1)
        return [(w, s) for w, s in res if w != word][:num]

    def get_vectors(self) -> Dict[str, np.ndarray]:
        return {w: self.vectors[i] for i, w in enumerate(self.words)}

    def save(self, path: str) -> None:
        """``vectors.npy`` and ``words.txt``, each through
        write-temp-then-rename."""
        os.makedirs(path, exist_ok=True)
        atomic_write_npy(os.path.join(path, "vectors.npy"), self.vectors)
        atomic_write_text(
            os.path.join(path, "words.txt"),
            "".join(w + "\n" for w in self.words),
        )

    @classmethod
    def load(cls, path: str) -> "LocalWord2VecModel":
        vectors = np.load(os.path.join(path, "vectors.npy"))
        with open(os.path.join(path, "words.txt"), encoding="utf-8") as f:
            words = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        return cls(words, vectors)
