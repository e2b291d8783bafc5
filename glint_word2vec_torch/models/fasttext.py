"""The fastText family of the port (counterpart of
``glint_word2vec_tpu/models/fasttext.py``).

The tables grow by ``bucket`` rows of character n-grams after the
vocabulary (``corpus/subword.py``). A center word trains as the mean of
its subword group's rows, through the host batcher and the engine's
composed step (``EmbeddingEngine.train_steps_grouped``), and every word
vector, out-of-vocabulary words included, is composed on the device with
``pull_average`` over the group. Similarity queries run against a second
engine whose syn0 holds the composed vectors of the vocabulary.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from glint_word2vec_torch.corpus.batching import BatchGroup
from glint_word2vec_torch.corpus.subword import build_subword_table, subword_group
from glint_word2vec_torch.corpus.vocab import Vocabulary
from glint_word2vec_torch.device import DeviceLike
from glint_word2vec_torch.obs import events as obs_events
from glint_word2vec_torch.models.word2vec import (
    MAX_QUERY_ROWS,
    LocalWord2VecModel,
    Word2Vec,
    Word2VecModel,
)
from glint_word2vec_torch.utils.params import Word2VecParams, _require


@dataclass
class FastTextParams(Word2VecParams):
    """Word2Vec params plus the subword geometry (fastText's defaults:
    ``-minn 3 -maxn 6 -bucket 2000000``)."""

    min_n: int = 3
    max_n: int = 6
    bucket: int = 2_000_000
    max_subwords: int = 32

    def validate(self) -> None:
        super().validate()
        _require(0 < self.min_n <= self.max_n, "need 0 < min_n <= max_n")
        _require(self.bucket > 0, "bucket must be > 0")
        _require(self.max_subwords >= 2, "max_subwords must be >= 2")


class FastTextWord2Vec(Word2Vec):
    """Subword SGNS estimator: the :class:`Word2Vec` surface plus the
    subword setters. ``fit`` and ``fit_file`` share the word-level host
    batcher loop (LR anneal, metrics, checkpoint and resume) through the
    family hooks; the centers expand to their subword groups on the
    host."""

    def __init__(self, params: Optional[FastTextParams] = None,
                 device: DeviceLike = None, obs=None, mesh=None, **overrides):
        super().__init__(params or FastTextParams(), device=device, obs=obs,
                         mesh=mesh, **overrides)
        if not isinstance(self.params, FastTextParams):
            raise TypeError("FastTextWord2Vec requires FastTextParams")
        self._sub_ids: Optional[np.ndarray] = None
        self._sub_mask: Optional[np.ndarray] = None

    def set_min_n(self, v: int) -> "FastTextWord2Vec":
        return self._set(min_n=v)

    def set_max_n(self, v: int) -> "FastTextWord2Vec":
        return self._set(max_n=v)

    def set_bucket(self, v: int) -> "FastTextWord2Vec":
        return self._set(bucket=v)

    def set_max_subwords(self, v: int) -> "FastTextWord2Vec":
        return self._set(max_subwords=v)

    # Family hooks -----------------------------------------------------

    def _device_corpus_eligible(self, corpus_words: int = 0) -> bool:
        # Subword centers need the host-side group expansion of
        # _train_batches; the packed path assembles word centers only.
        return False

    def _make_engine(self, vocab: Vocabulary, mesh=None):
        from glint_word2vec_torch.parallel.engine import EmbeddingEngine

        p = self.params
        self._sub_ids, self._sub_mask = build_subword_table(
            vocab.words, vocab.size, p.bucket, p.min_n, p.max_n, p.max_subwords
        )
        return EmbeddingEngine(
            vocab.size, p.vector_size, vocab.counts,
            num_negatives=p.num_negatives,
            unigram_power=p.unigram_power,
            unigram_table_size=p.unigram_table_size,
            seed=p.seed,
            dtype=p.dtype,
            extra_rows=p.bucket,
            shared_negatives=p.shared_negatives,
            compute_dtype=p.compute_dtype,
            device=None if mesh is not None else self.device,
            mesh=mesh,
            layout=p.layout,
        )

    def _train_batches(self, engine, group: BatchGroup, base_key: int,
                       step0: int, alphas: np.ndarray):
        # Padded batch rows (center 0) carry zero context masks, so their
        # group updates are zeroed by the gradient coefficients. The
        # expansion is this family's own host phase inside the loop's
        # device_steps span.
        with obs_events.span("subword_expand", step0=step0):
            groups = self._sub_ids[group.centers]
            gmask = self._sub_mask[group.centers]
        return engine.train_steps_grouped(
            groups, gmask, group.contexts, group.mask, base_key, alphas, step0,
        )

    def _make_model(self, vocab: Vocabulary, engine) -> "FastTextModel":
        return FastTextModel(
            vocab, engine, self.params, self._sub_ids, self._sub_mask
        )


class FastTextModel(Word2VecModel):
    """Fitted subword model: every word vector, in the vocabulary or not,
    is the mean of its subword group's rows, composed on the device."""

    #: Rows of one composition call: every call pads to this block, so
    #: the device sees one ``(COMPOSE_BLOCK, max_subwords)`` shape.
    COMPOSE_BLOCK = 4096

    def __init__(self, vocab, engine, params: FastTextParams, sub_ids,
                 sub_mask):
        super().__init__(vocab, engine, params)
        self._sub_ids = sub_ids
        self._sub_mask = sub_mask
        self._qeng = None

    # -- composition ---------------------------------------------------

    def _compose(self, groups: np.ndarray, gmask: np.ndarray) -> np.ndarray:
        """Compose any number of rows, ``COMPOSE_BLOCK`` at a time (each
        block padded with row 0 and mask 0, sliced off after)."""
        n = groups.shape[0]
        B = self.COMPOSE_BLOCK
        out = np.empty((n, self.vector_size), np.float32)
        for s in range(0, n, B):
            e = min(s + B, n)
            g, m = groups[s:e], gmask[s:e]
            if e - s < B:
                pad = B - (e - s)
                g = np.pad(g, ((0, pad), (0, 0)))
                m = np.pad(m, ((0, pad), (0, 0)))
            out[s:e] = self.engine.pull_average(g, m).cpu().numpy()[: e - s]
        return out

    def _oov_group(self, word: str) -> Tuple[np.ndarray, np.ndarray]:
        p: FastTextParams = self.params
        ids = subword_group(
            word, None, self.vocab.size, p.bucket, p.min_n, p.max_n,
            p.max_subwords,
        )
        if not ids:
            raise KeyError(
                f"word {word!r} is OOV and too short for any "
                f"[{p.min_n},{p.max_n}]-gram"
            )
        g = np.zeros((1, p.max_subwords), np.int32)
        m = np.zeros((1, p.max_subwords), np.float32)
        g[0, : len(ids)] = ids
        m[0, : len(ids)] = 1.0
        return g, m

    def transform(self, word: str) -> np.ndarray:
        """Word -> composed vector. An out-of-vocabulary word composes
        from its n-gram rows; one too short for any n-gram raises
        KeyError."""
        idx = self.vocab.word_index.get(word)
        if idx is not None:
            g, m = self._sub_ids[idx : idx + 1], self._sub_mask[idx : idx + 1]
        else:
            g, m = self._oov_group(word)
        return self._compose(g, m)[0]

    def transform_words(self, words: Sequence[str]) -> np.ndarray:
        """Composed vectors of vocabulary words (OOV raises KeyError)."""
        out = np.empty((len(words), self.vector_size), np.float32)
        for s in range(0, len(words), MAX_QUERY_ROWS):
            chunk = words[s : s + MAX_QUERY_ROWS]
            idx = self.vocab.encode_strict(chunk)
            out[s : s + len(chunk)] = self._compose(
                self._sub_ids[idx], self._sub_mask[idx]
            )
        return out

    def _segment_means(self, flat: np.ndarray, lens) -> np.ndarray:
        """Mean of the composed vectors of ``flat`` over consecutive
        segments of ``lens`` words (a zero row for an empty segment)."""
        out = np.zeros((len(lens), self.vector_size), np.float32)
        if flat.size == 0:
            return out
        vecs = self._compose(self._sub_ids[flat], self._sub_mask[flat])
        pos = 0
        for i, n in enumerate(lens):
            if n:
                out[i] = vecs[pos : pos + n].mean(axis=0)
                pos += n
        return out

    def transform_sentences(self, sentences) -> np.ndarray:
        """Mean of the composed word vectors of each sentence, OOV words
        dropped (empty or all-OOV sentences give zero vectors). Every word
        is composed in ``COMPOSE_BLOCK`` blocks, then averaged on the
        host."""
        encoded = [self.vocab.encode(s) for s in sentences]
        flat = (
            np.concatenate(encoded) if encoded else np.zeros(0, np.int32)
        ).astype(np.int32)
        return self._segment_means(flat, [e.size for e in encoded])

    def transform_packed(self, idx: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """:meth:`transform_sentences` of a packed ``(rows, len)`` word-id
        block with its mask (the bulk-transform form): the real tokens in
        row-major order, composed and averaged per row."""
        lens = mask.astype(bool).sum(axis=1)
        flat = idx[mask > 0.0].astype(np.int32)
        return self._segment_means(flat, [int(n) for n in lens])

    def bulk_warmup(self, rows: int, max_len: int) -> int:
        """The compose path dispatches only ``(COMPOSE_BLOCK,
        max_subwords)`` blocks whatever the producer's packing, so one
        shape warms the whole stream. Returns the shapes dispatched for
        the first time."""
        before = self.engine.query_compiles
        g = np.zeros((self.COMPOSE_BLOCK, self.params.max_subwords), np.int32)
        self.engine.pull_average(g, np.zeros(g.shape, np.float32))
        return self.engine.query_compiles - before

    # -- similarity over composed vectors ------------------------------

    def _query_engine(self):
        """A second engine whose syn0 holds the composed vector of every
        vocabulary word, assembled on the device block by block with
        ``write_rows``; built on first use, freed by :meth:`stop`."""
        if self._qeng is None:
            from glint_word2vec_torch.parallel.engine import EmbeddingEngine

            qeng = EmbeddingEngine(
                self.vocab.size, self.vector_size, self.vocab.counts,
                num_negatives=self.engine.num_negatives, seed=0,
                mesh=self.engine.mesh,
            )
            B = self.COMPOSE_BLOCK
            for s in range(0, self.vocab.size, B):
                e = min(s + B, self.vocab.size)
                qeng.write_rows(s, self.engine.pull_average(
                    self._sub_ids[s:e], self._sub_mask[s:e]
                ))
            self._qeng = qeng
        return self._qeng

    def to_local(self) -> LocalWord2VecModel:
        qeng = self._query_engine()
        vecs = np.empty((self.vocab.size, self.vector_size), np.float32)
        for s in range(0, self.vocab.size, MAX_QUERY_ROWS):
            idx = np.arange(s, min(s + MAX_QUERY_ROWS, self.vocab.size), dtype=np.int32)
            vecs[s : s + len(idx)] = qeng.pull(idx).cpu().numpy()
        return LocalWord2VecModel(list(self.vocab.words), vecs)

    def get_vectors(self):
        qeng = self._query_engine()
        for s in range(0, self.vocab.size, MAX_QUERY_ROWS):
            idx = np.arange(s, min(s + MAX_QUERY_ROWS, self.vocab.size), dtype=np.int32)
            rows = qeng.pull(idx).cpu().numpy()
            for i, r in zip(idx, rows):
                yield self.vocab.words[int(i)], r

    def stop(self) -> None:
        if self._qeng is not None:
            self._qeng.destroy()
            self._qeng = None
        super().stop()

    # -- persistence ---------------------------------------------------
    # save() is the word-level one: the bucket rows are the engine's extra
    # rows and params.json carries the subword geometry. load() is shared
    # too; the subword table is rebuilt from the words and the geometry.

    _PARAMS_CLS = FastTextParams

    @classmethod
    def _from_loaded(cls, vocab, engine, params) -> "FastTextModel":
        sub_ids, sub_mask = build_subword_table(
            vocab.words, vocab.size, params.bucket, params.min_n,
            params.max_n, params.max_subwords,
        )
        return cls(vocab, engine, params, sub_ids, sub_mask)
