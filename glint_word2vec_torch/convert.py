"""Build the port's engine and model from plain numpy arrays.

The on-disk model directory is the usual way a model moves between the
two packages. These helpers are the in-memory way: tables taken out of a
JAX engine as numpy arrays (``np.asarray(eng.syn0)[:num_rows]``, …) become
an engine or model of the port, with no file in between.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from glint_word2vec_torch.corpus.vocab import Vocabulary
from glint_word2vec_torch.device import DeviceLike
from glint_word2vec_torch.models.word2vec import Word2VecModel
from glint_word2vec_torch.parallel.engine import EmbeddingEngine
from glint_word2vec_torch.utils.params import Word2VecParams


def engine_from_arrays(
    syn0: np.ndarray, syn1: np.ndarray, counts: np.ndarray,
    *, device: DeviceLike = None, **meta,
) -> EmbeddingEngine:
    """An engine holding ``syn0``/``syn1`` (``(num_rows, dim)`` host arrays
    or tensors, rounded to the storage dtype). ``counts`` has one entry
    per vocabulary word; rows past it are extra rows. ``meta`` takes the
    engine's keyword arguments (``dtype``, ``num_negatives``, …)."""
    vocab_size = int(np.asarray(counts).shape[0])
    num_rows, dim = syn0.shape
    eng = EmbeddingEngine(
        vocab_size, dim, counts,
        extra_rows=num_rows - vocab_size, device=device, **meta,
    )
    eng.set_tables(syn0, syn1)
    return eng


def model_from_arrays(
    words: Sequence[str], syn0: np.ndarray, syn1: np.ndarray,
    counts: np.ndarray, params: Word2VecParams,
    *, device: DeviceLike = None,
) -> Word2VecModel:
    """A :class:`Word2VecModel` over the given words (most frequent first)
    and tables, with the storage dtype and noise geometry of ``params``."""
    vocab = Vocabulary.from_sorted(list(words), counts)
    eng = engine_from_arrays(
        syn0, syn1, vocab.counts, device=device,
        dtype=params.dtype,
        num_negatives=params.num_negatives,
        unigram_power=params.unigram_power,
        unigram_table_size=params.unigram_table_size,
        shared_negatives=params.shared_negatives,
        seed=params.seed,
    )
    return Word2VecModel(vocab, eng, params)
