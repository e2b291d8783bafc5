"""Build the port's engine and model from plain numpy arrays.

The on-disk model directory is the usual way a model moves between the
two packages. These helpers are the in-memory way: tables taken out of a
JAX engine as numpy arrays (``np.asarray(eng.syn0)[:num_rows]``, …) become
an engine or model of the port, with no file in between, and a JAX
package's ANN index becomes the port's (:func:`ann_index_from_arrays`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from glint_word2vec_torch.corpus.vocab import Vocabulary
from glint_word2vec_torch.device import DeviceLike
from glint_word2vec_torch.models.word2vec import Word2VecModel
from glint_word2vec_torch.ops.ann import AnnIndex
from glint_word2vec_torch.parallel.engine import EmbeddingEngine
from glint_word2vec_torch.utils.params import Word2VecParams


def engine_from_arrays(
    syn0: np.ndarray, syn1: np.ndarray, counts: np.ndarray,
    *, device: DeviceLike = None, mesh=None, layout: str = "rows", **meta,
) -> EmbeddingEngine:
    """An engine holding ``syn0``/``syn1`` (``(num_rows, dim)`` host arrays
    or tensors, rounded to the storage dtype), on one device or split over
    ``mesh`` in ``layout``. ``counts`` has one entry per vocabulary word;
    rows past it are extra rows. ``meta`` takes the engine's keyword
    arguments (``dtype``, ``num_negatives``, …)."""
    vocab_size = int(np.asarray(counts).shape[0])
    num_rows, dim = syn0.shape
    eng = EmbeddingEngine(
        vocab_size, dim, counts,
        extra_rows=num_rows - vocab_size, device=device, mesh=mesh,
        layout=layout, **meta,
    )
    eng.set_tables(syn0, syn1)
    return eng


def model_from_arrays(
    words: Sequence[str], syn0: np.ndarray, syn1: np.ndarray,
    counts: np.ndarray, params: Word2VecParams,
    *, device: DeviceLike = None, mesh=None, layout: str = "rows",
) -> Word2VecModel:
    """A :class:`Word2VecModel` over the given words (most frequent first)
    and tables, with the storage dtype and noise geometry of ``params``,
    on one device or over ``mesh`` in ``layout``."""
    vocab = Vocabulary.from_sorted(list(words), counts)
    eng = engine_from_arrays(
        syn0, syn1, vocab.counts, device=device, mesh=mesh, layout=layout,
        dtype=params.dtype,
        num_negatives=params.num_negatives,
        unigram_power=params.unigram_power,
        unigram_table_size=params.unigram_table_size,
        shared_negatives=params.shared_negatives,
        seed=params.seed,
    )
    return Word2VecModel(vocab, eng, params)


def ann_index_from_arrays(index, *, device: DeviceLike = None) -> AnnIndex:
    """The port's :class:`~glint_word2vec_torch.ops.ann.AnnIndex` holding
    the arrays of ``index``, an ANN index of either package (any object
    with the ``AnnIndex`` attributes, its device arrays readable by
    ``np.asarray``): the centroids, the ``(C, L)`` members and inverse
    norms and the ``(C, L, d)`` member blocks on ``device``, copies of the
    host masters, and the build's scalars."""
    from glint_word2vec_torch.device import resolve_device

    dev = resolve_device(device)
    C, L, d = int(index.clusters), int(index.slots), int(index.dim)
    blocks = np.asarray(index.member_rows)
    # A bf16 block layout crosses as fp32 (bf16 widens exactly) and is
    # rounded back, so the port keeps the table dtype.
    dtype = torch.bfloat16 if "bfloat16" in str(blocks.dtype) else torch.float32
    rows = torch.from_numpy(np.array(blocks[..., :d], np.float32))
    out = AnnIndex(
        clusters=C, slots=L, dim=d,
        centroids=torch.from_numpy(
            np.array(np.asarray(index.centroids)[:, :d], np.float32)).to(dev),
        members=None, member_invn=None,
        member_rows=rows.reshape(C, L, d).to(dev, dtype),
        members_np=np.array(index.members_np, np.int32),
        invn_np=np.array(index.invn_np, np.float32),
        fill=np.array(index.fill), cluster_of=np.array(index.cluster_of, np.int32),
        slot_of=np.array(index.slot_of, np.int32),
        table_version=int(index.table_version),
        build_seconds=float(index.build_seconds),
        built_rows=int(index.built_rows), sampled_rows=int(index.sampled_rows),
        spilled_rows=int(index.spilled_rows), iters=int(index.iters),
        updated_rows=int(index.updated_rows),
    )
    out._restage()
    return out
