"""The embedding engine of the port (counterpart of
``glint_word2vec_tpu/parallel/engine.py``).

It owns the two tables, ``syn0`` and ``syn1``, as ``[padded_vocab, dim]``
tensors on one device in fp32 or bf16 storage, and answers the query
surface the serving path needs: ``pull`` and ``pull_average`` through the
hand-written row gather (``ops/rows.py``), ``norms``, ``multiply`` and the
cosine top-k, whose matrix products and ``topk`` are plain torch calls, as
the JAX package leaves them to XLA. Every computation is in fp32 whatever
the storage dtype.

Training takes three routes, all updating the tables in place:

- the corpus-resident packed path: the flat corpus is uploaded once
  (:meth:`EmbeddingEngine.upload_corpus`), subsampled and compacted on
  the device once per epoch (:meth:`EmbeddingEngine.compact_corpus`),
  and :meth:`EmbeddingEngine.train_steps_corpus_packed` runs K steps of
  pair packing, negative draws and the fused pair step of
  ``ops/fused_sgns.py`` as a Python loop of launches, with one readback
  per K steps, which the caller may defer: the dispatch form takes its
  start position as a device scalar and returns its results on the
  device (:meth:`EmbeddingEngine.packed_readback` reads them), and the
  next epoch's compaction can be dispatched ahead
  (:meth:`EmbeddingEngine.prefetch_compact_corpus`);
- the corpus-resident grid path over the same corpus:
  :meth:`EmbeddingEngine.train_steps_corpus` assembles K grid batches on
  the device (``ops/device_batching.device_window_batch``) and runs the
  composed step below on each;
- the composed step of host batches (:meth:`EmbeddingEngine.
  train_steps_grouped`, the JAX engine's ``step_body_rows``,
  ``engine.py:643-758``): grid batches whose centers are groups of S rows
  (fastText subwords; S = 1 for words), gathered with ``gather_rows``,
  the SGNS gradients in PyTorch (``ops/sgns.sgns_grads``), and the
  updates through the ``scatter_add_rank1`` and ``scatter_add_rows``
  kernels of ``ops/rows.py``.

The engine also holds the ANN index of ``ops/ann.py`` (the JAX engine's
``configure_ann`` to ``ann_recall_at_k``): built from the live table or a
staged one, adopted as a value, searched by :meth:`EmbeddingEngine.
ann_top_k_batch`, and re-bucketed row by row on :meth:`EmbeddingEngine.
write_rows`. ``query_compiles`` counts the query shapes dispatched for the
first time, the counter the serving and bulk-transform warmups hold steady
state to.

Both routes also train the shared negative pool (``shared_negatives =
S > 0``): one pool of S negatives a step for the whole batch, through
``fused_pair_step_shared`` on the packed path and ``shared_sgns_grads``
(dense ``torch`` products) on the composed one.

The streaming trainer's hooks (``engine.py:1558-2270`` of the JAX
package): :meth:`EmbeddingEngine.upload_corpus` takes an ``n_valid``
prefix bound on a fixed-capacity buffer, :meth:`EmbeddingEngine.
assign_extra_rows` and :meth:`EmbeddingEngine.free_extra_rows` grow and
shrink the vocabulary on spare extra rows (which the packed path's
kernels train like any other row), and :meth:`EmbeddingEngine.
set_noise_counts` installs a new alias table from live counts.

The replica exchange's hooks (``engine.py:1910-2000, 2952-3030`` of the
JAX package): :meth:`EmbeddingEngine.exchange_adopt` installs the tables
a round rebuilt, :meth:`EmbeddingEngine.exchange_stats` holds the
round counters the heartbeat reads, :meth:`EmbeddingEngine.tables_digest`
hashes both tables, and :meth:`EmbeddingEngine.set_save_split` makes a
gang rank write only its own row block of a sharded save.

On a mesh (``parallel/mesh.py``; ``mesh=`` and ``layout=``) each table is
one tensor per model shard: a block of ``rows_per_shard`` rows (``rows``)
or a contiguous slice of ``cols_per_shard`` columns (``dims``). The data
ranks run their batch slices' forward passes in turn, the data-axis
gathers join what they ship, and every shard applies the batch's updates
it holds, each kernel launched shard by shard (``_mesh_step``,
``_mesh_pair_step``, ``engine.py:557-885`` of the JAX package); the queries
and the saves go by shard too. The 1 x 1 ``rows`` mesh, the default, runs
the single-device code above. In a gang with ``exchange="none"`` the
data axis also crosses processes (:meth:`EmbeddingEngine._gang_exchange`).

Checkpoints use the JAX package's on-disk layout (``engine.json``,
``counts.npy``, ``.npy`` table blocks, ``manifest.json`` and the per-shard
sidecars), so either package loads what the other saved. A save is a
snapshot of the tables to host arrays, then a write of those arrays;
:meth:`EmbeddingEngine.save_async` stalls its caller for the snapshot
alone and hands the write and the commit to one writer thread
(``utils/async_ckpt.py``). Loading reads
every form the JAX package writes: ``single`` files, ``sharded`` row blocks
``r…`` and ``dims`` column blocks ``c…``.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from glint_word2vec_torch.corpus.alias import build_unigram_alias
from glint_word2vec_torch.corpus.batching import context_width
from glint_word2vec_torch.device import DeviceLike, resolve_device
from glint_word2vec_torch.obs import events as obs_events
from glint_word2vec_torch.ops import device_batching as dbat
from glint_word2vec_torch.ops import random as rnd
from glint_word2vec_torch.ops.fused_sgns import (
    fused_pair_step,
    fused_pair_step_shared,
)
from glint_word2vec_torch.ops.rows import (
    gather_rows,
    scatter_add_rank1,
    scatter_add_rows,
)
from glint_word2vec_torch.ops.sampling import (
    sample_negatives,
    sample_negatives_per_row,
)
from glint_word2vec_torch.ops.sgns import (
    _operand,
    init_tables,
    negative_mask,
    pool_collision_mask,
    sgns_coefs,
    sgns_d_center,
    sgns_grads,
    shared_sgns_coefs,
    shared_sgns_grads,
    shared_sgns_updates,
)
from glint_word2vec_torch.parallel import mesh as mesh_mod
from glint_word2vec_torch.utils import faults
from glint_word2vec_torch.utils import integrity, next_pow2

#: Floor of the top-k k-bucket family (``engine.py:259`` of the JAX
#: package): a request for k rows fetches ``max(next_pow2(k), 16)`` and
#: truncates, so every small k runs the same shapes.
TOPK_MIN_K_BUCKET = 16

#: Floor of the batched top-k Q-bucket family for Q > 1 (``engine.py:267``):
#: batches of 2..7 queries pad to 8 zero rows.
TOPK_MIN_Q_BUCKET = 8

#: Query rows a batched approximate top-k dispatches at once
#: (``engine.py:273``): larger batches run in chunks of 16.
ANN_MAX_Q = 16

#: Rows a table block moves between host and device at a time, so loading
#: or saving a large table never holds more than one such slice in fp32 on
#: the host besides the memory-mapped file.
_IO_ROWS = 1 << 20

#: Bytes a slice of a table file moves to the device at a time when the
#: tables are staged: two host buffers of this size alternate.
_UPLOAD_BYTES = 64 << 20

#: Rows of a bf16 table upcast to fp32 at a time for the query products,
#: so a query never materialises a whole fp32 copy of the table.
_SCORE_ROWS = 1 << 20

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: Score budget of one Q chunk of a ``dims`` mesh's batched top-k: the
#: ``(Q, V)`` psum'd scores stay under 256 MB (``engine.py:2353-2360`` of
#: the JAX package).
_DIMS_SCORE_BYTES = 256 << 20


#: The replica exchange's counters (:meth:`EmbeddingEngine.exchange_stats`)
#: before any round: the heartbeat renders them as zeros on every fit.
_EXCHANGE_ZERO = {
    "exchange_bytes_total": 0, "exchange_rows_total": 0,
    "exchange_overflow_total": 0, "exchange_syncs_total": 0,
    "exchange_dense_syncs_total": 0, "exchange_last_seconds": 0.0,
    "exchange_bytes_wire_fp32_total": 0, "exchange_bytes_wire_bf16_total": 0,
    "exchange_bytes_wire_int8_total": 0, "exchange_groups_total": 0,
    "exchange_flushes_total": 0, "exchange_world1_skips_total": 0,
    "exchange_intra_bytes_total": 0, "exchange_inter_bytes_total": 0,
    "exchange_capacity": None, "exchange_capacity_grows_total": 0,
    "exchange_capacity_shrinks_total": 0, "exchange_residual_abs": 0.0,
}


#: Every (geometry, op, shape) key a query of this process dispatched, and
#: how many distinct ones there are (``engine.py:231-251`` of the JAX
#: package). The JAX engines share one compiled program per key; here a
#: key's first dispatch in the process is its "build", and a later engine
#: of the same geometry dispatching it counts a shared hit instead
#: (``shared_program_hits``). A second model of the same shape adds no
#: builds.
_QUERY_SHAPES_SEEN: set = set()
_QUERY_PROGRAM_BUILDS = [0]


def query_program_builds() -> int:
    """Distinct query (geometry, op, shape) keys this process has
    dispatched: flat while a same-shape engine warms the family again."""
    return _QUERY_PROGRAM_BUILDS[0]


def _dup_sum_f32(idx: torch.Tensor, upd: torch.Tensor):
    """Collapse duplicate target rows to one fp32-summed update per run
    of equal ids, the other slots of the run carrying exact zeros
    (``engine.py:118-148`` of the JAX package), so that a bf16 table
    scatter rounds each row's batch total once. Sorted-run form: a stable
    sort, an fp32 inclusive cumsum over the sorted updates, and each run's
    total as the cumsum at its end minus the cumsum just before its start.
    Returns ``(sorted ids, summed updates)``."""
    sid, order = torch.sort(idx, stable=True)
    su = upd[order].float()
    cum = torch.cumsum(su, dim=0)
    change = sid[1:] != sid[:-1]
    one = torch.ones(1, dtype=torch.bool, device=idx.device)
    is_start = torch.cat([one, change])
    is_end = torch.cat([change, one])
    pos = torch.arange(idx.shape[0], dtype=torch.int64, device=idx.device)
    run_start = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    prev_cum = torch.where(
        (run_start > 0)[:, None], cum[(run_start - 1).clamp(min=0)], 0.0
    )
    return sid.contiguous(), torch.where(is_end[:, None], cum - prev_cum, 0.0)


def _scatter_rows(table: torch.Tensor, idx: torch.Tensor,
                  upd: torch.Tensor) -> None:
    """``table[idx] += upd`` in place through ``scatter_add_rows``, whose
    runs sum in the table's dtype; under bf16 storage the duplicates are
    pre-summed in fp32 first (:func:`_dup_sum_f32`), as the JAX engine's
    ``_scatter_rows`` does (``engine.py:162-183``). Every id is a row of
    the one device's table: no ownership masking."""
    if table.dtype != torch.float32:
        idx, upd = _dup_sum_f32(idx, upd)
    scatter_add_rows(table, idx.contiguous(), upd.contiguous())


def _rank1_payload(c_pos: torch.Tensor, c_neg: torch.Tensor, C: int, n: int):
    """``(coefs, hidx)`` of the rank-1 syn1 updates, in the order of the
    update ids ``[contexts.flat | negs.flat]`` (``engine.py:276-287``)."""
    B = c_pos.shape[0]
    rows = torch.arange(B, dtype=torch.int32, device=c_pos.device)
    coefs = torch.cat([c_pos.reshape(-1), c_neg.reshape(-1)])
    hidx = torch.cat([rows.repeat_interleave(C), rows.repeat_interleave(C * n)])
    return coefs.contiguous(), hidx


def _rank1_dense_payload(c_pos: torch.Tensor, c_neg: torch.Tensor,
                         h: torch.Tensor) -> torch.Tensor:
    """The ``(N, d)`` fp32 rows ``coef * h[hidx]`` of the rank-1 syn1
    updates, in the order of :func:`_rank1_payload`."""
    d = h.shape[-1]
    d_upos = c_pos[..., None] * h[:, None, :]
    d_uneg = c_neg[..., None] * h[:, None, None, :]
    return torch.cat([d_upos.reshape(-1, d), d_uneg.reshape(-1, d)])


def _apply_rank1_updates(syn1: torch.Tensor, ids1: torch.Tensor,
                         c_pos: torch.Tensor, c_neg: torch.Tensor,
                         h: torch.Tensor, C: int, n: int):
    """The syn1 update of the composed step (``engine.py:290-331``). An
    fp32 table takes ``scatter_add_rank1`` and returns None: the update is
    applied. Under bf16 storage it returns the ``(N, d)`` fp32 payload for
    :func:`_scatter_rows`, whose fp32 pre-sum rounds each row's total
    once, as the JAX engine does. The JAX gate's other condition, that
    ``h`` fit 10 MB of TPU VMEM, has no counterpart: the kernel reads
    ``h`` from device memory."""
    if syn1.dtype == torch.float32:
        coefs, hidx = _rank1_payload(c_pos, c_neg, C, n)
        scatter_add_rank1(syn1, ids1, coefs, h, hidx)
        return None
    return _rank1_dense_payload(c_pos, c_neg, h)


class DeferredReadback(NamedTuple):
    """A device result whose readback is deferred: ``out`` on the device,
    ``host``, the pinned host tensor a copy enqueued right behind the work
    that made ``out`` fills, and ``ready``, the CUDA event recorded after
    that copy (None on the CPU, where ``host`` is ``out``).
    :meth:`wait` waits for that work alone, not for work queued after it,
    as a ``.cpu()`` on the same stream would."""

    out: torch.Tensor
    host: torch.Tensor
    ready: Optional["torch.cuda.Event"]

    def wait(self) -> np.ndarray:
        if self.ready is not None:
            self.ready.synchronize()
        return self.host.numpy()


def deferred_readback(out: torch.Tensor) -> DeferredReadback:
    """Enqueue the copy of ``out`` to host memory behind the work queued
    so far, without waiting for it."""
    if out.device.type != "cuda":
        return DeferredReadback(out, out, None)
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return DeferredReadback(out, host, ready)


def _fsync_dir(dirpath: str) -> None:
    """Make renames inside ``dirpath`` durable; best-effort (some
    filesystems refuse directory fsync)."""
    try:
        dfd = os.open(dirpath, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


class EmbeddingEngine:
    """Owns ``syn0``/``syn1`` on one device and all queries against them.

    Args:
      vocab_size: unpadded vocabulary size.
      dim: embedding dimension.
      counts: per-word corpus counts, shape ``(vocab_size,)``; saved with
        the tables (training's noise distribution is built from them).
      num_negatives / unigram_power / unigram_table_size /
        shared_negatives: noise geometry, carried into ``engine.json``.
      seed: seed of the ``torch.Generator`` that draws the initial syn0.
      dtype: table storage dtype, ``"float32"`` or ``"bfloat16"``.
      extra_rows: non-vocabulary rows after the vocabulary (masked from
        every similarity query unless assigned): fastText's n-gram
        buckets, or the streaming trainer's spare rows for promoted
        words.
      compute_dtype: operand dtype of the composed step's contractions,
        ``"float32"`` (None) or ``"bfloat16"`` (fp32 accumulation either
        way); the fused pair step always computes in fp32.
      device: ``None`` for the CUDA card (raises without one), ``"cpu"``
        or ``"cuda[:n]"``.
    """

    def __init__(
        self,
        vocab_size: int,
        dim: int,
        counts: np.ndarray,
        *,
        num_negatives: int = 5,
        unigram_power: float = 0.75,
        unigram_table_size: Optional[int] = None,
        seed: int = 1,
        dtype: str = "float32",
        extra_rows: int = 0,
        shared_negatives: int = 0,
        compute_dtype: Optional[str] = None,
        device: DeviceLike = None,
        mesh: Optional[mesh_mod.Mesh] = None,
        layout: str = "rows",
    ):
        if vocab_size <= 0 or dim <= 0:
            raise ValueError("vocab_size and dim must be > 0")
        counts = np.asarray(counts)
        if counts.shape != (vocab_size,):
            raise ValueError("counts must have shape (vocab_size,)")
        if extra_rows < 0:
            raise ValueError("extra_rows must be >= 0")
        if dtype not in _DTYPES:
            raise ValueError("dtype must be float32|bfloat16")
        if compute_dtype not in (None, "float32", "bfloat16"):
            raise ValueError("compute_dtype must be float32|bfloat16")
        if layout not in ("rows", "dims"):
            raise ValueError("layout must be 'rows' or 'dims'")
        self.compute_dtype = compute_dtype or "float32"
        if mesh is None:
            self.device = resolve_device(device)
            mesh = mesh_mod.Mesh([[self.device]])
        else:
            for dev in {d for row in mesh.devices for d in row}:
                resolve_device(dev)
            self.device = resolve_device(mesh.devices[0][0])
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(
                    f"device {device!r} is not the mesh's first device "
                    f"{self.device}"
                )
        #: The ("data", "model") device grid (``parallel/mesh.py``); a
        #: 1 x 1 grid of ``device`` by default.
        self.mesh = mesh
        self.num_data = mesh.shape[mesh_mod.DATA_AXIS]
        self.num_model = mesh.shape[mesh_mod.MODEL_AXIS]
        self.layout = layout
        self.vocab_size = int(vocab_size)
        self.num_rows = int(vocab_size) + int(extra_rows)
        self.dim = int(dim)
        self.num_negatives = int(num_negatives)
        self.unigram_power = float(unigram_power)
        self.unigram_table_size = unigram_table_size
        self.shared_negatives = int(shared_negatives)
        #: Seed of the initial tables, and of the ANN index's k-means
        #: sample and recall queries.
        self._seed = int(seed)
        self.dtype = dtype
        self._dtype = _DTYPES[dtype]
        # The model-axis geometry (``engine.py:462-472`` of the JAX
        # package): rows padded to a multiple of the shards (``rows``), or
        # columns (``dims``; ``padded_dim`` is that column padding).
        if layout == "rows":
            self.padded_vocab = mesh_mod.pad_to_multiple(
                self.num_rows, self.num_model)
            self.rows_per_shard = self.padded_vocab // self.num_model
            self.padded_dim = self.cols_per_shard = self.dim
        else:
            self.padded_vocab = self.rows_per_shard = self.num_rows
            self.padded_dim = mesh_mod.pad_to_multiple(self.dim, self.num_model)
            self.cols_per_shard = self.padded_dim // self.num_model
        #: False for the 1 x 1 ``rows`` engine, which runs the single-device
        #: code; True on any other mesh or layout.
        self._meshed = layout == "dims" or mesh.size > 1
        #: Data ranks this process runs; in a gang the data axis also
        #: crosses processes (:meth:`_gang_exchange`).
        self._local_data = len(mesh.devices)
        self._counts = counts.astype(np.int64).copy()
        #: Extra rows assigned to words (streaming growth); they are
        #: queryable, the rest of the extra rows are not.
        self.extra_rows_assigned = 0
        self._norms_cache: Optional[torch.Tensor] = None
        #: Ticks on every table mutation: the token the serving result
        #: cache validates against.
        self.table_version = 0
        #: Query shapes dispatched for the first time (the JAX engine's
        #: jit-compile count, ``engine.py:2003``): what a warmup must cover
        #: so that steady state adds none.
        self.query_compiles = 0
        self._query_shapes: set = set()
        #: First dispatches of a query shape that a same-geometry engine of
        #: this process had already dispatched (:func:`query_program_builds`).
        self.shared_program_hits = 0
        #: The adopted ANN index (None keeps every query exact) and its
        #: geometry (:meth:`configure_ann`).
        self._ann = None
        self._ann_conf: Optional[dict] = None
        # One tensor per model shard and table (None once released). The
        # initial tables are drawn whole, then padded and split, so they
        # are the same for every mesh shape and layout.
        self._shards: list = [None, None]
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.syn0, self.syn1 = init_tables(
            gen, self.num_rows, self.dim, self._dtype, self.device
        )
        # Training state: the noise tables are built on first use (serving
        # never needs them), the corpus by upload_corpus.
        self._noise = None
        self._corpus = None
        #: Live center positions of the uploaded corpus: a prefix bound
        #: (the streaming trainer's fill), or its length.
        self._corpus_n_valid = None
        self._corpus_compacted = None
        self._n_kept = None
        self._compacted_offsets_host = None
        self._keep_prob = None
        #: The next epoch's compaction dispatched ahead: ``(epoch_key,
        #: ids_c, offsets_c, n_kept)`` on the device, or None.
        self._compact_prefetch = None
        # Checkpoint writer and its telemetry (checkpoint_stats).
        self._ckpt_writer = None
        self._ckpt_forced_sync = 0
        self._ckpt_last_write_s: Optional[float] = None
        self._ckpt_last_commit: Optional[float] = None
        self._ckpt_shard_write_s: Optional[float] = None
        #: Replica save split ``(rank, world)`` (:meth:`set_save_split`).
        self._save_split: Optional[Tuple[int, int]] = None
        self._exchange_stats = dict(_EXCHANGE_ZERO)
        # Skip-clean in-place saves (``engine.py:1923-1966`` of the JAX
        # package): the shard files the last committed save to
        # ``_shard_clean_path`` holds current bytes for (None: all dirty).
        self._shard_dirty: Optional[dict] = None
        self._shard_clean_path: Optional[str] = None
        self._ckpt_shards_skipped = 0
        self._ckpt_peak_block_bytes = 0
        self._ckpt_shard_verify_s: Optional[float] = None
        self._stage_peak_block_bytes = 0

    # ------------------------------------------------------------------
    # Bookkeeping
    # ------------------------------------------------------------------

    @property
    def cols(self) -> int:
        """Column count == vector size."""
        return self.dim

    @property
    def syn0(self) -> Optional[torch.Tensor]:
        """The input table's live tensor, on a mesh whose model axis is 1;
        raises on a table split over model shards, which has no one live
        tensor (:meth:`logical_table` copies it whole, :meth:`shard_tables`
        gives the shards). Assigning a table of ``num_rows`` rows or more
        pads and splits it."""
        return self._live(0)

    @syn0.setter
    def syn0(self, table: Optional[torch.Tensor]) -> None:
        self._shards[0] = self._split(table)

    @property
    def syn1(self) -> Optional[torch.Tensor]:
        """The output table, as :attr:`syn0`."""
        return self._live(1)

    @syn1.setter
    def syn1(self, table: Optional[torch.Tensor]) -> None:
        self._shards[1] = self._split(table)

    def _live(self, i: int) -> Optional[torch.Tensor]:
        sh = self._shards[i]
        if sh is None:
            return None
        if len(sh) > 1:
            name = ("syn0", "syn1")[i]
            raise RuntimeError(
                f"{name} is split over {len(sh)} model shards: read it with "
                f"logical_table({i}) (a copy) or shard_tables({i})")
        return sh[0]

    def logical_table(self, i: int) -> Optional[torch.Tensor]:
        """Table ``i`` (0: syn0, 1: syn1) whole, ``(padded_vocab,
        padded_dim)`` on the engine's device: the live tensor on one model
        shard, else a new tensor assembled from the shards (writes to it
        reach no shard)."""
        sh = self._shards[i]
        if sh is None:
            return None
        if len(sh) == 1:
            return sh[0]
        return mesh_mod.all_gather(
            sh, dim=0 if self.layout == "rows" else 1, device=self.device)

    def shard_tables(self, i: int) -> list:
        """The live tensors of table ``i``, one per model shard in shard
        order: row blocks (``rows``) or column slices (``dims``)."""
        return list(self._shards[i] or [])

    def _split(self, table: Optional[torch.Tensor]) -> Optional[list]:
        """The per-shard tensors of a logical table: row blocks of
        ``rows_per_shard`` (``rows``) or contiguous column slices of
        ``cols_per_shard`` (``dims``), each on its shard's device, the
        padding zero."""
        if table is None:
            return None
        if self.num_model == 1 and table.shape[0] >= self.padded_vocab:
            return [table]
        pr = self.padded_vocab - table.shape[0]
        pc = self.padded_dim - table.shape[1]
        if pr > 0 or pc > 0:
            table = torch.nn.functional.pad(table, (0, max(pc, 0), 0, max(pr, 0)))
        out = []
        for m, dev in enumerate(self.mesh.model_devices):
            if self.layout == "rows":
                part = table[m * self.rows_per_shard:(m + 1) * self.rows_per_shard]
            else:
                c = self.cols_per_shard
                part = table[:self.padded_vocab, m * c:(m + 1) * c]
            out.append(part.to(dev).contiguous())
        return out

    def _shard_range(self, m: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        """``((row0, row1), (col0, col1))`` of shard ``m`` in the logical
        table, padding included."""
        if self.layout == "rows":
            r0 = m * self.rows_per_shard
            return (r0, r0 + self.rows_per_shard), (0, self.dim)
        c0 = m * self.cols_per_shard
        return (0, self.num_rows), (c0, c0 + self.cols_per_shard)

    @property
    def queryable_rows(self) -> int:
        """Rows the similarity ops may surface: the vocabulary plus every
        assigned extra row."""
        return self.vocab_size + self.extra_rows_assigned

    def _tick_tables(self, reason: str) -> None:
        """One table mutation: drop the norms cache, tick
        ``table_version`` and record the ``table_mutation`` event (one
        global read when no recorder is installed)."""
        self._norms_cache = None
        self.table_version += 1
        if reason != "exchange_adopt":
            # A mutation whose touched rows are unknown dirties every
            # shard file of the skip-clean save.
            self._shard_dirty = None
        obs_events.emit("table_mutation", reason=reason,
                        version=self.table_version)

    def _count_query_shape(self, *key) -> None:
        """Record one query dispatch shape; a first-seen shape ticks
        ``query_compiles``, then the process-level count: a build if no
        engine of this geometry dispatched it before, else a shared hit.
        Records the ``query_compile`` event."""
        if key not in self._query_shapes:
            self._query_shapes.add(key)
            self.query_compiles += 1
            pkey = (self.padded_vocab, self.dim, str(self._dtype),
                    self.device.type, self.num_data, self.num_model,
                    self.layout) + key
            shared = pkey in _QUERY_SHAPES_SEEN
            if shared:
                self.shared_program_hits += 1
            else:
                _QUERY_SHAPES_SEEN.add(pkey)
                _QUERY_PROGRAM_BUILDS[0] += 1
            obs_events.emit("query_compile", op=str(key[0]),
                            shape=list(key[1:]), total=self.query_compiles,
                            shared=shared)

    def _k_bucket(self, k: int) -> int:
        return min(max(next_pow2(k), TOPK_MIN_K_BUCKET), self.padded_vocab)

    def _q_bucket(self, n: int) -> int:
        return 1 if n <= 1 else max(next_pow2(n), TOPK_MIN_Q_BUCKET)

    def _ids(self, indices) -> torch.Tensor:
        return torch.as_tensor(
            np.asarray(indices, dtype=np.int32)
        ).to(self.device)

    # ------------------------------------------------------------------
    # Queries
    # ------------------------------------------------------------------

    def _pull_rows(self, idx: torch.Tensor,
                   table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """fp32 rows of ``table`` (syn0 by default) for int32 ``idx`` on
        the engine's device: ids outside the table are clipped for the
        gather and their rows zeroed, as ``_pull_rows`` of the JAX engine
        does around its kernel."""
        if self._meshed and table is None:
            return self._mesh_pull(0, idx)
        table = self.syn0 if table is None else table
        own = (idx >= 0) & (idx < self.padded_vocab)
        clipped = idx.clamp(0, self.padded_vocab - 1).contiguous()
        rows = gather_rows(table, clipped)
        return torch.where(own[:, None], rows, 0.0)

    def _mesh_pull(self, i: int, idx: torch.Tensor) -> torch.Tensor:
        """fp32 rows of table ``i`` (0: syn0, 1: syn1) for int32 ``idx``
        on a mesh. ``rows``: each shard gathers every id clipped to its
        block (``gather_rows``), zeroes the rows it does not own, and the
        model axis sums the partials (``_pull_rows``, ``engine.py:95-115``
        of the JAX package). ``dims``: each shard gathers its column
        slice of every row, and the slices are joined."""
        shards = self._shards[i]
        if self.layout == "dims":
            parts = [gather_rows(t, idx.to(t.device).contiguous())
                     for t in shards]
            return mesh_mod.all_gather(parts, dim=1, device=self.device)[
                :, : self.dim]
        Vs = self.rows_per_shard
        parts = []
        for m, t in enumerate(shards):
            loc = idx.to(t.device) - m * Vs
            own = (loc >= 0) & (loc < Vs)
            rows = gather_rows(t, loc.clamp(0, Vs - 1).contiguous())
            parts.append(torch.where(own[:, None], rows, 0.0))
        return mesh_mod.psum(parts, self.device)

    def pull(self, indices) -> torch.Tensor:
        """syn0 rows by global index, ``(N, dim)`` fp32 on the device."""
        idx = self._ids(indices).reshape(-1)
        self._count_query_shape("pull", int(idx.shape[0]))
        return self._pull_rows(idx)

    def pull_average(self, sentence_indices, mask) -> torch.Tensor:
        """Masked mean of syn0 rows per row of a padded ``(S, L)`` index
        block: ``(S, dim)`` fp32. All-masked rows give zero vectors."""
        idx = self._ids(sentence_indices)
        if idx.dim() != 2:
            raise ValueError("sentence_indices must be (S, L)")
        m = torch.as_tensor(np.asarray(mask, dtype=np.float32)).to(self.device)
        S, L = idx.shape
        self._count_query_shape("pull_average", S, L)
        rows = self._pull_rows(idx.reshape(-1)).reshape(S, L, self.dim)
        rows = rows * m[..., None]
        return rows.sum(dim=1) / m.sum(dim=1)[:, None].clamp(min=1.0)

    @staticmethod
    def _norms(syn0: torch.Tensor) -> torch.Tensor:
        """Euclidean norm of every row of ``syn0`` (the live table or a
        staged one), fp32, ``_SCORE_ROWS`` rows at a time."""
        return torch.cat([
            syn0[s : s + _SCORE_ROWS].float().square().sum(dim=1)
            for s in range(0, syn0.shape[0], _SCORE_ROWS)
        ]).sqrt()

    def norms(self) -> torch.Tensor:
        """Euclidean norm of every syn0 row, ``(padded_vocab,)`` fp32,
        cached until the next table mutation. On a mesh each shard sums
        its own squares: ``rows`` joins the shards' norms, ``dims`` sums
        the column partials over the model axis first."""
        if self._norms_cache is None:
            if not self._meshed:
                self._norms_cache = self._norms(self.syn0)
            elif self.layout == "rows":
                self._norms_cache = mesh_mod.all_gather(
                    [self._norms(t) for t in self._shards[0]],
                    device=self.device)
            else:
                self._norms_cache = mesh_mod.psum([
                    torch.cat([t[s:s + _SCORE_ROWS].float().square().sum(dim=1)
                               for s in range(0, t.shape[0], _SCORE_ROWS)])
                    for t in self._shards[0]], self.device).sqrt()
        return self._norms_cache

    def _scores(self, q: torch.Tensor,
                syn0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``syn0 @ q.T`` in fp32 for a ``(Q, d)`` fp32 query block,
        ``(padded_vocab, Q)``; the live table unless ``syn0`` is given. A
        bf16 table is upcast one row slice at a time."""
        if syn0 is None and self._meshed:
            return self._mesh_scores(q)
        syn0 = self.syn0 if syn0 is None else syn0
        if syn0.dtype == torch.float32:
            return syn0 @ q.T
        return torch.cat([
            syn0[s : s + _SCORE_ROWS].float() @ q.T
            for s in range(0, syn0.shape[0], _SCORE_ROWS)
        ])

    def _mesh_scores(self, q: torch.Tensor) -> torch.Tensor:
        """``syn0 @ q.T`` on a mesh, ``(padded_vocab, Q)`` fp32: the
        shards' row blocks joined (``rows``), or the psum of each column
        slice's partial products (``dims``)."""
        if self.layout == "rows":
            return mesh_mod.all_gather(
                [self._scores(q.to(t.device), t) for t in self._shards[0]],
                device=self.device)
        c = self.cols_per_shard
        qp = torch.nn.functional.pad(q, (0, self.padded_dim - self.dim))
        return mesh_mod.psum(
            [self._scores(qp[:, m * c:(m + 1) * c].contiguous().to(t.device), t)
             for m, t in enumerate(self._shards[0])], self.device)

    def _mesh_topk(self, q: torch.Tensor, k_b: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The masked cosine top-``k_b`` of unit ``(Q, d)`` queries on a
        mesh (``engine.py:1210-1270`` of the JAX package). ``rows``: each
        shard ranks its own block (its masks offset by the block's first
        row), the model axis gathers the ``num_model * k`` candidates and
        they are ranked again, so a padded row never surfaces. ``dims``:
        the psum'd scores of Q chunks sized to ``_DIMS_SCORE_BYTES``,
        ranked whole."""
        inv, neg = self._mask_terms()
        if self.layout == "dims":
            Qc = max(1, _DIMS_SCORE_BYTES // (4 * self.padded_vocab))
            vals, idxs = [], []
            for s in range(0, q.shape[0], Qc):
                sc = self._mesh_scores(q[s:s + Qc]).T
                v, i = torch.topk(sc * inv[None, :] + neg[None, :],
                                  min(k_b, sc.shape[1]))
                vals.append(v)
                idxs.append(i)
            return torch.cat(vals), torch.cat(idxs)
        Vs = self.rows_per_shard
        kk = min(k_b, Vs)
        cand_v, cand_i = [], []
        for m, t in enumerate(self._shards[0]):
            sc = self._scores(q.to(t.device), t).T
            sl = slice(m * Vs, (m + 1) * Vs)
            v, i = torch.topk(sc * inv[sl].to(t.device)[None, :]
                              + neg[sl].to(t.device)[None, :], kk)
            cand_v.append(v)
            cand_i.append(i + m * Vs)
        cv = mesh_mod.all_gather(cand_v, dim=1, device=self.device)
        ci = mesh_mod.all_gather(cand_i, dim=1, device=self.device)
        mv, pos = torch.topk(cv, min(k_b, cv.shape[1]))
        return mv, torch.gather(ci, 1, pos)

    def multiply(self, vec) -> torch.Tensor:
        """``syn0 @ vec``, ``(padded_vocab,)`` fp32."""
        v = np.asarray(vec, dtype=np.float32)
        if v.shape != (self.dim,):
            raise ValueError(f"vec must have shape ({self.dim},)")
        return self._scores(torch.from_numpy(v).to(self.device)[None, :])[:, 0]

    def _mask_terms(self, norms: Optional[torch.Tensor] = None,
                    queryable: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(inv, neg) over every row: the reciprocal norm (0 where
        masked) and 0 or -inf, so a masked cosine is ``s * inv + neg``.
        Zero-norm rows and rows at or past ``queryable_rows`` are masked:
        only real words surface from similarity search. ``norms`` and
        ``queryable`` default to the live table's."""
        norms = self.norms() if norms is None else norms
        queryable = self.queryable_rows if queryable is None else int(queryable)
        ok = (norms > 0) & (
            torch.arange(norms.shape[0], device=self.device) < queryable
        )
        inv = torch.where(ok, 1.0 / torch.where(norms > 0, norms, 1.0), 0.0)
        neg = torch.where(ok, 0.0, float("-inf"))
        return inv, neg

    def top_k_cosine(self, vec, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k rows of syn0 by cosine similarity to ``vec``:
        ``(similarities, indices)`` as host arrays of length k."""
        if not 0 < k <= self.padded_vocab:
            raise ValueError(f"k must be in [1, {self.padded_vocab}]")
        v = np.asarray(vec, dtype=np.float32)
        nrm = float(np.linalg.norm(v))
        if nrm > 0:
            v = v / nrm
        k_b = self._k_bucket(k)
        self._count_query_shape("topk", k_b)
        if self._meshed:
            val, idx = self._mesh_topk(
                torch.from_numpy(v).to(self.device)[None, :], k_b)
            return val[0, :k].cpu().numpy(), idx[0, :k].cpu().numpy()
        scores = self._scores(torch.from_numpy(v).to(self.device)[None, :])[:, 0]
        inv, neg = self._mask_terms()
        val, idx = torch.topk(scores * inv + neg, k_b)
        return val[:k].cpu().numpy(), idx[:k].cpu().numpy()

    def top_k_cosine_batch(self, vecs, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Batched :meth:`top_k_cosine`: ``(Q, d)`` queries give ``(Q, k)``
        similarities and indices, one matrix product and one ``topk``."""
        if not 0 < k <= self.padded_vocab:
            raise ValueError(f"k must be in [1, {self.padded_vocab}]")
        q = np.asarray(vecs, dtype=np.float32)
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(f"vecs must have shape (Q, {self.dim})")
        nrm = np.linalg.norm(q, axis=1, keepdims=True)
        q = q / np.where(nrm > 0, nrm, 1.0)
        n = q.shape[0]
        if n == 0:
            empty = np.zeros((0, k))
            return empty.astype(np.float32), empty.astype(np.int64)
        # Pad Q to its bucket with zero rows (each query ranks on its own,
        # so padding never changes a real row's result).
        q_b = self._q_bucket(n)
        if q_b != n:
            q = np.concatenate([q, np.zeros((q_b - n, self.dim), np.float32)])
        k_b = self._k_bucket(k)
        self._count_query_shape("topk_batch", q_b, k_b)
        val, idx = self._exact_topk(torch.from_numpy(q).to(self.device), k_b)
        with obs_events.stage("topk_readback"):
            return val[:n, :k].cpu().numpy(), idx[:n, :k].cpu().numpy()

    def _exact_topk(self, q: torch.Tensor, k_b: int, syn0=None, norms=None,
                    queryable=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The masked cosine top-``k_b`` of unit ``(Q, d)`` queries over the
        live table, or over ``syn0``/``norms``/``queryable`` (a staged
        generation's): one matrix product and one ``topk``, on the
        device."""
        if syn0 is None and self._meshed:
            return self._mesh_topk(q, k_b)
        with obs_events.stage("topk_scores", device=self.device):
            scores = self._scores(q, syn0).T
        with obs_events.stage("topk_select", device=self.device):
            inv, neg = self._mask_terms(norms, queryable)
            return torch.topk(scores * inv[None, :] + neg[None, :], k_b)

    def warmup(
        self,
        q_buckets=(1, 2, 4, 8, 16, 32, 64),
        k_buckets=(TOPK_MIN_K_BUCKET,),
        *,
        sentence_lens=(),
        sentence_rows=(1,),
    ) -> int:
        """Run every query shape the serving path dispatches once, so the
        first real request pays no kernel build, library load or library
        handle set-up. Returns the number of dispatches made. Recorded as
        the ``engine_warmup`` span and the ``warmup_done`` event."""
        n = 0
        d = self.dim
        with obs_events.span("engine_warmup"):
            ks = sorted({self._k_bucket(int(k)) for k in k_buckets})
            for k in ks:
                self.top_k_cosine(np.zeros(d, np.float32), k)
                n += 1
            for q in sorted({next_pow2(int(q)) for q in q_buckets}):
                self.pull(np.zeros(q, np.int32))
                n += 1
            for q in sorted({self._q_bucket(int(q)) for q in q_buckets}):
                for k in ks:
                    self.top_k_cosine_batch(np.zeros((q, d), np.float32), k)
                    n += 1
            for s in sorted({next_pow2(int(s)) for s in sentence_rows}):
                for L in sorted({next_pow2(int(L)) for L in sentence_lens}):
                    self.pull_average(
                        np.zeros((s, L), np.int32), np.zeros((s, L), np.float32)
                    )
                    n += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        obs_events.emit("warmup_done", dispatches=n)
        return n

    # ------------------------------------------------------------------
    # Approximate top-k (the ANN index of ops/ann.py)
    # ------------------------------------------------------------------

    def configure_ann(self, *, clusters: int = -1, nprobe: int = 8,
                      iters: int = 6, sample: int = 65536) -> dict:
        """Fix the coarse index's geometry (``engine.py:2388``):
        ``clusters`` -1 takes ``ann.auto_clusters`` of the full row
        capacity, from which the member slots follow. Returns it."""
        from glint_word2vec_torch.ops import ann as _ann

        C = int(clusters) if int(clusters) > 0 else _ann.auto_clusters(self.num_rows)
        self._ann_conf = {
            "clusters": C,
            "slots": _ann.member_slots(self.num_rows, C),
            "nprobe": max(1, min(int(nprobe), C)),
            "iters": max(1, int(iters)),
            "sample": max(1, int(sample)),
        }
        return dict(self._ann_conf)

    @property
    def ann_index(self):
        """The adopted index, or None."""
        return self._ann

    def ann_build(self, syn0=None, norms=None, queryable=None):
        """Build an index from the live table, or from a staged
        generation's ``syn0`` (with its ``norms`` and ``queryable``, or
        derived), and return it without adopting it
        (:meth:`adopt_ann`). Reads no engine state but the geometry of
        :meth:`configure_ann`, the seed and the table version."""
        from glint_word2vec_torch.ops import ann as _ann

        conf = self._ann_conf
        if conf is None:
            raise RuntimeError("call configure_ann() before ann_build()")
        if syn0 is None:
            syn0, norms, queryable = (self.logical_table(0), self.norms(),
                                      self.queryable_rows)
        elif norms is None:
            norms = self._norms(syn0)
        if queryable is None:
            queryable = self.queryable_rows
        return _ann.build(
            syn0, norms, int(queryable), clusters=conf["clusters"],
            iters=conf["iters"], sample=conf["sample"], seed=self._seed,
            table_version=self.table_version, num_rows=self.num_rows,
        )

    def adopt_ann(self, index) -> None:
        """Make ``index`` the live index (None disables the approximate
        path)."""
        self._ann = index
        if index is not None:
            index.table_version = self.table_version

    def ann_stats(self) -> dict:
        """Index telemetry; ``{"enabled": False}`` without an index."""
        idx = self._ann
        if idx is None:
            return {"enabled": False}
        st = idx.stats()
        st["enabled"] = True
        st["nprobe"] = self._ann_conf["nprobe"]
        st["table_versions_behind"] = max(0, self.table_version - idx.table_version)
        return st

    def ann_top_k_batch(self, vecs, k: int, nprobe: Optional[int] = None, *,
                        index=None, queryable=None
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Approximate :meth:`top_k_cosine_batch` through the index
        (``ann.search``): Q padded to its bucket and capped at
        ``ANN_MAX_Q`` a dispatch, k rounded to its bucket and truncated. A
        k past ``nprobe`` x slots raises (the model layer sends such a k to
        the exact path). ``index``/``queryable`` run a staged generation's
        recall check on the same path."""
        from glint_word2vec_torch.ops import ann as _ann

        idx = index if index is not None else self._ann
        if idx is None:
            raise RuntimeError("no ANN index adopted (ann_build/adopt_ann)")
        if queryable is None:
            queryable = self.queryable_rows
        if nprobe is None:
            nprobe = self._ann_conf["nprobe"]
        nprobe = max(1, min(int(nprobe), idx.clusters))
        if not 0 < k <= self.padded_vocab:
            raise ValueError(f"k must be in [1, {self.padded_vocab}]")
        if k > nprobe * idx.slots:
            raise ValueError(
                f"k={k} exceeds the index's probe capacity "
                f"({nprobe} probes x {idx.slots} slots); raise nprobe "
                "or use the exact path"
            )
        q = np.asarray(vecs, dtype=np.float32)
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(f"vecs must have shape (Q, {self.dim})")
        nrm = np.linalg.norm(q, axis=1, keepdims=True)
        q = q / np.where(nrm > 0, nrm, 1.0)
        if q.shape[0] == 0:
            empty = np.zeros((0, k))
            return empty.astype(np.float32), empty.astype(np.int64)
        k_b = min(self._k_bucket(k), nprobe * idx.slots)
        vals, ids = [], []
        for s in range(0, q.shape[0], ANN_MAX_Q):
            qc = q[s : s + ANN_MAX_Q]
            n = qc.shape[0]
            q_b = min(self._q_bucket(n), ANN_MAX_Q)
            if q_b != n:
                qc = np.concatenate([qc, np.zeros((q_b - n, self.dim), np.float32)])
            self._count_query_shape("ann_topk", q_b, k_b, nprobe)
            val, i = _ann.search(idx, torch.from_numpy(qc).to(self.device),
                                 k_b, nprobe, queryable)
            vals.append(val[:n, :k])
            ids.append(i[:n, :k])
        return (torch.cat(vals).cpu().numpy(),
                torch.cat(ids).long().cpu().numpy())

    def warmup_ann(self, q_buckets=(1, 8, ANN_MAX_Q),
                   k_buckets=(TOPK_MIN_K_BUCKET,), nprobes=()) -> int:
        """Dispatch the approximate family once: every (Q bucket, k
        bucket, nprobe), plus the incremental assignment's score product.
        Returns the query shapes it dispatched for the first time."""
        from glint_word2vec_torch.ops import ann as _ann

        idx = self._ann
        if idx is None:
            raise RuntimeError("adopt an index before warmup_ann()")
        before = self.query_compiles
        nps = sorted({max(1, min(int(p), idx.clusters))
                      for p in (*nprobes, self._ann_conf["nprobe"])})
        for p in nps:
            for q in sorted({min(self._q_bucket(int(q)), ANN_MAX_Q)
                             for q in q_buckets}):
                for k in sorted({self._k_bucket(int(k)) for k in k_buckets}):
                    self.ann_top_k_batch(
                        np.zeros((q, self.dim), np.float32),
                        min(k, p * idx.slots), p)
        _ann.centroid_scores(self.logical_table(0), self.norms(),
                             np.zeros(_ann.INCREMENTAL_BLOCK, np.int32),
                             idx.centroids)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.query_compiles - before

    def ann_recall_at_k(self, k: int = 10, sample: int = 64,
                        nprobe: Optional[int] = None, *, index=None,
                        syn0=None, norms=None, queryable=None,
                        q_chunk: int = 64) -> float:
        """Recall@k of the approximate path against the exact path on the
        same tables (live, or a staged generation's): ``sample`` table
        rows drawn by ``np.random.default_rng(seed)``, each query's exact
        and approximate top-(k+1) compared with the query row itself
        excluded, as ``/synonyms`` answers."""
        idx = index if index is not None else self._ann
        if idx is None:
            raise RuntimeError("no ANN index adopted")
        if syn0 is None:
            syn0, norms, queryable = (self.logical_table(0), self.norms(),
                                      self.queryable_rows)
        elif norms is None:
            norms = self._norms(syn0)
        if queryable is None:
            queryable = self.queryable_rows
        queryable = int(queryable)
        rng = np.random.default_rng(self._seed)
        n_q = min(int(sample), queryable)
        if n_q == 0:
            return 1.0
        qids = rng.choice(queryable, n_q, replace=False).astype(np.int32)
        qvecs = gather_rows(syn0, torch.from_numpy(qids).to(self.device))
        qvecs = qvecs.cpu().numpy()
        live = np.linalg.norm(qvecs, axis=1) > 0
        if not live.any():
            return 1.0
        qids, qvecs = qids[live], qvecs[live]
        k_b = self._k_bucket(k + 1)
        hits = total = 0
        for s in range(0, qids.shape[0], q_chunk):
            qc, ic = qvecs[s : s + q_chunk], qids[s : s + q_chunk]
            n = qc.shape[0]
            nrm = np.linalg.norm(qc, axis=1, keepdims=True)
            qp = qc / np.where(nrm > 0, nrm, 1.0)
            q_b = self._q_bucket(n)
            if q_b != n:
                qp = np.concatenate([qp, np.zeros((q_b - n, self.dim), np.float32)])
            self._count_query_shape("topk_batch", q_b, k_b)
            ex_val, ex_idx = self._exact_topk(
                torch.from_numpy(qp).to(self.device), k_b, syn0, norms, queryable)
            ex_val, ex_idx = ex_val[:n].cpu().numpy(), ex_idx[:n].cpu().numpy()
            ap_val, ap_idx = self.ann_top_k_batch(
                qc, k + 1, nprobe, index=idx, queryable=queryable)
            for row in range(n):
                # -inf entries are masked filler on either side, not
                # results.
                ex = [int(i) for i, v in zip(ex_idx[row], ex_val[row])
                      if np.isfinite(v) and int(i) != int(ic[row])]
                ap = {int(i) for i, v in zip(ap_idx[row], ap_val[row])
                      if np.isfinite(v) and int(i) != int(ic[row])}
                want = ex[:k]
                hits += len(set(want) & ap)
                total += len(want)
        return hits / max(1, total)

    # ------------------------------------------------------------------
    # Corpus-resident training
    # ------------------------------------------------------------------

    def noise_tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The unigram^power alias table on the device, ``(prob float32,
        alias int32)`` over the unpadded vocabulary, built on first use
        (and anew by :meth:`set_noise_counts`)."""
        if self._noise is None:
            t = build_unigram_alias(
                self._counts, power=self.unigram_power,
                table_size=self.unigram_table_size,
            )
            self._noise = (
                torch.from_numpy(t.prob).to(self.device),
                torch.from_numpy(t.alias).to(self.device),
            )
        return self._noise

    def set_noise_counts(self, counts: np.ndarray) -> None:
        """Install new per-word counts and rebuild the negative-sampling
        alias table from them (``engine.py:2246`` of the JAX package): the
        streaming trainer's adaptive unigram distribution. The shapes stay
        ``(vocab_size,)``; promoted extra rows are never negatives. New
        tensors are installed and the old ones left alone, so a packed
        group already queued keeps reading the table it was enqueued
        with; the next group's draws take the new one. Checkpoints carry
        the new counts."""
        c = np.asarray(counts, dtype=np.int64)
        if c.shape != (self.vocab_size,):
            raise ValueError(
                f"counts must have shape ({self.vocab_size},), got {c.shape}"
            )
        if c.sum() <= 0:
            raise ValueError("counts must sum to > 0")
        t = build_unigram_alias(
            c, power=self.unigram_power, table_size=self.unigram_table_size
        )
        self._counts = c.copy()
        self._noise = (
            torch.from_numpy(t.prob).to(self.device),
            torch.from_numpy(t.alias).to(self.device),
        )

    def upload_corpus(self, ids: np.ndarray, offsets: np.ndarray,
                      n_valid: Optional[int] = None) -> None:
        """Upload the flat encoded corpus (``corpus/vocab.encode_file``'s
        ``(ids, offsets)``) to the device once; the packed steps assemble
        every batch there.

        ``n_valid`` bounds the live center positions to a prefix of the
        buffer: positions at or past it are consumed but give no pairs.
        The streaming trainer fills one fixed-capacity buffer a round and
        passes its fill here."""
        n = int(np.asarray(ids).shape[0])
        if n < 1 or n >= 2**31 or int(np.asarray(offsets)[-1]) != n:
            raise ValueError(
                "corpus must be non-empty with offsets[-1] == len(ids) "
                f"< 2**31 (got len(ids)={n})"
            )
        if n_valid is None:
            n_valid = n
        if not 0 <= int(n_valid) <= n:
            raise ValueError(
                f"n_valid ({n_valid}) must be in [0, len(ids)={n}]"
            )
        self._corpus = dbat.to_device_corpus(ids, offsets, self.device)
        self._corpus_n_valid = int(n_valid)
        self._corpus_compacted = None
        self._compact_prefetch = None
        self._n_kept = None
        self._compacted_offsets_host = None

    def _require_corpus(self):
        if self._corpus is None:
            raise ValueError("no corpus uploaded (call upload_corpus first)")
        return self._corpus

    @property
    def corpus_positions(self) -> int:
        """Center positions of the uploaded corpus (its words)."""
        return int(self._require_corpus()[0].shape[0])

    def set_keep_probs(self, keep_prob: np.ndarray) -> None:
        """Install the per-word keep probabilities of frequency
        subsampling (``Vocabulary.device_keep_probabilities``); required
        before :meth:`compact_corpus`."""
        kp = np.asarray(keep_prob, dtype=np.float32)
        if kp.shape != (self.vocab_size,):
            raise ValueError(
                f"keep_prob must have shape ({self.vocab_size},), got {kp.shape}"
            )
        self._keep_prob = torch.from_numpy(kp).to(self.device)

    def _require_compactable(self) -> None:
        """Raise unless the uploaded corpus can be subsampled on the
        device: keep probabilities installed, and no ``n_valid`` bound
        (the pass draws over the whole buffer and would compact the
        padding past the bound into the live stream)."""
        ids = self._require_corpus()[0]
        if self._keep_prob is None:
            raise ValueError(
                "no keep probabilities installed (call set_keep_probs first)"
            )
        if self._corpus_n_valid != int(ids.shape[0]):
            raise ValueError(
                "on-device subsampling over an n_valid-bounded corpus "
                "view is unsupported (subsample host-side when filling "
                "the buffer)"
            )

    def _compact_dispatch(self, epoch_key: int,
                          keep: Optional[torch.Tensor] = None):
        """Enqueue one subsample-and-compact pass over the uploaded
        corpus; returns ``(ids_c, offsets_c, n_kept)`` on the device, with
        no readback."""
        ids, offsets = self._require_corpus()
        if keep is None:
            keep = dbat.subsample_keep_mask(ids, self._keep_prob, epoch_key)
        return dbat.subsample_compact(ids, offsets, keep)

    def compact_corpus(self, epoch_key: int,
                       keep: Optional[torch.Tensor] = None) -> int:
        """Run one epoch's subsample-and-compact pass over the uploaded
        corpus and make the compacted view the active corpus of the next
        packed steps. The keep mask is drawn from ``epoch_key``
        (``subsample_keep_mask``) unless given. A pass
        :meth:`prefetch_compact_corpus` dispatched for the same key is
        adopted instead of run again: the same function of the same
        inputs, so bitwise the same buffers. The previous view is dropped
        first, so without a prefetch the card holds one compacted copy.
        Returns ``n_kept``, the one scalar read back per epoch."""
        self._require_compactable()
        self._corpus_compacted = None
        self._compacted_offsets_host = None
        pre, self._compact_prefetch = self._compact_prefetch, None
        if keep is None and pre is not None and pre[0] == int(epoch_key):
            ids_c, offsets_c, n_kept = pre[1:]
        else:
            del pre  # prefetched for another key: dropped, not adopted
            ids_c, offsets_c, n_kept = self._compact_dispatch(epoch_key, keep)
        self._corpus_compacted = (ids_c, offsets_c)
        self._n_kept = int(n_kept)
        return self._n_kept

    def prefetch_compact_corpus(self, epoch_key: int) -> None:
        """Enqueue the next epoch's subsample-and-compact pass into new
        device buffers without adopting them, while the current epoch's
        last group is still queued, so the epoch boundary does not wait
        for the pass. Nothing is read back. The next
        :meth:`compact_corpus` with the same ``epoch_key`` adopts the
        buffers; the active view is untouched until then, so the card
        holds two compacted copies in between."""
        self._require_compactable()
        self._compact_prefetch = None
        self._compact_prefetch = (int(epoch_key),
                                  *self._compact_dispatch(epoch_key))

    def compacted_offsets(self) -> np.ndarray:
        """Host copy of the active epoch's compacted sentence offsets (one
        readback per epoch, for the host's words_done accounting)."""
        if self._corpus_compacted is None:
            raise ValueError("no compacted corpus (call compact_corpus)")
        if self._compacted_offsets_host is None:
            self._compacted_offsets_host = self._corpus_compacted[1].cpu().numpy()
        return self._compacted_offsets_host

    def train_steps_corpus_packed(
        self, start_position, pair_batch: int, window: int,
        grid_batch: int, base_key: int, n_steps: int, step0: int = 0,
        grid_step0: int = 0, *, step_size: float = 0.025,
        total_words: int = 1, words_base: int = 0,
        span: Optional[int] = None, draws=None, readback: bool = True,
    ):
        """K = ``n_steps`` packed SGNS steps over the active corpus view
        (the epoch's compacted buffers after :meth:`compact_corpus`, else
        the uploaded corpus).

        Step ``i`` packs the next valid pairs of the position stream into
        ``pair_batch`` slots (``pack_window_pairs`` over ``span``
        candidate positions, ``packed_span`` by default), draws
        ``num_negatives`` per pair row, masks them, and applies
        :func:`~glint_word2vec_torch.ops.fused_sgns.fused_pair_step`
        to the tables in place. The learning rate follows the consumed
        position on the device: ``max(step_size * (1 - wd / total_words),
        step_size * 1e-4)`` with ``wd = words_base + device_words_done``.
        The position, the consumed count and alpha stay 0-d device tensors
        through the loop; nothing is read back until its end.
        ``start_position`` is an int or a 0-d tensor on the device (the
        previous group's end position, so that a group chains on the one
        before it with no readback).

        With ``shared_negatives = S > 0`` step ``i`` draws one pool of S
        negatives for the whole batch instead and applies
        :func:`~glint_word2vec_torch.ops.fused_sgns.fused_pair_step_shared`
        (the shared branch of the JAX engine's ``fused_pair_body``,
        ``engine.py:574-599``).

        ``draws`` supplies the shrink, negative and pool draws
        (:class:`TrainingDraws` over ``base_key`` by default): step ``i``
        draws its negatives or its pool under the key ``fold_in(base_key,
        step0 + i)`` and position ``p`` its shrink under the grid key
        schedule of ``grid_batch``/``grid_step0``.

        Returns host arrays ``(losses (K,), pair_counts (K,), pos_ends
        (K,), alphas (K,))``: per-step loss, live pairs packed, consumed
        position after the step, and alpha. With ``readback=False`` it
        reads nothing back and returns a :class:`DeferredReadback` of
        those four rows as one ``(4, K)`` float64 tensor on the device,
        whose ``out[2, -1]`` is the next group's start;
        :meth:`packed_readback` waits for it later."""
        offsets = self._require_corpus()[1]
        P, W, B = int(pair_batch), int(window), int(grid_batch)
        C = context_width(W)
        if P < C:
            raise ValueError(f"pair_batch ({P}) must be >= context lanes ({C})")
        S = dbat.packed_span(P, C) if span is None else int(span)
        K = int(n_steps)
        self._check_data_split(P, "pair_batch")
        ids, soffs, n_valid = self._active_corpus()
        if draws is None:
            draws = TrainingDraws(
                base_key, *self.noise_tables(), W, B, self.num_negatives
            )
        dev = self.device
        # Scalars by fill kernels: a copy from host memory to the card
        # would wait for the groups already queued.
        f32 = dict(dtype=torch.float32, device=dev)
        step_size_t = torch.full((), float(step_size), **f32)
        floor = step_size_t * 1e-4
        inv_total = torch.full((), 1.0 / float(total_words), **f32)
        base_words = torch.full((), float(words_base), **f32)
        arange_s = torch.arange(S, dtype=torch.int64, device=dev)
        if isinstance(start_position, torch.Tensor):
            pos = start_position.to(device=dev, dtype=torch.int64)
        else:
            pos = torch.full((), int(start_position), dtype=torch.int64,
                             device=dev)
        out = torch.empty((4, K), dtype=torch.float64, device=dev)
        for i in range(K):
            with obs_events.stage("pack_pairs", device=dev):
                shrink = draws.shrink(pos + arange_s, grid_step0)
                pc, px, pm, n_cons, n_pairs = dbat.pack_window_pairs(
                    ids, soffs, pos, shrink, window=W, pair_batch=P,
                    n_valid=n_valid,
                )
                pos = pos + n_cons
                done = dbat.device_words_done(offsets, soffs, pos, n_valid)
                wd = base_words + done.to(torch.float32)
                alpha = torch.maximum(step_size_t * (1.0 - wd * inv_total),
                                      floor)
            if self._meshed:
                out[0, i] = self._mesh_pair_step(
                    pc, px, pm, alpha, draws, step0 + i)
            elif self.shared_negatives:
                with obs_events.stage("draw_negatives", device=dev):
                    pool = draws.pool(step0 + i, self.shared_negatives)
                loss_sum = fused_pair_step_shared(
                    self.syn0, self.syn1, pc, px, pm, pool, alpha,
                    self.num_negatives,
                )
            else:
                with obs_events.stage("draw_negatives", device=dev):
                    negs = draws.negatives(step0 + i, P)
                    nmask = negative_mask(negs, px, pm)
                loss_sum = fused_pair_step(
                    self.syn0, self.syn1, pc, px, pm, negs, nmask, alpha
                )
            if not self._meshed:
                out[0, i] = loss_sum / pm.sum().clamp(min=1.0)
            out[1, i] = n_pairs
            out[2, i] = pos
            out[3, i] = alpha
        self._tick_tables("train_steps_corpus_packed")
        group = deferred_readback(out)
        return self.packed_readback(group) if readback else group

    @staticmethod
    def packed_readback(group: DeferredReadback):
        """One packed group's results as host arrays ``(losses,
        pair_counts, pos_ends, alphas)``, once its copy has landed: the
        wait covers this group and not the groups queued after it."""
        with obs_events.stage("readback_wait"):
            host = group.wait()
        return (
            host[0].astype(np.float32), host[1].astype(np.int64),
            host[2].astype(np.int64), host[3].astype(np.float32),
        )

    def _active_corpus(self):
        """``(ids, sentence offsets, n_valid)`` of the active corpus view:
        the epoch's compacted buffers after :meth:`compact_corpus`, else
        the uploaded corpus with its ``n_valid`` bound."""
        ids, offsets = self._require_corpus()
        if self._corpus_compacted is not None:
            return (*self._corpus_compacted, self._n_kept)
        return ids, offsets, self._corpus_n_valid

    def train_steps_corpus(
        self, start_position: int, batch_size: int, window: int,
        base_key: int, alphas, step0: int = 0, *, draws=None,
    ) -> torch.Tensor:
        """K = ``len(alphas)`` composed steps of grid batches over the
        active corpus view (the JAX engine's ``train_steps_corpus``,
        ``engine.py:1761-1799``, and its corpus scan, :944-999).

        Batch ``i`` covers positions ``[start + i*B, start + (i+1)*B)``
        (``start`` a position of the compacted stream when subsampling);
        positions past the view's end are masked rows, the epoch tail. Its
        rows draw their window shrinks and their ``(C, n)`` negatives (or
        the step's shared pool) under ``fold_in(base_key, step0 + i)``, the
        key schedule of :meth:`train_steps`, so a grid step over the
        device corpus draws what the same batch draws from the host.
        ``draws`` supplies them (:class:`TrainingDraws` over ``base_key``
        by default; tests hand in the JAX package's). Every step is
        :meth:`_composed_step` (``gather_rows``, ``scatter_add_rank1``,
        ``scatter_add_rows``). Returns the ``(K,)`` fp32 losses as a
        device tensor, read back once by the caller."""
        ids, soffs, n_valid = self._active_corpus()
        B, W = int(batch_size), int(window)
        C = context_width(W)
        self._check_data_split(B, "batch_size")
        alphas_t = self._on_device(np.asarray(alphas, np.float32), torch.float32)
        K = alphas_t.shape[0]
        if draws is None:
            draws = TrainingDraws(
                base_key, *self.noise_tables(), W, B, self.num_negatives
            )
        dev = self.device
        rows = torch.arange(B, dtype=torch.int64, device=dev)
        ones = torch.ones((B, 1), dtype=torch.float32, device=dev)
        losses = torch.empty(K, dtype=torch.float32, device=dev)
        for i in range(K):
            step = int(step0) + i
            positions = rows + (int(start_position) + i * B)
            centers, contexts, mask = dbat.device_window_batch(
                ids, soffs, positions, draws.step_shrink(step, B), W,
                n_valid=n_valid,
            )
            if self._meshed:
                losses[i] = self._mesh_step(
                    centers[:, None], ones, contexts, mask, alphas_t[i],
                    lambda r0, n: (draws.pool(step, self.shared_negatives)
                                   if self.shared_negatives
                                   else draws.window_negatives(step, n, C, r0)))
                continue
            noise = (draws.pool(step, self.shared_negatives)
                     if self.shared_negatives
                     else draws.window_negatives(step, B, C))
            losses[i] = self._composed_step(
                centers[:, None], ones, contexts, mask, alphas_t[i], noise
            )
        self._tick_tables("train_steps_corpus")
        return losses

    # ------------------------------------------------------------------
    # Host batches: the composed step
    # ------------------------------------------------------------------

    def _on_device(self, a, dtype: torch.dtype) -> torch.Tensor:
        """A batch array (host array or tensor) on the engine's device. A
        host array goes to a card through pinned memory without blocking,
        so the host does not wait for the steps already queued."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device, dtype).contiguous()
        np_dtype = np.int32 if dtype == torch.int32 else np.float32
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np_dtype))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _composed_step(self, centers: torch.Tensor, cmask: torch.Tensor,
                       contexts: torch.Tensor, mask: torch.Tensor,
                       alpha: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """One composed SGNS step on one grid batch, the tables updated in
        place (``step_body_rows``, ``engine.py:661-758``, one device).
        ``centers``/``cmask`` ``(B, S)``: each center is the masked mean
        of its group's syn0 rows, and its gradient is spread back over the
        group as ``d_center / count``. ``contexts``/``mask`` ``(B, C)``.
        ``noise`` is the ``(B, C, n)`` per-pair negatives or, with
        ``shared_negatives > 0``, the step's pool ``(P,)``: its rows are
        pulled once and scored densely (``shared_sgns_grads``), and the
        syn1 update is the contexts' ``c_pos ⊗ h`` rows followed by
        ``d_pool`` on the pool's rows, through ``scatter_add_rows``
        (``engine.py:679-707``). Every gather happens before any scatter.
        Returns the masked-mean loss as a 0-d device tensor."""
        B, S = centers.shape
        C = contexts.shape[1]
        d = self.dim
        h_rows = self._pull_rows(centers.reshape(-1), self.syn0).reshape(B, S, d)
        cnt = cmask.sum(dim=1, keepdim=True).clamp(min=1.0)
        h = (h_rows * cmask[..., None]).sum(dim=1) / cnt
        u_pos = self._pull_rows(contexts.reshape(-1), self.syn1).reshape(B, C, d)
        if self.shared_negatives:
            pool = noise
            u_pool = self._pull_rows(pool, self.syn1)
            collide = pool_collision_mask(pool, contexts, mask)
            g = shared_sgns_grads(h, u_pos, u_pool, mask, collide, alpha,
                                  self.num_negatives, self.compute_dtype)
            ids1 = torch.cat([contexts.reshape(-1), pool])
            d_upos = g.c_pos[..., None] * h[:, None, :]
            upd1 = torch.cat([d_upos.reshape(-1, d), g.d_pool])
        else:
            negs = noise
            n = negs.shape[2]
            u_neg = self._pull_rows(negs.reshape(-1), self.syn1).reshape(B, C, n, d)
            nmask = negative_mask(negs, contexts, mask)
            g = sgns_grads(h, u_pos, u_neg, mask, nmask, alpha, self.compute_dtype)
            ids1 = torch.cat([contexts.reshape(-1), negs.reshape(-1)])
            upd1 = _apply_rank1_updates(self.syn1, ids1, g.c_pos, g.c_neg, h, C, n)
        dcen = g.d_center / cnt
        upd0 = (dcen[:, None, :] * cmask[..., None]).reshape(-1, d)
        _scatter_rows(self.syn0, centers.reshape(-1), upd0)
        if upd1 is not None:
            _scatter_rows(self.syn1, ids1, upd1)
        return g.loss

    # ------------------------------------------------------------------
    # The step on a mesh
    # ------------------------------------------------------------------

    def _check_data_split(self, rows: int, what: str) -> None:
        """``rows`` (this process's rows of a batch) must split evenly
        over the data ranks this process runs."""
        if rows % self._local_data:
            raise ValueError(
                f"{what} ({rows}) must be divisible by the data-axis size "
                f"({self._local_data} in this process)"
            )

    def _gang_exchange(self, gathered: list, summed: list):
        """The data axis across the processes of a gang: every tensor of
        ``gathered`` (this process's rows first on axis 0) joined in
        process order, every tensor of ``summed`` added over the processes
        in process order. Two host allgathers (gloo) carry them, fp32 and
        int32 (``distributed.allgather_host``); no-op in one process."""
        if self.mesh.process_count == 1:
            return gathered, summed
        from glint_word2vec_torch.parallel import distributed as dist

        pc = self.mesh.process_count
        fl = [t for t in gathered + summed if t.is_floating_point()]
        it = [t for t in gathered if not t.is_floating_point()]
        out = {}
        for group, dtype in ((fl, torch.float32), (it, torch.int32)):
            if not group:
                continue
            flat = torch.cat([t.reshape(-1).to("cpu", dtype) for t in group])
            allp = dist.allgather_host(flat)
            off = 0
            for t in group:
                n = t.numel()
                parts = allp[:, off:off + n].reshape(pc, *t.shape)
                off += n
                out[id(t)] = parts.to(t.device)
        g = [out[id(t)].reshape(-1, *t.shape[1:]) for t in gathered]
        s = [mesh_mod.psum(list(out[id(t)])) for t in summed]
        return g, s

    def _noise_fn(self, key: int, given, i: int, C: int, base: int = 0):
        """``noise(row0, n)``: the pool of the step (every rank the same),
        or the ``(n, C, negatives)`` draws of global rows ``row0`` on,
        keyed by their global row (``engine.py:35-41`` of the JAX
        package), or those rows of step ``i`` of ``given``, which holds
        this process's rows from global row ``base`` on."""
        Ps = self.shared_negatives

        def noise(row0: int, n: int):
            if given is not None:
                return given[i] if Ps else given[i][row0 - base:row0 - base + n]
            prob, alias = self.noise_tables()
            if Ps:
                return sample_negatives(key, prob, alias, (Ps,))
            rows = torch.arange(row0, row0 + n, dtype=torch.int64,
                                device=self.device)
            return sample_negatives_per_row(
                key, prob, alias, rows, (C, self.num_negatives))

        return noise

    def _owned(self, ids: torch.Tensor, m: int):
        """``(local ids, positions)`` of the ids model shard ``m`` owns, in
        input order; positions is None when every id is the shard's. The
        owned updates are compacted before a scatter instead of zeroed
        onto a clipped row as the JAX engine does (``engine.py:167-171``),
        which would make one run as long as the disowned updates. The
        count is read back (one host sync a shard and table)."""
        if self.layout == "dims" or self.num_model == 1:
            return ids, None
        Vs = self.rows_per_shard
        loc = ids - m * Vs
        sel = torch.nonzero((loc >= 0) & (loc < Vs)).squeeze(1)
        return loc[sel].to(torch.int32).contiguous(), sel

    def _mesh_forward_rows(self, centers, cmask, contexts, mask, alpha, noise):
        """One data rank's forward pass, ``rows`` layout: every pull is
        :meth:`_mesh_pull` (masked shard gathers and the model-axis psum),
        then the gradients of ``ops/sgns.py``. Returns ``(g, h, pool)``
        with ``h`` ``(Bl, d)`` and ``d_center`` per center row."""
        Bl, S = centers.shape
        C = contexts.shape[1]
        d = self.dim
        h_rows = self._mesh_pull(0, centers.reshape(-1)).reshape(Bl, S, d)
        cnt = cmask.sum(dim=1, keepdim=True).clamp(min=1.0)
        h = (h_rows * cmask[..., None]).sum(dim=1) / cnt
        u_pos = self._mesh_pull(1, contexts.reshape(-1)).reshape(Bl, C, d)
        if self.shared_negatives:
            u_pool = self._mesh_pull(1, noise)
            collide = pool_collision_mask(noise, contexts, mask)
            g = shared_sgns_grads(h, u_pos, u_pool, mask, collide, alpha,
                                  self.num_negatives, self.compute_dtype)
            return g, [h], [g.d_center / cnt], [g.d_pool]
        n = noise.shape[2]
        u_neg = self._mesh_pull(1, noise.reshape(-1)).reshape(Bl, C, n, d)
        nmask = negative_mask(noise, contexts, mask)
        g = sgns_grads(h, u_pos, u_neg, mask, nmask, alpha, self.compute_dtype)
        return g, [h], [g.d_center / cnt], None

    def _mesh_forward_dims(self, centers, cmask, contexts, mask, alpha, noise):
        """One data rank's forward pass, ``dims`` layout
        (``step_body_dims``, ``engine.py:760-885`` of the JAX package):
        every gather and the center means are shard-local column slices;
        the model axis sums only the scalar logit partials (``f_pos``,
        ``f_neg``, ``f_pool``). Returns ``(coefs, [h_m], [d_center_m],
        [d_pool_m])`` per shard."""
        Bl, S = centers.shape
        C = contexts.shape[1]
        cd = self.compute_dtype
        cnt = cmask.sum(dim=1, keepdim=True).clamp(min=1.0)
        hs, ups, uns = [], [], []
        for t in self._shards[0]:
            rows = gather_rows(t, centers.reshape(-1).contiguous())
            hs.append((rows.reshape(Bl, S, -1) * cmask[..., None]).sum(dim=1) / cnt)
        for t in self._shards[1]:
            ups.append(gather_rows(t, contexts.reshape(-1).contiguous())
                       .reshape(Bl, C, -1))
            if self.shared_negatives:
                uns.append(gather_rows(t, noise))
            else:
                n = noise.shape[2]
                uns.append(gather_rows(t, noise.reshape(-1).contiguous())
                           .reshape(Bl, C, n, -1))

        def op(x):
            return _operand(x, cd)

        f_pos = mesh_mod.psum([
            torch.einsum("bd,bcd->bc", op(h), op(u))
            for h, u in zip(hs, ups)])
        if self.shared_negatives:
            collide = pool_collision_mask(noise, contexts, mask)
            f_pool = mesh_mod.psum([op(h) @ op(u).T for h, u in zip(hs, uns)])
            co = shared_sgns_coefs(f_pos, f_pool, mask, collide, alpha,
                                   self.num_negatives)
            upd = [shared_sgns_updates(co.c_pos, co.c_pool, h, u, up, cd)
                   for h, u, up in zip(hs, ups, uns)]
            return (co, hs, [dc / cnt for dc, _ in upd],
                    [dp for _, dp in upd])
        nmask = negative_mask(noise, contexts, mask)
        f_neg = mesh_mod.psum([
            torch.einsum("bd,bcnd->bcn", op(h), op(u))
            for h, u in zip(hs, uns)])
        co = sgns_coefs(f_pos, f_neg, mask, nmask, alpha)
        dcs = [sgns_d_center(co.c_pos, co.c_neg, u, un, cd) / cnt
               for u, un in zip(ups, uns)]
        return co, hs, dcs, None

    def _mesh_step(self, centers: torch.Tensor, cmask: torch.Tensor,
                   contexts: torch.Tensor, mask: torch.Tensor,
                   alpha: torch.Tensor, noise) -> torch.Tensor:
        """One composed step on a mesh (``step_body_rows`` and
        ``step_body_dims``, ``engine.py:643-885`` of the JAX package), the
        shards updated in place; returns the masked-mean loss of the
        global batch.

        Each data rank runs the forward pass of its ``B / num_data`` rows
        (``noise(row0, n)`` gives its negatives, keyed by global row, or
        the step's pool). The data axis then gathers, in rank order, only
        ``h``, the scalar coefficients, the center gradients and int32
        ids (the shared pool's ``d_pool`` is summed over the ranks), and
        every model shard applies the whole batch's updates it owns:
        ``scatter_add_rank1`` for syn1 on fp32 tables (the dense payload
        through ``scatter_add_rows`` under bf16 or a shared pool), and
        ``scatter_add_rows`` for syn0, with the fp32 pre-sum under bf16."""
        B, S = centers.shape
        C = contexts.shape[1]
        R = self._local_data
        Bl = B // R
        n = self.num_negatives
        base = self.mesh.process_index * B
        fwd = (self._mesh_forward_rows if self.layout == "rows"
               else self._mesh_forward_dims)
        outs, nz, loss_sums, denoms = [], [], [], []
        for r in range(R):
            sl = slice(r * Bl, (r + 1) * Bl)
            z = noise(base + r * Bl, Bl)
            o = fwd(centers[sl], cmask[sl], contexts[sl], mask[sl], alpha, z)
            outs.append(o)
            nz.append(z)
            denom = mask[sl].sum()
            loss_sums.append(o[0].loss * denom.clamp(min=1.0))
            denoms.append(denom)
        gather = mesh_mod.all_gather
        n_sh = len(outs[0][1])
        shared = bool(self.shared_negatives)
        local = [gather([o[0].c_pos for o in outs]), cmask,
                 centers.reshape(-1), contexts.reshape(-1)]
        local += [gather([o[1][j] for o in outs]) for j in range(n_sh)]
        local += [gather([o[2][j] for o in outs]) for j in range(n_sh)]
        if not shared:
            local += [gather([o[0].c_neg for o in outs]),
                      gather([z.reshape(-1) for z in nz])]
        sums = [mesh_mod.psum(loss_sums), mesh_mod.psum(denoms)]
        if shared:
            sums += [mesh_mod.psum([o[3][j] for o in outs])
                     for j in range(n_sh)]
        glob, sums = self._gang_exchange(local, sums)
        cpos_g, cmask_g, ids0_g, ctx_g = glob[:4]
        hs_g, dcens_g = glob[4:4 + n_sh], glob[4 + n_sh:4 + 2 * n_sh]
        for m in range(self.num_model):
            t0, t1 = self._shards[0][m], self._shards[1][m]
            j = m if n_sh > 1 else 0
            h_g, dcen_g = hs_g[j], dcens_g[j]
            w = h_g.shape[1]
            if shared:
                pool = nz[0]
                ids1 = torch.cat([ctx_g, pool])
                d_upos = cpos_g[..., None] * h_g[:, None, :]
                upd1 = torch.cat([d_upos.reshape(-1, w), sums[2 + j]])
                loc, sel = self._owned(ids1, m)
                _scatter_rows(t1, loc, upd1 if sel is None else upd1[sel])
            else:
                cneg_g, negs_g = glob[4 + 2 * n_sh:]
                ids1 = torch.cat([ctx_g, negs_g])
                loc, sel = self._owned(ids1, m)
                if t1.dtype == torch.float32:
                    coefs, hidx = _rank1_payload(cpos_g, cneg_g, C, n)
                    if sel is not None:
                        coefs, hidx = coefs[sel].contiguous(), hidx[sel].contiguous()
                    scatter_add_rank1(t1, loc, coefs, h_g.contiguous(), hidx)
                else:
                    upd1 = _rank1_dense_payload(cpos_g, cneg_g, h_g)
                    _scatter_rows(t1, loc, upd1 if sel is None else upd1[sel])
            upd0 = (dcen_g[:, None, :] * cmask_g[..., None]).reshape(-1, w)
            loc, sel = self._owned(ids0_g, m)
            _scatter_rows(t0, loc, upd0 if sel is None else upd0[sel])
        return sums[0] / sums[1].clamp(min=1.0)

    def _mesh_pair_step(self, pc: torch.Tensor, px: torch.Tensor,
                        pm: torch.Tensor, alpha: torch.Tensor, draws,
                        step: int) -> torch.Tensor:
        """One packed pair step on a mesh; returns its masked-mean loss.
        Each data rank takes its ``P / num_data`` pair rows and draws
        their negatives by global pair row (``Pl = P // num_data``,
        ``engine.py:1023-1090`` of the JAX package). On a ``rows`` mesh
        whose model axis is 1 every row is local, and the step is the
        fused one (``fused_pair_body``, ``engine.py:557-641``): each rank's
        forward kernel (``pair_forward``, or ``pair_forward_shared`` with
        a pool, whose ``d_pool`` the ranks sum), the data-axis gathers,
        then ``scatter_add_rank1_hbm`` and ``scatter_add_rows_f32`` over
        the whole batch. Elsewhere it is :meth:`_mesh_step` with one
        context lane."""
        P = pc.shape[0]
        R = self._local_data
        Pl = P // R
        S = self.shared_negatives
        if self.mesh.process_count > 1:
            raise ValueError(
                "the packed corpus path runs in one process; a gang of "
                "processes trains through the host batcher")
        if not (self.layout == "rows" and self.num_model == 1):
            ones = torch.ones((P, 1), dtype=torch.float32, device=pc.device)
            return self._mesh_step(
                pc[:, None], ones, px[:, None], pm[:, None], alpha,
                lambda r0, n: (draws.pool(step, S) if S
                               else draws.negatives(step, n, r0)[:, None, :]))
        from glint_word2vec_torch.ops import fused_sgns as fs

        t0, t1 = self._shards[0][0], self._shards[1][0]
        pool = draws.pool(step, S) if S else None
        fws, negs = [], []
        for r in range(R):
            sl = slice(r * Pl, (r + 1) * Pl)
            if S:
                fws.append(fs.pair_forward_shared(
                    t0, t1, pc[sl], px[sl], pm[sl], pool, alpha,
                    self.num_negatives))
            else:
                ng = draws.negatives(step, Pl, r * Pl)
                fws.append(fs.pair_forward(
                    t0, t1, pc[sl], px[sl], pm[sl], ng,
                    negative_mask(ng, px[sl], pm[sl]), alpha))
                negs.append(ng)
        gather = mesh_mod.all_gather
        cpos = gather([f.c_pos for f in fws])
        h = gather([f.h for f in fws]).contiguous()
        rows = torch.arange(P, dtype=torch.int32, device=pc.device)
        if S:
            fs.scatter_add_rank1_hbm(t1, px, cpos, h, rows)
            fs.scatter_add_rows_f32(
                t1, pool, mesh_mod.psum([f.d_pool for f in fws]).contiguous())
        else:
            n = self.num_negatives
            cneg = gather([f.c_neg for f in fws])
            fs.scatter_add_rank1_hbm(
                t1, torch.cat([px, gather(negs).reshape(-1)]),
                torch.cat([cpos, cneg.reshape(-1)]), h,
                torch.cat([rows, rows.repeat_interleave(n)]))
        fs.scatter_add_rows_f32(t0, pc, gather([f.d_center for f in fws])
                                .contiguous())
        return (mesh_mod.psum([f.loss_sum for f in fws])
                / pm.sum().clamp(min=1.0))

    def train_step(self, centers, contexts, mask, key: int, alpha, *,
                   negs=None, pools=None) -> float:
        """One word-level minibatch update (``engine.py:1417`` of the JAX
        package); returns the batch loss. ``centers (B,)``, ``contexts``/
        ``mask (B, C)``: :meth:`train_step_grouped` with groups of one
        row."""
        centers = self._on_device(centers, torch.int32)
        ones = torch.ones(centers.shape, dtype=torch.float32, device=self.device)
        return self.train_step_grouped(
            centers[:, None], ones[:, None], contexts, mask, key, alpha,
            negs=negs, pools=pools,
        )

    def train_step_grouped(self, center_groups, group_mask, contexts, mask,
                           key: int, alpha, *, negs=None,
                           pools=None) -> float:
        """One minibatch update with grouped centers, each center the
        masked mean of its group's syn0 rows (``engine.py:1458`` of the
        JAX package); returns the batch loss as a Python float (one
        readback). It is :meth:`train_steps_grouped` with ``K = 1`` and
        ``step0 = 0``: the negatives are drawn under ``fold_in(key, 0)``,
        unless ``negs (B, C, n)`` (or ``pools (P,)`` with shared
        negatives) supplies them."""
        def one(x, dtype):
            return self._on_device(x, dtype)[None]

        losses = self.train_steps_grouped(
            one(center_groups, torch.int32), one(group_mask, torch.float32),
            one(contexts, torch.int32), one(mask, torch.float32), key,
            np.asarray([alpha], np.float32), 0,
            negs=None if negs is None else one(negs, torch.int32),
            pools=None if pools is None else one(pools, torch.int32),
        )
        return float(losses[0].item())

    def train_steps(self, centers_k, contexts_k, mask_k, base_key: int,
                    alphas, step0: int = 0, *, negs=None,
                    pools=None) -> torch.Tensor:
        """K word-level steps: :meth:`train_steps_grouped` with groups of
        one row. ``centers_k (K, B)``, ``contexts_k``/``mask_k (K, B,
        C)``."""
        centers = self._on_device(centers_k, torch.int32)
        ones = torch.ones(centers.shape, dtype=torch.float32, device=self.device)
        return self.train_steps_grouped(
            centers[..., None], ones[..., None], contexts_k, mask_k,
            base_key, alphas, step0, negs=negs, pools=pools,
        )

    def train_steps_grouped(self, center_groups_k, group_mask_k, contexts_k,
                            mask_k, base_key: int, alphas, step0: int = 0,
                            *, negs=None, pools=None) -> torch.Tensor:
        """K composed steps over a stacked group of grid batches, as a
        Python loop of launches (the JAX engine's ``train_steps_grouped``,
        ``engine.py:1524``). ``center_groups_k``/``group_mask_k (K, B,
        S)``, ``contexts_k``/``mask_k (K, B, C)``, ``alphas (K,)``; host
        arrays or tensors.

        Step ``i`` draws its negatives per batch row with shape ``(C, n)``
        under the key ``fold_in(base_key, step0 + i)``
        (``engine.py:713-716``), unless ``negs`` ``(K, B, C, n)`` supplies
        them (tests hand in the JAX package's draws). With
        ``shared_negatives = P > 0`` it draws one pool of P under the same
        key instead (``engine.py:685-687``), or takes step ``i``'s from
        ``pools`` ``(K, P)``. Returns the ``(K,)`` fp32 losses as a device
        tensor: the caller reads a group's losses back once, when it needs
        them."""
        cg = self._on_device(center_groups_k, torch.int32)
        gm = self._on_device(group_mask_k, torch.float32)
        cx = self._on_device(contexts_k, torch.int32)
        mk = self._on_device(mask_k, torch.float32)
        K, B, S = cg.shape
        C = cx.shape[2]
        n = self.num_negatives
        if gm.shape != cg.shape or mk.shape != cx.shape or cx.shape[:2] != (K, B):
            raise ValueError(
                f"batch shapes disagree: groups {tuple(cg.shape)}, group mask "
                f"{tuple(gm.shape)}, contexts {tuple(cx.shape)}, mask "
                f"{tuple(mk.shape)}"
            )
        alphas_t = self._on_device(np.asarray(alphas, np.float32), torch.float32)
        if alphas_t.shape != (K,):
            raise ValueError(f"alphas must have shape ({K},)")
        self._check_data_split(B, "batch")
        # Step i's negatives (K, B, C, n) or pools (K, P): handed in, or
        # drawn in the loop.
        Ps = self.shared_negatives
        given, name, shape = (
            (pools, "pools", (K, Ps)) if Ps else (negs, "negs", (K, B, C, n))
        )
        if given is not None:
            given = self._on_device(given, torch.int32)
            if given.shape != shape:
                raise ValueError(f"{name} must have shape {shape}")
        else:
            prob, alias = self.noise_tables()
            rows = torch.arange(B, dtype=torch.int64, device=self.device)
        losses = torch.empty(K, dtype=torch.float32, device=self.device)
        for i in range(K):
            if self._meshed:
                key = rnd.fold_in(int(base_key), (int(step0) + i) & 0xFFFFFFFF)
                losses[i] = self._mesh_step(
                    cg[i], gm[i], cx[i], mk[i], alphas_t[i],
                    self._noise_fn(key, given, i, C,
                                   self.mesh.process_index * B))
                continue
            if given is not None:
                ng = given[i]
            else:
                key = rnd.fold_in(int(base_key), (int(step0) + i) & 0xFFFFFFFF)
                ng = (sample_negatives(key, prob, alias, (Ps,)) if Ps
                      else sample_negatives_per_row(key, prob, alias, rows, (C, n)))
            losses[i] = self._composed_step(
                cg[i], gm[i], cx[i], mk[i], alphas_t[i], ng
            )
        self._tick_tables("train_steps")
        return losses

    def write_rows(self, start_row: int, rows) -> None:
        """Overwrite ``rows.shape[0]`` consecutive syn0 rows from
        ``start_row`` on (fp32 rows, rounded to the storage dtype), on the
        device: how fastText assembles its table of composed word
        vectors."""
        if not isinstance(rows, torch.Tensor):
            rows = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.float32))
        m = rows.shape[0]
        if rows.dim() != 2 or rows.shape[1] != self.dim:
            raise ValueError(f"rows must have shape (m, {self.dim})")
        if not 0 <= start_row <= self.num_rows - m:
            raise ValueError(
                f"rows [{start_row}, {start_row + m}) outside the table's "
                f"{self.num_rows} rows"
            )
        self._set_rows(0, start_row, rows)
        self._tick_tables("write_rows")
        self._ann_touch_rows(range(start_row, start_row + m))

    def _set_rows(self, i: int, start: int, vals: torch.Tensor) -> None:
        """Overwrite rows ``[start, start + m)`` of table ``i`` (0: syn0,
        1: syn1) with the fp32 ``(m, dim)`` ``vals``, rounded to the
        storage dtype, in whichever shards hold them."""
        m = vals.shape[0]
        for k, t in enumerate(self._shards[i]):
            (r0, r1), (c0, c1) = self._shard_range(k)
            lo, hi = max(start, r0), min(start + m, r1)
            c1 = min(c1, self.dim)
            if lo >= hi or c0 >= c1:
                continue
            t[lo - r0:hi - r0, :c1 - c0] = vals[lo - start:hi - start, c0:c1].to(
                t.device, self._dtype)

    # ------------------------------------------------------------------
    # Vocabulary growth (the streaming trainer's spare extra rows)
    # ------------------------------------------------------------------

    @property
    def extra_rows_total(self) -> int:
        """Spare non-vocabulary rows reserved at construction."""
        return self.num_rows - self.vocab_size

    @property
    def extra_rows_free(self) -> int:
        """Spare rows :meth:`assign_extra_rows` can still claim."""
        return self.extra_rows_total - self.extra_rows_assigned

    def _extra_row_init(self, start: int, m: int) -> torch.Tensor:
        """The fresh syn0 rows ``[start, start + m)``: word2vec's ``U[-0.5/d,
        0.5/d)``, element ``(r, j)`` from the counter hash under
        ``fold_in(fold_in(seed_key(seed), 2^30 + r), j)``. Each row depends
        on its global index alone, so a batch of rows equals the same rows
        assigned one at a time."""
        d = self.dim
        rows = torch.arange(start, start + m, dtype=torch.int64,
                            device=self.device) + (1 << 30)
        cols = torch.arange(d, dtype=torch.int64, device=self.device)
        keys = rnd.fold_in(rnd.fold_in(rnd.seed_key(self._seed), rows)[:, None],
                           cols[None, :])
        return (rnd.uniform(keys) - 0.5) * (1.0 / d)

    def assign_extra_rows(self, words) -> list:
        """Claim the next ``len(words)`` spare extra rows in one mutation
        (``engine.py:2135`` of the JAX package): each syn0 row gets its
        fresh init (:meth:`_extra_row_init`) and each syn1 row zeros, with
        one ``table_version`` tick for the batch. Returns the claimed
        global rows, always the next ones after ``queryable_rows``, so the
        caller's grown word list stays aligned with the table. ``words``
        feed the event only."""
        words = list(words)
        n = len(words)
        if n == 0:
            return []
        if n > self.extra_rows_free:
            raise ValueError(
                f"no spare extra rows left for {n} word(s) "
                f"({self.extra_rows_assigned}/{self.extra_rows_total} "
                "assigned); construct the engine with more extra_rows "
                "headroom"
            )
        start = self.vocab_size + self.extra_rows_assigned
        self._set_rows(0, start, self._extra_row_init(start, n))
        self._set_rows(1, start, torch.zeros((n, self.dim)))
        self.extra_rows_assigned += n
        self._tick_tables("assign_extra_row")
        self._ann_touch_rows(range(start, start + n))
        return list(range(start, start + n))

    def assign_extra_row(self, word: Optional[str] = None) -> int:
        """:meth:`assign_extra_rows` of one word; returns its row."""
        return self.assign_extra_rows([word])[0]

    def free_extra_rows(self, n: Optional[int] = None) -> int:
        """Release the last ``n`` assigned extra rows (default: all),
        zeroing both tables' rows so a later assignment never sees the
        previous word's values. Returns the number freed; one
        ``table_version`` tick unless it is 0."""
        if n is None:
            n = self.extra_rows_assigned
        n = int(n)
        if n < 0 or n > self.extra_rows_assigned:
            raise ValueError(
                f"cannot free {n} extra rows "
                f"({self.extra_rows_assigned} assigned)"
            )
        if n == 0:
            return 0
        start = self.vocab_size + self.extra_rows_assigned - n
        zeros = torch.zeros((n, self.dim))
        self._set_rows(0, start, zeros)
        self._set_rows(1, start, zeros)
        self.extra_rows_assigned -= n
        self._tick_tables("free_extra_rows")
        if self._ann is not None:
            from glint_word2vec_torch.ops import ann as _ann_mod

            _ann_mod.remove_rows(self._ann, self.logical_table(0),
                                 range(start, start + n))
            self._ann.table_version = self.table_version
        return n

    def _ann_touch_rows(self, rows) -> None:
        """Re-bucket rows whose values just changed into the adopted ANN
        index (only those rows move); a no-op without one. The index's
        version follows the table's."""
        if self._ann is None:
            return
        from glint_word2vec_torch.ops import ann as _ann_mod

        _ann_mod.update_rows(self._ann, self.logical_table(0), self.norms(), rows)
        self._ann.table_version = self.table_version

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------

    # ------------------------------------------------------------------
    # Replica exchange (parallel/exchange.py)
    # ------------------------------------------------------------------

    def exchange_adopt(self, syn0: torch.Tensor, syn1: torch.Tensor, *,
                       touched_ids=None) -> None:
        """Install the tables a replica-exchange round rebuilt (``base``
        plus every rank's deltas): two attribute flips and one
        ``table_version`` tick, like :meth:`adopt_tables`.
        ``touched_ids`` (a host array of the rows the round changed)
        narrows the skip-clean save's dirty shards to the row blocks
        holding them; None dirties every shard."""
        self.syn0 = syn0
        self.syn1 = syn1
        self._mark_shards_dirty(touched_ids)
        self._tick_tables("exchange_adopt")

    def _mark_shards_dirty(self, touched_ids=None) -> None:
        """Fold one mutation's touched rows into the dirty shard files:
        merged, never narrowed (``engine.py:1923-1947`` of the JAX
        package). Column blocks span every row, so ``dims`` always goes
        all dirty."""
        if touched_ids is None or self.layout != "rows":
            self._shard_dirty = None
            return
        if self._shard_dirty is None:
            return
        per = self._block_rows()
        for start in np.unique(np.asarray(touched_ids, np.int64) // per) * per:
            if 0 <= start < self.num_rows:
                for name in ("syn0", "syn1"):
                    self._shard_dirty[f"{name}.r{start:012d}.npy"] = True

    def _shard_is_dirty(self, fname: str, path: str) -> bool:
        """Whether an in-place save to ``path`` must write ``fname``: True
        unless the last committed save to this path wrote it and nothing
        has dirtied it since."""
        if self._shard_clean_path != path or self._shard_dirty is None:
            return True
        return bool(self._shard_dirty.get(fname, True))

    def _mark_shards_clean(self, path: str, fnames) -> None:
        if self._shard_clean_path != path or self._shard_dirty is None:
            self._shard_dirty = {}
            self._shard_clean_path = path
        for f in fnames:
            self._shard_dirty[f] = False

    def _block_rows(self) -> int:
        """Rows a ``rows`` shard file holds: the save split's block, or
        the mesh's rows per shard."""
        if self._save_split is not None:
            return max(1, -(-self.num_rows // self._save_split[1]))
        return self.rows_per_shard

    def _note_exchange(self, *, bytes_sent: int, rows: int, overflow: bool,
                       dense: bool, seconds: float, wire: str = "fp32",
                       groups: int = 1, flush: bool = False,
                       world1_skip: bool = False, intra_bytes: int = 0,
                       capacity: Optional[int] = None,
                       cap_event: Optional[str] = None,
                       residual_abs: float = 0.0) -> None:
        """Fold one exchange round into :meth:`exchange_stats`."""
        st = self._exchange_stats
        st["exchange_bytes_total"] += int(bytes_sent)
        st["exchange_rows_total"] += int(rows)
        st["exchange_overflow_total"] += int(bool(overflow))
        st["exchange_syncs_total"] += 1
        st["exchange_dense_syncs_total"] += int(bool(dense))
        st["exchange_last_seconds"] = round(float(seconds), 6)
        wire_key = "exchange_bytes_wire_%s_total" % (
            wire if wire in ("fp32", "bf16", "int8") else "fp32")
        st[wire_key] += int(bytes_sent)
        st["exchange_groups_total"] += int(groups)
        st["exchange_flushes_total"] += int(bool(flush))
        st["exchange_world1_skips_total"] += int(bool(world1_skip))
        st["exchange_intra_bytes_total"] += int(intra_bytes)
        st["exchange_inter_bytes_total"] += max(int(bytes_sent) - int(intra_bytes), 0)
        if capacity is not None:
            st["exchange_capacity"] = int(capacity)
        st["exchange_capacity_grows_total"] += int(cap_event == "grow")
        st["exchange_capacity_shrinks_total"] += int(cap_event == "shrink")
        st["exchange_residual_abs"] = float(residual_abs)

    def _note_exchange_stages(self, seconds: dict) -> None:
        """Fold one round's seconds by stage (``ReplicaExchanger``'s clock:
        device time on the card, the wire's host time between) into
        ``exchange_stats()["exchange_stage_seconds"]``."""
        tot = self._exchange_stats.setdefault("exchange_stage_seconds", {})
        for k, v in seconds.items():
            tot[k] = round(tot.get(k, 0.0) + float(v), 6)

    def exchange_stats(self) -> dict:
        """The replica exchange's counters for the heartbeat (zeros until
        a :class:`~glint_word2vec_torch.parallel.exchange.ReplicaExchanger`
        runs a round). Host values only."""
        out = dict(self._exchange_stats)
        if "exchange_stage_seconds" in out:
            out["exchange_stage_seconds"] = dict(out["exchange_stage_seconds"])
        return out

    def tables_digest(self) -> str:
        """sha256 of both tables' bytes in storage dtype (the first
        ``num_rows`` rows), copied to the host ``_IO_ROWS`` rows at a
        time: what a gang's ranks compare to show their replicas equal."""
        import hashlib

        h = hashlib.sha256()
        for table in (self.logical_table(0), self.logical_table(1)):
            for s in range(0, self.num_rows, _IO_ROWS):
                part = table[s:min(s + _IO_ROWS, self.num_rows), : self.dim]
                if part.dtype == torch.bfloat16:
                    part = part.contiguous().view(torch.int16)
                h.update(part.cpu().numpy().tobytes())
        return h.hexdigest()

    def set_save_split(self, rank: int, world: int) -> None:
        """Split sharded saves across the replicas of a gang: the tables
        (the same on every rank) are cut into ``world`` row blocks and
        this engine writes only block ``rank``, its sidecar manifest and,
        on rank 0, ``counts.npy``, ``engine.json`` and ``manifest.json``,
        all in place into the shared directory; the caller's barrier then
        orders every rank's writes before the state flip. ``world <= 1``
        clears the split."""
        if world <= 1:
            self._save_split = None
            return
        if self.layout != "rows":
            raise ValueError("save split requires the rows layout")
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} not in [0, {world})")
        self._save_split = (int(rank), int(world))
        self._shard_dirty = None

    def _split_blocks(self):
        """``(rank, [(name, table, file name, start, stop)])``: every row
        block of the save split (each table cut into ``world`` blocks of
        ``ceil(rows / world)``) and this engine's rank."""
        rank, world = self._save_split
        per = max(1, -(-self.num_rows // world))
        blocks = []
        for name, table in (("syn0", self.logical_table(0)),
                            ("syn1", self.logical_table(1))):
            for k in range(world):
                start, stop = k * per, min((k + 1) * per, self.num_rows)
                if start < stop:
                    blocks.append((k, name, table, f"{name}.r{start:012d}.npy",
                                   start, stop))
        return rank, blocks

    def _save_split_blocks(self, path: str) -> None:
        """The sharded save of one rank of a gang (:meth:`set_save_split`):
        in place into ``path``, every file through temp +
        ``os.replace``; rank 0 writes the small files and the version-2
        manifest that names every rank's blocks. The commit point is the
        caller's barrier and ``train_state.json`` flip."""
        from glint_word2vec_torch.utils import atomic_write_json, atomic_write_npy

        t0 = time.time()
        os.makedirs(path, exist_ok=True)
        t_shards = 0.0
        rank, blocks = self._split_blocks()
        for k, _, table, fname, start, stop in blocks:
            if k != rank:
                continue
            ts = time.time()
            obs_events.emit("ckpt_shard_write", file=fname, rank=rank)
            atomic_write_npy(os.path.join(path, fname),
                             self._host_rows(table, start, stop))
            integrity.write_shard_manifest(
                path, fname,
                integrity.build_shard_manifest(path, fname, self.table_version),
            )
            t_shards += time.time() - ts
        if rank == 0:
            meta = self._save_meta("sharded")
            meta["shards"] = {"syn0": [], "syn1": []}
            for _, name, _, fname, start, stop in blocks:
                meta["shards"][name].append({"file": fname, "start": start,
                                             "stop": stop, "axis": "rows"})
            atomic_write_npy(os.path.join(path, "counts.npy"),
                             np.asarray(self._counts, np.int64))
            atomic_write_json(os.path.join(path, "engine.json"), meta)
            manifest = integrity.build_manifest(
                path, ["counts.npy", "engine.json"], self.table_version,
                table_dtype=self.dtype,
            )
            manifest.update(version=2, shard_files=sorted(
                b["file"] for t in meta["shards"].values() for b in t))
            integrity.write_manifest(path, manifest)
        self._ckpt_last_write_s = time.time() - t0
        self._ckpt_last_commit = time.time()
        self._ckpt_shard_write_s = round(t_shards, 6)

    def _save_meta(self, mode: str) -> dict:
        return {
            "format": mode,
            "layout": self.layout,
            "vocab_size": self.vocab_size,
            "dim": self.dim,
            "num_negatives": self.num_negatives,
            "unigram_power": self.unigram_power,
            "unigram_table_size": self.unigram_table_size,
            "extra_rows": self.num_rows - self.vocab_size,
            "extra_rows_assigned": self.extra_rows_assigned,
            "dtype": self.dtype,
            "shared_negatives": self.shared_negatives,
        }

    def _host_table(self, table: torch.Tensor) -> np.ndarray:
        """A copy of the first ``num_rows`` rows of ``table`` as a new host
        fp32 array, ``_IO_ROWS`` rows a transfer. From the card each
        transfer waits for the work queued before it, so the copy holds
        the table as it stood when it was asked for, whatever the caller
        enqueues next."""
        return self._host_rows(table, 0, self.num_rows)

    def _host_rows(self, table: torch.Tensor, start: int, stop: int) -> np.ndarray:
        """Rows ``[start, stop)`` of ``table`` as a new host fp32 array, as
        :meth:`_host_table` copies them."""
        out = np.empty((stop - start, self.dim), np.float32)
        for s in range(start, stop, _IO_ROWS):
            e = min(s + _IO_ROWS, stop)
            torch.from_numpy(out[s - start:e - start]).copy_(
                table[s:e, : self.dim].float())
        return out

    def _snapshot_host(self, mode: str, *, lazy: bool = False):
        """The host half of a save: ``(files, meta)``, where ``files`` is
        the list of ``(file name, array)`` blocks (both tables, then
        ``counts.npy``) and ``meta`` the ``engine.json`` dict. ``lazy``
        (the blocking save) leaves each table as a zero-argument callable
        that copies it when the write reaches it, so host memory holds
        one table at a time; otherwise both tables are copied here (the
        asynchronous save, whose caller goes on training)."""
        if mode not in ("sharded", "single"):
            raise ValueError("mode must be 'sharded' or 'single'")
        meta = self._save_meta(mode)
        if mode == "sharded" and self._meshed:
            meta["shards"], blocks = self._mesh_blocks()
            files = [(f, p if lazy else p()) for f, p in blocks]
            files.append(("counts.npy", np.asarray(self._counts, np.int64).copy()))
            return files, meta
        if mode == "sharded":
            meta["shards"] = {}
            for name in ("syn0", "syn1"):
                meta["shards"][name] = [{
                    "file": f"{name}.r{0:012d}.npy", "start": 0,
                    "stop": self.num_rows, "axis": "rows",
                }]
            names = [f"{name}.r{0:012d}.npy" for name in ("syn0", "syn1")]
        else:
            names = ["syn0.npy", "syn1.npy"]
        files = []
        for fname, table in zip(names, (self.logical_table(0),
                                        self.logical_table(1))):
            files.append((fname, (lambda t=table: self._host_table(t))
                          if lazy else self._host_table(table)))
        files.append(("counts.npy", np.asarray(self._counts, np.int64).copy()))
        return files, meta

    def _mesh_blocks(self):
        """``(manifest, [(file name, producer)])`` of a mesh's sharded
        save: one block per model shard and table, never one per data
        rank: ``{name}.r…`` row blocks (``rows``) or ``{name}.c…``
        column blocks (``dims``), padding cut off and pure-padding blocks
        skipped. Each producer copies its shard to a host fp32 array."""
        manifest = {"syn0": [], "syn1": []}
        blocks = []
        axis = "rows" if self.layout == "rows" else "cols"
        for i, name in enumerate(("syn0", "syn1")):
            for m, t in enumerate(self._shards[i]):
                (r0, r1), (c0, c1) = self._shard_range(m)
                if axis == "rows":
                    start, stop = r0, min(r1, self.num_rows)
                else:
                    start, stop = c0, min(c1, self.dim)
                if start >= stop:
                    continue
                fname = f"{name}.{axis[0]}{start:012d}.npy"
                manifest[name].append({"file": fname, "start": start,
                                       "stop": stop, "axis": axis})
                rows = stop - start if axis == "rows" else self.num_rows
                cols = self.dim if axis == "rows" else stop - start

                def produce(t=t, rows=rows, cols=cols):
                    out = np.empty((rows, cols), np.float32)
                    for s in range(0, rows, _IO_ROWS):
                        e = min(s + _IO_ROWS, rows)
                        torch.from_numpy(out[s:e]).copy_(t[s:e, :cols].float())
                    return out

                blocks.append((fname, produce))
        return manifest, blocks

    @staticmethod
    def _commit_snapshot_dir(tmp: str, path: str) -> None:
        """The commit point of a fresh snapshot directory: one atomic
        rename (a seam of its own, so a test can fail the write between
        the temp directory and the rename)."""
        os.rename(tmp, path)

    def _write_snapshot(self, path: str, files, meta: dict,
                        table_version: int) -> None:
        """Write a host snapshot in the JAX package's layout: the table
        blocks (each shard with its sidecar manifest), ``counts.npy``,
        ``engine.json`` and ``manifest.json``, which names everything else
        by sha256 and size. A fresh ``path`` is written as a temp
        directory and committed with one rename, so a crash at any point
        before it leaves only an unreferenced ``*.tmp-*`` directory; an
        existing ``path`` is updated file by file through temp +
        ``os.replace``, ``engine.json`` and ``manifest.json`` last. Every
        file and the directories are fsync'd unless
        ``GLINT_CKPT_NO_FSYNC=1``. Runs on the writer thread for an
        asynchronous save: it touches host arrays only.

        The fresh directory's rename is the commit that fires the fault
        points ``ckpt.pre_rename`` (before it) and ``ckpt.post_rename``
        (after it), as the JAX package's single-writer commit does. Each
        shard block fires ``ckpt.shard_commit`` once written. An in-place
        update fires neither rename point, nor does a gang's per-block
        save (:meth:`_save_split_blocks`), whose commit is its caller's
        barrier."""
        t0 = time.time()
        fsync = os.environ.get("GLINT_CKPT_NO_FSYNC", "0") != "1"
        shard_set = {b["file"] for t in (meta.get("shards") or {}).values()
                     for b in t}
        t_shards = 0.0

        def put(dirpath: str, fname: str, write) -> None:
            tmp_f = os.path.join(dirpath, f"{fname}.tmp.{os.getpid()}")
            with open(tmp_f, "wb") as f:
                write(f)
                if fsync:
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp_f, os.path.join(dirpath, fname))

        fresh = not os.path.exists(path)
        target = f"{path}.tmp-{os.getpid()}" if fresh else path
        if fresh:
            shutil.rmtree(target, ignore_errors=True)
            os.makedirs(target)
        eager = sum(a.nbytes for _, a in files if not callable(a))
        peak = eager
        for fname, arr in files:
            # Skip-clean: an in-place save leaves a shard file the last
            # committed save to this path wrote, if nothing changed it.
            if (not fresh and fname in shard_set
                    and not self._shard_is_dirty(fname, path)
                    and os.path.exists(os.path.join(path, fname))
                    and os.path.exists(os.path.join(
                        path, fname + integrity.SHARD_MANIFEST_SUFFIX))):
                self._ckpt_shards_skipped += 1
                continue
            if callable(arr):
                arr = arr()
                peak = max(peak, eager + arr.nbytes)
            ts = time.time()
            put(target, fname, lambda f, a=arr: np.save(f, a))
            del arr
            if fname in shard_set:
                integrity.write_shard_manifest(
                    target, fname,
                    integrity.build_shard_manifest(target, fname, table_version),
                    fsync=fsync,
                )
                faults.fire("ckpt.shard_commit")
                t_shards += time.time() - ts
        put(target, "engine.json", lambda f: f.write(json.dumps(meta).encode()))
        manifest = integrity.build_manifest(
            target,
            [f for f, _ in files if f not in shard_set] + ["engine.json"],
            table_version,
            table_dtype=self.dtype,
        )
        if shard_set:
            manifest.update(version=2, shard_files=sorted(shard_set))
        integrity.write_manifest(target, manifest, fsync=fsync)
        if fsync:
            _fsync_dir(target)
        if fresh:
            faults.fire("ckpt.pre_rename")
            self._commit_snapshot_dir(target, path)
            faults.fire("ckpt.post_rename")
            if fsync:
                _fsync_dir(os.path.dirname(os.path.abspath(path)))
        self._ckpt_last_write_s = time.time() - t0
        self._ckpt_last_commit = time.time()
        self._ckpt_shard_write_s = round(t_shards, 6)
        self._ckpt_peak_block_bytes = int(peak)

    def save(self, path: str, mode: str = "sharded") -> None:
        """Write both tables, ``counts.npy``, ``engine.json`` and the
        integrity manifests in the JAX package's layout, blocking until
        committed (:meth:`_write_snapshot`).

        ``mode="sharded"`` writes one row block per table (this engine
        holds all rows on one device: ``syn0.r000000000000.npy``) with its
        sidecar manifest; ``mode="single"`` writes ``syn0.npy`` and
        ``syn1.npy``."""
        if self._save_split is not None and mode == "sharded":
            self._save_split_blocks(path)
            return
        files, meta = self._snapshot_host(mode, lazy=True)
        self._write_snapshot(path, files, meta, self.table_version)
        if mode == "sharded":
            self._mark_shards_clean(path, [
                b["file"] for t in meta["shards"].values() for b in t])

    def async_saves_enabled(self) -> bool:
        """Whether :meth:`save_async` writes in the background: unless
        ``GLINT_SYNC_CKPT=1`` asks for blocking saves, or a save split
        (a gang) needs its cross-rank barrier before the state flip."""
        return (self._save_split is None
                and os.environ.get("GLINT_SYNC_CKPT", "0") != "1")

    def save_async(self, path: str, mode: str = "sharded",
                   on_commit=None) -> bool:
        """:meth:`save` without the wait: the caller blocks for the copy
        of both tables to host memory alone, and the single writer thread
        (``utils/async_ckpt.py``) writes and commits them, then runs
        ``on_commit`` (the fit loops flip ``train_state.json`` there), so
        a crash mid-write never leaves the state naming a partial
        snapshot. At most one snapshot is in flight: a second request
        first waits for the first (``async_save_waits``). Under
        ``GLINT_SYNC_CKPT=1`` it saves and commits before returning, and
        returns False."""
        if not self.async_saves_enabled():
            self.save(path, mode)
            self._ckpt_forced_sync += 1
            if on_commit is not None:
                on_commit()
            return False
        if self._ckpt_writer is None:
            from glint_word2vec_torch.utils.async_ckpt import AsyncSnapshotWriter

            self._ckpt_writer = AsyncSnapshotWriter()
        writer = self._ckpt_writer
        # Wait for the snapshot in flight before copying this one: host
        # memory holds at most one extra table pair.
        writer.wait_for_slot()
        files, meta = self._snapshot_host(mode)
        tv = self.table_version

        def job():
            with obs_events.span("ckpt_write", ckpt=path):
                self._write_snapshot(path, files, meta, tv)
                if on_commit is not None:
                    on_commit()

        writer.submit(job, label=path)
        return True

    def wait_pending_saves(self, *, reraise: bool = True,
                           timeout=None) -> None:
        """Block until no asynchronous save is in flight. A failed write
        raises here unless ``reraise=False`` (the exception path, which
        must not mask the original failure); a writer still busy after
        ``timeout`` seconds raises ``SnapshotWriterHung``."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.wait(reraise=reraise, timeout=timeout)

    def checkpoint_stats(self) -> dict:
        """Checkpoint telemetry for the heartbeat: ``pending_async_saves``
        (0 or 1), ``async_save_waits`` (requests that waited for the one
        in flight), ``checkpoint_write_seconds`` (the last write),
        ``last_checkpoint_age_seconds`` (since the last commit; None
        before any), ``forced_sync_saves`` and
        ``checkpoint_shard_write_seconds``. Host values only."""
        w = self._ckpt_writer
        ws = w.stats() if w is not None else {}
        last_write = self._ckpt_last_write_s
        if ws.get("last_write_seconds") is not None:
            last_write = ws["last_write_seconds"]
        last_commit = self._ckpt_last_commit
        if ws.get("last_commit_time") is not None:
            last_commit = max(last_commit or 0.0, ws["last_commit_time"])
        return {
            "pending_async_saves": int(ws.get("pending", 0)),
            "async_save_waits": int(ws.get("blocked_waits", 0)),
            "checkpoint_write_seconds": (
                round(last_write, 4) if last_write is not None else None),
            "last_checkpoint_age_seconds": (
                round(time.time() - last_commit, 2) if last_commit else None),
            "forced_sync_saves": self._ckpt_forced_sync,
            "checkpoint_shard_write_seconds": self._ckpt_shard_write_s,
            "checkpoint_shard_verify_seconds": self._ckpt_shard_verify_s,
            "checkpoint_shards_skipped": int(self._ckpt_shards_skipped),
            "checkpoint_peak_block_bytes": int(self._ckpt_peak_block_bytes),
        }

    #: The settings :meth:`load` may take from its caller instead of the
    #: saved ``engine.json``.
    _LOAD_OVERRIDES = ("layout", "num_negatives", "unigram_power",
                      "unigram_table_size", "dtype", "shared_negatives")

    @classmethod
    def load(cls, path: str, device: DeviceLike = None,
             mesh: Optional[mesh_mod.Mesh] = None,
             **overrides) -> "EmbeddingEngine":
        """Rebuild an engine from a saved directory of either package, any
        format or layout, onto one device or onto ``mesh`` of any shape:
        the blocks are re-sliced to the shards the new mesh holds.
        ``overrides`` replace the saved ``layout``, ``num_negatives``,
        ``unigram_power``, ``unigram_table_size``, ``dtype`` and
        ``shared_negatives``; any other key raises ``TypeError``."""
        unknown = sorted(set(overrides) - set(cls._LOAD_OVERRIDES))
        if unknown:
            raise TypeError(
                f"EmbeddingEngine.load() got unexpected keyword argument(s) "
                f"{', '.join(unknown)}; it takes {', '.join(cls._LOAD_OVERRIDES)}")
        with open(os.path.join(path, "engine.json")) as f:
            meta = json.load(f)
        counts = np.load(os.path.join(path, "counts.npy"))
        eng = cls(
            meta["vocab_size"],
            meta["dim"],
            counts,
            num_negatives=overrides.get("num_negatives", meta["num_negatives"]),
            unigram_power=overrides.get(
                "unigram_power", meta.get("unigram_power", 0.75)),
            unigram_table_size=overrides.get(
                "unigram_table_size", meta.get("unigram_table_size")),
            dtype=overrides.get("dtype", meta["dtype"]),
            extra_rows=meta.get("extra_rows", 0),
            shared_negatives=overrides.get(
                "shared_negatives", meta.get("shared_negatives", 0)),
            device=None if mesh is not None else device,
            mesh=mesh,
            layout=overrides.get("layout") or meta.get("layout", "rows"),
        )
        eng.load_tables(path)
        return eng

    def load_tables(self, path: str, *, verify: bool = True) -> None:
        """Install the tables of a saved directory: :meth:`stage_tables`
        then :meth:`adopt_tables`."""
        self.adopt_tables(self.stage_tables(path, verify=verify))

    def stage_tables(self, path: str, *, verify: bool = True) -> dict:
        """Read a saved directory into new device tensors without touching
        the live tables. With ``verify`` (the default) ``manifest.json``
        and the shard sidecars are checked first (sizes and sha256, sizes
        alone under ``GLINT_CKPT_NO_VERIFY=1``): any mismatch or a partial
        directory raises
        :class:`~glint_word2vec_torch.utils.integrity.CheckpointCorruptError`
        (a directory with no manifest loads unverified). Raises
        ``ValueError`` when the saved geometry differs from this
        engine's."""
        if verify:
            tv0 = time.time()
            integrity.verify_snapshot_dir(path)
            self._ckpt_shard_verify_s = round(time.time() - tv0, 6)
        with open(os.path.join(path, "engine.json")) as f:
            meta = json.load(f)
        if (meta["vocab_size"], meta.get("extra_rows", 0), meta["dim"]) != (
            self.vocab_size, self.num_rows - self.vocab_size, self.dim
        ):
            raise ValueError(
                f"checkpoint at {path} has geometry "
                f"(V={meta['vocab_size']}, extra={meta.get('extra_rows', 0)}, "
                f"d={meta['dim']}), engine has (V={self.vocab_size}, "
                f"extra={self.num_rows - self.vocab_size}, d={self.dim})"
            )
        fmt = meta.get("format", "single")
        staged = {"meta": meta}
        for name in ("syn0", "syn1"):
            # Source blocks as (row range, col range, data): row blocks of
            # the rows layout, column blocks of the dims layout, or one
            # whole-table file.
            if fmt == "sharded":
                blocks = []
                for b in meta["shards"][name]:
                    data = np.load(os.path.join(path, b["file"]), mmap_mode="r")
                    if b.get("axis", "rows") == "rows":
                        blocks.append(
                            ((b["start"], b["stop"]), (0, data.shape[1]), data)
                        )
                    else:
                        blocks.append(
                            ((0, data.shape[0]), (b["start"], b["stop"]), data)
                        )
            else:
                arr = np.load(os.path.join(path, f"{name}.npy"), mmap_mode="r")
                blocks = [((0, arr.shape[0]), (0, arr.shape[1]), arr)]
            if self._meshed:
                staged[name] = [self._stage_shard(m, blocks)
                                for m in range(self.num_model)]
                continue
            table = torch.empty(
                (self.padded_vocab, self.dim), dtype=self._dtype,
                device=self.device,
            )
            with self._side_stream(table):
                table.zero_()
                for (r0, r1), (c0, c1), data in blocks:
                    r1, c1 = min(r1, self.num_rows), min(c1, self.dim)
                    if (isinstance(data, np.memmap) and data.dtype == "<f4"
                            and data.flags.c_contiguous and c0 == 0
                            and data.shape[1] == c1 == self.dim):
                        self._upload_rows(table, data, r0, r1)
                        continue
                    for s in range(r0, r1, _IO_ROWS):
                        e = min(s + _IO_ROWS, r1)
                        part = np.array(data[s - r0 : e - r0, : c1 - c0],
                                        np.float32)
                        # fp32 -> storage dtype on the device rounds to
                        # nearest even, as the JAX package's astype does.
                        table[s:e, c0:c1] = torch.from_numpy(part).to(
                            self.device
                        ).to(self._dtype)
            staged[name] = table
        return staged

    def _stage_shard(self, m: int, blocks) -> torch.Tensor:
        """Shard ``m`` of a table on a mesh, assembled from the source
        blocks' overlap with its row and column ranges into one
        shard-sized host buffer, then copied to its device in storage
        dtype: a restore holds one shard in host memory at a time."""
        (r0, r1), (c0, c1) = self._shard_range(m)
        out = np.zeros((r1 - r0, c1 - c0), np.float32)
        for (br0, br1), (bc0, bc1), data in blocks:
            rlo, rhi = max(r0, br0), min(r1, br1, self.num_rows)
            clo, chi = max(c0, bc0), min(c1, bc1, self.dim)
            if rlo < rhi and clo < chi:
                out[rlo - r0:rhi - r0, clo - c0:chi - c0] = data[
                    rlo - br0:rhi - br0, clo - bc0:chi - bc0]
        self._stage_peak_block_bytes = max(self._stage_peak_block_bytes,
                                           out.nbytes)
        dev = self.mesh.model_devices[m]
        return torch.from_numpy(out).to(dev).to(self._dtype)

    def _upload_rows(self, table: torch.Tensor, data: np.memmap,
                     r0: int, r1: int) -> None:
        """Copy rows ``[0, r1 - r0)`` of the fp32 ``.npy`` file behind
        ``data`` into ``table[r0:r1]``: read straight from the file in
        ``_UPLOAD_BYTES`` slices into two host buffers (pinned on the
        card, so each slice's copy runs while the next is read), then a
        device-side cast to the table's dtype, which rounds to nearest
        even as the JAX package's astype does."""
        cols = data.shape[1]
        chunk = max(1, _UPLOAD_BYTES // (4 * cols))
        pin = self.device.type == "cuda"
        bufs = [torch.empty(chunk * cols, dtype=torch.float32, pin_memory=pin)
                for _ in range(2)]
        done = [None, None]
        with open(data.filename, "rb") as f:
            for k, s in enumerate(range(r0, r1, chunk)):
                e = min(s + chunk, r1)
                n = (e - s) * cols
                if done[k % 2] is not None:
                    done[k % 2].synchronize()  # the buffer's last copy ended
                f.seek(data.offset + (s - r0) * 4 * cols)
                host = bufs[k % 2][:n]
                if f.readinto(memoryview(host.numpy()).cast("B")) != 4 * n:
                    raise OSError(f"{data.filename}: short read at row {s - r0}")
                src = host.view(e - s, cols)
                if table.dtype != torch.float32:
                    src = src.to(self.device, non_blocking=pin)
                table[s:e].copy_(src, non_blocking=pin)
                if pin:
                    done[k % 2] = torch.cuda.Event()
                    done[k % 2].record()
        for ev in done:
            if ev is not None:
                ev.synchronize()

    @contextlib.contextmanager
    def _side_stream(self, table: torch.Tensor):
        """Run the block's copies into ``table`` (allocated on the current
        stream) on a stream of their own, so they do not queue behind, or
        hold up, the queries other models of the process dispatch
        meanwhile. The stream is drained before the block returns, and
        ``record_stream`` tells the caching allocator the table was used
        there. A no-op off the card."""
        if self.device.type != "cuda":
            yield
            return
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(cur)  # the allocation precedes the copies
        with torch.cuda.stream(side):
            yield
        table.record_stream(side)
        side.synchronize()

    def adopt_tables(self, staged: dict) -> None:
        """Make a :meth:`stage_tables` result the live tables: two
        attribute flips and one ``table_version`` tick."""
        for i, name in enumerate(("syn0", "syn1")):
            t = staged[name]
            if isinstance(t, list):
                self._shards[i] = t
            else:
                setattr(self, name, t)
        self.extra_rows_assigned = int(
            staged["meta"].get("extra_rows_assigned", 0)
        )
        self._tick_tables("load_tables")

    def set_tables(self, syn0, syn1) -> None:
        """Install a copy of the given table values (all ``num_rows``
        rows), host arrays or tensors on any device, rounded through fp32
        to the storage dtype."""
        if tuple(syn0.shape) != (self.num_rows, self.dim):
            raise ValueError("syn0 shape mismatch")
        if tuple(syn1.shape) != (self.num_rows, self.dim):
            raise ValueError("syn1 shape mismatch")
        for name, arr in (("syn0", syn0), ("syn1", syn1)):
            if not isinstance(arr, torch.Tensor):
                arr = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
            t = arr.to(self.device, torch.float32)
            setattr(self, name, t.to(self._dtype, copy=True).contiguous())
        self._tick_tables("set_tables")

    def resident_bytes(self) -> int:
        """Device bytes of the live tables and an adopted ANN index
        (``centroids``, ``members``, ``member_invn``, ``member_rows``): the
        cost a serving catalog's memory budget counts. 0 after
        :meth:`release_tables`."""
        n = 0
        for sh in self._shards:
            for t in sh or ():
                n += t.numel() * t.element_size()
        idx = self._ann
        if idx is not None:
            for name in ("centroids", "members", "member_invn", "member_rows"):
                t = getattr(idx, name, None)
                if t is not None:
                    n += t.numel() * t.element_size()
        return n

    @property
    def tables_resident(self) -> bool:
        """Whether the tables are in device memory (False between
        :meth:`release_tables` and the next adopt)."""
        return self._shards[0] is not None

    def release_tables(self) -> None:
        """Free the tables' and the ANN index's device memory, after any
        pending asynchronous save has drained; :meth:`load_tables` (or
        :meth:`stage_tables` and :meth:`adopt_tables`) makes the engine
        answer again, on the query shapes it already dispatched."""
        self.wait_pending_saves(reraise=False)
        self.syn0 = self.syn1 = self._ann = None
        self._tick_tables("release_tables")

    def destroy(self) -> None:
        """Free every device buffer of the engine."""
        self.release_tables()
        self._noise = self._corpus = self._corpus_compacted = None
        self._corpus_n_valid = None
        self._compact_prefetch = self._keep_prob = None


class TrainingDraws:
    """The draws of the packed training steps, from ``ops/random.py``
    words under one base key.

    :meth:`shrink` gives the window-shrink draw of each position under the
    grid key schedule (``device_batching.grid_window_shrink``),
    :meth:`negatives` the per-pair-row negatives of one step under
    ``fold_in(base_key, step)`` (``sampling.sample_negatives_per_row``),
    and :meth:`pool` the step's shared pool under the same key, with no
    per-row fold (``sampling.sample_negatives``). The grid steps of the
    device corpus take :meth:`step_shrink`, the shrinks of one grid
    step's rows, and :meth:`window_negatives`, its rows' ``(C, n)``
    negatives. Tests hand the engine another object with these methods to
    replay the JAX package's draws."""

    def __init__(self, base_key: int, prob: torch.Tensor, alias: torch.Tensor,
                 window: int, grid_batch: int, num_negatives: int):
        self.base_key = int(base_key)
        self.prob, self.alias = prob, alias
        self.window, self.grid_batch = int(window), int(grid_batch)
        self.num_negatives = int(num_negatives)

    def shrink(self, positions: torch.Tensor, grid_step0: int) -> torch.Tensor:
        return dbat.grid_window_shrink(
            self.base_key, positions, self.grid_batch, grid_step0, self.window
        )

    def negatives(self, step: int, n_rows: int, row0: int = 0) -> torch.Tensor:
        """Step ``step``'s ``(n_rows, n)`` negatives of pair rows ``row0``
        on: a data rank of a mesh draws its own rows alone."""
        rows = torch.arange(row0, row0 + n_rows, dtype=torch.int64,
                            device=self.prob.device)
        key = rnd.fold_in(self.base_key, int(step) & 0xFFFFFFFF)
        return sample_negatives_per_row(
            key, self.prob, self.alias, rows, (self.num_negatives,)
        )

    def step_shrink(self, step: int, n_rows: int) -> torch.Tensor:
        """The shrinks of grid step ``step``'s rows: row ``r`` draws under
        ``fold_in(fold_in(fold_in(base_key, step), WINDOW_FOLD), r)``, what
        :meth:`shrink` gives the positions that step covers."""
        rows = torch.arange(n_rows, dtype=torch.int64, device=self.prob.device)
        return dbat.grid_window_shrink(
            self.base_key, rows, n_rows, step, self.window
        )

    def window_negatives(self, step: int, n_rows: int, lanes: int,
                         row0: int = 0) -> torch.Tensor:
        """Grid step ``step``'s ``(n_rows, lanes, n)`` negatives of rows
        ``row0`` on, the draws of :meth:`EmbeddingEngine.
        train_steps_grouped`."""
        rows = torch.arange(row0, row0 + n_rows, dtype=torch.int64,
                            device=self.prob.device)
        key = rnd.fold_in(self.base_key, int(step) & 0xFFFFFFFF)
        return sample_negatives_per_row(
            key, self.prob, self.alias, rows, (int(lanes), self.num_negatives)
        )

    def pool(self, step: int, size: int) -> torch.Tensor:
        key = rnd.fold_in(self.base_key, int(step) & 0xFFFFFFFF)
        return sample_negatives(key, self.prob, self.alias, (int(size),))
