"""Touched-row delta exchange between data-parallel replicas (counterpart
of ``glint_word2vec_tpu/parallel/exchange.py``).

Each process of a gang trains its own replica of the tables on its own
corpus shard; after every dispatch group (or every ``every`` groups) the
replicas reconcile only the rows they touched:

  * at a group's start each replica snapshots both tables (a ``clone``:
    the fused step updates the tables in place, so a reference is not a
    snapshot);
  * after the group a diff and an encode find the touched rows (any
    nonzero component of the fp32 delta: one row, one delta) and compact
    their ids into a fixed ``capacity`` buffer by a ``cumsum`` and a
    scatter into ``capacity + 1`` slots, the last one a dump slot: every
    shape is fixed by the capacity and nothing waits for the host until
    the payload's copy to pinned host memory, the one host wait of a
    round;
  * the replicas allgather a small int64 header, then the padded
    payloads (``ProcessTransport`` over gloo, ``distributed.
    allgather_host``);
  * every replica rebuilds ``base + delta_0 + delta_1 + ...`` in rank
    order on an fp32 accumulator and casts once to the table's dtype, so
    all replicas leave the round with the same bits.

The landing site is kernel B3, ``ops/rows.scatter_add_rows``
(``csrc/scatter_runs.cu``): one call a rank onto the fp32 accumulator.
The padding slots all point at row 0 with zero payload, a long run that
B3 sums in a fixed order with no float atomics, and ``x + 0.0`` is ``x``;
each rank's ids are otherwise unique. So the card, the CPU (B3's plain
version) and the JAX package's ``acc.at[ids].add(upd)`` compute the same
bits on the same payloads. The two-level node fold lands through B3 too.

The wire layers keep the JAX module's behaviour and knobs:

* ``wire="fp32"|"bf16"|"int8"``: bf16 rounds each delta once; int8 ships
  a per-row maxabs scale and int8 lanes and keeps the quantization
  residual in an error-feedback carry folded into the next sent rows.
  ``flush()`` ships pending deltas plus the carry exactly and zeroes it
  (the pre-checkpoint hook that keeps resume bitwise).
* ``every=R``: ``group_end`` runs a round every R-th call; drained
  replicas keep calling it with ``live=False, done=True`` so the rounds
  stay aligned across ranks.
* ``topology="twolevel"``: exact fp32 payloads over the intra-node hop,
  folded into one node delta, and only node leaders ship the wire-encoded
  node delta over the inter-node hop (``GLINT_RANKS_PER_NODE``).
* Adaptive capacity: every rank reads the same headers and takes the same
  grow or shrink decision (``GLINT_EXCHANGE_CAPACITY`` or an explicit
  capacity pins it).
* A round whose touched rows overflow the capacity spills to the dense
  path (full fp32 deltas); ``GLINT_DENSE_EXCHANGE=1`` forces it.
* One replica short-circuits the wire (``bytes=0``);
  ``GLINT_EXCHANGE_FORCE_WIRE=1`` restores the loopback protocol.
* The ``exchange.pre_send`` fault point fires before every header
  allgather.

:func:`sync_group` and :func:`flush_group` drive N replicas in one
process through the same helpers (the tests and ``chip_smoke.py``).
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import List, Optional, Sequence

import numpy as np
import torch

from glint_word2vec_torch.ops.rows import scatter_add_rows
from glint_word2vec_torch.utils import faults, next_pow2

#: Supported sparse payload encodings (``--exchange-wire``).
WIRE_FORMATS = ("fp32", "bf16", "int8")

#: Header layout (int64): [live, done, n0, ovf0, n1, ovf1].
HEADER_LEN = 6

#: Adaptive capacity: boundary rounds of high-water history required
#: before a shrink is considered, and the smallest capacity adaptation
#: will pick (the floor ``default_capacity`` uses too).
CAPACITY_WINDOW = 16
CAPACITY_FLOOR = 256

_WIRE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def wire_row_bytes(wire: str, dim: int) -> int:
    """Wire cost of one sparse touched row: 4-byte id, payload lanes and,
    for int8, the row's fp32 scale."""
    if wire == "bf16":
        return 4 + 2 * dim
    if wire == "int8":
        return 4 + dim + 4
    return 4 + 4 * dim


def default_capacity(engine, pair_batch: int, steps_per_call: int) -> int:
    """Rows one dispatch group can touch, ``steps_per_call * pair_batch``
    pairs of ``2 + num_negatives`` rows each, rounded up to a power of
    two and clamped to the table; ``GLINT_EXCHANGE_CAPACITY`` overrides
    (and pins) it."""
    env = os.environ.get("GLINT_EXCHANGE_CAPACITY")
    if env:
        return max(1, min(int(env), engine.num_rows))
    touched = pair_batch * steps_per_call * (2 + engine.num_negatives)
    return min(next_pow2(max(CAPACITY_FLOOR, touched)), engine.num_rows)


def release_host_cache() -> None:
    """Return the pinned blocks that PyTorch's host allocator keeps cached
    after their tensors are gone (each rounded up to a power of two) to the
    system. Without it the buffers of a capacity that no longer applies
    stay pinned for the life of the process."""
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None and torch.cuda.is_initialized():
        empty()


def pinned_stats() -> dict:
    """The pinned host allocator's statistics (``allocated_bytes.current``
    and ``.peak``: bytes of pinned blocks it owns, cached ones included);
    empty where this PyTorch has no such statistics."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    return dict(stats()) if stats is not None else {}


def _nbytes(t) -> int:
    return int(t.numel() * t.element_size())


def _build_diff_fn(engine):
    """(cur, base) -> full-shape fp32 delta."""

    def diff(cur, base):
        return cur.float() - base.float()

    return diff


def _build_encode_fn(engine, capacity: int, wire: str, flush: bool):
    """(delta, carry) -> ``(ids, payload, scales, n, overflow, new_carry,
    resid_abs)`` for one table, all on the engine's device.

    Touched = any component of the fp32 delta is nonzero (a flush also
    counts rows with pending carry); ids compact into the ``capacity``
    buffer by a prefix sum and a scatter (slot ``capacity`` is the dump
    slot for untouched and overflowing rows). fp32 ships the delta
    exactly and bf16 rounds it once, both leaving the carry alone; int8
    folds the carry into each sent row, quantizes to int8 lanes and a
    per-row maxabs scale, and returns ``new_carry`` holding ``full -
    q * scale`` for the sent rows (the caller adopts it only if the
    round ships this payload); ``flush`` ships ``delta + carry`` exactly
    with a zero new carry. ``carry`` has ``num_rows + 1`` rows, the last
    the scatter's dump row."""
    cap = int(capacity)
    num_rows = engine.num_rows

    def encode(delta, carry):
        dev = delta.device
        rows = torch.arange(delta.shape[0], dtype=torch.int32, device=dev)
        eff = delta + carry[:num_rows] if flush else delta
        touched = (eff != 0.0).any(dim=1)
        n = touched.sum(dtype=torch.int32)
        pos = torch.cumsum(touched.to(torch.int32), 0, dtype=torch.int32) - 1
        slot = torch.where(touched & (pos < cap), pos,
                           torch.full_like(pos, cap))
        ids = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
        ids.scatter_(0, slot.long(), rows)
        ids = ids[:cap]
        valid = torch.arange(cap, dtype=torch.int32, device=dev) < torch.clamp(
            n, max=cap)
        ids = torch.where(valid, ids, torch.zeros_like(ids))
        vcol = valid[:, None]
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        if flush:
            payload = torch.where(vcol, eff[ids.long()], zero)
            scales = torch.zeros(cap, dtype=torch.float32, device=dev)
            new_carry = torch.zeros_like(carry)
            resid = torch.zeros((), dtype=torch.float32, device=dev)
        elif wire == "int8":
            full = delta[ids.long()] + carry[ids.long()]
            full = torch.where(vcol, full, zero)
            # XLA folds the JAX encoder's ``/ 127.0`` into a multiply by
            # the fp32 reciprocal; the same product keeps the scales bitwise.
            scale = full.abs().amax(dim=1) * (1.0 / 127.0)
            safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
            q = torch.clamp(torch.round(full / safe[:, None]), -127.0,
                            127.0).to(torch.int8)
            # ``full - q * scale`` rounded once, as the fused multiply-add
            # XLA emits for it: the fp32 product is exact in fp64, and so
            # is the difference of two values this close.
            resid_rows = torch.where(
                vcol, (full.double() - q.double() * scale.double()[:, None]
                       ).float(), zero)
            dump = torch.where(valid, ids, torch.full_like(ids, num_rows))
            new_carry = carry.clone()
            new_carry[dump.long()] = resid_rows
            payload, scales = q, scale
            resid = new_carry.abs().max()
        else:
            payload = torch.where(vcol, delta[ids.long()], zero)
            if wire == "bf16":
                payload = payload.to(torch.bfloat16)
            scales = torch.zeros(cap, dtype=torch.float32, device=dev)
            new_carry = carry
            resid = carry.abs().max()
        return ids, payload, scales, n, n > cap, new_carry, resid

    return encode


def _build_dense_fn(engine):
    """(cur, base) -> the fp32 ``(num_rows, dim)`` delta: the spill and
    dense-mode payload."""

    def dense(cur, base):
        return cur.float() - base.float()

    return dense


def _build_dense_carry_fn(engine):
    """The dense payload with the error-feedback carry folded in (the
    flush round's spill form)."""
    num_rows = engine.num_rows

    def dense(cur, base, carry):
        return (cur.float() - base.float()) + carry[:num_rows]

    return dense


def _build_node_accum_fn(engine, capacity: int, members: tuple):
    """The two-level topology's node fold: the node members' exact fp32
    sparse payloads land on one fp32 node delta through B3, in rank
    order. Every member runs the same launches on the same buffers, so
    all members hold the same node delta."""
    num_rows, dim = engine.num_rows, engine.dim

    def accum(ids_r, deltas_r):
        dev = engine.device
        acc = torch.zeros((num_rows, dim), dtype=torch.float32, device=dev)
        for r in members:
            scatter_add_rows(acc, ids_r[r].to(dev).contiguous(),
                             deltas_r[r].to(dev).float().contiguous())
        return acc

    return accum


def _build_apply_sparse_fn(engine, capacity: int, world: int, wire: str):
    """``base + sum_r decode(payload_r)`` for both tables from ``world``
    stacked sparse payloads: the base widened into a new fp32
    accumulator, each rank's decoded rows landed through B3
    (``scatter_add_rows``) in rank order, then one cast to the table's
    dtype. Decoding happens here, at the landing site: int8 lanes times
    their fp32 row scale, bf16 lanes widened."""

    def one(base, ids_r, payload_r, scales_r):
        dev = base.device
        acc = base.to(torch.float32, copy=True)
        for r in range(world):
            dec = payload_r[r].to(dev, non_blocking=True).float()
            if wire == "int8":
                dec = dec * scales_r[r].to(dev, non_blocking=True)[:, None]
            scatter_add_rows(acc, ids_r[r].to(dev, non_blocking=True).contiguous(),
                             dec.contiguous())
        return acc if base.dtype == torch.float32 else acc.to(base.dtype)

    def apply(base0, base1, ids0, p0, s0, ids1, p1, s1):
        return one(base0, ids0, p0, s0), one(base1, ids1, p1, s1)

    return apply


def _build_snapshot_fn(engine):
    """A copy of both tables: the reconciliation base."""

    def snap(a, b):
        return a.clone(), b.clone()

    return snap


def _build_apply_dense_fn(engine, world: int):
    """The dense twin of the sparse apply: per-rank full deltas added in
    rank order on an fp32 accumulator (an untouched rank adds exact
    +0.0), then one cast."""

    def one(base, deltas_r):
        dev = base.device
        acc = base.to(torch.float32, copy=True)
        for r in range(world):
            acc += deltas_r[r].to(dev, non_blocking=True)
        return acc if base.dtype == torch.float32 else acc.to(base.dtype)

    def apply(base0, base1, d0, d1):
        return one(base0, d0), one(base1, d1)

    return apply


class _StageClock:
    """Seconds of a round's device stages: CUDA events on the card (read
    when asked, so timing adds no wait), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List[tuple] = []

    def reset(self) -> None:
        self.marks = []

    def mark(self, name: str):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def seconds(self) -> dict:
        """``{stage: seconds}`` between consecutive marks, the stage named
        by its closing mark."""
        out: dict = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            if self.cuda:
                b.synchronize()
                s = a.elapsed_time(b) / 1e3
            else:
                s = b - a
            out[name] = out.get(name, 0.0) + s
        return out


class NullTransport:
    """One-replica transport: allgather returns the local payload alone."""

    rank = 0
    world = 1

    def allgather(self, arr, slot: Optional[str] = None):
        if isinstance(arr, np.ndarray):
            return np.asarray(arr)[None]
        return arr[None]


class ProcessTransport:
    """Cross-process transport over the gang's gloo group
    (``distributed.allgather_host``). Every payload shape is fixed by the
    capacity, so each named gather lands in a buffer kept for that slot's
    next gather (pinned when the exchanger's engine is on the card, so
    the apply's upload runs at the copy engines' rate); bf16
    lanes travel as a byte view, bit for bit. It needs the group up: a
    rank whose group failed to form raises here rather than train
    alone."""

    def __init__(self):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                "ProcessTransport needs the gang's process group "
                "(distributed.initialize)"
            )
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        #: Gathered buffers in pinned memory (set by the exchanger).
        self.pin = False
        self._bufs: dict = {}

    def allgather(self, arr, slot: Optional[str] = None):
        """``(world, *shape)`` of ``arr`` from every rank. A tensor named
        by ``slot`` lands in that slot's buffer, overwritten by the slot's
        next gather: a round names each of its gathers apart."""
        from glint_word2vec_torch.parallel.distributed import allgather_host

        if isinstance(arr, np.ndarray) or slot is None:
            return allgather_host(arr)
        key = (slot, arr.dtype, tuple(arr.shape))
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = torch.empty(
                (self.world,) + tuple(arr.shape), dtype=arr.dtype,
                pin_memory=self.pin)
        return allgather_host(arr, out=buf)

    def drop_buffers(self) -> None:
        """Forget the kept gather buffers (the capacity changed)."""
        self._bufs.clear()

    def kept_bytes(self) -> int:
        return sum(b.nbytes for b in self._bufs.values())


class ReplicaExchanger:
    """Drives the touched-row delta exchange for ONE replica engine.

    ``begin()`` snapshots the tables; the fit loop runs a dispatch group
    and calls ``group_end(live=..., done=...)``, which runs a round
    (``sync``) every ``every``-th call: harvest, swap the encoded deltas
    with the peers through ``transport``, rebuild the reconciled tables,
    re-snapshot. Both return True while any replica still has work: a
    drained replica keeps calling ``group_end(live=False, done=True)``
    with empty payloads until the whole gang is done, so no collective is
    left waiting. ``flush()`` drains the error-feedback carry before a
    checkpoint; ``epoch_reset()`` rearms the latches between epochs.
    """

    def __init__(self, engine, *, mode: str = "sparse",
                 capacity: Optional[int] = None,
                 transport=None, pair_batch: int = 1024,
                 steps_per_call: int = 16, wire: str = "fp32",
                 every: int = 1, topology: str = "flat",
                 node_size: Optional[int] = None):
        if mode not in ("sparse", "dense"):
            raise ValueError("exchange mode must be 'sparse' or 'dense'")
        if wire not in WIRE_FORMATS:
            raise ValueError(f"exchange wire must be one of {WIRE_FORMATS}")
        if int(every) < 1:
            raise ValueError("exchange every must be >= 1")
        if topology not in ("flat", "twolevel"):
            raise ValueError("exchange topology must be flat|twolevel")
        self.engine = engine
        self.transport = transport if transport is not None else NullTransport()
        if os.environ.get("GLINT_DENSE_EXCHANGE", "0") == "1":
            mode = "dense"
        self.mode = mode
        # Dense rounds always ship exact fp32 full deltas.
        self.wire = wire if mode == "sparse" else "fp32"
        self.every = int(every)
        self.topology = topology if mode == "sparse" else "flat"
        env_ns = os.environ.get("GLINT_RANKS_PER_NODE")
        ns = int(node_size) if node_size else (int(env_ns) if env_ns else 0)
        #: Ranks per node of the two-level topology; None: one node.
        self.node_size = ns if ns > 0 else None
        #: An operator-chosen capacity (explicit or the env) never adapts.
        self.capacity_pinned = bool(capacity) or bool(
            os.environ.get("GLINT_EXCHANGE_CAPACITY"))
        self.capacity = int(
            capacity if capacity
            else default_capacity(engine, pair_batch, steps_per_call)
        )
        self._hw = deque(maxlen=CAPACITY_WINDOW)
        self._fns = {}
        self._base = None
        self._carry = None          # lazy (carry0, carry1) on the device
        self._pending_carry = None  # encoder output awaiting adoption
        self._resid_abs = 0.0
        self._window = 0
        self._live_pending = False
        self._done_pending = False
        self._gang_live = True
        #: Reused pinned host buffers of the harvest's copies.
        self._host_bufs: dict = {}
        #: Set when the capacity changed: the next harvest frees the old
        #: buffers' pinned blocks before it pins new ones.
        self._release_pending = False
        #: The latest round's device stages (``round_stage_seconds``).
        self.clock = _StageClock(engine.device)
        #: Set after a round's apply on the card: the next round's
        #: gathers reuse the buffers its uploads read.
        self._applied = None
        if hasattr(self.transport, "pin"):
            self.transport.pin = engine.device.type == "cuda"
        self.short_circuit = (
            self.transport.world == 1
            and os.environ.get("GLINT_EXCHANGE_FORCE_WIRE", "0") != "1"
        )
        # The base must predate the first dispatch group, or that group's
        # deltas vanish from the exchange.
        self.begin()

    def _fn(self, kind: str, builder, *args):
        key = (kind, *args)
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = builder(self.engine, *args)
        return fn

    def begin(self) -> None:
        """Snapshot the reconciliation base (a copy of both tables)."""
        fn = self._fn("snapshot", _build_snapshot_fn)
        eng = self.engine
        self._base = fn(eng.logical_table(0), eng.logical_table(1))

    def _carry_pair(self):
        """The error-feedback residual state, created on first use: one
        fp32 ``(num_rows + 1, dim)`` buffer a table (the last row is the
        encode's dump row)."""
        if self._carry is None:
            shape = (self.engine.num_rows + 1, self.engine.dim)
            dev = self.engine.device
            self._carry = (torch.zeros(shape, dtype=torch.float32, device=dev),
                           torch.zeros(shape, dtype=torch.float32, device=dev))
        return self._carry

    def _drop_host_buffers(self) -> None:
        """Forget the host buffers of the old capacity, its own and the
        transport's. Their pinned blocks go back to the system at the next
        harvest, when the round that still reads them has ended."""
        self._host_bufs.clear()
        if hasattr(self.transport, "drop_buffers"):
            self.transport.drop_buffers()
        self._release_pending = self.engine.device.type == "cuda"

    def host_memory(self) -> dict:
        """This process's host memory as the exchange sees it: the bytes of
        the buffers it keeps for the next round (the harvest's and the
        transport's), the pinned allocator's peak (on the card), and the
        process's peak resident set."""
        import resource

        kept = sum(b.nbytes for b in self._host_bufs.values())
        if hasattr(self.transport, "kept_bytes"):
            kept += self.transport.kept_bytes()
        out = {"exchange_kept_bytes": int(kept),
               "peak_rss_bytes": resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss * 1024}
        if self.engine.device.type == "cuda":
            st = pinned_stats()
            out["pinned_peak_bytes"] = st.get("allocated_bytes.peak")
            out["pinned_bytes"] = st.get("allocated_bytes.current")
        return out

    def residual_stats(self) -> dict:
        """Max-abs of the error-feedback carry after the latest encode."""
        return {"residual_abs": float(self._resid_abs)}

    def round_stage_seconds(self) -> dict:
        """Seconds of the latest round by stage (``diff``, ``encode``,
        ``copy_to_host``, ``wire``, ``apply``)."""
        return self.clock.seconds()

    def _fold_stages(self) -> None:
        """Add the last round's stage seconds to the engine's
        ``exchange_stage_seconds`` totals. Called as the next round
        starts, when the card has long finished the last one, so reading
        its events waits for nothing."""
        if len(self.clock.marks) > 1:
            self.engine._note_exchange_stages(self.clock.seconds())
        self.clock.reset()

    def _node_members(self, world: int, rank: int) -> tuple:
        """The two-level topology's node of ``rank``: ranks grouped
        contiguously ``node_size`` at a time, the lowest the leader."""
        ns = self.node_size or world
        node = rank // ns
        return tuple(r for r in range(world) if r // ns == node)

    # -- harvest: the one device -> host wait of a round -----------------

    def _to_host(self, tensors: Sequence[torch.Tensor],
                 keep: bool = True) -> List[torch.Tensor]:
        """Copies of ``tensors`` in host memory: on the card, pinned buffers
        kept for the next round (keyed by position and shape) filled by
        non-blocking copies and one event wait (the round's one host
        wait); on the CPU, the tensors themselves. The rare dense and
        flush rounds (``keep=False``) copy to pageable memory instead:
        pinned blocks are rounded up to a power of two and kept, several
        GB a table."""
        if self.engine.device.type != "cuda":
            return list(tensors)
        if not keep:
            return [t.cpu() for t in tensors]
        if self._release_pending:
            release_host_cache()
            self._release_pending = False
        outs = []
        for i, t in enumerate(tensors):
            key = (i, tuple(t.shape), t.dtype)
            buf = self._host_bufs.get(key)
            if buf is None:
                buf = self._host_bufs[key] = torch.empty(
                    t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            outs.append(buf)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return outs

    def harvest(self, *, flush: bool = False):
        """Diff and wire-encode this replica and bring the fixed-capacity
        buffers to the host. Returns ``((n0, o0, n1, o1), payload)`` where
        payload is ``(ids0, p0, s0, ids1, p1, s1)`` host tensors (lanes in
        the wire dtype, per-row scales for int8). Under
        ``topology="twolevel"`` the local hop encodes exact fp32 (the
        configured wire applies to the node-level stream); ``flush=True``
        encodes delta + carry exactly and stages a zero carry."""
        self._fold_stages()
        self.clock.mark("start")
        diff = self._fn("diff", _build_diff_fn)
        d0 = diff(self.engine.logical_table(0), self._base[0])
        d1 = diff(self.engine.logical_table(1), self._base[1])
        self.clock.mark("diff")
        local_wire = self.wire
        if self.topology == "twolevel" and not flush:
            local_wire = "fp32"
        enc = self._fn("encode", _build_encode_fn, self.capacity, local_wire,
                       bool(flush))
        c0, c1 = self._carry_pair()
        i0, p0, s0, n0, o0, nc0, r0 = enc(d0, c0)
        i1, p1, s1, n1, o1, nc1, r1 = enc(d1, c1)
        del d0, d1
        counts = torch.stack([n0.long(), o0.long(), n1.long(), o1.long()])
        resid = torch.stack([r0, r1])
        self.clock.mark("encode")
        i0, p0, s0, i1, p1, s1, counts, resid = self._to_host(
            (i0, p0, s0, i1, p1, s1, counts, resid), keep=not flush)
        self.clock.mark("copy_to_host")
        if self.topology != "twolevel" or flush:
            # Flat: the local encoding is the wire encoding, so its carry
            # and residual are the ones to (maybe) adopt.
            self._pending_carry = (nc0, nc1)
            self._resid_abs = float(resid.max())
        n0, o0, n1, o1 = (int(v) for v in counts.tolist())
        return (n0, o0, n1, o1), (i0, p0, s0, i1, p1, s1)

    def _dense_delta(self, *, with_carry: bool = False):
        """Host fp32 full-table deltas for a dense or spill round
        (``with_carry`` folds the error-feedback carry in: the flush
        round's spill form)."""
        if with_carry:
            fn = self._fn("dense_carry", _build_dense_carry_fn)
            c0, c1 = self._carry_pair()
            d = (fn(self.engine.logical_table(0), self._base[0], c0),
                 fn(self.engine.logical_table(1), self._base[1], c1))
        else:
            fn = self._fn("dense", _build_dense_fn)
            d = (fn(self.engine.logical_table(0), self._base[0]),
                 fn(self.engine.logical_table(1), self._base[1]))
        return tuple(t.cpu() for t in d)

    def _empty_sparse(self, wire: Optional[str] = None):
        """All-zero sparse payload in the round's wire dtype (the lockstep
        filler): zero ids add an exact +0.0 to row 0."""
        if wire is None:
            wire = "fp32" if self.topology == "twolevel" else self.wire
        cap, d = self.capacity, self.engine.dim
        wdt = _WIRE_DTYPES[wire]
        return (
            torch.zeros(cap, dtype=torch.int32), torch.zeros((cap, d), dtype=wdt),
            torch.zeros(cap, dtype=torch.float32),
            torch.zeros(cap, dtype=torch.int32), torch.zeros((cap, d), dtype=wdt),
            torch.zeros(cap, dtype=torch.float32),
        )

    def _empty_dense(self):
        z = torch.zeros((self.engine.num_rows, self.engine.dim),
                        dtype=torch.float32)
        return z, z

    # -- coalescing / window bookkeeping ---------------------------------

    def group_end(self, *, live: bool = True, done: bool = False) -> bool:
        """Account one dispatch group (or one drained filler slot) and run
        a round at every ``every``-th call. Liveness and doneness latch
        across the window and every call advances it, so boundary rounds
        stay aligned across ranks whoever drained first. Returns the
        latest gang-live verdict (True: keep looping)."""
        self._window += 1
        self._live_pending = self._live_pending or bool(live)
        self._done_pending = self._done_pending or bool(done)
        if self._window % self.every:
            return self._gang_live
        alive = self.sync(live=self._live_pending, done=self._done_pending,
                          groups=self.every)
        self._live_pending = False
        self._gang_live = alive
        return alive

    def flush(self) -> bool:
        """Checkpoint hook: drain the error-feedback carry through an
        exact fp32 round and zero it, so a resume from the checkpoint
        replays bitwise. The go/no-go is pure config (int8 wire,
        multi-replica sparse mode), the same on every rank. No-op
        (returns False) otherwise."""
        if (self.short_circuit or self.mode != "sparse"
                or self.wire != "int8"):
            self._window = 0
            return False
        if self.topology == "twolevel":
            # The carry is node-level state, the same on every member:
            # only the leader ships it.
            members = self._node_members(self.transport.world,
                                         self.transport.rank)
            if self.transport.rank != members[0]:
                self._carry = None
        self.sync(live=True, done=False, flush=True, groups=0)
        self._carry = None
        self._pending_carry = None
        self._resid_abs = 0.0
        self._window = 0
        return True

    def epoch_reset(self) -> None:
        """Rearm the window and the latches after a gang drain."""
        self._window = 0
        self._live_pending = False
        self._done_pending = False
        self._gang_live = True

    def _adapt_capacity(self, max_n: int, overflowed: bool):
        """Header-driven capacity adaptation (every rank sees the same
        headers, so every rank decides the same): grow straight past an
        overflow's true touched count; shrink only after a full window of
        high-water marks under half the capacity. Returns "grow",
        "shrink" or None."""
        if self.capacity_pinned or self.mode != "sparse":
            return None
        limit = self.engine.num_rows
        if overflowed:
            new = min(next_pow2(max(max_n, CAPACITY_FLOOR)), limit)
            self._hw.clear()
            if new > self.capacity:
                self.capacity = new
                self._drop_host_buffers()
                return "grow"
            return None
        self._hw.append(int(max_n))
        if len(self._hw) == CAPACITY_WINDOW:
            target = min(max(CAPACITY_FLOOR, next_pow2(2 * max(self._hw))),
                         limit)
            if target < self.capacity:
                self.capacity = target
                self._hw.clear()
                self._drop_host_buffers()
                return "shrink"
        return None

    # -- the protocol -----------------------------------------------------

    def sync(self, *, live: bool = True, done: bool = False,
             flush: bool = False, groups: int = 1) -> bool:
        """One wire round. ``live``: this replica dispatched a group since
        the last round (False: empty payload, lockstep filler). ``done``:
        it has no further groups this epoch. ``flush``: exact fp32 round
        that also drains the carry. ``groups``: dispatch groups folded
        into the round (telemetry). Returns True while any replica is not
        done."""
        eng, tr = self.engine, self.transport
        if self.short_circuit:
            eng._note_exchange(
                bytes_sent=0, rows=0, overflow=False, dense=False,
                seconds=0.0, wire=self.wire, groups=int(groups),
                flush=False, world1_skip=True, intra_bytes=0,
                capacity=int(self.capacity),
            )
            return not done
        t0 = time.time()
        if self._applied is not None:
            self._applied.synchronize()
            self._applied = None
        header = np.zeros(HEADER_LEN, np.int64)
        header[0], header[1] = int(live or flush), int(done)
        payload = None
        if live or flush:
            (n0, o0, n1, o1), payload = self.harvest(flush=flush)
            header[2:] = (n0, o0, n1, o1)
        else:
            self._fold_stages()
            self.clock.mark("start")
        faults.fire("exchange.pre_send")
        headers = tr.allgather(header)
        dense_round = decide_dense(self.mode, headers)
        sent = headers.nbytes // max(tr.world, 1)
        intra = 0
        wire_round = "fp32" if (dense_round or flush) else self.wire
        touched_ids = None
        cap = self.capacity
        max_n = int(max(headers[:, 2].max(), headers[:, 4].max()))
        if dense_round:
            if flush:
                d0, d1 = self._dense_delta(with_carry=True)
            elif live:
                d0, d1 = self._dense_delta()
            else:
                d0, d1 = self._empty_dense()
            deltas0 = tr.allgather(d0)
            deltas1 = tr.allgather(d1)
            sent += _nbytes(d0) + _nbytes(d1)
            self.clock.mark("wire")
            fn = self._fn("apply_dense", _build_apply_dense_fn, tr.world)
            syn0, syn1 = fn(*self._base, deltas0, deltas1)
            if flush:
                self._carry = None
        elif self.topology == "twolevel" and tr.world > 1 and not flush:
            syn0, syn1, hop = self._twolevel_round(payload, headers)
            sent += hop["intra"] + hop["inter"]
            intra = hop["intra"]
            wire_round = hop["wire"]
            dense_round = hop["dense"]
            touched_ids = hop["touched_ids"]
            max_n = max(max_n, hop["max_n"])
        else:
            if payload is None:
                payload = self._empty_sparse()
            i0, p0, s0, i1, p1, s1 = payload
            # A flush (fp32 under an int8 config, once an epoch) gathers
            # into fresh pageable memory, not into kept buffers.
            sl = (lambda name: None) if flush else (lambda name: name)
            ids0, ps0 = tr.allgather(i0, slot=sl("ids0")), tr.allgather(p0, slot=sl("p0"))
            ids1, ps1 = tr.allgather(i1, slot=sl("ids1")), tr.allgather(p1, slot=sl("p1"))
            sent += _nbytes(i0) + _nbytes(p0) + _nbytes(i1) + _nbytes(p1)
            if wire_round == "int8":
                sc0, sc1 = tr.allgather(s0, slot=sl("s0")), tr.allgather(s1, slot=sl("s1"))
                sent += _nbytes(s0) + _nbytes(s1)
            else:
                sc0 = sc1 = torch.zeros((tr.world, cap), dtype=torch.float32)
            self.clock.mark("wire")
            fn = self._fn("apply_sparse", _build_apply_sparse_fn, cap,
                          tr.world, wire_round)
            syn0, syn1 = fn(*self._base, ids0, ps0, sc0, ids1, ps1, sc1)
            touched_ids = _touched_ids(ids0, ids1)
            if flush:
                self._carry = None
            elif self.wire == "int8" and live:
                self._carry = self._pending_carry
        self.clock.mark("apply")
        if eng.device.type == "cuda":
            self._applied = torch.cuda.Event()
            self._applied.record()
        eng.exchange_adopt(syn0, syn1, touched_ids=touched_ids)
        self.begin()
        cap_event = self._adapt_capacity(
            max_n, bool((headers[:, 3] | headers[:, 5]).any()))
        eng._note_exchange(
            bytes_sent=int(sent),
            rows=int(header[2] + header[4]),
            overflow=bool(header[3] or header[5]),
            dense=bool(dense_round),
            seconds=time.time() - t0,
            wire=wire_round,
            groups=int(groups),
            flush=bool(flush),
            world1_skip=False,
            intra_bytes=int(intra),
            capacity=int(self.capacity),
            cap_event=cap_event,
            residual_abs=float(self._resid_abs),
        )
        return not bool(headers[:, 1].all())

    def _twolevel_round(self, payload, headers):
        """Both levels of a two-level sparse round: exact fp32 local
        payloads over the intra-node hop, folded into the node delta
        (B3), re-encoded under the configured wire with the node carry;
        only leaders ship it inter-node (non-leaders send zero buffers).
        Returns the reconciled tables and the per-hop bytes."""
        tr, cap = self.transport, self.capacity
        if payload is None:
            payload = self._empty_sparse("fp32")
        i0, p0, s0, i1, p1, s1 = payload
        g_i0, g_p0 = tr.allgather(i0, slot="node_ids0"), tr.allgather(p0, slot="node_p0")
        g_i1, g_p1 = tr.allgather(i1, slot="node_ids1"), tr.allgather(p1, slot="node_p1")
        intra = _nbytes(i0) + _nbytes(p0) + _nbytes(i1) + _nbytes(p1)
        members = self._node_members(tr.world, tr.rank)
        leader = tr.rank == members[0]
        acc = self._fn("node_accum", _build_node_accum_fn, cap, members)
        nd0 = acc(g_i0, g_p0)
        nd1 = acc(g_i1, g_p1)
        enc = self._fn("encode", _build_encode_fn, cap, self.wire, False)
        c0, c1 = self._carry_pair()
        ni0, np0, ns0, nn0, no0, nc0, nr0 = enc(nd0, c0)
        ni1, np1, ns1, nn1, no1, nc1, nr1 = enc(nd1, c1)
        h2 = np.zeros(HEADER_LEN, np.int64)
        h2[2:] = (int(nn0), int(no0), int(nn1), int(no1))
        h2s = tr.allgather(h2)
        inter = h2s.nbytes // max(tr.world, 1)
        max_n = int(max(h2s[:, 2].max(), h2s[:, 4].max()))
        if bool((h2s[:, 3] | h2s[:, 5]).any()):
            # Node-union spill: leaders ship the dense node delta, the
            # carry stays for the next round.
            if leader:
                d0, d1 = nd0.cpu(), nd1.cpu()
            else:
                d0, d1 = self._empty_dense()
            deltas0 = tr.allgather(d0)
            deltas1 = tr.allgather(d1)
            inter += (_nbytes(d0) + _nbytes(d1)) if leader else 0
            fn = self._fn("apply_dense", _build_apply_dense_fn, tr.world)
            syn0, syn1 = fn(*self._base, deltas0, deltas1)
            return syn0, syn1, {"intra": int(intra), "inter": int(inter),
                                "wire": "fp32", "dense": True, "max_n": max_n,
                                "touched_ids": None}
        if leader:
            out = tuple(t.cpu() for t in (ni0, np0, ns0, ni1, np1, ns1))
        else:
            out = self._empty_sparse(self.wire)
        li0, lp0, ls0, li1, lp1, ls1 = out
        ids0, ps0 = tr.allgather(li0, slot="ids0"), tr.allgather(lp0, slot="p0")
        ids1, ps1 = tr.allgather(li1, slot="ids1"), tr.allgather(lp1, slot="p1")
        if leader:
            inter += _nbytes(li0) + _nbytes(lp0) + _nbytes(li1) + _nbytes(lp1)
        if self.wire == "int8":
            sc0, sc1 = tr.allgather(ls0, slot="s0"), tr.allgather(ls1, slot="s1")
            if leader:
                inter += _nbytes(ls0) + _nbytes(ls1)
        else:
            sc0 = sc1 = torch.zeros((tr.world, cap), dtype=torch.float32)
        fn = self._fn("apply_sparse", _build_apply_sparse_fn, cap, tr.world,
                      self.wire)
        syn0, syn1 = fn(*self._base, ids0, ps0, sc0, ids1, ps1, sc1)
        if self.wire == "int8":
            self._carry = (nc0, nc1)
            self._resid_abs = float(torch.maximum(nr0, nr1))
        return syn0, syn1, {"intra": int(intra), "inter": int(inter),
                            "wire": self.wire, "dense": False, "max_n": max_n,
                            "touched_ids": _touched_ids(ids0, ids1)}


def decide_dense(mode: str, headers: np.ndarray) -> bool:
    """Spill rule shared by the transported and in-process drivers: a
    round is dense when the mode says so, the escape hatch forces it, or
    any replica overflowed its capacity buffer."""
    if os.environ.get("GLINT_DENSE_EXCHANGE", "0") == "1":
        return True
    return mode == "dense" or bool((headers[:, 3] | headers[:, 5]).any())


def _touched_ids(ids0, ids1) -> np.ndarray:
    """The rows a sparse round changed, as a host int64 array: every id
    of both tables' gathered payloads (a padding slot's id is row 0, so
    the set may hold row 0 spuriously, which only dirties more)."""
    ids = torch.cat([torch.as_tensor(t).reshape(-1).cpu().long()
                     for t in (ids0, ids1)])
    return torch.unique(ids).numpy().astype(np.int64)


def _stack(parts):
    return torch.stack(list(parts))


def sync_group(exchangers: Sequence[ReplicaExchanger], *,
               live: Optional[List[bool]] = None,
               flush: bool = False) -> dict:
    """In-process N-replica round: harvest every replica, decide sparse
    or dense by the same spill rule, and rebuild every replica's tables
    in the same rank order (each replica its own engine; the wire is
    process memory, its bytes counted as the transported protocol ships
    them). Mirrors ``ReplicaExchanger.sync`` across the wires, the
    two-level topology (list index = rank), flush rounds and the
    capacity adaptation."""
    world = len(exchangers)
    ex0 = exchangers[0]
    mode, wire, topo = ex0.mode, ex0.wire, ex0.topology
    cap = ex0.capacity
    if live is None:
        live = [True] * world
    t0 = time.time()
    headers = np.zeros((world, HEADER_LEN), np.int64)
    payloads = []
    for r, ex in enumerate(exchangers):
        headers[r, 0] = int(live[r] or flush)
        if live[r] or flush:
            (n0, o0, n1, o1), p = ex.harvest(flush=flush)
            headers[r, 2:] = (n0, o0, n1, o1)
            payloads.append(p)
        else:
            payloads.append(None)
    faults.fire("exchange.pre_send")
    dense_round = decide_dense(mode, headers)
    wire_round = "fp32" if (dense_round or flush) else wire
    max_n = int(max(headers[:, 2].max(), headers[:, 4].max()))
    hdr_bytes = headers[0].nbytes
    intra_by_rank = [0] * world
    inter_by_rank = [0] * world
    touched_ids = None
    if dense_round:
        deltas = [
            ex._dense_delta(with_carry=flush) if (live[r] or flush)
            else ex._empty_dense()
            for r, ex in enumerate(exchangers)
        ]
        d0 = _stack(d[0] for d in deltas)
        d1 = _stack(d[1] for d in deltas)
        for r in range(world):
            inter_by_rank[r] = hdr_bytes + _nbytes(d0[r]) + _nbytes(d1[r])
        apply_args = ("apply_dense", (_build_apply_dense_fn, world), (d0, d1))
    elif topo == "twolevel" and world > 1 and not flush:
        # A flush is one exact flat round, as in ``ReplicaExchanger.sync``
        # (the JAX module's in-process driver sends it through the
        # two-level path, whose int8 node hop then drops the carry).
        ps = [p if p is not None else ex._empty_sparse("fp32")
              for p, ex in zip(payloads, exchangers)]
        ids0 = _stack(p[0] for p in ps)
        ps0 = _stack(p[1] for p in ps)
        ids1 = _stack(p[3] for p in ps)
        ps1 = _stack(p[4] for p in ps)
        l1 = (_nbytes(ids0[0]) + _nbytes(ps0[0]) + _nbytes(ids1[0])
              + _nbytes(ps1[0]))
        for r in range(world):
            intra_by_rank[r] = l1
        # Level 2: fold and re-encode once a node (every member would
        # compute the same; the leader's engine does it).
        h2 = np.zeros((world, HEADER_LEN), np.int64)
        node_enc, node_nd, node_carry = {}, {}, {}
        for r, ex in enumerate(exchangers):
            members = ex._node_members(world, r)
            if r != members[0]:
                continue
            acc = ex._fn("node_accum", _build_node_accum_fn, cap, members)
            nd0, nd1 = acc(ids0, ps0), acc(ids1, ps1)
            enc = ex._fn("encode", _build_encode_fn, cap, wire, False)
            c0, c1 = ex._carry_pair()
            ni0, q0, sc0, nn0, no0, nc0, nr0 = enc(nd0, c0)
            ni1, q1, sc1, nn1, no1, nc1, nr1 = enc(nd1, c1)
            row = (int(nn0), int(no0), int(nn1), int(no1))
            for m in members:
                h2[m, 2:] = row
            node_enc[r] = tuple(t.cpu() for t in (ni0, q0, sc0, ni1, q1, sc1))
            node_nd[r] = (nd0, nd1)
            node_carry[r] = (nc0, nc1, float(torch.maximum(nr0, nr1)))
        max_n = max(max_n, int(max(h2[:, 2].max(), h2[:, 4].max())))
        if bool((h2[:, 3] | h2[:, 5]).any()):
            dense_round = True
            wire_round = "fp32"
            rows0, rows1 = [], []
            for r, ex in enumerate(exchangers):
                members = ex._node_members(world, r)
                if r == members[0]:
                    a, b = (t.cpu() for t in node_nd[r])
                    inter_by_rank[r] = hdr_bytes + _nbytes(a) + _nbytes(b)
                else:
                    a, b = ex._empty_dense()
                    inter_by_rank[r] = hdr_bytes
                rows0.append(a)
                rows1.append(b)
            apply_args = ("apply_dense", (_build_apply_dense_fn, world),
                          (_stack(rows0), _stack(rows1)))
        else:
            outs = []
            for r, ex in enumerate(exchangers):
                members = ex._node_members(world, r)
                if r == members[0]:
                    out = node_enc[r]
                    inter_by_rank[r] = (hdr_bytes + _nbytes(out[0])
                                        + _nbytes(out[1]) + _nbytes(out[3])
                                        + _nbytes(out[4]))
                    if wire == "int8":
                        inter_by_rank[r] += _nbytes(out[2]) + _nbytes(out[5])
                else:
                    out = ex._empty_sparse(wire)
                    inter_by_rank[r] = hdr_bytes
                outs.append(out)
            gathered = tuple(_stack(o[k] for o in outs) for k in range(6))
            touched_ids = _touched_ids(gathered[0], gathered[3])
            apply_args = ("apply_sparse",
                          (_build_apply_sparse_fn, cap, world, wire), gathered)
            for r, ex in enumerate(exchangers):
                if wire == "int8":
                    leader = ex._node_members(world, r)[0]
                    nc0, nc1, resid = node_carry[leader]
                    ex._carry = (nc0, nc1)
                    ex._resid_abs = resid
    else:
        ps = [p if p is not None else ex._empty_sparse(wire_round)
              for p, ex in zip(payloads, exchangers)]
        gathered = tuple(_stack(p[k] for p in ps) for k in range(6))
        ids0, q0, sc0, ids1, q1, sc1 = gathered
        per = (_nbytes(ids0[0]) + _nbytes(q0[0]) + _nbytes(ids1[0])
               + _nbytes(q1[0]))
        if wire_round == "int8":
            per += _nbytes(sc0[0]) + _nbytes(sc1[0])
        for r in range(world):
            inter_by_rank[r] = hdr_bytes + per
        touched_ids = _touched_ids(ids0, ids1)
        apply_args = ("apply_sparse",
                      (_build_apply_sparse_fn, cap, world, wire_round), gathered)
        for r, ex in enumerate(exchangers):
            if flush:
                ex._carry = None
            elif wire == "int8" and live[r]:
                ex._carry = ex._pending_carry
    kind, builder_args, args = apply_args
    devices = {ex.engine.device for ex in exchangers}
    if len(devices) == 1:
        # One trip of the gathered payloads to the replicas' device.
        dev = devices.pop()
        args = tuple(a.to(dev, non_blocking=True) for a in args)
    overflowed = bool((headers[:, 3] | headers[:, 5]).any())
    cap_event = None
    for r, ex in enumerate(exchangers):
        t1 = time.time()
        ex.clock.mark("wire")
        fn = ex._fn(kind, *builder_args)
        syn0, syn1 = fn(*ex._base, *args)
        ex.clock.mark("apply")
        ex.engine.exchange_adopt(syn0, syn1, touched_ids=touched_ids)
        ex.begin()
        cap_event = ex._adapt_capacity(max_n, overflowed)
        ex.engine._note_exchange(
            bytes_sent=int(intra_by_rank[r] + inter_by_rank[r]),
            rows=int(headers[r, 2] + headers[r, 4]),
            overflow=bool(headers[r, 3] or headers[r, 5]),
            dense=bool(dense_round),
            seconds=time.time() - t1,
            wire=wire_round,
            groups=1,
            flush=bool(flush),
            world1_skip=False,
            intra_bytes=int(intra_by_rank[r]),
            capacity=int(ex.capacity),
            cap_event=cap_event,
            residual_abs=float(ex._resid_abs),
        )
    return {
        "dense": bool(dense_round),
        "bytes_per_rank": int(sum(intra_by_rank[r] + inter_by_rank[r]
                                  for r in range(world)) // world),
        "intra_bytes_per_rank": int(sum(intra_by_rank) // world),
        "inter_bytes_per_rank": int(sum(inter_by_rank) // world),
        "wire": wire_round,
        "capacity": int(exchangers[0].capacity),
        "cap_event": cap_event,
        "seconds": time.time() - t0,
        "rows": [int(headers[r, 2] + headers[r, 4]) for r in range(world)],
    }


def flush_group(exchangers: Sequence[ReplicaExchanger]) -> bool:
    """In-process twin of ``ReplicaExchanger.flush``: drain every
    replica's error-feedback carry through one exact fp32 round. No-op
    unless the config accumulates a carry (int8 sparse)."""
    ex0 = exchangers[0]
    if ex0.mode != "sparse" or ex0.wire != "int8":
        for ex in exchangers:
            ex._window = 0
        return False
    world = len(exchangers)
    if ex0.topology == "twolevel":
        for r, ex in enumerate(exchangers):
            if r != ex._node_members(world, r)[0]:
                ex._carry = None  # the node carry ships once, via the leader
    sync_group(exchangers, flush=True)
    for ex in exchangers:
        ex._carry = None
        ex._pending_carry = None
        ex._resid_abs = 0.0
        ex._window = 0
    return True
