"""Device-resident two-stage approximate top-k (IVF) for serving: the port
of ``glint_word2vec_tpu/ops/ann.py``.

Stage A, the coarse quantizer: spherical k-means centroids trained on the
device from the table by a fixed number of sweeps over a seeded sample. A
query's coarse scores ``q @ centroids.T`` pick its ``nprobe`` clusters.

Stage B, an exact rerank inside the probed clusters: members live in a
padded ``(C, L)`` layout whose slot count ``L`` is a fixed function of the
engine's row capacity (:func:`member_slots`). Clusters larger than ``L``
spill their overflow to the next-best cluster with space (the capacity is
about 1.5 times the table, so packing always succeeds); ``nprobe == C``
scores every member slot, which is the exact masked top-k.

Per query the work is ``C·d`` (coarse) plus ``nprobe·L·d`` (rerank),
against ``V·d`` for the exact path.

Every row gather (the k-means sample, the assignment, the spill scores,
the member blocks and a cluster's refresh) goes through the hand-written
``gather_rows`` (``ops/rows.py``, B1), which returns fp32 rows of an fp32
or bf16 table. The k-means sums go through ``scatter_add_rows`` (B3) on a
``(C, d + 1)`` fp32 table with the payload ``[x·w, w]``: each cluster's
sum is one chain of adds in sorted order, so two builds on the same table
give bitwise-equal centroids (``index_add_`` on the card adds with float
atomics). The search itself is what the JAX package leaves to XLA: a
matrix product, ``topk``, whole-block ``index_select`` of the probed
clusters, ``bmm`` and a second ``topk``.

The index is a value (:class:`AnnIndex`): build it against any table, live
or staged, then adopt it together with its tables. Incremental maintenance
(:func:`add_rows`, :func:`remove_rows`, :func:`update_rows`) re-buckets only
the touched rows by editing small host masters, re-staging the ``(C, L)``
id and norm arrays and refreshing the touched clusters' blocks.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from glint_word2vec_torch.ops.rows import gather_rows, scatter_add_rows
from glint_word2vec_torch.utils import next_pow2

#: Row-block width of the k-means sweeps and of the full-table assignment:
#: bounds the ``(block, C)`` score matrix on the device.
ASSIGN_BLOCK = 8192

#: Chunk of the incremental (re-)assignment path.
INCREMENTAL_BLOCK = 256

#: Best clusters kept a spilled row (its candidates); a row that finds all
#: of them full takes its whole preference order.
SPILL_CANDIDATES = 32

#: Spilled rows placed a round (see :func:`_place_spills`).
SPILL_ROUND = 4096

#: Member-slot headroom: the index holds about ``SLOT_FACTOR`` times the
#: table's rows, split evenly across clusters.
SLOT_FACTOR = 1.5


def auto_clusters(num_rows: int) -> int:
    """Default cluster count: the power of two at or above sqrt(rows),
    at least 4."""
    return max(4, next_pow2(math.ceil(math.sqrt(max(1, num_rows)))))


def member_slots(num_rows: int, clusters: int) -> int:
    """Padded member slots per cluster: a fixed function of the engine's
    row capacity and the cluster count, never of a cluster census, so
    rebuilds and growth keep every shape."""
    return max(8, next_pow2(math.ceil(SLOT_FACTOR * num_rows / clusters)))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ids(ids: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(ids, dtype=np.int32)).to(device)


def normalized_rows(syn0: torch.Tensor, norms: torch.Tensor,
                    ids: torch.Tensor) -> torch.Tensor:
    """fp32 rows ``syn0[ids]`` (one ``gather_rows``) scaled to unit norm;
    zero-norm rows stay zero, so they score 0 against every centroid."""
    x = gather_rows(syn0, ids)
    n = norms.index_select(0, ids.long())
    scale = torch.where(n > 0, 1.0 / torch.where(n > 0, n, 1.0), 0.0)
    return x * scale[:, None]


def kmeans_sweep(xn: torch.Tensor, w: torch.Tensor,
                 cent: torch.Tensor) -> torch.Tensor:
    """One spherical k-means iteration over the ``(S, d)`` normalized
    sample, ``ASSIGN_BLOCK`` rows at a time: one fp32 product against the
    centroids, the argmax, and the per-cluster sums of ``x·w`` and ``w``
    through ``scatter_add_rows``. Centroids are re-normalized; an empty
    cluster keeps its previous centroid. ``w`` masks padding rows out."""
    C, d = cent.shape
    acc = torch.zeros((C, d + 1), dtype=torch.float32, device=cent.device)
    for s in range(0, xn.shape[0], ASSIGN_BLOCK):
        x, wt = xn[s : s + ASSIGN_BLOCK], w[s : s + ASSIGN_BLOCK]
        a = torch.argmax(x @ cent.T, dim=1).to(torch.int32)
        payload = torch.cat([x * wt[:, None], wt[:, None]], dim=1)
        scatter_add_rows(acc, a.contiguous(), payload.contiguous())
    sums, counts = acc[:, :d], acc[:, d]
    nrm = torch.linalg.norm(sums, dim=1, keepdim=True)
    fresh = sums / torch.where(nrm > 0, nrm, 1.0)
    keep = (counts > 0)[:, None] & (nrm > 0)
    return torch.where(keep, fresh, cent)


def assign_rows(syn0: torch.Tensor, norms: torch.Tensor, ids: np.ndarray,
                cent: torch.Tensor) -> np.ndarray:
    """Best centroid of every row of ``ids`` (host int32), in
    ``ASSIGN_BLOCK`` chunks with one readback at the end."""
    out = torch.empty(len(ids), dtype=torch.int32, device=cent.device)
    for s in range(0, len(ids), ASSIGN_BLOCK):
        xn = normalized_rows(syn0, norms, _ids(ids[s : s + ASSIGN_BLOCK],
                                               cent.device))
        out[s : s + xn.shape[0]] = torch.argmax(xn @ cent.T, dim=1)
    return out.cpu().numpy()


def centroid_scores(syn0: torch.Tensor, norms: torch.Tensor, ids: np.ndarray,
                    cent: torch.Tensor) -> np.ndarray:
    """The ``(n, C)`` centroid scores of rows ``ids`` as a host array, in
    ``INCREMENTAL_BLOCK`` chunks: the incremental path's preference
    order."""
    out = np.zeros((len(ids), cent.shape[0]), np.float32)
    for s in range(0, len(ids), INCREMENTAL_BLOCK):
        out[s : s + INCREMENTAL_BLOCK] = centroid_scores_on_device(
            syn0, norms, ids[s : s + INCREMENTAL_BLOCK], cent).cpu().numpy()
    return out


def centroid_scores_on_device(syn0: torch.Tensor, norms: torch.Tensor,
                              ids: np.ndarray, cent: torch.Tensor) -> torch.Tensor:
    """The ``(n, C)`` centroid scores of rows ``ids`` on the centroids'
    device, one gather and one product (the build's spill path)."""
    return normalized_rows(syn0, norms, _ids(ids, cent.device)) @ cent.T


def _preference(scores, width: int) -> torch.Tensor:
    """Each row's ``width`` best clusters, by descending score with ties to
    the lower cluster (a stable sort), on the scores' device; ``scores``
    is a host array or a tensor."""
    t = scores if isinstance(scores, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(scores, dtype=np.float32))
    return torch.sort(t, dim=1, descending=True, stable=True).indices[:, :width]


def _place_spills(pos: np.ndarray, rid: np.ndarray, inv: np.ndarray,
                  pref_scores, members, invn, fill, cluster_of, slot_of,
                  L: int) -> None:
    """Place the spilled rows in order, each into the first cluster of its
    preference order that still has space, editing the layout in place:
    the result of placing them one at a time. Each row's
    ``SPILL_CANDIDATES`` best clusters come from one readback; a row that
    finds them all full takes its whole order.

    The native host pass (``native.ann_place_spills_native``) places them
    one at a time with the interpreter lock released, whole orders fetched
    ``SPILL_ROUND`` rows at a time. Without it, the Python pass runs in
    vectorised rounds over up to ``SPILL_ROUND`` rows: every row takes
    its first candidate (of ``SPILL_CANDIDATES``, or of its whole order
    once they are all full) under the clusters full at the round's start.
    Those choices are a row at a time's up to the first row that finds its
    cluster filled by the rows before it in the round (the only way a
    cluster's fullness can differ), so the rows before that one are placed
    and the next round starts there. A round ends at a cluster filling up
    or at its last row, so there are at most ``C`` more rounds than
    ``ceil(n / SPILL_ROUND)``."""
    from glint_word2vec_torch import native

    n, C = rid.shape[0], members.shape[0]
    # One readback of every row's candidates.
    cand = torch.cat([
        _preference(pref_scores(rid[s : s + ASSIGN_BLOCK]), SPILL_CANDIDATES)
        for s in range(0, n, ASSIGN_BLOCK)
    ]).to(torch.int32).cpu().numpy()
    layout = (L, fill, members, invn, cluster_of, slot_of)
    i = native.ann_place_spills_native(0, n, cand, rid, pos, inv, *layout)
    if i is not None:
        while i < n:
            b = min(i + SPILL_ROUND, n)
            whole = _preference(pref_scores(rid[i:b]), C).to(torch.int32)
            native.ann_place_spills_native(i, b, whole.cpu().numpy(), rid, pos,
                                           inv, *layout)
            i = native.ann_place_spills_native(b, n, cand[b:], rid, pos, inv,
                                               *layout)
        return
    deep: dict = {}  # row -> its whole preference order
    i = 0
    while i < n:
        b = min(i + SPILL_ROUND, n)
        full = fill >= L
        c_k = cand[i:b]
        ok = ~full[c_k]
        has = ok.any(axis=1)
        ch = c_k[np.arange(b - i), ok.argmax(axis=1)]
        if not has.all():
            lack = np.flatnonzero(~has) + i
            new = [r for r in lack.tolist() if r not in deep]
            if new:
                whole = _preference(pref_scores(rid[new]), C).to(torch.int32).cpu().numpy()
                deep.update(zip(new, whole))
            order = np.stack([deep[r] for r in lack.tolist()])
            ch[lack - i] = order[np.arange(lack.size), (~full[order]).argmax(axis=1)]
        # Rank of each row among the round's rows choosing its cluster.
        srt = np.argsort(ch, kind="stable")
        counts = np.bincount(ch, minlength=C)
        starts = np.zeros(C + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        rank = np.empty(b - i, np.int64)
        rank[srt] = np.arange(b - i) - starts[ch[srt]]
        over = np.flatnonzero(rank >= L - fill[ch])
        m = int(over[0]) if over.size else b - i
        c, r = ch[:m], rank[:m]
        slot = fill[c] + r
        members[c, slot] = rid[i : i + m]
        invn[c, slot] = inv[pos[i : i + m]]
        cluster_of[rid[i : i + m]] = c
        slot_of[rid[i : i + m]] = slot
        fill += np.bincount(c, minlength=C).astype(fill.dtype)
        i += m


# ----------------------------------------------------------------------
# The index value
# ----------------------------------------------------------------------


@dataclass
class AnnIndex:
    """A built coarse index over one table generation.

    Device state: ``centroids`` ``(C, d)`` fp32 row-normalized, ``members``
    ``(C, L)`` int32 row ids (0 in empty slots), ``member_invn`` ``(C, L)``
    fp32 reciprocal row norms (0 marks an empty slot or a zero-norm row:
    either can never surface), and ``member_rows`` ``(C, L, d)`` in the
    table's dtype, the member blocks the rerank scores against (a copy of
    its generation's rows, so a search never reads the live table).

    Host masters mirror the member layout so incremental updates edit in
    place and re-stage the id and norm arrays plus the touched clusters'
    blocks; ``cluster_of``/``slot_of`` make a removal O(1) a row.
    ``build_parts`` holds the seconds of each build stage."""

    clusters: int
    slots: int
    dim: int
    centroids: torch.Tensor
    members: Optional[torch.Tensor]
    member_invn: Optional[torch.Tensor]
    member_rows: Optional[torch.Tensor]
    members_np: np.ndarray
    invn_np: np.ndarray
    fill: np.ndarray  # (C,) live members per cluster
    cluster_of: np.ndarray  # (num_rows,) int32, -1 = not indexed
    slot_of: np.ndarray  # (num_rows,) int32
    table_version: int
    build_seconds: float
    built_rows: int  # queryable rows at build time
    sampled_rows: int
    spilled_rows: int
    iters: int
    updated_rows: int = 0  # incrementally re-bucketed since the build
    build_parts: dict = field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    def stats(self) -> dict:
        """Host summary for ``/healthz`` (every field a host scalar)."""
        return {
            "clusters": self.clusters,
            "member_slots": self.slots,
            "build_seconds": round(self.build_seconds, 3),
            "built_rows": self.built_rows,
            "sampled_rows": self.sampled_rows,
            "spilled_rows": self.spilled_rows,
            "updated_rows": self.updated_rows,
            "kmeans_iters": self.iters,
            "table_version": self.table_version,
        }

    def _restage(self) -> None:
        """Copy the edited host masters to the device (same shapes)."""
        self.members = torch.as_tensor(self.members_np).to(self.device, copy=True)
        self.member_invn = torch.as_tensor(self.invn_np).to(self.device, copy=True)


# ----------------------------------------------------------------------
# Build
# ----------------------------------------------------------------------


def _pack_members(
    assign: np.ndarray,
    inv: np.ndarray,
    live_ids: np.ndarray,
    C: int,
    L: int,
    pref_scores,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Pack assigned rows into the fixed (C, L) slot layout, spilling
    the overflow of oversized clusters to their next-best cluster with
    space (``pref_scores(ids) -> (n, C)``, a host array or a tensor,
    supplies preference rows for spilled ids). Returns the host masters +
    spill count.

    The non-spill majority places vectorized (stable argsort + rank
    within cluster), the spill tail in vectorised rounds
    (:func:`_place_spills`). Where a row's scores tie, the lower cluster
    comes first (the JAX package's ``argsort`` leaves that order to its
    sort); elsewhere the layout is the JAX package's."""
    num_rows_bound = int(live_ids.max()) + 1 if live_ids.size else 1
    members = np.zeros((C, L), np.int32)
    invn = np.zeros((C, L), np.float32)
    cluster_of = np.full(num_rows_bound, -1, np.int32)
    slot_of = np.zeros(num_rows_bound, np.int32)

    order = np.argsort(assign, kind="stable")
    c_o = assign[order].astype(np.int64)
    counts = np.bincount(c_o, minlength=C)
    starts = np.zeros(C + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    # Rank of each row inside its cluster (stable order): rows ranked
    # past L are the spill tail.
    ranks = np.arange(order.size, dtype=np.int64) - starts[c_o]
    fit = ranks < L
    rows_o = live_ids[order].astype(np.int64)
    members[c_o[fit], ranks[fit]] = rows_o[fit]
    invn[c_o[fit], ranks[fit]] = inv[order][fit]
    cluster_of[rows_o[fit]] = c_o[fit]
    slot_of[rows_o[fit]] = ranks[fit]
    fill = np.minimum(counts, L)
    spilled = order[~fit]
    if spilled.size:
        # Total capacity C*L >= SLOT_FACTOR * rows > rows, so some cluster
        # always has space.
        if int(counts.sum()) > C * L:
            raise ValueError("ANN member capacity exhausted")
        sp = np.asarray(spilled, np.int64)
        _place_spills(sp, live_ids[sp].astype(np.int64), inv, pref_scores,
                      members, invn, fill, cluster_of, slot_of, L)
    return members, invn, fill, cluster_of, slot_of, len(spilled)


def build(
    syn0: torch.Tensor,
    norms: torch.Tensor,
    queryable: int,
    *,
    clusters: Optional[int] = None,
    iters: int = 6,
    sample: int = 65536,
    seed: int = 0,
    table_version: int = 0,
    num_rows: Optional[int] = None,
) -> AnnIndex:
    """Train centroids on ``syn0``'s device and pack the member layout.
    ``syn0``/``norms`` may be the live tables or a staged generation's:
    nothing here reads or writes engine state. ``num_rows`` fixes the slot
    geometry (defaults to ``queryable``; the engine passes its full row
    capacity). The order of the JAX package's build: seeded sample,
    strided init, ``iters`` sweeps, full-table assignment, packing with
    spills, then the member blocks from one gather."""
    t0 = time.perf_counter()
    dev = syn0.device
    V = int(queryable)
    capacity = int(num_rows if num_rows is not None else V)
    C = int(clusters) if clusters else auto_clusters(capacity)
    L = member_slots(capacity, C)
    d = int(syn0.shape[1])
    parts = {}

    norms_np = norms[:V].cpu().numpy().astype(np.float32)
    live_ids = np.flatnonzero(norms_np > 0).astype(np.int32)
    inv_all = np.zeros(V, np.float32)
    inv_all[live_ids] = 1.0 / norms_np[live_ids]

    rng = np.random.default_rng(seed)
    S_raw = min(int(sample), live_ids.size)
    if live_ids.size and S_raw:
        sample_ids = (
            live_ids
            if S_raw == live_ids.size
            else rng.choice(live_ids, S_raw, replace=False).astype(np.int32)
        )
    else:
        sample_ids = np.zeros(1, np.int32)
        S_raw = 0
    S = max(ASSIGN_BLOCK, next_pow2(max(1, S_raw)))
    ids_pad = np.zeros(S, np.int32)
    ids_pad[:S_raw] = sample_ids[:S_raw]
    w = np.zeros(S, np.float32)
    w[:S_raw] = 1.0

    # The normalized sample from one gather; the scale is formed on the
    # host as the JAX package forms it.
    t = time.perf_counter()
    scale = torch.from_numpy(inv_all[ids_pad] * w).to(dev)
    xn = gather_rows(syn0, _ids(ids_pad, dev)) * scale[:, None]
    # Deterministic init: centroids from evenly strided sample rows;
    # zero rows (degenerate tables) fall back to unit e0.
    if S_raw >= C:
        pick = np.linspace(0, S_raw - 1, C).astype(np.int64)
        cent = xn.index_select(0, torch.from_numpy(pick).to(dev))
    else:
        cent = torch.zeros((C, d), dtype=torch.float32, device=dev)
        cent[:S_raw] = xn[:S_raw]
    zero = torch.linalg.norm(cent, dim=1) == 0
    e0 = torch.zeros(d, dtype=torch.float32, device=dev)
    e0[0] = 1.0
    cent = torch.where(zero[:, None], e0, cent)
    _sync(dev)
    parts["sample_seconds"] = time.perf_counter() - t

    t = time.perf_counter()
    w_dev = torch.from_numpy(w).to(dev)
    for _ in range(max(1, int(iters))):
        cent = kmeans_sweep(xn, w_dev, cent)
    del xn
    _sync(dev)
    parts["sweep_seconds"] = time.perf_counter() - t

    t = time.perf_counter()
    assign = assign_rows(syn0, norms, live_ids, cent)
    parts["assign_seconds"] = time.perf_counter() - t

    t = time.perf_counter()
    inv_live = inv_all[live_ids]
    members, invn, fill, cluster_of, slot_of, n_spill = _pack_members(
        assign, inv_live, live_ids, C, L,
        lambda ids: centroid_scores_on_device(syn0, norms, ids, cent),
    )
    # Per-row maps sized to the full capacity so later promotions index
    # directly.
    cap = max(capacity, cluster_of.shape[0])
    cof = np.full(cap, -1, np.int32)
    sof = np.zeros(cap, np.int32)
    cof[: cluster_of.shape[0]] = cluster_of
    sof[: slot_of.shape[0]] = slot_of
    parts["pack_seconds"] = time.perf_counter() - t

    idx = AnnIndex(
        clusters=C, slots=L, dim=d, centroids=cent,
        members=None, member_invn=None, member_rows=None,
        members_np=members, invn_np=invn, fill=fill,
        cluster_of=cof, slot_of=sof,
        table_version=int(table_version), build_seconds=0.0,
        built_rows=V, sampled_rows=int(S_raw), spilled_rows=int(n_spill),
        iters=int(iters), build_parts=parts,
    )
    t = time.perf_counter()
    idx._restage()
    # The block layout: one gather from the source table (live or staged),
    # rounded back to the table's dtype (bf16 round-trips exactly).
    idx.member_rows = gather_rows(syn0, idx.members.reshape(-1)).to(
        syn0.dtype).reshape(C, L, d)
    _sync(dev)
    parts["blocks_seconds"] = time.perf_counter() - t
    idx.build_seconds = time.perf_counter() - t0
    return idx


# ----------------------------------------------------------------------
# Search
# ----------------------------------------------------------------------


def search(index: AnnIndex, q: torch.Tensor, k: int, nprobe: int,
           queryable: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two-stage query on unit ``(Q, d)`` fp32 queries: the coarse
    top-``nprobe`` over ``q @ centroids.T``, then the exact masked rerank
    inside the probed clusters' member blocks, gathered whole (``nprobe``
    contiguous ``(L, d)`` blocks a query) and scored with one ``bmm``. A
    slot scores ``dot * inv_norm``, and ``-inf`` where it is empty, holds a
    zero-norm row or a row at or past ``queryable``. Returns ``(vals, ids)``
    ``(Q, k)`` on the device."""
    C, L, d = index.clusters, index.slots, index.dim
    Q = q.shape[0]
    pid = torch.topk(q @ index.centroids.T, nprobe, dim=1).indices.reshape(-1)
    blocks = index.member_rows.reshape(C, L * d).index_select(0, pid)
    blocks = blocks.reshape(Q, nprobe * L, d).float()
    dots = torch.bmm(blocks, q[:, :, None])[:, :, 0]
    cand = index.members.index_select(0, pid).reshape(Q, nprobe * L)
    inv = index.member_invn.index_select(0, pid).reshape(Q, nprobe * L)
    ok = (inv > 0) & (cand < int(queryable))
    scores = dots * inv + torch.where(ok, 0.0, float("-inf"))
    val, pos = torch.topk(scores, k, dim=1)
    return val, torch.gather(cand, 1, pos)


# ----------------------------------------------------------------------
# Incremental maintenance (row writes, promotions, frees)
# ----------------------------------------------------------------------


def _refresh_clusters(index: AnnIndex, syn0: torch.Tensor, clusters) -> None:
    """Re-gather the member blocks of only the touched clusters from the
    table, one ``gather_rows`` of L ids each."""
    for c in sorted(clusters):
        index.member_rows[c] = gather_rows(syn0, index.members[c]).to(
            index.member_rows.dtype)


def add_rows(index: AnnIndex, syn0: torch.Tensor, norms: torch.Tensor,
             ids: Sequence[int]) -> int:
    """Bucket newly written rows into the layout: only these rows move.
    Each row goes to its best centroid with space (preference order from
    one score product per ``INCREMENTAL_BLOCK`` chunk); zero-norm rows are
    skipped. Returns the number of rows inserted."""
    ids = np.asarray(list(ids), np.int64)
    if ids.size == 0:
        return 0
    norms_host = norms.cpu().numpy()
    inserted = 0
    touched: set = set()
    for s in range(0, ids.size, INCREMENTAL_BLOCK):
        chunk = ids[s : s + INCREMENTAL_BLOCK]
        scores = centroid_scores(syn0, norms, chunk, index.centroids)
        pref = np.argsort(-scores, axis=1)
        for row, rid in enumerate(chunk):
            rid = int(rid)
            if rid >= index.cluster_of.shape[0]:
                continue  # beyond the indexed row capacity
            if index.cluster_of[rid] >= 0:
                _drop_row(index, rid, touched)
            nr = norms_host[rid]
            if nr <= 0:
                continue
            for c in pref[row]:
                c = int(c)
                if index.fill[c] < index.slots:
                    slot = int(index.fill[c])
                    index.members_np[c, slot] = rid
                    index.invn_np[c, slot] = 1.0 / nr
                    index.cluster_of[rid] = c
                    index.slot_of[rid] = slot
                    index.fill[c] += 1
                    inserted += 1
                    touched.add(c)
                    break
    index.updated_rows += int(ids.size)
    index._restage()
    _refresh_clusters(index, syn0, touched)
    return inserted


def _drop_row(index: AnnIndex, rid: int, touched: set) -> None:
    """Remove one row from its slot, back-filling with the cluster's last
    member so the live prefix stays dense."""
    c = int(index.cluster_of[rid])
    if c < 0:
        return
    s = int(index.slot_of[rid])
    last = int(index.fill[c]) - 1
    if s != last:
        mover = int(index.members_np[c, last])
        index.members_np[c, s] = mover
        index.invn_np[c, s] = index.invn_np[c, last]
        index.slot_of[mover] = s
    index.members_np[c, last] = 0
    index.invn_np[c, last] = 0.0
    index.fill[c] = last
    index.cluster_of[rid] = -1
    touched.add(c)


def remove_rows(index: AnnIndex, syn0: torch.Tensor,
                ids: Sequence[int]) -> int:
    """Drop rows from the layout (freed extra rows), back-filling their
    slots; returns the number removed."""
    removed = 0
    touched: set = set()
    for rid in ids:
        rid = int(rid)
        if 0 <= rid < index.cluster_of.shape[0] and index.cluster_of[rid] >= 0:
            _drop_row(index, rid, touched)
            removed += 1
    if removed:
        index.updated_rows += removed
        index._restage()
        _refresh_clusters(index, syn0, touched)
    return removed


def update_rows(index: AnnIndex, syn0: torch.Tensor, norms: torch.Tensor,
                ids: Sequence[int]) -> int:
    """Re-bucket rows whose values changed (``write_rows``): drop and
    re-add with fresh norms and assignments. Touched rows only."""
    return add_rows(index, syn0, norms, ids)
