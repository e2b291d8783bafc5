"""Row kernels of the composed step: the port of
``glint_word2vec_tpu/ops/pallas_rows.py``.

- :func:`gather_rows` (``csrc/gather_rows.cu``) returns ``table[ids]``
  upcast to fp32, which is what the JAX engine's ``_pull_rows`` consumes
  (``gather_rows(...).astype(f32)``).
- :func:`scatter_add_rows` and :func:`scatter_add_rank1`
  (``csrc/scatter_runs.cu``, the table-dtype policy) add update rows into
  a table in place: runs of equal ids summed in the table's dtype, each
  run starting from the table row and every add rounded to the table's
  dtype, as the TPU kernels' table-dtype accumulator does
  (``pallas_rows.py:109-214``). For fp32 tables that is the same sum as
  the fused step's scatters of ``ops/fused_sgns.py``; under bf16 those
  round once per run instead.

Because every add rounds, a column's sum over a run is a chain of
dependent adds that may not be split, reassociated or done with float
atomics: each column of a run is summed by one thread, in sorted order,
which is what keeps the kernels bitwise equal to their plain versions
and training resumable bit for bit. ``scatter_add_rows`` (B3) sums a
short run (under 32 updates) in the warps at its first positions, and
``scatter_add_rank1`` (B2) in the warp at its first position; both hand
each long run (32 or more, such as row 0 of a grid batch: 9,262 updates
in B3, 4,616 in B2 at fastText width) to blocks of their own in the same
launch, one per (run, 8-column slice), which stream the run's payload
rows through shared memory with ``cp.async`` while one thread per column
adds them: the run's loads spread over many SMs, the add chains run
beside the short runs, and the longest chain is what remains. B2 runs
B3's kernels with a rank-1 payload: each update ``coef * h[hidx]`` is
formed in fp32 where it is added, and a zero coefficient's update is
added like any other (skipping it could leave -0.0 where the sum is
+0.0).

For a CUDA tensor each wrapper launches its kernel on the current stream,
or raises; for a CPU tensor it runs its ``*_reference``, the plain
PyTorch version the tests and ``chip_smoke.py`` hold the kernel against.
The id sort is PyTorch glue, as the JAX package does it outside Pallas
(``pallas_rows.py:240-244, 288``); the cast of the update rows to the
table's dtype (``:291``) happens inside the kernel, which reads fp32
update rows.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from glint_word2vec_torch.ops.fused_sgns import (
    _check,
    _check_table,
    _check_vec,
    _route,
    launch_rows,
    sorted_runs,
)

_DTYPE_TAGS = {torch.float32: 0, torch.bfloat16: 1}
_bound = None
_scatter_bound = None
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32


def gather_rows_reference(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain version: ``table[ids]`` as fp32, one ``index_select``."""
    return table.index_select(0, ids.long()).float()


def _lib():
    global _bound
    if _bound is None:
        from glint_word2vec_torch.kernels import build

        lib = build.library("gather_rows")
        lib.glint_gather_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_void_p,
        ]
        lib.glint_gather_rows.restype = ctypes.c_int
        lib.glint_gather_rows_grid.argtypes = [_I64, _I32, _P]
        lib.glint_gather_rows_grid.restype = ctypes.c_int
        lib.glint_cuda_error_string.argtypes = [ctypes.c_int]
        lib.glint_cuda_error_string.restype = ctypes.c_char_p
        _bound = lib
    return _bound


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` as a new contiguous ``(N, d)`` fp32 tensor.

    ``table`` is a contiguous ``(V, d)`` fp32 or bf16 tensor, ``ids`` a
    contiguous ``(N,)`` int32 tensor on the same device with every id in
    ``[0, V)`` (the caller clips; the engine does). Each kernel launch
    adds one to ``gather_rows.launches``."""
    if table.dim() != 2:
        raise ValueError(f"table must be 2-D, got shape {tuple(table.shape)}")
    if table.dtype not in _DTYPE_TAGS:
        raise TypeError(f"table dtype must be float32 or bfloat16, got {table.dtype}")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise TypeError(
            f"ids must be a 1-D int32 tensor, got {ids.dtype} {tuple(ids.shape)}"
        )
    if not ids.is_contiguous():
        raise ValueError("ids must be contiguous")
    if ids.device != table.device:
        raise ValueError(f"ids on {ids.device}, table on {table.device}")
    if table.device.type == "cpu":
        return gather_rows_reference(table, ids)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    n, d = ids.shape[0], table.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=table.device)
    if n == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(table.device).cuda_stream
    rc = lib.glint_gather_rows(
        table.data_ptr(), ids.data_ptr(), out.data_ptr(),
        n, d, table.stride(0), _DTYPE_TAGS[table.dtype], stream,
    )
    if rc != 0:
        msg = lib.glint_cuda_error_string(rc).decode()
        raise RuntimeError(f"gather_rows launch failed: {msg} (cudaError {rc})")
    gather_rows.launches += 1
    return out


#: Kernel launches since the last reset (``chip_smoke.py`` zeroes it
#: before driving the served path and reads it after).
gather_rows.launches = 0


def gather_rows_grid(n: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """``(blocks, blocks an SM holds, SMs)`` of the launch
    :func:`gather_rows` makes for ``n`` rows of a ``dtype`` table on the
    current card: ``blocks / (per_sm * sms)`` is its number of waves."""
    out = (ctypes.c_int64 * 3)()
    lib = _lib()
    rc = lib.glint_gather_rows_grid(n, _DTYPE_TAGS[dtype], out)
    if rc != 0:
        msg = lib.glint_cuda_error_string(rc).decode()
        raise RuntimeError(f"gather_rows_grid failed: {msg} (cudaError {rc})")
    return out[0], out[1], out[2]


# ----------------------------------------------------------------------
# Scatter-adds in the table's dtype
# ----------------------------------------------------------------------


def _scatter_lib():
    global _scatter_bound
    if _scatter_bound is None:
        from glint_word2vec_torch.kernels import build

        lib = build.library("scatter_runs")
        lib.glint_scatter_add_rows.argtypes = [
            _P, _I64, _I64, _I32, _P, _P, _I64, _P, _P, _P,
        ]
        lib.glint_scatter_add_rows.restype = ctypes.c_int
        lib.glint_scatter_add_rows_workspace.argtypes = [_I64]
        lib.glint_scatter_add_rows_workspace.restype = _I64
        lib.glint_scatter_add_rank1_table.argtypes = [
            _P, _I64, _I64, _I32, _P, _P, _I64, _P, _P, _P, _I64, _P, _P,
        ]
        lib.glint_scatter_add_rank1_table.restype = ctypes.c_int
        lib.glint_cuda_error_string.argtypes = [ctypes.c_int]
        lib.glint_cuda_error_string.restype = ctypes.c_char_p
        _scatter_bound = lib
    return _scatter_bound


def _run_sum_table_reference(table, sid, order, payload) -> torch.Tensor:
    """``table[sid] += payload[order]`` with each run summed in the
    table's dtype: the run starts from the table row, and every add rounds
    to the table's dtype. ``payload`` is in the table's dtype already.

    On the CPU both calls below add serially in index order, which is the
    kernel's order: ``index_add_`` on an fp32 tensor (it sums a bf16 run
    in fp32, so not under bf16), and ``index_put_(accumulate=True)`` on a
    bf16 one, one rounding per add (for fp32 it turns to parallel float
    atomics from 32768 elements on)."""
    uniq, inverse = torch.unique_consecutive(sid.long(), return_inverse=True)
    acc = table[uniq]
    if acc.dtype == torch.float32:
        acc.index_add_(0, inverse, payload[order.long()])
    else:
        acc.index_put_((inverse,), payload[order.long()], accumulate=True)
    table[uniq] = acc
    return table


def scatter_add_rows_reference(table, ids, upd) -> torch.Tensor:
    """Plain version of :func:`scatter_add_rows` (in place)."""
    sid, order = sorted_runs(ids)
    return _run_sum_table_reference(table, sid, order, upd.to(table.dtype))


def scatter_add_rank1_reference(table, ids, coef, h, hidx) -> torch.Tensor:
    """Plain version of :func:`scatter_add_rank1` (in place): the update
    row ``coef * h[hidx]`` is formed in fp32 and cast to the table's dtype,
    then run-summed."""
    sid, order = sorted_runs(ids)
    payload = (coef.float()[:, None] * h.float()[hidx.long()]).to(table.dtype)
    return _run_sum_table_reference(table, sid, order, payload)


def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor,
                     upd: torch.Tensor) -> torch.Tensor:
    """``table[ids] += upd`` in place, ``upd`` cast to the table's dtype
    first and duplicate ids summed in the table's dtype, one rounding per
    add. ``table`` ``(V, d)`` fp32 or bf16; ``ids`` ``(N,)`` int32 in
    ``[0, V)``; ``upd`` ``(N, d)`` fp32 or of the table's dtype. Each
    call that reaches the card adds one to ``scatter_add_rows.launches``,
    though it is the pre-pass and the scatter kernel (see
    :func:`scatter_add_rows_sorted`)."""
    _check_table(table, "table")
    dev = table.device
    N, d = ids.shape[0], table.shape[1]
    _check_vec(ids, "ids", torch.int32, (N,), dev)
    if upd.dtype not in (torch.float32, table.dtype):
        raise TypeError(
            f"upd must be float32 or {table.dtype}, got {upd.dtype}"
        )
    _check_vec(upd, "upd", upd.dtype, (N, d), dev)
    if not _route(dev):
        return scatter_add_rows_reference(table, ids, upd)
    if N:
        # fp32 rows; bf16 ones widen exactly and round back to themselves.
        scatter_add_rows_sorted(table, *sorted_runs(ids), upd.float().contiguous())
    return table


def scatter_add_rows_sorted(table: torch.Tensor, sorted_ids: torch.Tensor,
                            order: torch.Tensor, upd: torch.Tensor) -> None:
    """The kernel launch of :func:`scatter_add_rows` for CUDA tensors
    already validated and sorted by
    :func:`~glint_word2vec_torch.ops.fused_sgns.sorted_runs`, with
    contiguous fp32 ``upd`` (what ``chip_smoke.py`` times on its own).

    One call is the scatter kernel and, when ``N >= 32``, before it a
    pre-pass that finds the long runs, both on the current stream: no
    host sync."""
    lib = _scatter_lib()
    launch_rows(lib, lib.glint_scatter_add_rows, "scatter_add_rows", table,
                sorted_ids, order, upd)
    scatter_add_rows.launches += 1


#: Calls that launched the kernels since the last reset: one a call,
#: though a call is up to two kernel launches (pre-pass, scatter).
scatter_add_rows.launches = 0


def scatter_add_rank1(table: torch.Tensor, ids: torch.Tensor,
                      coef: torch.Tensor, h: torch.Tensor,
                      hidx: torch.Tensor) -> torch.Tensor:
    """``table[ids] += (coef[:, None] * h[hidx])`` in place without the
    ``(N, d)`` payload: each update row is formed in fp32, cast to the
    table's dtype, and runs of equal ids are summed in the table's dtype.
    ``ids``/``hidx`` ``(N,)`` int32, ``coef`` ``(N,)`` fp32, ``h``
    ``(B, d)`` fp32 contiguous. Each call that reaches the card adds one
    to ``scatter_add_rank1.launches``, though it is the pre-pass and the
    scatter kernel (see :func:`scatter_add_rank1_sorted`)."""
    _check_table(table, "table")
    dev = table.device
    N, d = ids.shape[0], table.shape[1]
    _check_vec(ids, "ids", torch.int32, (N,), dev)
    _check_vec(coef, "coef", torch.float32, (N,), dev)
    _check_vec(hidx, "hidx", torch.int32, (N,), dev)
    if h.dim() != 2 or h.shape[1] != d:
        raise ValueError(f"h must be (B, {d}), got {tuple(h.shape)}")
    _check_vec(h, "h", torch.float32, tuple(h.shape), dev)
    if not _route(dev):
        return scatter_add_rank1_reference(table, ids, coef, h, hidx)
    if N:
        scatter_add_rank1_sorted(table, *sorted_runs(ids), coef, h, hidx)
    return table


def scatter_add_rank1_sorted(table: torch.Tensor, sorted_ids: torch.Tensor,
                             order: torch.Tensor, coef: torch.Tensor,
                             h: torch.Tensor, hidx: torch.Tensor) -> None:
    """The kernel launch of :func:`scatter_add_rank1` for CUDA tensors
    already validated and sorted (what ``chip_smoke.py`` times on its
    own): the kernels of :func:`scatter_add_rows_sorted` with the rank-1
    payload, and their workspace taken from the caching allocator."""
    lib = _scatter_lib()
    n = sorted_ids.shape[0]
    work = torch.empty(lib.glint_scatter_add_rows_workspace(n),
                       dtype=torch.int32, device=table.device)
    rc = lib.glint_scatter_add_rank1_table(
        table.data_ptr(), table.stride(0), table.shape[1],
        _DTYPE_TAGS[table.dtype], sorted_ids.data_ptr(), order.data_ptr(),
        n, coef.data_ptr(), h.data_ptr(), hidx.data_ptr(), h.stride(0),
        work.data_ptr(), torch.cuda.current_stream(table.device).cuda_stream,
    )
    _check(lib, rc, "scatter_add_rank1")
    scatter_add_rank1.launches += 1


#: Calls that launched the kernels since the last reset: one a call,
#: though a call is up to two kernel launches (pre-pass, scatter).
scatter_add_rank1.launches = 0
