"""The fused SGNS pair step: the port of ``glint_word2vec_tpu/ops/pallas_sgns.py``,
with per-pair negatives (:func:`fused_pair_step`) or a shared negative
pool (:func:`fused_pair_step_shared`).

Four hand-written CUDA kernels carry it, each beside its plain PyTorch
version and with a ``launches`` counter on its wrapper:

- :func:`pair_forward` (``csrc/pair_forward.cu``): gathers, dot products,
  sigmoids and coefficients, the fp32 center rows ``h`` and the center
  gradient ``d_center``, and the summed loss; one warp a pair, all of its
  ``2 + n`` rows staged in shared memory before any is used, or, where
  they do not fit, read from the tables in two passes (the tiled form).
- :func:`pair_forward_shared` (``csrc/pair_forward_shared.cu``): the same
  against one pool of S negatives shared by the batch, with the three
  dense pool products (``f_pool``, the pool term of ``d_center``, and
  ``d_pool``) on the tensor cores in split TF32, to fp32 accuracy.
- :func:`scatter_add_rank1_hbm` (``csrc/scatter_runs.cu``): ``table[ids] +=
  coef * h[hidx]``, never materialising the ``(N, d)`` payload.
- :func:`scatter_add_rows_f32` (``csrc/scatter_runs.cu``): ``table[ids] +=
  upd``.

The two scatters run on one kernel design with two payloads: a pre-pass
that finds the runs of 32 or more equal ids, then a scatter kernel whose
first blocks take those runs and whose other warps each take a short run.

The scatters sum each run of equal ids in fp32, in input order, and round
to the storage dtype once per run. Unlike the JAX functions, which return
new tables (``input_output_aliases`` lets XLA reuse the buffers), the
scatters here update the table in place and return it.

For a CPU tensor each wrapper runs its ``*_reference`` plain version; for
a CUDA tensor it launches the kernel on the current stream or raises.
Sorting the ids and building the concatenated syn1 update lists are
PyTorch glue, as the JAX package does them outside Pallas
(``_sorted_scatter_args``, ``pallas_sgns.py:585-597``; :762-765).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

_DTYPE_TAGS = {torch.float32: 0, torch.bfloat16: 1}
_libs: dict = {}
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32


def _lib(name: str):
    """The loaded library of ``csrc/<name>.cu``, built and bound on first
    use."""
    lib = _libs.get(name)
    if lib is None:
        from glint_word2vec_torch.kernels import build

        lib = build.library(name)
        if name == "pair_forward":
            forward = [
                _P, _P, _I64, _I32, _P, _P, _P, _P, _P, _P, _I64, _I32, _I64,
                _P, _P, _P, _P, _P, _P,
            ]
            lib.glint_pair_forward.argtypes = forward + [_P]
            lib.glint_pair_forward.restype = ctypes.c_int
            lib.glint_pair_forward_tiled.argtypes = forward
            lib.glint_pair_forward_tiled.restype = ctypes.c_int
            lib.glint_pair_forward_grid.argtypes = [
                _P, _P, _I64, _I32, _I64, _I32, _I64, _I32, _P,
            ]
            lib.glint_pair_forward_grid.restype = ctypes.c_int
        elif name == "pair_forward_shared":
            lib.glint_pair_forward_shared.argtypes = [
                _P, _P, _I64, _I32, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                ctypes.c_float, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
            ]
            lib.glint_pair_forward_shared.restype = ctypes.c_int
            lib.glint_pair_forward_shared_loss_tiles.argtypes = [_I64]
            lib.glint_pair_forward_shared_loss_tiles.restype = _I64
            lib.glint_pair_forward_shared_part_size.argtypes = [_I64] * 3
            lib.glint_pair_forward_shared_part_size.restype = _I64
            lib.glint_pair_forward_shared_grid.argtypes = [_I64] * 3 + [_I32, _P]
            lib.glint_pair_forward_shared_grid.restype = ctypes.c_int
        else:
            lib.glint_scatter_add_rows_f32.argtypes = [
                _P, _I64, _I64, _I32, _P, _P, _I64, _P, _P, _P,
            ]
            lib.glint_scatter_add_rows_f32.restype = ctypes.c_int
            lib.glint_scatter_add_rows_workspace.argtypes = [_I64]
            lib.glint_scatter_add_rows_workspace.restype = _I64
            lib.glint_scatter_add_rank1.argtypes = [
                _P, _I64, _I64, _I32, _P, _P, _I64, _P, _P, _P, _I64, _P, _P,
            ]
            lib.glint_scatter_add_rank1.restype = ctypes.c_int
        lib.glint_cuda_error_string.argtypes = [ctypes.c_int]
        lib.glint_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.glint_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {rc})")


def _check_table(table: torch.Tensor, name: str) -> None:
    if table.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(table.shape)}")
    if table.dtype not in _DTYPE_TAGS:
        raise TypeError(f"{name} dtype must be float32 or bfloat16, got {table.dtype}")
    if not table.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_vec(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise TypeError(
            f"{name} must be {dtype} of shape {tuple(shape)}, got "
            f"{t.dtype} {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, table on {device}")


def _route(device: torch.device) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return True


# ----------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------


class PairForward(NamedTuple):
    """Forward outputs of one dense pair batch."""

    c_pos: torch.Tensor  # (P,)   alpha * (1 - sigmoid(f_pos)) * mask
    c_neg: torch.Tensor  # (P, n) -alpha * sigmoid(f_neg) * nmask
    h: torch.Tensor  # (P, d) fp32 pre-update syn0 rows of the centers
    d_center: torch.Tensor  # (P, d) fp32 learning-rate-folded center gradient
    loss_sum: torch.Tensor  # () masked loss sum (divide by mask.sum())


def pair_forward_reference(syn0, syn1, centers, contexts, mask, negs, nmask,
                           alpha) -> PairForward:
    """Plain version of :func:`pair_forward`."""
    h = syn0[centers.long()].float()
    u = syn1[contexts.long()].float()
    un = syn1[negs.long()].float()
    f_pos = (h * u).sum(dim=-1)
    f_neg = (h[:, None, :] * un).sum(dim=-1)
    c_pos = alpha * (1.0 - torch.sigmoid(f_pos)) * mask
    c_neg = -alpha * torch.sigmoid(f_neg) * nmask
    d_center = c_pos[:, None] * u + (c_neg[..., None] * un).sum(dim=1)
    pair_loss = (
        -F.logsigmoid(f_pos) - (F.logsigmoid(-f_neg) * nmask).sum(dim=-1)
    ) * mask
    return PairForward(c_pos, c_neg, h, d_center, pair_loss.sum())


def _pair_forward(syn0, syn1, centers, contexts, mask, negs, nmask, alpha,
                  tiled: bool) -> PairForward:
    """:func:`pair_forward` (``tiled`` False) or :func:`pair_forward_tiled`
    (True)."""
    _check_table(syn0, "syn0")
    _check_table(syn1, "syn1")
    if syn0.dtype != syn1.dtype or syn0.shape[1] != syn1.shape[1]:
        raise ValueError("syn0 and syn1 must share dtype and width")
    dev = syn0.device
    if syn1.device != dev:
        raise ValueError(f"syn1 on {syn1.device}, syn0 on {dev}")
    P = centers.shape[0]
    n = negs.shape[1] if negs.dim() == 2 else -1
    if n < 1:
        raise ValueError("negs must be (P, n) with n >= 1")
    _check_vec(centers, "centers", torch.int32, (P,), dev)
    _check_vec(contexts, "contexts", torch.int32, (P,), dev)
    _check_vec(mask, "mask", torch.float32, (P,), dev)
    _check_vec(negs, "negs", torch.int32, (P, n), dev)
    _check_vec(nmask, "nmask", torch.float32, (P, n), dev)
    _check_vec(alpha, "alpha", torch.float32, (), dev)
    if not _route(dev):
        return pair_forward_reference(
            syn0, syn1, centers, contexts, mask, negs, nmask, alpha
        )
    d = syn0.shape[1]
    f32 = dict(dtype=torch.float32, device=dev)
    c_pos = torch.empty(P, **f32)
    c_neg = torch.empty((P, n), **f32)
    h = torch.empty((P, d), **f32)
    d_center = torch.empty((P, d), **f32)
    loss = torch.empty(P, **f32)
    if P:
        lib = _lib("pair_forward")
        args = (
            syn0.data_ptr(), syn1.data_ptr(), syn0.stride(0),
            _DTYPE_TAGS[syn0.dtype], centers.data_ptr(), contexts.data_ptr(),
            mask.data_ptr(), negs.data_ptr(), nmask.data_ptr(),
            alpha.data_ptr(), P, n, d, c_pos.data_ptr(), c_neg.data_ptr(),
            h.data_ptr(), d_center.data_ptr(), loss.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if tiled:
            _check(lib, lib.glint_pair_forward_tiled(*args),
                   "pair_forward_tiled")
            pair_forward_tiled.launches += 1
        else:
            form = ctypes.c_int32(0)
            _check(lib, lib.glint_pair_forward(*args, ctypes.byref(form)),
                   "pair_forward")
            pair_forward.launches += 1
            pair_forward.tiled_launches += form.value
    return PairForward(c_pos, c_neg, h, d_center, loss.sum())


def pair_forward(syn0: torch.Tensor, syn1: torch.Tensor,
                 centers: torch.Tensor, contexts: torch.Tensor,
                 mask: torch.Tensor, negs: torch.Tensor, nmask: torch.Tensor,
                 alpha: torch.Tensor) -> PairForward:
    """Forward half of the fused pair step (per-pair negatives).

    ``syn0``/``syn1`` are contiguous ``(V, d)`` tables of one dtype (fp32
    or bf16); ``centers``/``contexts`` ``(P,)`` int32 in ``[0, V)``;
    ``mask`` ``(P,)`` fp32; ``negs`` ``(P, n)`` int32; ``nmask`` ``(P, n)``
    fp32; ``alpha`` a 0-d fp32 tensor, all on one device. Every ``d`` and
    ``n >= 1`` runs: the kernel gives each pair one warp, which stages all
    its ``2 + n`` rows in shared memory before it uses any where they fit
    in a block's 227 KB (the one-pass form), and otherwise reads them from
    the tables in two passes over the columns (the tiled form,
    :func:`pair_forward_tiled`), which forms the same sums in the same
    order. The per-pair losses are summed in a fixed order
    (``torch.sum``), never with float atomics: two calls on the same
    inputs agree bitwise. Each kernel launch adds one to
    ``pair_forward.launches``, and one in the tiled form also to
    ``pair_forward.tiled_launches``."""
    return _pair_forward(syn0, syn1, centers, contexts, mask, negs, nmask,
                         alpha, tiled=False)


#: Kernel launches since the last reset (``chip_smoke.py`` zeroes it
#: before driving the training path and reads it after), and those of
#: them in the tiled form.
pair_forward.launches = 0
pair_forward.tiled_launches = 0


def pair_forward_tiled(syn0: torch.Tensor, syn1: torch.Tensor,
                       centers: torch.Tensor, contexts: torch.Tensor,
                       mask: torch.Tensor, negs: torch.Tensor,
                       nmask: torch.Tensor, alpha: torch.Tensor) -> PairForward:
    """:func:`pair_forward` in its tiled form at any shape, for holding
    the two forms against each other (:func:`pair_forward` takes it only
    where a pair's rows do not fit in shared memory). Each launch adds one
    to ``pair_forward_tiled.launches``."""
    return _pair_forward(syn0, syn1, centers, contexts, mask, negs, nmask,
                         alpha, tiled=True)


pair_forward_tiled.launches = 0


def pair_forward_grid(P: int, n: int, syn0: torch.Tensor,
                      syn1: torch.Tensor, tiled: bool = False) -> dict:
    """The launch :func:`pair_forward` (or, with ``tiled``,
    :func:`pair_forward_tiled`) makes for ``P`` pairs of ``n`` negatives on
    these CUDA tables, on the current card: ``{"blocks",
    "pairs_per_block", "per_sm": blocks an SM holds at once, "sms",
    "tiled": whether it takes the tiled form}``; ``blocks / (per_sm *
    sms)`` is its number of waves."""
    out = (ctypes.c_int64 * 5)()
    lib = _lib("pair_forward")
    _check(lib, lib.glint_pair_forward_grid(
        syn0.data_ptr(), syn1.data_ptr(), syn0.stride(0),
        _DTYPE_TAGS[syn0.dtype], P, n, syn0.shape[1], int(tiled), out),
        "pair_forward_grid")
    return {"blocks": out[0], "pairs_per_block": out[1], "per_sm": out[2],
            "sms": out[3], "tiled": bool(out[4])}


class SharedPairForward(NamedTuple):
    """Forward outputs of one dense pair batch under the shared-pool
    estimator."""

    c_pos: torch.Tensor  # (P,)
    h: torch.Tensor  # (P, d) fp32
    d_center: torch.Tensor  # (P, d) fp32
    d_pool: torch.Tensor  # (S, d) fp32 dense update of the pool rows
    loss_sum: torch.Tensor  # ()


def _pool_weight(num_negatives: int, S: int) -> float:
    """``n / S``, the weight of a pool word: taken in double precision
    and used as an fp32 scalar, as the JAX kernel's Python float is."""
    return float(num_negatives) / float(S)


def pair_forward_shared_reference(syn0, syn1, centers, contexts, mask, pool,
                                  alpha, num_negatives) -> SharedPairForward:
    """Plain version of :func:`pair_forward_shared`: the collision rule
    of the C = 1 form (a pool word equal to the pair's context is
    dropped) and the weight ``mask * n / S`` (``pallas_sgns.py:374-382``)."""
    h = syn0[centers.long()].float()
    u = syn1[contexts.long()].float()
    up = syn1[pool.long()].float()
    f_pos = (h * u).sum(dim=-1)
    f_pool = h @ up.T
    keep = (pool[None, :] != contexts[:, None]).to(torch.float32)
    w = (mask * _pool_weight(num_negatives, pool.shape[0]))[:, None] * keep
    c_pos = alpha * (1.0 - torch.sigmoid(f_pos)) * mask
    c_pool = -alpha * torch.sigmoid(f_pool) * w
    d_center = c_pos[:, None] * u + c_pool @ up
    d_pool = c_pool.T @ h
    loss = (-F.logsigmoid(f_pos) * mask).sum() + (
        -F.logsigmoid(-f_pool) * w
    ).sum()
    return SharedPairForward(c_pos, h, d_center, d_pool, loss)


def pair_forward_shared(syn0: torch.Tensor, syn1: torch.Tensor,
                        centers: torch.Tensor, contexts: torch.Tensor,
                        mask: torch.Tensor, pool: torch.Tensor,
                        alpha: torch.Tensor,
                        num_negatives: int) -> SharedPairForward:
    """Forward half of the fused pair step, shared-pool estimator.

    Arguments as :func:`pair_forward`, with ``pool`` ``(S,)`` int32 in
    ``[0, V)``, S >= 1 (ids may repeat and may equal a context), in place
    of the per-pair negatives, and ``num_negatives`` the ``n`` the pool
    stands for (each pool word weighs ``n / S``). The kernel runs its
    three pool products on the tensor cores in split TF32: each fp32
    operand is a TF32 ``hi`` plus a TF32 ``lo`` and each product the sum
    of three TF32 products, about 2^-22 off, so the result keeps fp32
    accuracy (bf16 rows are exact TF32 and need no ``lo``). Every output
    is summed in a fixed order, so two calls on the same inputs agree
    bitwise. Its per-pair partial losses are summed here in a fixed
    order (``torch.sum``). Each call that launches the kernels adds one
    to ``pair_forward_shared.launches``."""
    _check_table(syn0, "syn0")
    _check_table(syn1, "syn1")
    if syn0.dtype != syn1.dtype or syn0.shape[1] != syn1.shape[1]:
        raise ValueError("syn0 and syn1 must share dtype and width")
    dev = syn0.device
    if syn1.device != dev:
        raise ValueError(f"syn1 on {syn1.device}, syn0 on {dev}")
    P = centers.shape[0]
    S = pool.shape[0] if pool.dim() == 1 else 0
    if S < 1:
        raise ValueError("pool must be (S,) with S >= 1")
    if int(num_negatives) < 1:
        raise ValueError("num_negatives must be >= 1")
    _check_vec(centers, "centers", torch.int32, (P,), dev)
    _check_vec(contexts, "contexts", torch.int32, (P,), dev)
    _check_vec(mask, "mask", torch.float32, (P,), dev)
    _check_vec(pool, "pool", torch.int32, (S,), dev)
    _check_vec(alpha, "alpha", torch.float32, (), dev)
    if not _route(dev):
        return pair_forward_shared_reference(
            syn0, syn1, centers, contexts, mask, pool, alpha, num_negatives
        )
    d = syn0.shape[1]
    f32 = dict(dtype=torch.float32, device=dev)
    c_pos = torch.empty(P, **f32)
    h = torch.empty((P, d), **f32)
    d_center = torch.empty((P, d), **f32)
    if not P:
        return SharedPairForward(
            c_pos, h, d_center, torch.zeros((S, d), **f32), torch.zeros((), **f32)
        )
    d_pool = torch.empty((S, d), **f32)
    lib = _lib("pair_forward_shared")
    loss_pos = torch.empty(P, **f32)
    loss_part = torch.empty(
        (P, lib.glint_pair_forward_shared_loss_tiles(S)), **f32
    )
    pool32 = torch.empty((S, d), **f32)
    c_pool = torch.empty((P, S), **f32)
    part = torch.empty(lib.glint_pair_forward_shared_part_size(P, S, d), **f32)
    rc = lib.glint_pair_forward_shared(
        syn0.data_ptr(), syn1.data_ptr(), syn0.stride(0),
        _DTYPE_TAGS[syn0.dtype], centers.data_ptr(), contexts.data_ptr(),
        mask.data_ptr(), pool.data_ptr(), alpha.data_ptr(), P, S, d,
        _pool_weight(num_negatives, S), c_pos.data_ptr(), h.data_ptr(),
        d_center.data_ptr(), d_pool.data_ptr(), loss_pos.data_ptr(),
        loss_part.data_ptr(), pool32.data_ptr(), c_pool.data_ptr(),
        part.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _check(lib, rc, "pair_forward_shared")
    pair_forward_shared.launches += 1
    return SharedPairForward(
        c_pos, h, d_center, d_pool, loss_pos.sum() + loss_part.sum()
    )


#: Calls that launched the kernels since the last reset.
pair_forward_shared.launches = 0


def pair_forward_shared_grid(P: int, S: int, d: int,
                             dtype: torch.dtype) -> dict:
    """The product launches :func:`pair_forward_shared` makes for ``P``
    pairs, a pool of ``S`` and width ``d`` on ``dtype`` tables, on the
    current card: ``{"logits": (blocks, blocks an SM holds), "grads":
    (...), "sms": SMs}``; ``blocks / (per_sm * sms)`` is a launch's number
    of waves."""
    out = (ctypes.c_int64 * 5)()
    lib = _lib("pair_forward_shared")
    _check(lib, lib.glint_pair_forward_shared_grid(P, S, d, _DTYPE_TAGS[dtype], out),
           "pair_forward_shared_grid")
    return {"logits": (out[0], out[2]), "grads": (out[1], out[3]), "sms": out[4]}


# ----------------------------------------------------------------------
# Run-summing scatters
# ----------------------------------------------------------------------


def sorted_runs(ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sorted_ids, order)``, both int32: a stable sort of the ids, so
    equal ids form runs in input order."""
    sid, order = torch.sort(ids, stable=True)
    return sid.contiguous(), order.to(torch.int32)


def _run_sum_reference(table, sid, order, payload) -> torch.Tensor:
    """``table[sid] += payload[order]``, each run summed in fp32 in
    sorted order onto the fp32 table row and rounded once. On the CPU
    ``index_add_`` adds in index order, which is the kernels' order."""
    uniq, inverse = torch.unique_consecutive(sid.long(), return_inverse=True)
    acc = table[uniq].float()
    acc.index_add_(0, inverse, payload[order.long()])
    table[uniq] = acc.to(table.dtype)
    return table


def scatter_add_rows_f32_reference(table, ids, upd) -> torch.Tensor:
    """Plain version of :func:`scatter_add_rows_f32` (in place)."""
    sid, order = sorted_runs(ids)
    return _run_sum_reference(table, sid, order, upd.float())


def scatter_add_rank1_hbm_reference(table, ids, coef, h, hidx) -> torch.Tensor:
    """Plain version of :func:`scatter_add_rank1_hbm` (in place): the
    payload ``coef * h[hidx]`` is formed in fp32, then run-summed."""
    sid, order = sorted_runs(ids)
    payload = coef.float()[:, None] * h.float()[hidx.long()]
    return _run_sum_reference(table, sid, order, payload)


def scatter_add_rows_f32(table: torch.Tensor, ids: torch.Tensor,
                         upd: torch.Tensor) -> torch.Tensor:
    """``table[ids] += upd`` in place, duplicate ids summed in fp32 and
    rounded to the table's dtype once per run. ``table`` ``(V, d)`` fp32
    or bf16; ``ids`` ``(N,)`` int32 in ``[0, V)``; ``upd`` ``(N, d)``
    fp32. Each call that reaches the card adds one to
    ``scatter_add_rows_f32.launches``, though it is the pre-pass and the
    scatter kernel (see :func:`scatter_add_rows_f32_sorted`)."""
    _check_table(table, "table")
    dev = table.device
    N, d = ids.shape[0], table.shape[1]
    _check_vec(ids, "ids", torch.int32, (N,), dev)
    _check_vec(upd, "upd", torch.float32, (N, d), dev)
    if not _route(dev):
        return scatter_add_rows_f32_reference(table, ids, upd)
    if N:
        scatter_add_rows_f32_sorted(table, *sorted_runs(ids), upd)
    return table


def scatter_add_rows_f32_sorted(table: torch.Tensor, sorted_ids: torch.Tensor,
                                order: torch.Tensor,
                                upd: torch.Tensor) -> None:
    """The kernel launch of :func:`scatter_add_rows_f32` for CUDA tensors
    already validated and sorted by :func:`sorted_runs` (what
    ``chip_smoke.py`` times on its own).

    One call is the scatter kernel and, when ``N >= 32``, before it a
    pre-pass that finds the long runs, both on the current stream: no
    host sync."""
    lib = _lib("scatter_runs")
    launch_rows(lib, lib.glint_scatter_add_rows_f32, "scatter_add_rows_f32",
                table, sorted_ids, order, upd)
    scatter_add_rows_f32.launches += 1


def launch_rows(lib, entry, what: str, table: torch.Tensor,
                sorted_ids: torch.Tensor, order: torch.Tensor,
                upd: torch.Tensor) -> None:
    """Launch ``entry``, one of the rows forms of ``csrc/scatter_runs.cu``
    (``glint_scatter_add_rows_f32`` or ``glint_scatter_add_rows``), on
    the current stream, with the int32 workspace its pre-pass writes
    taken from the caching allocator."""
    n = sorted_ids.shape[0]
    work = torch.empty(lib.glint_scatter_add_rows_workspace(n),
                       dtype=torch.int32, device=table.device)
    rc = entry(
        table.data_ptr(), table.stride(0), table.shape[1],
        _DTYPE_TAGS[table.dtype], sorted_ids.data_ptr(), order.data_ptr(),
        n, upd.data_ptr(), work.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    _check(lib, rc, what)


#: Calls that launched the kernels since the last reset: one a call,
#: though a call is up to two kernel launches (pre-pass, scatter).
scatter_add_rows_f32.launches = 0


def scatter_add_rank1_hbm(table: torch.Tensor, ids: torch.Tensor,
                          coef: torch.Tensor, h: torch.Tensor,
                          hidx: torch.Tensor) -> torch.Tensor:
    """``table[ids] += coef[:, None] * h[hidx]`` in place, without the
    ``(N, d)`` payload: runs of equal ids summed in fp32, one rounding per
    run. ``ids``/``hidx`` ``(N,)`` int32, ``coef`` ``(N,)`` fp32, ``h``
    ``(B, d)`` fp32 contiguous. Each call that reaches the card adds one
    to ``scatter_add_rank1_hbm.launches``, though it is the pre-pass and
    the scatter kernel (see :func:`scatter_add_rank1_hbm_sorted`)."""
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
        return scatter_add_rank1_hbm_reference(table, ids, coef, h, hidx)
    if N:
        scatter_add_rank1_hbm_sorted(table, *sorted_runs(ids), coef, h, hidx)
    return table


def scatter_add_rank1_hbm_sorted(table: torch.Tensor, sorted_ids: torch.Tensor,
                                 order: torch.Tensor, coef: torch.Tensor,
                                 h: torch.Tensor, hidx: torch.Tensor) -> None:
    """The kernel launch of :func:`scatter_add_rank1_hbm` for CUDA tensors
    already validated and sorted by :func:`sorted_runs` (what
    ``chip_smoke.py`` times on its own): the kernels of
    :func:`scatter_add_rows_f32_sorted` with the rank-1 payload, and the
    int32 workspace of their pre-pass taken from the caching allocator."""
    lib = _lib("scatter_runs")
    n = sorted_ids.shape[0]
    work = torch.empty(lib.glint_scatter_add_rows_workspace(n),
                       dtype=torch.int32, device=table.device)
    rc = lib.glint_scatter_add_rank1(
        table.data_ptr(), table.stride(0), table.shape[1],
        _DTYPE_TAGS[table.dtype], sorted_ids.data_ptr(), order.data_ptr(),
        n, coef.data_ptr(), h.data_ptr(), hidx.data_ptr(), h.stride(0),
        work.data_ptr(), torch.cuda.current_stream(table.device).cuda_stream,
    )
    _check(lib, rc, "scatter_add_rank1_hbm")
    scatter_add_rank1_hbm.launches += 1


#: Calls that launched the kernels since the last reset: one a call,
#: though a call is up to two kernel launches (pre-pass, scatter).
scatter_add_rank1_hbm.launches = 0


# ----------------------------------------------------------------------
# The fused pair step
# ----------------------------------------------------------------------


def fused_pair_step(syn0: torch.Tensor, syn1: torch.Tensor,
                    centers: torch.Tensor, contexts: torch.Tensor,
                    pair_mask: torch.Tensor, negs: torch.Tensor,
                    nmask: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """One fused dense-pair SGNS update (per-pair negatives), applied to
    ``syn0`` and ``syn1`` in place. Returns the un-normalised loss sum
    (divide by ``pair_mask.sum()``).

    Order, as in the JAX package (``pallas_sgns.py:749-754``): syn1 first,
    from the materialised pre-update ``h``, then syn0 from ``d_center``.
    Neither scatter reads a table the other has changed, so every value
    the update consumes is the pre-step one."""
    P, n = negs.shape
    fw = pair_forward(syn0, syn1, centers, contexts, pair_mask, negs, nmask, alpha)
    rows = torch.arange(P, dtype=torch.int32, device=centers.device)
    ids1 = torch.cat([contexts, negs.reshape(-1)])
    coefs = torch.cat([fw.c_pos, fw.c_neg.reshape(-1)])
    hidx = torch.cat([rows, rows.repeat_interleave(n)])
    scatter_add_rank1_hbm(syn1, ids1, coefs, fw.h, hidx)
    scatter_add_rows_f32(syn0, centers, fw.d_center)
    return fw.loss_sum


def fused_pair_step_shared(syn0: torch.Tensor, syn1: torch.Tensor,
                           centers: torch.Tensor, contexts: torch.Tensor,
                           pair_mask: torch.Tensor, pool: torch.Tensor,
                           alpha: torch.Tensor,
                           num_negatives: int) -> torch.Tensor:
    """Shared-pool form of :func:`fused_pair_step`, in place; returns the
    un-normalised loss sum. Order, as in the JAX package
    (``pallas_sgns.py:796-812``): the contexts' rank-1 update of syn1
    from ``h``, then the dense ``d_pool`` onto the pool's syn1 rows, then
    ``d_center`` onto syn0. Under bf16 a row that is both a context and a
    pool word is rounded once by each of the two syn1 scatters."""
    P = centers.shape[0]
    fw = pair_forward_shared(
        syn0, syn1, centers, contexts, pair_mask, pool, alpha, num_negatives
    )
    rows = torch.arange(P, dtype=torch.int32, device=centers.device)
    scatter_add_rank1_hbm(syn1, contexts, fw.c_pos, fw.h, rows)
    scatter_add_rows_f32(syn1, pool, fw.d_pool)
    scatter_add_rows_f32(syn0, centers, fw.d_center)
    return fw.loss_sum
