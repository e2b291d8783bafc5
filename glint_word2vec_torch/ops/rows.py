"""Row gather: the port of ``glint_word2vec_tpu/ops/pallas_rows.py::gather_rows``.

:func:`gather_rows` returns ``table[ids]`` upcast to fp32, which is what
the JAX engine's ``_pull_rows`` consumes (``gather_rows(...).astype(f32)``).
For a CUDA tensor it launches the hand-written kernel of
``csrc/gather_rows.cu`` on the current stream, or raises; for a CPU tensor
it runs :func:`gather_rows_reference`, the plain PyTorch version the tests
and ``chip_smoke.py`` hold the kernel against.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPE_TAGS = {torch.float32: 0, torch.bfloat16: 1}
_bound = None


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
