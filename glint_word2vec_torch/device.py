"""Device choice for the port (counterpart of ``glint_word2vec_tpu/utils/platform.py``).

Every entry point of the port runs on the CUDA card unless the caller
asks for the CPU with ``device="cpu"``. There is no silent fallback: with
no device named and no card present, :func:`resolve_device` raises.
"""

from __future__ import annotations

from typing import Union

import torch

# Cosine ranking at d=300 separates neighbours whose scores differ in the
# fourth decimal, and TF32 keeps only about three. The JAX reference
# computes the query products in full fp32, so the port does too: no TF32
# in matrix products or convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``None`` means the current CUDA card and raises when there is none;
    ``"cpu"`` (what the CPU tests pass) and ``"cuda[:n]"`` are taken as
    asked, and a CUDA device asked for without a card raises too."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asked for, but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def device_name(device: torch.device) -> str:
    """Human-readable name of ``device`` for health and result records."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
