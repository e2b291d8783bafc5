"""Frozen counts of logical work and the card's peaks.

Each function counts what the algorithm needs for its inputs, whatever
kernels perform it. A roofline share is the least time of that work (the
larger of its bytes over the memory's peak rate and its operations over
the arithmetic peak) over the device time it took, so it cannot pass 100 %
unless the work is counted too high or the time leaves part of it out.
"""

from __future__ import annotations

import math
from typing import Sequence

#: NVIDIA H100 SXM, dense, from NVIDIA's data sheet at the 700 W limit.
#: TF32 is the fastest rate that keeps fp32 accuracy (three TF32 passes
#: make one fp32 product), so no fp32 step can beat it.
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def sgns_flops(pairs: int, rows_per_pair: int, dim: int) -> float:
    """Model FLOPs of ``pairs`` skip-gram pairs each scored against
    ``rows_per_pair`` rows (1 + n per-pair negatives, or 1 + S with a pool
    shared by every pair): 2d for the logit, 4d for the two gradients."""
    return 6.0 * dim * rows_per_pair * pairs


def group_bytes(rows0: int, rows1: int, dim: int, positions: int,
                table_bytes: int = 4) -> float:
    """Bytes a group of steps needs at the least: each distinct table row
    it touches read once and written once, and the corpus ids (int32) of
    the positions it consumes."""
    return 2.0 * (rows0 + rows1) * dim * table_bytes + 4.0 * positions


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def topk_flops(queries: int, dim: int, rows: int) -> float:
    """The cosine scores of a query block against the table: 2 Q d V."""
    return 2.0 * queries * dim * rows


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile by the nearest rank: the smallest value with
    at least ``q`` percent of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def median(values: Sequence[float]) -> float:
    xs = sorted(values)
    n = len(xs)
    if not n:
        raise ValueError("no values")
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])
