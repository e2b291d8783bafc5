"""Multi-process helpers of the port (counterpart of
``glint_word2vec_tpu/parallel/distributed.py``). It holds only
:func:`shard_span` (``distributed.py:243-268``), the bulk transform's input
split; the process-group set-up and the corpus sharding of training come
with the port's multi-process slice."""

from __future__ import annotations

from typing import Tuple


def shard_span(
    n_items: int, process_index: int, process_count: int
) -> Tuple[int, int]:
    """Contiguous, balanced ``[start, end)`` span for one rank over
    ``n_items``: every item is covered exactly once, the first
    ``n_items % process_count`` ranks take one extra. A pure function of
    its three arguments, so every rank and every resume derives the same
    split with no coordination."""
    if process_count < 1:
        raise ValueError("process_count must be >= 1")
    if not 0 <= process_index < process_count:
        raise ValueError(
            f"process_index {process_index} out of range for "
            f"{process_count} processes"
        )
    if n_items < 0:
        raise ValueError("n_items must be >= 0")
    q, r = divmod(n_items, process_count)
    start = process_index * q + min(process_index, r)
    return start, start + q + (1 if process_index < r else 0)
