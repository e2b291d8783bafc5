"""The program's stage table (``glint_word2vec_torch.obs.events``
``stage_table``), as the stage metrics read it.

The table holds the whole process, which runs one cell. A stage's device
intervals on the card are CUDA timing events the program records at the
stage's edges, only while the torch profiler runs. In a ``--trace 1`` run
the first the profiler times are those of ``perfbench/trace.py``'s first
pass, which profiles the device alone; the record's ``profiled_steps`` or
``profiled_calls`` counts that pass's units, so the metrics read that many
intervals of each stage and leave out the second pass, whose profile of
the host's operators slows the host. An interval is the stage's time on
the stream from its first event to its last: where the host launches the
stage's work slower than the card runs it, it holds the card's waits for
those launches. On the CPU a stage's device interval is its host duration,
taken in every step or call from the process's first.
A program without the table gives nothing to read.
"""

from __future__ import annotations

from typing import Optional, Sequence


def table() -> Optional[dict]:
    from glint_word2vec_torch.obs import events

    snapshot = getattr(events, "stage_table", None)
    return snapshot() if snapshot is not None else None


def device_ms(names: Sequence[str], n: Optional[int]) -> Optional[float]:
    """Device milliseconds a step or a call spends in the stages
    ``names``: the first ``n`` device intervals of each, summed, over
    ``n``; None where fewer were timed."""
    t = table()
    if not t or not n:
        return None
    first = [t[name]["device_s"][:n] for name in names]
    if any(len(f) < n for f in first):
        return None
    return 1e3 * sum(map(sum, first)) / n


def host_mean_ms(name: str) -> Optional[float]:
    """The mean host milliseconds of stage ``name`` over every time it
    ran, or None where it never ran."""
    t = table()
    if not t or not t[name]["host_count"]:
        return None
    return 1e3 * t[name]["host_s"] / t[name]["host_count"]
