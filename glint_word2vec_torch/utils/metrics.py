"""Training throughput counters, the step-time ledger and the serving
swap counters (trimmed copy of ``glint_word2vec_tpu/utils/metrics.py:27-527``):
words done, words per second, the host/step time split, the stall proxy,
loss and alpha per step, the per-phase attribution of the fit thread's
wall clock, and the hot-swap accounting of a server."""

from __future__ import annotations

import bisect
import contextlib
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)


@dataclass
class TrainingMetrics:
    """Accumulates per-run training statistics; cheap enough for every step."""

    log_every: int = 200
    #: Global words_done at construction (nonzero after a checkpoint
    #: resume); rates count only words processed by this invocation.
    base_words: int = 0
    steps: int = 0
    words_done: int = 0
    host_time: float = 0.0  # seconds spent preparing work on the host
    step_time: float = 0.0  # seconds spent dispatching and reading back steps
    #: Seconds the dispatch loop stood still: checkpoint saves (the
    #: snapshot copy alone when they are asynchronous), waits for the
    #: batch producer and the epoch-boundary compaction readback. An
    #: upper bound on the card's idle time, whose direction is exact.
    stall_time: float = 0.0
    last_loss: Optional[float] = None
    last_alpha: Optional[float] = None
    _t_start: float = field(default_factory=time.time)
    _t_window: float = field(default_factory=time.time)
    _words_window: int = -1
    history: List[dict] = field(default_factory=list)
    #: Bound on retained history entries (one lands every ``log_every``
    #: steps); the oldest drop first and ``history_dropped`` counts them.
    history_max: int = 4096
    history_dropped: int = 0

    def __post_init__(self) -> None:
        self.words_done = self.base_words
        self._words_window = self.base_words
        self.history = deque(self.history, maxlen=max(1, self.history_max))

    def record_step(self, words_done: int, loss: Optional[float] = None,
                    alpha: Optional[float] = None) -> None:
        """One finished step. ``loss`` and ``alpha`` are host floats: the
        training loop reads a group's values back in one transfer."""
        self.steps += 1
        self.words_done = words_done
        if loss is not None:
            self.last_loss = float(loss)
        if alpha is not None:
            self.last_alpha = float(alpha)
        if self.steps % self.log_every == 0:
            now = time.time()
            wps = (words_done - self._words_window) / max(now - self._t_window, 1e-9)
            entry = {
                "step": self.steps,
                "words_done": words_done,
                "words_per_sec": round(wps, 1),
                "alpha": self.last_alpha,
                "loss": self.last_loss,
                "host_frac": round(
                    self.host_time / max(self.host_time + self.step_time, 1e-9), 3
                ),
            }
            if len(self.history) == self.history.maxlen:
                self.history_dropped += 1
            self.history.append(entry)
            logger.info(
                "step %d: %.0f words/s alpha=%s loss=%s host_frac=%s",
                self.steps, wps, self.last_alpha, self.last_loss,
                entry["host_frac"],
            )
            self._t_window, self._words_window = now, words_done

    @contextlib.contextmanager
    def timing(self, kind: str):
        """Charge the wrapped block to ``host_time`` (``kind="host"``) or
        to ``step_time`` (anything else)."""
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            if kind == "host":
                self.host_time += dt
            else:
                self.step_time += dt

    def record_stall(self, seconds: float) -> None:
        self.stall_time += seconds

    @contextlib.contextmanager
    def stall_timing(self):
        """Charge the wrapped block to ``stall_time`` (composable with
        :meth:`timing`; the buckets are independent)."""
        t0 = time.time()
        try:
            yield
        finally:
            self.record_stall(time.time() - t0)

    def summary(self) -> dict:
        wall = max(time.time() - self._t_start, 1e-9)
        return {
            "steps": self.steps,
            "words_done": self.words_done,
            "wall_seconds": round(wall, 2),
            "words_per_sec": round((self.words_done - self.base_words) / wall, 1),
            "host_time": round(self.host_time, 2),
            "step_time": round(self.step_time, 2),
            "device_stall_seconds": round(self.stall_time, 3),
            "final_loss": self.last_loss,
            "final_alpha": self.last_alpha,
        }


class LatencyHistogram:
    """Fixed log-spaced latency histogram: O(1) memory, quantiles by
    linear interpolation inside the winning bucket. Edges run 50 us to
    about 20 min with a sqrt(2) growth factor."""

    _EDGES = [5e-5 * (2 ** (i / 2.0)) for i in range(64)]

    __slots__ = ("counts", "n", "total", "max")

    def __init__(self) -> None:
        self.counts = [0] * (len(self._EDGES) + 1)
        self.n = 0
        self.total = 0.0
        self.max = 0.0

    def record(self, seconds: float) -> None:
        self.counts[bisect.bisect_right(self._EDGES, seconds)] += 1
        self.n += 1
        self.total += seconds
        if seconds > self.max:
            self.max = seconds

    def quantile(self, q: float) -> float:
        if self.n == 0:
            return 0.0
        target = q * self.n
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if c and acc >= target:
                lo = self._EDGES[i - 1] if i > 0 else 0.0
                hi = self._EDGES[i] if i < len(self._EDGES) else self.max
                hi = min(max(hi, lo), self.max) if self.max else hi
                return lo + (hi - lo) * ((target - (acc - c)) / c)
        return self.max

    def state(self) -> dict:
        """JSON-serializable snapshot (sparse bucket counts)."""
        return {
            "counts": {str(i): c for i, c in enumerate(self.counts) if c},
            "n": self.n,
            "total": self.total,
            "max": self.max,
        }

    @classmethod
    def from_state(cls, state: dict) -> "LatencyHistogram":
        """Rebuild a histogram from :meth:`state`."""
        h = cls()
        for i, c in (state.get("counts") or {}).items():
            h.counts[int(i)] = int(c)
        h.n = int(state.get("n", 0))
        h.total = float(state.get("total", 0.0))
        h.max = float(state.get("max", 0.0))
        return h

    @classmethod
    def merge(cls, hists) -> "LatencyHistogram":
        """Merge histograms (objects or :meth:`state` dicts) into a new
        one, bucket for bucket: what the gang aggregate does to the ranks'
        step-time ledgers."""
        out = cls()
        for h in hists:
            if isinstance(h, dict):
                h = cls.from_state(h)
            for i, c in enumerate(h.counts):
                out.counts[i] += c
            out.n += h.n
            out.total += h.total
            out.max = max(out.max, h.max)
        return out


#: The step-time ledger's named phases (the JAX package's):
#:   dispatch          - device train-step dispatch calls
#:   readback_harvest  - reading a dispatched group's results back
#:   producer_wait     - waiting on the host batch producer
#:   compact           - subsample-compact passes (and their prefetch)
#:   checkpoint        - snapshot copies, blocking saves, restores
#:   other             - the corpus upload plus the wall-clock gap no
#:                       span covered
LEDGER_PHASES = (
    "dispatch", "readback_harvest", "producer_wait", "compact",
    "checkpoint", "other",
)


class StepTimeLedger:
    """Step-time attribution for one fit: every accounted span charges
    its wall time to a named phase, so the phases say where the fit
    thread's wall clock went. Fed by ``obs.ObsRun.span``; only the fit
    thread accounts (the checkpoint writer's spans bypass the ledger), so
    the phase totals sum to the wall clock. Per phase: total seconds,
    span count and a :class:`LatencyHistogram` of span durations."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._t0 = time.time()
        self._t_end: Optional[float] = None
        self._seconds = {p: 0.0 for p in LEDGER_PHASES}
        self._counts = {p: 0 for p in LEDGER_PHASES}
        self._hists = {p: LatencyHistogram() for p in LEDGER_PHASES}

    def account(self, phase: str, seconds: float) -> None:
        with self._mu:
            self._seconds[phase] += seconds
            self._counts[phase] += 1
            self._hists[phase].record(seconds)

    def finalize(self) -> None:
        """Freeze the wall clock at run end (first call wins)."""
        with self._mu:
            if self._t_end is None:
                self._t_end = time.time()

    def wall_seconds(self) -> float:
        with self._mu:
            return (self._t_end or time.time()) - self._t0

    def totals(self) -> Dict[str, float]:
        """{phase: seconds}, the unattributed gap folded into ``other``:
        the phases sum to the ledger's wall clock."""
        snap = self.snapshot(include_hists=False)
        return {p: info["seconds"] for p, info in snap["phases"].items()}

    def snapshot(self, include_hists: bool = True) -> dict:
        """Wall, per-phase seconds and count (with the histogram state),
        and the unattributed gap, which ``other`` includes."""
        with self._mu:
            wall = (self._t_end or time.time()) - self._t0
            accounted = sum(self._seconds.values())
            gap = max(0.0, wall - accounted)
            phases = {}
            for p in LEDGER_PHASES:
                info = {
                    "seconds": round(
                        self._seconds[p] + (gap if p == "other" else 0.0), 4
                    ),
                    "count": self._counts[p],
                }
                if include_hists:
                    info["hist"] = self._hists[p].state()
                phases[p] = info
            return {
                "wall_seconds": round(wall, 4),
                "accounted_seconds": round(accounted, 4),
                "unattributed_seconds": round(gap, 4),
                "phases": phases,
            }

    def dump(self, path: str) -> None:
        """Write the per-run STEPTIME.json (atomic): the phase breakdown
        plus each phase's span-duration quantiles."""
        from glint_word2vec_torch.utils import atomic_write_json

        snap = self.snapshot(include_hists=False)
        with self._mu:
            for p in LEDGER_PHASES:
                h = self._hists[p]
                snap["phases"][p].update(
                    p50_ms=round(h.quantile(0.50) * 1e3, 3),
                    p95_ms=round(h.quantile(0.95) * 1e3, 3),
                    p99_ms=round(h.quantile(0.99) * 1e3, 3),
                )
        snap["schema_version"] = 1
        atomic_write_json(path, snap)


class ServingMetrics:
    """A server's hot-swap accounting (``ServingMetrics`` of the JAX
    package, trimmed to ``record_swap`` and ``record_watch_error``):
    generations flipped into the live engine by the snapshot watcher or
    ``/reload``, failed attempts, and the transient publish-directory read
    errors the watcher absorbed. Thread-safe."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self.table_swaps = 0
        self.swap_failures = 0
        #: Transient publish-dir read errors the watcher backed off from
        #: instead of marking the generation failed.
        self.watch_errors = 0
        self.last_swap_time: Optional[float] = None
        #: Name of the generation served (None until one is named).
        self.generation: Optional[str] = None

    def record_swap(self, generation: Optional[str] = None,
                    ok: bool = True) -> None:
        """One hot-swap attempt: ``ok`` flips the live generation; a
        failure leaves the previous tables live."""
        with self._mu:
            if ok:
                self.table_swaps += 1
                self.last_swap_time = time.time()
                if generation is not None:
                    self.generation = generation
            else:
                self.swap_failures += 1

    def record_watch_error(self) -> None:
        """One transient ``LATEST.json`` or generation-directory read
        failure that the watcher backed off from and will retry."""
        with self._mu:
            self.watch_errors += 1
