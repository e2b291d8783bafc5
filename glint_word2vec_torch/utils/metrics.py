"""Training throughput counters, the step-time ledger, the serving
metrics and the profiler hook (copy of
``glint_word2vec_tpu/utils/metrics.py``): words done, words per second,
the host/step time split, the stall proxy, loss and alpha per step, the
per-phase attribution of the fit thread's wall clock, a server's
per-endpoint latency histograms with the overload, cache, hot-swap and
index counters, and a ``torch.profiler`` capture."""

from __future__ import annotations

import bisect
import contextlib
import logging
import os
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

    def dump(self, path: str) -> None:
        """Write the summary and the retained history as JSON, atomically
        (a temporary file, then ``os.replace``): a crash mid-write never
        leaves a truncated file behind."""
        from glint_word2vec_torch.utils import atomic_write_json

        atomic_write_json(path, {
            "summary": self.summary(),
            "history": list(self.history),
            "history_dropped": self.history_dropped,
        })


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
        #: The gang trace id (one a launch generation, minted by the
        #: supervisor): the snapshot carries it, so the training and gang
        #: step-time families link to the merged gang trace by exemplar.
        self.trace_id: Optional[str] = os.environ.get("GLINT_TRACE_ID")

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
            out = {
                "wall_seconds": round(wall, 4),
                "accounted_seconds": round(accounted, 4),
                "unattributed_seconds": round(gap, 4),
                "phases": phases,
            }
            if self.trace_id:
                out["trace_id"] = self.trace_id
            return out

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
    """Serving-path observability for ``serving.ModelServer``:
    per-endpoint latency histograms (p50/p95/p99), request/error
    counters, the coalesced-batch-size distribution, and the engine's
    query-shape compile counters — surfaced on ``/healthz`` and the
    ``/metrics`` endpoint. Thread-safe (the HTTP server is threaded)."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._hist: Dict[str, LatencyHistogram] = {}
        self._errors: Dict[str, int] = {}
        self._batches: Dict[int, int] = {}
        #: Per-endpoint latency exemplar: the latest KEPT
        #: request trace's id + observed latency, so the Prometheus
        #: exposition can point a dashboard at a trace that actually
        #: exists in the span ring (tail sampling guarantees kept ids).
        self._exemplars: Dict[str, dict] = {}
        #: Optional obs.slo.SloEngine fed by :meth:`observe` (attached
        #: by the server, duck-typed here — utils must not import obs).
        self.slo = None
        #: Engine query-shape compiles at the end of server warmup;
        #: ``snapshot`` reports compiles past this as ``post_warmup``.
        self.warmup_compiles = 0
        self.cache_hits = 0
        self.cache_misses = 0
        # Overload-protection counters: sheds by reason,
        # deadline 504s, degraded-mode entries, in-flight peak.
        self.shed_admission = 0
        self.shed_degraded = 0
        self.deadline_hits = 0
        self.degraded_entered = 0
        self.inflight_peak = 0
        # Hot-swap accounting: table generations flipped
        # into the live engine by the snapshot watcher / /reload.
        self.table_swaps = 0
        self.swap_failures = 0
        #: Transient publish-dir read errors the snapshot watcher
        #: absorbed (backed off and retried instead of marking the
        #: generation failed).
        self.watch_errors = 0
        self.last_swap_time: Optional[float] = None
        #: Name of the generation currently served (None until the
        #: first swap names one — a freshly-loaded model predates the
        #: publish protocol's naming).
        self.generation: Optional[str] = None
        # ANN index accounting: refresh/build telemetry set
        # by the server on every index build (boot + each hot-swap),
        # query-side counters fed by the coalescer's dispatches.
        self.index_enabled = False
        self.index_refreshes = 0
        self.index_stats: dict = {}
        self.index_recall_at10: Optional[float] = None
        self.index_recall_gate_ok: Optional[bool] = None
        self.index_recall_gate: Optional[float] = None
        self.index_nprobe: Optional[int] = None
        self.last_index_refresh_time: Optional[float] = None
        self.ann_queries = 0
        self.ann_probes = 0
        self.exact_fallbacks: Dict[str, int] = {}

    #: Cap on distinct tracked endpoint paths: the key is the raw
    #: client-supplied request path, and without a bound a port scanner
    #: (or a path-building client bug) grows one persistent histogram
    #: per probe for the server's lifetime. Overflow aggregates under
    #: "_other". 64 >> the real endpoint count.
    MAX_PATHS = 64

    def observe(self, path: str, seconds: float, status: int = 200,
                trace_id: Optional[str] = None) -> None:
        with self._mu:
            h = self._hist.get(path)
            if h is None:
                if len(self._hist) >= self.MAX_PATHS:
                    path = "_other"
                    h = self._hist.get(path)
                if h is None:
                    h = self._hist[path] = LatencyHistogram()
            h.record(seconds)
            if status >= 400:
                self._errors[path] = self._errors.get(path, 0) + 1
            if trace_id:
                self._exemplars[path] = {
                    "trace_id": trace_id,
                    "value_ms": round(seconds * 1e3, 3),
                }
        slo = self.slo
        if slo is not None:
            # Outside the metrics lock: the engine has its own (fixed
            # lock order, no nesting).
            slo.observe(path, seconds, status)

    def record_batch(self, size: int) -> None:
        """One coalesced device dispatch of ``size`` queries."""
        with self._mu:
            self._batches[size] = self._batches.get(size, 0) + 1

    def record_cache(self, hit: bool) -> None:
        """One synonym result-cache lookup."""
        with self._mu:
            if hit:
                self.cache_hits += 1
            else:
                self.cache_misses += 1

    def record_shed(self, kind: str) -> None:
        """One shed request: ``"admission"`` (past the in-flight
        high-water mark, 429) or ``"degraded"`` (cache-only mode
        shedding a device-needing request, 429)."""
        with self._mu:
            if kind == "admission":
                self.shed_admission += 1
            else:
                self.shed_degraded += 1

    def record_deadline(self) -> None:
        """One request answered 504: its deadline passed before it
        could reach the device."""
        with self._mu:
            self.deadline_hits += 1

    def record_degraded_entered(self) -> None:
        """One transition INTO degraded cache-only mode."""
        with self._mu:
            self.degraded_entered += 1

    def record_inflight(self, n: int) -> None:
        """Track the admitted in-flight high-water mark."""
        with self._mu:
            if n > self.inflight_peak:
                self.inflight_peak = n

    def record_swap(self, generation: Optional[str] = None,
                    ok: bool = True) -> None:
        """One hot-swap attempt: ``ok`` flips the live generation,
        failure means the previous tables stayed live (staging or
        verification rejected the candidate)."""
        with self._mu:
            if ok:
                self.table_swaps += 1
                self.last_swap_time = time.time()
                if generation is not None:
                    self.generation = generation
            else:
                self.swap_failures += 1

    def record_watch_error(self) -> None:
        """One transient ``LATEST.json``/generation-dir read failure
        the snapshot watcher absorbed: it backed off and will retry on
        a later poll — the pointer was NOT marked failed and the
        watcher thread did not stall."""
        with self._mu:
            self.watch_errors += 1

    def record_index_refresh(self, stats: dict, recall: Optional[float],
                             gate_ok: Optional[bool], gate: float,
                             nprobe: int) -> None:
        """One index build/refresh (boot or hot-swap staging): the
        engine's ``ann_stats()`` dict plus the measured recall@10 of
        the approximate path against the exact path on the same tables
        and the pass/fail of the recall gate."""
        with self._mu:
            self.index_enabled = True
            self.index_refreshes += 1
            self.index_stats = dict(stats)
            self.index_recall_at10 = (
                round(float(recall), 4) if recall is not None else None
            )
            self.index_recall_gate_ok = gate_ok
            self.index_recall_gate = float(gate)
            self.index_nprobe = int(nprobe)
            self.last_index_refresh_time = time.time()

    def record_ann_query(self, n: int, nprobe: int) -> None:
        """``n`` queries answered through the coarse index, each
        probing ``nprobe`` clusters."""
        with self._mu:
            self.ann_queries += int(n)
            self.ann_probes += int(n) * int(nprobe)

    def record_exact_fallback(self, n: int, reason: str) -> None:
        """``n`` queries served by the EXACT path while the index is
        enabled: ``"requested"`` (the per-request ``exact=true`` escape
        hatch) or ``"gate"`` (the recall gate is failing, so the server
        held the approximate path back)."""
        with self._mu:
            self.exact_fallbacks[reason] = (
                self.exact_fallbacks.get(reason, 0) + int(n)
            )

    def snapshot(self, total_compiles: int = 0,
                 checkpoint: Optional[dict] = None,
                 index_staleness: Optional[int] = None) -> dict:
        """``checkpoint`` is the engine's ``checkpoint_stats()`` dict
        (pending_async_saves / last_checkpoint_age_seconds /
        checkpoint_write_seconds); serving a freshly-loaded model reports
        Nones — the keys exist either way so dashboards never branch."""
        slo = self.slo
        slo_snap = slo.snapshot() if slo is not None else None
        with self._mu:
            endpoints = {}
            for path, h in sorted(self._hist.items()):
                endpoints[path] = {
                    "count": h.n,
                    "errors": self._errors.get(path, 0),
                    "p50_ms": round(h.quantile(0.50) * 1e3, 3),
                    "p95_ms": round(h.quantile(0.95) * 1e3, 3),
                    "p99_ms": round(h.quantile(0.99) * 1e3, 3),
                    "mean_ms": round(h.total / max(h.n, 1) * 1e3, 3),
                    "max_ms": round(h.max * 1e3, 3),
                    # Raw histogram state: quantiles cannot be merged,
                    # bucket counts can — the fleet aggregator combines
                    # replica snapshots exactly (obs.aggregate).
                    "hist": h.state(),
                }
                ex = self._exemplars.get(path)
                if ex:
                    endpoints[path]["exemplar"] = dict(ex)
            out = {
                "endpoints": endpoints,
                "coalesced_batch_sizes": {
                    str(k): v for k, v in sorted(self._batches.items())
                },
                "synonym_cache": {
                    "hits": self.cache_hits,
                    "misses": self.cache_misses,
                },
                "overload": {
                    "shed_admission_total": self.shed_admission,
                    "shed_degraded_total": self.shed_degraded,
                    "deadline_504_total": self.deadline_hits,
                    "degraded_entered_total": self.degraded_entered,
                    "inflight_peak": self.inflight_peak,
                },
                "compiles": {
                    "total": int(total_compiles),
                    "warmup": int(self.warmup_compiles),
                    "post_warmup": int(total_compiles)
                    - int(self.warmup_compiles),
                },
                "hot_swap": {
                    "table_swaps_total": self.table_swaps,
                    "swap_failures_total": self.swap_failures,
                    "watch_errors_total": self.watch_errors,
                    "last_swap_age_seconds": (
                        round(time.time() - self.last_swap_time, 2)
                        if self.last_swap_time else None
                    ),
                    "generation": self.generation,
                },
                "checkpoint": {
                    "pending_async_saves": (checkpoint or {}).get(
                        "pending_async_saves", 0
                    ),
                    "last_checkpoint_age_seconds": (checkpoint or {}).get(
                        "last_checkpoint_age_seconds"
                    ),
                    "checkpoint_write_seconds": (checkpoint or {}).get(
                        "checkpoint_write_seconds"
                    ),
                },
                "index": {
                    "enabled": self.index_enabled,
                    "clusters": self.index_stats.get("clusters"),
                    "member_slots": self.index_stats.get("member_slots"),
                    "nprobe": self.index_nprobe,
                    "build_seconds": self.index_stats.get("build_seconds"),
                    "spilled_rows": self.index_stats.get("spilled_rows"),
                    "updated_rows": self.index_stats.get("updated_rows"),
                    "refreshes_total": self.index_refreshes,
                    "last_refresh_age_seconds": (
                        round(time.time() - self.last_index_refresh_time, 2)
                        if self.last_index_refresh_time else None
                    ),
                    "recall_at10": self.index_recall_at10,
                    "recall_gate_ok": self.index_recall_gate_ok,
                    "recall_gate_threshold": self.index_recall_gate,
                    "ann_queries_total": self.ann_queries,
                    "probes_total": self.ann_probes,
                    "probes_per_query": (
                        round(self.ann_probes / self.ann_queries, 2)
                        if self.ann_queries else None
                    ),
                    "exact_fallbacks": dict(self.exact_fallbacks),
                    "table_versions_behind": index_staleness,
                },
            }
            if slo_snap is not None:
                out["slo"] = slo_snap
            return out


@contextlib.contextmanager
def profile_trace(out_dir: Optional[str]):
    """Capture a ``torch.profiler`` trace of the wrapped block into
    ``out_dir`` as a Chrome trace (``trace-<pid>-<ms>.json``, viewable in
    ``chrome://tracing`` or Perfetto); None is a no-op. The card's
    kernels are traced when one is present, the host's ops always."""
    if not out_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            out_dir, f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json"
        ))
