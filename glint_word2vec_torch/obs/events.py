"""Span and event recording for run-wide observability (trimmed copy of
``glint_word2vec_tpu/obs/events.py``).

Instrumentation sites (the fit loops' phases, engine table mutations and
warmup) record spans and instant events into a thread-safe bounded ring
with an optional JSONL sink, and the ring exports as a Chrome-trace
(``chrome://tracing`` / Perfetto) JSON.

Its parts:

- :class:`EventRecorder`, the recorder a run owns (``obs.ObsRun`` wires
  one per instrumented fit);
- the module-level :func:`emit` and :func:`span`, which instrumentation
  sites call unconditionally. With tracing off (no recorder installed,
  the torch profiler not running) they cost two global reads, and
  :func:`span` returns the shared no-op :data:`NULL_SPAN`;
- :func:`stage`, the program's stage spans (:data:`STAGE_SPANS`) inside
  the packed training step and the exact query. With tracing off only
  what a per-layer metric reads on any device is taken, into a
  process-wide stage table (:func:`stage_table`): the host duration of
  the :data:`HOST_STAGES`, and the device interval of a
  :data:`DEVICE_STAGES` stage on a device other than CUDA, which is its
  host duration there; every other stage is :data:`NULL_SPAN`. While
  tracing is on a stage also records into the ring and, while the torch
  profiler runs, a :data:`DEVICE_STAGES` stage on a CUDA device takes
  its device interval with a CUDA event at each edge, resolved at the
  program's next host sync;
- :class:`RequestTrace`, the server's per-request phase-span buffer: a
  request adopts the trace id a client or balancer sends in
  ``X-Glint-Trace`` (or mints one, :func:`mint_trace_id`), buffers its
  phases, and flushes them into the ring only when the tail sampler keeps
  it (always: errors, sheds, slow requests; 1 in ``GLINT_TRACE_SAMPLE``
  otherwise). Phase names come from :data:`REQUEST_SPANS`.

While the torch profiler runs, every span opened here also opens a
``torch.profiler.record_function`` range of the same name, so the
program's spans land in the profiler's trace beside the kernels they
launch, on its clock. The module never imports torch: it reads the
profiler's state only where torch is loaded already (the balancer's
processes never load it).
"""

from __future__ import annotations

import atexit
import itertools
import json
import logging
import os
import sys
import threading
import time
from collections import deque
from typing import Optional

logger = logging.getLogger(__name__)

#: The request-path span vocabulary: every request-tracing site
#: (``RequestTrace.phase``, ``RequestTrace.add_phase``, ``phase_span``)
#: names its span with a key of this dict, so tools that stitch traces
#: can rely on the names.
REQUEST_SPANS = {
    "req.accept": "per-process root span of one request hop "
                  "(balancer or replica handler, accept to response)",
    "req.admission": "admission gate: inflight-slot acquire or shed",
    "req.queue": "coalescer queue wait, enqueue to leader drain",
    "req.hop": "balancer -> replica proxy attempt (one per retry hop)",
    "req.dispatch": "warm-bucket device dispatch of one coalesced batch",
    "req.query": "engine query path (args carry mode=ann|exact)",
    "req.readback": "device result harvest / host materialization",
    "req.serialize": "response serialization + socket write",
}

#: The program's stage spans: every :func:`stage` site names its stage
#: with a key of this dict (an unknown name raises), and the
#: benchmark's per-layer metrics read them from :func:`stage_table`.
STAGE_SPANS = {
    "pack_pairs": "packed training step: the shrink draws, "
                  "pack_window_pairs, the words done and alpha",
    "draw_negatives": "packed training step: the shared pool, or the "
                      "per-pair negatives and their mask",
    "sgns_forward": "fused pair step: pair_forward_shared's launches "
                    "and the loss sum, or pair_forward",
    "sgns_scatter": "fused pair step: the syn1 and syn0 scatters "
                    "(scatter_add_rank1_hbm, scatter_add_rows_f32) with "
                    "their id sorts",
    "readback_wait": "packed group readback: the host's wait for the "
                     "group's copy",
    "topk_scores": "exact top-k: the cosine product of the query block "
                   "with the table",
    "topk_select": "exact top-k: the mask terms, the masked scores and "
                   "topk",
    "topk_readback": "exact top-k batch: the host's wait for the values "
                     "and ids",
    "decode_hits": "synonyms batch: the host decode of a whole block's "
                   "hits into (word, score) pairs",
}

#: Stages whose device interval the stage table keeps: on a CUDA device
#: a CUDA timing event at each edge, taken while the torch profiler runs;
#: on any other device, which runs the work as the host launches it, the
#: stage's host duration, taken always.
DEVICE_STAGES = frozenset({
    "pack_pairs", "draw_negatives", "sgns_forward", "sgns_scatter",
    "topk_scores", "topk_select",
})

#: Stages whose host duration the stage table takes in every call,
#: tracing on or off.
HOST_STAGES = frozenset({"decode_hits"})

#: Device intervals a stage keeps, the first it timed, in order.
_DEVICE_KEEP = 4096

#: Stages that end in a host sync, where pending device intervals are
#: resolved without waiting.
_SYNC_STAGES = frozenset({"readback_wait", "topk_readback"})

#: Wire header carrying the trace id across the balancer -> replica hop.
TRACE_HEADER = "X-Glint-Trace"

#: Tail-sampling knobs: keep 1 in GLINT_TRACE_SAMPLE of the healthy/fast
#: requests; always keep errors (status >= 400, which covers sheds and
#: deadline 504s) and requests slower than GLINT_TRACE_SLOW_MS.
_TRACE_SAMPLE_EVERY = max(
    1, int(os.environ.get("GLINT_TRACE_SAMPLE") or 32)
)
_TRACE_SLOW_MS = float(os.environ.get("GLINT_TRACE_SLOW_MS") or 250.0)

#: Default JSONL sink rotation bound: past it the sink rotates to
#: ``<path>.1`` (one generation kept), so disk stays near twice this.
_SINK_MAX_BYTES = int(
    os.environ.get("GLINT_EVENT_SINK_MAX_BYTES") or 64 * 1024 * 1024
)

_sample_counter = itertools.count()


def mint_trace_id() -> str:
    """A 16-hex-char request trace id, read from the OS entropy pool
    (no seeded generator is disturbed)."""
    return os.urandom(8).hex()


class _NullSpan:
    """Shared no-op context manager returned when recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def update(self, **args) -> None:
        """No-op twin of :meth:`_Span.update`."""


NULL_SPAN = _NullSpan()

#: ``torch.autograd.profiler`` once torch is loaded.
_autograd_profiler = None


def _profiling() -> bool:
    """Whether the torch profiler is running in this process, read
    without importing torch."""
    global _autograd_profiler
    prof = _autograd_profiler
    if prof is None:
        prof = sys.modules.get("torch.autograd.profiler")
        if prof is None:
            return False
        _autograd_profiler = prof
    return prof._is_profiler_enabled


def _open_range(name: str):
    """An entered ``record_function`` range while the profiler runs,
    else None."""
    if not _profiling():
        return None
    rf = _autograd_profiler.record_function(name)
    rf.__enter__()
    return rf


class _Range:
    """A span with no recorder installed: the profiler's range alone."""

    __slots__ = ("_name", "_rf")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        self._rf = _open_range(self._name)
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False

    def update(self, **args) -> None:
        """No-op twin of :meth:`_Span.update`."""


def mirror(name: str):
    """The profiler's range named ``name`` while it runs, else
    :data:`NULL_SPAN`: a span site with no recorder to record into."""
    return _Range(name) if _profiling() else NULL_SPAN


class _Span:
    __slots__ = ("_rec", "_name", "_args", "_t0", "_rf")

    def __init__(self, rec: "EventRecorder", name: str, args: dict):
        self._rec = rec
        self._name = name
        self._args = args

    def __enter__(self):
        self._rf = _open_range(self._name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self._rec._record(self._name, "X", self._t0, t1 - self._t0, self._args)
        return False

    def update(self, **args) -> None:
        """Amend the span's attributes before it closes (values known
        only mid-span, such as a harvested group's live step count)."""
        self._args.update(args)


class _Phase:
    """Context manager buffering one request phase span into its
    :class:`RequestTrace` (not the ring — the tail sampler decides at
    ``finish`` whether the buffered spans are flushed at all)."""

    __slots__ = ("_tr", "_name", "_args", "_t0", "_rf")

    def __init__(self, tr: "RequestTrace", name: str, args: dict):
        self._tr = tr
        self._name = name
        self._args = args

    def __enter__(self):
        self._rf = _open_range(self._name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self._tr._spans.append(
            (self._name, self._t0, t1 - self._t0, self._args)
        )
        return False

    def update(self, **args) -> None:
        self._args.update(args)


class NullRequestTrace:
    """Trace-id-carrying no-op returned when no recorder is installed:
    the id still propagates over the wire (a downstream hop may be
    recording even when this one is not), but nothing is buffered."""

    __slots__ = ("trace_id", "kept")

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.kept = False

    def phase(self, name: str, **args):
        return mirror(name)

    def add_phase(self, name: str, t0: float, dur: float, **args) -> None:
        pass

    def finish(self, status: int = 200, *, force: bool = False) -> bool:
        return False


#: Shared stateless no-op trace for call sites whose caller passed no
#: trace at all (direct library use of the coalescer, tests).
NULL_TRACE = NullRequestTrace("")


class RequestTrace:
    """Per-request phase-span buffer with tail-based sampling.

    One hop's handler owns one instance (single-writer; cross-thread
    phases — the coalescer leader's queue/dispatch timestamps — are
    converted by the OWNING handler thread via :meth:`add_phase`).
    ``finish(status)`` applies the tail-sampling policy: errors/sheds
    (status >= 400), slow requests, and ``force`` are always kept;
    everything else is kept 1 in ``GLINT_TRACE_SAMPLE``. Kept spans are
    flushed into the recorder ring/sink with the trace id attached, so
    hops of one request can be stitched across processes by id.
    """

    __slots__ = ("trace_id", "_rec", "_spans", "_t0", "kept")

    def __init__(self, trace_id: str, rec: "EventRecorder"):
        self.trace_id = trace_id
        self._rec = rec
        self._spans: list = []
        self._t0 = time.perf_counter()
        self.kept = False

    def phase(self, name: str, **args) -> _Phase:
        """Context manager buffering one registry-named phase span."""
        return _Phase(self, name, args)

    def add_phase(self, name: str, t0: float, dur: float, **args) -> None:
        """Buffer a phase from externally captured timestamps (the
        coalescer leader stamps perf_counter() pairs into the request
        dict; the waiter thread converts them here)."""
        self._spans.append((name, t0, dur, args))

    def finish(self, status: int = 200, *, force: bool = False) -> bool:
        """Apply tail sampling; flush buffered spans if kept. Returns
        whether the trace was kept (the caller can use that to attach
        an exemplar only for traces that actually exist in the ring)."""
        spans, self._spans = self._spans, []
        if not spans:
            return False
        slow = (time.perf_counter() - self._t0) * 1e3 >= _TRACE_SLOW_MS
        keep = (
            force or slow or int(status) >= 400
            or next(_sample_counter) % _TRACE_SAMPLE_EVERY == 0
        )
        if not keep:
            return False
        # The root span (req.accept closes last, so it is the final
        # buffered entry) carries the response status.
        spans[-1][3].setdefault("status", int(status))
        for name, t0, dur, args in spans:
            a = dict(args)
            a["trace"] = self.trace_id
            self._rec._record(name, "X", t0, dur, a)
        self.kept = True
        return True


def request_trace(trace_id: Optional[str] = None, rec=None):
    """Start one hop's request trace: adopts the propagated trace id (or
    mints one at the edge) and binds the process recorder. With no
    recorder installed this degrades to a :class:`NullRequestTrace` that
    still carries the id for onward propagation."""
    if rec is None:
        rec = _current
    tid = trace_id or mint_trace_id()
    if rec is None:
        return NullRequestTrace(tid)
    return RequestTrace(tid, rec)


class EventRecorder:
    """Thread-safe span/event log: the newest ``capacity`` events in a
    bounded ring (overflow counted in ``dropped``) plus an optional JSONL
    sink that receives every event.

    Timestamps (``ts``, microseconds) run on a monotonic clock anchored
    at construction; the sink's first line, a ``clock_anchor`` metadata
    event, maps them back to the epoch. Spans are Chrome-trace complete
    events (``ph: "X"`` with ``dur``), instants ``ph: "i"``: each JSONL
    line is a valid ``traceEvents`` entry. The sink rotates past
    ``max_sink_bytes``, and an ``atexit`` flush leaves complete lines
    behind a recorder that was never closed."""

    def __init__(self, capacity: int = 65536,
                 jsonl_path: Optional[str] = None,
                 max_sink_bytes: Optional[int] = None):
        self._mu = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self.recorded = 0
        self.dropped = 0
        self.jsonl_path = jsonl_path
        self.max_sink_bytes = int(
            max_sink_bytes if max_sink_bytes is not None else _SINK_MAX_BYTES
        )
        self.sink_rotations = 0
        self._sink_bytes = 0
        self.wall_t0 = time.time()
        self._t0 = time.perf_counter()
        # graftlint: ignore[atomic-persist] streaming JSONL sink, not an artifact: a crash leaves a valid line prefix that trace-merge accepts
        self._sink = open(jsonl_path, "w") if jsonl_path else None
        if self._sink is not None:
            self._write_anchor_locked()
            atexit.register(self.flush)

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    @property
    def mono_t0(self) -> float:
        """Monotonic half of the clock-anchor pair (``ts`` zero)."""
        return self._t0

    def _anchor_args(self) -> dict:
        args = {"wall_t0": self.wall_t0, "mono_t0": self._t0}
        # The supervisor mints one gang trace id a launch generation
        # (``GLINT_TRACE_ID``): it stitches this process's timeline to
        # its gang's in trace-merge.
        gang = os.environ.get("GLINT_TRACE_ID")
        if gang:
            args["trace"] = gang
        return args

    def _write_anchor_locked(self) -> None:
        """The clock-anchor metadata line: the (monotonic, wall) pair of
        this recorder's ``ts = 0``."""
        try:
            line = json.dumps({
                "name": "clock_anchor", "ph": "M", "ts": 0,
                "pid": os.getpid(),
                "args": self._anchor_args(),
            }) + "\n"
            self._sink.write(line)
            self._sink_bytes += len(line)
        except OSError as e:
            self._drop_sink_locked(e)

    def _rotate_sink_locked(self) -> None:
        try:
            self._sink.flush()
            self._sink.close()
            os.replace(self.jsonl_path, self.jsonl_path + ".1")
            self._sink = open(self.jsonl_path, "w")
        except OSError as e:
            self._drop_sink_locked(e)
            return
        self._sink_bytes = 0
        self.sink_rotations += 1
        self._write_anchor_locked()

    def _record(self, name: str, ph: str, t0: float, dur: float,
                args: dict) -> None:
        ev = {
            "name": name,
            "ph": ph,
            "ts": round((t0 - self._t0) * 1e6, 1),
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if ph == "X":
            ev["dur"] = round(dur * 1e6, 1)
        else:
            ev["s"] = "t"  # instant scope: this thread
        if args:
            ev["args"] = args
        with self._mu:
            self.recorded += 1
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(ev)
            if self._sink is not None:
                try:
                    line = json.dumps(ev) + "\n"
                    self._sink.write(line)
                    self._sink_bytes += len(line)
                except OSError as e:
                    # A dying sink degrades to ring-only recording; it
                    # never takes the run down.
                    self._drop_sink_locked(e)
                    return
                if self._sink_bytes >= self.max_sink_bytes:
                    self._rotate_sink_locked()

    def event(self, name: str, **args) -> None:
        """Record one instant event."""
        self._record(name, "i", time.perf_counter(), 0.0, args)

    def span(self, name: str, **args) -> _Span:
        """Context manager recording one complete ("X") span on exit."""
        return _Span(self, name, args)

    def events(self) -> list:
        """Snapshot of the ring, oldest first."""
        with self._mu:
            return list(self._ring)

    def recent_events(self, seconds: float) -> list:
        """Ring events that started within the last ``seconds`` (the
        ``/trace`` scrape and the flight recorder's bundle window)."""
        cutoff = (time.perf_counter() - self._t0 - seconds) * 1e6
        with self._mu:
            return [e for e in self._ring if e.get("ts", 0.0) >= cutoff]

    def counts(self) -> dict:
        with self._mu:
            return {
                "recorded": self.recorded,
                "dropped": self.dropped,
                "capacity": self._ring.maxlen,
            }

    def chrome_trace(self) -> dict:
        """The ring as a ``chrome://tracing`` / Perfetto JSON document."""
        events = self.events()
        with self._mu:
            dropped = self.dropped
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "wall_t0": self.wall_t0,
                "mono_t0": self._t0,
                "dropped": dropped,
            },
        }

    def export_chrome_trace(self, path: str) -> None:
        from glint_word2vec_torch.utils import atomic_write_json

        atomic_write_json(path, self.chrome_trace())

    def _drop_sink_locked(self, err) -> None:
        logger.warning(
            "event-log sink %s failed, continuing ring-only: %s",
            self.jsonl_path, err,
        )
        sink, self._sink = self._sink, None
        try:
            sink.close()
        except OSError:
            pass

    def flush(self) -> None:
        with self._mu:
            if self._sink is not None:
                try:
                    self._sink.flush()
                except OSError as e:
                    self._drop_sink_locked(e)

    def close(self) -> None:
        with self._mu:
            if self._sink is not None:
                try:
                    self._sink.flush()
                    self._sink.close()
                except OSError as e:
                    logger.warning("event-log sink %s failed at close: %s",
                                   self.jsonl_path, e)
                self._sink = None
                atexit.unregister(self.flush)


# The process-wide recorder engine-level sites emit through.
_current: Optional[EventRecorder] = None


def set_recorder(rec: Optional[EventRecorder]) -> Optional[EventRecorder]:
    """Install the process-wide recorder (None disables); returns it."""
    global _current
    _current = rec
    return rec


def get_recorder() -> Optional[EventRecorder]:
    return _current


def emit(name: str, **args) -> None:
    """Instant event on the current recorder; a no-op when off."""
    rec = _current
    if rec is not None:
        rec.event(name, **args)


def span(name: str, **args):
    """Span on the current recorder; the profiler's range alone with no
    recorder; :data:`NULL_SPAN` when tracing is off."""
    rec = _current
    if rec is None:
        return mirror(name)
    return rec.span(name, **args)


def phase_span(name: str, **args):
    """Request-path span recorded straight into the ring, never
    tail-sampled away: the coalescer leader's dispatch uses it, so a kept
    request's trace always shows the batch it rode in. ``name`` is a
    :data:`REQUEST_SPANS` key."""
    rec = _current
    if rec is None:
        return mirror(name)
    return rec.span(name, **args)


# ----------------------------------------------------------------------
# Stage spans
# ----------------------------------------------------------------------


class _StageStat:
    """One stage's totals: its host durations, and the number of its
    device intervals with the first :data:`_DEVICE_KEEP` of them."""

    __slots__ = ("host_n", "host_s", "device_n", "device")

    def __init__(self):
        self.host_n = 0
        self.host_s = 0.0
        self.device_n = 0
        self.device = []

    def add_host(self, seconds: float) -> None:
        with _stage_mu:
            self.host_n += 1
            self.host_s += seconds

    def add_device(self, seconds: float) -> None:
        with _stage_mu:
            self.device_n += 1
            if len(self.device) < _DEVICE_KEEP:
                self.device.append(seconds)


_stages = {name: _StageStat() for name in STAGE_SPANS}
_stage_mu = threading.Lock()
#: (stat, start event, end event) of device intervals not yet resolved,
#: oldest first; one resolver at a time takes them off.
_pending: deque = deque()
_resolve_mu = threading.Lock()


def _cuda_mark(device):
    """A timing event recorded on ``device``'s current stream."""
    cuda = sys.modules["torch"].cuda
    ev = cuda.Event(enable_timing=True)
    ev.record(cuda.current_stream(device))
    return ev


class _Stage:
    """One stage span: the profiler's range, the ring's span, and what
    the stage table takes of it (``take``: a host duration; ``cuda``:
    the device of its two events)."""

    __slots__ = ("_name", "_stat", "_rec", "_take", "_cuda", "_t0", "_rf",
                 "_ev0")

    def __init__(self, name, stat, rec, take, cuda):
        self._name = name
        self._stat = stat
        self._rec = rec
        self._take = take
        self._cuda = cuda

    def __enter__(self):
        self._rf = _open_range(self._name)
        self._ev0 = _cuda_mark(self._cuda) if self._cuda is not None else None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._ev0 is not None:
            _pending.append((self._stat, self._ev0, _cuda_mark(self._cuda)))
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if self._take is not None:
            self._take(t1 - self._t0)
        if self._rec is not None:
            self._rec._record(self._name, "X", self._t0, t1 - self._t0, {})
        if self._name in _SYNC_STAGES and _pending:
            _resolve(wait=False)
        return False


def stage(name: str, device=None):
    """Context manager around one stage of the program, ``name`` a
    :data:`STAGE_SPANS` key and ``device`` the one its work runs on.

    Into the stage table go, always, the host duration of a
    :data:`HOST_STAGES` stage and, on a device other than CUDA, the
    host duration of a :data:`DEVICE_STAGES` stage as its device
    interval. A recorder installed adds the ring's span. The torch
    profiler running adds the profiler's range and, for a
    :data:`DEVICE_STAGES` stage on a CUDA device, a timing event on the
    current stream at each edge. With none of these,
    :data:`NULL_SPAN`."""
    stat = _stages[name]
    rec = _current
    prof = _profiling()
    take = cuda = None
    if name in HOST_STAGES:
        take = stat.add_host
    elif device is not None and name in DEVICE_STAGES:
        if device.type != "cuda":
            take = stat.add_device
        elif prof:
            cuda = device
    if rec is None and not prof and take is None:
        return NULL_SPAN
    return _Stage(name, stat, rec, take, cuda)


def _resolve(wait: bool) -> None:
    """Add the pending device intervals to their stages, oldest first:
    up to the first whose end has not run yet, or, with ``wait``, all of
    them."""
    with _resolve_mu:
        while _pending:
            stat, ev0, ev1 = _pending[0]
            if not ev1.query():
                if not wait:
                    return
                ev1.synchronize()
            _pending.popleft()
            stat.add_device(ev0.elapsed_time(ev1) / 1e3)


def stage_table() -> dict:
    """The process's stage table, every pending device interval resolved
    first (a wait on the device): ``{name: {"host_count", "host_s",
    "device_count", "device_s"}}``, ``device_s`` the first
    :data:`_DEVICE_KEEP` device intervals in seconds, in the order they
    were timed."""
    _resolve(wait=True)
    with _stage_mu:
        return {
            name: {"host_count": st.host_n, "host_s": st.host_s,
                   "device_count": st.device_n, "device_s": list(st.device)}
            for name, st in _stages.items()
        }
