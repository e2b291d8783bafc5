"""Span and event recording for run-wide observability (trimmed copy of
``glint_word2vec_tpu/obs/events.py``).

Instrumentation sites (the fit loops' phases, engine table mutations and
warmup) record spans and instant events into a thread-safe bounded ring
with an optional JSONL sink, and the ring exports as a Chrome-trace
(``chrome://tracing`` / Perfetto) JSON.

Two layers:

- :class:`EventRecorder`, the recorder a run owns (``obs.ObsRun`` wires
  one per instrumented fit);
- the module-level :func:`emit` and :func:`span`, which instrumentation
  sites call unconditionally. With no recorder installed they cost one
  global read, and :func:`span` returns the shared no-op
  :data:`NULL_SPAN`;
- :class:`RequestTrace`, the server's per-request phase-span buffer: a
  request adopts the trace id a client or balancer sends in
  ``X-Glint-Trace`` (or mints one, :func:`mint_trace_id`), buffers its
  phases, and flushes them into the ring only when the tail sampler keeps
  it (always: errors, sheds, slow requests; 1 in ``GLINT_TRACE_SAMPLE``
  otherwise). Phase names come from :data:`REQUEST_SPANS`.
"""

from __future__ import annotations

import atexit
import itertools
import json
import logging
import os
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


class _Span:
    __slots__ = ("_rec", "_name", "_args", "_t0")

    def __init__(self, rec: "EventRecorder", name: str, args: dict):
        self._rec = rec
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
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

    __slots__ = ("_tr", "_name", "_args", "_t0")

    def __init__(self, tr: "RequestTrace", name: str, args: dict):
        self._tr = tr
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
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
        return NULL_SPAN

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
    """Span on the current recorder; :data:`NULL_SPAN` when off."""
    rec = _current
    if rec is None:
        return NULL_SPAN
    return rec.span(name, **args)


def phase_span(name: str, **args):
    """Request-path span recorded straight into the ring, never
    tail-sampled away: the coalescer leader's dispatch uses it, so a kept
    request's trace always shows the batch it rode in. ``name`` is a
    :data:`REQUEST_SPANS` key."""
    rec = _current
    if rec is None:
        return NULL_SPAN
    return rec.span(name, **args)
