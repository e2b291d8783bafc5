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
  :data:`NULL_SPAN`.

The serving data plane's request traces are not ported yet.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Optional

logger = logging.getLogger(__name__)

#: Default JSONL sink rotation bound: past it the sink rotates to
#: ``<path>.1`` (one generation kept), so disk stays near twice this.
_SINK_MAX_BYTES = int(
    os.environ.get("GLINT_EVENT_SINK_MAX_BYTES") or 64 * 1024 * 1024
)


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
        self._sink = open(jsonl_path, "w") if jsonl_path else None
        if self._sink is not None:
            self._write_anchor_locked()
            atexit.register(self.flush)

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    def _write_anchor_locked(self) -> None:
        """The clock-anchor metadata line: the (monotonic, wall) pair of
        this recorder's ``ts = 0``."""
        try:
            line = json.dumps({
                "name": "clock_anchor", "ph": "M", "ts": 0,
                "pid": os.getpid(),
                "args": {"wall_t0": self.wall_t0, "mono_t0": self._t0},
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
