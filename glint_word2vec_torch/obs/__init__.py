"""Run-wide observability of a fit (trimmed copy of
``glint_word2vec_tpu/obs/__init__.py``). All of it is opt-in:

- the span event log (:mod:`obs.events`): a bounded ring and JSONL sink
  over the fit loops' phases (upload, subsample-compact and its
  prefetch, host batches, device dispatch, readback harvest, checkpoint
  snapshot, write and restore) and engine events (table mutations,
  warmup), exportable as a Chrome trace;
- the live heartbeat (:mod:`obs.heartbeat`): ``/healthz`` and
  ``/metrics`` (JSON and Prometheus) on the training process, and an
  atomic status-file mirror, with the streaming trainer's and the bulk
  transform's gauges when they run;
- the divergence canary (:mod:`obs.canary`): rolling-loss NaN and
  explosion detection, warn or abort; an abort flushes the event log
  and raises :class:`TrainingDiverged`, and the fit loop leaves a
  ``ckpt-diverged`` snapshot;
- the step-time ledger (``utils.metrics.StepTimeLedger``): the fit
  thread's wall clock by phase, in ``training_metrics["steptime"]``, the
  heartbeat and ``STEPTIME.json``.

A fit owns one :class:`ObsRun`; :func:`start_run` returns the shared
no-op :data:`NULL_RUN` when observability is off, so the loops call the
hooks unconditionally. Span names and ledger phases are the JAX
package's.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Optional

from glint_word2vec_torch.obs import events
from glint_word2vec_torch.obs.canary import DivergenceCanary, TrainingDiverged
from glint_word2vec_torch.obs.events import EventRecorder
from glint_word2vec_torch.obs.heartbeat import HeartbeatServer, TrainingStatus
from glint_word2vec_torch.utils.metrics import StepTimeLedger

__all__ = [
    "DivergenceCanary", "EventRecorder", "HeartbeatServer", "NULL_RUN",
    "ObsConfig", "ObsRun", "StepTimeLedger", "TrainingDiverged",
    "TrainingStatus", "start_run",
]

logger = logging.getLogger(__name__)


@dataclass
class ObsConfig:
    """Observability of one fit invocation. Run config, never part of
    ``Word2VecParams`` or the saved model."""

    #: JSONL sink receiving every span and event (None: ring only).
    event_log: Optional[str] = None
    #: Bounded in-memory event ring; overflow counts as dropped.
    event_capacity: int = 65536
    #: Chrome-trace (chrome://tracing, Perfetto) JSON written at run end.
    chrome_trace: Optional[str] = None
    #: Record events even with no sink configured.
    record_events: bool = False
    #: Heartbeat HTTP port (None: no server; 0: ephemeral, the bound port
    #: is published back on ``bound_port``).
    status_port: Optional[int] = None
    status_host: str = "127.0.0.1"
    #: Atomic JSON mirror of the status snapshot, rewritten at most every
    #: ``status_interval`` seconds.
    status_file: Optional[str] = None
    status_interval: float = 1.0
    #: Divergence canary: "off", "warn" (log and event) or "abort"
    #: (event-log flush, ``ckpt-diverged``, then TrainingDiverged).
    canary: str = "off"
    canary_window: int = 64
    canary_factor: float = 10.0
    #: Steps between two canary checks. The loops hand the canary losses
    #: they already read back, so a check costs no device sync here.
    canary_check_every: int = 32
    #: STEPTIME.json written atomically at run end: the ledger's phase
    #: breakdown and per-phase quantiles.
    steptime_path: Optional[str] = None
    #: Filled in by start_run when a heartbeat server binds.
    bound_port: Optional[int] = None

    @property
    def wants_recorder(self) -> bool:
        return bool(self.event_log or self.chrome_trace or self.record_events)

    @property
    def enabled(self) -> bool:
        return bool(
            self.wants_recorder
            or self.status_port is not None
            or self.status_file
            or self.canary != "off"
            or self.steptime_path
        )


#: Span name -> ledger phase. Only these fit-thread spans are accounted:
#: nested or other-thread spans (``subword_expand`` inside
#: ``device_steps``, ``ckpt_write`` on the writer thread) stay out, so
#: the phase totals decompose the fit thread's wall clock.
_LEDGER_PHASE_OF = {
    "device_steps": "dispatch",
    "readback_harvest": "readback_harvest",
    "host_batch": "producer_wait",
    "subsample_compact": "compact",
    "subsample_prefetch": "compact",
    "ckpt_snapshot": "checkpoint",
    "checkpoint_save": "checkpoint",
    "checkpoint_restore": "checkpoint",
    "upload_corpus": "other",
}


class _LedgerSpan:
    """Charges a span's wall time to a ledger phase on top of recording
    it; ``with`` yields the inner span, so ``span.update`` works."""

    __slots__ = ("_ledger", "_phase", "_inner", "_t0")

    def __init__(self, ledger, phase: str, inner):
        self._ledger = ledger
        self._phase = phase
        self._inner = inner

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self._inner.__enter__()

    def __exit__(self, *exc):
        self._ledger.account(self._phase, time.perf_counter() - self._t0)
        return self._inner.__exit__(*exc)


class _NullRun:
    """Observability off: every hook is a no-op."""

    recorder = None
    canary = None
    status = None
    server = None
    ledger = None

    def span(self, name: str, **args):
        return events.NULL_SPAN

    def event(self, name: str, **args) -> None:
        pass

    def steptime_totals(self):
        return None

    def attach_metrics(self, metrics) -> None:
        pass

    def update(self, **kw) -> None:
        pass

    def update_streaming(self, **kw) -> None:
        pass

    def update_transform(self, **kw) -> None:
        pass

    def observe_losses(self, first_step: int, losses, n_real: int) -> None:
        pass

    def close(self, failed: bool = False) -> None:
        pass


NULL_RUN = _NullRun()


class ObsRun:
    """Observability of one fit: the event recorder (installed as the
    process-wide recorder, so engine-level sites emit too), the
    heartbeat server, the status-file mirror, the canary and the ledger,
    driven by the fit loop through ``span``, ``update``,
    ``observe_losses`` and ``close``."""

    def __init__(self, config: ObsConfig, *, pipeline: str = "",
                 total_epochs: int = 0, total_words: int = 0, engine=None):
        self.config = config
        self.recorder = (
            EventRecorder(config.event_capacity, config.event_log)
            if config.wants_recorder else None
        )
        self.ledger = StepTimeLedger()
        self._prev_recorder = events.get_recorder()
        events.set_recorder(self.recorder)
        try:
            self.canary = (
                DivergenceCanary(window=config.canary_window,
                                 factor=config.canary_factor)
                if config.canary != "off" else None
            )
            self.status = TrainingStatus(
                pipeline=pipeline, total_epochs=total_epochs,
                total_words=total_words, engine=engine,
                recorder=self.recorder, ledger=self.ledger,
            )
            if self.canary is not None:
                self.status.set_canary(config.canary, 0, None)
            self.server: Optional[HeartbeatServer] = None
            if config.status_port is not None:
                self.server = HeartbeatServer(
                    self.status, config.status_host, config.status_port
                )
                self.server.start()
                config.bound_port = self.server.port
                logger.info("training heartbeat on http://%s:%d "
                            "(/healthz, /metrics)",
                            self.server.host, self.server.port)
        except BaseException:
            # No ObsRun for the loop to close: uninstall the recorder and
            # release the sink here.
            events.set_recorder(self._prev_recorder)
            if self.recorder is not None:
                self.recorder.close()
            raise
        self._status_written = 0.0
        self._since_check = 0
        self._aborted = False
        self._closed = False
        self.status.update(state="running")
        self.event("run_start", pipeline=pipeline, total_epochs=total_epochs)
        self._write_status(force=True)

    def attach_metrics(self, metrics) -> None:
        self.status.attach(metrics=metrics)

    def span(self, name: str, **args):
        inner = (self.recorder.span(name, **args)
                 if self.recorder is not None else events.NULL_SPAN)
        phase = _LEDGER_PHASE_OF.get(name)
        if phase is None:
            return inner
        return _LedgerSpan(self.ledger, phase, inner)

    def steptime_totals(self) -> dict:
        """{phase: seconds}, the unattributed gap in ``other``."""
        return {p: round(s, 3) for p, s in self.ledger.totals().items()}

    def event(self, name: str, **args) -> None:
        if self.recorder is not None:
            self.recorder.event(name, **args)

    def update(self, **kw) -> None:
        self.status.update(**kw)
        self._write_status()

    def update_streaming(self, **kw) -> None:
        """The streaming trainer's gauge hook:
        ``TrainingStatus.set_streaming``, then the status file on its
        usual cadence."""
        self.status.set_streaming(**kw)
        self._write_status()

    def update_transform(self, **kw) -> None:
        """The bulk transform's gauge hook: ``TrainingStatus.set_transform``,
        then the status file on its usual cadence."""
        self.status.set_transform(**kw)
        self._write_status()

    def observe_losses(self, first_step: int, losses, n_real: int) -> None:
        """Canary hook, called once a group with its ``(K,)`` per-step
        losses, already read back to the host. Every
        ``canary_check_every`` steps it checks the group's last live loss.
        Warn mode logs and records an event; abort mode flushes the event
        log and raises :class:`TrainingDiverged`."""
        if self.canary is None or n_real <= 0:
            return
        self._since_check += n_real
        if self._since_check < max(1, self.config.canary_check_every):
            return
        self._since_check = 0
        step = first_step + n_real
        reason = self.canary.check(step, float(losses[n_real - 1]))
        if reason is None:
            return
        self.status.set_canary(self.config.canary, self.canary.trips, reason)
        self.event("canary_trip", step=step, mode=self.config.canary,
                   reason=reason)
        if self.config.canary == "abort":
            self._aborted = True
            self.status.update(state="diverged")
            if self.recorder is not None:
                self.recorder.flush()
            self._write_status(force=True)
            raise TrainingDiverged(reason)
        logger.warning("divergence canary: %s", reason)

    def _write_status(self, force: bool = False) -> None:
        path = self.config.status_file
        if not path:
            return
        now = time.time()
        if not force and now - self._status_written < self.config.status_interval:
            return
        self._status_written = now
        from glint_word2vec_torch.utils import atomic_write_json

        try:
            atomic_write_json(path, self.status.snapshot())
        except OSError as e:
            logger.warning("status-file write to %s failed: %s", path, e)
        # Keep the JSONL sink near-current on disk at the status cadence.
        if self.recorder is not None:
            self.recorder.flush()

    def close(self, failed: bool = False) -> None:
        """Idempotent teardown (first call wins): final state, ledger dump,
        Chrome-trace export, sink close, recorder uninstall, final status
        write, server stop. The loops call ``close(failed=True)`` from
        their exception handler and ``close()`` from ``finally``, so a
        crashed run never publishes a status that looks like success."""
        if self._closed:
            return
        self._closed = True
        if self._aborted:
            state = "diverged"
        elif failed:
            state = "failed"
        else:
            state = "done"
        self.status.update(state=state)
        self.event("run_end", state=state)
        self.ledger.finalize()
        if self.config.steptime_path:
            try:
                self.ledger.dump(self.config.steptime_path)
            except OSError as e:
                logger.warning("STEPTIME dump to %s failed: %s",
                               self.config.steptime_path, e)
        if self.recorder is not None:
            if self.config.chrome_trace:
                self.recorder.export_chrome_trace(self.config.chrome_trace)
            self.recorder.close()
        events.set_recorder(self._prev_recorder)
        self._write_status(force=True)
        if self.server is not None:
            self.server.stop()
            self.server = None


def start_run(config: Optional[ObsConfig], **kw):
    """:data:`NULL_RUN` when observability is off; a live ObsRun else."""
    if config is None or not config.enabled:
        return NULL_RUN
    return ObsRun(config, **kw)
