"""Background checkpoint writer: the host half of non-blocking saves
(copy of ``glint_word2vec_tpu/utils/async_ckpt.py``).

``EmbeddingEngine.save_async`` copies the tables from the card to host
arrays on the calling thread, the only work that stalls the fit loop,
and hands serialization, the durability fsyncs and the atomic commit to
the single writer thread this module owns. The writer touches host
arrays only, never a CUDA tensor.

A depth-1 pipeline: at most one snapshot is in flight. A second request
blocks until the first commits (counted in ``blocked_waits``, checkpoint
back-pressure on the heartbeat), which bounds the snapshot memory to one
table pair and keeps commits in order, so ``train_state.json`` never
flips to a checkpoint older than one already committed.

Failure contract: a failed write never crashes the training thread
mid-dispatch. The error is held and re-raised at the next ``submit`` or
at the ``wait()`` barrier the fit loops run before they return. The
commit callback (the ``train_state.json`` flip) runs only after a
successful write, so a failed or killed write leaves the previous
committed checkpoint authoritative.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)


class SnapshotWriterHung(RuntimeError):
    """A wait on the background checkpoint writer exceeded its timeout:
    the writer thread is stuck (dead filesystem, hung fsync, injected
    fault). The previous committed checkpoint is still authoritative —
    the in-flight snapshot never renamed."""


class AsyncSnapshotWriter:
    """Single daemon writer thread with a one-deep job hand-off.

    Written for a single submitting thread (the fit loop); concurrent
    submitters are not supported (they would race the in-flight guard).
    The writer thread is started lazily on first submit and is a daemon,
    so an abandoned engine never pins process exit.
    """

    def __init__(self, name: str = "glint-ckpt-writer"):
        self._jobs: queue.Queue = queue.Queue(maxsize=1)
        self._mu = threading.Lock()
        self._idle = threading.Event()
        self._idle.set()
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._name = name
        #: Snapshots queued but not yet committed (0 or 1).
        self.pending = 0
        #: Times a submit found the previous snapshot still in flight and
        #: had to block for it — checkpoint back-pressure, surfaced on
        #: the heartbeat (``async_save_waits``).
        self.blocked_waits = 0
        #: Successfully committed snapshots.
        self.commits = 0
        #: Wall seconds of the most recent write job (host-side copy +
        #: serialization + commit), successful or not.
        self.last_write_seconds: Optional[float] = None
        #: time.time() of the most recent successful commit.
        self.last_commit_time: Optional[float] = None
        #: Human-readable label of the job currently in flight (the
        #: checkpoint path) — named in the hung-writer error so the
        #: operator knows which snapshot to inspect.
        self.current_job: Optional[str] = None

    # -- writer thread --------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, daemon=True, name=self._name
            )
            self._thread.start()

    def _run(self) -> None:
        while True:
            job = self._jobs.get()
            t0 = time.time()
            try:
                job()
                with self._mu:
                    self.commits += 1
                    self.last_commit_time = time.time()
            except BaseException as e:  # held for the submitting thread
                logger.error("async checkpoint write failed: %s", e)
                with self._mu:
                    self._error = e
            finally:
                with self._mu:
                    self.pending -= 1
                    self.last_write_seconds = time.time() - t0
                    self.current_job = None
                self._idle.set()

    # -- submitting-thread API ------------------------------------------

    def _await_idle(self, timeout: Optional[float]) -> None:
        """Wait for the writer to go idle; on timeout, log the stuck job
        and raise :class:`SnapshotWriterHung` instead of pinning the
        caller (the fit-exit barrier) forever."""
        if self._idle.wait(timeout):
            return
        with self._mu:
            job = self.current_job
        logger.error(
            "checkpoint writer hung: job %r still in flight after "
            "%.1fs; previous committed checkpoint remains authoritative",
            job, timeout,
        )
        raise SnapshotWriterHung(
            f"checkpoint writer did not finish {job!r} within "
            f"{timeout:.1f}s"
        )

    def wait_for_slot(self, timeout: Optional[float] = None) -> None:
        """Block until no snapshot is in flight (counted in
        ``blocked_waits`` when it actually blocks) and surface any prior
        write error. Callers invoke this BEFORE materializing a new
        snapshot, so transient snapshot memory stays bounded to ONE
        table pair — snapshotting first and blocking in submit would
        briefly hold two. ``timeout`` raises
        :class:`SnapshotWriterHung` instead of waiting forever."""
        if not self._idle.is_set():
            with self._mu:
                self.blocked_waits += 1
            self._await_idle(timeout)
        self.raise_pending_error()

    def submit(self, job: Callable[[], None],
               label: Optional[str] = None,
               timeout: Optional[float] = None) -> None:
        """Queue one snapshot job. Blocks while a previous snapshot is
        still in flight (the at-most-one guard; prefer
        :meth:`wait_for_slot` before building the snapshot); re-raises
        any error a previous job recorded — the failed save's state flip
        never ran, so the caller learns before trusting the checkpoint
        chain. ``label`` names the job in hung-writer diagnostics."""
        self._ensure_thread()
        self.wait_for_slot(timeout)
        with self._mu:
            self.pending += 1
            self.current_job = label or getattr(job, "__name__", "job")
        self._idle.clear()
        self._jobs.put(job)

    def wait(self, *, reraise: bool = True,
             timeout: Optional[float] = None) -> None:
        """Barrier: return once no snapshot is in flight. ``reraise``
        surfaces a held write error (the fit-exit barrier wants it; the
        exception-path cleanup barrier must not mask the original
        failure and passes False). With ``timeout``, a writer thread
        stuck past it logs the pending job and raises
        :class:`SnapshotWriterHung` instead of hanging fit exit forever
        (with ``reraise=False`` the hang is logged but NOT raised — the
        cleanup barrier must not mask the original failure it is
        unwinding)."""
        try:
            self._await_idle(timeout)
        except SnapshotWriterHung:
            if reraise:
                raise
            return
        if reraise:
            self.raise_pending_error()

    def raise_pending_error(self) -> None:
        with self._mu:
            e, self._error = self._error, None
        if e is not None:
            raise RuntimeError(
                "asynchronous checkpoint write failed; the previous "
                "committed checkpoint is still authoritative"
            ) from e

    def stats(self) -> dict:
        with self._mu:
            return {
                "pending": self.pending,
                "blocked_waits": self.blocked_waits,
                "commits": self.commits,
                "last_write_seconds": self.last_write_seconds,
                "last_commit_time": self.last_commit_time,
            }
