"""The port's gang supervisor (counterpart of
``glint_word2vec_tpu/parallel/supervisor.py``): launch, watch, tear down
and relaunch the N processes of a training gang or a bulk transform.

  * launches the gang (a fresh coordinator port each generation: a
    half-dead coordinator is never rejoined), each worker in its own
    session, its output appended to ``worker-<rank>.log``;
  * watches liveness two ways: ``waitpid`` (a worker exiting nonzero or
    on a signal) and the workers' ``--status-file`` heartbeats (a
    current-generation status file whose mtime goes stale while its
    process runs is a hang);
  * on any failure tears the whole gang down (SIGTERM, grace, SIGKILL:
    the survivors are blocked in collectives), collects each rank's
    postmortem bundle (last heartbeat, event log, step-time ledger, log
    tail), re-resolves the last committed checkpoint through
    ``utils/integrity.resolve_train_state`` and relaunches with capped
    exponential backoff under a restart budget;
  * optionally serves the merged gang ``/metrics`` and ``/healthz``
    (``obs/aggregate.GangStatusServer``);
  * returns a :class:`SupervisorReport` of restarts and recovery times.

Each launch exports ``GLINT_SUPERVISOR_GEN``; a worker's heartbeat echoes
it as ``supervisor_generation`` (``obs/heartbeat.py``), so a pre-restart
status file never counts as a live heartbeat. The workers run ``python -m
glint_word2vec_torch.cli`` (:func:`cli_train_build_argv`,
:func:`cli_transform_build_argv`) and own the cards: the supervisor
never touches CUDA. One worker is the degenerate gang, a
restart-with-resume wrapper around one fit.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import socket
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from glint_word2vec_torch.utils import atomic_write_json

logger = logging.getLogger(__name__)

#: build_argv(rank, num_workers, coordinator_port, status_file,
#: generation) -> argv list for one worker process.
BuildArgv = Callable[[int, int, int, str, int], List[str]]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def capped_backoff(restarts: int, base: float, cap: float) -> float:
    """Capped exponential restart backoff: ``base * 2**restarts``,
    never past ``cap``."""
    return min(float(base) * (2 ** int(restarts)), float(cap))


def signal_process_group(proc: subprocess.Popen, sig) -> None:
    """Signal a child's whole process group (catching any
    grandchildren), falling back to the process itself when the group
    is gone or was never created."""
    try:
        os.killpg(os.getpgid(proc.pid), sig)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            proc.send_signal(sig)
        except (ProcessLookupError, OSError):
            pass


def terminate_process(proc: subprocess.Popen,
                      grace_seconds: float = 5.0) -> None:
    """SIGTERM a child's process group, wait out the grace window,
    SIGKILL whatever survives, and reap it: the one-process form of the
    gang teardown."""
    if proc.poll() is not None:
        return
    signal_process_group(proc, signal.SIGTERM)
    deadline = time.time() + max(0.0, grace_seconds)
    while time.time() < deadline and proc.poll() is None:
        time.sleep(0.05)
    if proc.poll() is None:
        signal_process_group(proc, signal.SIGKILL)
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:  # pragma: no cover
        logger.error("pid %d survived SIGKILL", proc.pid)


def cli_train_build_argv(train_rest: List[str]) -> BuildArgv:
    """:data:`BuildArgv` for workers running ``python -m
    glint_word2vec_torch.cli train <train_rest>`` — the ONE place the
    worker launch contract (per-rank status file, distributed flags for
    gangs > 1) is encoded, used by the CLI ``supervise`` subcommand."""
    import sys

    def build_argv(rank, n, port, status_file, generation):
        status_dir = os.path.dirname(status_file)
        argv = [
            sys.executable, "-m", "glint_word2vec_torch.cli", "train",
            *train_rest, "--status-file", status_file,
            # Crash flight recorder: every worker mirrors its
            # event ring to a per-rank JSONL (flushed on the status
            # cadence) and dumps its step-time ledger at run end, so
            # the supervisor can collect a postmortem bundle even for
            # a SIGKILLed or wedged rank. Appended AFTER the operator's
            # train args, so these supervisor-owned paths win argparse's
            # last-value-wins if the operator also set them.
            "--event-log",
            os.path.join(status_dir, f"events-{rank}.jsonl"),
            "--steptime-out",
            os.path.join(status_dir, f"steptime-{rank}.json"),
        ]
        if n > 1:
            argv += [
                "--coordinator", f"127.0.0.1:{port}",
                "--num-processes", str(n), "--process-id", str(rank),
            ]
        return argv

    return build_argv


def cli_transform_build_argv(transform_rest: List[str]) -> BuildArgv:
    """:data:`BuildArgv` for ranks running ``python -m
    glint_word2vec_torch.cli transform-file <transform_rest>`` — the
    bulk-embedding analogue of :func:`cli_train_build_argv`.
    Ranks are embarrassingly parallel: each derives its contiguous
    input span from ``--rank``/``--world``
    (:func:`parallel.distributed.shard_span`) and writes a private
    ``rank-NNNN/`` shard directory, so no coordinator flags are
    appended — a relaunched rank resumes from its own committed shards,
    independent of the others. Supervisor-owned flags come AFTER the
    operator's args so they win argparse's last-value-wins."""
    import sys

    def build_argv(rank, n, port, status_file, generation):
        status_dir = os.path.dirname(status_file)
        return [
            sys.executable, "-m", "glint_word2vec_torch.cli",
            "transform-file", *transform_rest,
            "--status-file", status_file,
            "--metrics-out",
            os.path.join(status_dir, f"transform-{rank}.json"),
            "--rank", str(rank), "--world", str(n),
        ]

    return build_argv


@dataclass
class RestartRecord:
    generation: int  # the generation that FAILED
    reason: str
    resumed_from: Optional[str]  # verified checkpoint name, None = fresh
    backoff_seconds: float
    detect_to_relaunch_seconds: float
    #: Detection -> first heartbeat snapshot of the NEW generation (the
    #: honest recovery latency: includes backoff, process-group bring-up, vocab
    #: rebuild, checkpoint restore). None when no heartbeat arrived
    #: before the run ended (very short tails).
    detect_to_heartbeat_seconds: Optional[float] = None
    #: Crash-flight-recorder bundles collected from the FAILED
    #: generation (postmortem-<gen>-<rank>/ under status_dir): each
    #: holds that rank's last heartbeat snapshot, event-ring JSONL,
    #: step-time ledger, and worker-log tail.
    postmortem: List[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "generation": self.generation,
            "reason": self.reason,
            "resumed_from": self.resumed_from,
            "backoff_seconds": round(self.backoff_seconds, 3),
            "detect_to_relaunch_seconds": round(
                self.detect_to_relaunch_seconds, 3
            ),
            "detect_to_heartbeat_seconds": (
                round(self.detect_to_heartbeat_seconds, 3)
                if self.detect_to_heartbeat_seconds is not None else None
            ),
            "postmortem": list(self.postmortem),
        }


@dataclass
class SupervisorReport:
    completed: bool = False
    restarts: int = 0
    generations: int = 0
    gave_up_reason: Optional[str] = None
    wall_seconds: float = 0.0
    restart_records: List[RestartRecord] = field(default_factory=list)
    #: EVERY flight-recorder bundle this run collected (restart AND
    #: give-up teardowns), newest last — the one list an operator
    #: walks for post-incident forensics.
    postmortem_bundles: List[str] = field(default_factory=list)
    #: Bound port of the merged gang /metrics endpoint (None = off).
    metrics_port: Optional[int] = None

    def to_dict(self) -> dict:
        return {
            "completed": self.completed,
            "restarts": self.restarts,
            "generations": self.generations,
            "gave_up_reason": self.gave_up_reason,
            "wall_seconds": round(self.wall_seconds, 2),
            "restart_records": [r.to_dict() for r in self.restart_records],
            "postmortem_bundles": list(self.postmortem_bundles),
            "metrics_port": self.metrics_port,
        }


class Supervisor:
    """Supervise one N-worker training gang to completion.

    Parameters
    ----------
    build_argv:
        Callable producing each worker's argv (see :data:`BuildArgv`).
        The CLI ``supervise`` subcommand builds these from the raw
        ``train`` arguments; tests pass tiny stub scripts.
    num_workers:
        Gang size. 1 supervises a plain single-process fit.
    status_dir:
        Directory for per-rank status files (``status-<rank>.json``) and
        worker logs (``worker-<rank>.log``, appended across generations).
    checkpoint_dir:
        The fit's checkpoint directory; consulted between generations to
        log (and integrity-verify) what the relaunch will resume from.
        None skips re-resolution (the workers still resume themselves).
    env:
        Extra environment for every launch of every rank.
    rank_env_first_launch:
        Extra environment per rank applied ONLY to generation 0 — the
        chaos-drill seam: a ``GLINT_FAULTS`` kill schedule armed here
        fires once and is NOT re-armed on the relaunch (re-arming would
        kill every generation and burn the whole restart budget).
    heartbeat_stale_seconds:
        A current-generation status file older than this while its
        process lives is a hang. None disables hang detection (crash
        detection alone).
    startup_grace_seconds:
        How long a worker may run without producing its first
        current-generation heartbeat before that too is a hang
        (compilation can take minutes on cold starts — keep generous).
    metrics_port:
        Bind the merged gang observability endpoint here (0 =
        ephemeral; the bound port is on ``self.metrics_port``): one
        ``/metrics`` (JSON + Prometheus) + ``/healthz`` for the whole
        gang, fed from the per-rank status files each liveness sweep,
        generation-stamped. None (default) disables.
    serving_urls:
        Serving replicas' JSON ``/metrics`` URLs joined into the merged
        exposition (scraped on each request; a replica that does not
        answer is reported, never fatal).
    """

    def __init__(
        self,
        build_argv: BuildArgv,
        num_workers: int,
        *,
        status_dir: str,
        checkpoint_dir: Optional[str] = None,
        env: Optional[Dict[str, str]] = None,
        rank_env_first_launch: Optional[Dict[int, Dict[str, str]]] = None,
        heartbeat_stale_seconds: Optional[float] = 120.0,
        startup_grace_seconds: float = 600.0,
        poll_interval: float = 0.25,
        max_restarts: int = 3,
        backoff_base_seconds: float = 1.0,
        backoff_cap_seconds: float = 30.0,
        kill_grace_seconds: float = 5.0,
        metrics_port: Optional[int] = None,
        metrics_host: str = "127.0.0.1",
        serving_urls: Optional[List[str]] = None,
    ):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self.build_argv = build_argv
        self.num_workers = int(num_workers)
        self.status_dir = status_dir
        self.checkpoint_dir = checkpoint_dir
        self.env = dict(env or {})
        self.rank_env_first_launch = dict(rank_env_first_launch or {})
        self.heartbeat_stale_seconds = heartbeat_stale_seconds
        self.startup_grace_seconds = float(startup_grace_seconds)
        self.poll_interval = float(poll_interval)
        self.max_restarts = int(max_restarts)
        self.backoff_base_seconds = float(backoff_base_seconds)
        self.backoff_cap_seconds = float(backoff_cap_seconds)
        self.kill_grace_seconds = float(kill_grace_seconds)
        self._procs: List[Optional[subprocess.Popen]] = []
        self._logs: List = []
        #: Per-generation gang id, minted at each launch and exported to
        #: every rank as ``GLINT_TRACE_ID``; postmortem bundles carry it
        #: in meta.json.
        self._gen_trace_id: Optional[str] = None
        #: Merged gang observability endpoint. Bound in the
        #: constructor so callers know the port before run() blocks.
        self.gang_server = None
        self.metrics_port: Optional[int] = None
        if metrics_port is not None:
            from glint_word2vec_torch.obs.aggregate import GangStatusServer

            self.gang_server = GangStatusServer(
                host=metrics_host, port=metrics_port,
                num_workers=self.num_workers, serving_urls=serving_urls,
            )
            self.gang_server.start()
            self.metrics_port = self.gang_server.port
            logger.info(
                "supervisor: merged gang metrics on http://%s:%d "
                "(/healthz, /metrics)",
                self.gang_server.host, self.gang_server.port,
            )

    # -- per-generation plumbing ----------------------------------------

    def _status_file(self, rank: int) -> str:
        return os.path.join(self.status_dir, f"status-{rank}.json")

    def _read_status(self, rank: int, generation: int) -> Optional[dict]:
        """The rank's status snapshot, or None if absent/unparseable/
        from a previous generation (the handshake: a stale pre-restart
        file must never count as a live heartbeat)."""
        try:
            with open(self._status_file(rank)) as f:
                snap = json.load(f)
        except (OSError, ValueError):
            return None
        gen = snap.get("supervisor_generation")
        if gen is not None and int(gen) != generation:
            return None
        return snap

    def _launch(self, generation: int) -> None:
        import uuid

        os.makedirs(self.status_dir, exist_ok=True)
        port = free_port()
        # One id per generation, shared by every rank; a restart mints
        # a fresh one.
        self._gen_trace_id = uuid.uuid4().hex[:16]
        self._procs, self._logs = [], []
        for rank in range(self.num_workers):
            sf = self._status_file(rank)
            try:
                os.remove(sf)
            except OSError:
                pass
            env = dict(os.environ)
            env.update(self.env)
            env["GLINT_SUPERVISOR"] = "1"
            env["GLINT_SUPERVISOR_GEN"] = str(generation)
            env["GLINT_TRACE_ID"] = self._gen_trace_id or ""
            if generation == 0:
                env.update(self.rank_env_first_launch.get(rank, {}))
            argv = self.build_argv(
                rank, self.num_workers, port, sf, generation
            )
            log = open(
                os.path.join(self.status_dir, f"worker-{rank}.log"), "ab"
            )
            log.write(
                f"\n===== generation {generation} rank {rank}: "
                f"{' '.join(argv)} =====\n".encode()
            )
            log.flush()
            self._logs.append(log)
            # Own session per worker: the gang teardown kills the whole
            # process group, catching any grandchildren, and an operator
            # Ctrl-C on the supervisor doesn't race the workers.
            self._procs.append(
                subprocess.Popen(
                    argv, env=env, stdout=log, stderr=subprocess.STDOUT,
                    start_new_session=True,
                )
            )
        logger.info(
            "supervisor: generation %d launched (%d workers, "
            "coordinator port %d)", generation, self.num_workers, port,
        )

    def _kill_gang(self) -> None:
        """SIGTERM every live worker's process group, grace, SIGKILL.
        Survivors of a partial failure are wedged in collectives — they
        cannot checkpoint or exit cleanly, so the teardown must not
        wait on their goodwill."""
        live = [p for p in self._procs if p is not None and p.poll() is None]
        for p in live:
            self._signal(p, signal.SIGTERM)
        deadline = time.time() + self.kill_grace_seconds
        while time.time() < deadline and any(
            p.poll() is None for p in live
        ):
            time.sleep(0.05)
        for p in live:
            if p.poll() is None:
                self._signal(p, signal.SIGKILL)
        for p in live:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:  # pragma: no cover
                logger.error(
                    "supervisor: worker pid %d survived SIGKILL", p.pid
                )
        for log in self._logs:
            try:
                log.close()
            except OSError:
                pass
        self._logs = []

    @staticmethod
    def _signal(proc: subprocess.Popen, sig) -> None:
        signal_process_group(proc, sig)

    # -- failure detection ----------------------------------------------

    def _check_failure(
        self, generation: int, launched_at: float
    ) -> Optional[str]:
        """One poll round: returns a failure reason, or None while the
        generation is healthy (or already fully done — the caller checks
        completion first)."""
        now = time.time()
        for rank, p in enumerate(self._procs):
            rc = p.poll()
            if rc is not None and rc != 0:
                if rc < 0:
                    try:
                        name = signal.Signals(-rc).name
                    except ValueError:
                        name = str(-rc)
                    return f"worker {rank} killed by signal {name}"
                return f"worker {rank} exited with code {rc}"
        if self.heartbeat_stale_seconds is None:
            return None
        for rank, p in enumerate(self._procs):
            if p.poll() == 0:
                continue  # finished cleanly; its file legitimately ages
            snap = self._read_status(rank, generation)
            if snap is None:
                if now - launched_at > self.startup_grace_seconds:
                    return (
                        f"worker {rank} produced no generation-"
                        f"{generation} heartbeat within "
                        f"{self.startup_grace_seconds:.0f}s"
                    )
                continue
            age = now - os.path.getmtime(self._status_file(rank))
            if age > self.heartbeat_stale_seconds:
                return (
                    f"worker {rank} heartbeat stale for {age:.1f}s "
                    f"(threshold {self.heartbeat_stale_seconds:.0f}s)"
                )
        return None

    # -- crash flight recorder ------------------------------------------

    #: Worker-log tail bytes copied into each postmortem bundle.
    POSTMORTEM_LOG_TAIL = 65536

    def _collect_postmortem(self, generation: int, reason: str) -> List[str]:
        """Flush each rank's on-disk observability remains into a
        ``postmortem-<gen>-<rank>/`` bundle after a gang teardown: the
        last heartbeat snapshot (``heartbeat.json``), the event-ring
        JSONL the worker mirrored (``events.jsonl``), the step-time
        ledger when the rank got far enough to dump one
        (``steptime.json``), the worker-log tail (``log_tail.txt``),
        and a ``meta.json`` naming the generation/rank/reason. A
        SIGKILLed rank cannot flush anything itself — these files are
        exactly why the launch contract writes them continuously.
        Collection is best-effort and must never block a restart."""
        import shutil

        bundles = []
        for rank in range(self.num_workers):
            sources = [
                (self._status_file(rank), "heartbeat.json"),
                (os.path.join(self.status_dir, f"events-{rank}.jsonl"),
                 "events.jsonl"),
                (os.path.join(self.status_dir, f"steptime-{rank}.json"),
                 "steptime.json"),
            ]
            if not any(os.path.exists(src) for src, _ in sources):
                continue  # rank died before producing anything
            bundle = os.path.join(
                self.status_dir, f"postmortem-{generation}-{rank}"
            )
            try:
                os.makedirs(bundle, exist_ok=True)
                for src, dst in sources:
                    if os.path.exists(src):
                        shutil.copyfile(src, os.path.join(bundle, dst))
                log_path = os.path.join(
                    self.status_dir, f"worker-{rank}.log"
                )
                if os.path.exists(log_path):
                    with open(log_path, "rb") as f:
                        f.seek(0, os.SEEK_END)
                        f.seek(max(0, f.tell() - self.POSTMORTEM_LOG_TAIL))
                        tail = f.read()
                    # Temp + replace: the bundle is what an operator (or
                    # the chaos drill) reads after a crash — a torn tail
                    # file would point the postmortem at a lie.
                    tail_path = os.path.join(bundle, "log_tail.txt")
                    tmp = f"{tail_path}.tmp.{os.getpid()}"
                    with open(tmp, "wb") as f:
                        f.write(tail)
                    os.replace(tmp, tail_path)
                atomic_write_json(os.path.join(bundle, "meta.json"), {
                    "generation": generation,
                    "rank": rank,
                    "reason": reason,
                    "trace": self._gen_trace_id,
                    "collected_at": time.time(),
                })
            except OSError as e:
                logger.warning(
                    "supervisor: postmortem collection for rank %d "
                    "failed: %s", rank, e,
                )
                continue
            bundles.append(bundle)
        if bundles:
            logger.error(
                "supervisor: flight-recorder bundles collected: %s",
                ", ".join(bundles),
            )
        return bundles

    def _update_gang_status(self, generation: int) -> None:
        """Feed the merged-metrics server this sweep's per-rank view."""
        if self.gang_server is None:
            return
        self.gang_server.update(generation, {
            rank: self._read_status(rank, generation)
            for rank in range(self.num_workers)
        })

    def _resolve_checkpoint(self) -> Optional[str]:
        """Integrity-verified name of the snapshot the relaunch will
        resume from (None = fresh start). Raises
        ``CheckpointCorruptError`` when a state file exists but nothing
        verifies — restarting would silently retrain from scratch."""
        if not self.checkpoint_dir:
            return None
        from glint_word2vec_torch.utils.integrity import resolve_train_state

        resolved = resolve_train_state(self.checkpoint_dir)
        if resolved is None:
            return None
        state, _ = resolved
        return state.get("ckpt")  # legacy records carry no dir name

    # -- main loop ------------------------------------------------------

    def run(self) -> SupervisorReport:
        report = SupervisorReport(metrics_port=self.metrics_port)
        t0 = time.time()
        generation = 0
        pending_hb: Optional[RestartRecord] = None
        hb_detect_t = 0.0
        try:
            self._launch(generation)
            report.generations = 1
            launched_at = time.time()
            while True:
                self._update_gang_status(generation)
                if all(p.poll() == 0 for p in self._procs):
                    report.completed = True
                    logger.info(
                        "supervisor: generation %d completed (%d "
                        "restarts total)", generation, report.restarts,
                    )
                    return report
                if pending_hb is not None and any(
                    self._read_status(r, generation) is not None
                    for r in range(self.num_workers)
                ):
                    pending_hb.detect_to_heartbeat_seconds = (
                        time.time() - hb_detect_t
                    )
                    pending_hb = None
                reason = self._check_failure(generation, launched_at)
                if reason is None:
                    time.sleep(self.poll_interval)
                    continue

                detect_t = time.time()
                logger.error(
                    "supervisor: generation %d FAILED: %s; tearing the "
                    "gang down", generation, reason,
                )
                self._kill_gang()
                # Flight recorder: capture the failed generation's
                # per-rank remains NOW — the relaunch reopens (and
                # truncates) the per-rank event logs and status files.
                bundles = self._collect_postmortem(generation, reason)
                report.postmortem_bundles.extend(bundles)
                if report.restarts >= self.max_restarts:
                    report.gave_up_reason = (
                        f"{reason} (restart budget {self.max_restarts} "
                        "exhausted)"
                    )
                    logger.error(
                        "supervisor: giving up: %s", report.gave_up_reason
                    )
                    return report
                try:
                    resumed_from = self._resolve_checkpoint()
                except Exception as e:
                    report.gave_up_reason = (
                        f"{reason}; no verifiable checkpoint to resume "
                        f"from: {e}"
                    )
                    logger.error(
                        "supervisor: giving up: %s", report.gave_up_reason
                    )
                    return report
                backoff = capped_backoff(
                    report.restarts, self.backoff_base_seconds,
                    self.backoff_cap_seconds,
                )
                logger.warning(
                    "supervisor: restart %d/%d in %.1fs (resuming from "
                    "%s)", report.restarts + 1, self.max_restarts,
                    backoff, resumed_from or "scratch",
                )
                time.sleep(backoff)
                generation += 1
                self._launch(generation)
                launched_at = time.time()
                report.restarts += 1
                report.generations += 1
                rec = RestartRecord(
                    generation=generation - 1,
                    reason=reason,
                    resumed_from=resumed_from,
                    backoff_seconds=backoff,
                    detect_to_relaunch_seconds=time.time() - detect_t,
                    postmortem=bundles,
                )
                report.restart_records.append(rec)
                pending_hb, hb_detect_t = rec, detect_t
        finally:
            self._kill_gang()
            self._update_gang_status(generation)
            if self.gang_server is not None:
                self.gang_server.stop()
                self.gang_server = None
            report.wall_seconds = time.time() - t0
        return report
