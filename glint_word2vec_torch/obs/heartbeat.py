"""Live training heartbeat: ``/healthz`` and ``/metrics`` on the training
process (trimmed copy of ``glint_word2vec_tpu/obs/heartbeat.py``).

The training loop feeds a :class:`TrainingStatus` snapshot (epoch and
step progress, rolling words/s, host_frac, last loss, the card's memory
stats, checkpoint telemetry, canary state), and an opt-in
:class:`HeartbeatServer` serves it read-only over HTTP:

  GET /healthz                    -> {"status": "ok"|"diverged"|..., ...}
  GET /metrics                    -> the full JSON snapshot
  GET /metrics?format=prometheus  -> text exposition

A process that cannot bind a port mirrors the same snapshot to an atomic
JSON status file instead (``obs.ObsRun``'s ``status_file``).

The server thread reads host values only: the metrics the fit loop
already read back, the engine's counters and checkpoint stats, and the
CUDA caching allocator's statistics. It never reads a CUDA tensor, which
would synchronize the card from a second thread.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

logger = logging.getLogger(__name__)


def _finite_or_none(v):
    """Non-finite floats serialize as bare NaN/Infinity, which strict JSON
    readers refuse exactly on the diverging run; None round-trips as
    null, and the Prometheus renderer maps it back to NaN."""
    if v is None:
        return None
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if math.isfinite(f) else None


def device_memory_stats(device=None) -> dict:
    """The CUDA caching allocator's byte counters for ``device`` (the
    engine's card) and the card's free and total memory, keyed by the
    device index; ``{}`` on the CPU or without a card. Never raises, and
    never synchronizes the device."""
    out: dict = {}
    try:
        import torch

        if device is None:
            if not torch.cuda.is_available():
                return out
            device = torch.device("cuda", torch.cuda.current_device())
        device = torch.device(device)
        if device.type != "cuda":
            return out
        stats = {
            k: int(v)
            for k, v in torch.cuda.memory_stats(device).items()
            if isinstance(v, (int, float)) and "bytes" in k
            and k.endswith((".all.current", ".all.peak"))
        }
        free, total = torch.cuda.mem_get_info(device)
        stats.update(bytes_free=int(free), bytes_limit=int(total))
        out[str(device.index or 0)] = stats
    except Exception:
        pass
    return out


class TrainingStatus:
    """Thread-safe snapshot of a running fit: written by the training
    loop (once a dispatch group), read by the heartbeat server and the
    status-file writer."""

    #: (wall time, words_done) samples kept for the rolling words/s.
    ROLLING = 32

    def __init__(self, *, pipeline: str = "", total_epochs: int = 0,
                 total_words: int = 0, metrics=None, engine=None,
                 recorder=None, ledger=None):
        self._mu = threading.Lock()
        self._ledger = ledger
        self.pipeline = pipeline
        self.total_epochs = int(total_epochs)
        self.total_words = int(total_words)
        self._metrics = metrics
        self._engine = engine
        self._recorder = recorder
        self.started = time.time()
        # starting|running|done|diverged|failed
        self.state = "starting"
        self.epoch = 0
        self.step = 0
        self.words_done = 0
        self.alpha: Optional[float] = None
        self.canary = {"mode": "off", "trips": 0, "last_reason": None}
        # The JAX package's supervisor fields; the port has no supervisor
        # yet, so every fit is unsupervised and healthy until it ends.
        self.unhealthy_reason: Optional[str] = None
        self.supervisor_generation: Optional[int] = None
        self._rolling: deque = deque(maxlen=self.ROLLING)
        #: The streaming trainer's gauges and its last publish's unix
        #: time; None until a ``fit_stream`` run sets them.
        self._streaming: Optional[dict] = None
        self._last_publish_unix: Optional[float] = None
        #: The bulk transform's gauges; None until a transform run sets
        #: them, so a fit's snapshot has no ``transform`` block.
        self._transform: Optional[dict] = None

    def attach(self, *, metrics=None, engine=None, recorder=None,
               ledger=None) -> None:
        with self._mu:
            if metrics is not None:
                self._metrics = metrics
            if engine is not None:
                self._engine = engine
            if recorder is not None:
                self._recorder = recorder
            if ledger is not None:
                self._ledger = ledger

    def update(self, *, epoch=None, step=None, words_done=None, alpha=None,
               state=None) -> None:
        with self._mu:
            if epoch is not None:
                self.epoch = int(epoch)
            if step is not None:
                self.step = int(step)
            if words_done is not None:
                self.words_done = int(words_done)
                self._rolling.append((time.time(), self.words_done))
            if alpha is not None:
                self.alpha = float(alpha)
            if state is not None:
                self.state = state

    def set_canary(self, mode: str, trips: int, last_reason) -> None:
        with self._mu:
            self.canary = {
                "mode": mode, "trips": int(trips), "last_reason": last_reason,
            }

    def set_streaming(self, *, words_streamed=0, sentences_streamed=0,
                      oov_words=0, vocab_size=0, promoted_words=0,
                      extra_rows_free=0, sketch_fill=0.0,
                      noise_drift_l1=None, stream_lag_seconds=None,
                      generations_published=0, last_publish_unix=None,
                      buffer_fill=None) -> None:
        """Install the streaming trainer's gauges (``heartbeat.py:170`` of
        the JAX package): stream progress, vocabulary growth, the noise
        distribution's drift and the publish cadence, which
        ``training_to_prometheus`` renders as ``glint_stream_*``. The
        publish age is computed at snapshot time."""
        with self._mu:
            self._last_publish_unix = last_publish_unix
            self._streaming = {
                "words_streamed_total": words_streamed,
                "sentences_streamed_total": sentences_streamed,
                "oov_words_total": oov_words,
                "stream_vocab_size": vocab_size,
                "promoted_words_total": promoted_words,
                "extra_rows_free": extra_rows_free,
                "sketch_fill": _finite_or_none(sketch_fill),
                "noise_drift_l1": _finite_or_none(noise_drift_l1),
                "stream_lag_seconds": _finite_or_none(stream_lag_seconds),
                "generations_published_total": generations_published,
                "buffer_fill": _finite_or_none(buffer_fill),
            }

    def set_transform(self, *, sentences_done=0, input_sentences=0,
                      sentences_per_sec=0.0, shards_committed=0,
                      shards_skipped=0, bucket_fill=None,
                      producer_wait_seconds=0.0, dispatch_seconds=0.0,
                      post_warmup_compiles=0) -> None:
        """Install the bulk transform's gauges (``heartbeat.py:200`` of
        the JAX package): progress, shard commits and skips, packing
        density, the producer wait and the dispatch seconds, and the query
        shapes first met after the warmup."""
        with self._mu:
            self._transform = {
                "sentences_done_total": sentences_done,
                "input_sentences": input_sentences,
                "sentences_per_sec": _finite_or_none(sentences_per_sec),
                "shards_committed_total": shards_committed,
                "shards_skipped_total": shards_skipped,
                "bucket_fill": _finite_or_none(bucket_fill),
                "producer_wait_seconds": _finite_or_none(producer_wait_seconds),
                "dispatch_seconds": _finite_or_none(dispatch_seconds),
                "post_warmup_compiles_total": post_warmup_compiles,
            }

    def _rolling_wps(self) -> float:
        if len(self._rolling) < 2:
            return 0.0
        (t0, w0), (t1, w1) = self._rolling[0], self._rolling[-1]
        return (w1 - w0) / max(t1 - t0, 1e-9)

    def snapshot(self, include_devices: bool = True) -> dict:
        with self._mu:
            m, eng, rec, ledger = (self._metrics, self._engine,
                                   self._recorder, self._ledger)
            snap = {
                "state": self.state,
                "pipeline": self.pipeline,
                "uptime_seconds": round(time.time() - self.started, 2),
                "epoch": self.epoch,
                "total_epochs": self.total_epochs,
                "step": self.step,
                "words_done": self.words_done,
                "total_words": self.total_words,
                "words_per_sec_rolling": round(self._rolling_wps(), 1),
                "alpha": _finite_or_none(self.alpha),
                "canary": dict(self.canary),
                "supervisor_generation": self.supervisor_generation,
                "unhealthy_reason": self.unhealthy_reason,
            }
            if self._streaming is not None:
                streaming = dict(self._streaming)
                streaming["last_publish_age_seconds"] = _finite_or_none(
                    time.time() - self._last_publish_unix
                    if self._last_publish_unix else None
                )
                snap["streaming"] = streaming
            if self._transform is not None:
                snap["transform"] = dict(self._transform)
        if m is not None:
            # last_loss is what the fit loop last read back: the
            # heartbeat never reads a device value of its own.
            ht, st = m.host_time, m.step_time
            snap.update({
                "last_loss": _finite_or_none(m.last_loss),
                "host_time": round(ht, 2),
                "step_time": round(st, 2),
                "host_frac": round(ht / max(ht + st, 1e-9), 3),
                "device_stall_seconds": round(getattr(m, "stall_time", 0.0), 3),
            })
        if eng is not None:
            snap["table_version"] = int(getattr(eng, "table_version", 0))
            snap["query_compiles"] = int(getattr(eng, "query_compiles", 0))
            ck_stats = getattr(eng, "checkpoint_stats", None)
            if ck_stats is not None:
                try:
                    ck = ck_stats()
                except Exception:  # telemetry must never kill the server
                    ck = {}
                snap["pending_async_saves"] = ck.get("pending_async_saves", 0)
                snap["async_save_waits"] = ck.get("async_save_waits", 0)
                snap["checkpoint_write_seconds"] = _finite_or_none(
                    ck.get("checkpoint_write_seconds"))
                snap["last_checkpoint_age_seconds"] = _finite_or_none(
                    ck.get("last_checkpoint_age_seconds"))
                snap["checkpoint_shard_write_seconds"] = _finite_or_none(
                    ck.get("checkpoint_shard_write_seconds"))
                snap["checkpoint_shard_verify_seconds"] = _finite_or_none(
                    ck.get("checkpoint_shard_verify_seconds"))
                snap["checkpoint_shards_skipped"] = ck.get(
                    "checkpoint_shards_skipped", 0)
        if rec is not None:
            snap["events"] = rec.counts()
        if ledger is not None:
            snap["steptime"] = ledger.snapshot()
        if include_devices:
            snap["device_memory"] = device_memory_stats(
                getattr(eng, "device", None) if eng is not None else None)
        return snap


class HeartbeatServer:
    """Background stdlib HTTP server over one :class:`TrainingStatus`:
    GET only, daemon-threaded, ``port=0`` binds an ephemeral port (the
    bound one is ``self.port``)."""

    def __init__(self, status: TrainingStatus, host: str = "127.0.0.1",
                 port: int = 0):
        from glint_word2vec_torch.obs.prometheus import training_to_prometheus

        server = self
        self.status = status

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                logger.debug("heartbeat: " + fmt, *args)

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/healthz":
                    snap = server.status.snapshot(include_devices=False)
                    ok = snap["state"] not in ("diverged", "failed", "unhealthy")
                    body = json.dumps({
                        "status": "ok" if ok else snap["state"],
                        "state": snap["state"],
                        "pipeline": snap["pipeline"],
                        "epoch": snap["epoch"],
                        "total_epochs": snap["total_epochs"],
                        "step": snap["step"],
                        "words_done": snap["words_done"],
                        "words_per_sec_rolling": snap["words_per_sec_rolling"],
                        "unhealthy_reason": snap["unhealthy_reason"],
                    }).encode()
                    # 503: probes act on the status code alone.
                    self._send(200 if ok else 503, body, "application/json")
                elif url.path == "/metrics":
                    snap = server.status.snapshot()
                    fmt = parse_qs(url.query).get("format", ["json"])[0]
                    if fmt == "prometheus":
                        self._send(200, training_to_prometheus(snap).encode(),
                                   "text/plain; version=0.0.4; charset=utf-8")
                    else:
                        self._send(200, json.dumps(snap).encode(),
                                   "application/json")
                else:
                    self._send(404, json.dumps(
                        {"error": f"no route {url.path}"}).encode(),
                        "application/json")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="glint-heartbeat",
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
