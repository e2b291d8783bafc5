"""The gang view of a supervised run: per-rank heartbeat snapshots merged
into one document (trimmed copy of ``glint_word2vec_tpu/obs/aggregate.py``,
the parts the supervisor needs).

- :func:`merge_training_snapshots` folds the per-rank ``--status-file``
  snapshots into one gang document: summed counters (the exchange's among
  them), total words/s, per-rank progress, the ``rank_skew`` straggler
  gauge (the slowest rank's mean step time over the median) and the
  step-time ledgers merged bucket for bucket.
- :class:`GangStatusServer` is the supervisor's HTTP face: one merged
  ``/metrics`` (JSON, or ``?format=prometheus``) and ``/healthz`` for the
  whole gang, stamped with the launch generation so a scrape during a
  restart never mixes pre-restart ranks in.

The serving merge (``merge_serving_snapshots``), the trace merge
(``merge_trace_logs``) and the supervisor's ``--join-serving`` come with
the port's fleet slice. Nothing here reads a device: it runs in the
supervisor process, which leaves the cards to the workers.
"""

from __future__ import annotations

import json
import logging
import statistics
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from glint_word2vec_torch.utils.metrics import LEDGER_PHASES, LatencyHistogram

logger = logging.getLogger(__name__)

#: Snapshot keys summed into the gang ``counters`` block: each merged
#: value is the sum of the per-rank values.
_SUM_COUNTERS = (
    ("steps_total", "step"),
    ("words_done_total", "words_done"),
    ("query_compiles_total", "query_compiles"),
    ("async_save_waits_total", "async_save_waits"),
    ("exchange_bytes_total", "exchange_bytes_total"),
    ("exchange_rows_total", "exchange_rows_total"),
    ("exchange_overflow_total", "exchange_overflow_total"),
    ("exchange_groups_total", "exchange_groups_total"),
    ("exchange_intra_bytes_total", "exchange_intra_bytes_total"),
    ("exchange_inter_bytes_total", "exchange_inter_bytes_total"),
    ("checkpoint_shards_skipped_total", "checkpoint_shards_skipped"),
)

#: Rank states that make the whole gang unhealthy on /healthz.
_BAD_STATES = ("diverged", "failed", "unhealthy")


def _mean_step_seconds(snap: dict) -> Optional[float]:
    steps = snap.get("step") or 0
    st = snap.get("step_time")
    if not steps or st is None:
        return None
    return float(st) / float(steps)


def _merge_transform(ranks: List[dict]) -> dict:
    """The bulk transform's rollup: counters summed, the fill folded to
    the sparsest rank and the producer wait to the slowest."""
    fills = [t.get("bucket_fill") for t in ranks
             if t.get("bucket_fill") is not None]

    def total(key):
        return sum(int(t.get(key) or 0) for t in ranks)

    return {
        "sentences_done_total": total("sentences_done_total"),
        "input_sentences": total("input_sentences"),
        "sentences_per_sec_total": round(sum(
            float(t.get("sentences_per_sec") or 0.0) for t in ranks), 1),
        "shards_committed_total": total("shards_committed_total"),
        "shards_skipped_total": total("shards_skipped_total"),
        "post_warmup_compiles_total": total("post_warmup_compiles_total"),
        "bucket_fill_min": min(fills) if fills else None,
        "producer_wait_seconds_max": max(
            float(t.get("producer_wait_seconds") or 0.0) for t in ranks),
    }


def merge_training_snapshots(
    snaps: Dict[int, Optional[dict]],
    *,
    generation: Optional[int] = None,
    num_workers: Optional[int] = None,
) -> dict:
    """One gang document from per-rank heartbeat snapshots. ``snaps``
    maps rank to snapshot (None: no current-generation heartbeat yet);
    a snapshot stamped with another ``supervisor_generation`` than
    ``generation`` is dropped."""
    live: Dict[int, dict] = {}
    for rank, snap in snaps.items():
        if snap is None:
            continue
        gen = snap.get("supervisor_generation")
        if generation is not None and gen is not None and int(gen) != generation:
            continue
        live[int(rank)] = snap

    counters = {out: 0 for out, _ in _SUM_COUNTERS}
    counters.update(canary_trips_total=0, events_recorded_total=0,
                    events_dropped_total=0)
    shard_write_max = None
    transform_ranks: List[dict] = []
    per_rank: Dict[str, dict] = {}
    wps_total = 0.0
    step_means: List[float] = []
    phase_acc = {p: {"seconds": 0.0, "count": 0, "hists": []}
                 for p in LEDGER_PHASES}
    states = []
    for rank in sorted(live):
        snap = live[rank]
        states.append(snap.get("state", "unknown"))
        for out, key in _SUM_COUNTERS:
            counters[out] += int(snap.get(key) or 0)
        counters["canary_trips_total"] += int(
            (snap.get("canary") or {}).get("trips") or 0)
        ev = snap.get("events") or {}
        counters["events_recorded_total"] += int(ev.get("recorded") or 0)
        counters["events_dropped_total"] += int(ev.get("dropped") or 0)
        v = snap.get("checkpoint_shard_write_seconds")
        if v is not None:
            shard_write_max = max(shard_write_max or 0.0, v)
        if snap.get("transform"):
            transform_ranks.append(snap["transform"])
        wps = float(snap.get("words_per_sec_rolling") or 0.0)
        wps_total += wps
        ms = _mean_step_seconds(snap)
        if ms is not None:
            step_means.append(ms)
        per_rank[str(rank)] = {
            "state": snap.get("state"),
            "epoch": snap.get("epoch"),
            "step": snap.get("step") or 0,
            "words_done": snap.get("words_done") or 0,
            "words_per_sec_rolling": wps,
            "mean_step_seconds": round(ms, 6) if ms is not None else None,
            "host_frac": snap.get("host_frac"),
            "last_loss": snap.get("last_loss"),
            "uptime_seconds": snap.get("uptime_seconds"),
            "device_stall_seconds": snap.get("device_stall_seconds"),
            "exchange_syncs_total": snap.get("exchange_syncs_total"),
            "exchange_bytes_total": snap.get("exchange_bytes_total"),
            "exchange_capacity": snap.get("exchange_capacity"),
        }
        st = (snap.get("steptime") or {}).get("phases") or {}
        for p in LEDGER_PHASES:
            info = st.get(p)
            if not info:
                continue
            phase_acc[p]["seconds"] += float(info.get("seconds") or 0.0)
            phase_acc[p]["count"] += int(info.get("count") or 0)
            if info.get("hist"):
                phase_acc[p]["hists"].append(info["hist"])

    rank_skew = None
    if step_means:
        med = statistics.median(step_means)
        if med > 0:
            rank_skew = round(max(step_means) / med, 4)

    if not states:
        gang_state = "starting"
    elif any(s in _BAD_STATES for s in states):
        gang_state = next(s for s in states if s in _BAD_STATES)
    elif all(s == "done" for s in states):
        gang_state = "done"
    else:
        gang_state = "running"

    steptime = {}
    for p in LEDGER_PHASES:
        acc = phase_acc[p]
        entry = {"seconds": round(acc["seconds"], 4), "count": acc["count"]}
        if acc["hists"]:
            h = LatencyHistogram.merge(acc["hists"])
            entry.update(
                p50_ms=round(h.quantile(0.50) * 1e3, 3),
                p95_ms=round(h.quantile(0.95) * 1e3, 3),
                p99_ms=round(h.quantile(0.99) * 1e3, 3),
                span_seconds=round(h.total, 4),
            )
        steptime[p] = entry

    out = {
        "generation": generation,
        "num_workers": num_workers if num_workers is not None else len(snaps),
        "ranks_reporting": len(live),
        "state": gang_state,
        "counters": counters,
        "words_per_sec_total": round(wps_total, 1),
        "rank_skew": rank_skew,
        "checkpoint_shard_write_seconds_max": shard_write_max,
        "per_rank": per_rank,
        "steptime": steptime,
    }
    if transform_ranks:
        out["transform"] = _merge_transform(transform_ranks)
    return out


class GangStatusServer:
    """Merged gang ``/metrics`` and ``/healthz`` for the supervisor.

    The supervisor feeds it each liveness sweep through :meth:`update`;
    a request serves the merge of the latest sweep.

      GET /healthz                   -> gang state (200, or 503 when a
                                        rank is diverged/failed/unhealthy)
      GET /metrics                   -> merged gang JSON
      GET /metrics?format=prometheus -> the gang exposition
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 num_workers: int = 1):
        from glint_word2vec_torch.obs.prometheus import gang_to_prometheus

        self.num_workers = int(num_workers)
        self._mu = threading.Lock()
        self._generation = 0
        self._snaps: Dict[int, Optional[dict]] = {}
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                logger.debug("gang-metrics: " + fmt, *args)

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/healthz":
                    merged = server.merged()
                    ok = merged["state"] not in _BAD_STATES
                    body = json.dumps({
                        "status": "ok" if ok else merged["state"],
                        "state": merged["state"],
                        "generation": merged["generation"],
                        "num_workers": merged["num_workers"],
                        "ranks_reporting": merged["ranks_reporting"],
                        "words_per_sec_total": merged["words_per_sec_total"],
                        "rank_skew": merged["rank_skew"],
                    }).encode()
                    self._send(200 if ok else 503, body, "application/json")
                elif url.path == "/metrics":
                    merged = server.merged()
                    fmt = parse_qs(url.query).get("format", ["json"])[0]
                    if fmt == "prometheus":
                        self._send(200, gang_to_prometheus(merged).encode(),
                                   "text/plain; version=0.0.4; charset=utf-8")
                    else:
                        self._send(200, json.dumps(merged).encode(),
                                   "application/json")
                else:
                    self._send(404, json.dumps(
                        {"error": f"no route {url.path}"}).encode(),
                        "application/json")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def update(self, generation: int, snaps: Dict[int, Optional[dict]]) -> None:
        """Install the latest sweep's per-rank snapshots (already
        generation-filtered by the supervisor's reader)."""
        with self._mu:
            self._generation = int(generation)
            self._snaps = dict(snaps)

    def merged(self) -> dict:
        with self._mu:
            gen, snaps = self._generation, dict(self._snaps)
        return merge_training_snapshots(snaps, generation=gen,
                                        num_workers=self.num_workers)

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="glint-gang-metrics",
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
