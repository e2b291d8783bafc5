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

- :func:`merge_serving_snapshots` does the same for serving replicas:
  latency histograms merge bucket for bucket and counters sum, per model
  and for the catalog too, into one document of the shape of one
  replica's ``/metrics``, so ``serving_to_prometheus`` renders a fleet.

- :func:`merge_trace_logs` stitches per-process request-trace files (a
  fleet's ``--trace-dir``, or any set of ``--trace-log`` and
  ``--event-log`` files) into one Chrome-trace / Perfetto timeline.
- :class:`GangStatusServer` joins serving replicas into the gang view by
  URL (``supervise --join-serving``): their JSON snapshots are scraped on
  each request and merged, a replica that does not answer reported.

Nothing here reads a device: it runs in the supervisor or balancer
process, which leaves the cards to the workers.
"""

from __future__ import annotations

import json
import logging
import os
import statistics
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterable, List, Optional
from urllib.parse import parse_qs, urlparse

from glint_word2vec_torch.obs.slo import merge_slo_snapshots
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
    # Shard-checkpoint seconds fold to the slowest rank.
    shard_write_max = None
    shard_verify_max = None
    transform_ranks: List[dict] = []
    slo_snaps: List[dict] = []
    steptime_trace_id = None
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
        v = snap.get("checkpoint_shard_verify_seconds")
        if v is not None:
            shard_verify_max = max(shard_verify_max or 0.0, v)
        if snap.get("transform"):
            transform_ranks.append(snap["transform"])
        if snap.get("slo"):
            slo_snaps.append(snap["slo"])
        if steptime_trace_id is None:
            # The supervisor mints one id a launch generation, so the
            # first rank's that carries one is the gang's.
            steptime_trace_id = (snap.get("steptime") or {}).get("trace_id")
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
        "checkpoint_shard_verify_seconds_max": shard_verify_max,
        "per_rank": per_rank,
        "steptime": steptime,
        "steptime_trace_id": steptime_trace_id,
    }
    if transform_ranks:
        out["transform"] = _merge_transform(transform_ranks)
    slo = merge_slo_snapshots(slo_snaps)
    if slo is not None:
        out["slo"] = slo
    return out


def merge_serving_snapshots(snaps: Iterable[dict]) -> Optional[dict]:
    """Merge serving-replica ``ServingMetrics.snapshot`` documents into
    one with the identical shape, so ``serving_to_prometheus`` renders a
    whole replica fleet with no second code path. Latency histograms
    merge bucket-exactly when snapshots carry ``hist`` state (this
    repo's do); a hist-less legacy snapshot degrades that endpoint's
    quantiles to the max across replicas (conservative, flagged via
    ``"approx": true``). The port's ``kernel_launches`` and
    ``kernel_launches_warmup`` blocks (each replica's launch counts) sum by
    kernel. Returns None for an empty
    input."""
    snaps = [s for s in snaps if s]
    if not snaps:
        return None
    endpoints: Dict[str, dict] = {}
    ep_hists: Dict[str, list] = {}
    for s in snaps:
        for path, ep in (s.get("endpoints") or {}).items():
            agg = endpoints.setdefault(path, {
                "count": 0, "errors": 0, "p50_ms": 0.0, "p95_ms": 0.0,
                "p99_ms": 0.0, "mean_ms": 0.0, "max_ms": 0.0,
                "_total_ms": 0.0,
            })
            agg["count"] += int(ep.get("count") or 0)
            agg["errors"] += int(ep.get("errors") or 0)
            agg["max_ms"] = max(agg["max_ms"], float(ep.get("max_ms") or 0.0))
            agg["_total_ms"] += (
                float(ep.get("mean_ms") or 0.0) * int(ep.get("count") or 0)
            )
            # Max-fold EVERY replica's quantiles (the approx fallback
            # must cover the whole fleet, hist-carrying replicas
            # included — dropping a slow replica's p99 because its peer
            # is legacy would hide the straggler); the exact merge
            # below overwrites when every replica carried hist state.
            for q in ("p50_ms", "p95_ms", "p99_ms"):
                agg[q] = max(agg[q], float(ep.get(q) or 0.0))
            if ep.get("hist"):
                ep_hists.setdefault(path, []).append(ep["hist"])
            else:
                agg["approx"] = True
    for path, agg in endpoints.items():
        hists = ep_hists.get(path)
        if hists and not agg.get("approx"):
            h = LatencyHistogram.merge(hists)
            agg.update(
                p50_ms=round(h.quantile(0.50) * 1e3, 3),
                p95_ms=round(h.quantile(0.95) * 1e3, 3),
                p99_ms=round(h.quantile(0.99) * 1e3, 3),
                hist=h.state(),
            )
        agg["mean_ms"] = round(
            agg.pop("_total_ms") / max(agg["count"], 1), 3
        )

    batches: Dict[str, int] = {}
    cache = {"hits": 0, "misses": 0}
    over = {
        "shed_admission_total": 0, "shed_degraded_total": 0,
        "deadline_504_total": 0, "degraded_entered_total": 0,
        "inflight_peak": 0,
    }
    compiles = {"total": 0, "warmup": 0, "post_warmup": 0}
    ck = {
        "pending_async_saves": 0,
        "last_checkpoint_age_seconds": None,
        "checkpoint_write_seconds": None,
    }
    # Hot-swap block: counters sum; the swap age folds
    # to the STALEST replica (the one a rolling rollout left behind is
    # the actionable number); the generation is the fleet's only when
    # every replica serves the same one — "mixed" is itself signal (a
    # rollout in flight, or a halted one).
    swap = {
        "table_swaps_total": 0,
        "swap_failures_total": 0,
        "watch_errors_total": 0,
        "last_swap_age_seconds": None,
        "generation": None,
    }
    swap_gens = set()
    # ANN index block: counters sum; the recall and its
    # gate fold to the WORST replica (min recall, all-gates-pass) —
    # the actionable fleet numbers; ages/staleness fold to the
    # stalest.
    index = {
        "enabled": False,
        "replicas_with_index": 0,
        "clusters": None,
        "member_slots": None,
        "nprobe": None,
        "build_seconds": None,
        "last_refresh_age_seconds": None,
        "refreshes_total": 0,
        "recall_at10": None,
        "recall_gate_ok": None,
        "recall_gate_threshold": None,
        "ann_queries_total": 0,
        "probes_total": 0,
        "probes_per_query": None,
        "exact_fallbacks": {},
        "table_versions_behind": None,
    }
    for s in snaps:
        for size, n in (s.get("coalesced_batch_sizes") or {}).items():
            batches[size] = batches.get(size, 0) + int(n)
        c = s.get("synonym_cache") or {}
        cache["hits"] += int(c.get("hits") or 0)
        cache["misses"] += int(c.get("misses") or 0)
        o = s.get("overload") or {}
        for k in over:
            v = int(o.get(k) or 0)
            if k == "inflight_peak":
                over[k] = max(over[k], v)
            else:
                over[k] += v
        comp = s.get("compiles") or {}
        for k in compiles:
            compiles[k] += int(comp.get(k) or 0)
        hs = s.get("hot_swap") or {}
        for k in ("table_swaps_total", "swap_failures_total",
                  "watch_errors_total"):
            swap[k] += int(hs.get(k) or 0)
        v = hs.get("last_swap_age_seconds")
        if v is not None:
            swap["last_swap_age_seconds"] = (
                v if swap["last_swap_age_seconds"] is None
                else max(swap["last_swap_age_seconds"], v)
            )
        swap_gens.add(hs.get("generation"))
        sck = s.get("checkpoint") or {}
        ck["pending_async_saves"] += int(sck.get("pending_async_saves") or 0)
        for k in ("last_checkpoint_age_seconds",
                  "checkpoint_write_seconds"):
            v = sck.get(k)
            if v is not None:
                # Worst (largest) across replicas: the stalest
                # checkpoint and the slowest write are the actionable
                # fleet numbers.
                ck[k] = v if ck[k] is None else max(ck[k], v)
        si = s.get("index") or {}
        if si.get("enabled"):
            index["enabled"] = True
            index["replicas_with_index"] += 1
            for k in ("clusters", "member_slots", "nprobe",
                      "recall_gate_threshold"):
                if si.get(k) is not None:
                    index[k] = si[k]
            index["refreshes_total"] += int(si.get("refreshes_total") or 0)
            index["ann_queries_total"] += int(
                si.get("ann_queries_total") or 0
            )
            index["probes_total"] += int(si.get("probes_total") or 0)
            for reason, n in (si.get("exact_fallbacks") or {}).items():
                index["exact_fallbacks"][reason] = (
                    index["exact_fallbacks"].get(reason, 0) + int(n)
                )
            r = si.get("recall_at10")
            if r is not None:
                index["recall_at10"] = (
                    r if index["recall_at10"] is None
                    else min(index["recall_at10"], r)
                )
            g = si.get("recall_gate_ok")
            if g is not None:
                index["recall_gate_ok"] = (
                    bool(g) if index["recall_gate_ok"] is None
                    else (index["recall_gate_ok"] and bool(g))
                )
            for k in ("build_seconds", "last_refresh_age_seconds",
                      "table_versions_behind"):
                v = si.get(k)
                if v is not None:
                    index[k] = (
                        v if index[k] is None else max(index[k], v)
                    )
    if index["ann_queries_total"]:
        index["probes_per_query"] = round(
            index["probes_total"] / index["ann_queries_total"], 2
        )
    if len(swap_gens) == 1:
        swap["generation"] = next(iter(swap_gens))
    elif swap_gens:
        swap["generation"] = "mixed"
    # Per-model blocks: group each catalog model's
    # snapshots by id across replicas and fold every group through
    # THIS function (a per-model snapshot nests no further models, so
    # the recursion is exactly one level deep). The residency extras
    # fold additively — "resident_replicas" becomes the fleet-wide
    # count of replicas holding that model's tables on device.
    by_model: Dict[str, list] = {}
    for s in snaps:
        for mid, ms in (s.get("models") or {}).items():
            by_model.setdefault(mid, []).append(ms)
    models = {}
    for mid in sorted(by_model):
        group = by_model[mid]
        m = merge_serving_snapshots(group)
        m["model_id"] = mid
        m["resident_replicas"] = sum(
            int(g.get("resident_replicas") or 0) for g in group
        )
        m["resident"] = m["resident_replicas"] > 0
        m["pinned"] = any(g.get("pinned") for g in group)
        for k in ("resident_bytes", "stage_ins_total",
                  "evictions_total"):
            m[k] = sum(int(g.get(k) or 0) for g in group)
        models[mid] = m
    # Catalog block: LRU churn counters sum across replicas; the
    # membership/budget numbers are per-replica configuration, folded
    # to the max so a heterogeneous fleet surfaces its largest shape.
    catalog = None
    cat_snaps = [s.get("catalog") for s in snaps if s.get("catalog")]
    if cat_snaps:
        catalog = {
            "replicas": len(cat_snaps),
            "default_model": cat_snaps[0].get("default_model"),
            "models": max(
                int(c.get("models") or 0) for c in cat_snaps
            ),
            "resident_models": sum(
                int(c.get("resident_models") or 0) for c in cat_snaps
            ),
            "budget_bytes": max(
                (int(c["budget_bytes"]) for c in cat_snaps
                 if c.get("budget_bytes") is not None),
                default=None,
            ),
            "stage_in_seconds_total": round(sum(
                float(c.get("stage_in_seconds_total") or 0.0)
                for c in cat_snaps
            ), 3),
        }
        for k in ("evictions_total", "stage_ins_total",
                  "cold_hits_total", "resident_bytes",
                  "query_program_builds", "shared_program_hits"):
            catalog[k] = sum(int(c.get(k) or 0) for c in cat_snaps)
    out = {
        "replicas": len(snaps),
        "endpoints": {p: endpoints[p] for p in sorted(endpoints)},
        "coalesced_batch_sizes": {
            k: batches[k] for k in sorted(batches, key=int)
        },
        "synonym_cache": cache,
        "overload": over,
        "compiles": compiles,
        "hot_swap": swap,
        "checkpoint": ck,
        "index": index,
        # Fleet SLO view: window counts sum exactly, burn
        # rates re-derived from the sums — a replica restart never
        # corrupts the merged error budget.
        "slo": merge_slo_snapshots([s.get("slo") for s in snaps]),
    }
    if models:
        out["models"] = models
    if catalog is not None:
        out["catalog"] = catalog
    for block in ("kernel_launches", "kernel_launches_warmup"):
        launches: Dict[str, int] = {}
        for s in snaps:
            for name, n in (s.get(block) or {}).items():
                launches[name] = launches.get(name, 0) + int(n or 0)
        if launches:
            out[block] = {k: launches[k] for k in sorted(launches)}
    return out


def merge_trace_logs(paths: Iterable[str]) -> dict:
    """Stitch per-process ``EventRecorder`` JSONL rings into ONE
    clock-anchored Chrome-trace / Perfetto document.

    Each sink's events carry ``ts`` microseconds on that process's OWN
    monotonic clock; its leading ``clock_anchor`` metadata line records
    the ``(mono_t0, wall_t0)`` pair mapping ts=0 back to the epoch.
    The merge rebases every file onto the earliest ``wall_t0`` across
    inputs, so spans from the balancer, every replica, and a training
    gang land on one shared timeline — a stitched request reads
    balancer ``req.accept`` -> replica ``req.accept`` ->
    ``req.dispatch`` left to right in Perfetto.

    Per-process lanes are named after the source file
    (``process_name`` metadata); a missing file or a torn trailing
    line (a crash mid-write) is skipped and reported in
    ``otherData.sources``, never fatal. ``otherData.stitched_traces``
    counts trace ids seen in more than one process (nonzero for a
    traced fleet that served a request).
    """
    events: List[dict] = []
    sources: Dict[str, str] = {}
    anchors: Dict[str, dict] = {}
    per_file: List[tuple] = []
    base_wall = None
    for path in paths:
        name = os.path.basename(path)
        if name.endswith(".jsonl"):
            name = name[: -len(".jsonl")]
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError as e:
            sources[str(path)] = f"error: {e}"
            continue
        anchor = None
        evs = []
        bad = 0
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                bad += 1  # torn trailing line from a crashed writer
                continue
            if ev.get("name") == "clock_anchor" and ev.get("ph") == "M":
                if anchor is None:
                    anchor = ev.get("args") or {}
                continue
            evs.append(ev)
        if anchor is None or anchor.get("wall_t0") is None:
            sources[str(path)] = "error: no clock_anchor line"
            continue
        sources[str(path)] = (
            "ok" if not bad else f"ok ({bad} torn line(s) skipped)"
        )
        anchors[name] = anchor
        wall = float(anchor["wall_t0"])
        base_wall = wall if base_wall is None else min(base_wall, wall)
        per_file.append((name, wall, evs))
    trace_pids: Dict[str, set] = {}
    for name, wall, evs in per_file:
        offset_us = (wall - base_wall) * 1e6
        pid = evs[0].get("pid") if evs else None
        for ev in evs:
            ev = dict(ev)
            ev["ts"] = round(float(ev.get("ts") or 0.0) + offset_us, 1)
            events.append(ev)
            tid = (ev.get("args") or {}).get("trace")
            if tid:
                trace_pids.setdefault(tid, set()).add(name)
        if pid is not None:
            events.append({
                "name": "process_name", "ph": "M", "ts": 0,
                "pid": pid, "args": {"name": name},
            })
    events.sort(key=lambda e: (e.get("ts") or 0.0))
    stitched = sum(1 for pids in trace_pids.values() if len(pids) > 1)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "wall_t0": base_wall,
            "sources": sources,
            "anchors": anchors,
            "trace_ids": len(trace_pids),
            "stitched_traces": stitched,
        },
    }


class GangStatusServer:
    """Merged gang ``/metrics`` and ``/healthz`` for the supervisor.

    The supervisor feeds it each liveness sweep through :meth:`update`;
    a request serves the merge of the latest sweep. ``serving_urls`` are
    scraped on each request (2 s each; a failure is reported in
    ``serving_sources``, never fails the scrape) and merged into one
    ``serving`` section.

      GET /healthz                   -> gang state (200, or 503 when a
                                        rank is diverged/failed/unhealthy)
      GET /metrics                   -> merged gang JSON (and "serving")
      GET /metrics?format=prometheus -> the gang exposition, and the
                                        serving fleet's when joined
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 num_workers: int = 1,
                 serving_urls: Optional[List[str]] = None):
        from glint_word2vec_torch.obs.prometheus import (
            gang_to_prometheus,
            serving_to_prometheus,
        )

        self.num_workers = int(num_workers)
        self.serving_urls = list(serving_urls or [])
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
                    merged = server.merged(include_serving=False)
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
                        text = gang_to_prometheus(merged)
                        if merged.get("serving"):
                            text += serving_to_prometheus(merged["serving"])
                        self._send(200, text.encode(),
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

    def merged(self, include_serving: bool = True) -> dict:
        with self._mu:
            gen, snaps = self._generation, dict(self._snaps)
        merged = merge_training_snapshots(snaps, generation=gen,
                                          num_workers=self.num_workers)
        if include_serving and self.serving_urls:
            serving, sources = self._scrape_serving()
            merged["serving"] = serving
            merged["serving_sources"] = sources
            # The replicas' merged SLO view beside the gang's, so the gang
            # exposition renders one glint_gang_slo_* family set.
            slo = merge_slo_snapshots([
                merged.get("slo"), (serving or {}).get("slo"),
            ])
            if slo is not None:
                merged["slo"] = slo
        return merged

    def _scrape_serving(self):
        """Each joined serving replica's JSON ``/metrics`` snapshot. A
        replica that does not answer is reported, never fatal: the gang
        view stays up while a replica restarts."""
        snaps, sources = [], {}
        for url in self.serving_urls:
            try:
                with urllib.request.urlopen(url, timeout=2.0) as r:
                    snaps.append(json.loads(r.read().decode()))
                sources[url] = "ok"
            except Exception as e:  # URLError, timeout, bad JSON
                sources[url] = f"error: {e}"
        return merge_serving_snapshots(snaps), sources

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="glint-gang-metrics",
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
