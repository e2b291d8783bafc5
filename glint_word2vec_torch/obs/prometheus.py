"""Prometheus text exposition (format version 0.0.4) of the training
heartbeat's, the server's and the fleet balancer's snapshots (copy of
``glint_word2vec_tpu/obs/prometheus.py``).

Pure functions dict -> text, so the heartbeat and the server render
``/metrics?format=prometheus`` from the same snapshot their JSON endpoint
serves. The metric families and their labels are the JAX package's,
including the replica-exchange ones, which a one-device fit reports as
0 or NaN. :func:`gang_to_prometheus` renders the supervisor's merged
gang view (``obs/aggregate.py``) and :func:`serving_to_prometheus` a
``ServingMetrics`` snapshot, with OpenMetrics exemplars naming kept
request traces; its per-model and catalog blocks render only when the
snapshot carries them. :func:`fleet_to_prometheus` renders a fleet
balancer's document (replicas, breakers, supervisor, rollout and canary).
Also :func:`lint_prometheus_text`, the validator the tests run over every
rendered exposition.
"""

from __future__ import annotations

import math
import re
from typing import Optional


def _esc(v) -> str:
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _num(v) -> str:
    if v is None:
        return "NaN"
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


class _Prom:
    """Tiny exposition writer: HELP/TYPE heads + sample lines."""

    def __init__(self):
        self.lines = []

    def head(self, name: str, mtype: str, help_: str) -> None:
        self.lines.append(f"# HELP {name} {help_}")
        self.lines.append(f"# TYPE {name} {mtype}")

    def sample(self, name: str, labels, value, exemplar=None) -> None:
        if labels:
            lab = ",".join(f'{k}="{_esc(v)}"' for k, v in labels.items())
            line = f"{name}{{{lab}}} {_num(value)}"
        else:
            line = f"{name} {_num(value)}"
        if exemplar and exemplar.get("trace_id"):
            # OpenMetrics-style exemplar suffix: a trace id pinned to
            # one recent observation, so a dashboard quantile links
            # straight to the trace that produced it.
            line += (
                f' # {{trace_id="{_esc(exemplar["trace_id"])}"}}'
                f' {_num(exemplar.get("value"))}'
            )
        self.lines.append(line)


    def text(self) -> str:
        return "\n".join(self.lines) + "\n"


#: Each renderer's help text for its eight SLO families, in the order
#: :func:`_slo_families` writes them (the JAX package's words, so the
#: expositions match it byte for byte).
_SLO_HELP = {
    "glint_training_slo": (
        "Availability objective (success-ratio target) per tracked "
        "endpoint.",
        "Latency objective (fraction of good requests under the "
        "threshold) per tracked endpoint.",
        "Latency SLI threshold in milliseconds per endpoint.",
        "Requests observed in each rolling SLO window.",
        "SLI-violating requests in each rolling window, by SLI "
        "(availability = 5xx; latency = slower than threshold).",
        "Error-budget burn rate per SLI and window (1.0 = burning exactly "
        "the budget).",
        "Multi-window fast-burn alert (5m AND 1h over 14.4x): "
        "page-severity budget burn.",
        "Multi-window slow-burn alert (30m AND 6h over 6x): "
        "ticket-severity budget burn.",
    ),
    "glint_gang_slo": (
        "Availability objective (success-ratio target) per tracked "
        "endpoint, fleet-merged view.",
        "Latency objective (fraction of good requests under the "
        "threshold) per tracked endpoint, fleet-merged view.",
        "Latency SLI threshold in milliseconds per endpoint.",
        "Requests observed in each rolling SLO window, summed over "
        "replicas.",
        "SLI-violating requests in each rolling window, by SLI, summed "
        "over replicas.",
        "Error-budget burn rate per SLI and window over the merged fleet "
        "traffic (1.0 = burning exactly the budget).",
        "Fleet-level multi-window fast-burn alert (5m AND 1h over 14.4x).",
        "Fleet-level multi-window slow-burn alert (30m AND 6h over 6x).",
    ),
    "glint_slo": (
        "Availability objective (success-ratio target) per tracked "
        "endpoint.",
        "Latency objective (fraction of good requests under the "
        "threshold) per tracked endpoint.",
        "Latency SLI threshold in milliseconds per endpoint.",
        "Requests observed in each rolling SLO window.",
        "SLI-violating requests in each rolling window, by SLI "
        "(availability = 5xx; latency = slower than threshold).",
        "Error-budget burn rate per SLI and window (1.0 = burning exactly "
        "the budget; 14.4 = the fast-burn page threshold).",
        "Multi-window fast-burn alert (5m AND 1h windows both over "
        "14.4x): page-severity budget burn.",
        "Multi-window slow-burn alert (30m AND 6h windows both over 6x): "
        "ticket-severity budget burn.",
    ),
}


def _slo_families(p: _Prom, prefix: str, slo: Optional[dict]) -> None:
    """The eight SLO burn-rate families of one ``obs/slo.SloEngine``
    snapshot (objectives, rolling-window counts, burn rates and alerts),
    named ``<prefix>_*`` so that concatenated scrapes stay family
    disjoint. Nothing is written without a snapshot."""
    if not slo:
        return
    eps = slo.get("endpoints") or {}
    (h_avail, h_lat, h_thr, h_req, h_bad, h_burn, h_fast,
     h_slow) = _SLO_HELP[prefix]
    for suffix, key, help_ in (
            ("availability_target", "availability_target", h_avail),
            ("latency_target", "latency_target", h_lat),
            ("latency_threshold_ms", "latency_threshold_ms", h_thr)):
        p.head(f"{prefix}_{suffix}", "gauge", help_)
        for ep, doc in eps.items():
            p.sample(f"{prefix}_{suffix}", {"endpoint": ep}, doc.get(key))
    p.head(f"{prefix}_window_requests", "gauge", h_req)
    for ep, doc in eps.items():
        for win, w in (doc.get("windows") or {}).items():
            p.sample(f"{prefix}_window_requests",
                     {"endpoint": ep, "window": win}, w.get("total", 0))
    p.head(f"{prefix}_window_bad", "gauge", h_bad)
    for ep, doc in eps.items():
        for win, w in (doc.get("windows") or {}).items():
            for sli in ("availability", "latency"):
                p.sample(f"{prefix}_window_bad",
                         {"endpoint": ep, "sli": sli, "window": win},
                         w.get(f"bad_{sli}", 0))
    p.head(f"{prefix}_burn_rate", "gauge", h_burn)
    for ep, doc in eps.items():
        burns = doc.get("burn_rates") or {}
        for sli in ("availability", "latency"):
            for win, rate in (burns.get(sli) or {}).items():
                p.sample(f"{prefix}_burn_rate",
                         {"endpoint": ep, "sli": sli, "window": win}, rate)
    for alert, help_ in (("fast_burn", h_fast), ("slow_burn", h_slow)):
        p.head(f"{prefix}_{alert}", "gauge", help_)
        for ep, doc in eps.items():
            p.sample(f"{prefix}_{alert}", {"endpoint": ep},
                     1 if (doc.get("alerts") or {}).get(alert) else 0)


# ----------------------------------------------------------------------
# Training heartbeat exposition (obs/heartbeat.TrainingStatus.snapshot)
# ----------------------------------------------------------------------


def training_to_prometheus(snap: dict) -> str:
    """Render a TrainingStatus snapshot as scrape-ready text."""
    p = _Prom()
    p.head("glint_training_info", "gauge",
           "Run metadata carried as labels; value is always 1.")
    p.sample("glint_training_info",
             {"pipeline": snap.get("pipeline", ""),
              "state": snap.get("state", "")}, 1)
    gauges = [
        ("glint_training_epoch", "epoch", "Current epoch (0-based)."),
        ("glint_training_total_epochs", "total_epochs",
         "Configured epoch count."),
        ("glint_training_words_per_sec", "words_per_sec_rolling",
         "Rolling trained-words/sec over the recent update window."),
        ("glint_training_alpha", "alpha", "Current annealed learning rate."),
        ("glint_training_last_loss", "last_loss",
         "Most recently synced per-step loss (NaN until first sync)."),
        ("glint_training_host_frac", "host_frac",
         "Fraction of accounted wall time spent in host batching."),
        ("glint_training_device_stall_seconds", "device_stall_seconds",
         "Host-side dispatch-starvation proxy: blocking checkpoint "
         "saves + batch-producer waits + compaction syncs."),
        ("glint_training_pending_async_saves", "pending_async_saves",
         "Async checkpoint snapshots currently in flight (0 or 1)."),
        ("glint_training_checkpoint_write_seconds",
         "checkpoint_write_seconds",
         "Wall seconds of the most recent checkpoint write job."),
        ("glint_training_last_checkpoint_age_seconds",
         "last_checkpoint_age_seconds",
         "Seconds since the last committed checkpoint (NaN before any)."),
        ("glint_training_checkpoint_shard_write_seconds",
         "checkpoint_shard_write_seconds",
         "Seconds writing+hashing table shard blocks in the most "
         "recent checkpoint save (shard-streaming path, NaN before "
         "any)."),
        ("glint_training_checkpoint_shard_verify_seconds",
         "checkpoint_shard_verify_seconds",
         "Seconds verifying per-shard manifests in the most recent "
         "checkpoint stage/restore (NaN before any)."),
        ("glint_training_exchange_capacity", "exchange_capacity",
         "Live touched-row exchange buffer capacity (adapts from the "
         "observed high-water mark unless pinned; NaN before any "
         "exchange round)."),
        ("glint_training_exchange_residual_abs", "exchange_residual_abs",
         "Max-abs of the int8 error-feedback residual carry after the "
         "latest encode (0 on exact wires and right after a flush)."),
        ("glint_training_uptime_seconds", "uptime_seconds",
         "Seconds since the fit's observability run started."),
        ("glint_training_table_version", "table_version",
         "Engine table-mutation counter (serving caches validate on it)."),
        ("glint_training_supervisor_generation", "supervisor_generation",
         "Supervisor launch generation echoed by the worker (NaN when "
         "the fit is unsupervised)."),
        ("glint_training_diverged", None,
         "1 when the divergence canary aborted the run, else 0."),
    ]
    for name, key, help_ in gauges:
        p.head(name, "gauge", help_)
        if key is None:
            p.sample(name, None, 1 if snap.get("state") == "diverged" else 0)
        else:
            p.sample(name, None, snap.get(key))
    counters = [
        ("glint_training_steps_total", "step", "Optimizer steps completed."),
        ("glint_training_words_done_total", "words_done",
         "Trained words (pre-subsampling accounting)."),
        ("glint_training_query_compiles_total", "query_compiles",
         "Query-op shapes jit-compiled by the engine."),
        ("glint_training_async_save_waits_total", "async_save_waits",
         "Checkpoint requests that blocked on a still-in-flight "
         "snapshot (checkpoint back-pressure)."),
        ("glint_training_exchange_bytes_total", "exchange_bytes_total",
         "Replica-exchange bytes this rank shipped (headers + padded "
         "id/delta buffers, or full deltas on dense/spill rounds)."),
        ("glint_training_exchange_rows_total", "exchange_rows_total",
         "Touched table rows this rank harvested into exchange "
         "payloads (pre-padding, both tables)."),
        ("glint_training_exchange_overflow_total",
         "exchange_overflow_total",
         "Exchange rounds whose touched rows overflowed the capacity "
         "buffer and spilled to the dense path."),
        ("glint_training_exchange_syncs_total", "exchange_syncs_total",
         "Replica-exchange reconciliation rounds completed."),
        ("glint_training_exchange_bytes_wire_fp32_total",
         "exchange_bytes_wire_fp32_total",
         "Exchange bytes shipped on fp32-encoded rounds (exact sparse "
         "wire, plus every dense/spill/flush round)."),
        ("glint_training_exchange_bytes_wire_bf16_total",
         "exchange_bytes_wire_bf16_total",
         "Exchange bytes shipped on bf16-encoded sparse rounds."),
        ("glint_training_exchange_bytes_wire_int8_total",
         "exchange_bytes_wire_int8_total",
         "Exchange bytes shipped on int8-encoded sparse rounds "
         "(per-row maxabs scales + error feedback)."),
        ("glint_training_exchange_groups_total",
         "exchange_groups_total",
         "Dispatch groups folded into exchange rounds (> syncs when "
         "round coalescing accumulates several groups per round)."),
        ("glint_training_exchange_flushes_total",
         "exchange_flushes_total",
         "Checkpoint flush rounds (error-feedback carry drained "
         "through an exact fp32 wire round)."),
        ("glint_training_exchange_world1_skips_total",
         "exchange_world1_skips_total",
         "Exchange rounds short-circuited at world=1 (no wire, zero "
         "bytes)."),
        ("glint_training_exchange_intra_bytes_total",
         "exchange_intra_bytes_total",
         "Two-level exchange bytes attributed to the fast intra-node "
         "hop (exact fp32 local payloads)."),
        ("glint_training_exchange_inter_bytes_total",
         "exchange_inter_bytes_total",
         "Exchange bytes attributed to the slow inter-node hop "
         "(leaders-only quantized node payloads under the two-level "
         "topology; every byte of a flat round)."),
        ("glint_training_exchange_capacity_grows_total",
         "exchange_capacity_grows_total",
         "Adaptive capacity grow events (after an overflow spill)."),
        ("glint_training_exchange_capacity_shrinks_total",
         "exchange_capacity_shrinks_total",
         "Adaptive capacity shrink events (rolling high-water mark "
         "with 2x headroom hysteresis)."),
        ("glint_training_checkpoint_shards_skipped_total",
         "checkpoint_shards_skipped",
         "In-place checkpoint shard writes skipped because the shard "
         "was clean since the last committed save."),
    ]
    for name, key, help_ in counters:
        p.head(name, "counter", help_)
        p.sample(name, None, snap.get(key, 0))
    canary = snap.get("canary") or {}
    p.head("glint_canary_trips_total", "counter",
           "Divergence-canary trips this run.")
    p.sample("glint_canary_trips_total", None, canary.get("trips", 0))
    events = snap.get("events") or {}
    if events:
        p.head("glint_obs_events_recorded_total", "counter",
               "Span/instant events recorded by the event ring.")
        p.sample("glint_obs_events_recorded_total", None,
                 events.get("recorded", 0))
        p.head("glint_obs_events_dropped_total", "counter",
               "Events evicted from the bounded ring.")
        p.sample("glint_obs_events_dropped_total", None,
                 events.get("dropped", 0))
    steptime = (snap.get("steptime") or {}).get("phases") or {}
    if steptime:
        p.head("glint_training_steptime_seconds", "gauge",
               "Step-time attribution ledger: fit-thread wall seconds "
               "by phase (unattributed gap folded into 'other').")
        for phase, info in steptime.items():
            p.sample("glint_training_steptime_seconds",
                     {"phase": phase}, info.get("seconds"))
        p.head("glint_training_steptime_ops_total", "counter",
               "Accounted spans per ledger phase.")
        # Exemplar: the gang trace id of this launch generation
        # (GLINT_TRACE_ID), which links a sample to the merged gang trace.
        trace_id = (snap.get("steptime") or {}).get("trace_id")
        for phase, info in steptime.items():
            p.sample("glint_training_steptime_ops_total",
                     {"phase": phase}, info.get("count", 0),
                     exemplar=({"trace_id": trace_id,
                                "value": info.get("seconds")}
                               if trace_id else None))
    stream = snap.get("streaming") or {}
    if stream:
        # The streaming trainer's gauges: present only on fit_stream runs.
        for name, key, help_ in [
            ("glint_stream_words_total", "words_streamed_total",
             "Kept (in-vocabulary) words consumed from the stream."),
            ("glint_stream_sentences_total", "sentences_streamed_total",
             "Sentences consumed from the stream."),
            ("glint_stream_oov_words_total", "oov_words_total",
             "Out-of-vocabulary occurrences routed to the candidate "
             "sketch."),
            ("glint_stream_promoted_words_total", "promoted_words_total",
             "Words promoted onto spare extra rows (online vocab "
             "growth)."),
            ("glint_stream_generations_published_total",
             "generations_published_total",
             "Committed model generations published for serving."),
        ]:
            p.head(name, "counter", help_)
            p.sample(name, None, stream.get(key, 0))
        for name, key, help_ in [
            ("glint_stream_vocab_size", "stream_vocab_size",
             "Grown vocabulary size (bootstrap base + promoted)."),
            ("glint_stream_extra_rows_free", "extra_rows_free",
             "Spare table rows still available for promotion."),
            ("glint_stream_sketch_fill", "sketch_fill",
             "Candidate-sketch occupancy fraction (1.0 = evicting)."),
            ("glint_stream_noise_drift_l1", "noise_drift_l1",
             "L1 distance between consecutive adaptive noise "
             "distributions at the last refresh."),
            ("glint_stream_lag_seconds", "stream_lag_seconds",
             "Wall seconds from a mini-epoch's first streamed sentence "
             "to its training completing (ingest-to-trained lag)."),
            ("glint_stream_last_publish_age_seconds",
             "last_publish_age_seconds",
             "Seconds since the last committed generation publish "
             "(NaN before any)."),
            ("glint_stream_buffer_fill", "buffer_fill",
             "Fill fraction of the last mini-epoch buffer."),
        ]:
            p.head(name, "gauge", help_)
            p.sample(name, None, stream.get(key))
    transform = snap.get("transform") or {}
    if transform:
        # The bulk transform's gauges: present only on transform runs.
        for name, key, help_ in [
            ("glint_transform_sentences_done_total", "sentences_done_total",
             "Sentences embedded into committed vector shards (resumed "
             "prefix included)."),
            ("glint_transform_shards_committed_total", "shards_committed_total",
             "Vector shards committed this run."),
            ("glint_transform_shards_skipped_total", "shards_skipped_total",
             "Committed shards verified and skipped by the resume scan."),
            ("glint_transform_post_warmup_compiles_total",
             "post_warmup_compiles_total",
             "Query shapes first dispatched after the bulk warmup."),
        ]:
            p.head(name, "counter", help_)
            p.sample(name, None, transform.get(key, 0))
        for name, key, help_ in [
            ("glint_transform_input_sentences", "input_sentences",
             "Input span size in sentences (lines)."),
            ("glint_transform_sentences_per_sec", "sentences_per_sec",
             "Embedded sentences a second this run (resumed prefix "
             "excluded)."),
            ("glint_transform_bucket_fill", "bucket_fill",
             "Real tokens over the padded capacity of the dispatched "
             "blocks."),
            ("glint_transform_producer_wait_seconds", "producer_wait_seconds",
             "Wall seconds the dispatch loop waited on the producer."),
            ("glint_transform_dispatch_seconds", "dispatch_seconds",
             "Wall seconds of device dispatch and readback."),
        ]:
            p.head(name, "gauge", help_)
            p.sample(name, None, transform.get(key))
    _slo_families(p, "glint_training_slo", snap.get("slo"))
    mem = snap.get("device_memory") or {}
    if mem:
        p.head("glint_device_memory_bytes", "gauge",
               "Per-device memory stats where the backend reports them.")
        for dev, stats in sorted(mem.items()):
            for stat, val in sorted(stats.items()):
                p.sample("glint_device_memory_bytes",
                         {"device": dev, "stat": stat}, val)
    return p.text()


# ----------------------------------------------------------------------
# Gang exposition (obs/aggregate.merge_training_snapshots)
# ----------------------------------------------------------------------


def gang_to_prometheus(snap: dict) -> str:
    """Render the merged gang snapshot as scrape-ready text: the gang's
    counters (sums of the per-rank values), total words/s, the rank-skew
    straggler gauge, per-rank progress and the merged step-time ledger
    (``prometheus.py:410`` of the JAX package, without the serving SLO
    families)."""
    p = _Prom()
    p.head("glint_gang_info", "gauge",
           "Gang metadata carried as labels; value is always 1.")
    p.sample("glint_gang_info", {"state": snap.get("state", "")}, 1)
    for name, key, help_ in [
        ("glint_gang_generation", "generation",
         "Supervisor launch generation the merged view reflects."),
        ("glint_gang_num_workers", "num_workers", "Configured gang size."),
        ("glint_gang_ranks_reporting", "ranks_reporting",
         "Ranks with a current-generation heartbeat in the last sweep."),
        ("glint_gang_words_per_sec", "words_per_sec_total",
         "Sum of per-rank rolling trained-words/sec."),
        ("glint_gang_rank_skew", "rank_skew",
         "Straggler skew: max/median of per-rank mean step seconds "
         "(1.0 = balanced; NaN until ranks report step timing)."),
        ("glint_gang_checkpoint_shard_write_seconds",
         "checkpoint_shard_write_seconds_max",
         "Slowest rank's shard-block write seconds in the most recent "
         "checkpoint save (NaN before any)."),
        ("glint_gang_checkpoint_shard_verify_seconds",
         "checkpoint_shard_verify_seconds_max",
         "Slowest rank's per-shard manifest verify seconds in the most "
         "recent restore/stage (NaN before any)."),
    ]:
        p.head(name, "gauge", help_)
        p.sample(name, None, snap.get(key))
    counters = snap.get("counters") or {}
    for name, key, help_ in [
        ("glint_gang_steps_total", "steps_total",
         "Optimizer steps summed over ranks."),
        ("glint_gang_words_done_total", "words_done_total",
         "Trained words summed over ranks."),
        ("glint_gang_query_compiles_total", "query_compiles_total",
         "Engine query shapes first dispatched, summed over ranks."),
        ("glint_gang_async_save_waits_total", "async_save_waits_total",
         "Checkpoint back-pressure waits summed over ranks."),
        ("glint_gang_exchange_bytes_total", "exchange_bytes_total",
         "Replica-exchange bytes on the wire summed over ranks."),
        ("glint_gang_exchange_rows_total", "exchange_rows_total",
         "Touched rows shipped through the exchange summed over ranks."),
        ("glint_gang_exchange_overflow_total", "exchange_overflow_total",
         "Capacity-overflow dense spills summed over ranks."),
        ("glint_gang_exchange_groups_total", "exchange_groups_total",
         "Dispatch groups folded into exchange rounds summed over ranks."),
        ("glint_gang_exchange_intra_bytes_total",
         "exchange_intra_bytes_total",
         "Two-level intra-node hop bytes summed over ranks."),
        ("glint_gang_exchange_inter_bytes_total",
         "exchange_inter_bytes_total",
         "Slow-hop (inter-node or flat) exchange bytes summed over ranks."),
        ("glint_gang_checkpoint_shards_skipped_total",
         "checkpoint_shards_skipped_total",
         "Clean checkpoint shards skipped in place summed over ranks."),
        ("glint_gang_canary_trips_total", "canary_trips_total",
         "Divergence-canary trips summed over ranks."),
        ("glint_gang_events_recorded_total", "events_recorded_total",
         "Obs events recorded summed over ranks."),
        ("glint_gang_events_dropped_total", "events_dropped_total",
         "Obs ring evictions summed over ranks."),
    ]:
        p.head(name, "counter", help_)
        p.sample(name, None, counters.get(key, 0))
    transform = snap.get("transform") or {}
    if transform:
        for name, key, help_ in [
            ("glint_gang_transform_sentences_done_total",
             "sentences_done_total",
             "Sentences embedded into committed shards summed over ranks."),
            ("glint_gang_transform_shards_committed_total",
             "shards_committed_total",
             "Vector shards committed summed over ranks."),
            ("glint_gang_transform_shards_skipped_total",
             "shards_skipped_total",
             "Resume-scan shard skips summed over ranks."),
            ("glint_gang_transform_post_warmup_compiles_total",
             "post_warmup_compiles_total",
             "Query shapes first met after the warmup, summed over ranks."),
        ]:
            p.head(name, "counter", help_)
            p.sample(name, None, transform.get(key, 0))
        for name, key, help_ in [
            ("glint_gang_transform_input_sentences", "input_sentences",
             "Total input sentences across all rank spans."),
            ("glint_gang_transform_sentences_per_sec",
             "sentences_per_sec_total",
             "Sum of per-rank embedded-sentences/sec."),
            ("glint_gang_transform_bucket_fill_min", "bucket_fill_min",
             "Sparsest rank's packing density."),
            ("glint_gang_transform_producer_wait_seconds",
             "producer_wait_seconds_max",
             "Slowest rank's wait on the producer thread."),
        ]:
            p.head(name, "gauge", help_)
            p.sample(name, None, transform.get(key))
    per_rank = snap.get("per_rank") or {}
    for name, key, help_ in [
        ("glint_gang_rank_words_per_sec", "words_per_sec_rolling",
         "Per-rank rolling trained-words/sec."),
        ("glint_gang_rank_mean_step_seconds", "mean_step_seconds",
         "Per-rank mean seconds per optimizer step."),
        ("glint_gang_rank_words_done", "words_done",
         "Per-rank trained-words counter."),
    ]:
        p.head(name, "gauge", help_)
        for rank, r in per_rank.items():
            p.sample(name, {"rank": rank}, r.get(key))
    steptime = snap.get("steptime") or {}
    if steptime:
        p.head("glint_gang_steptime_seconds", "gauge",
               "Merged step-time attribution: fit-thread wall seconds by "
               "phase, summed over ranks.")
        for phase, info in steptime.items():
            p.sample("glint_gang_steptime_seconds", {"phase": phase},
                     info.get("seconds"))
        p.head("glint_gang_steptime_span_seconds", "summary",
               "Merged per-span duration quantiles by ledger phase "
               "(bucket-exact cross-rank histogram merge).")
        for phase, info in steptime.items():
            if "p50_ms" not in info:
                continue
            for q, key in (("0.5", "p50_ms"), ("0.95", "p95_ms"),
                           ("0.99", "p99_ms")):
                p.sample("glint_gang_steptime_span_seconds",
                         {"phase": phase, "quantile": q}, info[key] / 1e3)
            p.sample("glint_gang_steptime_span_seconds_sum", {"phase": phase},
                     info.get("span_seconds", info.get("seconds")))
            trace_id = snap.get("steptime_trace_id")
            p.sample("glint_gang_steptime_span_seconds_count",
                     {"phase": phase}, info.get("count", 0),
                     exemplar=({"trace_id": trace_id,
                                "value": info.get("span_seconds")}
                               if trace_id else None))
    _slo_families(p, "glint_gang_slo", snap.get("slo"))
    # Per-model fleet rollup, lifted from the scraped
    # serving replicas' merged catalog view (gang-prefixed: this
    # exposition is concatenated with the full serving one, which
    # carries the detailed glint_model_* families).
    gmodels = (snap.get("serving") or {}).get("models") or {}
    if gmodels:
        p.head("glint_gang_model_requests_total", "counter",
               "Requests per catalog model summed over endpoints and "
               "serving replicas.")
        for mid, m in sorted(gmodels.items()):
            p.sample("glint_gang_model_requests_total", {"model": mid},
                     sum(int(ep.get("count") or 0)
                         for ep in (m.get("endpoints") or {}).values()))
        p.head("glint_gang_model_resident_replicas", "gauge",
               "Serving replicas holding this model's tables on "
               "device.")
        for mid, m in sorted(gmodels.items()):
            p.sample("glint_gang_model_resident_replicas",
                     {"model": mid}, m.get("resident_replicas", 0))
        p.head("glint_gang_model_table_swaps_total", "counter",
               "Per-model hot-swaps summed over serving replicas.")
        for mid, m in sorted(gmodels.items()):
            hs = m.get("hot_swap") or {}
            p.sample("glint_gang_model_table_swaps_total",
                     {"model": mid}, hs.get("table_swaps_total", 0))
        p.head("glint_gang_model_generation_info", "gauge",
               "Served generation per catalog model across the fleet "
               "('mixed' while a per-model rollout is in flight); "
               "value is always 1.")
        for mid, m in sorted(gmodels.items()):
            hs = m.get("hot_swap") or {}
            p.sample("glint_gang_model_generation_info",
                     {"model": mid,
                      "generation": hs.get("generation") or ""}, 1)
    return p.text()


# ----------------------------------------------------------------------
# Serving exposition (utils/metrics.ServingMetrics.snapshot)
# ----------------------------------------------------------------------


def serving_to_prometheus(snap: dict) -> str:
    """Render a ServingMetrics snapshot as scrape-ready text: request and
    error counters per endpoint, a latency summary (the histogram's
    p50/p95/p99), the coalesced-batch-size histogram, cache counters,
    and the compile accounting the PR-2 zero-compile contract watches."""
    p = _Prom()
    endpoints = snap.get("endpoints", {})
    p.head("glint_serving_requests_total", "counter",
           "Requests observed per endpoint path.")
    for path, ep in endpoints.items():
        p.sample("glint_serving_requests_total", {"path": path}, ep["count"])
    p.head("glint_serving_request_errors_total", "counter",
           "Responses with status >= 400 per endpoint path.")
    for path, ep in endpoints.items():
        p.sample("glint_serving_request_errors_total", {"path": path},
                 ep["errors"])
    p.head("glint_serving_request_latency_seconds", "summary",
           "Per-endpoint request latency quantiles.")
    for path, ep in endpoints.items():
        for q, key in (("0.5", "p50_ms"), ("0.95", "p95_ms"),
                       ("0.99", "p99_ms")):
            p.sample("glint_serving_request_latency_seconds",
                     {"path": path, "quantile": q}, ep[key] / 1e3)
        p.sample("glint_serving_request_latency_seconds_sum",
                 {"path": path}, ep["mean_ms"] * ep["count"] / 1e3)
        # Exemplar: the last kept request trace on this endpoint, so a
        # latency quantile on a dashboard links to a concrete trace.
        ex = ep.get("exemplar") or {}
        p.sample("glint_serving_request_latency_seconds_count",
                 {"path": path}, ep["count"],
                 exemplar=({"trace_id": ex.get("trace_id"),
                            "value": (ex.get("value_ms") or 0) / 1e3}
                           if ex.get("trace_id") else None))
    sizes = {int(k): int(v)
             for k, v in snap.get("coalesced_batch_sizes", {}).items()}
    p.head("glint_serving_coalesced_batch_size", "histogram",
           "Queries per coalesced device dispatch.")
    cum, total = 0, 0
    for size in sorted(sizes):
        cum += sizes[size]
        total += size * sizes[size]
        p.sample("glint_serving_coalesced_batch_size_bucket",
                 {"le": str(size)}, cum)
    p.sample("glint_serving_coalesced_batch_size_bucket", {"le": "+Inf"}, cum)
    p.sample("glint_serving_coalesced_batch_size_sum", None, total)
    p.sample("glint_serving_coalesced_batch_size_count", None, cum)
    over = snap.get("overload", {})
    p.head("glint_serving_shed_total", "counter",
           "Requests shed with 429, by reason (admission = in-flight "
           "high-water mark; degraded = cache-only mode).")
    p.sample("glint_serving_shed_total", {"reason": "admission"},
             over.get("shed_admission_total", 0))
    p.sample("glint_serving_shed_total", {"reason": "degraded"},
             over.get("shed_degraded_total", 0))
    p.head("glint_serving_deadline_hits_total", "counter",
           "Requests answered 504: deadline passed before the device.")
    p.sample("glint_serving_deadline_hits_total", None,
             over.get("deadline_504_total", 0))
    p.head("glint_serving_degraded_entered_total", "counter",
           "Transitions into degraded cache-only mode.")
    p.sample("glint_serving_degraded_entered_total", None,
             over.get("degraded_entered_total", 0))
    p.head("glint_serving_inflight_peak", "gauge",
           "Peak admitted device-touching requests in flight.")
    p.sample("glint_serving_inflight_peak", None,
             over.get("inflight_peak", 0))
    cache = snap.get("synonym_cache", {})
    p.head("glint_serving_cache_hits_total", "counter",
           "Synonym result-cache hits.")
    p.sample("glint_serving_cache_hits_total", None, cache.get("hits", 0))
    p.head("glint_serving_cache_misses_total", "counter",
           "Synonym result-cache misses.")
    p.sample("glint_serving_cache_misses_total", None, cache.get("misses", 0))
    compiles = snap.get("compiles", {})
    p.head("glint_serving_compiles_total", "counter",
           "Query-op shapes jit-compiled since engine construction.")
    p.sample("glint_serving_compiles_total", None, compiles.get("total", 0))
    p.head("glint_serving_post_warmup_compiles", "gauge",
           "Compiles past serving warmup (the zero-compile contract).")
    p.sample("glint_serving_post_warmup_compiles", None,
             compiles.get("post_warmup", 0))
    swap = snap.get("hot_swap") or {}
    p.head("glint_serving_table_swaps_total", "counter",
           "Table generations hot-swapped into the live engine.")
    p.sample("glint_serving_table_swaps_total", None,
             swap.get("table_swaps_total", 0))
    p.head("glint_serving_swap_failures_total", "counter",
           "Hot-swap attempts that failed verification or staging "
           "(the previous generation stayed live).")
    p.sample("glint_serving_swap_failures_total", None,
             swap.get("swap_failures_total", 0))
    p.head("glint_serving_watch_errors_total", "counter",
           "Transient publish-dir read errors the snapshot watcher "
           "absorbed (backed off, retried on a later poll; the "
           "generation was NOT marked failed).")
    p.sample("glint_serving_watch_errors_total", None,
             swap.get("watch_errors_total", 0))
    p.head("glint_serving_last_swap_age_seconds", "gauge",
           "Seconds since the last successful hot-swap (NaN before "
           "any).")
    p.sample("glint_serving_last_swap_age_seconds", None,
             swap.get("last_swap_age_seconds"))
    p.head("glint_serving_generation_info", "gauge",
           "Served snapshot generation carried as a label; value is "
           "always 1.")
    p.sample("glint_serving_generation_info",
             {"generation": swap.get("generation") or ""}, 1)
    ck = snap.get("checkpoint") or {}
    p.head("glint_serving_pending_async_saves", "gauge",
           "Async table snapshots in flight on the served engine.")
    p.sample("glint_serving_pending_async_saves", None,
             ck.get("pending_async_saves", 0))
    p.head("glint_serving_checkpoint_write_seconds", "gauge",
           "Wall seconds of the engine's most recent snapshot write.")
    p.sample("glint_serving_checkpoint_write_seconds", None,
             ck.get("checkpoint_write_seconds"))
    p.head("glint_serving_last_checkpoint_age_seconds", "gauge",
           "Seconds since the engine last committed a table snapshot "
           "(NaN when it never has).")
    p.sample("glint_serving_last_checkpoint_age_seconds", None,
             ck.get("last_checkpoint_age_seconds"))
    # ANN index family: the serving-side view of the
    # two-stage approximate top-k — build/refresh lifecycle, the
    # measured recall gate, and per-query probe accounting.
    index = snap.get("index") or {}
    p.head("glint_index_enabled", "gauge",
           "Whether a device-resident ANN index is built for this "
           "server (1) or every query is exact (0).")
    p.sample("glint_index_enabled", None,
             1 if index.get("enabled") else 0)
    p.head("glint_index_clusters", "gauge",
           "Coarse k-means clusters in the ANN index.")
    p.sample("glint_index_clusters", None, index.get("clusters"))
    p.head("glint_index_nprobe", "gauge",
           "Clusters probed per approximate query.")
    p.sample("glint_index_nprobe", None, index.get("nprobe"))
    p.head("glint_index_build_seconds", "gauge",
           "Wall seconds of the most recent index build/refresh.")
    p.sample("glint_index_build_seconds", None,
             index.get("build_seconds"))
    p.head("glint_index_last_refresh_age_seconds", "gauge",
           "Seconds since the index was last built or refreshed (NaN "
           "before any build).")
    p.sample("glint_index_last_refresh_age_seconds", None,
             index.get("last_refresh_age_seconds"))
    p.head("glint_index_refreshes_total", "counter",
           "Index builds/refreshes (boot + one per hot-swap).")
    p.sample("glint_index_refreshes_total", None,
             index.get("refreshes_total", 0))
    p.head("glint_index_recall_at10", "gauge",
           "Measured recall@10 of the approximate path vs the exact "
           "path on the same tables (NaN before any measurement).")
    p.sample("glint_index_recall_at10", None, index.get("recall_at10"))
    p.head("glint_index_recall_gate_ok", "gauge",
           "Whether the last recall measurement cleared the gate (a "
           "failing gate holds the exact path live).")
    p.sample("glint_index_recall_gate_ok", None,
             1 if index.get("recall_gate_ok") else 0)
    p.head("glint_index_probes_per_query", "gauge",
           "Mean clusters probed per approximate query (NaN before "
           "any approximate query).")
    p.sample("glint_index_probes_per_query", None,
             index.get("probes_per_query"))
    p.head("glint_index_ann_queries_total", "counter",
           "Synonym queries answered through the ANN index.")
    p.sample("glint_index_ann_queries_total", None,
             index.get("ann_queries_total", 0))
    p.head("glint_index_probes_total", "counter",
           "Total clusters probed across all approximate queries.")
    p.sample("glint_index_probes_total", None,
             index.get("probes_total", 0))
    p.head("glint_index_exact_fallbacks_total", "counter",
           "Queries served by the exact path while the index is "
           "enabled, by reason (requested = per-request exact=true; "
           "gate = recall gate holding the approximate path back).")
    for reason, n in sorted((index.get("exact_fallbacks") or {}).items()):
        p.sample("glint_index_exact_fallbacks_total",
                 {"reason": reason}, n)
    p.head("glint_index_table_versions_behind", "gauge",
           "Table mutations since the index was built against the "
           "live tables (staleness; NaN without an index).")
    p.sample("glint_index_table_versions_behind", None,
             index.get("table_versions_behind"))
    _slo_families(p, "glint_slo", snap.get("slo"))
    # Per-model catalog families: the same snapshot shape
    # as the top level, one block per catalog model, labeled {model}.
    # Rendered only for multi-model servers/fleets, so single-model
    # expositions are byte-identical to the pre-catalog format.
    models = snap.get("models") or {}
    if models:
        p.head("glint_model_requests_total", "counter",
               "Requests observed per catalog model and endpoint "
               "path.")
        for mid, m in sorted(models.items()):
            for path, ep in (m.get("endpoints") or {}).items():
                p.sample("glint_model_requests_total",
                         {"model": mid, "path": path}, ep["count"])
        p.head("glint_model_request_errors_total", "counter",
               "Responses with status >= 400 per catalog model and "
               "endpoint path.")
        for mid, m in sorted(models.items()):
            for path, ep in (m.get("endpoints") or {}).items():
                p.sample("glint_model_request_errors_total",
                         {"model": mid, "path": path}, ep["errors"])
        p.head("glint_model_cache_hits_total", "counter",
               "Synonym result-cache hits per catalog model (each "
               "model's cache is private — a cross-model hit is "
               "structurally impossible).")
        for mid, m in sorted(models.items()):
            c = m.get("synonym_cache") or {}
            p.sample("glint_model_cache_hits_total", {"model": mid},
                     c.get("hits", 0))
        p.head("glint_model_cache_misses_total", "counter",
               "Synonym result-cache misses per catalog model.")
        for mid, m in sorted(models.items()):
            c = m.get("synonym_cache") or {}
            p.sample("glint_model_cache_misses_total", {"model": mid},
                     c.get("misses", 0))
        p.head("glint_model_post_warmup_compiles", "gauge",
               "Compiles past this model's load warmup (0 proves "
               "shape-keyed program sharing: a same-shape model "
               "reuses every warmed program).")
        for mid, m in sorted(models.items()):
            comp = m.get("compiles") or {}
            p.sample("glint_model_post_warmup_compiles",
                     {"model": mid}, comp.get("post_warmup", 0))
        p.head("glint_model_table_swaps_total", "counter",
               "Generations hot-swapped per catalog model (a "
               "per-model rollout moves exactly one model's count).")
        for mid, m in sorted(models.items()):
            hs = m.get("hot_swap") or {}
            p.sample("glint_model_table_swaps_total", {"model": mid},
                     hs.get("table_swaps_total", 0))
        p.head("glint_model_swap_failures_total", "counter",
               "Failed hot-swap attempts per catalog model.")
        for mid, m in sorted(models.items()):
            hs = m.get("hot_swap") or {}
            p.sample("glint_model_swap_failures_total", {"model": mid},
                     hs.get("swap_failures_total", 0))
        p.head("glint_model_generation_info", "gauge",
               "Served generation per catalog model carried as a "
               "label; value is always 1.")
        for mid, m in sorted(models.items()):
            hs = m.get("hot_swap") or {}
            p.sample("glint_model_generation_info",
                     {"model": mid,
                      "generation": hs.get("generation") or ""}, 1)
        p.head("glint_model_resident_replicas", "gauge",
               "Replicas holding this model's tables on device (a "
               "single server reports 0 or 1; LRU stage-out drops "
               "it).")
        for mid, m in sorted(models.items()):
            p.sample("glint_model_resident_replicas", {"model": mid},
                     m.get("resident_replicas", 0))
        p.head("glint_model_resident_bytes", "gauge",
               "Device bytes this model's resident tables occupy "
               "(0 while staged out).")
        for mid, m in sorted(models.items()):
            p.sample("glint_model_resident_bytes", {"model": mid},
                     m.get("resident_bytes", 0))
        p.head("glint_model_pinned", "gauge",
               "Whether the model is pinned against LRU eviction "
               "(default model, mid-rollout holds).")
        for mid, m in sorted(models.items()):
            p.sample("glint_model_pinned", {"model": mid},
                     1 if m.get("pinned") else 0)
        p.head("glint_model_stage_ins_total", "counter",
               "Times this model's tables were staged back onto the "
               "device after an eviction.")
        for mid, m in sorted(models.items()):
            p.sample("glint_model_stage_ins_total", {"model": mid},
                     m.get("stage_ins_total", 0))
        p.head("glint_model_evictions_total", "counter",
               "Times this model's tables were staged out under "
               "memory-budget pressure.")
        for mid, m in sorted(models.items()):
            p.sample("glint_model_evictions_total", {"model": mid},
                     m.get("evictions_total", 0))
    cat = snap.get("catalog") or {}
    if cat:
        p.head("glint_catalog_models", "gauge",
               "Models installed in the serving catalog.")
        p.sample("glint_catalog_models", None, cat.get("models", 0))
        p.head("glint_catalog_resident_models", "gauge",
               "Catalog models currently resident on device (summed "
               "across replicas in the fleet view).")
        p.sample("glint_catalog_resident_models", None,
                 cat.get("resident_models", 0))
        p.head("glint_catalog_budget_bytes", "gauge",
               "Configured device-memory budget for resident tables "
               "(NaN when unbounded).")
        p.sample("glint_catalog_budget_bytes", None,
                 cat.get("budget_bytes"))
        p.head("glint_catalog_resident_bytes", "gauge",
               "Device bytes all resident catalog tables occupy.")
        p.sample("glint_catalog_resident_bytes", None,
                 cat.get("resident_bytes", 0))
        p.head("glint_catalog_evictions_total", "counter",
               "LRU stage-outs forced by the memory budget.")
        p.sample("glint_catalog_evictions_total", None,
                 cat.get("evictions_total", 0))
        p.head("glint_catalog_stage_ins_total", "counter",
               "Cold models staged back onto the device.")
        p.sample("glint_catalog_stage_ins_total", None,
                 cat.get("stage_ins_total", 0))
        p.head("glint_catalog_stage_in_seconds_total", "counter",
               "Wall seconds spent staging evicted models back in "
               "(off the request path; requests queue, never 500).")
        p.sample("glint_catalog_stage_in_seconds_total", None,
                 cat.get("stage_in_seconds_total", 0))
        p.head("glint_catalog_cold_hits_total", "counter",
               "Requests that arrived while their model was staged "
               "out (each waited for the stage-in, then served).")
        p.sample("glint_catalog_cold_hits_total", None,
                 cat.get("cold_hits_total", 0))
        p.head("glint_catalog_query_program_builds_total", "counter",
               "Process-level query program builds — flat across "
               "same-shape model loads (the sharing proof).")
        p.sample("glint_catalog_query_program_builds_total", None,
                 cat.get("query_program_builds", 0))
        p.head("glint_catalog_shared_program_hits_total", "counter",
               "Engine program lookups answered by another engine's "
               "compiled program.")
        p.sample("glint_catalog_shared_program_hits_total", None,
                 cat.get("shared_program_hits", 0))
    return p.text()


# ----------------------------------------------------------------------
# Fleet balancer exposition (fleet.LoadBalancer.metrics_doc; the data-plane shard,
# autoscaler and QoS families render only when those blocks are present)
# ----------------------------------------------------------------------


def fleet_to_prometheus(doc: dict) -> str:
    """Render a fleet balancer document: replica liveness and proxy
    accounting per replica, the balancer's retry/exhaustion counters,
    and each replica's index recall gauges (fleet-prefixed and labeled
    by replica — this text is concatenated with
    ``serving_to_prometheus`` over the merged ``fleet`` member, and
    families in one scrape must be disjoint). One scrape of the
    balancer therefore carries the fleet totals AND the per-replica
    recall-gate states."""
    p = _Prom()
    replicas = doc.get("replicas") or []
    p.head("glint_fleet_replicas", "gauge",
           "Serving replicas configured behind the balancer.")
    p.sample("glint_fleet_replicas", None, len(replicas))
    p.head("glint_fleet_replica_up", "gauge",
           "Whether the replica answered the last metrics scrape.")
    for r in replicas:
        p.sample("glint_fleet_replica_up", {"replica": r.get("url", "")},
                 1 if r.get("up") else 0)
    p.head("glint_fleet_proxied_total", "counter",
           "Requests the balancer forwarded, by replica.")
    for r in replicas:
        p.sample("glint_fleet_proxied_total",
                 {"replica": r.get("url", "")},
                 r.get("proxied_total", 0))
    p.head("glint_fleet_proxy_errors_total", "counter",
           "Forward attempts that failed at the connection level, by "
           "replica.")
    for r in replicas:
        p.sample("glint_fleet_proxy_errors_total",
                 {"replica": r.get("url", "")},
                 r.get("proxy_errors_total", 0))
    # Circuit breaker: per-replica state machine driven by
    # the active health prober and the data plane's own connection
    # verdicts — an ejected (open) replica costs zero client latency.
    p.head("glint_fleet_breaker_state", "gauge",
           "Per-replica circuit-breaker state: 1 on the row matching "
           "the current state (closed replicas receive traffic, open "
           "ones are ejected from rotation, half-open ones serve "
           "prober trials only).")
    for r in replicas:
        br = r.get("breaker") or {}
        for st in ("closed", "open", "half_open"):
            p.sample("glint_fleet_breaker_state",
                     {"replica": r.get("url", ""), "state": st},
                     1 if br.get("state") == st else 0)
    p.head("glint_fleet_breaker_held", "gauge",
           "Whether the replica is administratively held out of "
           "rotation (rollout drain / canary staging).")
    for r in replicas:
        br = r.get("breaker") or {}
        p.sample("glint_fleet_breaker_held",
                 {"replica": r.get("url", "")},
                 1 if br.get("held") else 0)
    for name, key, help_ in [
        ("glint_fleet_breaker_opened_total", "opened_total",
         "Closed -> open transitions (consecutive-failure ejections)."),
        ("glint_fleet_breaker_reopened_total", "reopened_total",
         "Half-open trial failures that re-opened the breaker."),
        ("glint_fleet_breaker_closed_total", "closed_total",
         "Half-open -> closed readmissions after the success "
         "threshold."),
        ("glint_fleet_probe_failures_total", "probe_failures_total",
         "Active health probes that failed (connect error, non-200, "
         "or a generation-handshake mismatch)."),
        ("glint_fleet_probe_successes_total", "probe_successes_total",
         "Active health probes answered healthy."),
    ]:
        p.head(name, "counter", help_)
        for r in replicas:
            br = r.get("breaker") or {}
            p.sample(name, {"replica": r.get("url", "")},
                     br.get(key, 0))
    bal = doc.get("balancer") or {}
    p.head("glint_fleet_shed_retries_total", "counter",
           "Requests retried on another replica after a 429/503 shed "
           "(the replicas' own backpressure steering the spread).")
    p.sample("glint_fleet_shed_retries_total", None,
             bal.get("shed_retries_total", 0))
    p.head("glint_fleet_exhausted_total", "counter",
           "Requests every replica shed or failed — the shed response "
           "was relayed to the client.")
    p.sample("glint_fleet_exhausted_total", None,
             bal.get("exhausted_total", 0))
    p.head("glint_fleet_breaker_skips_total", "counter",
           "Replica attempts avoided because the breaker was open or "
           "held — each one a timeout a client did not pay.")
    p.sample("glint_fleet_breaker_skips_total", None,
             bal.get("breaker_skips_total", 0))
    p.head("glint_fleet_restart_retries_total", "counter",
           "Connection-refused attempts retried with jittered backoff "
           "inside a known replica-restart window.")
    p.sample("glint_fleet_restart_retries_total", None,
             bal.get("restart_retries_total", 0))
    # Fleet supervisor: replica relaunch accounting.
    sup = doc.get("supervisor") or {}
    p.head("glint_fleet_restarts_total", "counter",
           "Replica relaunches by the fleet supervisor (crash or "
           "hung-probe kill), all replicas.")
    p.sample("glint_fleet_restarts_total", None,
             sup.get("restarts_total", 0))
    p.head("glint_fleet_replicas_failed", "gauge",
           "Replicas whose restart budget is exhausted (left down; "
           "the fleet serves from the survivors).")
    p.sample("glint_fleet_replicas_failed", None,
             sup.get("replicas_failed", 0))
    p.head("glint_fleet_replica_restarts_total", "counter",
           "Relaunches per replica slot.")
    for rs in sup.get("replica_states") or []:
        p.sample("glint_fleet_replica_restarts_total",
                 {"replica": str(rs.get("replica", ""))},
                 rs.get("restarts", 0))
    p.head("glint_fleet_replica_state_info", "gauge",
           "Fleet-supervisor state per replica slot carried as a "
           "label; value is always 1.")
    for rs in sup.get("replica_states") or []:
        p.sample("glint_fleet_replica_state_info",
                 {"replica": str(rs.get("replica", "")),
                  "state": rs.get("state", "")}, 1)
    # Rolling rollout + shadow canary.
    ro = doc.get("rollout") or {}
    for name, key, help_ in [
        ("glint_fleet_rollouts_started_total", "rollouts_started_total",
         "Generation rollouts the coordinator started."),
        ("glint_fleet_rollouts_completed_total",
         "rollouts_completed_total",
         "Rollouts that promoted the generation to every replica."),
        ("glint_fleet_rollouts_halted_total", "rollouts_halted_total",
         "Rollouts halted mid-way (replica unavailable — retried once "
         "the fleet is whole again)."),
        ("glint_fleet_rollout_steps_total", "rollout_steps_total",
         "Per-replica swap steps performed across all rollouts."),
        ("glint_fleet_generations_failed_total",
         "generations_failed_total",
         "Candidate generations whose staging failed on a replica "
         "(not retried until the pointer moves)."),
        ("glint_fleet_watch_errors_total", "watch_errors_total",
         "Transient publish-pointer read errors the rollout "
         "coordinator absorbed."),
    ]:
        p.head(name, "counter", help_)
        p.sample(name, None, ro.get(key, 0))
    p.head("glint_fleet_rollout_in_progress", "gauge",
           "Whether a rolling generation rollout is currently "
           "executing.")
    p.sample("glint_fleet_rollout_in_progress", None,
             1 if ro.get("in_progress") else 0)
    p.head("glint_fleet_generation_info", "gauge",
           "Fleet-promoted generation carried as a label; value is "
           "always 1.")
    p.sample("glint_fleet_generation_info",
             {"generation": ro.get("generation") or ""}, 1)
    can = ro.get("canary") or {}
    p.head("glint_fleet_canary_evaluations_total", "counter",
           "Shadow-canary evaluations run against candidate "
           "generations.")
    p.sample("glint_fleet_canary_evaluations_total", None,
             can.get("evaluations_total", 0))
    p.head("glint_fleet_canary_holdbacks_total", "counter",
           "Candidate generations held back by the canary gate "
           "(regression: the rollout never proceeded; the live "
           "generation kept serving everywhere).")
    p.sample("glint_fleet_canary_holdbacks_total", None,
             can.get("holdbacks_total", 0))
    p.head("glint_fleet_canary_last_agreement", "gauge",
           "Mean top-k agreement of the last canary evaluation "
           "against the live fleet (NaN before any evaluation).")
    p.sample("glint_fleet_canary_last_agreement", None,
             can.get("last_agreement"))
    p.head("glint_fleet_canary_agreement_gate", "gauge",
           "Agreement threshold a candidate must clear to promote.")
    p.sample("glint_fleet_canary_agreement_gate", None,
             can.get("agreement_gate"))
    p.head("glint_fleet_canary_last_scored", "gauge",
           "Mirrored + probe responses scored in the last canary "
           "evaluation.")
    p.sample("glint_fleet_canary_last_scored", None,
             can.get("last_scored", 0))
    # Per-replica index recall: the fleet view of the recall
    # gate (fleet-prefixed names — this exposition is concatenated
    # with serving_to_prometheus over the merged doc, and families in
    # one scrape must be disjoint).
    p.head("glint_fleet_index_recall_at10", "gauge",
           "Per-replica measured recall@10 of the approximate path vs "
           "the exact path (NaN before any measurement).")
    p.head("glint_fleet_index_recall_gate_ok", "gauge",
           "Per-replica recall-gate verdict (a failing gate holds "
           "that replica's exact path live).")
    for r in replicas:
        index = (r.get("snapshot") or {}).get("index") or {}
        if not index.get("enabled"):
            continue
        label = {"replica": r.get("url", "")}
        p.sample("glint_fleet_index_recall_at10", label,
                 index.get("recall_at10"))
        p.sample("glint_fleet_index_recall_gate_ok", label,
                 1 if index.get("recall_gate_ok") else 0)
    # Multi-process data plane: per-shard balancer blocks
    # (shard 0 = the supervisor's in-process balancer) + the retry
    # and QoS admission counters summed across shards in "balancer".
    p.head("glint_fleet_retry_after_honored_total", "counter",
           "All-replicas-shed retries that backed off by the replicas' "
           "own Retry-After hint before the next forward round.")
    p.sample("glint_fleet_retry_after_honored_total", None,
             bal.get("retry_after_honored_total", 0))
    dplane = doc.get("data_plane") or {}
    p.head("glint_fleet_balancer_procs", "gauge",
           "Balancer processes sharing the fleet listen port "
           "(SO_REUSEPORT or an inherited listener fd).")
    p.sample("glint_fleet_balancer_procs", None,
             dplane.get("balancer_procs", 1))
    shards = doc.get("balancer_shards") or []
    p.head("glint_fleet_shard_up", "gauge",
           "Whether the balancer shard answered the last control-"
           "channel snapshot.")
    for s in shards:
        p.sample("glint_fleet_shard_up",
                 {"shard": str(s.get("shard", ""))},
                 1 if s.get("up") else 0)
    for name, key, help_ in [
        ("glint_fleet_shard_proxied_total", "proxied_total",
         "Requests this balancer shard forwarded."),
        ("glint_fleet_shard_shed_retries_total", "shed_retries_total",
         "Shed-driven replica retries on this balancer shard."),
        ("glint_fleet_shard_exhausted_total", "exhausted_total",
         "Requests this shard relayed as all-replicas-shed."),
    ]:
        p.head(name, "counter", help_)
        for s in shards:
            stats = s.get("stats") or {}
            p.sample(name, {"shard": str(s.get("shard", ""))},
                     stats.get(key, 0))
    p.head("glint_fleet_shard_requests_total", "counter",
           "Device-path requests observed by the shard's forward path, "
           "by endpoint.")
    p.head("glint_fleet_shard_request_p95_ms", "gauge",
           "Forward-path p95 latency of the shard, by endpoint "
           "(client-observed: queueing + replica round trip).")
    for s in shards:
        serving = s.get("serving") or {}
        for ep, es in sorted((serving.get("endpoints") or {}).items()):
            lbl = {"shard": str(s.get("shard", "")), "endpoint": ep}
            p.sample("glint_fleet_shard_requests_total", lbl,
                     es.get("count", 0))
            p.sample("glint_fleet_shard_request_p95_ms", lbl,
                     es.get("p95_ms"))
    # Warm-spare autoscaler.
    auto = doc.get("autoscale") or {}
    if auto:
        p.head("glint_fleet_autoscale_live", "gauge",
               "Replicas currently live (serving traffic, no holds).")
        p.sample("glint_fleet_autoscale_live", None, auto.get("live", 0))
        p.head("glint_fleet_autoscale_spares", "gauge",
               "Warm spares parked by the autoscaler (launched and "
               "warmed, held out of rotation).")
        p.sample("glint_fleet_autoscale_spares", None,
                 auto.get("spares", 0))
        for name, key, help_ in [
            ("glint_fleet_autoscale_ups_total", "scale_ups_total",
             "Scale-up transitions (warm-spare readmits)."),
            ("glint_fleet_autoscale_downs_total", "scale_downs_total",
             "Scale-down transitions (live replicas parked to spare)."),
            ("glint_fleet_autoscale_pinned_skips_total",
             "pinned_skips_total",
             "Policy steps skipped because a rollout/canary pinned "
             "the replica set."),
            ("glint_fleet_autoscale_steps_total", "steps_total",
             "Autoscaler policy evaluations."),
        ]:
            p.head(name, "counter", help_)
            p.sample(name, None, auto.get(key, 0))
        p.head("glint_fleet_autoscale_last_shed_rate", "gauge",
               "Fleet shed rate (sheds/sec, QoS sheds included) at the "
               "last policy step.")
        p.sample("glint_fleet_autoscale_last_shed_rate", None,
                 auto.get("last_shed_rate", 0))
    # QoS admission: per-tenant quota + class shed
    # accounting from the balancer's front door.
    qos = bal.get("qos") or {}
    if qos:
        p.head("glint_fleet_qos_admitted_total", "counter",
               "Requests admitted by the QoS gate, by priority class.")
        for cls, n in sorted((qos.get("admitted_total") or {}).items()):
            p.sample("glint_fleet_qos_admitted_total",
                     {"class": cls}, n)
        p.head("glint_fleet_qos_shed_total", "counter",
               "Requests shed by the QoS gate, by reason (tenant "
               "quota, bulk-class inflight cap, infeasible deadline).")
        for reason, n in sorted((qos.get("shed_total") or {}).items()):
            p.sample("glint_fleet_qos_shed_total",
                     {"reason": reason}, n)
        p.head("glint_fleet_qos_tenant_shed_total", "counter",
               "Requests shed by the QoS gate, by tenant "
               "(X-Glint-Tenant).")
        for tenant, n in sorted(
                (qos.get("per_tenant_shed_total") or {}).items()):
            p.sample("glint_fleet_qos_tenant_shed_total",
                     {"tenant": tenant}, n)
        p.head("glint_fleet_qos_bulk_inflight", "gauge",
               "Bulk-class requests currently in flight.")
        p.sample("glint_fleet_qos_bulk_inflight", None,
                 qos.get("bulk_inflight", 0))
        p.head("glint_fleet_qos_bulk_inflight_peak", "gauge",
               "Peak concurrent bulk-class requests since boot.")
        p.sample("glint_fleet_qos_bulk_inflight_peak", None,
                 qos.get("bulk_inflight_peak", 0))
    return p.text()


# ----------------------------------------------------------------------
# Text-format lint
# ----------------------------------------------------------------------

_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_LABEL = r'[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\.)*"'
_VALUE = r"(?:NaN|[+-]?Inf|[+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)"
_SAMPLE_RE = re.compile(
    rf"^({_NAME})(\{{{_LABEL}(?:,{_LABEL})*\}})?"
    rf" ({_VALUE})"
    # Optional OpenMetrics-style exemplar: " # {labels} value".
    rf"( # \{{{_LABEL}(?:,{_LABEL})*\}} {_VALUE})?$"
)
_COMMENT_RE = re.compile(rf"^# (HELP|TYPE) ({_NAME})( .*)?$")
_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")


def lint_prometheus_text(text: str) -> None:
    """Validate the subset of the 0.0.4 text format the renderers emit.

    Raises ``ValueError`` naming the first offending line; returns None
    on clean input. Checks: trailing newline, HELP/TYPE comment grammar,
    valid metric types, no duplicate TYPE, TYPE declared before its
    samples, and full sample-line grammar (metric/label name charset,
    escaped label values, parseable value).
    """
    if not text.endswith("\n"):
        raise ValueError("exposition must end with a newline")
    typed: dict = {}
    sampled: set = set()
    for i, line in enumerate(text.split("\n")[:-1], 1):
        if line == "":
            continue
        if line.startswith("#"):
            m = _COMMENT_RE.match(line)
            if not m:
                raise ValueError(f"line {i}: malformed comment: {line!r}")
            if m.group(1) == "TYPE":
                name, t = m.group(2), (m.group(3) or "").strip()
                if t not in _TYPES:
                    raise ValueError(
                        f"line {i}: invalid metric type {t!r} for {name}"
                    )
                if name in typed:
                    raise ValueError(f"line {i}: duplicate TYPE for {name}")
                if name in sampled:
                    raise ValueError(
                        f"line {i}: TYPE for {name} after its samples"
                    )
                typed[name] = t
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {i}: malformed sample line: {line!r}")
        base = re.sub(r"_(bucket|sum|count)$", "", m.group(1))
        sampled.add(m.group(1))
        sampled.add(base)
