"""Prometheus text exposition (format version 0.0.4) of the training
heartbeat's snapshot (trimmed copy of
``glint_word2vec_tpu/obs/prometheus.py:18-409, 1417``).

A pure function dict -> text, so the heartbeat renders
``/metrics?format=prometheus`` from the same snapshot its JSON endpoint
serves. The metric families and their labels are the JAX package's,
including the replica-exchange ones, which a one-device fit reports as
0 or NaN. Also :func:`lint_prometheus_text`, the validator the tests run
over every rendered exposition. The gang, serving and fleet renderers
come with the port's multi-device and serving slices.
"""

from __future__ import annotations

import math
import re


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

    def sample(self, name: str, labels, value) -> None:
        if labels:
            lab = ",".join(f'{k}="{_esc(v)}"' for k, v in labels.items())
            self.lines.append(f"{name}{{{lab}}} {_num(value)}")
        else:
            self.lines.append(f"{name} {_num(value)}")

    def text(self) -> str:
        return "\n".join(self.lines) + "\n"


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
        for phase, info in steptime.items():
            p.sample("glint_training_steptime_ops_total",
                     {"phase": phase}, info.get("count", 0))
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
