"""Per-endpoint SLOs, multi-window burn rates, and the anomaly flight
recorder (copy of ``glint_word2vec_tpu/obs/slo.py``).

The serving data plane's overload machinery emits counters, but nothing
answers the operator
question "are we failing our users *right now*, and how fast": that is a
burn rate, not a counter. :class:`SloEngine` implements the standard
multi-window multi-burn-rate evaluation (Google SRE workbook ch. 5):
each endpoint owns an availability SLI (non-5xx fraction) and a latency
SLI (fraction of non-5xx responses under a threshold), bucketed into
10-second bins pruned at 6 hours, and evaluated over paired windows —
fast (5m AND 1h, trigger 14.4x) catches a sudden cliff within minutes
while the long window debounces blips; slow (30m AND 6h, trigger 6x)
catches a simmering leak. Snapshots carry the raw per-window good/bad
counts, so merging replicas is summing counts and recomputing burn —
the same mergeable-by-construction contract the serving aggregate uses.

:class:`FlightRecorder` is the anomaly postmortem half: when a breaker
opens, a shed burst fires (:class:`ShedBurstDetector`), an SLO enters
fast burn, or a rank dies, it snapshots every registered source (the
local span ring's last N seconds, the metrics snapshot, per-replica
scrapes at the balancer) into a ``flightrec-<seq>-<reason>/`` bundle —
rate-limited so a flapping trigger cannot fill the disk. Everything here
is stdlib-only: it runs inside serving handlers, never on a device.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

logger = logging.getLogger(__name__)

#: Evaluation windows (label -> seconds). The burn-rate pairs below
#: reference these labels; 6h is also the retention bound of the bucket
#: ring (longest window anything can ask about).
WINDOWS = {"5m": 300, "30m": 1800, "1h": 3600, "6h": 21600}

#: Multi-window alert pairs: (short window, long window, trigger burn).
#: Fast: 14.4x burn spends 2% of a 30-day budget in one hour. Slow: 6x
#: spends 10% in 6 hours. Both windows must exceed the trigger.
BURN_PAIRS = (
    ("fast", "5m", "1h", 14.4),
    ("slow", "30m", "6h", 6.0),
)

_BUCKET_SECONDS = 10
_RETENTION_SECONDS = WINDOWS["6h"] + _BUCKET_SECONDS


@dataclass
class SloObjective:
    """One endpoint's objectives. ``availability_target`` is the good
    fraction (non-5xx); ``latency_target`` the fraction of non-5xx
    responses that must finish under ``latency_threshold_ms``."""

    endpoint: str
    availability_target: float = 0.999
    latency_target: float = 0.99
    latency_threshold_ms: float = 250.0


class SloEngine:
    """Bucketed SLI counts + burn-rate evaluation for a set of
    objectives. Thread-safe; ``now_fn`` is injectable so tests can march
    a fake clock through the windows deterministically."""

    def __init__(self, objectives: Iterable[SloObjective],
                 now_fn: Callable[[], float] = time.monotonic):
        self._objectives = {o.endpoint: o for o in objectives}
        self._now = now_fn
        self._mu = threading.Lock()
        # endpoint -> {bucket_index -> [total, bad_avail, bad_latency]}
        self._buckets: Dict[str, Dict[int, List[int]]] = {
            e: {} for e in self._objectives
        }
        # Edge-triggered fast-burn state + throttle for the cheap
        # per-request check path.
        self._fast_burning: set = set()
        self._last_check = 0.0

    @classmethod
    def default_serving(cls, paths: Iterable[str],
                        now_fn: Callable[[], float] = time.monotonic
                        ) -> "SloEngine":
        """Objectives for the serving device paths, env-tunable:
        GLINT_SLO_AVAIL_TARGET / GLINT_SLO_LATENCY_TARGET /
        GLINT_SLO_LATENCY_MS."""
        avail = float(os.environ.get("GLINT_SLO_AVAIL_TARGET") or 0.999)
        lat_t = float(os.environ.get("GLINT_SLO_LATENCY_TARGET") or 0.99)
        lat_ms = float(os.environ.get("GLINT_SLO_LATENCY_MS") or 250.0)
        return cls(
            [SloObjective(p, avail, lat_t, lat_ms) for p in sorted(paths)],
            now_fn=now_fn,
        )

    def observe(self, endpoint: str, seconds: float, status: int) -> None:
        """Record one response. Endpoints without an objective are
        ignored (bounded cardinality by construction). 5xx counts
        against availability; the latency SLI is measured over non-5xx
        responses only (a fast 503 must not *improve* latency)."""
        obj = self._objectives.get(endpoint)
        if obj is None:
            return
        bad_avail = int(status) >= 500
        bad_lat = (
            not bad_avail
            and seconds * 1e3 > obj.latency_threshold_ms
        )
        idx = int(self._now() // _BUCKET_SECONDS)
        with self._mu:
            buckets = self._buckets[endpoint]
            b = buckets.get(idx)
            if b is None:
                b = buckets[idx] = [0, 0, 0]
                self._prune_locked(endpoint, idx)
            b[0] += 1
            b[1] += int(bad_avail)
            b[2] += int(bad_lat)

    def _prune_locked(self, endpoint: str, now_idx: int) -> None:
        floor = now_idx - _RETENTION_SECONDS // _BUCKET_SECONDS
        buckets = self._buckets[endpoint]
        for idx in [i for i in buckets if i < floor]:
            del buckets[idx]

    def _window_counts_locked(self, endpoint: str, now: float) -> dict:
        buckets = self._buckets[endpoint]
        now_idx = int(now // _BUCKET_SECONDS)
        out = {}
        for label, secs in WINDOWS.items():
            floor = now_idx - secs // _BUCKET_SECONDS
            total = bad_a = bad_l = 0
            for idx, (t, ba, bl) in buckets.items():
                if floor < idx <= now_idx:
                    total += t
                    bad_a += ba
                    bad_l += bl
            out[label] = {
                "total": total,
                "bad_availability": bad_a,
                "bad_latency": bad_l,
            }
        return out

    def snapshot(self) -> dict:
        """Mergeable SLO document: per-endpoint targets + raw per-window
        counts + derived burn rates and alert states. Merge replicas
        with :func:`merge_slo_snapshots` (sums counts, recomputes)."""
        now = self._now()
        with self._mu:
            per_ep = {}
            for ep, obj in self._objectives.items():
                per_ep[ep] = {
                    "availability_target": obj.availability_target,
                    "latency_target": obj.latency_target,
                    "latency_threshold_ms": obj.latency_threshold_ms,
                    "windows": self._window_counts_locked(ep, now),
                }
        return _derive_burns({"endpoints": per_ep})

    def fast_burn_transitions(self, min_interval: float = 5.0) -> list:
        """Endpoints that newly ENTERED fast burn since the last check
        (edge-triggered, throttled to one evaluation per
        ``min_interval`` seconds) — the flight-recorder trigger hook the
        serving handler calls on its response path."""
        now = self._now()
        with self._mu:
            if now - self._last_check < min_interval:
                return []
            self._last_check = now
        snap = self.snapshot()
        burning = {
            ep for ep, doc in snap["endpoints"].items()
            if doc["alerts"]["fast_burn"]
        }
        with self._mu:
            entered = sorted(burning - self._fast_burning)
            self._fast_burning = burning
        return entered


def _burn(bad: int, total: int, target: float) -> float:
    """Burn rate over one window: observed error rate / budgeted error
    rate. 0 with no traffic (absence of evidence is not an alert)."""
    if not total:
        return 0.0
    budget = 1.0 - target
    if budget <= 0:
        return 0.0
    return (bad / total) / budget


def _derive_burns(doc: dict) -> dict:
    """Fill in per-endpoint burn rates + alert booleans from raw window
    counts (shared by live snapshots and cross-replica merges, so a
    merged document derives identically)."""
    for ep_doc in doc["endpoints"].values():
        win = ep_doc["windows"]
        burns = {"availability": {}, "latency": {}}
        for label in WINDOWS:
            w = win[label]
            burns["availability"][label] = round(_burn(
                w["bad_availability"], w["total"],
                ep_doc["availability_target"],
            ), 3)
            burns["latency"][label] = round(_burn(
                w["bad_latency"], max(w["total"] - w["bad_availability"], 0),
                ep_doc["latency_target"],
            ), 3)
        def pair_fired(short: str, long_: str, trigger: float) -> bool:
            return any(
                burns[sli][short] > trigger and burns[sli][long_] > trigger
                for sli in ("availability", "latency")
            )

        # Literal keys, the BURN_PAIRS values: the renderers read these
        # keys back by name.
        alerts = {
            "fast_burn": pair_fired("5m", "1h", 14.4),
            "slow_burn": pair_fired("30m", "6h", 6.0),
        }
        ep_doc["burn_rates"] = burns
        ep_doc["alerts"] = alerts
    return doc


def merge_slo_snapshots(snaps: Iterable[dict]) -> Optional[dict]:
    """Fold per-replica SLO snapshots into one fleet document: window
    counts sum, targets come from the first replica carrying the
    endpoint (one config per fleet is the deployment contract), burns
    and alerts are re-derived from the summed counts."""
    snaps = [s for s in snaps if s and s.get("endpoints")]
    if not snaps:
        return None
    endpoints: Dict[str, dict] = {}
    for s in snaps:
        for ep, doc in s["endpoints"].items():
            agg = endpoints.get(ep)
            if agg is None:
                agg = endpoints[ep] = {
                    "availability_target": doc["availability_target"],
                    "latency_target": doc["latency_target"],
                    "latency_threshold_ms": doc["latency_threshold_ms"],
                    "windows": {
                        label: {
                            "total": 0,
                            "bad_availability": 0,
                            "bad_latency": 0,
                        } for label in WINDOWS
                    },
                }
            for label in WINDOWS:
                src = (doc.get("windows") or {}).get(label)
                if not src:
                    continue
                dst = agg["windows"][label]
                for k in dst:
                    dst[k] += int(src.get(k) or 0)
    return _derive_burns(
        {"endpoints": {e: endpoints[e] for e in sorted(endpoints)}}
    )


class ShedBurstDetector:
    """Edge detector for shed bursts: ``note()`` returns True when the
    shed count inside the sliding window first crosses the threshold
    (and re-arms only after the window drains below it), so the flight
    recorder sees one trigger per burst, not one per shed."""

    def __init__(self, threshold: int = 20, window_seconds: float = 10.0,
                 now_fn: Callable[[], float] = time.monotonic):
        self.threshold = max(1, int(threshold))
        self.window_seconds = float(window_seconds)
        self._now = now_fn
        self._mu = threading.Lock()
        self._times: List[float] = []
        self._armed = True

    def note(self) -> bool:
        now = self._now()
        with self._mu:
            self._times.append(now)
            floor = now - self.window_seconds
            self._times = [t for t in self._times if t >= floor]
            if len(self._times) >= self.threshold:
                if self._armed:
                    self._armed = False
                    return True
                return False
            self._armed = True
            return False


class FlightRecorder:
    """Postmortem bundle writer. ``sources`` are named zero-argument-ish
    callables (they receive the bundle's span window in seconds) whose
    JSON-serializable return values are written one file per source;
    :meth:`trigger` snapshots all of them into
    ``<out_dir>/flightrec-<seq>-<reason>/`` and finishes with
    ``meta.json`` (its presence marks the bundle complete). Triggers
    are rate-limited to one bundle per ``min_interval_seconds``; a
    failing source is recorded in the meta, never fatal — the recorder
    must not take down the data plane it is documenting."""

    def __init__(self, out_dir: str, *, window_seconds: float = 30.0,
                 min_interval_seconds: float = 60.0,
                 now_fn: Callable[[], float] = time.monotonic):
        self.out_dir = out_dir
        self.window_seconds = float(window_seconds)
        self.min_interval_seconds = float(min_interval_seconds)
        self._now = now_fn
        self._mu = threading.Lock()
        self._sources: Dict[str, Callable[[float], object]] = {}
        self._seq = 0
        self._last_trigger: Optional[float] = None
        self.triggered_total = 0
        self.suppressed_total = 0

    def add_source(self, name: str,
                   fn: Callable[[float], object]) -> None:
        with self._mu:
            self._sources[name] = fn

    def trigger(self, reason: str, **context) -> Optional[str]:
        """Write one bundle (or None when rate-limited). Never raises:
        this is called from breaker/handler paths that must survive a
        full disk."""
        now = self._now()
        with self._mu:
            if (self._last_trigger is not None
                    and now - self._last_trigger
                    < self.min_interval_seconds):
                self.suppressed_total += 1
                return None
            self._last_trigger = now
            self._seq += 1
            seq = self._seq
            sources = dict(self._sources)
        safe_reason = "".join(
            c if c.isalnum() or c in "-_" else "-" for c in reason
        )
        bundle = os.path.join(
            self.out_dir, f"flightrec-{seq:03d}-{safe_reason}"
        )
        try:
            from glint_word2vec_torch.utils import atomic_write_json

            os.makedirs(bundle, exist_ok=True)
            meta = {
                "reason": reason,
                "context": context,
                "wall_time": time.time(),
                "window_seconds": self.window_seconds,
                "sequence": seq,
                "sources": {},
            }
            for name, fn in sorted(sources.items()):
                try:
                    doc = fn(self.window_seconds)
                    atomic_write_json(
                        os.path.join(bundle, f"{name}.json"), doc
                    )
                    meta["sources"][name] = "ok"
                except Exception as e:
                    meta["sources"][name] = f"error: {e}"
            # meta.json last: its presence marks the bundle complete
            # (a reader never consumes a half-written bundle).
            atomic_write_json(os.path.join(bundle, "meta.json"), meta)
        except Exception as e:
            logger.warning(
                "flight recorder bundle %s failed: %s", bundle, e
            )
            return None
        with self._mu:
            self.triggered_total += 1
        logger.warning(
            "flight recorder: wrote %s (reason=%s)", bundle, reason
        )
        return bundle

    def stats(self) -> dict:
        with self._mu:
            return {
                "out_dir": self.out_dir,
                "triggered_total": self.triggered_total,
                "suppressed_total": self.suppressed_total,
                "sources": sorted(self._sources),
            }
