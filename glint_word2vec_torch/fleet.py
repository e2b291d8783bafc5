"""The self-healing replica fleet (counterpart of the first half of
``glint_word2vec_tpu/fleet.py``): N supervised serving replicas behind one
breaker-aware load balancer, with rolling generation rollout and a
shadow-canary promotion gate.

* :class:`LoadBalancer`: a raw-socket HTTP proxy with a
  :class:`ReplicaBreaker` per replica (closed / open / half-open), driven
  by an active ``/healthz`` prober and by the data plane's own connection
  verdicts: K consecutive failures eject a replica from rotation, a
  cooldown half-opens it for prober trials, and M consecutive successes
  readmit it. A shed (429/503) is retried on the next replica, and when
  every replica sheds the balancer relays the shed with its
  ``Retry-After``. ``GET /metrics`` merges the replicas' snapshots
  (``obs/aggregate.merge_serving_snapshots``); ``POST /shutdown`` fans out.
* :class:`FleetSupervisor`: launches the replica processes (``python -m
  glint_word2vec_torch.cli serve --device <dev>``), watches them by
  ``waitpid`` (crashes) and by sustained probe failure (hangs, with the
  ``GLINT_FLEET_GEN`` handshake, so a process of an earlier launch never
  answers for the new one), and relaunches them from the fleet's current
  model directory under capped exponential backoff and a per-replica
  restart budget.
* :class:`RolloutCoordinator`: when ``LATEST.json`` moves, replicas are
  swapped one at a time (breaker hold, drain, ``POST /reload``, wait until
  healthy with no new query shape, readmit), so the fleet never serves
  from fewer than N-1. Before that, the shadow canary stages the candidate
  on one held replica, mirrors a sample of live queries and probe queries
  to it, and scores its top-k agreement with the live fleet; a regression
  is held back, with the canary restored to the live generation first.

The demand-driven half:

* Balancer shard processes (:func:`run_balancer_shard`,
  :class:`BalancerShardManager`): ``balancer_procs`` data planes share the
  fleet's listen port (``SO_REUSEPORT``, else the parent's listener
  inherited by fd), each with its own breakers, prober and threads; the
  supervisor drives them over a private control listener, and every hold,
  release, adoption, down and fail is broadcast to every shard.
* Warm spares and the :class:`Autoscaler`: spares boot and warm with the
  fleet, then are parked (held by the owner ``autoscale`` in the
  :class:`ReplicaHoldLedger`); the shed rate, the windowed forward-path
  p95, open breakers and fast burns readmit one, and a sustained calm
  parks the highest live one again. A rollout in progress pins the set.
* QoS admission (:class:`QosConfig`, :class:`QosGate`): an infeasible
  ``X-Glint-Deadline-Ms`` is shed before a tenant token is spent, then the
  per-tenant token bucket (per shard), then the ``bulk`` class's in-flight
  cap; a shed is a 429 with ``Retry-After``.
* Fleet tracing (``trace_dir``): the balancer and each shard record their
  spans beside each replica's ``--trace-log``, and the balancer's flight
  recorder writes its bundles under ``flight/``; ``cli trace-merge``
  stitches the files into one timeline.

The fault points ``fleet.replica_probe``, ``fleet.rollout_step``,
``fleet.shard_accept`` and ``fleet.autoscale_step`` (and
``serving.reload`` on the replicas) drill those windows. Nothing here
touches a device: the replicas hold the tables, so a balancer crash leaves
N servers that answer on their own, and a shard process holds no CUDA
context.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import random
import socket
import subprocess
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from glint_word2vec_torch.obs import events as obs_events
from glint_word2vec_torch.obs.slo import FlightRecorder, SloEngine
from glint_word2vec_torch.parallel.supervisor import (
    capped_backoff,
    terminate_process,
)
from glint_word2vec_torch.utils import faults
from glint_word2vec_torch.utils.metrics import LatencyHistogram

logger = logging.getLogger(__name__)

#: Device paths the balancer keeps latency and SLO state for on its own
#: forward path (``serving._DEVICE_PATHS``). QoS admission applies to
#: these paths only; control routes are never shed.
_BALANCER_PATHS = (
    "/synonyms", "/synonyms_vector", "/analogy", "/vector", "/transform",
)


def _strip_model_prefix(path: str) -> str:
    """The endpoint path without a ``/m/<id>`` model prefix
    (``serving.split_model_path``'s path half): QoS admission and the
    balancer's histograms count ``/m/a/synonyms`` as ``/synonyms``, while
    the whole path is what goes to the replica."""
    if path.startswith("/m/"):
        sep = path.find("/", 3)
        return path[sep:] if sep >= 0 else "/"
    return path

#: Client headers the balancer reads (QoS admission) and forwards to the
#: replica as they came: the tenant and priority class, and the remaining
#: deadline (milliseconds) the replica tightens its own with.
_QOS_WIRE_HEADERS = (
    ("X-Glint-Tenant", "x-glint-tenant"),
    ("X-Glint-Priority", "x-glint-priority"),
    ("X-Glint-Deadline-Ms", "x-glint-deadline-ms"),
)


def _passthrough_headers(headers: dict) -> Optional[dict]:
    """QoS/deadline headers to forward replica-ward, wire-cased."""
    out = None
    for wire, low in _QOS_WIRE_HEADERS:
        v = headers.get(low)
        if v:
            if out is None:
                out = {}
            out[wire] = v
    return out


def _parse_retry_after(headers: dict) -> Optional[float]:
    """Seconds from a (lowercase-keyed) response header dict, or None.
    Only the delta-seconds form — everything in this stack emits it."""
    v = headers.get("retry-after") if headers else None
    if v is None:
        return None
    try:
        return max(0.0, float(v))
    except (TypeError, ValueError):
        return None


def _read_request(sock, buf: bytearray):
    """Read one HTTP/1.1 request off a keep-alive socket: returns
    (method, path, lowercase-header dict, body) or None on a clean
    close between requests. Raises on transport errors or malformed
    framing. Content-Length framing only — the serving stack (and
    every client of it) never chunks."""
    while True:
        head_end = buf.find(b"\r\n\r\n")
        if head_end >= 0:
            break
        chunk = sock.recv(65536)
        if not chunk:
            if buf:
                raise ConnectionError("client closed mid-request")
            return None
        buf += chunk
    head = bytes(buf[:head_end]).decode("latin-1")
    lines = head.split("\r\n")
    parts = lines[0].split(None, 2)
    if len(parts) < 3:
        raise ValueError(f"malformed request line: {lines[0]!r}")
    method, path = parts[0], parts[1]
    headers = {}
    for line in lines[1:]:
        k, _, v = line.partition(":")
        headers[k.strip().lower()] = v.strip()
    clen = int(headers.get("content-length", 0))
    body_end = head_end + 4 + clen
    while len(buf) < body_end:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("client closed mid-body")
        buf += chunk
    body = bytes(buf[head_end + 4 : body_end])
    del buf[:body_end]
    return method, path, headers, body

#: Statuses that mean "this replica cannot take the request right now,
#: another one might": bounded admission / degraded mode (429), plus
#: 503 for a replica mid-restart behind a stale port. 404/400/504 are
#: NOT retried — they are answers about the request, not the replica.
_SHED_STATUSES = frozenset((429, 503))


class ReplicaBreaker:
    """Per-replica circuit breaker: closed / open / half-open.

    Fed by BOTH failure signals — the active health prober's verdicts
    and the data plane's own connection errors. ``fail_threshold``
    consecutive failures open the breaker (the replica is ejected from
    rotation, so clients stop paying its timeouts); after
    ``open_seconds`` the prober half-opens it with trial probes, and
    ``success_threshold`` consecutive successes re-close it. A
    half-open trial failure re-opens immediately.

    Separately from the state machine, an **administrative hold**
    (:meth:`hold` / :meth:`release`) takes the replica out of client
    rotation regardless of health — the rollout coordinator's drain
    seam, and what keeps a canary staging a CANDIDATE generation from
    ever serving live traffic.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, *, fail_threshold: int = 3,
                 success_threshold: int = 2,
                 open_seconds: float = 2.0):
        self.fail_threshold = max(1, int(fail_threshold))
        self.success_threshold = max(1, int(success_threshold))
        self.open_seconds = float(open_seconds)
        self._mu = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0          # consecutive (closed-state) failures
        self._trial_successes = 0   # consecutive half-open successes
        self._opened_at: Optional[float] = None
        self._failing_since: Optional[float] = None
        self._held = 0
        self._opened_total = 0
        self._reopened_total = 0
        self._closed_total = 0
        self._probe_failures = 0
        self._probe_successes = 0
        #: Invoked on every CLOSED -> OPEN transition (a genuinely
        #: healthy replica just got ejected), OUTSIDE ``_mu`` — the
        #: flight recorder's breaker-trip snapshot hook scrapes every
        #: replica and must never run under the breaker lock. Cooldown
        #: refreshes and half-open re-opens do not re-fire.
        self.on_open: Optional[Callable[[], None]] = None

    def _fire_on_open(self) -> None:
        cb = self.on_open
        if cb is not None:
            try:
                cb()
            except Exception:  # pragma: no cover - defensive
                logger.exception("breaker on_open hook failed")

    def record_failure(self, probe: bool = False) -> None:
        """One failed probe or data-plane connection attempt."""
        opened = False
        with self._mu:
            if probe:
                self._probe_failures += 1
            if self._failing_since is None:
                self._failing_since = time.monotonic()
            if self._state == self.HALF_OPEN:
                # A failed trial re-opens immediately: the replica is
                # still bouncing, restart its cooldown.
                self._state = self.OPEN
                self._opened_at = time.monotonic()
                self._trial_successes = 0
                self._reopened_total += 1
            elif self._state == self.CLOSED:
                self._failures += 1
                if self._failures >= self.fail_threshold:
                    self._state = self.OPEN
                    self._opened_at = time.monotonic()
                    self._opened_total += 1
                    opened = True
        if opened:
            self._fire_on_open()

    def record_success(self, probe: bool = False) -> None:
        """One healthy probe answer or successful proxied exchange."""
        with self._mu:
            if probe:
                self._probe_successes += 1
            self._failing_since = None
            if self._state == self.HALF_OPEN:
                self._trial_successes += 1
                if self._trial_successes >= self.success_threshold:
                    self._state = self.CLOSED
                    self._failures = 0
                    self._trial_successes = 0
                    self._opened_at = None
                    self._closed_total += 1
            elif self._state == self.CLOSED:
                self._failures = 0

    def maybe_half_open(self) -> bool:
        """Prober seam: move open -> half-open once the cooldown
        elapsed. Returns True when the replica should receive a trial
        probe (it is half-open), False while still cooling (no traffic,
        no probes) or not open at all."""
        with self._mu:
            if (self._state == self.OPEN and self._opened_at is not None
                    and time.monotonic() - self._opened_at
                    >= self.open_seconds):
                self._state = self.HALF_OPEN
                self._trial_successes = 0
            return self._state == self.HALF_OPEN

    def force_open(self) -> None:
        """Supervisor seam: the replica process is KNOWN dead or
        restarting — eject immediately and keep refreshing the cooldown
        so no trial traffic flows until the supervisor readmits it."""
        opened = False
        with self._mu:
            if self._state == self.CLOSED:
                self._opened_total += 1
                opened = True
            self._state = self.OPEN
            self._opened_at = time.monotonic()
            self._trial_successes = 0
        if opened:
            self._fire_on_open()

    def trial(self) -> None:
        """Supervisor seam: a relaunched replica adopted a fresh
        address — go straight to half-open so it earns readmission
        through ``success_threshold`` probe successes (a fresh worker
        is not trusted until it proves healthy)."""
        with self._mu:
            self._state = self.HALF_OPEN
            self._trial_successes = 0
            self._failures = 0
            self._failing_since = None

    def hold(self) -> None:
        """Administrative ejection (rollout drain / canary staging)."""
        with self._mu:
            self._held += 1

    def release(self) -> None:
        with self._mu:
            self._held = max(0, self._held - 1)

    def clear_holds(self) -> None:
        """Supervisor seam, called when a RELAUNCHED replica's fresh
        address is adopted: any hold belonged to its previous
        incarnation (a rollout drain or canary staging that died under
        it) and the new process boots from the fleet's promoted
        generation — leaving the hold would park the replica serving
        nothing forever."""
        with self._mu:
            self._held = 0

    def held(self) -> bool:
        with self._mu:
            return self._held > 0

    def eligible(self) -> bool:
        """Whether client traffic may route here: closed and not
        administratively held."""
        with self._mu:
            return self._state == self.CLOSED and self._held == 0

    def state(self) -> str:
        with self._mu:
            return self._state

    def failing_for(self) -> float:
        """Seconds of CONTINUOUS failure (0.0 while healthy) — the
        fleet supervisor's hung-replica signal."""
        with self._mu:
            fs = self._failing_since
            return 0.0 if fs is None else time.monotonic() - fs

    def snapshot(self) -> dict:
        with self._mu:
            fs = self._failing_since
            return {
                "state": self._state,
                "held": self._held > 0,
                "consecutive_failures": self._failures,
                "trial_successes": self._trial_successes,
                "opened_total": self._opened_total,
                "reopened_total": self._reopened_total,
                "closed_total": self._closed_total,
                "probe_failures_total": self._probe_failures,
                "probe_successes_total": self._probe_successes,
                "failing_seconds": (
                    round(time.monotonic() - fs, 2)
                    if fs is not None else 0.0
                ),
            }


class _ReplicaConn:
    """One persistent keep-alive socket to a replica with a minimal
    HTTP/1.1 reader — the balancer's per-request cost IS the fleet's
    overhead floor, so the proxy hop skips ``http.client`` entirely.
    Owned by exactly one handler thread (per-thread pools), so no
    locking. The replica always answers Content-Length-framed JSON
    (serving.py's ``_send``)."""

    __slots__ = ("host", "port", "timeout", "addr_version", "_sock",
                 "_buf", "_sent", "_prefix")

    def __init__(self, host: str, port: int, timeout: float,
                 addr_version: int = 0):
        self.host, self.port, self.timeout = host, port, timeout
        #: Balancer address-table version this connection was built
        #: against: a supervisor relaunch bumps it, and the pool drops
        #: conns whose version is stale (a relaunched replica lives on
        #: a fresh ephemeral port).
        self.addr_version = addr_version
        self._sock = None
        self._buf = bytearray()
        self._sent = False
        self._prefix = (
            f"Host: {host}:{port}\r\n"
            "Content-Type: application/json\r\n"
            "Content-Length: "
        )

    def _connect(self):
        s = socket.create_connection(
            (self.host, self.port), timeout=self.timeout
        )
        # NODELAY: requests/responses are small multi-segment writes;
        # Nagle + delayed ACK turns each proxied call into a ~40ms
        # stall otherwise (the server's own fix, outbound).
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s
        self._buf.clear()
        return s

    def roundtrip(self, method: str, path: str, body: bytes,
                  retryable: Optional[bool] = None,
                  trace_id: Optional[str] = None,
                  extra_headers: Optional[dict] = None):
        """One request/response exchange; returns (status, body,
        header-dict with lowercase keys). Raises on any transport
        error (caller drops the connection and tries the next
        replica). ``trace_id`` propagates the balancer's request trace
        to the replica (the ``X-Glint-Trace`` wire header).

        A stale keep-alive socket after a replica bounce fails in one
        of two places: the send (nothing reached a handler — always
        safe to retry on a fresh connection) or the receive AFTER a
        locally-"successful" send into a dead socket's buffer. The
        recv-side retry is taken exactly once and only for idempotent
        requests (GETs by default; override with ``retryable``) — a
        bounced replica then costs the client nothing instead of a
        surfaced transport error."""
        if retryable is None:
            retryable = method == "GET"
        trace_hdr = (
            f"{obs_events.TRACE_HEADER}: {trace_id}\r\n"
            if trace_id else ""
        )
        if extra_headers:
            trace_hdr += "".join(
                f"{k}: {v}\r\n" for k, v in extra_headers.items()
            )
        req = (
            f"{method} {path} HTTP/1.1\r\n{trace_hdr}{self._prefix}"
            f"{len(body)}\r\n\r\n"
        ).encode("latin-1") + body
        try:
            return self._exchange(req)
        except OSError:
            if self._sent and not retryable:
                raise
            self.close()
            self._connect()
            return self._exchange(req)

    def _exchange(self, req: bytes):
        sock = self._sock or self._connect()
        self._sent = False
        sock.sendall(req)
        self._sent = True
        buf = self._buf
        while True:
            head_end = buf.find(b"\r\n\r\n")
            if head_end >= 0:
                break
            chunk = sock.recv(65536)
            if not chunk:
                raise ConnectionError("replica closed mid-response")
            buf += chunk
        head = bytes(buf[:head_end]).decode("latin-1")
        lines = head.split("\r\n")
        status = int(lines[0].split(None, 2)[1])
        headers = {}
        clen = 0
        for line in lines[1:]:
            k, _, v = line.partition(":")
            k = k.strip().lower()
            v = v.strip()
            headers[k] = v
            if k == "content-length":
                clen = int(v)
        body_end = head_end + 4 + clen
        while len(buf) < body_end:
            chunk = sock.recv(65536)
            if not chunk:
                raise ConnectionError("replica closed mid-body")
            buf += chunk
        rbody = bytes(buf[head_end + 4 : body_end])
        del buf[:body_end]
        return status, rbody, headers

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None


class _BalancerMetrics:
    """The balancer's forward-path observability: one log-spaced latency
    histogram and an error count per device path, and a small
    :class:`SloEngine` over the objectives the replicas use. Its snapshot
    has a serving snapshot's shape (``endpoints`` and ``slo`` only), so it
    folds through ``obs/aggregate.merge_serving_snapshots`` as a
    replica's does."""

    def __init__(self, paths=_BALANCER_PATHS):
        self._mu = threading.Lock()
        self._paths = frozenset(paths)
        self._hists: Dict[str, LatencyHistogram] = {}
        self._errors: Dict[str, int] = {}
        self.slo = SloEngine.default_serving(paths)
        # p95 cache for the deadline-aware shed check: recomputed at
        # most every _P95_TTL seconds — quantile() walks 65 buckets,
        # too hot for every admission.
        self._p95: Dict[str, Tuple[float, float]] = {}

    _P95_TTL = 0.5

    def observe(self, path: str, seconds: float, status: int) -> None:
        if path not in self._paths:
            return
        with self._mu:
            h = self._hists.get(path)
            if h is None:
                h = self._hists[path] = LatencyHistogram()
                self._errors[path] = 0
            h.record(seconds)
            if int(status) >= 500:
                self._errors[path] += 1
        self.slo.observe(path, seconds, status)

    def p95_ms(self, path: str) -> Optional[float]:
        """Current p95 for ``path`` in ms (cached ~0.5s); None before
        any traffic — a deadline cannot be judged infeasible against
        nothing."""
        now = time.monotonic()
        with self._mu:
            cached = self._p95.get(path)
            if cached is not None and now - cached[0] < self._P95_TTL:
                return cached[1]
            h = self._hists.get(path)
            if h is None or h.n == 0:
                return None
            val = h.quantile(0.95) * 1e3
            self._p95[path] = (now, val)
            return val

    def snapshot(self) -> dict:
        with self._mu:
            endpoints = {}
            for path, h in self._hists.items():
                endpoints[path] = {
                    "count": h.n,
                    "errors": self._errors[path],
                    "p50_ms": round(h.quantile(0.50) * 1e3, 3),
                    "p95_ms": round(h.quantile(0.95) * 1e3, 3),
                    "p99_ms": round(h.quantile(0.99) * 1e3, 3),
                    "mean_ms": round(h.total / max(h.n, 1) * 1e3, 3),
                    "max_ms": round(h.max * 1e3, 3),
                    "hist": h.state(),
                }
        return {"endpoints": endpoints, "slo": self.slo.snapshot()}



def _parse_deadline_ms(headers: dict) -> Optional[float]:
    v = headers.get("x-glint-deadline-ms")
    if v is None:
        return None
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


@dataclass
class QosConfig:
    """QoS admission knobs for the balancer's device paths. Everything
    defaults to off: a fleet without QoS flags admits every request
    (deadline headers still go on to the replicas).

    ``tenant_rate``/``tenant_burst``: per-tenant token bucket (req/s,
    burst tokens) keyed on ``X-Glint-Tenant`` (the ``default`` bucket
    otherwise); ``bulk_max_inflight`` caps concurrently-forwarded
    requests in the ``bulk`` priority class (``X-Glint-Priority:
    bulk``; anything else is ``interactive``). Deadline-aware shedding
    is armed by the REQUEST (``X-Glint-Deadline-Ms``): a budget that
    cannot cover the balancer's current p95 for the path is shed
    immediately with Retry-After instead of occupying a replica slot
    to time out."""

    tenant_rate: Optional[float] = None
    tenant_burst: Optional[float] = None
    bulk_max_inflight: Optional[int] = None
    #: Distinct tenant buckets tracked; overflow tenants share the
    #: ``other`` bucket (bounded cardinality on /metrics too).
    max_tenants: int = 32


class _TokenBucket:
    __slots__ = ("rate", "burst", "tokens", "t")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self.t = now

    def take(self, now: float) -> bool:
        self.tokens = min(
            self.burst, self.tokens + (now - self.t) * self.rate
        )
        self.t = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class _QosDecision:
    """One admission verdict: ``shed`` is None on admit, else
    (status, body-obj, retry-after string); an admitted bulk request
    holds a bulk-inflight slot until :meth:`QosGate.release`."""

    __slots__ = ("shed", "cls", "tenant", "bulk_slot")

    def __init__(self, shed, cls, tenant, bulk_slot=False):
        self.shed = shed
        self.cls = cls
        self.tenant = tenant
        self.bulk_slot = bulk_slot


class QosGate:
    """Admission control at the fleet edge: deadline feasibility, then
    per-tenant token buckets, then the bulk-class inflight cap. Sheds
    are 429 + Retry-After — honest backpressure in the same shape the
    replicas' bounded admission emits, so clients need one retry
    policy."""

    def __init__(self, config: QosConfig,
                 p95_ms: Callable[[str], Optional[float]],
                 now_fn: Callable[[], float] = time.monotonic):
        self.config = config
        self._p95 = p95_ms
        self._now = now_fn
        self._mu = threading.Lock()
        self._buckets: Dict[str, _TokenBucket] = {}
        self._admitted = {"interactive": 0, "bulk": 0}
        self._shed = {"tenant_quota": 0, "bulk_inflight": 0, "deadline": 0}
        self._tenant_shed: Dict[str, int] = {}
        self._bulk_inflight = 0
        self._bulk_inflight_peak = 0

    def _tenant_key(self, tenant: str) -> str:
        if tenant in self._buckets or tenant in self._tenant_shed:
            return tenant
        tracked = set(self._buckets) | set(self._tenant_shed)
        if len(tracked) >= self.config.max_tenants:
            return "other"
        return tenant

    def _count_shed(self, reason: str, tenant: str) -> None:
        self._shed[reason] += 1
        self._tenant_shed[tenant] = self._tenant_shed.get(tenant, 0) + 1

    def admit(self, path: str, headers: dict) -> _QosDecision:
        cfg = self.config
        tenant = headers.get("x-glint-tenant") or "default"
        cls = (
            "bulk"
            if headers.get("x-glint-priority", "").lower() == "bulk"
            else "interactive"
        )
        now = self._now()
        with self._mu:
            tenant = self._tenant_key(tenant)
            # Deadline feasibility first: an expired-or-infeasible
            # budget is shed before it spends a quota token — the
            # client pays nothing for a request that could only 504.
            budget_ms = _parse_deadline_ms(headers)
            if budget_ms is not None:
                p95 = self._p95(path)
                if budget_ms <= 0.0 or (
                        p95 is not None and budget_ms < p95):
                    self._count_shed("deadline", tenant)
                    return _QosDecision((
                        429,
                        {
                            "error": "deadline infeasible",
                            "deadline_ms": budget_ms,
                            "p95_ms": p95,
                        },
                        "1",
                    ), cls, tenant)
            if cfg.tenant_rate:
                b = self._buckets.get(tenant)
                if b is None:
                    burst = (
                        cfg.tenant_burst
                        if cfg.tenant_burst is not None
                        else 2.0 * cfg.tenant_rate
                    )
                    b = self._buckets[tenant] = _TokenBucket(
                        cfg.tenant_rate, burst, now
                    )
                if not b.take(now):
                    self._count_shed("tenant_quota", tenant)
                    retry = max(1.0 / cfg.tenant_rate, 0.05)
                    return _QosDecision((
                        429,
                        {"error": "tenant quota exceeded",
                         "tenant": tenant},
                        f"{retry:g}",
                    ), cls, tenant)
            if cls == "bulk" and cfg.bulk_max_inflight:
                if self._bulk_inflight >= cfg.bulk_max_inflight:
                    self._count_shed("bulk_inflight", tenant)
                    return _QosDecision((
                        429,
                        {"error": "bulk class at capacity",
                         "max_inflight": cfg.bulk_max_inflight},
                        "0.1",
                    ), cls, tenant)
                self._bulk_inflight += 1
                if self._bulk_inflight > self._bulk_inflight_peak:
                    self._bulk_inflight_peak = self._bulk_inflight
                self._admitted[cls] += 1
                return _QosDecision(None, cls, tenant, bulk_slot=True)
            self._admitted[cls] += 1
            return _QosDecision(None, cls, tenant)

    def release(self, decision: _QosDecision) -> None:
        if decision.bulk_slot:
            with self._mu:
                self._bulk_inflight = max(0, self._bulk_inflight - 1)

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "admitted_total": dict(self._admitted),
                "shed_total": dict(self._shed),
                "per_tenant_shed_total": dict(self._tenant_shed),
                "bulk_inflight": self._bulk_inflight,
                "bulk_inflight_peak": self._bulk_inflight_peak,
            }


class LoadBalancer:
    """Round-robin HTTP proxy over serving replicas with per-replica
    circuit breakers, overload-aware retry, and a merged fleet
    exposition.

    Routes:
      GET  /healthz   fleet health: replicas up/total (200 while >= 1 up)
      GET  /metrics   merged fleet snapshot (JSON; ?format=prometheus
                      renders the merged serving exposition + the
                      glint_fleet_* balancer/breaker/rollout families)
      POST /shutdown  fan-out shutdown to every replica, then stop
      anything else   proxied to a replica (round robin over CLOSED
                      breakers; sheds retried on the next replica,
                      exhaustion relays the shed; open breakers are a
                      last resort, held replicas never serve)
    """

    #: Same-replica retries for a connection-refused inside a KNOWN
    #: restart window (the supervisor may land the relaunched
    #: replica's fresh address mid-retry).
    RESTART_RETRIES = 3
    RESTART_RETRY_BASE = 0.1

    #: When EVERY replica sheds, a replica-advertised Retry-After up to
    #: this many seconds is honored — back off max(jitter, Retry-After)
    #: then take ONE more full pass before relaying the shed. Larger
    #: values are relayed to the client immediately: parking a proxy
    #: thread for seconds would turn backpressure into queueing.
    RETRY_AFTER_CAP = 0.5

    def __init__(self, replica_urls: List[str], host: str = "127.0.0.1",
                 port: int = 0, *, scrape_timeout: float = 2.0,
                 proxy_timeout: float = 60.0,
                 breaker_failures: int = 3,
                 breaker_successes: int = 2,
                 breaker_open_seconds: float = 2.0,
                 probe_interval: float = 0.5,
                 probe_timeout: float = 2.0,
                 reuse_port: bool = False,
                 listen_fd: Optional[int] = None,
                 control: bool = False,
                 shard_id: int = 0,
                 proxy_control: Optional[Tuple[str, int]] = None,
                 qos: Optional[QosConfig] = None):
        self.replicas = [self._parse(u) for u in replica_urls]
        if not self.replicas:
            raise ValueError("at least one replica url required")
        self.scrape_timeout = float(scrape_timeout)
        self.proxy_timeout = float(proxy_timeout)
        self.probe_interval = max(0.02, float(probe_interval))
        self.probe_timeout = float(probe_timeout)
        #: Which data-plane process this balancer is (0: the one in the
        #: supervisor; 1 and up: a ``fleet-shard`` process sharing the
        #: listen port).
        self.shard_id = int(shard_id)
        #: (host, port) of the supervisor balancer's control listener: a
        #: shard process relays ``/metrics`` and ``/shutdown`` there, since
        #: the shared data port cannot address one process and only the
        #: supervisor renders the fleet's document or tears it down.
        self.proxy_control = proxy_control
        self._mu = threading.Lock()
        self._rr = 0
        self._proxied = [0] * len(self.replicas)
        self._errors = [0] * len(self.replicas)
        self._shed_retries = 0
        self._exhausted = 0
        self._breaker_skips = 0
        self._restart_retries = 0
        self._retry_after_honored = 0
        #: Forward-path latency and SLO state of this shard (a
        #: serving-shaped snapshot; shards fold through
        #: ``merge_serving_snapshots``).
        self.metrics = _BalancerMetrics()
        self.qos = (
            QosGate(qos, self.metrics.p95_ms) if qos is not None else None
        )
        self._addr_version = [0] * len(self.replicas)
        self._expected_gen: List[Optional[str]] = [None] * len(self.replicas)
        self._restarting = [False] * len(self.replicas)
        #: Shadow-mirror state (canary evaluations): None when off;
        #: else {"paths", "every", "seen", "queue", "dropped"} guarded
        #: by ``_mu`` — the coordinator drains the bounded queue.
        self._mirror: Optional[dict] = None
        self.breakers = [
            ReplicaBreaker(
                fail_threshold=breaker_failures,
                success_threshold=breaker_successes,
                open_seconds=breaker_open_seconds,
            )
            for _ in self.replicas
        ]
        #: Extra top-level blocks merged into ``metrics_doc`` (the
        #: fleet supervisor's restart/rollout/canary accounting).
        self.doc_extra: Optional[Callable[[], dict]] = None
        #: Invoked at the START of a POST /shutdown, before replicas
        #: are told to exit — the supervisor's don't-restart-the-dead
        #: flag must be up before the first replica goes down.
        self.on_shutdown: Optional[Callable[[], None]] = None
        #: Armed by :meth:`enable_flight_recorder`: the fleet-wide
        #: anomaly bundle writer, triggered by breaker CLOSED -> OPEN
        #: transitions.
        self.flight: Optional[FlightRecorder] = None
        self._local = threading.local()
        # Data plane: a thread a connection over raw sockets with a
        # minimal HTTP/1.1 parser instead of ThreadingHTTPServer, whose
        # header parsing and date formatting cost more interpreter time
        # a request than the proxy hop itself; the balancer must stay the
        # cheapest stage of the chain.
        self._reuse_port = bool(reuse_port) and hasattr(
            socket, "SO_REUSEPORT"
        )
        if listen_fd is not None:
            # Without SO_REUSEPORT: adopt the listening socket the parent
            # bound and passed down (pass_fds), so every shard accepts
            # from one shared queue.
            self._listener = socket.socket(fileno=listen_fd)
        else:
            self._listener = socket.socket(
                socket.AF_INET, socket.SOCK_STREAM
            )
            self._listener.setsockopt(
                socket.SOL_SOCKET, socket.SO_REUSEADDR, 1
            )
            if self._reuse_port:
                self._listener.setsockopt(
                    socket.SOL_SOCKET, socket.SO_REUSEPORT, 1
                )
            self._listener.bind((host, port))
            self._listener.listen(128)
        self.host, self.port = self._listener.getsockname()[:2]
        self._inherited_listener = listen_fd is not None
        self._shared_listener = self._reuse_port or self._inherited_listener
        if self._shared_listener:
            # stop() cannot wake accept() with a self-connect here: on a
            # shared port the kernel may hand that connection to a
            # sibling shard. A bounded accept timeout makes the loop
            # re-check _stop on its own clock instead.
            self._listener.settimeout(1.0)
        #: This process's private control listener (127.0.0.1, ephemeral):
        #: the supervisor addresses one shard through it
        #: (``/_shard/snapshot``, ``/_shard/control``, ``/_shard/stop``),
        #: which the shared data port cannot do.
        self._control_listener = None
        if control:
            self._control_listener = socket.socket(
                socket.AF_INET, socket.SOCK_STREAM
            )
            self._control_listener.setsockopt(
                socket.SOL_SOCKET, socket.SO_REUSEADDR, 1
            )
            self._control_listener.bind(("127.0.0.1", 0))
            self._control_listener.listen(16)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._control_thread: Optional[threading.Thread] = None
        self._prober: Optional[threading.Thread] = None
        self._prev_switch: Optional[float] = None

    @property
    def control_addr(self) -> Optional[Tuple[str, int]]:
        if self._control_listener is None:
            return None
        return self._control_listener.getsockname()[:2]

    # -- data plane ----------------------------------------------------

    _STATUS_LINE = {
        code: f"HTTP/1.1 {code} {reason}\r\n".encode("latin-1")
        for code, reason in (
            (200, "OK"), (400, "Bad Request"), (404, "Not Found"),
            (429, "Too Many Requests"), (500, "Internal Server Error"),
            (503, "Service Unavailable"), (504, "Gateway Timeout"),
        )
    }

    def _respond(self, sock, code: int, body: bytes, ctype: str,
                 retry_after: Optional[str] = None) -> None:
        head = self._STATUS_LINE.get(
            code, f"HTTP/1.1 {code} X\r\n".encode("latin-1")
        )
        extra = (
            f"Retry-After: {retry_after}\r\n" if retry_after else ""
        )
        sock.sendall(
            head
            + (
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n{extra}\r\n"
            ).encode("latin-1")
            + body
        )

    def _respond_json(self, sock, code: int, obj,
                      retry_after: Optional[str] = None) -> None:
        self._respond(
            sock, code, json.dumps(obj).encode(), "application/json",
            retry_after,
        )

    def _accept_loop(self) -> None:
        self._accept_on(self._listener)

    def _control_accept_loop(self) -> None:
        self._accept_on(self._control_listener)

    def _accept_on(self, listener) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = listener.accept()
            except socket.timeout:
                continue  # a shared-port shard re-checks _stop
            except OSError:
                return  # listener closed by stop()
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True,
                name="glint-fleet-conn",
            ).start()

    def _serve_conn(self, sock) -> None:
        """One client connection: parse requests with the minimal
        framed reader, route control paths locally, proxy the rest.
        Keep-alive by default (HTTP/1.1); 'Connection: close' honored."""
        try:
            faults.fire("fleet.shard_accept")
        except Exception:
            sock.close()
            return
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        buf = bytearray()
        try:
            while not self._stop.is_set():
                req = _read_request(sock, buf)
                if req is None:
                    return  # client closed between requests
                method, path, headers, body = req
                self._route(sock, method, path, headers, body)
                if headers.get("connection", "").lower() == "close":
                    return
        except (OSError, ValueError, ConnectionError):
            pass  # torn client connection / malformed request
        finally:
            sock.close()
            pool = getattr(self._local, "conns", None)
            if pool:
                for c in pool.values():
                    c.close()
                pool.clear()

    def _route(self, sock, method: str, path: str, headers: dict,
               body: bytes) -> None:
        url = urlparse(path)
        if url.path.startswith("/_shard/"):
            return self._route_shard(sock, method, url.path, body)
        if self.proxy_control is not None and (
                (method == "GET" and url.path == "/metrics")
                or (method == "POST" and url.path == "/shutdown")):
            # A shard process: the fleet's merged document and the fleet's
            # teardown live with the supervisor's balancer; relay.
            return self._proxy_to_control(sock, method, path, body)
        if method == "GET" and url.path == "/healthz":
            up, total, states = self.health()
            return self._respond_json(sock, 200 if up else 503, {
                "status": "ok" if up == total else (
                    "degraded" if up else "down"
                ),
                "replicas": total,
                "replicas_up": up,
                "replica_states": states,
            })
        if method == "GET" and url.path == "/metrics":
            doc = self.metrics_doc()
            fmt = parse_qs(url.query).get("format", ["json"])[0]
            if fmt == "prometheus":
                from glint_word2vec_torch.obs.prometheus import (
                    fleet_to_prometheus,
                    serving_to_prometheus,
                )

                text = fleet_to_prometheus(doc)
                if doc.get("fleet"):
                    text += serving_to_prometheus(doc["fleet"])
                return self._respond(
                    sock, 200, text.encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            return self._respond_json(sock, 200, doc)
        if method == "POST" and url.path == "/shutdown":
            if self.on_shutdown is not None:
                self.on_shutdown()
            results = self.shutdown_fleet()
            self._respond_json(sock, 200, {
                "status": "shutting down fleet",
                "replicas": results,
            })
            threading.Thread(target=self.stop, daemon=True).start()
            return
        # QoS admission (device paths only): deadline feasibility, the
        # tenant's quota, the bulk class's cap. A shed answers here,
        # before a replica slot or a proxy exchange is taken.
        t0 = time.monotonic()
        decision = None
        ep = _strip_model_prefix(url.path)
        if self.qos is not None and ep in _BALANCER_PATHS:
            decision = self.qos.admit(ep, headers)
            if decision.shed is not None:
                status, obj, retry_after = decision.shed
                self.metrics.observe(
                    ep, time.monotonic() - t0, status
                )
                return self._respond_json(
                    sock, status, obj, retry_after=retry_after
                )
        # Adopt the client's trace id or mint one at the fleet edge: the
        # balancer hop's span wraps the proxy exchange, and the id rides
        # the wire header to the replica.
        tr = obs_events.request_trace(
            headers.get(obs_events.TRACE_HEADER.lower())
        )
        try:
            with tr.phase("req.accept", path=url.path, hop="balancer"):
                status, rbody, rheaders = self.forward(
                    method, path, body, trace=tr,
                    extra_headers=_passthrough_headers(headers),
                )
        finally:
            if decision is not None:
                self.qos.release(decision)
        tr.finish(status)
        self.metrics.observe(ep, time.monotonic() - t0, status)
        self._respond(
            sock, status, rbody,
            rheaders.get("content-type") or "application/json",
            rheaders.get("retry-after"),
        )

    # -- shard control channel (multi-process data plane) ------------

    def _route_shard(self, sock, method: str, path: str,
                     body: bytes) -> None:
        """The per-shard control surface the supervisor drives over
        each shard's private control listener: snapshot (local
        counters only — never scrapes replicas), breaker/address
        mirror ops, and stop."""
        if method == "GET" and path == "/_shard/snapshot":
            return self._respond_json(sock, 200, self.shard_snapshot())
        if method == "POST" and path == "/_shard/control":
            try:
                op = json.loads(body.decode() or "{}")
                out = self.apply_control(op)
            except (ValueError, KeyError, IndexError, TypeError) as e:
                return self._respond_json(
                    sock, 400, {"ok": False, "error": str(e)}
                )
            return self._respond_json(sock, 200, out)
        if method == "POST" and path == "/_shard/stop":
            self._respond_json(sock, 200, {"ok": True, "stopping": True})
            threading.Thread(target=self.stop, daemon=True).start()
            return
        return self._respond_json(sock, 404, {"error": "not found"})

    def shard_snapshot(self) -> dict:
        """This shard's own data-plane state: balancer counters,
        breaker views, and the serving-shaped forward-path block the
        supervisor folds through ``merge_serving_snapshots``."""
        return {
            "shard": self.shard_id,
            "up": True,
            "stats": self.balancer_stats(),
            "breakers": [b.snapshot() for b in self.breakers],
            "serving": self.metrics.snapshot(),
        }

    def apply_control(self, op: dict) -> dict:
        """Apply one supervisor mirror op. The supervisor owns the
        single control plane; shards replicate its address-table and
        breaker decisions so every data plane routes consistently
        while breaker STATE (probe verdicts, trip counts) stays
        per-shard and lock-free."""
        kind = str(op.get("op") or "")
        i = int(op.get("i", -1))
        if not 0 <= i < len(self.replicas):
            raise IndexError(f"replica index {i} out of range")
        b = self.breakers[i]
        if kind == "set_address":
            self.set_replica_address(
                i, str(op["host"]), int(op["port"]),
                generation=op.get("generation"),
            )
        elif kind == "set_restarting":
            self.set_restarting(i, bool(op.get("flag")))
        elif kind == "hold":
            b.hold()
        elif kind == "release":
            b.release()
        elif kind == "clear_holds":
            b.clear_holds()
        elif kind == "trial":
            b.trial()
        elif kind == "force_open":
            b.force_open()
        else:
            raise ValueError(f"unknown control op {kind!r}")
        return {"ok": True, "op": kind, "i": i}

    def _proxy_to_control(self, sock, method: str, path: str,
                          body: bytes) -> None:
        host, port = self.proxy_control
        try:
            conn = http.client.HTTPConnection(host, port, timeout=30.0)
            try:
                conn.request(
                    method, path, body=body or None,
                    headers={"Content-Type": "application/json"},
                )
                resp = conn.getresponse()
                data = resp.read()
                ctype = resp.getheader(
                    "Content-Type", "application/json"
                )
                status = resp.status
            finally:
                conn.close()
        except OSError as e:
            return self._respond_json(
                sock, 503, {"error": f"control plane unreachable: {e}"},
                retry_after="1",
            )
        self._respond(sock, status, data, ctype)

    @staticmethod
    def _parse(url: str):
        u = urlparse(url if "//" in url else f"http://{url}")
        return (u.hostname, int(u.port))

    # -- replica address table (supervisor seam) -----------------------

    def set_replica_address(self, i: int, host: str, port: int,
                            generation: Optional[str] = None) -> None:
        """Point replica slot ``i`` at a (re)launched process. Bumps
        the address version so every handler thread's cached
        keep-alive connection to the old incarnation is dropped on its
        next use; ``generation`` arms the /healthz handshake the
        prober verifies."""
        with self._mu:
            self.replicas[i] = (host, int(port))
            self._addr_version[i] += 1
            self._expected_gen[i] = generation

    def set_restarting(self, i: int, flag: bool) -> None:
        """Mark a replica as inside a known restart window: a
        connection-refused there is retried with jittered backoff
        (the address may land mid-retry) instead of counting as a
        dead-replica degrade."""
        with self._mu:
            self._restarting[i] = flag

    def is_restarting(self, i: int) -> bool:
        with self._mu:
            return self._restarting[i]

    def stopped(self) -> bool:
        return self._stop.is_set()

    # -- request forwarding --------------------------------------------

    def _conn(self, i: int) -> "_ReplicaConn":
        with self._mu:
            host, port = self.replicas[i]
            ver = self._addr_version[i]
        pool = getattr(self._local, "conns", None)
        if pool is None:
            pool = self._local.conns = {}
        c = pool.get(i)
        if c is not None and c.addr_version != ver:
            c.close()
            c = None
        if c is None:
            c = pool[i] = _ReplicaConn(
                host, port, self.proxy_timeout, addr_version=ver
            )
        return c

    def _drop_conn(self, i: int) -> None:
        pool = getattr(self._local, "conns", None)
        if pool and i in pool:
            try:
                pool.pop(i).close()
            except Exception:
                pass

    def _next_start(self) -> int:
        with self._mu:
            self._rr += 1
            return self._rr

    def _attempt(self, i: int, method: str, path: str, body: bytes,
                 trace_id: Optional[str] = None,
                 extra_headers: Optional[dict] = None):
        """One replica attempt; (status, body, headers) or None on
        connection failure (breaker and error accounting applied). A
        connection-refused inside a known restart window retries the
        SAME slot with jittered backoff — the supervisor may land the
        relaunched replica's fresh address mid-retry, and a bounce
        must not read as a dead-replica degrade."""
        for attempt in range(self.RESTART_RETRIES + 1):
            try:
                return self._conn(i).roundtrip(
                    method, path, body, trace_id=trace_id,
                    extra_headers=extra_headers,
                )
            except ConnectionRefusedError:
                self._drop_conn(i)
                if (not self.is_restarting(i)
                        or attempt >= self.RESTART_RETRIES):
                    break
                with self._mu:
                    self._restart_retries += 1
                time.sleep(
                    self.RESTART_RETRY_BASE * (attempt + 1)
                    * (0.5 + random.random())
                )
            except Exception:
                self._drop_conn(i)
                break
        with self._mu:
            self._errors[i] += 1
        self.breakers[i].record_failure()
        return None

    def forward(self, method: str, path: str, body: bytes, trace=None,
                extra_headers: Optional[dict] = None):
        """Send one request to the fleet: round-robin start over
        CLOSED breakers, advance on connection failure or a shed
        status (429/503), at most one attempt per replica. Returns
        (status, body, headers). When every replica sheds, a
        replica-advertised Retry-After within :attr:`RETRY_AFTER_CAP`
        is HONORED — back off max(jitter, Retry-After), then one more
        full pass — before the LAST shed response is relayed with its
        Retry-After intact, so the client sees the fleet's own
        backpressure, not an invented error. ``trace`` (a
        ``RequestTrace``) records one ``req.hop`` phase span per
        replica attempt and propagates its id to the replica over the
        wire header; ``extra_headers`` ride to the replica verbatim
        (tenant/priority/deadline propagation).

        Open/half-open breakers are skipped (each skip is a timeout a
        client did not pay) and only attempted as a last resort when
        no closed replica answered. Administratively HELD replicas are
        never attempted: a hold means a rollout drain, a canary
        serving a CANDIDATE generation, or a parked spare — none may
        touch live traffic."""
        tr = trace if trace is not None else obs_events.NULL_TRACE
        n = len(self.replicas)
        last_shed = None
        attempted = 0
        for round_no in range(2):
            start = self._next_start()
            order = [(start + j) % n for j in range(n)]
            eligible = [i for i in order if self.breakers[i].eligible()]
            fallback = [
                i for i in order
                if not self.breakers[i].eligible()
                and not self.breakers[i].held()
            ]
            if len(eligible) < n:
                with self._mu:
                    self._breaker_skips += n - len(eligible)
            for i in eligible + fallback:
                with tr.phase("req.hop", replica=i) as hop:
                    got = self._attempt(
                        i, method, path, body,
                        trace_id=tr.trace_id or None,
                        extra_headers=extra_headers,
                    )
                    hop.update(
                        outcome="conn_error" if got is None
                        else int(got[0])
                    )
                attempted += 1
                if got is None:
                    continue
                status, rbody, rheaders = got
                # ANY HTTP answer proves the process is alive — a shed
                # is backpressure, not breakage.
                self.breakers[i].record_success()
                if status in _SHED_STATUSES:
                    last_shed = got
                    with self._mu:
                        self._shed_retries += 1
                    continue
                with self._mu:
                    self._proxied[i] += 1
                self._maybe_mirror(method, path, body, status, rbody)
                return got
            if round_no == 0 and last_shed is not None \
                    and not self._stop.is_set():
                retry_after = _parse_retry_after(last_shed[2])
                if retry_after is not None \
                        and retry_after <= self.RETRY_AFTER_CAP:
                    with self._mu:
                        self._retry_after_honored += 1
                    jitter = (
                        self.RESTART_RETRY_BASE
                        * (0.5 + random.random())
                    )
                    time.sleep(max(retry_after, jitter))
                    continue
            break
        with self._mu:
            self._exhausted += 1
        if last_shed is not None:
            return last_shed
        return (
            503,
            json.dumps({
                "error": f"no replica reachable ({attempted} tried)"
            }).encode(),
            {"Content-Type": "application/json", "Retry-After": "1"},
        )

    # -- shadow mirroring (canary evaluations) -------------------------

    def start_mirror(self, paths, every: int,
                     max_queue: int = 256) -> None:
        """Begin sampling live POST traffic on ``paths``: every
        ``every``-th successful response is queued as (path, body,
        status, response-body) for the canary scorer to drain. The
        queue is bounded; overflow is dropped and counted — mirroring
        must never apply backpressure to live clients."""
        with self._mu:
            self._mirror = {
                "paths": frozenset(paths),
                "every": max(1, int(every)),
                "seen": 0,
                "queue": deque(),
                "max_queue": max(1, int(max_queue)),
                "dropped": 0,
            }

    def drain_mirror(self, limit: int = 16) -> List[tuple]:
        with self._mu:
            m = self._mirror
            if m is None:
                return []
            out = []
            while m["queue"] and len(out) < limit:
                out.append(m["queue"].popleft())
            return out

    def stop_mirror(self) -> None:
        with self._mu:
            self._mirror = None

    def _maybe_mirror(self, method: str, path: str, body: bytes,
                      status: int, rbody: bytes) -> None:
        if method != "POST":
            return
        with self._mu:
            m = self._mirror
            if m is None or urlparse(path).path not in m["paths"]:
                return
            m["seen"] += 1
            if m["seen"] % m["every"]:
                return
            if len(m["queue"]) >= m["max_queue"]:
                m["dropped"] += 1
                return
            m["queue"].append((path, body, status, rbody))

    # -- active health probing -----------------------------------------

    def start_prober(self) -> None:
        """Start the active health prober: every ``probe_interval``
        each replica's ``/healthz`` is probed (2s default timeout) and
        the verdict feeds its breaker — K consecutive failures eject,
        a cooldown half-opens, M trial successes readmit. Replicas
        inside an open breaker's cooldown get NO probes (and no
        traffic)."""
        if self._prober is not None:
            return
        self._prober = threading.Thread(
            target=self._probe_loop, daemon=True,
            name="glint-fleet-prober",
        )
        self._prober.start()

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval):
            for i in range(len(self.replicas)):
                b = self.breakers[i]
                if b.state() == ReplicaBreaker.OPEN \
                        and not b.maybe_half_open():
                    continue  # cooling down: no probes either
                self.probe_replica(i)

    def probe_replica(self, i: int) -> bool:
        """One active /healthz probe of replica ``i``; feeds the
        breaker and returns the verdict. A probe is healthy only when
        the replica answers 200 AND — when the supervisor armed a
        launch generation — echoes the expected ``fleet_generation``
        (the launch handshake: a stale pre-restart process must
        never answer for the new one)."""
        b = self.breakers[i]
        ok = False
        try:
            faults.fire("fleet.replica_probe")
            status, h = self._get_json(
                i, "/healthz", timeout=self.probe_timeout
            )
            with self._mu:
                expected = self._expected_gen[i]
            ok = status == 200
            if ok and expected is not None:
                ok = str(h.get("fleet_generation")) == str(expected)
        except Exception:
            ok = False
        if ok:
            b.record_success(probe=True)
        else:
            b.record_failure(probe=True)
        return ok

    # -- fleet views ---------------------------------------------------

    def _get_json(self, i: int, path: str,
                  timeout: Optional[float] = None):
        with self._mu:
            host, port = self.replicas[i]
        conn = http.client.HTTPConnection(
            host, port,
            timeout=self.scrape_timeout if timeout is None else timeout,
        )
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read().decode())
        finally:
            conn.close()

    def health(self):
        """(up, total, per-replica state) from each replica's
        /healthz; a dead replica reports "unreachable"."""
        states = []
        up = 0
        for i in range(len(self.replicas)):
            try:
                status, h = self._get_json(i, "/healthz")
                state = h.get("status", f"http {status}")
                if status == 200:
                    up += 1
            except Exception:
                state = "unreachable"
            states.append({
                "url": self.replica_url(i), "state": state,
                "breaker": self.breakers[i].state(),
            })
        return up, len(self.replicas), states

    def replica_url(self, i: int) -> str:
        with self._mu:
            host, port = self.replicas[i]
        return f"http://{host}:{port}"

    def balancer_stats(self) -> dict:
        with self._mu:
            out = {
                "shed_retries_total": self._shed_retries,
                "exhausted_total": self._exhausted,
                "proxied_total": int(sum(self._proxied)),
                "proxy_errors_total": int(sum(self._errors)),
                "breaker_skips_total": self._breaker_skips,
                "restart_retries_total": self._restart_retries,
                "retry_after_honored_total": self._retry_after_honored,
            }
        if self.qos is not None:
            out["qos"] = self.qos.snapshot()
        return out

    def metrics_doc(self) -> dict:
        """The merged fleet document: per-replica snapshots (scraped
        now, failures reported not fatal) with breaker state, the
        exact merge as ``fleet``, the balancer's own counters, and —
        when a fleet supervisor is attached — its restart/rollout/
        canary blocks."""
        from glint_word2vec_torch.obs.aggregate import (
            merge_serving_snapshots,
        )

        replicas = []
        snaps = []
        with self._mu:
            proxied = list(self._proxied)
            errors = list(self._errors)
            restarting = list(self._restarting)
        for i in range(len(self.replicas)):
            entry: Dict[str, object] = {
                "url": self.replica_url(i),
                "proxied_total": proxied[i],
                "proxy_errors_total": errors[i],
                "breaker": self.breakers[i].snapshot(),
                "restarting": restarting[i],
            }
            try:
                _, snap = self._get_json(i, "/metrics")
                entry["up"] = True
                entry["snapshot"] = snap
                snaps.append(snap)
            except Exception as e:
                entry["up"] = False
                entry["scrape_error"] = str(e)
            replicas.append(entry)
        doc = {
            "replicas": replicas,
            "fleet": merge_serving_snapshots(snaps),
            "balancer": self.balancer_stats(),
        }
        extra = self.doc_extra() if self.doc_extra is not None else None
        if extra:
            doc.update(extra)
        return doc

    def shutdown_fleet(self) -> List[dict]:
        """POST /shutdown to every replica (best effort)."""
        results = []
        for i in range(len(self.replicas)):
            with self._mu:
                host, port = self.replicas[i]
            try:
                conn = http.client.HTTPConnection(
                    host, port, timeout=self.scrape_timeout
                )
                try:
                    conn.request(
                        "POST", "/shutdown", body=b"{}",
                        headers={"Content-Type": "application/json"},
                    )
                    resp = conn.getresponse()
                    resp.read()
                    results.append({
                        "url": self.replica_url(i),
                        "status": resp.status,
                    })
                finally:
                    conn.close()
            except Exception as e:
                results.append({
                    "url": self.replica_url(i), "error": str(e),
                })
        return results

    # -- anomaly flight recorder ---------------------------------------

    def enable_flight_recorder(
        self, out_dir: str, *, window_seconds: float = 30.0,
        min_interval_seconds: float = 60.0,
    ) -> FlightRecorder:
        """Arm the fleet-wide anomaly flight recorder: a breaker's
        CLOSED -> OPEN transition (a healthy replica just got ejected)
        snapshots the last ``window_seconds`` of spans and metrics from
        the balancer AND every reachable replica into a postmortem
        bundle under ``out_dir``. Bundles are rate-limited; the
        recorder never raises into the data plane."""
        fl = FlightRecorder(
            out_dir, window_seconds=window_seconds,
            min_interval_seconds=min_interval_seconds,
        )
        fl.add_source("balancer", self._flight_balancer)
        fl.add_source("replica_spans", self._flight_replica_spans)
        fl.add_source("replica_metrics", self._flight_replica_metrics)
        self.flight = fl
        for i, b in enumerate(self.breakers):
            b.on_open = (
                lambda i=i: fl.trigger("breaker_open", replica=i)
            )
        return fl

    def _flight_balancer(self, window_seconds: float) -> dict:
        doc: Dict[str, object] = {
            "balancer": self.balancer_stats(),
            "breakers": [b.snapshot() for b in self.breakers],
        }
        rec = obs_events.get_recorder()
        if rec is not None:
            doc["spans"] = rec.recent_events(window_seconds)
            doc["anchor"] = {
                "wall_t0": rec.wall_t0, "mono_t0": rec.mono_t0,
            }
        return doc

    def _flight_replica_spans(self, window_seconds: float) -> dict:
        """Every replica's recent span window (its /trace route): the
        bundle shows what the whole fleet was doing when the anomaly
        fired, not just the process that noticed it."""
        out = {}
        for i in range(len(self.replicas)):
            try:
                _, doc = self._get_json(
                    i, f"/trace?seconds={window_seconds:g}"
                )
                out[f"replica_{i}"] = {
                    "url": self.replica_url(i), "trace": doc,
                }
            except Exception as e:
                out[f"replica_{i}"] = {
                    "url": self.replica_url(i), "error": str(e),
                }
        return out

    def _flight_replica_metrics(self, window_seconds: float) -> dict:
        out = {}
        for i in range(len(self.replicas)):
            try:
                _, snap = self._get_json(i, "/metrics")
                out[f"replica_{i}"] = {
                    "url": self.replica_url(i), "snapshot": snap,
                }
            except Exception as e:
                out[f"replica_{i}"] = {
                    "url": self.replica_url(i), "error": str(e),
                }
        return out

    # -- lifecycle -----------------------------------------------------

    def _tighten_gil_switch(self) -> None:
        # One handler thread per client connection, each a chain of
        # short GIL-holding sections (parse, forward, relay): at the
        # default 5ms switch interval the convoy adds whole scheduling
        # quanta per proxied call (the same effect serving.py tightens
        # for). Restored by stop().
        if self._prev_switch is None:
            self._prev_switch = sys.getswitchinterval()
            sys.setswitchinterval(0.001)

    def _start_control(self) -> None:
        if self._control_listener is None or \
                self._control_thread is not None:
            return
        self._control_thread = threading.Thread(
            target=self._control_accept_loop, daemon=True,
            name="glint-fleet-control",
        )
        self._control_thread.start()

    def serve_forever(self) -> None:
        logger.info(
            "fleet balancer on %s:%d over %d replica(s)",
            self.host, self.port, len(self.replicas),
        )
        self._tighten_gil_switch()
        self._start_control()
        self._accept_loop()

    def start_background(self) -> None:
        self._tighten_gil_switch()
        self._start_control()
        self._thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="glint-fleet-lb",
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        # Closing a listening socket from another thread does not wake an
        # accept() blocked on it (Linux): shutdown() does, and a
        # self-connect covers the platforms where it does not. Not on a
        # shared port: there the kernel may hand the self-connect to a
        # sibling shard, and a shard's accept loop re-checks _stop every
        # second instead. A listener inherited by fd is one socket with
        # the parent's and the siblings', so a shard only closes its fd
        # (a shutdown() would stop the whole fleet's accept queue).
        if not self._inherited_listener:
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if not self._shared_listener:
            try:
                socket.create_connection((self.host, self.port),
                                         timeout=1).close()
            except OSError:
                pass
        try:
            self._listener.close()
        except OSError:
            pass
        if self._control_listener is not None:
            ctrl_addr = None
            try:
                ctrl_addr = self._control_listener.getsockname()[:2]
                self._control_listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            if ctrl_addr is not None:
                # The control listener is private, so the self-connect
                # reaches this process.
                try:
                    socket.create_connection(ctrl_addr, timeout=1).close()
                except OSError:
                    pass
            try:
                self._control_listener.close()
            except OSError:
                pass
        if self._prev_switch is not None:
            sys.setswitchinterval(self._prev_switch)
            self._prev_switch = None


# ----------------------------------------------------------------------
# Rolling rollout + shadow-canary promotion gate
# ----------------------------------------------------------------------


def _topk_overlap(a, b, k: int) -> Optional[float]:
    """Agreement score between two /synonyms-or-/analogy JSON answers:
    |intersection| / max(|a|, |b|) over the top-k words. None when
    either side is not a scoreable hit list."""
    try:
        wa = [x[0] for x in a][: max(1, int(k))]
        wb = [x[0] for x in b][: max(1, int(k))]
    except (TypeError, IndexError):
        return None
    if not wa and not wb:
        return None
    sa, sb = set(wa), set(wb)
    return len(sa & sb) / max(len(sa), len(sb), 1)


class CanaryConfig:
    """Knobs for the shadow-canary promotion gate.

    ``probes`` are operator-defined deterministic checks — each a
    ``{"path": "/synonyms"|"/analogy", "body": {...}}`` request posted
    to BOTH the live fleet and the canary and scored for top-k
    agreement (the vienna/berlin + capital-of analogy gates of
    QUALITY.json, restated as live-vs-candidate agreement so no
    expected-answer labels are needed). Mirrored live traffic — every
    ``mirror_every``-th request on ``mirror_paths`` — adds organic
    samples until ``min_scores`` are collected or ``mirror_seconds``
    elapse. The mean agreement must clear ``agreement_gate`` or the
    candidate is held back. Choose probe words stable across
    generations: a live-404/canary-404 pair is unscorable (skipped),
    a one-sided 404 scores 0.
    """

    def __init__(self, *, mirror_paths=("/synonyms", "/analogy"),
                 mirror_every: int = 4, min_scores: int = 8,
                 mirror_seconds: float = 10.0,
                 agreement_gate: float = 0.6, top_k: int = 10,
                 probes: Optional[List[dict]] = None):
        self.mirror_paths = tuple(mirror_paths)
        self.mirror_every = max(1, int(mirror_every))
        self.min_scores = max(0, int(min_scores))
        self.mirror_seconds = float(mirror_seconds)
        self.agreement_gate = float(agreement_gate)
        self.top_k = max(1, int(top_k))
        self.probes = list(probes or [])

    def scoped(self, model_id: str) -> "CanaryConfig":
        """The same gate addressed to ONE catalog model:
        probe and mirror paths gain the ``/m/<id>`` routing prefix, so
        a per-model rollout canaries against that model's live
        traffic/answers only."""
        prefix = f"/m/{model_id}"
        return CanaryConfig(
            mirror_paths=tuple(prefix + p for p in self.mirror_paths),
            mirror_every=self.mirror_every,
            min_scores=self.min_scores,
            mirror_seconds=self.mirror_seconds,
            agreement_gate=self.agreement_gate,
            top_k=self.top_k,
            probes=[
                {**p, "path": prefix + str(p.get("path", "/synonyms"))}
                for p in self.probes
            ],
        )


class ReplicaHoldLedger:
    """The replica-hold ownership protocol the rollout coordinators and
    the autoscaler share: every administrative hold on a replica is owned
    by a NAMED owner — ``"rollout"`` (drain during a swap, or a canary
    serving a candidate) or ``"autoscale"`` (a warm spare parked out of
    rotation) — and applied through one pair of callbacks (ref-counted
    breaker holds, through the data-plane facade to every balancer
    shard).

    The protocol:
      * one hold per (owner, replica) — double-acquire is a no-op;
      * owners compose: a rollout may drain a PARKED spare (swapping
        it keeps the spare warm on the promoted generation) and
        releasing the rollout's hold leaves it parked;
      * a replica held by anyone besides the autoscaler is NEVER spare
        capacity (a held canary must not be readmitted by a scale-up);
      * after a relaunch wipes a replica's breaker holds
        (``clear_holds`` in supervisor adoption), :meth:`reapply`
        restores every surviving owner's hold — a parked spare that
        crashed comes back parked, not serving."""

    def __init__(self, hold: Callable[[int], None],
                 release: Callable[[int], None],
                 clear: Optional[Callable[[int], None]] = None):
        self._hold = hold
        self._release = release
        self._clear = clear
        self._mu = threading.Lock()
        self._owners: Dict[int, set] = {}

    def acquire(self, owner: str, i: int) -> bool:
        with self._mu:
            owners = self._owners.setdefault(i, set())
            if owner in owners:
                return False
            owners.add(owner)
        self._hold(i)
        return True

    def release(self, owner: str, i: int) -> bool:
        with self._mu:
            owners = self._owners.get(i) or set()
            if owner not in owners:
                return False
            owners.discard(owner)
        self._release(i)
        return True

    def owners(self, i: int) -> frozenset:
        with self._mu:
            return frozenset(self._owners.get(i) or ())

    def parked(self, owner: str) -> List[int]:
        """Replicas held by ``owner`` and NOBODY else — the only ones
        that count as spare capacity when ``owner == "autoscale"``."""
        with self._mu:
            return sorted(
                i for i, owners in self._owners.items()
                if owners == {owner}
            )

    def reapply(self, i: int) -> None:
        """Re-assert every owner's hold on ``i`` after a relaunch
        cleared the replica's breaker holds."""
        with self._mu:
            owners = sorted(self._owners.get(i) or ())
        if self._clear is not None:
            self._clear(i)
        for _ in owners:
            self._hold(i)

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "held": {
                    str(i): sorted(owners)
                    for i, owners in self._owners.items() if owners
                },
            }


class RolloutCoordinator:
    """Orders fleet-wide generation rollouts, one replica at a time.

    Follows ``LATEST.json`` the way the serving ``SnapshotWatcher``
    does, but instead of letting every replica swap simultaneously it
    drives the sequence: (canary gate, when configured) then for each
    replica — breaker hold, drain, ``POST /reload`` with the explicit
    generation dir, wait healthy + warm (the swap added zero
    post-warmup compiles), readmit. Fleet capacity never drops below
    N-1 replicas.

    Failure taxonomy:
      * replica unavailable (dead / mid-restart / not yet readmitted):
        the rollout HALTS — the old generation keeps serving on every
        un-swapped replica — and is retried on a later poll once the
        fleet is whole again;
      * staging failure (replica answered /reload with an error): the
        generation is marked failed and NOT retried until the pointer
        moves (the SnapshotWatcher contract, fleet-wide);
      * canary regression: the candidate is held back — canary
        restored to the live generation, counted, left on disk.
    """

    def __init__(self, lb: LoadBalancer, watch_dir: str, *,
                 poll_seconds: float = 1.0,
                 current: Optional[str] = None,
                 current_dir: Optional[str] = None,
                 canary: Optional[CanaryConfig] = None,
                 step_timeout: float = 600.0,
                 drain_seconds: float = 0.25,
                 replica_ok: Optional[Callable[[int], bool]] = None,
                 on_generation=None,
                 holds: Optional[ReplicaHoldLedger] = None,
                 model_id: Optional[str] = None):
        self.lb = lb
        self.watch_dir = watch_dir
        #: Which catalog model this coordinator rolls (None = the
        #: default). A per-model coordinator reloads through the
        #: ``/m/<id>/`` routing prefix and reads the replica's
        #: per-model metrics block, so one model's pointer move swaps
        #: ONLY that model's tables — every other model's generation,
        #: caches, and counters on the same replicas stay untouched.
        self.model_id = model_id
        prefix = f"/m/{model_id}" if model_id else ""
        self._reload_path = prefix + "/reload"
        self._metrics_path = prefix + "/metrics"
        self._healthz_path = prefix + "/healthz"
        self.poll_seconds = max(0.05, float(poll_seconds))
        self.canary = canary
        self.step_timeout = float(step_timeout)
        self.drain_seconds = float(drain_seconds)
        self._replica_ok = replica_ok or (lambda i: True)
        self.on_generation = on_generation
        #: Shared hold-ownership ledger (supervisor-provided when an
        #: autoscaler coexists); standalone use gets a private ledger
        #: over this balancer's breakers.
        self.holds = holds if holds is not None else ReplicaHoldLedger(
            lambda i: lb.breakers[i].hold(),
            lambda i: lb.breakers[i].release(),
        )
        self._mu = threading.Lock()
        #: Generation name the whole fleet serves (None when booted
        #: from a plain --model dir outside the publish protocol).
        self.current = current
        #: Model directory replicas (re)launch from — the previous
        #: generation the canary is restored to on hold-back.
        self.current_dir = current_dir
        self._failed: Optional[str] = None
        self._held_back: Optional[str] = None
        self._in_progress = False
        self._phase = "idle"
        self._stats = {
            "rollouts_started_total": 0,
            "rollouts_completed_total": 0,
            "rollouts_halted_total": 0,
            "rollout_steps_total": 0,
            "generations_failed_total": 0,
            "watch_errors_total": 0,
            # The last rollout's steps: the canary's evaluation and each
            # replica's swap, with their seconds (a block the JAX
            # coordinator does not keep).
            "step_seconds": [],
            "canary": {
                "evaluations_total": 0,
                "holdbacks_total": 0,
                "last_agreement": None,
                "last_scored": 0,
                "last_generation": None,
                "last_verdict": None,
                "agreement_gate": (
                    canary.agreement_gate if canary is not None else None
                ),
            },
        }
        self._poll_mu = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- pointer following ---------------------------------------------

    def poll_once(self) -> Optional[str]:
        """One pointer check; returns the generation name when a full
        rollout completed, else None. Never raises."""
        with self._poll_mu:
            return self._poll_once_locked()

    def _poll_once_locked(self) -> Optional[str]:
        from glint_word2vec_torch.streaming.publish import read_latest

        try:
            latest = read_latest(self.watch_dir, raise_errors=True)
        except (OSError, ValueError) as e:
            with self._mu:
                self._stats["watch_errors_total"] += 1
            logger.warning(
                "rollout coordinator: transient pointer read error: %s "
                "(retrying next poll)", e,
            )
            return None
        if latest is None:
            return None
        gen = str(latest["generation"])
        with self._mu:
            if gen in (self.current, self._failed, self._held_back):
                return None
        gen_dir = os.path.join(self.watch_dir, gen)
        try:
            return self._rollout(gen, gen_dir)
        except Exception as e:  # pragma: no cover - defensive
            logger.error("rollout of %s failed unexpectedly: %s", gen, e)
            return self._halt(gen, f"unexpected error: {e}")

    def _rollout(self, gen: str, gen_dir: str) -> Optional[str]:
        lb = self.lb
        n = len(lb.replicas)
        ok_idx = [i for i in range(n) if self._replica_ok(i)]
        with self._mu:
            self._stats["rollouts_started_total"] += 1
            self._stats["step_seconds"] = []
            self._in_progress = True
            self._phase = "starting"
        # A hot-swap arriving while a replica is mid-restart WAITS: the
        # rollout needs the whole (non-written-off) fleet serving, so
        # it halts and retries once the supervisor readmits the
        # replica — never racing a relaunch with a reload.
        not_ready = [
            i for i in ok_idx if not self._ready_for_rollout(i)
        ]
        if not ok_idx or not_ready:
            return self._halt(
                gen,
                f"replicas not serving: {not_ready or 'all written off'}",
            )
        completed: List[int] = []
        if self.canary is not None and len(ok_idx) < 2:
            if len(lb.replicas) >= 2:
                # Configured for canarying but degraded below a live
                # pair: never roll an unvetted candidate onto the only
                # serving replica — wait for the supervisor to restore
                # a peer, then evaluate properly.
                return self._halt(
                    gen, "canary gate needs >= 2 serving replicas "
                    f"(only {len(ok_idx)} left)",
                )
            # A deliberately single-replica fleet cannot canary (there
            # is no live side to hold out) — proceed, loudly.
            logger.warning(
                "single-replica fleet: canary gate impossible, "
                "rolling %s without evaluation", gen,
            )
        if self.canary is not None and len(ok_idx) >= 2:
            t0 = time.monotonic()
            verdict = self._canary_phase(ok_idx[0], gen, gen_dir)
            self._record_step(ok_idx[0], "canary", t0)
            if verdict == "held_back":
                with self._mu:
                    self._held_back = gen
                    self._stats["canary"]["holdbacks_total"] += 1
                    self._in_progress = False
                    self._phase = "held_back"
                    cur = self.current
                logger.error(
                    "canary HELD BACK %s: live generation %s keeps "
                    "serving everywhere; candidate left on disk at %s",
                    gen, cur, gen_dir,
                )
                return None
            if verdict == "stage_failed":
                return self._stage_failed(gen)
            if verdict != "pass":
                return self._halt(gen, f"canary: {verdict}")
            completed.append(ok_idx[0])
        for i in ok_idx:
            if i in completed:
                continue
            try:
                faults.fire("fleet.rollout_step")
            except Exception as e:
                return self._halt(gen, f"rollout step fault: {e}")
            with self._mu:
                self._stats["rollout_steps_total"] += 1
                self._phase = "rolling"
            if not self._replica_ok(i) or not self._ready_for_rollout(i):
                # Replica killed mid-rollout: halt — the old generation
                # keeps serving on every un-swapped replica, and the
                # next poll retries once the fleet is whole.
                return self._halt(gen, f"replica {i} unavailable")
            # Hold only when a SERVING peer can absorb the drained
            # traffic: written-off replicas don't count, so the sole
            # survivor of a degraded fleet is never held (its reload
            # stages off the request path anyway).
            t0 = time.monotonic()
            res = self._swap_replica(
                i, gen, gen_dir, hold=len(ok_idx) > 1
            )
            self._record_step(i, "swap", t0)
            if res == "stage_failed":
                return self._stage_failed(gen)
            if res != "ok":
                return self._halt(gen, f"replica {i}: {res}")
        with self._mu:
            self.current = gen
            self.current_dir = gen_dir
            self._stats["rollouts_completed_total"] += 1
            self._in_progress = False
            self._phase = "idle"
        if self.on_generation is not None:
            self.on_generation(gen, gen_dir)
        logger.info(
            "rollout complete: fleet promoted to %s (%d replicas)",
            gen, len(ok_idx),
        )
        return gen

    def _record_step(self, i: int, kind: str, t0: float) -> None:
        with self._mu:
            self._stats["step_seconds"].append({
                "replica": i, "kind": kind,
                "seconds": round(time.monotonic() - t0, 3)})

    def _ready_for_rollout(self, i: int) -> bool:
        """A replica is rollable when its breaker is serving-eligible
        OR it is a healthy warm spare parked ONLY by the autoscaler:
        spares are swapped too (they must stay warm on the promoted
        generation, ready for a zero-compile readmit) and must never
        stall a rollout. Any other hold — a canary carrying a
        candidate, a drain in progress — still blocks."""
        b = self.lb.breakers[i]
        if b.eligible():
            return True
        return (
            b.state() == ReplicaBreaker.CLOSED
            and self.holds.owners(i) == frozenset(("autoscale",))
        )

    def in_progress(self) -> bool:
        """Cheap rollout-pinning flag for the autoscaler: while a
        rollout (canary phase included) is in flight the replica set
        is PINNED — no scale transitions may fight the swap order."""
        with self._mu:
            return self._in_progress

    def _halt(self, gen: str, reason: str) -> None:
        """Transient abort: retried on a later poll (the pointer still
        names the generation)."""
        with self._mu:
            self._stats["rollouts_halted_total"] += 1
            self._in_progress = False
            self._phase = "halted"
            cur = self.current
        logger.warning(
            "rollout of %s HALTED: %s — old generation %s still "
            "serving on un-swapped replicas; retrying on a later poll",
            gen, reason, cur,
        )
        return None

    def _stage_failed(self, gen: str) -> None:
        """Permanent (until the pointer moves): the candidate failed
        staging on a replica."""
        with self._mu:
            self._failed = gen
            self._stats["generations_failed_total"] += 1
            self._in_progress = False
            self._phase = "failed"
            cur = self.current
        logger.error(
            "rollout of %s ABORTED: staging failed; generation marked "
            "failed (not retried until the pointer moves); %s keeps "
            "serving", gen, cur,
        )
        return None

    # -- per-replica swap ----------------------------------------------

    def _post_replica(self, i: int, path: str, payload,
                      timeout: Optional[float] = None,
                      shadow: bool = False):
        """Direct POST to one replica (NOT through the balancer's
        rotation): the rollout/canary control channel."""
        with self.lb._mu:
            host, port = self.lb.replicas[i]
        body = (
            payload if isinstance(payload, (bytes, bytearray))
            else json.dumps(payload).encode()
        )
        headers = {"Content-Type": "application/json"}
        if shadow:
            # Tag control/scoring traffic so a replica's access view
            # (and the stub replicas in tests) can tell shadow traffic
            # from live traffic that must never reach a held canary.
            headers["X-Glint-Shadow"] = "1"
        conn = http.client.HTTPConnection(
            host, port,
            timeout=self.step_timeout if timeout is None else timeout,
        )
        try:
            conn.request("POST", path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            try:
                doc = json.loads(data.decode() or "null")
            except ValueError:
                doc = None
            return resp.status, doc
        finally:
            conn.close()

    def _replica_metrics(self, i: int) -> Tuple[Optional[str], int, bool]:
        """(generation, post_warmup_compiles, healthy) of one replica —
        scoped to THIS coordinator's model (the per-model snapshot has
        the same hot_swap/compiles shape as the top-level one)."""
        try:
            status, snap = self.lb._get_json(i, self._metrics_path)
            hstatus, _ = self.lb._get_json(i, self._healthz_path)
        except Exception:
            return None, -1, False
        if status != 200:
            return None, -1, False
        gen = (snap.get("hot_swap") or {}).get("generation")
        compiles = int((snap.get("compiles") or {}).get("post_warmup") or 0)
        return gen, compiles, hstatus == 200

    def _wait_replica_on(self, i: int, gen: str,
                         compiles_before: int) -> str:
        """Poll until the replica serves ``gen``, healthy, with NO
        post-warmup compiles added by the swap. Returns "ok" or a
        reason string."""
        deadline = time.monotonic() + self.step_timeout
        while time.monotonic() < deadline and not self._stop.is_set():
            rgen, compiles, healthy = self._replica_metrics(i)
            if rgen == gen and healthy:
                if compiles_before >= 0 and compiles > compiles_before:
                    return (
                        f"swap added {compiles - compiles_before} "
                        "post-warmup compiles"
                    )
                return "ok"
            time.sleep(0.1)
        return f"not healthy on {gen} within {self.step_timeout:.0f}s"

    def _swap_replica(self, i: int, gen: str, gen_dir: str,
                      hold: bool) -> str:
        """One rollout step: drain via breaker hold, reload, wait
        healthy + warm, readmit. Returns "ok", "stage_failed", or a
        transient reason. Single-replica fleets skip the hold — with
        no peer to absorb traffic, ejecting the only replica would
        drop availability to zero, and the reload stages off the
        request path anyway."""
        _, compiles_before, _ = self._replica_metrics(i)
        if hold:
            # Through the shared ledger: on a parked spare this stacks
            # a "rollout" hold on the autoscaler's (ref-counted), and
            # releasing below leaves the spare parked, not serving.
            self.holds.acquire("rollout", i)
            time.sleep(self.drain_seconds)  # in-flight requests drain
        try:
            try:
                status, resp = self._post_replica(
                    i, self._reload_path,
                    {"dir": gen_dir, "generation": gen},
                    shadow=True,
                )
            except Exception as e:
                return f"unreachable during reload: {e}"
            if status == 503:
                # Transient staging trouble (storage hiccup on an
                # existing dir, answered 503 by the replica): halt and
                # retry the rollout on a later poll — branding the
                # generation failed is for REJECTED staging only.
                return f"transient staging error: {resp}"
            if status != 200:
                logger.error(
                    "replica %d rejected %s: http %d %s",
                    i, gen, status, resp,
                )
                return "stage_failed"
            return self._wait_replica_on(i, gen, compiles_before)
        finally:
            if hold:
                self.holds.release("rollout", i)

    # -- shadow canary -------------------------------------------------

    def _score_probe(self, ci: int, probe: dict) -> Optional[float]:
        """One deterministic probe: POST the same body to the live
        fleet (the held canary is excluded from rotation by
        construction) and to the canary; score top-k agreement."""
        path = str(probe.get("path", "/synonyms"))
        body = json.dumps(probe.get("body", {})).encode()
        try:
            lstatus, lbody, _ = self.lb.forward("POST", path, body)
            cstatus, cdoc = self._post_replica(
                ci, path, body, timeout=30.0, shadow=True
            )
        except Exception:
            return None
        if lstatus in _SHED_STATUSES or cstatus in _SHED_STATUSES:
            # Backpressure is not a model answer: an overloaded-but-
            # healthy fleet must not hold back a good candidate.
            return None
        if lstatus != 200 and cstatus != 200:
            return None  # unscorable on both sides (e.g. shared OOV)
        if lstatus != 200 or cstatus != 200:
            return 0.0  # one-sided SEMANTIC failure is disagreement
        try:
            ldoc = json.loads(lbody)
        except ValueError:
            return None
        return _topk_overlap(ldoc, cdoc, self.canary.top_k)

    def _canary_phase(self, ci: int, gen: str, gen_dir: str) -> str:
        """Stage the candidate on ONE held replica, mirror a sampled
        slice of live traffic to it, score agreement, and decide.
        Returns "pass", "held_back", "stage_failed", or a transient
        reason. The held replica serves NO live traffic throughout —
        the candidate generation cannot reach a client until it
        passes."""
        lb = self.lb
        with self._mu:
            self._stats["canary"]["evaluations_total"] += 1
            self._phase = "canary"
        self.holds.acquire("rollout", ci)
        mirroring = False
        restored = True
        try:
            _, compiles_before, _ = self._replica_metrics(ci)
            time.sleep(self.drain_seconds)
            # From the moment the reload is POSTed the replica may
            # have adopted the candidate (the handler swaps before
            # answering): pessimistically un-restored until a path
            # below proves the live generation is back.
            restored = False
            try:
                status, resp = self._post_replica(
                    ci, self._reload_path,
                    {"dir": gen_dir, "generation": gen},
                    shadow=True,
                )
            except Exception as e:
                # The reload may have been APPLIED with the response
                # lost — restore before ever releasing the hold.
                restored = self._restore_canary(ci, gen)
                return f"canary unreachable during reload: {e}"
            if status == 503:
                # Transient staging trouble on the replica (storage
                # hiccup): the old tables stayed live — retry the
                # whole rollout on a later poll.
                restored = True
                return f"canary transient staging error: {resp}"
            if status != 200:
                logger.error(
                    "canary replica %d rejected %s: http %d %s",
                    ci, gen, status, resp,
                )
                restored = True  # staging rejected: old tables live
                return "stage_failed"
            warm = self._wait_replica_on(ci, gen, compiles_before)
            if warm != "ok":
                # The candidate IS live on the canary but never proved
                # healthy/warm: restore before releasing the hold.
                restored = self._restore_canary(ci, gen)
                return f"canary {warm}"
            scores: List[float] = []
            for probe in (self.canary.probes or []):
                s = self._score_probe(ci, probe)
                if s is not None:
                    scores.append(s)
            lb.start_mirror(
                self.canary.mirror_paths, self.canary.mirror_every
            )
            mirroring = True
            deadline = time.monotonic() + self.canary.mirror_seconds
            want = max(self.canary.min_scores, len(scores))
            while (len(scores) < want
                   and time.monotonic() < deadline
                   and not self._stop.is_set()):
                drained = lb.drain_mirror(16)
                if not drained:
                    time.sleep(0.05)
                    continue
                for path, body, lstatus, lbody in drained:
                    if lstatus != 200:
                        continue
                    try:
                        cstatus, cdoc = self._post_replica(
                            ci, urlparse(path).path, body,
                            timeout=30.0, shadow=True,
                        )
                        if cstatus in _SHED_STATUSES:
                            continue  # backpressure, not an answer
                        if cstatus != 200:
                            scores.append(0.0)
                            continue
                        s = _topk_overlap(
                            json.loads(lbody), cdoc, self.canary.top_k
                        )
                        if s is not None:
                            scores.append(s)
                    except Exception:
                        continue
            lb.stop_mirror()
            mirroring = False
            agreement = (
                sum(scores) / len(scores) if scores else None
            )
            ok = (
                agreement is None
                or agreement >= self.canary.agreement_gate
            )
            with self._mu:
                can = self._stats["canary"]
                can["last_agreement"] = (
                    round(agreement, 4) if agreement is not None else None
                )
                can["last_scored"] = len(scores)
                can["last_generation"] = gen
                can["last_verdict"] = "pass" if ok else "held_back"
            if agreement is None:
                logger.warning(
                    "canary for %s collected no scoreable responses "
                    "(no live traffic, no probes) — passing vacuously",
                    gen,
                )
            if ok:
                logger.info(
                    "canary PASSED for %s: agreement %.3f >= %.3f "
                    "over %d responses",
                    gen, agreement if agreement is not None else 1.0,
                    self.canary.agreement_gate, len(scores),
                )
                restored = True  # it now serves the PROMOTED generation
                return "pass"
            # Hold-back: restore the canary to the live generation so
            # the candidate never serves a client, then count it.
            restored = self._restore_canary(ci, gen)
            return "held_back"
        finally:
            if mirroring:
                lb.stop_mirror()
            if restored:
                self.holds.release("rollout", ci)
            # NOT restored: the canary still holds the regressed
            # candidate — the "rollout" hold stays in the ledger (no
            # live traffic, and the autoscaler can never count it as
            # spare capacity) for the operator; the README runbook
            # documents recovery.

    def _restore_canary(self, ci: int, candidate: str) -> bool:
        """Reload the canary back to the live generation after a
        hold-back. Retried a few times; on total failure the replica
        is left HELD (serving nothing) rather than ever exposing the
        regressed candidate to clients."""
        with self._mu:
            prev_gen, prev_dir = self.current, self.current_dir
        if prev_dir is None:
            logger.error(
                "no previous generation dir to restore canary from "
                "(booted outside the publish protocol?) — replica "
                "stays held",
            )
            return False
        for _ in range(3):
            try:
                status, _ = self._post_replica(
                    ci, self._reload_path,
                    {"dir": prev_dir, "generation": prev_gen},
                    shadow=True,
                )
                if status == 200 and self._wait_replica_on(
                        ci, prev_gen, -1) == "ok":
                    logger.info(
                        "canary restored to %s after holding back %s",
                        prev_gen, candidate,
                    )
                    return True
            except Exception:
                pass
            time.sleep(0.5)
        logger.error(
            "canary restore to %s FAILED after holding back %s — "
            "replica left held out of rotation", prev_gen, candidate,
        )
        return False

    # -- observability -------------------------------------------------

    def stats(self) -> dict:
        with self._mu:
            out = {
                k: v for k, v in self._stats.items()
                if k not in ("canary", "step_seconds")
            }
            out["canary"] = dict(self._stats["canary"])
            out["step_seconds"] = list(self._stats["step_seconds"])
            out["model"] = self.model_id
            out["in_progress"] = self._in_progress
            out["phase"] = self._phase
            out["generation"] = self.current
            out["failed_generation"] = self._failed
            out["held_back_generation"] = self._held_back
            return out

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        suffix = f"-{self.model_id}" if self.model_id else ""
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"glint-fleet-rollout{suffix}",
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_seconds):
            self.poll_once()

    def stop(self) -> None:
        self._stop.set()



# ----------------------------------------------------------------------
# Multi-process data plane: balancer shard processes
# ----------------------------------------------------------------------


def run_balancer_shard(config_path: str) -> int:
    """Entry point of one ``fleet-shard`` subprocess: a full
    :class:`LoadBalancer` data plane (own thread pool, per-thread
    keep-alive replica connections, breakers + prober, EventRecorder
    sink) accepting from the SHARED fleet port, plus a private control
    listener the supervisor drives. Exits when stopped over the
    control channel or when the parent dies (orphan watchdog)."""
    from glint_word2vec_torch.utils import atomic_write_json

    with open(config_path) as f:
        cfg = json.load(f)
    if cfg.get("trace_log"):
        obs_events.set_recorder(obs_events.EventRecorder(
            jsonl_path=cfg["trace_log"],
        ))
    replicas = cfg["replicas"]
    qos_cfg = cfg.get("qos")
    lb = LoadBalancer(
        [f"http://{r['host']}:{r['port']}" for r in replicas],
        host=cfg.get("host", "127.0.0.1"),
        port=int(cfg.get("port", 0)),
        reuse_port=bool(cfg.get("reuse_port")),
        listen_fd=cfg.get("listen_fd"),
        control=True,
        shard_id=int(cfg.get("shard", 1)),
        proxy_control=(
            tuple(cfg["parent_control"])
            if cfg.get("parent_control") else None
        ),
        qos=QosConfig(**qos_cfg) if qos_cfg else None,
        proxy_timeout=float(cfg.get("proxy_timeout", 60.0)),
        scrape_timeout=float(cfg.get("scrape_timeout", 2.0)),
        breaker_failures=int(cfg.get("breaker_failures", 3)),
        breaker_successes=int(cfg.get("breaker_successes", 2)),
        breaker_open_seconds=float(cfg.get("breaker_open_seconds", 2.0)),
        probe_interval=float(cfg.get("probe_interval", 0.5)),
        probe_timeout=float(cfg.get("probe_timeout", 2.0)),
    )
    for i, r in enumerate(replicas):
        if r.get("generation") is not None:
            lb.set_replica_address(
                i, r["host"], int(r["port"]),
                generation=r["generation"],
            )
        for _ in range(int(r.get("held") or 0)):
            lb.breakers[i].hold()
        if r.get("restarting"):
            lb.set_restarting(i, True)
            lb.breakers[i].force_open()
    atomic_write_json(cfg["port_file"], {
        "shard": lb.shard_id,
        "pid": os.getpid(),
        "host": lb.host,
        "port": lb.port,
        "control_host": lb.control_addr[0],
        "control_port": lb.control_addr[1],
    })
    lb.start_background()
    lb.start_prober()
    ppid = os.getppid()
    try:
        while not lb.stopped():
            if os.getppid() != ppid:
                # Parent supervisor died without tearing us down: a
                # balancer shard must NEVER outlive its fleet.
                logger.error(
                    "fleet shard %d: parent died — exiting",
                    lb.shard_id,
                )
                break
            time.sleep(0.25)
    except KeyboardInterrupt:
        pass
    finally:
        lb.stop()
    return 0


class _ShardHandle:
    """The supervisor's view of one shard subprocess: its process and
    its private control address."""

    def __init__(self, shard_id: int, proc, host: str, port: int,
                 timeout: float = 5.0):
        self.shard_id = shard_id
        self.proc = proc
        self.host, self.port = host, int(port)
        self.timeout = float(timeout)

    def _request(self, method: str, path: str, payload=None):
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout
        )
        try:
            body = (
                json.dumps(payload).encode()
                if payload is not None else None
            )
            conn.request(
                method, path, body=body,
                headers={"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, json.loads(data.decode() or "null")
        finally:
            conn.close()

    def control(self, op: dict) -> bool:
        try:
            status, _ = self._request("POST", "/_shard/control", op)
            return status == 200
        except Exception as e:
            logger.warning(
                "fleet shard %d control op %s failed: %s",
                self.shard_id, op.get("op"), e,
            )
            return False

    def snapshot(self) -> dict:
        try:
            status, doc = self._request("GET", "/_shard/snapshot")
            if status == 200 and isinstance(doc, dict):
                return doc
            return {
                "shard": self.shard_id, "up": False,
                "error": f"http {status}",
            }
        except Exception as e:
            return {
                "shard": self.shard_id, "up": False, "error": str(e),
            }

    def request_stop(self) -> bool:
        try:
            status, _ = self._request("POST", "/_shard/stop", {})
            return status == 200
        except Exception:
            return False


class BalancerShardManager:
    """Launches and owns the extra balancer shard processes of a
    multi-process data plane (``balancer_procs`` N: the supervisor's
    balancer and N-1 of these). Each shard shares the fleet's listen port
    (``SO_REUSEPORT`` where the platform has it, else the parent's
    listener inherited by fd) and runs its own breakers, prober and
    threads; this manager is control plane only: the configuration
    handoff, the mirrored ops, the snapshots, the relaunch of a shard that
    died (:meth:`poll`) and the teardown."""

    def __init__(self, lb: LoadBalancer, count: int, *,
                 replica_specs: List[dict],
                 qos: Optional[dict] = None,
                 trace_dir: Optional[str] = None,
                 log_dir: Optional[str] = None,
                 start_timeout: float = 60.0,
                 kill_grace_seconds: float = 5.0):
        self.lb = lb
        self.count = max(0, int(count))
        self.replica_specs = list(replica_specs)
        self.qos = qos
        self.trace_dir = trace_dir
        self.log_dir = log_dir
        self.start_timeout = float(start_timeout)
        self.kill_grace_seconds = float(kill_grace_seconds)
        self.handles: List[_ShardHandle] = []
        self._procs: List = []
        self._logs: List = []
        self._tmp: Optional[str] = None
        self._pass_fds: Tuple[int, ...] = ()
        self._listen_fd: Optional[int] = None
        self._stopping = False
        #: Shard id -> a relaunch in flight: its process, port file,
        #: detection time, reason, the ops broadcast meanwhile, and how many
        #: launches of it died before binding.
        self._pending: Dict[int, dict] = {}
        #: One record a relaunch: shard, reason, seconds from detection to
        #: the new process's port file.
        self.relaunches: List[dict] = []
        self._launches = 0

    def _spawn(self, shard_id: int, replica_specs: List[dict],
               launch: int):
        """Write shard ``shard_id``'s configuration and start its
        process; returns (process, port file)."""
        port_file = os.path.join(
            self._tmp, f"shard-{shard_id}.{launch}.port"
        )
        cfg = {
            "shard": shard_id,
            "host": self.lb.host,
            "port": self.lb.port,
            "reuse_port": self.lb._reuse_port,
            "listen_fd": self._listen_fd,
            "port_file": port_file,
            "parent_control": list(self.lb.control_addr),
            "replicas": replica_specs,
            "qos": self.qos,
            "proxy_timeout": self.lb.proxy_timeout,
            "scrape_timeout": self.lb.scrape_timeout,
            "probe_interval": self.lb.probe_interval,
            "probe_timeout": self.lb.probe_timeout,
            "breaker_failures": self.lb.breakers[0].fail_threshold,
            "breaker_successes": self.lb.breakers[0].success_threshold,
            "breaker_open_seconds": self.lb.breakers[0].open_seconds,
            "trace_log": (
                os.path.join(self.trace_dir,
                             f"balancer-shard-{shard_id}.jsonl")
                if self.trace_dir else None
            ),
        }
        cfg_path = os.path.join(self._tmp, f"shard-{shard_id}.{launch}.json")
        # A one-shot handoff file the child reads once.
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        log = None
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            log = open(os.path.join(self.log_dir,
                                    f"balancer-shard-{shard_id}.log"), "ab")
            self._logs.append(log)
        proc = subprocess.Popen(
            [sys.executable, "-m", "glint_word2vec_torch.cli",
             "fleet-shard", "--config", cfg_path],
            pass_fds=self._pass_fds,
            stdout=log, stderr=log and subprocess.STDOUT,
            start_new_session=True,
        )
        self._procs.append(proc)
        return proc, port_file

    def start(self) -> None:
        import tempfile

        if self.count <= 0:
            return
        self._tmp = tempfile.mkdtemp(prefix="glint_fleet_shards_")
        if self.lb.control_addr is None:
            raise RuntimeError(
                "shard fan-out needs the parent balancer built with "
                "control=True"
            )
        if not self.lb._reuse_port:
            # The shared listener without SO_REUSEPORT: children adopt the
            # parent's bound socket by fd (one shared accept queue).
            self._listen_fd = self.lb._listener.fileno()
            self._pass_fds = (self._listen_fd,)
        launched = []
        for k in range(self.count):
            proc, port_file = self._spawn(k + 1, self.replica_specs, 0)
            launched.append((k + 1, proc, port_file))
        deadline = time.monotonic() + self.start_timeout
        for shard_id, proc, port_file in launched:
            info = None
            while time.monotonic() < deadline:
                info = self._read_port_file(port_file)
                if info is not None:
                    break
                if proc.poll() is not None:
                    self.stop_all()
                    raise RuntimeError(
                        f"balancer shard {shard_id} exited "
                        f"rc={proc.returncode} before binding"
                    )
                time.sleep(0.05)
            if info is None:
                self.stop_all()
                raise TimeoutError(
                    f"balancer shard {shard_id} not ready in "
                    f"{self.start_timeout:.0f}s"
                )
            self.handles.append(_ShardHandle(
                shard_id, proc, info["control_host"], info["control_port"],
            ))
        logger.info(
            "fleet data plane: %d shard process(es) sharing %s:%d (%s)",
            self.count, self.lb.host, self.lb.port,
            "SO_REUSEPORT" if self.lb._reuse_port
            else "inherited listener fd",
        )

    @staticmethod
    def _read_port_file(path: str) -> Optional[dict]:
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    #: Launches of one relaunch that may die before binding before the
    #: fleet gives up (``serve-fleet`` never runs on with fewer shards).
    RELAUNCH_ATTEMPTS = 3

    def broadcast(self, op: dict) -> None:
        for h in self.handles:
            pending = self._pending.get(h.shard_id)
            if pending is not None:
                pending["ops"].append(op)  # replayed once the shard is up
            else:
                h.control(op)

    def poll(self, replica_specs: Callable[[], List[dict]]) -> None:
        """Relaunch the shards whose process died, from the balancer's
        current replica table (``replica_specs()``), and adopt a relaunch
        whose port file has appeared, replaying the ops broadcast while it
        started. Never waits: the supervisor's sweep calls it. A launch
        that dies before binding is launched again, from a new snapshot of
        the table (which holds the ops sent meanwhile), up to
        :attr:`RELAUNCH_ATTEMPTS` times; then this raises."""
        if self._stopping:
            return
        now = time.monotonic()
        for h in self.handles:
            pending = self._pending.get(h.shard_id)
            if pending is None:
                rc = h.proc.poll()
                if rc is None:
                    continue
                reason = (f"exited rc={rc}" if rc >= 0
                          else f"killed by signal {-rc}")
                logger.error("fleet: balancer shard %d DOWN (%s); "
                             "relaunching", h.shard_id, reason)
                self._pending[h.shard_id] = {"detect_t": now,
                                             "reason": reason, "failed": 0}
                self._relaunch(h, replica_specs)
                continue
            info = self._read_port_file(pending["port_file"])
            if info is None:
                rc = pending["proc"].poll()
                if rc is not None:
                    pending["failed"] += 1
                    if pending["failed"] >= self.RELAUNCH_ATTEMPTS:
                        raise RuntimeError(
                            f"balancer shard {h.shard_id} died before "
                            f"binding {pending['failed']} times (rc={rc})")
                    self._relaunch(h, replica_specs)
                continue
            h.proc = pending["proc"]
            h.host, h.port = info["control_host"], int(info["control_port"])
            del self._pending[h.shard_id]
            for op in pending["ops"]:
                h.control(op)
            rec = {"shard": h.shard_id, "reason": pending["reason"],
                   "detect_to_ready_seconds": round(
                       now - pending["detect_t"], 3)}
            self.relaunches.append(rec)
            logger.info("fleet: balancer shard %d relaunched (pid %d) in "
                        "%.2fs", h.shard_id, h.proc.pid,
                        rec["detect_to_ready_seconds"])

    def _relaunch(self, h: _ShardHandle,
                  replica_specs: Callable[[], List[dict]]) -> None:
        """Start shard ``h`` again from the table as it stands now; the
        ops queued for an earlier launch are in that table already."""
        self._launches += 1
        pending = self._pending[h.shard_id]
        pending["proc"], pending["port_file"] = self._spawn(
            h.shard_id, replica_specs(), self._launches)
        pending["ops"] = []

    def snapshots(self) -> List[dict]:
        return [h.snapshot() for h in self.handles]

    def stop_all(self) -> None:
        """Teardown: ask every shard to stop over its control channel,
        then terminate or kill what is left, relaunches in flight too;
        ``serve-fleet`` never leaves a balancer process behind."""
        self._stopping = True
        for h in self.handles:
            h.request_stop()
        deadline = time.monotonic() + self.kill_grace_seconds
        for proc in self._procs:
            while proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if proc.poll() is None:
                terminate_process(
                    proc, grace_seconds=self.kill_grace_seconds
                )
        for f in self._logs:
            try:
                f.close()
            except OSError:
                pass
        self._logs = []
        if self._tmp:
            import shutil

            shutil.rmtree(self._tmp, ignore_errors=True)
            self._tmp = None


class _FleetDataPlane:
    """The supervisor's one write path to every balancer shard: an op is
    applied to the in-process balancer first and mirrored to each shard
    process over its control channel. ``down`` and ``fail``, asserted
    again on every sweep, are sent once a transition, so the steady state
    costs no control traffic; each shard's own prober keeps its breakers
    honest in between. Ops and a shard relaunch's snapshot of the replica
    table are serialised, so a relaunched shard misses no op and gets
    none twice."""

    def __init__(self, lb: LoadBalancer,
                 shards: Optional[BalancerShardManager] = None):
        self.lb = lb
        self.shards = shards
        self._sent_state: Dict[int, str] = {}
        self._mu = threading.RLock()

    def _bcast(self, op: dict) -> None:
        if self.shards is not None:
            self.shards.broadcast(op)

    def adopt(self, i: int, host: str, port: int,
              generation: Optional[str]) -> None:
        """A (re)launched replica: its address, out of the restart
        window, holds of its earlier incarnation cleared, and half-open
        so each shard's prober readmits it."""
        with self._mu:
            self.lb.set_replica_address(i, host, port,
                                        generation=generation)
            self.lb.set_restarting(i, False)
            self.lb.breakers[i].clear_holds()
            self.lb.breakers[i].trial()
            self._sent_state[i] = "up"
            self._bcast({
                "op": "set_address", "i": i, "host": host, "port": port,
                "generation": generation,
            })
            self._bcast({"op": "set_restarting", "i": i, "flag": False})
            self._bcast({"op": "clear_holds", "i": i})
            self._bcast({"op": "trial", "i": i})

    def down(self, i: int) -> None:
        """Replica inside a restart window: retry-on-refused and firmly
        open everywhere."""
        with self._mu:
            self.lb.set_restarting(i, True)
            self.lb.breakers[i].force_open()
            if self._sent_state.get(i) != "down":
                self._sent_state[i] = "down"
                self._bcast({"op": "set_restarting", "i": i, "flag": True})
                self._bcast({"op": "force_open", "i": i})

    def fail(self, i: int) -> None:
        """Replica written off (restart budget spent): no restart window,
        breaker firmly open everywhere."""
        with self._mu:
            self.lb.set_restarting(i, False)
            self.lb.breakers[i].force_open()
            if self._sent_state.get(i) != "failed":
                self._sent_state[i] = "failed"
                self._bcast({"op": "set_restarting", "i": i,
                             "flag": False})
                self._bcast({"op": "force_open", "i": i})

    def hold(self, i: int) -> None:
        with self._mu:
            self.lb.breakers[i].hold()
            self._bcast({"op": "hold", "i": i})

    def release(self, i: int) -> None:
        with self._mu:
            self.lb.breakers[i].release()
            self._bcast({"op": "release", "i": i})

    def clear_holds(self, i: int) -> None:
        with self._mu:
            self.lb.breakers[i].clear_holds()
            self._bcast({"op": "clear_holds", "i": i})

    def replica_specs(self) -> List[dict]:
        """The replica table a shard process starts from: each replica's
        address and launch generation, its hold count, and whether it is
        inside a restart window."""
        lb = self.lb
        with lb._mu:
            addrs = list(lb.replicas)
            gens = list(lb._expected_gen)
            restarting = list(lb._restarting)
        return [{"host": h, "port": p, "generation": g,
                 "held": b._held, "restarting": r}
                for (h, p), g, b, r in zip(addrs, gens, lb.breakers,
                                           restarting)]

    def poll_shards(self) -> None:
        """Relaunch a dead shard process (see
        :meth:`BalancerShardManager.poll`)."""
        if self.shards is None:
            return
        with self._mu:
            self.shards.poll(self.replica_specs)


# ----------------------------------------------------------------------
# Warm-spare autoscaler
# ----------------------------------------------------------------------


@dataclass
class AutoscaleConfig:
    """Demand-driven capacity policy. Scale-up = RELEASE a warm
    spare's park hold (the replica is already launched and warmed —
    readmit, never a cold boot); scale-down = park the highest-index
    live replica back to spare. Hysteresis windows + cooldown keep the
    loop from flapping; ``min_live``/``max_live`` bound it."""

    min_live: int
    max_live: int
    #: Policy evaluation period (seconds).
    interval: float = 0.5
    #: Scale-up pressure: fleet shed rate (sheds/sec across shards,
    #: QoS sheds included) at or above this...
    up_shed_per_sec: float = 1.0
    #: ...or forward-path p95 (ms, max across shards) at or above
    #: this. None = resolve to the SLO latency threshold
    #: (GLINT_SLO_LATENCY_MS, 250ms default).
    up_p95_ms: Optional[float] = None
    #: Pressure must be SUSTAINED this long before a scale-up...
    up_window_seconds: float = 1.0
    #: ...and idle this long before a scale-down (asymmetric on
    #: purpose: readmitting is cheap and urgent, parking is neither).
    down_window_seconds: float = 10.0
    #: Minimum seconds between ANY two transitions.
    cooldown_seconds: float = 5.0


class Autoscaler:
    """The FleetSupervisor's demand policy loop: reads the signals the
    fleet already emits (shed rate, forward-path p95 vs the SLO
    latency target, breaker-open count, fast-burn transitions) and
    moves replicas between live and parked through the shared
    :class:`ReplicaHoldLedger` — the same protocol the rollout
    coordinator holds through, so the two can never fight over a
    replica. A rollout in progress PINS the replica set (steps are
    counted, not applied); a replica held by any owner besides the
    autoscaler — a held canary above all — is never spare capacity.

    Dependency-injected callables keep it unit-testable without a
    fleet: ``signals()`` returns the current signal doc, ``parked()``
    the readmittable spares, ``live()`` the parkable live replicas,
    ``pinned()`` the rollout-pinning flag."""

    def __init__(self, *, holds: ReplicaHoldLedger,
                 config: AutoscaleConfig,
                 signals: Callable[[], dict],
                 parked: Callable[[], List[int]],
                 live: Callable[[], List[int]],
                 pinned: Optional[Callable[[], bool]] = None,
                 now_fn: Callable[[], float] = time.monotonic):
        cfg = config
        if cfg.up_p95_ms is None:
            cfg.up_p95_ms = float(
                os.environ.get("GLINT_SLO_LATENCY_MS") or 250.0
            )
        self.config = cfg
        self.holds = holds
        self._signals = signals
        self._parked = parked
        self._live = live
        self._pinned = pinned or (lambda: False)
        self._now = now_fn
        self._mu = threading.Lock()
        self._last_shed_total: Optional[float] = None
        self._last_step_t: Optional[float] = None
        self._pressure_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_transition_t: Optional[float] = None
        self._steps = 0
        self._step_faults = 0
        self._scale_ups = 0
        self._scale_downs = 0
        self._pinned_skips = 0
        self._last_shed_rate = 0.0
        self._last_p95_ms: Optional[float] = None
        self._transitions: deque = deque(maxlen=16)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def step(self) -> Optional[str]:
        """One policy evaluation; returns "up"/"down" when a
        transition happened, else None."""
        with self._mu:
            self._steps += 1
        try:
            faults.fire("fleet.autoscale_step")
        except Exception:
            with self._mu:
                self._step_faults += 1
            return None
        now = self._now()
        sig = self._signals() or {}
        shed_total = float(sig.get("shed_total") or 0.0)
        p95 = sig.get("p95_ms")
        with self._mu:
            if self._last_shed_total is None or self._last_step_t is None:
                rate = 0.0
            else:
                dt = max(now - self._last_step_t, 1e-6)
                rate = max(0.0, shed_total - self._last_shed_total) / dt
            self._last_shed_total = shed_total
            self._last_step_t = now
            self._last_shed_rate = rate
            self._last_p95_ms = p95
        cfg = self.config
        pressure = (
            rate >= cfg.up_shed_per_sec
            or (p95 is not None and p95 >= cfg.up_p95_ms)
            or int(sig.get("breakers_open") or 0) > 0
            or bool(sig.get("fast_burn"))
        )
        with self._mu:
            if pressure:
                self._idle_since = None
                if self._pressure_since is None:
                    self._pressure_since = now
                pressure_for = now - self._pressure_since
                idle_for = 0.0
            else:
                self._pressure_since = None
                if self._idle_since is None:
                    self._idle_since = now
                idle_for = now - self._idle_since
                pressure_for = 0.0
            last_t = self._last_transition_t
        if self._pinned():
            # Rollout/canary in flight: the replica set is pinned.
            # Hysteresis clocks keep running — a surge during a
            # rollout scales up the moment the swap completes.
            with self._mu:
                self._pinned_skips += 1
            return None
        if last_t is not None and now - last_t < cfg.cooldown_seconds:
            return None
        if pressure and pressure_for >= cfg.up_window_seconds:
            live = self._live()
            if len(live) >= cfg.max_live:
                return None
            spares = [
                i for i in self.holds.parked("autoscale")
                if i in set(self._parked())
            ]
            if not spares:
                return None
            i = spares[0]
            self.holds.release("autoscale", i)
            with self._mu:
                self._scale_ups += 1
                self._last_transition_t = now
                self._transitions.append({
                    "dir": "up", "replica": i,
                    "shed_rate": round(rate, 3),
                    "p95_ms": p95,
                    "t": round(now, 3),
                })
            logger.info(
                "autoscale UP: readmitted warm spare %d "
                "(shed %.2f/s, p95 %s ms)", i, rate, p95,
            )
            return "up"
        if not pressure and idle_for >= cfg.down_window_seconds:
            live = self._live()
            if len(live) <= cfg.min_live:
                return None
            candidates = [
                i for i in live if not self.holds.owners(i)
            ]
            if not candidates:
                return None
            i = max(candidates)
            self.holds.acquire("autoscale", i)
            with self._mu:
                self._scale_downs += 1
                self._last_transition_t = now
                self._idle_since = now
                self._transitions.append({
                    "dir": "down", "replica": i,
                    "shed_rate": round(rate, 3),
                    "p95_ms": p95,
                    "t": round(now, 3),
                })
            logger.info(
                "autoscale DOWN: parked replica %d as warm spare "
                "(idle %.1fs)", i, idle_for,
            )
            return "down"
        return None

    def stats(self) -> dict:
        cfg = self.config
        with self._mu:
            return {
                "enabled": True,
                "live": len(self._live()),
                "spares": len(self.holds.parked("autoscale")),
                "min_live": cfg.min_live,
                "max_live": cfg.max_live,
                "scale_ups_total": self._scale_ups,
                "scale_downs_total": self._scale_downs,
                "pinned_skips_total": self._pinned_skips,
                "steps_total": self._steps,
                "step_faults_total": self._step_faults,
                "last_shed_rate": round(self._last_shed_rate, 3),
                "last_p95_ms": self._last_p95_ms,
                "transitions": list(self._transitions),
            }

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="glint-fleet-autoscale",
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.config.interval):
            try:
                self.step()
            except Exception:  # pragma: no cover - defensive
                logger.exception("autoscale step failed")

    def stop(self) -> None:
        self._stop.set()


def _hist_window_delta(prev: Optional[dict],
                       cur: dict) -> Optional[LatencyHistogram]:
    """The traffic between two cumulative :class:`LatencyHistogram`
    states, as a histogram. ``prev`` None (first observation) returns
    the whole cumulative state; a bucket that went BACKWARDS means the
    producer restarted and reset, so the current state IS the window.
    The window's true max is unknowable from cumulative states — the
    cumulative max only widens the quantile interpolation clamp."""
    cur_h = LatencyHistogram.from_state(cur)
    if prev is None:
        return cur_h
    prev_h = LatencyHistogram.from_state(prev)
    out = LatencyHistogram()
    for i, c in enumerate(cur_h.counts):
        d = c - prev_h.counts[i]
        if d < 0:
            return cur_h
        out.counts[i] = d
    out.n = max(0, cur_h.n - prev_h.n)
    out.total = max(0.0, cur_h.total - prev_h.total)
    out.max = cur_h.max
    return out


def _sum_balancer_stats(blocks: List[dict]) -> dict:
    """Fold per-shard ``balancer_stats`` blocks into fleet totals
    (counters sum; QoS inflight gauges sum, peaks max, per-tenant
    maps merge key-wise)."""
    out = {
        "shed_retries_total": 0,
        "exhausted_total": 0,
        "proxied_total": 0,
        "proxy_errors_total": 0,
        "breaker_skips_total": 0,
        "restart_retries_total": 0,
        "retry_after_honored_total": 0,
    }
    qos_out = None
    for b in blocks:
        if not b:
            continue
        for k in out:
            out[k] += int(b.get(k) or 0)
        q = b.get("qos")
        if q:
            if qos_out is None:
                qos_out = {
                    "admitted_total": {},
                    "shed_total": {},
                    "per_tenant_shed_total": {},
                    "bulk_inflight": 0,
                    "bulk_inflight_peak": 0,
                }
            for key in ("admitted_total", "shed_total",
                        "per_tenant_shed_total"):
                for name, n in (q.get(key) or {}).items():
                    qos_out[key][name] = (
                        qos_out[key].get(name, 0) + int(n)
                    )
            qos_out["bulk_inflight"] += int(q.get("bulk_inflight") or 0)
            qos_out["bulk_inflight_peak"] = max(
                qos_out["bulk_inflight_peak"],
                int(q.get("bulk_inflight_peak") or 0),
            )
    if qos_out is not None:
        out["qos"] = qos_out
    return out


# ----------------------------------------------------------------------
# Fleet supervisor + launcher
# ----------------------------------------------------------------------


@dataclass
class _ReplicaSlot:
    """One supervised replica slot: the live process, its launch
    generation (the /healthz handshake value), and restart pacing."""

    index: int
    state: str = "starting"   # starting | up | backoff | failed | stopped
    proc: Optional[subprocess.Popen] = None
    launch_generation: int = -1
    port_file: str = ""
    host: Optional[str] = None
    port: Optional[int] = None
    restarts: int = 0
    relaunch_at: float = 0.0
    started_at: float = 0.0
    detect_t: Optional[float] = None
    last_reason: Optional[str] = None
    restart_records: List[dict] = field(default_factory=list)

    def gen_tag(self) -> str:
        return f"{self.index}.{self.launch_generation}"


class FleetSupervisor:
    """Self-healing serving fleet: supervised replicas behind a
    breaker-aware balancer, with coordinated rolling rollout
    (``fleet.py:3268-4159`` of the JAX package).

    Replica liveness is watched by ``waitpid`` (a crash) and by the
    balancer's active prober (a hang: a replica whose probes fail
    continuously for ``hang_kill_seconds`` while its process runs is
    killed and treated as crashed). A dead replica is relaunched from the
    fleet's current model directory under capped exponential backoff and
    a per-replica ``max_restarts`` budget; a replica out of budget is left
    down (the balancer serves from the others) and counted on
    ``/metrics``. Every launch exports ``GLINT_FLEET_GEN``; the replica
    echoes it on ``/healthz`` and in its port file, so a process or port
    file of an earlier launch is never taken for the new one.

    Replicas run ``python -m glint_word2vec_torch.cli serve --device
    <device>``, each on the card unless ``device`` says otherwise, and all
    hold the same catalog: the default model, ``models`` (id -> directory)
    and the models of ``model_watch_dirs`` (id -> publish directory), under
    ``model_memory_budget``. With ``watch_dir`` (coordinated, the
    default), replicas do not watch the publish directory themselves: a
    :class:`RolloutCoordinator` orders every swap one replica at a time,
    behind the shadow canary when ``canary`` is set, and each watched
    catalog model gets a coordinator of its own. A relaunched replica
    boots from the promoted generations, so a restart mid-rollout
    converges with the coordinator instead of racing it.

    Demand-driven: ``warm_spares`` replicas more boot and warm with the
    fleet and are parked until the :class:`Autoscaler` (``autoscale``, or
    its defaults) readmits them; ``balancer_procs`` data-plane processes
    share the listen port (:class:`BalancerShardManager`), a dead one
    relaunched by the sweep; ``qos`` arms the :class:`QosGate` in every
    shard; ``trace_dir`` gets ``balancer.jsonl``, one
    ``balancer-shard-<k>.jsonl`` a shard process, one
    ``replica-<i>.jsonl`` a replica, the balancer's flight bundles under
    ``flight/`` and each replica's under ``flight/replica-<i>/``.
    """

    def __init__(
        self,
        model_dir: Optional[str],
        *,
        replicas: int = 2,
        host: str = "127.0.0.1",
        port: int = 8800,
        watch_dir: Optional[str] = None,
        watch_poll: float = 1.0,
        replica_flags: Optional[List[str]] = None,
        log_dir: Optional[str] = None,
        ready_timeout: float = 900.0,
        port_file: Optional[str] = None,
        max_restarts: int = 3,
        backoff_base_seconds: float = 1.0,
        backoff_cap_seconds: float = 30.0,
        hang_kill_seconds: float = 10.0,
        poll_interval: float = 0.25,
        kill_grace_seconds: float = 5.0,
        probe_interval: float = 0.5,
        probe_timeout: float = 2.0,
        breaker_failures: int = 3,
        breaker_successes: int = 2,
        breaker_open_seconds: float = 2.0,
        canary: Optional[CanaryConfig] = None,
        rollout_step_timeout: float = 600.0,
        coordinated: bool = True,
        build_replica_argv: Optional[Callable[[int, str], List[str]]] = None,
        replica_env_first_launch: Optional[Dict[int, Dict[str, str]]] = None,
        models: Optional[Dict[str, str]] = None,
        model_watch_dirs: Optional[Dict[str, str]] = None,
        model_memory_budget=None,
        device: str = "cuda",
        trace_dir: Optional[str] = None,
        warm_spares: int = 0,
        autoscale: Optional[AutoscaleConfig] = None,
        balancer_procs: int = 1,
        qos: Optional[QosConfig] = None,
    ):
        if model_dir is None and watch_dir is None \
                and build_replica_argv is None:
            raise ValueError("model_dir or watch_dir required")
        self.model_dir = model_dir
        #: ``replicas`` live and ``warm_spares`` launched and parked: a
        #: spare boots and warms, then stays held out of rotation until the
        #: autoscaler readmits it (a scale-up is never a cold boot).
        self.base_replicas = max(1, int(replicas))
        self.warm_spares = max(0, int(warm_spares))
        self.num_replicas = self.base_replicas + self.warm_spares
        self.host, self.port = host, int(port)
        self.watch_dir = watch_dir
        self.watch_poll = float(watch_poll)
        self.replica_flags = list(replica_flags or [])
        self.log_dir = log_dir
        self.ready_timeout = float(ready_timeout)
        self.port_file = port_file
        self.max_restarts = int(max_restarts)
        self.backoff_base_seconds = float(backoff_base_seconds)
        self.backoff_cap_seconds = float(backoff_cap_seconds)
        self.hang_kill_seconds = float(hang_kill_seconds)
        self.poll_interval = float(poll_interval)
        self.kill_grace_seconds = float(kill_grace_seconds)
        self.probe_interval = float(probe_interval)
        self.probe_timeout = float(probe_timeout)
        self.breaker_failures = int(breaker_failures)
        self.breaker_successes = int(breaker_successes)
        self.breaker_open_seconds = float(breaker_open_seconds)
        self.canary = canary
        self.rollout_step_timeout = float(rollout_step_timeout)
        self.coordinated = bool(coordinated)
        self._build_replica_argv = build_replica_argv
        self.replica_env_first_launch = dict(replica_env_first_launch or {})
        #: The tracing directory: the balancer's spans go to
        #: ``balancer.jsonl``, each replica's ``--trace-log`` and
        #: ``--flight-dir`` point into it, and the balancer's flight
        #: recorder writes under ``flight/``; ``cli trace-merge`` stitches
        #: the files into one timeline.
        self.trace_dir = trace_dir
        self.balancer_procs = max(1, int(balancer_procs))
        self.qos = qos
        self.autoscale_config = autoscale
        #: The device every replica serves on (``serve --device``).
        self.device = str(device)
        #: Extra model id -> model directory every replica serves besides
        #: the default (``--add-model``); a watched model's entry follows
        #: its promoted generation.
        self.models: Dict[str, str] = dict(models or {})
        #: Model id -> publish directory, each with a rollout coordinator
        #: of its own, so one model's pointer move rolls that model only.
        self.model_watch_dirs: Dict[str, str] = dict(model_watch_dirs or {})
        self.model_memory_budget = model_memory_budget
        self._mu = threading.Lock()
        self._slots = [_ReplicaSlot(index=i) for i in range(self.num_replicas)]
        self._restarts_total = 0
        #: Model directory replicas (re)launch from; the rollout
        #: coordinator advances it on every promoted generation.
        self._current_model_dir = model_dir
        self._logs: List = []
        self._tmp: Optional[str] = None
        self._stop = threading.Event()
        #: Set once the balancer, its prober and the coordinators are
        #: live: the readiness barrier.
        self.ready = threading.Event()
        self.lb: Optional[LoadBalancer] = None
        self.coordinator: Optional[RolloutCoordinator] = None
        #: The per-model rollout coordinators (one a watched model),
        #: sharing the balancer and the hold ledger with the default one.
        self.model_coordinators: List[RolloutCoordinator] = []
        self.dp: Optional[_FleetDataPlane] = None
        self.holds: Optional[ReplicaHoldLedger] = None
        self.autoscaler: Optional[Autoscaler] = None
        self.shards: Optional[BalancerShardManager] = None
        #: The previous forward-path histogram state by (shard, endpoint),
        #: which ``_autoscale_signals`` differences into a windowed p95.
        #: Only the autoscaler's thread touches it.
        self._autoscale_prev_hists: Dict[Tuple, dict] = {}

    # -- replica launch ------------------------------------------------

    def _default_replica_argv(self, index: int, port_file: str) -> List[str]:
        argv = [
            sys.executable, "-m", "glint_word2vec_torch.cli", "serve",
            "--host", "127.0.0.1", "--port", "0",
            "--port-file", port_file, "--device", self.device,
        ]
        with self._mu:
            model = self._current_model_dir
            catalog = dict(self.models)
        if self.coordinated or self.watch_dir is None:
            # The replica serves one generation and swaps only when the
            # rollout coordinator orders it.
            argv += ["--model", model]
        else:
            # Uncoordinated: every replica follows the publish directory
            # itself (the whole fleet swaps at once).
            if model:
                argv += ["--model", model]
            argv += ["--watch-checkpoint", self.watch_dir,
                     "--watch-poll", str(self.watch_poll)]
        if self.trace_dir:
            # A flight directory a replica: each numbers its bundles from
            # 001, so two replicas sharing one would write into one bundle.
            argv += [
                "--trace-log",
                os.path.join(self.trace_dir, f"replica-{index}.jsonl"),
                "--flight-dir",
                os.path.join(self.trace_dir, "flight", f"replica-{index}"),
            ]
        # Every replica holds the same catalog; a watched model launches
        # from its promoted generation, so a relaunch converges with the
        # per-model rollouts.
        for mid in sorted(catalog):
            argv += ["--add-model", f"{mid}={catalog[mid]}"]
        if self.model_memory_budget is not None:
            argv += ["--model-memory-budget", str(self.model_memory_budget)]
        return argv + list(self.replica_flags)

    def _argv(self, index: int, port_file: str) -> List[str]:
        if self._build_replica_argv is not None:
            return self._build_replica_argv(index, port_file)
        return self._default_replica_argv(index, port_file)

    def _open_log(self, index: int):
        if not self.log_dir:
            return None
        os.makedirs(self.log_dir, exist_ok=True)
        f = open(os.path.join(self.log_dir, f"replica-{index}.log"), "ab")
        self._logs.append(f)
        return f

    def _launch(self, slot: _ReplicaSlot) -> None:
        slot.launch_generation += 1
        slot.port_file = os.path.join(
            self._tmp, f"replica-{slot.index}.{slot.launch_generation}.port")
        try:
            os.remove(slot.port_file)
        except OSError:
            pass
        env = dict(os.environ)
        env["GLINT_FLEET_GEN"] = slot.gen_tag()
        if slot.launch_generation == 0:
            # The chaos seam: a GLINT_FAULTS schedule armed here fires in
            # the first launch and is not armed again on a relaunch.
            env.update(self.replica_env_first_launch.get(slot.index, {}))
        log = self._open_log(slot.index)
        if log is not None:
            log.write(f"\n===== launch generation {slot.launch_generation} "
                      f"replica {slot.index} =====\n".encode())
            log.flush()
        slot.proc = subprocess.Popen(
            self._argv(slot.index, slot.port_file),
            env=env, stdout=log, stderr=log and subprocess.STDOUT,
            start_new_session=True,
        )
        slot.state = "starting"
        slot.started_at = time.monotonic()
        logger.info("fleet: replica %d launched (generation %s, pid %d)",
                    slot.index, slot.gen_tag(), slot.proc.pid)

    def _read_port_file(self, slot: _ReplicaSlot) -> Optional[dict]:
        """The replica's readiness file, generation-checked: a stale file
        of an earlier launch is never adopted."""
        try:
            with open(slot.port_file) as f:
                info = json.load(f)
        except (OSError, ValueError):
            return None
        gen = info.get("fleet_generation")
        if gen is not None and str(gen) != slot.gen_tag():
            return None
        return info

    # -- supervision ---------------------------------------------------

    def _schedule_restart(self, slot: _ReplicaSlot, reason: str) -> None:
        now = time.monotonic()
        with self._mu:
            if slot.restarts >= self.max_restarts:
                slot.state = "failed"
                slot.last_reason = reason
                logger.error(
                    "fleet: replica %d FAILED (%s) with restart budget %d "
                    "spent: left down, the fleet serves from the others",
                    slot.index, reason, self.max_restarts)
                if self.dp is not None:
                    self.dp.fail(slot.index)
                return
            backoff = capped_backoff(slot.restarts, self.backoff_base_seconds,
                                     self.backoff_cap_seconds)
            slot.restarts += 1
            self._restarts_total += 1
            slot.state = "backoff"
            slot.relaunch_at = now + backoff
            slot.detect_t = now
            slot.last_reason = reason
            slot.restart_records.append({
                "reason": reason,
                "backoff_seconds": round(backoff, 3),
                "launch_generation": slot.launch_generation,
                "detect_to_ready_seconds": None,
            })
        logger.error("fleet: replica %d DOWN (%s); restart %d/%d in %.1fs",
                     slot.index, reason, slot.restarts, self.max_restarts,
                     backoff)

    def _adopt(self, slot: _ReplicaSlot, info: dict) -> None:
        """A (re)launched replica published its generation-checked port
        file: point every balancer shard at it and half-open its breaker,
        so each shard's prober readmits it after M successes. Ledger holds
        survive the relaunch: a parked spare that crashes comes back
        parked."""
        slot.host = info.get("host", "127.0.0.1")
        slot.port = int(info["port"])
        self.dp.adopt(slot.index, slot.host, slot.port, slot.gen_tag())
        if self.holds is not None:
            self.holds.reapply(slot.index)
        with self._mu:
            slot.state = "up"
            if slot.detect_t is not None and slot.restart_records:
                slot.restart_records[-1]["detect_to_ready_seconds"] = round(
                    time.monotonic() - slot.detect_t, 3)
                slot.detect_t = None
        logger.info("fleet: replica %d ready on %s:%d (generation %s)",
                    slot.index, slot.host, slot.port, slot.gen_tag())

    def _sweep(self) -> None:
        """One supervision pass over every slot."""
        now = time.monotonic()
        for slot in self._slots:
            if slot.state in ("failed", "stopped"):
                if slot.state == "failed" and self.dp is not None:
                    # Keep the breaker firmly open: no trials against a
                    # written-off address.
                    self.dp.fail(slot.index)
                continue
            rc = slot.proc.poll() if slot.proc is not None else None
            if rc is not None and slot.state in ("up", "starting"):
                if self._stop.is_set():
                    slot.state = "stopped"
                    continue
                self.dp.down(slot.index)
                self._schedule_restart(
                    slot, f"exited rc={rc}" if rc >= 0
                    else f"killed by signal {-rc}")
                continue
            if slot.state == "up":
                failing = self.lb.breakers[slot.index].failing_for()
                if failing > self.hang_kill_seconds:
                    # Hung: the process lives but its probes have failed
                    # past the budget; put it down as a crash.
                    logger.error("fleet: replica %d HUNG (probes failing for "
                                 "%.1fs): killing pid %d", slot.index,
                                 failing, slot.proc.pid)
                    self.dp.down(slot.index)
                    terminate_process(slot.proc,
                                      grace_seconds=self.kill_grace_seconds)
                    self._schedule_restart(
                        slot, f"hung ({failing:.1f}s of probe failures)")
                continue
            if slot.state == "backoff":
                self.dp.down(slot.index)
                if now >= slot.relaunch_at:
                    self._launch(slot)
                continue
            if slot.state == "starting":
                self.dp.down(slot.index)
                info = self._read_port_file(slot)
                if info is not None:
                    self._adopt(slot, info)
                elif now - slot.started_at > self.ready_timeout:
                    terminate_process(slot.proc,
                                      grace_seconds=self.kill_grace_seconds)
                    self._schedule_restart(
                        slot, f"not ready within {self.ready_timeout:.0f}s")

    # -- observability -------------------------------------------------

    def _doc_extra(self) -> dict:
        with self._mu:
            states = [
                {
                    "replica": s.index,
                    "state": s.state,
                    "restarts": s.restarts,
                    "launch_generation": s.launch_generation,
                    "last_reason": s.last_reason,
                    "restart_records": list(s.restart_records[-8:]),
                }
                for s in self._slots
            ]
            sup = {
                "restarts_total": self._restarts_total,
                "replicas_failed": sum(1 for s in self._slots
                                       if s.state == "failed"),
                "max_restarts": self.max_restarts,
                "replica_states": states,
            }
        doc = {"supervisor": sup}
        if self.coordinator is not None:
            doc["rollout"] = self.coordinator.stats()
        if self.model_coordinators:
            doc["model_rollouts"] = {c.model_id: c.stats()
                                     for c in self.model_coordinators}
        if self.autoscaler is not None:
            doc["autoscale"] = self.autoscaler.stats()
        if self.holds is not None:
            doc["holds"] = self.holds.snapshot()
        if self.lb is not None:
            doc["data_plane"] = {
                "balancer_procs": self.balancer_procs,
                "reuse_port": self.lb._reuse_port,
            }
        if self.shards is not None and self.shards.handles \
                and self.lb is not None:
            from glint_word2vec_torch.obs.aggregate import (
                merge_serving_snapshots,
            )

            # Shard 0 is the supervisor's balancer, the others the shard
            # processes. Their serving snapshots fold like replicas' (the
            # histograms bucket for bucket, the SLO counts summed), and
            # their balancer counters sum into the fleet's.
            shard_snaps = [self.lb.shard_snapshot()] + self.shards.snapshots()
            doc["balancer_shards"] = shard_snaps
            doc["balancer_fleet"] = merge_serving_snapshots([
                s["serving"] for s in shard_snaps if s.get("serving")
            ])
            doc["balancer"] = _sum_balancer_stats([
                s.get("stats") for s in shard_snaps if s.get("up")
            ])
            doc["data_plane"]["shard_relaunches"] = list(
                self.shards.relaunches)
        return doc

    def report(self) -> dict:
        """The restart, rollout and hold accounting of ``/metrics``."""
        return self._doc_extra()

    # -- main loop -----------------------------------------------------

    def _resolve_boot(self) -> Optional[str]:
        """The generation the fleet boots from (None for a model
        directory outside the publish protocol). Waits for a first
        committed generation when only ``watch_dir`` was given."""
        from glint_word2vec_torch.streaming.publish import resolve_latest

        if self.model_dir is not None:
            if self.watch_dir is not None:
                md = os.path.abspath(self.model_dir)
                if os.path.dirname(md) == os.path.abspath(self.watch_dir):
                    return os.path.basename(md)
            return None
        if self.watch_dir is None:
            return None  # a custom build_replica_argv owns the boot
        while not self._stop.is_set():
            gen_dir = resolve_latest(self.watch_dir)
            if gen_dir is not None:
                with self._mu:
                    self._current_model_dir = gen_dir
                return os.path.basename(gen_dir)
            logger.info("fleet: waiting for a first committed generation "
                        "in %s", self.watch_dir)
            time.sleep(max(0.5, self.watch_poll))
        return None

    def _resolve_model_boots(self) -> Dict[str, str]:
        """The boot generation of each watched catalog model. A model also
        given an ``--add-model`` directory inside its publish directory
        boots from that generation; else this waits for the model's first
        committed generation and records its directory in ``models``, so
        every replica's ``--add-model`` names a loadable path."""
        from glint_word2vec_torch.streaming.publish import resolve_latest

        boots: Dict[str, str] = {}
        for mid in sorted(self.model_watch_dirs):
            pub = self.model_watch_dirs[mid]
            with self._mu:
                static = self.models.get(mid)
            if static is not None:
                sd = os.path.abspath(static)
                if os.path.dirname(sd) == os.path.abspath(pub):
                    boots[mid] = os.path.basename(sd)
                    continue
            while not self._stop.is_set():
                gen_dir = resolve_latest(pub)
                if gen_dir is not None:
                    with self._mu:
                        self.models[mid] = gen_dir
                    boots[mid] = os.path.basename(gen_dir)
                    break
                logger.info("fleet: waiting for model %r's first committed "
                            "generation in %s", mid, pub)
                time.sleep(max(0.5, self.watch_poll))
        return boots

    def _wait_initial_ready(self) -> None:
        """Wait until every replica published its generation-checked port
        file; a replica that dies first is a boot error (a misconfigured
        fleet fails fast)."""
        deadline = time.time() + self.ready_timeout
        for slot in self._slots:
            while True:
                if self._stop.is_set():
                    return  # stop() during boot: run() exits promptly
                info = self._read_port_file(slot)
                if info is not None:
                    slot.host = info.get("host", "127.0.0.1")
                    slot.port = int(info["port"])
                    slot.state = "up"
                    break
                if slot.proc.poll() is not None:
                    raise RuntimeError(
                        f"replica {slot.index} exited "
                        f"rc={slot.proc.returncode} before binding its port")
                if time.time() > deadline:
                    raise TimeoutError(f"replica {slot.index} not ready in "
                                       f"{self.ready_timeout}s")
                time.sleep(0.1)

    def _start_coordinators(self, boot_gen: Optional[str],
                            model_boots: Dict[str, str]) -> None:
        """The default model's rollout coordinator (with ``watch_dir``)
        and one a watched catalog model, all on the shared hold ledger."""
        if not self.coordinated:
            return
        if self.watch_dir is not None:
            with self._mu:
                cur_dir = self._current_model_dir
            self.coordinator = RolloutCoordinator(
                self.lb, self.watch_dir, poll_seconds=self.watch_poll,
                current=boot_gen, current_dir=cur_dir, canary=self.canary,
                step_timeout=self.rollout_step_timeout,
                replica_ok=self._replica_ok,
                on_generation=self._on_generation, holds=self.holds,
            )
            self.coordinator.start()
        mcs: List[RolloutCoordinator] = []
        for mid in sorted(self.model_watch_dirs):
            with self._mu:
                cur_dir = self.models.get(mid)
            mcs.append(RolloutCoordinator(
                self.lb, self.model_watch_dirs[mid],
                poll_seconds=self.watch_poll,
                current=model_boots.get(mid), current_dir=cur_dir,
                canary=(self.canary.scoped(mid)
                        if self.canary is not None else None),
                step_timeout=self.rollout_step_timeout,
                replica_ok=self._replica_ok,
                on_generation=self._on_model_generation(mid),
                holds=self.holds, model_id=mid,
            ))
        self.model_coordinators = mcs
        for mc in mcs:
            mc.start()

    def run(self) -> int:
        """Launch the fleet and supervise it until it is shut down (``POST
        /shutdown`` on the balancer, an interrupt, or :meth:`stop`).
        Returns 0 on a clean shutdown."""
        import tempfile

        from glint_word2vec_torch.utils import atomic_write_json

        recorder = None
        with tempfile.TemporaryDirectory(prefix="glint_fleet_") as tmp:
            self._tmp = tmp
            try:
                boot_gen = self._resolve_boot()
                if self._stop.is_set():
                    return 0
                # Watched catalog models resolve to loadable directories
                # before the first launch: they ride every --add-model.
                model_boots = self._resolve_model_boots()
                if self._stop.is_set():
                    return 0
                if self.trace_dir:
                    # Before the first launch: the replicas' --trace-log
                    # files open inside this directory.
                    os.makedirs(self.trace_dir, exist_ok=True)
                    recorder = obs_events.EventRecorder(
                        jsonl_path=os.path.join(self.trace_dir,
                                                "balancer.jsonl"))
                    obs_events.set_recorder(recorder)
                for slot in self._slots:
                    self._launch(slot)
                self._wait_initial_ready()
                if self._stop.is_set():
                    return 0
                urls = [f"http://{s.host}:{s.port}" for s in self._slots]
                multi = self.balancer_procs > 1
                self.lb = LoadBalancer(
                    urls, host=self.host, port=self.port,
                    breaker_failures=self.breaker_failures,
                    breaker_successes=self.breaker_successes,
                    breaker_open_seconds=self.breaker_open_seconds,
                    probe_interval=self.probe_interval,
                    probe_timeout=self.probe_timeout,
                    reuse_port=multi, control=multi, shard_id=0,
                    qos=self.qos,
                )
                for slot in self._slots:
                    self.lb.set_replica_address(slot.index, slot.host,
                                                slot.port,
                                                generation=slot.gen_tag())
                self.dp = _FleetDataPlane(self.lb)
                self.holds = ReplicaHoldLedger(
                    self.dp.hold, self.dp.release, self.dp.clear_holds)
                # Park the warm spares before any traffic flows: launched
                # and warmed, held out of rotation until readmitted.
                for slot in self._slots[self.base_replicas:]:
                    self.holds.acquire("autoscale", slot.index)
                self.lb.doc_extra = self._doc_extra
                self.lb.on_shutdown = self._stop.set
                if self.trace_dir:
                    self.lb.enable_flight_recorder(
                        os.path.join(self.trace_dir, "flight"))
                self.lb.start_background()
                self.lb.start_prober()
                if multi:
                    self._start_shards()
                self._start_coordinators(boot_gen, model_boots)
                self._start_autoscaler()
                # The port file is the readiness signal: written once the
                # whole control plane (shards, coordinators, autoscaler)
                # is up, so the first /metrics a reader sends carries
                # every block.
                if self.port_file:
                    atomic_write_json(self.port_file,
                                      {"host": self.lb.host,
                                       "port": self.lb.port})
                logger.info("fleet up: %d replicas (%s, %d warm spare(s)) "
                            "behind %s:%d x%d balancer process(es)%s",
                            self.num_replicas, ", ".join(urls),
                            self.warm_spares, self.lb.host, self.lb.port,
                            self.balancer_procs,
                            f", serving {boot_gen}" if boot_gen else "")
                self.ready.set()
                try:
                    while not self._stop.is_set() and not self.lb.stopped():
                        self._sweep()
                        self.dp.poll_shards()
                        time.sleep(self.poll_interval)
                except KeyboardInterrupt:
                    pass
                return 0
            finally:
                self._stop.set()
                self.ready.set()
                if self.autoscaler is not None:
                    self.autoscaler.stop()
                if self.coordinator is not None:
                    self.coordinator.stop()
                for mc in self.model_coordinators:
                    mc.stop()
                if self.shards is not None:
                    self.shards.stop_all()
                if self.lb is not None:
                    self.lb.stop()
                for slot in self._slots:
                    if slot.proc is not None:
                        terminate_process(slot.proc,
                                          grace_seconds=self.kill_grace_seconds)
                for f in self._logs:
                    try:
                        f.close()
                    except OSError:
                        pass
                self._logs = []
                self._tmp = None
                if recorder is not None:
                    if obs_events.get_recorder() is recorder:
                        obs_events.set_recorder(None)
                    recorder.close()

    def _start_shards(self) -> None:
        """The ``balancer_procs - 1`` shard processes, started from the
        balancer's replica table (spares already held), each with the QoS
        settings and its own trace file."""
        qos = None
        if self.qos is not None:
            qos = {
                "tenant_rate": self.qos.tenant_rate,
                "tenant_burst": self.qos.tenant_burst,
                "bulk_max_inflight": self.qos.bulk_max_inflight,
                "max_tenants": self.qos.max_tenants,
            }
        self.shards = BalancerShardManager(
            self.lb, self.balancer_procs - 1,
            replica_specs=self.dp.replica_specs(), qos=qos,
            trace_dir=self.trace_dir, log_dir=self.log_dir,
            kill_grace_seconds=self.kill_grace_seconds,
        )
        self.shards.start()
        self.dp.shards = self.shards

    def _start_autoscaler(self) -> None:
        """The autoscaler, when the fleet has warm spares or an
        ``autoscale`` policy; pinned while any rollout is in progress."""
        if self.warm_spares <= 0 and self.autoscale_config is None:
            return
        cfg = self.autoscale_config or AutoscaleConfig(
            min_live=self.base_replicas, max_live=self.num_replicas)
        coords = [c for c in [self.coordinator, *self.model_coordinators]
                  if c is not None]
        pinned = ((lambda: any(c.in_progress() for c in coords))
                  if coords else None)
        self.autoscaler = Autoscaler(
            holds=self.holds, config=cfg,
            signals=self._autoscale_signals,
            parked=self._autoscale_parked,
            live=self._autoscale_live,
            pinned=pinned,
        )
        self.autoscaler.start()

    def _replica_ok(self, i: int) -> bool:
        with self._mu:
            return self._slots[i].state not in ("failed", "stopped")

    # -- autoscaler plumbing -------------------------------------------

    def _autoscale_signals(self) -> dict:
        """The demand signals the fleet already emits, folded across
        every balancer shard: cumulative shed count (retry-path sheds +
        exhaustions + QoS sheds), WINDOWED forward-path p95 (over the
        traffic since the previous policy step — a cumulative p95
        would never decay after one surge, so idle could never be
        detected and scale-down would never fire), breaker-open count,
        and any SLO fast-burn alert."""
        lb = self.lb
        if lb is None:
            return {}
        blocks = [lb.balancer_stats()]
        snaps = [lb.shard_snapshot()]
        if self.shards is not None:
            for s in self.shards.snapshots():
                snaps.append(s)
                if s.get("up") and s.get("stats"):
                    blocks.append(s["stats"])
        shed = 0.0
        for b in blocks:
            shed += int(b.get("shed_retries_total") or 0)
            shed += int(b.get("exhausted_total") or 0)
            q = b.get("qos")
            if q:
                shed += sum((q.get("shed_total") or {}).values())
        fast_burn = False
        deltas = []
        cur: Dict[Tuple, dict] = {}
        for s in snaps:
            serving = s.get("serving") or {}
            for path, ep in (serving.get("endpoints") or {}).items():
                hs = ep.get("hist")
                if not hs:
                    continue
                key = (s.get("shard"), path)
                cur[key] = hs
                d = _hist_window_delta(
                    self._autoscale_prev_hists.get(key), hs
                )
                if d is not None:
                    deltas.append(d)
            slo = serving.get("slo") or {}
            for ep in (slo.get("endpoints") or {}).values():
                if (ep.get("alerts") or {}).get("fast_burn"):
                    fast_burn = True
        self._autoscale_prev_hists = cur
        p95 = None
        if deltas:
            h = LatencyHistogram.merge(deltas)
            if h.n > 0:
                p95 = round(h.quantile(0.95) * 1e3, 3)
        breakers_open = sum(
            1 for b in lb.breakers
            if b.state() == ReplicaBreaker.OPEN
        )
        return {
            "shed_total": shed,
            "p95_ms": p95,
            "breakers_open": breakers_open,
            "fast_burn": fast_burn,
        }

    def _autoscale_live(self) -> List[int]:
        """Replicas currently serving traffic: up, and held by no
        owner (a parked spare or a mid-rollout replica is not live)."""
        out = []
        for s in self._slots:
            with self._mu:
                up = s.state == "up"
            if up and not self.holds.owners(s.index):
                out.append(s.index)
        return out

    def _autoscale_parked(self) -> List[int]:
        """Warm spares the autoscaler may readmit: up, breaker CLOSED
        (the prober vouches for them), and held by the autoscaler
        ALONE — a canary or rollout hold disqualifies a replica from
        being spare capacity."""
        out = []
        for s in self._slots:
            with self._mu:
                up = s.state == "up"
            if not up:
                continue
            if self.holds.owners(s.index) != frozenset(("autoscale",)):
                continue
            if self.lb.breakers[s.index].state() \
                    != ReplicaBreaker.CLOSED:
                continue
            out.append(s.index)
        return out

    def _on_generation(self, gen: str, gen_dir: str) -> None:
        """The coordinator promoted ``gen`` fleet-wide: relaunches boot
        from it from now on."""
        with self._mu:
            self._current_model_dir = gen_dir

    def _on_model_generation(self, model_id: str):
        """The callback of a per-model coordinator: a promoted generation
        moves that model's ``--add-model`` directory only."""
        def cb(gen: str, gen_dir: str) -> None:
            with self._mu:
                self.models[model_id] = gen_dir
        return cb

    def stop(self) -> None:
        self._stop.set()


def serve_fleet(
    model_dir: Optional[str],
    *,
    replicas: int = 2,
    host: str = "127.0.0.1",
    port: int = 8800,
    watch_dir: Optional[str] = None,
    replica_flags: Optional[List[str]] = None,
    log_dir: Optional[str] = None,
    ready_timeout: float = 900.0,
    port_file: Optional[str] = None,
    **supervisor_kwargs,
) -> int:
    """Launch ``replicas`` supervised serving processes of one model (or
    one publish directory) and front them with a breaker-aware
    :class:`LoadBalancer` in this process until shut down.

    Each replica binds an ephemeral port and signals readiness through its
    generation-stamped ``--port-file``, written after its whole warmup, so
    the balancer's first request never lands on a cold replica.
    ``replica_flags`` go to every ``cli serve`` as they are. Dead or hung
    replicas are relaunched by the :class:`FleetSupervisor`; with
    ``watch_dir`` a new generation is rolled out one replica at a time
    behind the shadow canary (``supervisor_kwargs``: ``canary``,
    ``max_restarts``, ``device``, the breaker and probe knobs, ...).
    Returns the exit code (0 on a clean shutdown)."""
    return FleetSupervisor(
        model_dir,
        replicas=replicas,
        host=host,
        port=port,
        watch_dir=watch_dir,
        replica_flags=replica_flags,
        log_dir=log_dir,
        ready_timeout=ready_timeout,
        port_file=port_file,
        **supervisor_kwargs,
    ).run()
