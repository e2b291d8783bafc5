"""The port's demand-driven fleet (glint_word2vec_torch/fleet.py) against
the JAX package's: QoS admission (tenant token buckets, the bulk class's
in-flight cap, deadline sheds before the forward), the warm-spare
autoscaler's transitions, the balancer's Retry-After path, the shard
snapshot folds (``merge_serving_snapshots``, ``_sum_balancer_stats``,
``_hist_window_delta``) and the shard-labelled exposition; the cases of
tests/test_fleet_scale.py but the hold ledger's, which tests/test_torch_fleet*
already hold.

Each scenario runs with the JAX package's classes and with the port's, on
the same inputs and one injected clock, and the two must observe the same
thing: decisions, transitions, statuses, headers and counters compare
exactly, and the rendered texts byte for byte. The shard processes (a
``fleet-shard`` process per shard, sharing the listen port) run with the
port alone, against in-process stub replicas: they serve, take the
supervisor's mirrored ops, stop on ``/_shard/stop``, are torn down by
``stop_all``, and a killed one is relaunched with the replica table as it
stands, holds included.
"""

import importlib
import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

PKGS = ("glint_word2vec_tpu", "glint_word2vec_torch")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _both(run):
    """``run(pkg)`` for each package; asserts the two observations equal
    and returns the port's."""
    got = {pkg: run(pkg) for pkg in PKGS}
    assert got[PKGS[0]] == got[PKGS[1]], got
    return got[PKGS[1]]


def _wait_for(pred, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


class _EchoReplica:
    """A stub replica: 200 to ``/healthz`` and every POST, with an optional
    switch that sheds the first N POSTs with a Retry-After."""

    def __init__(self, shed_first=0, retry_after="0.05"):
        self.requests = 0
        self.shed_first = shed_first
        self._mu = threading.Lock()
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, code, obj, extra=None):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    return self._send(200, {"status": "ok"})
                if self.path == "/metrics":
                    return self._send(200, {"endpoints": {}})
                self._send(404, {"error": "no route"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                with stub._mu:
                    stub.requests += 1
                    shed = stub.requests <= stub.shed_first
                if shed:
                    return self._send(429, {"error": "stub shedding"},
                                      extra={"Retry-After": retry_after})
                if self.path == "/shutdown":
                    return self._send(200, {"status": "bye"})
                return self._send(200, [[req.get("word", "?"), 0.9]])

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.port}"

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()


def _post(host, port, path, payload, headers=None):
    req = urllib.request.Request(
        f"http://{host}:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get(host, port, path):
    with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                timeout=30) as r:
        return r.status, json.loads(r.read())


# ----------------------------------------------------------------------
# Warm-spare autoscaler
# ----------------------------------------------------------------------


def _mk_autoscaler(fleet, led, sig, live, *, pinned=None, now, **cfg_kw):
    cfg = fleet.AutoscaleConfig(
        min_live=cfg_kw.pop("min_live", 2), max_live=cfg_kw.pop("max_live", 3),
        up_shed_per_sec=1.0, up_window_seconds=1.0, down_window_seconds=5.0,
        cooldown_seconds=2.0, **cfg_kw)
    return fleet.Autoscaler(
        holds=led, config=cfg, signals=lambda: dict(sig),
        parked=lambda: led.parked("autoscale"), live=lambda: list(live),
        pinned=pinned, now_fn=lambda: now[0])


def _ledger(fleet, calls=None):
    calls = [] if calls is None else calls
    return fleet.ReplicaHoldLedger(lambda i: calls.append(("hold", i)),
                                   lambda i: calls.append(("release", i)))


def _readmit_then_park(pkg):
    fleet = _mod(pkg, "fleet")
    calls = []
    led = _ledger(fleet, calls)
    led.acquire("autoscale", 2)
    live, now = [0, 1], [0.0]
    sig = {"shed_total": 0.0, "p95_ms": 10.0, "breakers_open": 0,
           "fast_burn": False}
    a = _mk_autoscaler(fleet, led, sig, live, now=now)
    out = [a.step()]  # the first step only primes the rate window
    sig["shed_total"], now[0] = 100.0, 1.0
    out.append(a.step())  # pressure must last the up-window
    sig["shed_total"], now[0] = 300.0, 2.5
    out.append(a.step())
    parked_after_up = led.parked("autoscale")
    live.append(2)
    for t in (3.0, 4.0, 6.0, 9.0):  # the shed rate is 0 from here on
        now[0] = t
        out.append(a.step())
    st = a.stats()
    return (out, parked_after_up, led.parked("autoscale"), calls,
            {k: st[k] for k in ("scale_ups_total", "scale_downs_total",
                                "steps_total", "live", "spares",
                                "last_shed_rate", "last_p95_ms")},
            st["transitions"])


def _pinned_by_rollout(pkg):
    fleet = _mod(pkg, "fleet")
    led = _ledger(fleet)
    led.acquire("autoscale", 2)
    now = [0.0]
    sig = {"shed_total": 0.0, "p95_ms": 10_000.0, "breakers_open": 3,
           "fast_burn": True}
    a = _mk_autoscaler(fleet, led, sig, [0, 1], pinned=lambda: True, now=now)
    out = []
    for t in (0.0, 1.0, 2.0, 3.0, 4.0):
        now[0] = t
        out.append(a.step())
    st = a.stats()
    return (out, st["pinned_skips_total"], st["scale_ups_total"],
            led.parked("autoscale"))


def _held_canary(pkg):
    fleet = _mod(pkg, "fleet")
    led = _ledger(fleet)
    led.acquire("autoscale", 2)
    led.acquire("rollout", 2)  # the spare is also the staged canary
    now = [0.0]
    sig = {"shed_total": 0.0, "p95_ms": 10_000.0, "breakers_open": 0,
           "fast_burn": False}
    a = _mk_autoscaler(fleet, led, sig, [0, 1], now=now)
    out = []
    for t in (0.0, 1.5, 3.0):
        now[0] = t
        out.append(a.step())  # pressure, but no eligible spare
    return out, a.stats()["scale_ups_total"], led.owners(2) == {"autoscale",
                                                                "rollout"}


def _min_max_bounds(pkg):
    fleet = _mod(pkg, "fleet")
    led = _ledger(fleet)
    now = [0.0]
    hot = {"shed_total": 0.0, "p95_ms": 10_000.0, "breakers_open": 0,
           "fast_burn": False}
    # At max_live with no spares: pressure cannot scale up.
    a = _mk_autoscaler(fleet, led, hot, [0, 1, 2], max_live=3, now=now)
    out = []
    for t in (0.0, 1.5, 3.0):
        now[0] = t
        out.append(a.step())
    # At min_live: calm cannot scale down.
    calm = {"shed_total": 0.0, "p95_ms": 1.0, "breakers_open": 0,
            "fast_burn": False}
    b = _mk_autoscaler(fleet, led, calm, [0, 1], min_live=2, now=now)
    for t in (10.0, 13.0, 17.0, 22.0):
        now[0] = t
        out.append(b.step())
    return out, led.parked("autoscale")


@pytest.mark.parametrize("scenario", ["readmit_then_park", "pinned_by_rollout",
                                      "held_canary", "min_max_bounds"])
def test_autoscaler_transitions_match(scenario):
    got = _both(globals()[f"_{scenario}"])
    if scenario == "readmit_then_park":
        out, parked_up, parked_end, calls, st, tr = got
        assert out[:3] == [None, None, "up"] and out[-1] == "down"
        assert parked_up == [] and parked_end == [2]
        assert calls == [("hold", 2), ("release", 2), ("hold", 2)]
        assert (st["scale_ups_total"], st["scale_downs_total"],
                st["steps_total"]) == (1, 1, 7)
        assert [t["dir"] for t in tr] == ["up", "down"]
    elif scenario == "pinned_by_rollout":
        assert got == ([None] * 5, 5, 0, [2])
    elif scenario == "held_canary":
        assert got == ([None] * 3, 0, True)
    else:
        assert got == ([None] * 7, [])


def test_autoscaler_step_fault_and_default_p95(monkeypatch):
    """An armed ``fleet.autoscale_step`` fault skips the evaluation and is
    counted; an unset ``up_p95_ms`` resolves to the SLO latency threshold."""
    monkeypatch.setenv("GLINT_SLO_LATENCY_MS", "120")

    def run(pkg):
        fleet, faults = _mod(pkg, "fleet"), _mod(pkg, "utils.faults")
        led = _ledger(fleet)
        a = fleet.Autoscaler(
            holds=led, config=fleet.AutoscaleConfig(min_live=1, max_live=2),
            signals=dict, parked=list, live=list, now_fn=lambda: 0.0)
        faults.arm("fleet.autoscale_step:exc@1")
        try:
            out = [a.step(), a.step()]
        finally:
            faults.disarm()
        st = a.stats()
        return out, a.config.up_p95_ms, st["step_faults_total"], st["steps_total"]

    assert _both(run) == ([None, None], 120.0, 1, 2)


# ----------------------------------------------------------------------
# QoS admission
# ----------------------------------------------------------------------


def _decisions(gate, seq, now):
    """(shed status, body, Retry-After, class, tenant, bulk slot) of each
    admission of ``seq`` ((t, path, headers) or "release")."""
    out, held = [], []
    for item in seq:
        if item == "release":
            gate.release(held.pop(0))
            out.append("released")
            continue
        now[0], path, headers = item
        d = gate.admit(path, headers)
        if d.bulk_slot:
            held.append(d)
        out.append((d.shed, d.cls, d.tenant, d.bulk_slot))
    return out, gate.snapshot()


QOS_CASES = {
    "tenant_bucket": (
        {"tenant_rate": 1.0, "tenant_burst": 2.0}, None,
        [(0.0, "/synonyms", {"x-glint-tenant": "job-a"})] * 3
        + [(0.0, "/synonyms", {"x-glint-tenant": "job-b"}),
           (1.1, "/synonyms", {"x-glint-tenant": "job-a"}),
           (1.2, "/synonyms", {"x-glint-tenant": "job-a"}),
           (1.2, "/synonyms", {})]),
    "bulk_cap": (
        {"bulk_max_inflight": 1}, None,
        [(0.0, "/synonyms", {"x-glint-priority": "bulk",
                             "x-glint-tenant": "bulk-job"}),
         (0.0, "/synonyms", {"x-glint-priority": "BULK",
                             "x-glint-tenant": "bulk-job"}),
         (0.0, "/synonyms", {}), "release",
         (0.0, "/synonyms", {"x-glint-priority": "bulk",
                             "x-glint-tenant": "bulk-job"})]),
    "deadline_p95": (
        {}, 80.0,
        [(0.0, "/synonyms", {"x-glint-deadline-ms": "20"}),
         (0.0, "/synonyms", {"x-glint-deadline-ms": "500"}),
         (0.0, "/synonyms", {"x-glint-deadline-ms": "junk"})]),
    "deadline_no_p95": (
        {}, None,
        [(0.0, "/synonyms", {"x-glint-deadline-ms": "5"}),
         (0.0, "/synonyms", {"x-glint-deadline-ms": "0"}),
         (0.0, "/synonyms", {"x-glint-deadline-ms": "-3"})]),
    "deadline_before_quota": (
        {"tenant_rate": 1.0, "tenant_burst": 1.0}, 50.0,
        [(0.0, "/synonyms", {"x-glint-tenant": "t", "x-glint-deadline-ms": "1"}),
         (0.0, "/synonyms", {"x-glint-tenant": "t"}),
         (0.0, "/synonyms", {"x-glint-tenant": "t"})]),
    "tenant_overflow": (
        {"tenant_rate": 5.0, "max_tenants": 2}, None,
        [(0.0, "/synonyms", {"x-glint-tenant": f"t{i}"}) for i in range(4)]
        + [(0.0, "/synonyms", {"x-glint-tenant": "t3"})] * 12),
}


@pytest.mark.parametrize("case", sorted(QOS_CASES))
def test_qos_gate_decisions_match(case):
    cfg, p95, seq = QOS_CASES[case]

    def run(pkg):
        fleet = _mod(pkg, "fleet")
        now = [0.0]
        gate = fleet.QosGate(fleet.QosConfig(**cfg), lambda path: p95,
                             now_fn=lambda: now[0])
        return _decisions(gate, seq, now)

    out, snap = _both(run)
    sheds = [o[0][2] if o[0] else None for o in out if o != "released"]
    if case == "tenant_bucket":
        # A burst of 2, job-b untouched by job-a's flood, one token a second.
        assert [o[0] is None for o in out] == [True, True, False, True, True,
                                               False, True]
        assert snap["per_tenant_shed_total"] == {"job-a": 2}
        assert out[2][0][1]["error"] == "tenant quota exceeded"
        assert sheds[2] == "1"
    elif case == "bulk_cap":
        # Interactive traffic is never gated by the bulk cap.
        assert snap["shed_total"]["bulk_inflight"] == 1
        assert snap["admitted_total"] == {"interactive": 1, "bulk": 2}
        assert snap["bulk_inflight_peak"] == 1 and snap["bulk_inflight"] == 1
    elif case == "deadline_p95":
        assert out[0][0][0] == 429 and out[0][0][1]["p95_ms"] == 80.0
        assert float(out[0][0][2]) > 0 and out[1][0] is None
        assert out[2][0] is None  # an unreadable budget is no budget
    elif case == "deadline_no_p95":
        assert [o[0] is None for o in out] == [True, False, False]
    elif case == "deadline_before_quota":
        # The deadline shed spends no token: the next request still has it.
        assert [o[0] and o[0][1]["error"] for o in out] == [
            "deadline infeasible", None, "tenant quota exceeded"]
    else:
        # t2 and t3 overflow into one "other" bucket of 10 tokens.
        assert snap["per_tenant_shed_total"] == {"other": 4}


def _qos_balancer(pkg, qos_kw, calls):
    fleet = _mod(pkg, "fleet")
    rep = _EchoReplica()
    lb = fleet.LoadBalancer([rep.url], port=0,
                            qos=fleet.QosConfig(**qos_kw))
    lb.start_background()
    try:
        return calls(lb, rep, fleet)
    finally:
        lb.stop()
        rep.stop()


def test_qos_admission_end_to_end_per_tenant_accounting():
    """Through the balancer: the flooding bulk tenant is the one shed,
    the interactive default bucket untouched, and the QoS block renders
    lint-clean."""
    def calls(lb, rep, fleet):
        bulk = {"X-Glint-Tenant": "bulk-job", "X-Glint-Priority": "bulk"}
        codes = [_post(lb.host, lb.port, "/synonyms", {"word": "w"},
                       headers=bulk)[:2] for _ in range(6)]
        codes = [(c, h.get("Retry-After")) for c, h in codes]
        codes += [_post(lb.host, lb.port, "/m/b/synonyms", {"word": "w"})[0]
                  for _ in range(2)]
        doc = _get(lb.host, lb.port, "/metrics")[1]
        prom = _mod(fleet.__name__.split(".")[0], "obs.prometheus")
        text = prom.fleet_to_prometheus(doc)
        prom.lint_prometheus_text(text)
        lines = sorted(ln for ln in text.splitlines()
                       if ln.startswith("glint_fleet_qos"))
        return codes, doc["balancer"]["qos"], lines, rep.requests

    codes, qos, lines, forwarded = _both(
        lambda pkg: _qos_balancer(pkg, {"tenant_rate": 2.0,
                                        "tenant_burst": 2.0}, calls))
    assert [c for c, *_ in codes[:6]] == [200, 200, 429, 429, 429, 429]
    assert codes[2][1] == "0.5" and codes[6:] == [200, 200]
    assert qos["per_tenant_shed_total"] == {"bulk-job": 4}
    assert qos["admitted_total"] == {"interactive": 2, "bulk": 2}
    assert 'glint_fleet_qos_tenant_shed_total{tenant="bulk-job"} 4' in lines
    assert forwarded == 4


def test_deadline_header_sheds_before_forward():
    """``X-Glint-Deadline-Ms: 0`` is shed by the balancer (429 with
    Retry-After), never forwarded to take a replica slot; the bulk class's
    slot is released after a forward."""
    def calls(lb, rep, fleet):
        code, headers, obj = _post(lb.host, lb.port, "/synonyms",
                                   {"word": "w"},
                                   headers={"X-Glint-Deadline-Ms": "0"})
        bulk = [_post(lb.host, lb.port, "/synonyms", {"word": "w"},
                      headers={"X-Glint-Priority": "bulk"})[0]
                for _ in range(3)]
        qos = _get(lb.host, lb.port, "/metrics")[1]["balancer"]["qos"]
        return (code, headers.get("Retry-After"), obj, rep.requests, bulk,
                qos["shed_total"], qos["bulk_inflight"])

    got = _both(lambda pkg: _qos_balancer(pkg, {"bulk_max_inflight": 1}, calls))
    code, retry, obj, forwarded, bulk, shed, inflight = got
    assert (code, retry, obj["error"]) == (429, "1", "deadline infeasible")
    assert forwarded == 3 and bulk == [200, 200, 200]
    assert shed == {"tenant_quota": 0, "bulk_inflight": 0, "deadline": 1}
    assert inflight == 0


# ----------------------------------------------------------------------
# Retry-After on the balancer's retry path
# ----------------------------------------------------------------------


@pytest.mark.parametrize("retry_after,honored", [("0.05", True), ("7", False)])
def test_retry_after_when_every_replica_sheds(retry_after, honored):
    """Every replica sheds: a small Retry-After is waited out once and the
    next pass succeeds (``retry_after_honored_total``); one past the cap is
    the client's to pay, relayed at once with its header."""
    def run(pkg):
        fleet = _mod(pkg, "fleet")
        rep = _EchoReplica(shed_first=1 if honored else 1000,
                           retry_after=retry_after)
        lb = fleet.LoadBalancer([rep.url], port=0)
        lb.start_background()
        try:
            t0 = time.monotonic()
            code, headers, out = _post(lb.host, lb.port, "/synonyms",
                                       {"word": "w"})
            took = time.monotonic() - t0
            bal = _get(lb.host, lb.port, "/metrics")[1]["balancer"]
            return (code, headers.get("Retry-After"), out,
                    took >= 0.05 if honored else took < 5.0,
                    bal["retry_after_honored_total"], bal["exhausted_total"])
        finally:
            lb.stop()
            rep.stop()

    got = _both(run)
    if honored:
        assert got == (200, None, [["w", 0.9]], True, 1, 0)
    else:
        assert got == (429, "7", {"error": "stub shedding"}, True, 0, 1)


# ----------------------------------------------------------------------
# Shard snapshots and their folds
# ----------------------------------------------------------------------


def _observed(pkg, samples):
    m = _mod(pkg, "fleet")._BalancerMetrics()
    for path, seconds, status in samples:
        m.observe(path, seconds, status)
    return m


def test_merge_shard_snapshots_exact():
    """Shard snapshots merge as replicas' do: counts sum, the histogram
    merge equals one histogram fed the whole population, and the SLO window
    counts sum before the burn rates are derived again."""
    shard_a = [("/synonyms", 0.010 * (i + 1), 200) for i in range(40)]
    shard_b = [("/synonyms", 0.005 * (i + 1), 200) for i in range(60)]
    shard_b += [("/synonyms", 0.5, 503) for _ in range(5)]

    def run(pkg):
        snaps = [_observed(pkg, s).snapshot() for s in (shard_a, shard_b)]
        merged = _mod(pkg, "obs.aggregate").merge_serving_snapshots(snaps)
        truth = _mod(pkg, "utils.metrics").LatencyHistogram()
        for _, seconds, _ in shard_a + shard_b:
            truth.record(seconds)
        ep = merged["endpoints"]["/synonyms"]
        hist, want = dict(ep["hist"]), truth.state()
        total = hist.pop("total"), want.pop("total")
        slo = merged["slo"]["endpoints"]["/synonyms"]
        return (ep["count"], ep["errors"], "approx" in ep, hist == want,
                abs(total[0] - total[1]) <= 1e-12 * total[1],
                ep["p95_ms"] == round(truth.quantile(0.95) * 1e3, 3),
                slo["windows"]["5m"]["total"],
                slo["windows"]["5m"]["bad_availability"], sorted(slo["alerts"]))

    assert _both(run) == (105, 5, False, True, True, True, 105, 5,
                          ["fast_burn", "slow_burn"])


def test_shard_labeled_exposition_lints():
    def run(pkg):
        snap = _observed(pkg, [("/synonyms", 0.02, 200)] * 8
                         + [("/analogy", 0.1, 500)]).snapshot()
        stats = {"proxied_total": 9, "shed_retries_total": 1,
                 "exhausted_total": 0, "proxy_errors_total": 0,
                 "breaker_skips_total": 0, "restart_retries_total": 0,
                 "retry_after_honored_total": 0}
        shard0 = {"shard": 0, "up": True, "serving": snap, "stats": stats}
        shard1 = {"shard": 1, "up": False, "error": "connection refused"}
        doc = {"replicas": [],
               "balancer": _mod(pkg, "fleet")._sum_balancer_stats([stats]),
               "balancer_shards": [shard0, shard1],
               "data_plane": {"balancer_procs": 2, "reuse_port": True},
               "autoscale": {"enabled": True, "live": 1, "spares": 1,
                             "min_live": 1, "max_live": 2,
                             "scale_ups_total": 1, "scale_downs_total": 0,
                             "pinned_skips_total": 0, "steps_total": 9,
                             "step_faults_total": 0, "last_shed_rate": 2.5,
                             "last_p95_ms": None, "transitions": []}}
        prom = _mod(pkg, "obs.prometheus")
        text = prom.fleet_to_prometheus(doc)
        prom.lint_prometheus_text(text)
        return text

    text = _both(run)
    assert 'glint_fleet_shard_up{shard="0"} 1' in text
    assert 'glint_fleet_shard_up{shard="1"} 0' in text
    assert 'glint_fleet_shard_proxied_total{shard="0"} 9' in text
    assert ('glint_fleet_shard_requests_total'
            '{shard="0",endpoint="/synonyms"} 8') in text
    assert "glint_fleet_balancer_procs 2" in text
    assert "glint_fleet_autoscale_ups_total 1" in text


def test_hist_window_delta_isolates_recent_traffic():
    """The autoscaler's p95 is windowed: a cumulative p95 never decays
    after a surge, so calm could never be seen and nothing would park."""
    def run(pkg):
        delta = _mod(pkg, "fleet")._hist_window_delta
        H = _mod(pkg, "utils.metrics").LatencyHistogram
        slow = H()
        for _ in range(100):
            slow.record(1.0)
        surged = slow.state()
        after = H.from_state(surged)
        for _ in range(50):
            after.record(0.001)
        window = delta(surged, after.state())
        return (window.n, window.state(), window.quantile(0.95) < 0.1,
                after.quantile(0.95) > 0.5, delta(None, surged).n,
                delta(after.state(), surged).n)

    got = _both(run)
    assert (got[0], got[2:]) == (50, (True, True, 100, 100))


def test_sum_balancer_stats_folds_qos():
    a = {"proxied_total": 10, "shed_retries_total": 2, "exhausted_total": 1,
         "proxy_errors_total": 0, "breaker_skips_total": 3,
         "restart_retries_total": 0, "retry_after_honored_total": 1,
         "qos": {"admitted_total": {"interactive": 8, "bulk": 2},
                 "shed_total": {"tenant_quota": 1, "bulk_inflight": 0,
                                "deadline": 0},
                 "per_tenant_shed_total": {"job-a": 1},
                 "bulk_inflight": 1, "bulk_inflight_peak": 2}}
    b = {"proxied_total": 5, "shed_retries_total": 0, "exhausted_total": 0,
         "proxy_errors_total": 2, "breaker_skips_total": 0,
         "restart_retries_total": 1, "retry_after_honored_total": 0,
         "qos": {"admitted_total": {"interactive": 5},
                 "shed_total": {"tenant_quota": 0, "bulk_inflight": 2,
                                "deadline": 1},
                 "per_tenant_shed_total": {"job-a": 2, "job-b": 1},
                 "bulk_inflight": 0, "bulk_inflight_peak": 3}}
    out = _both(lambda pkg: _mod(pkg, "fleet")._sum_balancer_stats(
        [a, b, None, {"proxied_total": 1}]))
    assert out["proxied_total"] == 16
    assert out["qos"]["admitted_total"] == {"interactive": 13, "bulk": 2}
    assert out["qos"]["per_tenant_shed_total"] == {"job-a": 3, "job-b": 1}
    assert (out["qos"]["bulk_inflight"], out["qos"]["bulk_inflight_peak"]) \
        == (1, 3)


def test_apply_control_ops_match():
    """A shard applies the supervisor's mirrored ops to its own address
    table and breakers; the same ops leave both packages' shard snapshots
    alike, and a bad op is refused."""
    ops = [{"op": "hold", "i": 0}, {"op": "hold", "i": 0},
           {"op": "release", "i": 0}, {"op": "force_open", "i": 1},
           {"op": "set_restarting", "i": 1, "flag": True},
           {"op": "set_address", "i": 1, "host": "127.0.0.1", "port": 9,
            "generation": "0.1"},
           {"op": "trial", "i": 1}, {"op": "clear_holds", "i": 0}]

    def run(pkg):
        fleet = _mod(pkg, "fleet")
        lb = fleet.LoadBalancer(["http://127.0.0.1:7", "http://127.0.0.1:8"],
                                port=0, shard_id=3)
        try:
            out = [lb.apply_control(op) for op in ops]
            errs = []
            for bad in ({"op": "explode", "i": 0}, {"op": "hold", "i": 5}):
                with pytest.raises((ValueError, IndexError)) as e:
                    lb.apply_control(bad)
                errs.append(type(e.value).__name__)
            snap = lb.shard_snapshot()
            for b in snap["breakers"]:
                b.pop("failing_seconds")
            snap["serving"].pop("slo")
            return out, errs, snap, lb.replicas, lb.is_restarting(1), \
                lb.control_addr
        finally:
            lb.stop()

    out, errs, snap, replicas, restarting, ctrl = _both(run)
    assert errs == ["ValueError", "IndexError"] and ctrl is None
    assert snap["shard"] == 3 and replicas[1] == ("127.0.0.1", 9)
    assert snap["breakers"][1]["state"] == "half_open" and restarting


# ----------------------------------------------------------------------
# Shard processes (the port's own, against stub replicas)
# ----------------------------------------------------------------------


@pytest.fixture
def shard_env(monkeypatch):
    """Shard processes import the port from this checkout, on one thread."""
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _specs(reps, held=0):
    return [{"host": "127.0.0.1", "port": r.port, "generation": None,
             "held": held if i == 0 else 0} for i, r in enumerate(reps)]


def test_shard_processes_serve_and_tear_down(shard_env):
    """Two shard processes share the parent's port, answer traffic,
    relay /metrics to the supervisor's balancer, take mirrored ops, and are
    all torn down by stop_all: serve-fleet leaves no balancer behind."""
    from glint_word2vec_torch.fleet import BalancerShardManager, LoadBalancer

    reps = [_EchoReplica(), _EchoReplica()]
    lb = LoadBalancer([r.url for r in reps], port=0, reuse_port=True,
                      control=True)
    lb.start_background()
    mgr = BalancerShardManager(lb, 2, replica_specs=_specs(reps))
    try:
        mgr.start()
        assert len(mgr.handles) == 2
        assert all(h.proc.poll() is None for h in mgr.handles)
        # Fresh connections on the shared port, whichever shard accepts.
        for i in range(8):
            assert _post(lb.host, lb.port, "/synonyms",
                         {"word": f"w{i}"})[0] == 200
        snaps = mgr.snapshots()
        assert [s["shard"] for s in snaps] == [1, 2]
        assert all(s["up"] and "stats" in s and "serving" in s for s in snaps)
        proxied = lb.balancer_stats()["proxied_total"] + sum(
            s["stats"]["proxied_total"] for s in snaps)
        assert proxied == 8
        mgr.broadcast({"op": "hold", "i": 0})
        assert all(s["breakers"][0]["held"] for s in mgr.snapshots())
        # A shard's /metrics is the supervisor balancer's document.
        status, snap = mgr.handles[0]._request("GET", "/_shard/snapshot")
        assert status == 200 and snap["shard"] == 1
        status, doc = mgr.handles[0]._request("GET", "/metrics")
        assert status == 200 and "replicas" in doc
    finally:
        mgr.stop_all()
        lb.stop()
        for r in reps:
            r.stop()
    assert all(h.proc.poll() is not None for h in mgr.handles), \
        "a balancer shard process was left running"


def test_shard_stop_route_exits_cleanly(shard_env):
    """``POST /_shard/stop`` ends one shard although it accepts on a shared
    port (its accept loop re-checks the stop flag on a timeout)."""
    from glint_word2vec_torch.fleet import BalancerShardManager, LoadBalancer

    rep = _EchoReplica()
    lb = LoadBalancer([rep.url], port=0, reuse_port=True, control=True)
    lb.start_background()
    mgr = BalancerShardManager(lb, 1, replica_specs=_specs([rep]))
    try:
        mgr.start()
        h = mgr.handles[0]
        assert h.request_stop()
        _wait_for(lambda: h.proc.poll() is not None, timeout=15,
                  msg="shard exit after /_shard/stop")
        assert h.proc.returncode == 0
    finally:
        mgr.stop_all()
        lb.stop()
        rep.stop()


def test_dead_shard_is_relaunched_with_the_holds(shard_env):
    """A SIGKILLed shard is relaunched from the replica table as it stands
    (a parked spare stays held there) and gets the ops sent while it
    started; the relaunch is recorded."""
    from glint_word2vec_torch.fleet import (
        BalancerShardManager,
        LoadBalancer,
        ReplicaHoldLedger,
        _FleetDataPlane,
    )

    reps = [_EchoReplica(), _EchoReplica()]
    lb = LoadBalancer([r.url for r in reps], port=0, reuse_port=True,
                      control=True)
    lb.start_background()
    dp = _FleetDataPlane(lb)
    holds = ReplicaHoldLedger(dp.hold, dp.release, dp.clear_holds)
    holds.acquire("autoscale", 1)
    mgr = BalancerShardManager(lb, 1, replica_specs=dp.replica_specs())
    try:
        mgr.start()
        dp.shards = mgr
        h = mgr.handles[0]
        assert h.snapshot()["breakers"][1]["held"]
        old = h.proc
        os.kill(old.pid, signal.SIGKILL)
        old.wait(timeout=10)
        dp.poll_shards()  # detects the death and starts the relaunch
        assert mgr._pending and h.proc is old
        holds.acquire("rollout", 0)  # sent while the shard starts
        _wait_for(lambda: (dp.poll_shards(), not mgr._pending)[1],
                  timeout=60, msg="shard relaunched")
        assert h.proc is not old and h.proc.poll() is None
        brk = h.snapshot()["breakers"]
        assert brk[0]["held"] and brk[1]["held"]
        holds.release("autoscale", 1)
        assert not h.snapshot()["breakers"][1]["held"]
        (rec,) = mgr.relaunches
        assert rec["shard"] == 1 and rec["reason"] == "killed by signal 9"
        assert rec["detect_to_ready_seconds"] > 0
        for i in range(6):
            assert _post(lb.host, lb.port, "/synonyms",
                         {"word": f"w{i}"})[0] == 200
    finally:
        mgr.stop_all()
        lb.stop()
        for r in reps:
            r.stop()
    assert all(p.poll() is not None for p in mgr._procs)


def test_shard_that_cannot_come_back_stops_the_fleet(shard_env):
    """A relaunch whose every launch dies before binding is given up after
    ``RELAUNCH_ATTEMPTS``: the sweep raises, so the fleet stops (non-zero)
    instead of running on with fewer shards."""
    import subprocess
    import sys

    from glint_word2vec_torch.fleet import (
        BalancerShardManager,
        LoadBalancer,
        _FleetDataPlane,
    )

    rep = _EchoReplica()
    lb = LoadBalancer([rep.url], port=0, reuse_port=True, control=True)
    lb.start_background()
    dp = _FleetDataPlane(lb)
    mgr = BalancerShardManager(lb, 1, replica_specs=dp.replica_specs())
    try:
        mgr.start()
        dp.shards = mgr
        launches = []

        def doomed(shard_id, specs, launch):
            launches.append(launch)
            proc = subprocess.Popen([sys.executable, "-c", "raise SystemExit(3)"])
            return proc, os.path.join(mgr._tmp, f"never-{launch}.port")

        mgr._spawn = doomed
        os.kill(mgr.handles[0].proc.pid, signal.SIGKILL)
        mgr.handles[0].proc.wait(timeout=10)
        with pytest.raises(RuntimeError, match="died before binding 3 times"):
            for _ in range(500):
                dp.poll_shards()
                time.sleep(0.02)
        assert launches == [1, 2, 3] and mgr.relaunches == []
    finally:
        mgr.stop_all()
        lb.stop()
        rep.stop()
