"""The port's replica fleet (glint_word2vec_torch/fleet.py) against the JAX
package's: the breaker's state machine, the balancer over port servers
(round robin, a shed retried on the next replica, backpressure relayed when
every replica sheds, a dead replica, the shutdown fan-out; the cases of
tests/test_fleet.py), the merged exposition (``merge_serving_snapshots``
and ``fleet_to_prometheus``), the fleet supervisor over a stub replica
script (a relaunch after a kill, first-launch-only chaos environment), and
the snapshot watcher's transient-error backoff (tests/test_fleet_selfheal.py).

Each scenario runs with the JAX package's class and with the port's, on the
same inputs, and the two must observe the same thing: states, statuses,
headers and counters compare exactly, and the rendered texts byte for byte.
The port's ``/metrics`` carries ``kernel_launches`` blocks the JAX server
does not have; they are dropped before a comparison.
"""

import importlib
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_torch.convert import model_from_arrays
from glint_word2vec_torch.obs.prometheus import lint_prometheus_text
from glint_word2vec_torch.serving import ModelServer
from glint_word2vec_torch.utils.params import Word2VecParams

PKGS = ("glint_word2vec_tpu", "glint_word2vec_torch")
V, D = 256, 16


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


# ----------------------------------------------------------------------
# ReplicaBreaker
# ----------------------------------------------------------------------

BREAKER_SEQUENCES = {
    "open_halfopen_close": "f f s f f f h sleep h f sleep h s s",
    "hold_regardless_of_state": "hold f f f release sleep h s s hold release",
    "force_open_then_trial": "force force trial s s f f f force trial f",
    "probe_counters_and_clear": "pf ps pf pf pf hold hold clear sleep h ps ps",
}


def _breaker_trace(pkg, seq):
    b = _mod(pkg, "fleet").ReplicaBreaker(fail_threshold=3,
                                          success_threshold=2,
                                          open_seconds=0.05)
    ops = {
        "f": b.record_failure, "s": b.record_success,
        "pf": lambda: b.record_failure(probe=True),
        "ps": lambda: b.record_success(probe=True),
        "h": b.maybe_half_open, "force": b.force_open, "trial": b.trial,
        "hold": b.hold, "release": b.release, "clear": b.clear_holds,
        "sleep": lambda: time.sleep(0.06),
    }
    trace = []
    for op in seq.split():
        ret = ops[op]()
        snap = b.snapshot()
        snap.pop("failing_seconds")
        trace.append((op, ret, b.state(), b.eligible(), b.held(),
                      b.failing_for() > 0, snap))
    return trace


@pytest.mark.parametrize("name", sorted(BREAKER_SEQUENCES))
def test_breaker_state_trace_matches(name):
    _both(lambda pkg: _breaker_trace(pkg, BREAKER_SEQUENCES[name]))


# ----------------------------------------------------------------------
# LoadBalancer over port servers
# ----------------------------------------------------------------------


def _make_server():
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((V, D)).astype(np.float32)
    model = model_from_arrays([f"w{i}" for i in range(V)], pts,
                              np.zeros_like(pts),
                              np.arange(V, 0, -1, dtype=np.int64) + 4,
                              Word2VecParams(vector_size=D), device="cpu")
    server = ModelServer(model, port=0, warmup=False)
    server.start_background()
    return server, model


class _Always429Handler(BaseHTTPRequestHandler):
    """A replica that sheds everything, with ``Retry-After: 7``."""

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        pass

    def _shed(self):
        body = json.dumps({"error": "stub overloaded"}).encode()
        self.send_response(429)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Retry-After", "7")
        self.end_headers()
        self.wfile.write(body)

    do_GET = do_POST = _shed


@pytest.fixture()
def shed_stub():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Always429Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://{httpd.server_address[0]}:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def _post(host, port, path, payload, headers=None):
    req = urllib.request.Request(
        f"http://{host}:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get(host, port, path):
    with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=30) as r:
        return r.status, r.read()


def _drop_launches(doc):
    """A port metrics document without its ``kernel_launches`` and
    ``kernel_launches_warmup`` blocks."""
    if isinstance(doc, dict):
        return {k: _drop_launches(v) for k, v in doc.items()
                if not k.startswith("kernel_launches")}
    if isinstance(doc, list):
        return [_drop_launches(v) for v in doc]
    return doc


def _scenario_round_robin(pkg, urls):
    lb = _mod(pkg, "fleet").LoadBalancer(urls, port=0)
    lb.start_background()
    try:
        codes = [_post(lb.host, lb.port, "/synonyms",
                       {"word": f"w{i}", "num": 3})[0] for i in range(12)]
        # The model prefix is forwarded whole; the balancer's histograms
        # count it under the endpoint.
        codes.append(_post(lb.host, lb.port, "/m/default/synonyms",
                           {"word": "w1", "num": 3})[0])
        _, body = _get(lb.host, lb.port, "/metrics")
        doc = json.loads(body)
        _, text = _get(lb.host, lb.port, "/metrics?format=prometheus")
        text = text.decode()
        lint_prometheus_text(text)
        code, body = _get(lb.host, lb.port, "/healthz")
        missing = _post(lb.host, lb.port, "/synonyms",
                        {"word": "missing", "num": 3})[0]
        return (codes, sorted(r["proxied_total"] for r in doc["replicas"]),
                [r["up"] for r in doc["replicas"]], doc["fleet"]["replicas"],
                doc["fleet"]["endpoints"]["/synonyms"]["count"],
                doc["balancer"], "glint_fleet_replicas 2" in text,
                "glint_serving_requests_total" in text, code,
                json.loads(body)["replicas_up"], missing,
                sorted(lb.metrics.snapshot()["endpoints"]))
    finally:
        lb.stop()


def _scenario_shed_retry(pkg, urls):
    lb = _mod(pkg, "fleet").LoadBalancer(urls, port=0)
    lb.start_background()
    try:
        codes = [_post(lb.host, lb.port, "/synonyms",
                       {"word": f"w{i}", "num": 2})[0] for i in range(8)]
        bal = json.loads(_get(lb.host, lb.port, "/metrics")[1])["balancer"]
        return codes, bal["shed_retries_total"], bal["exhausted_total"]
    finally:
        lb.stop()


def _scenario_all_shed(pkg, urls):
    lb = _mod(pkg, "fleet").LoadBalancer(urls, port=0)
    lb.start_background()
    try:
        code, headers, _ = _post(lb.host, lb.port, "/synonyms",
                                 {"word": "w0", "num": 2})
        bal = json.loads(_get(lb.host, lb.port, "/metrics")[1])["balancer"]
        return code, headers.get("Retry-After"), bal["exhausted_total"]
    finally:
        lb.stop()


def _scenario_dead_replica(pkg, urls):
    lb = _mod(pkg, "fleet").LoadBalancer(urls, port=0)
    lb.start_background()
    try:
        codes = [_post(lb.host, lb.port, "/synonyms",
                       {"word": f"w{i}", "num": 2})[0] for i in range(6)]
        code, body = _get(lb.host, lb.port, "/healthz")
        h = json.loads(body)
        doc = json.loads(_get(lb.host, lb.port, "/metrics")[1])
        _, text = _get(lb.host, lb.port, "/metrics?format=prometheus")
        lint_prometheus_text(text.decode())
        return (codes, code, h["status"], h["replicas_up"],
                {r["url"]: r["up"] for r in doc["replicas"]})
    finally:
        lb.stop()


@pytest.mark.parametrize("scenario", ["round_robin", "shed_retry", "all_shed",
                                      "dead_replica"])
def test_balancer_matches(scenario, shed_stub):
    fn = globals()[f"_scenario_{scenario}"]

    def run(pkg):
        # Fresh replicas a package: their counters are part of the answer.
        servers = [_make_server() for _ in range(2)]
        try:
            u1, u2 = (f"http://{s.host}:{s.port}" for s, _ in servers)
            urls = {"round_robin": [u1, u2], "shed_retry": [shed_stub, u1],
                    "all_shed": [shed_stub],
                    "dead_replica": [u1, "http://127.0.0.1:9"]}[scenario]
            out = fn(pkg, urls)
            if scenario == "dead_replica":  # the live replica's own url
                out = out[:-1] + (sorted(out[-1].values()),)
            return out
        finally:
            for s, m in servers:
                s.stop()
                m.stop()

    got = _both(run)
    # What tests/test_fleet.py asserts, on the port's run.
    if scenario == "round_robin":
        assert got[1] == [6, 7] and got[3] == 2 and got[4] == 13
        assert got[6] and got[7] and got[9] == 2 and got[10] == 404
    elif scenario == "shed_retry":
        assert set(got[0]) == {200} and got[1] >= 4 and got[2] == 0
    elif scenario == "all_shed":
        assert got == (429, "7", 1)
    else:
        assert set(got[0]) == {200} and got[1:4] == (200, "degraded", 1)
        assert got[4] == [False, True]


@pytest.mark.parametrize("pkg", PKGS)
def test_shutdown_fans_out(pkg):
    s1, m1 = _make_server()
    s2, m2 = _make_server()
    lb = _mod(pkg, "fleet").LoadBalancer(
        [f"http://{s.host}:{s.port}" for s in (s1, s2)], port=0)
    lb.start_background()
    try:
        code, _, out = _post(lb.host, lb.port, "/shutdown", {})
        assert code == 200
        assert all(r.get("status") == 200 for r in out["replicas"]), out
        lb._thread.join(timeout=10)
        assert not lb._thread.is_alive(), "balancer accept loop hung"
        for s in (s1, s2):
            s._thread.join(timeout=10)
            assert not s._thread.is_alive(), "replica did not stop"
    finally:
        for m in (m1, m2):
            m.stop()


# ----------------------------------------------------------------------
# The merged exposition
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def fleet_doc():
    """A balancer document over two port replicas that served traffic on a
    default and a catalog model, one of them with an eviction."""
    from glint_word2vec_torch.fleet import LoadBalancer

    servers = [_make_server() for _ in range(2)]
    for s, m in servers:
        s.add_model("b", model=m, warmup=False)
    lb = LoadBalancer([f"http://{s.host}:{s.port}" for s, _ in servers], port=0)
    lb.start_background()
    try:
        for i in range(8):
            _post(lb.host, lb.port, "/synonyms", {"word": f"w{i}", "num": 5})
            _post(lb.host, lb.port, "/m/b/analogy",
                  {"positive": ["w1", "w2"], "negative": ["w3"], "num": 5})
        _post(lb.host, lb.port, "/vector", {"word": "nope"})
        doc = lb.metrics_doc()
        doc["supervisor"] = {
            "restarts_total": 1, "replicas_failed": 0, "max_restarts": 3,
            "replica_states": [{"replica": 0, "state": "up", "restarts": 1},
                               {"replica": 1, "state": "backoff",
                                "restarts": 0}]}
        doc["rollout"] = {
            "rollouts_started_total": 2, "rollouts_completed_total": 1,
            "in_progress": False, "generation": "gen-000002",
            "canary": {"evaluations_total": 2, "holdbacks_total": 1,
                       "last_agreement": 0.1, "agreement_gate": 0.6,
                       "last_scored": 9}}
        yield doc
    finally:
        lb.stop()
        for s, m in servers:
            s.stop()
            m.stop()


def test_merge_serving_snapshots_matches(fleet_doc):
    from glint_word2vec_tpu.obs.aggregate import merge_serving_snapshots as jm

    from glint_word2vec_torch.obs.aggregate import merge_serving_snapshots

    snaps = [r["snapshot"] for r in fleet_doc["replicas"]]
    for inputs in (snaps, snaps[:1], [snaps[0], snaps[0]], []):
        got = merge_serving_snapshots(inputs)
        want = jm(_drop_launches(inputs))
        assert _drop_launches(got) == want
    merged = merge_serving_snapshots(snaps)
    # Folded per model and for the catalog; launch counts summed.
    assert merged["models"]["b"]["resident_replicas"] == 2
    assert merged["catalog"]["replicas"] == 2
    assert merged["kernel_launches"] == {
        k: sum(s["kernel_launches"][k] for s in snaps)
        for k in snaps[0]["kernel_launches"]}


def test_fleet_to_prometheus_matches(fleet_doc):
    from glint_word2vec_tpu.obs.prometheus import fleet_to_prometheus as jf

    from glint_word2vec_torch.obs.prometheus import fleet_to_prometheus

    doc = _drop_launches(fleet_doc)
    text = fleet_to_prometheus(doc)
    assert text == jf(doc)
    lint_prometheus_text(text)
    for family in ("glint_fleet_replicas 2", "glint_fleet_restarts_total 1",
                   "glint_fleet_canary_holdbacks_total 1",
                   'glint_fleet_generation_info{generation="gen-000002"} 1'):
        assert family in text


# ----------------------------------------------------------------------
# FleetSupervisor over a stub replica script
# ----------------------------------------------------------------------

_REPLICA_STUB = r"""
import json, os, sys, threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

port_file = sys.argv[1]
gen = os.environ.get("GLINT_FLEET_GEN")
crash_after = float(os.environ.get("STUB_CRASH_AFTER", "0"))


class H(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _send(self, code, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            return self._send(200, {"status": "ok", "fleet_generation": gen,
                                    "post_warmup_compiles": 0})
        if self.path == "/metrics":
            return self._send(200, {"endpoints": {},
                                    "hot_swap": {"generation": None},
                                    "compiles": {"post_warmup": 0}})
        self._send(404, {})

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        self.rfile.read(n)
        if self.path == "/synonyms":
            return self._send(200, [["w", 0.5]])
        if self.path == "/shutdown":
            self._send(200, {"status": "bye"})
            threading.Thread(target=httpd.shutdown, daemon=True).start()
            return
        self._send(404, {})


httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
tmp = port_file + ".tmp"
with open(tmp, "w") as f:
    json.dump({"host": "127.0.0.1", "port": httpd.server_address[1],
               "fleet_generation": gen}, f)
os.replace(tmp, port_file)
if crash_after:
    def die():
        import time
        time.sleep(crash_after)
        os._exit(3)
    threading.Thread(target=die, daemon=True).start()
httpd.serve_forever()
"""


@pytest.fixture()
def stub_script(tmp_path):
    path = tmp_path / "stub_replica.py"
    path.write_text(_REPLICA_STUB)
    return str(path)


def _fast_supervisor(pkg, stub_script, **kw):
    kw.setdefault("replicas", 2)
    kw.setdefault("port", 0)
    kw.setdefault("poll_interval", 0.05)
    kw.setdefault("backoff_base_seconds", 0.1)
    kw.setdefault("backoff_cap_seconds", 0.5)
    kw.setdefault("probe_interval", 0.05)
    kw.setdefault("probe_timeout", 0.5)
    kw.setdefault("breaker_failures", 2)
    kw.setdefault("breaker_successes", 1)
    kw.setdefault("breaker_open_seconds", 0.2)
    kw.setdefault("ready_timeout", 30.0)
    kw.setdefault("kill_grace_seconds", 1.0)
    return _mod(pkg, "fleet").FleetSupervisor(
        None, build_replica_argv=lambda i, pf: [sys.executable, stub_script, pf],
        **kw)


def _restart_dead_replica(pkg, stub_script):
    sup = _fast_supervisor(pkg, stub_script, max_restarts=3)
    runner = threading.Thread(target=sup.run, daemon=True)
    runner.start()
    try:
        assert sup.ready.wait(30), "fleet never came up"
        lb = sup.lb
        first = _post(lb.host, lb.port, "/synonyms", {"word": "w", "num": 2})[0]
        old_pid = sup._slots[0].proc.pid
        os.kill(old_pid, 9)
        _wait_for(lambda: sup._slots[0].state == "up"
                  and sup._slots[0].restarts == 1
                  and sup._slots[0].proc.pid != old_pid,
                  timeout=20, msg="replica relaunch")
        _wait_for(lambda: lb.breakers[0].state() == "closed", timeout=10,
                  msg="relaunched replica readmitted")
        codes = [_post(lb.host, lb.port, "/synonyms",
                       {"word": f"w{i}", "num": 2})[0] for i in range(4)]
        doc = sup.report()
        recs = doc["supervisor"]["replica_states"][0]["restart_records"]
        _, text = _get(lb.host, lb.port, "/metrics?format=prometheus")
        text = text.decode()
        lint_prometheus_text(text)
        return (first, codes, doc["supervisor"]["restarts_total"],
                doc["supervisor"]["replicas_failed"],
                bool(recs) and recs[-1]["detect_to_ready_seconds"] is not None,
                recs[-1]["reason"], sup._slots[0].launch_generation,
                "glint_fleet_restarts_total 1" in text)
    finally:
        sup.stop()
        runner.join(timeout=15)
        assert not runner.is_alive(), "supervisor loop hung"


def _first_launch_env(pkg, stub_script):
    sup = _fast_supervisor(pkg, stub_script, max_restarts=1,
                           replica_env_first_launch={0: {"STUB_CRASH_AFTER": "0.3"}})
    runner = threading.Thread(target=sup.run, daemon=True)
    runner.start()
    try:
        assert sup.ready.wait(30)
        _wait_for(lambda: sup._slots[0].state == "up"
                  and sup._slots[0].restarts == 1,
                  timeout=20, msg="one restart after the first-launch crash")
        time.sleep(0.6)  # it would crash again were the env armed again
        return (sup._slots[0].state, sup._slots[0].restarts,
                _post(sup.lb.host, sup.lb.port, "/synonyms",
                      {"word": "w", "num": 2})[0])
    finally:
        sup.stop()
        runner.join(timeout=15)


@pytest.mark.parametrize("scenario", ["restart_dead_replica", "first_launch_env"])
def test_fleet_supervisor_matches(scenario, stub_script):
    fn = globals()[f"_{scenario}"]
    got = _both(lambda pkg: fn(pkg, stub_script))
    if scenario == "restart_dead_replica":
        assert got == (200, [200] * 4, 1, 0, True, "killed by signal 9", 1, True)
    else:
        assert got == ("up", 1, 200)


def test_fleet_supervisor_refuses_the_demand_driven_knobs():
    """The demand-driven knobs, once refused, are taken as the JAX
    supervisor takes them: the same public fields on both sides."""
    def run(pkg):
        fleet = _mod(pkg, "fleet")
        out = []
        for kw in ({"warm_spares": 1}, {"balancer_procs": 2},
                   {"qos": fleet.QosConfig(tenant_rate=5.0)},
                   {"autoscale": fleet.AutoscaleConfig(min_live=2,
                                                       max_live=3)},
                   {"trace_dir": "t"}):
            sup = fleet.FleetSupervisor("m", **kw)
            out.append((sup.base_replicas, sup.warm_spares, sup.num_replicas,
                        sup.balancer_procs, sup.trace_dir,
                        sup.qos == kw.get("qos"),
                        sup.autoscale_config == kw.get("autoscale"),
                        sup.autoscaler, sup.shards))
        return out

    got = _both(run)
    assert got[0][:3] == (2, 1, 3) and got[1][3] == 2 and got[4][4] == "t"


# ----------------------------------------------------------------------
# SnapshotWatcher transient-error backoff
# ----------------------------------------------------------------------


class _WatchStubServer:
    """A stand-in server that records reloads, with real metrics."""

    def __init__(self, pkg):
        self.metrics = _mod(pkg, "utils.metrics").ServingMetrics()
        self.reloads = []
        self.fail_with = None

    def reload_generation(self, gen_dir, generation=None):
        if self.fail_with is not None:
            raise self.fail_with
        self.reloads.append(generation)
        self.metrics.record_swap(generation, ok=True)


def _point(pub, gen):
    (pub / gen).mkdir(exist_ok=True)
    tmp = pub / "LATEST.json.tmp"
    tmp.write_text(json.dumps({"generation": gen}))
    os.replace(tmp, pub / "LATEST.json")


def _watch_errs(server):
    return server.metrics.snapshot()["hot_swap"]["watch_errors_total"]


def _pointer_error(pkg, pub):
    server = _WatchStubServer(pkg)
    w = _mod(pkg, "serving").SnapshotWatcher(server, str(pub), poll_seconds=0.05)
    (pub / "LATEST.json").mkdir()  # an unreadable pointer (an OSError)
    out = [w.poll_once(), _watch_errs(server), w._failed, w.poll_once(),
           _watch_errs(server)]
    (pub / "LATEST.json").rmdir()
    _point(pub, "gen-000007")
    time.sleep(0.06)
    _wait_for(lambda: w.poll_once() == "gen-000007", timeout=5)
    return out + [server.reloads, w.current]


def _staging_error(pkg, pub):
    SnapshotWatcher = _mod(pkg, "serving").SnapshotWatcher
    _point(pub, "gen-000001")
    server = _WatchStubServer(pkg)
    server.fail_with = OSError("nfs hiccup")
    w = SnapshotWatcher(server, str(pub), poll_seconds=0.05)
    out = [w.poll_once(), w._failed, _watch_errs(server)]
    server.fail_with = None
    time.sleep(0.11)
    out.append(w.poll_once())
    server.fail_with = ValueError("manifest mismatch")
    _point(pub, "gen-000002")
    out += [w.poll_once(), w._failed,
            server.metrics.snapshot()["hot_swap"]["swap_failures_total"]]
    server.fail_with = OSError("shard deleted")
    _point(pub, "gen-000003")
    for _ in range(SnapshotWatcher.STAGING_ERROR_STRIKES):
        w._retry_at = 0.0
        out.append(w.poll_once())
    return out + [w._failed,
                  server.metrics.snapshot()["hot_swap"]["swap_failures_total"]]


def _backoff_caps(pkg, pub):
    SnapshotWatcher = _mod(pkg, "serving").SnapshotWatcher
    (pub / "LATEST.json").mkdir()
    server = _WatchStubServer(pkg)
    w = SnapshotWatcher(server, str(pub), poll_seconds=0.01)
    backoffs = []
    for _ in range(6):
        w.poll_once()
        backoffs.append(w._backoff)
        w._retry_at = 0.0  # collapse the wait, keep the doubling
    return _watch_errs(server), backoffs, w._backoff <= SnapshotWatcher.BACKOFF_CAP


@pytest.mark.parametrize("scenario", ["pointer_error", "staging_error",
                                      "backoff_caps"])
def test_watcher_backoff_matches(scenario, tmp_path):
    fn = globals()[f"_{scenario}"]

    def run(pkg):
        pub = tmp_path / pkg / "pub"
        pub.mkdir(parents=True)
        return fn(pkg, pub)

    got = _both(run)
    if scenario == "pointer_error":
        assert got == [None, 1, None, None, 1, ["gen-000007"], "gen-000007"]
    elif scenario == "backoff_caps":
        assert got[0] == 6 and got[2]


# ----------------------------------------------------------------------
# The module's helpers
# ----------------------------------------------------------------------


def _hist_state(pkg, seconds):
    h = _mod(pkg, "utils.metrics").LatencyHistogram()
    for s in seconds:
        h.record(s)
    return h.state()


HELPER_CASES = {
    "strip_model_prefix": ("_strip_model_prefix",
                           ["/synonyms", "/m/b/synonyms", "/m/b", "/m/", "/models"]),
    "parse_retry_after": ("_parse_retry_after",
                          [{}, {"retry-after": "7"}, {"retry-after": "-1"},
                           {"retry-after": "soon"}, None]),
    "passthrough_headers": ("_passthrough_headers",
                            [{}, {"x-glint-tenant": "t1", "x-glint-priority": "bulk",
                                  "x-glint-deadline-ms": "250", "other": "x"}]),
    "parse_deadline_ms": ("_parse_deadline_ms",
                          [{}, {"x-glint-deadline-ms": "12.5"},
                           {"x-glint-deadline-ms": "never"}]),
    "sum_balancer_stats": ("_sum_balancer_stats",
                           [[], [{"proxied_total": 3, "shed_retries_total": 1},
                                 None, {"proxied_total": 2,
                                        "qos": {"shed_total": {"tenant": 2},
                                                "bulk_inflight": 1,
                                                "bulk_inflight_peak": 4}}]]),
}


@pytest.mark.parametrize("name", sorted(HELPER_CASES))
def test_helpers_match(name):
    fn, inputs = HELPER_CASES[name]
    _both(lambda pkg: [getattr(_mod(pkg, "fleet"), fn)(x) for x in inputs])


def test_topk_overlap_and_window_delta_match():
    pairs = [([["a", 1], ["b", 1]], [["b", 1], ["c", 1]], 2), ([], [], 3),
             ([["a", 1]], "not a list", 1), ([["a", 1], ["b", 1]], [["a", 1]], 1)]
    _both(lambda pkg: [_mod(pkg, "fleet")._topk_overlap(a, b, k)
                       for a, b, k in pairs])

    def deltas(pkg):
        f = _mod(pkg, "fleet")
        early = _hist_state(pkg, [0.001, 0.002])
        late = _hist_state(pkg, [0.001, 0.002, 0.004, 0.008])
        out = []
        for prev, cur in ((None, late), (early, late), (late, early)):
            h = f._hist_window_delta(prev, cur)
            out.append((h.n, list(h.counts), round(h.quantile(0.95), 9)))
        return out

    _both(deltas)
