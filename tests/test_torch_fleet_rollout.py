"""Rolling rollout, the shadow canary and breaker-driven ejection of the
port's fleet (glint_word2vec_torch/fleet.py) against the JAX package's, the
cases of tests/test_fleet_selfheal.py over in-process stub replicas: the
prober ejects a dead replica and readmits it, a half-open trial failure
re-opens, keep-alive bounces cost the client nothing, a refused connection
inside a restart window is retried; the rollout swaps one replica at a
time, halts on an unavailable replica and resumes, marks a generation that
fails staging, halts without marking on a transient 503; the canary holds
a regression back, never lets a held candidate serve live traffic, halts
below a live pair, and restores the live generation before it lets a
canary go. Each case runs once with the JAX package's classes and once
with the port's and asserts the same outcomes (exact for states, statuses,
counters and generations).

Last, the whole slice on the CPU: ``python -m glint_word2vec_torch.cli
serve-fleet --device cpu`` over real port replicas with a catalog model,
a replica killed under traffic and relaunched, a generation rolled out
behind the canary and a regressed one held back.
"""

import importlib
import json
import os
import signal
import subprocess
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("glint_word2vec_tpu", "glint_word2vec_torch")


@pytest.fixture(params=PKGS)
def fleet(request):
    return importlib.import_module(f"{request.param}.fleet")


def _wait_for(pred, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


class StubReplica:
    """In-process replica speaking what the balancer, the prober and the
    rollout coordinator use: ``/healthz`` (``fleet_generation`` echo, a
    failure switch), ``/metrics`` (``hot_swap.generation``, compiles),
    ``/reload`` (records swaps; can fail or answer a transient 503) and
    ``/synonyms`` (answers by generation; live and shadow traffic told
    apart by ``X-Glint-Shadow``)."""

    def __init__(self, generation="gen-000001", answers=None):
        self.generation = generation
        self.answers = answers or {}
        self.default_answer = ["a", "b", "c"]
        self.healthz_fail = False
        self.reload_fail = False
        self.reload_transient = False
        self.reloads = []          # (generation, t_start, t_end)
        self.synonyms_live = []    # (word, generation)
        self.synonyms_shadow = []  # (word, generation)
        self._mu = threading.Lock()
        stub = self

        class Handler(BaseHTTPRequestHandler):
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
                    if stub.healthz_fail:
                        return self._send(503, {"status": "down"})
                    return self._send(200, {"status": "ok",
                                            "fleet_generation": None,
                                            "generation": stub.generation})
                if self.path == "/metrics":
                    return self._send(200, {
                        "endpoints": {},
                        "hot_swap": {"generation": stub.generation,
                                     "table_swaps_total": len(stub.reloads)},
                        "compiles": {"total": 0, "warmup": 0, "post_warmup": 0},
                    })
                if self.path == "/gen":
                    return self._send(200, {"generation": stub.generation})
                self._send(404, {"error": "no route"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                shadow = self.headers.get("X-Glint-Shadow") == "1"
                if self.path == "/reload":
                    t0 = time.monotonic()
                    if stub.reload_transient:
                        return self._send(503, {"error": "transient staging error"})
                    if stub.reload_fail:
                        return self._send(400, {"error": "stub refuses"})
                    gen = req.get("generation") or os.path.basename(
                        os.path.normpath(req.get("dir", "")))
                    with stub._mu:
                        stub.generation = gen
                        stub.reloads.append((gen, t0, time.monotonic()))
                    return self._send(200, {"status": "reloaded",
                                            "generation": gen})
                if self.path == "/synonyms":
                    with stub._mu:
                        gen = stub.generation
                        (stub.synonyms_shadow if shadow
                         else stub.synonyms_live).append((req.get("word"), gen))
                    words = stub.answers.get(gen, stub.default_answer)
                    return self._send(200, [[w, 0.9 - 0.1 * i]
                                            for i, w in enumerate(words)])
                self._send(404, {"error": "no route"})

        self._handler = Handler
        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.port}"

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()

    def restart_same_port(self):
        """A bounce: a fresh server on the same port."""
        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port), self._handler)
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()


def _post(host, port, path, payload, timeout=30):
    req = urllib.request.Request(
        f"http://{host}:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(host, port, path, timeout=30):
    with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=timeout) as r:
        return r.status, r.read()


def _make_pub(tmp_path, gen):
    """A publish directory whose LATEST names ``gen`` (stub replicas never
    read the generation directory)."""
    pub = tmp_path / "pub"
    pub.mkdir(exist_ok=True)
    (pub / gen).mkdir(exist_ok=True)
    tmp = pub / "LATEST.json.tmp"
    tmp.write_text(json.dumps({"generation": gen}))
    os.replace(tmp, pub / "LATEST.json")
    return str(pub)


@pytest.fixture()
def stubs():
    made = []

    def make(n, **kw):
        made.extend(StubReplica(**kw) for _ in range(n))
        return made[-n:]

    yield make
    for s in made:
        s.stop()


# ----------------------------------------------------------------------
# Probe-driven ejection and the keep-alive transport
# ----------------------------------------------------------------------


def test_prober_ejects_dead_replica_and_readmits(fleet, stubs):
    from glint_word2vec_torch.obs.prometheus import lint_prometheus_text

    s1, s2 = stubs(2)
    lb = fleet.LoadBalancer([s1.url, s2.url], port=0, breaker_failures=2,
                            breaker_successes=2, breaker_open_seconds=0.2,
                            probe_interval=0.05, probe_timeout=0.5)
    lb.start_background()
    lb.start_prober()
    try:
        _wait_for(lambda: all(b.state() == "closed" for b in lb.breakers))
        s2.stop()
        _wait_for(lambda: lb.breakers[1].state() == "open", msg="ejection")
        with lb._mu:
            errors_at_open = lb._errors[1]
        for i in range(6):
            assert _post(lb.host, lb.port, "/synonyms", {"word": f"w{i}"})[0] == 200
        with lb._mu:
            assert lb._errors[1] == errors_at_open
        assert lb.balancer_stats()["breaker_skips_total"] > 0
        text = _get(lb.host, lb.port, "/metrics?format=prometheus")[1].decode()
        lint_prometheus_text(text)
        assert 'state="open"} 1' in text
        s2.restart_same_port()
        _wait_for(lambda: lb.breakers[1].state() == "closed", msg="readmission")
        assert lb.breakers[1].snapshot()["closed_total"] >= 1
    finally:
        lb.stop()


def test_half_open_trial_failure_reopens(fleet, stubs):
    (s1,) = stubs(1)
    lb = fleet.LoadBalancer([s1.url], port=0, breaker_failures=1,
                            breaker_successes=1, breaker_open_seconds=0.1,
                            probe_interval=0.03, probe_timeout=0.3)
    lb.start_prober()
    try:
        s1.healthz_fail = True
        _wait_for(lambda: lb.breakers[0].state() == "open")
        _wait_for(lambda: lb.breakers[0].snapshot()["reopened_total"] >= 2)
        s1.healthz_fail = False
        _wait_for(lambda: lb.breakers[0].state() == "closed")
    finally:
        lb.stop()


def test_keepalive_bounces_cost_the_client_nothing(fleet, stubs):
    (s1,) = stubs(1)
    conn = fleet._ReplicaConn("127.0.0.1", s1.port, timeout=5.0)
    lb = fleet.LoadBalancer([s1.url], port=0)
    lb.start_background()
    try:
        assert conn.roundtrip("GET", "/gen", b"")[0] == 200
        assert _post(lb.host, lb.port, "/synonyms", {"word": "w"})[0] == 200
        s1.stop()
        s1.restart_same_port()
        time.sleep(0.1)
        status, body, _ = conn.roundtrip("GET", "/gen", b"")
        assert (status, json.loads(body)["generation"]) == (200, "gen-000001")
        assert _post(lb.host, lb.port, "/synonyms", {"word": "w"})[0] == 200
    finally:
        conn.close()
        lb.stop()


def test_refused_inside_restart_window_is_retried(fleet, stubs):
    (s1,) = stubs(1)
    lb = fleet.LoadBalancer([s1.url], port=0)
    lb.start_background()
    try:
        assert _post(lb.host, lb.port, "/synonyms", {"word": "w"})[0] == 200
        s1.stop()
        lb.set_restarting(0, True)
        t = threading.Timer(0.15, s1.restart_same_port)
        t.start()
        code = _post(lb.host, lb.port, "/synonyms", {"word": "w"})[0]
        t.join()
        assert code == 200
        assert lb.balancer_stats()["restart_retries_total"] >= 1
    finally:
        lb.stop()


# ----------------------------------------------------------------------
# Rolling rollout
# ----------------------------------------------------------------------


def _coordinator(fleet, lb, pub, **kw):
    kw.setdefault("poll_seconds", 0.05)
    kw.setdefault("current", "gen-000001")
    kw.setdefault("current_dir", os.path.join(pub, "gen-000001"))
    kw.setdefault("step_timeout", 10.0)
    kw.setdefault("drain_seconds", 0.05)
    return fleet.RolloutCoordinator(lb, pub, **kw)


def test_rollout_swaps_one_replica_at_a_time(fleet, stubs, tmp_path):
    reps = stubs(3)
    lb = fleet.LoadBalancer([s.url for s in reps], port=0)
    pub = _make_pub(tmp_path, "gen-000001")
    co = _coordinator(fleet, lb, pub)
    try:
        assert co.poll_once() is None
        _make_pub(tmp_path, "gen-000002")
        assert co.poll_once() == "gen-000002"
        assert [(s.generation, len(s.reloads)) for s in reps] == \
            [("gen-000002", 1)] * 3
        windows = sorted((t0, t1) for s in reps for (_, t0, t1) in s.reloads)
        for (_, a1), (b0, _) in zip(windows, windows[1:]):
            assert a1 <= b0, "two replicas reloaded at once"
        st = co.stats()
        assert (st["rollouts_completed_total"], st["rollout_steps_total"],
                st["generation"]) == (1, 3, "gen-000002")
        assert all(b.eligible() for b in lb.breakers)
    finally:
        co.stop()
        lb.stop()


def test_rollout_halts_on_unavailable_replica_and_resumes(fleet, stubs, tmp_path):
    reps = stubs(3)
    lb = fleet.LoadBalancer([s.url for s in reps], port=0)
    pub = _make_pub(tmp_path, "gen-000001")
    co = _coordinator(fleet, lb, pub)
    try:
        lb.breakers[1].force_open()
        _make_pub(tmp_path, "gen-000002")
        assert co.poll_once() is None
        assert co.stats()["rollouts_halted_total"] == 1
        assert all(s.generation == "gen-000001" for s in reps)
        lb.breakers[1].trial()
        lb.breakers[1].record_success(probe=True)
        lb.breakers[1].record_success(probe=True)
        assert co.poll_once() == "gen-000002"
        assert all(s.generation == "gen-000002" for s in reps)
    finally:
        co.stop()
        lb.stop()


def test_rollout_killed_mid_way_keeps_old_generation(fleet, stubs, tmp_path):
    reps = stubs(3)
    lb = fleet.LoadBalancer([s.url for s in reps], port=0)
    pub = _make_pub(tmp_path, "gen-000001")
    co = _coordinator(fleet, lb, pub)
    orig = co._swap_replica

    def swap_and_kill(i, gen, gen_dir, hold):
        res = orig(i, gen, gen_dir, hold)
        if i == 0:
            reps[1].stop()
            reps[1].restart_same_port = lambda: None
            lb.breakers[1].force_open()
        return res

    co._swap_replica = swap_and_kill
    try:
        _make_pub(tmp_path, "gen-000002")
        assert co.poll_once() is None
        st = co.stats()
        assert (st["rollouts_halted_total"], st["generation"]) == (1, "gen-000001")
        assert reps[0].generation == "gen-000002"
        assert (reps[2].generation, len(reps[2].reloads)) == ("gen-000001", 0)
    finally:
        co.stop()
        lb.stop()


def test_rollout_stage_failure_marks_generation(fleet, stubs, tmp_path):
    reps = stubs(2)
    reps[0].reload_fail = True
    lb = fleet.LoadBalancer([s.url for s in reps], port=0)
    pub = _make_pub(tmp_path, "gen-000001")
    co = _coordinator(fleet, lb, pub)
    try:
        _make_pub(tmp_path, "gen-000002")
        assert co.poll_once() is None
        st = co.stats()
        assert (st["generations_failed_total"], st["failed_generation"]) == \
            (1, "gen-000002")
        assert all(s.generation == "gen-000001" for s in reps)
        assert co.poll_once() is None
        assert co.stats()["rollouts_started_total"] == 1
        reps[0].reload_fail = False
        _make_pub(tmp_path, "gen-000003")
        assert co.poll_once() == "gen-000003"
    finally:
        co.stop()
        lb.stop()


def test_rollout_transient_503_halts_without_marking(fleet, stubs, tmp_path):
    reps = stubs(2)
    reps[0].reload_transient = True
    lb = fleet.LoadBalancer([s.url for s in reps], port=0)
    pub = _make_pub(tmp_path, "gen-000001")
    co = _coordinator(fleet, lb, pub)
    try:
        _make_pub(tmp_path, "gen-000002")
        assert co.poll_once() is None
        st = co.stats()
        assert (st["rollouts_halted_total"], st["generations_failed_total"],
                st["failed_generation"]) == (1, 0, None)
        reps[0].reload_transient = False
        assert co.poll_once() == "gen-000002"
        assert all(s.generation == "gen-000002" for s in reps)
    finally:
        co.stop()
        lb.stop()


# ----------------------------------------------------------------------
# Shadow canary
# ----------------------------------------------------------------------


def _canary(fleet, **kw):
    kw.setdefault("min_scores", 0)
    kw.setdefault("mirror_seconds", 0.3)
    kw.setdefault("agreement_gate", 0.6)
    kw.setdefault("probes", [
        {"path": "/synonyms", "body": {"word": "vienna", "num": 10}},
        {"path": "/synonyms", "body": {"word": "berlin", "num": 10}},
    ])
    return fleet.CanaryConfig(**kw)


def test_canary_holds_back_a_regression(fleet, stubs, tmp_path):
    answers = {"gen-000001": ["vienna", "berlin", "paris"],
               "gen-000002": ["xx", "yy", "zz"],
               "gen-000003": ["vienna", "berlin", "paris"]}
    reps = stubs(2, answers=answers)
    lb = fleet.LoadBalancer([s.url for s in reps], port=0)
    pub = _make_pub(tmp_path, "gen-000001")
    co = _coordinator(fleet, lb, pub, canary=_canary(fleet))
    try:
        _make_pub(tmp_path, "gen-000002")
        assert co.poll_once() is None
        st = co.stats()
        assert (st["canary"]["holdbacks_total"], st["canary"]["last_verdict"],
                st["held_back_generation"]) == (1, "held_back", "gen-000002")
        assert st["canary"]["last_agreement"] < 0.6
        assert (reps[1].generation, len(reps[1].reloads)) == ("gen-000001", 0)
        assert reps[0].generation == "gen-000001"
        assert all(b.eligible() for b in lb.breakers)
        assert co.poll_once() is None
        assert co.stats()["canary"]["evaluations_total"] == 1
        _make_pub(tmp_path, "gen-000003")
        assert co.poll_once() == "gen-000003"
        assert all(s.generation == "gen-000003" for s in reps)
        st = co.stats()
        assert (st["canary"]["last_verdict"], st["canary"]["last_agreement"]) == \
            ("pass", 1.0)
    finally:
        co.stop()
        lb.stop()


def test_canary_never_serves_live_traffic_while_held(fleet, stubs, tmp_path):
    reps = stubs(2, answers={"gen-000001": ["vienna", "berlin"],
                             "gen-000002": ["xx", "yy"]})
    lb = fleet.LoadBalancer([s.url for s in reps], port=0)
    lb.start_background()
    pub = _make_pub(tmp_path, "gen-000001")
    co = _coordinator(fleet, lb, pub, canary=_canary(
        fleet, min_scores=4, mirror_seconds=3.0, mirror_every=1))
    stop = threading.Event()

    def client():
        while not stop.is_set():
            _post(lb.host, lb.port, "/synonyms", {"word": "vienna", "num": 5})
            time.sleep(0.01)

    t = threading.Thread(target=client)
    t.start()
    try:
        _make_pub(tmp_path, "gen-000002")
        assert co.poll_once() is None
        stop.set()
        t.join()
        assert [x for x in reps[0].synonyms_live if x[1] == "gen-000002"] == []
        assert any(g == "gen-000002" for _, g in reps[0].synonyms_shadow)
        assert co.stats()["canary"]["last_scored"] >= 4
    finally:
        stop.set()
        co.stop()
        lb.stop()


def test_canary_below_a_live_pair_halts(fleet, stubs, tmp_path):
    reps = stubs(2)
    lb = fleet.LoadBalancer([s.url for s in reps], port=0)
    pub = _make_pub(tmp_path, "gen-000001")
    co = _coordinator(fleet, lb, pub, canary=_canary(fleet),
                      replica_ok=lambda i: i != 1)
    try:
        _make_pub(tmp_path, "gen-000002")
        assert co.poll_once() is None
        st = co.stats()
        assert (st["rollouts_halted_total"], st["canary"]["evaluations_total"]) \
            == (1, 0)
        assert all(s.generation == "gen-000001" for s in reps)
        assert len(reps[0].reloads) == 0
    finally:
        co.stop()
        lb.stop()


def test_canary_restored_before_release(fleet, stubs, tmp_path):
    reps = stubs(2)
    lb = fleet.LoadBalancer([s.url for s in reps], port=0)
    pub = _make_pub(tmp_path, "gen-000001")
    co = _coordinator(fleet, lb, pub, canary=_canary(fleet), step_timeout=0.5)
    co._wait_replica_on = lambda i, gen, before=-1, *a, **k: (
        "ok" if gen == "gen-000001" else "not healthy on gen-000002 within 0s")
    try:
        _make_pub(tmp_path, "gen-000002")
        assert co.poll_once() is None
        assert co.stats()["rollouts_halted_total"] == 1
        assert reps[0].generation == "gen-000001"
        assert [g for g, _, _ in reps[0].reloads] == ["gen-000002", "gen-000001"]
        assert lb.breakers[0].eligible()
    finally:
        co.stop()
        lb.stop()


def test_canary_scoped_to_a_catalog_model(fleet):
    cfg = _canary(fleet).scoped("b")
    assert cfg.mirror_paths == ("/m/b/synonyms", "/m/b/analogy")
    assert [p["path"] for p in cfg.probes] == ["/m/b/synonyms"] * 2


# ----------------------------------------------------------------------
# The slice on the CPU: serve-fleet over real port replicas
# ----------------------------------------------------------------------

V, D = 64, 16
WORDS = [f"w{i}" for i in range(V)]


def _publish_tables(pub, tables):
    """Each table one committed generation in ``pub``, published by the
    port."""
    from glint_word2vec_torch.parallel.engine import EmbeddingEngine
    from glint_word2vec_torch.streaming.publish import SnapshotPublisher
    from glint_word2vec_torch.utils.params import Word2VecParams

    class _Vocab:
        words = WORDS

    eng = EmbeddingEngine(V, D, np.arange(V, 0, -1, dtype=np.int64) * 10,
                          device="cpu")
    publisher = SnapshotPublisher(pub, eng, Word2VecParams(vector_size=D),
                                  keep=8)
    out = []
    for t in tables:
        eng.set_tables(t, np.zeros_like(t))
        out.append(os.path.join(pub, publisher.publish(_Vocab())))
        eng.wait_pending_saves()
    return out


def test_serve_fleet_cli_on_the_cpu(tmp_path):
    rng = np.random.default_rng(5)
    t1 = rng.normal(size=(V, D)).astype(np.float32)
    t_b = rng.normal(size=(V, D)).astype(np.float32)
    pub = str(tmp_path / "pub")
    _publish_tables(pub, [t1])
    (b_dir,) = _publish_tables(str(tmp_path / "pub_b"), [t_b])
    port_file = str(tmp_path / "lb.json")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    proc = subprocess.Popen(
        [sys.executable, "-m", "glint_word2vec_torch.cli", "serve-fleet",
         "--replicas", "2", "--device", "cpu", "--watch-checkpoint", pub,
         "--watch-poll", "0.2", "--add-model", f"b={b_dir}", "--port", "0",
         "--port-file", port_file, "--max-batch", "8",
         "--canary-mirror-seconds", "1", "--canary-min-scores", "4",
         "--canary-mirror-every", "1", "--probe-interval", "0.1",
         "--breaker-open-seconds", "0.3", "--backoff-base", "0.2",
         "--replica-log-dir", str(tmp_path / "logs")],
        cwd=str(tmp_path), env=env, start_new_session=True,
    )
    stop = threading.Event()
    failures = []
    try:
        _wait_for(lambda: os.path.exists(port_file) or proc.poll() is not None,
                  timeout=120, msg="fleet port file")
        assert proc.poll() is None, "serve-fleet exited"
        lb = json.load(open(port_file))
        host, port = lb["host"], lb["port"]

        def fleet_doc():
            return json.loads(_get(host, port, "/metrics")[1])

        doc = fleet_doc()
        for r in doc["replicas"]:
            rhost, rport = r["url"][len("http://"):].split(":")
            h = json.loads(_get(rhost, int(rport), "/healthz")[1])
            assert h["device"] == "cpu" and h["models"].keys() == {"default", "b"}
        code, body = _post(host, port, "/m/b/synonyms", {"word": "w3", "num": 5})
        assert code == 200 and body[0][0] != "w3"

        def client(c):
            i = 0
            while not stop.is_set():
                try:
                    code, _ = _post(host, port, "/synonyms",
                                    {"word": f"w{(c * 7 + i) % V}", "num": 5})
                    if code != 200:
                        failures.append(code)
                except OSError as e:
                    failures.append(repr(e))
                i += 1

        threads = [threading.Thread(target=client, args=(c,)) for c in range(2)]
        for t in threads:
            t.start()
        # A replica killed under traffic: relaunched and readmitted.
        _kill_replica(host, port, 1)
        _wait_for(lambda: fleet_doc()["supervisor"]["restarts_total"] == 1
                  and fleet_doc()["replicas"][1]["breaker"]["state"] == "closed",
                  timeout=120, msg="replica 1 relaunched and readmitted")
        # (c) a close generation rolls out behind the canary.
        _publish_tables(pub, [t1 + 0.01 * rng.normal(size=t1.shape).astype(np.float32)])
        _wait_for(lambda: (fleet_doc().get("rollout") or {}).get("generation")
                  == "gen-000002", timeout=120, msg="gen-000002 rolled out")
        doc = fleet_doc()
        assert [r["snapshot"]["hot_swap"]["generation"]
                for r in doc["replicas"]] == ["gen-000002"] * 2
        assert doc["rollout"]["canary"]["last_verdict"] == "pass"
        # (d) a fresh random table is held back.
        _publish_tables(pub, [rng.normal(size=t1.shape).astype(np.float32)])
        _wait_for(lambda: fleet_doc()["rollout"]["held_back_generation"]
                  == "gen-000003", timeout=120, msg="gen-000003 held back")
        doc = fleet_doc()
        assert [r["snapshot"]["hot_swap"]["generation"]
                for r in doc["replicas"]] == ["gen-000002"] * 2
        stop.set()
        for t in threads:
            t.join()
        assert failures == []
        text = _get(host, port, "/metrics?format=prometheus")[1].decode()
        from glint_word2vec_torch.obs.prometheus import lint_prometheus_text

        lint_prometheus_text(text)
        assert "kernel_launches" in doc["fleet"]
        assert _post(host, port, "/shutdown", {})[0] == 200
        assert proc.wait(timeout=60) == 0
    finally:
        stop.set()
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def _kill_replica(host, port, i):
    """SIGKILL the first launch of replica ``i``: the process whose command
    line names its port file ``replica-<i>.0.port``."""
    del host, port
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if any(a.endswith(f"replica-{i}.0.port".encode()) for a in argv):
            os.kill(int(pid), signal.SIGKILL)
            return
    raise AssertionError(f"replica {i} not found")
