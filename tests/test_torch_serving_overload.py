"""Overload protection of the port's server (glint_word2vec_torch/serving.py)
against the JAX package's: the nine scenarios of tests/test_serving_overload.py
(bounded admission with 429 and ``Retry-After``, deadlines answered 504
without a dispatch slot, degraded cache-only mode while the device lock is
held, the overload counters in both ``/metrics`` renderers, the overload
config on ``/healthz``, 0 turning each protection off, the
``serving.dispatch`` fault, and the ``X-Glint-Deadline-Ms`` header that
only tightens the deadline) run on a JAX server and on a port server over
the same tables, and give the same statuses, headers and counters.

The JAX tests build their model on ``make_mesh(1, 2)``; here both servers
serve a plain model of random rows (one device on each side), which is all
the overload layer sees. Tolerances: statuses, headers, counters and
answer words compare exactly (scores within 1e-5), but for the in-flight
peak of back-to-back requests, 1 or 2 on either side; wall-clock bounds
are the JAX tests' own.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

WORDS = ["austria", "vienna", "germany", "berlin"] + [f"w{i}" for i in range(44)]
D = 16


@pytest.fixture(scope="module")
def packages():
    """``{"jax": (ModelServer, faults, model), "torch": (...)}`` over the
    same random tables."""
    from glint_word2vec_tpu.corpus.vocab import Vocabulary as JaxVocab
    from glint_word2vec_tpu.models.word2vec import Word2VecModel as JaxModel
    from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
    from glint_word2vec_tpu.parallel.mesh import make_mesh
    from glint_word2vec_tpu.serving import ModelServer as JaxServer
    from glint_word2vec_tpu.utils import faults as jfaults
    from glint_word2vec_tpu.utils.params import Word2VecParams as JaxParams

    from glint_word2vec_torch.convert import model_from_arrays
    from glint_word2vec_torch.serving import ModelServer
    from glint_word2vec_torch.utils import faults
    from glint_word2vec_torch.utils.params import Word2VecParams

    rng = np.random.default_rng(7)
    V = len(WORDS)
    s0 = rng.normal(size=(V, D)).astype(np.float32)
    s1 = np.zeros((V, D), np.float32)
    counts = np.arange(V, 0, -1).astype(np.int64)
    jeng = JaxEngine(make_mesh(1, 1), V, D, counts)
    jeng.set_tables(s0, s1)
    jmodel = JaxModel(JaxVocab.from_sorted(WORDS, counts), jeng,
                      JaxParams(vector_size=D, min_count=1))
    pmodel = model_from_arrays(WORDS, s0, s1, counts,
                               Word2VecParams(vector_size=D, min_count=1),
                               device="cpu")
    yield {"jax": (JaxServer, jfaults, jmodel), "torch": (ModelServer, faults, pmodel)}
    jmodel.stop()
    pmodel.stop()


@pytest.fixture()
def run_both(packages):
    """Run one scenario on each package's server; returns the two
    observation records."""
    servers = []

    def run(scenario, **kw):
        out = {}
        for name, (cls, faults, model) in packages.items():
            kw.setdefault("warmup", False)
            server = cls(model, port=0, **kw)
            server.start_background()
            servers.append(server)
            out[name] = scenario(server, faults)
        return out

    yield run
    for s in servers:
        s.stop()


def _post(server, path, payload, headers=None, timeout=30):
    req = urllib.request.Request(
        f"http://{server.host}:{server.port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _status(server, path, payload, headers=None):
    """``(status, Retry-After, body)`` of one POST."""
    try:
        return 200, None, _post(server, path, payload, headers)
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Retry-After"), None


def _get(server, path):
    with urllib.request.urlopen(
        f"http://{server.host}:{server.port}{path}", timeout=30
    ) as r:
        return json.loads(r.read())


def _hold_lock(server, seconds):
    """Hold the device lock from a background thread: the wedged or slow
    dispatch the deadline and degraded paths defend against."""
    acquired = threading.Event()

    def hold():
        server._lock.acquire()
        acquired.set()
        time.sleep(seconds)
        server._lock.release()

    t = threading.Thread(target=hold, daemon=True)
    t.start()
    assert acquired.wait(5)
    return t


def _overload(server) -> dict:
    return _get(server, "/metrics")["overload"]


def _admission(server, faults):
    holder = _hold_lock(server, 1.0)
    results = {}

    def admitted():
        results["a"] = _post(server, "/synonyms", {"word": "austria", "num": 5})

    t = threading.Thread(target=admitted, daemon=True)
    t.start()
    deadline = time.time() + 5
    while server._inflight < 1 and time.time() < deadline:
        time.sleep(0.01)
    t0 = time.time()
    shed = _status(server, "/synonyms", {"word": "vienna", "num": 5})
    shed_s = time.time() - t0
    t.join(timeout=30)
    holder.join(timeout=30)
    assert shed_s < 0.5  # shed now, not after queueing
    return {"shed": shed, "admitted": results["a"], "overload": _overload(server)}


def _deadline(server, faults):
    holder = _hold_lock(server, 1.5)
    t0 = time.time()
    syn = _status(server, "/synonyms", {"word": "austria", "num": 5})
    ana = _status(server, "/analogy",
                  {"positive": ["vienna"], "negative": [], "num": 3})
    assert time.time() - t0 < 1.4  # within the deadline, not the hold
    holder.join(timeout=30)
    pending = list(server._coalescer._pending)
    after = _post(server, "/synonyms", {"word": "austria", "num": 5})
    return {"synonyms": syn, "analogy": ana, "pending": pending,
            "overload": _overload(server), "after": after}


def _degraded(server, faults):
    hot = _post(server, "/synonyms", {"word": "austria", "num": 5})
    holder = _hold_lock(server, 2.0)
    time.sleep(0.4)  # past degraded_after
    out = {"health": _get(server, "/healthz")["status"],
           "hit": _post(server, "/synonyms", {"word": "austria", "num": 5}) == hot,
           "miss": _status(server, "/synonyms", {"word": "vienna", "num": 5}),
           "transform": _status(server, "/transform", {"sentences": [["austria"]]})}
    holder.join(timeout=30)
    out["health_after"] = _get(server, "/healthz")["status"]
    out["after"] = _post(server, "/synonyms", {"word": "vienna", "num": 5})
    out["overload"] = _overload(server)
    return out


def _prometheus(server, faults):
    _post(server, "/synonyms", {"word": "austria", "num": 5})
    with urllib.request.urlopen(
        f"http://{server.host}:{server.port}/metrics?format=prometheus",
        timeout=30,
    ) as r:
        text = r.read().decode()
    names = ('glint_serving_shed_total{reason="admission"}',
             'glint_serving_shed_total{reason="degraded"}',
             "glint_serving_deadline_hits_total",
             "glint_serving_degraded_entered_total",
             "glint_serving_inflight_peak")
    return {"lines": sorted(line for line in text.splitlines()
                            if line.startswith(names)),
            "text": text}


def _health_config(server, faults):
    h = _get(server, "/healthz")
    return {k: h[k] for k in ("max_inflight", "request_deadline_seconds",
                              "degraded_after_seconds")}


def _zero_disables(server, faults):
    out = {"config": (server.max_inflight, server.request_deadline,
                      server.degraded_after)}
    holder = _hold_lock(server, 0.3)
    out["answer"] = _post(server, "/synonyms", {"word": "austria", "num": 5})
    holder.join(timeout=30)
    return out


def _dispatch_fault(server, faults):
    faults.arm("serving.dispatch:exc@1")
    try:
        with pytest.raises(Exception):
            # The injected failure fails this request, never the server.
            _post(server, "/synonyms", {"word": "austria", "num": 5})
    finally:
        faults.disarm()
    return {"answer": _post(server, "/synonyms", {"word": "austria", "num": 5}),
            "health": _get(server, "/healthz")["status"]}


def _header_tightens(server, faults):
    holder = _hold_lock(server, 1.0)
    t0 = time.time()
    tight = _status(server, "/synonyms", {"word": "austria", "num": 5},
                    {"X-Glint-Deadline-Ms": "200"})
    assert time.time() - t0 < 0.9  # the 200 ms budget won, not the 30 s
    holder.join(timeout=30)
    return {"tight": tight,
            "generous": _post(server, "/synonyms", {"word": "austria", "num": 5},
                              {"X-Glint-Deadline-Ms": "60000"}),
            "malformed": _post(server, "/synonyms", {"word": "austria", "num": 5},
                               {"X-Glint-Deadline-Ms": "soon"}),
            "overload": _overload(server)}


def _header_cannot_extend(server, faults):
    holder = _hold_lock(server, 1.2)
    t0 = time.time()
    st = _status(server, "/synonyms", {"word": "austria", "num": 5},
                 {"X-Glint-Deadline-Ms": "30000"})
    assert time.time() - t0 < 1.1
    holder.join(timeout=30)
    return {"status": st}


def _same_overload(r):
    """The overload counters of both servers: equal, but for the in-flight
    peak of back-to-back requests, which is 1 or 2 on either side (a
    handler releases its slot just after its answer is sent, so the next
    request can be admitted first)."""
    j, p = (dict(r[k]["overload"]) for k in ("jax", "torch"))
    assert 1 <= j.pop("inflight_peak") <= 2 and 1 <= p.pop("inflight_peak") <= 2
    assert j == p


def _same_answers(a, b):
    """Synonym lists: the same words in order, scores within 1e-5 (fp32
    products summed in another order)."""
    assert [w for w, _ in a] == [w for w, _ in b]
    np.testing.assert_allclose([s for _, s in a], [s for _, s in b], atol=1e-5)


def test_admission_shed_429_with_retry_after(run_both):
    r = run_both(_admission, max_inflight=1, request_deadline=5.0,
                 degraded_after=None)
    for side in r.values():
        assert side["shed"] == (429, "1", None)
        assert side["overload"]["shed_admission_total"] == 1
        assert side["overload"]["inflight_peak"] == 1
    _same_answers(r["jax"]["admitted"], r["torch"]["admitted"])
    assert r["jax"]["overload"] == r["torch"]["overload"]


def test_deadline_answered_504_without_dispatch_slot(run_both):
    r = run_both(_deadline, max_inflight=8, request_deadline=0.3,
                 degraded_after=None)
    for side in r.values():
        assert side["synonyms"] == side["analogy"] == (504, None, None)
        assert side["pending"] == []
        assert side["overload"]["deadline_504_total"] == 2
    _same_overload(r)
    _same_answers(r["jax"]["after"], r["torch"]["after"])


def test_degraded_cache_only_serves_hits_sheds_misses(run_both):
    r = run_both(_degraded, max_inflight=8, request_deadline=10.0,
                 degraded_after=0.2, cache_size=1024)
    for side in r.values():
        assert (side["health"], side["hit"], side["health_after"]) == (
            "degraded", True, "ok")
        assert side["miss"] == side["transform"] == (429, "1", None)
        assert side["overload"]["shed_degraded_total"] == 2
        assert side["overload"]["degraded_entered_total"] == 1
    _same_overload(r)
    _same_answers(r["jax"]["after"], r["torch"]["after"])


def test_overload_counters_render_in_prometheus(run_both):
    from glint_word2vec_tpu.obs.prometheus import lint_prometheus_text as jlint

    from glint_word2vec_torch.obs.prometheus import lint_prometheus_text

    r = run_both(_prometheus)
    assert len(r["torch"]["lines"]) == 5
    assert r["jax"]["lines"] == r["torch"]["lines"]
    lint_prometheus_text(r["torch"]["text"])
    jlint(r["torch"]["text"])


def test_healthz_reports_overload_config(run_both):
    r = run_both(_health_config, max_inflight=7, request_deadline=2.5,
                 degraded_after=1.25)
    assert r["jax"] == r["torch"] == {
        "max_inflight": 7, "request_deadline_seconds": 2.5,
        "degraded_after_seconds": 1.25}


def test_zero_disables_each_protection(run_both):
    r = run_both(_zero_disables, max_inflight=0, request_deadline=0,
                 degraded_after=0)
    assert r["jax"]["config"] == r["torch"]["config"] == (0, None, None)
    _same_answers(r["jax"]["answer"], r["torch"]["answer"])
    assert len(r["torch"]["answer"]) == 5


def test_dispatch_fault_fails_one_request_server_survives(run_both):
    r = run_both(_dispatch_fault)
    assert r["jax"]["health"] == r["torch"]["health"] == "ok"
    _same_answers(r["jax"]["answer"], r["torch"]["answer"])


def test_deadline_header_tightens_replica_deadline(run_both):
    r = run_both(_header_tightens, max_inflight=8, request_deadline=30.0,
                 degraded_after=None)
    for side in r.values():
        assert side["tight"] == (504, None, None)
        assert side["overload"]["deadline_504_total"] == 1
    _same_overload(r)
    for key in ("generous", "malformed"):
        _same_answers(r["jax"][key], r["torch"][key])


def test_deadline_header_cannot_extend_local_deadline(run_both):
    r = run_both(_header_cannot_extend, max_inflight=8, request_deadline=0.3,
                 degraded_after=None)
    assert r["jax"] == r["torch"] == {"status": (504, None, None)}


def test_port_dispatch_fault_answers_500_and_counts_it(packages):
    # JAX drops the connection of a request its dispatch fault failed;
    # the port answers 500 with the error. Both count one 5xx.
    cls, faults, model = packages["torch"]
    server = cls(model, port=0, warmup=False)
    server.start_background()
    try:
        faults.arm("serving.dispatch:exc@1")
        try:
            assert _status(server, "/synonyms", {"word": "austria", "num": 5})[0] == 500
        finally:
            faults.disarm()
        ep = _get(server, "/metrics")["endpoints"]["/synonyms"]
        assert (ep["count"], ep["errors"]) == (1, 1)
        slo = _get(server, "/metrics")["slo"]["endpoints"]["/synonyms"]
        assert slo["windows"]["5m"]["bad_availability"] == 1
    finally:
        server.stop()


@pytest.mark.parametrize("fault", [None, "serving.dispatch:exc@1"])
def test_port_counts_a_request_before_its_answer_arrives(packages, fault):
    # A request is counted before the last bytes of its answer leave: a
    # client that reads the answer and then asks /metrics finds it
    # counted, however late the server's thread gets to its bookkeeping.
    cls, faults, model = packages["torch"]
    server = cls(model, port=0, warmup=False)
    observe = server._observe_request

    def late(*args, **kw):
        time.sleep(0.3)
        return observe(*args, **kw)

    server._observe_request = late
    server.start_background()
    try:
        if fault:
            faults.arm(fault)
        try:
            code = _status(server, "/synonyms", {"word": "austria", "num": 5})[0]
        finally:
            faults.disarm()
        assert code == (500 if fault else 200)
        ep = _get(server, "/metrics")["endpoints"]["/synonyms"]
        assert (ep["count"], ep["errors"]) == (1, 1 if fault else 0)
    finally:
        server.stop()
