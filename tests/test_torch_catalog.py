"""The model catalog of the port's server (glint_word2vec_torch/serving.py:
``ModelCatalog``, ``ServedModel``, ``ModelServer.add_model``, the
``/m/<id>/``, ``X-Glint-Model``, ``/models`` and ``/models/pin`` routes,
per-model reloads) against the JAX package's, the cases of
tests/test_multimodel.py.

Three models of the same shape (48 words, 16 wide, random rows of seeds
1, 2 and 3) are published once by the JAX package and loaded by both: a JAX
``ModelServer`` and a port ``ModelServer(device="cpu")`` each serve the
first as the default model and add the other two as ``b`` and ``d``. Every
case runs the same request sequence against both servers and compares what
they observe: statuses, answer words (scores within 1e-5), the LRU eviction
order, pins, the catalog counters and the ``/models`` document without its
timings, the process-wide build count and the count of requests that met
a cold model (which depends on thread timing on both sides). Each case
leaves every model resident and the budget off.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_tpu import Word2Vec as JaxWord2Vec
from glint_word2vec_tpu import load_model as jax_load_model
from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
from glint_word2vec_tpu.parallel.engine import (
    query_program_builds as jax_builds,
)
from glint_word2vec_tpu.parallel.mesh import make_mesh
from glint_word2vec_tpu.serving import ModelServer as JaxServer
from glint_word2vec_tpu.serving import parse_memory_budget as jax_budget
from glint_word2vec_tpu.serving import split_model_path as jax_split
from glint_word2vec_tpu.streaming.publish import (
    SnapshotPublisher as JaxPublisher,
)

from glint_word2vec_torch.models import load_model
from glint_word2vec_torch.parallel.engine import query_program_builds
from glint_word2vec_torch.serving import (
    DEFAULT_MODEL_ID,
    ModelServer,
    parse_memory_budget,
    split_model_path,
)
from glint_word2vec_torch.streaming.publish import LATEST_NAME
from glint_word2vec_torch.utils import atomic_write_json

V, D = 48, 16
WORDS = [f"w{i}" for i in range(V)]
SCORE_TOL = 1e-5


class _Vocab:
    def __init__(self, words):
        self.words = list(words)


def _publish(pub, seeds):
    """One committed generation a seed in ``pub`` (random rows of that
    seed, published by the JAX package); returns their directories."""
    counts = np.arange(V, 0, -1, dtype=np.int64) * 10
    eng = JaxEngine(make_mesh(1, 1), V, D, counts, num_negatives=2, seed=7,
                    extra_rows=4)
    publisher = JaxPublisher(pub, eng, JaxWord2Vec(vector_size=D).params,
                             keep=4)
    dirs = []
    for i, seed in enumerate(seeds):
        t = np.random.default_rng(seed).normal(
            size=(eng.num_rows, D)).astype(np.float32)
        eng.set_tables(t, np.zeros_like(t))
        publisher.publish(_Vocab(WORDS))
        eng.wait_pending_saves()
        dirs.append(os.path.join(pub, f"gen-{i + 1:06d}"))
    eng.destroy()
    return dirs


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("catalog")
    (a,) = _publish(str(root / "a"), [1])
    b = _publish(str(root / "b"), [2, 4])
    (d,) = _publish(str(root / "d"), [3])
    # b's pointer back at gen-000001: the reload case moves b forward.
    atomic_write_json(os.path.join(str(root / "b"), LATEST_NAME),
                      {"generation": "gen-000001", "seq": 1})
    return {"a": a, "b": b, "d": d}


@pytest.fixture(scope="module")
def servers(dirs):
    """``{"jax": server, "torch": server}`` over the same three models."""
    out = {
        "jax": JaxServer(jax_load_model(dirs["a"]), port=0, max_batch=8),
        "torch": ModelServer(load_model(dirs["a"], device="cpu"), port=0,
                             max_batch=8),
    }
    for s in out.values():
        s.catalog.default.source_dir = dirs["a"]
        s.start_background()
        s.add_model("b", model_dir=dirs["b"][0])
        s.add_model("d", model_dir=dirs["d"])
    yield out
    for s in out.values():
        s.stop()
        for e in list(s.catalog.entries.values()):
            e.model.stop()


def _post(server, path, payload, headers=None):
    req = urllib.request.Request(
        f"http://{server.host}:{server.port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(server, path):
    try:
        with urllib.request.urlopen(
            f"http://{server.host}:{server.port}{path}", timeout=60
        ) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _answers_equal(a, b) -> bool:
    """Two observations equal, answer lists compared by word exactly and
    by score within ``SCORE_TOL``."""
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= SCORE_TOL
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(map(_answers_equal, a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_answers_equal(a[k], b[k]) for k in a)
    return a == b


def _restore(server):
    server.catalog.budget_bytes = None
    for e in list(server.catalog.entries.values()):
        if e.evictable:
            server.catalog.ensure_resident(e)


# -- the cases: each runs on one server and returns what it observed ------


def case_routing(server, dirs):
    out = {}
    for path, hdr in (("/synonyms", None), ("/m/b/synonyms", None),
                      ("/m/d/synonyms", None), ("/synonyms", {"X-Glint-Model": "b"}),
                      (f"/m/{DEFAULT_MODEL_ID}/synonyms", None),
                      ("/m/d/synonyms", {"X-Glint-Model": "b"}),
                      ("/m/nope/synonyms", None)):
        status, body = _post(server, path, {"word": "w5", "num": 10}, hdr)
        out[(path, str(hdr))] = (status, body if status == 200 else None)
    for mid in ("", "/m/b", "/m/d"):
        out[mid + "/analogy"] = _post(server, mid + "/analogy",
                                      {"positive": ["w1", "w2"],
                                       "negative": ["w3"], "num": 10})
        out[mid + "/vector"] = _post(server, mid + "/vector", {"word": "w7"})
        out[mid + "/vector oov"] = _post(server, mid + "/vector",
                                         {"word": "nope"})[0]
        out[mid + "/transform"] = _post(server, mid + "/transform",
                                        {"sentences": [["w1", "w2"], ["w9"]]})
        out[mid + "/synonyms_vector"] = _post(
            server, mid + "/synonyms_vector",
            {"vector": [0.1 * i for i in range(D)], "num": 10})
    out["/m/nope/healthz"] = _get(server, "/m/nope/healthz")[0]
    status, h = _get(server, "/m/b/healthz")
    out["/m/b/healthz"] = (status, h["model"], h["resident"], h["vocab_size"],
                           h["dim"], h["generation"])
    status, h = _get(server, "/healthz")
    out["/healthz"] = (status, h["model"], h["resident"], sorted(h["models"]))
    status, doc = _get(server, "/models")
    out["/models"] = (status, doc["default"], sorted(doc["models"]))
    return out


def case_per_model_metrics(server, dirs):
    _, m = _get(server, "/m/b/metrics")
    _, top = _get(server, "/metrics")
    return (m["model_id"], m["resident"], m["resident_replicas"], m["pinned"],
            sorted(top["models"]), top["catalog"]["models"],
            top["model_id"], top["models"]["d"]["model_id"])


def case_cache_isolation(server, dirs):
    _, mb0 = _get(server, "/m/b/metrics")
    _, ma0 = _get(server, "/metrics")
    tops = []
    for _ in range(3):  # repeats past the first are cache hits
        for path in ("/synonyms", "/m/b/synonyms"):
            tops.append(_post(server, path, {"word": "w11", "num": 3})[1][0][0])
    _, mb = _get(server, "/m/b/metrics")
    _, ma = _get(server, "/metrics")
    return (tops,
            mb["synonym_cache"]["hits"] - mb0["synonym_cache"]["hits"],
            ma["synonym_cache"]["hits"] - ma0["synonym_cache"]["hits"])


def case_same_shape_adds_no_builds(server, dirs):
    builds = jax_builds if isinstance(server, JaxServer) else query_program_builds
    n0 = builds()
    entry = server.add_model(f"zero-{len(server.catalog.entries)}",
                             model_dir=dirs["a"])
    _, doc = _get(server, "/models")
    return (builds() - n0,
            doc["models"][entry.model_id]["post_warmup_compiles"],
            entry.model.engine.shared_program_hits > 0,
            _post(server, f"/m/{entry.model_id}/synonyms",
                  {"word": "w5", "num": 10}))


def case_lru_eviction_order(server, dirs):
    cat = server.catalog
    b, d = cat.get("b"), cat.get("d")
    try:
        for e in (b, d):
            cat.ensure_resident(e)
        cat.touch(d)
        for e in list(cat.entries.values()):
            if e not in (b, d) and e.resident:
                cat.touch(e)
        cat.touch(b)
        cat.budget_bytes = cat.resident_bytes() - 1
        cat.enforce_budget()
        seen = {mid: e.resident for mid, e in cat.entries.items()}
        # The evicted model answers again, staged back in.
        ans = _post(server, "/m/d/synonyms", {"word": "w6", "num": 10})
        return seen, ans, d.resident
    finally:
        _restore(server)


def case_pins(server, dirs):
    cat = server.catalog
    b, d = cat.get("b"), cat.get("d")
    try:
        for e in (b, d):
            cat.ensure_resident(e)
        pinned = _post(server, "/models/pin", {"model": "b", "pinned": True})
        unknown = _post(server, "/models/pin", {"model": "nope"})[0]
        cat.budget_bytes = 1  # nothing fits: every unpinned model goes
        cat.enforce_budget()
        seen = (b.resident, cat.default.resident, d.resident, cat.evict(b),
                cat.evict(cat.default))
        unpinned = _post(server, "/models/pin", {"model": "b", "pinned": False})
        return pinned, unknown, seen, unpinned, b.pins, cat.default.pins
    finally:
        _restore(server)


def case_budget_accounting(server, dirs):
    cat = server.catalog
    d = cat.get("d")
    try:
        cat.ensure_resident(d)
        total0, d_bytes = cat.resident_bytes(), d.resident_bytes()
        snap0 = cat.snapshot()
        evicted = cat.evict(d)
        after = (d.resident, d.resident_bytes(), d.cost_bytes == d_bytes,
                 cat.resident_bytes() == total0 - d_bytes,
                 cat.evict(d))
        cat.ensure_resident(d)
        snap1 = cat.snapshot()
        return (d_bytes > 0, evicted, after, d.resident,
                cat.resident_bytes() == total0,
                {k: snap1[k] - snap0[k] for k in
                 ("evictions_total", "stage_ins_total", "cold_hits_total",
                  "resident_models")},
                snap1["stage_in_seconds_total"] >= snap0["stage_in_seconds_total"])
    finally:
        _restore(server)


def case_concurrent_stage_in(server, dirs):
    cat = server.catalog
    d = cat.get("d")
    try:
        cat.ensure_resident(d)
        assert cat.evict(d)
        stage_ins0 = d.stage_ins
        results = [None] * 8

        def hit(i):
            results[i] = _post(server, "/m/d/synonyms", {"word": "w3", "num": 10})

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        return results, d.stage_ins - stage_ins0, d.resident
    finally:
        _restore(server)


def case_per_model_reload(server, dirs):
    _, before = _get(server, "/metrics")
    reload = _post(server, "/m/b/reload",
                   {"dir": dirs["b"][1], "generation": "gen-000002"})
    b_top = _post(server, "/m/b/synonyms", {"word": "w5", "num": 10})
    a_top = _post(server, "/synonyms", {"word": "w5", "num": 10})
    _, after = _get(server, "/metrics")
    out = (reload, b_top, a_top,
           after["hot_swap"]["table_swaps_total"]
           - before["hot_swap"]["table_swaps_total"],
           after["models"]["b"]["hot_swap"]["generation"],
           after["models"]["d"]["hot_swap"]["table_swaps_total"]
           - before["models"]["d"]["hot_swap"]["table_swaps_total"],
           server.catalog.get("b").source_dir == dirs["b"][1],
           _post(server, "/m/d/reload", {})[0])
    # Back to gen-000001 for the other cases.
    _post(server, "/m/b/reload", {"dir": dirs["b"][0], "generation": "gen-000001"})
    return out


def case_models_document(server, dirs):
    _, doc = _get(server, "/models")
    cat = dict(doc["catalog"])
    for k in ("stage_in_seconds_total", "query_program_builds",
              "shared_program_hits", "resident_bytes", "budget_bytes"):
        cat.pop(k)
    # How many of the concurrent requests found their model still cold
    # depends on the threads' timing, on either side.
    cold = cat.pop("cold_hits_total")
    return doc["default"], doc["models"], cat, cold >= cat["stage_ins_total"]


CASES = {f.__name__[len("case_"):]: f for f in (
    case_routing, case_per_model_metrics, case_cache_isolation,
    case_same_shape_adds_no_builds, case_lru_eviction_order, case_pins,
    case_budget_accounting, case_concurrent_stage_in, case_per_model_reload,
    case_models_document,
)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_catalog_matches_the_jax_server(servers, dirs, case):
    got = {name: CASES[case](s, dirs) for name, s in servers.items()}
    assert _answers_equal(got["jax"], got["torch"]), got


def test_catalog_cases_see_what_the_jax_tests_assert(servers, dirs):
    """The port's own answers to the JAX test file's assertions (the
    parity cases above would pass on two equally wrong servers)."""
    s = servers["torch"]
    routes = case_routing(s, dirs)
    assert routes[("/m/nope/synonyms", "None")][0] == 404
    assert routes[("/m/d/synonyms", "{'X-Glint-Model': 'b'}")] == \
        routes[("/m/d/synonyms", "None")]  # the prefix wins
    assert routes[("/m/b/synonyms", "None")][1] != routes[("/synonyms", "None")][1]
    seen, ans, resident = case_lru_eviction_order(s, dirs)
    assert seen["d"] is False and seen["b"] is True and seen[DEFAULT_MODEL_ID]
    assert ans[0] == 200 and resident
    results, stage_ins, _ = case_concurrent_stage_in(s, dirs)
    assert all(r[0] == 200 for r in results) and stage_ins == 1
    n, post_warmup, shared, ans = case_same_shape_adds_no_builds(s, dirs)
    assert (n, post_warmup, shared, ans[0]) == (0, 0, True, 200)


SPLIT_CASES = [("/synonyms", None), ("/m/b/synonyms", None), ("/m/b", None),
               ("/m/b/vector", "c"), ("/vector", "c"), ("/m//synonyms", None),
               ("/m/", None), ("/models/pin", "x")]


@pytest.mark.parametrize("path,header", SPLIT_CASES)
def test_split_model_path_matches(path, header):
    assert split_model_path(path, header) == jax_split(path, header)


BUDGET_CASES = [None, 0, -5, 4096, 1.5, "", "4096", "2kb", "1mb", "1.5gb",
                "3g", "7k", "12b", " 64MB ", "lots"]


@pytest.mark.parametrize("value", BUDGET_CASES, ids=repr)
def test_parse_memory_budget_matches(value):
    def run(fn):
        try:
            return fn(value)
        except ValueError:
            return "ValueError"

    assert run(parse_memory_budget) == run(jax_budget)
