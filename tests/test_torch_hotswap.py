"""Hot swap in the port's server (glint_word2vec_torch/serving.py:
``SnapshotWatcher``, ``reload_generation``, ``POST /reload``) under load,
ported from the JAX package's tests/test_hotswap.py with its crafted
``EXPECT`` tables: every generation's rows are one-hot directions, so each
``/synonyms`` answer names the generation that gave it, and a "mix" row
surfaces as top-1 if a query vector of one generation were ever ranked
against another's tables. Across a run under four hammering clients: no
dropped or 5xx response, no mix, no new query shape after the warmup, the
result cache emptied on a swap, and a word that did not exist at start
answering after its generation arrives.

Also: the watcher never loads a generation ``LATEST.json`` does not name,
backs off on transient read errors and marks a generation failed after
its strikes; geometry mismatches and corrupt generations are counted
failures with the old tables (and index) still serving; a bf16 generation
round-trips; a JAX-published generation is hot-swapped by the port's
server and answers the JAX model's top-1; ``serve_model_dir`` and the
CLI's ``serve --watch-checkpoint`` boot from the newest generation.
Answers are compared exactly (word identities)."""

import json
import os
import shutil
import subprocess
import sys
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

from glint_word2vec_tpu import Word2Vec as JaxWord2Vec
from glint_word2vec_tpu import load_model as jax_load_model
from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
from glint_word2vec_tpu.parallel.mesh import make_mesh
from glint_word2vec_tpu.streaming.publish import (
    SnapshotPublisher as JaxPublisher,
)

from glint_word2vec_torch.models import load_model
from glint_word2vec_torch.parallel.engine import EmbeddingEngine
from glint_word2vec_torch.serving import ModelServer, SnapshotWatcher
from glint_word2vec_torch.streaming.publish import (
    LATEST_NAME,
    SnapshotPublisher,
)
from glint_word2vec_torch.utils import atomic_write_json
from glint_word2vec_torch.utils.params import Word2VecParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["q", "a1", "a2", "mix", "f1", "f2", "f3", "f4"]
DIM = 16


def _e(i, scale=1.0):
    v = np.zeros(DIM, np.float32)
    v[i] = scale
    return v


def _tables(rows: dict, num_rows: int) -> np.ndarray:
    t = np.zeros((num_rows, DIM), np.float32)
    for idx, vec in rows.items():
        t[idx] = vec
    return t


class _Vocab:
    def __init__(self, words):
        self.words = list(words)


@pytest.fixture(scope="module")
def publish_dir(tmp_path_factory):
    """Three crafted generations, published by the port.

    gen1: q=e1, a1=e1          -> top-1 of q is a1
    gen2: q=e2, a2=e2, mix=e1  -> top-1 is a2; a stale gen1 q ranked here
                                  surfaces mix
    gen3: q=e8, fresh=e8 (a promoted word on an extra row), mix=e1+e2
    """
    pub = str(tmp_path_factory.mktemp("pub"))
    counts = np.arange(len(WORDS), 0, -1, dtype=np.int64) * 10
    eng = EmbeddingEngine(len(WORDS), DIM, counts, num_negatives=2, seed=5,
                          extra_rows=4, device="cpu")
    publisher = SnapshotPublisher(pub, eng, Word2VecParams(vector_size=DIM),
                                  keep=3)
    N = eng.num_rows
    base = {4: _e(4), 5: _e(5), 6: _e(6), 7: _e(7)}
    zeros = np.zeros((N, DIM), np.float32)
    eng.set_tables(_tables({**base, 0: _e(1), 1: _e(1), 2: _e(2), 3: _e(3)}, N),
                   zeros)
    publisher.publish(_Vocab(WORDS))
    eng.wait_pending_saves()
    eng.set_tables(_tables({**base, 0: _e(2), 1: _e(0), 2: _e(2), 3: _e(1)}, N),
                   zeros)
    publisher.publish(_Vocab(WORDS))
    eng.wait_pending_saves()
    fresh_row = eng.assign_extra_row("fresh")
    assert fresh_row == len(WORDS)
    mix3 = (_e(1) + _e(2)) / np.sqrt(2)
    eng.set_tables(_tables({**base, 0: _e(8), 1: _e(9), 2: _e(10), 3: mix3,
                            fresh_row: _e(8)}, N), zeros)
    publisher.publish(_Vocab(WORDS + ["fresh"]))
    eng.wait_pending_saves()
    _flip(pub, "gen-000001")  # the tests flip it forward by hand
    return pub


#: Generation -> the only legal top-1 for /synonyms of "q" there.
EXPECT = {"gen-000001": "a1", "gen-000002": "a2", "gen-000003": "fresh"}


def _flip(pub, gen):
    atomic_write_json(os.path.join(pub, LATEST_NAME),
                      {"generation": gen, "seq": int(gen.split("-")[1])})


def _post(server, path, payload, timeout=30):
    req = urllib.request.Request(
        f"http://{server.host}:{server.port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _health(server):
    with urllib.request.urlopen(
            f"http://{server.host}:{server.port}/healthz", timeout=30) as r:
        return json.loads(r.read())


def _load(pub, gen="gen-000001"):
    return load_model(os.path.join(pub, gen), device="cpu")


def _hammer_and_swap(server, pub, check_phase1=None):
    """Four clients hammer /synonyms of "q" while the pointer moves to
    gen 2, then gen 3. Returns (results, errors)."""
    results, errors = [], []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                code, out = _post(server, "/synonyms", {"word": "q", "num": 3})
            except Exception as e:  # a dropped connection
                errors.append(repr(e))
                continue
            results.append((code, out[0][0] if code == 200 and out else None))

    def wait_responses(n):
        deadline = time.monotonic() + 60
        while len(results) < n:
            assert time.monotonic() < deadline, "load stalled"
            time.sleep(0.01)

    def wait_generation(gen):
        deadline = time.monotonic() + 60
        while server.metrics.generation != gen:
            assert time.monotonic() < deadline, f"no swap to {gen}"
            time.sleep(0.01)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        wait_responses(25)
        if check_phase1:
            check_phase1()
        _flip(pub, "gen-000002")
        wait_generation("gen-000002")
        wait_responses(len(results) + 25)
        code, out = _post(server, "/synonyms", {"word": "q", "num": 3})
        assert (code, out[0][0]) == (200, "a2")  # the cache was emptied
        _flip(pub, "gen-000003")
        wait_generation("gen-000003")
        wait_responses(len(results) + 25)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    return results, errors


def _assert_clean(results, errors):
    assert errors == []
    assert all(code == 200 for code, _ in results), {c for c, _ in results}
    seen = {t for _, t in results}
    assert seen <= set(EXPECT.values()), seen
    assert "mix" not in seen and len(seen) >= 2, seen


def test_hotswap_under_load(publish_dir):
    pub = publish_dir
    _flip(pub, "gen-000001")
    model = _load(pub)
    server = ModelServer(model, port=0, cache_size=1024)
    server.watch(pub, poll_seconds=0.05, current="gen-000001")
    server.start_background()
    try:
        def phase1():
            code, _ = _post(server, "/synonyms", {"word": "fresh", "num": 3})
            assert code == 404
            _post(server, "/synonyms", {"word": "q", "num": 3})
            hits = _health(server)["coalescer"]["cache_hits"]
            _post(server, "/synonyms", {"word": "q", "num": 3})
            assert _health(server)["coalescer"]["cache_hits"] > hits
            assert _health(server)["generation"] == "gen-000001"

        results, errors = _hammer_and_swap(server, pub, phase1)
        code, _ = _post(server, "/synonyms", {"word": "fresh", "num": 3})
        assert code == 200
        code, out = _post(server, "/synonyms", {"word": "q", "num": 3})
        assert (code, out[0][0]) == (200, "fresh")
        _assert_clean(results, errors)
        m = server.metrics
        assert (m.table_swaps, m.swap_failures, m.generation) == (
            2, 0, "gen-000003")
        health = _health(server)
        assert health["post_warmup_compiles"] == 0  # across the swaps
        assert health["vocab_size"] == len(WORDS) + 1
        assert health["generation"] == "gen-000003"
        assert [s["generation"] for s in server.swap_history] == [
            "gen-000002", "gen-000003"]
        assert all(s["flip_seconds"] >= 0 for s in server.swap_history)
    finally:
        server.stop()
        model.stop()


def test_reload_endpoint_explicit_dir(publish_dir):
    pub = publish_dir
    _flip(pub, "gen-000001")
    model = _load(pub)
    server = ModelServer(model, port=0, warmup=False)
    server.start_background()
    try:
        code, out = _post(server, "/reload", {})
        assert code == 400 and "no watched publish dir" in out["error"]
        code, out = _post(server, "/reload", {"dir": os.path.join(pub, "gen-000002")})
        assert (code, out["status"], out["generation"]) == (
            200, "reloaded", "gen-000002")
        code, out = _post(server, "/synonyms", {"word": "q", "num": 3})
        assert (code, out[0][0]) == (200, "a2")
        code, out = _post(server, "/reload", {"dir": os.path.join(pub, "gen-999999")})
        assert code == 400
        assert server.metrics.swap_failures == 1
        code, out = _post(server, "/synonyms", {"word": "q", "num": 3})
        assert (code, out[0][0]) == (200, "a2")
        # With a watcher, {} polls now: the pointer names gen 1.
        server.watch(pub, poll_seconds=3600, current="gen-000002")
        code, out = _post(server, "/reload", {})
        assert (code, out["status"], out["generation"]) == (
            200, "reloaded", "gen-000001")
        code, out = _post(server, "/reload", {})
        assert (code, out["status"]) == (200, "unchanged")
    finally:
        server.stop()
        model.stop()


def test_reload_transient_staging_error_answers_503(publish_dir, monkeypatch):
    pub = publish_dir
    model = _load(pub)
    server = ModelServer(model, port=0, warmup=False)
    server.start_background()
    try:
        eng = model.engine

        def flaky(path):
            raise OSError("stale file handle")

        monkeypatch.setattr(eng, "stage_tables", flaky)
        req = urllib.request.Request(
            f"http://{server.host}:{server.port}/reload",
            data=json.dumps({"dir": os.path.join(pub, "gen-000002")}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 503 and e.value.headers["Retry-After"] == "1"
        assert (server.metrics.watch_errors, server.metrics.swap_failures) == (1, 0)
    finally:
        server.stop()
        model.stop()


def test_watcher_never_loads_unreferenced_generation(publish_dir):
    pub = publish_dir
    _flip(pub, "gen-000001")
    model = _load(pub)
    server = ModelServer(model, port=0, warmup=False)
    watcher = server.watch(pub, poll_seconds=3600, current="gen-000001")
    server.start_background()
    try:
        m = server.metrics
        assert watcher.poll_once() is None  # gen 3 exists, LATEST says 1
        assert m.table_swaps == 0
        with open(os.path.join(pub, LATEST_NAME), "w") as f:
            f.write("{torn")
        assert watcher.poll_once() is None
        assert (m.table_swaps, m.watch_errors) == (0, 1)
        assert watcher._backoff == SnapshotWatcher.BACKOFF_CAP  # poll > cap
        assert watcher.poll_once() is None  # inside the backoff: no read
        assert m.watch_errors == 1
        watcher._retry_at = 0.0
        _flip(pub, "gen-000002")
        assert watcher.poll_once() == "gen-000002"
        assert watcher._backoff == 0.0
        _flip(pub, "gen-777777")
        assert watcher.poll_once() is None
        assert (m.swap_failures, m.watch_errors) == (0, 2)  # strike 1
        watcher._retry_at = 0.0
        assert watcher.poll_once() is None
        assert m.swap_failures == 1  # strike 2: failed
        assert watcher.poll_once() is None
        assert m.swap_failures == 1  # not retried
        _flip(pub, "gen-000003")
        assert watcher.poll_once() == "gen-000003"
    finally:
        server.stop()
        model.stop()


def test_watcher_staging_read_errors_strike_out(publish_dir, monkeypatch):
    """OSError inside an existing generation directory is transient (a
    capped doubling backoff) until STAGING_ERROR_STRIKES in a row."""
    pub = publish_dir
    _flip(pub, "gen-000001")
    model = _load(pub)
    server = ModelServer(model, port=0, warmup=False)
    watcher = SnapshotWatcher(server, pub, poll_seconds=0.05)
    watcher.current = "gen-000001"
    server.watcher = watcher
    server.start_background()  # stop() joins the serve loop
    calls = []

    def failing(gen_dir, generation=None):
        calls.append(generation)
        raise OSError("transient")

    monkeypatch.setattr(server, "reload_generation", failing)
    try:
        _flip(pub, "gen-000002")
        backoffs = []
        for _ in range(SnapshotWatcher.STAGING_ERROR_STRIKES):
            watcher._retry_at = 0.0
            assert watcher.poll_once() is None
            backoffs.append(watcher._backoff)
        assert len(calls) == SnapshotWatcher.STAGING_ERROR_STRIKES
        assert backoffs[:3] == [0.05, 0.1, 0.2]
        m = server.metrics
        assert (m.watch_errors, m.swap_failures) == (
            SnapshotWatcher.STAGING_ERROR_STRIKES - 1, 1)
        watcher._retry_at = 0.0
        assert watcher.poll_once() is None and len(calls) == len(backoffs)
        watcher._backoff = 20.0
        watcher._watch_error_locked("x")
        assert watcher._backoff == SnapshotWatcher.BACKOFF_CAP
    finally:
        server.stop()
        model.stop()


def test_reload_rejects_geometry_mismatch(publish_dir, tmp_path):
    pub = publish_dir
    eng8 = EmbeddingEngine(4, 8, np.full(4, 10, np.int64), num_negatives=2,
                           seed=3, device="cpu")
    other = str(tmp_path / "otherpub")
    SnapshotPublisher(other, eng8, Word2VecParams(vector_size=8)).publish(
        _Vocab(["w", "x", "y", "z"]))
    eng8.wait_pending_saves()
    _flip(pub, "gen-000001")
    model = _load(pub)
    server = ModelServer(model, port=0, warmup=False)
    server.start_background()
    try:
        code, out = _post(server, "/reload", {"dir": os.path.join(other, "gen-000001")})
        assert code == 400 and "geometry" in out["error"]
        assert server.metrics.swap_failures == 1
        code, out = _post(server, "/synonyms", {"word": "q", "num": 2})
        assert (code, out[0][0]) == (200, "a1")
    finally:
        server.stop()
        model.stop()


def test_hotswap_with_ann_index_under_load(publish_dir):
    pub = publish_dir
    _flip(pub, "gen-000001")
    model = _load(pub)
    server = ModelServer(model, port=0, cache_size=1024, ann=True,
                         ann_recall_sample=8)
    assert server._ann_live, "tiny crafted tables must clear the gate"
    server.watch(pub, poll_seconds=0.05, current="gen-000001")
    server.start_background()
    try:
        results, errors = _hammer_and_swap(server, pub)
        code, out = _post(server, "/synonyms", {"word": "q", "num": 3})
        assert (code, out[0][0]) == (200, "fresh")
        _assert_clean(results, errors)
        assert (server.metrics.table_swaps, server.metrics.swap_failures) == (2, 0)
        # One index build and gate a swap, every generation gate-clean.
        assert all(s["recall_at10"] >= server.ann_recall_gate
                   for s in server.swap_history)
        health = _health(server)
        assert health["ann_enabled"] is True
        assert health["index"]["ann_queries_total"] > 0
        assert health["index"]["table_versions_behind"] == 0
        assert health["post_warmup_compiles"] == 0  # both query families
    finally:
        server.stop()
        model.stop()


def test_corrupt_generation_keeps_old_index_serving(publish_dir, tmp_path):
    pub = publish_dir
    _flip(pub, "gen-000001")
    bad = str(tmp_path / "gen-000009")
    shutil.copytree(os.path.join(pub, "gen-000002"), bad)
    with open(os.path.join(bad, "matrix", "counts.npy"), "ab") as f:
        f.write(b"x")  # the manifest's size no longer matches
    model = _load(pub)
    server = ModelServer(model, port=0, ann=True, ann_recall_sample=8)
    server.start_background()
    try:
        index = model.engine.ann_index
        for gen_dir in (bad, os.path.join(pub, "gen-999999")):
            code, _ = _post(server, "/reload", {"dir": gen_dir})
            assert code == 400
        assert server.metrics.swap_failures == 2
        assert model.engine.ann_index is index and not server.swap_history
        before = _health(server)["index"]["ann_queries_total"]
        code, out = _post(server, "/synonyms", {"word": "q", "num": 3})
        assert (code, out[0][0]) == (200, "a1")
        assert _health(server)["index"]["ann_queries_total"] == before + 1
    finally:
        server.stop()
        model.stop()


def test_bf16_generation_round_trip(tmp_path):
    Vv, d = 24, 16
    words = [f"w{i}" for i in range(Vv)]
    counts = np.arange(Vv, 0, -1, dtype=np.int64) * 5
    rng = np.random.default_rng(0)
    trainer = EmbeddingEngine(Vv, d, counts, num_negatives=2, seed=1,
                              dtype="bfloat16", device="cpu")
    syn0 = rng.normal(0, 1.0, (Vv, d)).astype(np.float32)
    trainer.set_tables(syn0, np.zeros_like(syn0))
    pub = str(tmp_path / "pub")
    SnapshotPublisher(pub, trainer, Word2VecParams(vector_size=d, dtype="bfloat16")
                      ).publish(_Vocab(words))
    trainer.wait_pending_saves()
    gen_matrix = os.path.join(pub, "gen-000001", "matrix")
    with open(os.path.join(gen_matrix, "manifest.json")) as f:
        assert json.load(f)["table_dtype"] == "bfloat16"
    with open(os.path.join(gen_matrix, "engine.json")) as f:
        assert json.load(f)["dtype"] == "bfloat16"
    server_eng = EmbeddingEngine(Vv, d, counts, num_negatives=2, seed=9,
                                 dtype="bfloat16", device="cpu")
    server_eng.adopt_tables(server_eng.stage_tables(gen_matrix))
    assert server_eng.syn0.dtype == torch.bfloat16
    assert torch.equal(server_eng.syn0, trainer.syn0)
    assert server_eng.norms().dtype == torch.float32
    upcast = server_eng.syn0.float().numpy()
    safe = np.linalg.norm(upcast, axis=1)
    for qi in (0, 3, 17):
        q = upcast[qi] / np.linalg.norm(upcast[qi])
        oracle = (upcast @ q) / safe
        rank = np.argsort(-oracle)[:5]
        sims, idx = server_eng.top_k_cosine(upcast[qi], 5)
        np.testing.assert_array_equal(idx, rank)
        np.testing.assert_allclose(sims, oracle[rank], rtol=1e-6, atol=1e-7)


def test_jax_published_generation_hot_swapped_by_port(publish_dir, tmp_path):
    """A generation the JAX package publishes (with a promoted row) swaps
    into the port's server and answers the JAX model's top-1."""
    counts = np.arange(len(WORDS), 0, -1, dtype=np.int64) * 10
    jeng = JaxEngine(make_mesh(1, 1), len(WORDS), DIM, counts, num_negatives=2,
                     seed=5, extra_rows=4)
    jpub = str(tmp_path / "jaxpub")
    rng = np.random.default_rng(3)
    row = jeng.assign_extra_row("fresh")
    jeng.set_tables(rng.normal(0, 1, (jeng.num_rows, DIM)).astype(np.float32),
                    np.zeros((jeng.num_rows, DIM), np.float32))
    JaxPublisher(jpub, jeng, JaxWord2Vec(vector_size=DIM).params).publish(
        _Vocab(WORDS + ["fresh"]))
    jeng.wait_pending_saves()
    jeng.destroy()
    gen = os.path.join(jpub, "gen-000001")
    jm = jax_load_model(gen)
    want = {w: jm.find_synonyms(w, 3)[0][0] for w in WORDS + ["fresh"]}
    jm.stop()
    _flip(publish_dir, "gen-000001")
    model = _load(publish_dir)
    server = ModelServer(model, port=0, warmup=False)
    server.watch(jpub, poll_seconds=3600)
    server.start_background()
    try:
        code, out = _post(server, "/reload", {})
        assert (code, out["generation"]) == (200, "gen-000001")
        assert model.vocab.size == len(WORDS) + 1 == row + 1
        for w, top1 in want.items():
            code, out = _post(server, "/synonyms", {"word": w, "num": 3})
            assert (code, out[0][0]) == (200, top1), w
    finally:
        server.stop()
        model.stop()


def _wait_port_file(path, proc=None, timeout=120):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        assert time.monotonic() < deadline, "server never became ready"
        if proc is not None:
            assert proc.poll() is None, proc.stderr.read()
        time.sleep(0.05)
    with open(path) as f:
        return json.load(f)


def test_serve_model_dir_boots_from_newest_generation(publish_dir, tmp_path):
    from glint_word2vec_torch.serving import serve_model_dir

    _flip(publish_dir, "gen-000002")
    port_file = str(tmp_path / "port.json")
    t = threading.Thread(target=serve_model_dir, args=(None,), kwargs=dict(
        port=0, warmup=False, port_file=port_file, device="cpu",
        watch_dir=publish_dir, watch_poll=0.05), daemon=True)
    t.start()
    addr = _wait_port_file(port_file)

    class S:
        host, port = addr["host"], addr["port"]

    try:
        assert _health(S)["generation"] == "gen-000002"
        code, out = _post(S, "/synonyms", {"word": "q", "num": 3})
        assert (code, out[0][0]) == (200, "a2")
        _flip(publish_dir, "gen-000003")
        deadline = time.monotonic() + 60
        while _health(S)["generation"] != "gen-000003":
            assert time.monotonic() < deadline
            time.sleep(0.05)
        code, out = _post(S, "/synonyms", {"word": "q", "num": 3})
        assert (code, out[0][0]) == (200, "fresh")
    finally:
        _post(S, "/shutdown", {})
        t.join(timeout=60)
        _flip(publish_dir, "gen-000001")
    assert not t.is_alive()
    with pytest.raises(ValueError, match="model_dir or watch_dir"):
        serve_model_dir(None, device="cpu")


def test_cli_serve_watch_checkpoint_boots_without_model(publish_dir, tmp_path):
    """``serve --watch-checkpoint`` with no ``--model``, in a child process
    with JAX poisoned: it boots from the newest generation."""
    pub = str(tmp_path / "pub")
    shutil.copytree(publish_dir, pub)
    _flip(pub, "gen-000003")
    port_file = str(tmp_path / "port.json")
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'glint_word2vec_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from glint_word2vec_torch import cli\n"
        "sys.exit(cli.main(sys.argv[1:]))\n"
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "serve", "--watch-checkpoint", pub,
         "--watch-poll", "0.1", "--port", "0", "--port-file", port_file,
         "--no-warmup", "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        addr = _wait_port_file(port_file, proc)

        class S:
            host, port = addr["host"], addr["port"]

        assert _health(S)["generation"] == "gen-000003"
        code_, out = _post(S, "/synonyms", {"word": "q", "num": 3})
        assert (code_, out[0][0]) == (200, "fresh")
        _post(S, "/shutdown", {})
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
