"""The port's serving observability against the JAX package's: request
traces and their tail sampler (obs/events.py), the SLO engine, the shed
burst detector and the flight recorder (obs/slo.py), ``ServingMetrics``
(utils/metrics.py) and ``serving_to_prometheus`` (obs/prometheus.py), and
the server's ``/metrics``, ``/trace`` and request traces.

* ``serving_to_prometheus`` of one snapshot dict is the JAX renderer's
  text byte for byte, exemplars, SLO, per-model and catalog blocks
  included, and passes both packages' ``lint_prometheus_text``.
* ``ServingMetrics.snapshot`` after the same recorded sequence is the JAX
  dict; the wall clock its age fields read is injected.
* ``SloEngine`` and ``ShedBurstDetector`` under one injected clock give
  equal snapshots, fast-burn transitions and burst edges; flight bundles
  hold the same files.
* ``RequestTrace`` keeps and drops the same requests under the same
  ``GLINT_TRACE_SAMPLE`` and ``GLINT_TRACE_SLOW_MS``, read at import.
* A port server records a kept request's phases under its trace id,
  answers them on ``/trace`` and names the trace as the latency exemplar.

Tolerances: text, dicts, decisions and names compare exactly.
"""

import itertools
import json
import os
import signal
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

from glint_word2vec_tpu.obs import events as jevents
from glint_word2vec_tpu.obs import prometheus as jprom
from glint_word2vec_tpu.obs import slo as jslo
from glint_word2vec_tpu.utils import metrics as jmetrics

from glint_word2vec_torch.obs import events as pevents
from glint_word2vec_torch.obs import prometheus as pprom
from glint_word2vec_torch.obs import slo as pslo
from glint_word2vec_torch.utils import metrics as pmetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_PATHS = ("/synonyms", "/synonyms_vector", "/analogy", "/vector",
                "/transform")


class Clock:
    """An injected clock both packages read."""

    def __init__(self, t=1_000_000.0):
        self.t = t

    def __call__(self):
        return self.t


def _record(m, clock):
    """One sequence of serving events on a ``ServingMetrics``, the clock
    marching between them."""
    for i in range(40):
        clock.t += 0.5
        status = 200 if i % 7 else (504 if i % 2 else 429)
        m.observe(DEVICE_PATHS[i % 5], 0.001 * (i + 1) ** 1.5, status=status,
                  trace_id=f"{i:016x}" if i % 3 == 0 else None)
    m.observe("/healthz", 0.0002)
    for size in (1, 1, 3, 16, 64, 64):
        m.record_batch(size)
    for hit in (True, False, False, True, True):
        m.record_cache(hit)
    m.record_shed("admission")
    m.record_shed("degraded")
    m.record_shed("degraded")
    m.record_deadline()
    m.record_degraded_entered()
    for n in (3, 9, 4):
        m.record_inflight(n)
    m.record_swap("gen-000002", ok=True)
    m.record_swap("gen-000003", ok=False)
    m.record_watch_error()
    m.record_index_refresh(
        {"enabled": True, "clusters": 64, "member_slots": 128,
         "build_seconds": 0.25, "spilled_rows": 3, "updated_rows": 0},
        0.98765, True, 0.95, 8)
    m.record_ann_query(12, 8)
    m.record_exact_fallback(2, "requested")
    m.record_exact_fallback(1, "gate")
    clock.t += 30.0


def _metrics_pair(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(time, "time", clock)
    out = []
    for mod, slo in ((jmetrics, jslo), (pmetrics, pslo)):
        m = mod.ServingMetrics()
        m.slo = slo.SloEngine.default_serving(DEVICE_PATHS, now_fn=clock)
        m.warmup_compiles = 5
        clock.t = 1_000_000.0
        _record(m, clock)
        out.append(m.snapshot(
            9, checkpoint={"pending_async_saves": 1,
                           "last_checkpoint_age_seconds": 12.5,
                           "checkpoint_write_seconds": 0.75},
            index_staleness=2))
    return out


def test_serving_metrics_snapshot_equals_the_jax_one(monkeypatch):
    jsnap, psnap = _metrics_pair(monkeypatch)
    assert psnap == jsnap
    assert psnap["overload"] == {
        "shed_admission_total": 1, "shed_degraded_total": 2,
        "deadline_504_total": 1, "degraded_entered_total": 1,
        "inflight_peak": 9}
    assert psnap["hot_swap"]["last_swap_age_seconds"] == 30.0
    assert psnap["endpoints"]["/synonyms"]["exemplar"]["trace_id"]


def test_serving_metrics_caps_tracked_paths():
    for mod in (jmetrics, pmetrics):
        m = mod.ServingMetrics()
        for i in range(mod.ServingMetrics.MAX_PATHS + 10):
            m.observe(f"/probe{i}", 0.001, status=404)
        eps = m.snapshot()["endpoints"]
        assert len(eps) == mod.ServingMetrics.MAX_PATHS + 1
        assert eps["_other"]["count"] == 10


def _full_snapshot(monkeypatch):
    """A snapshot with every block the renderer reads: a recorded
    sequence, then per-model and catalog blocks as the JAX catalog
    server adds them."""
    snap, _ = _metrics_pair(monkeypatch)
    snap["models"] = {
        "default": {**snap, "resident_replicas": 1, "resident_bytes": 4096,
                    "pinned": True, "stage_ins_total": 0,
                    "evictions_total": 0},
        "b": {"endpoints": {"/synonyms": {"count": 3, "errors": 1}},
              "synonym_cache": {"hits": 2, "misses": 1},
              "compiles": {"post_warmup": 0},
              "hot_swap": {"table_swaps_total": 1, "swap_failures_total": 0,
                           "generation": "gen-000007"},
              "resident_replicas": 0, "resident_bytes": 0, "pinned": False,
              "stage_ins_total": 2, "evictions_total": 3},
    }
    snap["catalog"] = {"models": 2, "resident_models": 1, "budget_bytes": None,
                       "resident_bytes": 4096, "evictions_total": 3,
                       "stage_ins_total": 2, "stage_in_seconds_total": 0.5,
                       "cold_hits_total": 4, "query_program_builds": 11,
                       "shared_program_hits": 9}
    return snap


@pytest.mark.parametrize("blocks", ["bare", "served", "full"])
def test_serving_prometheus_text_is_byte_identical(monkeypatch, blocks):
    if blocks == "bare":
        snap = jmetrics.ServingMetrics().snapshot()
    elif blocks == "served":
        snap, _ = _metrics_pair(monkeypatch)
    else:
        snap = _full_snapshot(monkeypatch)
    text = pprom.serving_to_prometheus(json.loads(json.dumps(snap)))
    assert text.encode() == jprom.serving_to_prometheus(snap).encode()
    pprom.lint_prometheus_text(text)
    jprom.lint_prometheus_text(text)
    if blocks != "bare":
        assert ' # {trace_id="' in text  # an exemplar
        assert "glint_slo_burn_rate{" in text
    if blocks == "full":
        assert 'glint_model_requests_total{model="b"' in text
        assert "glint_catalog_models 2" in text


def test_prom_sample_exemplar_suffix():
    for mod in (jprom, pprom):
        p = mod._Prom()
        p.sample("x_count", {"path": "/a"}, 3,
                 exemplar={"trace_id": "ab", "value": 0.25})
        p.sample("y", None, 1, exemplar={"trace_id": None})
        assert p.lines == ['x_count{path="/a"} 3 # {trace_id="ab"} 0.25', "y 1"]


def test_slo_engine_and_burst_detector_match_the_jax_ones():
    clock = Clock(50_000.0)
    engines = [m.SloEngine.default_serving(DEVICE_PATHS, now_fn=clock)
               for m in (jslo, pslo)]
    bursts = [m.ShedBurstDetector(threshold=5, window_seconds=10.0, now_fn=clock)
              for m in (jslo, pslo)]
    transitions = [[], []]
    edges = [[], []]
    rng = np.random.default_rng(3)
    for step in range(3000):
        clock.t += 1.5
        # A healthy stretch, a cliff of 5xx and slow answers, recovery.
        bad = 1200 <= step < 1700
        path = DEVICE_PATHS[int(rng.integers(5))]
        status = 503 if bad and rng.random() < 0.5 else 200
        secs = 0.4 if bad and rng.random() < 0.5 else 0.01
        for i in range(2):
            engines[i].observe(path, secs, status)
            engines[i].observe("/healthz", 9.0, 500)  # no objective: ignored
            transitions[i].append(engines[i].fast_burn_transitions())
            edges[i].append(bursts[i].note() if bad or step % 50 == 0 else None)
        if step % 250 == 0:
            assert engines[1].snapshot() == engines[0].snapshot()
    assert transitions[1] == transitions[0]
    assert edges[1] == edges[0]
    assert any(transitions[0]) and any(e for e in edges[0])
    assert engines[1].snapshot() == engines[0].snapshot()
    merged = [m.merge_slo_snapshots([e.snapshot(), e.snapshot()])
              for m, e in zip((jslo, pslo), engines)]
    assert merged[1] == merged[0]
    assert pslo._burn(3, 100, 0.99) == jslo._burn(3, 100, 0.99)
    assert pslo._burn(0, 0, 0.99) == pslo._burn(1, 10, 1.0) == 0.0


def test_flight_recorder_bundles_match_the_jax_ones(tmp_path):
    clock = Clock()
    out = []
    for name, mod in (("jax", jslo), ("torch", pslo)):
        fl = mod.FlightRecorder(str(tmp_path / name), window_seconds=5.0,
                                min_interval_seconds=60.0, now_fn=clock)
        fl.add_source("spans", lambda w: {"window": w})
        fl.add_source("broken", lambda w: 1 / 0)
        first = fl.trigger("shed burst", shed_reason="admission")
        suppressed = fl.trigger("slo_fast_burn")
        clock.t += 61.0
        second = fl.trigger("slo_fast_burn", endpoint="/synonyms")
        meta = json.load(open(os.path.join(first, "meta.json")))
        meta.pop("wall_time")
        out.append((os.path.basename(first), suppressed,
                    os.path.basename(second), sorted(os.listdir(first)), meta,
                    {k: v for k, v in fl.stats().items() if k != "out_dir"}))
        clock.t -= 61.0
    assert out[1] == out[0]
    assert out[0][0] == "flightrec-001-shed-burst"


def _decisions(mod, rec, statuses, slow):
    """Keep/drop of one request per status; ``slow`` marks requests whose
    start is moved a second back."""
    out = []
    for i, st in enumerate(statuses):
        tr = mod.request_trace(f"{i:016x}", rec=rec)
        with tr.phase("req.accept", path="/synonyms"):
            pass
        if slow[i]:
            tr._t0 -= 1.0
        out.append(tr.finish(st))
    return out


@pytest.mark.parametrize("every,slow_ms", [(32, 250.0), (4, 500.0), (1, 250.0)])
def test_tail_sampler_keeps_the_same_requests(monkeypatch, every, slow_ms):
    rng = np.random.default_rng(every)
    statuses = [int(s) for s in rng.choice([200, 200, 200, 404, 429, 504], 200)]
    slow = [bool(x) for x in rng.random(200) < 0.05]
    got = []
    for mod in (jevents, pevents):
        monkeypatch.setattr(mod, "_TRACE_SAMPLE_EVERY", every)
        monkeypatch.setattr(mod, "_TRACE_SLOW_MS", slow_ms)
        monkeypatch.setattr(mod, "_sample_counter", itertools.count())
        rec = mod.EventRecorder()
        kept = _decisions(mod, rec, statuses, slow)
        ring = [(e["name"], e["args"]["trace"], e["args"].get("status"))
                for e in rec.events()]
        got.append((kept, ring))
    assert got[1] == got[0]
    kept = got[0][0]
    assert all(k for k, s, sl in zip(kept, statuses, slow) if s >= 400 or sl)
    assert sum(kept) < len(kept) or every == 1


def test_sampler_settings_are_read_from_the_environment():
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from glint_word2vec_tpu.obs import events as j\n"
        "from glint_word2vec_torch.obs import events as p\n"
        "print(json.dumps([[m._TRACE_SAMPLE_EVERY, m._TRACE_SLOW_MS]"
        " for m in (j, p)]))\n" % REPO
    )
    for env, want in (({"GLINT_TRACE_SAMPLE": "7", "GLINT_TRACE_SLOW_MS": "12.5"},
                       [7, 12.5]),
                      ({"GLINT_TRACE_SAMPLE": "0"}, [1, 250.0]),
                      ({}, [32, 250.0])):
        e = {k: v for k, v in os.environ.items()
             if not k.startswith("GLINT_TRACE")}
        e.update(env)
        out = subprocess.run([sys.executable, "-c", code], env=e, check=True,
                             capture_output=True, text=True, timeout=120)
        assert json.loads(out.stdout) == [want, want]


def test_null_trace_carries_the_id_without_a_recorder():
    for mod in (jevents, pevents):
        tr = mod.request_trace("feed", rec=None) if mod.get_recorder() is None \
            else mod.NullRequestTrace("feed")
        assert tr.trace_id == "feed" and tr.finish(500) is False
        assert len(mod.mint_trace_id()) == 16
        assert mod.TRACE_HEADER == "X-Glint-Trace"
    assert set(pevents.REQUEST_SPANS) == set(jevents.REQUEST_SPANS)


def test_recent_events_window():
    for mod in (jevents, pevents):
        rec = mod.EventRecorder()
        rec.event("old")
        rec._ring[0]["ts"] -= 10e6  # ten seconds earlier
        rec.event("new")
        assert [e["name"] for e in rec.recent_events(5.0)] == ["new"]
        assert rec.mono_t0 == rec._t0


# ----------------------------------------------------------------------
# The server's /metrics, /trace and request traces
# ----------------------------------------------------------------------

WORDS = ["austria", "vienna", "germany", "berlin"] + [f"w{i}" for i in range(28)]


@pytest.fixture()
def server():
    from glint_word2vec_torch.convert import model_from_arrays
    from glint_word2vec_torch.serving import ModelServer
    from glint_word2vec_torch.utils.params import Word2VecParams

    rng = np.random.default_rng(1)
    V, d = len(WORDS), 8
    model = model_from_arrays(
        WORDS, rng.normal(size=(V, d)).astype(np.float32),
        np.zeros((V, d), np.float32), np.arange(V, 0, -1),
        Word2VecParams(vector_size=d, min_count=1), device="cpu")
    prev = pevents.set_recorder(pevents.EventRecorder())
    switch = sys.getswitchinterval()
    srv = ModelServer(model, port=0, warmup=False)
    # Embedded beside other work: the process's switch interval stays.
    srv.start_background()
    assert sys.getswitchinterval() == switch
    yield srv
    srv.stop()
    assert sys.getswitchinterval() == switch
    pevents.set_recorder(prev)
    model.stop()


def test_switch_interval_tightened_only_when_the_server_owns_the_process():
    from glint_word2vec_torch.convert import model_from_arrays
    from glint_word2vec_torch.serving import ModelServer
    from glint_word2vec_torch.utils.params import Word2VecParams

    V, d = len(WORDS), 8
    model = model_from_arrays(
        WORDS, np.ones((V, d), np.float32), np.zeros((V, d), np.float32),
        np.arange(V, 0, -1), Word2VecParams(vector_size=d, min_count=1),
        device="cpu")
    switch = sys.getswitchinterval()
    srv = ModelServer(model, port=0, warmup=False)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        for _ in range(200):
            if sys.getswitchinterval() == 0.001:
                break
            time.sleep(0.01)
        assert sys.getswitchinterval() == 0.001
    finally:
        srv.stop()
        model.stop()
    th.join(timeout=30)
    # stop() gives the process its interval back.
    assert sys.getswitchinterval() == switch


def _post(srv, path, payload, headers=None):
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(srv, path, raw=False):
    with urllib.request.urlopen(f"http://{srv.host}:{srv.port}{path}",
                                timeout=30) as r:
        body = r.read()
        return body.decode() if raw else json.loads(body)


def test_a_traced_404_appears_on_trace(server):
    tid = "00c0ffee00c0ffee"
    assert _post(server, "/vector", {"word": "nope"},
                 {"X-Glint-Trace": tid})[0] == 404
    doc = _get(server, "/trace?seconds=60")
    mine = [e for e in doc["events"] if e.get("args", {}).get("trace") == tid]
    names = [e["name"] for e in mine]
    assert names[-1] == "req.accept" and "req.admission" in names
    assert mine[-1]["args"]["status"] == 404
    assert set(names) <= set(pevents.REQUEST_SPANS)
    assert doc["anchor"]["wall_t0"] > 0
    snap = _get(server, "/metrics")
    assert snap["endpoints"]["/vector"]["exemplar"]["trace_id"] == tid
    text = _get(server, "/metrics?format=prometheus", raw=True)
    pprom.lint_prometheus_text(text)
    assert f'# {{trace_id="{tid}"}}' in text


def test_coalesced_requests_record_their_phases_and_the_dispatch(server):
    tids = [f"{i:016x}" for i in range(1, 9)]
    codes = [None] * len(tids)

    def ask(i):
        # Force-kept: an unknown vector shape answers 400.
        codes[i] = _post(server, "/synonyms_vector",
                         {"vector": [0.0] * (3 if i % 2 else 8), "num": 3},
                         {"X-Glint-Trace": tids[i]})[0]

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(tids))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert codes == [200 if i % 2 == 0 else 400 for i in range(len(tids))]
    events = _get(server, "/trace?seconds=60")["events"]
    dispatched = {t for e in events if e["name"] == "req.dispatch"
                  for t in e["args"]["traces"]}
    assert dispatched  # the dispatch lane names the traces it carried
    kept_400 = {e["args"]["trace"] for e in events
                if e["name"] == "req.accept" and e["args"]["status"] == 400}
    assert kept_400 == set(tids[1::2])


def test_metrics_json_counts_every_request(server):
    for _ in range(3):
        _post(server, "/synonyms", {"word": "austria", "num": 2})
    _post(server, "/analogy", {"positive": ["vienna", "germany"],
                               "negative": ["austria"], "num": 2})
    _post(server, "/nowhere", {})
    _get(server, "/healthz")
    snap = _get(server, "/metrics")
    counts = {p: e["count"] for p, e in snap["endpoints"].items()}
    assert counts == {"/synonyms": 3, "/analogy": 1, "/nowhere": 1, "/healthz": 1}
    assert snap["synonym_cache"] == {"hits": 2, "misses": 1}
    assert snap["coalesced_batch_sizes"] == {"1": 1}
    assert snap["model_id"] == "default"
    assert set(snap["slo"]["endpoints"]) == set(DEVICE_PATHS)


def test_shed_burst_writes_a_flight_bundle(server, tmp_path):
    fl = server.enable_flight_recorder(str(tmp_path / "flight"))
    server._shed_burst = pslo.ShedBurstDetector(threshold=3)
    server.max_inflight = 1
    server._inflight = 1  # every device request sheds
    try:
        for _ in range(4):
            assert _post(server, "/synonyms", {"word": "austria"})[0] == 429
    finally:
        server._inflight = 0
    bundles = os.listdir(tmp_path / "flight")
    assert bundles == ["flightrec-001-shed_burst"]
    files = sorted(os.listdir(tmp_path / "flight" / bundles[0]))
    assert files == ["meta.json", "metrics.json", "spans.json"]
    meta = json.load(open(tmp_path / "flight" / bundles[0] / "meta.json"))
    assert meta["sources"] == {"metrics": "ok", "spans": "ok"}
    assert fl.stats()["triggered_total"] == 1


def test_serve_model_dir_traces_and_restores_the_recorder(tmp_path):
    from glint_word2vec_torch.convert import model_from_arrays
    from glint_word2vec_torch.serving import serve_model_dir
    from glint_word2vec_torch.utils.params import Word2VecParams

    rng = np.random.default_rng(2)
    V, d = len(WORDS), 8
    model = model_from_arrays(
        WORDS, rng.normal(size=(V, d)).astype(np.float32),
        np.zeros((V, d), np.float32), np.arange(V, 0, -1),
        Word2VecParams(vector_size=d, min_count=1), device="cpu")
    model.save(str(tmp_path / "m"))
    model.stop()
    prev = pevents.get_recorder()
    port_file, log = tmp_path / "port.json", tmp_path / "trace.jsonl"
    th = threading.Thread(target=serve_model_dir, args=(str(tmp_path / "m"),), kwargs=dict(
        port=0, port_file=str(port_file), device="cpu", warmup=False,
        trace_log=str(log), flight_dir=str(tmp_path / "flight"), max_inflight=3,
        request_deadline=2.5, degraded_after=1.5), daemon=True)
    th.start()
    for _ in range(600):
        if port_file.exists():
            break
        time.sleep(0.05)
    info = json.load(open(port_file))
    assert set(info) == {"host", "port", "fleet_generation"}

    class Srv:
        host, port = info["host"], info["port"]

    h = _get(Srv, "/healthz")
    assert (h["max_inflight"], h["request_deadline_seconds"],
            h["degraded_after_seconds"]) == (3, 2.5, 1.5)
    assert _post(Srv, "/synonyms", {"word": "zzz"}, {"X-Glint-Trace": "beef"})[0] == 404
    assert any(e.get("args", {}).get("trace") == "beef"
               for e in _get(Srv, "/trace")["events"])
    assert _post(Srv, "/shutdown", {})[0] == 200
    th.join(timeout=60)
    assert not th.is_alive()
    assert pevents.get_recorder() is prev
    lines = [json.loads(x) for x in open(log)]
    assert lines[0]["name"] == "clock_anchor"
    assert any(e.get("args", {}).get("trace") == "beef" for e in lines)


def test_cli_serve_passes_the_overload_and_trace_flags(monkeypatch):
    from glint_word2vec_torch import cli, serving

    seen = {}
    monkeypatch.setattr(serving, "serve_model_dir",
                        lambda model, **kw: seen.update(model=model, **kw))
    assert cli.main(["serve", "--model", "m/", "--device", "cpu",
                     "--max-inflight", "9", "--request-deadline", "1.5",
                     "--degraded-after", "0", "--trace-log", "t.jsonl",
                     "--flight-dir", "fl/"]) == 0
    assert (seen["model"], seen["max_inflight"], seen["request_deadline"],
            seen["degraded_after"], seen["trace_log"], seen["flight_dir"]) == (
        "m/", 9, 1.5, 0.0, "t.jsonl", "fl/")
    seen.clear()
    cli.main(["serve", "--model", "m/", "--device", "cpu"])
    assert (seen["max_inflight"], seen["request_deadline"],
            seen["degraded_after"], seen["trace_log"], seen["flight_dir"]) == (
        256, 30.0, 5.0, None, None)


# ----------------------------------------------------------------------
# The fleet's traces: merge_trace_logs, a traced CPU fleet, the gang join
# ----------------------------------------------------------------------


def _write_lane(path, wall_t0, events, trace=None):
    anchor = {"name": "clock_anchor", "ph": "M", "ts": 0, "pid": 1234,
              "args": {"wall_t0": wall_t0, "mono_t0": 55.5}}
    if trace:
        anchor["args"]["trace"] = trace
    with open(path, "w") as f:
        f.write(json.dumps(anchor) + "\n")
        for ev in events:
            f.write(json.dumps(ev) + "\n")


def _merged_both(paths):
    from glint_word2vec_tpu.obs.aggregate import merge_trace_logs as jmerge

    from glint_word2vec_torch.obs.aggregate import merge_trace_logs

    doc = merge_trace_logs(paths)
    assert doc == jmerge(paths)
    return doc


def test_merge_trace_logs_rebases_and_stitches_as_the_jax_one(tmp_path):
    t0 = 1700000000.0
    bal = str(tmp_path / "balancer.jsonl")
    rep = str(tmp_path / "replica-0.jsonl")
    _write_lane(bal, t0, [
        {"name": "req.accept", "ph": "X", "ts": 100.0, "dur": 5000.0,
         "pid": 10, "tid": 1, "args": {"trace": "t1"}},
    ])
    # The replica's clock started 1 s later: its ts lands inside the
    # balancer's accept span once rebased.
    _write_lane(rep, t0 + 1.0, [
        {"name": "req.query", "ph": "X", "ts": 50.0, "dur": 200.0,
         "pid": 20, "tid": 2, "args": {"trace": "t1"}},
        {"name": "req.query", "ph": "X", "ts": 300.0, "dur": 200.0,
         "pid": 20, "tid": 2, "args": {"trace": "only-here"}},
    ])
    doc = _merged_both([bal, rep])
    other = doc["otherData"]
    assert doc["displayTimeUnit"] == "ms" and other["wall_t0"] == t0
    assert (other["trace_ids"], other["stitched_traces"]) == (2, 1)
    lanes = {e["args"]["name"] for e in doc["traceEvents"]
             if e["name"] == "process_name"}
    assert lanes == {"balancer", "replica-0"}
    q = next(e for e in doc["traceEvents"] if e["name"] == "req.query")
    assert q["ts"] == pytest.approx(1e6 + 50.0)
    ts = [e["ts"] for e in doc["traceEvents"] if e["ph"] != "M"]
    assert ts == sorted(ts)
    json.loads(json.dumps(doc))


def test_merge_trace_logs_skips_unanchored_and_torn_lines_as_the_jax_one(
        tmp_path):
    good = str(tmp_path / "good.jsonl")
    _write_lane(good, 1.0, [
        {"name": "req.accept", "ph": "X", "ts": 1.0, "dur": 2.0,
         "pid": 1, "tid": 1},
    ])
    with open(good, "a") as f:
        f.write('{"torn')
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as f:
        f.write('{"name": "no_anchor", "ph": "i", "ts": 1.0}\n')
        f.write('{"torn line')
    doc = _merged_both([good, bad, str(tmp_path / "missing.jsonl")])
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] != "M"]
    assert names == ["req.accept"]
    src = doc["otherData"]["sources"]
    assert "no clock_anchor" in src[bad]
    assert src[good] == "ok (1 torn line(s) skipped)"
    assert src[str(tmp_path / "missing.jsonl")].startswith("error")


def _fleet_pids(tag: bytes) -> dict:
    """Processes whose command line names ``tag``: fleet shards and
    replicas by pid."""
    out = {}
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read()
        except OSError:
            continue
        if tag in argv and (b"fleet-shard" in argv or b"serve\0" in argv):
            out[int(pid)] = argv
    return out


def _bundles(path):
    return [b for b in os.listdir(path) if b.startswith("flightrec-")]


def test_traced_cpu_fleet_stitches_lanes_and_writes_a_flight_bundle(tmp_path):
    """One CPU fleet through ``serve-fleet``: a live replica, a warm spare,
    two balancer processes, QoS and a trace directory. The parked spare,
    killed, writes the balancer's flight bundle and comes back parked; a
    tenant's flood is shed and readmits it; ``trace-merge`` of the
    directory after the shutdown has a lane per balancer process and per
    replica and traces stitched across them; nothing is left running."""
    from glint_word2vec_torch import cli
    from glint_word2vec_torch.convert import model_from_arrays
    from glint_word2vec_torch.utils.params import Word2VecParams

    rng = np.random.default_rng(3)
    V, d = len(WORDS), 8
    model = model_from_arrays(
        WORDS, rng.normal(size=(V, d)).astype(np.float32),
        np.zeros((V, d), np.float32), np.arange(V, 0, -1),
        Word2VecParams(vector_size=d, min_count=1), device="cpu")
    model.save(str(tmp_path / "m"))
    model.stop()
    trace_dir, port_file = tmp_path / "trace", tmp_path / "lb.json"
    # The fleet's temporary files (the shards' configurations among them)
    # under tmp_path, so its processes' command lines name it.
    (tmp_path / "tmp").mkdir()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO,
           "TMPDIR": str(tmp_path / "tmp")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "glint_word2vec_torch.cli", "serve-fleet",
         "--model", str(tmp_path / "m"), "--device", "cpu", "--replicas", "1",
         "--warm-spares", "1", "--balancer-procs", "2",
         "--qos-tenant-rate", "2", "--qos-tenant-burst", "2",
         "--autoscale-interval", "0.1", "--autoscale-up-window", "0.2",
         "--autoscale-cooldown", "0.5", "--autoscale-down-window", "600",
         "--trace-dir", str(trace_dir), "--port", "0",
         "--port-file", str(port_file), "--max-batch", "8",
         "--probe-interval", "0.1", "--breaker-open-seconds", "0.3",
         "--backoff-base", "0.2", "--replica-log-dir", str(tmp_path / "logs")],
        cwd=str(tmp_path), env=env, start_new_session=True)

    def doc():
        return _get(Lb, "/metrics")

    def wait(pred, what, timeout=120):
        for _ in range(int(timeout / 0.05)):
            if pred():
                return
            assert proc.poll() is None, f"serve-fleet exited {proc.returncode}"
            time.sleep(0.05)
        raise AssertionError(f"timed out waiting for {what}")

    try:
        wait(port_file.exists, "the fleet's port file")
        info = json.load(open(port_file))

        class Lb:
            host, port = info["host"], info["port"]

        d0 = doc()
        assert d0["holds"] == {"held": {"1": ["autoscale"]}}
        assert d0["autoscale"]["spares"] == 1 and d0["autoscale"]["live"] == 1
        assert d0["data_plane"]["balancer_procs"] == 2
        assert [s["up"] for s in d0["balancer_shards"]] == [True, True]
        pids = _fleet_pids(str(tmp_path).encode())
        assert sum(b"fleet-shard" in a for a in pids.values()) == 1
        # The parked spare killed: its breaker opens (a flight bundle), and
        # it is relaunched still parked.
        spare = next(p for p, a in pids.items() if b"replica-1.0.port" in a)
        os.kill(spare, signal.SIGKILL)
        wait(lambda: (trace_dir / "flight").is_dir()
             and _bundles(trace_dir / "flight"), "a flight bundle")
        wait(lambda: doc()["supervisor"]["replica_states"][1]["state"] == "up"
             and doc()["supervisor"]["restarts_total"] == 1, "the relaunch")
        d1 = doc()
        assert d1["holds"] == {"held": {"1": ["autoscale"]}}
        assert d1["replicas"][1]["breaker"]["held"]
        # One tenant's flood, shed at the edge for as long as it lasts:
        # the sheds readmit the spare.
        codes = []
        for _ in range(2000):
            codes.append(_post(Lb, "/synonyms", {"word": "austria", "num": 2},
                               {"X-Glint-Tenant": "flood"})[0])
            if len(codes) % 20 == 0 and doc()["autoscale"]["scale_ups_total"]:
                break
        assert 429 in codes and set(codes) <= {200, 429}
        assert doc()["autoscale"]["scale_ups_total"] == 1
        wait(lambda: doc()["replicas"][1]["breaker"]["state"] == "closed"
             and not doc()["replicas"][1]["breaker"]["held"], "readmission")
        # Unknown words answer 404 on fresh connections: kept at every hop
        # (a tenant each, inside its quota).
        for i in range(24):
            assert _post(Lb, "/synonyms", {"word": f"zz{i}"},
                         {"X-Glint-Tenant": f"t{i}"})[0] == 404
        d2 = doc()
        qos = d2["balancer"]["qos"]
        assert qos["shed_total"]["tenant_quota"] >= 1
        assert set(qos["per_tenant_shed_total"]) == {"flood"}
        assert all(s["stats"]["proxied_total"] > 0
                   for s in d2["balancer_shards"])
        text = _get(Lb, "/metrics?format=prometheus", raw=True)
        pprom.lint_prometheus_text(text)
        for fam in ("glint_fleet_shard_up", "glint_fleet_qos_shed_total",
                    "glint_fleet_autoscale_ups_total"):
            assert fam in text
        assert _post(Lb, "/shutdown", {})[0] == 200
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        for _ in range(200):
            if not _fleet_pids(str(tmp_path).encode()):
                break
            time.sleep(0.05)
        left = _fleet_pids(str(tmp_path).encode())
        # Replicas and shards run in sessions of their own: a failed run
        # must not leave them behind.
        for pid in left:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
    assert not left, "a fleet process was left"
    (bundle,) = _bundles(trace_dir / "flight")
    assert bundle.startswith("flightrec-001-breaker_open")
    meta = json.load(open(trace_dir / "flight" / bundle / "meta.json"))
    assert meta["context"] == {"replica": 1}
    assert set(meta["sources"]) == {"balancer", "replica_spans",
                                    "replica_metrics"}
    out = tmp_path / "merged.json"
    assert cli.main(["trace-merge", str(trace_dir), "--out", str(out)]) == 0
    merged = json.load(open(out))
    lanes = {e["args"]["name"] for e in merged["traceEvents"]
             if e["name"] == "process_name"}
    assert lanes == {"balancer", "balancer-shard-1", "replica-0", "replica-1"}
    assert merged["otherData"]["stitched_traces"] >= 1
    assert all(v.startswith("ok") for v in merged["otherData"]["sources"].values())


@pytest.mark.parametrize("stop", ["sigterm", "shutdown_then_sigterm"])
def test_a_stopped_replica_keeps_every_kept_span_in_its_trace_log(
        tmp_path, stop):
    """A ``cli serve`` replica stopped the way the fleet supervisor stops
    one (``terminate_process``: SIGTERM to its group, at once; or after
    the balancer's ``POST /shutdown`` answered) leaves every span it kept
    in its trace log: the 404s' root spans, each with its trace id."""
    from glint_word2vec_torch.convert import model_from_arrays
    from glint_word2vec_torch.parallel.supervisor import terminate_process
    from glint_word2vec_torch.utils.params import Word2VecParams

    rng = np.random.default_rng(5)
    V, d = len(WORDS), 8
    model = model_from_arrays(
        WORDS, rng.normal(size=(V, d)).astype(np.float32),
        np.zeros((V, d), np.float32), np.arange(V, 0, -1),
        Word2VecParams(vector_size=d, min_count=1), device="cpu")
    model.save(str(tmp_path / "m"))
    model.stop()
    port_file, log = tmp_path / "p.json", tmp_path / "replica.jsonl"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    proc = subprocess.Popen(
        [sys.executable, "-m", "glint_word2vec_torch.cli", "serve",
         "--model", str(tmp_path / "m"), "--device", "cpu", "--port", "0",
         "--port-file", str(port_file), "--trace-log", str(log),
         "--no-warmup"],
        cwd=str(tmp_path), env=env, start_new_session=True)
    tids = [f"{i:016x}" for i in range(1, 6)]
    try:
        for _ in range(1200):
            if port_file.exists():
                break
            assert proc.poll() is None, f"serve exited {proc.returncode}"
            time.sleep(0.05)
        info = json.load(open(port_file))

        class Srv:
            host, port = info["host"], info["port"]

        for tid in tids:
            assert _post(Srv, "/synonyms", {"word": "nope"},
                         {"X-Glint-Trace": tid})[0] == 404
        if stop == "shutdown_then_sigterm":
            assert _post(Srv, "/shutdown", {})[0] == 200
        terminate_process(proc, grace_seconds=10.0)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    roots = {}
    for line in open(log):
        ev = json.loads(line)
        args = ev.get("args", {})
        if ev["name"] == "req.accept" and "trace" in args:
            roots[args["trace"]] = args["status"]
    # (The /shutdown request may be a kept trace of its own.)
    assert {t: roots.get(t) for t in tids} == {tid: 404 for tid in tids}


def test_gang_status_server_joins_serving_replicas_lazily():
    """Both packages' gang servers scrape the same replica snapshot and a
    dead URL on each request: the live one merged, the dead one reported,
    never fatal; the exposition carries the serving families."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from glint_word2vec_tpu.obs.aggregate import GangStatusServer as JaxGang

    from glint_word2vec_torch.obs.aggregate import GangStatusServer

    m = pmetrics.ServingMetrics()
    m.slo = pslo.SloEngine.default_serving(DEVICE_PATHS)
    for lat in (0.001, 0.002):
        m.observe("/synonyms", lat, status=200)
    snap = m.snapshot(1)

    class Replica(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = json.dumps(snap).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    rep = ThreadingHTTPServer(("127.0.0.1", 0), Replica)
    threading.Thread(target=rep.serve_forever, daemon=True).start()
    live = f"http://127.0.0.1:{rep.server_address[1]}/metrics"
    dead = "http://127.0.0.1:1/metrics"
    rank = {"state": "running", "supervisor_generation": 0, "step": 10,
            "words_done": 100, "words_per_sec_rolling": 5.0,
            "step_time": 1.0, "epoch": 1}
    got = []
    try:
        for cls in (JaxGang, GangStatusServer):
            srv = cls(port=0, num_workers=1, serving_urls=[live, dead])
            srv.start()
            try:
                srv.update(0, {0: dict(rank)})

                class S:
                    host, port = "127.0.0.1", srv.port

                merged = _get(S, "/metrics")
                health = _get(S, "/healthz")
                text = _get(S, "/metrics?format=prometheus", raw=True)
                pprom.lint_prometheus_text(text)
                got.append((merged["serving"], merged["serving_sources"],
                            merged["slo"], health["status"],
                            sorted({ln.split("{")[0].split(" ")[0]
                                    for ln in text.splitlines()
                                    if ln.startswith(("glint_serving",
                                                      "glint_gang_slo"))})))
            finally:
                srv.stop()
    finally:
        rep.shutdown()
        rep.server_close()
    jax_side, port_side = got
    for g in got:
        for ep in g[0]["endpoints"].values():
            ep.pop("exemplar", None)
    assert jax_side[:4] == port_side[:4]
    serving, sources, slo, status, families = port_side
    assert serving["replicas"] == 1
    assert serving["endpoints"]["/synonyms"]["count"] == 2
    assert sources[live] == "ok" and sources[dead].startswith("error")
    assert status == "ok" and "/synonyms" in slo["endpoints"]
    assert "glint_serving_requests_total" in families
    assert "glint_gang_slo_burn_rate" in families
    assert set(jax_side[4]) <= set(families) | {"glint_serving_compiles_total"}
