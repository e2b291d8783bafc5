"""The port's run observability against the JAX package's.

* ``DivergenceCanary`` trips at the same step with the same reason on
  the same loss sequences (NaN, Inf, explosions, a recovery), and
  ``ObsRun.observe_losses`` keeps the same check cadence and status.
* ``training_to_prometheus`` of one snapshot dict is the JAX renderer's
  text, line for line, and passes both packages' ``lint_prometheus_text``.
* ``TrainingStatus`` snapshots, ``/healthz`` and the status file carry
  the JAX package's keys; the ledger's phases and span map are its own.
* A port fit with an event log records the JAX package's span names; a
  canary abort writes ``ckpt-diverged`` and flips no ``train_state.json``;
  a crashed fit publishes ``failed``; ``cli train --canary abort`` exits 2
  with one line; the heartbeat answers mid-fit in both formats.

Tolerances: strings, keys and counts compare exactly.
"""

import copy
import json
import math
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_tpu import obs as jobs
from glint_word2vec_tpu.obs import canary as jcanary
from glint_word2vec_tpu.obs import heartbeat as jhb
from glint_word2vec_tpu.obs import prometheus as jprom
from glint_word2vec_tpu.utils import metrics as jmetrics

from glint_word2vec_torch import Word2Vec
from glint_word2vec_torch import obs as pobs
from glint_word2vec_torch.models import word2vec as w2v_mod
from glint_word2vec_torch.obs import canary as pcanary
from glint_word2vec_torch.obs import events as pevents
from glint_word2vec_torch.obs import heartbeat as phb
from glint_word2vec_torch.obs import prometheus as pprom
from glint_word2vec_torch.parallel.engine import EmbeddingEngine
from glint_word2vec_torch.utils import metrics as pmetrics

SMALL = [
    "the quick brown fox jumps over the lazy dog".split(),
    "the dog sleeps all day long in the sun".split(),
    "a quick fox and a lazy dog meet in the field".split(),
    "the sun rises over the field every day".split(),
] * 30


def _small(**kw):
    defaults = dict(vector_size=12, batch_size=32, min_count=1,
                    num_iterations=2, seed=7, steps_per_call=4, window=3)
    defaults.update(kw)
    return Word2Vec(device="cpu", **defaults)


def _loss_sequences():
    rng = np.random.default_rng(0)
    healthy = list(rng.uniform(2.0, 3.0, 40))
    return {
        "nan": healthy[:12] + [float("nan")] + healthy[12:20],
        "inf": healthy[:5] + [float("inf"), float("-inf")] + healthy[5:9],
        "explosion": healthy[:20] + [40.0, 2.5, 500.0, 2.4] + healthy[20:],
        "short_history": [1.0, 50.0, 2.0, 1.0, 1e6],
        "zero_median": [0.0] * 10 + [5.0],
        "healthy": healthy,
    }


@pytest.mark.parametrize("case", sorted(_loss_sequences()))
@pytest.mark.parametrize("window,factor", [(64, 10.0), (16, 3.0)])
def test_canary_trips_where_the_jax_canary_trips(case, window, factor):
    losses = _loss_sequences()[case]
    p = pcanary.DivergenceCanary(window=window, factor=factor)
    j = jcanary.DivergenceCanary(window=window, factor=factor)
    got = [p.check(step, x) for step, x in enumerate(losses)]
    want = [j.check(step, x) for step, x in enumerate(losses)]
    assert got == want
    assert (p.trips, p.last_reason, list(p.window)) == (
        j.trips, j.last_reason, list(j.window))
    if case in ("nan", "inf", "explosion"):
        assert p.trips > 0


@pytest.mark.parametrize("every", [1, 5])
def test_observe_losses_matches_the_jax_run(every):
    healthy = list(np.random.default_rng(1).uniform(2.0, 3.0, 80))
    seq = healthy[:72] + [400.0] * 8 + healthy[72:]
    groups = [np.asarray(seq[i:i + 4], np.float32) for i in range(0, len(seq), 4)]
    runs = [mod.ObsRun(mod.ObsConfig(canary="warn", canary_check_every=every))
            for mod in (pobs, jobs)]
    try:
        step = 0
        for g in groups:
            n = len(g) - 1  # a tail no-op step in every group
            for run in runs:
                run.observe_losses(step, g, n)
            assert runs[0].status.canary == runs[1].status.canary
            step += n
        assert runs[0].canary.trips == runs[1].canary.trips > 0
    finally:
        for run in runs:
            run.close()


def test_canary_abort_raises_the_port_error():
    run = pobs.ObsRun(pobs.ObsConfig(canary="abort", canary_check_every=1))
    try:
        with pytest.raises(pobs.TrainingDiverged, match="non-finite"):
            run.observe_losses(7, np.array([np.nan], np.float32), 1)
        assert run.status.state == "diverged"
    finally:
        run.close()
    assert run.status.state == "diverged"


class _StubEngine:
    """The engine surface the heartbeat reads, identical for both
    packages: a mutation counter, checkpoint stats and the replica
    exchange's counters (zeros before any round)."""

    table_version = 5
    device = torch.device("cpu")

    def exchange_stats(self):
        return {}

    def checkpoint_stats(self):
        return {"pending_async_saves": 1, "async_save_waits": 2,
                "checkpoint_write_seconds": 0.125,
                "last_checkpoint_age_seconds": 3.5,
                "checkpoint_shard_write_seconds": 0.0625}


def _statuses(recorder=True):
    """A port and a JAX TrainingStatus fed the same updates."""
    out = []
    for mod, hb, met, ev in ((pobs, phb, pmetrics, pevents),
                             (jobs, jhb, jmetrics, jobs.events)):
        m = met.TrainingMetrics()
        m.host_time, m.step_time, m.last_loss = 1.5, 4.5, float("nan")
        m.record_stall(0.75)
        ledger = met.StepTimeLedger()
        ledger.account("dispatch", 0.5)
        ledger.account("checkpoint", 0.25)
        st = hb.TrainingStatus(
            pipeline="device_corpus", total_epochs=3, total_words=900,
            metrics=m, engine=_StubEngine(), ledger=ledger,
            recorder=ev.EventRecorder(16) if recorder else None,
        )
        st.update(epoch=1, step=40, words_done=300, alpha=0.02, state="running")
        st.update(words_done=350)
        st.set_canary("warn", 1, "loss 40 at step 20")
        out.append(st)
    return out


def _masked(snap):
    snap = copy.deepcopy(snap)
    snap["uptime_seconds"] = snap["words_per_sec_rolling"] = 0
    snap["steptime"] = {k: v for k, v in snap["steptime"].items()
                        if k not in ("wall_seconds", "unattributed_seconds")}
    snap["steptime"]["phases"]["other"] = None
    return snap


def test_status_snapshot_and_prometheus_text_equal_the_jax_ones():
    p, j = _statuses()
    ps, js = p.snapshot(), j.snapshot()
    assert set(ps) == set(js)
    assert ps["device_memory"] == js["device_memory"] == {}  # the CPU
    assert _masked(ps) == _masked(js)
    # One snapshot dict through both renderers.
    text = pprom.training_to_prometheus(js)
    assert text == jprom.training_to_prometheus(js)
    pprom.lint_prometheus_text(text)
    jprom.lint_prometheus_text(text)
    for name in ("glint_training_device_stall_seconds",
                 "glint_training_pending_async_saves",
                 "glint_training_checkpoint_write_seconds",
                 'glint_training_steptime_seconds{phase="dispatch"}',
                 "glint_canary_trips_total 1"):
        assert name in text, name
    with pytest.raises(ValueError):
        pprom.lint_prometheus_text(text + "bad line\n")


def test_device_memory_stats_on_the_cpu_is_empty():
    assert phb.device_memory_stats(torch.device("cpu")) == {}
    assert phb.device_memory_stats("cpu") == {}


def test_ledger_and_span_map_are_the_jax_ones():
    assert pmetrics.LEDGER_PHASES == jmetrics.LEDGER_PHASES
    assert pobs._LEDGER_PHASE_OF == jobs._LEDGER_PHASE_OF
    assert set(pobs.ObsConfig.__dataclass_fields__) == set(
        jobs.ObsConfig.__dataclass_fields__)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_healthz_and_metrics_carry_the_jax_keys():
    p, j = _statuses(recorder=False)
    servers = [phb.HeartbeatServer(p), jhb.HeartbeatServer(j)]
    try:
        for s in servers:
            s.start()
        bodies = [json.loads(_get(f"http://127.0.0.1:{s.port}/healthz")[1])
                  for s in servers]
        assert set(bodies[0]) == set(bodies[1])
        assert bodies[0]["status"] == "ok"
        full = [json.loads(_get(f"http://127.0.0.1:{s.port}/metrics")[1])
                for s in servers]
        assert set(full[0]) == set(full[1])
        code, text = _get(f"http://127.0.0.1:{servers[0].port}/metrics?format=prometheus")
        assert code == 200
        jprom.lint_prometheus_text(text)
        assert _get(f"http://127.0.0.1:{servers[0].port}/nope")[0] == 404
        p.update(state="diverged")
        assert _get(f"http://127.0.0.1:{servers[0].port}/healthz")[0] == 503
    finally:
        for s in servers:
            s.stop()


def test_fit_status_file_carries_the_jax_keys(tmp_path):
    status = str(tmp_path / "status.json")
    m = _small(obs=pobs.ObsConfig(status_file=status, status_interval=0.0)).fit(
        SMALL, checkpoint_dir=str(tmp_path / "ck"))
    snap = json.loads(open(status).read())
    want = jhb.TrainingStatus(
        metrics=jmetrics.TrainingMetrics(), engine=_StubEngine(),
        ledger=jmetrics.StepTimeLedger()).snapshot()
    assert set(snap) == set(want)
    assert snap["state"] == "done" and snap["pipeline"] == "device_corpus"
    # The step counter also counts each epoch's tail no-op steps.
    with open(tmp_path / "ck" / "train_state.json") as f:
        last = json.load(f)["step"]
    assert m.training_metrics["steps"] <= snap["step"] <= last
    assert snap["words_done"] == m.training_metrics["words_done"]
    assert set(snap["steptime"]["phases"]) == set(jmetrics.LEDGER_PHASES)
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def _event_names(log):
    return {json.loads(line)["name"] for line in open(log) if line.strip()}


def test_fit_event_log_records_the_jax_span_names(tmp_path):
    from glint_word2vec_tpu import Word2Vec as JaxWord2Vec
    from glint_word2vec_tpu.parallel.mesh import make_mesh

    kw = dict(vector_size=12, batch_size=32, min_count=1, num_iterations=2,
              seed=7, steps_per_call=4, window=3, subsample_ratio=0.01)
    names = {}
    for who in ("port", "jax"):
        log = str(tmp_path / f"{who}.jsonl")
        trace = str(tmp_path / f"{who}.trace.json")
        cfg = (pobs if who == "port" else jobs).ObsConfig(
            event_log=log, chrome_trace=trace)
        if who == "port":
            m = Word2Vec(device="cpu", obs=cfg, **kw)
        else:
            m = JaxWord2Vec(mesh=make_mesh(1, 1), obs=cfg, **kw)
        m.fit(SMALL, checkpoint_dir=str(tmp_path / f"ck-{who}")).stop()
        names[who] = _event_names(log)
        doc = json.loads(open(trace).read())
        assert doc["traceEvents"] and {"name", "ph", "ts"} <= set(doc["traceEvents"][0])
    core = {"run_start", "run_end", "upload_corpus", "subsample_compact",
            "subsample_prefetch", "device_steps", "readback_harvest",
            "ckpt_snapshot", "ckpt_write", "table_mutation", "clock_anchor"}
    assert core <= names["port"]
    assert names["port"] <= names["jax"], names["port"] - names["jax"]
    assert pevents.get_recorder() is None


def test_host_route_event_log_and_subword_spans(tmp_path, monkeypatch):
    from glint_word2vec_torch import FastTextWord2Vec

    monkeypatch.setattr(w2v_mod, "_free_device_bytes", lambda device: 0)
    log = str(tmp_path / "events.jsonl")
    steptime = str(tmp_path / "STEPTIME.json")
    m = FastTextWord2Vec(
        device="cpu", obs=pobs.ObsConfig(event_log=log, steptime_path=steptime),
        vector_size=8, batch_size=32, min_count=1, num_iterations=1, seed=3,
        steps_per_call=4, window=3, bucket=50, min_n=3, max_n=4,
    ).fit(SMALL)
    assert m.training_metrics["pipeline"] == "host"
    m.find_synonyms("fox", 3)
    names = _event_names(log)
    assert {"host_batch", "device_steps", "readback_harvest",
            "subword_expand", "table_mutation"} <= names
    doc = json.loads(open(steptime).read())
    assert doc["schema_version"] == 1
    assert set(doc["phases"]) == set(jmetrics.LEDGER_PHASES)
    total = sum(p["seconds"] for p in doc["phases"].values())
    assert total == pytest.approx(doc["wall_seconds"], rel=0.05)
    assert doc["phases"]["producer_wait"]["count"] > 0


def _nan_steps(monkeypatch):
    real = EmbeddingEngine.train_steps_grouped

    def nan_losses(self, *a, **kw):
        return torch.full_like(real(self, *a, **kw), float("nan"))

    monkeypatch.setattr(EmbeddingEngine, "train_steps_grouped", nan_losses)


@pytest.mark.parametrize("route", ["device_corpus", "host"])
def test_canary_abort_writes_ckpt_diverged_and_no_state(tmp_path, monkeypatch,
                                                         route):
    if route == "host":
        monkeypatch.setattr(w2v_mod, "_free_device_bytes", lambda device: 0)
        _nan_steps(monkeypatch)
    else:
        real = EmbeddingEngine.packed_readback

        def nan_readback(out):
            losses, *rest = real(out)
            return (np.full_like(losses, np.nan), *rest)

        monkeypatch.setattr(EmbeddingEngine, "packed_readback",
                            staticmethod(nan_readback))
    ck = str(tmp_path / "ck")
    log = str(tmp_path / "events.jsonl")
    status = str(tmp_path / "status.json")
    obs = pobs.ObsConfig(event_log=log, status_file=status, status_interval=0.0,
                         canary="abort", canary_check_every=1)
    with pytest.raises(pobs.TrainingDiverged, match="non-finite"):
        _small(obs=obs).fit(SMALL, checkpoint_dir=ck)
    assert os.path.exists(os.path.join(ck, "ckpt-diverged", "manifest.json"))
    assert not os.path.exists(os.path.join(ck, "train_state.json"))
    events = [json.loads(line) for line in open(log) if line.strip()]
    trips = [e for e in events if e["name"] == "canary_trip"]
    assert trips and trips[0]["args"]["mode"] == "abort"
    assert json.loads(open(status).read())["state"] == "diverged"
    assert pevents.get_recorder() is None


def test_crashed_fit_publishes_failed(tmp_path, monkeypatch):
    status = str(tmp_path / "status.json")

    def boom(self, *a, **kw):
        raise RuntimeError("device fell over")

    monkeypatch.setattr(EmbeddingEngine, "train_steps_corpus_packed", boom)
    with pytest.raises(RuntimeError, match="device fell over"):
        _small(obs=pobs.ObsConfig(status_file=status, status_interval=0.0)).fit(SMALL)
    assert json.loads(open(status).read())["state"] == "failed"
    assert pevents.get_recorder() is None


def test_heartbeat_answers_mid_fit(tmp_path, monkeypatch):
    obs = pobs.ObsConfig(status_port=0)
    seen = []
    real = EmbeddingEngine.packed_readback

    def probe(out):
        if not seen:
            base = f"http://127.0.0.1:{obs.bound_port}"
            seen.append(json.loads(_get(base + "/healthz")[1]))
            seen.append(_get(base + "/metrics?format=prometheus")[1])
        return real(out)

    monkeypatch.setattr(EmbeddingEngine, "packed_readback", staticmethod(probe))
    _small(obs=obs).fit(SMALL).stop()
    health, text = seen
    assert health["status"] == "ok" and health["state"] == "running"
    assert health["pipeline"] == "device_corpus"
    pprom.lint_prometheus_text(text)
    assert 'glint_training_info{pipeline="device_corpus",state="running"} 1' in text


def test_cli_train_canary_abort_exits_2(tmp_path, capsys, monkeypatch):
    from glint_word2vec_torch import cli

    corpus = tmp_path / "c.txt"
    corpus.write_text("".join(" ".join(s) + "\n" for s in SMALL))
    _nan_steps(monkeypatch)
    monkeypatch.setattr(w2v_mod, "_free_device_bytes", lambda device: 0)
    ck = str(tmp_path / "ck")
    rc = cli.main(["train", "--corpus", str(corpus), "--output", str(tmp_path / "m"),
                   "--device", "cpu", "--vector-size", "8", "--batch-size", "32",
                   "--min-count", "1", "--window", "3", "--steps-per-call", "4",
                   "--checkpoint-dir", ck, "--canary", "abort",
                   "--canary-check-every", "1",
                   "--steptime-out", str(tmp_path / "STEPTIME.json")])
    assert rc == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1].startswith("error: training diverged: non-finite loss")
    assert os.path.isdir(os.path.join(ck, "ckpt-diverged"))
    assert not os.path.exists(tmp_path / "m")
    assert json.loads(open(tmp_path / "STEPTIME.json").read())["schema_version"] == 1


def test_cli_train_with_observability_flags(tmp_path, capsys):
    from glint_word2vec_torch import cli

    corpus = tmp_path / "c.txt"
    corpus.write_text("".join(" ".join(s) + "\n" for s in SMALL))
    status = tmp_path / "status.json"
    rc = cli.main(["train", "--corpus", str(corpus), "--output", str(tmp_path / "m"),
                   "--device", "cpu", "--vector-size", "8", "--batch-size", "32",
                   "--min-count", "1", "--window", "3", "--steps-per-call", "4",
                   "--status-file", str(status), "--status-port", "0",
                   "--event-log", str(tmp_path / "ev.jsonl"),
                   "--chrome-trace", str(tmp_path / "trace.json"),
                   "--canary", "warn"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line["steptime"]) == set(jmetrics.LEDGER_PHASES)
    assert math.isfinite(line["final_loss"])
    snap = json.loads(status.read_text())
    assert snap["state"] == "done" and snap["canary"]["mode"] == "warn"
    assert "device_steps" in _event_names(str(tmp_path / "ev.jsonl"))
    assert json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
