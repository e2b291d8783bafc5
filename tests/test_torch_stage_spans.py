"""The port's stage spans (``obs/events.py`` ``STAGE_SPANS``).

* With tracing off (no recorder installed, the torch profiler not
  running) ``span()`` and a stage with nothing to take are the shared
  no-op, and the process's stage table still counts the host stage and a
  CPU stage's device interval (its host duration).
* Inside ``torch.profiler.profile`` a packed training call and a synonyms
  batch open one ``record_function`` range a stage: K of each per-step
  stage for K steps, one of each per-call stage.
* With a recorder installed a fit's event log holds the same names, each
  per-step stage inside the fit's ``device_steps`` span and the group's
  wait inside ``readback_harvest``; a recorder alone takes no CUDA event.
* The table keeps a stage's first device intervals in order, and the
  benchmark's readers take the first ``n`` of each.
* Every stage name the program opens is a key of ``STAGE_SPANS``, and
  every key has a site.
* On a card (``cuda``), under a device-only profile, the device intervals
  of one step's four stages add up to within 10 % of a CUDA-event time
  around the whole step.

Run the ``cuda`` test on a card with
``python -m pytest tests/test_torch_stage_spans.py -m cuda --noconftest -q``.
"""

import ast
import collections
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from glint_word2vec_torch import Word2Vec  # noqa: E402
from glint_word2vec_torch import obs as pobs  # noqa: E402
from glint_word2vec_torch.convert import (  # noqa: E402
    engine_from_arrays,
    model_from_arrays,
)
from glint_word2vec_torch.corpus.batching import packed_pair_batch  # noqa: E402
from glint_word2vec_torch.obs import events as pevents  # noqa: E402
from glint_word2vec_torch.utils.params import Word2VecParams  # noqa: E402

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "glint_word2vec_torch")
STEP_STAGES = ("pack_pairs", "draw_negatives", "sgns_forward", "sgns_scatter")
CALL_STAGES = ("topk_scores", "topk_select", "topk_readback", "decode_hits")
V, D, W, B = 200, 16, 3, 16


def _corpus(n_tokens, vocab, seed=0, length=20):
    ids = np.random.default_rng(seed).integers(0, vocab, n_tokens).astype(np.int32)
    offsets = np.arange(0, n_tokens + 1, length, dtype=np.int64)
    if offsets[-1] != n_tokens:
        offsets = np.append(offsets, n_tokens)
    return ids, offsets


def _engine(shared, device="cpu", vocab=V, dim=D, tokens=4000):
    rng = np.random.default_rng(1)
    syn0 = rng.uniform(-0.5 / dim, 0.5 / dim, (vocab, dim)).astype(np.float32)
    counts = np.arange(vocab, 0, -1).astype(np.int64) * 3
    eng = engine_from_arrays(syn0, np.zeros_like(syn0), counts,
                             num_negatives=5, device=device,
                             shared_negatives=shared)
    eng.upload_corpus(*_corpus(tokens, vocab))
    return eng


def _model():
    rng = np.random.default_rng(2)
    syn0 = rng.normal(size=(V, D)).astype(np.float32)
    params = Word2VecParams(vector_size=D, min_count=1)
    return model_from_arrays([f"w{i}" for i in range(V)], syn0,
                             np.zeros_like(syn0),
                             np.arange(V, 0, -1, dtype=np.int64), params,
                             device="cpu")


def _counts():
    return {k: v["host_count"] + v["device_count"]
            for k, v in pevents.stage_table().items()}


def test_tracing_off_spans_are_null_and_the_stage_table_still_counts():
    assert pevents.get_recorder() is None
    assert not torch.autograd.profiler._is_profiler_enabled
    assert pevents.span("engine_warmup") is pevents.NULL_SPAN
    assert pevents.phase_span("req.dispatch") is pevents.NULL_SPAN
    assert pevents.request_trace("t").phase("req.query") is pevents.NULL_SPAN
    assert pobs.NULL_RUN.span("device_steps") is pevents.NULL_SPAN
    # Off, a stage no metric reads on the host costs nothing.
    cuda = torch.device("cuda", 0)
    assert pevents.stage("readback_wait") is pevents.NULL_SPAN
    assert pevents.stage("topk_readback") is pevents.NULL_SPAN
    assert pevents.stage("sgns_forward", device=cuda) is pevents.NULL_SPAN
    assert pevents.stage("pack_pairs") is pevents.NULL_SPAN
    before = pevents.stage_table()
    with pevents.stage("decode_hits"):
        time.sleep(0.002)
    with pevents.stage("topk_select", device=torch.device("cpu")):
        time.sleep(0.002)
    after = pevents.stage_table()
    dec, sel = after["decode_hits"], after["topk_select"]
    assert dec["host_count"] == before["decode_hits"]["host_count"] + 1
    assert dec["host_s"] - before["decode_hits"]["host_s"] >= 0.002
    assert dec["device_count"] == before["decode_hits"]["device_count"]
    assert sel["device_count"] == before["topk_select"]["device_count"] + 1
    assert sel["host_count"] == before["topk_select"]["host_count"]
    if len(sel["device_s"]) > len(before["topk_select"]["device_s"]):
        assert sel["device_s"][-1] >= 0.002
    with pytest.raises(KeyError):
        pevents.stage("no_such_stage")


def test_a_recorder_alone_takes_no_cuda_event():
    """Device marks are the profiler's: with a recorder installed and no
    profiler, a CUDA stage records the ring's span and touches no CUDA
    call (this build may have no CUDA at all)."""
    cuda = torch.device("cuda", 0)
    before = pevents.stage_table()["sgns_forward"]
    rec = pevents.set_recorder(pevents.EventRecorder())
    try:
        with pevents.stage("sgns_forward", device=cuda):
            pass
    finally:
        pevents.set_recorder(None)
    assert [e["name"] for e in rec.events()] == ["sgns_forward"]
    after = pevents.stage_table()["sgns_forward"]
    assert after["device_count"] == before["device_count"]
    assert not pevents._pending


def test_the_table_keeps_the_first_device_intervals(monkeypatch):
    monkeypatch.setattr(pevents, "_DEVICE_KEEP", 3)
    st = pevents._StageStat()
    for s in (0.5, 0.25, 0.125, 2.0, 4.0):
        st.add_device(s)
    assert (st.device_n, st.device) == (5, [0.5, 0.25, 0.125])


def test_the_benchmark_readers_take_the_first_intervals(monkeypatch):
    from perfbench import stages

    table = {name: {"host_count": 0, "host_s": 0.0, "device_count": 0,
                    "device_s": []} for name in pevents.STAGE_SPANS}
    table["pack_pairs"]["device_s"] = [0.001, 0.003, 0.100]
    table["draw_negatives"]["device_s"] = [0.002, 0.002, 0.100]
    table["decode_hits"].update(host_count=4, host_s=0.1)
    monkeypatch.setattr(pevents, "stage_table", lambda: table)
    assert stages.device_ms(("pack_pairs", "draw_negatives"), 2) == (
        pytest.approx(4.0))
    assert stages.device_ms(("pack_pairs",), 4) is None
    assert stages.device_ms(("pack_pairs",), 0) is None
    assert stages.host_mean_ms("decode_hits") == pytest.approx(25.0)
    assert stages.host_mean_ms("topk_readback") is None
    # A program without the table gives nothing to read.
    monkeypatch.delattr(pevents, "stage_table")
    assert stages.device_ms(("pack_pairs",), 2) is None
    assert stages.host_mean_ms("decode_hits") is None


@pytest.mark.parametrize("shared", [0, 8])
def test_profiler_ranges_name_every_stage(shared):
    from torch.profiler import ProfilerActivity, profile

    eng = _engine(shared)
    model = _model()
    K = 3
    P = packed_pair_batch(B, W)
    vecs = np.random.default_rng(3).normal(size=(4, D)).astype(np.float32)
    before = _counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.train_steps_corpus_packed(0, P, W, B, 5, K)
        model.find_synonyms_batch(vecs, 3)
        with pevents.span("engine_warmup"):
            pass
    got = collections.Counter(e.name for e in prof.events())
    want = {**{n: K for n in STEP_STAGES}, "readback_wait": 1,
            **{n: 1 for n in CALL_STAGES}}
    assert {n: got[n] for n in pevents.STAGE_SPANS} == want
    assert got["engine_warmup"] == 1
    # The table takes the CPU stages' intervals and the decode's host
    # time; the two waits only name the profiler's ranges.
    after = _counts()
    taken = {**want, "readback_wait": 0, "topk_readback": 0}
    assert {n: after[n] - before[n] for n in pevents.STAGE_SPANS} == taken
    model.stop()


def test_fit_event_log_nests_the_stages_in_the_fit_spans(tmp_path):
    log = str(tmp_path / "events.jsonl")
    sents = [" ".join(f"w{(7 * i + j) % 60}" for j in range(12)).split()
             for i in range(200)]
    Word2Vec(device="cpu", obs=pobs.ObsConfig(event_log=log), vector_size=8,
             batch_size=32, min_count=1, num_iterations=1, seed=7,
             steps_per_call=4, window=3).fit(sents).stop()
    assert pevents.get_recorder() is None
    evs = [json.loads(line) for line in open(log) if line.strip()]
    spans = [e for e in evs if e.get("ph") == "X"]

    def inside(e, outer):
        return any(o["tid"] == e["tid"] and o["ts"] <= e["ts"]
                   and e["ts"] + e["dur"] <= o["ts"] + o["dur"] + 0.2
                   for o in spans if o["name"] == outer)

    names = collections.Counter(e["name"] for e in spans)
    for n in STEP_STAGES:
        assert names[n] > 0, n
        assert names[n] == names["pack_pairs"], n
        assert all(inside(e, "device_steps") for e in spans if e["name"] == n), n
    assert names["readback_wait"] > 0
    assert all(inside(e, "readback_harvest")
               for e in spans if e["name"] == "readback_wait")


def _stage_sites():
    """``stage("<name>")`` call sites in the port's source: name ->
    [path:line]."""
    out = collections.defaultdict(list)
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tree = ast.parse(open(path).read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "stage" and node.args):
                    arg = node.args[0]
                    assert isinstance(arg, ast.Constant), f"{path}:{node.lineno}"
                    out[arg.value].append(f"{path}:{node.lineno}")
    return out


def test_every_stage_site_names_a_registered_stage():
    sites = _stage_sites()
    assert set(sites) == set(pevents.STAGE_SPANS), (
        set(sites) ^ set(pevents.STAGE_SPANS))
    assert pevents.DEVICE_STAGES <= set(pevents.STAGE_SPANS)
    assert all(isinstance(v, str) and v for v in pevents.STAGE_SPANS.values())


@pytest.mark.cuda
def test_cuda_step_stages_cover_the_step():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stages' device intervals are "
                    "CUDA events")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    eng = _engine(4096, device=dev, vocab=100_000, dim=300, tokens=400_000)
    # The benchmark's step size, at which the card, not the host's
    # launches, paces the step.
    Bc, Wc = 16384, 5
    P = packed_pair_batch(Bc, Wc)
    eng.train_steps_corpus_packed(0, P, Wc, Bc, 5, 2)  # builds the kernels
    torch.cuda.synchronize(dev)
    # Off the profiler, a step takes no device interval.
    before = pevents.stage_table()
    eng.train_steps_corpus_packed(0, P, Wc, Bc, 5, 1, readback=False)
    torch.cuda.synchronize(dev)
    assert {s: pevents.stage_table()[s]["device_count"] for s in STEP_STAGES} \
        == {s: before[s]["device_count"] for s in STEP_STAGES}
    with profile(activities=[ProfilerActivity.CUDA]):
        # The profiler's first launches set it up, as perfbench/trace.py
        # has it: one untimed step first.
        eng.train_steps_corpus_packed(0, P, Wc, Bc, 5, 1, readback=False)
        torch.cuda.synchronize(dev)
        for _ in range(3):
            before = pevents.stage_table()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            eng.train_steps_corpus_packed(0, P, Wc, Bc, 5, 1, readback=False)
            e1.record()
            torch.cuda.synchronize(dev)
            after = pevents.stage_table()
            whole = e0.elapsed_time(e1) / 1e3
            new = {s: after[s]["device_s"][before[s]["device_count"]:]
                   for s in STEP_STAGES}
            assert {s: len(v) for s, v in new.items()} == \
                {s: 1 for s in STEP_STAGES}
            parts = sum(v[0] for v in new.values())
            assert abs(parts - whole) <= 0.1 * whole, (parts, whole)
    eng.destroy()
