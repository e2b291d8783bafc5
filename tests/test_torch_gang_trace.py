"""The gang trace id, the gang's shard-verify gauge and the training SLO
families of the port against the JAX package's.

* Under ``GLINT_TRACE_ID`` an ``EventRecorder``'s clock anchor carries
  the id as ``args.trace``, a ``StepTimeLedger`` snapshot as
  ``trace_id``, and ``merge_trace_logs`` of two ranks' logs reports it in
  each anchor, as the JAX package's do.
* ``merge_training_snapshots`` lifts the first rank's id as
  ``steptime_trace_id``, keeps the slowest rank's
  ``checkpoint_shard_verify_seconds`` and folds the ranks' SLO snapshots,
  as the JAX merge does; ``gang_to_prometheus`` renders the gauge and the
  step-time exemplar, ``training_to_prometheus`` the step-time exemplar
  and the eight ``glint_training_slo_*`` families of a ``TrainingStatus``
  built with ``slo=``, each line the JAX renderer's.

Tolerances: text, ids and dicts compare exactly.
"""

import json

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_tpu.obs import aggregate as jagg
from glint_word2vec_tpu.obs import events as jevents
from glint_word2vec_tpu.obs import heartbeat as jhb
from glint_word2vec_tpu.obs import prometheus as jprom
from glint_word2vec_tpu.obs import slo as jslo
from glint_word2vec_tpu.utils import metrics as jmetrics

from glint_word2vec_torch.obs import aggregate as pagg
from glint_word2vec_torch.obs import events as pevents
from glint_word2vec_torch.obs import heartbeat as phb
from glint_word2vec_torch.obs import prometheus as pprom
from glint_word2vec_torch.obs import slo as pslo
from glint_word2vec_torch.utils import metrics as pmetrics

GANG = "gang-abc"
SIDES = {"jax": (jevents, jmetrics, jagg, jprom, jslo, jhb),
         "torch": (pevents, pmetrics, pagg, pprom, pslo, phb)}


def _anchor(path) -> dict:
    with open(path) as f:
        return json.loads(f.readline())


def test_event_log_anchor_carries_the_gang_id(tmp_path, monkeypatch):
    monkeypatch.setenv("GLINT_TRACE_ID", GANG)
    anchors = {}
    for side, (events, *_) in SIDES.items():
        rec = events.EventRecorder(jsonl_path=str(tmp_path / f"{side}.jsonl"))
        rec.close()
        anchors[side] = _anchor(tmp_path / f"{side}.jsonl")
    for a in anchors.values():
        assert a["name"] == "clock_anchor" and a["args"]["trace"] == GANG
    assert set(anchors["torch"]["args"]) == set(anchors["jax"]["args"])
    monkeypatch.delenv("GLINT_TRACE_ID")
    rec = pevents.EventRecorder(jsonl_path=str(tmp_path / "none.jsonl"))
    rec.close()
    assert "trace" not in _anchor(tmp_path / "none.jsonl")["args"]


def test_ledger_snapshot_carries_the_gang_id(monkeypatch):
    monkeypatch.setenv("GLINT_TRACE_ID", GANG)
    snaps = {}
    for side, (_, metrics, *_) in SIDES.items():
        led = metrics.StepTimeLedger()
        led.account("dispatch", 0.01)
        snaps[side] = led.snapshot()
        assert led.trace_id == GANG
    assert snaps["torch"]["trace_id"] == snaps["jax"]["trace_id"] == GANG
    monkeypatch.delenv("GLINT_TRACE_ID")
    assert "trace_id" not in pmetrics.StepTimeLedger().snapshot()


def test_trace_merge_reports_each_ranks_gang_id(tmp_path, monkeypatch):
    monkeypatch.setenv("GLINT_TRACE_ID", GANG)
    paths = []
    for rank in range(2):
        path = str(tmp_path / f"rank{rank}.jsonl")
        rec = pevents.EventRecorder(jsonl_path=path)
        with rec.span("dispatch", rank=rank):
            pass
        rec.close()
        paths.append(path)
    docs = {side: mods[2].merge_trace_logs(paths)
            for side, mods in SIDES.items()}
    for doc in docs.values():
        assert {a.get("trace") for a in doc["otherData"]["anchors"].values()
                } == {GANG}
    assert docs["torch"]["otherData"]["anchors"] == \
        docs["jax"]["otherData"]["anchors"]
    assert docs["torch"]["otherData"]["stitched_traces"] == \
        docs["jax"]["otherData"]["stitched_traces"]


class Clock:
    def __init__(self, t=1_000_000.0):
        self.t = t

    def __call__(self):
        return self.t


def _slo(slo_mod, clock):
    eng = slo_mod.SloEngine([slo_mod.SloObjective("step", 0.99, 0.9, 50.0)],
                            now_fn=clock)
    for i in range(40):
        eng.observe("step", 0.01 if i % 4 else 0.2, 500 if i % 13 == 0 else 200)
    return eng


def _rank_snaps(side, with_id: bool):
    _, metrics, _, _, slo_mod, _ = SIDES[side]
    clock = Clock()
    snaps = {}
    for r in range(2):
        led = metrics.StepTimeLedger()
        led.trace_id = GANG if (with_id and r == 1) else None
        for i in range(4):
            led.account("dispatch", 0.01 * (i + r + 1))
        snaps[r] = {"state": "running", "supervisor_generation": 1,
                    "step": 10, "words_done": 100,
                    "checkpoint_shard_write_seconds": 0.25 * (r + 1),
                    "checkpoint_shard_verify_seconds": 0.5 + 0.2 * r,
                    "steptime": led.snapshot(),
                    "slo": _slo(slo_mod, clock).snapshot()}
    return snaps


@pytest.mark.parametrize("with_id", [True, False])
def test_gang_merge_keeps_verify_seconds_and_the_gang_id(with_id):
    merged = {side: SIDES[side][2].merge_training_snapshots(
        _rank_snaps(side, with_id), generation=1, num_workers=2)
        for side in SIDES}
    for key in ("checkpoint_shard_verify_seconds_max",
                "checkpoint_shard_write_seconds_max", "steptime_trace_id",
                "slo"):
        assert merged["torch"][key] == merged["jax"][key], key
    assert merged["torch"]["checkpoint_shard_verify_seconds_max"] == 0.7
    assert merged["torch"]["steptime_trace_id"] == (GANG if with_id else None)


def _lines(text, *prefixes):
    return [ln for ln in text.splitlines()
            if any(ln.startswith(p) or ln.startswith(f"# HELP {p}")
                   or ln.startswith(f"# TYPE {p}") for p in prefixes)]


def test_gang_scrape_renders_verify_gauge_and_exemplar():
    texts = {}
    for side, (_, _, agg, prom, *_) in SIDES.items():
        merged = agg.merge_training_snapshots(_rank_snaps(side, True),
                                              generation=1, num_workers=2)
        texts[side] = prom.gang_to_prometheus(merged)
        prom.lint_prometheus_text(texts[side])
    fams = ("glint_gang_checkpoint_shard_verify_seconds",
            "glint_gang_steptime_span_seconds", "glint_gang_slo_")
    got, want = _lines(texts["torch"], *fams), _lines(texts["jax"], *fams)
    assert got == want
    assert f'trace_id="{GANG}"' in "\n".join(got)
    assert "glint_gang_checkpoint_shard_verify_seconds 0.7" in got


def test_training_scrape_renders_exemplar_and_slo_families(monkeypatch):
    monkeypatch.setenv("GLINT_TRACE_ID", GANG)
    texts, snaps = {}, {}
    for side, (_, metrics, _, prom, slo_mod, hb) in SIDES.items():
        led = metrics.StepTimeLedger()
        led.account("dispatch", 0.25)
        led.account("checkpoint", 0.5)
        led.finalize()
        status = hb.TrainingStatus(pipeline="host", total_epochs=1,
                                   ledger=led)
        status.attach(slo=_slo(slo_mod, Clock()))
        snaps[side] = status.snapshot(include_devices=False)
        texts[side] = prom.training_to_prometheus(snaps[side])
        prom.lint_prometheus_text(texts[side])
    assert snaps["torch"]["slo"] == snaps["jax"]["slo"]
    fams = ("glint_training_steptime_ops_total", "glint_training_slo_")
    # "other" holds each ledger's own unattributed wall clock.
    got, want = ([ln for ln in _lines(texts[side], *fams)
                  if 'phase="other"' not in ln] for side in ("torch", "jax"))
    assert got == want
    names = {ln.split()[2] for ln in got if ln.startswith("# TYPE")}
    assert names == {"glint_training_steptime_ops_total"} | {
        f"glint_training_slo_{f}" for f in (
            "availability_target", "latency_target", "latency_threshold_ms",
            "window_requests", "window_bad", "burn_rate", "fast_burn",
            "slow_burn")}
    assert f'trace_id="{GANG}"' in "\n".join(got)
    # Built with slo= instead of attach: the same block.
    status = phb.TrainingStatus(slo=_slo(pslo, Clock()))
    assert status.snapshot(include_devices=False)["slo"] == snaps["torch"]["slo"]
