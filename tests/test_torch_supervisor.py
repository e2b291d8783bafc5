"""The port's gang supervisor (``glint_word2vec_torch/parallel/
supervisor.py``) with torch-free stub workers, the pattern of
``tests/test_supervisor.py``: clean completion, crash detection and
restart with a first-launch-only environment, the teardown of a wedged
peer, the restart budget, a hang through a stale heartbeat, the
generation handshake, the postmortem bundles, the merged gang endpoint,
the give-up on an unverifiable checkpoint, the worker launch contract
(``python -m glint_word2vec_torch.cli``) and the ``supervise`` and
``transform-file --workers`` argument validation."""

import json
import os
import sys
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from glint_word2vec_torch.parallel.supervisor import (
    Supervisor,
    cli_train_build_argv,
    cli_transform_build_argv,
)

# Stub worker: writes generation-stamped heartbeats (with the progress
# fields the gang aggregator sums) plus a per-rank event-log JSONL (the
# flight recorder's collection source), then follows the behavior its
# env/generation selects. argv: <status_file> <behavior> [<rank>]
_STUB = r"""
import json, os, sys, time

status_file, behavior = sys.argv[1], sys.argv[2]
rank = int(sys.argv[3]) if len(sys.argv) > 3 else 0
gen = int(os.environ.get("GLINT_SUPERVISOR_GEN", "-1"))

events_file = os.path.join(
    os.path.dirname(status_file), "events-%d.jsonl" % rank
)
with open(events_file, "w") as f:
    f.write(json.dumps({"name": "clock_anchor", "ph": "M", "ts": 0,
                        "args": {"wall_t0": time.time()}}) + "\n")
    f.write(json.dumps({"name": "run_start", "ph": "i", "ts": 1.0,
                        "args": {"generation": gen}}) + "\n")


def beat(state="running"):
    tmp = status_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump({
            "state": state, "supervisor_generation": gen,
            "step": 10 * (rank + 1), "words_done": 100 * (rank + 1),
            "words_per_sec_rolling": 5.0 * (rank + 1),
            "step_time": 1.0,
            "events": {"recorded": 2, "dropped": 0},
        }, f)
    os.replace(tmp, status_file)


beat()
if behavior == "ok":
    for _ in range(3):
        time.sleep(0.05)
        beat()
    beat("done")
    sys.exit(0)
if behavior == "crash-env":
    # Crashes only when the first-launch-only env var is present.
    if os.environ.get("GLINT_TEST_CRASH") == "1":
        sys.exit(3)
    time.sleep(0.1)
    beat("done")
    sys.exit(0)
if behavior == "crash-after-peer":
    # Like crash-env, but the crashing rank first waits for its peer's
    # first heartbeat, so every rank has remains to collect.
    if os.environ.get("GLINT_TEST_CRASH") == "1":
        peer = os.path.join(os.path.dirname(status_file), "status-1.json")
        for _ in range(400):
            if os.path.exists(peer):
                break
            time.sleep(0.025)
        sys.exit(3)
    time.sleep(0.1)
    beat("done")
    sys.exit(0)
if behavior == "crash-always":
    time.sleep(0.05)
    sys.exit(3)
if behavior == "hang-gen0":
    if gen == 0:
        time.sleep(120)  # heartbeat never refreshes -> stale
    time.sleep(0.1)
    beat("done")
    sys.exit(0)
if behavior == "slow-ok":
    # Heartbeats long enough for the test to scrape the merged gang
    # endpoint mid-run.
    for _ in range(60):
        time.sleep(0.05)
        beat()
    beat("done")
    sys.exit(0)
if behavior == "wedge-on-peer":
    # Rank 0 crashes in gen 0; rank 1 "wedges" (keeps heartbeating but
    # never exits) — only the gang teardown can end it.
    if gen == 0 and rank == 0:
        sys.exit(3)
    if gen == 0:
        for _ in range(2400):
            time.sleep(0.05)
            beat()
        sys.exit(0)
    time.sleep(0.1)
    beat("done")
    sys.exit(0)
sys.exit(99)
"""


def _sup(tmp_path, behavior, workers=1, **kw):
    stub = tmp_path / "stub.py"
    stub.write_text(_STUB)

    def build_argv(rank, n, port, status_file, generation):
        return [
            sys.executable, str(stub), status_file, behavior, str(rank),
        ]

    defaults = dict(
        status_dir=str(tmp_path / "sup"),
        poll_interval=0.05,
        max_restarts=2,
        backoff_base_seconds=0.05,
        backoff_cap_seconds=0.2,
        kill_grace_seconds=1.0,
        heartbeat_stale_seconds=1.0,
        startup_grace_seconds=10.0,
    )
    defaults.update(kw)
    return Supervisor(build_argv, workers, **defaults)


def test_clean_completion_no_restarts(tmp_path):
    report = _sup(tmp_path, "ok", workers=2).run()
    assert report.completed
    assert report.restarts == 0
    assert report.generations == 1


def test_crash_detected_restarted_once_env_not_rearmed(tmp_path):
    # The first-launch-only env (the chaos drill's GLINT_FAULTS seam)
    # crashes generation 0; generation 1 runs WITHOUT it and completes.
    report = _sup(
        tmp_path, "crash-env",
        rank_env_first_launch={0: {"GLINT_TEST_CRASH": "1"}},
    ).run()
    assert report.completed
    assert report.restarts == 1
    rec = report.restart_records[0]
    assert "exited with code 3" in rec.reason
    assert rec.detect_to_relaunch_seconds >= rec.backoff_seconds
    d = report.to_dict()
    assert d["restart_records"][0]["reason"] == rec.reason


def test_gang_teardown_kills_wedged_survivor(tmp_path):
    # Rank 0 dies; rank 1 heartbeats forever (the stuck-collective
    # analogue). The supervisor must kill it, relaunch BOTH, complete.
    t0 = time.time()
    report = _sup(tmp_path, "wedge-on-peer", workers=2).run()
    assert report.completed
    assert report.restarts == 1
    assert time.time() - t0 < 60  # the wedged worker did not pin us


def test_restart_budget_exhausted_gives_up(tmp_path):
    report = _sup(tmp_path, "crash-always", max_restarts=2).run()
    assert not report.completed
    assert report.restarts == 2
    assert "budget" in report.gave_up_reason


def test_hang_detected_via_stale_heartbeat(tmp_path):
    report = _sup(
        tmp_path, "hang-gen0", heartbeat_stale_seconds=0.5,
    ).run()
    assert report.completed
    assert report.restarts == 1
    assert "stale" in report.restart_records[0].reason


def test_stale_pre_restart_status_file_not_trusted(tmp_path):
    # A status file stamped with an older generation must read as
    # "no heartbeat yet", not as a live (or stale) current one.
    sup = _sup(tmp_path, "ok")
    os.makedirs(sup.status_dir, exist_ok=True)
    with open(sup._status_file(0), "w") as f:
        json.dump({"state": "running", "supervisor_generation": 0}, f)
    assert sup._read_status(0, generation=1) is None
    assert sup._read_status(0, generation=0) is not None




def test_cli_supervise_validates_arguments(capsys, monkeypatch):
    # The supervise branch returns before any worker or device set-up.
    from glint_word2vec_torch import cli
    from glint_word2vec_torch.parallel import supervisor

    assert cli.main(["supervise", "--workers", "1"]) == 1
    assert "expects the train command" in capsys.readouterr().err
    assert cli.main(["supervise", "train", "--corpus", "x"]) == 1
    assert "--checkpoint-dir" in capsys.readouterr().err
    # --join-serving goes to the supervisor's gang server.
    seen = {}

    class Sup:
        def __init__(self, build_argv, workers, **kw):
            seen.update(kw, workers=workers)

        def run(self):
            return supervisor.SupervisorReport(completed=True)

    monkeypatch.setattr(supervisor, "Supervisor", Sup)
    assert cli.main(["supervise", "--join-serving", "http://127.0.0.1:1/m",
                     "--join-serving", "http://127.0.0.1:2/m",
                     "train", "--corpus", "x", "--checkpoint-dir", "c"]) == 0
    assert seen["serving_urls"] == ["http://127.0.0.1:1/m",
                                    "http://127.0.0.1:2/m"]
    assert json.loads(capsys.readouterr().out)["completed"] is True
    assert cli.main(["supervise", "--rank-env", "x", "train", "--corpus", "x",
                     "--checkpoint-dir", "c"]) == 1
    assert "R:KEY=VAL" in capsys.readouterr().err


def test_cli_argv_value_forms():
    from glint_word2vec_torch.cli import _argv_value

    argv = ["--corpus", "c.txt", "--checkpoint-dir", "a", "--checkpoint-dir=b"]
    assert _argv_value(argv, "--checkpoint-dir") == "b"  # last wins
    assert _argv_value(argv, "--corpus") == "c.txt"
    assert _argv_value(argv, "--output") is None


def test_crash_collects_postmortem_bundles_referenced_from_report(tmp_path):
    report = _sup(
        tmp_path, "crash-after-peer", workers=2,
        rank_env_first_launch={0: {"GLINT_TEST_CRASH": "1"}},
    ).run()
    assert report.completed and report.restarts == 1
    rec = report.restart_records[0]
    assert rec.postmortem, "restart record references no bundles"
    assert set(rec.postmortem) <= set(report.postmortem_bundles)
    d = report.to_dict()
    assert d["restart_records"][0]["postmortem"] == rec.postmortem
    assert d["postmortem_bundles"] == report.postmortem_bundles
    sup_dir = tmp_path / "sup"
    for rank in (0, 1):
        bundle = sup_dir / f"postmortem-0-{rank}"
        assert str(bundle) in rec.postmortem
        assert {"heartbeat.json", "events.jsonl", "meta.json",
                "log_tail.txt"} <= set(os.listdir(bundle))
        assert json.load(open(bundle / "heartbeat.json"))[
            "supervisor_generation"] == 0
        events = [json.loads(line) for line in open(bundle / "events.jsonl")]
        assert any(e["name"] == "run_start" for e in events)
        meta = json.load(open(bundle / "meta.json"))
        assert meta["generation"] == 0 and meta["rank"] == rank
        assert "exited with code 3" in meta["reason"]
    assert not [e for e in os.listdir(sup_dir) if e.startswith("postmortem-1-")]


def test_give_up_teardown_also_collects_postmortem(tmp_path):
    report = _sup(tmp_path, "crash-always", max_restarts=1).run()
    assert not report.completed
    gens = {os.path.basename(b).split("-")[1] for b in report.postmortem_bundles}
    assert gens == {"0", "1"}


def test_merged_gang_metrics_endpoint_live_during_run(tmp_path):
    import threading
    import urllib.request

    from glint_word2vec_torch.obs.prometheus import lint_prometheus_text

    sup = _sup(tmp_path, "slow-ok", workers=2, metrics_port=0)
    assert sup.metrics_port
    base = f"http://127.0.0.1:{sup.metrics_port}"
    result = {}
    t = threading.Thread(target=lambda: result.update(r=sup.run()))
    t.start()
    try:
        merged = None
        for _ in range(200):
            try:
                with urllib.request.urlopen(base + "/metrics", timeout=2) as r:
                    m = json.loads(r.read())
                if m["ranks_reporting"] == 2:
                    merged = m
                    break
            except OSError:
                pass
            time.sleep(0.05)
        assert merged, "merged endpoint never saw both ranks"
        assert merged["generation"] == 0 and merged["num_workers"] == 2
        assert merged["counters"]["steps_total"] == 30
        assert merged["counters"]["words_done_total"] == 300
        assert merged["counters"]["events_recorded_total"] == 4
        assert merged["words_per_sec_total"] == 15.0
        assert merged["rank_skew"] is not None
        assert set(merged["per_rank"]) == {"0", "1"}
        with urllib.request.urlopen(base + "/metrics?format=prometheus",
                                    timeout=2) as r:
            text = r.read().decode()
        lint_prometheus_text(text)
        assert "glint_gang_rank_skew" in text
        with urllib.request.urlopen(base + "/healthz", timeout=2) as r:
            h = json.loads(r.read())
        assert h["status"] == "ok" and h["ranks_reporting"] == 2
    finally:
        t.join(timeout=60)
    assert result["r"].completed
    assert result["r"].metrics_port == sup.metrics_port


def test_worker_launch_contract_names_the_port_cli(tmp_path):
    argv = cli_train_build_argv(["--corpus", "c.txt"])(
        1, 2, 12345, str(tmp_path / "status-1.json"), 0)
    assert argv[:4] == [sys.executable, "-m", "glint_word2vec_torch.cli", "train"]
    joined = " ".join(argv)
    assert "--status-file" in joined
    assert str(tmp_path / "events-1.jsonl") in argv
    assert str(tmp_path / "steptime-1.json") in argv
    assert "--coordinator 127.0.0.1:12345" in joined
    assert "--num-processes 2" in joined and "--process-id 1" in joined
    one = cli_train_build_argv(["--corpus", "c.txt"])(
        0, 1, 1, str(tmp_path / "status-0.json"), 0)
    assert "--coordinator" not in one
    targv = cli_transform_build_argv(["--model", "m"])(
        2, 3, 1, str(tmp_path / "status-2.json"), 0)
    assert targv[:4] == [sys.executable, "-m", "glint_word2vec_torch.cli",
                         "transform-file"]
    assert targv[-4:] == ["--rank", "2", "--world", "3"]
    assert str(tmp_path / "transform-2.json") in targv


def test_gave_up_on_unverifiable_checkpoint(tmp_path):
    ck = tmp_path / "ck"
    os.makedirs(ck / "ckpt-1")
    with open(ck / "train_state.json", "w") as f:
        json.dump({"epochs_completed": 1, "step": 1, "words_done": 1,
                   "ckpt": "ckpt-1"}, f)
    report = _sup(tmp_path, "crash-always", checkpoint_dir=str(ck),
                  max_restarts=3).run()
    assert not report.completed
    assert report.restarts == 0
    assert "no verifiable checkpoint" in report.gave_up_reason


def test_supervisor_process_touches_no_device(tmp_path):
    # The supervisor owns no card: a whole supervised run leaves CUDA
    # uninitialised in its process.
    report = _sup(tmp_path, "ok", workers=2).run()
    assert report.completed
    assert not torch.cuda.is_initialized()


def test_heartbeat_echoes_the_supervisor_generation(monkeypatch):
    from glint_word2vec_torch.obs.heartbeat import TrainingStatus

    monkeypatch.setenv("GLINT_SUPERVISOR_GEN", "3")
    assert TrainingStatus().snapshot(
        include_devices=False)["supervisor_generation"] == 3
    monkeypatch.delenv("GLINT_SUPERVISOR_GEN")
    assert TrainingStatus().snapshot(
        include_devices=False)["supervisor_generation"] is None
