"""A cell is data: a workload file under a new name is found and run with
no edit to the harness."""

import json

import pb_tiny


def test_new_workload_file_runs_without_a_code_edit(tmp_path):
    root = pb_tiny.tiny_root(tmp_path)
    train = [c for c in pb_tiny.cells() if ".train" in c][0]
    base = json.loads((root / "workloads" / f"{train}.json").read_text())
    traffic = json.loads((root / "traffic" / f"{base['traffic']}.json").read_text())
    traffic["batch_size"] = 32
    (root / "traffic" / "smaller-batch.json").write_text(json.dumps(traffic))
    base["traffic"] = "smaller-batch"
    (root / "workloads" / "brand-new.cell.json").write_text(json.dumps(base))
    line = pb_tiny.run(root, "brand-new.cell")
    assert line["correct"] is True
    assert line["attempted"] > 0
