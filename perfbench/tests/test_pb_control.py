"""A run in the next precision down fails the comparison: the program
with bfloat16 tables, its own lower-precision path, on every cell."""

import pytest

import pb_tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pb_tiny.tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", pb_tiny.tiny_cells())
def test_bfloat16_tables_fail_the_comparison(root, cell):
    line = pb_tiny.run(root, cell, dtype="bfloat16")
    assert line["correct"] is False
    failed = [n for n, c in line["checks"].items() if c["value"] > c["limit"]]
    assert failed, line["checks"]


@pytest.mark.cuda
def test_tf32_reference_in_the_programs_place_fails_on_the_card(tmp_path):
    """The shared pool's and the query's products in TF32, at a small size
    on the card (the CPU has no TF32; the per-pair step has no product)."""
    import time

    import torch

    if not torch.cuda.is_available():
        pytest.skip("TF32 exists on the card only")
    from perfbench import calibrate

    root = pb_tiny.tiny_root(tmp_path)
    for name in pb_tiny.tiny_cells():
        cell = pb_tiny.harness.Cell(name, root)
        ctx = pb_tiny.harness.Context(cell, 7, 1.0, False,
                                      torch.device("cuda"), time.time())
        if cell.workload["driver"] == "synonyms_bulk":
            vals = calibrate.query_reference_in_place(ctx)
        elif cell.traffic["shared_negatives"]:
            vals = calibrate.train_reference_in_place(ctx)
        else:
            continue
        assert any(vals[n] > cell.limits[n] for n in vals), (name, vals)
