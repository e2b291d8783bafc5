"""A run with the timed path broken underneath comes out not correct,
for each fault a cell can have (``perfbench/faults.py``). Every cell runs
on one card, so none has an exchange between chips to leave out."""

import pytest

import pb_tiny
from perfbench import faults


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pb_tiny.tiny_root(tmp_path_factory.mktemp("tiny"))


def _cases():
    out = []
    for cell in pb_tiny.tiny_cells():
        kind = "train" if ".train" in cell else "query"
        out += [(cell, kind, f) for f in faults.FAULTS[kind]]
    return out


@pytest.mark.parametrize("cell,kind,fault", _cases())
def test_fault_comes_out_not_correct(root, cell, kind, fault):
    with faults.planted(fault, kind):
        line = pb_tiny.run(root, cell)
    assert line["correct"] is False, (fault, line["checks"])


@pytest.mark.parametrize("cell", pb_tiny.tiny_cells())
def test_the_same_run_without_a_fault_is_correct(root, cell):
    assert pb_tiny.run(root, cell)["correct"] is True
