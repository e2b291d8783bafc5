"""Each cell of the benchmark, on the card at its own size, for two
seconds: correct. Marked ``cuda``; skips without a card."""

import pytest

import pb_tiny


@pytest.mark.cuda
@pytest.mark.parametrize("cell", pb_tiny.cells())
def test_cell_on_the_card_is_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    line = pb_tiny.harness.run_cell(pb_tiny.harness.Cell(cell), 2**31 + 99,
                                    2.0, False, torch.device("cuda", 0))
    assert line["correct"] is True, line["checks"]
