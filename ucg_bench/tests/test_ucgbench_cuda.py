"""On the card: each one-card cell at its own size, a short window, the
program correct and the control (the reference in bfloat16 in the
program's place) not.  Skips without a CUDA card."""

import pytest
import torch

from ucg_bench import check, harness

CELLS = ["ucgld_fluid.nvt_1m", "bethe_density.switch_1m"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_correct_control_not(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = harness.run_cell(cell, 2**31 + 4242, 3.0, False, control=True,
                           calibrate=True)
    assert res["correct"], res["compared"]
    ok, _ = check.judge(res["control"], check.limits(
        harness.cell_of(harness.benchmark(), cell)["config"]))
    assert not ok
