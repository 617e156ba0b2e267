"""The control (the reference one precision step below the configuration,
in the program's place) and each planted fault (`calibrate.FAULTS`, in the
reference put in the program's place) fail the cell's limits and the
program does not: on the CPU at a tiny size, and on the card at the
cell's own size (``cuda`` marker)."""

import pytest
import torch

from benchlib import common
from calibrate import readings
from tiny import tiny_cell

torch.set_num_threads(4)


def control_check(cell, seed, device):
    """``{who: checks}`` of the program, the control and each fault."""
    limits = cell.spec["limits"]
    return {r["who"]: common.checks(r["numbers"], limits)
            for r in readings(cell, seed, device, 1.0, control=True,
                              fault=True)}


def assert_separates(checks):
    assert common.all_within(checks.pop("program"))
    assert "control" in checks
    for who, c in checks.items():
        assert not common.all_within(c), who


@pytest.mark.parametrize("name", ["s3dis-train", "s3dis-eval"])
def test_control_fails_at_a_tiny_size(name):
    assert_separates(control_check(tiny_cell(name), 2 ** 31 + 3, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["s3dis-train", "scannet-eval",
                                  "scannet-train", "s3dis-eval"])
def test_control_fails_at_the_cell_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert_separates(control_check(common.Cell(name), 2 ** 31 + 7, "cuda:0"))


def test_control_rounding_keeps_small_gradients():
    """The control's fp8 roundings are scaled per tensor: gradients of a
    mean loss over ~10^5 points (~1e-6) keep e4m3's and e5m2's relative
    precision and do not round to 0."""
    from reference.run import fp8_round
    g = torch.tensor([1e-6, -3e-6, 2.5e-7, 7e-9])
    for rnd, rel in ((fp8_round, 2 ** -4), (fp8_round.grad, 2 ** -3)):
        r = rnd(g)
        assert torch.all(r != 0)
        assert torch.all((r - g).abs() <= rel * g.abs())
