"""The control at a size a test run holds: the reference in bfloat16 in
the program's place fails each cell's limits (the chip runs the same at
the cells' own sizes: python3 -m benchmark.control)."""

from __future__ import annotations

import pytest
import torch

from benchmark import control, run
from benchmark.tests.conftest import FIXTURE_CELL

CELLS = ("cornell.path-2048", FIXTURE_CELL, "cornell.grad-2048x1024",
         "cornell.sppm-362")


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(tiny_root, name):
    cell = run.load_cell(name, tiny_root)
    passes = 1 if cell["traffic"].get("integrator") == "sppm" else 2
    nums = control.numbers(cell, 2 ** 31 + 33, passes, torch.device("cpu"))
    assert any(v > lim for _, v, lim in nums), nums


@pytest.mark.parametrize("fault", ("half", "altered"))
def test_grad_faults_in_the_reference_fail_the_limits(tiny_root, fault):
    cell = run.load_cell("cornell.grad-2048x1024", tiny_root)
    nums = control.numbers(cell, 2 ** 31 + 35, 0, torch.device("cpu"),
                           fault)
    assert any(v > lim for _, v, lim in nums), nums
