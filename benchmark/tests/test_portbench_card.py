"""The cells at a tiny size on the card, through the program's CUDA
kernels (skipped without a card: run them on the GPU machine with
`python -m pytest benchmark/tests -m cuda -n 0`)."""

from __future__ import annotations

import time

import pytest

from benchmark import run
from benchmark.tests.conftest import FIXTURE_CELL


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("cornell.path-2048",
                                  FIXTURE_CELL,
                                  "cornell.grad-2048x1024",
                                  "cornell.sppm-362"))
def test_tiny_cell_on_the_card(tiny_root, card, name):
    cell = run.load_cell(name, tiny_root)
    res = run.execute(cell, 2 ** 31 + 7, 0.5, 0, card, time.perf_counter())
    assert res["correct"] is True, res["compared"]
    assert res["device"]["platform"] == "gpu"
