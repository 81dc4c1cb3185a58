"""On a CUDA card: a short run of every cell at its full size is correct."""
from __future__ import annotations

import argparse

import pytest

from perfbench import core, run
from perfbench.tests.conftest import CELLS


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, card):
    result, checks = run.run(argparse.Namespace(workload=name, seed=2**31 + 101, seconds=2.0, trace=0), card,
                             core.Cell(name))
    assert result["correct"] is True, checks
    assert result["device"]["platform"] == "gpu"
