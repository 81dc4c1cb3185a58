"""Tests of the benchmark at tiny sizes on the CPU; tests marked `card` run
only where a CUDA card is (the decision is made inside the `card` fixture).

    python3 -m pytest perfbench/tests -q -p no:cacheprovider
"""
from __future__ import annotations

import pytest
import torch

from perfbench import core

TINY = {"num_gaussians": 600, "width": 96, "height": 64, "train_views": 6}
CELLS = ("train-3dgs-m360", "serve-lg-m360-orbit", "serve-3dgs-m360-orbit", "distill-lg-m360")


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped elsewhere")


def tiny_cell(name: str) -> core.Cell:
    cell = core.Cell(name)
    cell.config = {**cell.config, **TINY}
    return cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test measures the card")
    return torch.device("cuda", 0)
