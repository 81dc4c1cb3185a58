"""The numbers a check compares, each a gap between the program's reading
and the reference's, relative to the reference's.

Norms are taken in float64 over each leaf (parameter field) and compared as
norms: the gap between the program's norm and the reference's, over the
reference's norm of that leaf or of the median leaf, whichever is larger,
and the worst leaf counts. A leaf whose reference gradient is under a
thousandth of the median leaf's moves by round-off alone and is left out.
"""
from __future__ import annotations

import statistics

import torch

FROZEN_SHARE = 1e-3


def norms(tensors: dict, scale: float = 1.0) -> dict:
    return {k: float(torch.linalg.vector_norm(v, dtype=torch.float64)) * scale for k, v in tensors.items()}


def moving(ref_grad_norms: dict) -> list[str]:
    """The leaves the reference's first gradient moves."""
    med = statistics.median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v >= FROZEN_SHARE * med]


def leaf_gap(prog: dict, ref: dict, keys: list[str]) -> float:
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def loss_gap(prog: list[float], ref: list[float]) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(prog, ref))


def image_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap of a pixel's value."""
    return float((prog.to(ref.device) - ref).abs().max())
