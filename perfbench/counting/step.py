"""The counted work of one training step or served frame, on its own inputs.

The blend pairs come from the reference's own binning and walk of the
Gaussians and the camera the traced step or frame rendered; every other
piece is counted from shapes (`work`). Each function returns the least time
of every blend kernel launch it counts, by the kernel's launch name, and the
least time of the whole step or frame.
"""
from __future__ import annotations

import torch

from perfbench.counting import work as W
from perfbench.reference import render as R


def _forward(p: dict, degree: int, view, cut: int, exact: bool):
    """(pairs by kind, live instances, tiles, the forward's least time of
    preprocess, binning and compose)."""
    with torch.no_grad():
        s = R.preprocess(p, degree, view)
        b = R.bin_splats(s, R.make_grid(view.width, view.height), cut)
        _, _, work = R.blend(b, exact=exact)
    n, m, tiles = s.mean2d.shape[0], b.inst.shape[0], b.grid.num_tiles
    pf, pm = W.preprocess_forward(degree)
    pixels = view.width * view.height
    rest = (W.least_s(n * pf, n * pm)
            + W.least_s(n * W.BINNING_PER_GAUSSIAN[0] + m * W.BINNING_PER_INSTANCE[0],
                        n * W.BINNING_PER_GAUSSIAN[1] + m * W.BINNING_PER_INSTANCE[1])
            + W.least_s(pixels * W.COMPOSE_PER_PIXEL[0]))
    return W.pairs_by_kind(work), m, tiles, n, rest


def frame(p: dict, degree: int, view, cut: int) -> tuple[dict, float]:
    """A served frame (render-only blend, B6)."""
    pairs, m, tiles, n, rest = _forward(p, degree, view, cut, exact=False)
    b6 = W.pairs_least_s(pairs, False, W.blend_bytes(m, tiles, n, False))
    return {"blend_forward_fast": b6}, b6 + rest


def train_step(p: dict, degree: int, view, cut: int, moment_planes: int, stats: bool,
               teacher: tuple | None = None) -> tuple[dict, float]:
    """A training step: forward (B1), loss, backward (B2 and the preprocess
    backward), Adam and, with `stats`, the densification statistics. With
    `teacher` = (its Gaussians, its SH degree), a distillation step, which
    renders the teacher (B1) first."""
    kernels = {"blend_forward": 0.0, "blend_backward": 0.0}
    total = 0.0
    if teacher is not None:
        pairs, m, tiles, n, rest = _forward(teacher[0], teacher[1], view, cut, exact=True)
        b1 = W.pairs_least_s(pairs, False, W.blend_bytes(m, tiles, n, False))
        kernels["blend_forward"] += b1
        total += b1 + rest
    pairs, m, tiles, n, rest = _forward(p, degree, view, cut, exact=True)
    b1 = W.pairs_least_s(pairs, False, W.blend_bytes(m, tiles, n, False))
    b2 = W.pairs_least_s(pairs, True, W.blend_bytes(m, tiles, n, True))
    kernels["blend_forward"] += b1
    kernels["blend_backward"] += b2
    pixels = view.width * view.height
    lf, lm = W.loss_forward(moment_planes)
    lbf, lbm = W.loss_backward(moment_planes)
    bf, bm = W.preprocess_backward(degree)
    floats = n * W.trained_floats(degree)
    total += (b1 + b2 + rest + W.least_s(pixels * lf, pixels * lm) + W.least_s(pixels * lbf, pixels * lbm)
              + W.least_s(n * bf, n * bm) + W.least_s(floats * W.ADAM_PER_FLOAT[0], floats * W.ADAM_PER_FLOAT[1]))
    if stats:
        total += W.least_s(n * W.STATS_PER_GAUSSIAN[0], n * W.STATS_PER_GAUSSIAN[1])
    return kernels, total
