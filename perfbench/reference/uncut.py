"""The reference's served frame uncut, for frames past the JAX package's 2^24
instances.

`render.render_frame` cuts a frame at `render.default_cut`, at most 2^24
instances, as the JAX package does. Here the cut is `UNCUT`, which no frame
reaches, so every live instance is binned and blended. The work is the
reference's own: `render.bin_splats` computes the cover in blocks of splats
and `render.blend` walks the tiles in groups of `render.TILE_GROUP`, so a
frame of 25-47 M instances fits a card. Plain PyTorch in float32 with TF32
off; nothing of the program or of JAX is imported.
"""
from __future__ import annotations

import contextlib

import torch

from perfbench.reference import render as R
from perfbench.reference.camera import View

UNCUT = 1 << 62  # a cut that no frame reaches


@contextlib.contextmanager
def no_tf32():
    """float32 matrix products (the blend's colour sum) in float32, not TF32."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def render_frame(p: dict, sh_degree: int, view: View, bg: torch.Tensor, fast: bool = True,
                 q: R.Q = R.identity) -> tuple[torch.Tensor, int]:
    """(the served frame [3, H, W], its live instances), every instance kept:
    the render-only blend if `fast`, else the exact one."""
    with torch.no_grad(), no_tf32():
        s = R.preprocess(p, sh_degree, view, q=q)
        b = R.bin_splats(s, R.make_grid(view.width, view.height), UNCUT)
        rgb, t, _ = R.blend(b, exact=not fast)
        return q(R.compose(rgb, t, bg, b.grid)[0]), b.total
