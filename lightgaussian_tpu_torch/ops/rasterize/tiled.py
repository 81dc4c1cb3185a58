"""Tiled blend: binning plus the blend kernels, assembled into an image.

Port of `lightgaussian_tpu/ops/rasterize/tiled.py` (`blend_tiled`,
`blend_tiled_fast`, `blend_tiled_counting`, and the cached-binning pair
`build_binning` and `blend_tiled_cached`). `blend_tiled` is differentiable: a
`torch.autograd.Function` whose forward is the exact blend (B1) and whose
backward runs the backward kernel (B2) over the forward's binning, with
the per-pixel remaining-contribution seed of the JAX VJP (`tiled.py:66-122`
there). The boundary sits after the (autograd-friendly) preprocess: inputs
are screen-space splats. The render-only blend has no backward, as in the
JAX package, and refuses inputs that require a gradient. So does the
cached blend, which renders a frame over a binning made for a camera near
it (trajectory frames). The counting
blend runs without a graph; its kernel (B5) adds each instance's statistics
to its Gaussian itself, so the JAX package's gather and segmented sum after
the kernel have no counterpart.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from lightgaussian_tpu_torch.ops.rasterize import binning as binning_mod
from lightgaussian_tpu_torch.ops.rasterize import blend as blend_mod
from lightgaussian_tpu_torch.ops.rasterize.binning import (
    FEAT_B,
    FEAT_CA,
    FEAT_CC,
    FEAT_MX,
    FEAT_MY,
    FEAT_OPA,
    FEAT_R,
    TILE_SIZE,
    make_grid,
)
from lightgaussian_tpu_torch.ops.rasterize.projection import Splats
from lightgaussian_tpu_torch.utils import stage_marks


def _assemble_image(tile_planes: torch.Tensor, grid) -> torch.Tensor:
    """[T, C, PIX] per-tile planes -> [C, H_pad, W_pad] image."""
    c = tile_planes.shape[1]
    x = tile_planes.reshape(grid.tiles_y, grid.tiles_x, c, TILE_SIZE, TILE_SIZE)
    x = x.permute(2, 0, 3, 1, 4)
    return x.reshape(c, grid.tiles_y * TILE_SIZE, grid.tiles_x * TILE_SIZE)


def _tile_image(image: torch.Tensor, grid) -> torch.Tensor:
    """[C, H, W] -> [T, C, PIX] per-tile planes, zero-padded to the grid."""
    c, h, w = image.shape
    x = F.pad(image, (0, grid.tiles_x * TILE_SIZE - w, 0, grid.tiles_y * TILE_SIZE - h))
    x = x.reshape(c, grid.tiles_y, TILE_SIZE, grid.tiles_x, TILE_SIZE)
    return x.permute(1, 3, 0, 2, 4).reshape(grid.num_tiles, c, TILE_SIZE * TILE_SIZE).contiguous()


def _compose(tile_rgb, tile_t, bg, grid, width: int, height: int):
    img_pad = _assemble_image(tile_rgb, grid)
    t_pad = _assemble_image(tile_t, grid)[0]
    image = img_pad[:, :height, :width] + t_pad[None, :height, :width] * bg[:, None, None]
    return image, t_pad[:height, :width]


def _backward_seed(image, final_t, g_image, g_t, grid):
    """B2's inputs from the exact blend's cotangents: (the image cotangent
    per tile [T, 3, PIX], the per-pixel "remaining contribution" seed per
    tile [T, 1, PIX]). The seed is dot(rendered colour incl. background, g)
    plus the direct cotangent of final_T (both decay as -x / (1 - alpha_i)
    along the walk)."""
    r = (image * g_image).sum(dim=0) + final_t * g_t
    return _tile_image(g_image.contiguous(), grid), _tile_image(r[None].contiguous(), grid)


def _splat_grads(grads: torch.Tensor) -> tuple:
    """B2's per-Gaussian [N, FEAT_WIDTH] gradients as those of (mean2d,
    conic, color, opacity)."""
    return (grads[:, FEAT_MX:FEAT_MY + 1], grads[:, FEAT_CA:FEAT_CC + 1], grads[:, FEAT_R:FEAT_B + 1],
            grads[:, FEAT_OPA])


def _detached(splats: Splats) -> Splats:
    return Splats(**{k: v.detach() for k, v in vars(splats).items()})


class _ExactBlend(torch.autograd.Function):
    """(mean2d, conic, color, opacity, bg) -> (image, final_T) over a
    binning made beforehand; depth and radius only order and place the
    instances and get no gradient."""

    @staticmethod
    def forward(ctx, mean2d, conic, color, opacity, bg, b, grid, width, height):
        tile_rgb, tile_t = blend_mod.blend_forward(b.tile_starts, b.inst, grid)
        stage_marks.mark("B1")
        image, final_t = _compose(tile_rgb, tile_t, bg, grid, width, height)
        stage_marks.mark("compose")
        ctx.save_for_backward(image, final_t)
        ctx.binning, ctx.grid, ctx.n = b, grid, mean2d.shape[0]
        return image, final_t

    @staticmethod
    def backward(ctx, g_image, g_t):
        stage_marks.mark("loss backward")
        image, final_t = ctx.saved_tensors
        b, grid = ctx.binning, ctx.grid
        if g_image is None:
            g_image = torch.zeros_like(image)
        if g_t is None:
            g_t = torch.zeros_like(final_t)
        tile_g, tile_r = _backward_seed(image, final_t, g_image, g_t, grid)
        grads = blend_mod.blend_backward(b.tile_starts, b.inst, b.gid_sorted, tile_g, tile_r, grid, ctx.n)
        d_bg = (final_t[None] * g_image).sum(dim=(1, 2))
        stage_marks.mark("B2 + reduce")
        return (*_splat_grads(grads), d_bg, None, None, None, None)


def blend_tiled(
    splats: Splats,
    bg: torch.Tensor,
    width: int,
    height: int,
    max_instances: int,
):
    """Exact blend (kernel B1; backward B2). Returns (image [3,H,W], final_T
    [H,W], total) with `total` the live instance count (compare with
    `max_instances`). Differentiable in mean2d, conic, color, opacity and bg."""
    grid = make_grid(width, height)
    with torch.no_grad():
        b = binning_mod.bin_splats(_detached(splats), grid, max_instances)
    stage_marks.mark("binning")
    image, final_t = _ExactBlend.apply(
        splats.mean2d, splats.conic, splats.color, splats.opacity, bg, b, grid, width, height
    )
    return image, final_t, b.total


def _refuse_gradients(splats: Splats, bg: torch.Tensor, what: str) -> None:
    tensors = (splats.mean2d, splats.conic, splats.color, splats.opacity, bg)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"the {what} has no backward; render with fast=False and no cached "
            "binning for gradients, or under torch.no_grad()"
        )


def blend_tiled_fast(
    splats: Splats,
    bg: torch.Tensor,
    width: int,
    height: int,
    max_instances: int,
):
    """Render-only blend (kernel B6): the inference path. The image differs
    from `blend_tiled`'s only on saturated pixels, by under 1e-2. It has no
    backward, as in the JAX package: inputs that require a gradient raise."""
    _refuse_gradients(splats, bg, "render-only blend")
    grid = make_grid(width, height)
    b = binning_mod.bin_splats(splats, grid, max_instances)
    stage_marks.mark("binning")
    tile_rgb, tile_t = blend_mod.blend_forward_fast(b.tile_starts, b.inst, grid)
    stage_marks.mark("B6")
    image, final_t = _compose(tile_rgb, tile_t, bg, grid, width, height)
    stage_marks.mark("compose")
    return image, final_t, b.total


@torch.no_grad()
def build_binning(splats: Splats, width: int, height: int, max_instances: int) -> binning_mod.Binning:
    """Bin splats for later reuse by `blend_tiled_cached`."""
    return binning_mod.bin_splats(splats, make_grid(width, height), max_instances)


def blend_tiled_cached(
    splats: Splats,
    bg: torch.Tensor,
    width: int,
    height: int,
    cached: binning_mod.Binning,
    fast: bool = False,
):
    """Blend over a cached binning's (tile | depth) order with the features
    of `splats` gathered anew (`binning.rebind_features`): the sorts are
    skipped. The render-only kernel (B6) when `fast`, else the exact one
    (B1). Forward only: inputs that require a gradient raise. Returns
    (image, final_T, the keyframe's total)."""
    _refuse_gradients(splats, bg, "cached blend")
    grid = make_grid(width, height)
    b = binning_mod.rebind_features(splats, cached)
    stage_marks.mark("rebind")
    fwd = blend_mod.blend_forward_fast if fast else blend_mod.blend_forward
    tile_rgb, tile_t = fwd(b.tile_starts, b.inst, grid)
    stage_marks.mark("B6" if fast else "B1")
    image, final_t = _compose(tile_rgb, tile_t, bg, grid, width, height)
    stage_marks.mark("compose")
    return image, final_t, b.total


@torch.no_grad()
def blend_tiled_counting(
    splats: Splats,
    bg: torch.Tensor,
    width: int,
    height: int,
    max_instances: int,
):
    """Counting blend (kernel B5), not differentiable. Returns (image,
    final_T, total, count int32 [N], importance float32 [N]): the exact
    blend's image, and per Gaussian the pixels it was blended into and its
    summed blending weight over them."""
    grid = make_grid(width, height)
    b = binning_mod.bin_splats(_detached(splats), grid, max_instances)
    stage_marks.mark("binning")
    tile_rgb, tile_t, imp, cnt = blend_mod.blend_forward_counting(
        b.tile_starts, b.inst, b.gid_sorted, grid, splats.mean2d.shape[0]
    )
    stage_marks.mark("B5")
    image, final_t = _compose(tile_rgb, tile_t, bg, grid, width, height)
    stage_marks.mark("compose")
    return image, final_t, b.total, cnt, imp
