"""Tiled blend: binning plus the blend kernels, assembled into an image.

Port of the forward of `lightgaussian_tpu/ops/rasterize/tiled.py`
(`blend_tiled`, `blend_tiled_fast`). The backward (an autograd.Function over
the exact blend) comes with the training slice; until then both blends
refuse inputs that require a gradient rather than return an image that
silently carries none.
"""
from __future__ import annotations

import torch

from lightgaussian_tpu_torch.ops.rasterize import binning as binning_mod
from lightgaussian_tpu_torch.ops.rasterize import blend as blend_mod
from lightgaussian_tpu_torch.ops.rasterize.binning import TILE_SIZE, make_grid
from lightgaussian_tpu_torch.ops.rasterize.projection import Splats


def _assemble_image(tile_planes: torch.Tensor, grid) -> torch.Tensor:
    """[T, C, PIX] per-tile planes -> [C, H_pad, W_pad] image."""
    c = tile_planes.shape[1]
    x = tile_planes.reshape(grid.tiles_y, grid.tiles_x, c, TILE_SIZE, TILE_SIZE)
    x = x.permute(2, 0, 3, 1, 4)
    return x.reshape(c, grid.tiles_y * TILE_SIZE, grid.tiles_x * TILE_SIZE)


def _compose(tile_rgb, tile_t, bg, grid, width: int, height: int):
    img_pad = _assemble_image(tile_rgb, grid)
    t_pad = _assemble_image(tile_t, grid)[0]
    image = img_pad[:, :height, :width] + t_pad[None, :height, :width] * bg[:, None, None]
    return image, t_pad[:height, :width]


def _refuse_grad(splats: Splats, bg: torch.Tensor) -> None:
    tensors = (splats.mean2d, splats.conic, splats.color, splats.opacity, bg)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the tiled blend has no backward yet (it comes with the training "
            "slice, ROADMAP A slice 2); render under torch.no_grad() or detach"
        )


def _blend(splats, bg, width, height, max_instances, fast: bool):
    _refuse_grad(splats, bg)
    grid = make_grid(width, height)
    b = binning_mod.bin_splats(splats, grid, max_instances)
    kernel = blend_mod.blend_forward_fast if fast else blend_mod.blend_forward
    tile_rgb, tile_t = kernel(b.tile_starts, b.inst, grid)
    image, final_t = _compose(tile_rgb, tile_t, bg, grid, width, height)
    return image, final_t, b.total


def blend_tiled(
    splats: Splats,
    bg: torch.Tensor,
    width: int,
    height: int,
    max_instances: int,
):
    """Exact blend (kernel B1). Returns (image [3,H,W], final_T [H,W], total)
    with `total` the live instance count (compare with `max_instances`)."""
    return _blend(splats, bg, width, height, max_instances, fast=False)


def blend_tiled_fast(
    splats: Splats,
    bg: torch.Tensor,
    width: int,
    height: int,
    max_instances: int,
):
    """Render-only blend (kernel B6): the inference path. The image differs
    from `blend_tiled`'s only on saturated pixels, by under 1e-2."""
    return _blend(splats, bg, width, height, max_instances, fast=True)
