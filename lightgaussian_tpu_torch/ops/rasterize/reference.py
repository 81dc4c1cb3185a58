"""Oracle rasterizer: exact, plain torch, without tiles.

Port of `lightgaussian_tpu/ops/rasterize/reference.py:blend_reference`,
with its tile restriction always on (as `render(method="reference")` asks
for it). Every (Gaussian, pixel) pair whose 32-px pixel tile overlaps the
Gaussian's 3-sigma rect is considered, in depth order, with the reference's skip
(alpha < 1/255), clamp (alpha <= 0.99) and early stop (T*(1-alpha) < 1e-4
=> not applied, T frozen). The stop is the masked-prefix form: with T_i the
naive transmittance (product over all eligible earlier alphas) the test
T_i*(1-alpha_i) >= T_EPS is monotone in i, so "apply iff it passes" equals
the sequential frozen-T rule.

Slow (O(N * H * W)): the test oracle for tiny scenes, and with
`with_counts` the oracle of the counting blend.
"""
from __future__ import annotations

import torch

from lightgaussian_tpu_torch.ops.rasterize import binning as binning_mod
from lightgaussian_tpu_torch.ops.rasterize.projection import (
    ALPHA_EPS,
    MAX_ALPHA,
    T_EPS,
    Splats,
)

_CHUNK = 64  # Gaussians blended at once


def blend_reference(
    splats: Splats,
    width: int,
    height: int,
    bg: torch.Tensor,
    with_counts: bool = False,
):
    """Blend depth-sorted splats over the full image, each Gaussian
    restricted to pixels whose tile overlaps its radius rect (as the tiled
    path does).

    Returns:
      image [3, H, W], final_T [H, W], and with `with_counts` the pair
      (count int32 [N], importance float32 [N]) in the original Gaussian
      order: the pixels each Gaussian was blended into, and its summed
      blending weight alpha * T over them.
    """
    dev = splats.mean2d.device
    order = torch.argsort(splats.depth, stable=True)
    mean2d = splats.mean2d[order]
    conic = splats.conic[order]
    color = splats.color[order]
    opacity = splats.opacity[order]
    radius = splats.radius[order]

    hw = height * width
    pix_x = torch.arange(width, dtype=torch.float32, device=dev).repeat(height)  # [HW]
    pix_y = torch.arange(height, dtype=torch.float32, device=dev).repeat_interleave(width)
    grid = binning_mod.make_grid(width, height)
    tile_px = (pix_x / binning_mod.TILE_SIZE).to(torch.int64)
    tile_py = (pix_y / binning_mod.TILE_SIZE).to(torch.int64)

    rgb_acc = torch.zeros((hw, 3), dtype=torch.float32, device=dev)
    t_naive = torch.ones(hw, dtype=torch.float32, device=dev)
    t_actual = torch.ones(hw, dtype=torch.float32, device=dev)
    w_sums, hit_counts = [], []
    for c0 in range(0, order.numel(), _CHUNK):
        m2 = mean2d[c0:c0 + _CHUNK]
        con = conic[c0:c0 + _CHUNK]
        col = color[c0:c0 + _CHUNK]
        opa = opacity[c0:c0 + _CHUNK]
        rad = radius[c0:c0 + _CHUNK]
        dx = pix_x[None, :] - m2[:, 0:1]  # [chunk, HW]
        dy = pix_y[None, :] - m2[:, 1:2]
        power = -0.5 * (con[:, 0:1] * dx * dx + con[:, 2:3] * dy * dy) - con[:, 1:2] * dx * dy
        alpha = torch.clamp(opa[:, None] * torch.exp(power), max=MAX_ALPHA)
        lo_x, lo_y, hi_x, hi_y, _ = binning_mod.tile_rect(m2, rad, grid)
        in_rect = (
            (tile_px[None, :] >= lo_x[:, None])
            & (tile_px[None, :] < hi_x[:, None])
            & (tile_py[None, :] >= lo_y[:, None])
            & (tile_py[None, :] < hi_y[:, None])
        )
        eligible = (power <= 0.0) & (alpha >= ALPHA_EPS) & (rad[:, None] > 0) & in_rect
        alpha = torch.where(eligible, alpha, 0.0)

        # Naive transmittance prefix within the chunk, seeded by the carry.
        log1m = torch.log1p(-alpha)
        ecs = torch.cumsum(log1m, dim=0) - log1m  # exclusive prefix
        t_i = t_naive[None, :] * torch.exp(ecs)
        apply = (t_i * (1.0 - alpha)) >= T_EPS
        w = torch.where(apply, alpha * t_i, 0.0)  # [chunk, HW]
        rgb_acc = rgb_acc + w.T @ col
        t_naive = t_naive * torch.exp(torch.sum(log1m, dim=0))
        t_actual = t_actual * torch.exp(torch.sum(torch.where(apply, log1m, 0.0), dim=0))
        if with_counts:
            w_sums.append(w.sum(dim=1))
            hit_counts.append((w > 0.0).sum(dim=1))

    image = rgb_acc + t_actual[:, None] * bg[None, :]
    image = image.T.reshape(3, height, width)
    final_t = t_actual.reshape(height, width)
    if not with_counts:
        return image, final_t
    n = order.numel()
    imp = torch.zeros(n, dtype=torch.float32, device=dev)
    cnt = torch.zeros(n, dtype=torch.int32, device=dev)
    if n:
        imp[order] = torch.cat(w_sums)
        cnt[order] = torch.cat(hit_counts).to(torch.int32)
    return image, final_t, cnt, imp
