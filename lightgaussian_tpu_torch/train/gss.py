"""Global Significance Score (GSS) pruning.

Port of `lightgaussian_tpu/train/gss.py`. `accumulate_gss` sweeps the
training cameras with the counting render (kernel B5) and sums each
Gaussian's blending weight and hit count; `calculate_v_imp_score` scales
the weight by the normalised volume to the power `v_pow`;
`percentile_keep_mask` keeps what scores above the `percent` quantile of the
alive Gaussians.

The two quantile indices are float32 products cut to an integer, as the JAX
package computes them: a float64 product differs by one at some alive
counts, and then another Gaussian is pruned.
"""
from __future__ import annotations

from typing import Iterable

import torch

from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.models.gaussians import GaussianScene
from lightgaussian_tpu_torch.ops.rasterize import count_render


def accumulate_gss(scene: GaussianScene, cameras: Iterable[Camera], bg: torch.Tensor, max_instances: int):
    """(hit count int32 [N], importance float32 [N]) summed over `cameras`,
    one counting render each."""
    dev = scene.means.device
    counts = torch.zeros(scene.capacity, dtype=torch.int32, device=dev)
    imp = torch.zeros(scene.capacity, dtype=torch.float32, device=dev)
    for cam in cameras:
        out = count_render(scene, cam, bg, max_instances=max_instances)
        counts = counts + out.gaussians_count
        imp = imp + out.important_score
    return counts, imp


def accumulate_gss_auto(scene: GaussianScene, cameras: Iterable[Camera], bg: torch.Tensor, max_instances: int):
    """`accumulate_gss` for cameras as a training loop holds them: the
    cached SSIM planes, which a counting render never reads, are dropped.
    One device; the sweep sharded over several comes with the multi-device
    slice."""
    return accumulate_gss(scene, [c.with_gt_ssim_stats(None) for c in cameras], bg, max_instances)


def _f32_index(fraction: float, n_alive: torch.Tensor) -> torch.Tensor:
    """int(float32(fraction) * float32(n_alive)), the product in float32."""
    frac = torch.tensor(fraction, dtype=torch.float32, device=n_alive.device)
    return (frac * n_alive.to(torch.float32)).to(torch.int64)


@torch.no_grad()
def calculate_v_imp_score(scene: GaussianScene, imp_list: torch.Tensor, v_pow: float) -> torch.Tensor:
    """(volume / the volume at the 90% place of the descending order)^v_pow
    * importance, over alive Gaussians; 0 on dead slots."""
    volume = torch.prod(scene.scales, dim=1)
    masked = torch.where(scene.alive, volume, -torch.inf)
    sorted_desc = torch.sort(masked, descending=True).values
    index = _f32_index(0.9, scene.alive.sum())
    kth_percent_largest = sorted_desc[torch.clamp(index, max=scene.capacity - 1)]
    v_list = torch.pow(volume / kth_percent_largest, v_pow) * imp_list
    return torch.where(scene.alive, v_list, 0.0)


@torch.no_grad()
def percentile_keep_mask(scene: GaussianScene, scores: torch.Tensor, percent: float) -> torch.Tensor:
    """keep = score > the value at the `percent` quantile among alive
    Gaussians (strict: what ties with the threshold is pruned)."""
    masked = torch.where(scene.alive, scores, torch.inf)
    sorted_asc = torch.sort(masked).values
    idx = torch.clamp(_f32_index(percent, scene.alive.sum()), 0, scene.capacity - 1)
    return scores > sorted_asc[idx]
