"""Synthetic scenes for tests, benchmarks and the GPU smoke run.

Port of `lightgaussian_tpu/utils/synthetic.py`: draws from
`np.random.default_rng(seed)` in the same order, so the same seed gives
bit-identical arrays in both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.models.gaussians import GaussianScene, empty_scene, fill_scene
from lightgaussian_tpu_torch.ops import sh as sh_ops


def random_scene(
    n: int = 512,
    seed: int = 0,
    max_sh_degree: int = 3,
    active_sh_degree: int | None = None,
    capacity: int | None = None,
    extent: float = 1.0,
    scale_range=(0.01, 0.08),
    device: str | torch.device = "cuda",
) -> GaussianScene:
    rng = np.random.default_rng(seed)
    cap = n if capacity is None else capacity
    active = max_sh_degree if active_sh_degree is None else active_sh_degree
    scene = empty_scene(cap, max_sh_degree, active, device=device)
    k_rest = sh_ops.num_sh_coeffs(max_sh_degree) - 1
    arrays = dict(
        means=rng.uniform(-extent, extent, (n, 3)).astype(np.float32),
        sh_dc=rng.normal(0.0, 0.5, (n, 3)).astype(np.float32),
        sh_rest=rng.normal(0.0, 0.05, (n, k_rest, 3)).astype(np.float32),
        log_scales=np.log(rng.uniform(*scale_range, (n, 3))).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opacity_logits=rng.uniform(-1.0, 3.0, (n,)).astype(np.float32),
    )
    return fill_scene(scene, arrays, n)


def default_camera(
    width: int = 96, height: int = 64, dist: float = 4.0, device: str | torch.device = "cuda"
) -> Camera:
    return Camera.look_at(
        eye=[0.3, -0.2, -dist], target=[0.0, 0.0, 0.0], width=width, height=height,
        device=device,
    )
