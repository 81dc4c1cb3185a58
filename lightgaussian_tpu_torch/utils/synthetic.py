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
from lightgaussian_tpu_torch.ops.rasterize.binning import TILE_SIZE
from lightgaussian_tpu_torch.ops.rasterize.projection import ALPHA_EPS, Splats


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


COVER_STRESS_KINDS = ("large", "alpha_eps", "offscreen", "behind", "radius0", "grazing")


def cover_stress_splats(kind: str, n: int, width: int, height: int, seed: int = 0,
                        device: str | torch.device = "cuda"):
    """n screen-space Gaussians that stress binning's tile cover on a
    width x height image, one kind of `COVER_STRESS_KINDS`:

    - "large": rects of more than 32 tiles (radius 150-600 px, round and
      elongated) beside small ones that take the exact mask;
    - "alpha_eps": opacities at 1/255 in float32, a few ulps below and
      above it, and just above it, where the splat lives or is dropped;
    - "offscreen": means up to 700 px outside the image on every side;
    - "behind": what the projection leaves of Gaussians behind the camera
      (radius 0, opacity 0, means of +-inf, NaN or +-1e30, conics 0 or
      NaN), and such means under a positive radius;
    - "radius0": radius 0 under otherwise ordinary splats;
    - "grazing": axis-aligned and slightly rotated ellipses whose alpha
      support ends within a few ulps of a neighbouring tile's box.
    """
    rng = np.random.default_rng(seed)
    f32 = np.float32
    mean = rng.uniform([0.0, 0.0], [width, height], (n, 2))
    s1, s2 = rng.uniform(0.5, 12.0, n), rng.uniform(0.5, 12.0, n)
    theta = rng.uniform(0.0, np.pi, n)
    opacity = rng.uniform(0.05, 1.0, n)
    radius = np.ceil(3.0 * np.maximum(s1, s2)).astype(np.int64)
    if kind == "large":
        big = rng.random(n) < 0.5
        s1 = np.where(big, rng.uniform(50.0, 200.0, n), s1)
        s2 = np.where(big, rng.uniform(5.0, 200.0, n), s2)
        radius = np.ceil(3.0 * np.maximum(s1, s2)).astype(np.int64)
    elif kind == "alpha_eps":
        ulps = rng.integers(-4, 5, n).astype(np.int32)  # float32 1/255 moved by up to 4 ulps
        opacity = (np.array([ALPHA_EPS], f32).view(np.int32) + ulps).view(f32)
        opacity = np.where(rng.random(n) < 0.25, rng.uniform(ALPHA_EPS, 1.02 * ALPHA_EPS, n), opacity)
    elif kind == "offscreen":
        side = rng.integers(0, 4, n)
        off = rng.uniform(1.0, 700.0, n)
        mean[side == 0, 0] = -off[side == 0]
        mean[side == 1, 0] = width + off[side == 1]
        mean[side == 2, 1] = -off[side == 2]
        mean[side == 3, 1] = height + off[side == 3]
        s1 = np.where(rng.random(n) < 0.3, rng.uniform(20.0, 150.0, n), s1)
        radius = np.ceil(3.0 * np.maximum(s1, s2)).astype(np.int64)
    elif kind == "behind":
        bad = np.array([np.inf, -np.inf, np.nan, 1e30, -1e30])
        mean = bad[rng.integers(0, len(bad), (n, 2))]
        culled = rng.random(n) < 0.75
        radius = np.where(culled, 0, radius)
        opacity = np.where(culled, 0.0, opacity)
    elif kind == "radius0":
        radius = np.where(rng.random(n) < 0.5, 0, radius)
    elif kind != "grazing":
        raise ValueError(f"unknown stress kind {kind!r}; expected one of {COVER_STRESS_KINDS}")
    c, sn, i1, i2 = np.cos(theta), np.sin(theta), 1.0 / s1**2, 1.0 / s2**2
    conic = np.stack([c * c * i1 + sn * sn * i2, c * sn * (i1 - i2), sn * sn * i1 + c * c * i2], axis=1)
    if kind == "behind":
        conic = np.where((rng.random(n) < 0.5)[:, None], 0.0,
                         np.where((rng.random(n) < 0.5)[:, None], np.nan, conic))
    if kind == "grazing":
        # The ellipse's support along x ends d px short of (or past) the
        # margin box of the next tile to the right: ca = q / d^2 scaled by
        # a few ulps, q = 2 ln(opacity / ALPHA_EPS).
        tx = rng.integers(0, -(-width // TILE_SIZE) - 1, n)
        ty = rng.integers(0, -(-height // TILE_SIZE), n)
        mean = np.stack([tx * TILE_SIZE + rng.uniform(4.0, 28.0, n), ty * TILE_SIZE + rng.uniform(4.0, 28.0, n)],
                        axis=1)
        d = (tx + 1) * TILE_SIZE - 0.25 - mean[:, 0]  # 0.25: binning's margin around a tile's pixel centres
        q = 2.0 * np.log(opacity / ALPHA_EPS)
        ca = q / d**2 * (1.0 + rng.integers(-6, 7, n) * 2.0**-23)
        cc = rng.uniform(0.5, 2.0, n) * ca
        cb = np.where(rng.random(n) < 0.5, 0.0, rng.uniform(-1e-3, 1e-3, n) * np.sqrt(ca * cc))
        conic = np.stack([ca, cb, cc], axis=1)
        radius = np.ceil(3.0 * np.sqrt(np.maximum(1.0 / ca, 1.0 / cc))).astype(np.int64) + 1

    def as_t(a, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    return Splats(
        mean2d=as_t(mean.astype(f32)),
        conic=as_t(conic.astype(f32)),
        color=as_t(rng.uniform(0.0, 1.0, (n, 3)).astype(f32)),
        opacity=as_t(np.asarray(opacity, f32)),
        depth=as_t(rng.uniform(1.0, 9.0, n).astype(f32)),
        radius=as_t(radius.astype(np.int32), torch.int32),
    )
