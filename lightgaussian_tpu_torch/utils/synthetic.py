"""Synthetic scenes for tests, benchmarks and the GPU smoke run.

Port of `lightgaussian_tpu/utils/synthetic.py`: draws from
`np.random.default_rng(seed)` in the same order, so the same seed gives
bit-identical arrays in both packages.
"""
from __future__ import annotations

import dataclasses

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


PREPROCESS_STRESS_KINDS = ("ordinary", "dead", "near_plane", "tz_clamp", "fov_clamp", "colour_clamp",
                           "scales", "offscreen")


def preprocess_stress(n: int, width: int, height: int, seed: int = 0, max_sh_degree: int = 3,
                      active_sh_degree: int | None = None, device: str | torch.device = "cuda"):
    """(scene, camera, cov3d_precomp, kind) that stress the preprocess at
    every edge of its chain: a camera at the origin looking down +z with an
    identity `world_view` (so a Gaussian's camera-space position is its mean,
    exactly), and n Gaussians whose kind (`PREPROCESS_STRESS_KINDS`, int64
    index per Gaussian, in turn) is:

    - "ordinary": in front of the camera, within the frustum;
    - "dead": ordinary but not alive;
    - "near_plane": z at, one ulp above and below the near plane 0.2, or behind
      the camera;
    - "tz_clamp": z at the EWA clamp 1e-6, at 0, or negative;
    - "fov_clamp": x / z or y / z exactly at 1.3 tan(fov / 2) (either sign),
      or past it;
    - "colour_clamp": DC bands of a black point (`rgb_to_sh(0)`, which lands
      on the colour clamp's 0 exactly) and higher bands 0, on some channels;
    - "scales": sizes from e^-12 (a point) to e^2 (larger than the view);
    - "offscreen": far outside the image on either side.

    `cov3d_precomp` ([n, 6]) holds a valid covariance for every other round
    of the kinds and an indefinite one (det <= 0 after the projection) for
    the rest."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    scene = random_scene(n, seed, max_sh_degree, active_sh_degree, device="cpu")
    camera = Camera.from_Rt(np.eye(3), np.zeros(3), 0.9, 2.0 * np.arctan(np.tan(0.45) * height / width), width,
                            height, device="cpu")
    limx, limy = float(1.3 * camera.tan_fovx), float(1.3 * camera.tan_fovy)
    kind = np.arange(n) % len(PREPROCESS_STRESS_KINDS)
    z = rng.uniform(1.0, 8.0, n).astype(f32)
    x = (rng.uniform(-0.9, 0.9, n) * limx / 1.3 * z).astype(f32)
    y = (rng.uniform(-0.9, 0.9, n) * limy / 1.3 * z).astype(f32)
    alive = np.ones(n, bool)
    alive[kind == 1] = False
    near = np.array([0.2, np.nextafter(f32(0.2), f32(1)), np.nextafter(f32(0.2), f32(0)), -1.0, 0.0], f32)
    sel = kind == 2
    z[sel] = near[rng.integers(0, len(near), sel.sum())]
    tzs = np.array([1e-6, 0.0, -0.5, np.nextafter(f32(1e-6), f32(1))], f32)
    sel = kind == 3
    z[sel] = tzs[rng.integers(0, len(tzs), sel.sum())]
    sel = np.flatnonzero(kind == 4)
    z[sel] = np.array([1.0, 2.0, 4.0], f32)[rng.integers(0, 3, sel.size)]  # powers of two: lim * z is exact
    side = rng.integers(0, 4, sel.size)
    past = rng.uniform(1.0, 3.0, sel.size)
    x[sel] = np.where(side == 0, f32(limx) * z[sel], np.where(side == 1, -f32(limx) * z[sel],
                                                               (past * limx * z[sel]).astype(f32)))
    y[sel] = np.where(side == 2, f32(limy) * z[sel], np.where(side == 3, -f32(limy) * z[sel], y[sel]))
    sel = kind == 7
    x[sel] = (rng.choice([-1.0, 1.0], sel.sum()) * rng.uniform(2.0, 20.0, sel.sum()) * z[sel]).astype(f32)
    means = np.stack([x, y, z], axis=1)
    sh_dc = scene.sh_dc.numpy().copy()
    sh_rest = scene.sh_rest.numpy().copy()
    sel = np.flatnonzero(kind == 5)
    black = (f32(0.0) - f32(0.5)) / f32(sh_ops.C0)  # rgb_to_sh(0), a float32 division
    channels = rng.random((sel.size, 3)) < 0.67
    sh_dc[sel] = np.where(channels, black, sh_dc[sel])
    sh_rest[sel] = 0.0
    log_scales = scene.log_scales.numpy().copy()
    sel = kind == 6
    # one size per Gaussian, the axes within e^0.5 of it (a covariance of axes many orders apart is
    # ill-conditioned: two float32 orders of its chain rule differ there by more than rounding)
    log_scales[sel] = (rng.uniform(-12.0, 2.0, (sel.sum(), 1)) + rng.uniform(-0.5, 0.5, (sel.sum(), 3))).astype(f32)
    # an SPD covariance L L^T; on odd rows a negative yy, so that the 2D covariance's det is negative
    L = rng.normal(0.0, 0.05, (n, 3, 3))
    cov = np.einsum("nij,nkj->nik", L, L)
    odd = (np.arange(n) // len(PREPROCESS_STRESS_KINDS)) % 2 == 1
    cov[odd, 1, 1] = -rng.uniform(0.01, 0.05, odd.sum())
    cov6 = np.stack([cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2], cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]], axis=1)

    def as_t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)

    dev = torch.device(device)
    scene = dataclasses.replace(scene, means=as_t(means), sh_dc=as_t(sh_dc), sh_rest=as_t(sh_rest),
                                log_scales=as_t(log_scales), quats=scene.quats.to(dev),
                                opacity_logits=scene.opacity_logits.to(dev),
                                alive=torch.from_numpy(alive).to(dev))
    camera = dataclasses.replace(camera, **{k: getattr(camera, k).to(dev) for k in
                                            ("world_view", "full_proj", "camera_center", "tan_fovx", "tan_fovy")})
    return scene, camera, as_t(cov6), torch.from_numpy(kind)
