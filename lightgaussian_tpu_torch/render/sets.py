"""Batch rendering of camera sets and trajectories to PNG directories.

Port of `lightgaussian_tpu/render/sets.py`: train/test stills into
`{renders,gt}/` for the metrics tools, and trajectory frames (ellipse,
circular, spherical, spherify, spiral) with cached-binning reuse between
keyframes, gated on measured splat drift. When a process group of more
than one process runs (torchrun), stills and trajectory frames go through
the strip renderer (`parallel.render`, every process on the ``space``
axis; each trajectory frame fresh), and only rank 0 writes files.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.models.gaussians import GaussianScene
from lightgaussian_tpu_torch.ops.rasterize import build_binning, render
from lightgaussian_tpu_torch.ops.rasterize.binning import MAX_CAPACITY, snug_capacity
from lightgaussian_tpu_torch.ops.rasterize.projection import NEAR_PLANE
from lightgaussian_tpu_torch.parallel import parallel_render
from lightgaussian_tpu_torch.parallel.mesh import is_multi_process
from lightgaussian_tpu_torch.render import poses as pose_gen
from lightgaussian_tpu_torch.utils import image_io


def save_png(img: torch.Tensor, path: str | Path) -> None:
    """[3, H, W] float in [0,1] -> 8-bit PNG (rounded as the JAX package rounds)."""
    arr = torch.clamp(torch.nan_to_num(img.detach()), 0.0, 1.0).cpu().numpy()
    arr = (arr.transpose(1, 2, 0) * 255.0 + 0.5).astype(np.uint8)
    image_io.write_png(path, arr)


@torch.no_grad()
def render_set(
    model_path: str | Path,
    name: str,
    iteration: int,
    cameras: list[Camera],
    scene: GaussianScene,
    bg: torch.Tensor,
    max_instances: int | None = None,
) -> Path:
    """Render every camera with the render-only kernel (its difference from
    the exact one is below PNG quantization) and write renders/ and gt/ PNGs
    under `<model_path>/<name>/ours_<iteration>/`. Without `max_instances`
    every live instance is rendered."""
    base = Path(model_path) / name / f"ours_{iteration}"
    multi = is_multi_process()
    images = None
    if multi and cameras and len({(c.width, c.height) for c in cameras}) == 1:
        images = parallel_render(scene, cameras, bg, max_instances=max_instances)  # every rank takes part
    if multi and dist.get_rank() != 0:
        return base
    if images is None:
        # one process; under torchrun, rank 0 alone renders a set of mixed resolutions
        images = (render(scene, cam, bg, max_instances=max_instances, fast=True).render for cam in cameras)
    for idx, (img, cam) in enumerate(zip(images, cameras)):
        save_png(img, base / "renders" / f"{idx:05d}.png")
        if cam.gt_image is not None:
            save_png(cam.gt_image, base / "gt" / f"{idx:05d}.png")
    return base


def _sample_means(scene: GaussianScene, k: int) -> np.ndarray:
    """A fixed subset of the alive Gaussians' centres for host-side drift
    estimation (the JAX package's draw, so both sample the same ones)."""
    means = scene.means.detach().cpu().numpy()
    idx = np.flatnonzero(scene.alive.cpu().numpy())
    if idx.size == 0:
        idx = np.arange(means.shape[0])
    if idx.size > k:
        idx = np.random.default_rng(0).choice(idx, size=k, replace=False)
    return means[idx]


def _project_np(means: np.ndarray, cam: Camera):
    """Host-side mirror of the preprocess's screen mapping: world -> clip
    -> NDC -> pixel centres, and the camera-space depth."""
    fp = cam.full_proj.cpu().numpy()
    wv = cam.world_view.cpu().numpy()
    ph = means @ fp[:3, :3].T + fp[:3, 3]
    pw = means @ fp[3, :3] + fp[3, 3]
    ndc = ph[:, :2] / (pw[:, None] + 1e-7)
    size = np.array([cam.width, cam.height], np.float64)
    xy = ((ndc + 1.0) * size - 1.0) * 0.5
    z = means @ wv[2, :3] + wv[2, 3]
    return xy, z


# The drift plan follows this many alive Gaussians, those whose keyframe
# position lies within this many pixels of the image.
DRIFT_SAMPLE = 4096
DRIFT_MARGIN_PX = 64.0


def plan_rebin_schedule(scene: GaussianScene, frames: list[Camera], rebin_every: int, drift_px: float) -> list[bool]:
    """Keyframe plan for cached-binning reuse, gated on measured splat drift.

    Frame i rebins iff the largest screen-space displacement (pixels) of a
    sampled in-frustum subset of splats since the last keyframe exceeds
    `drift_px`, or `rebin_every` frames have passed. A drift of about 1 px
    is harmless: `tile_rect` pads every splat's tile footprint by 1 px, so
    the stale tile ranges still cover the support, and the blend uses fresh
    features. All decisions are numpy over the whole trajectory, made
    before any frame renders."""
    means = _sample_means(scene, DRIFT_SAMPLE)
    proj = [_project_np(means, c) for c in frames]
    margin = DRIFT_MARGIN_PX
    flags = [True]
    key = 0
    for i in range(1, len(frames)):
        xy0, z0 = proj[key]
        xy1, z1 = proj[i]
        w, h = frames[i].width, frames[i].height
        vis = (
            (z0 > NEAR_PLANE) & (z1 > NEAR_PLANE)
            & (xy0[:, 0] > -margin) & (xy0[:, 0] < w + margin)
            & (xy0[:, 1] > -margin) & (xy0[:, 1] < h + margin)
        )
        drift = float(np.linalg.norm(xy1[vis] - xy0[vis], axis=1).max()) if vis.any() else np.inf
        if (i - key) >= rebin_every or drift > drift_px:
            flags.append(True)
            key = i
        else:
            flags.append(False)
    return flags


def trajectory_frames(kind: str, cameras: list[Camera], n_frames: int, radius: float) -> list[Camera]:
    """The cameras of a trajectory of `kind`, with the first camera's
    intrinsics; the circular kind orbits camera 13 (or the last)."""
    template = cameras[0]
    if kind == "circular":
        ref_cam = cameras[min(13, len(cameras) - 1)]
        return [pose_gen.circular_pose(ref_cam, radius, 2.0 * np.pi * i / n_frames) for i in range(n_frames)]
    if kind == "ellipse":
        w2cs = pose_gen.generate_ellipse_path(cameras, n_frames=n_frames)
    elif kind == "spherical":
        w2cs = pose_gen.generate_spherical_sample_path(cameras, n=n_frames)
    elif kind == "spherify":
        w2cs = pose_gen.generate_spherify_path(cameras, n_frames=n_frames)
    elif kind == "spiral":
        w2cs = pose_gen.generate_spiral_path_focal(cameras, n_frames=n_frames)
    else:
        raise ValueError(f"unknown trajectory kind {kind!r}")
    return [pose_gen.camera_from_w2c(p, template) for p in w2cs]


TRAJECTORY_DIRS = {"ellipse": "video", "circular": "circular", "spherical": "spherical",
                   "spherify": "spherify", "spiral": "spiral"}


@torch.no_grad()
def render_trajectory(
    model_path: str | Path,
    kind: str,
    iteration: int,
    cameras: list[Camera],
    scene: GaussianScene,
    bg: torch.Tensor,
    max_instances: int,
    n_frames: int = 600,
    radius: float = 0.5,
    rebin_every: int = 8,
    drift_px: float = 1.5,
) -> Path:
    """Trajectory frames into `<model_path>/<dir of kind>/ours_<iteration>/`,
    through the render-only kernel.

    `rebin_every` bounds the frames between fresh binnings; the gate that
    acts is `drift_px` (`plan_rebin_schedule`). A keyframe whose binning the
    next frame does not reuse renders fresh in one call; the others bin once
    and render over the binning, as do the frames that reuse it. The same
    frames take the same path as in the JAX package.

    The instance buffer is sized per frame, so of the JAX package's capacity
    policy one rule is left: when a frame's live count reaches the cut, the
    cut rises to `snug_capacity` of the count, at most the port's ceiling
    `MAX_CAPACITY` (a line says so), and the frame renders again."""
    base = Path(model_path) / TRAJECTORY_DIRS[kind] / f"ours_{iteration}"
    frames = trajectory_frames(kind, cameras, n_frames, radius)

    if is_multi_process():
        # every frame fresh through the strip renderer: strips scale with
        # the processes, and the reuse plan below is per device
        images = parallel_render(scene, frames, bg, max_instances=max_instances)
        if dist.get_rank() == 0:
            for idx, img in enumerate(images):
                save_png(img, base / f"{idx:05d}.png")
        return base

    cap = max_instances

    def grown(idx: int, total: int, again: str) -> bool:
        """Raise the cut past a frame whose live count reaches it."""
        nonlocal cap
        if total < cap:
            return False
        grown_cap = min(snug_capacity(total), MAX_CAPACITY)
        print(f"[{kind} frame {idx}] {total} live instances reach the cut {cap}; growing it to "
              f"{grown_cap} and {again} the frame again (the ceiling is MAX_CAPACITY {MAX_CAPACITY}, "
              "the int32 tile ranges')")
        cap = grown_cap
        return True

    def fresh(idx, cam):
        out = render(scene, cam, bg, max_instances=cap, fast=True)
        if grown(idx, out.num_instances, "rendering"):
            out = render(scene, cam, bg, max_instances=cap, fast=True)
        return out.render

    def keyframe(idx, cam):
        b = build_binning(scene, cam, max_instances=cap)
        return build_binning(scene, cam, max_instances=cap) if grown(idx, b.total, "binning") else b

    if rebin_every <= 1:
        for idx, cam in enumerate(frames):
            save_png(fresh(idx, cam), base / f"{idx:05d}.png")
        return base

    rebin = plan_rebin_schedule(scene, frames, rebin_every, drift_px)
    n = len(frames)
    reused = [idx + 1 < n and not rebin[idx + 1] for idx in range(n)]
    binning = None
    for idx, cam in enumerate(frames):
        if rebin[idx] and not reused[idx]:
            save_png(fresh(idx, cam), base / f"{idx:05d}.png")
            continue
        if rebin[idx]:
            binning = keyframe(idx, cam)
        img = render(scene, cam, bg, cached_binning=binning, fast=True).render
        save_png(img, base / f"{idx:05d}.png")
    return base
