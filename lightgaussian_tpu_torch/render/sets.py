"""Batch rendering of camera sets to PNG directories.

Port of `save_png` and `render_set` of `lightgaussian_tpu/render/sets.py`:
train/test stills into `{renders,gt}/` for the metrics tools. Single
device; the multi-device strip renderer and trajectories come with later
slices.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.models.gaussians import GaussianScene
from lightgaussian_tpu_torch.ops.rasterize import render
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
    max_instances: int,
) -> Path:
    """Render every camera with the render-only kernel (its difference from
    the exact one is below PNG quantization) and write renders/ and gt/ PNGs
    under `<model_path>/<name>/ours_<iteration>/`."""
    base = Path(model_path) / name / f"ours_{iteration}"
    for idx, cam in enumerate(cameras):
        img = render(scene, cam, bg, max_instances=max_instances, fast=True).render
        save_png(img, base / "renders" / f"{idx:05d}.png")
        if cam.gt_image is not None:
            save_png(cam.gt_image, base / "gt" / f"{idx:05d}.png")
    return base
