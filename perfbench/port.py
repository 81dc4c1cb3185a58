"""The system under test's objects, made from the benchmark's inputs.

The port (`lightgaussian_tpu_torch`) is the only package of the program the
benchmark imports; these are the calls its CLIs make to hold a scene and a
camera, and the trainer's rule for its instance cut.
"""
from __future__ import annotations

import numpy as np
import torch

from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.models.gaussians import GaussianScene
from lightgaussian_tpu_torch.ops.rasterize.binning import MAX_CAPACITY, snug_capacity
from lightgaussian_tpu_torch.train.loop import GROW_TRIGGER


def scene(p: dict, degree: int) -> GaussianScene:
    """A scene of the Gaussians `p`, every slot alive, all SH bands active."""
    n = p["means"].shape[0]
    return GaussianScene(alive=torch.ones(n, dtype=torch.bool, device=p["means"].device),
                         active_sh_degree=degree, max_sh_degree=degree, **p)


def camera(eye: np.ndarray, target: np.ndarray, cfg: dict, device: torch.device) -> Camera:
    return Camera.look_at(eye=eye, target=target, fovx=cfg["cameras"]["fovx"], width=cfg["width"],
                          height=cfg["height"], device=device)


def grown_cut(cut: int, live: int) -> int:
    """The training loop's cut after a step with `live` instances: grown to
    `snug_capacity` once the count passes GROW_TRIGGER of it."""
    if live > GROW_TRIGGER * cut:
        return min(snug_capacity(live), MAX_CAPACITY)
    return cut
