"""Carry scenes and cameras across from host arrays.

The JAX package's `GaussianScene` and `Camera` are dataclasses of arrays; a
caller that holds one hands its fields over as numpy arrays, and these
functions build the port's counterpart on a device. Both packages then
compute from the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.models.gaussians import GaussianScene
from lightgaussian_tpu_torch.utils.device import resolve_device


def scene_from_numpy(
    arrays: dict,
    alive: np.ndarray,
    active_sh_degree: int,
    max_sh_degree: int,
    device: str | torch.device = "cuda",
) -> GaussianScene:
    """`arrays` maps each of `GaussianScene.PARAM_FIELDS` to a float32 array
    with the capacity as its first axis; `alive` is the bool mask."""
    dev = resolve_device(device)
    missing = set(GaussianScene.PARAM_FIELDS) - set(arrays)
    if missing:
        raise ValueError(f"missing scene arrays: {sorted(missing)}")
    params = {
        k: torch.from_numpy(np.array(arrays[k], dtype=np.float32)).to(dev)
        for k in GaussianScene.PARAM_FIELDS
    }
    return GaussianScene(
        alive=torch.from_numpy(np.asarray(alive, dtype=bool).copy()).to(dev),
        active_sh_degree=int(active_sh_degree),
        max_sh_degree=int(max_sh_degree),
        **params,
    )


def camera_from_numpy(
    world_view: np.ndarray,
    full_proj: np.ndarray,
    camera_center: np.ndarray,
    tan_fovx,
    tan_fovy,
    width: int,
    height: int,
    device: str | torch.device = "cuda",
) -> Camera:
    """A Camera from the fields of another package's camera (float32)."""
    dev = resolve_device(device)

    def f32(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    return Camera(
        world_view=f32(world_view),
        full_proj=f32(full_proj),
        camera_center=f32(camera_center),
        tan_fovx=f32(tan_fovx),
        tan_fovy=f32(tan_fovy),
        width=int(width),
        height=int(height),
    )
