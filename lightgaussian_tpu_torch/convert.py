"""Carry scenes, cameras and train states across as host arrays.

The JAX package's `GaussianScene`, `Camera` and `TrainState` are dataclasses
of arrays; a caller that holds one hands its fields over as numpy arrays,
and these functions build the port's counterpart on a device. Both packages
then compute from the same bits. The `*_to_numpy` functions go the other
way, to the same layout.

A train state travels as a dict: "scene" (the scene's parameter arrays,
"alive", "active_sh_degree", "max_sh_degree"), "mu" and "nu" (Adam's moments
by parameter), "count" (Adam's step count), "step", and the densification
statistics "max_radii2d", "xyz_grad_accum" and "denom".
"""
from __future__ import annotations

import numpy as np
import torch

from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.models.gaussians import GaussianScene
from lightgaussian_tpu_torch.train.optim import AdamState
from lightgaussian_tpu_torch.train.state import TrainState
from lightgaussian_tpu_torch.utils.device import resolve_device

STAT_FIELDS = ("max_radii2d", "xyz_grad_accum", "denom")


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


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


def scene_to_numpy(scene: GaussianScene) -> dict:
    """The scene's parameter arrays, "alive" and its SH degrees."""
    out = {k: _np(v) for k, v in scene.params().items()}
    out.update(alive=_np(scene.alive), active_sh_degree=scene.active_sh_degree,
               max_sh_degree=scene.max_sh_degree)
    return out


def train_state_from_numpy(arrays: dict, device: str | torch.device = "cuda") -> TrainState:
    """A TrainState from the dict layout of this module's docstring."""
    dev = resolve_device(device)
    s = arrays["scene"]
    scene = scene_from_numpy(
        {k: s[k] for k in GaussianScene.PARAM_FIELDS}, s["alive"], s["active_sh_degree"],
        s["max_sh_degree"], device=dev,
    )

    def f32(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    opt = AdamState(
        mu={k: f32(arrays["mu"][k]) for k in GaussianScene.PARAM_FIELDS},
        nu={k: f32(arrays["nu"][k]) for k in GaussianScene.PARAM_FIELDS},
        count=int(arrays["count"]),
    )
    return TrainState(scene=scene, opt=opt, step=int(arrays["step"]),
                      **{k: f32(arrays[k]) for k in STAT_FIELDS})


def train_state_to_numpy(state: TrainState) -> dict:
    """The dict layout of this module's docstring, on the host."""
    return dict(
        scene=scene_to_numpy(state.scene),
        mu={k: _np(v) for k, v in state.opt.mu.items()},
        nu={k: _np(v) for k, v in state.opt.nu.items()},
        count=state.opt.count,
        step=state.step,
        **{k: _np(getattr(state, k)) for k in STAT_FIELDS},
    )
