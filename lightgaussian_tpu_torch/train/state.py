"""TrainState: scene, optimizer and densification statistics together.

Port of `lightgaussian_tpu/train/state.py`. The statistics are the
reference's `max_radii2D`, `xyz_gradient_accum` and `denom`, kept at the
scene's capacity."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from lightgaussian_tpu_torch.models.gaussians import GaussianScene
from lightgaussian_tpu_torch.train.optim import AdamState, init_adam


@dataclasses.dataclass(frozen=True)
class TrainState:
    scene: GaussianScene
    opt: AdamState
    step: int
    max_radii2d: torch.Tensor  # [cap] f32
    xyz_grad_accum: torch.Tensor  # [cap] f32
    denom: torch.Tensor  # [cap] f32

    @property
    def capacity(self) -> int:
        return self.scene.capacity


def init_train_state(scene: GaussianScene) -> TrainState:
    cap = scene.capacity
    zeros = dict(dtype=torch.float32, device=scene.means.device)
    return TrainState(
        scene=scene,
        opt=init_adam(scene.params()),
        step=0,
        max_radii2d=torch.zeros(cap, **zeros),
        xyz_grad_accum=torch.zeros(cap, **zeros),
        denom=torch.zeros(cap, **zeros),
    )


def grow_capacity(state: TrainState, new_capacity: int) -> TrainState:
    """Every per-Gaussian tensor padded with zeros (False for `alive`) to a
    larger capacity, as the JAX package pads them."""
    old = state.capacity
    if new_capacity <= old:
        raise ValueError(f"new capacity {new_capacity} is not above {old}")

    def grow(x: torch.Tensor) -> torch.Tensor:
        pad = [0, 0] * (x.dim() - 1) + [0, new_capacity - old]
        return F.pad(x, pad) if x.dtype != torch.bool else F.pad(x.to(torch.uint8), pad).bool()

    scene = state.scene
    scene = dataclasses.replace(
        scene, alive=grow(scene.alive), **{k: grow(v) for k, v in scene.params().items()}
    )
    opt = AdamState(
        mu={k: grow(v) for k, v in state.opt.mu.items()},
        nu={k: grow(v) for k, v in state.opt.nu.items()},
        count=state.opt.count,
    )
    return dataclasses.replace(
        state, scene=scene, opt=opt, max_radii2d=grow(state.max_radii2d),
        xyz_grad_accum=grow(state.xyz_grad_accum), denom=grow(state.denom),
    )
