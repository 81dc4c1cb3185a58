"""Per-group Adam over the GaussianScene parameters.

Port of `lightgaussian_tpu/train/optim.py`: the reference's Adam (eps
1e-15), per-group learning rates (xyz on the delayed exponential schedule
scaled by the scene extent, f_rest at feature_lr / 20) and an optional
global multiplier that never applies to the means. Written by hand so that
densification can zero the moments of re-used slots. The state is a
dataclass of tensors; an update returns new tensors, as the JAX package's
pure update does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from lightgaussian_tpu_torch.config import OptimizationParams
from lightgaussian_tpu_torch.utils.general import expon_lr_schedule

BETA1, BETA2 = 0.9, 0.999
EPS = 1e-15


@dataclasses.dataclass(frozen=True)
class AdamState:
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int


def init_adam(params: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
        count=0,
    )


def make_lr_fns(opt: OptimizationParams, spatial_lr_scale: float) -> Dict[str, Callable]:
    """Per-parameter learning-rate schedules keyed by GaussianScene field."""
    xyz = expon_lr_schedule(
        opt.position_lr_init * spatial_lr_scale,
        opt.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt.position_lr_delay_mult,
        lr_delay_steps=0,
        max_steps=opt.position_lr_max_steps,
    )

    def const(v):
        return lambda step: torch.tensor(v, dtype=torch.float32)

    return {
        "means": xyz,
        "sh_dc": const(opt.feature_lr),
        "sh_rest": const(opt.feature_lr / 20.0),
        "opacity_logits": const(opt.opacity_lr),
        "log_scales": const(opt.scaling_lr),
        "quats": const(opt.rotation_lr),
    }


def _f32(x) -> float:
    """A Python float that is exactly the float32 value of `x`."""
    return float(torch.as_tensor(x, dtype=torch.float32))


def adam_update(
    params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
    state: AdamState,
    lr_fns: Dict[str, Callable],
    step: int,
    alive: torch.Tensor,
    lr_mult=1.0,
):
    """One Adam step; dead slots keep their parameters and moments."""
    count = state.count + 1
    f32 = torch.float32
    c1 = _f32(1.0 - torch.pow(torch.tensor(BETA1, dtype=f32), torch.tensor(count, dtype=f32)))
    c2 = _f32(1.0 - torch.pow(torch.tensor(BETA2, dtype=f32), torch.tensor(count, dtype=f32)))

    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        mu = BETA1 * state.mu[k] + (1.0 - BETA1) * g
        nu = BETA2 * state.nu[k] + (1.0 - BETA2) * (g * g)
        # The global multiplier never sticks to xyz in the reference: its
        # update_learning_rate overwrites the xyz group's rate every step.
        lr = _f32(lr_fns[k](step)) * (1.0 if k == "means" else _f32(lr_mult))
        upd = lr * (mu / c1) / (torch.sqrt(nu / c2) + EPS)
        mask = alive.reshape((-1,) + (1,) * (p.dim() - 1))
        new_p[k] = torch.where(mask, p - upd, p)
        new_mu[k] = torch.where(mask, mu, state.mu[k])
        new_nu[k] = torch.where(mask, nu, state.nu[k])
    return new_p, AdamState(mu=new_mu, nu=new_nu, count=count)


def zero_moments_at(state: AdamState, slot_mask: torch.Tensor) -> AdamState:
    """Zero the moments of the slots in `slot_mask` (the reference's reset of
    replaced optimizer rows)."""

    def z(x):
        return torch.where(slot_mask.reshape((-1,) + (1,) * (x.dim() - 1)), 0.0, x)

    return AdamState(
        mu={k: z(v) for k, v in state.mu.items()},
        nu={k: z(v) for k, v in state.nu.items()},
        count=state.count,
    )


def zero_moments_field(state: AdamState, field: str) -> AdamState:
    """Zero the moments of one field everywhere (opacity reset)."""
    mu, nu = dict(state.mu), dict(state.nu)
    mu[field] = torch.zeros_like(mu[field])
    nu[field] = torch.zeros_like(nu[field])
    return AdamState(mu=mu, nu=nu, count=state.count)
