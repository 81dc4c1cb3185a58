"""Small general utilities: the inverse of the opacity activation, the
learning-rate schedules and the run setup shared by the CLIs (port of
`lightgaussian_tpu/utils/general.py`).

The schedules return a float32 0-d tensor for an integer step, computed in
float32 as the JAX package computes them inside its jitted step.
"""
from __future__ import annotations

import random
import sys
from datetime import datetime

import numpy as np
import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def expon_lr_schedule(
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
):
    """Log-space lerp from `lr_init` to `lr_final` over `max_steps`, with an
    optional sine-eased delay (the reference's `get_expon_lr_func`); both
    rates 0 disable it, and a negative step gives 0."""
    f32 = torch.float32
    if lr_init == 0.0 and lr_final == 0.0:
        return lambda step: torch.zeros((), dtype=f32)

    log_init = torch.tensor(np.log(max(lr_init, 1e-30)), dtype=f32)
    log_final = torch.tensor(np.log(max(lr_final, 1e-30)), dtype=f32)

    def schedule(step) -> torch.Tensor:
        step = torch.tensor(step, dtype=f32)
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1.0 - lr_delay_mult) * torch.sin(
                0.5 * torch.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0)
            )
        else:
            delay_rate = 1.0
        t = torch.clamp(step / max_steps, 0.0, 1.0)
        lr = delay_rate * torch.exp(log_init * (1.0 - t) + log_final * t)
        return torch.where(step < 0, 0.0, lr)

    return schedule


def exponential_decay_every(gamma: float, every: int):
    """gamma ** (step // every): torch's ExponentialLR stepped every `every`
    iterations (the finetune and distillation drivers' `lr_mult_fn`)."""

    def schedule(step) -> torch.Tensor:
        return torch.pow(torch.tensor(gamma, dtype=torch.float32), float(int(step) // every))

    return schedule


def safe_state(quiet: bool = False, seed: int = 0) -> None:
    """Seed the host RNGs and torch's default generator with `seed`, and
    unless `quiet`, timestamp every stdout line (as the reference's
    `safe_state` does)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

    if not quiet and not getattr(sys.stdout, "_lg_wrapped", False):
        orig_write = sys.stdout.write

        def write(text):
            if text.endswith("\n") and text != "\n":
                ts = datetime.now().strftime("%d/%m %H:%M:%S")
                text = text.replace("\n", f" [{ts}]\n")
            return orig_write(text)

        sys.stdout.write = write
        sys.stdout._lg_wrapped = True
