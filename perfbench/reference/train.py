"""Plain PyTorch reference of the 3D-GS training step and of SH distillation.

The loss is (1 - 0.2) L1 + 0.2 (1 - SSIM), SSIM over an 11x11 Gaussian window
(sigma 1.5, taps computed in float64 and rounded to float32), C1 = 0.01^2,
C2 = 0.03^2, zero "same" padding, mean over pixels and channels; its
gradient is taken by autograd through a plain shift-and-add blur. Adam is the
3D-GS one (betas 0.9 and 0.999, eps 1e-15) with per-group rates: the means on
the delayed exponential schedule times the scene extent, the SH rest at a
twentieth of the feature rate, and a multiplier that never applies to the
means. The densification statistics are the 3D-GS ones: the largest screen
radius, the summed norm of the screen-space positional gradient over the views
that see a Gaussian, and their count.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import render as R

WINDOW, SIGMA = 11, 1.5
LAMBDA_DSSIM = 0.2
BETA1, BETA2, EPS = 0.9, 0.999, 1e-15
ALTERED = 0.05  # the planted fault "alter": the first tile's colours moved by this much where rendered
FIELDS = ("means", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logits")
# OptimizationParams' defaults of 3D-GS
LR = {"position_init": 0.00016, "position_final": 0.0000016, "position_max_steps": 30_000,
      "feature": 0.0025, "opacity": 0.05, "scaling": 0.005, "rotation": 0.001}


def _taps() -> list[float]:
    xs = np.arange(WINDOW, dtype=np.float64) - WINDOW // 2
    g = np.exp(-(xs ** 2) / (2.0 * SIGMA ** 2))
    return (g / g.sum()).astype(np.float32).tolist()


TAPS = _taps()


def blur(x: torch.Tensor) -> torch.Tensor:
    """[C, H, W] separable blur, rows first, taps summed in order."""
    r = WINDOW // 2
    _, h, w = x.shape
    xp = torch.nn.functional.pad(x, (r, r))
    x = sum(t * xp[:, :, i:i + w] for i, t in enumerate(TAPS))
    xp = torch.nn.functional.pad(x, (0, 0, r, r))
    return sum(t * xp[:, i:i + h, :] for i, t in enumerate(TAPS))


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    c = x.shape[0]
    mu1, mu2, s11, s22, s12 = blur(torch.cat([x, y, x * x, y * y, x * y])).split(c)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq, sigma2_sq, sigma12 = s11 - mu1_sq, s22 - mu2_sq, s12 - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2.0 * mu1_mu2 + c1) * (2.0 * sigma12 + c2)) / ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return m.mean()


def loss_fn(image: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    l1 = torch.abs(image - target).mean()
    return (1.0 - LAMBDA_DSSIM) * l1 + LAMBDA_DSSIM * (1.0 - ssim(image, target))


def _f32(x) -> float:
    return float(torch.as_tensor(x, dtype=torch.float32))


def rates(step: int, extent: float) -> dict:
    """Each field's learning rate at `step`, as float32 values."""
    f32 = torch.float32
    log_init = torch.tensor(np.log(LR["position_init"] * extent), dtype=f32)
    log_final = torch.tensor(np.log(LR["position_final"] * extent), dtype=f32)
    t = torch.clamp(torch.tensor(step, dtype=f32) / LR["position_max_steps"], 0.0, 1.0)
    means = torch.where(torch.tensor(step, dtype=f32) < 0, 0.0, 1.0 * torch.exp(log_init * (1.0 - t) + log_final * t))
    return {"means": _f32(means), "sh_dc": _f32(LR["feature"]), "sh_rest": _f32(LR["feature"] / 20.0),
            "opacity_logits": _f32(LR["opacity"]), "log_scales": _f32(LR["scaling"]),
            "quats": _f32(LR["rotation"])}


def adam(p: dict, g: dict, mu: dict, nu: dict, count: int, lr: dict, lr_mult: float = 1.0):
    """One Adam step: (params, mu, nu) anew."""
    count += 1
    f32 = torch.float32
    c1 = _f32(1.0 - torch.pow(torch.tensor(BETA1, dtype=f32), torch.tensor(count, dtype=f32)))
    c2 = _f32(1.0 - torch.pow(torch.tensor(BETA2, dtype=f32), torch.tensor(count, dtype=f32)))
    new_p, new_mu, new_nu = {}, {}, {}
    for k in FIELDS:
        new_mu[k] = BETA1 * mu[k] + (1.0 - BETA1) * g[k]
        new_nu[k] = BETA2 * nu[k] + (1.0 - BETA2) * (g[k] * g[k])
        rate = lr[k] * (1.0 if k == "means" else _f32(lr_mult))
        new_p[k] = p[k] - rate * (new_mu[k] / c1) / (torch.sqrt(new_nu[k] / c2) + EPS)
    return new_p, new_mu, new_nu


class Trainer:
    """Three things the benchmark compares, for a run of steps from `p`:
    each step's loss, the first step's gradient and, after the last step,
    the parameters and the densification statistics."""

    def __init__(self, p: dict, sh_degree: int, step: int, extent: float, cut: int, q=R.identity,
                 frozen: tuple = (), lr_mult: float = 1.0, grow: bool = False, fault: str | None = None):
        self.p = {k: q(v) for k, v in p.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in p.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in p.items()}
        self.count, self.step, self.sh_degree = 0, step, sh_degree
        self.extent, self.cut, self.q, self.frozen, self.lr_mult = extent, cut, q, frozen, lr_mult
        self.grow = grow  # the trainer's growth of the cut (`render.grow_cut`)
        self.fault = fault  # a planted fault: "half" (the loss over half the rows), "alter" (a tile moved by ALTERED)
        n = p["means"].shape[0]
        dev = p["means"].device
        self.max_radii = torch.zeros(n, device=dev)
        self.accum = torch.zeros(n, device=dev)
        self.denom = torch.zeros(n, device=dev)
        self.losses: list[float] = []
        self.first_grad: dict | None = None

    def run(self, view, target: torch.Tensor, bg: torch.Tensor, teacher: tuple | None = None) -> None:
        """One step on `view` against `target`, or, with `teacher` = (its
        parameters, its SH degree), against the teacher's exact render."""
        q = self.q
        if teacher is not None:
            with torch.no_grad():
                s = R.preprocess(teacher[0], teacher[1], view, q=q)
                b = R.bin_splats(s, R.make_grid(view.width, view.height), self.cut)
                rgb, t, _ = R.blend(b, exact=True)
                target = q(R.compose(rgb, t, bg, b.grid)[0])
                del s, b, rgb, t
        leaves = {k: v.detach().requires_grad_(True) for k, v in self.p.items()}
        offset = torch.zeros((self.p["means"].shape[0], 2), device=bg.device, requires_grad=True)
        image, radius, live = R.render_exact(leaves, self.sh_degree, view, bg, self.cut, offset, q)
        if self.fault == "half":
            image, target = image[:, : image.shape[1] // 2], target[:, : target.shape[1] // 2]
        elif self.fault == "alter":
            delta = torch.zeros_like(image)
            delta[:, :R.TILE, :R.TILE] = ALTERED
            image = image + delta
        loss = loss_fn(image, target)
        got = torch.autograd.grad(loss, [leaves[k] for k in FIELDS] + [offset])
        grads = {k: torch.zeros_like(x) if k in self.frozen else x for k, x in zip(FIELDS, got)}
        self.losses.append(float(loss.detach()))
        if self.first_grad is None:
            self.first_grad = grads
        with torch.no_grad():
            self.p, self.mu, self.nu = self.adam_step(grads)
            visible = radius > 0
            self.max_radii = torch.maximum(self.max_radii, torch.where(visible, radius.to(torch.float32), 0.0))
            gnorm = torch.sqrt((got[-1] * got[-1]).sum(dim=-1))
            self.accum = self.accum + torch.where(visible, gnorm, 0.0)
            self.denom = self.denom + visible.to(torch.float32)
        self.step += 1
        if self.grow:
            self.cut = R.grow_cut(self.cut, live)

    def adam_step(self, grads: dict):
        lr = rates(self.step, self.extent)
        p, mu, nu = adam(self.p, grads, self.mu, self.nu, self.count, lr, self.lr_mult)
        self.count += 1
        return {k: self.q(v) for k, v in p.items()}, mu, nu
