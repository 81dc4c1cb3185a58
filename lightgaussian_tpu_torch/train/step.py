"""The training step: render -> L1 + D-SSIM -> backward -> Adam ->
densification statistics; and the evaluation render.

Port of `lightgaussian_tpu/train/step.py`. One call is one iteration on one
camera. The screen-space positional gradient that drives densification is
the gradient of an explicit zero `mean2d_offset` input (NDC units, so it
carries the 0.5 W and 0.5 H factors as the CUDA reference's does).

On the card a step launches each of the exact blend (B1), its backward
(B2), the x-side SSIM moments (B3) and the blur (B4, the moments'
backward) once; `make_eval_render` launches B1 and the five-moment blur
(B7) once per view. The step marks the ends of its stages with
`utils.stage_marks` (off unless a caller turns the marks on).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from lightgaussian_tpu_torch.config import OptimizationParams
from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.ops import losses
from lightgaussian_tpu_torch.ops.rasterize import render
from lightgaussian_tpu_torch.train import optim
from lightgaussian_tpu_torch.train.state import TrainState
from lightgaussian_tpu_torch.utils import stage_marks


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    psnr: torch.Tensor
    num_instances: int
    n_visible: torch.Tensor


def make_train_step(
    opt_cfg: OptimizationParams,
    spatial_lr_scale: float,
    max_instances: int,
    lr_mult_fn=None,
    frozen_fields: tuple = (),
    update_densify_stats: bool = True,
    camera_batch: int = 1,
):
    """Build train_step(state, camera, bg) -> (state, metrics).

    `frozen_fields` zeroes the gradients of the named parameters (the
    distillation driver freezes scaling, rotation and opacity).
    `lr_mult_fn(step)` is the global multiplier of the finetune and
    distillation drivers; it never applies to the means."""
    if camera_batch > 1:
        raise NotImplementedError(
            "camera_batch > 1 (one Adam update over several cameras) comes with the "
            "multi-device slice (ROADMAP A, multi-device)"
        )
    lr_fns = optim.make_lr_fns(opt_cfg, spatial_lr_scale)

    def train_step(state: TrainState, camera: Camera, bg: torch.Tensor):
        gt = camera.gt_image
        if gt is None:
            raise ValueError(
                "train_step needs a camera with a ground-truth image; "
                "attach one with camera.with_gt(img)."
            )
        old = state.scene
        params = param_leaves(old)
        offset = torch.zeros((state.capacity, 2), dtype=torch.float32, device=old.means.device,
                             requires_grad=True)
        out = render(old.with_params(params), camera, bg, mean2d_offset=offset,
                     max_instances=max_instances)
        l1 = losses.l1_loss(out.render, gt)
        ssim_v = losses.ssim(out.render, gt, target_stats=camera.gt_ssim_stats)
        loss = (1.0 - opt_cfg.lambda_dssim) * l1 + opt_cfg.lambda_dssim * (1.0 - ssim_v)
        stage_marks.mark("loss forward")
        grads, (offset_grad,) = gradients(loss, params, frozen_fields, (offset,))
        stage_marks.mark("preprocess backward")

        with torch.no_grad():
            scene, new_opt = adam_step(state, grads, lr_fns, lr_mult_fn)
            stage_marks.mark("Adam")
            visible = out.visibility & scene.alive
            if update_densify_stats:
                max_radii = torch.where(
                    visible,
                    torch.maximum(state.max_radii2d, out.radii.to(torch.float32)),
                    state.max_radii2d,
                )
                gnorm = torch.sqrt((offset_grad * offset_grad).sum(dim=-1))
                accum = state.xyz_grad_accum + torch.where(visible, gnorm, 0.0)
                denom = state.denom + visible.to(torch.float32)
            else:
                max_radii, accum, denom = state.max_radii2d, state.xyz_grad_accum, state.denom
            metrics = StepMetrics(
                loss=loss.detach(),
                l1=l1.detach(),
                psnr=losses.psnr(out.render.detach(), gt),
                num_instances=out.num_instances,
                n_visible=visible.sum(),
            )
            stage_marks.mark("densify statistics + metrics")
        new_state = dataclasses.replace(
            state,
            scene=scene,
            opt=new_opt,
            step=state.step + 1,
            max_radii2d=max_radii,
            xyz_grad_accum=accum,
            denom=denom,
        )
        return new_state, metrics

    return train_step


def param_leaves(scene) -> dict[str, torch.Tensor]:
    """The scene's parameters as fresh leaves that require a gradient."""
    return {k: v.detach().requires_grad_(True) for k, v in scene.params().items()}


def gradients(loss: torch.Tensor, params: dict, frozen_fields: tuple = (), extra: tuple = ()):
    """(gradient of each parameter, gradients of `extra`) of `loss`. A
    tensor the loss does not reach (sh_rest at SH degree 0) has a zero
    gradient, and so has every field of `frozen_fields`."""
    names = list(params)
    leaves = [params[k] for k in names] + list(extra)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    got = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, got)]
    grads = dict(zip(names, got))
    for f in frozen_fields:
        grads[f] = torch.zeros_like(grads[f])
    return grads, tuple(got[len(names):])


def adam_step(state: TrainState, grads: dict, lr_fns: dict, lr_mult_fn=None):
    """One Adam update of the state's scene: (new scene, new Adam state).
    `lr_mult_fn(step)` scales every group's rate but the means'."""
    lr_mult = lr_mult_fn(state.step) if lr_mult_fn is not None else 1.0
    old = state.scene
    new_params, new_opt = optim.adam_update(old.params(), grads, state.opt, lr_fns, state.step, old.alive, lr_mult)
    return old.with_params(new_params), new_opt


def make_eval_render(max_instances: int):
    """eval_render(scene, camera, bg) -> (image, l1, psnr, ssim) against the
    camera's ground truth; the image is clipped to [0, 1]."""

    @torch.no_grad()
    def eval_render(scene, camera: Camera, bg: torch.Tensor):
        out = render(scene, camera, bg, max_instances=max_instances)
        img = torch.clamp(out.render, 0.0, 1.0)
        gt = camera.gt_image
        return img, losses.l1_loss(img, gt), losses.psnr(img, gt), losses.ssim(img, gt)

    return eval_render
