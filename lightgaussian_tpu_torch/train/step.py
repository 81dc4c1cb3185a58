"""The training step: render -> L1 + D-SSIM -> backward -> Adam ->
densification statistics; and the evaluation render.

Port of `lightgaussian_tpu/train/step.py`. One call is one iteration on one
camera, or, with `camera_batch > 1`, one Adam update over a list of
cameras. The screen-space positional gradient that drives densification is
the gradient of an explicit zero `mean2d_offset` input (NDC units, so it
carries the 0.5 W and 0.5 H factors as the CUDA reference's does).

On the card a step launches each of the exact blend (B1), its backward
(B2), the x-side SSIM moments (B3) and the blur (B4, the moments'
backward) once, B times each with a batch of B cameras; `make_eval_render` launches B1 and the five-moment blur
(B7) once per view. The step marks the ends of its stages with
`utils.stage_marks` (off unless a caller turns the marks on).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from lightgaussian_tpu_torch.config import OptimizationParams
from lightgaussian_tpu_torch.models.camera import Camera, stack_cameras
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
    distillation drivers; it never applies to the means.

    `camera_batch > 1`: train_step(state, cameras, bg) takes a
    `list[Camera]` of that length (`models.camera.stack_cameras`). The
    cameras render one after another through the exact blend, and ONE Adam
    update follows on the mean of their losses. The densification
    statistics count as B single-camera steps would: the largest radius
    over the cameras; the sum, over the cameras that see a Gaussian, of
    each one's screen-space gradient norm (the mean's 1/B undone); and
    `denom` the number of those cameras."""
    lr_fns = optim.make_lr_fns(opt_cfg, spatial_lr_scale)
    B = camera_batch

    @stage_marks.in_unit("step")
    def step(state: TrainState, cameras: list[Camera], bg: torch.Tensor):
        cameras = stack_cameras(cameras)
        if len(cameras) != B:
            raise ValueError(f"the step takes {B} cameras, got {len(cameras)}")
        if any(c.gt_image is None for c in cameras):
            raise ValueError(
                "train_step needs a camera with a ground-truth image; "
                "attach one with camera.with_gt(img)."
            )
        old = state.scene
        params = param_leaves(old, frozen_fields)
        scene = old.with_params(params)
        offsets = [torch.zeros((state.capacity, 2), dtype=torch.float32, device=old.means.device,
                               requires_grad=True) for _ in range(B)]
        losses_b, l1_b, psnr_b, inst_b, radii_b = [], [], [], [], []
        for cam, offset in zip(cameras, offsets):
            out = render(scene, cam, bg, mean2d_offset=offset, max_instances=max_instances)
            gt = cam.gt_image
            l1 = losses.l1_loss(out.render, gt)
            ssim_v = losses.ssim(out.render, gt, target_stats=cam.gt_ssim_stats)
            losses_b.append((1.0 - opt_cfg.lambda_dssim) * l1 + opt_cfg.lambda_dssim * (1.0 - ssim_v))
            l1_b.append(l1.detach())
            psnr_b.append(losses.psnr(out.render.detach(), gt))
            inst_b.append(out.num_instances)
            radii_b.append(out.radii)
        loss = torch.stack(losses_b).mean()
        stage_marks.mark("loss forward")
        grads, offset_grads = gradients(loss, params, frozen_fields, tuple(offsets))
        stage_marks.mark("preprocess backward")

        with torch.no_grad():
            new_scene, new_opt = adam_step(state, grads, lr_fns, lr_mult_fn)
            stage_marks.mark("Adam")
            radii = torch.stack(radii_b)  # [B, N]
            visible = (radii > 0) & new_scene.alive[None, :]
            if update_densify_stats:
                radii_f = torch.where(visible, radii.to(torch.float32), 0.0)
                max_radii = torch.maximum(state.max_radii2d, radii_f.amax(dim=0))
                g = torch.stack(offset_grads) * B
                gnorm = torch.sqrt((g * g).sum(dim=-1))
                accum = state.xyz_grad_accum + torch.where(visible, gnorm, 0.0).sum(dim=0)
                denom = state.denom + visible.sum(dim=0).to(torch.float32)
            else:
                max_radii, accum, denom = state.max_radii2d, state.xyz_grad_accum, state.denom
            metrics = StepMetrics(
                loss=loss.detach(),
                l1=torch.stack(l1_b).mean(),
                psnr=torch.stack(psnr_b).mean(),
                num_instances=max(inst_b),
                n_visible=visible.any(dim=0).sum(),
            )
            stage_marks.mark("densify statistics + metrics")
        new_state = dataclasses.replace(
            state,
            scene=new_scene,
            opt=new_opt,
            step=state.step + 1,
            max_radii2d=max_radii,
            xyz_grad_accum=accum,
            denom=denom,
        )
        return new_state, metrics

    if B > 1:
        return step

    def train_step(state: TrainState, camera: Camera, bg: torch.Tensor):
        return step(state, [camera], bg)

    return train_step


def param_leaves(scene, frozen_fields: tuple = ()) -> dict[str, torch.Tensor]:
    """The scene's parameters as fresh leaves, those of `frozen_fields`
    without a gradient (so that no backward computes one)."""
    return {k: v.detach().requires_grad_(k not in frozen_fields) for k, v in scene.params().items()}


def gradients(loss: torch.Tensor, params: dict, frozen_fields: tuple = (), extra: tuple = ()):
    """(gradient of each parameter, gradients of `extra`) of `loss`. A
    tensor the loss does not reach (sh_rest at SH degree 0) has a zero
    gradient, and so has every field of `frozen_fields`."""
    names = [k for k, v in params.items() if v.requires_grad and k not in frozen_fields]
    leaves = [params[k] for k in names] + list(extra)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    got = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, got)]
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    grads.update(zip(names, got))
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
