"""SH distillation: a degree-3 teacher into a lower-degree student.

Port of `lightgaussian_tpu/train/distill.py`. Teacher and student come from
the same checkpoint; the student's `sh_rest` is truncated to the new degree
and trained to match the frozen teacher's renders with L1 + lambda D-SSIM
(the dataset's ground truth is never read). A global multiplier of gamma
every `gamma_every` steps rides on the per-group rates, and scaling,
rotation and opacity can be frozen.

On the card a step renders the teacher without a graph (the exact kernel
B1, or the render-only B6 with `teacher_fast`) and the student with one
(B1, backward B2). The teacher's image changes every step, so no target
moments are cached: the SSIM runs all five moments (B7) forward and the
blur (B4) over their 15 planes backward. The step marks the ends of its
stages with `utils.stage_marks` as the training step does, the teacher's
render adding to the same stages as the student's.
"""
from __future__ import annotations

import dataclasses

import torch

from lightgaussian_tpu_torch.config import OptimizationParams
from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.models.gaussians import GaussianScene
from lightgaussian_tpu_torch.ops import losses
from lightgaussian_tpu_torch.ops.rasterize import render
from lightgaussian_tpu_torch.train import optim
from lightgaussian_tpu_torch.train.state import TrainState
from lightgaussian_tpu_torch.train.step import StepMetrics, adam_step, gradients, param_leaves
from lightgaussian_tpu_torch.utils import stage_marks
from lightgaussian_tpu_torch.utils.general import exponential_decay_every


def make_distill_step(
    opt_cfg: OptimizationParams,
    spatial_lr_scale: float,
    max_instances: int,
    gamma: float = 0.90,
    gamma_every: int = 500,
    frozen_fields: tuple = ("log_scales", "quats", "opacity_logits"),
    teacher_fast: bool = False,
):
    """Build distill_step(state, teacher, camera, bg) -> (state, metrics).

    `frozen_fields` defaults to the reference's behaviour without
    covariance distillation: only positions and SH train."""
    lr_fns = optim.make_lr_fns(opt_cfg, spatial_lr_scale)
    lr_mult_fn = exponential_decay_every(gamma, gamma_every)

    @stage_marks.in_unit("step")
    def distill_step(state: TrainState, teacher: GaussianScene, camera: Camera, bg: torch.Tensor):
        with torch.no_grad():
            teacher_img = render(teacher, camera, bg, max_instances=max_instances, fast=teacher_fast).render
        params = param_leaves(state.scene, frozen_fields)
        out = render(state.scene.with_params(params), camera, bg, max_instances=max_instances)
        l1 = losses.l1_loss(out.render, teacher_img)
        ssim_v = losses.ssim(out.render, teacher_img)
        loss = (1.0 - opt_cfg.lambda_dssim) * l1 + opt_cfg.lambda_dssim * (1.0 - ssim_v)
        stage_marks.mark("loss forward")
        grads, _ = gradients(loss, params, frozen_fields)
        stage_marks.mark("preprocess backward")
        with torch.no_grad():
            scene, new_opt = adam_step(state, grads, lr_fns, lr_mult_fn)
            stage_marks.mark("Adam")
            metrics = StepMetrics(
                loss=loss.detach(),
                l1=l1.detach(),
                psnr=losses.psnr(out.render.detach(), teacher_img),
                num_instances=out.num_instances,
                n_visible=(out.visibility & state.scene.alive).sum(),
            )
        return dataclasses.replace(state, scene=scene, opt=new_opt, step=state.step + 1), metrics

    return distill_step


def init_student(teacher: GaussianScene, new_sh_degree: int) -> GaussianScene:
    """The student's start: the teacher with SH truncated to the new degree."""
    return teacher.truncate_sh(new_sh_degree)
