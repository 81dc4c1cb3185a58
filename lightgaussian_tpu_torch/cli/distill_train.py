"""CLI: SH distillation, a degree-3 teacher into a lower-degree student.

Port of `lightgaussian_tpu/cli/distill_train.py`: teacher and student from
the same checkpoint (`--start_checkpoint`), else an interchange PLY
(`--start_pointcloud`), else the scene's point cloud; the student's SH
truncated to `--new_max_sh`; trained on the teacher's renders, from a
jittered pose on 2 of 3 iterations with `--augmented_view` (translation sd
0.05, no rotation). `--enable_covariance` unfreezes scaling and rotation,
`--enable_opacity` opacity. Cameras come in the order `random.Random(seed)`
draws and the jitter from `np.random.default_rng(seed)`, as in the JAX CLI,
so both visit the same cameras. Losses are read every 8 iterations; reports,
saves and checkpoints at their iterations; `imp_score.npz` at the end. The
flags are the JAX CLI's without `--interpret`, plus `--device` (default
cuda; without CUDA that raises unless `--device cpu` is given).

Usage: python -m lightgaussian_tpu_torch.cli.distill_train -s <scene> -m <out> \
           --start_checkpoint <chkpnt.npz> --new_max_sh 2 --augmented_view [--device cpu]
"""
from __future__ import annotations

import argparse
import random as pyrandom
from pathlib import Path

import numpy as np
import torch

from lightgaussian_tpu_torch.cli import common
from lightgaussian_tpu_torch.config import OptimizationParams, TrainConfig
from lightgaussian_tpu_torch.data.ply import load_gaussian_ply
from lightgaussian_tpu_torch.data.scene import Scene
from lightgaussian_tpu_torch.ops.rasterize import default_max_instances
from lightgaussian_tpu_torch.render.poses import gaussian_pose
from lightgaussian_tpu_torch.train import checkpoint as ckpt_mod
from lightgaussian_tpu_torch.train import distill, gss, loop
from lightgaussian_tpu_torch.train.state import init_train_state
from lightgaussian_tpu_torch.train.step import make_eval_render
from lightgaussian_tpu_torch.utils.device import resolve_device
from lightgaussian_tpu_torch.utils.general import safe_state
from lightgaussian_tpu_torch.utils.logging import MetricsLogger, StepTimer, prepare_output_dir, training_report


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="SH distillation")
    common.add_standard_groups(parser, opt=True)
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[35_000, 40_000])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[40_000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[40_000])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--start_pointcloud", type=str, default=None)
    parser.add_argument("--new_max_sh", type=int, default=2)
    parser.add_argument("--augmented_view", action="store_true")
    parser.add_argument("--enable_covariance", action="store_true", help="unfreeze scaling and rotation")
    parser.add_argument("--enable_opacity", action="store_true", help="unfreeze opacity")
    parser.add_argument("--iteration_base", type=int, default=30_000)
    parser.add_argument("--iterations_total", type=int, default=40_000)
    parser.add_argument("--lr_gamma", type=float, default=0.90)
    parser.add_argument("--lr_step_every", type=int, default=500)
    parser.add_argument("--v_pow", type=float, default=0.1)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--fast_teacher", action="store_true",
                        help="render the frozen teacher with the render-only kernel instead of the exact one "
                             "(its image differs on saturated pixels only, by under 1e-2)")
    common.add_device_flag(parser)
    common.add_debug_nans_flag(parser)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    common.refuse_world_size("distill_train")
    common.apply_debug_flags(args)
    model, pipeline = common.extract_standard(args)
    opt = common.extract_dataclass(args, OptimizationParams)
    device = resolve_device(args.device)
    # Full float32 in any matrix product on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    safe_state(args.quiet, seed=args.seed)

    cfg = TrainConfig(model=model, pipeline=pipeline, opt=opt, seed=args.seed)
    out = prepare_output_dir(model.model_path, cfg)
    scene = Scene(
        model.source_path, out, images_dir=model.images,
        white_background=model.white_background, eval_split=model.eval,
        resolution=model.resolution, seed=args.seed, device=device,
    )
    bg = torch.full((3,), 1.0 if model.white_background else 0.0, device=device)

    if args.start_checkpoint:
        t_state, first_iter, _ = ckpt_mod.load_checkpoint(args.start_checkpoint, device=device)
        teacher = t_state.scene
    elif args.start_pointcloud:
        teacher = load_gaussian_ply(args.start_pointcloud, device=device)
        first_iter = args.iteration_base
    else:
        teacher = scene.gaussians
        first_iter = args.iteration_base
    state = init_train_state(distill.init_student(teacher, args.new_max_sh))
    print(
        f"Distilling SH deg {teacher.max_sh_degree} -> {args.new_max_sh}; "
        f"{teacher.num_alive()} gaussians; covariance "
        f"{'unfrozen' if args.enable_covariance else 'frozen'}"
    )

    cams = scene.getTrainCameras()
    test_cams = scene.getTestCameras()
    max_instances = default_max_instances(state.scene)
    frozen = ()
    if not args.enable_covariance:
        frozen += ("log_scales", "quats")
    if not args.enable_opacity:
        frozen += ("opacity_logits",)
    step_fn = distill.make_distill_step(
        opt, scene.cameras_extent, max_instances, gamma=args.lr_gamma, gamma_every=args.lr_step_every,
        frozen_fields=frozen, teacher_fast=args.fast_teacher,
    )
    eval_fn = make_eval_render(max_instances)
    logger = MetricsLogger(out)
    timer = StepTimer()
    rng = np.random.default_rng(args.seed)
    prand = pyrandom.Random(args.seed)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    camera_stack = []
    ema = 0.0
    pending = []  # [(iteration, loss tensor), ...]: read in one transfer every loop.SYNC_LAG iterations

    def drain():
        nonlocal ema
        ready, pending[:] = list(pending), []
        if not ready:
            return
        for (it0, _), loss in zip(ready, torch.stack([v for _, v in ready]).tolist()):
            ema = 0.4 * loss + 0.6 * ema if it0 > first_iter + 1 else loss
            logger.scalar("distill/loss", loss, it0)

    for iteration in range(first_iter + 1, args.iterations_total + 1):
        timer.resume()
        if not camera_stack:
            camera_stack = list(cams)
        cam = camera_stack.pop(prand.randrange(len(camera_stack)))
        if args.augmented_view and iteration % 3 != 0:
            cam = gaussian_pose(cam, rng, std_translation=0.05, std_rotation=0.0)

        state, metrics = step_fn(state, teacher, cam, bg)
        pending.append((iteration, metrics.loss))
        if iteration % loop.SYNC_LAG == 0:
            drain()
        if iteration % 100 == 0:
            drain()
            print(f"[{iteration}/{args.iterations_total}] distill loss={ema:.6f}")

        if iteration in args.test_iterations:
            drain()
            sync()
            timer.pause()
            training_report(
                logger, iteration, state.scene, eval_fn, test_cams, cams[: min(5, len(cams))], bg, timer.total,
            )
        if iteration in args.save_iterations:
            sync()
            timer.pause()
            scene.save(iteration, state.scene)
        if iteration in args.checkpoint_iterations:
            sync()
            timer.pause()
            ckpt_mod.save_checkpoint(Path(out) / f"chkpnt{iteration}.npz", state, iteration, scene.cameras_extent)

    drain()
    sync()
    timer.pause()
    _, imp = gss.accumulate_gss_auto(state.scene, cams, bg, max_instances)
    v_imp = gss.calculate_v_imp_score(state.scene, imp, args.v_pow)
    loop.save_imp_score(Path(out) / "imp_score.npz", state.scene, v_imp)
    logger.close()
    print("\nDistillation complete.")


if __name__ == "__main__":
    main()
