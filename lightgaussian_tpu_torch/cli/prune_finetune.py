"""CLI: prune a trained model by GSS and finetune it to recover.

Port of `lightgaussian_tpu/cli/prune_finetune.py`: start from a training
checkpoint (`--start_checkpoint`), else an interchange PLY
(`--start_pointcloud`), else the scene's point cloud; prune at
`--prune_iterations` by `--prune_type`, and finetune without densification
under a global multiplier of `--lr_gamma` every `--lr_step_every` steps on
the per-group rates. An `--iterations` left at 30,000 becomes 35,000. The
flags are the JAX CLI's without `--interpret`, plus `--device` (default
cuda; without CUDA that raises unless `--device cpu` is given).

Usage: python -m lightgaussian_tpu_torch.cli.prune_finetune -s <scene> -m <out> \
           --start_checkpoint <chkpnt.npz> --prune_percent 0.66 [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from lightgaussian_tpu_torch.cli import common
from lightgaussian_tpu_torch.config import OptimizationParams, TrainConfig
from lightgaussian_tpu_torch.data.ply import load_gaussian_ply
from lightgaussian_tpu_torch.data.scene import Scene
from lightgaussian_tpu_torch.train import loop
from lightgaussian_tpu_torch.train.checkpoint import load_checkpoint
from lightgaussian_tpu_torch.train.state import init_train_state
from lightgaussian_tpu_torch.utils.device import resolve_device
from lightgaussian_tpu_torch.utils.general import exponential_decay_every, safe_state
from lightgaussian_tpu_torch.utils.logging import MetricsLogger, prepare_output_dir


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="GSS prune + recovery finetune")
    common.add_standard_groups(parser, opt=True)
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[30_000, 35_000])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[35_000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[35_000])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--start_pointcloud", type=str, default=None)
    parser.add_argument("--prune_iterations", nargs="+", type=int, default=[30_001])
    parser.add_argument("--prune_percent", type=float, default=0.1)
    parser.add_argument("--prune_decay", type=float, default=1.0)
    parser.add_argument("--prune_type", type=str, default="important_score", choices=list(loop.PRUNE_TYPES))
    parser.add_argument("--v_pow", type=float, default=0.1)
    parser.add_argument("--lr_gamma", type=float, default=0.95)
    parser.add_argument("--lr_step_every", type=int, default=400)
    parser.add_argument("--iteration_base", type=int, default=30_000)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    common.add_device_flag(parser)
    common.add_debug_nans_flag(parser)
    common.add_cache_gt_ssim_flag(parser)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    common.refuse_world_size("prune_finetune")
    common.apply_debug_flags(args)
    model, pipeline = common.extract_standard(args)
    opt = common.extract_dataclass(args, OptimizationParams)
    if opt.iterations == 30_000:
        opt = dataclasses.replace(opt, iterations=35_000)
    device = resolve_device(args.device)
    # Full float32 in any matrix product on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TrainConfig(
        model=model, pipeline=pipeline, opt=opt,
        test_iterations=args.test_iterations,
        save_iterations=args.save_iterations,
        checkpoint_iterations=args.checkpoint_iterations,
        prune_iterations=args.prune_iterations,
        prune_percent=args.prune_percent,
        prune_decay=args.prune_decay,
        v_pow=args.v_pow,
        seed=args.seed,
    )
    safe_state(args.quiet, seed=args.seed)

    out = prepare_output_dir(model.model_path, cfg)
    scene = Scene(
        model.source_path, out, images_dir=model.images,
        white_background=model.white_background, eval_split=model.eval,
        resolution=model.resolution, seed=args.seed, device=device,
    )
    bg = torch.full((3,), 1.0 if model.white_background else 0.0, device=device)

    first_iter = args.iteration_base
    if args.start_checkpoint:
        state, first_iter, _ = load_checkpoint(args.start_checkpoint, device=device)
        print(f"Resumed checkpoint at iteration {first_iter}")
    elif args.start_pointcloud:
        gaussians = load_gaussian_ply(args.start_pointcloud, device=device)
        state = init_train_state(gaussians)
        print(f"Loaded point cloud {args.start_pointcloud} ({gaussians.num_alive()} gaussians)")
    else:
        state = init_train_state(scene.gaussians)

    logger = MetricsLogger(out)
    loop.train(
        scene, cfg, bg, state=state, first_iter=first_iter,
        densify=False, lr_mult_fn=exponential_decay_every(args.lr_gamma, args.lr_step_every),
        sh_degree_interval=None, logger=logger, seed=args.seed,
        prune_type=args.prune_type, cache_gt_ssim=args.cache_gt_ssim,
    )
    logger.close()
    print("\nPrune + finetune complete.")


if __name__ == "__main__":
    main()
