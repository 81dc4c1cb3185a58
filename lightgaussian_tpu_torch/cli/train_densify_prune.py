"""CLI: full 3D-GS training with densification and in-training GSS pruning.

Port of `lightgaussian_tpu/cli/train_densify_prune.py`: the same flags and
defaults (prune_iterations [16000, 24000], decayed percent, the imp_score
export at the last checkpoint), plus `--device` (default cuda; without CUDA
that raises unless `--device cpu` is given). `--debug_nans` turns on
`torch.autograd.set_detect_anomaly`; `--profile_dir` records a
`torch.profiler` trace of a few steps. `--interpret` has no counterpart.
The live viewer is not ported yet: `--ip`, `--port` and `--disable_viewer`
parse, and a run without `--disable_viewer` says so in one line and trains
on.

Usage: python -m lightgaussian_tpu_torch.cli.train_densify_prune -s <scene> -m <out> [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from lightgaussian_tpu_torch.cli import common
from lightgaussian_tpu_torch.config import OptimizationParams, TrainConfig
from lightgaussian_tpu_torch.data.scene import Scene
from lightgaussian_tpu_torch.train import loop
from lightgaussian_tpu_torch.train.checkpoint import load_checkpoint
from lightgaussian_tpu_torch.utils.device import resolve_device
from lightgaussian_tpu_torch.utils.general import safe_state
from lightgaussian_tpu_torch.utils.logging import MetricsLogger, prepare_output_dir


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Training with densify + GSS prune")
    common.add_standard_groups(parser, opt=True)
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[30_000])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--prune_iterations", nargs="+", type=int, default=[16_000, 24_000])
    parser.add_argument("--prune_percent", type=float, default=0.5)
    parser.add_argument("--prune_decay", type=float, default=0.6)
    parser.add_argument("--v_pow", type=float, default=0.1)
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--disable_viewer", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="record a torch.profiler trace of a few steps here")
    parser.add_argument("--profile_start", type=int, default=100)
    parser.add_argument("--profile_steps", type=int, default=5)
    parser.add_argument("--camera_batch", type=int, default=1,
                        help="cameras per optimizer step (1 = as the reference trains; "
                             ">1 comes with the multi-device slice and raises)")
    common.add_device_flag(parser)
    common.add_debug_nans_flag(parser)
    common.add_cache_gt_ssim_flag(parser)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    common.apply_debug_flags(args)
    model, pipeline = common.extract_standard(args)
    opt = common.extract_dataclass(args, OptimizationParams)
    device = resolve_device(args.device)
    # Full float32 in any matrix product on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TrainConfig(
        model=model, pipeline=pipeline, opt=opt,
        test_iterations=args.test_iterations,
        save_iterations=args.save_iterations,
        checkpoint_iterations=args.checkpoint_iterations,
        start_checkpoint=args.start_checkpoint,
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
        resolution=model.resolution, seed=args.seed,
        device=device,
    )
    bg = torch.full((3,), 1.0 if model.white_background else 0.0, device=device)

    state, first_iter = None, 0
    if cfg.start_checkpoint:
        state, first_iter, _ = load_checkpoint(cfg.start_checkpoint, device=device)
        print(f"Resumed from {cfg.start_checkpoint} at iteration {first_iter}")

    if not args.disable_viewer:
        print(f"[viewer] the live viewer is not ported yet; nothing listens on {args.ip}:{args.port}")

    callbacks = None
    if args.profile_dir:
        callbacks = loop.LoopCallbacks(
            on_iteration=loop.make_profiler_callback(
                args.profile_dir, args.profile_start, args.profile_steps
            )
        )

    logger = MetricsLogger(out)
    loop.train(
        scene, cfg, bg, state=state, first_iter=first_iter, callbacks=callbacks,
        densify=True, logger=logger, seed=args.seed,
        camera_batch=args.camera_batch, cache_gt_ssim=args.cache_gt_ssim,
    )
    logger.close()
    print("\nTraining complete.")


if __name__ == "__main__":
    main()
