"""CLI: the full benchmark evaluation over the 13 standard scenes.

Port of `lightgaussian_tpu/cli/full_eval.py`: trains, renders and evaluates
Mip-NeRF 360 (x9, images_4 outdoor / images_2 indoor), Tanks&Temples (x2)
and Deep Blending (x2) through the port's CLIs' `main()`s in this process,
`--device` passed to each (default cuda; without CUDA that raises unless
`--device cpu` is given). The scene lists shrink to the dataset roots that
are given; with none, the metrics run over the model directories already
under `--output_path`. The flags are the JAX CLI's without `--interpret`.

Usage:
  python -m lightgaussian_tpu_torch.cli.full_eval -m360 <root> -tat <root> -db <root> [--device cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

from lightgaussian_tpu_torch.cli import common
from lightgaussian_tpu_torch.utils.device import resolve_device

MIPNERF360_OUTDOOR = ["bicycle", "flowers", "garden", "stump", "treehill"]
MIPNERF360_INDOOR = ["room", "counter", "kitchen", "bonsai"]
TANKS_AND_TEMPLES = ["truck", "train"]
DEEP_BLENDING = ["drjohnson", "playroom"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Full evaluation over standard scenes")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="./eval")
    parser.add_argument("--mipnerf360", "-m360", type=str, default=None)
    parser.add_argument("--tanksandtemples", "-tat", type=str, default=None)
    parser.add_argument("--deepblending", "-db", type=str, default=None)
    parser.add_argument("--iterations", type=int, default=30_000)
    common.add_device_flag(parser)
    return parser


def scene_jobs(args) -> list[tuple[str, str, str]]:
    """(source_path, images_dir, scene_name) per available dataset root."""
    jobs = []
    if args.mipnerf360:
        jobs += [(f"{args.mipnerf360}/{s}", "images_4", s) for s in MIPNERF360_OUTDOOR]
        jobs += [(f"{args.mipnerf360}/{s}", "images_2", s) for s in MIPNERF360_INDOOR]
    if args.tanksandtemples:
        jobs += [(f"{args.tanksandtemples}/{s}", "images", s) for s in TANKS_AND_TEMPLES]
    if args.deepblending:
        jobs += [(f"{args.deepblending}/{s}", "images", s) for s in DEEP_BLENDING]
    return jobs


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    device = ["--device", args.device]
    jobs = scene_jobs(args)
    if not jobs and not args.skip_metrics:
        # metrics only, over the model directories that exist
        jobs = [(None, None, p.name) for p in sorted(Path(args.output_path).iterdir()) if p.is_dir()]
    model_paths = [f"{args.output_path}/{name}" for _, _, name in jobs]

    if not args.skip_training:
        from lightgaussian_tpu_torch.cli import train_densify_prune

        for (source, images, name), mpath in zip(jobs, model_paths):
            if source is None:
                continue
            print(f"=== train {name} ===")
            train_densify_prune.main([
                "-s", source, "-i", images, "-m", mpath, "--quiet", "--eval",
                "--iterations", str(args.iterations), "--test_iterations", str(args.iterations),
                "--save_iterations", str(args.iterations), "--checkpoint_iterations", str(args.iterations),
                *device,
            ])

    if not args.skip_rendering:
        from lightgaussian_tpu_torch.cli import render_sets

        for (source, _, name), mpath in zip(jobs, model_paths):
            if source is None:
                continue
            print(f"=== render {name} ===")
            render_sets.main(["-s", source, "-m", mpath, "--quiet", "--eval", "--skip_train",
                              "--iteration", str(args.iterations), *device])

    if not args.skip_metrics:
        from lightgaussian_tpu_torch.cli import metrics

        metrics.main(["-m", *model_paths, *device])


if __name__ == "__main__":
    main()
