"""CLI: render train/test sets of a saved iteration to PNG directories.

Port of `lightgaussian_tpu/cli/render_sets.py`, the serving path: the same
flags (`--iteration -1` = latest, `--skip_train/--skip_test`, `--new_sh` for
SH-truncating loads, `--load_vq` for the iteration's `extreme_saving/`
bundle) without `--interpret`, plus `--device` (default cuda; without CUDA
that raises unless `--device cpu` is given). Under torchrun
(`torchrun --nproc_per_node=N -m lightgaussian_tpu_torch.cli.render_sets
...`) the frames are rendered in strips over the N processes, one card
each, and rank 0 writes them.

Usage: python -m lightgaussian_tpu_torch.cli.render_sets -s <scene> -m <model_dir> [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from lightgaussian_tpu_torch.cli import common
from lightgaussian_tpu_torch.data.scene import Scene
from lightgaussian_tpu_torch.render import sets as render_sets
from lightgaussian_tpu_torch.utils.device import resolve_device
from lightgaussian_tpu_torch.utils.general import safe_state


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Render saved train/test sets")
    common.add_standard_groups(parser)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--load_vq", action="store_true")
    parser.add_argument("--new_sh", type=int, default=None)
    parser.add_argument("--quiet", action="store_true")
    common.add_device_flag(parser)
    return parser


def main(argv=None) -> None:
    args = common.get_combined_args(build_parser(), argv)
    model, _pipeline = common.extract_standard(args)
    device = common.init_distributed(resolve_device(args.device))
    # Full float32 in any matrix product on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    safe_state(args.quiet)
    print(f"Rendering {model.model_path}")

    scene = Scene(
        model.source_path, model.model_path, images_dir=model.images,
        white_background=model.white_background, eval_split=model.eval,
        resolution=model.resolution, load_iteration=args.iteration,
        shuffle=False, load_vq=args.load_vq, new_sh_degree=args.new_sh,
        device=device,
    )
    bg = torch.full((3,), 1.0 if model.white_background else 0.0, device=device)

    if not args.skip_train and scene.getTrainCameras():
        render_sets.render_set(
            model.model_path, "train", scene.loaded_iter, scene.getTrainCameras(),
            scene.gaussians, bg,
        )
    if not args.skip_test and scene.getTestCameras():
        render_sets.render_set(
            model.model_path, "test", scene.loaded_iter, scene.getTestCameras(),
            scene.gaussians, bg,
        )
    common.leave_distributed()


if __name__ == "__main__":
    main()
