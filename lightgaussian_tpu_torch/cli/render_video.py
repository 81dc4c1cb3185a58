"""CLI: trajectory rendering of a saved model.

Port of `lightgaussian_tpu/cli/render_video.py`: `--video` renders the
PCA-ellipse path, `--circular` a circular offset orbit of `--radius`,
`--spherify` a spherified inward orbit, `--spiral` the flat FoV-derived
spiral, `--gaussians` perturbed-pose frames around the train views (exact
kernel); train/test stills unless skipped. Trajectories reuse a keyframe's
binning while the measured splat drift stays under `--drift_px`, for at most
`--rebin_every` frames. The flags are the JAX CLI's without `--interpret`,
plus `--device` (default cuda; without CUDA that raises unless `--device
cpu` is given); `--load_vq` renders the iteration's `extreme_saving/` bundle.

Usage: python -m lightgaussian_tpu_torch.cli.render_video -s <scene> -m <model_dir> --video [--device cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from lightgaussian_tpu_torch.cli import common
from lightgaussian_tpu_torch.data.scene import Scene
from lightgaussian_tpu_torch.ops.rasterize import default_max_instances, render
from lightgaussian_tpu_torch.render import poses as pose_gen
from lightgaussian_tpu_torch.render import sets as render_sets
from lightgaussian_tpu_torch.utils.device import resolve_device
from lightgaussian_tpu_torch.utils.general import safe_state

# flag -> trajectory kind
TRAJECTORIES = (("video", "ellipse"), ("circular", "circular"), ("spherify", "spherify"), ("spiral", "spiral"))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Render camera trajectories")
    common.add_standard_groups(parser)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--video", action="store_true")
    parser.add_argument("--circular", action="store_true")
    parser.add_argument("--spherify", action="store_true")
    parser.add_argument("--spiral", action="store_true", help="flat FoV-derived spiral orbit")
    parser.add_argument("--radius", default=5.0, type=float)
    parser.add_argument("--gaussians", action="store_true")
    parser.add_argument("--mean", default=0.0, type=float)
    parser.add_argument("--std", default=0.03, type=float)
    parser.add_argument("--n_frames", default=600, type=int)
    parser.add_argument(
        "--rebin_every", default=8, type=int,
        help="upper bound on trajectory frames between fresh binnings; the gate that acts is "
        "--drift_px. 1 = bin every frame",
    )
    parser.add_argument(
        "--drift_px", default=1.5, type=float,
        help="rebin when the largest screen-space drift of sampled splats since the last keyframe "
        "exceeds this many pixels",
    )
    parser.add_argument("--load_vq", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    common.add_device_flag(parser)
    return parser


@torch.no_grad()
def main(argv=None) -> None:
    args = common.get_combined_args(build_parser(), argv)
    model, _pipeline = common.extract_standard(args)
    device = resolve_device(args.device)
    # Full float32 in any matrix product on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    safe_state(args.quiet)

    scene = Scene(
        model.source_path, model.model_path, images_dir=model.images,
        white_background=model.white_background, eval_split=model.eval,
        resolution=model.resolution, load_iteration=args.iteration,
        shuffle=False, load_vq=args.load_vq, device=device,
    )
    bg = torch.full((3,), 1.0 if model.white_background else 0.0, device=device)
    cams = scene.getTrainCameras() or scene.getTestCameras()
    max_instances = default_max_instances(scene.gaussians)

    for name, cameras in (("train", scene.getTrainCameras()), ("test", scene.getTestCameras())):
        if not getattr(args, f"skip_{name}") and cameras:
            render_sets.render_set(
                model.model_path, name, scene.loaded_iter, cameras, scene.gaussians, bg, max_instances,
            )
    for flag, kind in TRAJECTORIES:
        if getattr(args, flag):
            render_sets.render_trajectory(
                model.model_path, kind, scene.loaded_iter, cams, scene.gaussians, bg, max_instances,
                n_frames=args.n_frames, radius=args.radius, rebin_every=args.rebin_every,
                drift_px=args.drift_px,
            )
    if args.gaussians:
        # perturbed-pose frames around the first train views
        rng = np.random.default_rng(0)
        base = Path(model.model_path) / "perturbed" / f"ours_{scene.loaded_iter}"
        for idx in range(min(args.n_frames, 100)):
            cam = pose_gen.gaussian_pose(cams[idx % len(cams)], rng, mean=args.mean, std_translation=args.std)
            img = render(scene.gaussians, cam, bg, max_instances=max_instances).render
            render_sets.save_png(img, base / f"{idx:05d}.png")


if __name__ == "__main__":
    main()
