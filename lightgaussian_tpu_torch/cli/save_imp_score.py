"""CLI: compute and export the Global Significance Score of a checkpoint.

Port of `lightgaussian_tpu/cli/save_imp_score.py`: load a training
checkpoint, sum per-Gaussian hit counts and blending weights over all train
cameras with the counting kernel (B5), weight them by the normalised volume
to the power `--v_pow`, and save `imp_score.npz` (one score per alive
Gaussian, in PLY row order). Each camera's live instance count is printed
against the cut: a frame above it is cut, and so are its scores, as in the
reference. `--show_imp_score` prints the scores' percentiles; `--get_fps`
times a render-only sweep of the train views (one warm-up render, then the
sweep between two synchronisations). The flags are the JAX CLI's without
`--interpret`, plus `--device` (default cuda; without CUDA that raises
unless `--device cpu` is given). Under torchrun the cameras are split over
the processes (one card each) and rank 0 writes the file and prints.

Usage: python -m lightgaussian_tpu_torch.cli.save_imp_score -s <scene> -m <model> --start_checkpoint <chkpnt.npz>
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from lightgaussian_tpu_torch.cli import common
from lightgaussian_tpu_torch.data.scene import Scene
from lightgaussian_tpu_torch.ops.rasterize import default_max_instances, render
from lightgaussian_tpu_torch.train import gss, loop
from lightgaussian_tpu_torch.train.checkpoint import load_checkpoint
from lightgaussian_tpu_torch.utils.device import resolve_device
from lightgaussian_tpu_torch.utils.general import safe_state


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Export imp_score.npz for a checkpoint")
    common.add_standard_groups(parser)
    parser.add_argument("--start_checkpoint", type=str, required=True)
    parser.add_argument("--v_pow", type=float, default=0.1)
    parser.add_argument("--show_imp_score", action="store_true")
    parser.add_argument("--get_fps", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    common.add_device_flag(parser)
    return parser


@torch.no_grad()
def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    model, _pipeline = common.extract_standard(args)
    device = common.init_distributed(resolve_device(args.device))
    # Full float32 in any matrix product on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    safe_state(args.quiet)

    scene = Scene(
        model.source_path, model.model_path, images_dir=model.images,
        white_background=model.white_background, eval_split=model.eval,
        resolution=model.resolution, device=device,
    )
    state, iteration, _ = load_checkpoint(args.start_checkpoint, device=device)
    print(f"Loaded checkpoint at iteration {iteration}")
    bg = torch.full((3,), 1.0 if model.white_background else 0.0, device=device)
    cams = scene.getTrainCameras()
    max_instances = default_max_instances(state.scene)

    live: list[int] = []
    _, imp = gss.accumulate_gss_auto(state.scene, cams, bg, max_instances, live_counts=live)
    over = sum(n > max_instances for n in live)
    print(f"live instances per train camera (cut {max_instances}): {live}; {over} above the cut")
    v_imp = gss.calculate_v_imp_score(state.scene, imp, args.v_pow)
    out = Path(model.model_path) / "imp_score.npz"
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    if rank0:
        loop.save_imp_score(out, state.scene, v_imp)
        print(f"Saved {out}")

    if args.show_imp_score:
        alive = state.scene.alive
        scores = v_imp[alive].cpu().numpy()
        qs = np.percentile(scores, [0, 10, 50, 90, 100])
        print(
            f"imp_score over {int(alive.sum())} gaussians: min {qs[0]:.4g} "
            f"p10 {qs[1]:.4g} median {qs[2]:.4g} p90 {qs[3]:.4g} max {qs[4]:.4g}"
        )

    if args.get_fps and rank0:
        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        render(state.scene, cams[0], bg, max_instances=max_instances, fast=True)  # warm-up
        sync()
        t0 = time.perf_counter()
        for cam in cams:
            render(state.scene, cam, bg, max_instances=max_instances, fast=True)
        sync()
        dt = time.perf_counter() - t0
        print(f"render FPS over {len(cams)} train views: {len(cams) / dt:.1f}")
    common.leave_distributed()


if __name__ == "__main__":
    main()
