"""CLI: SSIM, PSNR and LPIPS over rendered sets.

Port of `lightgaussian_tpu/cli/metrics.py`, plus `--device` (default cuda;
without CUDA that raises unless `--device cpu` is given): walks each
`<model>/<set>/ours_<it>/{renders,gt}` pair and writes `results.json` and
`per_view.json` into the model directory. LPIPS weights: `$LPIPS_WEIGHTS`
or `eval/weights/lpips_vgg.npz`, else the seeded `vgg-random` network.

Usage: python -m lightgaussian_tpu_torch.cli.metrics -m <model_dir> [<model_dir> ...] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from lightgaussian_tpu_torch.cli import common
from lightgaussian_tpu_torch.eval.metrics import evaluate_model_paths
from lightgaussian_tpu_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Evaluate rendered model sets")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+", type=str, default=[])
    parser.add_argument("--set_name", type=str, default="test")
    common.add_device_flag(parser)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    evaluate_model_paths(args.model_paths, set_name=args.set_name, device=device)


if __name__ == "__main__":
    main()
