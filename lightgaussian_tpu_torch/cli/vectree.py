"""CLI: VecTree vector quantization of a trained Gaussian PLY.

Port of `lightgaussian_tpu/cli/vectree.py` with the same flags, plus
`--device` (default cuda; without CUDA that raises unless `--device cpu`
is given): the SH features of the least important `--vq_ratio` of the
Gaussians go into a `--codebook_size` codebook fit on the device, the
bundle is bit-packed to `extreme_saving/` (with a zip for the size), and
the dequantized model is written as a PLY unless `--no_save_ply`.

Usage:
  python -m lightgaussian_tpu_torch.cli.vectree \\
      --important_score_npz_path <dir_or_npz> \\
      --input_path <.../point_cloud.ply> --save_path <out_dir> [--device cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from lightgaussian_tpu_torch.cli import common
from lightgaussian_tpu_torch.compress import vectree as vt
from lightgaussian_tpu_torch.data import ply as ply_io
from lightgaussian_tpu_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="vectree quantization")
    parser.add_argument("--important_score_npz_path", type=str, required=True)
    parser.add_argument("--input_path", type=str, required=True)
    parser.add_argument("--save_path", type=str, required=True)
    parser.add_argument("--no_save_ply", action="store_true")
    # None = the input PLY's degree; another value than the PLY's raises
    parser.add_argument("--sh_degree", type=int, default=None)
    parser.add_argument("--iteration_num", type=int, default=1000)
    parser.add_argument("--vq_ratio", type=float, default=0.6)
    parser.add_argument("--codebook_size", type=int, default=2**13)
    parser.add_argument("--no_IS", action="store_true")
    parser.add_argument("--vq_way", type=str, default="half")
    parser.add_argument("--seed", type=int, default=0)
    common.add_device_flag(parser)
    return parser


def resolve_imp_path(path: str | Path) -> Path:
    """A model directory or the npz itself."""
    p = Path(path)
    return p if p.suffix == ".npz" else p / "imp_score.npz"


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    # Full float32 in the codebook's distance products.
    torch.backends.cuda.matmul.allow_tf32 = False
    scene = ply_io.load_gaussian_ply(args.input_path, device=device)
    cfg = vt.VQConfig(
        sh_degree=args.sh_degree if args.sh_degree is not None else scene.max_sh_degree,
        vq_ratio=args.vq_ratio,
        codebook_size=args.codebook_size,
        iterations=args.iteration_num,
        no_importance=args.no_IS,
        vq_way=args.vq_way,
    )
    with np.load(resolve_imp_path(args.important_score_npz_path)) as z:
        imp = z["arr_0"]
    print(f"VQ: {scene.num_alive()} gaussians, sh_degree {cfg.sh_degree} (dim {cfg.sh_dim}), "
          f"ratio {cfg.vq_ratio}, codebook {cfg.codebook_size}")
    result, deq_scene = vt.quantize_scene(scene, imp, args.save_path, cfg, seed=args.seed)
    print(f"extreme_saving bundle: {result.size_mb:.3f} MB")
    if not args.no_save_ply:
        out_ply = Path(args.save_path) / "extreme_saving.ply"
        ply_io.save_gaussian_ply(deq_scene, out_ply)
        print(f"dequantized PLY: {out_ply}")


if __name__ == "__main__":
    main()
