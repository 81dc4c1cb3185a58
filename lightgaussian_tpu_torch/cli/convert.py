"""CLI: COLMAP structure-from-motion preprocessing (feature extraction,
matching, mapping, undistortion) and image pyramids.

Port of `lightgaussian_tpu/cli/convert.py`: the COLMAP stages run as
subprocesses (argument lists, no shell) and need the `colmap` binary; the
undistorter's `sparse/*` move under `sparse/0`; `--resize` writes
images_2/4/8 at 50/25/12.5% with PIL (imported inside the call). The flags
are the JAX CLI's, plus `--device` as every CLI of the port has it (the
command does no device work; without CUDA it raises unless `--device cpu`
is given).

Usage: python -m lightgaussian_tpu_torch.cli.convert -s <scene_dir> [--device cpu]  (expects input/)
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

from lightgaussian_tpu_torch.cli import common
from lightgaussian_tpu_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("Colmap converter")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--source_path", "-s", required=True, type=str)
    parser.add_argument("--camera", default="OPENCV", type=str)
    parser.add_argument("--colmap_executable", default="", type=str)
    parser.add_argument("--resize", action="store_true")
    common.add_device_flag(parser)
    return parser


def _run(cmd: list[str]) -> None:
    print("+", " ".join(cmd))
    proc = subprocess.run(cmd)
    if proc.returncode != 0:
        print(f"error: {cmd[1]} failed with code {proc.returncode}", file=sys.stderr)
        sys.exit(proc.returncode)


def run_colmap(args) -> None:
    colmap = args.colmap_executable or "colmap"
    if shutil.which(colmap) is None:
        print(f"error: COLMAP executable {colmap!r} not found; install COLMAP or pass --colmap_executable",
              file=sys.stderr)
        sys.exit(1)
    src = Path(args.source_path)
    use_gpu = "0" if args.no_gpu else "1"

    if not args.skip_matching:
        (src / "distorted/sparse").mkdir(parents=True, exist_ok=True)
        _run([colmap, "feature_extractor",
              "--database_path", str(src / "distorted/database.db"),
              "--image_path", str(src / "input"),
              "--ImageReader.single_camera", "1",
              "--ImageReader.camera_model", args.camera,
              "--SiftExtraction.use_gpu", use_gpu])
        _run([colmap, "exhaustive_matcher",
              "--database_path", str(src / "distorted/database.db"),
              "--SiftMatching.use_gpu", use_gpu])
        _run([colmap, "mapper",
              "--database_path", str(src / "distorted/database.db"),
              "--image_path", str(src / "input"),
              "--output_path", str(src / "distorted/sparse"),
              "--Mapper.ba_global_function_tolerance=0.000001"])

    _run([colmap, "image_undistorter",
          "--image_path", str(src / "input"),
          "--input_path", str(src / "distorted/sparse/0"),
          "--output_path", str(src),
          "--output_type", "COLMAP"])

    # the undistorter writes sparse/*; the readers expect sparse/0/*
    sparse = src / "sparse"
    (sparse / "0").mkdir(exist_ok=True)
    for f in sparse.iterdir():
        if f.name != "0":
            shutil.move(str(f), str(sparse / "0" / f.name))


def build_pyramids(source_path: str | Path) -> None:
    """images -> images_2/4/8 at 50/25/12.5% (Lanczos)."""
    from PIL import Image

    src = Path(source_path)
    images = src / "images"
    for factor, name in ((2, "images_2"), (4, "images_4"), (8, "images_8")):
        out = src / name
        out.mkdir(exist_ok=True)
        for f in sorted(images.iterdir()):
            if f.suffix.lower() not in (".png", ".jpg", ".jpeg"):
                continue
            with Image.open(f) as img:
                img.resize(
                    (max(1, round(img.width / factor)), max(1, round(img.height / factor))),
                    Image.LANCZOS,
                ).save(out / f.name)
    print("Resizing done.")


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    run_colmap(args)
    if args.resize:
        print("Copying and resizing...")
        build_pyramids(args.source_path)
    print("Done.")


if __name__ == "__main__":
    main()
