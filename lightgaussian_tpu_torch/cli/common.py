"""Shared CLI plumbing: dataclass-backed argument groups.

Port of `lightgaussian_tpu/cli/common.py`: every field of the config
dataclasses becomes a `--flag` with its default, and `get_combined_args`
merges a saved `cfg_args.json` from the model dir with the command line
(explicit flags win). The training CLIs' shared flags (`--device`,
`--debug_nans`, the ground-truth SSIM cache) are here too.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path
from typing import get_type_hints

import torch
import torch.distributed as dist

from lightgaussian_tpu_torch.config import ModelParams, OptimizationParams, PipelineParams


def add_dataclass_args(parser: argparse.ArgumentParser, cls, shorthand: dict | None = None) -> None:
    """One `--<field>` flag per field of a dataclass of bool/int/float/str."""
    shorthand = shorthand or {}
    hints = get_type_hints(cls)
    for f in dataclasses.fields(cls):
        names = [f"--{f.name}"] + ([f"-{shorthand[f.name]}"] if f.name in shorthand else [])
        t = hints[f.name]
        if t is bool:
            parser.add_argument(*names, action="store_true", default=f.default)
        else:
            parser.add_argument(*names, type=t, default=f.default)


def extract_dataclass(args: argparse.Namespace, cls):
    return cls(**{f.name: getattr(args, f.name) for f in dataclasses.fields(cls)})


# the reference's single-letter shorthands
MODEL_SHORTHAND = {"source_path": "s", "model_path": "m", "images": "i", "resolution": "r", "white_background": "w"}


def add_standard_groups(parser: argparse.ArgumentParser, opt: bool = False) -> None:
    add_dataclass_args(parser, ModelParams, shorthand=MODEL_SHORTHAND)
    add_dataclass_args(parser, PipelineParams)
    if opt:
        add_dataclass_args(parser, OptimizationParams)


def extract_standard(args: argparse.Namespace):
    return extract_dataclass(args, ModelParams), extract_dataclass(args, PipelineParams)


def add_device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def add_debug_nans_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--debug_nans", action="store_true",
        help="turn on torch.autograd.set_detect_anomaly: fail at the operation whose backward made a NaN",
    )


def apply_debug_flags(args: argparse.Namespace) -> None:
    if getattr(args, "debug_nans", False):
        torch.autograd.set_detect_anomaly(True)


def add_cache_gt_ssim_flag(parser: argparse.ArgumentParser) -> None:
    """Three-way control of the per-camera ground-truth SSIM moment cache
    (`train.loop._attach_gt_ssim_stats`): on, off, or, by default, on while
    it fits the loop's budget."""
    g = parser.add_mutually_exclusive_group()
    g.add_argument("--cache_gt_ssim", dest="cache_gt_ssim", action="store_true", default=None,
                   help="always cache the ground truth's SSIM moments (two image-sized planes a camera)")
    g.add_argument("--no_cache_gt_ssim", dest="cache_gt_ssim", action="store_false",
                   help="never cache them")


def get_combined_args(parser: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """Merge a saved training config with the command line: values in the
    model dir's cfg_args.json override argparse defaults; explicit flags win."""
    args = parser.parse_args(argv)
    cfg_path = Path(getattr(args, "model_path", "") or "") / "cfg_args.json"
    if cfg_path.exists():
        saved = json.loads(cfg_path.read_text())
        flat = {}
        for group in ("model", "pipeline", "opt"):
            if isinstance(saved.get(group), dict):
                flat.update(saved[group])
        flat.update({k: v for k, v in saved.items() if not isinstance(v, dict)})
        defaults = parser.parse_args([] if argv is None else [])
        for k, v in flat.items():
            if hasattr(args, k) and getattr(args, k) == getattr(defaults, k, None):
                setattr(args, k, v)
    return args


def refuse_world_size(name: str) -> None:
    """Trainers run in one process: under torchrun with WORLD_SIZE > 1,
    each process would train its own replica, and the replicas would drift
    apart (the blend backward adds in a varying order)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise SystemExit(
            f"{name} trains in one process (WORLD_SIZE={world}); run it without torchrun. "
            "The multi-device paths are render_sets, render_video and save_imp_score under torchrun, "
            "and the library's parallel/ steps."
        )


def init_distributed(device: torch.device) -> torch.device:
    """Join torchrun's process group when WORLD_SIZE > 1 (this process on
    `cuda:LOCAL_RANK` for a card) and keep every rank but 0 quiet; nothing
    otherwise. Returns the device this process works on."""
    from lightgaussian_tpu_torch.parallel.mesh import init_from_env

    device = init_from_env(device)
    if dist.is_initialized() and dist.get_rank() != 0:
        sys.stdout = open(os.devnull, "w")
    return device


def leave_distributed() -> None:
    """At the end of a CLI's work under torchrun: wait for every rank (rank
    0 may still be writing files) and leave the group, so that no process
    exits with the group's threads still running."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
