"""Where a serving frame's time goes: a fresh frame and a cached one, piece by piece.

Port of `scripts/profile_binning_infer.py`. Two operating points:

  default  120,000 Gaussians at 1237x822, SH 2 (the render-FPS bench's
           evaluation point), cut at `snug_capacity` of the live count;
  --large  300,000 Gaussians at 1920x1080, SH 3, cut the same way.

Rows, each between CUDA events: the fresh frame (`render(fast=True)`:
preprocess, binning, B6, compose); preprocess alone; `bin_splats` whole
and its pieces (a)-(g) (`profile_binning.time_pieces`, with the host clock
beside the events); B6 alone; `rebind_features`, the per-frame cost of a
frame over a cached binning.

The JAX script's `forward_only` binning and its search-based slot fill
were candidates for the TPU layout; the port's binning has one form.

Usage: python -m lightgaussian_tpu_torch.scripts.profile_binning_infer [--large] [--device cuda]
           [--out_root DIR]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.ops.rasterize import blend, default_max_instances, render
from lightgaussian_tpu_torch.ops.rasterize.binning import bin_splats, make_grid, rebind_features, snug_capacity
from lightgaussian_tpu_torch.ops.rasterize.projection import preprocess
from lightgaussian_tpu_torch.scripts import harness, profile_binning
from lightgaussian_tpu_torch.utils.device import resolve_device
from lightgaussian_tpu_torch.utils.synthetic import random_scene

# operating point -> (Gaussians, width, height, SH degree)
POINTS = {"default": (120_000, 1237, 822, 2), "large": (300_000, 1920, 1080, 3)}
REPS = 30


def frame_inputs(point: str, dev: torch.device):
    """The operating point's scene, camera and background, its live
    instances and the snug cut: `render(scene, cam, bg, max_instances=cap,
    fast=True)` is its fresh frame."""
    n, width, height, degree = POINTS[point]
    scene = random_scene(n=n, seed=0, extent=2.0, scale_range=(0.004, 0.02), active_sh_degree=degree, device=dev)
    cam = Camera.look_at(eye=[5.0 * 0.19867, 0.6, -5.0 * 0.98007], target=[0, 0, 0], width=width, height=height,
                         fovx=0.9, device=dev)
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        live = render(scene, cam, bg, max_instances=default_max_instances(scene)).num_instances
    return scene, cam, bg, live, snug_capacity(live)


def run(args) -> dict:
    dev = resolve_device(args.device)
    card = harness.card_line(dev)
    point = "large" if args.large else "default"
    n, width, height, degree = POINTS[point]
    scene, cam, bg, live, cap = frame_inputs(point, dev)
    grid = make_grid(width, height)
    with torch.no_grad():
        splats = preprocess(scene, cam)
        b = bin_splats(splats, grid, cap)
    print(f"profile_binning_infer ({point}) on {card}: {n} Gaussians SH {degree} at {width}x{height}; live {live}, "
          f"snug cut {cap}, grid {grid.tiles_x}x{grid.tiles_y}; {REPS} calls a row")
    rows = {}

    def row(name, fn):
        rows[name] = harness.ms_per_call(torch.no_grad()(fn), dev, reps=REPS)
        print(f"  {name:48s} {rows[name]:9.3f} ms", flush=True)

    row("fresh frame (render(fast=True))", lambda: render(scene, cam, bg, max_instances=cap, fast=True))
    row("preprocess alone", lambda: preprocess(scene, cam))
    print("  bin_splats:")
    binning = profile_binning.time_pieces(splats, grid, cap, dev, REPS)
    row("B6 alone (blend_forward_fast)", lambda: blend.blend_forward_fast(b.tile_starts, b.inst, grid))
    row("rebind_features (a cached frame's binning)", lambda: rebind_features(splats, b))
    result = {"card": card, "point": point, "live": live, "cap": cap, "rows": rows, "binning": binning}
    out = Path(args.out_root or harness.default_out_root()) / f"profile_binning_infer_{point}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="a fresh serving frame and a cached one, piece by piece")
    p.add_argument("--large", action="store_true", help="300k Gaussians at 1920x1080, SH 3")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out_root", type=Path, default=None, help="where the report goes (default: the temporary "
                   "directory)")
    return p


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
