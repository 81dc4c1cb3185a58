"""Where binning's time goes: `bin_splats` piece by piece, in its train form.

Port of `scripts/profile_binning.py`, by default at its operating point:
300,000 Gaussians (SH 3) at 1920x1080 from the bench's camera, instance cut
1,114,112; `--gaussians`, `--width`, `--height` and `--cut` set another
(the benchmark's cells: 3,000,000 or 1,020,000 at 1237x822 and 6,100,000 at
3840x2160, `--cut 0` keeping every live instance). The scene is
`random_scene`'s cube of small splats, seen from `default_camera`. Each of
the pieces `bin_splats` runs, in its order (the private helpers of
`ops/rasterize/binning.py`, so the profile times the code the path runs):

  (a) the tile cover                       (b) cumsum + the host read of the total
  (c-d) the emission: each slot's Gaussian, tile and 32-bit (tile | depth) key
  (e) the sort + the gid gather            (f) searchsorted for tile_starts
  (g) `pack_features` + the row gather

is timed two ways on the inputs the pieces before it made: between CUDA
events over back-to-back calls, and on the host clock around one call
between synchronises. The whole `bin_splats` is timed the same ways. The
host read in (b) is the binning's one synchronise: it shows as the gap
between its two times. The pieces composed in order must give
`bin_splats`'s outputs bit for bit (`compose`).

The JAX script's other rows are A/B tests of TPU layouts and have no
counterpart here: scatter-marks + `cummax` for the slot fill, the 1-key /
2-payload sorts, the `pre_pos` permutation and the chunk transpose (the
port keeps instances instance-major and reduces with atomics).

Usage: python -m lightgaussian_tpu_torch.scripts.profile_binning [--device cuda] [--gaussians N] [--width W]
       [--height H] [--cut M] [--out_root DIR]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from lightgaussian_tpu_torch.ops.rasterize import binning as B
from lightgaussian_tpu_torch.ops.rasterize.projection import preprocess
from lightgaussian_tpu_torch.scripts import harness
from lightgaussian_tpu_torch.utils.device import resolve_device
from lightgaussian_tpu_torch.utils.synthetic import default_camera, random_scene

WIDTH, HEIGHT = 1920, 1080
N_GAUSS = 300_000
CAP = 1_114_112
REPS = 20
PIECES = ("(a) tile cover", "(b) cumsum + host read of the total", "(c-d) emission (gid, tile, 32-bit key)",
          "(e) sort + gid gather", "(f) searchsorted tile_starts", "(g) pack_features + row gather")


def compose(splats, grid, cap: int):
    """`bin_splats`'s pieces run in its order. Returns [(piece, call)], each
    call running its piece again on the inputs the pieces before it made,
    and the composed outputs (gid_sorted, tile_starts, inst, total)."""
    cover = B._cover(splats, grid)
    cum, total, _ = B._instance_total(cover.count)
    m = min(total, B.instance_capacity(cap))
    if m == 0:
        raise ValueError("no live instance to bin")
    key, gid = B._emit(cover, cum, splats.depth, total, m, grid)
    key_s, gid_s = B._sort_instances(key, gid)
    starts = B._tile_starts(key_s, grid)
    inst = B._gather_features(splats, gid_s)
    calls = [
        lambda: B._cover(splats, grid),
        lambda: B._instance_total(cover.count),
        lambda: B._emit(cover, cum, splats.depth, total, m, grid),
        lambda: B._sort_instances(key, gid),
        lambda: B._tile_starts(key_s, grid),
        lambda: B._gather_features(splats, gid_s),
    ]
    return list(zip(PIECES, calls)), {"gid_sorted": gid_s, "tile_starts": starts, "inst": inst, "total": total}


def equals_bin_splats(composed: dict, b: B.Binning) -> bool:
    return (composed["total"] == b.total and torch.equal(composed["gid_sorted"], b.gid_sorted)
            and torch.equal(composed["tile_starts"], b.tile_starts) and torch.equal(composed["inst"], b.inst))


def time_pieces(splats, grid, cap: int, dev: torch.device, reps: int = REPS) -> dict:
    """Each piece and the whole `bin_splats`, CUDA events and host clock,
    and whether the composition equals `bin_splats` bit for bit."""
    calls, composed = compose(splats, grid, cap)
    b = B.bin_splats(splats, grid, cap)
    rows = {}
    for name, fn in [*calls, ("bin_splats whole", lambda: B.bin_splats(splats, grid, cap))]:
        rows[name] = {"ms": harness.ms_per_call(fn, dev, reps=reps), "host_ms": harness.host_ms_per_call(fn, dev, reps)}
        print(f"  {name:40s} {rows[name]['ms']:9.3f} ms a call back to back; {rows[name]['host_ms']:9.3f} ms between "
              "synchronises", flush=True)
    whole = rows.pop("bin_splats whole")
    total_ms = sum(r["ms"] for r in rows.values())
    bit_equal = equals_bin_splats(composed, b)
    print(f"  pieces sum {total_ms:.3f} ms = {total_ms / whole['ms']:.3f} x the whole; composed outputs "
          f"{'bit-equal to' if bit_equal else 'DIFFER from'} bin_splats's; {b.total} live instances, cut {cap}")
    return {"pieces": rows, "whole": whole, "sum_ms": total_ms, "ratio": total_ms / whole["ms"],
            "bit_equal": bit_equal, "live": b.total, "cap": cap}


def run(args) -> dict:
    dev = resolve_device(args.device)
    card = harness.card_line(dev)
    cap = args.cut or B.MAX_CAPACITY
    print(f"profile_binning on {card}: {args.gaussians} Gaussians SH 3 at {args.width}x{args.height}, cut {cap}, "
          f"{REPS} calls a row")
    scene = random_scene(n=args.gaussians, seed=0, extent=2.0, scale_range=(0.004, 0.02), active_sh_degree=3,
                         device=dev)
    cam = default_camera(width=args.width, height=args.height, dist=5.0, device=dev)
    with torch.no_grad():
        splats = preprocess(scene, cam)
    del scene
    result = {"card": card, "gaussians": args.gaussians, "width": args.width, "height": args.height,
              **time_pieces(splats, B.make_grid(args.width, args.height), cap, dev)}
    out = Path(args.out_root or harness.default_out_root()) / "profile_binning.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="bin_splats piece by piece")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--gaussians", type=int, default=N_GAUSS, help=f"Gaussians of the scene (default {N_GAUSS})")
    p.add_argument("--width", type=int, default=WIDTH, help=f"image width in pixels (default {WIDTH})")
    p.add_argument("--height", type=int, default=HEIGHT, help=f"image height in pixels (default {HEIGHT})")
    p.add_argument("--cut", type=int, default=CAP, help=f"instance cut (default {CAP}; 0 keeps every live instance)")
    p.add_argument("--out_root", type=Path, default=None, help="where profile_binning.json goes (default: the "
                   "temporary directory)")
    return p


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
