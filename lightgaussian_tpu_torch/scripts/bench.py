"""Throughput of the differentiable 1080p step on one card: pixels/s.

Port of the throughput path of the root `bench.py` (its `main`). A step is
the forward render of a 1920x1080 view of a 300,000-Gaussian synthetic
scene (SH 3, instance cut 983,040), the L1 + D-SSIM loss against a zero
target with its SSIM moments cached once (`precompute_ssim_target_stats`),
and the backward to every parameter (`train/step.gradients` of
`param_leaves`), the hot loop of 3D-GS training. There is no Adam and no
densification statistic: the bench times a gradient, as the JAX one does.

Timing: one first step, WARMUP more, then `--repeats` groups of `--iters`
steps, each group between CUDA events and a synchronise (the host clock on
the CPU). The reported step time is the median group; the spread is the
least and the largest group. The last line of stdout is one JSON object:

  {"metric": "pixels_per_sec_per_chip_fwd_bwd_1080p", "value": pixels/s,
   "unit": "pixels/s", "median_ms": ..., "spread_ms": [min, max], "groups": ...}

`--batch B` renders B orbit cameras a step (eye at angle 0.2 + 0.01 i) and
takes one backward of the mean of their losses; value is then B x the
pixels of a view per second. Differences from the JAX script: the batched
step uses the cached target moments too (the JAX one recomputes them each
step; the loss is the same to rounding, and the launches are the
trainer's); `vs_baseline` is gone (its divisor was a guess about another
GPU class, not a measurement); `--parity` is not ported (its gate is
`chip_smoke.py`, phases 2 and 3). The card line precedes the JSON line and
the report also goes to `<out_root>/bench.json`.

On the card a step launches B1, B2, B3 and B4 once a camera; B4 also runs
once at set-up (the target's moments).

Usage: python -m lightgaussian_tpu_torch.scripts.bench [--batch B] [--iters N] [--repeats R]
           [--device cuda] [--out_root DIR]
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import torch

from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.ops import losses
from lightgaussian_tpu_torch.ops.rasterize import render
from lightgaussian_tpu_torch.scripts import harness
from lightgaussian_tpu_torch.train.step import gradients, param_leaves
from lightgaussian_tpu_torch.utils.device import resolve_device
from lightgaussian_tpu_torch.utils.synthetic import default_camera, random_scene

METRIC = "pixels_per_sec_per_chip_fwd_bwd_1080p"
WIDTH, HEIGHT = 1920, 1080
N_GAUSS = 300_000
# The cut real training settles at for this scene: snug_capacity of its
# ~750k live instances (the JAX script's MAX_INSTANCES).
MAX_INSTANCES = 983_040
WARMUP, ITERS, REPEATS = 3, 10, 5


def bench_scene(device: torch.device):
    return random_scene(n=N_GAUSS, seed=0, extent=2.0, scale_range=(0.004, 0.02), active_sh_degree=3, device=device)


def bench_cameras(batch: int, width: int, height: int, device: torch.device) -> list[Camera]:
    """The bench's view, or with `batch` > 1 its orbit of cameras."""
    if batch == 1:
        return [default_camera(width=width, height=height, dist=5.0, device=device)]
    return [Camera.look_at(eye=[5.0 * math.sin(0.2 + 0.01 * i), 0.6, -5.0 * math.cos(0.2 + 0.01 * i)],
                           target=[0, 0, 0], width=width, height=height, device=device) for i in range(batch)]


def make_step(scene, cameras: list[Camera], bg, target, target_stats, max_instances: int):
    """step() -> (loss, gradients of every parameter, most live instances of
    a view): the mean over `cameras` of `gs_loss` of the render against
    `target` with its cached moments, differentiated once."""

    def step():
        params = param_leaves(scene)
        s = scene.with_params(params)
        per_view, live = [], []
        for cam in cameras:
            out = render(s, cam, bg, max_instances=max_instances)
            per_view.append(losses.gs_loss(out.render, target, target_stats=target_stats))
            live.append(out.num_instances)
        loss = torch.stack(per_view).mean()
        grads, _ = gradients(loss, params)
        return loss.detach(), grads, max(live)

    return step


def setup(batch: int, device: torch.device):
    """The bench's step at its operating point; the target's moments are
    computed here (B4 once on the card)."""
    scene = bench_scene(device)
    bg = torch.zeros(3, device=device)
    target = torch.zeros((3, HEIGHT, WIDTH), device=device)
    stats = losses.precompute_ssim_target_stats(target)
    return make_step(scene, bench_cameras(batch, WIDTH, HEIGHT, device), bg, target, stats, MAX_INSTANCES)


def run(args) -> dict:
    dev = resolve_device(args.device)
    card = harness.card_line(dev)
    step = setup(args.batch, dev)
    t0 = time.perf_counter()
    _, _, live = step()
    harness.sync(dev)
    print(f"first step: {time.perf_counter() - t0:.3f} s, instances={live} (capacity {MAX_INSTANCES}, camera batch "
          f"{args.batch})", file=sys.stderr)
    for _ in range(WARMUP):
        step()
    groups = sorted(harness.ms_per_call(step, dev, reps=args.iters, warmup=0) for _ in range(args.repeats))
    half = len(groups) // 2
    median = groups[half] if len(groups) % 2 else 0.5 * (groups[half - 1] + groups[half])
    print(f"step time: median {median:.3f} ms over {args.repeats}x{args.iters} steps (min {groups[0]:.3f}, max "
          f"{groups[-1]:.3f}; {args.batch} cameras) on {card}", file=sys.stderr)
    line = {
        "metric": METRIC,
        "value": round(args.batch * WIDTH * HEIGHT / (median * 1e-3)),
        "unit": "pixels/s",
        "median_ms": median,
        "spread_ms": [groups[0], groups[-1]],
        "groups": args.repeats,
    }
    out = Path(args.out_root or harness.default_out_root()) / "bench.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "batch": args.batch, "iters": args.iters, "group_ms": groups,
                               "live_instances": live, **line}, indent=1))
    print(card)
    print(json.dumps(line), flush=True)
    return line


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="pixels/s of the differentiable 1080p step")
    p.add_argument("--batch", type=int, default=1, help="cameras a step (one backward of their mean loss)")
    p.add_argument("--iters", type=int, default=ITERS, help="timed steps a group")
    p.add_argument("--repeats", type=int, default=REPEATS, help="timing groups; the reported time is the median")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out_root", type=Path, default=None, help="where bench.json goes (default: the temporary "
                   "directory)")
    return p


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
