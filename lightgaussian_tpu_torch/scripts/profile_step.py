"""Where the bench step's time goes: its pieces, and a profiler trace read through.

Port of `scripts/profile_step.py`, at the operating point of
`scripts/bench.py` (300,000 Gaussians, SH 3, 1920x1080, cut 983,040, a zero
target with its SSIM moments cached).

  (i) Each piece timed between CUDA events (the host clock on the CPU):
      preprocess; `bin_splats`; the blend forward with its binning
      (`blend_tiled`); the full forward render; the loss; the loss's
      backward (d/dimage); forward and loss; the whole step (the bench's).
      The forward pieces run without an autograd graph, as the JAX script's
      jitted forwards do; the loss runs as the step runs it, on the cached
      moments.
  (ii) One `torch.profiler` trace of `--trace_steps` bench steps, written to
      `<out_root>/profile_step_trace.json` and read through by
      `harness.trace_summary`: the device's window and busy time, launches
      by kernel (the hand-written ones by launch counter, beside the
      counters' own count over the same steps), the device ops with the
      most time, and the longest idle gaps with the host op that was
      running when each began. The profiler slows the host, so the idle
      share is the device's busy time a step over the whole step's time
      from (i), measured without it.

`--trace PATH` reads an existing trace instead (for one, the trainer's:
`train_densify_prune --profile_dir`) and times nothing.

Usage: python -m lightgaussian_tpu_torch.scripts.profile_step [--trace_steps N] [--trace PATH]
           [--device cuda] [--out_root DIR]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from lightgaussian_tpu_torch.ops import losses
from lightgaussian_tpu_torch.ops.rasterize import render
from lightgaussian_tpu_torch.ops.rasterize.binning import bin_splats, make_grid
from lightgaussian_tpu_torch.ops.rasterize.projection import preprocess
from lightgaussian_tpu_torch.ops.rasterize.tiled import blend_tiled
from lightgaussian_tpu_torch.scripts import bench, harness, profile_bwd
from lightgaussian_tpu_torch.utils import cuda_build
from lightgaussian_tpu_torch.utils.device import resolve_device

REPS = 10


def pieces(dev: torch.device) -> dict:
    """ms of each piece of the step at the bench's operating point."""
    w, h, cap = bench.WIDTH, bench.HEIGHT, bench.MAX_INSTANCES
    scene = bench.bench_scene(dev)
    (cam,) = bench.bench_cameras(1, w, h, dev)
    bg = torch.zeros(3, device=dev)
    target = torch.zeros((3, h, w), device=dev)
    stats = losses.precompute_ssim_target_stats(target)
    grid = make_grid(w, h)
    step = bench.make_step(scene, [cam], bg, target, stats, cap)
    with torch.no_grad():
        splats = preprocess(scene, cam)
        image = render(scene, cam, bg, max_instances=cap).render

    @torch.no_grad()
    def forward_and_loss():
        return losses.gs_loss(render(scene, cam, bg, max_instances=cap).render, target, target_stats=stats)

    rows = (
        ("preprocess (cull, EWA, SH)", torch.no_grad()(lambda: preprocess(scene, cam))),
        ("bin_splats", lambda: bin_splats(splats, grid, cap)),
        ("blend_tiled forward (binning, B1, compose)", torch.no_grad()(lambda: blend_tiled(splats, bg, w, h, cap))),
        ("full forward render", torch.no_grad()(lambda: render(scene, cam, bg, max_instances=cap))),
        ("loss (L1 + D-SSIM, cached moments)", torch.no_grad()(lambda: losses.gs_loss(image, target,
                                                                                     target_stats=stats))),
        ("loss backward (d/dimage)", lambda: profile_bwd.image_gradient(image, target, stats)),
        ("forward + loss", forward_and_loss),
        ("whole step (forward, loss, backward)", step),
    )
    out = {}
    for name, fn in rows:
        out[name] = harness.ms_per_call(fn, dev, reps=REPS)
        print(f"  {name:46s} {out[name]:9.3f} ms", flush=True)
    return out


def trace_steps(dev: torch.device, steps: int, path: Path) -> dict:
    """A torch.profiler trace of `steps` bench steps at `path`, and the
    launch counters' count over the same steps."""
    step = bench.setup(1, dev)
    for _ in range(1 + bench.WARMUP):
        step()
    harness.sync(dev)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    before = cuda_build.launch_counts()
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(steps):
            step()
        harness.sync(dev)
    after = cuda_build.launch_counts()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return {k: v - before.get(k, 0) for k, v in after.items()}


def print_summary(summary: dict, steps: int | None) -> None:
    print(f"  device window {summary['window'] / 1e3:.3f} ms, busy {summary['busy'] / 1e3:.3f} ms")
    per = f" a step (over {steps})" if steps else " (the whole trace)"
    hand = {k: v / (steps or 1) for k, v in summary["hand_written"].items() if v}
    print(f"  hand-written launches{per}: {hand}")
    print(f"  kernels launched{per}: {sum(summary['launches'].values()) / (steps or 1):.1f} of "
          f"{len(summary['launches'])} names")
    print("  device ops with the most time:")
    for name, total, count in summary["top_ops"]:
        print(f"    {total / 1e3:9.3f} ms in {count:5d}  {name[:110]}")
    print("  longest idle gaps, with the host op running when each began:")
    for start, length, op in summary["gaps"]:
        print(f"    {length:9.1f} us at {start:.1f}  {op or '(no host op: Python between ops)'}")


def run(args) -> dict:
    if args.trace is not None:
        summary = harness.trace_summary(args.trace)
        print(f"trace {args.trace}")
        print_summary(summary, None)
        return {"trace": summary}
    dev = resolve_device(args.device)
    card = harness.card_line(dev)
    print(f"profile_step on {card}: {bench.N_GAUSS} Gaussians SH 3 at {bench.WIDTH}x{bench.HEIGHT}, cut "
          f"{bench.MAX_INSTANCES}; {REPS} calls a piece")
    print("(i) pieces:")
    times = pieces(dev)
    root = Path(args.out_root or harness.default_out_root())
    path = root / "profile_step_trace.json"
    counted = trace_steps(dev, args.trace_steps, path)
    summary = harness.trace_summary(path)
    print(f"(ii) torch.profiler trace of {args.trace_steps} bench steps -> {path}")
    print_summary(summary, args.trace_steps)
    print(f"  launch counters over the same steps: { {k: v for k, v in counted.items() if v} }")
    # The profiler slows the host, so the trace's window overstates the idle time of a step run without it.
    busy = summary["busy"] / 1e3 / args.trace_steps
    whole = times["whole step (forward, loss, backward)"]
    unprofiled_idle = 1.0 - busy / whole if busy else None
    print(f"  device busy {busy:.3f} ms a step against the unprofiled step's {whole:.3f} ms (piece (i)): idle share of "
          f"a step run without the profiler {unprofiled_idle}")
    result = {"card": card, "pieces": times, "trace_steps": args.trace_steps, "trace": summary,
              "launches": counted, "busy_ms_per_step": busy, "unprofiled_idle_share": unprofiled_idle}
    (root / "profile_step.json").write_text(json.dumps(result, indent=1))
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="the bench step's pieces, and a profiler trace of it read through")
    p.add_argument("--trace_steps", type=int, default=5, help="bench steps in the trace")
    p.add_argument("--trace", type=Path, default=None, help="summarise this Chrome trace instead (e.g. "
                   "train_densify_prune --profile_dir's trace.json)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out_root", type=Path, default=None, help="where the trace and profile_step.json go "
                   "(default: the temporary directory)")
    return p


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
