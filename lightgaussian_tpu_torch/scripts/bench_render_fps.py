"""Forward-only rendering FPS on the port: fresh against cached binning.

Port of `scripts/bench_render_fps.py`. Times ms per frame over an orbit at
the trajectory step (2 pi / 600 by default, `render_video`'s), on the
render-only kernel (the shipped inference path), in four configurations:

  A. fresh binning per frame, cut at `default_max_instances`
  B. fresh binning per frame, cut at `snug_capacity` of frame 0's live count
  C. cached binning, rebinned every `--rebin_every` frames, at the snug cut
  D. the drift-gated schedule of `render_video` (`render.sets.plan_rebin_schedule`:
     rebin when the measured splat drift exceeds `--drift_px`, at the
     latest every `--rebin_every` frames)

and the worst PSNR of a reused (cached) frame against its fresh render, so
that the speed-up's cost in quality is measured on the card.

Differences from the JAX script: the port sizes its instance buffer per
frame from the live count, so A and B differ only on frames whose count
passes B's cut; the report lists those frames. `--headroom` is gone: the
port's `snug_capacity` takes the live count alone. Times are CUDA events.

Usage: python -m lightgaussian_tpu_torch.scripts.bench_render_fps [--n ...] [--width ...]
           [--height ...] [--frames ...] [--device cuda]
"""
from __future__ import annotations

import argparse
import math

import torch

from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.ops import losses
from lightgaussian_tpu_torch.ops.rasterize import build_binning, default_max_instances, render
from lightgaussian_tpu_torch.ops.rasterize.binning import snug_capacity
from lightgaussian_tpu_torch.render.sets import plan_rebin_schedule
from lightgaussian_tpu_torch.scripts import harness
from lightgaussian_tpu_torch.utils.device import resolve_device
from lightgaussian_tpu_torch.utils.synthetic import random_scene

WARMUP = 4


def orbit_eye(t: float) -> list[float]:
    return [5.0 * math.sin(t), 0.6, -5.0 * math.cos(t)]


def orbit(args, device) -> list[Camera]:
    step = 2 * math.pi / args.step_div
    return [Camera.look_at(eye=orbit_eye(0.2 + i * step), target=[0, 0, 0], width=args.width, height=args.height,
                           fovx=0.9, device=device) for i in range(args.frames)]


def run(args) -> dict:
    dev = resolve_device(args.device)
    card = harness.card_line(dev)
    scene = random_scene(n=args.n, seed=0, extent=2.0, scale_range=(0.004, 0.02), active_sh_degree=args.sh_degree,
                         device=dev)
    cams = orbit(args, dev)
    bg = torch.zeros(3, device=dev)

    cap_default = default_max_instances(scene)
    with torch.no_grad():
        total0 = render(scene, cams[0], bg, max_instances=cap_default).num_instances
    cap_snug = snug_capacity(total0)
    print(f"live instances {total0}; default cut {cap_default}, snug {cap_snug}", flush=True)

    @torch.no_grad()
    def fresh(c, cap=cap_snug):
        return render(scene, c, bg, max_instances=cap, fast=True)

    @torch.no_grad()
    def cached(c, b):
        return render(scene, c, bg, cached_binning=b, fast=True).render

    def bin_at(c):
        return build_binning(scene, c, max_instances=cap_snug)

    totals = [fresh(c).num_instances for c in cams]
    cut = {"A": [i for i, t in enumerate(totals) if t > cap_default],
           "B": [i for i, t in enumerate(totals) if t > cap_snug]}

    def ms_fresh(cap):
        def pass_():
            for c in cams:
                fresh(c, cap)

        for c in cams[:WARMUP]:
            fresh(c, cap)
        return harness.ms_per_call(pass_, dev, reps=1, warmup=0) / len(cams)

    def ms_schedule(flags):
        # as render_trajectory: a keyframe whose binning no frame reuses goes
        # through the fused fresh render
        n = len(flags)
        reused = [i + 1 < n and not flags[i + 1] for i in range(n)]

        def pass_():
            binning = None
            for i, c in enumerate(cams):
                if flags[i] and not reused[i]:
                    fresh(c)
                    continue
                if flags[i]:
                    binning = bin_at(c)
                cached(c, binning)

        warm = bin_at(cams[0])
        for c in cams[:WARMUP]:
            cached(c, warm)
        return harness.ms_per_call(pass_, dev, reps=1, warmup=0) / n

    def worst_psnr(flags):
        binning, worst = None, 100.0
        for i, c in enumerate(cams):
            if flags[i]:
                binning = bin_at(c)
                continue
            a = torch.clamp(cached(c, binning), 0, 1)
            b = torch.clamp(fresh(c).render, 0, 1)
            worst = min(worst, float(losses.psnr(a, b)))
        return worst

    ms_a = ms_fresh(cap_default)
    ms_b = ms_fresh(cap_snug)
    flags_c = [i % args.rebin_every == 0 for i in range(len(cams))]
    ms_c = ms_schedule(flags_c)
    worst_c = worst_psnr(flags_c)
    flags_d = plan_rebin_schedule(scene, cams, args.rebin_every, args.drift_px)
    n_rebin = sum(flags_d)
    ms_d = ms_schedule(flags_d)
    worst_d = worst_psnr(flags_d) if n_rebin < len(cams) else float("inf")

    def cut_note(key):
        return f"; frames over the cut: {cut[key]}" if cut[key] else "; no frame over the cut"

    print(f"device: {card}; {args.n} Gaussians SH {args.sh_degree}, {args.width}x{args.height}, {len(cams)} frames, "
          f"step 2pi/{args.step_div}")
    print(f"A fresh @default cut : {ms_a:7.2f} ms/frame = {1e3 / ms_a:6.1f} FPS{cut_note('A')}")
    print(f"B fresh @snug cut    : {ms_b:7.2f} ms/frame = {1e3 / ms_b:6.1f} FPS{cut_note('B')}")
    print(f"C cached (rebin {args.rebin_every:2d})  : {ms_c:7.2f} ms/frame = {1e3 / ms_c:6.1f} FPS ; "
          f"worst reused-frame PSNR {worst_c:.1f} dB")
    print(f"D drift-gated {args.drift_px:4.1f}px  : {ms_d:7.2f} ms/frame = {1e3 / ms_d:6.1f} FPS ; "
          f"{n_rebin}/{len(cams)} frames rebinned ; worst reused-frame PSNR {worst_d:.1f} dB")
    print(f"speedup C/A: {ms_a / ms_c:.2f}x ; D/A: {ms_a / ms_d:.2f}x", flush=True)
    return {"card": card, "total0": total0, "cap_default": cap_default, "cap_snug": cap_snug, "cut": cut,
            "ms": {"A": ms_a, "B": ms_b, "C": ms_c, "D": ms_d}, "worst_psnr": {"C": worst_c, "D": worst_d},
            "flags_d": flags_d, "n_rebin": n_rebin}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="forward-only rendering FPS, fresh against cached binning")
    p.add_argument("--n", type=int, default=300_000)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--frames", type=int, default=48)
    p.add_argument("--rebin_every", type=int, default=8)
    p.add_argument("--drift_px", type=float, default=1.5)
    p.add_argument("--step_div", type=int, default=600, help="orbit step = 2*pi/step_div (600 = render_video's)")
    p.add_argument("--sh_degree", type=int, default=3, help="active SH degree (2 = a distilled model's)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
