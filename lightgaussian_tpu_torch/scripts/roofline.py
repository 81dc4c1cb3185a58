"""Speed-of-light accounting on the card: the instruction rates, the memory
stream and the training step's stages against their byte floors.

Port of the measuring parts of `scripts/roofline.py` and
`scripts/roofline_close.py`:

  (a) the issue-rate probe's rates (`utils/issue_probe.measure`, the port of
      the JAX script's `_chain_kernel`);
  (b) the memory stream (one large `copy_`, read + write) beside the
      published 3.35 TB/s that every byte bound divides by, and a row gather
      of [rows, 16] float32 at the binning's own indices (instance ->
      Gaussian, as the cached binning gathers its features), at those
      indices sorted, and at identity indices;
  (c) the training step at the bench shape (300,000 Gaussians, SH 3,
      1920x1080, cut 983,040), split at its stage marks
      (`utils/stage_marks.py`), each stage beside the floor of the bytes it
      must read and write once (the per-piece accounting of
      `roofline_close.py`, taken from the step's own marks instead of
      stubbing pieces out).

The JAX scripts' Pallas and XLA-layout pieces (the VPU micro-chains on a
[128, 1024] block, `unchunk + gather + segment_reduce`) have no counterpart:
the port's backward reduces per Gaussian with atomicAdd. The report goes to
stdout and `<out_root>/roofline.json`.

Usage: python -m lightgaussian_tpu_torch.scripts.roofline [--device cuda] [--out_root DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
from pathlib import Path

import torch

from lightgaussian_tpu_torch.config import OptimizationParams
from lightgaussian_tpu_torch.ops import losses
from lightgaussian_tpu_torch.ops.rasterize import render
from lightgaussian_tpu_torch.ops.rasterize.binning import make_grid
from lightgaussian_tpu_torch.ops.rasterize.projection import preprocess
from lightgaussian_tpu_torch.ops.rasterize.tiled import build_binning
from lightgaussian_tpu_torch.scripts import harness
from lightgaussian_tpu_torch.train.state import init_train_state
from lightgaussian_tpu_torch.train.step import make_train_step
from lightgaussian_tpu_torch.utils import issue_probe, stage_marks
from lightgaussian_tpu_torch.utils.device import resolve_device
from lightgaussian_tpu_torch.utils.synthetic import default_camera, random_scene

# Published H100 SXM memory rate (NVIDIA data sheet): the divisor of every
# byte bound that chip_smoke.py reports.
PEAK_BYTES = 3.35e12
WIDTH, HEIGHT = 1920, 1080
N_GAUSS = 300_000
CAP = 983_040  # the step's instance cut at the bench shape
STREAM_BYTES = 1 << 30  # each of the copy's two buffers; far past the 50 MB L2
GATHER_WIDTH = 16
STEP_REPS = 20
PIX = 1024  # pixels of a 32x32 tile


def probe_rates(device: torch.device) -> dict:
    print("\n== (a) issue rates: dependent chains of one instruction kind (utils/issue_probe) ==")
    rates = issue_probe.measure(device)
    for kind, r in rates.items():
        print(f"  {kind:14s} {r['ns_per_pass']:9.3f} ns a pass over {r['elements']} elements = "
              f"{r['per_second'] / 1e12:7.3f} T {r['unit']} instructions/s")
    return rates


def stream_and_gather(device: torch.device, stream_bytes: int, gid: torch.Tensor, rows: int) -> dict:
    print("\n== (b) memory stream and row gathers ==")
    src = torch.rand(stream_bytes // 4, device=device)
    dst = torch.empty_like(src)
    ms = harness.ms_per_call(lambda: dst.copy_(src), device)
    stream = 2 * src.numel() * 4 / (ms * 1e-3)
    print(f"  copy_ of {stream_bytes / 2**20:.0f} MiB (read + write) {ms:9.4f} ms -> {stream / 1e9:8.1f} GB/s "
          f"({stream / PEAK_BYTES:.3f} of the published {PEAK_BYTES / 1e12:.2f} TB/s)")
    del src, dst
    table = torch.zeros(max(rows, gid.numel()), GATHER_WIDTH, device=device)
    m = gid.numel()
    gathers = {}
    for name, idx in (("binning order", gid), ("sorted", torch.sort(gid).values),
                      ("identity", torch.arange(m, device=device))):
        g_ms = harness.ms_per_call(lambda i=idx: table[i], device)
        moved = m * (2 * GATHER_WIDTH * 4 + idx.element_size())
        gathers[name] = {"ms": g_ms, "ns_per_row": g_ms * 1e6 / m, "bytes_per_s": moved / (g_ms * 1e-3)}
        print(f"  gather {m} rows of {GATHER_WIDTH} f32, {name:13s} {g_ms:9.4f} ms -> "
              f"{g_ms * 1e6 / m:6.3f} ns/row ({moved / (g_ms * 1e-3) / 1e9:7.1f} GB/s)")
    return {"stream_ms": ms, "stream_bytes_per_s": stream, "stream_bytes": 2 * stream_bytes, "gathers": gathers}


def stage_bytes(n: int, params_b: int, splat_b: int, m: int, tiles: int, width: int, height: int) -> dict:
    """Bytes each stage of the step must read and write once: a floor for
    any implementation of it. n Gaussians, m live instances."""
    inst_b, gid_b, starts_b = 36 * m, 8 * m, 4 * (tiles + 1)
    tile_img_b = 4 * 4 * PIX * tiles  # RGB + T per tile pixel
    img_b, t_b = 4 * 3 * width * height, 4 * width * height
    grad_b = 36 * n  # d(mean2d, conic, colour, opacity) per Gaussian
    return {
        "preprocess": params_b + splat_b,
        "binning": splat_b + inst_b + gid_b + starts_b,
        "B1": inst_b + starts_b + tile_img_b,
        "compose": tile_img_b + img_b + t_b,
        # the image, the ground truth and its two cached SSIM moment planes
        "loss forward": 4 * img_b,
        "loss backward": 4 * img_b + img_b,
        # the image's gradient, the image and T (the seed), the binning; per-Gaussian gradients out
        "B2 + reduce": 2 * img_b + t_b + inst_b + gid_b + starts_b + grad_b,
        "preprocess backward": params_b + grad_b + params_b,
        # read parameters, gradients and both moments; write parameters and moments
        "Adam": 7 * params_b,
        # radii, the offset gradient (2), accumulator, denominator and max radii in; the last three out
        "densify statistics + metrics": 4 * n * (1 + 2 + 3 + 3),
    }


def step_stages(device: torch.device, width: int, height: int, n: int, cap: int, stream: float,
                reps: int) -> dict:
    print(f"\n== (c) the training step at {width}x{height}, {n} Gaussians SH 3, cut {cap}, split at its stage "
          "marks ==")
    scene = random_scene(n=n, seed=0, extent=2.0, scale_range=(0.004, 0.02), active_sh_degree=3, device=device)
    cam = default_camera(width=width, height=height, dist=5.0, device=device)
    gt = torch.rand((3, height, width), generator=torch.Generator(device=device).manual_seed(0), device=device)
    cam = cam.with_gt(gt).with_gt_ssim_stats(losses.precompute_ssim_target_stats(gt))
    bg = torch.zeros(3, device=device)
    state = init_train_state(scene)
    step = make_train_step(OptimizationParams(), 1.0, cap)
    with torch.no_grad():
        splats = preprocess(scene, cam)
        m = render(scene, cam, bg, max_instances=cap).num_instances
    splat_b = sum(getattr(splats, f.name).numel() * getattr(splats, f.name).element_size()
                  for f in dataclasses.fields(splats))
    params_b = sum(v.numel() * v.element_size() for v in scene.params().values())
    floors = stage_bytes(n, params_b, splat_b, min(m, cap), make_grid(width, height).num_tiles, width, height)
    for _ in range(3):
        step(state, cam, bg)
    runs = []
    for _ in range(reps):
        harness.sync(device)
        stage_marks.start(device)
        step(state, cam, bg)
        harness.sync(device)
        runs.append(stage_marks.stop())
    names = [name for name, _ in runs[0]]
    out = {}
    for i, name in enumerate(names):
        ms = statistics.median(r[i][1] for r in runs)
        b = floors.get(name, 0)
        out[name] = {"ms": ms, "bytes": b, "floor_ms_stream": 1e3 * b / stream, "floor_ms_peak": 1e3 * b / PEAK_BYTES}
        print(f"  {name:30s} {ms:9.3f} ms; floor {b / 1e6:8.1f} MB -> {1e3 * b / stream:7.3f} ms at the measured "
              f"stream, {1e3 * b / PEAK_BYTES:7.3f} ms at {PEAK_BYTES / 1e12:.2f} TB/s")
    total = sum(v["ms"] for v in out.values())
    floor = sum(v["floor_ms_stream"] for v in out.values())
    print(f"  marked step {total:.3f} ms against a byte floor of {floor:.3f} ms at the measured stream "
          f"({m} live instances, median of {reps})", flush=True)
    return {"stages": out, "live_instances": m, "step_ms": total, "floor_ms": floor}


def run(device: str | torch.device = "cuda", out_root: Path | None = None) -> dict:
    dev = resolve_device(device)
    card = harness.card_line(dev)
    print(f"roofline on {card}")
    rates = probe_rates(dev)
    scene = random_scene(n=N_GAUSS, seed=0, extent=2.0, scale_range=(0.004, 0.02), active_sh_degree=3, device=dev)
    with torch.no_grad():
        cam = default_camera(width=WIDTH, height=HEIGHT, dist=5.0, device=dev)
        b = build_binning(preprocess(scene, cam), WIDTH, HEIGHT, CAP)
    mem = stream_and_gather(dev, STREAM_BYTES, b.gid_sorted, N_GAUSS)
    del scene, b
    steps = step_stages(dev, WIDTH, HEIGHT, N_GAUSS, CAP, mem["stream_bytes_per_s"], STEP_REPS)
    result = {"card": card, "peak_bytes_per_s": PEAK_BYTES, "rates": rates, "memory": mem, "step": steps}
    out = Path(out_root or harness.default_out_root()) / "roofline.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(f"written {out}")
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="issue rates, the memory stream and the step's stages against floors")
    p.add_argument("--device", default="cuda", help="cuda (default); the probe needs a card")
    p.add_argument("--out_root", type=Path, default=None, help="where roofline.json goes (default: the temporary "
                   "directory)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    run(args.device, args.out_root)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
