#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`lightgaussian_tpu_torch`) on one GPU.

Usage: python3 chip_smoke.py        (from the repository root; needs one CUDA card)

Phases, each of which exits non-zero on failure:
  1. The card (nvidia-smi name and power limit) and the kernels' nvcc build.
  2. Each blend kernel against its plain PyTorch version on the card, on the
     2048-Gaussian 192x128 parity scene and on a scene whose tiles saturate
     (so the early exit runs): atol 2e-4, the JAX package's compiled-kernel
     tolerance (other exp and summation order); the render-only kernel
     against the exact one at 2e-3 (they differ on saturated pixels only).
  3. The serving path at full width: a 300k-Gaussian SH-3 scene at
     1920x1080 saved as a PLY, a Blender-format source with 8 test cameras,
     and `lightgaussian_tpu_torch.cli.render_sets` writing their PNGs through
     the render-only kernel. Then the exact render path (`render()`'s
     default) over the same cameras. Launch counts are read around each path.
     Kernels are held against their plain versions at these shapes, and the
     render, its stages and the kernels are timed.
Then a `{"kernels": [...]}` line, the card line, and the final
`{"ok": true, "device": {...}}` line.

The script imports nothing of JAX. It builds everything it runs from the
sources beside it; without CUDA, or without the package beside it, it fails.
"""
from __future__ import annotations

import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): 67 TFLOP/s in float32
# outside the tensor cores, which counts a fused multiply-add as two
# operations, and 3.35 TB/s of HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# The blend kernels are built with --fmad=false, so each float32 add,
# multiply, compare or min of their source is one instruction. The FP32 pipes
# issue one instruction per lane and clock: half the flop rate. exp2 runs on
# the MUFU pipe at 16 results per SM and clock against 128 for FP32 (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0). Compares and mins are counted at the FP32 add rate, the fastest they
# could go, so the bound stays a least time.
F32_INSTR_RATE = PEAK_F32_FLOPS / 2
MUFU_RATE = F32_INSTR_RATE * 16 / 128
# Instructions per (instance, pixel) pair of each kind of blend.WORK_KINDS,
# from the per-pair code of csrc/blend_forward.cu:
#   every pair: dx, dy (2), power (9), power > 0 (1)                12 FP32
#   power <= 0: expf (six FP32 around one MUFU.EX2), the opacity
#     product, the min with 0.99 and the alpha test (3)             +9 FP32, 1 MUFU
#   eligible: 1 - alpha and the T product (2)                       +2
#     past the pixel's stop (render-only kernel): nothing more
#     ending the blend: the T test (1)                              +1
#     applied: the T test, alpha * T, three colour multiply-adds    +8
F32_PER_PAIR = {"culled": 12, "faint": 21, "past_stop": 23, "stopping": 24, "applied": 31}
MUFU_PER_PAIR = {"culled": 0, "faint": 1, "past_stop": 1, "stopping": 1, "applied": 1}
N_VIEWS = 8
WIDTH, HEIGHT = 1920, 1080
KERNEL_TOL = 2e-4
FAST_VS_EXACT_TOL = 2e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=False,
    )
    if proc.returncode != 0 or not proc.stdout.strip():
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def orbit_eye(t: float) -> list[float]:
    """The orbit of scripts/bench_render_fps.py."""
    return [5.0 * math.sin(t), 0.6, -5.0 * math.cos(t)]


def blender_c2w(eye) -> list[list[float]]:
    """Camera-to-world matrix of a camera at `eye` looking at the origin, in
    the Blender convention of transforms_*.json (y up, z back)."""
    eye = np.asarray(eye, np.float64)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, down, fwd], axis=1)
    c2w[:3, 3] = eye
    c2w[:3, 1:3] *= -1
    return c2w.tolist()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    if not (REPO / "lightgaussian_tpu_torch" / "csrc" / "blend_forward.cu").is_file():
        fail(f"the port package is not beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))

    from lightgaussian_tpu_torch.cli import render_sets
    from lightgaussian_tpu_torch.data.ply import load_gaussian_ply, save_gaussian_ply
    from lightgaussian_tpu_torch.models.camera import Camera
    from lightgaussian_tpu_torch.ops.rasterize import binning, blend, default_max_instances, render, tiled
    from lightgaussian_tpu_torch.ops.rasterize.projection import preprocess
    from lightgaussian_tpu_torch.utils import image_io
    from lightgaussian_tpu_torch.utils.synthetic import default_camera, random_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    card = card_line()
    print(f"card: {card}", flush=True)

    def say(msg: str) -> None:
        """A line with numbers in it, with the card beside them."""
        print(f"{msg}  [{card}]", flush=True)

    # ---- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    lib = blend.build_library()
    blend._library()
    say(f"phase 1 ok: built {lib.name} in {time.perf_counter() - t0:.2f} s")
    print(lib.with_suffix(".log").read_text().strip())

    # kernel wrapper and the `exact` flag of its plain version
    kernels = {
        "blend_forward": (blend.blend_forward, True),
        "blend_forward_fast": (blend.blend_forward_fast, False),
    }

    def hold(name, b, grid, what):
        """Kernel vs plain version on the same inputs; returns (max err, outputs)."""
        kernel, exact_flag = kernels[name]
        got = kernel(b.tile_starts, b.inst, grid)
        sync()
        want = blend.plain_blend(b.tile_starts, b.inst, grid, exact=exact_flag)[:2]
        err = 0.0
        for g, w in zip(got, want):
            if not torch.isfinite(g).all():
                fail(f"{name} on {what}: non-finite output")
            err = max(err, float((g - w).abs().max()))
        say(f"  {name:20s} vs plain on {what}: max|d| = {err:.3e} (atol {KERNEL_TOL:.0e})")
        if err > KERNEL_TOL:
            fail(f"{name} disagrees with its plain version on {what}")
        return err, got

    # ---- phase 2: kernels vs plain versions at the parity sizes ---------------
    small_scenes = {
        "parity scene 192x128": (dict(n=2048, seed=1, extent=1.2, scale_range=(0.01, 0.06)), 192, 128),
        "saturating scene 96x64": (dict(n=800, seed=3, extent=1.5, scale_range=(0.15, 0.4)), 96, 64),
    }
    bg_small = torch.tensor([0.1, 0.2, 0.3], device=dev)
    blend.reset_launch_counts()
    for what, (kw, w, h) in small_scenes.items():
        scene = random_scene(device=dev, **kw)
        cam = default_camera(width=w, height=h, device=dev)
        grid = binning.make_grid(w, h)
        b = binning.bin_splats(preprocess(scene, cam), grid, 1 << 16)
        if b.total < 2000:
            fail(f"{what}: {b.total} instances is too few for multi-batch tiles")
        _, (rgb_e, t_e) = hold("blend_forward", b, grid, what)
        _, (rgb_f, t_f) = hold("blend_forward_fast", b, grid, what)
        img_e, _ = tiled._compose(rgb_e, t_e, bg_small, grid, w, h)
        img_f, _ = tiled._compose(rgb_f, t_f, bg_small, grid, w, h)
        d = float((img_f - img_e).abs().max())
        say(f"  fast vs exact image on {what}: max|d| = {d:.3e} (atol {FAST_VS_EXACT_TOL:.0e})")
        if d > FAST_VS_EXACT_TOL:
            fail(f"render-only kernel differs from the exact one on {what}")
    if min(blend.LAUNCHES.values()) < 1:
        fail(f"a kernel did not count its launches: {blend.LAUNCHES}")
    print("phase 2 ok")

    # ---- phase 3: the serving path at full width --------------------------------
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        t0 = time.perf_counter()
        scene = random_scene(n=300_000, seed=0, extent=2.0, scale_range=(0.004, 0.02), device=dev)
        model = tmp / "model"
        ply = model / "point_cloud" / "iteration_1" / "point_cloud.ply"
        save_gaussian_ply(scene, ply)
        src = tmp / "src"
        views = [0.2 + 2.0 * math.pi * i / N_VIEWS for i in range(N_VIEWS)]
        gray = np.full((HEIGHT, WIDTH, 3), 128, np.uint8)
        for split, ts in (("train", [0.2 + math.pi / N_VIEWS]), ("test", views)):
            frames = []
            for i, t in enumerate(ts):
                image_io.write_png(src / split / f"r_{i}.png", gray)
                frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": blender_c2w(orbit_eye(t))})
            (src / f"transforms_{split}.json").write_text(
                json.dumps({"camera_angle_x": 0.9, "frames": frames})
            )
        say(f"  wrote the 300k-Gaussian model and a {N_VIEWS}-view source in "
            f"{time.perf_counter() - t0:.2f} s")

        # path A: the render CLI (render-only kernel)
        blend.reset_launch_counts()
        t0 = time.perf_counter()
        render_sets.main(["-s", str(src), "-m", str(model), "--eval", "--skip_train",
                          "-r", "1", "--quiet"])
        sync()
        cli_s = time.perf_counter() - t0
        launches_cli = dict(blend.LAUNCHES)
        say(f"  render_sets CLI: {N_VIEWS} views in {cli_s:.2f} s incl. loading and PNG I/O; "
            f"launches {launches_cli}")
        if launches_cli["blend_forward_fast"] != N_VIEWS:
            fail(f"the CLI launched the render-only kernel {launches_cli['blend_forward_fast']} "
                 f"times for {N_VIEWS} views")
        renders = sorted((model / "test" / "ours_1" / "renders").glob("*.png"))
        if len(renders) != N_VIEWS:
            fail(f"expected {N_VIEWS} rendered PNGs, found {len(renders)}")
        for p in renders:
            arr = image_io.read_image(p)
            if arr.shape != (HEIGHT, WIDTH, 3) or arr.max() == 0 or arr.std() < 1.0:
                fail(f"{p.name} is blank or misshapen: {arr.shape}, max {arr.max()}, std {arr.std():.2f}")

        # path B: render()'s default, the exact kernel
        loaded = load_gaussian_ply(ply, device=dev)
        cams = [Camera.look_at(orbit_eye(t), [0, 0, 0], fovx=0.9, width=WIDTH, height=HEIGHT, device=dev)
                for t in views]
        bg = torch.zeros(3, device=dev)
        max_inst = default_max_instances(loaded)
        cap = binning.instance_capacity(max_inst)
        blend.reset_launch_counts()
        exact = [render(loaded, cam, bg) for cam in cams]
        sync()
        launches_exact = dict(blend.LAUNCHES)
        say(f"  exact render(): {N_VIEWS} views, launches {launches_exact}")
        if launches_exact["blend_forward"] != N_VIEWS:
            fail(f"render() launched the exact kernel {launches_exact['blend_forward']} times")
        for out in exact:
            if not torch.isfinite(out.render).all() or not 0 < out.num_instances <= cap:
                fail(f"bad exact render: {out.num_instances} instances, capacity {cap}")
        live = [out.num_instances for out in exact]
        say(f"  live instances per view: {live} (capacity {cap})")

        # the PNGs are the fast kernel's images: compare with the exact ones
        fast0 = render(loaded, cams[0], bg, fast=True).render
        d = float((fast0 - exact[0].render).abs().max())
        png0 = torch.from_numpy(image_io.read_image(renders[0]).astype(np.float32) / 255.0)
        d_png = float((png0.permute(2, 0, 1).to(dev) - exact[0].render.clamp(0, 1)).abs().max())
        say(f"  view 0: fast vs exact max|d| = {d:.3e}; PNG vs exact max|d| = {d_png:.3e}")
        if d > FAST_VS_EXACT_TOL or d_png > 1.0 / 255.0 + FAST_VS_EXACT_TOL:
            fail("the served images differ from the exact render")

        # timing of render(fast=True), split into its stages (PNG excluded)
        grid = binning.make_grid(WIDTH, HEIGHT)
        for cam in cams[:2]:
            render(loaded, cam, bg, fast=True)
        stages = {"preprocess": [], "binning": [], "kernel": [], "compose": [], "total": []}
        whole = []
        for cam in cams:
            sync()
            t0 = time.perf_counter()
            render(loaded, cam, bg, fast=True)
            sync()
            whole.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            splats = preprocess(loaded, cam)
            sync()
            t1 = time.perf_counter()
            b = binning.bin_splats(splats, grid, max_inst)
            sync()
            t2 = time.perf_counter()
            rgb, tt = blend.blend_forward_fast(b.tile_starts, b.inst, grid)
            sync()
            t3 = time.perf_counter()
            tiled._compose(rgb, tt, bg, grid, WIDTH, HEIGHT)
            sync()
            t4 = time.perf_counter()
            for k, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t4 - t0)):
                stages[k].append(v)
        ms = {k: 1e3 * statistics.median(v) for k, v in stages.items()}
        say(f"  render(fast=True) 1920x1080, 300k Gaussians SH 3: median "
            f"{1e3 * statistics.median(whole):.3f} ms/frame over {N_VIEWS} views")
        say("  split (synchronised stages, median ms): " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))

        # kernels vs plain versions at the main path's shapes, and their times
        b = binning.bin_splats(preprocess(loaded, cams[0]), grid, max_inst)
        rows = []
        for name, (kernel, exact_flag) in kernels.items():
            err, _ = hold(name, b, grid, "view 0 at 1920x1080")
            for _ in range(3):
                kernel(b.tile_starts, b.inst, grid)
            reps = 20
            start_ev = torch.cuda.Event(enable_timing=True)
            end_ev = torch.cuda.Event(enable_timing=True)
            start_ev.record()
            for _ in range(reps):
                kernel(b.tile_starts, b.inst, grid)
            end_ev.record()
            sync()
            k_ms = start_ev.elapsed_time(end_ev) / reps
            plain_times = []
            for _ in range(3):
                sync()
                t0 = time.perf_counter()
                _, _, work = blend.plain_blend(b.tile_starts, b.inst, grid, exact=exact_flag)
                sync()
                plain_times.append(time.perf_counter() - t0)
            plain_ms = 1e3 * statistics.median(plain_times)
            pairs = dict(zip(blend.WORK_KINDS, work.sum(dim=0).tolist()))
            f32_s = sum(n * F32_PER_PAIR[k] for k, n in pairs.items()) / F32_INSTR_RATE
            mufu_s = sum(n * MUFU_PER_PAIR[k] for k, n in pairs.items()) / MUFU_RATE
            ops_s = max(f32_s, mufu_s)  # separate pipes, which overlap
            n_bytes = b.inst.numel() * 4 + b.tile_starts.numel() * 4 + grid.num_tiles * 4 * blend.PIX * 4
            bytes_s = n_bytes / PEAK_BYTES
            bound_ms = 1e3 * max(ops_s, bytes_s)
            say(f"  {name}: {k_ms:.4f} ms/launch (CUDA events, {reps} launches), plain {plain_ms:.3f} ms, "
                f"bound {bound_ms:.4f} ms by {'operations' if ops_s >= bytes_s else 'bytes'} "
                f"(FP32 {1e3 * f32_s:.4f} ms, MUFU {1e3 * mufu_s:.4f} ms; pairs {pairs}, "
                f"{b.inst.shape[0]} instances); no single PyTorch call computes "
                f"a tile alpha blend, so library_ms is null")
            launches = launches_cli[name] if name == "blend_forward_fast" else launches_exact[name]
            rows.append({
                "name": name,
                "route": "cuda",
                "source": "lightgaussian_tpu_torch/csrc/blend_forward.cu",
                "replaces": "lightgaussian_tpu/ops/rasterize/pallas_blend.py:"
                            + ("166" if name == "blend_forward" else "241"),
                "launches": launches,
                "max_abs_err": err,
                "ms": k_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": "operations" if ops_s >= bytes_s else "bytes",
                "library_ms": None,
            })
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("phase 3 ok")

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
