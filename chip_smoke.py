#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`lightgaussian_tpu_torch`) on one GPU.

Usage: python3 chip_smoke.py        (from the repository root; needs one CUDA card)

Phases, each of which exits non-zero on failure:
  1. The card (nvidia-smi name and power limit) and the kernels' build: the
     three CUDA sources compiled at once, one nvcc each, with ptxas's
     registers, spills and shared memory for every kernel.
  2. Each kernel against its plain PyTorch version on the card:
     - the exact and render-only blends (B1, B6) on the 2048-Gaussian
       192x128 parity scene and on a scene whose tiles saturate (so the early
       exit runs): atol 2e-4, the JAX package's compiled-kernel tolerance
       (other exp and summation order); the render-only kernel against the
       exact one at 2e-3 (they differ on saturated pixels only);
     - the blend backward (B2) on the same scenes, per Gaussian: its
       difference from the plain version divided by the plain version's
       largest magnitude per feature, atol 1e-5 (its atomics add in a
       varying order); and, since most gradients are far below the largest,
       the median over the Gaussians with a gradient of the difference
       divided by the Gaussian's own plain gradient, per feature, 1e-3;
     - the SSIM blurs B3, B4 and B7 at (15,37,53), (3,64,96) and
       (9,1080,1920): atol 1e-5;
     - the SSIM value (atol 1e-6) and its gradient (1e-5 of its largest
       magnitude) on both paths, the kernels against the plain versions.
  3. The serving path at full width: a 300k-Gaussian SH-3 scene at
     1920x1080 saved as a PLY, a Blender-format source with 8 test cameras,
     and `lightgaussian_tpu_torch.cli.render_sets` writing their PNGs through
     the render-only kernel. Then the exact render path (`render()`'s
     default) over the same cameras. Launch counts are read around each path.
     The blend kernels are held against their plain versions at these shapes
     and timed, and so is the render, split at its stage marks.
  4. Training at full width: the same scene rendered exactly from the 8
     views is the ground truth; a copy with seeded noise on colour, opacity
     and position trains against it for 24 steps of `make_train_step` (the
     cached-target SSIM; instance capacity 983,040), cycling the views. The
     launch counts are read around the steps (B1, B2, B3 and B4 once a
     step) and around `make_eval_render` (B1 and B7 once a view), whose mean
     L1 over the 8 views must fall. Each step is timed whole and split at
     its stage marks (CUDA events recorded by the step itself, see
     `lightgaussian_tpu_torch/utils/stage_marks.py`), and each training
     kernel is held against its plain version and timed at the step's
     shapes.
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
# The kernels are built with --fmad=false, so each float32 add, multiply,
# compare or min of their source is one instruction. The FP32 pipes issue
# one instruction per lane and clock: half the flop rate. exp2 and the
# reciprocal run on the MUFU pipe at 16 results per SM and clock against 128
# for FP32 (CUDA C++ Programming Guide, arithmetic instruction throughput,
# compute capability 9.0). Compares and mins are counted at the FP32 add
# rate, the fastest they could go, so the bound stays a least time.
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
# The same for the backward, csrc/blend_backward.cu: up to the T test as
# the exact forward (stopping 24); an applied pair adds colour . g (5),
# w, cw w, r_i, cw T (4), the IEEE division r_i / (1 - alpha) (eight FP32
# around one MUFU.RCP), d_alpha, the clamp test, d_power, q1, q2 (5) and
# the nine sums (3 adds, 3 multiply-adds, 3 colour multiply-adds: 15).
F32_PER_PAIR_BWD = {"culled": 12, "faint": 21, "past_stop": 0, "stopping": 24, "applied": 61}
MUFU_PER_PAIR_BWD = {"culled": 0, "faint": 1, "past_stop": 0, "stopping": 1, "applied": 2}
# The blur: 11 multiplies and 10 adds per output element and pass.
F32_PER_BLUR_OUTPUT = 42

DEVICE = "cuda"
N_VIEWS = 8
WIDTH, HEIGHT = 1920, 1080
N_GAUSS = 300_000
TRAIN_STEPS = 24
STEP_WARMUP = 4
MAX_INSTANCES = 983_040  # bench.py's steady-state instance capacity
SMALL_SCENES = {
    "parity scene 192x128": (dict(n=2048, seed=1, extent=1.2, scale_range=(0.01, 0.06)), 192, 128),
    "saturating scene 96x64": (dict(n=800, seed=3, extent=1.5, scale_range=(0.15, 0.4)), 96, 64),
}
MIN_SMALL_INSTANCES = 2000
BLUR_SHAPES = ((15, 37, 53), (3, 64, 96), (9, 1080, 1920))
SSIM_SHAPE = (3, 128, 192)
KERNEL_TOL = 2e-4
B2_TOL = 1e-5  # normalised per feature; 4x the largest difference seen, a decade above atomics noise
# The median over Gaussians of |d| / |plain|, per feature. On the saturating
# scene, where d(alpha) subtracts nearly equal terms, two float32 versions
# differ there by up to 1.3e-4 (kernel vs plain; the plain version vs the JAX
# kernel 4.7e-5); an error of 0.1% on most Gaussians fails.
B2_MEDIAN_REL_TOL = 1e-3
FAST_VS_EXACT_TOL = 2e-3
BLUR_TOL = 1e-5
SSIM_VALUE_TOL = 1e-6
SSIM_GRAD_TOL = 1e-5
TIMING_REPS = 20
PLAIN_REPS = 3
MARK_SLACK_MS = 0.01  # a run's marked span may not exceed its synchronised host time
TRAIN_STAGES = ("preprocess", "binning", "B1", "compose", "loss forward", "loss backward", "B2 + reduce",
                "preprocess backward", "Adam", "densify statistics + metrics")
SERVE_STAGES = ("preprocess", "binning", "B6", "compose")


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


class Smoke:
    """State shared by the phases: the card, the device and the kernels' rows."""

    def __init__(self):
        import torch

        self.torch = torch
        self.dev = torch.device(DEVICE)
        self.card = card_line()
        self.rows = {}  # kernel name -> its entry of the kernels line
        print(f"card: {self.card}", flush=True)

    def say(self, msg: str) -> None:
        """A line with numbers in it, with the card beside them."""
        print(f"{msg}  [{self.card}]", flush=True)

    def sync(self) -> None:
        self.torch.cuda.synchronize()

    def event_ms(self, fn, reps: int = TIMING_REPS) -> float:
        """CUDA-event time per call of `fn` over `reps` back-to-back calls,
        after three warm-up calls."""
        torch = self.torch
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        self.sync()
        return start.elapsed_time(end) / reps

    def host_ms(self, fn, reps: int = PLAIN_REPS) -> float:
        """Median host time of `fn`, each call ending in a synchronise."""
        times = []
        for _ in range(reps):
            self.sync()
            t0 = time.perf_counter()
            fn()
            self.sync()
            times.append(time.perf_counter() - t0)
        return 1e3 * statistics.median(times)

    def row(self, name, source, replaces, err, ms, plain_ms, ops_s, bytes_s, library_ms):
        bound_ms = 1e3 * max(ops_s, bytes_s)
        self.rows[name] = {
            "name": name,
            "route": "cuda",
            "source": f"lightgaussian_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": None,  # filled from the path's run
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "library_ms": library_ms,
        }
        return bound_ms


def build_kernels(s: Smoke) -> None:
    from lightgaussian_tpu_torch.ops import losses
    from lightgaussian_tpu_torch.ops.rasterize import blend
    from lightgaussian_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    libs = cuda_build.build(blend.FORWARD_SOURCE, blend.BACKWARD_SOURCE, losses.SOURCE)
    blend._forward_library()
    blend._backward_library()
    losses._library()
    s.say(f"phase 1 ok: built {', '.join(p.name for p in libs)} in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        print(f"-- {lib.with_suffix('.log').name}")
        print(lib.with_suffix(".log").read_text().strip())


def reset_counts() -> None:
    from lightgaussian_tpu_torch.ops import losses
    from lightgaussian_tpu_torch.ops.rasterize import blend

    blend.reset_launch_counts()
    losses.reset_launch_counts()


def read_counts() -> dict:
    from lightgaussian_tpu_torch.ops import losses
    from lightgaussian_tpu_torch.ops.rasterize import blend

    return {**blend.LAUNCHES, **losses.LAUNCHES}


def backward_seed(s: Smoke, image, final_t, grid, seed: int):
    """Random image and final_T cotangents as the backward's tile inputs."""
    from lightgaussian_tpu_torch.ops.rasterize import tiled

    torch = s.torch
    gen = torch.Generator(device=s.dev).manual_seed(seed)
    g = torch.randn(image.shape, generator=gen, device=s.dev)
    g_t = torch.randn(final_t.shape, generator=gen, device=s.dev)
    r = (image * g).sum(dim=0) + final_t * g_t
    return tiled._tile_image(g, grid), tiled._tile_image(r[None].contiguous(), grid)


def hold_backward(s: Smoke, b, grid, n, tile_g, tile_r, what):
    """B2 against its plain version, per Gaussian; returns (normalised
    error, absolute error, work)."""
    from lightgaussian_tpu_torch.ops.rasterize import blend

    torch = s.torch
    got = blend.blend_backward(b.tile_starts, b.inst, b.gid_sorted, tile_g, tile_r, grid, n)
    s.sync()
    per_inst, work = blend.plain_blend_backward(b.tile_starts, b.inst, tile_g, tile_r, grid)
    want = blend.reduce_per_gaussian(per_inst, b.gid_sorted, n)
    if not torch.isfinite(got).all():
        fail(f"blend_backward on {what}: non-finite output")
    scale = want.abs().amax(dim=0).clamp(min=1e-12)
    diff = (got - want).abs()
    err = float((diff / scale).max())
    err_abs = float(diff.max())
    # a typical gradient lies far below the largest: hold each Gaussian to its own
    typical, rel = [], []
    for f in range(want.shape[1]):
        nz = want[:, f] != 0
        typical.append(float((want[nz, f].abs() / scale[f]).median()))
        rel.append(float((diff[nz, f] / want[nz, f].abs()).median()))
    unseen = torch.ones(n, dtype=torch.bool, device=s.dev)
    unseen[b.gid_sorted] = False
    s.say(f"  {'blend_backward':20s} vs plain on {what}: max|d|/max|plain| = {err:.3e} "
          f"(atol {B2_TOL:.0e}), max|d| = {err_abs:.3e}; per feature over the Gaussians with a "
          f"gradient, median |plain|/max|plain| [{', '.join(f'{v:.2e}' for v in typical)}] and median "
          f"|d|/|plain| [{', '.join(f'{v:.2e}' for v in rel)}] (atol {B2_MEDIAN_REL_TOL:.0e}); "
          f"{int(unseen.sum())} Gaussians in no tile")
    if err > B2_TOL or max(rel) > B2_MEDIAN_REL_TOL:
        fail(f"blend_backward disagrees with its plain version on {what}")
    if unseen.any() and got[unseen].abs().max() > 0:
        fail(f"blend_backward gave a gradient to a Gaussian in no tile on {what}")
    return err, err_abs, work


def phase2(s: Smoke) -> dict:
    """Kernels against their plain versions at the parity sizes."""
    from lightgaussian_tpu_torch.ops import losses
    from lightgaussian_tpu_torch.ops.rasterize import binning, blend, tiled
    from lightgaussian_tpu_torch.ops.rasterize.projection import preprocess
    from lightgaussian_tpu_torch.utils.synthetic import default_camera, random_scene

    torch = s.torch
    kernels = {
        "blend_forward": (blend.blend_forward, True),
        "blend_forward_fast": (blend.blend_forward_fast, False),
    }
    errors = {}

    def hold(name, b, grid, what):
        kernel, exact_flag = kernels[name]
        got = kernel(b.tile_starts, b.inst, grid)
        s.sync()
        want = blend.plain_blend(b.tile_starts, b.inst, grid, exact=exact_flag)[:2]
        err = 0.0
        for g, w in zip(got, want):
            if not torch.isfinite(g).all():
                fail(f"{name} on {what}: non-finite output")
            err = max(err, float((g - w).abs().max()))
        s.say(f"  {name:20s} vs plain on {what}: max|d| = {err:.3e} (atol {KERNEL_TOL:.0e})")
        if err > KERNEL_TOL:
            fail(f"{name} disagrees with its plain version on {what}")
        return err, got

    bg_small = torch.tensor([0.1, 0.2, 0.3], device=s.dev)
    reset_counts()
    for i, (what, (kw, w, h)) in enumerate(SMALL_SCENES.items()):
        scene = random_scene(device=s.dev, **kw)
        cam = default_camera(width=w, height=h, device=s.dev)
        grid = binning.make_grid(w, h)
        b = binning.bin_splats(preprocess(scene, cam), grid, 1 << 16)
        if b.total < MIN_SMALL_INSTANCES:
            fail(f"{what}: {b.total} instances is too few for multi-chunk tiles")
        _, (rgb_e, t_e) = hold("blend_forward", b, grid, what)
        _, (rgb_f, t_f) = hold("blend_forward_fast", b, grid, what)
        img_e, fin_e = tiled._compose(rgb_e, t_e, bg_small, grid, w, h)
        img_f, _ = tiled._compose(rgb_f, t_f, bg_small, grid, w, h)
        d = float((img_f - img_e).abs().max())
        s.say(f"  fast vs exact image on {what}: max|d| = {d:.3e} (atol {FAST_VS_EXACT_TOL:.0e})")
        if d > FAST_VS_EXACT_TOL:
            fail(f"render-only kernel differs from the exact one on {what}")
        tile_g, tile_r = backward_seed(s, img_e, fin_e, grid, seed=i)
        hold_backward(s, b, grid, scene.capacity, tile_g, tile_r, what)
    counts = read_counts()
    if min(counts[k] for k in ("blend_forward", "blend_forward_fast", "blend_backward")) < 1:
        fail(f"a blend kernel did not count its launches: {counts}")

    gen = torch.Generator(device=s.dev).manual_seed(7)
    for shape in BLUR_SHAPES:
        x = torch.rand(shape, generator=gen, device=s.dev)
        y = torch.rand(shape, generator=gen, device=s.dev)
        for name, kernel, plain in (
            ("blur", lambda: losses.blur(x), lambda: losses.plain_blur(x)),
            ("blur3", lambda: losses.blur3(x, y), lambda: losses.plain_blur3(x, y)),
            ("blur5", lambda: losses.blur5(x, y), lambda: losses.plain_blur5(x, y)),
        ):
            got = kernel()
            s.sync()
            want = plain()
            if got.shape != want.shape or not torch.isfinite(got).all():
                fail(f"{name} at {shape}: shape {tuple(got.shape)} or non-finite output")
            err = float((got - want).abs().max())
            errors[name] = err  # at the largest shape, the last
            s.say(f"  {name:20s} vs plain at {shape}: max|d| = {err:.3e} (atol {BLUR_TOL:.0e})")
            if err > BLUR_TOL:
                fail(f"{name} disagrees with its plain version at {shape}")
    counts = read_counts()
    if min(counts[k] for k in ("blur", "blur3", "blur5")) < 1:
        fail(f"a blur kernel did not count its launches: {counts}")

    x = torch.rand(SSIM_SHAPE, generator=gen, device=s.dev)
    y = (x + 0.1 * torch.randn(SSIM_SHAPE, generator=gen, device=s.dev)).clamp(0, 1)
    for cached in (False, True):
        values, grads = [], []
        for dev in (s.dev, torch.device("cpu")):  # the kernels, then the plain versions
            xd = x.to(dev).requires_grad_(True)
            yd = y.to(dev).requires_grad_(not cached)
            stats = losses.precompute_ssim_target_stats(yd.detach()) if cached else None
            v = losses.ssim(xd, yd, target_stats=stats)
            ins = [xd] if cached else [xd, yd]
            grads.append([g.cpu() for g in torch.autograd.grad(v, ins)])
            values.append(float(v.detach()))
        dv = abs(values[0] - values[1])
        dg = max(float(((a - b).abs() / b.abs().max()).max()) for a, b in zip(*grads))
        what = "cached-target" if cached else "five-moment"
        s.say(f"  ssim ({what}) kernels vs plain: value {values[0]:.7f}, |d| = {dv:.2e} "
              f"(atol {SSIM_VALUE_TOL:.0e}); gradient max|d|/max|plain| = {dg:.2e} (atol {SSIM_GRAD_TOL:.0e})")
        if dv > SSIM_VALUE_TOL or dg > SSIM_GRAD_TOL:
            fail(f"the {what} SSIM on the kernels disagrees with the plain versions")
    print("phase 2 ok", flush=True)
    return errors


def time_blend_kernels(s: Smoke, b, grid) -> None:
    """B1 and B6 at the serving scene's view 0: error, time and bound."""
    from lightgaussian_tpu_torch.ops.rasterize import blend

    torch = s.torch
    for name, kernel, exact in (("blend_forward", blend.blend_forward, True),
                                ("blend_forward_fast", blend.blend_forward_fast, False)):
        got = kernel(b.tile_starts, b.inst, grid)
        s.sync()
        rgb, t, work = blend.plain_blend(b.tile_starts, b.inst, grid, exact=exact)
        err = max(float((got[0] - rgb).abs().max()), float((got[1] - t).abs().max()))
        if not all(torch.isfinite(g).all() for g in got) or err > KERNEL_TOL:
            fail(f"{name} disagrees with its plain version at 1920x1080 (max|d| {err:.3e})")
        k_ms = s.event_ms(lambda: kernel(b.tile_starts, b.inst, grid))
        plain_ms = s.host_ms(lambda: blend.plain_blend(b.tile_starts, b.inst, grid, exact=exact))
        pairs = dict(zip(blend.WORK_KINDS, work.sum(dim=0).tolist()))
        f32_s = sum(n * F32_PER_PAIR[k] for k, n in pairs.items()) / F32_INSTR_RATE
        mufu_s = sum(n * MUFU_PER_PAIR[k] for k, n in pairs.items()) / MUFU_RATE
        n_bytes = b.inst.numel() * 4 + b.tile_starts.numel() * 4 + grid.num_tiles * 4 * blend.PIX * 4
        bound_ms = s.row(name, "blend_forward.cu",
                         "lightgaussian_tpu/ops/rasterize/pallas_blend.py:" + ("166" if exact else "241"),
                         err, k_ms, plain_ms, max(f32_s, mufu_s), n_bytes / PEAK_BYTES, None)
        s.say(f"  {name}: max|d| {err:.3e}; {k_ms:.4f} ms/launch (CUDA events, {TIMING_REPS} launches), "
              f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms (FP32 {1e3 * f32_s:.4f} ms, MUFU "
              f"{1e3 * mufu_s:.4f} ms; pairs {pairs}, {b.inst.shape[0]} instances); no single PyTorch "
              f"call computes a tile alpha blend, so library_ms is null")


def phase3(s: Smoke, tmp: Path) -> dict:
    """The serving path at full width; returns the CLI's launch counts."""
    from lightgaussian_tpu_torch.cli import render_sets
    from lightgaussian_tpu_torch.data.ply import load_gaussian_ply, save_gaussian_ply
    from lightgaussian_tpu_torch.models.camera import Camera
    from lightgaussian_tpu_torch.ops.rasterize import binning, default_max_instances, render
    from lightgaussian_tpu_torch.ops.rasterize.projection import preprocess
    from lightgaussian_tpu_torch.utils import image_io, stage_marks
    from lightgaussian_tpu_torch.utils.synthetic import random_scene

    torch = s.torch
    dev = s.dev
    t0 = time.perf_counter()
    scene = random_scene(n=N_GAUSS, seed=0, extent=2.0, scale_range=(0.004, 0.02), device=dev)
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
    s.say(f"  wrote the 300k-Gaussian model and a {N_VIEWS}-view source in "
          f"{time.perf_counter() - t0:.2f} s")

    # path A: the render CLI (render-only kernel)
    reset_counts()
    t0 = time.perf_counter()
    render_sets.main(["-s", str(src), "-m", str(model), "--eval", "--skip_train",
                      "-r", "1", "--quiet", "--device", DEVICE])
    s.sync()
    cli_s = time.perf_counter() - t0
    launches_cli = read_counts()
    s.say(f"  render_sets CLI: {N_VIEWS} views in {cli_s:.2f} s incl. loading and PNG I/O; "
          f"launches {launches_cli}")
    if launches_cli["blend_forward_fast"] != N_VIEWS or sum(launches_cli.values()) != N_VIEWS:
        fail(f"the CLI made launches {launches_cli} for {N_VIEWS} views")
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
    reset_counts()
    exact = [render(loaded, cam, bg) for cam in cams]
    s.sync()
    launches_exact = read_counts()
    s.say(f"  exact render(): {N_VIEWS} views, launches {launches_exact}")
    if launches_exact["blend_forward"] != N_VIEWS or sum(launches_exact.values()) != N_VIEWS:
        fail(f"render() made launches {launches_exact} for {N_VIEWS} views")
    for out in exact:
        if not torch.isfinite(out.render).all() or not 0 < out.num_instances <= cap:
            fail(f"bad exact render: {out.num_instances} instances, capacity {cap}")
    s.say(f"  live instances per view: {[out.num_instances for out in exact]} (capacity {cap})")

    # the PNGs are the fast kernel's images: compare with the exact ones
    fast0 = render(loaded, cams[0], bg, fast=True).render
    d = float((fast0 - exact[0].render).abs().max())
    png0 = torch.from_numpy(image_io.read_image(renders[0]).astype(np.float32) / 255.0)
    d_png = float((png0.permute(2, 0, 1).to(dev) - exact[0].render.clamp(0, 1)).abs().max())
    s.say(f"  view 0: fast vs exact max|d| = {d:.3e}; PNG vs exact max|d| = {d_png:.3e}")
    if d > FAST_VS_EXACT_TOL or d_png > 1.0 / 255.0 + FAST_VS_EXACT_TOL:
        fail("the served images differ from the exact render")

    # timing of render(fast=True), split at its stage marks (PNG excluded)
    grid = binning.make_grid(WIDTH, HEIGHT)
    for cam in cams[:2]:
        render(loaded, cam, bg, fast=True)
    whole, runs = [], []
    for cam in cams:
        s.sync()
        t0 = time.perf_counter()
        stage_marks.start()
        render(loaded, cam, bg, fast=True)
        s.sync()
        whole.append(1e3 * (time.perf_counter() - t0))
        runs.append(stage_marks.stop())
    s.say(f"  render(fast=True) 1920x1080, 300k Gaussians SH 3: median "
          f"{statistics.median(whole):.3f} ms/frame over {N_VIEWS} views")
    stage_split(s, runs, SERVE_STAGES, whole, "render(fast=True)")
    time_blend_kernels(s, binning.bin_splats(preprocess(loaded, cams[0]), grid, max_inst), grid)
    print("phase 3 ok", flush=True)
    return launches_cli


def stage_split(s: Smoke, runs, names, walls_ms, what) -> dict:
    """Median time of each stage over `runs`, each a list of (stage, ms) from
    `stage_marks.stop()`. Fails if a run's marks are not `names` in order, or
    if they span more than the run's own synchronised host time."""
    for marks, wall in zip(runs, walls_ms):
        got = [name for name, _ in marks]
        if got != list(names):
            fail(f"{what}: stage marks {got}, expected {list(names)}")
        span = sum(ms for _, ms in marks)
        if span > wall + MARK_SLACK_MS:
            fail(f"{what}: the marks span {span:.3f} ms, more than the run's {wall:.3f} ms")
    split = {name: statistics.median(marks[i][1] for marks in runs) for i, name in enumerate(names)}
    span = statistics.median(sum(ms for _, ms in marks) for marks in runs)
    s.say(f"  {what} split at its stage marks (CUDA events on the path itself, median ms over "
          f"{len(runs)} runs): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f"; marked span {span:.3f} of a synchronised host time of {statistics.median(walls_ms):.3f}")
    return split


def time_training_kernels(s: Smoke, state, cam, bg, errors: dict) -> None:
    """B2, B3, B4 and B7 at the step's shapes (view 0): error, time, bound,
    plain time and, for B4, the library call."""
    from lightgaussian_tpu_torch.config import OptimizationParams
    from lightgaussian_tpu_torch.ops import losses
    from lightgaussian_tpu_torch.ops.rasterize import binning, blend, tiled
    from lightgaussian_tpu_torch.ops.rasterize.projection import preprocess

    torch = s.torch
    grid = binning.make_grid(WIDTH, HEIGHT)
    scene = state.scene
    n = scene.capacity
    with torch.no_grad():
        b = binning.bin_splats(preprocess(scene, cam), grid, MAX_INSTANCES)
        rgb, t = blend.blend_forward(b.tile_starts, b.inst, grid)
        image, final_t = tiled._compose(rgb, t, bg, grid, WIDTH, HEIGHT)
    x = image.clone().requires_grad_(True)
    lam = OptimizationParams().lambda_dssim
    loss = (1.0 - lam) * losses.l1_loss(x, cam.gt_image) + lam * (
        1.0 - losses.ssim(x, cam.gt_image, target_stats=cam.gt_ssim_stats))
    (g_image,) = torch.autograd.grad(loss, [x])
    r = (image * g_image).sum(dim=0)
    tile_g, tile_r = tiled._tile_image(g_image, grid), tiled._tile_image(r[None].contiguous(), grid)
    err, err_abs, work = hold_backward(s, b, grid, n, tile_g, tile_r, "the step's view 0 at 1920x1080")
    k_ms = s.event_ms(lambda: blend.blend_backward(b.tile_starts, b.inst, b.gid_sorted, tile_g, tile_r, grid, n))
    plain_ms = s.host_ms(lambda: blend.reduce_per_gaussian(
        blend.plain_blend_backward(b.tile_starts, b.inst, tile_g, tile_r, grid)[0], b.gid_sorted, n))
    pairs = dict(zip(blend.WORK_KINDS, work.sum(dim=0).tolist()))
    f32_s = sum(c * F32_PER_PAIR_BWD[k] for k, c in pairs.items()) / F32_INSTR_RATE
    mufu_s = sum(c * MUFU_PER_PAIR_BWD[k] for k, c in pairs.items()) / MUFU_RATE
    n_bytes = (b.inst.numel() * 4 + b.gid_sorted.numel() * 8 + b.tile_starts.numel() * 4
               + (tile_g.numel() + tile_r.numel()) * 4 + n * blend.FEAT_WIDTH * 4)
    bound = s.row("blend_backward", "blend_backward.cu", "lightgaussian_tpu/ops/rasterize/pallas_blend.py:457",
                  err_abs, k_ms, plain_ms, max(f32_s, mufu_s), n_bytes / PEAK_BYTES, None)
    s.rows["blend_backward"]["max_err_normalised"] = err  # the number held against B2_TOL
    s.say(f"  blend_backward: {k_ms:.4f} ms/launch (CUDA events, {TIMING_REPS} launches, incl. zeroing the "
          f"[{n}, 9] output), plain {plain_ms:.3f} ms (plain walk + index_add_), bound {bound:.4f} ms "
          f"(FP32 {1e3 * f32_s:.4f} ms, MUFU {1e3 * mufu_s:.4f} ms, bytes {1e3 * n_bytes / PEAK_BYTES:.4f} ms; "
          f"pairs {pairs}, {b.inst.shape[0]} instances); no single PyTorch call computes it, library_ms null")

    img = image.detach().contiguous()
    gt = cam.gt_image.contiguous()
    plane = HEIGHT * WIDTH * 4  # bytes of one float32 image plane
    g9 = torch.randn((9, HEIGHT, WIDTH), device=s.dev, generator=torch.Generator(device=s.dev).manual_seed(3))
    taps = torch.tensor(losses.TAPS, device=s.dev)
    window = (taps[:, None] * taps[None, :]).expand(9, 1, losses.WINDOW, losses.WINDOW).contiguous()
    conv = torch.nn.functional.conv2d
    # name, TPU source line, kernel, plain version, planes read, planes written, library call
    specs = (
        ("blur3", "losses.py:194", lambda: losses.blur3(img, gt), lambda: losses.plain_blur3(img, gt),
         6, 9, None, "no single PyTorch call forms and blurs the moment planes, library_ms null"),
        ("blur", "losses.py:82", lambda: losses.blur(g9), lambda: losses.plain_blur(g9),
         9, 9, lambda: conv(g9[None], window, padding=5, groups=9),
         "library: F.conv2d(x[None], 11x11 window, padding=5, groups=9), TF32 off"),
        ("blur5", "losses.py:134", lambda: losses.blur5(img, gt), lambda: losses.plain_blur5(img, gt),
         6, 15, None, "no single PyTorch call forms and blurs the moment planes, library_ms null"),
    )
    for name, line, kernel, plain, planes_in, planes_out, library, note in specs:
        got = kernel()
        s.sync()
        err = float((got - plain()).abs().max())
        if err > BLUR_TOL:
            fail(f"{name} disagrees with its plain version at the step's shape ({err:.3e})")
        k_ms = s.event_ms(kernel)
        plain_ms = s.host_ms(plain)
        lib_ms = None
        if library is not None:
            d_lib = float((library()[0] - got).abs().max())
            lib_ms = s.event_ms(library)
            note += f", its max|d| from the kernel {d_lib:.2e}"
        n_bytes = (planes_in + planes_out) * plane
        ops_s = planes_out * HEIGHT * WIDTH * F32_PER_BLUR_OUTPUT / F32_INSTR_RATE
        bytes_s = n_bytes / PEAK_BYTES
        bound = s.row(name, "ssim_blur.cu", f"lightgaussian_tpu/ops/{line}", max(err, errors.get(name, 0.0)),
                      k_ms, plain_ms, ops_s, bytes_s, lib_ms)
        s.say(f"  {name} [{planes_in} planes in, {planes_out} out]: max|d| {err:.3e}; {k_ms:.4f} ms/launch "
              f"(CUDA events), plain {plain_ms:.3f} ms, bound {bound:.4f} ms ({n_bytes / 1e6:.1f} MB; "
              f"operations {1e3 * ops_s:.4f} ms), library "
              f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'}; {note}")


def phase4(s: Smoke, blur_errors: dict) -> dict:
    """Training at full width; returns the launch counts of each path."""
    from lightgaussian_tpu_torch.config import OptimizationParams
    from lightgaussian_tpu_torch.models.camera import Camera
    from lightgaussian_tpu_torch.ops import losses
    from lightgaussian_tpu_torch.ops.rasterize import render
    from lightgaussian_tpu_torch.train.state import init_train_state
    from lightgaussian_tpu_torch.train.step import make_eval_render, make_train_step
    from lightgaussian_tpu_torch.utils import stage_marks
    from lightgaussian_tpu_torch.utils.synthetic import random_scene

    torch = s.torch
    dev = s.dev
    t0 = time.perf_counter()
    truth = random_scene(n=N_GAUSS, seed=0, extent=2.0, scale_range=(0.004, 0.02), active_sh_degree=3,
                         device=dev)
    views = [0.2 + 2.0 * math.pi * i / N_VIEWS for i in range(N_VIEWS)]
    bg = torch.zeros(3, device=dev)
    cams = []
    for t in views:
        cam = Camera.look_at(orbit_eye(t), [0, 0, 0], fovx=0.9, width=WIDTH, height=HEIGHT, device=dev)
        with torch.no_grad():
            gt = render(truth, cam, bg, max_instances=MAX_INSTANCES).render.clamp(0.0, 1.0)
        cams.append(cam.with_gt(gt))
    rng = np.random.default_rng(1)
    noisy = {}
    for k, sd in (("sh_dc", 0.3), ("opacity_logits", 0.5), ("means", 0.01)):
        v = getattr(truth, k)
        noisy[k] = v + torch.from_numpy(rng.normal(0.0, sd, tuple(v.shape)).astype(np.float32)).to(dev)
    scene = truth.with_params({**truth.params(), **noisy})
    cams = [c.with_gt_ssim_stats(losses.precompute_ssim_target_stats(c.gt_image)) for c in cams]
    s.sync()
    s.say(f"  ground truth of {N_VIEWS} views and their SSIM moments in {time.perf_counter() - t0:.2f} s")

    eval_render = make_eval_render(MAX_INSTANCES)

    def mean_eval_l1(sc):
        reset_counts()
        l1 = statistics.fmean(float(eval_render(sc, c, bg)[1]) for c in cams)
        s.sync()
        counts = read_counts()
        if counts["blend_forward"] != N_VIEWS or counts["blur5"] != N_VIEWS or sum(counts.values()) != 2 * N_VIEWS:
            fail(f"make_eval_render made launches {counts} for {N_VIEWS} views")
        return l1, counts

    l1_before, eval_counts = mean_eval_l1(scene)
    s.say(f"  eval render before training: mean L1 {l1_before:.6f} over {N_VIEWS} views; launches {eval_counts}")

    opt_cfg = OptimizationParams()
    state = init_train_state(scene)
    step = make_train_step(opt_cfg, spatial_lr_scale=2.0, max_instances=MAX_INSTANCES)
    step_ms, step_loss, step_marks = [], [], []
    reset_counts()
    for i in range(TRAIN_STEPS):
        s.sync()
        t0 = time.perf_counter()
        stage_marks.start()
        state, m = step(state, cams[i % N_VIEWS], bg)
        s.sync()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        step_marks.append(stage_marks.stop())
        step_loss.append(float(m.loss))
    train_counts = read_counts()
    s.say(f"  {TRAIN_STEPS} training steps: launches {train_counts}")
    per_step = ("blend_forward", "blend_backward", "blur3", "blur")
    if any(train_counts[k] != TRAIN_STEPS for k in per_step) or sum(train_counts.values()) != 4 * TRAIN_STEPS:
        fail(f"the training steps made launches {train_counts}, not one each of {per_step} a step")
    s.say(f"  loss per step: {', '.join(f'{v:.5f}' for v in step_loss)}")
    if not all(math.isfinite(v) for v in step_loss):
        fail("a training loss is not finite")
    for k, v in state.scene.params().items():
        if not torch.isfinite(v).all() or not torch.isfinite(state.opt.nu[k]).all():
            fail(f"{k} or its Adam moment is not finite after training")
    seen = state.denom > 0
    accum_on_seen = float((state.xyz_grad_accum[seen] > 0).float().mean())
    s.say(f"  densify statistics: {int(seen.sum())} Gaussians visible at least once, "
          f"{100 * accum_on_seen:.1f}% of them with a non-zero gradient sum; max denom "
          f"{float(state.denom.max()):.0f}, max radius {float(state.max_radii2d.max()):.0f} px")
    if not seen.any() or accum_on_seen < 0.5 or (state.max_radii2d[seen] <= 0).any():
        fail("the densification statistics are empty on visible Gaussians")
    if (state.xyz_grad_accum[~seen] != 0).any() or (state.max_radii2d[~seen] != 0).any():
        fail("the densification statistics moved on Gaussians no camera saw")
    l1_after, _ = mean_eval_l1(state.scene)
    s.say(f"  eval render after training: mean L1 {l1_after:.6f} (before {l1_before:.6f})")
    if not l1_after < l1_before:
        fail("training did not lower the eval L1")

    # what the marks cost: steps with the marks off and on in turn, two on each view
    cost = {False: [], True: []}
    for i in range(2 * N_VIEWS):
        marked = i % 2 == 1
        s.sync()
        t0 = time.perf_counter()
        if marked:
            stage_marks.start()
        state, _ = step(state, cams[i // 2], bg)
        s.sync()
        cost[marked].append(1e3 * (time.perf_counter() - t0))
        if marked:
            stage_marks.stop()
    s.say(f"  stage marks' cost: median step {statistics.median(cost[False]):.3f} ms with the marks off, "
          f"{statistics.median(cost[True]):.3f} ms on ({N_VIEWS} steps each, in turn on the same views)")

    med = statistics.median(step_ms[STEP_WARMUP:])
    s.say(f"  train step 1920x1080, 300k Gaussians SH 3: median {med:.3f} ms over steps "
          f"{STEP_WARMUP + 1}-{TRAIN_STEPS} (min {min(step_ms[STEP_WARMUP:]):.3f}, "
          f"max {max(step_ms[STEP_WARMUP:]):.3f}; first {step_ms[0]:.3f})")
    stage_split(s, step_marks[STEP_WARMUP:], TRAIN_STAGES, step_ms[STEP_WARMUP:], "train step")
    time_training_kernels(s, state, cams[0], bg, blur_errors)
    print("phase 4 ok", flush=True)
    return {"train": train_counts, "eval": eval_counts}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    if not (REPO / "lightgaussian_tpu_torch" / "csrc" / "blend_forward.cu").is_file():
        fail(f"the port package is not beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s = Smoke()
    build_kernels(s)
    blur_errors = phase2(s)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        cli_counts = phase3(s, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = phase4(s, blur_errors)
    # launches on each kernel's path: the CLI (B6), the training steps (B1-B4), the eval render (B7)
    for name, row in s.rows.items():
        row["launches"] = (cli_counts if name == "blend_forward_fast"
                           else counts["eval"] if name == "blur5" else counts["train"])[name]
    order = ("blend_forward", "blend_forward_fast", "blend_backward", "blur3", "blur", "blur5")
    print(json.dumps({"kernels": [s.rows[k] for k in order]}))
    print(s.card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
