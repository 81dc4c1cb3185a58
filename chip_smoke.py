#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`lightgaussian_tpu_torch`) on one GPU.

Usage: python3 chip_smoke.py        (from the repository root; needs one CUDA card)

Phases, each of which exits non-zero on failure:
  1. The card (nvidia-smi name and power limit) and the kernels' build: the
     five CUDA sources compiled at once, one nvcc each, with ptxas's
     registers, spills and shared memory for every kernel (the forward,
     counting and backward blends, their tile-ordering kernel included).
  2. Each kernel against its plain PyTorch version on the card:
     - the exact and render-only blends (B1, B6) on the 2048-Gaussian
       192x128 parity scene and on a scene whose tiles saturate (so the early
       exit runs): atol 2e-4, the JAX package's compiled-kernel tolerance
       (other exp and summation order); the render-only kernel against the
       exact one at 2e-3 (they differ on saturated pixels only);
     - B1, B6 and B2 again on a scene made to stress their cull (every
       Gaussian in every tile's range: sub-pixel Gaussians, Gaussians larger
       than a tile, opacities on both sides of 1/255, needles, means outside
       the image), at the same tolerances, with `blend.cull_census` of it;
       and B1 and B6 once more on that binning with a fifth of its
       Gaussians culled (radius 0) and their rows zeroed by
       `binning.rebind_features`, as a cached trajectory binning holds them;
     - the device's cull itself (`blend.instance_cull`: the cells each
       instance may reach in its tile, and the level under which a pair is
       spared its exp) against its plain twins on those scenes: no cell the
       plain rectangle keeps may be missing, and the levels agree to 1e-4;
     - the blend backward (B2) on the same scenes, per Gaussian: its
       difference from the plain version divided by the plain version's
       largest magnitude per feature, atol 1e-5 (its atomics add in a
       varying order); and, since most gradients are far below the largest,
       the median over the Gaussians with a gradient of the difference
       divided by the Gaussian's own plain gradient, per feature, 1e-3;
     - the SSIM blurs B3, B4 and B7 at the shapes of BLUR_SHAPES: the
       step's and the eval view's (3,1080,1920), the step's backward
       (9,1080,1920), the set-up's (6,1080,1920) and the distillation
       step's backward (15,1080,1920), and small ones at the
       edges of the kernel's strips and runs (heights 1, 7, 15, 17; widths
       1, 7, 127, 129, 260; the kernel takes float4 rows where the width is
       a multiple of 4 and the pointers are aligned, single floats
       elsewhere), and once on the single-float path at a width that is a
       multiple of 4, with an input one float past an aligned address: each
       bit for bit;
     - the SSIM value (atol 1e-6) and its gradient (1e-5 of its largest
       magnitude) on both paths, the kernels against the plain versions;
     - the counting blend (B5) on the same two scenes and the cull-stress
       one: image and T at 2e-4 and bit for bit equal to the exact blend's
       (B1's) on the same binning, importance at 1e-4 (the JAX suite's
       tolerance) + 1e-6 relative, hit counts equal; and
       `count_render(method="tiled")` against `method="reference"` likewise;
     - the chunk transpose (B8) against `permute` bit for bit at (5, 16,
       128), (3, 40, 128) and (7680, 16, 128);
     - the issue-rate probe's seven chains (P) against the same recurrences
       in elementwise torch: the float chains bit for bit, the approximate
       units, the shuffle sum and the scan at 1e-5.
  3. The serving path at full width: a 300k-Gaussian SH-3 scene at
     1920x1080 saved as a PLY, a Blender-format source with 8 test cameras,
     and `lightgaussian_tpu_torch.cli.render_sets` writing their PNGs through
     the render-only kernel. Then the exact render path (`render()`'s
     default) over the same cameras. Launch counts are read around each path.
     The blend kernels, the counting blend included, are held against their
     plain versions at these shapes and timed (B5's image and T bit-equal to
     B1's here too), and so is the render, split at its stage marks; the
     device's cull is held against its plain twins at this size too. At this size a pair that sits on a threshold may
     flip between nvcc's expf and torch's exp, so the counting blend's hit
     counts are held by the sum of |difference| over the sum of counts
     (COUNT_RATIO_TOL), with the number of Gaussians that differ printed.
     The chunk transpose is timed beside `permute(0, 2, 1).contiguous()`,
     and the probe's rates are printed beside the two constants the bounds
     assume.
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
     shapes; B4 also at the set-up's six planes.
  5. The CLI trainer at full width: a Blender-format source at 1920x1080
     whose 8 train and 8 test views are exact renders of the serving scene,
     and a `points3d.ply` of its 300,000 means with seeded noise. Then
     `lightgaussian_tpu_torch.cli.train_densify_prune` through its flags:
     100 iterations from the point cloud, densify at 25, 50 and 75, an
     opacity reset at 60, a GSS prune of 30% at 90, reports at 1 and 100,
     save and checkpoint at 100 with the `imp_score.npz` export; a second
     call that resumes from the checkpoint to 110; and `render_sets` over
     what was saved. Launch counts are read around the first call: B1 the
     iterations plus one per evaluated view, B2 and B3 the iterations, B4
     the iterations plus one per train camera, B5 8 x (1 prune + 1 export),
     B7 one per evaluated view. The artifacts, the prune's share, the
     falling test L1 and the resumed state are checked; the trainer's wall
     time, its iterations per second and the cost of its parts are printed.
  6. The GSS, distillation and trajectory CLIs at full width on phase 5's
     model, each with its launch counts read around it:
     `save_imp_score` on the resumed checkpoint (B5 8, B6 9 with
     `--get_fps`; one finite score per alive PLY row; the live instances per
     camera against the cut); `prune_finetune` 110 -> 140 with a 66% prune
     at 115 and reports at 115 and 140 (B1 56, B2 30, B3 30, B4 38, B5 16,
     B7 26; the kept share to the rounding, the test L1 falling after the
     prune); `distill_train` SH 3 -> 2, 140 -> 170, from the finetuned
     checkpoint raised to SH degree 3 with seeded coefficients (B1 86, B2
     30, B7 56, B4 30 at 15 planes, B5 8; 24 `f_rest` fields, the frozen
     fields bit-equal to the teacher's, the loss falling); the distillation
     step beside the finetune step on the same state and views, in turns;
     and `render_video` of an ellipse and of a circle of 48 frames each (B6
     48 a call, one more for each fresh frame rendered again under a raised
     cut), the circle's radius the largest of CIRCLE_RADII whose drift plan
     reuses half its frames. Every reused frame is held against its fresh
     render (above 45 dB), and fresh and cached frames are split at their
     stage marks.
  7. The COLMAP source, VecTree and the evaluation at full width on phases
     5 and 6, each path with its launch counts read around it: phase 5's 8
     train views and 300,000-point cloud written as a COLMAP `sparse/0`
     (binary PINHOLE cameras, images.bin, points3D.bin) with the port's
     writers and read through `Scene` (cameras equal to the Blender
     reading's, R and T within 1e-6, fov within 1e-7; the cached
     points3D.ply the Blender source's byte for byte); the phase 5 model
     served from both sources by `render_sets` (B6 8 each, PNGs within
     1/255); `cli.vectree` with its defaults on the distilled model and its
     imp_score.npz (no counted kernel; the keep count, the seven files, the
     bundle loading back to the in-memory result, every VQ row a codebook
     row, the SH error under a quarter of a random codebook's; the fit's
     time split at its stage marks into draw, nearest-code search and EMA +
     expire, the final assignment, peak memory, the bundle's size against
     the PLY's); the bundle served as the next iteration with `render_sets
     --load_vq` beside the raw model (B6 8 each); and `cli.metrics` over
     both (B7 one a view, LPIPS finite and vgg-random, PSNR(VQ) above
     PSNR(raw) - 1 dB), with a view's SSIM and LPIPS timed.
     Phases 5 and 6 also hold their metric.csv's LPIPS finite and vgg-random.
Each phase ends with its own seconds. Then a `{"kernels": [...]}` line of the
nine kernels, the card line, and the final `{"ok": true, "device": {...}}`
line.

Bounds. `bound_ms` is the least time the card could take for a kernel's
outputs whatever computes them: the larger of its bytes over the memory rate
and its operations over their peak rates. For the blends the operations are
those of the pairs that change an output, with multiply-adds fused (see
F32_MIN_PER_PAIR); `bound_walk_ms` beside it is the cost of evaluating every
pair of the tiles' ranges the way the first version of these kernels did,
the figure earlier runs printed as the bound. A kernel timed under its
`bound_ms` fails the run.

The script imports nothing of JAX. It builds everything it runs from the
sources beside it; without CUDA, or without the package beside it, it fails.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
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
# The walk bound (`bound_walk_ms`): the kernels are built with --fmad=false,
# so each float32 add, multiply,
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
# The counting blend, the counting form of csrc/blend_forward.cu: the exact
# forward's pairs; an applied pair adds the weight sum's add, the w > 0
# compare and the count.
F32_PER_PAIR_COUNT = {**F32_PER_PAIR, "applied": F32_PER_PAIR["applied"] + 3}
# The least any design pays for the same outputs: only the pairs that
# change one (applied and stopping; for the render-only blend also the
# eligible pairs past a stop, which move its naive T), their arithmetic with
# multiply-adds fused and log2(e) folded into the conic, no compare or select
# counted:
#   dx, dy (2); power = dx (ha dx + hb dy) + (hc dy) dy (5); opa * e, min (2);
#   T - alpha T (1)                                                 10 FP32, 1 MUFU
#   applied: alpha T and three colour multiply-adds                 +4
F32_MIN_PER_PAIR = {"culled": 0, "faint": 0, "past_stop": 10, "stopping": 10, "applied": 14}
MUFU_MIN_PER_PAIR = {"culled": 0, "faint": 0, "past_stop": 1, "stopping": 1, "applied": 1}
# The backward's applied pair: colour . g (3), alpha T (1), r_i (1), r_i times
# the reciprocal and d_alpha (2), d_power (1), q1, q2 (2), the nine sums (9):
# +19 on the 10, and the reciprocal. The reduce over a tile's pixels is left
# out: how much of it there is depends on the design.
F32_MIN_PER_PAIR_BWD = {"culled": 0, "faint": 0, "past_stop": 0, "stopping": 10, "applied": 29}
MUFU_MIN_PER_PAIR_BWD = {"culled": 0, "faint": 0, "past_stop": 0, "stopping": 1, "applied": 2}
# The counting blend's applied pair adds the weight sum's add.
F32_MIN_PER_PAIR_COUNT = {**F32_MIN_PER_PAIR, "applied": F32_MIN_PER_PAIR["applied"] + 1}
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
CULL_STRESS = dict(n=1536, width=192, height=128, seed=5)
ZEROED_SHARE = 0.2  # of the cull-stress Gaussians, culled for the rebound-binning case
# The blur kernel (csrc/ssim_blur.cu, B3, B4 and B7) gives a warp a strip of
# 128 columns and a run of at least 16 rows (small shapes get 16): heights of
# one row, under the 11 taps, and a run +- 1; widths of one column, under a
# float4 of halo, a strip +- 1 and not a multiple of 4 (single-float rows);
# then at full size the step's images (B3) and the eval view's (B7), the
# step's backward, the set-up's target statistics and the distillation
# step's backward over the five moments of three channels (B4).
BLUR_SHAPES = ((15, 37, 53), (3, 64, 96), (2, 1, 64), (3, 7, 40), (4, 15, 129), (4, 17, 127), (3, 40, 1),
               (3, 40, 7), (2, 33, 260), (3, 1080, 1920), (6, 1080, 1920), (9, 1080, 1920), (15, 1080, 1920))
# The single-float path at a width that is a multiple of 4: the inputs lie one
# float past an aligned address.
BLUR_UNALIGNED_SHAPE = (3, 40, 64)
SSIM_SHAPE = (3, 128, 192)
KERNEL_TOL = 2e-4
B2_TOL = 1e-5  # normalised per feature; 4x the largest difference seen, a decade above atomics noise
# The median over Gaussians of |d| / |plain|, per feature. On the saturating
# scene, where d(alpha) subtracts nearly equal terms, two float32 versions
# differ there by up to 1.3e-4 (kernel vs plain; the plain version vs the JAX
# kernel 4.7e-5); an error of 0.1% on most Gaussians fails.
B2_MEDIAN_REL_TOL = 1e-3
FAST_VS_EXACT_TOL = 2e-3
CULL_LEVEL_TOL = 1e-4  # logf against torch.log; a hundredth of the margin the level carries for it
SSIM_VALUE_TOL = 1e-6
SSIM_GRAD_TOL = 1e-5
# The importance: atol 1e-4 is the JAX suite's, on a scene whose largest importance is 18. The
# saturating scene's reaches 373, where one float32 ulp is 3e-5 and the kernel's atomics add a
# Gaussian's tiles in an order that changes from run to run (2 ulp seen), so 1e-6 relative is added.
IMP_TOL, IMP_RTOL = 1e-4, 1e-6
# Full size: sum of |count difference| over the sum of counts. A pair flips
# when a float lies within an ulp or two of one of the walk's three
# thresholds, and a flipped stop lets a few more instances through on that
# pixel, so the share of such pairs is of the order of float32's epsilon:
# measured 2.0e-8 (2 hits of 1.02e8, on 2 of 303,104 Gaussians). Held at 50
# times that; a kernel that miscounts one pixel of one tile's instances
# (1 in 1024) fails it by three decades.
COUNT_RATIO_TOL = 1e-6
# Full size: |d importance| over the largest importance (982 here). Measured
# 1.4e-7, float32 sums of up to thousands of weights in another order.
IMP_REL_TOL_FULL = 2e-6
UNCHUNK_SHAPES = ((5, 16, 128), (3, 40, 128), (7680, 16, 128))
PROBE_CHECK_PASSES = 6  # few: the approximate chains contract to a fixed point within twenty
PROBE_TOL = 1e-5  # ex2.approx and rcp.approx are good to 2 ulp; the sums run in another order
TIMING_REPS = 20
PLAIN_REPS = 3
MARK_SLACK_MS = 0.01  # a run's marked span may not exceed its synchronised host time
TRAIN_STAGES = ("preprocess", "binning", "B1", "compose", "loss forward", "loss backward", "B2 + reduce",
                "preprocess backward", "Adam", "densify statistics + metrics")
SERVE_STAGES = ("preprocess", "binning", "B6", "compose")
COUNT_STAGES = ("preprocess", "binning", "B5", "compose")
# Phase 5, the trainer's schedule (its flags are built from these).
CLI_ITERATIONS = 100
CLI_RESUME_TO = 110
CLI_DENSIFY = (20, 25, 80)  # from, every, until
CLI_OPACITY_RESET = 60
CLI_PRUNE_AT, CLI_PRUNE_PERCENT = 90, 0.3
CLI_TEST_AT = (1, 100)
N_TEST_VIEWS = 8
REPORT_TRAIN_VIEWS = 5  # the loop's train sample of a report
POINT_NOISE_SD = 0.01
HOT_SHARE = 0.2  # the share of the point-cloud start's Gaussians above --densify_grad_threshold
# Phase 6, on phase 5's model: the finetune (its flags are built from these), the distillation, the trajectories.
FT_TO, FT_PRUNE_AT, FT_PRUNE_PERCENT = 140, 115, 0.66
FT_TEST_AT = (115, 140)
DISTILL_TO, DISTILL_SH = 170, 2
DISTILL_TEST_AT = (141, 170)
TEACHER_SH_SD = 0.3
VIDEO_FRAMES = 48
CIRCLE_RADII = (0.02, 0.01, 0.005, 0.003, 0.002, 0.001)  # the largest that reuses half the frames is taken
REUSED_PSNR_MIN = 45.0  # dB, the JAX suite's gate (tests/test_temporal_binning.py)
STEP_RATIO_STEPS = 8
TRAJECTORY_STAGES = {"fresh": ("preprocess", "binning", "B6", "compose"),
                     "cached": ("preprocess", "rebind", "B6", "compose")}
# Phase 7, on phases 5 and 6: the COLMAP source, VecTree (the vectree CLI's defaults: ratio 0.6,
# codebook 8192, 1000 iterations, chunk 80,000, fp16 storage) and the evaluation.
COLMAP_RT_TOL, COLMAP_FOV_TOL = 1e-6, 1e-7
VQ_KEEP = 0.4  # 1 - the default --vq_ratio
VQ_CODEBOOK, VQ_ITERATIONS = 8192, 1000  # the defaults of --codebook_size and --iteration_num
VQ_RANDOM_SHARE = 0.25  # the VQ rows' SH error under this share of a random codebook's (the JAX suite's rule)
VQ_PSNR_DROP = 1.0  # dB: PSNR(VQ) > PSNR(raw) - this (tests/test_cli.py)
VQ_STAGES = ("draw", "nearest code", "EMA + expire")


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

    def row(self, name, source, replaces, err, ms, plain_ms, ops_s, bytes_s, library_ms, walk_s=None):
        bound_ms = 1e3 * max(ops_s, bytes_s)
        if ms < bound_ms:
            fail(f"{name} was timed at {ms:.4f} ms, under its bound of {bound_ms:.4f} ms: the bound or the timing is wrong")
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
        if walk_s is not None:
            self.rows[name]["bound_walk_ms"] = 1e3 * walk_s
        return bound_ms


def build_kernels(s: Smoke) -> None:
    from lightgaussian_tpu_torch.ops import losses
    from lightgaussian_tpu_torch.ops.rasterize import blend
    from lightgaussian_tpu_torch.utils import cuda_build, issue_probe

    t0 = time.perf_counter()
    libs = cuda_build.build(blend.FORWARD_SOURCE, blend.BACKWARD_SOURCE, losses.SOURCE,
                            blend.UNCHUNK_SOURCE, issue_probe.SOURCE)
    blend._forward_library()
    blend._backward_library()
    losses._library()
    blend._unchunk_library()
    issue_probe._library()
    s.say(f"phase 1 ok: built {', '.join(p.name for p in libs)} in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        print(f"-- {lib.with_suffix('.log').name}")
        print(lib.with_suffix(".log").read_text().strip())


def reset_counts() -> None:
    from lightgaussian_tpu_torch.ops import losses
    from lightgaussian_tpu_torch.ops.rasterize import blend
    from lightgaussian_tpu_torch.utils import issue_probe

    blend.reset_launch_counts()
    losses.reset_launch_counts()
    issue_probe.reset_launch_counts()


def read_counts() -> dict:
    from lightgaussian_tpu_torch.ops import losses
    from lightgaussian_tpu_torch.ops.rasterize import blend
    from lightgaussian_tpu_torch.utils import issue_probe

    return {**blend.LAUNCHES, **losses.LAUNCHES, **issue_probe.LAUNCHES}


def blend_bounds(pairs: dict, f32_min: dict, mufu_min: dict, f32_walk: dict, mufu_walk: dict, n_bytes: int):
    """A blend's bounds from its pairs by kind, as the plain version counted
    them on this run's inputs: (seconds of the least operations, seconds of
    the bytes, seconds of the walk over every pair, a line of the parts)."""
    f32_s = sum(c * f32_min[k] for k, c in pairs.items()) / F32_INSTR_RATE
    mufu_s = sum(c * mufu_min[k] for k, c in pairs.items()) / MUFU_RATE
    walk_f32_s = sum(c * f32_walk[k] for k, c in pairs.items()) / F32_INSTR_RATE
    walk_mufu_s = sum(c * mufu_walk[k] for k, c in pairs.items()) / MUFU_RATE
    bytes_s = n_bytes / PEAK_BYTES
    walk_s = max(walk_f32_s, walk_mufu_s, bytes_s)
    parts = (f"least work: FP32 {1e3 * f32_s:.4f} ms, MUFU {1e3 * mufu_s:.4f} ms, bytes {1e3 * bytes_s:.4f} ms; "
             f"walk of every pair {1e3 * walk_s:.4f} ms (FP32 {1e3 * walk_f32_s:.4f} ms, MUFU {1e3 * walk_mufu_s:.4f} ms)")
    return max(f32_s, mufu_s), bytes_s, walk_s, parts


def cull_stress_scene(s: Smoke):
    """A binning made to stress the blends' cull: every Gaussian is in every
    tile's range, in one random depth order, so most (instance, warp) pairs
    are skipped and each kind of instance meets tiles near and far. Nearly two
    fifths are sub-pixel to 1.5 pixels wide, a tenth larger than a tile with
    opacities from under 1/255 up, a fifth mid-sized with opacities within a
    factor of two of 1/255, a fifth needles (15 to 80 pixels by 0.55 to 0.9),
    a tenth centred up to 60 pixels outside the image, and a few opaque blobs
    crowd one corner so that pixels there saturate. Returns the binning, its
    grid, the Gaussian count and the splats it was made from."""
    from lightgaussian_tpu_torch.ops.rasterize import binning
    from lightgaussian_tpu_torch.ops.rasterize.projection import Splats

    torch = s.torch
    n, w, h = CULL_STRESS["n"], CULL_STRESS["width"], CULL_STRESS["height"]
    rng = np.random.default_rng(CULL_STRESS["seed"])
    kind = rng.choice(6, size=n, p=[0.37, 0.1, 0.2, 0.2, 0.1, 0.03])
    lo = np.array([0.15, 30.0, 2.0, 15.0, 4.0, 5.0])[kind]
    hi = np.array([1.5, 120.0, 8.0, 80.0, 25.0, 10.0])[kind]
    s1 = np.exp(rng.uniform(np.log(lo), np.log(hi)))
    s2 = np.where(kind == 3, rng.uniform(0.55, 0.9, n), np.exp(rng.uniform(np.log(lo), np.log(hi))))
    theta = rng.uniform(0.0, np.pi, n)
    opa_lo = np.array([0.2, 0.002, 0.5 / 255, 0.5, 0.3, 0.95])[kind]
    opa_hi = np.array([1.0, 0.05, 2.0 / 255, 0.99, 0.9, 0.99])[kind]
    opa = np.exp(rng.uniform(np.log(opa_lo), np.log(opa_hi)))
    mean = rng.uniform([0.0, 0.0], [w, h], (n, 2))
    blob = kind == 5
    mean[blob] = rng.uniform([40.0, 30.0], [90.0, 70.0], (int(blob.sum()), 2))
    out = kind == 4
    side = rng.integers(0, 2, n)
    mean[out, 0] = np.where(side[out] == 0, -rng.uniform(1, 60, out.sum()), w + rng.uniform(1, 60, out.sum()))
    c, sn, i1, i2 = np.cos(theta), np.sin(theta), 1.0 / s1**2, 1.0 / s2**2
    conic = np.stack([c * c * i1 + sn * sn * i2, c * sn * (i1 - i2), sn * sn * i1 + c * c * i2], axis=1)
    feats = np.concatenate([mean, conic, rng.uniform(0, 1, (n, 3)), opa[:, None]], axis=1).astype(np.float32)
    order = rng.permutation(n)
    grid = binning.make_grid(w, h)
    t = grid.num_tiles
    b = binning.Binning(
        inst=torch.from_numpy(feats[order]).to(s.dev).repeat(t, 1).contiguous(),
        tile_starts=(torch.arange(t + 1, dtype=torch.int32) * n).to(s.dev),
        total=t * n,
        gid_sorted=torch.from_numpy(order).to(s.dev).repeat(t).contiguous(),
        num_gaussians=n,
    )
    f = torch.from_numpy(feats).to(s.dev)
    splats = Splats(mean2d=f[:, 0:2], conic=f[:, 2:5], color=f[:, 5:8], opacity=f[:, 8],
                    depth=torch.ones(n, device=s.dev), radius=torch.ones(n, dtype=torch.int32, device=s.dev))
    return b, grid, n, splats


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


def hold_cull(s: Smoke, b, grid, what) -> None:
    """The device's cull (`cull_cells` and `cull_level` of blend_tile.cuh,
    through `blend.instance_cull`) against its plain twins, instance by
    instance: a cell the plain rectangle keeps must not be missing."""
    from lightgaussian_tpu_torch.ops.rasterize import blend

    torch = s.torch
    cells, level = blend.instance_cull(b.tile_starts, b.inst, grid)
    s.sync()
    w_cells, w_level = blend.plain_instance_cull(b.tile_starts, b.inst, grid)
    missing = int(((w_cells & ~cells) != 0).sum())
    extra = int(((cells & ~w_cells) != 0).sum())
    whole = int((w_cells == 0xFFFFFFFF).sum())
    none = int((w_cells == 0).sum())
    finite = torch.isfinite(w_level)
    same_kind = bool((torch.isfinite(level) == finite).all())
    d_level = float((level[finite] - w_level[finite]).abs().max()) if finite.any() else 0.0
    s.say(f"  {'device cull':20s} vs plain on {what}: {cells.numel()} instances, {whole} keep every cell and {none} "
          f"none; the device lacks a cell of the plain rectangle in {missing} (must be 0) and has one more in "
          f"{extra}; level max|d| = {d_level:.3e} (atol {CULL_LEVEL_TOL:.0e})")
    if missing or not same_kind or d_level > CULL_LEVEL_TOL:
        fail(f"the device's cull is narrower than its plain twin on {what}")


def hold_counting(s: Smoke, b, grid, n, what, full_size: bool):
    """B5 against its plain version, and its image and T against B1's on the
    same binning (bit for bit: one walk); returns (image error, importance
    error, count ratio, work)."""
    from lightgaussian_tpu_torch.ops.rasterize import blend

    torch = s.torch
    rgb, t, imp, cnt = blend.blend_forward_counting(b.tile_starts, b.inst, b.gid_sorted, grid, n)
    rgb1, t1 = blend.blend_forward(b.tile_starts, b.inst, grid)
    s.sync()
    as_b1 = torch.equal(rgb, rgb1) and torch.equal(t, t1)
    w_rgb, w_t, w_imp, w_cnt, work = blend.plain_blend_counting(b.tile_starts, b.inst, b.gid_sorted, grid, n)
    if not all(torch.isfinite(x).all() for x in (rgb, t, imp)):
        fail(f"blend_count on {what}: non-finite output")
    if imp.dtype != torch.float32 or cnt.dtype != torch.int32 or tuple(cnt.shape) != (n,):
        fail(f"blend_count on {what}: outputs {imp.dtype} {cnt.dtype} {tuple(cnt.shape)}")
    err = max(float((rgb - w_rgb).abs().max()), float((t - w_t).abs().max()))
    d_imp = float((imp - w_imp).abs().max())
    imp_over = float(((imp - w_imp).abs() - IMP_RTOL * w_imp.abs()).max())
    d_cnt = (cnt.long() - w_cnt.long()).abs()
    differ = int((d_cnt > 0).sum())
    ratio = float(d_cnt.sum()) / max(float(w_cnt.long().sum()), 1.0)
    unseen = torch.ones(n, dtype=torch.bool, device=s.dev)
    unseen[b.gid_sorted] = False
    imp_scale = float(w_imp.max())
    s.say(f"  {'blend_count':20s} vs plain on {what}: image and T max|d| = {err:.3e} (atol {KERNEL_TOL:.0e}), "
          f"{'bit-equal' if as_b1 else 'NOT EQUAL'} to blend_forward's; "
          f"importance max|d| = {d_imp:.3e} of a largest {imp_scale:.3e}; hit counts: {differ} of {n} Gaussians "
          f"differ, sum|d| / sum = {ratio:.3e} of {int(w_cnt.long().sum())} hits; {int(unseen.sum())} Gaussians "
          f"in no tile")
    if err > KERNEL_TOL:
        fail(f"blend_count's image disagrees with its plain version on {what}")
    if not as_b1:
        fail(f"blend_count's image or T differs from blend_forward's on {what}")
    if full_size:
        if ratio > COUNT_RATIO_TOL or d_imp > IMP_REL_TOL_FULL * imp_scale:
            fail(f"blend_count's statistics disagree with the plain version on {what} "
                 f"(count ratio tol {COUNT_RATIO_TOL:.0e}, importance {IMP_REL_TOL_FULL:.0e} of the largest)")
    elif differ or imp_over > IMP_TOL:
        fail(f"blend_count's statistics disagree with the plain version on {what} "
             f"(counts must be equal, importance atol {IMP_TOL:.0e} + rtol {IMP_RTOL:.0e})")
    if unseen.any() and (imp[unseen].abs().max() > 0 or cnt[unseen].abs().max() > 0):
        fail(f"blend_count gave a score to a Gaussian in no tile on {what}")
    return err, d_imp, ratio, work


def hold_tools(s: Smoke) -> None:
    """B8 against `permute` and the probe against its plain recurrences."""
    from lightgaussian_tpu_torch.ops.rasterize import blend
    from lightgaussian_tpu_torch.utils import issue_probe

    torch = s.torch
    gen = torch.Generator(device=s.dev).manual_seed(11)
    for shape in UNCHUNK_SHAPES:
        x = torch.randn(shape, generator=gen, device=s.dev)
        got = blend.unchunk_transpose(x)
        s.sync()
        want = blend.plain_unchunk_transpose(x)
        equal = got.shape == want.shape and torch.equal(got, want)
        s.say(f"  {'unchunk_transpose':20s} vs permute at {shape}: {'bit-equal' if equal else 'DIFFERS'}")
        if not equal:
            fail(f"unchunk_transpose disagrees with permute at {shape}")
    n = 8 * issue_probe.GRANULE
    for kind in issue_probe.KINDS:
        x = issue_probe.start_values(kind, n, s.dev)
        got = issue_probe.run_chain(x, kind, PROBE_CHECK_PASSES)
        s.sync()
        want = issue_probe.plain_chain(x, kind, PROBE_CHECK_PASSES)
        err = float((got - want).abs().max())
        moved = float((got - x).abs().max())
        tol = 0.0 if kind in ("mul", "mul_add", "fma") else PROBE_TOL
        s.say(f"  {'issue_probe ' + kind:20s} vs plain over {PROBE_CHECK_PASSES} passes: max|d| = {err:.3e} "
              f"(atol {tol:.0e}); the chain moved its values by up to {moved:.3e}")
        if not torch.isfinite(got).all() or err > tol or moved == 0.0:
            fail(f"the probe's {kind} chain disagrees with its plain recurrence")
        s.probe_err = max(getattr(s, "probe_err", 0.0), err)


def phase2(s: Smoke) -> dict:
    """Kernels against their plain versions at the parity sizes."""
    from lightgaussian_tpu_torch.ops import losses
    from lightgaussian_tpu_torch.ops.rasterize import binning, blend, count_render, tiled
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
        hold_cull(s, b, grid, what)
        hold_counting(s, b, grid, scene.capacity, what, full_size=False)
        tiled_out = count_render(scene, cam, bg_small, max_instances=1 << 16)
        oracle = count_render(scene, cam, bg_small, method="reference")
        d_img = float((tiled_out.render - oracle.render).abs().max())
        d_abs = (tiled_out.important_score - oracle.important_score).abs()
        d_imp = float(d_abs.max())
        imp_over = float((d_abs - IMP_RTOL * oracle.important_score.abs()).max())
        differ = int((tiled_out.gaussians_count != oracle.gaussians_count).sum())
        s.say(f"  count_render tiled vs reference on {what}: image max|d| = {d_img:.3e} (atol {KERNEL_TOL:.0e}), "
              f"importance max|d| = {d_imp:.3e} (atol {IMP_TOL:.0e} + rtol {IMP_RTOL:.0e}), {differ} hit counts differ")
        if d_img > KERNEL_TOL or imp_over > IMP_TOL or differ:
            fail(f"count_render's tiled path disagrees with the oracle on {what}")
    b, grid, n, splats = cull_stress_scene(s)
    what = f"cull-stress scene {grid.width}x{grid.height}"
    _, (rgb_e, t_e) = hold("blend_forward", b, grid, what)
    hold("blend_forward_fast", b, grid, what)
    img_e, fin_e = tiled._compose(rgb_e, t_e, bg_small, grid, grid.width, grid.height)
    tile_g, tile_r = backward_seed(s, img_e, fin_e, grid, seed=len(SMALL_SCENES))
    _, _, work = hold_backward(s, b, grid, n, tile_g, tile_r, what)
    hold_counting(s, b, grid, n, what, full_size=False)
    hold_cull(s, b, grid, what)
    census = blend.cull_census(b.tile_starts, b.inst, grid)
    whole = blend.plain_cull_rect(b.inst[:n], torch.zeros(1, device=s.dev), torch.zeros(1, device=s.dev))
    unboxed = int(((whole[0] == 0) & (whole[1] == blend.TILE_SIZE - 1) & (whole[2] == 0)
                   & (whole[3] == blend.TILE_SIZE - 1)).sum())
    pairs = dict(zip(blend.WORK_KINDS, work.sum(dim=0).tolist()))
    s.say(f"  {what}: {b.total} instances, pairs {pairs}; census {census}; the first tile keeps {unboxed} of its "
          f"{n} instances whole")
    if not (0 < census["cell_applied"] <= census["cell_reached"] < 0.5 * 4 * census["warp_walked"]
            and pairs["applied"] > 0 and pairs["stopping"] > 0 and unboxed > 0):
        fail(f"{what} does not stress the cull: {census}, {pairs}, {unboxed} kept whole")
    # A cached binning's rows of Gaussians culled since its keyframe come in all zero (opacity 0, so
    # cull_level is -inf and every pair of the row is faint): a fifth of the cull-stress Gaussians, culled by
    # their radius, through rebind_features.
    gone = torch.from_numpy(np.random.default_rng(CULL_STRESS["seed"] + 1).random(n) < ZEROED_SHARE).to(s.dev)
    bz = binning.rebind_features(dataclasses.replace(splats, radius=torch.where(gone, 0, splats.radius)), b)
    zero_rows = gone[bz.gid_sorted]
    if not (bz.inst[zero_rows] == 0).all() or not torch.equal(bz.inst[~zero_rows], b.inst[~zero_rows]):
        fail("rebind_features did not zero exactly the culled Gaussians' rows")
    what_z = f"{what} with {int(gone.sum())} of its {n} Gaussians' rows zeroed"
    hold("blend_forward", bz, grid, what_z)
    hold("blend_forward_fast", bz, grid, what_z)
    hold_cull(s, bz, grid, what_z)
    counts = read_counts()
    if min(counts[k] for k in ("blend_forward", "blend_forward_fast", "blend_backward", "blend_count")) < 1:
        fail(f"a blend kernel did not count its launches: {counts}")
    hold_tools(s)
    counts = read_counts()
    if counts["unchunk_transpose"] != len(UNCHUNK_SHAPES) or counts["issue_probe"] < 7:
        fail(f"B8 or the probe did not count its launches: {counts}")

    gen = torch.Generator(device=s.dev).manual_seed(7)
    n_un = math.prod(BLUR_UNALIGNED_SHAPE)
    storage = torch.rand(2 * n_un + 8, generator=gen, device=s.dev)
    for shape in BLUR_SHAPES + ("unaligned",):
        if shape == "unaligned":  # x aligned, y (and B4's input) one float past an aligned address
            shape = BLUR_UNALIGNED_SHAPE
            x, y = storage[:n_un].view(shape), storage[n_un + 5:2 * n_un + 5].view(shape)
            b4_in = y
            if x.data_ptr() % 16 != 0 or y.data_ptr() % 16 != 4:
                fail(f"the unaligned blur inputs are not where they should be: {x.data_ptr()}, {y.data_ptr()}")
        else:
            x = torch.rand(shape, generator=gen, device=s.dev)
            y = torch.rand(shape, generator=gen, device=s.dev)
            b4_in = x
        for name, kernel, plain in (
            ("blur", lambda: losses.blur(b4_in), lambda: losses.plain_blur(b4_in)),
            ("blur3", lambda: losses.blur3(x, y), lambda: losses.plain_blur3(x, y)),
            ("blur5", lambda: losses.blur5(x, y), lambda: losses.plain_blur5(x, y)),
        ):
            got = kernel()
            s.sync()
            want = plain()
            if got.shape != want.shape or not torch.isfinite(got).all():
                fail(f"{name} at {shape}: shape {tuple(got.shape)} or non-finite output")
            err = float((got - want).abs().max())
            errors[name] = max(err, errors.get(name, 0.0))
            same = torch.equal(got, want)
            where = f"{shape}{', y one float past 16 bytes' if y.data_ptr() % 16 else ''}"
            s.say(f"  {name:20s} vs plain at {where}: max|d| = {err:.3e}; {'bit-equal' if same else 'DIFFERS'}")
            if not same:
                fail(f"{name} differs from its plain version at {where}")
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
        n_bytes = b.inst.numel() * 4 + b.tile_starts.numel() * 4 + grid.num_tiles * 4 * blend.PIX * 4
        ops_s, bytes_s, walk_s, parts = blend_bounds(pairs, F32_MIN_PER_PAIR, MUFU_MIN_PER_PAIR, F32_PER_PAIR,
                                                     MUFU_PER_PAIR, n_bytes)
        bound_ms = s.row(name, "blend_forward.cu",
                         "lightgaussian_tpu/ops/rasterize/pallas_blend.py:" + ("166" if exact else "241"),
                         err, k_ms, plain_ms, ops_s, bytes_s, None, walk_s)
        s.say(f"  {name}: max|d| {err:.3e}; {k_ms:.4f} ms/launch (CUDA events, {TIMING_REPS} launches, incl. the "
              f"tile-ordering kernel), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({parts}; pairs {pairs}, "
              f"{b.inst.shape[0]} instances); no single PyTorch call computes a tile alpha blend, so library_ms "
              f"is null")
    hold_cull(s, b, grid, "the serving scene's view 0 at 1920x1080")


def time_counting_kernel(s: Smoke, b, grid, n: int) -> None:
    """B5 at the serving scene's view 0: differences, time and bound."""
    from lightgaussian_tpu_torch.ops.rasterize import blend

    err, d_imp, ratio, work = hold_counting(s, b, grid, n, "the serving scene's view 0 at 1920x1080", full_size=True)
    args = (b.tile_starts, b.inst, b.gid_sorted, grid, n)
    k_ms = s.event_ms(lambda: blend.blend_forward_counting(*args))
    plain_ms = s.host_ms(lambda: blend.plain_blend_counting(*args))
    pairs = dict(zip(blend.WORK_KINDS, work.sum(dim=0).tolist()))
    n_bytes = (b.inst.numel() * 4 + b.gid_sorted.numel() * 8 + b.tile_starts.numel() * 4
               + grid.num_tiles * 4 * blend.PIX * 4 + n * 8)
    ops_s, bytes_s, walk_s, parts = blend_bounds(pairs, F32_MIN_PER_PAIR_COUNT, MUFU_MIN_PER_PAIR, F32_PER_PAIR_COUNT,
                                                 MUFU_PER_PAIR, n_bytes)
    bound = s.row("blend_count", "blend_forward.cu", "lightgaussian_tpu/ops/rasterize/pallas_blend.py:360",
                  err, k_ms, plain_ms, ops_s, bytes_s, None, walk_s)
    s.rows["blend_count"].update(importance_max_abs_err=d_imp, count_diff_ratio=ratio)
    s.say(f"  blend_count: {k_ms:.4f} ms/launch (CUDA events, {TIMING_REPS} launches, incl. zeroing the two "
          f"[{n}] outputs and the tile-ordering kernel), plain {plain_ms:.3f} ms (plain walk + two index_add_), "
          f"bound {bound:.4f} ms ({parts}; pairs {pairs}, {b.inst.shape[0]} instances); no single PyTorch call "
          f"computes it, library_ms null")


def time_tools(s: Smoke) -> None:
    """B8 at the JAX package's profiled shape beside `contiguous()`, and the
    probe's rates beside the constants the bounds assume. Neither lies on a
    product path: their launches are those of their own entry points here."""
    from lightgaussian_tpu_torch.ops.rasterize import blend
    from lightgaussian_tpu_torch.utils import issue_probe

    torch = s.torch
    shape = UNCHUNK_SHAPES[-1]
    x = torch.randn(shape, device=s.dev, generator=torch.Generator(device=s.dev).manual_seed(12))
    reset_counts()
    k_ms = s.event_ms(lambda: blend.unchunk_transpose(x))
    launches = read_counts()["unchunk_transpose"]
    equal = torch.equal(blend.unchunk_transpose(x), blend.plain_unchunk_transpose(x))
    if not equal:
        fail(f"unchunk_transpose disagrees with permute at {shape}")
    # a launch this short is timed by events for all three: a host time would be launch and sync latency
    plain_ms = s.event_ms(lambda: blend.plain_unchunk_transpose(x))
    lib_ms = s.event_ms(lambda: x.permute(0, 2, 1).contiguous())
    n_bytes = 2 * x.numel() * 4
    bound = s.row("unchunk_transpose", "unchunk_transpose.cu", "lightgaussian_tpu/ops/rasterize/pallas_blend.py:682",
                  0.0, k_ms, plain_ms, 0.0, n_bytes / PEAK_BYTES, lib_ms)
    s.rows["unchunk_transpose"]["launches"] = launches
    s.say(f"  unchunk_transpose {shape} -> {(shape[0] * shape[2], shape[1])}: bit-equal to permute; {k_ms:.4f} "
          f"ms/launch (CUDA events, {n_bytes / k_ms / 1e6:.0f} GB/s), plain {plain_ms:.4f} ms (permute + reshape, "
          f"CUDA events too), bound {bound:.4f} ms ({n_bytes / 1e6:.1f} MB), library {lib_ms:.4f} ms: "
          f"x.permute(0, 2, 1).contiguous(); {launches} launches of its own entry point")

    reset_counts()
    t0 = time.perf_counter()
    rates = issue_probe.measure()
    took = time.perf_counter() - t0
    launches = read_counts()["issue_probe"]
    assumed = {"fp32": F32_INSTR_RATE, "mufu": MUFU_RATE}
    for kind, r in rates.items():
        if not (r["ns_per_pass"] > 0 and math.isfinite(r["per_second"])):
            fail(f"the probe's {kind} chain gave no rate: {r}")
        line = (f"  issue_probe {kind:9s}: {r['ns_per_pass']:.2f} ns per pass over {r['elements']} elements, "
                f"{r['per_second']:.4e} {r['unit']} instructions/s ({r['instructions_per_pass']} per pass and element)")
        if r["unit"] in assumed:
            name = "F32_INSTR_RATE" if r["unit"] == "fp32" else "MUFU_RATE"
            line += f"; {name} assumes {assumed[r['unit']]:.4e}: measured / assumed = {r['per_second'] / assumed[r['unit']]:.3f}"
        s.say(line)
    # the probe's row: the float multiply chain, the kind the bounds lean on most
    mul = rates["mul"]
    hi = 4096
    n = mul["elements"]
    x = issue_probe.start_values("mul", n, s.dev)
    k_ms = s.event_ms(lambda: issue_probe.run_chain(x, "mul", hi), reps=5)
    plain_ms = s.host_ms(lambda: issue_probe.plain_chain(x, "mul", hi), reps=1)
    bound = s.row("issue_probe", "issue_probe.cu", "scripts/roofline.py:62", getattr(s, "probe_err", 0.0), k_ms,
                  plain_ms, n * hi / F32_INSTR_RATE, 2 * n * 4 / PEAK_BYTES, None)
    s.rows["issue_probe"]["launches"] = launches
    s.rows["issue_probe"]["rates_per_second"] = {k: r["per_second"] for k, r in rates.items()}
    s.say(f"  issue_probe (mul chain of {hi} passes over {n} floats): {k_ms:.4f} ms/launch, plain {plain_ms:.3f} ms "
          f"({hi} elementwise launches), bound {bound:.4f} ms (operations at F32_INSTR_RATE); measure() made "
          f"{launches} launches in {took:.2f} s; library_ms null (no PyTorch call runs a dependent chain)")


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
    b0 = binning.bin_splats(preprocess(loaded, cams[0]), grid, max_inst)
    time_blend_kernels(s, b0, grid)
    time_counting_kernel(s, b0, grid, loaded.capacity)
    time_tools(s)
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
    n_bytes = (b.inst.numel() * 4 + b.gid_sorted.numel() * 8 + b.tile_starts.numel() * 4
               + (tile_g.numel() + tile_r.numel()) * 4 + n * blend.FEAT_WIDTH * 4)
    ops_s, bytes_s, walk_s, parts = blend_bounds(pairs, F32_MIN_PER_PAIR_BWD, MUFU_MIN_PER_PAIR_BWD, F32_PER_PAIR_BWD,
                                                 MUFU_PER_PAIR_BWD, n_bytes)
    bound = s.row("blend_backward", "blend_backward.cu", "lightgaussian_tpu/ops/rasterize/pallas_blend.py:457",
                  err_abs, k_ms, plain_ms, ops_s, bytes_s, None, walk_s)
    s.rows["blend_backward"]["max_err_normalised"] = err  # the number held against B2_TOL
    s.say(f"  blend_backward: {k_ms:.4f} ms/launch (CUDA events, {TIMING_REPS} launches, incl. zeroing the "
          f"[{n}, 9] output and the tile-ordering kernel), plain {plain_ms:.3f} ms (plain walk + index_add_), bound "
          f"{bound:.4f} ms ({parts}; pairs {pairs}, {b.inst.shape[0]} instances); no single PyTorch call computes "
          f"it, library_ms null")

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
        want = plain()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            fail(f"{name} differs from its plain version at the step's shape (max|d| {err:.3e})")
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
        s.say(f"  {name} [{planes_in} planes in, {planes_out} out]: bit-equal to plain; {k_ms:.4f} ms/launch "
              f"(CUDA events), plain {plain_ms:.3f} ms, bound {bound:.4f} ms ({n_bytes / 1e6:.1f} MB; "
              f"operations {1e3 * ops_s:.4f} ms), library "
              f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'}; {note}")

    # B4's other call on the trainer's path: a camera's target statistics at set-up, B(y) and B(y^2)
    y6 = torch.cat([gt, gt * gt])
    if not torch.equal(losses.blur(y6), losses.plain_blur(y6)):
        fail("blur differs from its plain version on the set-up's six planes")
    k6_ms = s.event_ms(lambda: losses.blur(y6))
    bound6_ms = 1e3 * max(12 * plane / PEAK_BYTES, 6 * HEIGHT * WIDTH * F32_PER_BLUR_OUTPUT / F32_INSTR_RATE)
    s.rows["blur"].update(ms_6_planes=k6_ms, bound_ms_6_planes=bound6_ms)
    s.say(f"  blur [6 planes in, 6 out: precompute_ssim_target_stats of a camera]: bit-equal to plain; {k6_ms:.4f} "
          f"ms/launch (CUDA events), bound {bound6_ms:.4f} ms ({12 * plane / 1e6:.1f} MB)")
    # and the distillation step's: the backward of the five moments of three channels, 15 planes
    g15 = torch.randn((15, HEIGHT, WIDTH), device=s.dev, generator=torch.Generator(device=s.dev).manual_seed(4))
    if not torch.equal(losses.blur(g15), losses.plain_blur(g15)):
        fail("blur differs from its plain version on the distillation step's 15 planes")
    k15_ms = s.event_ms(lambda: losses.blur(g15))
    bound15_ms = 1e3 * max(30 * plane / PEAK_BYTES, 15 * HEIGHT * WIDTH * F32_PER_BLUR_OUTPUT / F32_INSTR_RATE)
    s.rows["blur"].update(ms_15_planes=k15_ms, bound_ms_15_planes=bound15_ms)
    s.say(f"  blur [15 planes in, 15 out: the distillation step's five-moment backward]: bit-equal to plain; "
          f"{k15_ms:.4f} ms/launch (CUDA events), bound {bound15_ms:.4f} ms ({30 * plane / 1e6:.1f} MB)")


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


class _Tee:
    """Collects what a phase's callee prints, and passes it on."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    @property
    def text(self) -> str:
        return "".join(self.parts)


def _called(fn, argv) -> tuple[str, float]:
    """Run a CLI's main(argv); returns (what it printed, its wall time)."""
    import contextlib

    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        fn(argv)
    return tee.text, time.perf_counter() - t0


def phase5(s: Smoke, tmp: Path) -> dict:
    """The CLI trainer at full width; returns the first call's launch counts."""
    import csv

    from lightgaussian_tpu_torch.cli import render_sets, train_densify_prune
    from lightgaussian_tpu_torch.config import OptimizationParams
    from lightgaussian_tpu_torch.data import dataset
    from lightgaussian_tpu_torch.data.ply import load_gaussian_ply, save_gaussian_ply, store_point_cloud
    from lightgaussian_tpu_torch.models.camera import Camera
    from lightgaussian_tpu_torch.models.gaussians import from_point_cloud
    from lightgaussian_tpu_torch.ops import losses
    from lightgaussian_tpu_torch.ops.rasterize import default_max_instances, render
    from lightgaussian_tpu_torch.ops.rasterize.projection import preprocess
    from lightgaussian_tpu_torch.ops.rasterize.tiled import blend_tiled
    from lightgaussian_tpu_torch.train import checkpoint, densify, gss
    from lightgaussian_tpu_torch.train.state import init_train_state
    from lightgaussian_tpu_torch.train.step import make_eval_render, make_train_step
    from lightgaussian_tpu_torch.utils import image_io, stage_marks
    from lightgaussian_tpu_torch.utils.synthetic import random_scene

    torch = s.torch
    dev = s.dev
    t0 = time.perf_counter()
    truth = random_scene(n=N_GAUSS, seed=0, extent=2.0, scale_range=(0.004, 0.02), active_sh_degree=3, device=dev)
    bg = torch.zeros(3, device=dev)
    src, out = tmp / "src5", tmp / "model5"
    train_views = [0.2 + 2.0 * math.pi * i / N_VIEWS for i in range(N_VIEWS)]
    test_views = [0.2 + math.pi / N_VIEWS + 2.0 * math.pi * i / N_TEST_VIEWS for i in range(N_TEST_VIEWS)]
    gt_cams = []  # the train cameras with their ground truth as the PNGs hold it
    for split, ts in (("train", train_views), ("test", test_views)):
        frames = []
        for i, t in enumerate(ts):
            cam = Camera.look_at(orbit_eye(t), [0, 0, 0], fovx=0.9, width=WIDTH, height=HEIGHT, device=dev)
            with torch.no_grad():
                img = render(truth, cam, bg, max_instances=MAX_INSTANCES).render.clamp(0.0, 1.0)
            quantised = (img.permute(1, 2, 0) * 255.0 + 0.5).to(torch.uint8)
            if split == "train":
                gt_cams.append(cam.with_gt(quantised.permute(2, 0, 1).to(torch.float32) / 255.0))
            arr = quantised.cpu().numpy()
            image_io.write_png(src / split / f"r_{i}.png", arr)
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": blender_c2w(orbit_eye(t))})
        (src / f"transforms_{split}.json").write_text(json.dumps({"camera_angle_x": 0.9, "frames": frames}))
    rng = np.random.default_rng(2)
    alive = truth.alive.cpu().numpy()
    points = truth.means.cpu().numpy()[alive] + rng.normal(0.0, POINT_NOISE_SD, (int(alive.sum()), 3))
    store_point_cloud(src / "points3d.ply", points, rng.random((points.shape[0], 3)) * 255)
    s.sync()
    s.say(f"  wrote {N_VIEWS} train and {N_TEST_VIEWS} test views (exact renders of the serving scene, PNG) and "
          f"a point cloud of {points.shape[0]} points in {time.perf_counter() - t0:.2f} s")

    # from_point_cloud at this size, and the percent_dense that splits its scales in two
    init_ms = s.host_ms(lambda: from_point_cloud(points, np.zeros_like(points), device=dev), reps=3)
    init = from_point_cloud(points, np.zeros_like(points), device=dev)
    extent = dataset.read_scene(src, eval_split=True).nerf_normalization["radius"]
    median_scale = float(init.scales[init.alive].amax(dim=1).median())
    percent_dense = median_scale / extent
    # The positional gradient's size depends on the scene (300k small Gaussians under a mean over 2M
    # pixels): one step per train view from the same start says where HOT_SHARE of it lies.
    probe = init_train_state(from_point_cloud(points, rng.random(points.shape), device=dev))
    probe_step = make_train_step(OptimizationParams(), extent, 2 * default_max_instances(init))
    for cam in gt_cams:
        probe, _ = probe_step(probe, cam, bg)
    seen = probe.denom > 0
    mean_grad = probe.xyz_grad_accum[seen] / probe.denom[seen]
    grad_threshold = float(torch.quantile(mean_grad, 1 - HOT_SHARE))
    # The statistic is in NDC units: one more backward, with the blend backward's d loss / d mean2d (pixels)
    # kept, shows that it is 0.5 W and 0.5 H times the pixel gradient at this frame size.
    offset = torch.zeros((probe.capacity, 2), device=dev, requires_grad=True)
    splats = preprocess(probe.scene, gt_cams[0], mean2d_offset=offset)
    splats.mean2d.retain_grad()
    image, _, _ = blend_tiled(splats, bg, WIDTH, HEIGHT, 2 * default_max_instances(init))
    lam = OptimizationParams().lambda_dssim
    loss = (1.0 - lam) * losses.l1_loss(image, gt_cams[0].gt_image) + lam * (1.0 - losses.ssim(image, gt_cams[0].gt_image))
    loss.backward()
    g_px, g_ndc = splats.mean2d.grad, offset.grad
    half = torch.tensor([0.5 * WIDTH, 0.5 * HEIGHT], device=dev)
    hit = g_px.abs().sum(dim=1) > 0
    ndc_err = float((g_ndc - g_px * half).abs().max() / g_ndc.abs().max())
    px_norm, ndc_norm = g_px[hit].norm(dim=1), g_ndc[hit].norm(dim=1)
    s.say(f"  positional gradient at {WIDTH}x{HEIGHT}: d loss / d mean2d from the blend backward, median norm over "
          f"the {int(hit.sum())} Gaussians it reaches {float(px_norm.median()):.3e} per pixel, times 0.5 W = "
          f"{0.5 * WIDTH * float(px_norm.median()):.3e}; the same backward's NDC gradient (what the step "
          f"accumulates) median {float(ndc_norm.median()):.3e}, largest |NDC - (0.5 W, 0.5 H) x pixel| / largest "
          f"{ndc_err:.1e}; median of xyz_grad_accum / denom after the {N_VIEWS} probe steps {float(mean_grad.median()):.3e}, "
          f"mean {float(mean_grad.mean()):.3e} (the default threshold is 2e-4)")
    if not (ndc_err < 1e-5 and 0.5 * HEIGHT * float(px_norm.median()) <= float(ndc_norm.median())
            <= 0.5 * WIDTH * float(px_norm.median())):
        fail("the positional gradient is not the pixel gradient in NDC units")
    del offset, splats, image, loss, g_px, g_ndc
    s.say(f"  from_point_cloud of {points.shape[0]} points (3-NN over three Morton orders): {init_ms:.2f} ms "
          f"(host-timed, median of 3); capacity {init.capacity}, median scale {median_scale:.5f}, scene extent "
          f"{extent:.3f}, so --percent_dense {percent_dense:.6f} sends half the hot Gaussians to clone, half to split; "
          f"after {N_VIEWS} steps from this start {HOT_SHARE:.0%} of the {int(seen.sum())} Gaussians seen have a mean "
          f"positional gradient above {grad_threshold:.3e}, the --densify_grad_threshold used (the default 2e-4 "
          f"placed nothing here)")
    del probe, gt_cams

    d_from, d_every, d_until = CLI_DENSIFY
    common_flags = ["-s", str(src), "-m", str(out), "--eval", "-r", "1", "--quiet", "--device", DEVICE,
                    "--densify_from_iter", str(d_from), "--densification_interval", str(d_every),
                    "--densify_until_iter", str(d_until), "--opacity_reset_interval", str(CLI_OPACITY_RESET),
                    "--percent_dense", f"{percent_dense:.6f}", "--densify_grad_threshold", f"{grad_threshold:.4e}",
                    "--position_lr_max_steps", str(CLI_ITERATIONS)]
    reset_counts()
    text, wall = _called(train_densify_prune.main, [
        *common_flags, "--disable_viewer", "--iterations", str(CLI_ITERATIONS),
        "--prune_iterations", str(CLI_PRUNE_AT), "--prune_percent", str(CLI_PRUNE_PERCENT),
        "--test_iterations", *map(str, CLI_TEST_AT), "--save_iterations", str(CLI_ITERATIONS),
        "--checkpoint_iterations", str(CLI_ITERATIONS),
    ])
    s.sync()
    counts = read_counts()
    n_eval = len(CLI_TEST_AT) * (N_TEST_VIEWS + min(REPORT_TRAIN_VIEWS, N_VIEWS))
    n_sweeps = 2  # the prune, and the imp_score export at the last checkpoint
    want = {
        "blend_forward": CLI_ITERATIONS + n_eval, "blend_backward": CLI_ITERATIONS, "blur3": CLI_ITERATIONS,
        "blur": CLI_ITERATIONS + N_VIEWS, "blur5": n_eval, "blend_count": N_VIEWS * n_sweeps,
        "blend_forward_fast": 0, "unchunk_transpose": 0, "issue_probe": 0,
    }
    s.say(f"  trainer CLI: {CLI_ITERATIONS} iterations in {wall:.2f} s wall incl. loading {N_VIEWS + N_TEST_VIEWS} "
          f"PNGs, the point-cloud start, reports and saves; launches {counts}")
    s.say(f"  expected: B1 {CLI_ITERATIONS} steps + {n_eval} evaluated views ({len(CLI_TEST_AT)} reports x "
          f"({N_TEST_VIEWS} test + {min(REPORT_TRAIN_VIEWS, N_VIEWS)} train views), one exact render and one "
          f"five-moment SSIM each), B2 and B3 one a step, B4 one a step + {N_VIEWS} train cameras at set-up, "
          f"B5 {N_VIEWS} cameras x {n_sweeps} sweeps, B7 {n_eval}")
    if counts != want:
        fail(f"the trainer made launches {counts}, expected {want}")

    # densify and prune lines
    placed = [tuple(map(int, m)) for m in re.findall(r"densify: cloned (\d+), split (\d+), pruned (\d+), dropped (\d+), alive (\d+)", text)]
    n_densify = len(range(d_every * (d_from // d_every + 1), d_until, d_every))
    if len(placed) != n_densify or sum(p[0] for p in placed) == 0 or sum(p[1] for p in placed) == 0:
        fail(f"expected {n_densify} densify lines with clones and splits placed, got {placed}")
    m = re.search(r"GSS prune 30\.00% \(pass 0\)\n\s+(\d+) -> (\d+) gaussians", text)
    if not m:
        fail("the trainer printed no GSS prune line")
    before, after = int(m.group(1)), int(m.group(2))
    idx = int(np.float32(CLI_PRUNE_PERCENT) * np.float32(before))
    s.say(f"  GSS prune at {CLI_PRUNE_AT}: {before} -> {after} alive; without ties {before - idx - 1} "
          f"(scores at or below the one at place {idx} of the ascending order go)")
    if not 0.65 * before <= after <= before - idx - 1:
        fail(f"the GSS prune kept {after} of {before}, not {1 - CLI_PRUNE_PERCENT:.0%} within ties")

    # artifacts
    ply_path = out / "point_cloud" / f"iteration_{CLI_ITERATIONS}" / "point_cloud.ply"
    ckpt_path = out / f"chkpnt{CLI_ITERATIONS}.npz"
    for f in (out / "cfg_args.json", out / "cameras.json", out / "input.ply", out / "metric.csv", ckpt_path,
              out / "imp_score.npz", ply_path):
        if not f.is_file() or f.stat().st_size == 0:
            fail(f"the trainer left no {f.relative_to(out)}")
    state, it, ckpt_extent = checkpoint.load_checkpoint(ckpt_path, device=dev)
    n_alive = state.scene.num_alive()
    saved = load_gaussian_ply(ply_path, device=dev)
    imp_score = np.load(out / "imp_score.npz")["arr_0"]
    if not (imp_score.shape == (n_alive,) and saved.num_alive() == n_alive and it == state.step == CLI_ITERATIONS):
        fail(f"imp_score {imp_score.shape}, PLY rows {saved.num_alive()}, alive {n_alive}, iteration {it}")
    if not (np.isfinite(imp_score).all() and imp_score.max() > 0 and abs(ckpt_extent - extent) < 1e-6):
        fail("imp_score.npz is not finite and positive, or the checkpoint's extent is not the scene's")
    params = ("means", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logits")
    want_keys = sorted(["__meta__", "scene/alive", "opt/count", "step", "max_radii2d", "xyz_grad_accum", "denom"]
                       + [f"{g}/{k}" for g in ("scene", "opt/mu", "opt/nu") for k in params])
    with np.load(ckpt_path) as z:
        if sorted(z.files) != want_keys:
            fail(f"checkpoint keys {sorted(z.files)}")
    all_rows = list(csv.DictReader(open(out / "metric.csv")))
    rows = [r for r in all_rows if r["set"] == "test"]
    if [int(r["iteration"]) for r in rows] != list(CLI_TEST_AT):
        fail(f"metric.csv test rows at {[r['iteration'] for r in rows]}")
    lpips_col = [(float(r["lpips"]), r["lpips_kind"]) for r in all_rows]
    if not all(math.isfinite(v) and kind == "vgg-random" for v, kind in lpips_col):
        fail(f"metric.csv's LPIPS column is not finite and vgg-random: {lpips_col}")
    l1_first, l1_last, elapsed = float(rows[0]["l1_loss"]), float(rows[-1]["l1_loss"]), float(rows[-1]["elapsed"])
    s.say(f"  test L1 {l1_first:.6f} at iteration {CLI_TEST_AT[0]} -> {l1_last:.6f} at {CLI_TEST_AT[-1]} (PSNR "
          f"{rows[0]['psnr']} -> {rows[-1]['psnr']}, LPIPS {rows[0]['lpips']} -> {rows[-1]['lpips']} "
          f"{rows[-1]['lpips_kind']}); training sections (StepTimer) {elapsed:.2f} s = "
          f"{CLI_ITERATIONS / elapsed:.2f} iterations/s; alive {n_alive} of capacity {state.capacity}")
    if not l1_last < l1_first:
        fail("the trainer did not lower the test L1")

    # resume, then serve what was saved
    text2, wall2 = _called(train_densify_prune.main, [
        *common_flags, "--start_checkpoint", str(ckpt_path), "--iterations", str(CLI_RESUME_TO),
        "--prune_iterations", str(10 * CLI_RESUME_TO), "--test_iterations", str(CLI_RESUME_TO),
        "--save_iterations", str(CLI_RESUME_TO), "--checkpoint_iterations", str(CLI_RESUME_TO),
    ])
    state2, it2, _ = checkpoint.load_checkpoint(out / f"chkpnt{CLI_RESUME_TO}.npz", device=dev)
    resumed = f"at iteration {CLI_ITERATIONS}" in text2 and f"{CLI_RESUME_TO - CLI_ITERATIONS} iterations in" in text2
    if not (resumed and it2 == state2.step == CLI_RESUME_TO and "viewer is not ported" in text2):
        fail(f"the resumed run did not start at {CLI_ITERATIONS + 1} and end at {CLI_RESUME_TO}")
    if torch.equal(state2.scene.means, state.scene.means) or not torch.isfinite(state2.scene.means).all():
        fail("the resumed run left the checkpoint's means as they were")
    s.say(f"  resumed from chkpnt{CLI_ITERATIONS}.npz to {CLI_RESUME_TO} in {wall2:.2f} s wall")
    reset_counts()
    render_sets.main(["-s", str(src), "-m", str(out), "--eval", "--skip_train", "-r", "1", "--quiet",
                      "--device", DEVICE])
    served = sorted((out / "test" / f"ours_{CLI_RESUME_TO}" / "renders").glob("*.png"))
    serve_counts = read_counts()
    if len(served) != N_TEST_VIEWS or serve_counts["blend_forward_fast"] != N_TEST_VIEWS:
        fail(f"render_sets served {len(served)} views of the trained model with launches {serve_counts}")
    got = image_io.read_image(served[0]).astype(np.float32)
    gt = image_io.read_image(src / "test" / "r_0.png").astype(np.float32)
    d_served = float(np.abs(got - gt).mean()) / 255.0
    s.say(f"  render_sets served {len(served)} test views of iteration {CLI_RESUME_TO}; view 0 mean |render - gt| "
          f"= {d_served:.6f} (the report's test L1 {l1_last:.6f})")
    if got.shape != (HEIGHT, WIDTH, 3) or got.std() < 1.0 or d_served > 2.0 * l1_first:
        fail("the served render of the trained model is blank or far from the ground truth")

    # what the trainer's parts cost, one at a time on the trained state
    cams = [Camera.look_at(orbit_eye(t), [0, 0, 0], fovx=0.9, width=WIDTH, height=HEIGHT, device=dev)
            for t in train_views]
    max_inst = default_max_instances(state2.scene)
    sweep_ms = s.host_ms(lambda: gss.accumulate_gss_auto(state2.scene, cams, bg, max_inst))
    stage_marks.start()
    gss.accumulate_gss(state2.scene, cams[:1], bg, max_inst)
    s.sync()
    marks = stage_marks.stop()
    if [name for name, _ in marks] != list(COUNT_STAGES):
        fail(f"count_render's stage marks {[name for name, _ in marks]}, expected {list(COUNT_STAGES)}")
    gen = torch.Generator(device=dev).manual_seed(0)
    hot = dataclasses.replace(state2, xyz_grad_accum=torch.rand(state2.capacity, device=dev, generator=gen) * 4e-4,
                              denom=torch.ones(state2.capacity, device=dev))
    densify_ms = s.host_ms(lambda: densify.densify_and_prune(hot, 2e-4, 0.005, extent, 20, percent_dense, gen))
    eval_render = make_eval_render(max_inst)
    gt0 = image_io.read_image(src / "train" / "r_0.png").astype(np.float32) / 255.0
    gt_cam = cams[0].with_gt(torch.from_numpy(gt0).permute(2, 0, 1).to(dev))
    eval_ms = s.host_ms(lambda: eval_render(state2.scene, gt_cam, bg))
    save_ms = s.host_ms(lambda: save_gaussian_ply(state2.scene, tmp / "timed.ply"), reps=1)
    ckpt_ms = s.host_ms(lambda: checkpoint.save_checkpoint(tmp / "timed.npz", state2, 0), reps=1)
    s.say(f"  the trainer's parts on the trained state ({state2.scene.num_alive()} alive, capacity {state2.capacity}; "
          f"host-timed, median of {PLAIN_REPS}): one GSS sweep over {N_VIEWS} cameras {sweep_ms:.2f} ms (one camera "
          f"at its marks: {', '.join(f'{k} {v:.3f}' for k, v in marks)} ms); one densify_and_prune {densify_ms:.2f} "
          f"ms; one evaluated view (exact render + five-moment SSIM) {eval_ms:.2f} ms, so a report of "
          f"{n_eval // len(CLI_TEST_AT)} views {eval_ms * n_eval / len(CLI_TEST_AT):.1f} ms; PLY save {save_ms:.1f} "
          f"ms, checkpoint save {ckpt_ms:.1f} ms")
    print("phase 5 ok", flush=True)
    return counts


def _launches_of(s: Smoke, what: str, counts: dict, want: dict) -> None:
    want = {k: want.get(k, 0) for k in counts}
    s.say(f"  {what}: launches {counts}")
    if counts != want:
        fail(f"{what} made launches {counts}, expected {want}")


def phase6(s: Smoke, tmp: Path) -> dict:
    """The GSS CLIs, the distillation CLI and the trajectory CLI at full
    width on phase 5's model; returns each path's launch counts."""
    import csv

    from lightgaussian_tpu_torch.cli import distill_train, prune_finetune, render_video, save_imp_score
    from lightgaussian_tpu_torch.config import OptimizationParams
    from lightgaussian_tpu_torch.data.ply import load_gaussian_ply, read_ply
    from lightgaussian_tpu_torch.data.scene import Scene
    from lightgaussian_tpu_torch.ops import losses
    from lightgaussian_tpu_torch.ops.rasterize import binning as bin_mod
    from lightgaussian_tpu_torch.ops.rasterize import build_binning, default_max_instances, render
    from lightgaussian_tpu_torch.render import sets as render_sets
    from lightgaussian_tpu_torch.train import checkpoint, distill, loop
    from lightgaussian_tpu_torch.train.state import init_train_state
    from lightgaussian_tpu_torch.train.step import make_train_step
    from lightgaussian_tpu_torch.utils import logging as lg_logging
    from lightgaussian_tpu_torch.utils import stage_marks

    torch = s.torch
    dev = s.dev
    src, model5 = tmp / "src5", tmp / "model5"
    start = model5 / f"chkpnt{CLI_RESUME_TO}.npz"
    common = ["-s", str(src), "--eval", "-r", "1", "--quiet", "--device", DEVICE]
    n_report = len(FT_TEST_AT) * (N_TEST_VIEWS + min(REPORT_TRAIN_VIEWS, N_VIEWS))
    paths = {}

    # 6a: save_imp_score on the resumed checkpoint
    reset_counts()
    text, wall = _called(save_imp_score.main, [*common, "-m", str(tmp / "imp6"), "--start_checkpoint", str(start),
                                               "--show_imp_score", "--get_fps"])
    s.sync()
    paths["save_imp_score"] = read_counts()
    _launches_of(s, "save_imp_score CLI", paths["save_imp_score"],
                 {"blend_count": N_VIEWS, "blend_forward_fast": N_VIEWS + 1})
    scores = np.load(tmp / "imp6" / "imp_score.npz")["arr_0"]
    ply110 = load_gaussian_ply(model5 / "point_cloud" / f"iteration_{CLI_RESUME_TO}" / "point_cloud.ply", device=dev)
    if scores.shape != (ply110.num_alive(),) or not np.isfinite(scores).all() or scores.max() <= 0:
        fail(f"save_imp_score wrote {scores.shape} scores for {ply110.num_alive()} PLY rows, or not finite and positive")
    live = re.search(r"live instances per train camera \(cut (\d+)\): \[([\d, ]+)\]; (\d+) above the cut", text)
    fps = re.search(r"render FPS over (\d+) train views: ([\d.]+)", text)
    if not live or not fps or "imp_score over" not in text:
        fail("save_imp_score printed no live counts, FPS or score percentiles")
    s.say(f"  save_imp_score on chkpnt{CLI_RESUME_TO}.npz: {scores.shape[0]} finite scores, one per alive PLY row, "
          f"in {wall:.2f} s wall; live instances per train camera [{live.group(2)}] against the cut "
          f"{live.group(1)}: {live.group(3)} above it; render FPS (render(fast=True), 8 views between two "
          f"synchronisations) {fps.group(2)}")

    # 6b: prune 66% and finetune
    out_b = tmp / "prune6"
    reset_counts()
    text, wall = _called(prune_finetune.main, [
        *common, "-m", str(out_b), "--start_checkpoint", str(start), "--iterations", str(FT_TO),
        "--prune_iterations", str(FT_PRUNE_AT), "--prune_percent", str(FT_PRUNE_PERCENT),
        "--prune_type", "v_important_score", "--test_iterations", *map(str, FT_TEST_AT),
        "--save_iterations", str(FT_TO), "--checkpoint_iterations", str(FT_TO)])
    s.sync()
    steps = FT_TO - CLI_RESUME_TO
    paths["prune_finetune"] = read_counts()
    _launches_of(s, "prune_finetune CLI", paths["prune_finetune"], {
        "blend_forward": steps + n_report, "blend_backward": steps, "blur3": steps, "blur": steps + N_VIEWS,
        "blend_count": 2 * N_VIEWS, "blur5": n_report})
    before = ply110.num_alive()
    pruned = load_gaussian_ply(out_b / "point_cloud" / f"iteration_{FT_TO}" / "point_cloud.ply", device=dev)
    after = pruned.num_alive()
    idx = int(np.float32(FT_PRUNE_PERCENT) * np.float32(before))
    rows = [r for r in csv.DictReader(open(out_b / "metric.csv")) if r["set"] == "test"]
    l1 = {int(r["iteration"]): float(r["l1_loss"]) for r in rows}
    if not all(math.isfinite(float(r["lpips"])) and r["lpips_kind"] == "vgg-random" for r in rows):
        fail(f"the finetune's metric.csv LPIPS is not finite and vgg-random: {[r['lpips'] for r in rows]}")
    its = re.search(r"Training sections: (\d+) iterations in ([\d.]+) s \(([\d.]+) it/s\)", text)
    s.say(f"  prune_finetune from chkpnt{CLI_RESUME_TO}.npz: {before} -> {after} alive at {FT_PRUNE_AT} (without "
          f"ties {before - idx - 1}, {after / before:.4f} kept); test L1 {l1.get(FT_TEST_AT[0])} at "
          f"{FT_TEST_AT[0]} (after the prune) -> {l1.get(FT_TEST_AT[1])} at {FT_TEST_AT[1]}; {wall:.2f} s wall; "
          f"training sections {its.group(2) if its else '?'} s for {steps} iterations "
          f"({its.group(3) if its else '?'} it/s)")
    if not (1 - FT_PRUNE_PERCENT - 0.005) * before <= after <= before - idx - 1:
        fail(f"the finetune's prune kept {after} of {before}, not {1 - FT_PRUNE_PERCENT:.0%} to the rounding")
    if sorted(l1) != list(FT_TEST_AT) or not l1[FT_TEST_AT[1]] < l1[FT_TEST_AT[0]]:
        fail(f"the finetune did not lower the test L1 after the prune: {l1}")

    # 6c: distil SH 3 -> 2. The finetuned model is still at SH degree 0 (the trainer raises the degree every
    # 1000 iterations; 140 reach none), so the teacher is its checkpoint with degree 3 and seeded coefficients.
    ft_state, _, ft_extent = checkpoint.load_checkpoint(out_b / f"chkpnt{FT_TO}.npz", device=dev)
    rest = np.random.default_rng(6).normal(0.0, TEACHER_SH_SD, tuple(ft_state.scene.sh_rest.shape))
    rest = torch.where(ft_state.scene.alive[:, None, None], torch.from_numpy(rest.astype(np.float32)).to(dev), 0.0)
    teacher_path = tmp / f"teacher{FT_TO}.npz"
    checkpoint.save_checkpoint(teacher_path, dataclasses.replace(ft_state, scene=dataclasses.replace(
        ft_state.scene, sh_rest=rest, active_sh_degree=3)), FT_TO, ft_extent)
    del ft_state, rest
    out_c = tmp / "distill6"
    seen = []
    scalar = lg_logging.MetricsLogger.scalar

    def record(self, tag, value, step):  # the drained losses, as the CLI logs them
        if tag == "distill/loss":
            seen.append((step, value))
        return scalar(self, tag, value, step)

    lg_logging.MetricsLogger.scalar = record
    reset_counts()
    try:
        text, wall = _called(distill_train.main, [
            *common, "-m", str(out_c), "--start_checkpoint", str(teacher_path),
            "--new_max_sh", str(DISTILL_SH), "--augmented_view", "--iterations_total", str(DISTILL_TO),
            "--test_iterations", *map(str, DISTILL_TEST_AT), "--save_iterations", str(DISTILL_TO),
            "--checkpoint_iterations", str(DISTILL_TO)])
        s.sync()
    finally:
        lg_logging.MetricsLogger.scalar = scalar
    steps = DISTILL_TO - FT_TO
    paths["distill_train"] = read_counts()
    _launches_of(s, "distill_train CLI", paths["distill_train"], {
        "blend_forward": 2 * steps + n_report, "blend_backward": steps, "blur5": steps + n_report, "blur": steps,
        "blend_count": N_VIEWS})
    ply_c = out_c / "point_cloud" / f"iteration_{DISTILL_TO}" / "point_cloud.ply"
    f_rest = [n for n in read_ply(ply_c)["vertex"].property_names if n.startswith("f_rest_")]
    teacher, _, _ = checkpoint.load_checkpoint(teacher_path, device=dev)
    student, it, _ = checkpoint.load_checkpoint(out_c / f"chkpnt{DISTILL_TO}.npz", device=dev)
    frozen = all(torch.equal(getattr(student.scene, f), getattr(teacher.scene, f))
                 for f in ("log_scales", "quats", "opacity_logits"))
    moved = not torch.equal(student.scene.sh_dc, teacher.scene.sh_dc)
    losses_seq = [v for _, v in sorted(seen)]
    epoch = N_VIEWS  # one pass over the train cameras
    first, last = statistics.fmean(losses_seq[:epoch]), statistics.fmean(losses_seq[2 * epoch:3 * epoch])
    rows = [r for r in csv.DictReader(open(out_c / "metric.csv")) if r["set"] == "test"]
    elapsed = float(rows[-1]["elapsed"]) if rows else float("nan")
    s.say(f"  distill_train SH 3 -> {DISTILL_SH} from chkpnt{FT_TO}.npz at SH degree 3 (rest coefficients "
          f"N(0, {TEACHER_SH_SD}), seeded): {len(f_rest)} f_rest fields; scaling, "
          f"rotation and opacity {'bit-equal to' if frozen else 'DIFFER FROM'} the teacher's; drained loss first "
          f"{losses_seq[0]:.6f} -> last {losses_seq[-1]:.6f}, mean over iterations {FT_TO + 1}-{FT_TO + epoch} "
          f"{first:.6f} -> {FT_TO + 2 * epoch + 1}-{FT_TO + 3 * epoch} {last:.6f} (the same {epoch} cameras); test "
          f"PSNR {[r['psnr'] for r in rows]}; {wall:.2f} s wall, training sections {elapsed:.2f} s for {steps} "
          f"iterations ({steps / elapsed:.2f} it/s)")
    if len(f_rest) != 3 * (DISTILL_SH + 1) ** 2 - 3 or not frozen or not moved or it != DISTILL_TO:
        fail("the distilled model has the wrong SH width, moved a frozen field, or did not train")
    if len(losses_seq) != steps or not (losses_seq[0] > losses_seq[-1] and first > last):
        fail(f"the distillation loss did not fall: {losses_seq}")

    # the distillation step beside the finetune step, on the same state and views, in turns
    scene_c = Scene(str(src), str(out_c), eval_split=True, resolution=1, load_iteration=-1, shuffle=False,
                    device=dev)
    cams = scene_c.getTrainCameras()
    bg = torch.zeros(3, device=dev)
    max_inst = default_max_instances(teacher.scene)
    d_step = distill.make_distill_step(OptimizationParams(), scene_c.cameras_extent, max_inst)
    t_step = make_train_step(OptimizationParams(), scene_c.cameras_extent, max_inst, update_densify_stats=False)
    t_cams = [c.with_gt_ssim_stats(losses.precompute_ssim_target_stats(c.gt_image)) for c in cams]
    d_state, t_state = init_train_state(distill.init_student(teacher.scene, DISTILL_SH)), teacher
    times = {"distill": [], "finetune": []}
    for i in range(2 * STEP_RATIO_STEPS + 2):
        s.sync()
        t0 = time.perf_counter()
        if i % 2:
            d_state, _ = d_step(d_state, teacher.scene, cams[(i // 2) % N_VIEWS], bg)
        else:
            t_state, _ = t_step(t_state, t_cams[(i // 2) % N_VIEWS], bg)
        s.sync()
        if i >= 2:
            times["distill" if i % 2 else "finetune"].append(1e3 * (time.perf_counter() - t0))
    d_ms, t_ms = statistics.median(times["distill"]), statistics.median(times["finetune"])
    s.say(f"  step times on the pruned model ({teacher.scene.num_alive()} alive), median of {STEP_RATIO_STEPS} each, "
          f"in turns on the same views: distillation step {d_ms:.3f} ms, finetune step {t_ms:.3f} ms, ratio "
          f"{d_ms / t_ms:.3f}")
    del d_state, t_state, t_cams

    # 6d: trajectories of the distilled model
    scene = scene_c.gaussians
    frames_circ = None
    for radius in CIRCLE_RADII:
        frames_circ = render_sets.trajectory_frames("circular", cams, VIDEO_FRAMES, radius)
        plan = render_sets.plan_rebin_schedule(scene, frames_circ, 8, 1.5)
        if VIDEO_FRAMES - sum(plan) >= VIDEO_FRAMES // 2:
            break
    else:
        fail(f"no radius of {CIRCLE_RADII} lets half the circular frames reuse a binning")
    frames_ell = render_sets.trajectory_frames("ellipse", cams, VIDEO_FRAMES, 0.0)
    plan_ell = render_sets.plan_rebin_schedule(scene, frames_ell, 8, 1.5)
    for flags, what in ((["--video"], "ellipse"), (["--circular", "--radius", str(radius)], "circular")):
        reset_counts()
        text, wall = _called(render_video.main, [*common, "-m", str(out_c), "--skip_train", "--skip_test", *flags,
                                                 "--n_frames", str(VIDEO_FRAMES)])
        s.sync()
        # a fresh frame whose live count reaches the cut renders again under a raised cut (B6 once more), a
        # keyframe bins again (no launch); each says so
        grows = re.findall(r"\[\w+ frame (\d+)\] (\d+) live instances reach the cut (\d+); growing it to \d+ "
                           r"and (rendering|binning)", text)
        renders_again = sum(g[3] == "rendering" for g in grows)
        paths[f"render_video {what}"] = read_counts()
        _launches_of(s, f"render_video --{what}", paths[f"render_video {what}"],
                     {"blend_forward_fast": VIDEO_FRAMES + renders_again})
        pngs = sorted((out_c / render_sets.TRAJECTORY_DIRS[what] / f"ours_{DISTILL_TO}").glob("*.png"))
        if len(pngs) != VIDEO_FRAMES:
            fail(f"render_video --{what} wrote {len(pngs)} frames, not {VIDEO_FRAMES}")
        s.say(f"  render_video --{what}: {VIDEO_FRAMES} PNGs in {wall:.2f} s wall incl. loading and PNG writes; "
              f"{VIDEO_FRAMES} B6 launches and {renders_again} more for the frames rendered again under a raised "
              f"cut (frame, live instances, cut, what ran again: {grows})")
    s.say(f"  rebin plans (1 = bin fresh): ellipse {''.join(str(int(f)) for f in plan_ell)} "
          f"({VIDEO_FRAMES - sum(plan_ell)} reused); circular radius {radius} "
          f"{''.join(str(int(f)) for f in plan)} ({VIDEO_FRAMES - sum(plan)} reused)")

    # the reused circular frames against fresh renders, and the two kinds of frame at their stage marks (no cut)
    worst, marks, walls = float("inf"), {"fresh": [], "cached": []}, {"fresh": [], "cached": []}
    binning, uncut = None, bin_mod.MAX_CAPACITY
    for i, cam in enumerate(frames_circ):
        if plan[i]:
            binning = build_binning(scene, cam, max_instances=uncut)
            kind, kw = "fresh", dict(max_instances=uncut)
        else:
            kind, kw = "cached", dict(cached_binning=binning)
        s.sync()
        t0 = time.perf_counter()
        stage_marks.start()
        img = render(scene, cam, bg, fast=True, **kw).render
        s.sync()
        walls[kind].append(1e3 * (time.perf_counter() - t0))
        marks[kind].append(stage_marks.stop())
        if kind == "cached":
            fresh = render(scene, cam, bg, max_instances=uncut, fast=True).render
            worst = min(worst, float(losses.psnr(img.clamp(0, 1), fresh.clamp(0, 1))))
    s.say(f"  the {len(walls['cached'])} reused circular frames against fresh renders: worst PSNR {worst:.2f} dB "
          f"(gate {REUSED_PSNR_MIN} dB)")
    if not worst > REUSED_PSNR_MIN:
        fail(f"a reused trajectory frame is {worst:.2f} dB from its fresh render")
    for kind in ("fresh", "cached"):
        s.say(f"  {kind} trajectory frame (render(fast=True){' over a keyframe binning' if kind == 'cached' else ''}): "
              f"median {statistics.median(walls[kind]):.3f} ms over {len(walls[kind])} frames")
        stage_split(s, marks[kind], TRAJECTORY_STAGES[kind], walls[kind], f"{kind} trajectory frame")
    print("phase 6 ok", flush=True)
    return paths


def phase7(s: Smoke, tmp: Path) -> dict:
    """A COLMAP source, VecTree with `--load_vq` serving and the metrics at
    full width on phases 5 and 6; returns each path's launch counts."""
    from lightgaussian_tpu_torch.cli import metrics as metrics_cli
    from lightgaussian_tpu_torch.cli import render_sets, vectree as vectree_cli
    from lightgaussian_tpu_torch.compress import vectree, vq
    from lightgaussian_tpu_torch.data import colmap, dataset
    from lightgaussian_tpu_torch.data.ply import load_gaussian_ply, read_ply
    from lightgaussian_tpu_torch.data.scene import Scene
    from lightgaussian_tpu_torch.eval import lpips, metrics
    from lightgaussian_tpu_torch.models.camera import fov2focal
    from lightgaussian_tpu_torch.ops import losses
    from lightgaussian_tpu_torch.utils import image_io, stage_marks, threefry

    torch = s.torch
    dev = s.dev
    src5, model5, out_c = tmp / "src5", tmp / "model5", tmp / "distill6"
    paths = {}

    # 7a: phase 5's train views and point cloud as a COLMAP source (binary PINHOLE cameras)
    t0 = time.perf_counter()
    blender = dataset.read_scene(src5, eval_split=True)
    src7 = tmp / "colmap7"
    sparse = src7 / "sparse" / "0"
    sparse.mkdir(parents=True)
    (src7 / "images").mkdir()
    cams, images = {}, {}
    for i, info in enumerate(blender.train_cameras):
        f = fov2focal(info.fovx, info.width)
        cams[i + 1] = colmap.ColmapCamera(i + 1, "PINHOLE", info.width, info.height,
                                          np.array([f, fov2focal(info.fovy, info.height), info.width / 2,
                                                    info.height / 2]))
        images[i + 1] = colmap.ColmapImage(i + 1, colmap.rotmat2qvec(info.R.T), info.T, i + 1,
                                           Path(info.image_path).name, np.zeros((0, 2)), np.zeros(0, np.int64))
        shutil.copy(info.image_path, src7 / "images" / Path(info.image_path).name)
    colmap.write_cameras_binary(sparse / "cameras.bin", cams)
    colmap.write_images_binary(sparse / "images.bin", images)
    v = read_ply(src5 / "points3d.ply")["vertex"]
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    rgb = np.stack([v["red"], v["green"], v["blue"]], axis=1)
    colmap.write_points3D_binary(sparse / "points3D.bin", xyz, rgb)
    written_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene7 = Scene(str(src7), str(tmp / "colmap7_model"), resolution=1, shuffle=False, device=dev)
    read_s = time.perf_counter() - t0
    worst = {"R": 0.0, "T": 0.0, "fov": 0.0}
    got_cams = scene7.scene_info.train_cameras
    if [c.image_name for c in got_cams] != [c.image_name for c in blender.train_cameras]:
        fail(f"the COLMAP source's cameras {[c.image_name for c in got_cams]} are not the Blender train views")
    for c, b in zip(got_cams, blender.train_cameras):
        worst["R"] = max(worst["R"], float(np.abs(c.R - b.R).max()))
        worst["T"] = max(worst["T"], float(np.abs(c.T - b.T).max()))
        worst["fov"] = max(worst["fov"], abs(c.fovx - b.fovx), abs(c.fovy - b.fovy))
    cached_ply = (sparse / "points3D.ply").read_bytes() == (src5 / "points3d.ply").read_bytes()
    s.say(f"  COLMAP source: {len(cams)} PINHOLE cameras, {len(images)} images and {xyz.shape[0]} points written in "
          f"{written_s:.2f} s; Scene read it in {read_s:.2f} s ({scene7.gaussians.num_alive()} Gaussians from the "
          f"cloud, {len(scene7.getTrainCameras())} cameras at {WIDTH}x{HEIGHT}); against the Blender reading: "
          f"largest |dR| {worst['R']:.2e}, |dT| {worst['T']:.2e}, |d fov| {worst['fov']:.2e}; the cached "
          f"points3D.ply {'is' if cached_ply else 'IS NOT'} the Blender source's point cloud byte for byte")
    if not (worst["R"] < COLMAP_RT_TOL and worst["T"] < COLMAP_RT_TOL and worst["fov"] < COLMAP_FOV_TOL and cached_ply):
        fail("the COLMAP source's cameras or points differ from the Blender source's")
    del scene7
    served = {}
    for what, source, flags in (("colmap", src7, []), ("blender", src5, ["--eval", "--skip_test"])):
        m = tmp / f"serve7_{what}"
        it_dir = m / "point_cloud" / f"iteration_{CLI_RESUME_TO}"
        it_dir.mkdir(parents=True)
        shutil.copy(model5 / "point_cloud" / f"iteration_{CLI_RESUME_TO}" / "point_cloud.ply", it_dir)
        reset_counts()
        _, wall = _called(render_sets.main, ["-s", str(source), "-m", str(m), "-r", "1", "--quiet", "--device",
                                             DEVICE, *flags])
        s.sync()
        paths[f"render_sets {what}"] = read_counts()
        _launches_of(s, f"render_sets from the {what} source ({wall:.2f} s wall)", paths[f"render_sets {what}"],
                     {"blend_forward_fast": N_VIEWS})
        served[what] = sorted((m / "train" / f"ours_{CLI_RESUME_TO}" / "renders").glob("*.png"))
    if not len(served["colmap"]) == len(served["blender"]) == N_VIEWS:
        fail(f"render_sets served {len(served['colmap'])} and {len(served['blender'])} views")
    d_max = max(int(np.abs(image_io.read_image(a).astype(np.int16) - image_io.read_image(b).astype(np.int16)).max())
                for a, b in zip(served["colmap"], served["blender"]))
    s.say(f"  the phase 5 model served from both sources: largest PNG difference {d_max}/255 over {N_VIEWS} views")
    if d_max > 1:
        fail(f"the COLMAP and Blender sources render {d_max}/255 apart")

    # 7b: VecTree on the distilled model with its imp_score.npz, the CLI's defaults
    ply_c = out_c / "point_cloud" / f"iteration_{DISTILL_TO}" / "point_cloud.ply"
    vq_dir = tmp / "vq7"
    fit, assign, captured = {}, {}, {}
    train_codebook, quantize_fp16, quantize_features = (vq.train_codebook, vq.quantize_with_fp16_codebook,
                                                        vectree.quantize_features)

    def timed_fit(*args, **kwargs):
        s.sync()
        t = time.perf_counter()
        stage_marks.start()
        state = train_codebook(*args, **kwargs)
        s.sync()
        fit["s"], fit["marks"] = time.perf_counter() - t, stage_marks.stop()
        return state

    def timed_assign(*args):
        s.sync()
        t = time.perf_counter()
        out = quantize_fp16(*args)
        s.sync()
        assign["ms"] = 1e3 * (time.perf_counter() - t)
        return out

    def kept(*args, **kwargs):
        captured["result"], captured["feats"] = quantize_features(*args, **kwargs)
        return captured["result"], captured["feats"]

    vq.train_codebook, vq.quantize_with_fp16_codebook, vectree.quantize_features = timed_fit, timed_assign, kept
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        _, wall = _called(vectree_cli.main, ["--important_score_npz_path", str(out_c), "--input_path", str(ply_c),
                                             "--save_path", str(vq_dir), "--codebook_size", str(VQ_CODEBOOK),
                                             "--iteration_num", str(VQ_ITERATIONS), "--device", DEVICE])
        s.sync()
    finally:
        vq.train_codebook, vq.quantize_with_fp16_codebook, vectree.quantize_features = (
            train_codebook, quantize_fp16, quantize_features)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    paths["vectree"] = read_counts()
    _launches_of(s, "vectree CLI (no counted kernel: the fit is matrix products and index_add_)",
                 paths["vectree"], {})
    result, qfeats = captured["result"], captured["feats"]
    n = qfeats.shape[0]
    bundle = vq_dir / "extreme_saving"
    files = sorted(p.name for p in bundle.iterdir())
    full = vectree.load_extreme(bundle)
    cfg = vectree.VQConfig(sh_degree=DISTILL_SH, codebook_size=VQ_CODEBOOK, iterations=VQ_ITERATIONS)
    sh = slice(6, 6 + cfg.sh_dim)
    keep = result.non_vq_mask
    feats = vectree.scene_to_feature_matrix(vectree.load_vq_scene(bundle, device=dev))  # the bundle, as served
    source = vectree.scene_to_feature_matrix(load_gaussian_ply(ply_c, device=dev))
    with np.load(bundle / "vq_indexs.npz") as z:
        idx = vectree.unpack_bits_msb(z["arr_0"], n - int(keep.sum()), int(math.log2(cfg.codebook_size)))
    codebook = result.codebook
    vq_rows = source[~keep, sh]
    err = float(np.mean((full[~keep, sh] - vq_rows) ** 2))
    rand = threefry.normal(threefry.prng_key(9), (cfg.codebook_size, cfg.sh_dim), device=dev)
    q_rand, _ = vq.quantize_with_fp16_codebook(torch.from_numpy(np.ascontiguousarray(vq_rows)).to(dev), rand)
    err_rand = float(np.mean((q_rand.cpu().numpy() - vq_rows) ** 2))
    round_trip = (np.array_equal(full, qfeats) and np.array_equal(full[:, 0:3], source[:, 0:3])
                  and np.array_equal(full[keep, sh], source[keep, sh].astype(np.float16).astype(np.float32))
                  and np.array_equal(full[:, -8:], source[:, -8:].astype(np.float16).astype(np.float32))
                  and np.array_equal(feats[:, 0:3], full[:, 0:3]))
    marks = fit["marks"]
    split = {name: sum(ms for k, ms in marks if k == name) for name in VQ_STAGES}
    if [k for k, _ in marks if k != "draw"] != list(VQ_STAGES[1:]) * cfg.iterations or set(dict(marks)) != set(VQ_STAGES):
        fail(f"the fit's stage marks are not a draw per block and a step's two marks per iteration: {len(marks)} marks")
    fit_ms = sum(split.values())
    zip_mb = (vq_dir / "extreme_saving.zip").stat().st_size / 2**20
    ply_mb = ply_c.stat().st_size / 2**20
    s.say(f"  vectree CLI on the distilled model ({n} Gaussians, SH {DISTILL_SH}, imp_score.npz of its export): "
          f"{wall:.2f} s wall; kept {int(keep.sum())} (int({VQ_KEEP} n) = {int(n * VQ_KEEP)}), {n - int(keep.sum())} "
          f"quantized into {cfg.codebook_size} codes; files {files}")
    s.say(f"  the fit: {cfg.iterations} iterations of chunk {cfg.chunk} in {fit['s']:.3f} s host = "
          f"{1e3 * fit['s'] / cfg.iterations:.3f} ms an iteration; at its stage marks {fit_ms:.1f} ms: "
          + ", ".join(f"{k} {v:.1f} ms ({v / fit_ms:.1%}, {v / cfg.iterations:.3f} ms an iteration)"
                      for k, v in split.items())
          + f"; the final assignment of {n} rows {assign['ms']:.1f} ms; peak device memory {peak_gb:.2f} GiB")
    s.say(f"  bundle {zip_mb:.3f} MB (extreme_saving.zip) against point_cloud.ply {ply_mb:.3f} MB: "
          f"{ply_mb / zip_mb:.2f}x; VQ rows' SH error {err:.6f} against {err_rand:.6f} for a random normal codebook "
          f"({err / err_rand:.4f}); load_extreme {'equals' if round_trip else 'DIFFERS FROM'} the in-memory result "
          f"(xyz exact, fp16 fields exact)")
    if int(keep.sum()) != int(n * VQ_KEEP) or files != sorted(vectree.BUNDLE_FILES):
        fail("the bundle keeps the wrong count or lacks a file")
    if not (round_trip and np.isfinite(codebook).all() and idx.max() < cfg.codebook_size
            and np.array_equal(full[~keep, sh], codebook[idx])):
        fail("the bundle does not load back to the quantized features, or a VQ row is no codebook row")
    if not err < VQ_RANDOM_SHARE * err_rand:
        fail(f"the codebook's SH error {err:.6f} is not under {VQ_RANDOM_SHARE} of a random codebook's {err_rand:.6f}")

    # 7c: serve the bundle as iteration DISTILL_TO + 1 beside the raw model
    shutil.copytree(bundle, out_c / "point_cloud" / f"iteration_{DISTILL_TO + 1}" / "extreme_saving")
    common = ["-s", str(src5), "-m", str(out_c), "--eval", "--skip_train", "-r", "1", "--quiet", "--device", DEVICE]
    for what, flags in (("raw", ["--iteration", str(DISTILL_TO)]),
                        ("--load_vq", ["--iteration", str(DISTILL_TO + 1), "--load_vq"])):
        reset_counts()
        _, wall = _called(render_sets.main, [*common, *flags])
        s.sync()
        paths[f"render_sets {what}"] = read_counts()
        _launches_of(s, f"render_sets {what} ({wall:.2f} s wall)", paths[f"render_sets {what}"],
                     {"blend_forward_fast": N_TEST_VIEWS})

    # 7d: metrics over both
    reset_counts()
    _, wall = _called(metrics_cli.main, ["-m", str(out_c), "--device", DEVICE])
    s.sync()
    paths["metrics"] = read_counts()
    _launches_of(s, f"metrics CLI ({wall:.2f} s wall incl. reading {4 * N_TEST_VIEWS} PNGs)", paths["metrics"],
                 {"blur5": 2 * N_TEST_VIEWS})
    res = json.loads((out_c / "results.json").read_text())
    raw, vqd = res.get(f"ours_{DISTILL_TO}", {}), res.get(f"ours_{DISTILL_TO + 1}", {})
    s.say(f"  results.json: raw PSNR {raw.get('PSNR')} SSIM {raw.get('SSIM')} LPIPS {raw.get('LPIPS')}; VQ PSNR "
          f"{vqd.get('PSNR')} SSIM {vqd.get('SSIM')} LPIPS {vqd.get('LPIPS')}; lpips_kind {vqd.get('lpips_kind')}")
    if not (raw and vqd and all(math.isfinite(r[k]) for r in (raw, vqd) for k in ("PSNR", "SSIM", "LPIPS"))
            and raw["lpips_kind"] == vqd["lpips_kind"] == "vgg-random"):
        fail(f"metrics wrote {res}")
    if not vqd["PSNR"] > raw["PSNR"] - VQ_PSNR_DROP:
        fail(f"the VQ model's PSNR {vqd['PSNR']:.3f} is more than {VQ_PSNR_DROP} dB under the raw model's")
    method = out_c / "test" / f"ours_{DISTILL_TO + 1}"
    name = sorted(p.name for p in (method / "renders").iterdir())[0]
    render_img = metrics.load_image(method / "renders" / name, dev)
    gt_img = metrics.load_image(method / "gt" / name, dev)
    net = lpips.get_lpips_params(device=dev)
    ssim_ms = s.event_ms(lambda: losses.ssim(render_img, gt_img))
    lpips_ms = s.event_ms(lambda: net(render_img, gt_img), reps=5)
    s.say(f"  a {WIDTH}x{HEIGHT} view's SSIM (B7 and the map) {ssim_ms:.3f} ms, LPIPS (two VGG16 stacks, float32, "
          f"TF32 off) {lpips_ms:.3f} ms (CUDA events)")
    print("phase 7 ok", flush=True)
    return paths


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

    def timed(number: int, phase, *args):
        t0 = time.perf_counter()
        out = phase(s, *args)
        s.sync()
        print(f"phase {number} took {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    timed(1, build_kernels)
    blur_errors = timed(2, phase2)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        cli_counts = timed(3, phase3, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = timed(4, phase4, blur_errors)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        trainer_counts = timed(5, phase5, tmp)
        cli_paths = timed(6, phase6, tmp)
        cli_paths.update(timed(7, phase7, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # launches on each kernel's path: the render CLI (B6), the training steps (B1-B4), the eval render
    # (B7), the trainer CLI (B5); B8 and the probe, on no product path, carry their own entry points'.
    # Beside them, each kernel's launches on every path the run drove.
    by_path = {"render_sets": cli_counts, "train step": counts["train"], "eval render": counts["eval"],
               "train_densify_prune": trainer_counts, **cli_paths}
    for name, row in s.rows.items():
        if row["launches"] is None:
            row["launches"] = (cli_counts if name == "blend_forward_fast" else counts["eval"] if name == "blur5"
                               else trainer_counts if name == "blend_count" else counts["train"])[name]
        row["launches_by_path"] = {path: c[name] for path, c in by_path.items() if c.get(name)}
    order = ("blend_forward", "blend_forward_fast", "blend_backward", "blur3", "blur", "blur5", "blend_count",
             "unchunk_transpose", "issue_probe")
    print(json.dumps({"kernels": [s.rows[k] for k in order]}))
    print(s.card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
