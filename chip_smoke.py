#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`lightgaussian_tpu_torch`) on one GPU.

Usage: python3 chip_smoke.py        (from the repository root; needs one CUDA card)

Phases, each of which exits non-zero on failure:
  1. The card (nvidia-smi name and power limit) and the kernels' build: the
     seven CUDA sources of the kernel table (`utils/cuda_build.py`)
     compiled at once, one nvcc each, and loaded, with ptxas's
     registers, spills and shared memory for every kernel (the forward,
     counting and backward blends, their tile-ordering kernel included, and
     the preprocess forward and backward at each SH degree).
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
       units, the shuffle sum and the scan at 1e-5;
     - binning's tile cover (`lg_bin_cover`) against the torch chain it
       replaces (`binning.plain_cover`) on each kind of the stress set
       (`synthetic.cover_stress_splats`: rects over 32 tiles, opacities at
       and just above 1/255, means off-screen, behind the camera and
       non-finite, radius 0, ellipses grazing a neighbouring tile's box) at
       1237x822, and on the whole set as column views of one array: count
       and mask equal on every Gaussian, lo_x, lo_y and hi_x where the
       count is positive;
     - binning's instance emission (`lg_bin_emit`) against the plain
       emission (`binning.plain_emit`, the torch chain `_fill_slots` +
       `_depth_key` it replaces) on each kind of that stress set with no
       cut, with a cut one slot into a Gaussian's instances, with every
       Gaussian on the >32-tile fallback and with all depths equal: every
       slot's 32-bit key and Gaussian equal, one launch of its row each;
     - the preprocess kernels (`lg_preprocess_forward`,
       `lg_preprocess_backward`) against the torch chain they replace
       (`projection.plain_preprocess` and its autograd) on the stress set
       (`synthetic.preprocess_stress`: dead Gaussians, depths on and around
       the near plane and the EWA's depth clamp, means exactly on the 1.3
       tan(fov) clamp, colours exactly on the clamp at 0, sizes from a point
       to larger than the view, means off-screen) at 1237x822, at each SH
       degree of 4 with the offset, with precomputed colours and a scale
       modifier, with precomputed covariances (half with det <= 0), and at
       SH 2 over a view of wider sh_rest rows with the opacity frozen: the
       forward's six outputs bit for bit (differing elements counted), the
       backward within PREPROCESS_GRAD_TOL of autograd's largest gradient
       and its elements counted against the plain twin
       (`projection.preprocess_backward_plain`), one launch of each.
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
     assume. Last, the tile cover on a 3 M-Gaussian scene drawn like the
     benchmark's 3dgs-m360 at 1237x822 from two ring angles, equal to the
     chain as in phase 2, then timed (CUDA events over 20 launches) beside
     its byte bound and the chain's time. The emission on that scene and on
     the 4K cell's (6.1 M Gaussians drawn by `perfbench/surface.py` from
     its configuration, 3840x2160, ring angle 0), uncut and cut inside a
     Gaussian, equal to the plain emission as in phase 2, then timed beside
     its byte bound and the plain emission's time, the 32-bit sort beside
     the int64 one it replaced, and `bin_splats` run under
     `torch.cuda.set_sync_debug_mode("warn")`: one synchronise (the host
     read of the total), else the run fails. And the preprocess kernels as in
     phase 2 on a 1.02 M-Gaussian SH-2 scene (lg-m360's size) and that 3 M
     SH-3 one from two ring angles, then timed at 3 M beside their byte
     bounds, the chain's forward and forward + backward, and the twin.
  4. Training at full width: the same scene rendered exactly from the 8
     views is the ground truth; a copy with seeded noise on colour, opacity
     and position trains against it for 24 steps of `make_train_step` (the
     cached-target SSIM; instance capacity 983,040), cycling the views. The
     launch counts are read around the steps (B1, B2, B3, B4, the cover and
     the preprocess forward and backward once a step) and around `make_eval_render` (B1 and B7 once a view), whose mean
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
  8. The live viewer, camera-batched training and the multi-device paths at
     full width on phases 4 to 7, each path with its launch counts read
     around it: a viewer client on a localhost socket asks `NetworkGUI.poll`
     for phase 5's model from its first train view at scales 1.0 and 0.5
     and once at zero resolution (B6 2; both frames byte for byte
     `image_to_bytes` of `render(..., fast=True)`, the verify string the
     source path); `make_train_step(camera_batch=4)` on phase 4's start
     (B1, B2, B3 and B4 4 each; Adam's first moment against the mean of the
     four single steps' by B2's rules, the parameters against one Adam
     update on that mean where the gradient is strong, denom and
     max_radii2d their sum and maximum), timed against four single steps;
     `cli.train_densify_prune --camera_batch 4` for 16 iterations on phase
     5's source with the viewer on at a free port and a client served
     through it (B1 64 + 26 evaluated views, B2 and B3 64, B4 64 + 8, B7 26,
     B6 1; the test L1 falls); and, in torch.cuda.device_count() processes
     under NCCL (one card each, a FileStore in the phase's directory; a
     failed rank fails the phase), `parallel_render` of the 8 serving views
     (B6 8; bit for bit `render(fast=True)` on one card, 1e-5 on more),
     `make_parallel_train_step` and `make_gauss_train_step` at mesh
     (world, 1) (B1, B2, B3 and B4 once each; against `make_train_step` by
     B2's rules), `accumulate_gss_sharded` over the 8 views (B5 8 over the
     ranks; against `accumulate_gss` at phase 3's full-size limits) and
     `vectree.quantize_features` with a mesh on phase 7's distilled model
     (200 iterations of the CLI's codebook and chunk; SH error under a
     quarter of a random codebook's), each timed beside its single-device
     counterpart.
  9. The end-to-end harness (`lightgaussian_tpu_torch/scripts/`) at full
     width, each path with its launch counts read around it:
     `e2e_hard.run` at the hard1080 width (1240x824, a 150,000-Gaussian
     target, 56 train and 8 test views, codebook 8192, evaluator cut
     4,194,304), cut in depth (E2E_CUT: 300 training iterations with
     densification from 100 every 50 until 250 instead of 15,000 until
     9,000; finetunes of 60 and, short, 30 instead of 5,000 and 2,500; 60
     of distillation instead of 5,000; a VQ fit of 300 iterations instead
     of 1,000): all eleven rows through the CLIs, each stage's launches
     against what its preset implies (`e2e_stage_launches`); each prune
     keeps 40% of the trained count to the rounding, the control all of
     it; rows [3] and [4] carry 24 f_rest fields; the bundle of [7] loads
     and scores above PSNR([4]) - 1 dB; the test L1 of the trained model
     lies under the point-cloud start's; no evaluated view reaches the cut
     (the evaluator raises). The eight criteria are printed, not gated: at
     this depth the SH degree never rises past 0, so truncation and
     distillation cost and recover nothing. Then `bench_render_fps` at its
     defaults (300k Gaussians, 1920x1080, 48 frames, step 2 pi/600) and at
     step 2 pi/BENCH_FINE_STEP_DIV, a slow trajectory (B1 1, B6 one a rendered
     frame; every reused frame above 45 dB against its fresh render, but
     those of the fixed rebin-8 schedule at the default step, where splats
     drift 2-14 px a frame: that worst frame is printed),
     and `roofline` (the probe, a 1 GiB `copy_` and the row
     gathers, 23 training steps split at their stage marks beside their
     byte floors; the measured stream may not exceed 1.05 x PEAK_BYTES).
     First, `ops.sh.rgb_to_sh` of the 256 8-bit levels on the card equals
     the CPU's bit for bit (e2e_hard's point cloud is black: one ulp lower,
     its colours sit under the clamp and it never trains).
  10. The measurement layer (`lightgaussian_tpu_torch/scripts/`) at full
     width, each path with its launch counts read around it: `bench` at its
     defaults (300,000 Gaussians SH 3, 1920x1080, cut 983,040; 1 + 3 + 5 x
     10 steps: B1, B2 and B3 54 each, B4 55 with the target's moments) and
     at `--batch 2 --repeats 3 --iters 3` (B1-B3 26, B4 27), its JSON line
     printed and its value held to the pixels over the median step; the
     bench step's gradients against the same loss through the plain
     versions of B1-B4, the cover, the emission and the preprocess on the
     card, by B2's rules (B2_TOL,
     B2_MEDIAN_REL_TOL); `profile_binning` at the dense cell's size (3 M
     Gaussians at 1237x822, uncut: the pieces of `bin_splats` composed in
     order give its outputs bit for bit, and their times sum to 0.7-1.5x
     the whole); `profile_binning_infer` at both points (the same
     bit-equality; at `--large` its fresh frame within 1.5x of phase 3's
     serving frame, the two timed in turns); `profile_bwd` (its B2 seed bit-equal to what the
     autograd blend hands B2 for the same cotangent); and last
     `profile_step` (its pieces, and a `torch.profiler` trace of 5 bench
     steps read through by `harness.trace_summary`: each hand-written
     kernel's launches in the trace equal the counters', the busy time
     lies within the trace's window; the top ops and longest gaps printed). The trace runs
     last: in a process after a profiler session the host runs ops more
     slowly. First, `sh_dc_to_rgb` of the 256 levels'
     DC values on the card equals the CPU's bit for bit.
  11. A frame past the JAX package's 2^24 instances (BIG_FRAME: 2,000,000
     Gaussians at 3840x2160, about 20 M live instances, a sixth from the
     >32-tile fallback) binned at the default cut (`build_binning`): every
     live instance kept, none counted cut (`binning.INSTANCES`); on it the
     render-only blend (B6) and the exact blend (B1) against their plain
     versions (KERNEL_TOL), the blend backward (B2) per Gaussian against the
     plain per-instance gradients summed by `gid_sorted` (B2's rules), and
     the counting blend (B5) as in phase 2 at full size; then
     `api.render(fast=True)` with no cut reports the same live count, none
     cut, and B6's image within KERNEL_TOL.
Launches are read from the kernel table's counters, one for each of the
thirteen counted kernels (`cuda_build.launch_counts`).
From phase 3 on, every binning launches the tile cover and the emission
once each: a path's expected launches hold one `bin_cover` and one
`bin_emit` a render (a B1, B6 or B5 launch), and the paths that bin
otherwise (cached trajectory frames, the binning profiler, the FPS study,
the roofline tool) give their own count, the emission's the cover's. So with
the preprocess kernels: one `preprocess_forward` a render and one
`preprocess_backward` a blend backward (B2), and the paths that preprocess
otherwise (a keyframe's binning, the profilers' preprocess alone) give
theirs. Each
phase ends with its own seconds. Then a `{"kernels": [...]}` line of the
thirteen kernels, the card line, and the final `{"ok": true, "device": {...}}`
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

import contextlib
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
CLI_VIEWER_TO = 150  # the viewer-on and viewer-off runs resume from CLI_RESUME_TO to here
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
# Phase 8, on phases 4 to 7: the live viewer, camera-batched training and the multi-device paths.
VIEWER_SCALES = (1.0, 0.5)  # the scaling_modifier of the two frames asked of the viewer's poll
CAMERA_BATCH = 4
BATCH_STEP_REPS = 3  # the batched step and four single steps, in turns
BATCH_CLI_ITERATIONS = 16
BATCH_CLI_TEST_AT = (1, 16)
VQ8_ITERATIONS = 200  # the sharded fit's, at the CLI's codebook and chunk
MULTI_TOL = 1e-5  # the strip renderer against render(fast=True) on more than one card (the JAX suite's)
# Phase 9: the end-to-end harness. e2e_hard at the hard1080 width, cut in depth (15,000 training iterations,
# finetunes of 5,000 and 2,500, 5,000 of distillation and a 1,000-iteration fit at full depth).
E2E_PRESET = "hard1080"
E2E_CUT = dict(train_iters=300, densify_from=100, densification_interval=50, densify_until=250, ft_iters=60,
               ft_short=30, distill_iters=60, vq_fit_iters=300)
STREAM_SLACK = 1.05  # a measured stream above this share of PEAK_BYTES would make the byte bounds no bounds
# bench_render_fps at its defaults (300k Gaussians, 1920x1080, 48 frames, step 2 pi/600), where splats drift 2-14
# px a frame and the drift gate rebins every frame, and at step 2 pi/BENCH_FINE_STEP_DIV, where it reuses frames
# (at 2 pi/4000 it still rebinned all 48).
BENCH_FINE_STEP_DIV = 20000
# Phase 10, the measurement layer: the bench's batched run, the binning split's sum against the whole, and the
# profiler's fresh frame against phase 3's serving frame, timed in turns.
BENCH_BATCH_ARGS = ("--batch", "2", "--repeats", "3", "--iters", "3")
PIECES_RATIO = (0.7, 1.5)  # sum of the binning pieces over the whole; outside it the split misses or repeats work
# The binning profiler at the dense cell's size (3dgs-m360: 3 M Gaussians at 1237x822), uncut, where the binning's
# device work sets its time. At the profiler's own 300k at 1920x1080 the binning is about 0.4 ms of device work, and
# the host's launches after its one synchronise show in the whole's time but not in the pieces' timed back to back
# (their sum read 0.669x the whole on an H100 80GB HBM3 at 700 W).
PROFILE_BINNING_ARGS = ("--gaussians", "3000000", "--width", "1237", "--height", "822", "--cut", "0")
FRESH_VS_SERVING = 1.5
FRESH_GROUPS, FRESH_REPS = 5, 10  # the two frames' groups, taken in turns, and each group's calls
# The tile cover (csrc/bin_cover.cu) against the torch chain: each kind of `synthetic.COVER_STRESS_KINDS` at the
# benchmark's 1237x822, and a scene drawn like perfbench/configs/3dgs-m360.json's (3 M Gaussians, means in a cube
# of half-width 2, log-scales uniform in [log 0.004, log 0.02], SH 3) seen from its ring (eye (5 sin t, 0.6,
# -5 cos t), fovx 0.9).
COVER_SIZE = (1237, 822)
COVER_STRESS_N = 65_536
COVER_SCENE_N = 3_000_000
COVER_BYTES = 28 + 40  # a Gaussian's mean, conic, opacity and radius in; five int64 out
COVER_TARGET_MS = 0.15
# The instance emission (csrc/bin_cover.cu, `lg_bin_emit`) against the plain emission: the stress set as the cover's,
# with and without a cut, every Gaussian on the >32-tile fallback and all depths equal; the 3 M scene above; and the
# benchmark's 4K scene (perfbench/configs/3dgs-bicycle-4k.json, drawn by perfbench/surface.py, ring angle 0). Its
# bytes: a Gaussian's cover, prefix sum and depth read once; a slot's int32 key and int64 id written once.
EMIT_GAUSSIAN_BYTES = 40 + 8 + 4
EMIT_SLOT_BYTES = 4 + 8
BICYCLE_CONFIG = REPO / "perfbench" / "configs" / "3dgs-bicycle-4k.json"
BICYCLE_SEED = 2024
# The preprocess kernels (csrc/preprocess.cu) against the chain: the stress set at 1237x822, and scenes drawn like
# 3dgs-m360's (3 M, SH 3) and lg-m360's (1.02 M, SH 2). The backward against autograd of the chain: the JAX
# suite's gradient tolerance, after dividing by autograd's largest magnitude (the chain rule's terms are added in
# another order).
PREPROCESS_STRESS_N = 65_536
PREPROCESS_SMALL_N = 1_020_000
PREPROCESS_GRAD_TOL = 5e-5
# A render bins once for its one blend (B1, B6 or B5); B2 blends over its step's binning.
RENDER_BLENDS = ("blend_forward", "blend_forward_fast", "blend_count")
# Phase 11's frame of more than 2^24 live instances (the JAX package's ceiling).
BIG_FRAME = dict(n=2_000_000, width=3840, height=2160, extent=2.0, scale_range=(0.008, 0.03), seed=23)
JAX_CEILING = 1 << 24


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
    """Build every source of the kernel table at once and load each."""
    from lightgaussian_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    libs = cuda_build.build(*cuda_build.SOURCES)
    for source in cuda_build.SOURCES:
        cuda_build.load(source)
    s.say(f"phase 1 ok: built {', '.join(p.name for p in libs)} in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        print(f"-- {lib.with_suffix('.log').name}")
        print(lib.with_suffix(".log").read_text().strip())


def reset_counts() -> None:
    """Zero the kernel table's launch counters and binning's instance counters."""
    from lightgaussian_tpu_torch.ops.rasterize import binning
    from lightgaussian_tpu_torch.utils import cuda_build

    cuda_build.reset_launch_counts()
    binning.reset_instances()


def read_counts() -> dict:
    from lightgaussian_tpu_torch.utils import cuda_build

    return cuda_build.launch_counts()


def expected(counts: dict, want: dict) -> dict:
    """`want` over the keys of `counts`, 0 where it names none, with the
    cover kernel's, the emission kernel's and the preprocess kernels'
    launches: by default one binning and one preprocess forward a render
    (RENDER_BLENDS) and one preprocess backward a blend backward (B2); a
    path that bins or preprocesses otherwise names them. A binning launches
    the cover and the emission once each, so the emission's launches are
    the cover's unless the path names them."""
    renders = sum(want.get(k, 0) for k in RENDER_BLENDS)
    want = {"bin_cover": renders, "preprocess_forward": renders,
            "preprocess_backward": want.get("blend_backward", 0), **want}
    want.setdefault("bin_emit", want["bin_cover"])
    return {k: want.get(k, 0) for k in counts}


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
    hold_cover_stress(s)
    hold_emit_stress(s)
    hold_preprocess_stress(s)

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


def hold_cover(s: Smoke, splats, grid, what: str) -> dict:
    """The cover kernel (`binning._cover` on the card) against the torch
    chain (`binning.plain_cover`, on the card too): count and mask equal on
    every Gaussian, the rect's lo_x, lo_y and hi_x where the count is
    positive (nothing reads them elsewhere; the chain casts NaN there).
    Returns a census of the splats."""
    from lightgaussian_tpu_torch.ops.rasterize import binning

    torch = s.torch
    launched = read_counts()["bin_cover"]
    got = binning._cover(splats, grid)
    s.sync()
    if read_counts()["bin_cover"] != launched + 1:
        fail(f"the cover on {what} did not launch its kernel once")
    want = binning.plain_cover(splats, grid)
    live = want.count > 0
    bad = {f: int((getattr(got, f) != getattr(want, f)).sum()) for f in ("count", "mask")}
    bad.update({f: int((getattr(got, f) != getattr(want, f))[live].sum()) for f in ("lo_x", "lo_y", "hi_x")})
    census = {"gaussians": int(live.numel()), "live": int(live.sum()), "instances": int(want.count.sum()),
              "over_32_tiles": int(((want.mask == 0) & live).sum())}
    s.say(f"  bin_cover vs the torch chain on {what}: {census}; differing count, mask (all) and lo_x, lo_y, hi_x "
          f"(live): {bad}")
    if any(bad.values()) or any(getattr(got, f).dtype != torch.int64 for f in got._fields):
        fail(f"the cover kernel differs from the torch chain on {what}")
    return census


def hold_cover_stress(s: Smoke) -> None:
    """The cover kernel bit for bit against the chain on every kind of the
    stress set, and on the whole set as strided views of one packed array."""
    from lightgaussian_tpu_torch.ops.rasterize import binning
    from lightgaussian_tpu_torch.ops.rasterize.projection import Splats
    from lightgaussian_tpu_torch.utils import synthetic

    torch = s.torch
    grid = binning.make_grid(*COVER_SIZE)
    parts = []
    for i, kind in enumerate(synthetic.COVER_STRESS_KINDS):
        splats = synthetic.cover_stress_splats(kind, COVER_STRESS_N, *COVER_SIZE, seed=20 + i, device=s.dev)
        hold_cover(s, splats, grid, f"the {kind} stress set ({COVER_STRESS_N} at {COVER_SIZE[0]}x{COVER_SIZE[1]})")
        parts.append(splats)
    packed = torch.cat([torch.cat([p.mean2d, p.conic, p.opacity[:, None]], 1) for p in parts])
    radius = torch.cat([p.radius for p in parts])
    views = Splats(mean2d=packed[:, 0:2], conic=packed[:, 2:5], color=torch.cat([p.color for p in parts]),
                   opacity=packed[:, 5], depth=torch.cat([p.depth for p in parts]), radius=radius)
    hold_cover(s, views, grid, "the whole stress set as column views of one [N, 6] array")


def time_cover(s: Smoke) -> None:
    """The cover kernel at the benchmark's size: bit for bit against the
    chain on a 3 M-Gaussian scene drawn like 3dgs-m360's, then its time
    beside its byte bound and the chain's time; then the emission on that
    scene and on the 4K cell's (`time_emit`)."""
    from lightgaussian_tpu_torch.models.camera import Camera
    from lightgaussian_tpu_torch.ops.rasterize import binning
    from lightgaussian_tpu_torch.ops.rasterize.projection import preprocess
    from lightgaussian_tpu_torch.utils.synthetic import random_scene

    torch = s.torch
    scene = random_scene(n=COVER_SCENE_N, seed=17, extent=2.0, scale_range=(0.004, 0.02), active_sh_degree=3,
                         device=s.dev)
    grid = binning.make_grid(*COVER_SIZE)
    for t in (0.0, 2.0):
        cam = Camera.look_at(orbit_eye(t), [0, 0, 0], fovx=0.9, width=COVER_SIZE[0], height=COVER_SIZE[1],
                             device=s.dev)
        with torch.no_grad():
            splats = preprocess(scene, cam)
        census = hold_cover(s, splats, grid, f"the 3 M scene from ring angle {t} at {COVER_SIZE[0]}x{COVER_SIZE[1]}")
    del scene
    k_ms = s.event_ms(lambda: binning._cover(splats, grid))
    plain_ms = s.host_ms(lambda: binning.plain_cover(splats, grid))
    n_bytes = COVER_BYTES * COVER_SCENE_N
    bound = s.row("bin_cover", "bin_cover.cu", "none: tile_rect + _exact_tile_mask of "
                  "lightgaussian_tpu/ops/rasterize/binning.py are XLA ops", 0.0, k_ms, plain_ms, 0.0,
                  n_bytes / PEAK_BYTES, None)
    s.say(f"  bin_cover at 3 M Gaussians, {COVER_SIZE[0]}x{COVER_SIZE[1]} ({census['live']} live, "
          f"{census['instances']} instances): {k_ms:.4f} ms/launch (CUDA events, {TIMING_REPS} launches; target "
          f"{COVER_TARGET_MS} ms), bound {bound:.4f} ms ({n_bytes / 1e6:.0f} MB at {PEAK_BYTES / 1e12:.2f} TB/s, "
          f"{n_bytes / k_ms / 1e6:.0f} GB/s achieved), the torch chain {plain_ms:.3f} ms (host, median of "
          f"{PLAIN_REPS}); no PyTorch call computes a tile cover, library_ms null")
    time_emit(s, splats, grid, COVER_SCENE_N, f"the 3 M scene at {COVER_SIZE[0]}x{COVER_SIZE[1]}", row=True)
    del splats
    splats, grid, n = bicycle_splats(s)
    time_emit(s, splats, grid, n, f"the 4K cell's scene ({grid.width}x{grid.height})", row=False)


def hold_emit(s: Smoke, cover, cum, depth, total: int, m: int, grid, what: str) -> dict:
    """The emission kernel (`binning._emit` on the card, one launch of its
    row) against the plain emission (`binning.plain_emit`, on the card too):
    every slot's key and Gaussian equal. Returns a census of the slots."""
    from lightgaussian_tpu_torch.ops.rasterize import binning

    torch = s.torch
    launched = read_counts()["bin_emit"]
    key, gid = binning._emit(cover, cum, depth, total, m, grid)
    s.sync()
    if read_counts()["bin_emit"] != launched + 1:
        fail(f"the emission on {what} did not launch its kernel once")
    w_key, w_gid = binning.plain_emit(cover, cum, depth, total, m, grid)
    bad = {"key": int((key != w_key).sum()), "gid": int((gid != w_gid).sum())}
    census = {"slots": m, "live": total, "cut": total - m,
              "fallback": int(torch.where(cover.mask == 0, cover.count, 0).sum()),
              "top_bit": int((key >= 0).sum())}  # the flipped key is >= 0 where the key's top bit is set
    s.say(f"  bin_emit vs the plain emission on {what}: {census}; differing keys and Gaussians: {bad}")
    if any(bad.values()) or key.dtype != torch.int32 or gid.dtype != torch.int64:
        fail(f"the emission kernel differs from the plain emission on {what}")
    return census


def emit_inputs(s: Smoke, splats, grid):
    """The cover (the kernel's), its prefix sum and the live total."""
    from lightgaussian_tpu_torch.ops.rasterize import binning

    cover = binning._cover(splats, grid)
    cum, total, _fallback = binning._instance_total(cover.count)
    return cover, cum, total


def split_cut(cover, cum) -> int:
    """A cut one slot into the middle Gaussian of at least two instances."""
    many = (cover.count >= 2).nonzero().flatten()
    g = int(many[len(many) // 2])
    return int(cum[g] - cover.count[g]) + 1


def hold_emit_stress(s: Smoke) -> None:
    """The emission kernel bit for bit against the plain emission on every
    kind of the stress set: uncut, cut inside a Gaussian's instances, every
    Gaussian on the fallback, all depths equal."""
    from lightgaussian_tpu_torch.ops.rasterize import binning
    from lightgaussian_tpu_torch.utils import synthetic

    torch = s.torch
    grid = binning.make_grid(*COVER_SIZE)
    for i, kind in enumerate(synthetic.COVER_STRESS_KINDS):
        splats = synthetic.cover_stress_splats(kind, COVER_STRESS_N, *COVER_SIZE, seed=20 + i, device=s.dev)
        cover, cum, total = emit_inputs(s, splats, grid)
        what = f"the {kind} stress set"
        if total == 0:
            s.say(f"  bin_emit: {what} has no live instance; bin_splats emits nothing")
            continue
        hold_emit(s, cover, cum, splats.depth, total, total, grid, what)
        hold_emit(s, cover, cum, splats.depth, total, split_cut(cover, cum), grid, f"{what}, cut inside a Gaussian")
        lo_x, lo_y, hi_x, _hi_y, rect = binning.tile_rect(splats.mean2d, splats.radius, grid, conic=splats.conic,
                                                          opacity=splats.opacity)
        fb = binning.TileCover(lo_x, lo_y, hi_x, torch.zeros_like(rect), rect)
        fb_cum, fb_total, _ = binning._instance_total(rect)
        hold_emit(s, fb, fb_cum, splats.depth, fb_total, fb_total, grid, f"{what}, every Gaussian on the fallback")
        flat = torch.full_like(splats.depth, 4.0)
        hold_emit(s, cover, cum, flat, total, total, grid, f"{what}, all depths equal")


def bicycle_splats(s: Smoke):
    """The 4K cell's scene and first frame: (splats, grid, Gaussians)."""
    from lightgaussian_tpu_torch.ops.rasterize import binning
    from lightgaussian_tpu_torch.ops.rasterize.projection import preprocess
    from perfbench import inputs, port, surface

    torch = s.torch
    cfg = json.loads(BICYCLE_CONFIG.read_text())
    p = inputs.truncate_sh(surface.gaussians(cfg, BICYCLE_SEED, s.dev), cfg["sh_degree"])
    scene = port.scene(p, cfg["sh_degree"])
    cam = port.camera(inputs.ring_eye(cfg, 0.0), np.zeros(3), cfg, s.dev)
    with torch.no_grad():
        splats = preprocess(scene, cam)
    return splats, binning.make_grid(cfg["width"], cfg["height"]), cfg["num_gaussians"]


def time_emit(s: Smoke, splats, grid, n: int, what: str, row: bool) -> None:
    """The emission at a benchmark size: bit for bit against the plain
    emission uncut and cut inside a Gaussian, then its time (CUDA events,
    both launches) beside its byte bound and the plain emission's time; the
    32-bit sort beside the int64 sort it replaced; and the binning's host
    synchronises, read with `torch.cuda.set_sync_debug_mode("warn")`."""
    import warnings

    from lightgaussian_tpu_torch.ops.rasterize import binning

    torch = s.torch
    cover, cum, total = emit_inputs(s, splats, grid)
    census = hold_emit(s, cover, cum, splats.depth, total, total, grid, what)
    hold_emit(s, cover, cum, splats.depth, total, split_cut(cover, cum), grid, f"{what}, cut inside a Gaussian")
    k_ms = s.event_ms(lambda: binning._emit(cover, cum, splats.depth, total, total, grid))
    plain_ms = s.host_ms(lambda: binning.plain_emit(cover, cum, splats.depth, total, total, grid))
    n_bytes = EMIT_GAUSSIAN_BYTES * n + EMIT_SLOT_BYTES * total
    bound = n_bytes / PEAK_BYTES
    if row:
        s.row("bin_emit", "bin_cover.cu", "none: the slot fill and depth key of "
              "lightgaussian_tpu/ops/rasterize/binning.py are XLA ops", 0.0, k_ms, plain_ms, 0.0, bound, None)
    elif k_ms < 1e3 * bound:
        fail(f"bin_emit was timed at {k_ms:.4f} ms on {what}, under its bound of {1e3 * bound:.4f} ms")
    key, gid = binning._emit(cover, cum, splats.depth, total, total, grid)
    key64 = key.to(torch.int64) + (1 << 31)
    sort32_ms = s.event_ms(lambda: binning._sort_instances(key, gid))
    sort64_ms = s.event_ms(lambda: binning._sort_instances(key64, gid))
    s.say(f"  bin_emit on {what} ({n} Gaussians, {census['live']} slots, {census['fallback']} from the fallback): "
          f"{k_ms:.4f} ms a call (CUDA events, {TIMING_REPS} calls of two launches), bound {1e3 * bound:.4f} ms "
          f"({n_bytes / 1e6:.0f} MB at {PEAK_BYTES / 1e12:.2f} TB/s, {n_bytes / k_ms / 1e6:.0f} GB/s achieved), the "
          f"plain emission {plain_ms:.3f} ms (host, median of {PLAIN_REPS}); the sort and gather of the 32-bit keys "
          f"{sort32_ms:.4f} ms, of the same keys in int64 {sort64_ms:.4f} ms")
    del key, gid, key64
    syncs = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            binning.bin_splats(splats, grid, binning.MAX_CAPACITY)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs = [str(w.message).splitlines()[0] for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message)]
    s.sync()
    s.say(f"  bin_splats on {what} under set_sync_debug_mode('warn'): {len(syncs)} synchronising call(s) {syncs}")
    if len(syncs) != 1:
        fail(f"bin_splats on {what} synchronised {len(syncs)} times, not once (the host read of the total)")


def _bits_differ(a, b) -> int:
    """Elements of two same-shaped tensors whose bits differ (NaNs of one
    pattern equal)."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def hold_preprocess(s: Smoke, scene, cam, what: str, offset=None, colors=None, cov3d=None, scale_modifier=1.0,
                    frozen=(), seed=0) -> dict:
    """The preprocess kernels against the chain on the card: the forward's
    six outputs bit for bit (differing elements counted per output), the
    backward's gradients within PREPROCESS_GRAD_TOL of the largest magnitude
    of autograd's through the chain, and against the plain twin
    (`preprocess_backward_plain`, on the card too). The launch counters
    read one forward and one backward. Returns the readings: the forward's
    differing counts (`differ`) and largest |difference| over its float
    outputs (`forward_abs`), and the backward's largest |difference| from
    autograd over the gradients (`backward_abs`) and largest after dividing
    by each gradient's largest magnitude (`backward_normalised`)."""
    from lightgaussian_tpu_torch.ops.rasterize import projection

    torch = s.torch
    fields = ("mean2d", "conic", "color", "opacity", "depth", "radius")
    params = {k: v.detach().clone().requires_grad_(k not in frozen) for k, v in scene.params().items()}
    extra = {name: t.detach().clone().requires_grad_(True) for name, t in
             (("mean2d_offset", offset), ("colors_precomp", colors), ("cov3d_precomp", cov3d)) if t is not None}
    args = (extra.get("mean2d_offset"), extra.get("colors_precomp"), extra.get("cov3d_precomp"))
    live = scene.with_params(params)
    before = {k: read_counts()[k] for k in ("preprocess_forward", "preprocess_backward")}
    got = projection.preprocess(live, cam, scale_modifier, *args)
    s.sync()
    want = projection.plain_preprocess(live, cam, scale_modifier, *args)
    differ = {f: _bits_differ(getattr(got, f), getattr(want, f)) for f in fields}
    # equal elements (infinite depths too) differ by 0; a NaN on one side only reads NaN
    forward_abs = max(float(torch.where(a == b, 0.0, (a - b).abs()).max()) for a, b in
                      ((getattr(got, f).detach(), getattr(want, f).detach()) for f in fields[:5]))
    gen = torch.Generator(device=s.dev).manual_seed(seed)
    up = [torch.randn(getattr(want, f).shape, generator=gen, device=s.dev) for f in fields[:4]]
    leaves = {k: v for k, v in {**params, **extra}.items() if v.requires_grad}
    # the outputs the leaves reach in the chain (a frozen opacity's reaches none), and their gradients
    outs = [i for i, f in enumerate(fields[:4]) if getattr(want, f).requires_grad]
    g_got = torch.autograd.grad([getattr(got, fields[i]) for i in outs], list(leaves.values()),
                                [up[i] for i in outs], allow_unused=True)
    s.sync()
    counted = {k: read_counts()[k] - before[k] for k in before}
    g_want = torch.autograd.grad([getattr(want, fields[i]) for i in outs], list(leaves.values()),
                                 [up[i] for i in outs], allow_unused=True)
    up = [u if i in outs else torch.zeros_like(u) for i, u in enumerate(up)]
    twin = projection.preprocess_backward_plain(scene, cam, *up, scale_modifier=scale_modifier,
                                                mean2d_offset=offset, colors_precomp=colors, cov3d_precomp=cov3d)
    err, err_abs, twin_differ = {}, {}, {}
    for k, a, b in zip(leaves, g_got, g_want):
        if a is None or b is None:
            if not (a is None and (b is None or not b.any())):
                fail(f"the preprocess backward on {what}: {k} is {a is None and 'None' or 'given'}, autograd's "
                     f"{b is None and 'None' or 'given'}")
            continue
        scale = float(b.abs().max())
        err_abs[k] = float((a - b).abs().max())
        err[k] = err_abs[k] / scale if scale > 0 else float(a.abs().max())
        twin_differ[k] = _bits_differ(a, twin[k])
    census = {"gaussians": scene.capacity, "valid": int((want.radius > 0).sum()), "colour clamped": int(
        (want.color == 0).sum())}
    s.say(f"  preprocess kernels vs the chain on {what}: {census}; forward differing elements {differ}; backward "
          f"max|d|/max|autograd| {{{', '.join(f'{k}: {v:.2e}' for k, v in err.items())}}} (tol "
          f"{PREPROCESS_GRAD_TOL:.0e}), elements differing from the plain twin {twin_differ}; launches {counted}")
    if counted != {"preprocess_forward": 1, "preprocess_backward": 1}:
        fail(f"the preprocess on {what} launched {counted}, expected one forward and one backward")
    if any(differ.values()):
        fail(f"the preprocess forward kernel differs from the chain on {what}: {differ}")
    if any(v > PREPROCESS_GRAD_TOL or v != v for v in err.values()):
        fail(f"the preprocess backward kernel disagrees with autograd of the chain on {what}")
    return {"differ": differ, "forward_abs": forward_abs, "backward_abs": max(err_abs.values(), default=0.0),
            "backward_normalised": max(err.values(), default=0.0)}


def hold_preprocess_stress(s: Smoke) -> None:
    """The preprocess kernels on the stress set (`synthetic.preprocess_stress`)
    at the benchmark's size, at every SH degree, with the offset, precomputed
    colours and covariances, a scale modifier, frozen fields and sh_rest as a
    view of wider rows (the distillation student's)."""
    import dataclasses as dc

    from lightgaussian_tpu_torch.utils import synthetic

    torch = s.torch
    n = PREPROCESS_STRESS_N
    for degree in range(5):
        scene, cam, cov6, _kind = synthetic.preprocess_stress(n, *COVER_SIZE, seed=40 + degree, max_sh_degree=4,
                                                              active_sh_degree=degree, device=s.dev)
        offset = torch.zeros((n, 2), device=s.dev)
        hold_preprocess(s, scene, cam, f"the stress set at SH {degree} of 4 (offset)", offset=offset, seed=degree)
    scene, cam, cov6, _kind = synthetic.preprocess_stress(n, *COVER_SIZE, seed=50, device=s.dev)
    colors = torch.rand((n, 3), generator=torch.Generator(device=s.dev).manual_seed(1), device=s.dev)
    hold_preprocess(s, scene, cam, "the stress set with precomputed colours, scale modifier 0.8", colors=colors,
                    scale_modifier=0.8, seed=5)
    hold_preprocess(s, scene, cam, "the stress set with precomputed covariances (half with det <= 0)", cov3d=cov6,
                    seed=6)
    wide = torch.cat([scene.sh_rest, torch.ones((n, 7, 3), device=s.dev)], dim=1)
    student = dc.replace(scene, sh_rest=wide[:, :8], active_sh_degree=2, max_sh_degree=2)
    hold_preprocess(s, student, cam, "the stress set at SH 2 over a view of wider sh_rest rows, opacity frozen",
                    offset=torch.zeros((n, 2), device=s.dev), frozen=("opacity_logits",), seed=7)


def _preprocess_bytes(n: int, k: int, offset: bool) -> tuple[int, int]:
    """Least bytes of the forward and the backward: each input read once
    and each output written once (PERF.md's table)."""
    inputs = 12 + 12 + 16 + 4 + 12 + 12 * k + 1 + (8 if offset else 0)
    outputs = 8 + 12 + 12 + 4 + 4 + 4
    grads = 12 + 12 + 16 + 4 + 12 + 12 * k + (8 if offset else 0)
    return n * (inputs + outputs), n * (inputs + 36 + grads)


def time_preprocess(s: Smoke) -> None:
    """The preprocess kernels at the benchmark's sizes: bit for bit (forward)
    and within tolerance (backward) against the chain on a 3 M-Gaussian SH-3
    scene drawn like 3dgs-m360's from two ring angles at 1237x822 and on a
    1.02 M SH-2 one like lg-m360's; then their times beside their byte
    bounds, the chain's forward and forward + backward, and the twin's."""
    from lightgaussian_tpu_torch.models.camera import Camera
    from lightgaussian_tpu_torch.ops.rasterize import projection
    from lightgaussian_tpu_torch.utils.synthetic import random_scene

    torch = s.torch
    held = []
    for n, degree, seed in ((PREPROCESS_SMALL_N, 2, 19), (COVER_SCENE_N, 3, 17)):
        scene = random_scene(n=n, seed=seed, extent=2.0, scale_range=(0.004, 0.02), max_sh_degree=degree,
                             device=s.dev)
        offset = torch.zeros((n, 2), device=s.dev)
        for t in (0.0, 2.0):
            cam = Camera.look_at(orbit_eye(t), [0, 0, 0], fovx=0.9, width=COVER_SIZE[0], height=COVER_SIZE[1],
                                 device=s.dev)
            held.append(hold_preprocess(s, scene, cam, f"{n} Gaussians at SH {degree} from ring angle {t} at "
                                        f"{COVER_SIZE[0]}x{COVER_SIZE[1]} (offset)", offset=offset, seed=int(t)))
    # times at 3 M, SH 3, as the training step runs it (offset given, every parameter differentiated)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in scene.params().items()}
    off = offset.clone().requires_grad_(True)
    live = scene.with_params(params)
    leaves = [*params.values(), off]
    with torch.no_grad():
        fwd_ms = s.event_ms(lambda: projection.preprocess(live, cam, mean2d_offset=off))
    out = projection.preprocess(live, cam, mean2d_offset=off)
    up = [torch.randn_like(t) for t in (out.mean2d, out.conic, out.color, out.opacity)]
    outs = [out.mean2d, out.conic, out.color, out.opacity]
    bwd_ms = s.event_ms(lambda: torch.autograd.grad(outs, leaves, up, retain_graph=True))
    chain_ms = s.host_ms(lambda: projection.plain_preprocess(live, cam, mean2d_offset=off))

    def chain_both():
        o = projection.plain_preprocess(live, cam, mean2d_offset=off)
        torch.autograd.grad([o.mean2d, o.conic, o.color, o.opacity], leaves, up)

    chain_both_ms = s.host_ms(chain_both)
    twin_ms = s.host_ms(lambda: projection.preprocess_backward_plain(scene, cam, *up, mean2d_offset=offset))
    f_bytes, b_bytes = _preprocess_bytes(COVER_SCENE_N, scene.sh_rest.shape[1], True)
    replaces = "none: the preprocess of lightgaussian_tpu/ops/rasterize/projection.py is XLA ops"
    # the errors are the largest of the holds above, at both sizes and both angles
    f_bound = s.row("preprocess_forward", "preprocess.cu", replaces, max(h["forward_abs"] for h in held), fwd_ms,
                    chain_ms, 0.0, f_bytes / PEAK_BYTES, None)
    b_bound = s.row("preprocess_backward", "preprocess.cu", replaces, max(h["backward_abs"] for h in held), bwd_ms,
                    chain_both_ms - chain_ms, 0.0, b_bytes / PEAK_BYTES, None)
    # the number held against PREPROCESS_GRAD_TOL
    s.rows["preprocess_backward"]["max_err_normalised"] = max(h["backward_normalised"] for h in held)
    s.say(f"  preprocess_forward at 3 M Gaussians, SH 3, {COVER_SIZE[0]}x{COVER_SIZE[1]}: {fwd_ms:.4f} ms/launch "
          f"(CUDA events, {TIMING_REPS} launches), bound {f_bound:.4f} ms ({f_bytes / 1e6:.0f} MB at "
          f"{PEAK_BYTES / 1e12:.2f} TB/s, {f_bytes / fwd_ms / 1e6:.0f} GB/s achieved); the chain {chain_ms:.3f} ms "
          f"(host, median of {PLAIN_REPS})")
    s.say(f"  preprocess_backward at 3 M Gaussians, SH 3: {bwd_ms:.4f} ms a differentiated render (CUDA events, "
          f"autograd.grad over {TIMING_REPS} calls), bound {b_bound:.4f} ms ({b_bytes / 1e6:.0f} MB, "
          f"{b_bytes / bwd_ms / 1e6:.0f} GB/s achieved); the chain's forward + autograd backward "
          f"{chain_both_ms:.3f} ms, the plain twin {twin_ms:.3f} ms (host, medians of {PLAIN_REPS}); no PyTorch "
          f"call computes a preprocess, library_ms null")


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
    if launches_cli != expected(launches_cli, {"blend_forward_fast": N_VIEWS}):
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
    if launches_exact != expected(launches_exact, {"blend_forward": N_VIEWS}):
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
    s.serving_frame_ms = statistics.median(whole)
    s.serving_frame = (loaded, cams[0], bg)
    s.say(f"  render(fast=True) 1920x1080, 300k Gaussians SH 3: median "
          f"{s.serving_frame_ms:.3f} ms/frame over {N_VIEWS} views")
    stage_split(s, runs, SERVE_STAGES, whole, "render(fast=True)")
    b0 = binning.bin_splats(preprocess(loaded, cams[0]), grid, max_inst)
    time_blend_kernels(s, b0, grid)
    time_counting_kernel(s, b0, grid, loaded.capacity)
    time_tools(s)
    time_cover(s)
    time_preprocess(s)
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
        if counts != expected(counts, {"blend_forward": N_VIEWS, "blur5": N_VIEWS}):
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
    per_step = ("blend_forward", "blend_backward", "blur3", "blur", "bin_cover", "preprocess_forward",
                "preprocess_backward")
    if train_counts != expected(train_counts, {k: TRAIN_STEPS for k in per_step}):
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
    # the noisy start and its cameras (with the cached SSIM moments) serve phase 8's camera-batched step
    return {"train": train_counts, "eval": eval_counts, "start": scene, "cams": cams}


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
    want = expected(counts, {
        "blend_forward": CLI_ITERATIONS + n_eval, "blend_backward": CLI_ITERATIONS, "blur3": CLI_ITERATIONS,
        "blur": CLI_ITERATIONS + N_VIEWS, "blur5": n_eval, "blend_count": N_VIEWS * n_sweeps,
    })
    s.say(f"  trainer CLI: {CLI_ITERATIONS} iterations in {wall:.2f} s wall incl. loading {N_VIEWS + N_TEST_VIEWS} "
          f"PNGs, the point-cloud start, reports and saves; launches {counts}")
    s.say(f"  expected: B1 {CLI_ITERATIONS} steps + {n_eval} evaluated views ({len(CLI_TEST_AT)} reports x "
          f"({N_TEST_VIEWS} test + {min(REPORT_TRAIN_VIEWS, N_VIEWS)} train views), one exact render and one "
          f"five-moment SSIM each), B2 and B3 one a step, B4 one a step + {N_VIEWS} train cameras at set-up, "
          f"B5 {N_VIEWS} cameras x {n_sweeps} sweeps, B7 {n_eval}, the cover one a render")
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
        "--save_iterations", str(CLI_RESUME_TO), "--checkpoint_iterations", str(CLI_RESUME_TO), "--port", "0",
    ])
    state2, it2, _ = checkpoint.load_checkpoint(out / f"chkpnt{CLI_RESUME_TO}.npz", device=dev)
    resumed = f"at iteration {CLI_ITERATIONS}" in text2 and f"{CLI_RESUME_TO - CLI_ITERATIONS} iterations in" in text2
    # the viewer on (no --disable_viewer): its listener opens, and with no viewer connected training goes on
    if not (resumed and it2 == state2.step == CLI_RESUME_TO and "[viewer]" not in text2):
        fail(f"the resumed run did not start at {CLI_ITERATIONS + 1} and end at {CLI_RESUME_TO}")
    if torch.equal(state2.scene.means, state.scene.means) or not torch.isfinite(state2.scene.means).all():
        fail("the resumed run left the checkpoint's means as they were")
    s.say(f"  resumed from chkpnt{CLI_ITERATIONS}.npz to {CLI_RESUME_TO} in {wall2:.2f} s wall")

    # what the open listener costs a run that no viewer joins: the same resumed run with it and without
    rates = {}
    for viewer in ("off", "on"):
        reset_counts()
        text3, _ = _called(train_densify_prune.main, [
            *common_flags[:3], str(tmp / f"viewer_{viewer}"), *common_flags[4:],
            "--start_checkpoint", str(out / f"chkpnt{CLI_RESUME_TO}.npz"), "--iterations", str(CLI_VIEWER_TO),
            "--prune_iterations", str(10 * CLI_VIEWER_TO), "--test_iterations", str(10 * CLI_VIEWER_TO),
            "--save_iterations", str(10 * CLI_VIEWER_TO), "--checkpoint_iterations", str(10 * CLI_VIEWER_TO),
            *(["--disable_viewer"] if viewer == "off" else ["--port", "0"]),
        ])
        m = re.search(r"Training sections: (\d+) iterations in [\d.]+ s \(([\d.]+) it/s\)", text3)
        n_fast = read_counts()["blend_forward_fast"]
        if not m or int(m.group(1)) != CLI_VIEWER_TO - CLI_RESUME_TO or n_fast:
            fail(f"the viewer-{viewer} run printed no training sections line for "
                 f"{CLI_VIEWER_TO - CLI_RESUME_TO} iterations, or rendered {n_fast} viewer frames")
        rates[viewer] = float(m.group(2))
    s.say(f"  viewer listener open, no viewer connected: {rates['on']:.2f} iterations/s over "
          f"{CLI_VIEWER_TO - CLI_RESUME_TO} resumed iterations (training sections), against {rates['off']:.2f} "
          f"with --disable_viewer (one run each, off first)")
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
    want = expected(counts, want)
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
        # a frame that rebins (fresh, or a keyframe whose binning the next frames reuse) bins once, and again
        # when it grows the cut; a reused frame does not bin
        flags = plan_ell if what == "ellipse" else plan
        bins = sum(flags) + len(grows)
        # each render preprocesses once, and so does each keyframe's binning (a rebin that is not a fresh frame)
        fresh = sum(f and not (i + 1 < len(flags) and not flags[i + 1]) for i, f in enumerate(flags))
        _launches_of(s, f"render_video --{what}", paths[f"render_video {what}"],
                     {"blend_forward_fast": VIDEO_FRAMES + renders_again, "bin_cover": bins,
                      "preprocess_forward": VIDEO_FRAMES + bins - fresh})
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


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("the server closed the connection")
        buf += chunk
    return buf


def viewer_message(cam, scale: float, train: bool) -> dict:
    """What a SIBR viewer sends for `cam`: the reference's transposed
    matrices with columns 1 and 2 negated."""
    wvt = cam.world_view.cpu().numpy().T.copy()
    fpt = cam.full_proj.cpu().numpy().T.copy()
    for m in (wvt, fpt):
        m[:, 1:3] *= -1
    return {"resolution_x": cam.width, "resolution_y": cam.height, "train": train,
            "fov_y": 2.0 * math.atan(float(cam.tan_fovy)), "fov_x": 2.0 * math.atan(float(cam.tan_fovx)),
            "z_near": 0.01, "z_far": 100.0, "shs_python": False, "rot_scale_python": False, "keep_alive": False,
            "scaling_modifier": scale, "view_matrix": wvt.reshape(-1).tolist(),
            "view_projection_matrix": fpt.reshape(-1).tolist()}


def viewer_client(port: int, requests: list, replies: list, connected=None) -> None:
    """A viewer on a thread: connect (retrying while the listener is not up
    yet; then set the `connected` event where one is given), send each
    request, read back its frame (none at zero resolution) and the verify
    string. An error is put among the replies."""
    import socket

    try:
        deadline = time.time() + 300
        while True:
            try:
                sock = socket.create_connection(("127.0.0.1", port), timeout=300)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.05)
        if connected is not None:
            connected.set()
        with sock:
            for msg in requests:
                raw = json.dumps(msg).encode("utf-8")
                sock.sendall(len(raw).to_bytes(4, "little") + raw)
                n_img = 3 * msg["resolution_x"] * msg["resolution_y"]
                img = _recv_exact(sock, n_img) if n_img else None
                n = int.from_bytes(_recv_exact(sock, 4), "little")
                replies.append((img, _recv_exact(sock, n).decode("ascii")))
    except Exception as e:  # the phase reads it from the replies and fails
        replies.append(e)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def hold_gradients(what: str, got: dict, want: dict) -> float:
    """Adam's first moments (0.1 x the gradient each update used) per
    field, by B2's rules: the largest difference over the field's largest
    magnitude (B2_TOL), and the median difference relative to each entry
    with a gradient (B2_MEDIAN_REL_TOL). Returns the largest normalised
    difference."""
    worst = 0.0
    for k in want:
        w, g = want[k].reshape(-1), got[k].reshape(-1)
        scale = float(w.abs().max())
        if scale == 0.0:
            if g.abs().max() > 0:
                fail(f"{what}: {k} has a gradient where the single-device step has none")
            continue
        d = (g - w).abs()
        nz = w != 0
        err, rel = float(d.max()) / scale, float((d[nz] / w[nz].abs()).median())
        worst = max(worst, err)
        if err > B2_TOL or rel > B2_MEDIAN_REL_TOL:
            fail(f"{what}: {k}'s gradient is {err:.3e} of its largest off (median {rel:.3e} of each entry's)")
    return worst


def phase8_scenes(dev, n_cams: int):
    """Phase 3's serving scene and views, and phase 4's noisy start with the
    first `n_cams` views' ground truth and cached SSIM moments."""
    import torch

    from lightgaussian_tpu_torch.models.camera import Camera
    from lightgaussian_tpu_torch.ops import losses
    from lightgaussian_tpu_torch.ops.rasterize import render
    from lightgaussian_tpu_torch.utils.synthetic import random_scene

    serving = random_scene(n=N_GAUSS, seed=0, extent=2.0, scale_range=(0.004, 0.02), device=dev)
    views = [0.2 + 2.0 * math.pi * i / N_VIEWS for i in range(N_VIEWS)]
    cams = [Camera.look_at(orbit_eye(t), [0, 0, 0], fovx=0.9, width=WIDTH, height=HEIGHT, device=dev)
            for t in views]
    truth = random_scene(n=N_GAUSS, seed=0, extent=2.0, scale_range=(0.004, 0.02), active_sh_degree=3, device=dev)
    bg = torch.zeros(3, device=dev)
    batch = []
    for cam in cams[:n_cams]:
        with torch.no_grad():
            gt = render(truth, cam, bg, max_instances=MAX_INSTANCES).render.clamp(0.0, 1.0)
        batch.append(cam.with_gt(gt).with_gt_ssim_stats(losses.precompute_ssim_target_stats(gt)))
    rng = np.random.default_rng(1)
    noisy = {}
    for k, sd in (("sh_dc", 0.3), ("opacity_logits", 0.5), ("means", 0.01)):
        v = getattr(truth, k)
        noisy[k] = v + torch.from_numpy(rng.normal(0.0, sd, tuple(v.shape)).astype(np.float32)).to(dev)
    return serving, cams, truth.with_params({**truth.params(), **noisy}), batch, bg


def _phase8_rank(rank: int, world: int, store: str, tmp: str) -> None:
    """One rank of phase 8c, a process with its own card: the strip
    renderer, the two training steps, the GSS sweep and the codebook fit,
    each against its single-device counterpart on this rank's card. Rank 0
    writes the numbers for the phase to print; a failed check exits the
    rank non-zero, and that fails the phase."""
    import torch
    import torch.distributed as dist

    from lightgaussian_tpu_torch.compress import vectree, vq
    from lightgaussian_tpu_torch.config import OptimizationParams
    from lightgaussian_tpu_torch.data.ply import load_gaussian_ply
    from lightgaussian_tpu_torch.ops.rasterize import default_max_instances, render
    from lightgaussian_tpu_torch.parallel import (accumulate_gss_sharded, gather_state, make_gauss_mesh,
                                                  make_gauss_train_step, make_mesh, make_parallel_train_step,
                                                  parallel_render, shard_state)
    from lightgaussian_tpu_torch.parallel.mesh import init_rank
    from lightgaussian_tpu_torch.train.gss import accumulate_gss
    from lightgaussian_tpu_torch.train.state import init_train_state
    from lightgaussian_tpu_torch.train.step import make_train_step
    from lightgaussian_tpu_torch.utils import threefry

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = init_rank(rank, world, store, DEVICE)
    tmp = Path(tmp)
    out = {"world": world, "rank": rank}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        return r, 1e3 * (time.perf_counter() - t0)

    def counted(what, fn, want):
        reset_counts()
        r, ms = timed(fn)
        counts = read_counts()
        want = expected(counts, want)
        if counts != want:
            fail(f"rank {rank}: {what} made launches {counts}, expected {want}")
        out[what] = {"launches": counts, "ms": ms}
        return r, ms

    try:
        serving, cams, start, batch, bg = phase8_scenes(dev, world)
        mi = default_max_instances(serving)

        # the strip renderer (B6) over the 8 serving views, every rank on `space`
        mesh = make_mesh(data=1, space=world)
        with torch.no_grad():
            parallel_render(serving, cams[:1], bg, mesh=mesh, max_instances=mi)  # warm-up: the groups' first use
            single, single_ms = timed(lambda: [render(serving, c, bg, max_instances=mi, fast=True).render
                                              for c in cams])
        frames, _ = counted("parallel_render", lambda: parallel_render(serving, cams, bg, mesh=mesh, max_instances=mi),
                            {"blend_forward_fast": N_VIEWS})
        err = max(float((a - b).abs().max()) for a, b in zip(frames, single))
        if (world == 1 and err != 0.0) or err > MULTI_TOL:
            fail(f"rank {rank}: the strip renderer is {err:.3e} off render(fast=True)")
        out["parallel_render"].update(err=err, single_ms=single_ms)
        del frames, single

        # the strip step and the Gaussian-sharded step at mesh (world, 1) against the single-device step
        opt = OptimizationParams()
        ref_step = make_train_step(opt, 2.0, MAX_INSTANCES, camera_batch=world)
        one = batch if world > 1 else batch[0]
        ref_step(init_train_state(start), one, bg)  # warm-up
        ref, ref_ms = timed(lambda: ref_step(init_train_state(start), one, bg)[0])
        per_step = {"blend_forward": 1, "blend_backward": 1, "blur3": 1, "blur": 1}
        strip_step = make_parallel_train_step(opt, 2.0, MAX_INSTANCES, make_mesh(data=world, space=1), HEIGHT)
        strip_step(init_train_state(start), batch, bg)  # warm-up
        got, _ = counted("strip step", lambda: strip_step(init_train_state(start), batch, bg)[0], per_step)
        gmesh = make_gauss_mesh(data=world, gauss=1)
        gauss_step = make_gauss_train_step(opt, 2.0, MAX_INSTANCES, gmesh, HEIGHT)
        gauss_step(shard_state(init_train_state(start), gmesh), batch, bg)  # warm-up
        got_g, _ = counted("gauss step", lambda: gauss_step(shard_state(init_train_state(start), gmesh), batch, bg)[0],
                           per_step)
        got_g = gather_state(got_g, gmesh)
        for what, st in (("strip step", got), ("gauss step", got_g)):
            out[what]["err"] = hold_gradients(what, st.opt.mu, ref.opt.mu)
            if not (torch.equal(st.denom, ref.denom) and torch.equal(st.max_radii2d, ref.max_radii2d)):
                fail(f"rank {rank}: the {what}'s denom or max_radii2d differ from the single-device step's")
            out[what]["single_ms"] = ref_ms
        del ref, got, got_g

        # the GSS sweep (B5) over the 8 train views, split over `data`
        accumulate_gss(serving, cams[:1], bg, mi)  # warm-up
        (c_seq, i_seq), seq_ms = timed(lambda: accumulate_gss(serving, cams, bg, mi))
        k = -(-N_VIEWS // world)
        mine = max(0, min(k, N_VIEWS - rank * k))
        accumulate_gss_sharded(make_mesh(data=world, space=1), serving, cams[:world], bg, mi)  # warm-up
        (c_sh, i_sh), _ = counted("gss sweep", lambda: accumulate_gss_sharded(make_mesh(data=world, space=1), serving,
                                                                             cams, bg, mi), {"blend_count": mine})
        ratio = float((c_sh - c_seq).abs().sum()) / max(float(c_seq.sum()), 1.0)
        d_imp = float((i_sh - i_seq).abs().max()) / float(i_seq.abs().max())
        if ratio > COUNT_RATIO_TOL or d_imp > IMP_REL_TOL_FULL:
            fail(f"rank {rank}: the sharded sweep is off the sequential one: counts {ratio:.2e}, importance {d_imp:.2e}")
        out["gss sweep"].update(count_ratio=ratio, imp_rel=d_imp, single_ms=seq_ms)

        # the sharded codebook fit on phase 7's features (the distilled model and its scores)
        out_c = tmp / "distill6"
        feats = vectree.scene_to_feature_matrix(
            load_gaussian_ply(out_c / "point_cloud" / f"iteration_{DISTILL_TO}" / "point_cloud.ply", device=dev))
        imp = np.load(out_c / "imp_score.npz")["arr_0"]
        cfg = vectree.VQConfig(sh_degree=DISTILL_SH, codebook_size=VQ_CODEBOOK, iterations=VQ8_ITERATIONS)
        (res, q), fit_ms = counted("codebook fit", lambda: vectree.quantize_features(
            feats, imp, cfg, device=dev, mesh=make_mesh(data=world, space=1)), {})
        _, single_fit_ms = timed(lambda: vectree.quantize_features(feats, imp, cfg, device=dev))
        sh = slice(6, 6 + cfg.sh_dim)
        rows = feats[~res.non_vq_mask, sh]
        err = float(np.mean((q[~res.non_vq_mask, sh] - rows) ** 2))
        rand = threefry.normal(threefry.prng_key(9), (cfg.codebook_size, cfg.sh_dim), device=dev)
        q_rand, _ = vq.quantize_with_fp16_codebook(torch.from_numpy(np.ascontiguousarray(rows)).to(dev), rand)
        err_rand = float(np.mean((q_rand.cpu().numpy() - rows) ** 2))
        if not err < VQ_RANDOM_SHARE * err_rand:
            fail(f"rank {rank}: the sharded fit's SH error {err:.4e} is not under {VQ_RANDOM_SHARE} of a random "
                 f"codebook's {err_rand:.4e}")
        out["codebook fit"].update(err=err, err_rand=err_rand, rows=int(rows.shape[0]), single_ms=single_fit_ms)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        (tmp / "phase8_rank0.json").write_text(json.dumps(out))


def phase8(s: Smoke, tmp: Path, p4: dict) -> dict:
    """The live viewer, camera-batched training and the multi-device paths
    at full width on phases 4 to 7; returns each path's launch counts."""
    import csv
    import threading

    import torch.multiprocessing as mp

    from lightgaussian_tpu_torch.cli import train_densify_prune
    from lightgaussian_tpu_torch.config import OptimizationParams
    from lightgaussian_tpu_torch.data.ply import load_gaussian_ply
    from lightgaussian_tpu_torch.models.camera import Camera
    from lightgaussian_tpu_torch.ops.rasterize import default_max_instances, render
    from lightgaussian_tpu_torch.render.network_gui import NetworkGUI, camera_from_message, image_to_bytes
    from lightgaussian_tpu_torch.train import optim
    from lightgaussian_tpu_torch.train.state import init_train_state
    from lightgaussian_tpu_torch.train.step import make_train_step

    torch = s.torch
    dev = s.dev
    paths = {}
    src5, model5 = tmp / "src5", tmp / "model5"
    bg = torch.zeros(3, device=dev)

    # 8a: the viewer's poll over a localhost socket, on phase 5's model and its first train view
    model = load_gaussian_ply(model5 / "point_cloud" / f"iteration_{CLI_RESUME_TO}" / "point_cloud.ply", device=dev)
    mi = default_max_instances(model)
    view = Camera.look_at(orbit_eye(0.2), [0, 0, 0], fovx=0.9, width=WIDTH, height=HEIGHT, device=dev)
    zero = {**viewer_message(view, 1.0, False), "resolution_x": 0, "resolution_y": 0}
    requests = [viewer_message(view, VIEWER_SCALES[0], False), zero, viewer_message(view, VIEWER_SCALES[1], True)]

    def frame(cam, scale):
        with torch.no_grad():
            return render(model, cam, bg, scale_modifier=scale, max_instances=mi, fast=True).render

    gui = NetworkGUI(device=dev)
    gui.init("127.0.0.1", 0)
    replies, connected = [], threading.Event()
    client = threading.Thread(target=viewer_client, daemon=True,
                              args=(gui.listener.getsockname()[1], requests, replies, connected))
    client.start()
    connected.wait(timeout=60)  # the poll accepts a connection that is already waiting
    reset_counts()
    t0 = time.perf_counter()
    gui.poll(frame, str(src5), training_done=False)
    s.sync()
    poll_ms = 1e3 * (time.perf_counter() - t0)
    paths["viewer poll"] = read_counts()
    client.join(timeout=120)
    gui.close()
    if len(replies) != 3 or any(isinstance(r, Exception) for r in replies):
        fail(f"the viewer client got {replies!r:.300}")
    if replies[1][0] is not None or any(r[1] != str(src5) for r in replies):
        fail("the viewer's replies carry a frame at zero resolution or another verify string")
    for (img, _), msg in ((replies[0], requests[0]), (replies[2], requests[2])):
        want = image_to_bytes(frame(camera_from_message(msg, dev), msg["scaling_modifier"]))
        if img != want:
            fail(f"the frame at scale {msg['scaling_modifier']} is not image_to_bytes(render(..., fast=True))")
    if replies[0][0] == replies[2][0]:
        fail("the frames at scales 1.0 and 0.5 are the same")
    _launches_of(s, f"the viewer's poll (frames at scales {VIEWER_SCALES}, one request at zero resolution)",
                 paths["viewer poll"], {"blend_forward_fast": 2})
    s.say(f"  viewer: 3 requests answered in {poll_ms:.1f} ms (two {WIDTH}x{HEIGHT} frames, render, copy to the "
          f"host and {3 * WIDTH * HEIGHT} bytes each over localhost), byte for byte the render's")

    # 8b: the camera-batched step on phase 4's start against one Adam update on the mean of the per-camera gradients
    start, cams = p4["start"], p4["cams"][:CAMERA_BATCH]
    opt = OptimizationParams()
    batched = make_train_step(opt, 2.0, MAX_INSTANCES, camera_batch=CAMERA_BATCH)
    single = make_train_step(opt, 2.0, MAX_INSTANCES)
    state0 = init_train_state(start)
    reset_counts()
    got, m = batched(state0, cams, bg)
    s.sync()
    paths["batched step"] = read_counts()
    _launches_of(s, f"the camera-batched step (B={CAMERA_BATCH})", paths["batched step"],
                 {k: CAMERA_BATCH for k in ("blend_forward", "blend_backward", "blur3", "blur")})
    singles = [single(state0, c, bg)[0] for c in cams]
    mean_mu = {k: sum(st.opt.mu[k] for st in singles) / CAMERA_BATCH for k in state0.opt.mu}
    err = hold_gradients("the camera-batched step", got.opt.mu, mean_mu)
    lr_fns = optim.make_lr_fns(opt, 2.0)
    lr = {k: float(f(0)) for k, f in lr_fns.items()}
    want, _ = optim.adam_update(state0.scene.params(), {k: v / (1 - optim.BETA1) for k, v in mean_mu.items()},
                                state0.opt, lr_fns, state0.step, state0.scene.alive, 1.0)
    for k, v in want.items():
        g = mean_mu[k].abs()
        strong = g > 1e-3 * g.max()
        d = (got.scene.params()[k] - v).abs()
        if strong.any() and float(d[strong].max()) > 1e-3 * lr[k]:
            fail(f"the camera-batched step's {k} is {float(d[strong].max()):.3e} off one Adam update on the mean "
                 f"gradient where the gradient is strong (lr {lr[k]:.3e})")
    denom = sum(st.denom for st in singles)
    radii = torch.stack([st.max_radii2d for st in singles]).amax(dim=0)
    if not (torch.equal(got.denom, denom) and torch.equal(got.max_radii2d, radii)):
        fail("the camera-batched step's denom or max_radii2d are not the single steps' sum and maximum")
    times = {"batched": [], "singles": []}
    for _ in range(BATCH_STEP_REPS):
        s.sync()
        t0 = time.perf_counter()
        batched(state0, cams, bg)
        s.sync()
        times["batched"].append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        for c in cams:
            single(state0, c, bg)
        s.sync()
        times["singles"].append(1e3 * (time.perf_counter() - t0))
    s.say(f"  camera-batched step B={CAMERA_BATCH} at {WIDTH}x{HEIGHT}, {N_GAUSS} Gaussians SH 3: Adam's first moment "
          f"{err:.3e} of each field's largest off the mean of the {CAMERA_BATCH} single-camera gradients "
          f"(atol {B2_TOL:.0e}); loss {float(m.loss):.5f}; median {statistics.median(times['batched']):.3f} ms "
          f"against {statistics.median(times['singles']):.3f} ms for {CAMERA_BATCH} single steps "
          f"({BATCH_STEP_REPS} of each, in turns)")
    del got, singles, want

    # 8b/8a: the trainer CLI with --camera_batch and the viewer on, a client served through it
    port = free_port()
    replies = []
    client = threading.Thread(target=viewer_client, args=(port, [viewer_message(view, 1.0, True)], replies),
                              daemon=True)
    client.start()
    out = tmp / "batch8"
    n_eval = len(BATCH_CLI_TEST_AT) * (N_TEST_VIEWS + min(REPORT_TRAIN_VIEWS, N_VIEWS))
    never = str(10 * BATCH_CLI_ITERATIONS)
    reset_counts()
    text, wall = _called(train_densify_prune.main, [
        "-s", str(src5), "-m", str(out), "--eval", "-r", "1", "--quiet", "--device", DEVICE, "--port", str(port),
        "--camera_batch", str(CAMERA_BATCH), "--iterations", str(BATCH_CLI_ITERATIONS),
        "--densify_until_iter", "0", "--opacity_reset_interval", never, "--prune_iterations", never,
        "--test_iterations", *map(str, BATCH_CLI_TEST_AT), "--save_iterations", never,
        "--checkpoint_iterations", never, "--position_lr_max_steps", str(BATCH_CLI_ITERATIONS)])
    s.sync()
    paths["train_densify_prune --camera_batch"] = read_counts()
    client.join(timeout=120)
    steps = CAMERA_BATCH * BATCH_CLI_ITERATIONS
    _launches_of(s, f"train_densify_prune --camera_batch {CAMERA_BATCH}, {BATCH_CLI_ITERATIONS} iterations, the "
                    f"viewer served once", paths["train_densify_prune --camera_batch"],
                 {"blend_forward": steps + n_eval, "blend_backward": steps, "blur3": steps, "blur": steps + N_VIEWS,
                  "blur5": n_eval, "blend_forward_fast": 1})
    if len(replies) != 1 or isinstance(replies[0], Exception) or replies[0][1] != str(src5) or "Connected by" not in text:
        fail(f"the trainer's viewer did not serve the client: {replies!r:.300}")
    rows = [r for r in csv.DictReader(open(out / "metric.csv")) if r["set"] == "test"]
    l1 = [float(r["l1_loss"]) for r in rows]
    if [int(r["iteration"]) for r in rows] != list(BATCH_CLI_TEST_AT) or not l1[-1] < l1[0]:
        fail(f"the batched trainer's test L1 {l1} at {[r['iteration'] for r in rows]} did not fall")
    s.say(f"  trainer CLI --camera_batch {CAMERA_BATCH}: {BATCH_CLI_ITERATIONS} optimizer steps ({steps} views) in "
          f"{wall:.2f} s wall incl. loading and {len(BATCH_CLI_TEST_AT)} reports; test L1 {l1[0]:.5f} -> {l1[-1]:.5f}; "
          f"one {WIDTH}x{HEIGHT} frame served to a viewer during the run")

    # 8c: the multi-device paths, one process per card under NCCL
    import torch.distributed  # noqa: F401 (the ranks' backend must exist here too)

    world = torch.cuda.device_count()
    mp.spawn(_phase8_rank, args=(world, str(tmp / "store8"), str(tmp)), nprocs=world, join=True)
    r0 = json.loads((tmp / "phase8_rank0.json").read_text())
    for what in ("parallel_render", "strip step", "gauss step", "gss sweep", "codebook fit"):
        paths[f"{what} (rank 0 of {world})"] = r0[what]["launches"]
    pr, st, gs, sw, cb = (r0[k] for k in ("parallel_render", "strip step", "gauss step", "gss sweep", "codebook fit"))
    s.say(f"  multi-device, {world} rank(s) under {'NCCL' if DEVICE == 'cuda' else 'gloo'}, rank 0: strip renderer {N_VIEWS} views {pr['ms']:.2f} ms "
          f"(render(fast=True) {pr['single_ms']:.2f} ms; largest difference {pr['err']:.3e}); strip step "
          f"{st['ms']:.2f} ms, Gaussian-sharded step {gs['ms']:.2f} ms (single-device step {st['single_ms']:.2f} ms; "
          f"Adam's first moment {st['err']:.3e} and {gs['err']:.3e} of the largest off); GSS sweep {sw['ms']:.2f} ms "
          f"(sequential {sw['single_ms']:.2f} ms; counts {sw['count_ratio']:.2e}, importance {sw['imp_rel']:.2e}); "
          f"codebook fit + assignment, {VQ8_ITERATIONS} iterations, {cb['ms']:.1f} ms (one device {cb['single_ms']:.1f} "
          f"ms; SH error {cb['err']:.4e} against a random codebook's {cb['err_rand']:.4e} on {cb['rows']} rows)")
    print("phase 8 ok", flush=True)
    return paths


E2E_ROWS = ("[1]", "[1b]", "[2c]", "[2d]", "[2s]", "[2t]", "[2]", "[2b]", "[3]", "[4]", "[7]")


def e2e_stage_launches(p) -> dict:
    """Each stage's launches on e2e_hard's path, from its preset: a trainer CLI
    makes one B1, B2, B3 and B4 a step, one B4 a train camera for the cached
    SSIM moments, one B1 and one B7 a reported view, one B5 a train camera
    for each GSS sweep (a prune; the imp_score.npz export with the
    checkpoint); the distillation step two B1 (teacher, student), one B2,
    one B4 at 15 planes and one B7; an evaluated view one B1 and one B7."""
    report = p.n_test_views + min(REPORT_TRAIN_VIEWS, p.n_train_views)
    sweep = p.n_train_views

    def trainer(iters: int, prunes: int) -> dict:
        return {"blend_forward": iters + report, "blend_backward": iters, "blur3": iters,
                "blur": iters + p.n_train_views, "blur5": report, "blend_count": sweep * (1 + prunes)}

    want = {
        "dataset": {"blend_forward": p.n_train_views + p.n_test_views},
        "[1] train": trainer(p.train_iters, 0),  # the trainer's default GSS prunes (16,000, 24,000) lie past the end
        "[1b] finetune": trainer(p.ft_iters, 0),
        "[2c] prune": {"blend_count": sweep},
        "[2d] prune": {"blend_count": sweep},
        "[2s] finetune": trainer(p.ft_short, 1),
        "[2t] finetune": trainer(p.ft_short, 1),
        "[2] finetune": trainer(p.ft_iters, 1),
        "[2b] finetune": trainer(p.ft_iters, 1),
        "[4] distill": {"blend_forward": 2 * p.distill_iters + report, "blend_backward": p.distill_iters,
                        "blur": p.distill_iters, "blur5": p.distill_iters + report, "blend_count": sweep},
        "[7] vectree": {},
    }
    for tag in E2E_ROWS:
        want[f"eval {tag}"] = {"blend_forward": p.n_test_views, "blur5": p.n_test_views}
    return want


def phase9(s: Smoke, tmp: Path) -> dict:
    """The end-to-end harness at full width: `e2e_hard` cut in depth,
    `bench_render_fps` at its defaults and `roofline`; returns each path's
    launch counts."""
    from lightgaussian_tpu_torch.data.ply import fetch_point_cloud, load_gaussian_ply
    from lightgaussian_tpu_torch.models.gaussians import from_point_cloud
    from lightgaussian_tpu_torch.ops import losses
    from lightgaussian_tpu_torch.ops import sh as sh_ops
    from lightgaussian_tpu_torch.ops.rasterize import render
    from lightgaussian_tpu_torch.scripts import bench_render_fps, e2e_hard, roofline
    from lightgaussian_tpu_torch.utils import issue_probe

    torch = s.torch
    dev = s.dev
    paths = {}

    # A point cloud's 8-bit colours enter the DC band as on the CPU (and in JAX): a black point one ulp
    # lower renders -6e-8, under the colour clamp, and never trains (e2e_hard's cloud is black).
    levels = torch.arange(256, dtype=torch.float32) / 255.0
    if not torch.equal(sh_ops.rgb_to_sh(levels.to(dev)).cpu(), sh_ops.rgb_to_sh(levels)):
        fail("rgb_to_sh on the card is not the CPU's float32 division")

    # 9a: the Table-5 progression through the CLIs, every stage's launches read around it
    preset = dataclasses.replace(e2e_hard.PRESETS[E2E_PRESET], name=f"{E2E_PRESET}_cut", **E2E_CUT)
    reset_counts()
    r = e2e_hard.run(preset, tmp / "e2e9", DEVICE)
    s.sync()
    paths["e2e_hard"] = read_counts()
    want = e2e_stage_launches(preset)
    total = {k: 0 for k in paths["e2e_hard"]}
    for row in r["stages"]:
        counts = {k: row["launches"].get(k, 0) for k in paths["e2e_hard"]}
        _launches_of(s, f"e2e_hard {row['stage']} ({row['wall_s']:.2f} s"
                        + (f", {row['it_per_s']:.2f} it/s)" if row["it_per_s"] else ")"), counts, want[row["stage"]])
        total = {k: total[k] + v for k, v in counts.items()}
    if sorted(row["stage"] for row in r["stages"]) != sorted(want) or total != paths["e2e_hard"]:
        fail(f"e2e_hard ran the stages {[row['stage'] for row in r['stages']]} with launches {paths['e2e_hard']}")
    rows = {label.split(" ")[0]: (m, size, n) for label, m, size, n in r["rows"]}
    if tuple(rows) != E2E_ROWS:
        fail(f"e2e_hard made the rows {list(rows)}")
    n1 = rows["[1]"][2]
    for tag in E2E_ROWS[2:]:
        if abs(rows[tag][2] - (1 - e2e_hard.PRUNE_RATIO) * n1) > 1:
            fail(f"e2e_hard row {tag} keeps {rows[tag][2]} of {n1} Gaussians, not {1 - e2e_hard.PRUNE_RATIO:.0%}")
    if rows["[1b]"][2] != n1:
        fail(f"the no-prune control keeps {rows['[1b]'][2]} of {n1} Gaussians")
    if r["f_rest"] != {"[3]": 24, "[4]": 24}:
        fail(f"rows [3] and [4] carry {r['f_rest']} f_rest fields, not 24")
    p4, p7 = rows["[4]"][0]["PSNR"], rows["[7]"][0]["PSNR"]
    if not p7 > p4 - VQ_PSNR_DROP:
        fail(f"PSNR of the VQ bundle [7] {p7:.3f} is not above [4]'s {p4:.3f} - {VQ_PSNR_DROP} dB")
    ws = e2e_hard.Workspace(tmp / "e2e9", preset)
    test_cams, gts = e2e_hard.load_test_gt(preset, ws, dev)
    xyz, rgb, _ = fetch_point_cloud(ws.scene / "points3d.ply")
    bg = torch.zeros(3, device=dev)

    def test_l1(scene) -> float:
        with torch.no_grad():
            return float(np.mean([float(losses.l1_loss(render(scene, c, bg, max_instances=preset.max_inst).render
                                                       .clamp(0, 1), gt)) for c, gt in zip(test_cams, gts)]))

    l1_first = test_l1(from_point_cloud(xyz, rgb, 3, device=dev))
    l1_last = test_l1(load_gaussian_ply(ws.model / f"point_cloud/iteration_{preset.train_iters}/point_cloud.ply",
                                        device=dev))
    if not l1_last < l1_first:
        fail(f"e2e_hard's training did not lower the test L1: {l1_first:.5f} -> {l1_last:.5f}")
    peak = max(m["max_instances"] for m, _, _ in rows.values())
    s.say(f"  e2e_hard at {preset.width}x{preset.height}, {preset.n_target} target Gaussians, "
          f"{preset.n_train_views}/{preset.n_test_views} views, cut to {preset.train_iters} training iterations: "
          f"{n1} Gaussians trained, each prune keeps {rows['[2c]'][2]}; test L1 {l1_first:.5f} (the point-cloud "
          f"start) -> {l1_last:.5f}; most live instances of an evaluated view {peak} (cut {preset.max_inst})")
    for label, m, size, n in r["rows"]:
        s.say(f"    {label}: PSNR {m['PSNR']:.3f} SSIM {m['SSIM']:.4f} LPIPS {m['LPIPS']:.3e} {size:.2f} MB {n}")
    for name, ok, value in r["criteria"]:
        print(f"    criterion (printed, not gated at this depth): {name}: {'PASS' if ok else 'FAIL'} {value}")

    # 9b: the serving FPS study at its defaults and at a finer step. Every reused frame is held above 45 dB but
    # the fixed rebin-8 schedule's (C) at the default step, which reuses frames whatever they drifted (the JAX
    # package's record there: 19.4 dB); that one is printed.
    for label, extra in (("defaults", []), (f"step 2 pi/{BENCH_FINE_STEP_DIV}", ["--step_div", str(BENCH_FINE_STEP_DIV)])):
        args = bench_render_fps.build_parser().parse_args([*extra, "--device", DEVICE])
        reset_counts()
        b = bench_render_fps.run(args)
        s.sync()
        what = f"bench_render_fps {label}"
        paths[what] = read_counts()
        n, warm = args.frames, bench_render_fps.WARMUP
        key_c = math.ceil(n / args.rebin_every)
        # a frame a pass (the totals, A, B after warm-up, C, D) and two a reused frame in each PSNR sweep
        fast = (n + 2 * (warm + n) + (warm + n) + 2 * (n - key_c) + (warm + n)
                + (2 * (n - b["n_rebin"]) if b["n_rebin"] < n else 0))
        # binnings: the first frame's live count, the totals, A and B with warm-up, each schedule's warm-up
        # keyframe and its rebinned frames, and a frame a PSNR sweep (a reused frame's fresh render, a keyframe's
        # binning)
        bins = (1 + n + 2 * (warm + n) + (1 + key_c) + n + (1 + b["n_rebin"])
                + (n if b["n_rebin"] < n else 0))

        def keyframes(flags):  # a schedule's keyframes that bin apart from a render (the next frame reuses them)
            return sum(f and i + 1 < len(flags) and not flags[i + 1] for i, f in enumerate(flags))

        # a render preprocesses once, and so does each binning apart from a render: a schedule's warm-up binning
        # and keyframes, and each rebinned frame of a PSNR sweep
        flags_c = [i % args.rebin_every == 0 for i in range(n)]
        apart = ((1 + keyframes(flags_c) + key_c) + (1 + keyframes(b["flags_d"]))
                 + (b["n_rebin"] if b["n_rebin"] < n else 0))
        _launches_of(s, what, paths[what], {"blend_forward": 1, "blend_forward_fast": fast, "bin_cover": bins,
                                            "preprocess_forward": 1 + fast + apart})
        gated = ("D",) if not extra else ("C", "D")
        for k in gated:
            if not b["worst_psnr"][k] > REUSED_PSNR_MIN:
                fail(f"{what}: a frame that schedule {k} reused lies at {b['worst_psnr'][k]:.2f} dB against its fresh "
                     f"render, not above {REUSED_PSNR_MIN}")
        s.say(f"  {what}: ms a frame A {b['ms']['A']:.3f}, B {b['ms']['B']:.3f}, C {b['ms']['C']:.3f}, "
              f"D {b['ms']['D']:.3f} ({b['n_rebin']}/{n} rebinned); worst reused frame C {b['worst_psnr']['C']:.2f} dB, "
              f"D {b['worst_psnr']['D']:.2f} dB (gated: {', '.join(gated)}); frames over the cut {b['cut']}")

    # 9c: the roofline tool: issue rates, the memory stream, the step's stages against their floors
    reset_counts()
    rl = roofline.run(DEVICE, tmp / "roofline9")
    s.sync()
    paths["roofline"] = read_counts()
    steps = roofline.STEP_REPS + 3  # and three warm-up steps
    _launches_of(s, "roofline", paths["roofline"], {
        "issue_probe": len(issue_probe.KINDS) * 2 * (1 + issue_probe.REPS), "blend_forward": steps + 1,
        "blend_backward": steps, "blur3": steps, "blur": steps + 1,
        "bin_cover": steps + 2,  # and section (b)'s binning, whose order it gathers by
        "preprocess_forward": steps + 3})  # and the preprocess of (b)'s binning and of (c)'s byte floors
    stream = rl["memory"]["stream_bytes_per_s"]
    s.say(f"  roofline: measured stream {stream / 1e12:.4f} TB/s against PEAK_BYTES {PEAK_BYTES / 1e12:.2f} TB/s "
          f"({stream / PEAK_BYTES:.3f}); the step's stages {rl['step']['step_ms']:.3f} ms against a byte floor of "
          f"{rl['step']['floor_ms']:.3f} ms at that stream")
    if stream > STREAM_SLACK * PEAK_BYTES:
        fail(f"the measured stream {stream / 1e12:.3f} TB/s exceeds {STREAM_SLACK} x PEAK_BYTES: the byte bounds "
             "would not be bounds")
    print("phase 9 ok", flush=True)
    return paths


@contextlib.contextmanager
def plain_kernels():
    """Within it, the training path's kernels (B1, B2, B3, B4, the tile
    cover, the emission and the preprocess) run their plain PyTorch versions
    on the card: the callers reach the wrappers as module attributes (the
    render reaches the preprocess as `api.preprocess`)."""
    from lightgaussian_tpu_torch.ops import losses
    from lightgaussian_tpu_torch.ops.rasterize import api, binning, blend, projection

    saved = (blend.blend_forward, blend.blend_backward, losses.blur, losses.blur3, binning._cover, binning._emit,
             api.preprocess)
    blend.blend_forward = lambda ts, inst, grid: blend.plain_blend(ts, inst, grid, exact=True)[:2]
    blend.blend_backward = lambda ts, inst, gid, tg, tr, grid, n: blend.reduce_per_gaussian(
        blend.plain_blend_backward(ts, inst, tg, tr, grid)[0], gid, n)
    losses.blur, losses.blur3 = losses.plain_blur, losses.plain_blur3
    binning._cover, binning._emit = binning.plain_cover, binning.plain_emit
    api.preprocess = projection.plain_preprocess
    try:
        yield
    finally:
        (blend.blend_forward, blend.blend_backward, losses.blur, losses.blur3, binning._cover, binning._emit,
         api.preprocess) = saved


def phase10(s: Smoke, tmp: Path) -> dict:
    """The measurement layer at full width: the bench, the step profiler
    with its trace read through, the binning profilers and the backward
    profiler; returns each path's launch counts."""
    from lightgaussian_tpu_torch.ops import sh as sh_ops
    from lightgaussian_tpu_torch.ops.rasterize import blend, render, tiled
    from lightgaussian_tpu_torch.scripts import (bench, harness, profile_binning, profile_binning_infer, profile_bwd,
                                                 profile_step)

    torch = s.torch
    paths = {}

    # sh_dc_to_rgb on the card rounds as on the CPU (C0 a float32 tensor, as in rgb_to_sh)
    levels = torch.arange(256, dtype=torch.float32) / 255.0
    dc = sh_ops.rgb_to_sh(levels)
    if not torch.equal(sh_ops.sh_dc_to_rgb(dc.to(s.dev)).cpu(), sh_ops.sh_dc_to_rgb(dc)):
        fail("sh_dc_to_rgb on the card is not the CPU's")

    # 10a: the bench at its defaults and batched, launches read around each run
    for label, extra in (("bench", ()), ("bench " + " ".join(BENCH_BATCH_ARGS), BENCH_BATCH_ARGS)):
        args = bench.build_parser().parse_args([*extra, "--device", DEVICE, "--out_root", str(tmp)])
        reset_counts()
        line = bench.run(args)
        s.sync()
        paths[label] = read_counts()
        steps = args.batch * (1 + bench.WARMUP + args.repeats * args.iters)
        _launches_of(s, label, paths[label], {"blend_forward": steps, "blend_backward": steps, "blur3": steps,
                                              "blur": steps + 1})
        s.say(f"  {label}: {json.dumps(line)}")
        want = args.batch * bench.WIDTH * bench.HEIGHT / (line["median_ms"] * 1e-3)
        if set(line) != {"metric", "value", "unit", "median_ms", "spread_ms", "groups"} or abs(line["value"] - want) > 0.5:
            fail(f"{label}: the line {line} does not hold value = pixels / median ({want:.1f})")
    # the bench step's gradients against the same loss through the plain versions of B1-B4, the cover, the emission
    # and the preprocess, by B2's rules
    step = bench.setup(1, s.dev)
    loss_k, grads_k, live = step()
    with plain_kernels():
        reset_counts()
        loss_p, grads_p, _ = step()
        s.sync()
        if any(read_counts().values()):
            fail(f"the plain step launched kernels: {read_counts()}")
    worst = hold_gradients("the bench step against its plain kernels", grads_k, grads_p)
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    s.say(f"  bench step ({live} live instances) against the plain versions of B1-B4, the cover, the emission and "
          f"the preprocess: loss {float(loss_k):.7f} vs {float(loss_p):.7f} (rel {rel:.2e}); largest gradient "
          f"difference {worst:.2e} of its field's largest")
    del step, grads_k, grads_p

    # 10b: binning piece by piece, train form
    reset_counts()
    r = profile_binning.run(profile_binning.build_parser().parse_args(
        [*PROFILE_BINNING_ARGS, "--device", DEVICE, "--out_root", str(tmp)]))
    s.sync()
    paths["profile_binning"] = read_counts()
    # the composition and the whole once each, then the cover piece and the whole timed both ways
    _launches_of(s, "profile_binning", paths["profile_binning"],
                 {"bin_cover": 2 + 2 * 2 * (3 + profile_binning.REPS), "preprocess_forward": 1})
    if not r["bit_equal"]:
        fail("binning's pieces composed in order differ from bin_splats")
    lo, hi = PIECES_RATIO
    if not lo <= r["ratio"] <= hi:
        fail(f"binning's pieces sum to {r['ratio']:.3f} x the whole, outside [{lo}, {hi}]")

    # 10c: a serving frame piece by piece at both points
    for extra in ((), ("--large",)):
        reset_counts()
        r = profile_binning_infer.run(profile_binning_infer.build_parser().parse_args(
            [*extra, "--device", DEVICE, "--out_root", str(tmp)]))
        s.sync()
        what = f"profile_binning_infer {r['point']}"
        paths[what] = read_counts()
        if not r["binning"]["bit_equal"] or not paths[what]["blend_forward_fast"]:
            fail(f"{what}: pieces bit-equal {r['binning']['bit_equal']}, launches {paths[what]}")
        if extra:
            # the profiler's fresh frame and phase 3's serving frame, both host-paced (one launch a preprocess,
            # binning's one synchronise), timed the profiler's way in turns here: medians of FRESH_GROUPS groups,
            # so that a stall of the host hits both sides or one group
            scene_p, cam_p, bg_p, _live, cap_p = profile_binning_infer.frame_inputs("large", s.dev)
            loaded, cam_s, bg_s = s.serving_frame
            sides = {"fresh": (lambda: render(scene_p, cam_p, bg_p, max_instances=cap_p, fast=True), []),
                     "serving": (lambda: render(loaded, cam_s, bg_s, fast=True), [])}
            for _ in range(FRESH_GROUPS):
                for fn, times in sides.values():
                    times.append(harness.ms_per_call(torch.no_grad()(fn), s.dev, reps=FRESH_REPS))
            fresh, serving = (statistics.median(times) for _fn, times in sides.values())
            ratio = fresh / serving
            s.say(f"  {what}: fresh frame {fresh:.3f} ms against phase 3's serving frame {serving:.3f} ms in turns "
                  f"({ratio:.3f}x; medians of {FRESH_GROUPS} groups of {FRESH_REPS}, CUDA events); the profiler's "
                  f"row {r['rows']['fresh frame (render(fast=True))']:.3f} ms, phase 3's {s.serving_frame_ms:.3f} ms")
            if not 1.0 / FRESH_VS_SERVING <= ratio <= FRESH_VS_SERVING:
                fail(f"{what}: the fresh frame is {ratio:.3f} x phase 3's serving frame")
            del scene_p, sides

    # 10d: the backward piece by piece; its B2 seed is what the autograd blend hands B2
    reset_counts()
    r = profile_bwd.run(profile_bwd.build_parser().parse_args(["--device", DEVICE, "--out_root", str(tmp)]))
    s.sync()
    paths["profile_bwd"] = read_counts()
    bw = r["inputs"]
    handed = {}
    real = blend.blend_backward

    def capture(ts, inst, gid, tile_g, tile_r, grid, n):
        handed["seed"] = (tile_g.clone(), tile_r.clone())
        return real(ts, inst, gid, tile_g, tile_r, grid, n)

    blend.blend_backward = capture
    try:
        image, _, _ = tiled.blend_tiled(bw.splats, torch.zeros(3, device=s.dev), profile_bwd.WIDTH,
                                        profile_bwd.HEIGHT, profile_bwd.CAP)
        torch.autograd.grad(image, bw.splats.mean2d, bw.g_image, retain_graph=True)
    finally:
        blend.blend_backward = real
    if not all(torch.equal(a, b) for a, b in zip(handed["seed"], bw.seed)):
        fail("profile_bwd's B2 seed differs from what the autograd blend hands B2")
    s.say(f"  profile_bwd: B2's seed bit-equal to the autograd blend's; launches {paths['profile_bwd']}")
    # 10e: the step's pieces and a profiler trace of bench steps, read through. Last: in this process the host
    # runs ops more slowly after a torch.profiler session, and the rows above would read that
    reset_counts()
    r = profile_step.run(profile_step.build_parser().parse_args(["--device", DEVICE, "--out_root", str(tmp)]))
    s.sync()
    paths["profile_step"] = read_counts()
    tr, counted = r["trace"], r["launches"]
    traced = {k: tr["hand_written"].get(k, 0) for k in counted}
    s.say(f"  profile_step: trace of {r['trace_steps']} bench steps, hand-written launches {traced}, the counters "
          f"{counted}; busy {tr['busy']} of a {tr['window']} us window")
    if traced != counted or not counted["blend_backward"]:
        fail(f"the trace's hand-written launches {traced} are not the counters' {counted}")
    if not 0.0 < tr["busy"] <= tr["window"]:
        fail(f"the trace's busy time {tr['busy']} us lies outside its window of {tr['window']} us")

    print("phase 10 ok", flush=True)
    return paths


def phase11(s: Smoke) -> None:
    """A frame of more than 2^24 live instances, binned and blended whole."""
    from lightgaussian_tpu_torch.models.camera import Camera
    from lightgaussian_tpu_torch.ops.rasterize import binning, blend, build_binning, render, tiled
    from lightgaussian_tpu_torch.utils import synthetic

    torch = s.torch
    cfg = BIG_FRAME
    w, h, n = cfg["width"], cfg["height"], cfg["n"]
    scene = synthetic.random_scene(n=n, seed=cfg["seed"], extent=cfg["extent"], scale_range=cfg["scale_range"],
                                   device=s.dev)
    cam = Camera.look_at(eye=orbit_eye(0.0), target=[0.0, 0.0, 0.0], fovx=0.9, width=w, height=h, device=s.dev)
    bg = torch.zeros(3, device=s.dev)
    grid = binning.make_grid(w, h)
    reset_counts()
    b = build_binning(scene, cam)
    s.sync()
    counted = dict(binning.INSTANCES)
    s.say(f"  a {w}x{h} frame of {n} Gaussians: {b.total} live instances ({b.total / JAX_CEILING:.3f} x 2^24), "
          f"{b.inst.shape[0]} binned; counters {counted}")
    if b.total <= JAX_CEILING:
        fail(f"phase 11's frame has {b.total} live instances, not more than 2^24")
    if b.inst.shape[0] != b.total or counted["cut"] or counted["live"] != b.total:
        fail("the default cut dropped live instances of a frame past 2^24")
    if int(b.tile_starts[-1]) != b.total:
        fail(f"the tile ranges end at {int(b.tile_starts[-1])}, not at the live count {b.total}")

    out = {}
    for name, fn, exact in (("blend_forward_fast", blend.blend_forward_fast, False),
                            ("blend_forward", blend.blend_forward, True)):
        rgb, t = fn(b.tile_starts, b.inst, grid)
        s.sync()
        w_rgb, w_t, _ = blend.plain_blend(b.tile_starts, b.inst, grid, exact=exact)
        err = max(float((rgb - w_rgb).abs().max()), float((t - w_t).abs().max()))
        s.say(f"  {name:20s} vs plain on the 2^24+ frame: max|d| = {err:.3e} (atol {KERNEL_TOL:.0e})")
        if not (torch.isfinite(rgb).all() and torch.isfinite(t).all()) or err > KERNEL_TOL:
            fail(f"{name} disagrees with its plain version on a frame past 2^24")
        out[name] = (rgb, t)
    image, final_t = tiled._compose(*out["blend_forward"], bg, grid, w, h)
    tile_g, tile_r = backward_seed(s, image, final_t, grid, 11)
    hold_backward(s, b, grid, n, tile_g, tile_r, "the 2^24+ frame")
    hold_counting(s, b, grid, n, "the 2^24+ frame", full_size=True)

    reset_counts()
    served = render(scene, cam, bg, fast=True)
    s.sync()
    want, _ = tiled._compose(*out["blend_forward_fast"], bg, grid, w, h)
    err = float((served.render - want).abs().max())
    s.say(f"  api.render(fast=True) with no cut: {served.num_instances} live, counters {dict(binning.INSTANCES)}; "
          f"image max|d| = {err:.3e} from B6's on the binning above (atol {KERNEL_TOL:.0e})")
    if served.num_instances != b.total or binning.INSTANCES["cut"] or err > KERNEL_TOL:
        fail("api.render's default cut dropped instances of a frame past 2^24")
    s.say(f"phase 11 ok: a frame of {b.total} live instances rendered, exact-rendered, backpropagated and "
          f"counted whole")


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
        cli_paths.update(timed(8, phase8, tmp, counts))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for number, phase in ((9, phase9), (10, phase10)):
        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
        try:
            cli_paths.update(timed(number, phase, tmp))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    timed(11, phase11)
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
             "unchunk_transpose", "issue_probe", "bin_cover", "bin_emit", "preprocess_forward", "preprocess_backward")
    print(json.dumps({"kernels": [s.rows[k] for k in order]}))
    print(s.card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
