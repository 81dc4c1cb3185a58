"""The frozen counting of work: the H100's peaks, the least instructions of
each piece of a training step or a served frame, and the least time of the
blend kernels from their pairs by kind.

Every count is of the work the algorithm needs, whatever implements it:
multiply-adds fused, compares and selects free, each input byte read once
and each output byte written once. A kernel's or a step's least time is the
larger of its FP32 instructions at `F32_INSTR_RATE`, its MUFU instructions
(exp2, reciprocal, square root) at `MUFU_RATE` and its bytes at
`PEAK_BYTES`; a step's is the sum of its pieces'. A later change that
replaces an implementation leaves these counts as they are.
"""
from __future__ import annotations

from perfbench.reference.render import PIX, WORK_KINDS

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit):
# 67 TFLOP/s in float32 outside the tensor cores, counting a fused
# multiply-add as two operations, and 3.35 TB/s of HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# One FP32 instruction per lane and clock: half the flop rate. The MUFU pipe
# gives 16 results per SM and clock against 128 for FP32 (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability 9.0).
F32_INSTR_RATE = PEAK_F32_FLOPS / 2
MUFU_RATE = F32_INSTR_RATE * 16 / 128

# The blends' least instructions per (instance, pixel) pair of each kind of
# WORK_KINDS: only the pairs that change an output count (applied and
# stopping; for the render-only blend also the eligible pairs past a stop,
# which move its naive transmittance):
#   dx, dy (2); power = dx (ha dx + hb dy) + (hc dy) dy (5); opacity * e and
#   the min with 0.99 (2); T - alpha T (1)                 10 FP32, 1 MUFU (exp2)
#   applied: alpha T and three colour multiply-adds        +4
F32_MIN_PER_PAIR = {"culled": 0, "faint": 0, "past_stop": 10, "stopping": 10, "applied": 14}
MUFU_MIN_PER_PAIR = {"culled": 0, "faint": 0, "past_stop": 1, "stopping": 1, "applied": 1}
# The backward's applied pair: colour . g (3), alpha T (1), the remaining
# contribution (1), times the reciprocal of 1 - alpha and d_alpha (2),
# d_power (1), q1, q2 (2), the nine sums (9): +19 on the 10, and the
# reciprocal. The reduce over a tile's pixels is left out.
F32_MIN_PER_PAIR_BWD = {"culled": 0, "faint": 0, "past_stop": 0, "stopping": 10, "applied": 29}
MUFU_MIN_PER_PAIR_BWD = {"culled": 0, "faint": 0, "past_stop": 0, "stopping": 1, "applied": 2}

# Per Gaussian, the preprocess forward (FP32, MUFU), by SH degree:
#   world->camera and ->clip of the mean, 3 rows each and w (18 FMA); 1/w (1
#   MUFU), NDC and pixel coordinates (6)                              24, 1
#   quaternion norm (4), rsqrt (1 MUFU), normalise (4); rotation (21);
#   exp of 3 log-scales (3 MUFU); R S (9); Sigma = M M^T, 6 of 3 (18)   56, 4
#   W Sigma W^T: W Sigma (27), its 6 needed entries of 3 (18)         45
#   EWA: x/z, y/z (1 MUFU, 2), clamps (4), back to camera (2), 1/z and
#   its square (1 MUFU, 1), Jacobian (4), a, b, d (12), low-pass (2)   27, 2
#   det (2), 1/det (1 MUFU), conic (3); radius: mid (2), discriminant
#   (2), sqrt (1 MUFU), lambda (1), 3 sqrt (1 MUFU, 1)                 13, 3
#   opacity sigmoid (1, 2 MUFU); view direction: 3 subtractions, norm
#   (3), rsqrt (1 MUFU), scale (3)                                      10, 3
#   SH: basis products per degree above 0 (3, 8, 15), three channels'
#   multiply-adds per coefficient (3 (d+1)^2), offset and clamp (6)
_PRE_BASE = 24 + 56 + 45 + 27 + 13 + 10
_PRE_MUFU = 1 + 4 + 2 + 3 + 3
_SH_BASIS = {0: 0, 1: 3, 2: 11, 3: 26}


def preprocess_forward(degree: int) -> tuple[int, int]:
    return _PRE_BASE + _SH_BASIS[degree] + 3 * (degree + 1) ** 2 + 6, _PRE_MUFU


def preprocess_backward(degree: int) -> tuple[int, int]:
    """The adjoint of each multiply-add is two multiply-adds: twice the forward."""
    f, m = preprocess_forward(degree)
    return 2 * f, 2 * m


# Binning's float work: per Gaussian the tightened rect (log of the opacity,
# two square roots: 3 MUFU; 16 FP32), per instance kept the ellipse-vs-tile
# minimum over its box (four edge minima of 7 each, 2 reciprocals; 30).
BINNING_PER_GAUSSIAN = (16, 3)
BINNING_PER_INSTANCE = (30, 2)

# The loss per pixel: the 11-tap window in two passes is 22 multiply-adds per
# plane; planes blurred forward are the moments the step has to form (three
# a channel with the target's cached, five without), backward the same count
# (the blur is its own adjoint). Around the blurs: L1 (2 a channel), forming
# the moments (1 a plane), the SSIM map (12 a channel, 1 MUFU reciprocal),
# the means (1 a channel); backward the L1 sign (1), the map's adjoint (18)
# and the moments' chain rule (2 a plane).
BLUR_PER_PLANE = 22


def loss_forward(moment_planes: int, channels: int = 3) -> tuple[int, int]:
    return BLUR_PER_PLANE * moment_planes + moment_planes + channels * (2 + 12 + 1), channels


def loss_backward(moment_planes: int, channels: int = 3) -> tuple[int, int]:
    return BLUR_PER_PLANE * moment_planes + 2 * moment_planes + channels * (1 + 18), channels


# Adam per trained float: both moments (2 + 3), the bias corrections (2), the
# square root (1 MUFU) plus eps (1), the quotient (1 MUFU reciprocal, 1), the
# rate (1) and the update (1).
ADAM_PER_FLOAT = (11, 2)
# The densification statistics per Gaussian: the screen gradient's norm (3,
# 1 MUFU), the largest radius (1), the sums (2).
STATS_PER_GAUSSIAN = (6, 1)
# Compose per pixel: three multiply-adds of the background.
COMPOSE_PER_PIXEL = (3, 0)


def trained_floats(degree: int) -> int:
    """Floats a Gaussian trains: mean 3, SH 3 (d+1)^2, log-scale 3, quaternion 4, opacity 1."""
    return 3 + 3 * (degree + 1) ** 2 + 3 + 4 + 1


def least_s(f32: float, mufu: float = 0.0, n_bytes: float = 0.0) -> float:
    return max(f32 / F32_INSTR_RATE, mufu / MUFU_RATE, n_bytes / PEAK_BYTES)


def pairs_least_s(pairs: dict, backward: bool, n_bytes: float) -> float:
    """A blend kernel's least time from its pairs by kind."""
    f_tab, m_tab = (F32_MIN_PER_PAIR_BWD, MUFU_MIN_PER_PAIR_BWD) if backward else (F32_MIN_PER_PAIR, MUFU_MIN_PER_PAIR)
    return least_s(sum(c * f_tab[k] for k, c in pairs.items()), sum(c * m_tab[k] for k, c in pairs.items()),
                   n_bytes)


def blend_bytes(instances: int, tiles: int, gaussians: int, backward: bool) -> int:
    """Bytes a blend has to move: its instances (9 floats), the tile ranges
    and four planes a tile (colour and transmittance out, or the image
    cotangent and seed in); the backward also reads each instance's Gaussian
    id and writes 9 floats a Gaussian."""
    n = instances * 9 * 4 + (tiles + 1) * 4 + tiles * 4 * PIX * 4
    if backward:
        n += instances * 8 + gaussians * 9 * 4
    return n


def pairs_by_kind(work) -> dict:
    """A walk's [T, 5] work count as {kind: pairs}."""
    return dict(zip(WORK_KINDS, (int(v) for v in work.sum(dim=0).tolist())))
