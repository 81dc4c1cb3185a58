"""Per-tile front-to-back alpha blend, its backward and its counting form:
the CUDA kernels, their plain versions, and their launch counters.

Port of `blend_forward`, `blend_forward_fast`, `blend_backward`,
`blend_forward_counting` and `unchunk_transpose` of
`lightgaussian_tpu/ops/rasterize/pallas_blend.py`. The kernels live in
`csrc/blend_forward.cu`, `csrc/blend_backward.cu`, `csrc/blend_count.cu`
and `csrc/unchunk_transpose.cu`; those files say what bounds them and how
they are laid out (`csrc/blend_tile.cuh` holds what the forward and the
backward share). They are built with `nvcc` for
sm_90a at first use (`utils/cuda_build.py`) and bound with `ctypes`.

The forward and backward kernels skip, warp by warp, the instances whose
alpha >= 1/255 level set cannot reach the warp's pixels, and spare the pairs
under that level their exp. `plain_cull_rect` and `plain_cull_level` are the
plain twins of the device functions that bound the set by a rectangle and
give the level; the plain versions take `cull=True` to drop the same pairs, which
changes none of their outputs, and `cull_census` counts what the cull and
the warps' compact footprints leave of a walk. `instance_cull` runs the
device functions themselves over a binning, to be held against
`plain_instance_cull`. None of these is on the main path.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. The plain versions are pure torch, vectorised
over tiles, with `torch.cumprod` transmittance prefixes (the JAX kernels'
masked-prefix form) and, in the backward, `torch.cumsum` prefixes of the
remaining contribution.

Kernels and plain versions walk a tile's range in the 128-instance chunks of
the instance buffer, aligned to multiples of 128 as the JAX kernels' chunks
are, and test the early exit after each chunk. The render-only blend's naive
T depends on where the walk stops, so with the same chunks it equals the JAX
package's; the backward gives zero to every instance past the exit, as the
JAX backward does. `chip_smoke.py` holds each kernel against its plain
version on the card.

Inputs: `tile_starts` int32 [T+1] and `inst` float32 [M, FEAT_WIDTH] from
`binning.bin_splats`. Outputs: tile RGB [T, 3, 1024] and tile T [T, 1,
1024]; the backward's per-Gaussian gradients [N, FEAT_WIDTH]; the counting
blend's per-Gaussian importance float32 [N] and hit count int32 [N].
"""
from __future__ import annotations

import ctypes

import torch

from lightgaussian_tpu_torch.ops.rasterize.binning import (
    FEAT_B,
    FEAT_CA,
    FEAT_CB,
    FEAT_CC,
    FEAT_MX,
    FEAT_MY,
    FEAT_OPA,
    FEAT_R,
    FEAT_WIDTH,
    TILE_SIZE,
    TileGrid,
)
from lightgaussian_tpu_torch.ops.rasterize.projection import ALPHA_EPS, MAX_ALPHA, T_EPS
from lightgaussian_tpu_torch.utils import cuda_build

PIX = TILE_SIZE * TILE_SIZE
BATCH = 128  # instances per chunk, in the kernels and in their plain versions

FORWARD_SOURCE = cuda_build.CSRC / "blend_forward.cu"
BACKWARD_SOURCE = cuda_build.CSRC / "blend_backward.cu"
COUNT_SOURCE = cuda_build.CSRC / "blend_count.cu"
UNCHUNK_SOURCE = cuda_build.CSRC / "unchunk_transpose.cu"

# Tiles the plain versions blend at once: about _TILE_GROUP * BATCH * PIX
# floats per intermediate.
_TILE_GROUP = 256

# Columns of the plain versions' work count: the (instance, in-image pixel)
# pairs a kernel has to evaluate on its inputs, by how far the per-pair code
# of the kernels runs for them: rejected at power > 0; rejected at alpha <
# 1/255; eligible and applied; eligible and ending the pixel's blend;
# eligible past that end (only the render-only kernel's naive T walks those).
WORK_KINDS = ("culled", "faint", "applied", "stopping", "past_stop")

# Launches of each kernel since the last reset (the plain versions do not count).
LAUNCHES = {"blend_forward": 0, "blend_forward_fast": 0, "blend_backward": 0, "blend_count": 0,
            "unchunk_transpose": 0}
_SYMBOLS = {
    "blend_forward": "lg_blend_forward",
    "blend_forward_fast": "lg_blend_forward_fast",
    "blend_backward": "lg_blend_backward",
    "blend_count": "lg_blend_count",
    "unchunk_transpose": "lg_unchunk_transpose",
}
_P, _I = ctypes.c_void_p, ctypes.c_int
_FORWARD_ARGS = [_P] * 5 + [_I] * 4 + [_P]
_BACKWARD_ARGS = [_P] * 7 + [_I] * 4 + [_P]
_COUNT_ARGS = [_P] * 7 + [_I] * 4 + [_P]
_UNCHUNK_ARGS = [_P] * 2 + [_I] * 2 + [_P]
_INSTANCE_CULL_ARGS = [_P] * 4 + [_I] * 3 + [_P]


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _forward_library() -> ctypes.CDLL:
    return cuda_build.load(FORWARD_SOURCE, {
        "lg_blend_forward": _FORWARD_ARGS, "lg_blend_forward_fast": _FORWARD_ARGS,
        "lg_instance_cull": _INSTANCE_CULL_ARGS,
    })


def _backward_library() -> ctypes.CDLL:
    return cuda_build.load(BACKWARD_SOURCE, {"lg_blend_backward": _BACKWARD_ARGS})


def _count_library() -> ctypes.CDLL:
    return cuda_build.load(COUNT_SOURCE, {"lg_blend_count": _COUNT_ARGS})


def _unchunk_library() -> ctypes.CDLL:
    return cuda_build.load(UNCHUNK_SOURCE, {"lg_unchunk_transpose": _UNCHUNK_ARGS})


def _check_inputs(tile_starts: torch.Tensor, inst: torch.Tensor, grid: TileGrid) -> None:
    if tile_starts.dtype != torch.int32 or tuple(tile_starts.shape) != (grid.num_tiles + 1,):
        raise ValueError(
            f"tile_starts must be int32 [{grid.num_tiles + 1}], got "
            f"{tile_starts.dtype} {tuple(tile_starts.shape)}"
        )
    if inst.dtype != torch.float32 or inst.dim() != 2 or inst.shape[1] != FEAT_WIDTH:
        raise ValueError(f"inst must be float32 [M, {FEAT_WIDTH}], got {inst.dtype} {tuple(inst.shape)}")
    if tile_starts.device != inst.device:
        raise ValueError(f"tile_starts on {tile_starts.device}, inst on {inst.device}")
    if not (tile_starts.is_contiguous() and inst.is_contiguous()):
        raise ValueError("tile_starts and inst must be contiguous")


def _order_scratch(grid: TileGrid, device: torch.device) -> torch.Tensor:
    """int32 [T] for the forward and backward entry points to fill with the
    tiles by falling range length: their blocks take tiles in that order."""
    return torch.empty(grid.num_tiles, dtype=torch.int32, device=device)


def _launch(name: str, tile_starts: torch.Tensor, inst: torch.Tensor, grid: TileGrid):
    dev = inst.device
    t = grid.num_tiles
    order = _order_scratch(grid, dev)
    rgb = torch.empty((t, 3, PIX), dtype=torch.float32, device=dev)
    t_out = torch.empty((t, 1, PIX), dtype=torch.float32, device=dev)
    fn = getattr(_forward_library(), _SYMBOLS[name])
    with torch.cuda.device(dev):
        err = fn(
            tile_starts.data_ptr(), order.data_ptr(), inst.data_ptr(), rgb.data_ptr(), t_out.data_ptr(),
            t, grid.tiles_x, grid.width, grid.height, cuda_build.stream_of(inst),
        )
    cuda_build.check(err, _SYMBOLS[name])
    LAUNCHES[name] += 1
    return rgb, t_out


def _dispatch(name: str, exact: bool, tile_starts, inst, grid):
    _check_inputs(tile_starts, inst, grid)
    if inst.device.type == "cpu":
        rgb, t, _ = plain_blend(tile_starts, inst, grid, exact=exact)
        return rgb, t
    if inst.device.type != "cuda":
        raise ValueError(f"blend kernels run on CUDA or, as plain torch, on the CPU; got {inst.device}")
    return _launch(name, tile_starts, inst, grid)


def blend_forward(tile_starts: torch.Tensor, inst: torch.Tensor, grid: TileGrid):
    """Exact blend (B1). Returns (tile_rgb [T, 3, PIX], tile_T [T, 1, PIX])
    with the applied transmittance."""
    return _dispatch("blend_forward", True, tile_starts, inst, grid)


def blend_forward_fast(tile_starts: torch.Tensor, inst: torch.Tensor, grid: TileGrid):
    """Render-only blend (B6): as `blend_forward`, but tile_T is the naive
    transmittance (differs only on saturated pixels, by under 1e-2)."""
    return _dispatch("blend_forward_fast", False, tile_starts, inst, grid)


def _check_backward_inputs(tile_starts, inst, gid_sorted, tile_g, tile_r, grid: TileGrid) -> None:
    _check_inputs(tile_starts, inst, grid)
    t, m = grid.num_tiles, inst.shape[0]
    if gid_sorted.dtype != torch.int64 or tuple(gid_sorted.shape) != (m,):
        raise ValueError(f"gid_sorted must be int64 [{m}], got {gid_sorted.dtype} {tuple(gid_sorted.shape)}")
    for name, x, c in (("tile_g", tile_g, 3), ("tile_r", tile_r, 1)):
        if x.dtype != torch.float32 or tuple(x.shape) != (t, c, PIX):
            raise ValueError(f"{name} must be float32 [{t}, {c}, {PIX}], got {x.dtype} {tuple(x.shape)}")
    if any(x.device != inst.device for x in (gid_sorted, tile_g, tile_r)):
        raise ValueError("the backward's inputs must lie on one device")
    if not all(x.is_contiguous() for x in (gid_sorted, tile_g, tile_r)):
        raise ValueError("gid_sorted, tile_g and tile_r must be contiguous")


def blend_backward(
    tile_starts: torch.Tensor,
    inst: torch.Tensor,
    gid_sorted: torch.Tensor,
    tile_g: torch.Tensor,
    tile_r: torch.Tensor,
    grid: TileGrid,
    num_gaussians: int,
) -> torch.Tensor:
    """Backward of the exact blend (B2): per-Gaussian gradients [N,
    FEAT_WIDTH] of the features `inst` holds, from the image cotangent laid
    out per tile (`tile_g` [T, 3, PIX]) and the per-pixel remaining-
    contribution seed (`tile_r` [T, 1, PIX]). `gid_sorted` is the binning's
    instance -> Gaussian map (every entry below `num_gaussians`). Gaussians
    that no tile holds get exact zeros."""
    _check_backward_inputs(tile_starts, inst, gid_sorted, tile_g, tile_r, grid)
    if inst.device.type == "cpu":
        per_inst, _ = plain_blend_backward(tile_starts, inst, tile_g, tile_r, grid)
        return reduce_per_gaussian(per_inst, gid_sorted, num_gaussians)
    if inst.device.type != "cuda":
        raise ValueError(f"blend kernels run on CUDA or, as plain torch, on the CPU; got {inst.device}")
    grads = torch.zeros((num_gaussians, FEAT_WIDTH), dtype=torch.float32, device=inst.device)
    order = _order_scratch(grid, inst.device)
    fn = _backward_library().lg_blend_backward
    with torch.cuda.device(inst.device):
        err = fn(
            tile_starts.data_ptr(), order.data_ptr(), inst.data_ptr(), gid_sorted.data_ptr(), tile_g.data_ptr(),
            tile_r.data_ptr(), grads.data_ptr(), grid.num_tiles, grid.tiles_x, grid.width,
            grid.height, cuda_build.stream_of(inst),
        )
    cuda_build.check(err, _SYMBOLS["blend_backward"])
    LAUNCHES["blend_backward"] += 1
    return grads


def _check_counting_inputs(tile_starts, inst, gid_sorted, grid: TileGrid, num_gaussians: int) -> None:
    _check_inputs(tile_starts, inst, grid)
    m = inst.shape[0]
    if gid_sorted.dtype != torch.int64 or tuple(gid_sorted.shape) != (m,):
        raise ValueError(f"gid_sorted must be int64 [{m}], got {gid_sorted.dtype} {tuple(gid_sorted.shape)}")
    if gid_sorted.device != inst.device:
        raise ValueError(f"gid_sorted on {gid_sorted.device}, inst on {inst.device}")
    if not gid_sorted.is_contiguous():
        raise ValueError("gid_sorted must be contiguous")
    if num_gaussians < 0:
        raise ValueError(f"num_gaussians must not be negative, got {num_gaussians}")


def blend_forward_counting(
    tile_starts: torch.Tensor,
    inst: torch.Tensor,
    gid_sorted: torch.Tensor,
    grid: TileGrid,
    num_gaussians: int,
):
    """Counting blend (B5): the exact blend's (tile_rgb, tile_T), plus per
    Gaussian the summed blending weight alpha * T over every pixel it was
    blended into (`imp` float32 [N]) and the number of those pixels (`cnt`
    int32 [N]). `gid_sorted` is the binning's instance -> Gaussian map (every
    entry below `num_gaussians`). Gaussians that no tile holds get exact
    zeros. No backward."""
    _check_counting_inputs(tile_starts, inst, gid_sorted, grid, num_gaussians)
    if inst.device.type == "cpu":
        rgb, t, imp, cnt, _ = plain_blend_counting(tile_starts, inst, gid_sorted, grid, num_gaussians)
        return rgb, t, imp, cnt
    if inst.device.type != "cuda":
        raise ValueError(f"blend kernels run on CUDA or, as plain torch, on the CPU; got {inst.device}")
    dev = inst.device
    t = grid.num_tiles
    rgb = torch.empty((t, 3, PIX), dtype=torch.float32, device=dev)
    t_out = torch.empty((t, 1, PIX), dtype=torch.float32, device=dev)
    imp = torch.zeros(num_gaussians, dtype=torch.float32, device=dev)
    cnt = torch.zeros(num_gaussians, dtype=torch.int32, device=dev)
    fn = _count_library().lg_blend_count
    with torch.cuda.device(dev):
        err = fn(
            tile_starts.data_ptr(), inst.data_ptr(), gid_sorted.data_ptr(), rgb.data_ptr(),
            t_out.data_ptr(), imp.data_ptr(), cnt.data_ptr(), t, grid.tiles_x, grid.width,
            grid.height, cuda_build.stream_of(inst),
        )
    cuda_build.check(err, _SYMBOLS["blend_count"])
    LAUNCHES["blend_count"] += 1
    return rgb, t_out, imp, cnt


# The transpose kernel's grid has one row of blocks per 32 features.
_UNCHUNK_MAX_FEATURES = 32 * 65535


def unchunk_transpose(x: torch.Tensor) -> torch.Tensor:
    """[NC, F, 128] chunk-major -> [NC * 128, F] instance-major (B8), for
    float32 of any NC and F. Nothing in the port's product paths calls it
    (their buffers are instance-major from the start); it is the
    counterpart of the JAX package's transpose kernel, for tools that read
    chunk-major buffers."""
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[2] != BATCH:
        raise ValueError(f"x must be float32 [NC, F, {BATCH}], got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type == "cpu":
        return plain_unchunk_transpose(x)
    if x.device.type != "cuda":
        raise ValueError(f"unchunk_transpose runs on CUDA or, as plain torch, on the CPU; got {x.device}")
    nc, f, _ = x.shape
    if f > _UNCHUNK_MAX_FEATURES:
        raise ValueError(f"unchunk_transpose takes at most {_UNCHUNK_MAX_FEATURES} features, got {f}")
    out = torch.empty((nc * BATCH, f), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    fn = _unchunk_library().lg_unchunk_transpose
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), nc, f, cuda_build.stream_of(x))
    cuda_build.check(err, _SYMBOLS["unchunk_transpose"])
    LAUNCHES["unchunk_transpose"] += 1
    return out


def plain_unchunk_transpose(x: torch.Tensor) -> torch.Tensor:
    """Plain-torch version of `unchunk_transpose`."""
    return x.permute(0, 2, 1).reshape(-1, x.shape[1])


def reduce_per_gaussian(per_inst: torch.Tensor, gid_sorted: torch.Tensor, num_gaussians: int) -> torch.Tensor:
    """Sum per-instance rows [M, F] into per-Gaussian rows [N, F]."""
    out = torch.zeros((num_gaussians, per_inst.shape[1]), dtype=per_inst.dtype, device=per_inst.device)
    return out.index_add_(0, gid_sorted, per_inst)


# The cull's margins, as csrc/blend_tile.cuh holds them.
CULL_MIN_DET = 1e-3  # det / (ca cc) under which the conic counts as singular
CULL_LEVEL_REL, CULL_LEVEL_ABS = 1e-4, 0.01  # on log(255 opa): exp and log
CULL_ROUNDING = 1e-6  # times (ca + cc + 2 |cb|) far^2: the float32 power's rounding over the tile
CULL_WIDTH_REL, CULL_WIDTH_ABS = 1.001, 1.0  # on the half-widths; pixels
CULL_MAX_WIDTH = 1e6
# A warp's rectangle and a cell (the warp's 32 pixels at one k), in pixels.
WARP_RECT = (16, 8)
CELL = (8, 4)


def plain_cull_level(f: torch.Tensor) -> torch.Tensor:
    """Plain twin of `cull_level` (csrc/blend_tile.cuh): log(255 opa) with
    the margin for exp and log, per instance of `f` [..., FEAT_WIDTH]. A pair
    whose power lies under minus this has alpha < 1/255 (the kernels skip its
    exp); NaN where the opacity is negative, which no test passes."""
    return torch.log(255.0 * f[..., FEAT_OPA]) * (1.0 + CULL_LEVEL_REL) + CULL_LEVEL_ABS


def plain_cull_rect(f: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor):
    """Plain twin of `cull_cells` (csrc/blend_tile.cuh): for instances `f`
    [..., FEAT_WIDTH] in tiles whose first pixel is (`ox`, `oy`) (float32,
    broadcastable to `f`'s leading shape), the tile-local rectangle (x0, x1,
    y0, y1), int64 and inclusive, outside which no pixel of the tile can be
    eligible. An empty rectangle is (1, 0, 1, 0); an instance whose level set
    cannot be boxed keeps the whole tile (0, 31, 0, 31).

    Eligible means alpha = opa exp(power) >= 1/255, that is power >=
    -log(255 opa), and the conic bounds that level set: |dx| <= sqrt(2 L cc /
    det), |dy| <= sqrt(2 L ca / det). L is raised by the rounding the float32
    power can carry at the tile's farthest pixel and by a margin for exp and
    log; the half-widths grow by 0.1% and one pixel."""
    mx, my = f[..., FEAT_MX], f[..., FEAT_MY]
    ca, cb, cc, opa = f[..., FEAT_CA], f[..., FEAT_CB], f[..., FEAT_CC], f[..., FEAT_OPA]
    last = float(TILE_SIZE - 1)
    det = ca * cc - cb * cb
    boxed = (opa > ALPHA_EPS) & (ca > 0.0) & (cc > 0.0) & (det > CULL_MIN_DET * (ca * cc))
    far_x = torch.maximum((ox - mx).abs(), (ox + last - mx).abs())
    far_y = torch.maximum((oy - my).abs(), (oy + last - my).abs())
    far = torch.maximum(far_x, far_y)
    level = plain_cull_level(f) + CULL_ROUNDING * (ca + cc + 2.0 * cb.abs()) * (far * far)
    k2 = 2.0 * level / det
    hx = torch.sqrt(k2 * cc) * CULL_WIDTH_REL + CULL_WIDTH_ABS
    hy = torch.sqrt(k2 * ca) * CULL_WIDTH_REL + CULL_WIDTH_ABS
    boxed = boxed & (hx < CULL_MAX_WIDTH) & (hy < CULL_MAX_WIDTH)
    x_lo, x_hi = mx - hx - ox, mx + hx - ox
    y_lo, y_hi = my - hy - oy, my + hy - oy
    empty = boxed & ~((x_hi >= 0.0) & (x_lo <= last) & (y_hi >= 0.0) & (y_lo <= last))

    def edge(v, whole: float, none: int):
        # the pixels lo <= x <= hi: from ceil(lo) to floor(hi)
        v = torch.ceil(v.clamp(min=0.0)) if whole == 0.0 else torch.floor(v.clamp(max=last))
        return torch.where(empty, none, torch.where(boxed, v, whole).to(torch.int64))

    return edge(x_lo, 0.0, 1), edge(x_hi, last, 0), edge(y_lo, 0.0, 1), edge(y_hi, last, 0)


def plain_cull_cells(f: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor) -> torch.Tensor:
    """The cells of `plain_cull_rect`'s rectangle as the kernels hold them: an
    int64 word whose bit row * 4 + col is set for each CELL (4 columns by 8
    rows of them a tile) the rectangle reaches; 0 for an empty rectangle."""
    x0, x1, y0, y1 = plain_cull_rect(f, ox, oy)
    (cw, ch), per_row = CELL, TILE_SIZE // CELL[0]
    c0, c1, r0, r1 = x0 // cw, x1 // cw, y0 // ch, y1 // ch
    cols = (2 << c1) - (1 << c0)  # bits c0..c1 of a row's four
    rows = ((1 << (per_row * (r1 + 1))) - 1) & ~((1 << (per_row * r0)) - 1)
    return torch.where(x1 >= x0, (cols * 0x11111111) & rows, 0)


def plain_instance_cull(tile_starts: torch.Tensor, inst: torch.Tensor, grid: TileGrid):
    """Plain version of `instance_cull`: for each row of `inst`, the
    `plain_cull_cells` word in the tile whose range holds it (0 for a row
    past the last range) and its `plain_cull_level`. Returns (cells int64
    [M], level float32 [M])."""
    rows = torch.arange(inst.shape[0], device=inst.device)
    starts = tile_starts[:-1].to(torch.int64).contiguous()
    tile = (torch.searchsorted(starts, rows, right=True) - 1).clamp(min=0)  # the last tile starting at or before
    ox = ((tile % grid.tiles_x) * TILE_SIZE).to(torch.float32)
    oy = ((tile // grid.tiles_x) * TILE_SIZE).to(torch.float32)
    cells = torch.where(rows < tile_starts[-1], plain_cull_cells(inst, ox, oy), 0)
    return cells, plain_cull_level(inst)


def instance_cull(tile_starts: torch.Tensor, inst: torch.Tensor, grid: TileGrid):
    """What the forward and backward kernels' staging computes for each row
    of `inst` in its tile: the cells its level set can reach (int64 [M], a
    32-bit word each) and its level (float32 [M]). On the card this runs
    `cull_cells` and `cull_level` of csrc/blend_tile.cuh themselves, so that
    they can be held against their plain twins; no product path calls it and
    it counts no launch."""
    _check_inputs(tile_starts, inst, grid)
    if inst.device.type == "cpu":
        return plain_instance_cull(tile_starts, inst, grid)
    if inst.device.type != "cuda":
        raise ValueError(f"blend kernels run on CUDA or, as plain torch, on the CPU; got {inst.device}")
    m = inst.shape[0]
    cells = torch.empty(m, dtype=torch.int32, device=inst.device)
    level = torch.empty(m, dtype=torch.float32, device=inst.device)
    fn = _forward_library().lg_instance_cull
    with torch.cuda.device(inst.device):
        err = fn(tile_starts.data_ptr(), inst.data_ptr(), cells.data_ptr(), level.data_ptr(), m,
                 grid.num_tiles, grid.tiles_x, cuda_build.stream_of(inst))
    cuda_build.check(err, "lg_instance_cull")
    return cells.to(torch.int64) & 0xFFFFFFFF, level


def cull_census(tile_starts: torch.Tensor, inst: torch.Tensor, grid: TileGrid) -> dict:
    """What the exact walk over these inputs asks of warps, counted with the
    plain version's per-pixel masks. Keys, all numbers of pairs:
      instances        instances walked (a tile's range up to its exit)
      warp_walked      (instance, warp) when every warp walks every instance: 8 an instance
      strided_applied  (instance, warp) with a pixel applied, a warp holding rows w, w+8, w+16, w+24
      compact_applied  the same with a warp holding a compact WARP_RECT
      cell_applied     (instance, cell) with a pixel applied, a CELL being a warp's pixels at one k
      warp_reached     (instance, warp) whose WARP_RECT the cull rectangle reaches
      cell_reached     (instance, cell) whose CELL it reaches: 32 pixel pairs each
    """
    census = dict.fromkeys(("instances", "warp_walked", "strided_applied", "compact_applied", "cell_applied",
                            "warp_reached", "cell_reached"), 0)
    if inst.shape[0] == 0:
        return census
    (ww, wh), (cw, ch) = WARP_RECT, CELL
    warps = (TILE_SIZE // ww) * (TILE_SIZE // wh)  # 8: one rectangle each
    walk = _Walk(tile_starts, grid)
    for ids, act in walk.groups():
        t_naive = torch.where(walk.pix_valid[ids], 1.0, 0.0)
        step = 0
        while act.numel():
            tid = ids[act]
            _, row_ok, f, _, _, _, _, alpha, elig = walk.chunk(inst, tid, step)
            _, incl, _, apply = _prefixes(alpha, t_naive[act])
            a, b = apply.shape[:2]
            grid4 = (apply & elig).reshape(a, b, TILE_SIZE, TILE_SIZE)  # [.., y, x]
            x0, x1, y0, y1 = plain_cull_rect(f, walk.px[tid][:, :1], walk.py[tid][:, :1])
            some = row_ok & (x1 >= x0)
            census["instances"] += int(row_ok.sum())
            census["strided_applied"] += int(grid4.reshape(a, b, -1, warps, TILE_SIZE).any(dim=4).any(dim=2).sum())
            census["compact_applied"] += int(
                grid4.reshape(a, b, TILE_SIZE // wh, wh, TILE_SIZE // ww, ww).any(dim=5).any(dim=3).sum())
            census["cell_applied"] += int(
                grid4.reshape(a, b, TILE_SIZE // ch, ch, TILE_SIZE // cw, cw).any(dim=5).any(dim=3).sum())
            for key, (w, h) in (("warp_reached", WARP_RECT), ("cell_reached", CELL)):
                n = (x1 // w - x0 // w + 1) * (y1 // h - y0 // h + 1)
                census[key] += int(n[some].sum())
            t_naive[act] = t_naive[act] * incl[:, -1]
            step += 1
            act = act[walk.more(tid, step, t_naive[act])]
    census["warp_walked"] = warps * census["instances"]
    return census


class _Walk:
    """What the plain versions share: each tile's range, first chunk and
    pixel coordinates."""

    def __init__(self, tile_starts: torch.Tensor, grid: TileGrid):
        dev = tile_starts.device
        self.starts = tile_starts[:-1].to(torch.int64)
        self.ends = tile_starts[1:].to(torch.int64)
        self.bases = self.starts // BATCH * BATCH  # each tile's first chunk
        lane = torch.arange(PIX, device=dev)
        self.tile_ids = torch.arange(grid.num_tiles, device=dev)
        px = ((self.tile_ids % grid.tiles_x) * TILE_SIZE)[:, None] + (lane % TILE_SIZE)[None, :]
        py = ((self.tile_ids // grid.tiles_x) * TILE_SIZE)[:, None] + (lane // TILE_SIZE)[None, :]
        self.pix_valid = (px < grid.width) & (py < grid.height)
        self.px, self.py = px.to(torch.float32), py.to(torch.float32)
        self.lx, self.ly = lane % TILE_SIZE, lane // TILE_SIZE  # tile-local
        self.rows_in_batch = torch.arange(BATCH, device=dev)

    def groups(self):
        """Groups of tile ids, and in each the rows whose range is not empty."""
        for g0 in range(0, self.tile_ids.numel(), _TILE_GROUP):
            ids = self.tile_ids[g0:g0 + _TILE_GROUP]
            act = torch.arange(ids.numel(), device=ids.device)
            yield ids, act[self.ends[ids] > self.starts[ids]]

    def chunk(self, inst: torch.Tensor, tid: torch.Tensor, step: int, cull: bool = False):
        """Chunk `step` of tiles `tid`: (rows [A, BATCH], row_ok, features
        [A, BATCH, FEAT_WIDTH], dx, dy, power, alpha_raw, alpha, elig), with
        alpha zeroed where the instance is not eligible. With `cull`, pairs
        outside the instance's `plain_cull_rect` or with a power under minus
        its `plain_cull_level` are not eligible either."""
        rows = self.bases[tid][:, None] + step * BATCH + self.rows_in_batch[None, :]
        row_ok = (rows >= self.starts[tid][:, None]) & (rows < self.ends[tid][:, None])
        f = inst[torch.clamp(rows, max=inst.shape[0] - 1)]
        dx = self.px[tid][:, None, :] - f[..., FEAT_MX:FEAT_MX + 1]
        dy = self.py[tid][:, None, :] - f[..., FEAT_MY:FEAT_MY + 1]
        ca = f[..., FEAT_CA:FEAT_CA + 1]
        cb = f[..., FEAT_CB:FEAT_CB + 1]
        cc = f[..., FEAT_CC:FEAT_CC + 1]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha_raw = f[..., FEAT_OPA:FEAT_OPA + 1] * torch.exp(power)
        alpha = torch.clamp(alpha_raw, max=MAX_ALPHA)
        elig = (
            (power <= 0.0) & (alpha >= ALPHA_EPS)
            & self.pix_valid[tid][:, None, :] & row_ok[:, :, None]
        )
        if cull:
            elig = elig & self.inside_cull_rect(f, tid) & ~(power < -plain_cull_level(f)[..., None])
        alpha = torch.where(elig, alpha, 0.0)
        return rows, row_ok, f, dx, dy, power, alpha_raw, alpha, elig

    def inside_cull_rect(self, f: torch.Tensor, tid: torch.Tensor) -> torch.Tensor:
        """[A, BATCH, PIX]: the pixels inside each instance's cull rectangle."""
        x0, x1, y0, y1 = plain_cull_rect(f, self.px[tid][:, :1], self.py[tid][:, :1])
        lx, ly = self.lx[None, None, :], self.ly[None, None, :]
        return (lx >= x0[..., None]) & (lx <= x1[..., None]) & (ly >= y0[..., None]) & (ly <= y1[..., None])

    def work(self, tid, row_ok, power, elig, t_i, apply, exact: bool) -> torch.Tensor:
        """[A, len(WORK_KINDS)] pairs of this chunk by kind. The exact walk
        covers a pixel only while it still blends (naive T >= T_EPS); the
        render-only one's naive T needs every pixel."""
        walked = row_ok[:, :, None] & self.pix_valid[tid][:, None, :]
        blending = t_i >= T_EPS
        if exact:
            walked = walked & blending
        culled = power > 0.0
        kinds = (
            walked & culled,
            walked & ~culled & ~elig,
            walked & elig & apply,
            walked & elig & ~apply & blending,
            walked & elig & ~blending,
        )
        return torch.stack([k.sum(dim=(1, 2)) for k in kinds], dim=1)

    def more(self, tid, step: int, t_naive: torch.Tensor) -> torch.Tensor:
        """The exit test after chunk `step`: rows left and a pixel blending."""
        return (self.bases[tid] + step * BATCH < self.ends[tid]) & (t_naive.amax(dim=1) >= T_EPS)


def _prefixes(alpha: torch.Tensor, t_naive: torch.Tensor):
    """(1 - alpha, inclusive prefix product of it, T_i, apply) of a chunk."""
    om = 1.0 - alpha
    incl = torch.cumprod(om, dim=1)
    excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
    t_i = t_naive[:, None, :] * excl
    return om, incl, t_i, (t_i * om) >= T_EPS


def plain_blend(tile_starts: torch.Tensor, inst: torch.Tensor, grid: TileGrid, exact: bool, cull: bool = False):
    """Plain-torch version of both forward kernels.

    Returns (tile_rgb [T, 3, PIX], tile_T [T, 1, PIX], work [T, 5]), where
    `work` counts, per tile and per kind of `WORK_KINDS`, the (instance,
    in-image pixel) pairs the kernel has to evaluate on these inputs: the
    exact blend walks a pixel only until its blend ends, the render-only one
    every pixel until the tile exits. It bounds the kernels' time. `cull`
    drops the pairs outside each instance's `plain_cull_rect` or under its
    `plain_cull_level`, as the kernels do; no output changes.
    """
    return _plain_forward(tile_starts, inst, grid, exact, None, cull)


def plain_blend_counting(
    tile_starts: torch.Tensor,
    inst: torch.Tensor,
    gid_sorted: torch.Tensor,
    grid: TileGrid,
    num_gaussians: int,
    cull: bool = False,
):
    """Plain-torch version of the counting kernel: `plain_blend(exact=True)`
    with, per instance, the sum of its weights w = alpha * T over the tile's
    pixels and the number of pixels with w > 0, added up per Gaussian with
    `index_add_`. Instances past a tile's exit keep zeros: once every pixel
    has stopped, nothing after it is applied.

    Returns (tile_rgb, tile_T, imp float32 [N], cnt int32 [N], work [T, 5]).
    """
    m, dev = inst.shape[0], inst.device
    w_sum = torch.zeros(m, dtype=torch.float32, device=dev)
    hits = torch.zeros(m, dtype=torch.int64, device=dev)
    rgb, t, work = _plain_forward(tile_starts, inst, grid, True, (w_sum, hits), cull)
    imp = torch.zeros(num_gaussians, dtype=torch.float32, device=dev).index_add_(0, gid_sorted, w_sum)
    cnt = torch.zeros(num_gaussians, dtype=torch.int64, device=dev).index_add_(0, gid_sorted, hits)
    return rgb, t, imp, cnt.to(torch.int32), work


def _plain_forward(tile_starts, inst, grid: TileGrid, exact: bool, stats, cull: bool = False):
    """The forward walk of `plain_blend`; `stats`, when given, is the pair
    (w_sum [M], hits [M]) of per-instance tensors to fill."""
    dev = inst.device
    num_tiles = grid.num_tiles
    rgb_out = torch.zeros((num_tiles, 3, PIX), dtype=torch.float32, device=dev)
    t_out = torch.ones((num_tiles, 1, PIX), dtype=torch.float32, device=dev)
    work = torch.zeros((num_tiles, len(WORK_KINDS)), dtype=torch.int64, device=dev)
    if inst.shape[0] == 0:
        return rgb_out, t_out, work

    walk = _Walk(tile_starts, grid)
    for ids, act in walk.groups():
        # Out-of-image pixels start at 0 so they never hold the exit back.
        t_naive = torch.where(walk.pix_valid[ids], 1.0, 0.0)
        t_act = torch.ones_like(t_naive)
        rgb = torch.zeros((ids.numel(), 3, PIX), dtype=torch.float32, device=dev)
        step = 0
        while act.numel():
            tid = ids[act]
            rows, row_ok, f, _, _, power, _, alpha, elig = walk.chunk(inst, tid, step, cull)
            _, incl, t_i, apply = _prefixes(alpha, t_naive[act])
            w = torch.where(apply, alpha * t_i, 0.0)
            if stats is not None:  # each row belongs to one tile
                stats[0][rows[row_ok]] = w.sum(dim=-1)[row_ok]
                stats[1][rows[row_ok]] = (w > 0.0).sum(dim=-1)[row_ok]
            col = f[..., FEAT_R:FEAT_B + 1]  # [A, BATCH, 3]
            rgb[act] += torch.einsum("abc,abp->acp", col, w)
            t_naive[act] = t_naive[act] * incl[:, -1]
            if exact:
                t_act[act] = t_act[act] * torch.where(apply, incl, 1.0).amin(dim=1)
            work[tid] += walk.work(tid, row_ok, power, elig, t_i, apply, exact)
            step += 1
            act = act[walk.more(tid, step, t_naive[act])]
        rgb_out[ids] = rgb
        if exact:
            t_out[ids, 0] = t_act
        else:
            t_out[ids, 0] = torch.where(walk.pix_valid[ids], t_naive, 1.0)
    return rgb_out, t_out, work


def plain_blend_backward(
    tile_starts: torch.Tensor,
    inst: torch.Tensor,
    tile_g: torch.Tensor,
    tile_r: torch.Tensor,
    grid: TileGrid,
    cull: bool = False,
):
    """Plain-torch version of the backward kernel, per instance.

    Returns (inst_grads [M, FEAT_WIDTH], work [T, 5]): the gradient of each
    instance's features from its own tile (each row belongs to one tile),
    and the pairs walked by kind, as `plain_blend(exact=True)` counts them.
    Within a chunk the remaining contribution after each instance is the
    carry minus a `torch.cumsum` prefix of colour . g times its weight, as in
    the JAX kernel.
    """
    dev = inst.device
    m, num_tiles = inst.shape[0], grid.num_tiles
    grads = torch.zeros((m, FEAT_WIDTH), dtype=torch.float32, device=dev)
    work = torch.zeros((num_tiles, len(WORK_KINDS)), dtype=torch.int64, device=dev)
    if m == 0:
        return grads, work

    walk = _Walk(tile_starts, grid)
    for ids, act in walk.groups():
        t_naive = torch.where(walk.pix_valid[ids], 1.0, 0.0)
        r_carry = tile_r[ids, 0].clone()
        g_all = tile_g[ids]  # [G, 3, PIX]
        step = 0
        while act.numel():
            tid = ids[act]
            rows, row_ok, f, dx, dy, power, alpha_raw, alpha, elig = walk.chunk(inst, tid, step, cull)
            om, incl, t_i, apply = _prefixes(alpha, t_naive[act])
            w = torch.where(apply, alpha * t_i, 0.0)
            g = g_all[act][:, None]  # [A, 1, 3, PIX]
            cw = (
                f[..., FEAT_R:FEAT_R + 1] * g[:, :, 0] + f[..., FEAT_R + 1:FEAT_R + 2] * g[:, :, 1]
                + f[..., FEAT_B:FEAT_B + 1] * g[:, :, 2]
            )
            prefix = torch.cumsum(cw * w, dim=1)
            r_i = r_carry[act][:, None, :] - prefix
            d_alpha = cw * t_i - r_i / om
            # the 0.99 clamp and the eligibility gates are cut-offs: no gradient
            d_power = torch.where((alpha_raw < MAX_ALPHA) & apply, d_alpha, 0.0) * alpha
            q1, q2 = d_power * dx, d_power * dy
            s0 = d_power.sum(-1)
            sx, sy = q1.sum(-1), q2.sum(-1)
            sxx, sxy, syy = (q1 * dx).sum(-1), (q1 * dy).sum(-1), (q2 * dy).sum(-1)
            d_col = torch.einsum("abp,acp->abc", w, g_all[act])
            ca, cb, cc = f[..., FEAT_CA], f[..., FEAT_CB], f[..., FEAT_CC]
            d = torch.cat([
                torch.stack([ca * sx + cb * sy, cc * sy + cb * sx, -0.5 * sxx, -sxy, -0.5 * syy], -1),
                d_col,
                (s0 / torch.clamp(f[..., FEAT_OPA], min=1e-12))[..., None],
            ], dim=-1)
            grads[rows[row_ok]] = d[row_ok]
            work[tid] += walk.work(tid, row_ok, power, elig, t_i, apply, exact=True)
            t_naive[act] = t_naive[act] * incl[:, -1]
            r_carry[act] = r_carry[act] - prefix[:, -1]
            step += 1
            act = act[walk.more(tid, step, t_naive[act])]
    return grads, work
