"""Per-tile front-to-back alpha blend and its backward: the CUDA kernels,
their plain versions, and their launch counters.

Port of `blend_forward`, `blend_forward_fast` and `blend_backward` of
`lightgaussian_tpu/ops/rasterize/pallas_blend.py`. The kernels live in
`csrc/blend_forward.cu` and `csrc/blend_backward.cu`; those files say what
bounds them and how they are laid out. They are built with `nvcc` for
sm_90a at first use (`utils/cuda_build.py`) and bound with `ctypes`.

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
1024]; the backward's per-Gaussian gradients [N, FEAT_WIDTH].
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
LAUNCHES = {"blend_forward": 0, "blend_forward_fast": 0, "blend_backward": 0}
_SYMBOLS = {
    "blend_forward": "lg_blend_forward",
    "blend_forward_fast": "lg_blend_forward_fast",
    "blend_backward": "lg_blend_backward",
}
_P, _I = ctypes.c_void_p, ctypes.c_int
_FORWARD_ARGS = [_P] * 4 + [_I] * 4 + [_P]
_BACKWARD_ARGS = [_P] * 6 + [_I] * 4 + [_P]


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _forward_library() -> ctypes.CDLL:
    return cuda_build.load(FORWARD_SOURCE, {
        "lg_blend_forward": _FORWARD_ARGS, "lg_blend_forward_fast": _FORWARD_ARGS,
    })


def _backward_library() -> ctypes.CDLL:
    return cuda_build.load(BACKWARD_SOURCE, {"lg_blend_backward": _BACKWARD_ARGS})


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


def _launch(name: str, tile_starts: torch.Tensor, inst: torch.Tensor, grid: TileGrid):
    dev = inst.device
    t = grid.num_tiles
    rgb = torch.empty((t, 3, PIX), dtype=torch.float32, device=dev)
    t_out = torch.empty((t, 1, PIX), dtype=torch.float32, device=dev)
    fn = getattr(_forward_library(), _SYMBOLS[name])
    with torch.cuda.device(dev):
        err = fn(
            tile_starts.data_ptr(), inst.data_ptr(), rgb.data_ptr(), t_out.data_ptr(),
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
    fn = _backward_library().lg_blend_backward
    with torch.cuda.device(inst.device):
        err = fn(
            tile_starts.data_ptr(), inst.data_ptr(), gid_sorted.data_ptr(), tile_g.data_ptr(),
            tile_r.data_ptr(), grads.data_ptr(), grid.num_tiles, grid.tiles_x, grid.width,
            grid.height, cuda_build.stream_of(inst),
        )
    cuda_build.check(err, _SYMBOLS["blend_backward"])
    LAUNCHES["blend_backward"] += 1
    return grads


def reduce_per_gaussian(per_inst: torch.Tensor, gid_sorted: torch.Tensor, num_gaussians: int) -> torch.Tensor:
    """Sum per-instance rows [M, F] into per-Gaussian rows [N, F]."""
    out = torch.zeros((num_gaussians, per_inst.shape[1]), dtype=per_inst.dtype, device=per_inst.device)
    return out.index_add_(0, gid_sorted, per_inst)


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
        self.rows_in_batch = torch.arange(BATCH, device=dev)

    def groups(self):
        """Groups of tile ids, and in each the rows whose range is not empty."""
        for g0 in range(0, self.tile_ids.numel(), _TILE_GROUP):
            ids = self.tile_ids[g0:g0 + _TILE_GROUP]
            act = torch.arange(ids.numel(), device=ids.device)
            yield ids, act[self.ends[ids] > self.starts[ids]]

    def chunk(self, inst: torch.Tensor, tid: torch.Tensor, step: int):
        """Chunk `step` of tiles `tid`: (rows [A, BATCH], row_ok, features
        [A, BATCH, FEAT_WIDTH], dx, dy, power, alpha_raw, alpha, elig), with
        alpha zeroed where the instance is not eligible."""
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
        alpha = torch.where(elig, alpha, 0.0)
        return rows, row_ok, f, dx, dy, power, alpha_raw, alpha, elig

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


def plain_blend(tile_starts: torch.Tensor, inst: torch.Tensor, grid: TileGrid, exact: bool):
    """Plain-torch version of both forward kernels.

    Returns (tile_rgb [T, 3, PIX], tile_T [T, 1, PIX], work [T, 5]), where
    `work` counts, per tile and per kind of `WORK_KINDS`, the (instance,
    in-image pixel) pairs the kernel has to evaluate on these inputs: the
    exact blend walks a pixel only until its blend ends, the render-only one
    every pixel until the tile exits. It bounds the kernels' time.
    """
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
            _, row_ok, f, _, _, power, _, alpha, elig = walk.chunk(inst, tid, step)
            _, incl, t_i, apply = _prefixes(alpha, t_naive[act])
            w = torch.where(apply, alpha * t_i, 0.0)
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
            rows, row_ok, f, dx, dy, power, alpha_raw, alpha, elig = walk.chunk(inst, tid, step)
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
