"""Tile binning: duplicate splats into a (tile, depth)-sorted instance buffer.

Port of the binning of `lightgaussian_tpu/ops/rasterize/binning.py`,
in torch ops on the splats' device. Each Gaussian is duplicated once per tile
that its alpha support touches (the tightened rect of `tile_rect` and the
exact ellipse-vs-tile test of `_exact_tile_mask`); the duplicates are sorted
by one (tile | range-adaptive depth) key whose value equals the JAX package's
u32 key, so `total`, `tile_starts` and each tile's ordered set of Gaussian
ids equal the JAX package's.

Unlike the JAX package, the instance buffer is sized per frame from the live
count (one host read of `total`), and holds only live instances, instance-
major `[M, FEAT_WIDTH]`. A capacity from `max_instances` is still honoured
the way the JAX package honours it: instances past it are dropped, and
`total` reports the count before the cut. The port's own ceiling is its
index widths' (`MAX_CAPACITY`, the int32 `tile_starts`), not the JAX
package's 2^24: a frame of more live instances than that raises, and a
render given no cut (`MAX_CAPACITY`) renders every live instance.

The depth's float32 bit pattern is read as an int32 (depths of binned
splats are positive and finite). The key is below 2^32; it is sorted as an
int32 with its top bit flipped (the key less 2^31), which a signed sort
orders as the unsigned key.

Two pieces are CUDA kernels on CUDA tensors (`csrc/bin_cover.cu`, rows of
`utils/cuda_build.py`'s kernel table): the tile cover, piece (a)
(`lg_bin_cover`), and the instance emission, pieces (c) and (d)
(`lg_bin_emit`: each slot's Gaussian, tile and key). On CPU tensors
`plain_cover` and `plain_emit` run them as the torch chains the kernels
replace (`tile_rect` + `_exact_tile_mask`; `_fill_slots` + `_depth_key`),
whose outputs the kernels equal bit for bit on the card. The other pieces
are torch ops on either device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from lightgaussian_tpu_torch.ops.rasterize.projection import ALPHA_EPS, Splats
from lightgaussian_tpu_torch.utils import cuda_build, stage_marks

TILE_SIZE = 32  # 32x32 px per tile, as in the JAX package

# Per-instance feature columns the blend kernels read.
FEAT_MX, FEAT_MY = 0, 1
FEAT_CA, FEAT_CB, FEAT_CC = 2, 3, 4
FEAT_R, FEAT_G, FEAT_B = 5, 6, 7
FEAT_OPA = 8
FEAT_WIDTH = 9

# The JAX package stores instances in 128-wide chunks; capacities are still
# rounded to it so both packages cut an overflowing frame at the same slot.
INST_CHUNK = 128

# The port's ceiling on a frame's instances (the JAX package's is 2^24, its
# f32 metadata): the int32 `tile_starts` index them, so at most 2^31 - 1,
# here in whole chunks. Row offsets (`size_t` in the blend kernels) and
# `gid_sorted` (int64) are wider.
MAX_CAPACITY = ((1 << 31) - 1) // INST_CHUNK * INST_CHUNK

# Rects with at most this many tiles get exact per-tile ellipse tests.
MAX_MASK_TILES = 32

# Tile pixel-center boxes are inflated by this many pixels before the
# intersection test, so it stays conservative under f32 rounding.
_MASK_MARGIN_PX = 0.25

# Blocks of the emission's depth-range pass, each of which writes the least
# and greatest depth bit pattern of its share of the Gaussians.
_RANGE_BLOCKS = 128

# Instances of the binnings since the last reset: live (before any cut), cut
# (past the capacity, dropped) and those of the >32-tile rect fallback.
INSTANCES = {"live": 0, "cut": 0, "fallback": 0}


def reset_instances() -> None:
    for k in INSTANCES:
        INSTANCES[k] = 0


class TileGrid(NamedTuple):
    tiles_x: int
    tiles_y: int
    width: int
    height: int

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


def make_grid(width: int, height: int) -> TileGrid:
    return TileGrid(
        tiles_x=-(-width // TILE_SIZE),
        tiles_y=-(-height // TILE_SIZE),
        width=width,
        height=height,
    )


def tile_rect(
    mean2d: torch.Tensor,
    radius: torch.Tensor,
    grid: TileGrid,
    conic: torch.Tensor | None = None,
    opacity: torch.Tensor | None = None,
):
    """Clamped [lo, hi) tile rectangle per Gaussian.

    Without `conic`/`opacity` this is the square box of the 3-sigma radius.
    With them, each axis is tightened to the support of eligible alpha
    (alpha >= ALPHA_EPS), plus a 1 px margin; splats whose peak alpha is
    below ALPHA_EPS are dropped.

    Returns lo_x, lo_y, hi_x, hi_y (int64) and count (0 where culled).
    """
    r = radius.to(torch.float32)
    alive = radius > 0
    if conic is not None:
        ca, cb, cc = conic[:, 0], conic[:, 1], conic[:, 2]
        det = torch.clamp(ca * cc - cb * cb, min=1e-12)
        q_max = 2.0 * torch.log(torch.clamp(opacity, min=1e-12) / ALPHA_EPS)
        alive = alive & (q_max > 0.0)
        q_max = torch.clamp(q_max, min=0.0)
        rx = torch.minimum(r, torch.sqrt(q_max * cc / det) + 1.0)
        ry = torch.minimum(r, torch.sqrt(q_max * ca / det) + 1.0)
    else:
        rx = ry = r

    def edge(v, lim):
        return torch.clamp(v, 0, lim).to(torch.int64)

    lo_x = edge(torch.floor((mean2d[:, 0] - rx) / TILE_SIZE), grid.tiles_x)
    hi_x = edge(torch.floor((mean2d[:, 0] + rx) / TILE_SIZE) + 1, grid.tiles_x)
    lo_y = edge(torch.floor((mean2d[:, 1] - ry) / TILE_SIZE), grid.tiles_y)
    hi_y = edge(torch.floor((mean2d[:, 1] + ry) / TILE_SIZE) + 1, grid.tiles_y)
    area = torch.clamp(hi_x - lo_x, min=0) * torch.clamp(hi_y - lo_y, min=0)
    count = torch.where(alive, area, 0)
    return lo_x, lo_y, hi_x, hi_y, count


def _exact_tile_mask(
    splats: Splats,
    lo_x: torch.Tensor,
    lo_y: torch.Tensor,
    hi_x: torch.Tensor,
    rect_count: torch.Tensor,
):
    """Exact ellipse-vs-tile intersection masks over row-major rect slots.

    A tile is kept iff the minimum of q(dx, dy) = ca*dx^2 + 2*cb*dx*dy +
    cc*dy^2 over its margin-inflated pixel box is <= q_max =
    2*ln(opa/ALPHA_EPS): zero if the mean is inside the box, else the least
    of the four clamped edge minima. Dropped tiles hold no eligible pixel.

    Returns (mask int64 [N] of up to 32 bits, count int64 [N], use_mask bool
    [N]); where `use_mask` is False (rects of more than 32 tiles) the mask is
    0 and `count` is the rect count.
    """
    ca, cb, cc = splats.conic[:, 0], splats.conic[:, 1], splats.conic[:, 2]
    q_max = 2.0 * torch.log(torch.clamp(splats.opacity, min=1e-12) / ALPHA_EPS)
    use_mask = (rect_count > 0) & (rect_count <= MAX_MASK_TILES)

    w = torch.clamp(hi_x - lo_x, min=1)
    j = torch.arange(MAX_MASK_TILES, dtype=torch.int64, device=lo_x.device)[None, :]
    tx = lo_x[:, None] + j % w[:, None]
    ty = lo_y[:, None] + j // w[:, None]
    ts = float(TILE_SIZE)
    x0 = tx.to(torch.float32) * ts - _MASK_MARGIN_PX
    x1 = x0 + (ts - 1.0 + 2.0 * _MASK_MARGIN_PX)
    y0 = ty.to(torch.float32) * ts - _MASK_MARGIN_PX
    y1 = y0 + (ts - 1.0 + 2.0 * _MASK_MARGIN_PX)
    mx = splats.mean2d[:, 0:1]
    my = splats.mean2d[:, 1:2]
    caj, cbj, ccj = ca[:, None], cb[:, None], cc[:, None]

    def edge_x(xf):  # min over the edge x == xf, y free in the box
        dx = xf - mx
        dy = torch.minimum(
            torch.maximum(-cbj * dx / torch.clamp(ccj, min=1e-12), y0 - my), y1 - my
        )
        return (caj * dx + 2.0 * cbj * dy) * dx + ccj * dy * dy

    def edge_y(yf):
        dy = yf - my
        dx = torch.minimum(
            torch.maximum(-cbj * dy / torch.clamp(caj, min=1e-12), x0 - mx), x1 - mx
        )
        return (caj * dx + 2.0 * cbj * dy) * dx + ccj * dy * dy

    q_min = torch.minimum(
        torch.minimum(edge_x(x0), edge_x(x1)), torch.minimum(edge_y(y0), edge_y(y1))
    )
    inside = (mx >= x0) & (mx <= x1) & (my >= y0) & (my <= y1)
    q_min = torch.where(inside, 0.0, q_min)

    in_rect = j < rect_count[:, None]
    keep = in_rect & ((q_min <= q_max[:, None]) | ~use_mask[:, None])
    count = torch.where(use_mask, keep.sum(dim=1), rect_count)
    mask = torch.where(use_mask, (keep.to(torch.int64) << j).sum(dim=1), 0)
    return mask, count, use_mask


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 holding a value below 2^32 (SWAR count)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _kth_set_bit(mask: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Index of the (k+1)-th set bit of a 32-bit mask (int64 tensors);
    callers guarantee k < popcount(mask). Branch-free binary search."""
    word = mask
    base = torch.zeros_like(k)
    for wdt in (16, 8, 4, 2, 1):
        low = word & ((1 << wdt) - 1)
        c = _popcount32(low)
        go_hi = k >= c
        word = torch.where(go_hi, word >> wdt, low)
        k = k - torch.where(go_hi, c, 0)
        base = base + torch.where(go_hi, wdt, 0)
    return base


@dataclasses.dataclass(frozen=True)
class Binning:
    """(tile, depth)-sorted live instances and per-tile ranges.

    Tile t owns instances [tile_starts[t], tile_starts[t+1]) of `inst`.
    """

    inst: torch.Tensor  # [M, FEAT_WIDTH] f32, M = min(total, capacity)
    tile_starts: torch.Tensor  # [T+1] int32
    total: int  # live instances before any capacity cut
    gid_sorted: torch.Tensor  # [M] int64 sorted position -> Gaussian id
    num_gaussians: int  # N of the splats it was built from


def instance_capacity(max_instances: int) -> int:
    """Instance capacity: the live-instance budget rounded to whole chunks."""
    cap = ((max_instances + INST_CHUNK - 1) // INST_CHUNK) * INST_CHUNK
    if cap > MAX_CAPACITY:
        raise ValueError(f"instance capacity {cap} exceeds MAX_CAPACITY {MAX_CAPACITY} (int32 tile_starts)")
    return cap


def pack_features(splats: Splats) -> torch.Tensor:
    """[N, FEAT_WIDTH] feature rows in Gaussian order."""
    return torch.cat(
        [splats.mean2d, splats.conic, splats.color, splats.opacity[:, None]], dim=1
    ).to(torch.float32)


def sort_key_bits(grid: TileGrid) -> int:
    """Bits of the 32-bit (tile | depth) key given to depth: the tile id takes
    the bits it needs, depth the rest (see `bin_splats`)."""
    tile_bits = max(int(grid.num_tiles + 1).bit_length(), 1)
    return 32 - tile_bits


class TileCover(NamedTuple):
    """Each Gaussian's clamped tile rect (lo_x, lo_y, hi_x), its exact-
    intersection mask over the rect's row-major slots (0 on the >32-tile
    fallback) and its instance count."""

    lo_x: torch.Tensor
    lo_y: torch.Tensor
    hi_x: torch.Tensor
    mask: torch.Tensor
    count: torch.Tensor


# The pieces of `bin_splats`, in the order it runs them; the binning
# profiler (`scripts/profile_binning.py`) times each of them.


def plain_cover(splats: Splats, grid: TileGrid) -> TileCover:
    """The tile cover as torch ops: `tile_rect` + `_exact_tile_mask`."""
    lo_x, lo_y, hi_x, _hi_y, rect_count = tile_rect(
        splats.mean2d, splats.radius, grid, conic=splats.conic, opacity=splats.opacity
    )
    mask, count, _use_mask = _exact_tile_mask(splats, lo_x, lo_y, hi_x, rect_count)
    return TileCover(lo_x, lo_y, hi_x, mask, count)


def _check_cover_inputs(splats: Splats) -> None:
    n = splats.mean2d.shape[0] if splats.mean2d.dim() == 2 else -1
    for name, t, dtype, shape in (("mean2d", splats.mean2d, torch.float32, (n, 2)),
                                  ("conic", splats.conic, torch.float32, (n, 3)),
                                  ("opacity", splats.opacity, torch.float32, (n,)),
                                  ("radius", splats.radius, torch.int32, (n,))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {list(shape)}, got {t.dtype} {list(t.shape)}")
        if t.device != splats.mean2d.device:
            raise ValueError(f"{name} on {t.device}, mean2d on {splats.mean2d.device}")
        if t.dim() == 2 and t.stride(1) != 1 and n > 0:
            raise ValueError(f"{name} must have unit stride along its last dimension, got {t.stride()}")


def _cover(splats: Splats, grid: TileGrid) -> TileCover:
    """(a) Each Gaussian's tile rect, exact mask and count: the cover kernel
    on CUDA tensors, `plain_cover` on CPU tensors. The kernel's rows of the
    rect (lo_x, lo_y, hi_x) are read only where the count is positive."""
    _check_cover_inputs(splats)
    if not cuda_build.on_card(splats.mean2d, "the tile cover"):
        return plain_cover(splats, grid)
    n = splats.mean2d.shape[0]
    out = torch.empty((5, n), dtype=torch.int64, device=splats.mean2d.device)
    if n > 0:
        cuda_build.KERNELS["lg_bin_cover"](
            out, splats.mean2d.data_ptr(), splats.conic.data_ptr(), splats.opacity.data_ptr(),
            splats.radius.data_ptr(), *(row.data_ptr() for row in out), n, splats.mean2d.stride(0),
            splats.conic.stride(0), splats.opacity.stride(0), splats.radius.stride(0), grid.tiles_x, grid.tiles_y)
    return TileCover(*out)


def _instance_total(count: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """(b) The counts' inclusive prefix sum, the live total and the
    instances of the >32-tile fallback, read on the host together: the
    binning's one synchronise."""
    cum = torch.cumsum(count, dim=0)
    if not count.numel():
        return cum, 0, 0
    fallback = torch.threshold(count, MAX_MASK_TILES, 0).sum()
    total, fallback = torch.stack((cum[-1], fallback)).tolist()
    return cum, total, fallback


def _fill_slots(cover: TileCover, cum: torch.Tensor, total: int, m: int, grid: TileGrid):
    """(c) Instance slot -> (source Gaussian, tile) for the first m of the
    `total` slots; slots past the capacity are cut."""
    dev = cum.device
    n = cover.count.shape[0]
    gid = torch.repeat_interleave(
        torch.arange(n, device=dev), cover.count, output_size=total
    )[:m]
    offsets = cum - cover.count
    local = torch.arange(m, device=dev) - offsets[gid]
    # The (local+1)-th surviving bit of the exact-intersection mask, or the
    # rect slot itself on the >32-tile fallback (mask == 0).
    g_mask = cover.mask[gid]
    local = torch.where(g_mask > 0, _kth_set_bit(g_mask, local), local)
    rect_w = torch.clamp(cover.hi_x - cover.lo_x, min=1)[gid]
    tile = (cover.lo_y[gid] + local // rect_w) * grid.tiles_x + (cover.lo_x[gid] + local % rect_w)
    return gid, tile


def _depth_key(depth: torch.Tensor, gid: torch.Tensor, tile: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """(d) The (tile | depth) sort key, with range-adaptive depth
    quantization: subtract the frame's least depth bit pattern and shift
    only as far as the frame's depth range needs."""
    depth_bits = sort_key_bits(grid)
    dep_raw = depth.view(torch.int32).to(torch.int64)[gid]
    rel = dep_raw - dep_raw.min()
    pow2 = 1 << torch.arange(33, dtype=torch.int64, device=gid.device)
    bits_needed = (rel.max() >= pow2).sum()  # bit length; 0 when depths are equal
    shift = torch.clamp(bits_needed - depth_bits, min=0)
    return (tile << depth_bits) | (rel >> shift)


def plain_emit(cover: TileCover, cum: torch.Tensor, depth: torch.Tensor, total: int, m: int, grid: TileGrid):
    """The instance emission as torch ops: `_fill_slots` + `_depth_key`, the
    key stored as an int32 with its top bit flipped (the key less 2^31).
    Returns (key int32 [m], gid int64 [m])."""
    gid, tile = _fill_slots(cover, cum, total, m, grid)
    key = _depth_key(depth, gid, tile, grid)
    return (key - (1 << 31)).to(torch.int32), gid


def _check_emit_inputs(cover: TileCover, cum: torch.Tensor, depth: torch.Tensor, total: int, m: int) -> None:
    n = cum.shape[0] if cum.dim() == 1 else -1
    for name, t in (*zip(TileCover._fields, cover), ("cum", cum)):
        if t.dtype != torch.int64 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be torch.int64 [{n}], got {t.dtype} {list(t.shape)}")
        if n > 0 and t.stride(0) != 1:
            raise ValueError(f"{name} must be contiguous, got stride {t.stride()}")
    if depth.dtype != torch.float32 or tuple(depth.shape) != (n,):
        raise ValueError(f"depth must be torch.float32 [{n}], got {depth.dtype} {list(depth.shape)}")
    for name, t in (*zip(TileCover._fields, cover), ("depth", depth)):
        if t.device != cum.device:
            raise ValueError(f"{name} on {t.device}, cum on {cum.device}")
    if not 0 < m <= total <= MAX_CAPACITY:
        raise ValueError(f"the emission takes 0 < m <= total <= MAX_CAPACITY, got m {m}, total {total}")


def _emit(cover: TileCover, cum: torch.Tensor, depth: torch.Tensor, total: int, m: int, grid: TileGrid):
    """(c) + (d) Each of the first m slots' Gaussian and its 32-bit flipped
    (tile | depth) key: the emission kernel on CUDA tensors (two launches,
    the depth range and the emission, counted as one), `plain_emit` on CPU
    tensors."""
    _check_emit_inputs(cover, cum, depth, total, m)
    if not cuda_build.on_card(cum, "the instance emission"):
        return plain_emit(cover, cum, depth, total, m, grid)
    dev = cum.device
    key = torch.empty(m, dtype=torch.int32, device=dev)
    gid = torch.empty(m, dtype=torch.int64, device=dev)
    partials = torch.empty(2 * _RANGE_BLOCKS, dtype=torch.int32, device=dev)
    cuda_build.KERNELS["lg_bin_emit"](
        key, *(t.data_ptr() for t in cover), cum.data_ptr(), depth.data_ptr(), key.data_ptr(), gid.data_ptr(),
        partials.data_ptr(), cum.shape[0], m, depth.stride(0), grid.tiles_x, sort_key_bits(grid), _RANGE_BLOCKS)
    return key, gid


def _sort_instances(key: torch.Tensor, gid: torch.Tensor):
    """(e) The stable sort by the 32-bit flipped key, and the Gaussian of
    each sorted slot."""
    key_s, order = torch.sort(key, stable=True)
    return key_s, gid[order]


def _tile_starts(key_s: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """(f) Each tile's first slot in the sorted flipped keys (and the end):
    tile t starts at the first key of at least t << depth_bits, flipped."""
    tiles = torch.arange(grid.num_tiles + 1, dtype=torch.int64, device=key_s.device)
    firsts = (tiles << sort_key_bits(grid)) - (1 << 31)
    return torch.searchsorted(key_s, firsts.to(torch.int32), side="left", out_int32=True)


def _gather_features(splats: Splats, gid_s: torch.Tensor) -> torch.Tensor:
    """(g) The sorted instances' feature rows."""
    return pack_features(splats)[gid_s].contiguous()


@stage_marks.in_span("binning")
def bin_splats(splats: Splats, grid: TileGrid, max_instances: int) -> Binning:
    """Binning for the blends and the blend backward. The backward needs
    only `gid_sorted` (its kernel adds each instance's gradient to its
    Gaussian), so the JAX package's `pre_pos` permutation, `gauss_cum` and
    `segment_reduce_pre`, a TPU layout for an atomics-free reduce, have no
    counterpart here."""
    n = splats.mean2d.shape[0]
    cap = instance_capacity(max_instances)
    cover = _cover(splats, grid)
    cum, total, fallback = _instance_total(cover.count)
    if total > MAX_CAPACITY:
        raise ValueError(f"{total} live instances exceed MAX_CAPACITY {MAX_CAPACITY}, what the int32 "
                         "tile_starts index: the frame cannot be binned whole")
    m = min(total, cap)
    INSTANCES["live"] += total
    INSTANCES["cut"] += total - m
    INSTANCES["fallback"] += fallback
    if m == 0:
        dev = splats.mean2d.device
        return Binning(
            inst=torch.zeros((0, FEAT_WIDTH), dtype=torch.float32, device=dev),
            tile_starts=torch.zeros(grid.num_tiles + 1, dtype=torch.int32, device=dev),
            total=total,
            gid_sorted=torch.zeros(0, dtype=torch.int64, device=dev),
            num_gaussians=n,
        )
    key, gid = _emit(cover, cum, splats.depth, total, m, grid)
    key_s, gid_s = _sort_instances(key, gid)
    tile_starts = _tile_starts(key_s, grid)
    inst = _gather_features(splats, gid_s)
    return Binning(inst=inst, tile_starts=tile_starts, total=total, gid_sorted=gid_s, num_gaussians=n)


def rebind_features(splats: Splats, b: Binning) -> Binning:
    """A cached binning with its instance features gathered anew from
    `splats`, in the cached (tile | depth) order and tile ranges: the
    trajectory renderer's reuse of a keyframe's sort over the frames near
    it. A Gaussian culled in the new frame but still in the cached order
    gets an all-zero row (opacity 0, so it blends nothing). `total` stays
    the keyframe's. Forward only.

    The zeroing is a `where`, not a product with the mask: a Gaussian
    behind the camera may have non-finite screen coordinates, and NaN
    times 0 is NaN."""
    n = splats.mean2d.shape[0]
    if n != b.num_gaussians:
        raise ValueError(
            f"cached binning was built for {b.num_gaussians} Gaussians, got {n}: "
            "a larger scene would gather in range and mis-render"
        )
    visible = (splats.radius > 0)[:, None]
    feat = torch.where(visible, pack_features(splats), 0.0)
    return dataclasses.replace(b, inst=feat[b.gid_sorted].contiguous())


def snug_capacity(live: int) -> int:
    """Right-sized instance capacity for a measured live count: 1.4x the
    live instances, at least 16k, rounded to 8k (64k above 500k live)."""
    cap = max(int(live * 1.4), 1 << 14)
    quantum = 65536 if cap > 500_000 else 8192
    return ((cap + quantum - 1) // quantum) * quantum


def estimate_max_instances(num_gaussians: int) -> int:
    """Instance-capacity heuristic of the JAX package (8 tiles a Gaussian),
    capped at the port's ceiling: the JAX package's own below
    2^24 / 8 Gaussians, where its cap does not bind."""
    m = int(num_gaussians * 8.0)
    m = min(max(m, 1 << 16), MAX_CAPACITY)
    return ((m + INST_CHUNK - 1) // INST_CHUNK) * INST_CHUNK
