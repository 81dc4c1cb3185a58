"""Plain PyTorch reference of the tiled Gaussian-splat render and its backward.

A frozen, self-contained copy of the 3D-GS render as the program under test
defines it, in float32 and plain torch operations, written so that each
operation rounds as the program's own plain path does:

- preprocess: frustum cull at z 0.2, the EWA projection with the 0.3 low-pass
  and the 1.3x frustum clamp, the conic, a 3-sigma pixel radius and the view-
  dependent SH colour clamped at 0;
- binning: 32x32 tiles; each splat in the tiles of its 3-sigma rect tightened
  to its alpha >= 1/255 support, with an exact ellipse-vs-tile test for rects
  of up to 32 tiles; instances sorted by a 32-bit (tile | range-adaptive
  depth) key, stable; the instances past `max_instances` cut;
- blend: each tile walked front to back in 128-instance chunks; a pair blends
  where power <= 0 and alpha = min(opacity e^power, 0.99) >= 1/255; the exact
  blend stops a pixel once its transmittance would fall under 1e-4, the
  render-only blend keeps the naive transmittance and stops only the tile;
- backward: the exact blend's gradient with the per-pixel remaining-
  contribution seed, per instance, summed per Gaussian.

The walk also counts the (instance, pixel) pairs it evaluates by kind
(`WORK_KINDS`), which the benchmark's counting turns into least times.
Tiles are walked in blocks of `TILE_GROUP`, so that the reference fits.

`q` is a rounding applied where a stage hands its results on: the identity
for the reference, a round trip through bfloat16 for the precision control.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from perfbench.reference.camera import View

NEAR_PLANE = 0.2
ALPHA_EPS = 1.0 / 255.0
T_EPS = 1e-4
MAX_ALPHA = 0.99
TILE = 32
PIX = TILE * TILE
BATCH = 128
MAX_MASK_TILES = 32
MASK_MARGIN_PX = 0.25
MAX_CAPACITY = 1 << 24
TILE_GROUP = 256
FEAT = 9  # mean2d (2), conic (3), colour (3), opacity (1)
WORK_KINDS = ("culled", "faint", "applied", "stopping", "past_stop")

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154, -0.4570457994644658,
         1.445305721320277, -0.5900435899266435)

Q = Callable[[torch.Tensor], torch.Tensor]


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """The precision control's rounding: float32 held as bfloat16."""
    return t.to(torch.bfloat16).to(t.dtype)


# ---------------------------------------------------------------- preprocess


def eval_sh(degree: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    result = SH_C0 * sh[..., 0, :]
    if degree < 1:
        return result
    x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
    result = result - SH_C1 * y * sh[..., 1, :] + SH_C1 * z * sh[..., 2, :] - SH_C1 * x * sh[..., 3, :]
    if degree < 2:
        return result
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    result = (
        result
        + SH_C2[0] * xy * sh[..., 4, :]
        + SH_C2[1] * yz * sh[..., 5, :]
        + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
        + SH_C2[3] * xz * sh[..., 7, :]
        + SH_C2[4] * (xx - yy) * sh[..., 8, :]
    )
    if degree < 3:
        return result
    return (
        result
        + SH_C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :]
        + SH_C3[1] * xy * z * sh[..., 10, :]
        + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :]
        + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 12, :]
        + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :]
        + SH_C3[5] * z * (xx - yy) * sh[..., 14, :]
        + SH_C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :]
    )


def covariance(log_scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """Sigma = R S S^T R^T, [N, 3, 3]."""
    q = quats / (torch.sqrt(torch.sum(quats * quats, dim=-1, keepdim=True)) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rot = torch.stack([
        torch.stack([1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y)], dim=-1),
        torch.stack([2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x)], dim=-1),
        torch.stack([2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y)], dim=-1),
    ], dim=-2)
    m = rot * (1.0 * torch.exp(log_scales))[..., None, :]
    rows = [m[..., i, :] for i in range(3)]
    return torch.stack([torch.stack([torch.sum(rows[i] * rows[j], dim=-1) for j in range(3)], dim=-1)
                        for i in range(3)], dim=-2)


def ewa(p_view, cov_cam, view: View) -> torch.Tensor:
    tx, ty, tz = p_view[..., 0], p_view[..., 1], p_view[..., 2]
    tz = torch.clamp(tz, min=1e-6)
    limx, limy = 1.3 * view.tan_fovx, 1.3 * view.tan_fovy
    txz = torch.clamp(tx / tz, min=-limx, max=limx) * tz
    tyz = torch.clamp(ty / tz, min=-limy, max=limy) * tz
    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    fx, fy = view.focal_x, view.focal_y
    j00, j02 = fx * inv_tz, -fx * txz * inv_tz2
    j11, j12 = fy * inv_tz, -fy * tyz * inv_tz2
    c = cov_cam
    a = j00 * (j00 * c[..., 0, 0] + j02 * c[..., 2, 0]) + j02 * (j00 * c[..., 0, 2] + j02 * c[..., 2, 2])
    b = j11 * (j00 * c[..., 0, 1] + j02 * c[..., 2, 1]) + j12 * (j00 * c[..., 0, 2] + j02 * c[..., 2, 2])
    d = j11 * (j11 * c[..., 1, 1] + j12 * c[..., 2, 1]) + j12 * (j11 * c[..., 1, 2] + j12 * c[..., 2, 2])
    return torch.stack([a + 0.3, b, d + 0.3], dim=-1)


@dataclasses.dataclass(frozen=True)
class Splats:
    mean2d: torch.Tensor  # [N, 2]
    conic: torch.Tensor  # [N, 3]
    color: torch.Tensor  # [N, 3]
    opacity: torch.Tensor  # [N]
    depth: torch.Tensor  # [N] (inf where culled)
    radius: torch.Tensor  # [N] int32 (0 where culled)


def preprocess(p: dict, sh_degree: int, view: View, mean2d_offset=None, q: Q = identity) -> Splats:
    """Screen-space splats of the Gaussians `p` (means, sh_dc, sh_rest,
    log_scales, quats, opacity_logits) seen by `view`."""
    means = p["means"]
    wv, fp = view.world_view, view.full_proj

    def matvec3(m3):
        return torch.sum(means[:, None, :] * m3[None, :, :], dim=-1)

    p_view = matvec3(wv[:3, :3]) + wv[:3, 3]
    depth = p_view[:, 2]
    p_hom = matvec3(fp[:3, :3]) + fp[:3, 3]
    p_w = torch.sum(means * fp[3, :3], dim=-1) + fp[3, 3]
    inv_w = 1.0 / (p_w + 1e-7)
    ndc = p_hom[:, :2] * inv_w[:, None]
    if mean2d_offset is not None:
        ndc = ndc + mean2d_offset
    size = torch.tensor([view.width, view.height], dtype=torch.float32, device=means.device)
    mean2d = ((ndc + 1.0) * size - 1.0) * 0.5

    cov3d = covariance(p["log_scales"], p["quats"])
    wr = wv[:3, :3]
    tmp = torch.sum(wr[None, :, None, :] * cov3d[:, None, :, :], dim=-1)
    cov_cam = torch.sum(tmp[:, :, None, :] * wr[None, None, :, :], dim=-1)
    cov2d = ewa(p_view, cov_cam, view)
    a, b, c = cov2d[:, 0], cov2d[:, 1], cov2d[:, 2]
    det = a * c - b * b
    det_valid = det > 0.0
    inv_det = torch.where(det_valid, 1.0 / torch.where(det_valid, det, 1.0), 0.0)
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)
    mid = 0.5 * (a + c)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lambda1))

    dirs = means - view.center
    dirs = dirs / (torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True)) + 1e-12)
    sh = torch.cat([p["sh_dc"][:, None, :], p["sh_rest"]], dim=1)
    color = torch.clamp(eval_sh(sh_degree, sh, dirs) + 0.5, min=0.0)

    valid = (depth > NEAR_PLANE) & det_valid
    return Splats(
        mean2d=q(mean2d),
        conic=q(conic),
        color=q(color),
        opacity=q(torch.where(valid, torch.sigmoid(p["opacity_logits"]), 0.0)),
        depth=torch.where(valid, depth, torch.inf),
        radius=torch.where(valid, radius_f, 0.0).to(torch.int32),
    )


# ------------------------------------------------------------------- binning


class Grid(NamedTuple):
    tiles_x: int
    tiles_y: int
    width: int
    height: int

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


def make_grid(width: int, height: int) -> Grid:
    return Grid(-(-width // TILE), -(-height // TILE), width, height)


def default_cut(num_gaussians: int) -> int:
    """The instance cut of a frame: 8 tiles a Gaussian, at least 2^16, at most
    2^24, in whole 128-instance chunks."""
    m = min(max(int(num_gaussians * 8.0), 1 << 16), MAX_CAPACITY)
    return ((m + BATCH - 1) // BATCH) * BATCH


@dataclasses.dataclass(frozen=True)
class Binning:
    inst: torch.Tensor  # [M, FEAT] f32
    tile_starts: torch.Tensor  # [T + 1] int64
    gid: torch.Tensor  # [M] int64
    total: int  # live instances before the cut
    grid: Grid


def _popcount32(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _kth_set_bit(mask, k):
    word, base = mask, torch.zeros_like(k)
    for wdt in (16, 8, 4, 2, 1):
        low = word & ((1 << wdt) - 1)
        c = _popcount32(low)
        go_hi = k >= c
        word = torch.where(go_hi, word >> wdt, low)
        k = k - torch.where(go_hi, c, 0)
        base = base + torch.where(go_hi, wdt, 0)
    return base


def _cover(s: Splats, grid: Grid):
    """Each splat's tile rect (lo_x, lo_y, hi_x), its exact-intersection mask
    over the rect's row-major slots and its instance count."""
    r = s.radius.to(torch.float32)
    ca, cb, cc = s.conic[:, 0], s.conic[:, 1], s.conic[:, 2]
    det = torch.clamp(ca * cc - cb * cb, min=1e-12)
    q_max = 2.0 * torch.log(torch.clamp(s.opacity, min=1e-12) / ALPHA_EPS)
    alive = (s.radius > 0) & (q_max > 0.0)
    qc = torch.clamp(q_max, min=0.0)
    rx = torch.minimum(r, torch.sqrt(qc * cc / det) + 1.0)
    ry = torch.minimum(r, torch.sqrt(qc * ca / det) + 1.0)

    def edge(v, lim):
        return torch.clamp(v, 0, lim).to(torch.int64)

    lo_x = edge(torch.floor((s.mean2d[:, 0] - rx) / TILE), grid.tiles_x)
    hi_x = edge(torch.floor((s.mean2d[:, 0] + rx) / TILE) + 1, grid.tiles_x)
    lo_y = edge(torch.floor((s.mean2d[:, 1] - ry) / TILE), grid.tiles_y)
    hi_y = edge(torch.floor((s.mean2d[:, 1] + ry) / TILE) + 1, grid.tiles_y)
    rect = torch.where(alive, torch.clamp(hi_x - lo_x, min=0) * torch.clamp(hi_y - lo_y, min=0), 0)

    use_mask = (rect > 0) & (rect <= MAX_MASK_TILES)
    w = torch.clamp(hi_x - lo_x, min=1)
    j = torch.arange(MAX_MASK_TILES, dtype=torch.int64, device=lo_x.device)[None, :]
    x0 = (lo_x[:, None] + j % w[:, None]).to(torch.float32) * float(TILE) - MASK_MARGIN_PX
    x1 = x0 + (float(TILE) - 1.0 + 2.0 * MASK_MARGIN_PX)
    y0 = (lo_y[:, None] + j // w[:, None]).to(torch.float32) * float(TILE) - MASK_MARGIN_PX
    y1 = y0 + (float(TILE) - 1.0 + 2.0 * MASK_MARGIN_PX)
    mx, my = s.mean2d[:, 0:1], s.mean2d[:, 1:2]
    caj, cbj, ccj = ca[:, None], cb[:, None], cc[:, None]

    def edge_x(xf):
        dx = xf - mx
        dy = torch.minimum(torch.maximum(-cbj * dx / torch.clamp(ccj, min=1e-12), y0 - my), y1 - my)
        return (caj * dx + 2.0 * cbj * dy) * dx + ccj * dy * dy

    def edge_y(yf):
        dy = yf - my
        dx = torch.minimum(torch.maximum(-cbj * dy / torch.clamp(caj, min=1e-12), x0 - mx), x1 - mx)
        return (caj * dx + 2.0 * cbj * dy) * dx + ccj * dy * dy

    q_min = torch.minimum(torch.minimum(edge_x(x0), edge_x(x1)), torch.minimum(edge_y(y0), edge_y(y1)))
    inside = (mx >= x0) & (mx <= x1) & (my >= y0) & (my <= y1)
    q_min = torch.where(inside, 0.0, q_min)
    keep = (j < rect[:, None]) & ((q_min <= q_max[:, None]) | ~use_mask[:, None])
    count = torch.where(use_mask, keep.sum(dim=1), rect)
    mask = torch.where(use_mask, (keep.to(torch.int64) << j).sum(dim=1), 0)
    return lo_x, lo_y, hi_x, mask, count


def bin_splats(s: Splats, grid: Grid, cut: int, block: int = 1 << 20) -> Binning:
    """Instances of the splats in (tile | depth) order, the first `cut` kept.
    The cover is computed `block` splats at a time."""
    dev = s.mean2d.device
    n = s.mean2d.shape[0]
    parts = [_cover(Splats(*(getattr(s, f.name)[i:i + block] for f in dataclasses.fields(Splats))), grid)
             for i in range(0, n, block)]
    lo_x, lo_y, hi_x, mask, count = (torch.cat(c) for c in zip(*parts))
    cum = torch.cumsum(count, dim=0)
    total = int(cum[-1]) if n else 0
    cap = ((cut + BATCH - 1) // BATCH) * BATCH
    m = min(total, cap)
    if m == 0:
        return Binning(torch.zeros((0, FEAT), device=dev), torch.zeros(grid.num_tiles + 1, dtype=torch.int64,
                       device=dev), torch.zeros(0, dtype=torch.int64, device=dev), total, grid)
    gid = torch.repeat_interleave(torch.arange(n, device=dev), count, output_size=total)[:m]
    local = torch.arange(m, device=dev) - (cum - count)[gid]
    g_mask = mask[gid]
    local = torch.where(g_mask > 0, _kth_set_bit(g_mask, local), local)
    rect_w = torch.clamp(hi_x - lo_x, min=1)[gid]
    tile = (lo_y[gid] + local // rect_w) * grid.tiles_x + (lo_x[gid] + local % rect_w)

    depth_bits = 32 - max(int(grid.num_tiles + 1).bit_length(), 1)
    dep = s.depth.view(torch.int32).to(torch.int64)[gid]
    rel = dep - dep.min()
    pow2 = 1 << torch.arange(33, dtype=torch.int64, device=dev)
    shift = torch.clamp((rel.max() >= pow2).sum() - depth_bits, min=0)
    key = (tile << depth_bits) | (rel >> shift)
    key_s, order = torch.sort(key, stable=True)
    gid_s = gid[order]
    starts = torch.searchsorted(key_s >> depth_bits, torch.arange(grid.num_tiles + 1, dtype=torch.int64,
                                                                   device=dev), side="left")
    feat = torch.cat([s.mean2d, s.conic, s.color, s.opacity[:, None]], dim=1)
    return Binning(feat[gid_s].contiguous(), starts, gid_s, total, grid)


# --------------------------------------------------------------------- blend


class _Walk:
    """Each tile's range, first chunk and pixel coordinates."""

    def __init__(self, b: Binning):
        grid, dev = b.grid, b.inst.device
        self.starts, self.ends = b.tile_starts[:-1], b.tile_starts[1:]
        self.bases = self.starts // BATCH * BATCH
        lane = torch.arange(PIX, device=dev)
        self.ids = torch.arange(grid.num_tiles, device=dev)
        px = ((self.ids % grid.tiles_x) * TILE)[:, None] + (lane % TILE)[None, :]
        py = ((self.ids // grid.tiles_x) * TILE)[:, None] + (lane // TILE)[None, :]
        self.pix_valid = (px < grid.width) & (py < grid.height)
        self.px, self.py = px.to(torch.float32), py.to(torch.float32)
        self.rows = torch.arange(BATCH, device=dev)

    def groups(self):
        for g0 in range(0, self.ids.numel(), TILE_GROUP):
            ids = self.ids[g0:g0 + TILE_GROUP]
            act = torch.arange(ids.numel(), device=ids.device)
            yield ids, act[self.ends[ids] > self.starts[ids]]

    def chunk(self, inst, tid, step):
        rows = self.bases[tid][:, None] + step * BATCH + self.rows[None, :]
        row_ok = (rows >= self.starts[tid][:, None]) & (rows < self.ends[tid][:, None])
        f = inst[torch.clamp(rows, max=inst.shape[0] - 1)]
        dx = self.px[tid][:, None, :] - f[..., 0:1]
        dy = self.py[tid][:, None, :] - f[..., 1:2]
        ca, cb, cc = f[..., 2:3], f[..., 3:4], f[..., 4:5]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha_raw = f[..., 8:9] * torch.exp(power)
        alpha = torch.clamp(alpha_raw, max=MAX_ALPHA)
        elig = (power <= 0.0) & (alpha >= ALPHA_EPS) & self.pix_valid[tid][:, None, :] & row_ok[:, :, None]
        return rows, row_ok, f, dx, dy, power, alpha_raw, torch.where(elig, alpha, 0.0), elig

    def work(self, tid, row_ok, power, elig, t_i, apply, exact: bool):
        walked = row_ok[:, :, None] & self.pix_valid[tid][:, None, :]
        blending = t_i >= T_EPS
        if exact:
            walked = walked & blending
        culled = power > 0.0
        kinds = (walked & culled, walked & ~culled & ~elig, walked & elig & apply,
                 walked & elig & ~apply & blending, walked & elig & ~blending)
        return torch.stack([k.sum(dim=(1, 2)) for k in kinds], dim=1)

    def more(self, tid, step, t_naive):
        return (self.bases[tid] + step * BATCH < self.ends[tid]) & (t_naive.amax(dim=1) >= T_EPS)


def _prefixes(alpha, t_naive):
    om = 1.0 - alpha
    incl = torch.cumprod(om, dim=1)
    excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
    t_i = t_naive[:, None, :] * excl
    return om, incl, t_i, (t_i * om) >= T_EPS


def blend(b: Binning, exact: bool):
    """(tile_rgb [T, 3, PIX], tile_T [T, 1, PIX], work [T, 5]): the exact
    blend's applied transmittance, or the render-only blend's naive one."""
    dev, nt = b.inst.device, b.grid.num_tiles
    rgb_out = torch.zeros((nt, 3, PIX), dtype=torch.float32, device=dev)
    t_out = torch.ones((nt, 1, PIX), dtype=torch.float32, device=dev)
    work = torch.zeros((nt, len(WORK_KINDS)), dtype=torch.int64, device=dev)
    if b.inst.shape[0] == 0:
        return rgb_out, t_out, work
    walk = _Walk(b)
    for ids, act in walk.groups():
        t_naive = torch.where(walk.pix_valid[ids], 1.0, 0.0)
        t_act = torch.ones_like(t_naive)
        rgb = torch.zeros((ids.numel(), 3, PIX), dtype=torch.float32, device=dev)
        step = 0
        while act.numel():
            tid = ids[act]
            _, row_ok, f, _, _, power, _, alpha, elig = walk.chunk(b.inst, tid, step)
            _, incl, t_i, apply = _prefixes(alpha, t_naive[act])
            w = torch.where(apply, alpha * t_i, 0.0)
            rgb[act] += torch.einsum("abc,abp->acp", f[..., 5:8], w)
            t_naive[act] = t_naive[act] * incl[:, -1]
            if exact:
                t_act[act] = t_act[act] * torch.where(apply, incl, 1.0).amin(dim=1)
            work[tid] += walk.work(tid, row_ok, power, elig, t_i, apply, exact)
            step += 1
            act = act[walk.more(tid, step, t_naive[act])]
        rgb_out[ids] = rgb
        t_out[ids, 0] = t_act if exact else torch.where(walk.pix_valid[ids], t_naive, 1.0)
    return rgb_out, t_out, work


def blend_backward(b: Binning, tile_g: torch.Tensor, tile_r: torch.Tensor) -> torch.Tensor:
    """Per-instance gradients [M, FEAT] of the exact blend's (mean2d, conic,
    colour, opacity) from the image cotangent per tile and the seed."""
    dev = b.inst.device
    grads = torch.zeros((b.inst.shape[0], FEAT), dtype=torch.float32, device=dev)
    if b.inst.shape[0] == 0:
        return grads
    walk = _Walk(b)
    for ids, act in walk.groups():
        t_naive = torch.where(walk.pix_valid[ids], 1.0, 0.0)
        r_carry = tile_r[ids, 0].clone()
        g_all = tile_g[ids]
        step = 0
        while act.numel():
            tid = ids[act]
            rows, row_ok, f, dx, dy, power, alpha_raw, alpha, elig = walk.chunk(b.inst, tid, step)
            om, incl, t_i, apply = _prefixes(alpha, t_naive[act])
            w = torch.where(apply, alpha * t_i, 0.0)
            g = g_all[act][:, None]
            cw = f[..., 5:6] * g[:, :, 0] + f[..., 6:7] * g[:, :, 1] + f[..., 7:8] * g[:, :, 2]
            prefix = torch.cumsum(cw * w, dim=1)
            r_i = r_carry[act][:, None, :] - prefix
            d_alpha = cw * t_i - r_i / om
            d_power = torch.where((alpha_raw < MAX_ALPHA) & apply, d_alpha, 0.0) * alpha
            q1, q2 = d_power * dx, d_power * dy
            s0 = d_power.sum(-1)
            sx, sy = q1.sum(-1), q2.sum(-1)
            sxx, sxy, syy = (q1 * dx).sum(-1), (q1 * dy).sum(-1), (q2 * dy).sum(-1)
            d_col = torch.einsum("abp,acp->abc", w, g_all[act])
            ca, cb, cc = f[..., 2], f[..., 3], f[..., 4]
            d = torch.cat([
                torch.stack([ca * sx + cb * sy, cc * sy + cb * sx, -0.5 * sxx, -sxy, -0.5 * syy], -1),
                d_col,
                (s0 / torch.clamp(f[..., 8], min=1e-12))[..., None],
            ], dim=-1)
            grads[rows[row_ok]] = d[row_ok]
            t_naive[act] = t_naive[act] * incl[:, -1]
            r_carry[act] = r_carry[act] - prefix[:, -1]
            step += 1
            act = act[walk.more(tid, step, t_naive[act])]
    return grads


def untile(planes: torch.Tensor, grid: Grid) -> torch.Tensor:
    """[T, C, PIX] -> [C, H_pad, W_pad]."""
    c = planes.shape[1]
    x = planes.reshape(grid.tiles_y, grid.tiles_x, c, TILE, TILE).permute(2, 0, 3, 1, 4)
    return x.reshape(c, grid.tiles_y * TILE, grid.tiles_x * TILE)


def tile(image: torch.Tensor, grid: Grid) -> torch.Tensor:
    """[C, H, W] -> [T, C, PIX], zero-padded."""
    c, h, w = image.shape
    x = F.pad(image, (0, grid.tiles_x * TILE - w, 0, grid.tiles_y * TILE - h))
    x = x.reshape(c, grid.tiles_y, TILE, grid.tiles_x, TILE)
    return x.permute(1, 3, 0, 2, 4).reshape(grid.num_tiles, c, PIX).contiguous()


def compose(tile_rgb, tile_t, bg, grid: Grid):
    img = untile(tile_rgb, grid)
    t = untile(tile_t, grid)[0]
    h, w = grid.height, grid.width
    return img[:, :h, :w] + t[None, :h, :w] * bg[:, None, None], t[:h, :w]


# ------------------------------------------------------------ render entries


def render_frame(p: dict, sh_degree: int, view: View, bg: torch.Tensor, cut: int, fast: bool, q: Q = identity):
    """The served frame [3, H, W] (render-only blend if `fast`, else exact)."""
    with torch.no_grad():
        s = preprocess(p, sh_degree, view, q=q)
        b = bin_splats(s, make_grid(view.width, view.height), cut)
        rgb, t, _ = blend(b, exact=not fast)
        return q(compose(rgb, t, bg, b.grid)[0])


class _ExactBlend(torch.autograd.Function):
    """(mean2d, conic, colour, opacity) -> image, over a binning made from them."""

    @staticmethod
    def forward(ctx, mean2d, conic, color, opacity, b, bg, q):
        rgb, t, _ = blend(b, exact=True)
        image, final_t = compose(rgb, t, bg, b.grid)
        ctx.save_for_backward(image, final_t)
        ctx.b, ctx.n, ctx.q = b, mean2d.shape[0], q
        return q(image)

    @staticmethod
    def backward(ctx, g_image):
        image, final_t = ctx.saved_tensors
        b, q = ctx.b, ctx.q
        g_image = q(g_image)
        seed = (image * g_image).sum(dim=0)
        inst_g = blend_backward(b, tile(g_image.contiguous(), b.grid), tile(seed[None].contiguous(), b.grid))
        g = torch.zeros((ctx.n, FEAT), dtype=torch.float32, device=image.device).index_add_(0, b.gid, inst_g)
        g = q(g)
        return g[:, 0:2], g[:, 2:5], g[:, 5:8], g[:, 8], None, None, None


def render_exact(p: dict, sh_degree: int, view: View, bg: torch.Tensor, cut: int, mean2d_offset=None,
                 q: Q = identity):
    """(image, radius, live instances) of the exact blend, differentiable in
    `p` and `mean2d_offset`."""
    s = preprocess(p, sh_degree, view, mean2d_offset=mean2d_offset, q=q)
    with torch.no_grad():
        det = Splats(*(getattr(s, f.name).detach() for f in dataclasses.fields(Splats)))
        b = bin_splats(det, make_grid(view.width, view.height), cut)
    image = _ExactBlend.apply(s.mean2d, s.conic, s.color, s.opacity, b, bg, q)
    return image, s.radius, b.total


def grow_cut(cut: int, live: int) -> int:
    """The trainer's instance cut after a frame of `live` instances: once
    they pass 0.85 of it, 1.4 times them (at least 2^14), rounded up to 8192
    (65536 above 500,000), at most 2^24."""
    if live <= 0.85 * cut:
        return cut
    c = max(int(live * 1.4), 1 << 14)
    quantum = 65536 if c > 500_000 else 8192
    return min(((c + quantum - 1) // quantum) * quantum, MAX_CAPACITY)
