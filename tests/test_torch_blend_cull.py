"""The blend kernels' cull, through its plain twin, on the CPU.

The forward and backward CUDA kernels skip the (instance, warp) pairs that
`cull_cells` (csrc/blend_tile.cuh) says cannot hold an eligible pixel.
`blend.plain_cull_rect` is the same formula on tensors. These tests hold it
to what makes the skip safe:

(a) it is conservative: every pixel the plain versions would find eligible
    (power <= 0 and alpha >= 1/255, in their float32 arithmetic) lies inside
    the rectangle, and its power is not under the level (`plain_cull_level`)
    below which the kernels skip the exp, over fixed hard cases and a
    hypothesis search;
(b) the plain versions with the pairs outside the rectangle dropped
    (`cull=True`) equal the unculled ones bit for bit on the three scenes of
    test_torch_rasterize.py, and so still agree with the JAX package (image
    and final_T 2e-5, per-instance gradients 5e-5 of the largest, the
    tolerances of test_torch_rasterize.py and test_torch_backward.py; the
    counting blend's hit counts equal and importance 1e-4, those of
    test_torch_gss.py; the JAX kernels run in interpret mode);
    the cells word the kernels test (`plain_cull_cells`) covers exactly the
    cells that rectangle reaches, and `instance_cull`, which on a card runs
    the device functions, gives on the CPU each instance its word in its
    own tile;
(c) on the 256-Gaussian scene it leaves under a third of the (instance, warp)
    pairs a walk of every warp over every instance makes.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lightgaussian_tpu.ops.rasterize import binning as jb
from lightgaussian_tpu.ops.rasterize import count_render as jcount
from lightgaussian_tpu.ops.rasterize import pallas_blend as jpk
from lightgaussian_tpu.ops.rasterize import render as jrender
from lightgaussian_tpu.ops.rasterize import tiled as jtiled
from lightgaussian_tpu.ops.rasterize.projection import preprocess as jpreprocess
from lightgaussian_tpu.utils import synthetic as jsyn
from lightgaussian_tpu_torch.ops.rasterize import binning as tb
from lightgaussian_tpu_torch.ops.rasterize import blend as tblend
from lightgaussian_tpu_torch.ops.rasterize import tiled as ttiled
from lightgaussian_tpu_torch.ops.rasterize.projection import ALPHA_EPS, MAX_ALPHA
from lightgaussian_tpu_torch.ops.rasterize.projection import Splats as TSplats
from lightgaussian_tpu_torch.ops.rasterize.projection import preprocess as tpreprocess
from lightgaussian_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

BG = np.array([0.1, 0.2, 0.3], np.float32)
SPLAT_FIELDS = ("mean2d", "conic", "color", "opacity", "depth", "radius")
MAX_INST = 1 << 16
TILE = tb.TILE_SIZE
# tile origins: the first tile, the last of a 1920x1080 frame, one between
ORIGINS = ((0, 0), (59 * TILE, 33 * TILE), (20 * TILE, 7 * TILE))
# the scenes of test_torch_rasterize.py
CASES = {
    "small": (dict(n=256, seed=1), 96, 64),
    "dense": (dict(n=2048, seed=1, extent=1.2, scale_range=(0.01, 0.06)), 192, 128),
    "saturated": (dict(n=800, seed=3, extent=1.5, scale_range=(0.15, 0.4)), 96, 64),
}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _conic(s1, s2, theta):
    """Conic (a, b, c) of a Gaussian with standard deviations s1, s2 (pixels)
    along and across the direction theta."""
    c, s = math.cos(theta), math.sin(theta)
    i1, i2 = 1.0 / (s1 * s1), 1.0 / (s2 * s2)
    return c * c * i1 + s * s * i2, c * s * (i1 - i2), s * s * i1 + c * c * i2


def _instance(mx, my, conic, opa):
    return [mx, my, *conic, 0.5, 0.5, 0.5, opa]


def _escapes(rows, ox, oy):
    """Eligible pixels of the tile at (ox, oy) outside each instance's cull
    rectangle, [K, PIX], by the plain versions' own float32 expressions; and
    the rectangles."""
    f = torch.tensor(rows, dtype=torch.float32).reshape(-1, tb.FEAT_WIDTH)
    lane = torch.arange(tblend.PIX)
    lx, ly = lane % TILE, lane // TILE
    dx = (ox + lx).to(torch.float32)[None] - f[:, tb.FEAT_MX, None]
    dy = (oy + ly).to(torch.float32)[None] - f[:, tb.FEAT_MY, None]
    ca, cb, cc = f[:, tb.FEAT_CA, None], f[:, tb.FEAT_CB, None], f[:, tb.FEAT_CC, None]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.clamp(f[:, tb.FEAT_OPA, None] * torch.exp(power), max=MAX_ALPHA)
    elig = (power <= 0.0) & (alpha >= ALPHA_EPS)
    o = torch.tensor([[float(ox)], [float(oy)]])
    x0, x1, y0, y1 = tblend.plain_cull_rect(f, o[0], o[1])
    inside = (lx >= x0[:, None]) & (lx <= x1[:, None]) & (ly >= y0[:, None]) & (ly <= y1[:, None])
    inside = inside & ~(power < -tblend.plain_cull_level(f)[:, None])  # the test that spares a pair its exp
    return elig & ~inside, elig, (x0, x1, y0, y1)


EPS = 1.0 / 255.0
FIXED = {
    "opacity just under 1/255": _instance(16.0, 16.0, _conic(6, 6, 0), EPS * (1 - 1e-6)),
    "opacity at 1/255": _instance(16.0, 16.0, _conic(6, 6, 0), float(np.float32(EPS))),
    "opacity just over 1/255": _instance(16.0, 16.0, _conic(6, 6, 0), EPS * (1 + 1e-5)),
    "opacity 1": _instance(16.3, 15.7, _conic(5, 3, 0.4), 1.0),
    "opacity 0": _instance(16.0, 16.0, _conic(6, 6, 0), 0.0),
    "sub-pixel": _instance(9.49, 20.51, _conic(0.05, 0.05, 0), 0.9),
    "sub-pixel on a pixel": _instance(9.0, 20.0, _conic(0.02, 0.02, 0), 0.9),
    "huge": _instance(400.0, -300.0, _conic(5000, 3000, 1.0), 0.8),
    "needle along the diagonal": _instance(16.0, 16.0, _conic(300, 0.55, math.pi / 4), 0.95),
    "needle from afar": _instance(-180.0, -170.0, _conic(400, 0.6, math.pi / 4 + 0.03), 0.95),
    "near-singular": [16.0, 16.0, 1.0, 0.9999999, 1.0, 0.5, 0.5, 0.5, 0.9],
    "singular": [16.0, 16.0, 4.0, 2.0, 1.0, 0.5, 0.5, 0.5, 0.9],
    "indefinite": [16.0, 16.0, 1.0, 3.0, 1.0, 0.5, 0.5, 0.5, 0.9],
    "zero conic": [16.0, 16.0, 0.0, 0.0, 0.0, 0.5, 0.5, 0.5, 0.9],
    "tiny conic": [16.0, 16.0, 1e-30, 0.0, 1e-30, 0.5, 0.5, 0.5, 0.9],
    "large conic far away": _instance(5000.0, 16.0, (1e4, 0.0, 1e4), 0.9),
    "mean left of the tile": _instance(-20.0, 10.0, _conic(9, 4, 0.2), 0.7),
    "mean right of the tile": _instance(45.0, 40.0, _conic(7, 7, 0), 0.7),
    "nan mean": [float("nan"), 16.0, 0.1, 0.0, 0.1, 0.5, 0.5, 0.5, 0.9],
    "inf mean": [float("inf"), 16.0, 0.1, 0.0, 0.1, 0.5, 0.5, 0.5, 0.9],
    "inf conic": [16.0, 16.0, float("inf"), 0.0, 0.1, 0.5, 0.5, 0.5, 0.9],
    "nan opacity": [16.0, 16.0, 0.1, 0.0, 0.1, 0.5, 0.5, 0.5, float("nan")],
}


@pytest.mark.parametrize("name", list(FIXED))
def test_cull_rect_is_conservative_on_fixed_cases(name):
    for ox, oy in ORIGINS:
        row = list(FIXED[name])
        row[0] += ox
        row[1] += oy
        escapes, _, rect = _escapes(row, ox, oy)
        assert not escapes.any(), f"{name} at tile ({ox}, {oy}): rect {[int(v) for v in rect]}"
        x0, x1, y0, y1 = (int(v) for v in rect)
        assert (x0, x1, y0, y1) == (1, 0, 1, 0) or (0 <= x0 <= x1 < TILE and 0 <= y0 <= y1 < TILE)


@pytest.mark.parametrize("name", ["nan mean", "inf conic", "singular", "indefinite", "zero conic", "opacity 0",
                                  "nan opacity", "tiny conic"])
def test_cull_rect_keeps_the_whole_tile_where_it_cannot_box(name):
    rect = tblend.plain_cull_rect(torch.tensor([FIXED[name]], dtype=torch.float32), torch.zeros(1), torch.zeros(1))
    assert [int(v) for v in rect] == [0, TILE - 1, 0, TILE - 1]


def test_cull_rect_is_tight_on_ordinary_gaussians():
    """A Gaussian of 3 sigma = 6 pixels in the tile's middle keeps a
    rectangle a little larger than its level set; one far outside, none."""
    rows = [_instance(16.0, 16.0, _conic(2, 2, 0), 0.5), _instance(200.0, 16.0, _conic(2, 2, 0), 0.5),
            _instance(16.0, -90.0, _conic(4, 2, 0.3), 0.9)]
    escapes, elig, (x0, x1, y0, y1) = _escapes(rows, 0, 0)
    assert not escapes.any()
    half = 2.0 * math.sqrt(2.0 * math.log(255 * 0.5))  # 6.2 pixels
    assert 16 - half - 3 <= int(x0[0]) <= 16 - half and 16 + half <= int(x1[0]) <= 16 + half + 3
    assert 16 - half - 3 <= int(y0[0]) <= 16 - half and 16 + half <= int(y1[0]) <= 16 + half + 3
    assert elig[0].sum() > 100 and not elig[1:].any()
    for k in (1, 2):
        assert (int(x0[k]), int(x1[k]), int(y0[k]), int(y1[k])) == (1, 0, 1, 0)


def test_cull_rect_broadcasts_over_tiles():
    rng = np.random.default_rng(0)
    f = torch.from_numpy(rng.uniform(0.05, 1.0, (3, 5, tb.FEAT_WIDTH)).astype(np.float32))
    f[..., tb.FEAT_CB] = 0.0
    f[..., :2] = torch.from_numpy(rng.uniform(0, 96, (3, 5, 2)).astype(np.float32))
    ox = torch.tensor([[0.0], [32.0], [64.0]])
    got = tblend.plain_cull_rect(f, ox, torch.zeros(3, 1))
    for t in range(3):
        want = tblend.plain_cull_rect(f[t], ox[t], torch.zeros(1))
        for g, w in zip(got, want):
            assert g.shape == (3, 5) and g.dtype == torch.int64
            np.testing.assert_array_equal(_np(g[t]), _np(w))


def _cells_of_rect(x0, x1, y0, y1):
    """The cells word of an inclusive pixel rectangle, cell by cell; an
    empty rectangle (x1 < x0) reaches none."""
    (cw, ch), word = tblend.CELL, 0
    if x1 < x0:
        return 0
    for row in range(TILE // ch):
        for col in range(TILE // cw):
            if x0 <= col * cw + cw - 1 and x1 >= col * cw and y0 <= row * ch + ch - 1 and y1 >= row * ch:
                word |= 1 << (row * (TILE // cw) + col)
    return word


@pytest.mark.parametrize("name", list(FIXED))
def test_cull_cells_are_the_cells_of_the_rect(name):
    for ox, oy in ORIGINS:
        row = list(FIXED[name])
        row[0] += ox
        row[1] += oy
        f = torch.tensor([row], dtype=torch.float32)
        o = torch.tensor([[float(ox)], [float(oy)]])
        rect = [int(v) for v in tblend.plain_cull_rect(f, o[0], o[1])]
        assert int(tblend.plain_cull_cells(f, o[0], o[1])) == _cells_of_rect(*rect), rect


def test_cull_cells_over_random_rects():
    """Ordinary Gaussians all over three tiles: every shape of rectangle."""
    rng = np.random.default_rng(3)
    n = 400
    f = np.zeros((n, tb.FEAT_WIDTH), np.float32)
    f[:, :2] = rng.uniform(-10, 106, (n, 2))
    for i in range(n):
        f[i, 2:5] = _conic(float(np.exp(rng.uniform(-1.5, 3.0))), float(np.exp(rng.uniform(-1.5, 3.0))),
                           float(rng.uniform(0, math.pi)))
    f[:, tb.FEAT_OPA] = rng.uniform(0.0, 1.0, n)
    f = torch.from_numpy(f)
    seen = set()
    for ox in (0.0, 32.0, 64.0):
        o = torch.tensor([[ox], [0.0]])
        rects = torch.stack(tblend.plain_cull_rect(f, o[0], o[1]), dim=1).tolist()
        words = tblend.plain_cull_cells(f, o[0], o[1]).tolist()
        for rect, word in zip(rects, words):
            assert word == _cells_of_rect(*rect), rect
            seen.add(word)
    assert 0 in seen and 0xFFFFFFFF in seen and len(seen) > 50


def test_instance_cull_gives_each_instance_its_tile(case):
    """On the CPU `instance_cull` is its plain version: the word and the
    level of each instance, in the tile whose range holds it; rows past the
    last range reach nothing."""
    b, grid = case.b, case.grid
    pad = torch.cat([b.inst, b.inst[:3]])
    cells, level = tblend.instance_cull(b.tile_starts, pad, grid)
    assert cells.dtype == torch.int64 and tuple(cells.shape) == (b.total + 3,) and not cells[b.total:].any()
    np.testing.assert_array_equal(_np(level), _np(tblend.plain_cull_level(pad)))
    starts = _np(b.tile_starts)
    some = False
    for t in range(grid.num_tiles):
        lo, hi = int(starts[t]), int(starts[t + 1])
        if hi == lo:
            continue
        o = torch.tensor([[float(t % grid.tiles_x * TILE)], [float(t // grid.tiles_x * TILE)]])
        np.testing.assert_array_equal(_np(cells[lo:hi]), _np(tblend.plain_cull_cells(b.inst[lo:hi], o[0], o[1])))
        some = some or bool((cells[lo:hi] != 0xFFFFFFFF).any())
    assert some and (cells[:b.total] != 0).any()


@settings(max_examples=300, deadline=None)
@given(
    mx=st.floats(-200.0, 232.0), my=st.floats(-200.0, 232.0),
    log_s1=st.floats(-2.0, 3.5), log_ratio=st.floats(0.0, 4.0), theta=st.floats(0.0, math.pi),
    opa=st.one_of(st.floats(0.0, 1.0), st.floats(EPS * 0.99, EPS * 1.01)),
    origin=st.sampled_from(ORIGINS),
)
def test_cull_rect_is_conservative_for_any_gaussian(mx, my, log_s1, log_ratio, theta, opa, origin):
    s1 = 10.0 ** log_s1
    s2 = max(s1 / 10.0 ** log_ratio, 1e-3)
    ox, oy = origin
    escapes, _, rect = _escapes(_instance(mx + ox, my + oy, _conic(s1, s2, theta), opa), ox, oy)
    assert not escapes.any(), [int(v) for v in rect]


@settings(max_examples=300, deadline=None)
@given(
    mx=st.floats(-100.0, 132.0), my=st.floats(-100.0, 132.0),
    log_ca=st.floats(-6.0, 4.0), log_cc=st.floats(-6.0, 4.0), rho=st.floats(-1.2, 1.2),
    opa=st.floats(0.0, 1.0), origin=st.sampled_from(ORIGINS),
)
def test_cull_rect_is_conservative_for_any_conic(mx, my, log_ca, log_cc, rho, opa, origin):
    """Conics straight from their entries: |rho| near 1 is near-singular,
    above 1 indefinite."""
    ca, cc = 10.0 ** log_ca, 10.0 ** log_cc
    ox, oy = origin
    row = _instance(mx + ox, my + oy, (ca, rho * math.sqrt(ca * cc), cc), opa)
    escapes, _, rect = _escapes(row, ox, oy)
    assert not escapes.any(), [int(v) for v in rect]


class Case:
    """One scene of CASES: the port's binning of the JAX splats (so both
    packages blend identical instances), and a backward seed."""

    def __init__(self, name):
        kw, w, h = CASES[name]
        self.w, self.h = w, h
        self.jscene, self.jcam = jsyn.random_scene(**kw), jsyn.default_camera(width=w, height=h)
        self.js = jpreprocess(self.jscene, self.jcam)
        self.grid = tb.make_grid(w, h)
        splats = TSplats(**{f: torch.from_numpy(np.array(getattr(self.js, f))) for f in SPLAT_FIELDS})
        self.b = tb.bin_splats(splats, self.grid, MAX_INST)
        self.n = self.js.mean2d.shape[0]
        rng = np.random.default_rng(7)
        self.w_img = rng.normal(size=(3, h, w)).astype(np.float32)
        self.w_t = rng.normal(size=(h, w)).astype(np.float32)
        self._seed = None

    def seed(self):
        """(tile_g, tile_r) from the JAX forward, as test_torch_backward.py makes them."""
        if self._seed is None:
            jgrid = jb.make_grid(self.w, self.h)
            image, final_t, _ = jtiled.blend_tiled(self.js, jnp.asarray(BG), self.w, self.h, MAX_INST, interpret=True)
            g = jnp.asarray(self.w_img)
            r = (image * g).sum(axis=0) + final_t * jnp.asarray(self.w_t)
            pad = lambda x: jnp.pad(x, ((0, 0), (0, jgrid.tiles_y * 32 - self.h), (0, jgrid.tiles_x * 32 - self.w)))
            self._seed = tuple(torch.from_numpy(np.array(jtiled._tile_image(pad(x), jgrid))) for x in (g, r[None]))
        return self._seed


_BUILT = {}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    if request.param not in _BUILT:
        _BUILT[request.param] = Case(request.param)
    return _BUILT[request.param]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_culled_plain_blend_is_bit_equal(case, exact):
    b = case.b
    want = tblend.plain_blend(b.tile_starts, b.inst, case.grid, exact=exact)
    got = tblend.plain_blend(b.tile_starts, b.inst, case.grid, exact=exact, cull=True)
    for g, w in zip(got, want):  # tile rgb, tile T, and the pairs by kind
        np.testing.assert_array_equal(_np(g), _np(w))
    assert _np(want[2])[:, 2].sum() > 0  # pairs were applied


def test_culled_plain_backward_is_bit_equal(case):
    b = case.b
    tile_g, tile_r = case.seed()
    want, work = tblend.plain_blend_backward(b.tile_starts, b.inst, tile_g, tile_r, case.grid)
    got, work_c = tblend.plain_blend_backward(b.tile_starts, b.inst, tile_g, tile_r, case.grid, cull=True)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(work_c), _np(work))
    assert np.abs(_np(want)).max() > 0


def test_culled_plain_counting_is_bit_equal(case):
    b = case.b
    want = tblend.plain_blend_counting(b.tile_starts, b.inst, b.gid_sorted, case.grid, case.n)
    got = tblend.plain_blend_counting(b.tile_starts, b.inst, b.gid_sorted, case.grid, case.n, cull=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
    assert int(want[3].sum()) > 0


def test_culled_plain_counting_matches_jax(case):
    """The counting blend's plain version with the cull on against the JAX
    counting path: hit counts equal to its tiled kernel's (interpret mode)
    and to its oracle's; importance within 1e-4 of the oracle's. The JAX
    tiled path takes each Gaussian's importance as a difference of a running
    float32 sum over all instances, 1.6e-3 off its own oracle on the dense
    scene (ROADMAP section C), so against it the limit is twice its own
    distance from the oracle, as in test_torch_gss.py."""
    b = case.b
    _, _, imp, cnt, _ = tblend.plain_blend_counting(b.tile_starts, b.inst, b.gid_sorted, case.grid, case.n, cull=True)
    bg = jnp.asarray(BG)
    tiled = jcount(case.jscene, case.jcam, bg, interpret=True)
    oracle = jcount(case.jscene, case.jcam, bg, method="reference")
    for want in (tiled, oracle):
        np.testing.assert_array_equal(_np(cnt), np.asarray(want.gaussians_count))
    np.testing.assert_allclose(_np(imp), np.asarray(oracle.important_score), atol=1e-4, rtol=0)
    own = float(np.abs(np.asarray(tiled.important_score) - np.asarray(oracle.important_score)).max())
    np.testing.assert_allclose(_np(imp), np.asarray(tiled.important_score), atol=max(1e-4, 2 * own), rtol=0)
    assert int(cnt.sum()) > 1000


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_culled_blend_matches_jax(case, fast):
    want = jrender(case.jscene, case.jcam, jnp.asarray(BG), method="tiled", interpret=True, fast=fast)
    b = case.b
    rgb, t, _ = tblend.plain_blend(b.tile_starts, b.inst, case.grid, exact=not fast, cull=True)
    image, final_t = ttiled._compose(rgb, t, torch.from_numpy(BG), case.grid, case.w, case.h)
    np.testing.assert_allclose(_np(image), np.asarray(want.render), atol=2e-5, rtol=0)
    np.testing.assert_allclose(_np(final_t), np.asarray(want.final_T), atol=2e-5, rtol=0)


def test_culled_backward_matches_jax_kernel(case):
    tile_g, tile_r = case.seed()
    jgrid = jb.make_grid(case.w, case.h)
    jbin = jb.bin_splats(case.js, jgrid, MAX_INST)
    total = int(jbin.total)
    want = np.asarray(jtiled._unchunk(jpk.blend_backward(
        jbin.tile_starts, jbin.inst_chunks, jnp.asarray(_np(tile_g)), jnp.asarray(_np(tile_r)), jgrid,
        interpret=True)))[:total, :tb.FEAT_WIDTH]
    b = case.b
    np.testing.assert_array_equal(_np(b.gid_sorted), np.asarray(jbin.gid_sorted)[:total])
    got, _ = tblend.plain_blend_backward(b.tile_starts, b.inst, tile_g, tile_r, case.grid, cull=True)
    for c in range(tb.FEAT_WIDTH):
        scale = np.abs(want[:, c]).max()
        assert scale > 0
        np.testing.assert_allclose(_np(got)[:, c] / scale, want[:, c] / scale, atol=5e-5, rtol=0,
                                   err_msg=f"per-instance column {c}")


def test_cull_census_on_the_small_scene():
    """`random_scene(n=256, seed=1)` at 96x64: 395 instances. A walk of every
    warp over every instance makes 8 x 395 (instance, warp) pairs; the cull
    rectangle over compact warp rectangles left 804 of them, and 1,743 of the
    4 x 3,160 (instance, cell) pairs, when this was written."""
    scene = tsyn.random_scene(n=256, seed=1, device="cpu")
    cam = tsyn.default_camera(width=96, height=64, device="cpu")
    grid = tb.make_grid(96, 64)
    b = tb.bin_splats(tpreprocess(scene, cam), grid, MAX_INST)
    c = tblend.cull_census(b.tile_starts, b.inst, grid)
    assert c["instances"] == b.total == 395 and c["warp_walked"] == 8 * 395
    # what the cull leaves covers what is applied, and is under a third (a seventh) of today's
    assert c["compact_applied"] <= c["warp_reached"] <= 0.3 * c["warp_walked"]
    assert c["cell_applied"] <= c["cell_reached"] <= 0.16 * 4 * c["warp_walked"]
    # compact rectangles alone: a third of the warps the strided footprint keeps busy
    assert 0 < c["compact_applied"] <= 0.4 * c["strided_applied"] <= 0.4 * c["warp_walked"]
    empty = tblend.cull_census(torch.zeros(grid.num_tiles + 1, dtype=torch.int32),
                               torch.zeros((0, tb.FEAT_WIDTH)), grid)
    assert set(empty) == set(c) and not any(empty.values())
