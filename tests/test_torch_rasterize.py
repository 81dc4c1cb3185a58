"""PyTorch port vs the JAX package: preprocess, oracle, binning, blend.

Scenes come from the same-seed `random_scene` of both packages (bit-
identical, see test_torch_math.py) and go through the JAX function and its
port counterpart on the CPU. There the blend wrappers run their plain
PyTorch versions; the CUDA kernels are held against those on the card by
`chip_smoke.py`. The JAX tiled path runs its Pallas kernels in interpret
mode, as the JAX package's own tests do.

Tolerances (float32):
- preprocess 1e-5: the same expressions, with sums of three terms possibly
  reordered; `radius` is an integer and must match exactly.
- image and final_T 2e-5, the JAX package's own oracle-vs-tiled tolerance
  (tests/test_rasterizer.py): prefix products are associated differently.
- the render-only (fast) blend against the JAX render-only blend: 2e-5 as
  above, since both compute the same naive-T contract with the same
  128-instance batches and the same exit rule.
- the render-only blend against the exact one 2e-3: they differ on
  saturated pixels by at most T_EPS/(1-MAX_ALPHA) = 1e-2 times bg; 2e-3 is
  the JAX package's gate for it (bench.py --parity).
- binning is integer work on identical inputs: exact.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgaussian_tpu.ops.rasterize import binning as jb
from lightgaussian_tpu.ops.rasterize import reference as jref
from lightgaussian_tpu.ops.rasterize import render as jrender
from lightgaussian_tpu.ops.rasterize.projection import Splats as JSplats
from lightgaussian_tpu.ops.rasterize.projection import preprocess as jpreprocess
from lightgaussian_tpu.utils import synthetic as jsyn
from lightgaussian_tpu_torch.ops.rasterize import binning as tb
from lightgaussian_tpu_torch.ops.rasterize import blend as tblend
from lightgaussian_tpu_torch.ops.rasterize import reference as tref
from lightgaussian_tpu_torch.ops.rasterize import render as trender
from lightgaussian_tpu_torch.ops.rasterize.projection import Splats as TSplats
from lightgaussian_tpu_torch.ops.rasterize.projection import preprocess as tpreprocess
from lightgaussian_tpu_torch.utils import cuda_build
from lightgaussian_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

BG = np.array([0.1, 0.2, 0.3], np.float32)
SPLAT_FIELDS = ("mean2d", "conic", "color", "opacity", "depth", "radius")

# (scene kwargs, width, height): the JAX suite's 256-Gaussian scene, the
# multi-chunk scene of bench.py --parity, and a scene of large opaque splats
# whose central tiles saturate, so the blends' early exit is taken.
CASES = {
    "small": (dict(n=256, seed=1), 96, 64),
    "dense": (dict(n=2048, seed=1, extent=1.2, scale_range=(0.01, 0.06)), 192, 128),
    "saturated": (dict(n=800, seed=3, extent=1.5, scale_range=(0.15, 0.4)), 96, 64),
}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Case:
    """Both packages' scene, camera and renders for one entry of CASES."""

    def __init__(self, name):
        kw, w, h = CASES[name]
        self.w, self.h = w, h
        self.jscene = jsyn.random_scene(**kw)
        self.jcam = jsyn.default_camera(width=w, height=h)
        self.tscene = tsyn.random_scene(device="cpu", **kw)
        self.tcam = tsyn.default_camera(width=w, height=h, device="cpu")
        self.jbg, self.tbg = jnp.asarray(BG), torch.from_numpy(BG)
        self.jsplats = jpreprocess(self.jscene, self.jcam)
        self.tsplats = tpreprocess(self.tscene, self.tcam)
        self.jref = jrender(self.jscene, self.jcam, self.jbg, method="reference")
        self.jtiled = jrender(self.jscene, self.jcam, self.jbg, method="tiled", interpret=True)
        self.jfast = jrender(self.jscene, self.jcam, self.jbg, method="tiled", interpret=True, fast=True)
        self.texact = trender(self.tscene, self.tcam, self.tbg)
        self.tfast = trender(self.tscene, self.tcam, self.tbg, fast=True)

    def jax_splats_in_torch(self):
        """The JAX splats as port Splats: binning compared on identical inputs."""
        return TSplats(**{f: torch.from_numpy(np.array(getattr(self.jsplats, f))) for f in SPLAT_FIELDS})


_BUILT = {}


def _case(name):
    if name not in _BUILT:
        _BUILT[name] = Case(name)
    return _BUILT[name]


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return _case(request.param)


@pytest.fixture(scope="module")
def small():
    return _case("small")


def test_preprocess_matches_jax(case):
    for f in SPLAT_FIELDS:
        want, got = np.asarray(getattr(case.jsplats, f)), _np(getattr(case.tsplats, f))
        assert got.shape == want.shape and got.dtype == want.dtype, f
        if f == "radius":
            np.testing.assert_array_equal(got, want)
            continue
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=f)
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], atol=1e-5, rtol=1e-6, err_msg=f)
    assert (_np(case.tsplats.radius) > 0).sum() > 100


def test_preprocess_overrides_match_jax(small):
    rng = np.random.default_rng(5)
    n = small.tscene.capacity
    offset = rng.normal(0, 0.01, (n, 2)).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    cov6 = np.abs(rng.normal(0, 0.01, (n, 6))).astype(np.float32)
    cov6[:, [0, 3, 5]] += 0.01
    j = jpreprocess(small.jscene, small.jcam, scale_modifier=0.8, mean2d_offset=jnp.asarray(offset),
                    colors_precomp=jnp.asarray(colors), cov3d_precomp=jnp.asarray(cov6))
    t = tpreprocess(small.tscene, small.tcam, scale_modifier=0.8, mean2d_offset=torch.from_numpy(offset),
                    colors_precomp=torch.from_numpy(colors), cov3d_precomp=torch.from_numpy(cov6))
    for f in SPLAT_FIELDS:
        want, got = np.asarray(getattr(j, f)), _np(getattr(t, f))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], atol=1e-5, rtol=1e-6, err_msg=f)
    j2 = jpreprocess(small.jscene, small.jcam, scale_modifier=0.8)
    t2 = tpreprocess(small.tscene, small.tcam, scale_modifier=0.8)
    np.testing.assert_array_equal(_np(t2.radius), np.asarray(j2.radius))


def test_culled_and_dead_gaussians(small):
    alive = small.tscene.alive.clone()
    alive[::3] = False
    s = tpreprocess(dataclasses.replace(small.tscene, alive=alive), small.tcam)
    dead = ~alive.numpy()
    assert (_np(s.radius)[dead] == 0).all() and (_np(s.opacity)[dead] == 0).all()
    assert np.isinf(_np(s.depth)[dead]).all()


def test_oracle_matches_jax_oracle(case):
    # the port's oracle always restricts Gaussians to their tile rects
    want_img, want_t = jref.blend_reference(case.jsplats, case.w, case.h, case.jbg, tile_size=32)
    got_img, got_t = tref.blend_reference(case.tsplats, case.w, case.h, case.tbg)
    np.testing.assert_allclose(_np(got_img), np.asarray(want_img), atol=2e-5, rtol=0)
    np.testing.assert_allclose(_np(got_t), np.asarray(want_t), atol=2e-5, rtol=0)
    assert _np(got_t).min() < 0.6  # the scene is not vacuous


def test_tile_rect_and_mask_match_jax(case):
    grid = jb.make_grid(case.w, case.h)
    js, ts = case.jsplats, case.jax_splats_in_torch()
    for tight in (False, True):
        extra_j = dict(conic=js.conic, opacity=js.opacity) if tight else {}
        extra_t = dict(conic=ts.conic, opacity=ts.opacity) if tight else {}
        want = jb.tile_rect(js.mean2d, js.radius, grid, **extra_j)
        got = tb.tile_rect(ts.mean2d, ts.radius, tb.make_grid(case.w, case.h), **extra_t)
        live = np.asarray(want[4]) > 0
        np.testing.assert_array_equal(_np(got[4]), np.asarray(want[4]))
        for a, b in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(_np(a)[live], np.asarray(b)[live])
    lo_x, lo_y, hi_x, _, cnt = want
    jm, jc, ju = jb._exact_tile_mask(js, lo_x, lo_y, hi_x, cnt, 32)
    tm, tc, tu = tb._exact_tile_mask(ts, *[torch.from_numpy(np.asarray(x, np.int64)) for x in (lo_x, lo_y, hi_x, cnt)])
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(tu), np.asarray(ju))
    np.testing.assert_array_equal(_np(tm)[np.asarray(ju)], np.asarray(jm).astype(np.int64)[np.asarray(ju)])
    assert (np.asarray(jc) < np.asarray(cnt)).any()  # the exact test drops tiles here


def test_kth_set_bit_matches_jax():
    rng = np.random.default_rng(0)
    masks = rng.integers(1, 1 << 32, size=512, dtype=np.int64)
    pops = np.array([bin(int(m)).count("1") for m in masks])
    ks = (rng.uniform(size=512) * pops).astype(np.int64)
    want = np.asarray(jb._kth_set_bit(jnp.asarray(masks.astype(np.uint32)), jnp.asarray(ks, jnp.int32)))
    got = _np(tb._kth_set_bit(torch.from_numpy(masks), torch.from_numpy(ks)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_np(tb._popcount32(torch.from_numpy(masks))), pops)


@pytest.mark.parametrize("inputs", ["jax_splats", "port_splats"])
def test_bin_splats_matches_jax(case, inputs):
    grid = jb.make_grid(case.w, case.h)
    want = jb.bin_splats(case.jsplats, grid, 1 << 16, forward_only=True)
    splats = case.jax_splats_in_torch() if inputs == "jax_splats" else case.tsplats
    got = tb.bin_splats(splats, tb.make_grid(case.w, case.h), 1 << 16)
    total = int(want.total)
    assert got.total == total and total > 0
    np.testing.assert_array_equal(_np(got.tile_starts), np.asarray(want.tile_starts))
    starts = np.asarray(want.tile_starts)
    jgid, tgid = np.asarray(want.gid_sorted), _np(got.gid_sorted)
    for t in range(grid.num_tiles):
        a, b = starts[t], starts[t + 1]
        # each tile's Gaussians, in the same depth order
        np.testing.assert_array_equal(tgid[a:b], jgid[a:b], err_msg=f"tile {t}")
    feat = np.asarray(jb.pack_features(case.jsplats))[jgid[:total]][:, :tb.FEAT_WIDTH]
    if inputs == "jax_splats":
        np.testing.assert_array_equal(_np(got.inst), feat)


def test_bin_splats_capacity_cut_matches_jax(small):
    """An overflowing frame drops the same instances in both packages."""
    grid = jb.make_grid(small.w, small.h)
    full = jb.bin_splats(small.jsplats, grid, 1 << 16, forward_only=True)
    cap = (int(full.total) // 2) // 128 * 128
    want = jb.bin_splats(small.jsplats, grid, cap, forward_only=True)
    got = tb.bin_splats(small.jax_splats_in_torch(), tb.make_grid(small.w, small.h), cap)
    assert got.total == int(want.total) == int(full.total)
    assert got.inst.shape[0] == cap
    np.testing.assert_array_equal(_np(got.tile_starts), np.asarray(want.tile_starts))
    np.testing.assert_array_equal(_np(got.gid_sorted), np.asarray(want.gid_sorted)[:cap])


def test_depth_ties_keep_gaussian_order():
    """Equal depths and positions: a stable sort keeps ascending ids, as the
    JAX package's stable u32 sort does."""
    n = 40
    mean2d = np.tile(np.array([[40.0, 30.0]], np.float32), (n, 1))
    conic = np.tile(np.array([[0.05, 0.0, 0.05]], np.float32), (n, 1))
    kw = dict(mean2d=mean2d, conic=conic, color=np.full((n, 3), 0.5, np.float32),
              opacity=np.full(n, 0.5, np.float32), depth=np.full(n, 3.0, np.float32),
              radius=np.full(n, 12, np.int32))
    grid = jb.make_grid(96, 64)
    want = jb.bin_splats(JSplats(**{k: jnp.asarray(v) for k, v in kw.items()}), grid, 4096, forward_only=True)
    got = tb.bin_splats(TSplats(**{k: torch.from_numpy(v) for k, v in kw.items()}), tb.make_grid(96, 64), 4096)
    np.testing.assert_array_equal(_np(got.gid_sorted), np.asarray(want.gid_sorted)[:got.total])


def test_exact_blend_matches_jax(case):
    for want in (case.jtiled, case.jref):
        np.testing.assert_allclose(_np(case.texact.render), np.asarray(want.render), atol=2e-5, rtol=0)
        np.testing.assert_allclose(_np(case.texact.final_T), np.asarray(want.final_T), atol=2e-5, rtol=0)
    assert case.texact.num_instances == int(case.jtiled.num_instances)
    np.testing.assert_array_equal(_np(case.texact.radii), np.asarray(case.jtiled.radii))
    np.testing.assert_array_equal(_np(case.texact.visibility), np.asarray(case.jtiled.visibility))


def test_fast_blend_matches_jax(case):
    np.testing.assert_allclose(_np(case.tfast.render), np.asarray(case.jfast.render), atol=2e-5, rtol=0)
    np.testing.assert_allclose(_np(case.tfast.final_T), np.asarray(case.jfast.final_T), atol=2e-5, rtol=0)
    np.testing.assert_allclose(_np(case.tfast.render), _np(case.texact.render), atol=2e-3, rtol=0)


def test_saturated_case_exercises_early_exit():
    c = _case("saturated")
    grid = tb.make_grid(c.w, c.h)
    b = tb.bin_splats(c.tsplats, grid, 1 << 16)
    assert b.total > 2000  # several 128-instance batches per tile
    _, t_exact, work = tblend.plain_blend(b.tile_starts, b.inst, grid, exact=True)
    pairs = _np(work).sum(axis=1)
    lengths = _np(b.tile_starts[1:] - b.tile_starts[:-1]).astype(np.int64)
    # every pixel of the 96x64 grid is in the image
    assert (pairs <= lengths * tblend.PIX).all() and (pairs < lengths * tblend.PIX).any()
    assert pairs.sum() > 0
    kinds = dict(zip(tblend.WORK_KINDS, _np(work).sum(axis=0)))
    # the exact blend never walks past a stop; faint, applied and stopping
    # pairs all occur (positive-definite conics leave "culled" empty)
    assert kinds["past_stop"] == 0
    assert min(kinds["faint"], kinds["applied"], kinds["stopping"]) > 0
    _, t_fast, work_fast = tblend.plain_blend(b.tile_starts, b.inst, grid, exact=False)
    pairs_fast = _np(work_fast).sum(axis=1)
    # the render-only blend walks the same instances, for every pixel
    assert (pairs_fast >= pairs).all() and (pairs_fast > pairs).any()
    assert (pairs_fast % tblend.PIX == 0).all() and (pairs_fast < lengths * tblend.PIX).any()
    # both apply and stop on the same pairs; the render-only blend also walks
    # faint and eligible pairs past each pixel's stop
    np.testing.assert_array_equal(_np(work_fast)[:, 2:4], _np(work)[:, 2:4])
    assert (_np(work_fast)[:, :2] >= _np(work)[:, :2]).all() and _np(work_fast)[:, 4].sum() > 0
    # naive T never exceeds the applied T; they differ on saturated pixels only
    assert (_np(t_fast) <= _np(t_exact) + 1e-7).all() and (_np(t_fast) < _np(t_exact)).any()


def test_empty_scene_renders_bg(small):
    s = tsyn.random_scene(n=8, seed=2, device="cpu")
    s = dataclasses.replace(s, alive=torch.zeros_like(s.alive))
    for fast in (False, True):
        out = trender(s, small.tcam, small.tbg, fast=fast)
        img = _np(out.render)
        np.testing.assert_allclose(img, np.broadcast_to(BG[:, None, None], img.shape), atol=1e-6)
        assert out.num_instances == 0
        np.testing.assert_array_equal(_np(out.final_T), 1.0)


def test_reference_method_and_bad_method(small):
    out = trender(small.tscene, small.tcam, small.tbg, method="reference")
    np.testing.assert_allclose(_np(out.render), np.asarray(small.jref.render), atol=2e-5, rtol=0)
    assert out.num_instances == 0
    with pytest.raises(ValueError, match="unknown render method"):
        trender(small.tscene, small.tcam, small.tbg, method="nope")


def test_blend_wrappers_on_cpu_use_plain_versions(small):
    grid = tb.make_grid(small.w, small.h)
    b = tb.bin_splats(small.tsplats, grid, 1 << 16)
    cuda_build.reset_launch_counts()
    for wrapper, exact in ((tblend.blend_forward, True), (tblend.blend_forward_fast, False)):
        got = wrapper(b.tile_starts, b.inst, grid)
        want = tblend.plain_blend(b.tile_starts, b.inst, grid, exact=exact)[:2]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), _np(w))
            assert g.shape[0] == grid.num_tiles and g.shape[2] == tblend.PIX
    assert set(cuda_build.launch_counts()) >= {"blend_forward", "blend_forward_fast"}
    assert not any(cuda_build.launch_counts().values())  # no kernel ran
    with pytest.raises(ValueError, match="int32"):
        tblend.blend_forward(b.tile_starts.long(), b.inst, grid)
    with pytest.raises(ValueError, match="float32"):
        tblend.blend_forward(b.tile_starts, b.inst.double(), grid)
    with pytest.raises(ValueError, match="contiguous"):
        tblend.blend_forward(b.tile_starts, torch.zeros(tb.FEAT_WIDTH, 4).T, grid)


def test_blend_refuses_gradients(small):
    """The render-only blend has no backward (as in the JAX package) and
    refuses inputs that require a gradient; the exact blend has one."""
    scene = dataclasses.replace(small.tscene, means=small.tscene.means.clone().requires_grad_(True))
    with pytest.raises(NotImplementedError, match="backward"):
        trender(scene, small.tcam, small.tbg, fast=True)
    with torch.no_grad():
        out = trender(scene, small.tcam, small.tbg, fast=True)
    np.testing.assert_allclose(_np(out.render), _np(small.tfast.render), atol=0)
    out = trender(scene, small.tcam, small.tbg)
    np.testing.assert_allclose(_np(out.render), _np(small.texact.render), atol=0)
    (g,) = torch.autograd.grad(out.render.sum(), [scene.means])
    assert torch.isfinite(g).all() and g.abs().max() > 0


def test_capacity_helpers_match_jax():
    grid_j, grid_t = jb.make_grid(1920, 1080), tb.make_grid(1920, 1080)
    assert tuple(grid_t) == tuple(grid_j) and grid_t.num_tiles == grid_j.num_tiles == 2040
    assert tb.sort_key_bits(grid_t) == jb.sort_key_bits(grid_j)
    for n in (1, 1000, 303_104):
        assert tb.estimate_max_instances(n) == jb.estimate_max_instances(n, grid_j)
        assert tb.instance_capacity(n) == jb.instance_capacity(n, grid_j)
    for live in (10, 700_000, 768_651):
        assert tb.snug_capacity(live) == jb.snug_capacity(live)
    # the port's ceiling is its int32 tile ranges', not the JAX package's 2^24
    assert tb.MAX_CAPACITY == (1 << 31) - tb.INST_CHUNK and jb.MAX_CAPACITY == 1 << 24
    assert tb.instance_capacity(jb.MAX_CAPACITY + 1) == jb.MAX_CAPACITY + tb.INST_CHUNK
    assert tb.estimate_max_instances(3_000_000) == 24_000_000 > jb.estimate_max_instances(3_000_000, grid_j)
    with pytest.raises(ValueError):
        tb.instance_capacity(tb.MAX_CAPACITY + 1)
