"""PyTorch port vs the JAX package: the counting blend, the Global
Significance Score, the 3-NN scale initialisation, the chunk transpose and
the issue-rate probe's recurrences.

Scenes come from the same-seed `random_scene` of both packages (bit-
identical, see test_torch_math.py). The JAX tiled path runs its Pallas
kernels in interpret mode; the port's wrappers run their plain PyTorch
versions on the CPU (the CUDA kernels are held against those on the card by
`chip_smoke.py`).

Tolerances (float32):
- hit counts are integers decided by the same thresholds on the same
  splats: equal.
- importance against either package's oracle: atol 1e-4 per camera, the JAX
  suite's own (tests/test_rasterizer.py); the sums run in another order.
  Against the JAX tiled path the same on the small scene. On the dense and
  the saturated scene the JAX tiled path is itself 1.6e-3 and 6.9e-4 off its
  own oracle (it takes each Gaussian's sum as a difference of a running
  float32 sum over all instances), so there the port is held to twice the
  JAX tiled path's own distance from its oracle, and to the oracles at 1e-4.
- the counting render's image against the port's exact render: 1e-6 (the
  same operations).
- `calculate_v_imp_score` rtol 1e-5 (`pow` differs in the last bits);
  `percentile_keep_mask` equal, given the same scores.
- 3-NN distances rtol 1e-5: the same candidates, sums of three squares.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgaussian_tpu.models import gaussians as jgauss
from lightgaussian_tpu.ops import knn as jknn
from lightgaussian_tpu.ops.rasterize import count_render as jcount
from lightgaussian_tpu.ops.rasterize import pallas_blend as jpk
from lightgaussian_tpu.train import densify as jdensify
from lightgaussian_tpu.train import gss as jgss
from lightgaussian_tpu.train import loop as jloop
from lightgaussian_tpu.train import state as jstate
from lightgaussian_tpu.utils import synthetic as jsyn
from lightgaussian_tpu_torch.models import gaussians as tgauss
from lightgaussian_tpu_torch.ops import knn as tknn
from lightgaussian_tpu_torch.ops.rasterize import binning as tb
from lightgaussian_tpu_torch.ops.rasterize import blend as tblend
from lightgaussian_tpu_torch.ops.rasterize import count_render as tcount
from lightgaussian_tpu_torch.ops.rasterize import render as trender
from lightgaussian_tpu_torch.ops.rasterize.projection import preprocess as tpreprocess
from lightgaussian_tpu_torch.train import gss as tgss
from lightgaussian_tpu_torch.train import loop as tloop
from lightgaussian_tpu_torch.train import state as tstate
from lightgaussian_tpu_torch.utils import cuda_build, issue_probe
from lightgaussian_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

BG = np.array([0.1, 0.2, 0.3], np.float32)
MAX_INST = 1 << 16
# the three scenes of test_torch_rasterize.py
CASES = {
    "small": (dict(n=256, seed=1), 96, 64),
    "dense": (dict(n=2048, seed=1, extent=1.2, scale_range=(0.01, 0.06)), 192, 128),
    "saturated": (dict(n=800, seed=3, extent=1.5, scale_range=(0.15, 0.4)), 96, 64),
}
IMP_ATOL = 1e-4


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Case:
    def __init__(self, name):
        kw, w, h = CASES[name]
        self.name, self.w, self.h = name, w, h
        self.jscene = jsyn.random_scene(**kw)
        self.jcam = jsyn.default_camera(width=w, height=h)
        self.tscene = tsyn.random_scene(device="cpu", **kw)
        self.tcam = tsyn.default_camera(width=w, height=h, device="cpu")
        self.jbg, self.tbg = jnp.asarray(BG), torch.from_numpy(BG)
        self.jtiled = jcount(self.jscene, self.jcam, self.jbg, interpret=True)
        self.jref = jcount(self.jscene, self.jcam, self.jbg, method="reference")
        self.ttiled = tcount(self.tscene, self.tcam, self.tbg)
        self.tref = tcount(self.tscene, self.tcam, self.tbg, method="reference")


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return Case(request.param)


def test_count_render_matches_jax_and_oracles(case):
    got = case.ttiled
    assert got.gaussians_count.dtype == torch.int32 and got.important_score.dtype == torch.float32
    assert int(got.gaussians_count.sum()) > 1000
    jax_tiled_own = float(np.abs(_np(case.jtiled.important_score) - _np(case.jref.important_score)).max())
    assert jax_tiled_own <= IMP_ATOL or case.name != "small"
    for want, atol in ((case.jtiled, max(IMP_ATOL, 2 * jax_tiled_own)), (case.jref, IMP_ATOL),
                       (case.tref, IMP_ATOL)):
        np.testing.assert_array_equal(_np(got.gaussians_count), _np(want.gaussians_count))
        np.testing.assert_allclose(_np(got.important_score), _np(want.important_score), atol=atol, rtol=0)
    assert got.num_instances == int(case.jtiled.num_instances)
    exact = trender(case.tscene, case.tcam, case.tbg)
    np.testing.assert_allclose(_np(got.render), _np(exact.render), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(got.final_T), _np(exact.final_T), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(case.tref.render), _np(case.jref.render), atol=2e-5, rtol=0)
    # a Gaussian that was blended into no pixel holds an exact zero
    unseen = _np(got.gaussians_count) == 0
    assert (_np(got.important_score)[unseen] == 0).all()
    assert unseen.any() or case.name != "saturated"


def test_counting_wrapper_on_cpu_uses_plain_version(case):
    grid = tb.make_grid(case.w, case.h)
    b = tb.bin_splats(tpreprocess(case.tscene, case.tcam), grid, MAX_INST)
    n = case.tscene.capacity
    cuda_build.reset_launch_counts()
    got = tblend.blend_forward_counting(b.tile_starts, b.inst, b.gid_sorted, grid, n)
    want = tblend.plain_blend_counting(b.tile_starts, b.inst, b.gid_sorted, grid, n)
    for g, w in zip(got, want[:4]):
        np.testing.assert_array_equal(_np(g), _np(w))
    assert cuda_build.launch_counts()["blend_count"] == 0  # no kernel ran
    # the work is the exact blend's, and so are the image planes
    rgb, t, work = tblend.plain_blend(b.tile_starts, b.inst, grid, exact=True)
    np.testing.assert_array_equal(_np(want[4]), _np(work))
    np.testing.assert_array_equal(_np(got[0]), _np(rgb))
    np.testing.assert_array_equal(_np(got[1]), _np(t))
    # the count is the number of applied pairs
    assert int(got[3].sum()) == int(work[:, tblend.WORK_KINDS.index("applied")].sum())
    if case.name == "saturated":
        # tiles exit early here: instances past the exit keep zeros
        lengths = _np(b.tile_starts[1:] - b.tile_starts[:-1]).astype(np.int64)
        assert (_np(work).sum(axis=1) < lengths * tblend.PIX).any()


def test_count_render_under_a_cut_matches_jax():
    """A frame that overflows `max_instances`: both packages cut the same
    instances, so the counts of what is left are equal too."""
    c = Case("small")
    cap = (int(c.jtiled.num_instances) // 2) // 128 * 128
    want = jcount(c.jscene, c.jcam, c.jbg, max_instances=cap, interpret=True)
    got = tcount(c.tscene, c.tcam, c.tbg, max_instances=cap)
    assert got.num_instances == int(want.num_instances) == int(c.jtiled.num_instances) > cap
    np.testing.assert_array_equal(_np(got.gaussians_count), _np(want.gaussians_count))
    np.testing.assert_allclose(_np(got.important_score), _np(want.important_score), atol=IMP_ATOL, rtol=0)
    np.testing.assert_allclose(_np(got.render), _np(want.render), atol=2e-5, rtol=0)
    assert int(got.gaussians_count.sum()) < int(c.ttiled.gaussians_count.sum())


def test_counting_wrapper_checks_its_inputs():
    c = Case("small")
    grid = tb.make_grid(c.w, c.h)
    b = tb.bin_splats(tpreprocess(c.tscene, c.tcam), grid, MAX_INST)
    n = c.tscene.capacity
    with pytest.raises(ValueError, match="int64"):
        tblend.blend_forward_counting(b.tile_starts, b.inst, b.gid_sorted.int(), grid, n)
    with pytest.raises(ValueError, match="int64"):
        tblend.blend_forward_counting(b.tile_starts, b.inst, b.gid_sorted[:-1], grid, n)
    with pytest.raises(ValueError, match="int32"):
        tblend.blend_forward_counting(b.tile_starts.long(), b.inst, b.gid_sorted, grid, n)
    with pytest.raises(ValueError, match="contiguous"):
        tblend.blend_forward_counting(b.tile_starts, b.inst, b.gid_sorted.repeat(2)[::2], grid, n)
    with pytest.raises(ValueError, match="unknown render method"):
        tcount(c.tscene, c.tcam, c.tbg, method="nope")
    empty = dataclasses.replace(c.tscene, alive=torch.zeros_like(c.tscene.alive))
    out = tcount(empty, c.tcam, c.tbg)
    assert int(out.gaussians_count.sum()) == 0 and out.num_instances == 0


# ---- GSS ----------------------------------------------------------------------

class GssWorld:
    """The JAX suite's GSS scene and three cameras, in both packages."""

    def __init__(self):
        kw = dict(n=48, seed=3, max_sh_degree=1, scale_range=(0.05, 0.15), capacity=64)
        self.jscene = jsyn.random_scene(**kw)
        self.tscene = tsyn.random_scene(device="cpu", **kw)
        self.jcams, self.tcams = [], []
        from lightgaussian_tpu.models.camera import Camera as JCamera
        from lightgaussian_tpu_torch.models.camera import Camera as TCamera

        for i in range(3):
            eye = [3.0 * np.sin(0.5 * i), 0.4, -3.0 * np.cos(0.5 * i)]
            self.jcams.append(JCamera.look_at(eye=eye, target=[0, 0, 0], width=64, height=64))
            self.tcams.append(TCamera.look_at(eye=eye, target=[0, 0, 0], width=64, height=64, device="cpu"))
        self.jbg, self.tbg = jnp.zeros(3), torch.zeros(3)
        self.jcounts, self.jimp = jgss.accumulate_gss(self.jscene, self.jcams, self.jbg, 1 << 14, interpret=True)


@pytest.fixture(scope="module")
def gss_world():
    return GssWorld()


def test_accumulate_gss_matches_jax(gss_world):
    w = gss_world
    counts, imp = tgss.accumulate_gss(w.tscene, w.tcams, w.tbg, 1 << 14)
    np.testing.assert_array_equal(_np(counts), np.asarray(w.jcounts))
    np.testing.assert_allclose(_np(imp), np.asarray(w.jimp), atol=IMP_ATOL * len(w.tcams), rtol=0)
    # cameras that carry cached SSIM planes give the same sums
    planes = (torch.zeros(3, 64, 64), torch.zeros(3, 64, 64))
    with_stats = [c.with_gt_ssim_stats(planes) for c in w.tcams]
    counts2, imp2 = tgss.accumulate_gss_auto(w.tscene, with_stats, w.tbg, 1 << 14)
    np.testing.assert_array_equal(_np(counts2), _np(counts))
    np.testing.assert_array_equal(_np(imp2), _np(imp))


def test_v_imp_score_matches_jax(gss_world):
    w = gss_world
    imp = np.asarray(w.jimp)
    for v_pow in (0.1, 0.5):
        want = np.asarray(jgss.calculate_v_imp_score(w.jscene, jnp.asarray(imp), v_pow))
        got = _np(tgss.calculate_v_imp_score(w.tscene, torch.from_numpy(imp.copy()), v_pow))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        assert (got[~_np(w.tscene.alive)] == 0).all() and got.max() > 0


def _scene_with_alive(n_alive, cap, seed):
    rng = np.random.default_rng(seed)
    alive = np.zeros(cap, bool)
    alive[rng.permutation(cap)[:n_alive]] = True
    kw = dict(n=cap, seed=5, max_sh_degree=0, capacity=cap)
    js = dataclasses.replace(jsyn.random_scene(**kw), alive=jnp.asarray(alive))
    ts = dataclasses.replace(tsyn.random_scene(device="cpu", **kw), alive=torch.from_numpy(alive))
    return js, ts


def test_quantile_indices_are_float32_for_every_alive_count():
    """`n_alive` swept over 1..200: the kept set and the volume score equal
    the JAX package's, whose indices are float32 products."""
    cap = 208
    rng = np.random.default_rng(0)
    scores = rng.permutation(cap).astype(np.float32)  # distinct, so an index off by one shows
    differs_from_float64 = 0
    for n_alive in range(1, 201):
        js, ts = _scene_with_alive(n_alive, cap, n_alive)
        for percent in (0.3, 0.5, 0.58, 0.7):
            want = np.asarray(jgss.percentile_keep_mask(js, jnp.asarray(scores), jnp.float32(percent)))
            got = _np(tgss.percentile_keep_mask(ts, torch.from_numpy(scores), percent))
            np.testing.assert_array_equal(got, want, err_msg=f"n_alive {n_alive} percent {percent}")
            differs_from_float64 += int(percent * n_alive) != int(np.float32(percent) * np.float32(n_alive))
        want_v = np.asarray(jgss.calculate_v_imp_score(js, jnp.asarray(scores), 0.1))
        got_v = _np(tgss.calculate_v_imp_score(ts, torch.from_numpy(scores), 0.1))
        np.testing.assert_allclose(got_v, want_v, rtol=1e-5, atol=0, err_msg=f"n_alive {n_alive}")
    assert differs_from_float64 > 0  # the sweep holds counts where a float64 index would differ


def test_percentile_keep_mask_is_strict():
    _, ts = _scene_with_alive(10, 16, 1)
    scores = torch.ones(16)
    assert not tgss.percentile_keep_mask(ts, scores, 0.5).any()  # ties with the threshold go


@pytest.mark.parametrize("prune_type", tloop.PRUNE_TYPES)
def test_gss_prune_matches_jax(gss_world, prune_type):
    w = gss_world
    jst = jstate.init_train_state(w.jscene)
    tst = tstate.init_train_state(w.tscene)
    want, want_v = jloop.gss_prune(jst, w.jcams, w.jbg, 0.4, 0.1, 1 << 14, True, prune_type=prune_type)
    got, got_v = tloop.gss_prune(tst, w.tcams, w.tbg, 0.4, 0.1, 1 << 14, prune_type=prune_type)
    np.testing.assert_array_equal(_np(got.scene.alive), np.asarray(want.scene.alive))
    np.testing.assert_allclose(_np(got_v), np.asarray(want_v), rtol=1e-4, atol=1e-6)
    n0, n1 = int(w.tscene.alive.sum()), int(got.scene.alive.sum())
    assert n1 < n0 and n1 >= int(0.5 * n0)
    with pytest.raises(ValueError, match="prune_type"):
        tloop.gss_prune(tst, w.tcams, w.tbg, 0.4, 0.1, 1 << 14, prune_type="nope")


def test_prune_by_mask_and_prune_only_match_jax(gss_world):
    from lightgaussian_tpu_torch.train import densify as tdensify

    w = gss_world
    keep = np.random.default_rng(2).random(64) > 0.3
    jst = jdensify.prune_by_mask(jstate.init_train_state(w.jscene), jnp.asarray(keep))
    tst = tdensify.prune_by_mask(tstate.init_train_state(w.tscene), torch.from_numpy(keep))
    np.testing.assert_array_equal(_np(tst.scene.alive), np.asarray(jst.scene.alive))
    min_opacity = float(w.tscene.opacities[w.tscene.alive].median())
    for size in (0, 20):
        jp = jdensify.prune_only(jstate.init_train_state(w.jscene), min_opacity, 1.0, size)
        tp = tdensify.prune_only(tstate.init_train_state(w.tscene), min_opacity, 1.0, size)
        np.testing.assert_array_equal(_np(tp.scene.alive), np.asarray(jp.scene.alive))
        assert 0 < int(tp.scene.alive.sum()) < 48


# ---- kNN and the scene from a point cloud ---------------------------------------

def _points(n=500, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, 1.0, (n, 3)).astype(np.float32)
    pts[n - 20:] = pts[:20]  # duplicates: several points in one Morton cell
    pts[n - 25:n - 20] = pts[0]
    return pts


def test_morton_codes_match_jax():
    pts = _points()
    for perm in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        want = np.asarray(jknn.morton_codes(jnp.asarray(pts), perm)).astype(np.int64)
        got = _np(tknn.morton_codes(torch.from_numpy(pts), perm))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            _np(tknn._window_candidates(torch.from_numpy(pts), perm, 24)),
            np.asarray(jknn._window_candidates(jnp.asarray(pts), perm, 24)),
        )


def test_mean_sq_dist_to_3nn_matches_jax():
    pts = _points()
    want = np.asarray(jknn.mean_sq_dist_to_3nn(jnp.asarray(pts)))
    got = _np(tknn.mean_sq_dist_to_3nn(torch.from_numpy(pts)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)
    exact = _np(tknn.mean_sq_dist_to_3nn_exact(torch.from_numpy(pts)))
    np.testing.assert_allclose(exact, np.asarray(jknn.mean_sq_dist_to_3nn_exact(jnp.asarray(pts))),
                               rtol=1e-5, atol=1e-12)
    # the window search never finds a nearer neighbour than there is, and on
    # this cloud it finds the true three for more than half the points
    assert (got >= exact * (1 - 1e-5) - 1e-12).all()
    assert np.mean(np.isclose(got, exact, rtol=1e-5, atol=1e-12)) > 0.5
    # two points only: the missing neighbours count as 0
    two = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    np.testing.assert_allclose(_np(tknn.mean_sq_dist_to_3nn(two)), [1.0 / 3.0, 1.0 / 3.0], rtol=1e-6)


def test_from_point_cloud_and_compact_match_jax():
    pts = _points(300, seed=4)
    cols = np.random.default_rng(5).random((300, 3))
    # the JAX package's host entry runs this same search (natively where built)
    want = jgauss.from_point_cloud(pts, cols, max_sh_degree=2)
    got = tgauss.from_point_cloud(pts, cols, max_sh_degree=2, device="cpu")
    assert got.capacity == want.capacity == 4096 and got.max_sh_degree == 2
    np.testing.assert_array_equal(_np(got.alive), np.asarray(want.alive))
    for k in tgauss.GaussianScene.PARAM_FIELDS:
        np.testing.assert_allclose(_np(getattr(got, k)), np.asarray(getattr(want, k)), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert float(got.log_scales[:300].max()) < 2.0 and float(got.log_scales[:300].min()) >= np.log(np.sqrt(1e-7)) - 1e-4
    # compact: holes punched, then packed, in both packages
    alive = np.asarray(want.alive).copy()
    alive[5:200:3] = False
    jc = jgauss.compact(dataclasses.replace(want, alive=jnp.asarray(alive)), 512)
    tc = tgauss.compact(dataclasses.replace(got, alive=torch.from_numpy(alive)), 512)
    tc_grown = tgauss.compact(dataclasses.replace(got, alive=torch.from_numpy(alive)), 8192)
    np.testing.assert_array_equal(_np(tc.alive), np.asarray(jc.alive))
    assert tc.capacity == 512 and tc_grown.capacity == 8192
    n_alive = int(alive.sum())
    for k in tgauss.GaussianScene.PARAM_FIELDS:
        np.testing.assert_allclose(_np(getattr(tc, k))[:n_alive], np.asarray(getattr(jc, k))[:n_alive],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(_np(getattr(tc_grown, k))[:n_alive], _np(getattr(tc, k))[:n_alive])


# ---- the chunk transpose and the probe's recurrences -----------------------------

@pytest.mark.parametrize("shape", [(4, 16, 128), (3, 9, 128), (1, 40, 128)])
def test_unchunk_transpose_plain_matches_jax(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(jpk.unchunk_transpose(jnp.asarray(x), interpret=True))
    cuda_build.reset_launch_counts()
    got = tblend.unchunk_transpose(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(tblend.plain_unchunk_transpose(torch.from_numpy(x))), want)
    assert got.shape == (shape[0] * 128, shape[1]) and cuda_build.launch_counts()["unchunk_transpose"] == 0
    with pytest.raises(ValueError, match="float32"):
        tblend.unchunk_transpose(torch.from_numpy(x).double())
    with pytest.raises(ValueError, match="float32"):
        tblend.unchunk_transpose(torch.zeros(2, 16, 64))
    with pytest.raises(ValueError, match="contiguous"):
        tblend.unchunk_transpose(torch.zeros(2, 128, shape[1]).permute(0, 2, 1))


def _numpy_chain(x, kind, passes):
    """The probe's recurrences as numpy loops over the kernel's layout."""
    f32 = np.float32
    a, b = f32(issue_probe.A), f32(issue_probe.B)
    x = x.copy()
    for _ in range(passes):
        if kind == "mul":
            x = x * a
        elif kind == "mul_add":
            x = (x * a).astype(f32) + b
        elif kind == "fma":
            x = (x.astype(np.float64) * np.float64(a) + np.float64(b)).astype(f32)
        elif kind == "ex2":
            x = np.exp2(-x).astype(f32)
        elif kind == "rcp":
            x = (f32(1.0) / (x + f32(1.0))).astype(f32)
        elif kind == "shfl_sum":
            lanes = x.reshape(-1, 32)
            x = (f32(0.5) * lanes + lanes.sum(axis=1, keepdims=True, dtype=f32) * f32(1.0 / 64.0)).reshape(-1)
        elif kind == "scan128":
            y = np.cumprod(x.reshape(-1, 128), axis=1, dtype=f32)
            x = (f32(1.0) + (y - f32(1.0)) * f32(1.0 / 128.0)).reshape(-1)
    return x


@pytest.mark.parametrize("kind", issue_probe.KINDS)
def test_probe_plain_recurrence_matches_numpy(kind):
    x = issue_probe.start_values(kind, 2 * issue_probe.GRANULE, device="cpu")
    cuda_build.reset_launch_counts()
    got = _np(issue_probe.run_chain(x, kind, 24))
    want = _numpy_chain(_np(x), kind, 24)
    # the exact kinds bit for bit; sums and products in another order within 1e-6
    tol = 0 if kind in ("mul", "mul_add", "fma", "rcp") else 1e-6
    np.testing.assert_allclose(got, want, rtol=tol, atol=0)
    assert np.isfinite(got).all() and got.min() > 0 and got.max() < 2 and not np.array_equal(got, _np(x))
    assert cuda_build.launch_counts()["issue_probe"] == 0
    np.testing.assert_array_equal(_np(issue_probe.run_chain(x, kind, 0)), _np(x))


def test_probe_checks_its_inputs():
    x = issue_probe.start_values("mul", issue_probe.GRANULE, device="cpu")
    with pytest.raises(ValueError, match="unknown probe kind"):
        issue_probe.run_chain(x, "nope", 1)
    with pytest.raises(ValueError, match="multiple"):
        issue_probe.run_chain(x[:100], "mul", 1)
    with pytest.raises(ValueError, match="negative"):
        issue_probe.run_chain(x, "mul", -1)
    with pytest.raises(ValueError, match="CUDA card"):
        issue_probe.measure(device="cpu")
    assert set(issue_probe.ISSUED) == set(issue_probe.KINDS)
