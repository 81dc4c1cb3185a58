"""PyTorch port vs the JAX package: poses, cached binning and trajectories.

The cases of tests/test_temporal_binning.py and the pose generators of
tests/test_render_eval.py, port against JAX on the same inputs: scenes from
both packages' same-seed `random_scene` (bit-identical), cameras from both
packages' `look_at` with the same arguments. The JAX side runs its Pallas
kernels in interpret mode; the port runs the plain versions of its kernels.

Tolerances (float32):
- cameras from the pose generators: `world_view` and `full_proj` within
  1e-6 (the numpy work is the same lines; the matrices are float32 casts of
  the same float64 values);
- the rebin plan: the same flags;
- a cached render on the camera it was binned for: bit-equal to the port's
  fresh render (the same order and the same features);
- cached renders of nearby and of swung cameras against JAX's cached
  renders: 2e-5, the blends' own tolerance (tests/test_torch_rasterize.py);
- trajectory PNGs: within one 8-bit level of JAX's.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lightgaussian_tpu.models.camera import Camera as JCamera
from lightgaussian_tpu.ops.rasterize import build_binning as jbuild_binning
from lightgaussian_tpu.ops.rasterize import render as jrender
from lightgaussian_tpu.render import poses as jposes
from lightgaussian_tpu.render import sets as jsets
from lightgaussian_tpu.utils import synthetic as jsyn
from lightgaussian_tpu_torch.models.camera import Camera as TCamera
from lightgaussian_tpu_torch.ops.rasterize import binning as tbinning
from lightgaussian_tpu_torch.ops.rasterize import build_binning as tbuild_binning
from lightgaussian_tpu_torch.ops.rasterize import render as trender
from lightgaussian_tpu_torch.ops.rasterize.projection import preprocess as tpreprocess
from lightgaussian_tpu_torch.render import poses as tposes
from lightgaussian_tpu_torch.render import sets as tsets
from lightgaussian_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

W, H = 96, 64
MAXI = 1 << 16
BG = np.array([0.1, 0.1, 0.1], np.float32)
JBG, TBG = jnp.asarray(BG), torch.from_numpy(BG)
SCENE = dict(n=400, seed=3, extent=0.8, scale_range=(0.02, 0.08))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _orbit(t, dist=2.6):
    """The orbit camera of tests/test_temporal_binning.py in both packages."""
    kw = dict(fovx=0.9, width=W, height=H)
    eye = (dist * math.cos(t), 0.4, dist * math.sin(t))
    return JCamera.look_at(eye, (0, 0, 0), **kw), TCamera.look_at(eye, (0, 0, 0), device="cpu", **kw)


def _ring(n=8, dist=2.5):
    """The camera ring of tests/test_render_eval.py in both packages."""
    kw = dict(fovx=0.9, width=64, height=48)
    ts = np.linspace(0, 2 * np.pi, n, endpoint=False)
    eyes = [(dist * math.cos(t), 0.4, dist * math.sin(t)) for t in ts]
    return ([JCamera.look_at(e, (0, 0, 0), **kw) for e in eyes],
            [TCamera.look_at(e, (0, 0, 0), device="cpu", **kw) for e in eyes])


def _scenes(**kw):
    return jsyn.random_scene(**kw), tsyn.random_scene(device="cpu", **kw)


def _same_cameras(jcams, tcams):
    assert len(jcams) == len(tcams) > 0
    for jc, tc in zip(jcams, tcams):
        assert (tc.width, tc.height) == (jc.width, jc.height)
        for f in ("world_view", "full_proj", "camera_center", "tan_fovx", "tan_fovy"):
            np.testing.assert_allclose(_np(getattr(tc, f)), np.asarray(getattr(jc, f)), atol=1e-6, rtol=0, err_msg=f)


# ---- poses ---------------------------------------------------------------------------

GENERATORS = {
    "ellipse": lambda m, cams: m.generate_ellipse_path(cams, n_frames=40),
    "ellipse_z": lambda m, cams: m.generate_ellipse_path(cams, n_frames=12, z_variation=0.3, z_phase=0.2),
    "spiral": lambda m, cams: m.generate_spiral_path(cams, bounds=np.array([1.0, 10.0]), n_frames=6),
    "spiral_focal": lambda m, cams: m.generate_spiral_path_focal(cams, n_frames=12),
    "spherical": lambda m, cams: m.generate_spherical_sample_path(cams, n=6),
    "spherify": lambda m, cams: m.generate_spherify_path(cams, n_frames=8),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_pose_generators_match_jax(name):
    jcams, tcams = _ring(10 if name == "spherify" else 8)
    want = GENERATORS[name](jposes, jcams)
    got = GENERATORS[name](tposes, tcams)
    assert len(got) == len(want)
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=1e-12, rtol=0)
    _same_cameras([jposes.camera_from_w2c(p, jcams[0]) for p in want],
                  [tposes.camera_from_w2c(p, tcams[0]) for p in got])


def test_spiral_focal_keeps_the_fovx_quirk():
    """"focal" is the first camera's FoVx in radians, as in the reference."""
    jcams, tcams = _ring(8)
    wide = [TCamera.look_at((2.5, 0.4, 0.0), (0, 0, 0), fovx=1.4, width=64, height=48, device="cpu")] + tcams[1:]
    assert not np.allclose(tposes.generate_spiral_path_focal(wide, n_frames=4),
                           tposes.generate_spiral_path_focal(tcams, n_frames=4))


def test_camera_helpers_match_jax():
    jcams, tcams = _ring(3)
    for jc, tc in zip(jcams, tcams):
        for a, b in zip(tposes.camera_Rt(tc), jposes.camera_Rt(jc)):
            np.testing.assert_array_equal(a, b)
        for blender in (False, True):
            np.testing.assert_array_equal(tposes.c2w_from_camera(tc, blender), jposes.c2w_from_camera(jc, blender))


def test_gaussian_and_circular_poses_match_jax():
    jcams, tcams = _ring(3)
    gt = np.random.default_rng(2).random((3, 48, 64)).astype(np.float32)
    jrng, trng = np.random.default_rng(7), np.random.default_rng(7)
    jout, tout = [], []
    for i in range(6):
        jc, tc = jcams[i % 3].with_gt(jnp.asarray(gt)), tcams[i % 3].with_gt(torch.from_numpy(gt))
        kw = dict(std_translation=0.05, std_rotation=0.0) if i % 2 else {}
        jout.append(jposes.gaussian_pose(jc, jrng, **kw))
        tout.append(tposes.gaussian_pose(tc, trng, **kw))
    _same_cameras(jout, tout)
    assert all(torch.equal(c.gt_image, torch.from_numpy(gt)) for c in tout)
    assert np.abs(_np(tout[0].world_view) - _np(tcams[0].world_view)).max() > 1e-6
    _same_cameras([jposes.circular_pose(jcams[1], 0.5, a) for a in (0.0, 0.3, 2.0)],
                  [tposes.circular_pose(tcams[1], 0.5, a) for a in (0.0, 0.3, 2.0)])


# ---- the rebin plan ------------------------------------------------------------------

@pytest.mark.parametrize("step", ["coarse", "fine"])
def test_rebin_plan_matches_jax(step):
    jscene, tscene = _scenes(n=300, seed=4, extent=0.8, scale_range=(0.03, 0.09))
    if step == "coarse":
        ts = np.linspace(0, 2 * math.pi, 8, endpoint=False)
    else:
        ts = 0.3 + np.arange(24) * 2 * math.pi / 40000
    jcams, tcams = zip(*(_orbit(t) for t in ts))
    want = jsets.plan_rebin_schedule(jscene, list(jcams), rebin_every=6, drift_px=1.5)
    got = tsets.plan_rebin_schedule(tscene, list(tcams), rebin_every=6, drift_px=1.5)
    assert got == want
    assert got == [True] * len(ts) if step == "coarse" else 1 < sum(got) < len(ts)
    np.testing.assert_array_equal(tsets._sample_means(tscene, 64), jsets._sample_means(jscene, 64))


# ---- cached binning --------------------------------------------------------------------

@pytest.mark.parametrize("fast", [False, True])
def test_same_camera_cached_equals_fresh(fast):
    _, tscene = _scenes(**SCENE)
    _, tc = _orbit(0.3)
    fresh = trender(tscene, tc, TBG, max_instances=MAXI, fast=fast)
    b = tbuild_binning(tscene, tc, max_instances=MAXI)
    cached = trender(tscene, tc, TBG, cached_binning=b, fast=fast)
    assert torch.equal(cached.render, fresh.render) and torch.equal(cached.final_T, fresh.final_T)
    assert cached.num_instances == fresh.num_instances == b.total > 0


@pytest.fixture(scope="module")
def nearby():
    """Eight frames of a 600-frame orbit over one keyframe's binning, in
    both packages: (JAX cached, port cached, port fresh) images."""
    jscene, tscene = _scenes(**SCENE)
    step = 2 * math.pi / 600
    jc0, tc0 = _orbit(0.3)
    jb = jbuild_binning(jscene, jc0, max_instances=MAXI)
    tb = tbuild_binning(tscene, tc0, max_instances=MAXI)
    out = []
    for k in (1, 4, 7):
        jc, tc = _orbit(0.3 + k * step)
        out.append((jrender(jscene, jc, JBG, cached_binning=jb, interpret=True),
                    trender(tscene, tc, TBG, cached_binning=tb),
                    trender(tscene, tc, TBG, max_instances=MAXI)))
    return out, int(jb.total), tb.total


def test_nearby_frames_match_jax_cached(nearby):
    frames, jtotal, ttotal = nearby
    assert ttotal == jtotal
    for jout, tout, _ in frames:
        np.testing.assert_allclose(_np(tout.render), np.asarray(jout.render), atol=2e-5, rtol=0)
        np.testing.assert_allclose(_np(tout.final_T), np.asarray(jout.final_T), atol=2e-5, rtol=0)
        assert tout.num_instances == int(jout.num_instances) == ttotal


def test_nearby_frames_high_fidelity(nearby):
    from lightgaussian_tpu_torch.ops import losses

    frames, _, _ = nearby
    worst = min(float(losses.psnr(t.render.clamp(0, 1), f.render.clamp(0, 1))) for _, t, f in frames)
    assert worst > 45.0, f"cached-binning drift too visible: {worst:.1f} dB"


def test_newly_culled_gaussians_inert():
    """A move large enough that Gaussians of the keyframe's order fall behind
    the near plane (the swing of tests/test_temporal_binning.py, and a step
    into the scene): their rows come in zeroed and render nothing, as in
    JAX."""
    jscene, tscene = _scenes(n=300, seed=5, extent=1.2, scale_range=(0.03, 0.09))
    jc0, tc0 = _orbit(0.0)
    jc1, tc1 = _orbit(0.35, dist=1.3)
    tb = tbuild_binning(tscene, tc0, max_instances=MAXI)
    splats = tpreprocess(tscene, tc1)
    gone = set(_np(tb.gid_sorted).tolist()) & set(np.flatnonzero(_np(splats.radius) == 0).tolist())
    assert gone, "the swing culls none of the keyframe's Gaussians"
    rebound = tbinning.rebind_features(splats, tb)
    zeroed = np.isin(_np(tb.gid_sorted), sorted(gone))
    assert (_np(rebound.inst)[zeroed] == 0).all() and (_np(rebound.inst)[~zeroed] != 0).any()
    out = trender(tscene, tc1, TBG, cached_binning=tb).render
    want = jrender(jscene, jc1, JBG, cached_binning=jbuild_binning(jscene, jc0, max_instances=MAXI),
                   interpret=True).render
    assert torch.isfinite(out).all() and float(out.std()) > 0.02
    np.testing.assert_allclose(_np(out), np.asarray(want), atol=2e-5, rtol=0)
    # the zeroed rows blend nothing: the same order without them gives the same
    # image, to the rounding of T's products, which the 128-instance batches group
    # otherwise once rows go (6e-8 seen)
    from lightgaussian_tpu_torch.ops.rasterize import blend

    grid = tbinning.make_grid(W, H)
    keep = torch.from_numpy(~zeroed)
    starts = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(
        torch.stack([keep[a:b].sum() for a, b in zip(rebound.tile_starts[:-1], rebound.tile_starts[1:])]), 0)])
    with_rows = blend.plain_blend(rebound.tile_starts, rebound.inst, grid, exact=True)
    without = blend.plain_blend(starts.to(torch.int32), rebound.inst[keep].contiguous(), grid, exact=True)
    for a, b in zip(with_rows[:2], without[:2]):
        assert float((a - b).abs().max()) <= 1e-6


def test_scene_size_mismatch_raises():
    _, tscene = _scenes(n=400, seed=3)
    _, other = _scenes(n=272, seed=3)
    _, tc = _orbit(0.1)
    b = tbuild_binning(tscene, tc, max_instances=MAXI)
    for scene in (other, tsyn.random_scene(n=400, seed=3, capacity=528, device="cpu")):
        with pytest.raises(ValueError, match="built for 400 Gaussians"):
            trender(scene, tc, TBG, cached_binning=b)


def test_cached_render_refuses_gradients_and_a_second_capacity():
    _, tscene = _scenes(n=256, seed=1)
    _, tc = _orbit(0.1)
    b = tbuild_binning(tscene, tc, max_instances=MAXI)
    with pytest.raises(ValueError, match="either max_instances or cached_binning"):
        trender(tscene, tc, TBG, max_instances=MAXI, cached_binning=b)
    means = tscene.means.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="cached blend has no backward"):
        trender(tscene.with_params({**tscene.params(), "means": means}), tc, TBG, cached_binning=b)


# ---- trajectories ------------------------------------------------------------------------

def _pngs(d):
    return [np.asarray(Image.open(p), np.float32) for p in sorted(d.glob("*.png"))]


@pytest.mark.parametrize("kind, n_frames, radius, rebin_every", [
    ("circular", 6, 0.4, 8),  # coarse: every frame fresh
    ("circular", 6, 0.0004, 8),  # fine: frames reuse their keyframe's binning
    ("spiral", 4, 0.0, 8),
])
def test_render_trajectory_matches_jax(tmp_path, kind, n_frames, radius, rebin_every):
    jscene, tscene = _scenes(n=300, seed=4, extent=0.8, scale_range=(0.03, 0.09))
    jcams, tcams = zip(*(_orbit(t) for t in np.linspace(0, 2 * math.pi, 8, endpoint=False)))
    kw = dict(n_frames=n_frames, radius=radius, rebin_every=rebin_every)
    want = jsets.render_trajectory(tmp_path / "jax", kind, 1, list(jcams), jscene, JBG, MAXI, interpret=True, **kw)
    got = tsets.render_trajectory(tmp_path / "port", kind, 1, list(tcams), tscene, TBG, MAXI, **kw)
    assert got.relative_to(tmp_path / "port") == want.relative_to(tmp_path / "jax")
    jp, tp = _pngs(want), _pngs(got)
    assert len(tp) == len(jp) == n_frames
    for i, (a, b) in enumerate(zip(tp, jp)):
        assert np.abs(a - b).max() <= 1.0, f"frame {i}"
    if radius == 0.0004:
        frames = tsets.trajectory_frames(kind, list(tcams), n_frames, radius)
        assert not all(tsets.plan_rebin_schedule(tscene, frames, rebin_every, 1.5))


def test_trajectory_grows_the_cut_on_denser_views(tmp_path, capsys):
    """A cut under the dense frames' live counts rises to `snug_capacity` of
    the count and the frame renders again: no frame is cut."""
    _, tscene = _scenes(n=400, seed=5, extent=0.8, scale_range=(0.03, 0.09))
    jref, ref = _orbit(2.1, dist=3.5)
    n_frames, radius = 6, 1.9
    frames = tsets.trajectory_frames("circular", [ref], n_frames, radius)
    totals = [trender(tscene, c, TBG, max_instances=MAXI).num_instances for c in frames]
    cut = tbinning.instance_capacity(min(totals) + 1)
    assert max(totals) > cut, totals
    for rebin_every in (1, 8):
        out = tsets.render_trajectory(tmp_path / str(rebin_every), "circular", 1, [ref], tscene, TBG, cut,
                                      n_frames=n_frames, radius=radius, rebin_every=rebin_every)
        assert "live instances reach the cut" in capsys.readouterr().out
        for i, (png, cam) in enumerate(zip(_pngs(out), frames)):
            want = trender(tscene, cam, TBG, max_instances=MAXI, fast=True).render.clamp(0, 1)
            want = _np(want).transpose(1, 2, 0) * 255.0
            assert np.abs(png - want).max() <= 1.0 + 1e-3, f"frame {i} (total {totals[i]}) cut or stale"
