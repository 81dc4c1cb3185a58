"""PyTorch port vs the JAX package: SH, covariance, EWA, cameras, scenes.

The same numpy inputs go through the JAX function and its port counterpart
on the CPU. Tolerances are float32 ones: 1e-6 absolute where values are
O(1) and the two packages evaluate the same expression in the same order
(any difference is a reordered sum of three terms); bit equality where the
computation is numpy in both (camera matrices, synthetic draws).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgaussian_tpu.models import camera as jcam
from lightgaussian_tpu.models import gaussians as jg
from lightgaussian_tpu.ops import covariance as jcov
from lightgaussian_tpu.ops import sh as jsh
from lightgaussian_tpu.utils import synthetic as jsyn
from lightgaussian_tpu_torch import convert
from lightgaussian_tpu_torch.models import camera as tcam
from lightgaussian_tpu_torch.models import gaussians as tg
from lightgaussian_tpu_torch.ops import covariance as tcov
from lightgaussian_tpu_torch.ops import sh as tsh
from lightgaussian_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _unit_dirs(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(degree):
    rng = np.random.default_rng(degree)
    sh = rng.normal(size=(64, 25, 3)).astype(np.float32)
    dirs = _unit_dirs(rng, 64)
    want = np.asarray(jsh.eval_sh(degree, jnp.asarray(sh), jnp.asarray(dirs)))
    got = _np(tsh.eval_sh(degree, _t(sh), _t(dirs)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    want_rgb = np.asarray(jsh.sh_to_rgb(degree, jnp.asarray(sh), jnp.asarray(dirs)))
    np.testing.assert_allclose(_np(tsh.sh_to_rgb(degree, _t(sh), _t(dirs))), want_rgb, atol=1e-6, rtol=0)
    assert (want_rgb >= 0).all() and (want_rgb == 0).any()  # the clamp is exercised


def test_sh_helpers_match_jax():
    rgb = np.random.default_rng(0).uniform(size=(32, 3)).astype(np.float32)
    np.testing.assert_array_equal(_np(tsh.rgb_to_sh(_t(rgb))), np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb))))
    assert [tsh.num_sh_coeffs(d) for d in range(5)] == [jsh.num_sh_coeffs(d) for d in range(5)]
    with pytest.raises(ValueError):
        tsh.eval_sh(5, _t(np.zeros((1, 36, 3), np.float32)), _t(np.zeros((1, 3), np.float32)))


def test_every_8_bit_colour_starts_with_a_gradient():
    """A point cloud's colours (k/255) go through `rgb_to_sh` into the DC
    band: bit for bit JAX's float32 division, and a black point renders
    exactly 0, where the colour clamp still passes its gradient (one ulp
    lower, as a reciprocal multiply gave on the card, a black start never
    trains; chip_smoke.py phase 9 holds the card's levels to these)."""
    levels = np.repeat((np.arange(256, dtype=np.float32) / 255.0)[:, None], 3, axis=1)
    dc = tsh.rgb_to_sh(_t(levels))
    np.testing.assert_array_equal(_np(dc), np.asarray(jsh.rgb_to_sh(jnp.asarray(levels))))
    sh = dc.clone().requires_grad_(True)
    rgb = tsh.sh_to_rgb(0, sh[:, None, :], _t(np.tile([[0.0, 0.0, 1.0]], (256, 1)).astype(np.float32)))
    assert float(rgb[0].abs().max()) == 0.0
    rgb.sum().backward()
    assert bool((sh.grad == np.float32(tsh.C0)).all())


def test_sh_dc_to_rgb_matches_jax():
    """The DC band back to RGB (the reference's `SH2RGB`) over the DC values
    of the 256 8-bit levels and random ones, against JAX's within 1e-7."""
    levels = np.repeat((np.arange(256, dtype=np.float32) / 255.0)[:, None], 3, axis=1)
    rng = np.random.default_rng(2)
    for dc in (np.asarray(jsh.rgb_to_sh(jnp.asarray(levels))), rng.normal(0.0, 0.5, (64, 3)).astype(np.float32)):
        want = np.asarray(jsh.sh_dc_to_rgb(jnp.asarray(dc)))
        np.testing.assert_allclose(_np(tsh.sh_dc_to_rgb(_t(dc))), want, atol=1e-7, rtol=0)


def test_sh_dc_round_trip_as_jax_holds_it():
    """JAX's round trip `sh_dc_to_rgb(rgb_to_sh(rgb))` (`tests/test_math_core.py`) over the 256 levels."""
    levels = np.repeat((np.arange(256, dtype=np.float32) / 255.0)[:, None], 3, axis=1)
    np.testing.assert_allclose(_np(tsh.sh_dc_to_rgb(tsh.rgb_to_sh(_t(levels)))), levels, rtol=1e-5, atol=1e-6)


def test_covariance_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(128, 4)).astype(np.float32)
    s = rng.uniform(0.01, 0.3, size=(128, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tcov.quat_to_rotmat(_t(q))), np.asarray(jcov.quat_to_rotmat(jnp.asarray(q))), atol=1e-6, rtol=0
    )
    for mod in (1.0, 0.7):
        want = np.asarray(jcov.build_covariance_3d(jnp.asarray(s), jnp.asarray(q), mod))
        got = _np(tcov.build_covariance_3d(_t(s), _t(q), mod))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    c6 = np.asarray(jcov.strip_symmetric(jnp.asarray(want)))
    np.testing.assert_array_equal(_np(tcov.strip_symmetric(_t(want))), c6)
    np.testing.assert_array_equal(_np(tcov.unstrip_symmetric(_t(c6))), np.asarray(jcov.unstrip_symmetric(jnp.asarray(c6))))


def test_ewa_project_matches_jax():
    rng = np.random.default_rng(2)
    means = np.concatenate(
        [rng.uniform(-3, 3, (256, 2)), rng.uniform(0.3, 8, (256, 1))], axis=1
    ).astype(np.float32)
    s = rng.uniform(0.01, 0.3, size=(256, 3)).astype(np.float32)
    q = rng.normal(size=(256, 4)).astype(np.float32)
    cov = np.asarray(jcov.build_covariance_3d(jnp.asarray(s), jnp.asarray(q)))
    fx, fy = np.float32(120.5), np.float32(80.25)
    tx, ty = np.float32(0.57), np.float32(0.38)
    want = np.asarray(jcov.ewa_project(jnp.asarray(means), jnp.asarray(cov), jnp.float32(fx),
                                       jnp.float32(fy), jnp.float32(tx), jnp.float32(ty)))
    got = _np(tcov.ewa_project(_t(means), _t(cov), _t(fx), _t(fy), _t(tx), _t(ty)))
    # screen covariances reach ~1e3 px^2: compare at float32 relative precision
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


def test_camera_matrices_bit_identical():
    rng = np.random.default_rng(3)
    for _ in range(4):
        q = rng.normal(size=4)
        R = np.asarray(jcov.quat_to_rotmat(jnp.asarray(q[None], jnp.float32)))[0].astype(np.float64)
        t = rng.normal(size=3)
        np.testing.assert_array_equal(tcam.world_to_view(R, t), jcam.world_to_view(R, t))
        np.testing.assert_array_equal(
            tcam.world_to_view(R, t, translate=[0.1, 0.2, 0.3], scale=1.5),
            jcam.world_to_view(R, t, translate=[0.1, 0.2, 0.3], scale=1.5),
        )
    np.testing.assert_array_equal(
        tcam.projection_matrix(0.01, 100.0, 0.9, 0.6), jcam.projection_matrix(0.01, 100.0, 0.9, 0.6)
    )
    assert tcam.fov2focal(0.9, 800) == jcam.fov2focal(0.9, 800)
    assert tcam.focal2fov(700.0, 800) == jcam.focal2fov(700.0, 800)


@pytest.mark.parametrize("kw", [
    dict(eye=[0.3, -0.2, -4.0], target=[0, 0, 0], width=96, height=64),
    dict(eye=[5.0 * math.sin(0.2), 0.6, -5.0 * math.cos(0.2)], target=[0, 0, 0],
         width=1920, height=1080, fovx=0.9),
])
def test_look_at_camera_bit_identical(kw):
    j = jcam.Camera.look_at(**kw)
    t = tcam.Camera.look_at(device="cpu", **kw)
    for f in ("world_view", "full_proj", "camera_center", "tan_fovx", "tan_fovy"):
        np.testing.assert_array_equal(_np(getattr(t, f)), np.asarray(getattr(j, f)), err_msg=f)
        assert getattr(t, f).dtype == torch.float32
    assert (t.width, t.height) == (j.width, j.height)
    np.testing.assert_array_equal(_np(t.focal_x), np.asarray(j.focal_x))
    np.testing.assert_array_equal(_np(t.focal_y), np.asarray(j.focal_y))


@pytest.mark.parametrize("kw", [
    dict(n=256, seed=1),
    dict(n=100, seed=7, max_sh_degree=2, active_sh_degree=1, capacity=160, extent=0.8),
    dict(n=64, seed=3, max_sh_degree=0, scale_range=(0.004, 0.02)),
])
def test_random_scene_bit_identical(kw):
    j = jsyn.random_scene(**kw)
    t = tsyn.random_scene(device="cpu", **kw)
    for f in tg.GaussianScene.PARAM_FIELDS + ("alive",):
        np.testing.assert_array_equal(_np(getattr(t, f)), np.asarray(getattr(j, f)), err_msg=f)
    assert (t.active_sh_degree, t.max_sh_degree) == (j.active_sh_degree, j.max_sh_degree)
    np.testing.assert_array_equal(_np(t.sh_coeffs), np.asarray(j.sh_coeffs))
    np.testing.assert_allclose(_np(t.scales), np.asarray(j.scales), rtol=1e-6)
    np.testing.assert_allclose(_np(t.opacities), np.asarray(j.opacities), atol=1e-7, rtol=0)
    assert t.num_alive() == int(j.num_alive())


def test_default_camera_and_empty_scene_match_jax():
    j, t = jsyn.default_camera(128, 96, dist=5.0), tsyn.default_camera(128, 96, dist=5.0, device="cpu")
    np.testing.assert_array_equal(_np(t.full_proj), np.asarray(j.full_proj))
    je, te = jg.empty_scene(10, 2, 1), tg.empty_scene(10, 2, 1, device="cpu")
    for f in tg.GaussianScene.PARAM_FIELDS + ("alive",):
        np.testing.assert_array_equal(_np(getattr(te, f)), np.asarray(getattr(je, f)), err_msg=f)
    for n in (1, 4096, 4097, 300_000):
        assert tg.round_capacity(n) == jg.round_capacity(n)


def test_convert_carries_jax_objects():
    js = jsyn.random_scene(n=50, seed=4, capacity=64)
    ts = convert.scene_from_numpy(
        {k: np.asarray(getattr(js, k)) for k in tg.GaussianScene.PARAM_FIELDS},
        np.asarray(js.alive), js.active_sh_degree, js.max_sh_degree, device="cpu",
    )
    for f in tg.GaussianScene.PARAM_FIELDS + ("alive",):
        np.testing.assert_array_equal(_np(getattr(ts, f)), np.asarray(getattr(js, f)))
    jc = jsyn.default_camera()
    tc = convert.camera_from_numpy(
        np.asarray(jc.world_view), np.asarray(jc.full_proj), np.asarray(jc.camera_center),
        np.asarray(jc.tan_fovx), np.asarray(jc.tan_fovy), jc.width, jc.height, device="cpu",
    )
    np.testing.assert_array_equal(_np(tc.focal_x), np.asarray(jc.focal_x))
    with pytest.raises(ValueError, match="missing"):
        convert.scene_from_numpy({}, np.zeros(1, bool), 0, 0, device="cpu")
