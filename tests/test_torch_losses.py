"""PyTorch port vs the JAX package: losses, the SSIM blur and its moments,
and the learning-rate schedules.

The same numpy-seeded images go through both packages on the CPU. There the
port's blur wrappers run their plain versions (the JAX package's
`_blur_jnp`, in torch, with the same order of operations); the CUDA kernels
are held against those on the card by `chip_smoke.py`. The JAX Pallas blur
kernels run in interpret mode, as the JAX package's own tests run them.

Tolerances (float32), those of the JAX suite (tests/test_math_core.py):
blur and moment planes 1e-6 (the same sums; XLA may still fuse them
differently), SSIM values 1e-6, SSIM gradients 1e-5 after dividing by the
JAX gradient's largest magnitude (the port's backward blurs cotangents, the
JAX CPU path differentiates the shifted sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgaussian_tpu.ops import losses as jl
from lightgaussian_tpu.utils import general as jgen
from lightgaussian_tpu_torch.ops import losses as tl
from lightgaussian_tpu_torch.utils import cuda_build
from lightgaussian_tpu_torch.utils import general as tgen

torch.set_num_threads(1)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=shape).astype(np.float32), rng.uniform(size=shape).astype(np.float32)


def _close_normalised(got, want, atol, what=""):
    want = np.asarray(want)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale, atol=atol, rtol=0, err_msg=what)
    assert np.abs(want).max() > 0


def test_gaussian_taps_match_jax():
    assert (tl.WINDOW, tl.SIGMA) == (11, 1.5)
    assert tl.TAPS == jl._gaussian_taps(11, 1.5)
    assert abs(sum(tl.TAPS) - 1.0) < 1e-6


# The shapes of chip_smoke.py's BLUR_SHAPES below full size, where the card's
# blur is held bit for bit to this plain version: the edges of its 128-column
# strips and 16-row runs (heights 1, 7, 15, 17; widths 1, 7, 127, 129, 260).
BLUR_EDGE_SHAPES = [(2, 1, 64), (3, 7, 40), (4, 15, 129), (4, 17, 127), (3, 40, 1), (3, 40, 7), (2, 33, 260)]


@pytest.mark.parametrize("shape", [(15, 37, 53), (3, 64, 96), (1, 8, 8)] + BLUR_EDGE_SHAPES)
def test_plain_blur_matches_jax(shape):
    x, _ = _pair(shape, 0)
    got = _np(tl.blur(torch.from_numpy(x)))
    np.testing.assert_allclose(got, np.asarray(jl._blur_jnp(jnp.asarray(x), 11, 1.5)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(jl._blur_pallas_raw(jnp.asarray(x), 11, 1.5, interpret=True)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(3, 41, 67), (1, 8, 8)] + BLUR_EDGE_SHAPES)
def test_moment_planes_match_jax_kernels(shape):
    x, y = _pair(shape, 1)
    tx, ty, jx, jy = torch.from_numpy(x), torch.from_numpy(y), jnp.asarray(x), jnp.asarray(y)
    np.testing.assert_allclose(_np(tl.blur3(tx, ty)), np.asarray(jl._blur3_pallas_raw(jx, jy, 11, 1.5, True)),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(tl.blur5(tx, ty)), np.asarray(jl._blur5_pallas_raw(jx, jy, 11, 1.5, True)),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(3, 41, 67), (1, 8, 8)] + BLUR_EDGE_SHAPES)
def test_moment_planes_are_the_blur_of_the_formed_planes(shape):
    """The kernels form x^2, y^2 and x y in registers and blur them as B4
    blurs a plane; on the card they are held to these planes bit for bit."""
    x, y = _pair(shape, 9)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for got, formed in ((tl.blur3(tx, ty), [tx, tx * tx, tx * ty]),
                        (tl.blur5(tx, ty), [tx, ty, tx * tx, ty * ty, tx * ty])):
        want = np.empty((shape[0] * len(formed), *shape[1:]), np.float32)
        for k, plane in enumerate(formed):
            want[k::len(formed)] = _np(tl.plain_blur(plane))  # plane k of channel c at c * P + k
        np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("cached", [False, True])
def test_ssim_value_matches_jax(cached):
    x, y = _pair((3, 41, 67), 2)
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.from_numpy(x), torch.from_numpy(y)
    j_stats = jl.precompute_ssim_target_stats(jy) if cached else None
    t_stats = tl.precompute_ssim_target_stats(ty) if cached else None
    want = float(jl.ssim(jx, jy, target_stats=j_stats))
    assert float(tl.ssim(tx, ty, target_stats=t_stats)) == pytest.approx(want, abs=1e-6)
    assert want == pytest.approx(float(jl.ssim(jx, jy)), abs=1e-6)


def test_target_stats_match_jax():
    _, y = _pair((3, 33, 48), 3)
    for got, want in zip(tl.precompute_ssim_target_stats(torch.from_numpy(y)),
                         jl.precompute_ssim_target_stats(jnp.asarray(y))):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("cached", [False, True])
def test_ssim_gradients_match_jax(cached):
    x, y = _pair((3, 33, 48), 4)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(y).requires_grad_(True)
    if cached:
        j_stats = jl.precompute_ssim_target_stats(jy)
        want = [jax.grad(lambda a: jl.ssim(a, jy, target_stats=j_stats))(jx)]
        got = torch.autograd.grad(tl.ssim(tx, ty, target_stats=tl.precompute_ssim_target_stats(ty.detach())), [tx])
    else:
        want = jax.grad(lambda a, b: jl.ssim(a, b), argnums=(0, 1))(jx, jy)
        got = torch.autograd.grad(tl.ssim(tx, ty), [tx, ty])
    for g, w in zip(got, want):
        _close_normalised(_np(g), w, 1e-5)


def test_cached_path_gives_the_target_no_gradient():
    x, y = _pair((3, 24, 32), 5)
    tx, ty = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(y).requires_grad_(True)
    # the x-side moments' own backward returns a zero dy by design
    m = tl._Moments3.apply(tx, ty)
    gx, gy = torch.autograd.grad((m * torch.from_numpy(np.arange(m.numel(), dtype=np.float32)
                                                       .reshape(m.shape) / m.numel())).sum(), [tx, ty])
    assert gx.abs().max() > 0
    np.testing.assert_array_equal(_np(gy), 0.0)
    # and ssim() detaches the target on that path, as the JAX package stops its gradient
    stats = tl.precompute_ssim_target_stats(ty.detach())
    (gy2,) = torch.autograd.grad(tl.ssim(tx, ty, target_stats=stats), [ty], allow_unused=True)
    assert gy2 is None
    jgy = jax.grad(lambda b: jl.ssim(jnp.asarray(x), b, target_stats=jl.precompute_ssim_target_stats(jnp.asarray(y))))(
        jnp.asarray(y))
    np.testing.assert_array_equal(np.asarray(jgy), 0.0)


def test_five_moment_backward_skips_dy_for_a_detached_target():
    """Distillation's teacher image needs no gradient: the five-moment
    backward then returns no dy, and its dx is bit-equal to the dx of a
    backward that forms dy too; the JAX gradient holds it as before."""
    x, y = _pair((3, 33, 48), 8)
    tx = torch.from_numpy(x).requires_grad_(True)
    (dx_alone,) = torch.autograd.grad(tl.ssim(tx, torch.from_numpy(y)), [tx])
    ty = torch.from_numpy(y).requires_grad_(True)
    dx_both, dy = torch.autograd.grad(tl.ssim(tx, ty), [tx, ty])
    assert torch.equal(dx_alone, dx_both) and dy.abs().max() > 0
    want = jax.grad(lambda a: jl.ssim(a, jnp.asarray(y)))(jnp.asarray(x))
    _close_normalised(_np(dx_alone), want, 1e-5)

    class Ctx:
        saved_tensors = (tx.detach(), ty.detach())
        needs_input_grad = (True, False)

    g = torch.from_numpy(np.random.default_rng(8).normal(size=(15, 33, 48)).astype(np.float32))
    dx, none = tl._Moments5.backward(Ctx, g)
    assert none is None and torch.equal(dx, tl._Moments5.backward(
        type("Both", (Ctx,), {"needs_input_grad": (True, True)}), g)[0])


def test_blur_vjp_is_the_blur():
    x, _ = _pair((3, 24, 40), 6)
    wgt = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad((tl.separable_blur(tx) * torch.from_numpy(wgt)).sum(), [tx])
    tx2 = torch.from_numpy(x).requires_grad_(True)
    (autodiff,) = torch.autograd.grad((tl.plain_blur(tx2) * torch.from_numpy(wgt)).sum(), [tx2])
    np.testing.assert_allclose(_np(got), _np(autodiff), atol=1e-5, rtol=0)
    want = jax.grad(lambda v: (jl._blur_self_adjoint(11, 1.5, True)(v) * jnp.asarray(wgt)).sum())(jnp.asarray(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=0)


def test_gs_loss_psnr_and_plain_losses_match_jax():
    x, y = _pair((3, 24, 32), 7)
    mask = (np.random.default_rng(7).uniform(size=(1, 24, 32)) > 0.3).astype(np.float32)
    jx, jy, jm = jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)
    tx, ty, tm = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask)
    pairs = [
        (tl.gs_loss(tx, ty), jl.gs_loss(jx, jy)),
        (tl.gs_loss(tx, ty, target_stats=tl.precompute_ssim_target_stats(ty), lambda_dssim=0.3),
         jl.gs_loss(jx, jy, target_stats=jl.precompute_ssim_target_stats(jy), lambda_dssim=0.3)),
        (tl.l1_loss(tx, ty), jl.l1_loss(jx, jy)),
        (tl.l2_loss(tx, ty), jl.l2_loss(jx, jy)),
        (tl.mse(tx, ty), jl.mse(jx, jy)),
        (tl.masked_mse(tx, ty, tm), jl.masked_mse(jx, jy, jm)),
        (tl.masked_mae(tx, ty, tm), jl.masked_mae(jx, jy, jm)),
        (tl.masked_mse(tx, ty), jl.masked_mse(jx, jy)),
        (tl.masked_mae(tx, ty), jl.masked_mae(jx, jy)),
    ]
    for i, (got, want) in enumerate(pairs):
        assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-7), i
    assert float(tl.psnr(tx, ty)) == pytest.approx(float(jl.psnr(jx, jy)), abs=1e-4)
    assert float(tl.psnr(torch.zeros(3, 8, 8), torch.full((3, 8, 8), 0.1))) == pytest.approx(20.0, abs=1e-4)
    assert float(tl.psnr(tx, tx)) == pytest.approx(float(jl.psnr(jx, jx)))


def test_lr_schedules_match_jax():
    for kw in (dict(lr_init=1.6e-4, lr_final=1.6e-6, max_steps=30_000),
               dict(lr_init=3.2e-4, lr_final=3.2e-6, lr_delay_mult=0.01, max_steps=30_000),
               dict(lr_init=1e-3, lr_final=1e-5, lr_delay_steps=100, lr_delay_mult=0.1, max_steps=500),
               dict(lr_init=0.0, lr_final=0.0)):
        f, jf = tgen.expon_lr_schedule(**kw), jgen.expon_lr_schedule(**kw)
        for step in (-1, 0, 1, 50, 100, 15_000, 30_000, 40_000):
            assert float(f(step)) == pytest.approx(float(jf(step)), rel=1e-6, abs=0), (kw, step)
    f = tgen.expon_lr_schedule(1.6e-4, 1.6e-6, max_steps=30_000)
    assert float(f(15_000)) == pytest.approx((1.6e-4 * 1.6e-6) ** 0.5, rel=1e-4)
    d, jd = tgen.exponential_decay_every(0.95, 400), jgen.exponential_decay_every(0.95, 400)
    for step in (0, 399, 400, 1200, 5000):
        assert float(d(step)) == float(jd(step))
    x = torch.tensor([0.1, 0.5, 0.9])
    np.testing.assert_allclose(_np(tgen.inverse_sigmoid(x)), np.asarray(jgen.inverse_sigmoid(jnp.asarray(_np(x)))),
                               rtol=1e-6)


def test_blur_wrappers_on_cpu_use_plain_versions():
    x, y = _pair((2, 9, 13), 8)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    cuda_build.reset_launch_counts()
    np.testing.assert_array_equal(_np(tl.blur(tx)), _np(tl.plain_blur(tx)))
    np.testing.assert_array_equal(_np(tl.blur3(tx, ty)), _np(tl.plain_blur3(tx, ty)))
    np.testing.assert_array_equal(_np(tl.blur5(tx, ty)), _np(tl.plain_blur5(tx, ty)))
    assert not any(cuda_build.launch_counts().values())  # no kernel ran
    # channel-major planes: plane k of channel c at c * P + k
    np.testing.assert_array_equal(_np(tl.blur5(tx, ty))[1 * 5 + 3], _np(tl.plain_blur(ty * ty))[1])
    with pytest.raises(ValueError, match="float32"):
        tl.blur(tx.double())
    with pytest.raises(ValueError, match="differ"):
        tl.blur3(tx, ty[:1])
