"""PyTorch port vs the JAX package: gradients of the tiled blend.

Same-seed scenes (bit-identical in both packages) go through the JAX render
and the port's on the CPU, where the port's backward runs its plain version
(`blend.plain_blend_backward` and a per-Gaussian `index_add_`); the CUDA
kernel is held against that on the card by `chip_smoke.py`. The JAX tiled
path runs its Pallas kernels in interpret mode, as its own tests do.

Tolerances (float32), those of the JAX suite (tests/test_rasterizer.py):
- parameter and `mean2d_offset` gradients 5e-5 after dividing by the
  JAX gradient's largest magnitude: the transmittance products and the
  remaining-contribution prefixes are associated differently;
- the background gradient rtol 1e-4;
- the backward's per-instance and per-Gaussian gradients on identical
  binnings 5e-5 normalised, as above.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgaussian_tpu.ops.rasterize import binning as jb
from lightgaussian_tpu.ops.rasterize import pallas_blend as jpk
from lightgaussian_tpu.ops.rasterize import render as jrender
from lightgaussian_tpu.ops.rasterize import tiled as jtiled
from lightgaussian_tpu.ops.rasterize.projection import preprocess as jpreprocess
from lightgaussian_tpu.utils import synthetic as jsyn
from lightgaussian_tpu_torch.ops.rasterize import binning as tb
from lightgaussian_tpu_torch.ops.rasterize import blend as tblend
from lightgaussian_tpu_torch.ops.rasterize import render as trender
from lightgaussian_tpu_torch.ops.rasterize.projection import Splats as TSplats
from lightgaussian_tpu_torch.ops.rasterize.projection import preprocess as tpreprocess
from lightgaussian_tpu_torch.utils import cuda_build
from lightgaussian_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

BG = np.array([0.1, 0.2, 0.3], np.float32)
PARAMS = ("means", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logits")
SPLAT_FIELDS = ("mean2d", "conic", "color", "opacity", "depth", "radius")
MAX_INST = 1 << 16

# The JAX suite's 256-Gaussian scene, and a scene of large opaque splats
# whose central tiles saturate, so the walk's early exit is taken.
CASES = {
    "small": (dict(n=256, seed=1), 96, 64),
    "saturated": (dict(n=800, seed=3, extent=1.5, scale_range=(0.15, 0.4)), 96, 64),
}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close_normalised(got, want, atol, what):
    want = np.asarray(want)
    scale = np.abs(want).max() + 1e-8
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale, atol=atol, rtol=0, err_msg=what)
    assert np.abs(want).max() > 0, f"{what}: the JAX gradient is all zero (vacuous test)"


class Case:
    """Both packages' scene and camera for one entry of CASES, with 64 dead
    slots past the live Gaussians and the first 8 moved out of view, so
    some Gaussians reach no tile."""

    def __init__(self, name):
        kw, w, h = CASES[name]
        self.w, self.h = w, h
        kw = dict(kw, capacity=kw["n"] + 64)
        jscene = jsyn.random_scene(**kw)
        means = np.array(jscene.means)
        means[:8, 0] += 50.0
        self.jscene = dataclasses.replace(jscene, means=jnp.asarray(means))
        self.jcam = jsyn.default_camera(width=w, height=h)
        self.tscene = dataclasses.replace(tsyn.random_scene(device="cpu", **kw), means=torch.from_numpy(means))
        self.tcam = tsyn.default_camera(width=w, height=h, device="cpu")
        rng = np.random.default_rng(7)
        self.w_img = rng.normal(size=(3, h, w)).astype(np.float32)
        self.w_t = rng.normal(size=(h, w)).astype(np.float32)
        self._jgrads = {}

    def jax_grads(self, method):
        """JAX gradients of sum(image * w_img) + sum(final_T * w_t)."""
        if method not in self._jgrads:
            w_img, w_t = jnp.asarray(self.w_img), jnp.asarray(self.w_t)

            def loss(params, offset, bg):
                out = jrender(self.jscene.with_params(params), self.jcam, bg, mean2d_offset=offset,
                              method=method, interpret=True, max_instances=MAX_INST)
                return (out.render * w_img).sum() + (out.final_T * w_t).sum()

            zeros = jnp.zeros((self.jscene.capacity, 2), jnp.float32)
            self._jgrads[method] = jax.grad(loss, argnums=(0, 1, 2))(
                self.jscene.params(), zeros, jnp.asarray(BG))
        return self._jgrads[method]

    def port_grads(self):
        params = {k: v.clone().requires_grad_(True) for k, v in self.tscene.params().items()}
        offset = torch.zeros((self.tscene.capacity, 2), requires_grad=True)
        bg = torch.from_numpy(BG).requires_grad_(True)
        out = trender(self.tscene.with_params(params), self.tcam, bg, mean2d_offset=offset,
                      max_instances=MAX_INST)
        loss = (out.render * torch.from_numpy(self.w_img)).sum() + (out.final_T * torch.from_numpy(self.w_t)).sum()
        got = torch.autograd.grad(loss, [params[k] for k in PARAMS] + [offset, bg])
        return dict(zip(PARAMS, got[:-2])), got[-2], got[-1]


_BUILT = {}


def _case(name):
    if name not in _BUILT:
        _BUILT[name] = Case(name)
    return _BUILT[name]


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return _case(request.param)


@pytest.fixture(scope="module")
def port_grads(case):
    return case.port_grads()


@pytest.mark.parametrize("method", ["tiled", "reference"])
def test_param_grads_match_jax(case, port_grads, method):
    want = case.jax_grads(method)[0]
    got, _, _ = port_grads
    for k in PARAMS:
        _close_normalised(_np(got[k]), want[k], 5e-5, k)


def test_mean2d_offset_grad_matches_jax(case, port_grads):
    _, offset_grad, _ = port_grads
    for method in ("tiled", "reference"):
        want = case.jax_grads(method)[1]
        _close_normalised(_np(offset_grad), want, 5e-5, f"mean2d_offset vs JAX {method}")
    assert np.abs(_np(offset_grad)).max() > 1e-3


def test_bg_grad_matches_jax(case, port_grads):
    _, _, bg_grad = port_grads
    np.testing.assert_allclose(_np(bg_grad), np.asarray(case.jax_grads("tiled")[2]), rtol=1e-4)
    # d(sum image)/d(bg) is the summed final transmittance, per channel
    with torch.no_grad():
        out = trender(case.tscene, case.tcam, torch.from_numpy(BG))
    want = (_np(out.final_T)[None] * case.w_img).sum(axis=(1, 2))
    np.testing.assert_allclose(_np(bg_grad), want, rtol=1e-4)


def test_unseen_gaussians_get_exact_zero_grads(case, port_grads):
    got, offset_grad, _ = port_grads
    b = tb.bin_splats(tpreprocess(case.tscene, case.tcam), tb.make_grid(case.w, case.h), MAX_INST)
    unseen = np.ones(case.tscene.capacity, bool)
    unseen[_np(b.gid_sorted)] = False
    assert unseen[:8].all() and unseen[-64:].all()  # out of view, and dead
    want = case.jax_grads("tiled")
    for k in ("means", "log_scales", "opacity_logits"):
        np.testing.assert_array_equal(_np(got[k])[unseen], 0.0)
        np.testing.assert_array_equal(np.asarray(want[0][k])[unseen], 0.0)
    np.testing.assert_array_equal(_np(offset_grad)[unseen], 0.0)


def _jax_binning_and_seed(case):
    """The JAX binning of the JAX splats, and a backward seed (g, r) from
    the JAX forward with random image and final_T cotangents."""
    js = jpreprocess(case.jscene, case.jcam)
    grid = jb.make_grid(case.w, case.h)
    b = jb.bin_splats(js, grid, MAX_INST)
    image, final_t, _ = jtiled.blend_tiled(js, jnp.asarray(BG), case.w, case.h, MAX_INST, interpret=True)
    g = jnp.asarray(case.w_img)
    r = (image * g).sum(axis=0) + final_t * jnp.asarray(case.w_t)
    pad = lambda x: jnp.pad(x, ((0, 0), (0, grid.tiles_y * 32 - case.h), (0, grid.tiles_x * 32 - case.w)))
    return js, grid, b, jtiled._tile_image(pad(g), grid), jtiled._tile_image(pad(r[None]), grid)


def test_plain_backward_matches_jax_kernel(case):
    js, grid, jbin, tile_g, tile_r = _jax_binning_and_seed(case)
    total = int(jbin.total)
    want_inst = np.asarray(jtiled._unchunk(jpk.blend_backward(
        jbin.tile_starts, jbin.inst_chunks, tile_g, tile_r, grid, interpret=True)))[:total, :tb.FEAT_WIDTH]
    gid = np.asarray(jbin.gid_sorted)[:total]
    want_gauss = np.zeros((js.mean2d.shape[0], tb.FEAT_WIDTH), np.float32)
    np.add.at(want_gauss, gid, want_inst)

    splats = TSplats(**{f: torch.from_numpy(np.array(getattr(js, f))) for f in SPLAT_FIELDS})
    tgrid = tb.make_grid(case.w, case.h)
    b = tb.bin_splats(splats, tgrid, MAX_INST)
    np.testing.assert_array_equal(_np(b.gid_sorted), gid)
    tg, tr = torch.from_numpy(np.array(tile_g)), torch.from_numpy(np.array(tile_r))
    got_inst, work = tblend.plain_blend_backward(b.tile_starts, b.inst, tg, tr, tgrid)
    for c in range(tb.FEAT_WIDTH):
        _close_normalised(_np(got_inst)[:, c], want_inst[:, c], 5e-5, f"per-instance column {c}")
    got_gauss = tblend.blend_backward(b.tile_starts, b.inst, b.gid_sorted, tg, tr, tgrid, js.mean2d.shape[0])
    for c in range(tb.FEAT_WIDTH):
        _close_normalised(_np(got_gauss)[:, c], want_gauss[:, c], 5e-5, f"per-Gaussian column {c}")
    # the backward walks the exact forward's pairs
    _, _, work_fwd = tblend.plain_blend(b.tile_starts, b.inst, tgrid, exact=True)
    np.testing.assert_array_equal(_np(work), _np(work_fwd))


def test_saturated_backward_zeroes_instances_past_the_exit():
    case = _case("saturated")
    js, grid, jbin, tile_g, tile_r = _jax_binning_and_seed(case)
    splats = TSplats(**{f: torch.from_numpy(np.array(getattr(js, f))) for f in SPLAT_FIELDS})
    tgrid = tb.make_grid(case.w, case.h)
    b = tb.bin_splats(splats, tgrid, MAX_INST)
    got, work = tblend.plain_blend_backward(
        b.tile_starts, b.inst, torch.from_numpy(np.array(tile_g)), torch.from_numpy(np.array(tile_r)), tgrid)
    starts = _np(b.tile_starts).astype(np.int64)
    lengths = starts[1:] - starts[:-1]
    walked = _np(work).sum(axis=1)
    exited = np.nonzero(walked < lengths * tblend.PIX)[0]
    assert exited.size > 0  # some tiles saturate before their last instance
    zero_rows = 0
    for t in exited:
        rows = _np(got)[starts[t]:starts[t + 1]]
        zero_rows += int((np.abs(rows).sum(axis=1) == 0).sum())
    assert zero_rows > 0  # instances behind saturated pixels get nothing


def test_backward_wrapper_checks_and_counts(case):
    grid = tb.make_grid(case.w, case.h)
    b = tb.bin_splats(tpreprocess(case.tscene, case.tcam), grid, MAX_INST)
    t = grid.num_tiles
    g, r = torch.zeros((t, 3, tblend.PIX)), torch.zeros((t, 1, tblend.PIX))
    cuda_build.reset_launch_counts()
    out = tblend.blend_backward(b.tile_starts, b.inst, b.gid_sorted, g, r, grid, case.tscene.capacity)
    assert out.shape == (case.tscene.capacity, tb.FEAT_WIDTH) and not out.any()
    assert not any(cuda_build.launch_counts().values())  # the plain version ran
    with pytest.raises(ValueError, match="gid_sorted"):
        tblend.blend_backward(b.tile_starts, b.inst, b.gid_sorted.int(), g, r, grid, 1)
    with pytest.raises(ValueError, match="tile_g"):
        tblend.blend_backward(b.tile_starts, b.inst, b.gid_sorted, g[:, :2].contiguous(), r, grid, 1)
    with pytest.raises(ValueError, match="tile_r"):
        tblend.blend_backward(b.tile_starts, b.inst, b.gid_sorted, g, r.double(), grid, 1)


def test_fast_path_refuses_gradients(case):
    scene = dataclasses.replace(case.tscene, means=case.tscene.means.clone().requires_grad_(True))
    bg = torch.from_numpy(BG)
    with pytest.raises(NotImplementedError, match="no backward"):
        trender(scene, case.tcam, bg, fast=True)
    with torch.no_grad():
        out = trender(scene, case.tcam, bg, fast=True)
    assert torch.isfinite(out.render).all()
