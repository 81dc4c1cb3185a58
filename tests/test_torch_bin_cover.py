"""Binning's tile cover (`binning._cover`): the wrapper of the cover kernel.

On CPU tensors `_cover` runs the torch chain `tile_rect` + `_exact_tile_mask`
(its plain version); the kernel, which runs only on a card, is held to that
chain bit for bit by `chip_smoke.py`. Here `_cover` is held to the chain on
every kind of the stress set, and the wrapper is shown to refuse inputs the
kernel does not take before anything is built or launched.
"""
import dataclasses

import pytest
import torch

from lightgaussian_tpu_torch.ops.rasterize import binning as tb
from lightgaussian_tpu_torch.utils import cuda_build
from lightgaussian_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

W, H = 1237, 822  # the benchmark's Mip-NeRF 360 images_4 size
N = 4096


def _stress(kind):
    return tsyn.cover_stress_splats(kind, N, W, H, seed=11, device="cpu")


def _chain(splats, grid):
    lo_x, lo_y, hi_x, _hi_y, rect_count = tb.tile_rect(
        splats.mean2d, splats.radius, grid, conic=splats.conic, opacity=splats.opacity
    )
    mask, count, _use_mask = tb._exact_tile_mask(splats, lo_x, lo_y, hi_x, rect_count)
    return tb.TileCover(lo_x, lo_y, hi_x, mask, count), rect_count


@pytest.mark.parametrize("kind", tsyn.COVER_STRESS_KINDS)
def test_cover_on_the_cpu_is_the_chain(kind):
    splats, grid = _stress(kind), tb.make_grid(W, H)
    cuda_build.reset_launch_counts()
    got = tb._cover(splats, grid)
    want, _rect_count = _chain(splats, grid)
    assert cuda_build.launch_counts()["bin_cover"] == 0
    for field in tb.TileCover._fields:
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == torch.int64 and g.shape == (N,), field
        assert torch.equal(g, w), field
    # each kind stresses what it is drawn for
    alive = got.count > 0
    if kind == "large":
        assert ((got.mask == 0) & (got.count > tb.MAX_MASK_TILES)).any() and (got.mask > 0).any()
    elif kind == "alpha_eps":
        eps = torch.tensor(tb.ALPHA_EPS, dtype=torch.float32)
        one_ulp_up = torch.nextafter(eps, torch.tensor(1.0))
        assert (splats.opacity == eps).any() and (splats.opacity == one_ulp_up).any()
        assert not (alive & (splats.opacity <= eps)).any() and (alive & (splats.opacity > eps)).any()
    elif kind == "offscreen":
        assert alive.any() and (splats.radius > 0).sum() > alive.sum()
    elif kind == "behind":
        assert not torch.isfinite(splats.mean2d).all() and (splats.radius > 0).any() and not alive.any()
    elif kind == "radius0":
        assert alive.any() and not alive[splats.radius == 0].any()
    elif kind == "grazing":
        # the tile right of the mean's: kept by some splats, dropped by others
        tx = torch.floor(splats.mean2d[:, 0] / tb.TILE_SIZE).long()
        ty = torch.floor(splats.mean2d[:, 1] / tb.TILE_SIZE).long()
        slot = (ty - got.lo_y) * (got.hi_x - got.lo_x) + (tx + 1 - got.lo_x)
        kept = (got.mask >> slot) & 1
        assert alive.all() and 0.2 < float(kept.float().mean()) < 0.8


def _bad_inputs():
    n = 64
    return {
        "radius float32": dict(radius=torch.ones(n, dtype=torch.float32)),
        "radius int64": dict(radius=torch.ones(n, dtype=torch.int64)),
        "radius [N+1]": dict(radius=torch.ones(n + 1, dtype=torch.int32)),
        "conic float64": dict(conic=torch.ones(n, 3, dtype=torch.float64)),
        "conic [N, 2]": dict(conic=torch.ones(n, 2)),
        "conic strided columns": dict(conic=torch.ones(n, 6)[:, ::2]),
        "mean2d float16": dict(mean2d=torch.ones(n, 2, dtype=torch.float16)),
        "mean2d [N, 3]": dict(mean2d=torch.ones(n, 3)),
        "mean2d [N]": dict(mean2d=torch.ones(n)),
        "opacity [N, 1]": dict(opacity=torch.ones(n, 1)),
        "mean2d on another device": dict(mean2d=torch.ones(n, 2, device="meta")),
        "radius on another device": dict(radius=torch.ones(n, dtype=torch.int32, device="meta")),
        "all on a device of neither kind": "meta",
    }


BAD = _bad_inputs()


@pytest.mark.parametrize("case", sorted(BAD))
def test_cover_refuses_bad_inputs_before_any_launch(case, monkeypatch):
    def no_build(*_args):
        raise AssertionError("the cover kernel was built or launched")

    monkeypatch.setattr(cuda_build, "load", no_build)
    splats = tsyn.cover_stress_splats("radius0", 64, W, H, seed=3, device="cpu")
    bad = BAD[case]
    if bad == "meta":
        splats = tb.Splats(**{f.name: getattr(splats, f.name).to("meta") for f in dataclasses.fields(splats)})
    else:
        splats = dataclasses.replace(splats, **bad)
    cuda_build.reset_launch_counts()
    with pytest.raises(ValueError):
        tb._cover(splats, tb.make_grid(W, H))
    assert cuda_build.launch_counts()["bin_cover"] == 0


def test_cover_takes_strided_rows():
    """Splats that are column views of one packed array (as the Gaussian-
    sharded step gathers them) pass the checks and give the same cover."""
    splats, grid = _stress("grazing"), tb.make_grid(W, H)
    packed = torch.cat([splats.mean2d, splats.conic, splats.color, splats.opacity[:, None]], 1)
    views = dataclasses.replace(splats, mean2d=packed[:, 0:2], conic=packed[:, 2:5], opacity=packed[:, 8])
    assert not views.mean2d.is_contiguous()
    for a, b in zip(tb._cover(views, grid), tb._cover(splats, grid)):
        assert torch.equal(a, b)
