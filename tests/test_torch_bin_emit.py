"""Binning's instance emission (`binning._emit`): the wrapper of the emission
kernel, pieces (c) and (d) of `bin_splats`.

On CPU tensors `_emit` runs `plain_emit`, the int64 torch chain
`_fill_slots` + `_depth_key` with the key stored as an int32 whose top bit is
flipped; the kernel, which runs only on a card, is held to it bit for bit by
`chip_smoke.py`. Here the plain emission is held to the chain and to a
Gaussian-by-Gaussian numpy emission on every kind of the stress set (with no
cut, with a cut inside a Gaussian's instances, with every instance on the
>32-tile fallback, with all depths equal, and with no instance), `bin_splats`
with its 32-bit sort is held to the int64 sort it replaces, and the wrapper
is shown to refuse inputs the kernel does not take before anything is built
or launched.
"""
import dataclasses

import numpy as np
import pytest
import torch

from lightgaussian_tpu_torch.ops.rasterize import binning as tb
from lightgaussian_tpu_torch.utils import cuda_build
from lightgaussian_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

W, H = 1237, 822  # the benchmark's Mip-NeRF 360 images_4 size
N = 4096
CASES = ("uncut", "cut", "fallback", "equal_depths")


def _stress(kind, width=W, height=H):
    return tsyn.cover_stress_splats(kind, N, width, height, seed=11, device="cpu")


def _inputs(kind, case, width=W, height=H):
    """Splats, grid, cover, prefix sum, live total and cut m of one case."""
    splats, grid = _stress(kind, width, height), tb.make_grid(width, height)
    if case == "equal_depths":
        splats = dataclasses.replace(splats, depth=torch.full_like(splats.depth, 4.0))
    cover = tb._cover(splats, grid)
    if case == "fallback":  # every live Gaussian on its rect's row-major slots
        lo_x, lo_y, hi_x, _hi_y, rect_count = tb.tile_rect(
            splats.mean2d, splats.radius, grid, conic=splats.conic, opacity=splats.opacity)
        cover = tb.TileCover(lo_x, lo_y, hi_x, torch.zeros_like(rect_count), rect_count)
    cum, total, _fallback = tb._instance_total(cover.count)
    m = total
    if case == "cut" and total:
        # a cut inside the instances of the middle Gaussian of at least two
        many = torch.nonzero(cover.count >= 2).flatten()
        g = int(many[len(many) // 2])
        m = int(cum[g] - cover.count[g]) + 1
    return splats, grid, cover, cum, total, m


def _chain(splats, grid, cover, cum, total, m):
    gid, tile = tb._fill_slots(cover, cum, total, m, grid)
    return tb._depth_key(splats.depth, gid, tile, grid), gid


def _by_gaussian(splats, grid, cover, cum, m):
    """The emission written Gaussian by Gaussian in numpy: its slots below m,
    each on the next set bit of its mask (or its rect's next row-major slot
    on the fallback), keyed by tile and range-adaptive depth."""
    c = {f: getattr(cover, f).numpy() for f in tb.TileCover._fields}
    end = cum.numpy()
    start = end - c["count"]
    owners = np.nonzero((c["count"] > 0) & (start < m))[0]
    dep = splats.depth.numpy().view(np.int32).astype(np.int64)
    least = dep[owners].min()
    shift = max(int(dep[owners].max() - least).bit_length() - tb.sort_key_bits(grid), 0)
    keys, gids = [], []
    for i in owners:
        mask = int(c["mask"][i])
        local = np.array([b for b in range(32) if mask >> b & 1]) if mask else np.arange(c["count"][i])
        local = local[: min(end[i], m) - start[i]]
        w = max(int(c["hi_x"][i] - c["lo_x"][i]), 1)
        tile = (c["lo_y"][i] + local // w) * grid.tiles_x + c["lo_x"][i] + local % w
        keys.append((tile << tb.sort_key_bits(grid)) | ((dep[i] - least) >> shift))
        gids.append(np.full(len(local), i))
    return np.concatenate(keys), np.concatenate(gids)


def _unflip(key32):
    return key32.to(torch.int64) + (1 << 31)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", tsyn.COVER_STRESS_KINDS)
def test_plain_emission_is_the_int64_chain(kind, case):
    splats, grid, cover, cum, total, m = _inputs(kind, case)
    if kind == "behind":  # nothing lives: there is nothing to emit
        assert total == 0
        with pytest.raises(ValueError):
            tb._emit(cover, cum, splats.depth, total, m, grid)
        return
    assert 0 < m <= total and (m < total) == (case == "cut")
    cuda_build.reset_launch_counts()
    key, gid = tb._emit(cover, cum, splats.depth, total, m, grid)
    assert cuda_build.launch_counts()["bin_emit"] == 0
    assert key.dtype == torch.int32 and gid.dtype == torch.int64 and key.shape == gid.shape == (m,)
    want_key, want_gid = _chain(splats, grid, cover, cum, total, m)
    assert torch.equal(_unflip(key), want_key) and torch.equal(gid, want_gid)
    ref_key, ref_gid = _by_gaussian(splats, grid, cover, cum, m)
    np.testing.assert_array_equal(_unflip(key).numpy(), ref_key)
    np.testing.assert_array_equal(gid.numpy(), ref_gid)
    # the flip keeps the order: a signed sort of the int32 keys is the sort of the unsigned ones
    assert torch.equal(torch.sort(key, stable=True).indices, torch.sort(want_key, stable=True).indices)
    if case == "cut":  # the cut falls inside a Gaussian's instances
        assert int(gid[-1]) == int(want_gid[-1]) and int(cover.count[gid[-1]]) >= 2
        assert int(cum[gid[-1]]) > m
    if case == "fallback":
        assert not cover.mask.any()
    if case == "equal_depths":  # the key is the tile alone
        assert torch.equal(want_key & ((1 << tb.sort_key_bits(grid)) - 1), torch.zeros_like(want_key))


def _int64_bin(splats, grid, cap):
    """`bin_splats` as it was with an int64 key: the chain's key, its stable
    sort, the tiles read by shifting the sorted keys."""
    cover = tb._cover(splats, grid)
    cum, total, _fallback = tb._instance_total(cover.count)
    m = min(total, tb.instance_capacity(cap))
    key, gid = _chain(splats, grid, cover, cum, total, m)
    key_s, order = torch.sort(key, stable=True)
    gid_s = gid[order]
    tiles = torch.arange(grid.num_tiles + 1, dtype=torch.int64)
    starts = torch.searchsorted(key_s >> tb.sort_key_bits(grid), tiles, side="left").to(torch.int32)
    return gid_s, starts, tb.pack_features(splats)[gid_s].contiguous(), total, key


@pytest.mark.parametrize("size", [(W, H), (3840, 2160)])
@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("kind", [k for k in tsyn.COVER_STRESS_KINDS if k != "behind"])
def test_bin_splats_equals_the_int64_sort(kind, cut, size):
    splats, grid = _stress(kind, *size), tb.make_grid(*size)
    total = tb.bin_splats(splats, grid, tb.MAX_CAPACITY).total
    cap = total // 2 if cut else tb.MAX_CAPACITY
    got = tb.bin_splats(splats, grid, cap)
    gid_s, starts, inst, want_total, key = _int64_bin(splats, grid, cap)
    assert got.total == want_total == total
    assert got.gid_sorted.dtype == torch.int64 and torch.equal(got.gid_sorted, gid_s)
    assert torch.equal(got.tile_starts, starts) and torch.equal(got.inst, inst)
    assert (key >= 1 << 31).any()  # tiles in the grid's upper half set the key's top bit
    if cut:
        assert got.inst.shape[0] == tb.instance_capacity(cap) < total


@pytest.mark.parametrize("kind", ["behind", "radius0 all culled"])
def test_no_instance_skips_the_emission(kind, monkeypatch):
    def no_emission(*_args):
        raise AssertionError("a binning with no instance emitted")

    splats = _stress(kind.split()[0])
    if kind == "radius0 all culled":
        splats = dataclasses.replace(splats, radius=torch.zeros_like(splats.radius))
    monkeypatch.setattr(tb, "_emit", no_emission)
    b = tb.bin_splats(splats, tb.make_grid(W, H), tb.MAX_CAPACITY)
    assert b.total == 0 and b.gid_sorted.shape == (0,) and b.inst.shape == (0, tb.FEAT_WIDTH)
    assert not b.tile_starts.any()


def _bad_inputs():
    n = 64
    i64 = torch.ones(n, dtype=torch.int64)
    return {
        "lo_x int32": dict(lo_x=torch.ones(n, dtype=torch.int32)),
        "mask float32": dict(mask=torch.ones(n)),
        "count [N+1]": dict(count=torch.ones(n + 1, dtype=torch.int64)),
        "hi_x strided": dict(hi_x=torch.ones(2 * n, dtype=torch.int64)[::2]),
        "lo_y [N, 1]": dict(lo_y=i64[:, None]),
        "cum int32": dict(cum=torch.ones(n, dtype=torch.int32)),
        "cum strided": dict(cum=torch.ones(2 * n, dtype=torch.int64)[::2]),
        "depth float64": dict(depth=torch.ones(n, dtype=torch.float64)),
        "depth [N-1]": dict(depth=torch.ones(n - 1)),
        "depth on another device": dict(depth=torch.ones(n, device="meta")),
        "mask on another device": dict(mask=torch.ones(n, dtype=torch.int64, device="meta")),
        "m 0": dict(m=0),
        "m past the total": dict(m=65),
        "total past MAX_CAPACITY": dict(total=tb.MAX_CAPACITY + 1, m=64),
        "all on a device of neither kind": "meta",
    }


BAD = _bad_inputs()


@pytest.mark.parametrize("case", sorted(BAD))
def test_emission_refuses_bad_inputs_before_any_launch(case, monkeypatch):
    def no_build(*_args):
        raise AssertionError("the emission kernel was built or launched")

    monkeypatch.setattr(cuda_build, "load", no_build)
    monkeypatch.setattr(cuda_build.Kernel, "_launch", no_build)
    n = 64
    args = dict(lo_x=torch.zeros(n, dtype=torch.int64), lo_y=torch.zeros(n, dtype=torch.int64),
                hi_x=torch.ones(n, dtype=torch.int64), mask=torch.ones(n, dtype=torch.int64),
                count=torch.ones(n, dtype=torch.int64), cum=torch.arange(1, n + 1), depth=torch.ones(n),
                total=n, m=n)
    bad = BAD[case]
    if bad == "meta":
        args = {k: v.to("meta") if isinstance(v, torch.Tensor) else v for k, v in args.items()}
    else:
        args.update(bad)
    cover = tb.TileCover(*(args[f] for f in tb.TileCover._fields))
    cuda_build.reset_launch_counts()
    with pytest.raises(ValueError):
        tb._emit(cover, args["cum"], args["depth"], args["total"], args["m"], tb.make_grid(W, H))
    assert cuda_build.launch_counts()["bin_emit"] == 0


def test_emission_takes_a_strided_depth():
    """Depths that are a column of one packed array (as the Gaussian-sharded
    step gathers them) give the same emission."""
    splats, grid, cover, cum, total, m = _inputs("grazing", "uncut")
    packed = torch.stack([splats.opacity, splats.depth], 1)
    assert not packed[:, 1].is_contiguous()
    a = tb._emit(cover, cum, packed[:, 1], total, m, grid)
    b = tb._emit(cover, cum, splats.depth, total, m, grid)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
