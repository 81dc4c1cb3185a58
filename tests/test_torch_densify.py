"""PyTorch port vs the JAX package: densification, pruning, opacity reset and
checkpoint files.

One train state, made with numpy from a seed (a `random_scene` of 200
Gaussians in 256 slots with holes punched into `alive`, random densification
statistics and non-zero Adam moments), goes through both packages. The
split noise is drawn once with `jax.random.normal` from the key the JAX
function is given, and handed to the port's `densify_with_noise` as numpy,
so both place the same children.

Tolerances (float32): `alive`, the report, the Adam moments and every copied
row are equal bit for bit (copies and zeroing only); the sampled means and
the children's log-scales agree to atol 1e-6 (`exp`, `log` and the rotation
differ in the last bits between the two frameworks). Checkpoint arrays are
equal bit for bit both ways.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgaussian_tpu.train import checkpoint as jckpt
from lightgaussian_tpu.train import densify as jdensify
from lightgaussian_tpu.train import state as jstate
from lightgaussian_tpu.utils import synthetic as jsyn
from lightgaussian_tpu_torch import convert
from lightgaussian_tpu_torch.train import checkpoint as tckpt
from lightgaussian_tpu_torch.train import densify as tdensify

torch.set_num_threads(1)

N, CAP = 200, 256
PARAMS = ("means", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logits")
EXTENT = 1.0


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_state_to_numpy(s) -> dict:
    """A JAX TrainState in `convert`'s dict layout."""
    scene = {k: np.asarray(getattr(s.scene, k)) for k in PARAMS}
    scene.update(alive=np.asarray(s.scene.alive), active_sh_degree=s.scene.active_sh_degree,
                 max_sh_degree=s.scene.max_sh_degree)
    return dict(
        scene=scene,
        mu={k: np.asarray(v) for k, v in s.opt.mu.items()},
        nu={k: np.asarray(v) for k, v in s.opt.nu.items()},
        count=int(s.opt.count), step=int(s.step),
        max_radii2d=np.asarray(s.max_radii2d), xyz_grad_accum=np.asarray(s.xyz_grad_accum),
        denom=np.asarray(s.denom),
    )


def make_states(n_alive_holes=True, cap=CAP, hot="some"):
    """(JAX state, port state) with the same contents."""
    rng = np.random.default_rng(21)
    scene = jsyn.random_scene(n=N, seed=2, max_sh_degree=1, scale_range=(0.004, 0.03), capacity=cap)
    alive = np.asarray(scene.alive).copy()
    if n_alive_holes:
        alive[3:N:7] = False  # free slots in between, so targets are not a plain tail
    scene = dataclasses.replace(scene, alive=jnp.asarray(alive))
    st = jstate.init_train_state(scene)
    denom = rng.integers(0, 4, cap).astype(np.float32)
    accum = rng.random(cap).astype(np.float32) * denom * (2e-4 if hot == "some" else 1.0)
    if hot == "all":
        denom = np.ones(cap, np.float32)
        accum = np.ones(cap, np.float32)
    mu = {k: jnp.asarray(rng.normal(size=np.shape(v)).astype(np.float32)) for k, v in st.opt.mu.items()}
    nu = {k: jnp.asarray(rng.random(np.shape(v)).astype(np.float32)) for k, v in st.opt.nu.items()}
    st = dataclasses.replace(
        st, opt=dataclasses.replace(st.opt, mu=mu, nu=nu, count=jnp.int32(7)), step=jnp.int32(7),
        xyz_grad_accum=jnp.asarray(accum), denom=jnp.asarray(denom),
        max_radii2d=jnp.asarray(rng.random(cap).astype(np.float32) * 30),
    )
    return st, convert.train_state_from_numpy(_jax_state_to_numpy(st), device="cpu")


def run_both(jst, tst, max_grad, min_opacity, extent, max_screen_size, percent_dense, seed):
    key = jax.random.key(seed)
    want, want_report = jdensify.densify_and_prune(jst, max_grad, min_opacity, extent, max_screen_size,
                                                   percent_dense, key)
    eps_a, eps_b = np.asarray(jax.random.normal(key, (2, jst.scene.capacity, 3), jnp.float32))
    got, got_report = tdensify.densify_with_noise(
        tst, max_grad, min_opacity, extent, max_screen_size, percent_dense,
        torch.from_numpy(eps_a.copy()), torch.from_numpy(eps_b.copy()),
    )
    return want, want_report, got, got_report


def assert_states_equal(want, got, touched_atol=1e-6):
    np.testing.assert_array_equal(_np(got.scene.alive), np.asarray(want.scene.alive))
    for k in PARAMS:
        w, g = np.asarray(getattr(want.scene, k)), _np(getattr(got.scene, k))
        if k in ("means", "log_scales"):
            np.testing.assert_allclose(g, w, atol=touched_atol, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
        np.testing.assert_array_equal(_np(got.opt.mu[k]), np.asarray(want.opt.mu[k]), err_msg=f"mu {k}")
        np.testing.assert_array_equal(_np(got.opt.nu[k]), np.asarray(want.opt.nu[k]), err_msg=f"nu {k}")
    for k in convert.STAT_FIELDS:
        np.testing.assert_array_equal(_np(getattr(got, k)), np.asarray(getattr(want, k)), err_msg=k)
    assert got.step == int(want.step) and got.opt.count == int(want.opt.count)


def assert_reports_equal(want, got):
    assert tuple(got) == tuple(int(v) for v in want), (got, want)


@pytest.mark.parametrize("max_screen_size", [0, 20])
def test_densify_and_prune_matches_jax_slot_by_slot(max_screen_size):
    jst, tst = make_states()
    # percent_dense splits the hot Gaussians into clones and splits; the
    # opacity floor prunes some, and with a screen size the world-size prune runs
    want, wr, got, gr = run_both(jst, tst, 1e-4, 0.5, EXTENT, max_screen_size, 0.024, seed=5)
    assert_reports_equal(wr, gr)
    assert gr.n_cloned > 5 and gr.n_split > 5 and gr.n_pruned > 5 and gr.n_dropped == 0
    assert_states_equal(want, got)
    # every statistic starts over on every slot
    for k in convert.STAT_FIELDS:
        assert float(getattr(got, k).abs().max()) == 0.0
    # Adam's moments are zero on the new slots and the split parents, and untouched elsewhere
    newly = _np(got.scene.alive) & ~_np(tst.scene.alive)
    assert newly.sum() > 0
    assert np.abs(_np(got.opt.mu["means"])[newly]).max() == 0.0
    untouched = (_np(got.opt.mu["means"]) == _np(tst.opt.mu["means"])).all(axis=1)
    assert untouched.sum() > 0.3 * CAP
    # clones went to the lowest free slots, in order, before the splits' children
    free = np.flatnonzero(~_np(tst.scene.alive))
    filled = np.flatnonzero((_np(got.opt.mu["means"]) == 0).all(axis=1) & ~_np(tst.scene.alive))
    np.testing.assert_array_equal(filled, free[:gr.n_cloned + gr.n_split])
    assert gr.n_alive == int(got.scene.alive.sum())


def test_capacity_overflow_drops_the_same_selections():
    """Everything hot in a capacity with too few free slots: clones first,
    then splits, each dropped past the free slots, as in the JAX package."""
    jst, tst = make_states(hot="all")
    n_alive = int(tst.scene.alive.sum())
    n_free = CAP - n_alive
    want, wr, got, gr = run_both(jst, tst, 1e-9, 0.005, EXTENT, 0, 0.012, seed=1)
    assert_reports_equal(wr, gr)
    assert gr.n_dropped == n_alive - n_free > 0
    assert gr.n_cloned + gr.n_split >= n_free  # n_split counts the selected
    assert_states_equal(want, got)
    assert int(got.scene.alive.sum()) + gr.n_pruned == CAP  # every slot was filled
    # percent_dense = 100: all small, all clones; the 56 free slots take the first 56
    jst2, tst2 = make_states(n_alive_holes=False, hot="all")
    want, wr, got, gr = run_both(jst2, tst2, 1e-9, 0.005, EXTENT, 0, 100.0, seed=1)
    assert_reports_equal(wr, gr)
    assert gr.n_split == 0 and gr.n_cloned == CAP - N and gr.n_dropped == N - (CAP - N)
    assert_states_equal(want, got, touched_atol=0)


def test_densify_ignores_screen_radius():
    """A huge all-time screen radius must not cull, and the radii come out zero."""
    jst, tst = make_states()
    jst = dataclasses.replace(jst, max_radii2d=jnp.full_like(jst.max_radii2d, 1e6))
    tst = dataclasses.replace(tst, max_radii2d=torch.full_like(tst.max_radii2d, 1e6))
    n0 = int(tst.scene.alive.sum())
    # extent large enough that the world-size prune cannot fire; threshold huge: nothing densifies
    want, wr, got, gr = run_both(jst, tst, 1e9, 0.0, 100.0, 20, 0.01, seed=0)
    assert_reports_equal(wr, gr)
    assert gr == tdensify.DensifyReport(0, 0, 0, 0, n0)
    assert int(got.scene.alive.sum()) == n0 and float(got.max_radii2d.max()) == 0.0
    assert_states_equal(want, got, touched_atol=0)


def test_densify_and_prune_draws_from_its_generator():
    _, tst = make_states()
    args = (1e-4, 0.5, EXTENT, 0, 0.024)
    a, ra = tdensify.densify_and_prune(tst, *args, torch.Generator().manual_seed(3))
    b, rb = tdensify.densify_and_prune(tst, *args, torch.Generator().manual_seed(3))
    c, _ = tdensify.densify_and_prune(tst, *args, torch.Generator().manual_seed(4))
    assert ra == rb and ra.n_split > 0
    np.testing.assert_array_equal(_np(a.scene.means), _np(b.scene.means))
    assert not np.array_equal(_np(a.scene.means), _np(c.scene.means))
    # only the split parents and their children move; the rest, and all else, is the same
    np.testing.assert_array_equal(_np(a.scene.alive), _np(c.scene.alive))
    np.testing.assert_array_equal(_np(a.scene.log_scales), _np(c.scene.log_scales))
    eps = torch.randn((2, CAP, 3), generator=torch.Generator().manual_seed(3))
    d, _ = tdensify.densify_with_noise(tst, *args, eps[0], eps[1])
    np.testing.assert_array_equal(_np(a.scene.means), _np(d.scene.means))


def test_reset_opacity_matches_jax():
    jst, tst = make_states()
    want, got = jdensify.reset_opacity(jst), tdensify.reset_opacity(tst)
    np.testing.assert_allclose(_np(got.scene.opacity_logits), np.asarray(want.scene.opacity_logits),
                               rtol=1e-6, atol=1e-6)
    opa = _np(got.scene.opacities)[_np(got.scene.alive)]
    assert (opa <= 0.0101).all()
    for k in PARAMS:
        np.testing.assert_array_equal(_np(got.opt.mu[k]), np.asarray(want.opt.mu[k]))
        np.testing.assert_array_equal(_np(got.opt.nu[k]), np.asarray(want.opt.nu[k]))
    assert np.abs(_np(got.opt.mu["opacity_logits"])).max() == 0.0
    assert np.abs(_np(got.opt.mu["means"])).max() > 0.0


# ---- checkpoints ----------------------------------------------------------------

CHECKPOINT_KEYS = (
    ["__meta__", "scene/alive", "opt/count", "step", "max_radii2d", "xyz_grad_accum", "denom"]
    + [f"scene/{k}" for k in PARAMS] + [f"opt/mu/{k}" for k in PARAMS] + [f"opt/nu/{k}" for k in PARAMS]
)


def _npz(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def test_checkpoint_round_trip_through_both_packages(tmp_path):
    """JAX saves -> port loads -> port saves -> JAX loads: the same keys,
    dtypes and bits all the way."""
    jst, _ = make_states()
    jst = dataclasses.replace(jst, scene=dataclasses.replace(jst.scene, active_sh_degree=1))
    jckpt.save_checkpoint(tmp_path / "jax.npz", jst, 123, spatial_lr_scale=2.5)
    tst, iteration, extent = tckpt.load_checkpoint(tmp_path / "jax.npz", device="cpu")
    assert (iteration, extent) == (123, 2.5)
    assert (tst.step, tst.opt.count, tst.scene.active_sh_degree, tst.scene.max_sh_degree) == (7, 7, 1, 1)
    tckpt.save_checkpoint(tmp_path / "port.npz", tst, 123, spatial_lr_scale=2.5)
    a, b = _npz(tmp_path / "jax.npz"), _npz(tmp_path / "port.npz")
    assert sorted(a) == sorted(b) == sorted(CHECKPOINT_KEYS)
    assert json.loads(str(a["__meta__"])) == json.loads(str(b["__meta__"])) == dict(
        iteration=123, capacity=CAP, active_sh_degree=1, max_sh_degree=1, spatial_lr_scale=2.5, format_version=1)
    for k in a:
        if k == "__meta__":
            continue
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["scene/alive"].dtype == bool and a["step"].dtype == np.int32 and a["opt/count"].dtype == np.int32
    back, it2, ext2 = jckpt.load_checkpoint(tmp_path / "port.npz")
    assert (it2, ext2) == (123, 2.5) and back.scene.active_sh_degree == 1
    want, got = _jax_state_to_numpy(jst), _jax_state_to_numpy(back)
    for k in PARAMS:
        np.testing.assert_array_equal(got["scene"][k], want["scene"][k])
        np.testing.assert_array_equal(got["mu"][k], want["mu"][k])
        np.testing.assert_array_equal(got["nu"][k], want["nu"][k])
    np.testing.assert_array_equal(got["scene"]["alive"], want["scene"]["alive"])
    for k in convert.STAT_FIELDS:
        np.testing.assert_array_equal(got[k], want[k])


def test_checkpoint_refuses_a_wrong_shape_or_a_missing_array(tmp_path):
    _, tst = make_states()
    tckpt.save_checkpoint(tmp_path / "ok.npz", tst, 5)
    arrays = _npz(tmp_path / "ok.npz")
    bad = dict(arrays)
    bad["scene/quats"] = bad["scene/quats"][:, :3]
    np.savez(tmp_path / "shape.npz", **bad)
    with pytest.raises(ValueError, match="scene/quats"):
        tckpt.load_checkpoint(tmp_path / "shape.npz", device="cpu")
    with pytest.raises(ValueError, match="scene/quats"):
        jckpt.load_checkpoint(tmp_path / "shape.npz")
    del bad["scene/quats"]
    np.savez(tmp_path / "missing.npz", **bad)
    with pytest.raises(KeyError, match="scene/quats"):
        tckpt.load_checkpoint(tmp_path / "missing.npz", device="cpu")
    state, it, extent = tckpt.load_checkpoint(tmp_path / "ok.npz", device="cpu")
    assert it == 5 and extent == 1.0 and state.capacity == CAP
