"""PyTorch port vs the JAX package: the multi-device paths (`parallel/`).

The port runs one process per device. Here the devices are gloo processes
on the CPU, spawned with `torch.multiprocessing` and joined through a
`FileStore` under the test's temporary directory, one thread each (the
suite runs in several pytest workers at once). All the work of one world
size runs in one spawn (a module fixture), and rank 0 hands its results
back in a file; the JAX side runs here, on the 8 virtual CPU devices of
`tests/conftest.py`, with its Pallas kernels in interpret mode. JAX is
imported inside the test functions only, so the spawned ranks never load
it.

For each entry point one mesh shape is held against the JAX mesh function
at the same shape, on the same scene, cameras and ground truth; the other
shapes are held against the port's own single-device path (which
`tests/test_torch_train_step.py`, `test_torch_batched_step.py`,
`test_torch_gss.py` and `test_torch_rasterize.py` hold against JAX).

Tolerances:
- the two training steps against the single-device batched step: params
  rtol 2e-4, atol 2e-5 (the JAX suite's); cached ground-truth SSIM moments
  against the plain path 1e-6;
- against the JAX mesh steps: the rule of the one-step test
  (`test_torch_train_step.py`) for a step across packages: Adam's first
  moment within 5e-5 of the field's largest, parameters within 2 lr
  everywhere and within 1e-3 lr where the JAX gradient exceeds 1e-3 of the
  field's largest (Adam's first step is lr times the gradient's sign, and
  a gradient at rounding-noise level may flip it between the packages).
  The JAX mesh steps' gradients are the number of strips times the mean
  loss's (the transpose of their image all_gather sums the strip ranks'
  identical cotangents; Adam's update does not see the factor), so the
  first moment and the densification sum are held against JAX's over that
  number, and the port's equal the single-device step's;
- the GSS sweep: counts equal, importance 1e-5 (the JAX suite's);
- the strip renderer: images and final_T 1e-5 (the JAX suite's).
"""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lightgaussian_tpu_torch.config import OptimizationParams
from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.ops import losses
from lightgaussian_tpu_torch.ops.rasterize import render
from lightgaussian_tpu_torch.parallel import (
    comm,
    gather_state,
    make_gauss_mesh,
    make_gauss_train_step,
    make_mesh,
    make_parallel_render,
    make_parallel_train_step,
    parallel_render,
    shard_state,
)
from lightgaussian_tpu_torch.parallel.gss import accumulate_gss_sharded, pad_cameras
from lightgaussian_tpu_torch.parallel.mesh import init_rank, is_multi_process
from lightgaussian_tpu_torch.train import gss as tgss
from lightgaussian_tpu_torch.train.state import init_train_state
from lightgaussian_tpu_torch.train.step import make_train_step
from lightgaussian_tpu_torch.utils.synthetic import random_scene

REPO = Path(__file__).resolve().parents[1]
H, W = 64, 96
MAX_INST = 8192
PARAMS = ("means", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logits")
BG = np.zeros(3, np.float32)

# (data, space) shapes of the strip step held against the single-device
# step, per world size; (2, 2) is held against the JAX mesh too
STRIP_SHAPES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (4, 1), (1, 4))}
GAUSS_SHAPES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}
RENDER_SHAPES = {2: ((1, 2),), 4: ((2, 2), (1, 4))}
GSS_CASES = {2: (((2, 1), 7),), 4: (((4, 1), 5), ((2, 2), 4))}


# ---- what the ranks and the tests share (no JAX) -------------------------

def _cameras(n_cams: int, width: int = W, height: int = H) -> list[Camera]:
    out = []
    for i in range(n_cams):
        ang = 2 * np.pi * i / n_cams
        out.append(Camera.look_at(eye=[3.5 * np.sin(ang), -0.3, -3.5 * np.cos(ang)], target=[0, 0, 0],
                                  width=width, height=height, device="cpu"))
    return out


def _gt_scene():
    return random_scene(n=128, seed=3, capacity=256, device="cpu")


def _batch(n_cams: int, with_gt: bool = True):
    """The JAX suite's batch: cameras on a ring around its 128-Gaussian
    scene, with that scene's (clipped) exact renders as ground truth."""
    scene, bg = _gt_scene(), torch.from_numpy(BG)
    cams = _cameras(n_cams)
    if with_gt:
        cams = [c.with_gt(torch.clamp(render(scene, c, bg, max_instances=MAX_INST).render, 0, 1)) for c in cams]
    return scene, cams, bg


def _student(seed: int = 7):
    return random_scene(n=96, seed=seed, capacity=128, device="cpu")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _state_arrays(state, prefix: str) -> dict:
    out = {f"{prefix}/{k}": _np(v) for k, v in state.scene.params().items()}
    out.update({f"{prefix}/mu/{k}": _np(v) for k, v in state.opt.mu.items()})
    for k in ("max_radii2d", "xyz_grad_accum", "denom"):
        out[f"{prefix}/{k}"] = _np(getattr(state, k))
    out[f"{prefix}/alive"] = _np(state.scene.alive)
    return out


def _single_device_step(cams, bg, steps: int = 1):
    """The port's single-device step over the same camera batch: the
    batched step (one Adam update on the mean loss), the plain step for one
    camera."""
    state = init_train_state(_student())
    step = make_train_step(OptimizationParams(), 1.0, MAX_INST, camera_batch=len(cams))
    for _ in range(steps):
        state, m = step(state, cams if len(cams) > 1 else cams[0], bg)
    return state, m


# ---- the ranks' work ------------------------------------------------------

def _strip_jobs(world: int) -> dict:
    out = {}
    for data, space in STRIP_SHAPES[world]:
        _, cams, bg = _batch(data)
        mesh = make_mesh(data=data, space=space)
        step = make_parallel_train_step(OptimizationParams(), 1.0, MAX_INST, mesh, H)
        state, m = step(init_train_state(_student()), cams, bg)
        tag = f"strip{data}x{space}"
        out.update(_state_arrays(state, tag))
        out[f"{tag}/loss"] = _np(m.loss)
        out[f"{tag}/step"] = np.asarray(state.step)
        if (data, space) == (2, 2):
            cached = [c.with_gt_ssim_stats(losses.precompute_ssim_target_stats(c.gt_image)) for c in cams]
            s_c, m_c = step(init_train_state(_student()), cached, bg)
            out.update(_state_arrays(s_c, "strip_cached"))
            out["strip_cached/loss"] = _np(m_c.loss)
            state, losses_seen = init_train_state(_student(seed=11)), []
            for _ in range(10):
                state, m = step(state, cams, bg)
                losses_seen.append(float(m.loss))
            out["strip_losses"] = np.asarray(losses_seen)
    return out


def _gauss_jobs(world: int) -> dict:
    out = {}
    for data, gauss in GAUSS_SHAPES[world]:
        _, cams, bg = _batch(data)
        mesh = make_gauss_mesh(data=data, gauss=gauss)
        step = make_gauss_train_step(OptimizationParams(), 1.0, MAX_INST, mesh, H)
        state, m = step(shard_state(init_train_state(_student()), mesh), cams, bg)
        tag = f"gauss{data}x{gauss}"
        out.update(_state_arrays(gather_state(state, mesh), tag))
        out[f"{tag}/loss"] = _np(m.loss)
        out[f"{tag}/n_visible"] = _np(m.n_visible)
        if (data, gauss) == (1, world):
            state, losses_seen = shard_state(init_train_state(_student(seed=11)), mesh), []
            for _ in range(10):
                state, m = step(state, cams, bg)
                losses_seen.append(float(m.loss))
            out["gauss_losses"] = np.asarray(losses_seen)
            full = init_train_state(_student())
            back = gather_state(shard_state(full, mesh), mesh)
            out.update(_state_arrays(back, "round_trip"))
    return out


def _render_jobs(world: int) -> dict:
    out = {}
    for data, space in RENDER_SHAPES[world]:
        scene, cams, bg = _batch(data, with_gt=False)
        mesh = make_mesh(data=data, space=space)
        for fast in (False, True):
            images, final_t = make_parallel_render(mesh, W, H, MAX_INST, fast=fast)(scene, cams, bg)
            out[f"render{data}x{space}/{fast}/images"] = _np(images)
            out[f"render{data}x{space}/{fast}/final_t"] = _np(final_t)
    if world == 4:
        h, w = 41, 96
        scene, bg = _gt_scene(), torch.from_numpy(BG)
        cam = Camera.look_at(eye=[0.5, -0.3, -3.5], target=[0, 0, 0], width=w, height=h, device="cpu")
        images, final_t = make_parallel_render(make_mesh(data=1, space=4), w, h, MAX_INST)(scene, [cam], bg)
        out["odd/images"], out["odd/final_t"] = _np(images), _np(final_t)
        scene, cams, bg = _batch(3, with_gt=False)
        out["padded"] = _np(torch.stack(parallel_render(scene, cams, bg, mesh=make_mesh(data=2, space=2),
                                                        max_instances=MAX_INST)))
    else:
        scene, cams, bg = _batch(1, with_gt=False)
        out["empty"] = np.asarray(len(parallel_render(scene, [], bg, max_instances=MAX_INST)))
        other = Camera.look_at(eye=[0.0, 0.0, -3.5], target=[0, 0, 0], width=W // 2, height=H, device="cpu")
        try:
            parallel_render(scene, [cams[0], other], bg, max_instances=MAX_INST)
            out["mixed"] = np.asarray("")
        except ValueError as e:
            out["mixed"] = np.asarray(str(e))
        out.update(_mixed_set_job(world, scene, [cams[0], other], bg))
    return out


def _mixed_set_job(world: int, scene, cams, bg) -> dict:
    """`render_set` of mixed resolutions (the strip renderer takes one) in
    a directory of each rank's own: what each rank wrote, and rank 0's
    PNGs."""
    import tempfile

    from lightgaussian_tpu_torch.render.sets import render_set
    from lightgaussian_tpu_torch.utils import image_io

    out = {}
    with tempfile.TemporaryDirectory() as d:
        render_set(d, "test", 1, cams, scene, bg, MAX_INST)
        pngs = sorted(Path(d).rglob("*.png"))
        for i, png in enumerate(pngs):
            out[f"mixed_set/png{i}"] = image_io.read_image(png)
        written = [str(png.relative_to(d)) for png in pngs]
    per_rank = [None] * world
    dist.all_gather_object(per_rank, written)
    out["mixed_set/written"] = np.asarray([len(w) for w in per_rank])
    out["mixed_set/names"] = np.asarray(per_rank[0])
    return out


def _gss_jobs(world: int) -> dict:
    out = {}
    for (data, space), n_cams in GSS_CASES[world]:
        scene, cams, bg = _batch(n_cams)
        live = []
        counts, imp = accumulate_gss_sharded(make_mesh(data=data, space=space), scene, cams, bg, MAX_INST,
                                             live_counts=live)
        tag = f"gss{data}x{space}_{n_cams}"
        out[f"{tag}/counts"], out[f"{tag}/imp"], out[f"{tag}/live"] = _np(counts), _np(imp), np.asarray(live)
    if world == 2:
        scene, cams, bg = _batch(5)
        assert is_multi_process()
        stats = [c.with_gt_ssim_stats(losses.precompute_ssim_target_stats(c.gt_image)) for c in cams]
        counts, imp = tgss.accumulate_gss_auto(scene, stats, bg, MAX_INST)
        out["auto/counts"], out["auto/imp"] = _np(counts), _np(imp)
    return out


def _comm_jobs(world: int) -> dict:
    """The two gathers' backwards, and the mesh's layout."""
    mesh = make_mesh(data=1, space=world)
    r = comm.axis_index(mesh, "space")
    x = torch.full((2, 3), float(r + 1), requires_grad=True)
    full = comm.gather_strips(x, mesh, "space", dim=0)
    # the same cotangent on every rank, as the same loss on the same image gives
    (full * torch.arange(full.numel(), dtype=torch.float32).reshape(full.shape)).sum().backward()
    strips = comm.all_gather(x.grad, mesh, "space", dim=0)
    y = torch.full((2, 3), float(r + 1), requires_grad=True)
    # a different cotangent on every rank: rank r weighs the rows by r + 1
    (comm.gather_shards(y, mesh, "space") * float(r + 1)).sum().backward()
    shards = comm.all_gather(y.grad, mesh, "space", dim=0)
    grid = make_mesh(data=2, space=world // 2)
    coords = comm.all_gather(torch.tensor([[dist.get_rank(), comm.axis_index(grid, "data"),
                                            comm.axis_index(grid, "space")]]), grid, "space", dim=0)
    coords = comm.all_gather(coords, grid, "data", dim=0)
    try:
        make_mesh(data=world, space=2)
        too_big = ""
    except ValueError as e:
        too_big = str(e)
    return {"comm/strips": _np(strips), "comm/full": _np(full), "comm/shards": _np(shards),
            "comm/coords": _np(coords), "comm/too_big": np.asarray(too_big)}


def _parallel_jobs(world: int, rank: int) -> dict:
    out = {}
    for job in (_comm_jobs, _strip_jobs, _gauss_jobs, _render_jobs, _gss_jobs):
        out.update(job(world))
    return out if rank == 0 else {}


def _rank_main(rank: int, world: int, store: str, out_dir: str, job) -> None:
    torch.set_num_threads(1)
    init_rank(rank, world, store, "cpu")
    try:
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **job(world, rank))
    finally:
        dist.destroy_process_group()


def spawn_ranks(out_dir, world: int, job) -> list[dict]:
    """Run `job(world, rank)` in `world` gloo processes; returns each
    rank's dict of arrays. `job` is a module-level function of a module
    that does not import JAX."""
    mp.spawn(_rank_main, args=(world, str(out_dir / "store"), str(out_dir), job), nprocs=world, join=True)
    out = []
    for r in range(world):
        with np.load(out_dir / f"rank{r}.npz") as f:
            out.append({k: f[k] for k in f.files})
    return out


def _spawn(tmp_path_factory, world: int) -> dict:
    return spawn_ranks(tmp_path_factory.mktemp(f"world{world}"), world, _parallel_jobs)[0]


# ---- the sharded codebook fit's ranks (its tests are in test_torch_compress.py)

FIT = dict(rows=2003, dim=27, codes=32, chunk=256, iterations=40, k_expire=4)
PAD_FIT = dict(rows=5, dim=8, codes=4, chunk=8, iterations=60, k_expire=1)


def fit_data(rows: int, dim: int, padding_case: bool = False):
    """(features, importance) of the sharded-fit tests, from a seed."""
    rng = np.random.default_rng(5)
    if padding_case:
        # near one point far from the origin, zero importance (the unit-weight fallback)
        return (np.full((rows, dim), 10.0, np.float32) + rng.normal(size=(rows, dim)).astype(np.float32) * 0.01,
                np.zeros(rows, np.float32))
    return rng.normal(size=(rows, dim)).astype(np.float32), rng.random(rows).astype(np.float32)


def fit_job(world: int, rank: int) -> dict:
    """Rank r's draws and each EMA step's state in and out of the sharded
    fit at FIT, and the fit at PAD_FIT."""
    from lightgaussian_tpu_torch.compress import vq
    from lightgaussian_tpu_torch.utils import threefry

    mesh = make_mesh(data=world, space=1)
    out, steps = {}, []
    ema = vq._ema_step

    def recorded(state, chunk, weight, k_expire, mesh=None, axis="data"):
        new = ema(state, chunk, weight, k_expire, mesh, axis)
        steps.append((chunk, weight, state, new))
        return new

    feats, imp = (torch.from_numpy(a) for a in fit_data(FIT["rows"], FIT["dim"]))
    key0 = threefry.prng_key(0)
    state0 = vq.init_codebook(key0, FIT["codes"], FIT["dim"], feats=feats)
    vq._ema_step = recorded
    try:
        fit = vq.train_codebook_sharded(mesh, key0, state0, feats, imp, iterations=FIT["iterations"],
                                        chunk=FIT["chunk"], k_expire=FIT["k_expire"])
    finally:
        vq._ema_step = ema
    for i, (chunk, weight, s_in, s_out) in enumerate(steps):
        out[f"chunk{i}"], out[f"weight{i}"] = _np(chunk), _np(weight)
        for name, s in (("in", s_in), ("out", s_out)):
            for f in ("embed", "embed_avg", "cluster_size"):
                out[f"{name}{i}/{f}"] = _np(getattr(s, f))
    out["fit/embed"] = _np(fit.embed)
    feats, imp = (torch.from_numpy(a) for a in fit_data(PAD_FIT["rows"], PAD_FIT["dim"], padding_case=True))
    key1 = threefry.prng_key(1)
    state0 = vq.init_codebook(key1, PAD_FIT["codes"], PAD_FIT["dim"], feats=feats)
    out["pad/embed"] = _np(vq.train_codebook_sharded(mesh, key1, state0, feats, imp, iterations=PAD_FIT["iterations"],
                                                     chunk=PAD_FIT["chunk"], k_expire=PAD_FIT["k_expire"]).embed)
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _spawn(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn(tmp_path_factory, 4)


@pytest.fixture(scope="module")
def worlds(world2, world4):
    return {2: world2, 4: world4}


# ---- the JAX side --------------------------------------------------------

def _jax_batch(cams):
    """The port's cameras (with their ground truth) as JAX cameras."""
    import jax.numpy as jnp
    from lightgaussian_tpu.models.camera import Camera as JCamera

    out = []
    for c in cams:
        jc = JCamera(world_view=jnp.asarray(_np(c.world_view)), full_proj=jnp.asarray(_np(c.full_proj)),
                     camera_center=jnp.asarray(_np(c.camera_center)), tan_fovx=jnp.float32(_np(c.tan_fovx)),
                     tan_fovy=jnp.float32(_np(c.tan_fovy)), width=c.width, height=c.height)
        out.append(jc.with_gt(jnp.asarray(_np(c.gt_image))) if c.gt_image is not None else jc)
    return out


def _jax_scene(n, seed, capacity):
    from lightgaussian_tpu.utils.synthetic import random_scene as jrandom_scene

    return jrandom_scene(n=n, seed=seed, capacity=capacity)


def _hold_against_jax(got: dict, tag: str, js, lr: dict, n_strips: int) -> None:
    """The one-step rule across packages (module docstring). The JAX mesh
    step's gradients are `n_strips` times the mean loss's: the transpose of
    its image all_gather sums the strip ranks' identical cotangents. Adam's
    update does not see a constant factor; its first moment and the
    densification gradient sum do, so they are held against the JAX ones
    over `n_strips`."""
    from lightgaussian_tpu.train import optim as joptim

    for k in PARAMS:
        want_mu = np.asarray(js.opt.mu[k]) / n_strips
        scale = np.abs(want_mu).max()
        if scale == 0:  # sh_rest at SH degree 0 over the whole step
            np.testing.assert_array_equal(got[f"{tag}/mu/{k}"], want_mu)
            continue
        np.testing.assert_allclose(got[f"{tag}/mu/{k}"] / scale, want_mu / scale, atol=5e-5, rtol=0, err_msg=k)
        g = np.abs(want_mu / (1.0 - joptim.BETA1))
        d = np.abs(got[f"{tag}/{k}"] - np.asarray(getattr(js.scene, k)))
        assert d.max() <= 2 * lr[k], k
        strong = g > 1e-3 * g.max()
        assert d[strong].max() <= 1e-3 * lr[k], k
    np.testing.assert_array_equal(got[f"{tag}/denom"], np.asarray(js.denom))
    np.testing.assert_array_equal(got[f"{tag}/max_radii2d"], np.asarray(js.max_radii2d))
    accum = np.asarray(js.xyz_grad_accum) / n_strips
    np.testing.assert_allclose(got[f"{tag}/xyz_grad_accum"] / accum.max(), accum / accum.max(), atol=5e-5, rtol=0)


def _jax_lr() -> dict:
    from lightgaussian_tpu.config import OptimizationParams as JOpt
    from lightgaussian_tpu.train import optim as joptim

    return {k: float(f(0)) for k, f in joptim.make_lr_fns(JOpt(), 1.0).items()}


def _hold_against_single_device(got: dict, tag: str, state) -> None:
    for k in PARAMS:
        np.testing.assert_allclose(got[f"{tag}/{k}"], _np(state.scene.params()[k]), rtol=2e-4, atol=2e-5,
                                   err_msg=f"param {k} for {tag}")
    np.testing.assert_array_equal(got[f"{tag}/denom"], _np(state.denom))
    np.testing.assert_array_equal(got[f"{tag}/max_radii2d"], _np(state.max_radii2d))
    np.testing.assert_allclose(got[f"{tag}/xyz_grad_accum"], _np(state.xyz_grad_accum), rtol=2e-4, atol=2e-5)


# ---- the tests ------------------------------------------------------------

def test_mesh_needs_a_process_group():
    """No emulation of several devices in one process."""
    assert not is_multi_process()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(data=1, space=1)


def test_init_rank_defaults_to_the_card(tmp_path, monkeypatch):
    """Like every entry point of the port, joining a group asks for CUDA
    unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_rank(0, 1, str(tmp_path / "store"))
    assert not dist.is_initialized()


def test_mesh_layout_and_gathers(world4):
    w = world4
    # ranks row-major over (data, space) = (2, 2), as JAX's devices[:4].reshape(2, 2)
    coords = w["comm/coords"].reshape(4, 3)
    np.testing.assert_array_equal(coords[np.argsort(coords[:, 0])], [[0, 0, 0], [1, 0, 1], [2, 1, 0], [3, 1, 1]])
    assert "mesh 4x2 > 4 processes" in str(w["comm/too_big"])
    # the strip gather hands each rank its own rows' cotangent, once (not summed over the ranks)
    n = w["comm/full"].size
    np.testing.assert_array_equal(w["comm/strips"].reshape(-1), np.arange(n, dtype=np.float32))
    # the shard gather's backward sums the ranks' cotangents: (1 + 2 + 3 + 4) on every row
    np.testing.assert_array_equal(w["comm/shards"], np.full((8, 3), 10.0, np.float32))


@pytest.mark.parametrize("world,shape", [(2, s) for s in STRIP_SHAPES[2]] + [(4, s) for s in STRIP_SHAPES[4]])
def test_strip_step_matches_single_device(worlds, world, shape):
    data, space = shape
    _, cams, bg = _batch(data)
    state, m = _single_device_step(cams, bg)
    got = worlds[world]
    _hold_against_single_device(got, f"strip{data}x{space}", state)
    assert float(got[f"strip{data}x{space}/loss"]) == pytest.approx(float(m.loss), rel=1e-5)
    assert int(got[f"strip{data}x{space}/step"]) == 1


def test_strip_step_matches_jax_mesh(world4):
    """(2, 2) against `lightgaussian_tpu.parallel.make_parallel_train_step`
    on a JAX mesh of the same shape."""
    from lightgaussian_tpu.config import OptimizationParams as JOpt
    from lightgaussian_tpu.models.camera import stack_cameras as jstack
    from lightgaussian_tpu.parallel import make_mesh as jmake_mesh
    from lightgaussian_tpu.parallel import make_parallel_train_step as jstep
    from lightgaussian_tpu.train.state import init_train_state as jinit

    import jax.numpy as jnp

    _, cams, _ = _batch(2)
    step = jstep(JOpt(), 1.0, max_instances=MAX_INST, mesh=jmake_mesh(data=2, space=2), image_height=H,
                 interpret=True)
    js, jm = step(jinit(_jax_scene(96, 7, 128)), jstack(_jax_batch(cams)), jnp.asarray(BG))
    _hold_against_jax(world4, "strip2x2", js, _jax_lr(), n_strips=2)
    assert float(world4["strip2x2/loss"]) == pytest.approx(float(jm.loss), rel=1e-5)


def test_strip_step_cached_gt_ssim_matches_plain(world4):
    w = world4
    assert float(w["strip_cached/loss"]) == pytest.approx(float(w["strip2x2/loss"]), abs=1e-6)
    for k in PARAMS:
        np.testing.assert_allclose(w[f"strip_cached/{k}"], w[f"strip2x2/{k}"], atol=1e-6, err_msg=k)


def test_strip_step_lowers_the_loss(world4):
    seen = world4["strip_losses"]
    assert np.isfinite(seen).all() and seen[-1] < seen[0]


@pytest.mark.parametrize("world,shape", [(2, s) for s in GAUSS_SHAPES[2]] + [(4, s) for s in GAUSS_SHAPES[4]])
def test_gauss_step_matches_single_device(worlds, world, shape):
    data, gauss = shape
    _, cams, bg = _batch(data)
    state, m = _single_device_step(cams, bg)
    got = worlds[world]
    _hold_against_single_device(got, f"gauss{data}x{gauss}", state)
    assert float(got[f"gauss{data}x{gauss}/loss"]) == pytest.approx(float(m.loss), rel=1e-5)
    assert int(got[f"gauss{data}x{gauss}/n_visible"]) == int(m.n_visible)


def test_gauss_step_matches_jax_mesh(world4):
    """(2, 2) against `lightgaussian_tpu.parallel.make_gauss_train_step`."""
    import jax.numpy as jnp

    from lightgaussian_tpu.config import OptimizationParams as JOpt
    from lightgaussian_tpu.models.camera import stack_cameras as jstack
    from lightgaussian_tpu.parallel.gauss import gather_state as jgather
    from lightgaussian_tpu.parallel.gauss import make_gauss_mesh as jmesh
    from lightgaussian_tpu.parallel.gauss import make_gauss_train_step as jstep
    from lightgaussian_tpu.parallel.gauss import shard_state as jshard
    from lightgaussian_tpu.train.state import init_train_state as jinit

    mesh = jmesh(data=2, gauss=2)
    _, cams, _ = _batch(2)
    step = jstep(JOpt(), 1.0, max_instances=MAX_INST, mesh=mesh, image_height=H, interpret=True)
    js, jm = step(jshard(jinit(_jax_scene(96, 7, 128)), mesh), jstack(_jax_batch(cams)), jnp.asarray(BG))
    _hold_against_jax(world4, "gauss2x2", jgather(js), _jax_lr(), n_strips=2)
    assert float(world4["gauss2x2/loss"]) == pytest.approx(float(jm.loss), rel=1e-5)


def test_gauss_step_lowers_the_loss(worlds):
    for w in worlds.values():
        seen = w["gauss_losses"]
        assert np.isfinite(seen).all() and seen[-1] < seen[0]


def test_shard_and_gather_state_round_trip(world4):
    want = init_train_state(_student())
    for k, v in _state_arrays(want, "round_trip").items():
        np.testing.assert_array_equal(world4[k], v, err_msg=k)


def test_shard_state_needs_a_divisible_capacity(monkeypatch):
    monkeypatch.setattr(comm, "axis_size", lambda mesh, axis: 4)
    state = init_train_state(random_scene(n=10, seed=0, capacity=10, device="cpu"))
    with pytest.raises(ValueError, match="not divisible by gauss=4"):
        shard_state(state, mesh=None)


@pytest.mark.parametrize("world,shape", [(2, s) for s in RENDER_SHAPES[2]] + [(4, s) for s in RENDER_SHAPES[4]])
def test_parallel_render_matches_single_device(worlds, world, shape):
    data, space = shape
    scene, cams, bg = _batch(data, with_gt=False)
    got = worlds[world]
    for fast in (False, True):
        images = got[f"render{data}x{space}/{fast}/images"]
        final_t = got[f"render{data}x{space}/{fast}/final_t"]
        assert images.shape == (data, 3, H, W) and final_t.shape == (data, H, W)
        for i, cam in enumerate(cams):
            ref = render(scene, cam, bg, max_instances=MAX_INST, fast=fast)
            np.testing.assert_allclose(images[i], _np(ref.render), atol=1e-5, err_msg=f"{shape} {fast} {i}")
            np.testing.assert_allclose(final_t[i], _np(ref.final_T), atol=1e-5, err_msg=f"{shape} {fast} {i}")


def test_parallel_render_matches_jax_mesh(world4):
    """(1, 4) against `lightgaussian_tpu.parallel.make_parallel_render`."""
    import jax.numpy as jnp

    from lightgaussian_tpu.models.camera import stack_cameras as jstack
    from lightgaussian_tpu.parallel import make_mesh as jmake_mesh
    from lightgaussian_tpu.parallel import make_parallel_render as jrender

    _, cams, _ = _batch(1, with_gt=False)
    for fast in (False, True):
        fn = jrender(jmake_mesh(data=1, space=4), W, H, max_instances=MAX_INST, interpret=True, fast=fast)
        images, final_t = fn(_jax_scene(128, 3, 256), jstack(_jax_batch(cams)), jnp.asarray(BG))
        np.testing.assert_allclose(world4[f"render1x4/{fast}/images"], np.asarray(images), atol=1e-5)
        np.testing.assert_allclose(world4[f"render1x4/{fast}/final_t"], np.asarray(final_t), atol=1e-5)


def test_parallel_render_odd_height(world4):
    """41 rows over 4 strips of 11: the last strip renders past the image
    and is cropped after the gather."""
    scene, bg = _gt_scene(), torch.from_numpy(BG)
    cam = Camera.look_at(eye=[0.5, -0.3, -3.5], target=[0, 0, 0], width=96, height=41, device="cpu")
    ref = render(scene, cam, bg, max_instances=MAX_INST, fast=True)
    assert world4["odd/images"].shape == (1, 3, 41, 96)
    np.testing.assert_allclose(world4["odd/images"][0], _np(ref.render), atol=1e-5)
    np.testing.assert_allclose(world4["odd/final_t"][0], _np(ref.final_T), atol=1e-5)


def test_parallel_render_list_padding(world4):
    scene, cams, bg = _batch(3, with_gt=False)
    got = world4["padded"]
    assert got.shape[0] == 3
    for img, cam in zip(got, cams):
        np.testing.assert_allclose(img, _np(render(scene, cam, bg, max_instances=MAX_INST, fast=True).render),
                                   atol=1e-5)


def test_parallel_render_edge_inputs(world2):
    assert int(world2["empty"]) == 0
    assert "single resolution" in str(world2["mixed"])


def test_render_set_of_mixed_resolutions_is_rank_0s(world2, tmp_path):
    """Under a group, a set the strip renderer cannot take (mixed
    resolutions) is rendered and written by rank 0 alone, as one process
    would write it."""
    from lightgaussian_tpu_torch.render.sets import render_set
    from lightgaussian_tpu_torch.utils import image_io

    scene, cams, bg = _batch(1, with_gt=False)
    other = Camera.look_at(eye=[0.0, 0.0, -3.5], target=[0, 0, 0], width=W // 2, height=H, device="cpu")
    render_set(tmp_path, "test", 1, [cams[0], other], scene, bg, MAX_INST)
    want = sorted(tmp_path.rglob("*.png"))
    np.testing.assert_array_equal(world2["mixed_set/written"], [len(want), 0])
    assert list(world2["mixed_set/names"]) == [str(p.relative_to(tmp_path)) for p in want]
    for i, png in enumerate(want):
        np.testing.assert_array_equal(world2[f"mixed_set/png{i}"], image_io.read_image(png))


@pytest.mark.parametrize("world,case", [(2, c) for c in GSS_CASES[2]] + [(4, c) for c in GSS_CASES[4]])
def test_sharded_gss_matches_sequential(worlds, world, case):
    (data, space), n_cams = case
    scene, cams, bg = _batch(n_cams)
    live = []
    counts, imp = tgss.accumulate_gss(scene, cams, bg, MAX_INST, live_counts=live)
    got = worlds[world]
    tag = f"gss{data}x{space}_{n_cams}"
    np.testing.assert_array_equal(got[f"{tag}/counts"], _np(counts))
    np.testing.assert_allclose(got[f"{tag}/imp"], _np(imp), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[f"{tag}/live"], live)
    assert int(_np(counts).sum()) > 0, "vacuous sweep"


def test_sharded_gss_matches_jax_mesh(world2):
    """(2, 1) over 7 cameras (one padding camera) against
    `lightgaussian_tpu.parallel.accumulate_gss_sharded`."""
    import jax.numpy as jnp

    from lightgaussian_tpu.parallel import make_mesh as jmake_mesh
    from lightgaussian_tpu.parallel.gss import accumulate_gss_sharded as jsweep

    _, cams, _ = _batch(7)
    counts, imp = jsweep(jmake_mesh(data=2, space=1), _jax_scene(128, 3, 256), _jax_batch(cams),
                         jnp.asarray(BG), MAX_INST, interpret=True)
    np.testing.assert_array_equal(world2["gss2x1_7/counts"], np.asarray(counts))
    # the JAX suite's counting tolerance across packages (tests/test_torch_gss.py), per camera
    np.testing.assert_allclose(world2["gss2x1_7/imp"], np.asarray(imp), atol=1e-4 * len(cams), rtol=0)


def test_pad_cameras_weights():
    cams = _cameras(3)
    padded, w = pad_cameras(cams, 4)
    assert len(padded) == 4 and padded[3] is cams[0]
    np.testing.assert_array_equal(_np(w), [1, 1, 1, 0])
    with pytest.raises(ValueError):
        pad_cameras([], 2)


def test_accumulate_gss_auto_dispatches_to_the_sharded_sweep(world2):
    scene, cams, bg = _batch(5)
    counts, imp = tgss.accumulate_gss(scene, cams, bg, MAX_INST)
    np.testing.assert_array_equal(world2["auto/counts"], _np(counts))
    np.testing.assert_allclose(world2["auto/imp"], _np(imp), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cli", ["train_densify_prune", "prune_finetune", "distill_train"])
def test_trainers_refuse_several_processes(monkeypatch, cli):
    import importlib

    monkeypatch.setenv("WORLD_SIZE", "2")
    mod = importlib.import_module(f"lightgaussian_tpu_torch.cli.{cli}")
    with pytest.raises(SystemExit, match="trains in one process"):
        mod.main(["-s", "nowhere", "-m", "nowhere", "--device", "cpu"])


def test_render_sets_under_torchrun(tmp_path):
    """`torchrun --standalone --nproc_per_node=2 -m ...cli.render_sets
    --device cpu`: the CLI joins torchrun's gloo group, renders each test
    view in strips over the two processes, and rank 0 writes PNGs equal to
    a one-process run's within one 8-bit level (the strips regroup float32
    sums, and rounding may put a 1e-6 difference on either side of a
    level). The train views are of two resolutions, which the strip
    renderer does not take: rank 0 renders them alone, as one process
    does."""
    import shutil
    import subprocess
    import sys

    from lightgaussian_tpu_torch.cli import render_sets
    from lightgaussian_tpu_torch.data.ply import save_gaussian_ply, store_point_cloud
    from lightgaussian_tpu_torch.render.poses import c2w_from_camera
    from lightgaussian_tpu_torch.utils import image_io

    src, one, two = tmp_path / "scene", tmp_path / "one", tmp_path / "two"
    rng = np.random.default_rng(0)
    for split, n in (("train", 2), ("test", 3)):
        frames = []
        for i, cam in enumerate(_cameras(n, width=40, height=40)):
            h = 32 if (split, i) == ("train", 1) else 40
            image_io.write_png(src / split / f"r_{i}.png", rng.integers(0, 256, (h, 40, 3), dtype=np.uint8))
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w_from_camera(cam, blender=True).tolist()})
        (src / f"transforms_{split}.json").write_text(json.dumps({"camera_angle_x": 0.9, "frames": frames}))
    store_point_cloud(src / "points3d.ply", rng.normal(0, 0.5, (50, 3)), rng.random((50, 3)) * 255)
    save_gaussian_ply(random_scene(n=300, seed=5, extent=0.8, scale_range=(0.03, 0.1), device="cpu"),
                      one / "point_cloud" / "iteration_7" / "point_cloud.ply")
    shutil.copytree(one, two)
    argv = ["-s", str(src), "--eval", "--quiet", "--device", "cpu"]
    render_sets.main(["-m", str(one), *argv])
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2", "-m",
                           "lightgaussian_tpu_torch.cli.render_sets", "-m", str(two), *argv],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count(f"Rendering {two}") == 1  # rank 1 prints nothing
    for split, n, level in (("test", 3, 1), ("train", 2, 0)):
        for d in ("renders", "gt"):
            got = sorted((two / split / "ours_7" / d).glob("*.png"))
            want = sorted((one / split / "ours_7" / d).glob("*.png"))
            assert [p.name for p in got] == [p.name for p in want] and len(got) == n
            for g, w in zip(got, want):
                diff = np.abs(image_io.read_image(g).astype(int) - image_io.read_image(w).astype(int))
                assert diff.max() <= level, (split, g.name, diff.max())
    shapes = {image_io.read_image(p).shape for p in (two / "train" / "ours_7" / "renders").glob("*.png")}
    assert shapes == {(32, 40, 3), (40, 40, 3)}
