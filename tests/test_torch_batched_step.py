"""PyTorch port vs the JAX package: camera-batched training
(`make_train_step(camera_batch=B)`, the loop and the trainer CLI).

The scene and cameras are `test_torch_train_loop.py`'s: a 48-Gaussian
student in 128 slots against renders of a target scene from 64x64 cameras,
handed to both packages as the same arrays. The JAX step runs its Pallas
kernels in interpret mode; the port's runs the plain versions of its
kernels. A port batch is a `list[Camera]`, JAX's a stacked pytree.

Held:
- the port's B=2 step against its own two single-camera gradients (the JAX
  suite's `test_batched_step_semantics`, atol 1e-6): one Adam update on the
  mean gradient, the densification sums the two single steps' increments,
  `denom` their sum, `max_radii2d` their maximum;
- the port's B=2 step against JAX's from one state, by the one-step rule
  across packages of `test_torch_train_step.py` (noted there: Adam's
  first step is lr times the gradient's sign, and a gradient at
  rounding-noise level may flip it, so atol 1e-6 holds only within one
  package): Adam's first moment and the densification sum within 5e-5 of
  the field's largest, parameters within 2 lr everywhere and 1e-3 lr where
  the gradient is strong, `denom` and `max_radii2d` equal, the loss rel 1e-5;
- frozen fields stay bit for bit; cached ground-truth SSIM moments give the
  plain step's update within 1e-6;
- the loop draws JAX's camera order for B=3 over 4 cameras (the same
  `random.Random(seed)` stack, without replacement, refilled when empty);
- the trainer CLI with `--camera_batch 2` at the JAX suite's flags
  (`tests/test_cli.py`): it saves, its test PSNR passes 8 dB, and its
  checkpoint counts optimizer steps.
"""
import csv
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgaussian_tpu.config import OptimizationParams as JOpt
from lightgaussian_tpu.config import TrainConfig as JTrainConfig
from lightgaussian_tpu.models.camera import stack_cameras as jstack
from lightgaussian_tpu.train import loop as jloop
from lightgaussian_tpu.train import optim as joptim
from lightgaussian_tpu.train import state as jstate
from lightgaussian_tpu.train import step as jstep
from lightgaussian_tpu_torch import config as tconfig
from lightgaussian_tpu_torch import convert
from lightgaussian_tpu_torch.cli import train_densify_prune as tcli
from lightgaussian_tpu_torch.models.camera import stack_cameras
from lightgaussian_tpu_torch.ops import losses as tl
from lightgaussian_tpu_torch.train import checkpoint as tckpt
from lightgaussian_tpu_torch.train import loop as tloop
from lightgaussian_tpu_torch.train import optim as toptim
from lightgaussian_tpu_torch.train import step as tstep
from lightgaussian_tpu_torch.utils import logging as tlogging
from test_torch_train_loop import PARAMS, FakeScene, _cameras, _jax_state_to_numpy, _student, _write_blender_dataset

torch.set_num_threads(1)

MAX_INST = 1 << 14
BG_J, BG_T = jnp.zeros(3), torch.zeros(3)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def world():
    target, student = _student()
    jcams, tcams = _cameras(4, 64, with_gt_of=target)
    state0 = jstate.init_train_state(student)
    return dict(jcams=jcams, tcams=tcams, jstate0=state0,
                tstate0=lambda: convert.train_state_from_numpy(_jax_state_to_numpy(state0), device="cpu"))


def test_camera_batch_helpers(world):
    """A batch is the plain list; the batched step checks it with
    `stack_cameras` and refuses mixed resolutions."""
    cams = world["tcams"]
    batch = stack_cameras(cams[:3])
    assert isinstance(batch, list) and len(batch) == 3 and batch[1] is cams[1]
    other = dataclasses.replace(cams[0], width=32)
    with pytest.raises(ValueError, match="one resolution"):
        stack_cameras([cams[0], other])
    step = tstep.make_train_step(tconfig.OptimizationParams(), 1.0, MAX_INST, camera_batch=2)
    with pytest.raises(ValueError, match="one resolution"):
        step(world["tstate0"](), [cams[0], other], BG_T)


def test_batched_step_semantics(world):
    """One Adam update on the mean of the cameras' gradients; densification
    statistics as two single-camera steps from the same state."""
    opt = tconfig.OptimizationParams()
    cams = world["tcams"][:2]
    state0 = world["tstate0"]()
    state_b, m_b = tstep.make_train_step(opt, 1.0, MAX_INST, camera_batch=2)(state0, cams, BG_T)

    single = tstep.make_train_step(opt, 1.0, MAX_INST)
    sa, ma = single(state0, cams[0], BG_T)
    sb, mb = single(state0, cams[1], BG_T)
    mean_g = {k: (sa.opt.mu[k] + sb.opt.mu[k]) / 2 / (1 - toptim.BETA1) for k in PARAMS}
    want, _ = toptim.adam_update(state0.scene.params(), mean_g, state0.opt, toptim.make_lr_fns(opt, 1.0),
                                 state0.step, state0.scene.alive, 1.0)
    for k in PARAMS:
        np.testing.assert_allclose(_np(state_b.scene.params()[k]), _np(want[k]), atol=1e-6, err_msg=k)
    inc = lambda s: _np(s.xyz_grad_accum - state0.xyz_grad_accum)  # noqa: E731
    np.testing.assert_allclose(inc(state_b), inc(sa) + inc(sb), atol=1e-6)
    np.testing.assert_array_equal(_np(state_b.denom - state0.denom),
                                  _np(sa.denom - state0.denom) + _np(sb.denom - state0.denom))
    np.testing.assert_allclose(_np(state_b.max_radii2d), np.maximum(_np(sa.max_radii2d), _np(sb.max_radii2d)),
                               atol=1e-6)
    assert float(m_b.loss) == pytest.approx((float(ma.loss) + float(mb.loss)) / 2, rel=1e-6)
    assert m_b.num_instances == max(ma.num_instances, mb.num_instances)
    assert state_b.step == 1 and state_b.opt.count == 1


def test_batched_step_matches_jax(world):
    opt = JOpt()
    js, jm = jstep.make_train_step(opt, 1.0, MAX_INST, interpret=True, camera_batch=2)(
        world["jstate0"], jstack(world["jcams"][:2]), BG_J)
    ts, tm = tstep.make_train_step(tconfig.OptimizationParams(), 1.0, MAX_INST, camera_batch=2)(
        world["tstate0"](), world["tcams"][:2], BG_T)
    lr = {k: float(f(0)) for k, f in joptim.make_lr_fns(opt, 1.0).items()}
    assert float(tm.loss) == pytest.approx(float(jm.loss), rel=1e-5)
    assert tm.num_instances == int(jm.num_instances) and int(tm.n_visible) == int(jm.n_visible)
    for k in PARAMS:
        want_mu = np.asarray(js.opt.mu[k])
        scale = np.abs(want_mu).max()
        assert scale > 0, k
        np.testing.assert_allclose(_np(ts.opt.mu[k]) / scale, want_mu / scale, atol=5e-5, rtol=0, err_msg=k)
        g = np.abs(want_mu)
        d = np.abs(_np(ts.scene.params()[k]) - np.asarray(getattr(js.scene, k)))
        assert d.max() <= 2 * lr[k], k
        assert d[g > 1e-3 * g.max()].max() <= 1e-3 * lr[k], k
    np.testing.assert_array_equal(_np(ts.denom), np.asarray(js.denom))
    np.testing.assert_array_equal(_np(ts.max_radii2d), np.asarray(js.max_radii2d))
    accum = np.asarray(js.xyz_grad_accum)
    np.testing.assert_allclose(_np(ts.xyz_grad_accum) / accum.max(), accum / accum.max(), atol=5e-5, rtol=0)


def test_batched_step_frozen_fields_and_cached_ssim(world):
    opt = tconfig.OptimizationParams()
    cams = world["tcams"][:2]
    state0 = world["tstate0"]()
    frozen = ("log_scales", "quats", "opacity_logits")
    s, _ = tstep.make_train_step(opt, 1.0, MAX_INST, frozen_fields=frozen, camera_batch=2)(state0, cams, BG_T)
    for k in frozen:
        assert torch.equal(s.scene.params()[k], state0.scene.params()[k]), k
    assert not torch.equal(s.scene.sh_dc, state0.scene.sh_dc)
    step = tstep.make_train_step(opt, 1.0, MAX_INST, camera_batch=2)
    plain, mp_ = step(state0, cams, BG_T)
    cached = [c.with_gt_ssim_stats(tl.precompute_ssim_target_stats(c.gt_image)) for c in cams]
    fast, mf = step(state0, cached, BG_T)
    assert float(mf.loss) == pytest.approx(float(mp_.loss), abs=1e-6)
    for k in PARAMS:
        np.testing.assert_allclose(_np(fast.scene.params()[k]), _np(plain.scene.params()[k]), atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="takes 2 cameras"):
        step(state0, cams[:1], BG_T)


def test_loop_draws_the_jax_camera_order(world, tmp_path, monkeypatch):
    """B=3 over 4 cameras for 5 iterations: each batch draws without
    replacement from the shuffled stack, refilled when it runs dry."""
    target, student = _student()
    iters, batch = 5, 3

    def centers(c):
        return tuple(np.round(_np(c.camera_center), 6))

    def run(mod, cams, state, bg, cfg, logger, **kw):
        seen = []
        index = {centers(c): i for i, c in enumerate(cams)}

        class Metrics:
            loss, num_instances = (torch.tensor(0.5) if mod is tloop else jnp.float32(0.5)), 0

        def fake_make_train_step(*args, **kwargs):
            def step(state, cam, bg):
                if mod is tloop:
                    seen.append([index[centers(c)] for c in cam])
                else:
                    seen.append([index[tuple(np.round(np.asarray(cam.camera_center[i]), 6))]
                                 for i in range(cam.camera_center.shape[0])])
                return state, Metrics()
            return step

        monkeypatch.setattr(mod, "make_train_step", fake_make_train_step)
        scene = FakeScene(tmp_path / mod.__name__, None, cams, cams[:1], lambda *a: None)
        mod.train(scene, cfg, bg, state=state, densify=False, logger=logger, seed=3, camera_batch=batch,
                  cache_gt_ssim=False, **kw)
        return seen

    jcfg = JTrainConfig(opt=JOpt(iterations=iters), test_iterations=[], save_iterations=[],
                        checkpoint_iterations=[], prune_iterations=[])
    tcfg = tconfig.TrainConfig(opt=tconfig.OptimizationParams(iterations=iters), test_iterations=[],
                               save_iterations=[], checkpoint_iterations=[], prune_iterations=[])
    from lightgaussian_tpu.utils.logging import MetricsLogger as JLogger

    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()

    jseen = run(jloop, world["jcams"], jstate.init_train_state(student), BG_J, jcfg,
                JLogger(tmp_path / "j", enable_tensorboard=False), max_instances=MAX_INST, interpret=True)
    tseen = run(tloop, world["tcams"], world["tstate0"](), BG_T, tcfg,
                tlogging.MetricsLogger(tmp_path / "t", enable_tensorboard=False), max_instances=MAX_INST)
    assert len(tseen) == iters and all(len(b) == batch for b in tseen)
    assert tseen == jseen
    # without replacement within a pass over the four cameras
    flat = sum(tseen, [])
    assert sorted(flat[:4]) == [0, 1, 2, 3] and sorted(flat[4:8]) == [0, 1, 2, 3]


def test_train_cli_with_camera_batch(tmp_path):
    """The JAX suite's `test_train_cli_camera_batch` flags: one optimizer
    step per two cameras, densification on, through the CLI."""
    data, model = tmp_path / "data", tmp_path / "model"
    _write_blender_dataset(data)
    tcli.main(["-s", str(data), "-m", str(model), "--eval", "--quiet", "--disable_viewer", "--device", "cpu",
               "--iterations", "12", "--camera_batch", "2", "--densify_from_iter", "4",
               "--densification_interval", "5", "--densify_until_iter", "10", "--opacity_reset_interval", "1000",
               "--test_iterations", "12", "--save_iterations", "12", "--checkpoint_iterations", "12",
               "--prune_iterations", "999", "--position_lr_max_steps", "12"])
    assert (model / "point_cloud/iteration_12/point_cloud.ply").exists()
    rows = [r for r in csv.DictReader(open(model / "metric.csv")) if r["set"] == "test"]
    assert rows and float(rows[-1]["psnr"]) > 8
    state, it, _ = tckpt.load_checkpoint(model / "chkpnt12.npz", device="cpu")
    assert it == 12 and state.step == 12  # optimizer steps, two cameras each
