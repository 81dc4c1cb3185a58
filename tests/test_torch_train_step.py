"""PyTorch port vs the JAX package: the training step, Adam, the train state
and the evaluation render.

A student scene (the JAX suite's 256-Gaussian scene with numpy-seeded noise
on colour, opacity and position, and 64 dead slots) is trained against
renders of the clean scene from three cameras at 96x64, with the cached
ground-truth SSIM moments, in both packages from one state carried across
(`convert.train_state_from_numpy`). The JAX step runs its Pallas kernels in
interpret mode; the port's step runs the plain versions of its kernels.

The noise is large (loss about 0.14) so that rel 1e-6 on the loss stays
above the float32 rounding of its two means: the JAX package's float32 means
of the L1 and SSIM maps here are 3e-7 to 4e-7 off their float64 values,
torch's 2e-8, and over ten steps the losses of the two packages differ by
1e-7 to 6e-7 relative (a student at loss 0.03 gave 2e-6).

Tolerances (float32):
- after 1 step: loss rel 1e-6; Adam's first moment (0.1 x the gradient)
  and the densification gradient sum 5e-5 after dividing by the JAX field's
  largest magnitude (the blend's own tolerance); `denom` and `max_radii2d`
  exactly (integer work on identical splats). Parameters within 2 lr of the
  field everywhere, and within 1e-3 lr wherever the JAX gradient exceeds
  1e-3 of the field's largest: Adam's first step is lr times the sign of
  the gradient, so a gradient at rounding-noise level may flip its sign
  between the packages and move its parameter 2 lr apart, and nowhere else
  may they differ by more than rounding.
- after 10 steps: loss rel 1e-4; parameters within 20 lr everywhere, with
  the median difference at most 1e-2 lr.
"""
import dataclasses
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgaussian_tpu.config import OptimizationParams as JOpt
from lightgaussian_tpu.models.camera import Camera as JCamera
from lightgaussian_tpu.ops import losses as jl
from lightgaussian_tpu.ops.rasterize import render as jrender
from lightgaussian_tpu.train import optim as joptim
from lightgaussian_tpu.train import state as jstate
from lightgaussian_tpu.train import step as jstep
from lightgaussian_tpu.utils import synthetic as jsyn
from lightgaussian_tpu_torch import convert
from lightgaussian_tpu_torch.config import OptimizationParams as TOpt
from lightgaussian_tpu_torch.models.camera import Camera as TCamera
from lightgaussian_tpu_torch.ops import losses as tl
from lightgaussian_tpu_torch.train import optim as toptim
from lightgaussian_tpu_torch.train import state as tstate
from lightgaussian_tpu_torch.ops.rasterize import render as trender
from lightgaussian_tpu_torch.train import step as tstep
from lightgaussian_tpu_torch.utils import stage_marks

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
W, H = 96, 64
MAX_INST = 1 << 14
N, CAP = 256, 320
SPATIAL = 1.0
PARAMS = ("means", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logits")


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


class World:
    """Cameras with ground truth in both packages, the JAX student state,
    and the JAX states after 1 and 10 steps."""

    def __init__(self):
        bg = np.zeros(3, np.float32)
        self.jbg, self.tbg = jnp.asarray(bg), torch.from_numpy(bg)
        target = jsyn.random_scene(n=N, seed=1)
        self.jcams, self.tcams = [], []
        for i in range(3):
            eye = [4.0 * np.sin(0.4 * i), -0.2 + 0.1 * i, -4.0 * np.cos(0.4 * i)]
            jc = JCamera.look_at(eye=eye, target=[0, 0, 0], width=W, height=H)
            tc = TCamera.look_at(eye=eye, target=[0, 0, 0], width=W, height=H, device="cpu")
            gt = np.clip(np.asarray(jrender(target, jc, self.jbg, method="reference").render), 0.0, 1.0)
            jc = jc.with_gt(jnp.asarray(gt))
            tc = tc.with_gt(torch.from_numpy(gt))
            self.jcams.append(jc.with_gt_ssim_stats(jl.precompute_ssim_target_stats(jc.gt_image)))
            self.tcams.append(tc.with_gt_ssim_stats(tl.precompute_ssim_target_stats(tc.gt_image)))

        student = jsyn.random_scene(n=N, seed=1, capacity=CAP)
        rng = np.random.default_rng(11)
        noisy = {}
        for k, sd in (("sh_dc", 1.0), ("opacity_logits", 2.0), ("means", 0.1)):
            v = np.array(getattr(student, k))
            v[:N] += rng.normal(0.0, sd, v[:N].shape).astype(np.float32)
            noisy[k] = jnp.asarray(v)
        self.state0 = jstate.init_train_state(student.with_params({**student.params(), **noisy}))
        self.opt = JOpt()
        step = jstep.make_train_step(self.opt, SPATIAL, MAX_INST, interpret=True)
        self.lr = {k: float(f(0)) for k, f in joptim.make_lr_fns(self.opt, SPATIAL).items()}
        self.jstates, self.jmetrics = [self.state0], []
        for i in range(10):
            s, m = step(self.jstates[-1], self.jcams[i % 3], self.jbg)
            self.jstates.append(s)
            self.jmetrics.append(m)

    def port_run(self, steps):
        state = convert.train_state_from_numpy(_jax_state_to_numpy(self.state0), device="cpu")
        step = tstep.make_train_step(TOpt(), SPATIAL, MAX_INST)
        metrics = []
        for i in range(steps):
            state, m = step(state, self.tcams[i % 3], self.tbg)
            metrics.append(m)
        return state, metrics


@pytest.fixture(scope="module")
def world():
    return World()


@pytest.fixture(scope="module")
def port10(world):
    return world.port_run(10)


def _jgrad(world, k):
    """The JAX gradient of the first step, from Adam's first moment."""
    return np.asarray(world.jstates[1].opt.mu[k]) / (1.0 - joptim.BETA1)


def test_one_step_matches_jax(world):
    state, (m,) = world.port_run(1)
    jm, js = world.jmetrics[0], world.jstates[1]
    assert float(m.loss) == pytest.approx(float(jm.loss), rel=1e-6)
    assert float(m.l1) == pytest.approx(float(jm.l1), rel=1e-6)
    assert float(m.psnr) == pytest.approx(float(jm.psnr), abs=1e-4)
    assert m.num_instances == int(jm.num_instances) and int(m.n_visible) == int(jm.n_visible)
    for k in PARAMS:
        for name, got, want in (("mu", state.opt.mu[k], js.opt.mu[k]), ("nu", state.opt.nu[k], js.opt.nu[k])):
            want = np.asarray(want)
            scale = np.abs(want).max()
            assert scale > 0, k
            # nu holds squared gradients: its normalised error is twice mu's
            atol = 5e-5 if name == "mu" else 1e-4
            np.testing.assert_allclose(_np(got) / scale, want / scale, atol=atol, rtol=0, err_msg=f"{name}[{k}]")
        g = np.abs(_jgrad(world, k))
        d = np.abs(_np(state.scene.params()[k]) - np.asarray(getattr(js.scene, k)))
        lr = world.lr[k]
        assert d.max() <= 2 * lr, k
        strong = g > 1e-3 * g.max()
        assert strong.sum() > 0.5 * (g > 0).sum(), k
        assert d[strong].max() <= 1e-3 * lr, k
    np.testing.assert_array_equal(_np(state.denom), np.asarray(js.denom))
    np.testing.assert_array_equal(_np(state.max_radii2d), np.asarray(js.max_radii2d))
    accum = np.asarray(js.xyz_grad_accum)
    np.testing.assert_allclose(_np(state.xyz_grad_accum) / accum.max(), accum / accum.max(), atol=5e-5, rtol=0)
    assert (_np(state.xyz_grad_accum)[:N] > 0).sum() > 0.5 * N
    assert state.step == 1 and state.opt.count == 1


def test_ten_steps_match_jax(world, port10):
    state, metrics = port10
    js = world.jstates[10]
    assert float(metrics[-1].loss) == pytest.approx(float(world.jmetrics[-1].loss), rel=1e-4)
    for k in PARAMS:
        d = np.abs(_np(state.scene.params()[k]) - np.asarray(getattr(js.scene, k)))
        assert d.max() <= 20 * world.lr[k], k
        assert np.median(d) <= 1e-2 * world.lr[k], k
    np.testing.assert_array_equal(_np(state.denom), np.asarray(js.denom))
    assert state.step == 10


def test_training_lowers_the_loss(world, port10):
    _, metrics = port10
    # the same camera, before and after nine steps
    assert float(metrics[9].loss) < float(metrics[0].loss)
    assert float(world.jmetrics[9].loss) < float(world.jmetrics[0].loss)


def test_dead_slots_stay_frozen(world, port10):
    state, _ = port10
    dead = ~_np(state.scene.alive)
    assert dead.sum() == CAP - N
    for k in PARAMS:
        np.testing.assert_array_equal(_np(state.scene.params()[k])[dead],
                                      np.asarray(getattr(world.state0.scene, k))[dead])
        np.testing.assert_array_equal(_np(state.opt.mu[k])[dead], 0.0)
    np.testing.assert_array_equal(_np(state.denom)[dead], 0.0)


def test_frozen_fields(world):
    state = convert.train_state_from_numpy(_jax_state_to_numpy(world.state0), device="cpu")
    frozen = ("log_scales", "quats", "opacity_logits")
    step = tstep.make_train_step(TOpt(), SPATIAL, MAX_INST, frozen_fields=frozen)
    s2, _ = step(state, world.tcams[0], world.tbg)
    for k in frozen:
        np.testing.assert_array_equal(_np(s2.scene.params()[k]), _np(state.scene.params()[k]))
        np.testing.assert_array_equal(_np(s2.opt.mu[k]), 0.0)
    for k in ("means", "sh_dc"):
        assert not np.array_equal(_np(s2.scene.params()[k]), _np(state.scene.params()[k]))
    assert s2.denom.sum() > 0
    # without the densification statistics the step leaves them as they were
    quiet = tstep.make_train_step(TOpt(), SPATIAL, MAX_INST, update_densify_stats=False)
    s3, _ = quiet(s2, world.tcams[1], world.tbg)
    for k in convert.STAT_FIELDS:
        np.testing.assert_array_equal(_np(getattr(s3, k)), _np(getattr(s2, k)))
    assert not np.array_equal(_np(s3.scene.means), _np(s2.scene.means))


def test_lr_mult_leaves_means_alone_and_adam_matches_jax(world):
    scene = world.state0.scene
    params = {k: np.array(v) for k, v in scene.params().items()}
    rng = np.random.default_rng(12)
    grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    alive = np.array(scene.alive)
    j_lr = joptim.make_lr_fns(world.opt, SPATIAL)
    t_lr = toptim.make_lr_fns(TOpt(), SPATIAL)
    jo = joptim.init_adam({k: jnp.asarray(v) for k, v in params.items()})
    to = toptim.init_adam({k: torch.from_numpy(v) for k, v in params.items()})
    out = {}
    for mult in (1.0, 0.5):
        jp, jo2 = joptim.adam_update({k: jnp.asarray(v) for k, v in params.items()},
                                     {k: jnp.asarray(v) for k, v in grads.items()}, jo, j_lr,
                                     jnp.int32(3), jnp.asarray(alive), mult)
        tp, to2 = toptim.adam_update({k: torch.from_numpy(v) for k, v in params.items()},
                                     {k: torch.from_numpy(v) for k, v in grads.items()}, to, t_lr,
                                     3, torch.from_numpy(alive), mult)
        for k in params:
            np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), atol=1e-7 * max(1.0, world.lr[k]), rtol=1e-6)
            np.testing.assert_array_equal(_np(to2.mu[k]), np.asarray(jo2.mu[k]))
        out[mult] = tp
    np.testing.assert_array_equal(_np(out[1.0]["means"]), _np(out[0.5]["means"]))
    assert not np.array_equal(_np(out[1.0]["sh_dc"]), _np(out[0.5]["sh_dc"]))
    # moment resets
    z = toptim.zero_moments_at(to2, torch.from_numpy(np.arange(CAP) < 10))
    jz = joptim.zero_moments_at(jo2, jnp.arange(CAP) < 10)
    z2, jz2 = toptim.zero_moments_field(to2, "opacity_logits"), joptim.zero_moments_field(jo2, "opacity_logits")
    for k in params:
        np.testing.assert_array_equal(_np(z.mu[k]), np.asarray(jz.mu[k]))
        np.testing.assert_array_equal(_np(z2.nu[k]), np.asarray(jz2.nu[k]))


def test_eval_render_matches_jax(world, port10):
    state, _ = port10
    js = world.jstates[10]
    j_eval = jstep.make_eval_render(MAX_INST, interpret=True)
    t_eval = tstep.make_eval_render(MAX_INST)
    for jc, tc in zip(world.jcams[:2], world.tcams[:2]):
        # the same scene in both: the JAX state after 10 steps
        scene = convert.train_state_from_numpy(_jax_state_to_numpy(js), device="cpu").scene
        jimg, jl1, jpsnr, jssim = j_eval(js.scene, jc, world.jbg)
        timg, tl1, tpsnr, tssim = t_eval(scene, tc, world.tbg)
        np.testing.assert_allclose(_np(timg), np.asarray(jimg), atol=2e-5, rtol=0)
        assert float(tl1) == pytest.approx(float(jl1), abs=1e-6)
        assert float(tpsnr) == pytest.approx(float(jpsnr), abs=1e-3)
        assert float(tssim) == pytest.approx(float(jssim), abs=1e-6)
        assert not timg.requires_grad
    # the trained port scene's eval is close to the JAX one's
    _, tl1, _, _ = t_eval(state.scene, world.tcams[0], world.tbg)
    assert float(tl1) == pytest.approx(float(j_eval(js.scene, world.jcams[0], world.jbg)[1]), rel=1e-3)


def test_train_state_round_trip(world):
    arrays = _jax_state_to_numpy(world.jstates[1])
    back = convert.train_state_to_numpy(convert.train_state_from_numpy(arrays, device="cpu"))
    assert back["count"] == arrays["count"] == 1 and back["step"] == arrays["step"] == 1
    for k in PARAMS:
        np.testing.assert_array_equal(back["scene"][k], arrays["scene"][k])
        np.testing.assert_array_equal(back["mu"][k], arrays["mu"][k])
        np.testing.assert_array_equal(back["nu"][k], arrays["nu"][k])
    np.testing.assert_array_equal(back["scene"]["alive"], arrays["scene"]["alive"])
    for k in convert.STAT_FIELDS:
        np.testing.assert_array_equal(back[k], arrays[k])
    assert back["scene"]["active_sh_degree"] == arrays["scene"]["active_sh_degree"]


def test_grow_capacity_matches_jax(world):
    j = jstate.grow_capacity(world.jstates[1], CAP + 128)
    t = tstate.grow_capacity(convert.train_state_from_numpy(_jax_state_to_numpy(world.jstates[1]), device="cpu"),
                             CAP + 128)
    want, got = _jax_state_to_numpy(j), convert.train_state_to_numpy(t)
    assert t.capacity == CAP + 128
    for k in PARAMS:
        np.testing.assert_array_equal(got["scene"][k], want["scene"][k])
        np.testing.assert_array_equal(got["mu"][k], want["mu"][k])
    np.testing.assert_array_equal(got["scene"]["alive"], want["scene"]["alive"])
    for k in convert.STAT_FIELDS:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        tstate.grow_capacity(t, CAP)


def test_scene_param_helpers_match_jax(world):
    js = world.state0.scene
    ts = convert.train_state_from_numpy(_jax_state_to_numpy(world.state0), device="cpu").scene
    assert set(ts.params()) == set(js.params())
    low = dataclasses.replace(ts, active_sh_degree=1)
    assert low.one_up_sh_degree().active_sh_degree == 2 and ts.one_up_sh_degree() is ts
    tt, jt = ts.truncate_sh(1), js.truncate_sh(1)
    assert (tt.max_sh_degree, tt.active_sh_degree) == (jt.max_sh_degree, jt.active_sh_degree)
    np.testing.assert_array_equal(_np(tt.sh_rest), np.asarray(jt.sh_rest))


def test_step_needs_gt_and_one_camera(world):
    state = convert.train_state_from_numpy(_jax_state_to_numpy(world.state0), device="cpu")
    step = tstep.make_train_step(TOpt(), SPATIAL, MAX_INST)
    bare = dataclasses.replace(world.tcams[0], gt_image=None)
    with pytest.raises(ValueError, match="ground-truth"):
        step(state, bare, world.tbg)
    batched = tstep.make_train_step(TOpt(), SPATIAL, MAX_INST, camera_batch=2)
    with pytest.raises(ValueError, match="takes 2 cameras"):
        batched(state, world.tcams[:1], world.tbg)
    with pytest.raises(ValueError, match="ground-truth"):
        batched(state, [world.tcams[0], bare], world.tbg)


class _OrderedEvent:
    """Stands in for torch.cuda.Event on the CPU: its time is its place in
    the order of recording."""

    recorded: list = []

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self):
        self.at = len(self.recorded)
        self.recorded.append(self)

    def elapsed_time(self, end):
        return float(end.at - self.at)


def test_step_and_render_mark_their_stages(world, monkeypatch):
    smoke_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(smoke_spec)
    smoke_spec.loader.exec_module(smoke)
    monkeypatch.setattr(torch.cuda, "Event", _OrderedEvent)
    state = convert.train_state_from_numpy(_jax_state_to_numpy(world.state0), device="cpu")
    step = tstep.make_train_step(TOpt(), SPATIAL, MAX_INST)
    # off by default: the step records nothing
    step(state, world.tcams[0], world.tbg)
    assert _OrderedEvent.recorded == [] and stage_marks.stop() == []
    # on: the stages chip_smoke.py splits the step and the served frame into, in order
    stage_marks.start()
    step(state, world.tcams[0], world.tbg)
    assert stage_marks.stop() == [(name, 1.0) for name in smoke.TRAIN_STAGES]
    stage_marks.start()
    with torch.no_grad():
        trender(state.scene, world.tcams[0], world.tbg, fast=True)
    assert [name for name, _ in stage_marks.stop()] == list(smoke.SERVE_STAGES)
    stage_marks.mark("after")
    assert len(_OrderedEvent.recorded) == 2 + len(smoke.TRAIN_STAGES) + len(smoke.SERVE_STAGES)


def test_training_modules_import_neither_jax_nor_the_jax_package():
    mods = ["lightgaussian_tpu_torch.train.optim", "lightgaussian_tpu_torch.train.state",
            "lightgaussian_tpu_torch.train.step", "lightgaussian_tpu_torch.ops.losses",
            "lightgaussian_tpu_torch.utils.cuda_build", "lightgaussian_tpu_torch.utils.stage_marks",
            "lightgaussian_tpu_torch.convert"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lightgaussian_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_positional_gradient_scale_on_a_larger_frame():
    """The densify statistic carries the 0.5 W and 0.5 H factors of NDC
    units: at 192x128 (24 tiles, non-square) one step's `xyz_grad_accum`
    equals JAX's within 5e-5 of its largest entry, as at 96x64."""
    w, h, n = 192, 128, 96
    bg = np.zeros(3, np.float32)
    target = jsyn.random_scene(n=n, seed=3)
    eye = [1.2, -0.3, -3.8]
    jc = JCamera.look_at(eye=eye, target=[0, 0, 0], width=w, height=h)
    tc = TCamera.look_at(eye=eye, target=[0, 0, 0], width=w, height=h, device="cpu")
    gt = np.clip(np.asarray(jrender(target, jc, jnp.asarray(bg), method="reference").render), 0.0, 1.0)
    student = jsyn.random_scene(n=n, seed=3, capacity=128)
    means = np.array(student.means)
    means[:n] += np.random.default_rng(4).normal(0.0, 0.1, (n, 3)).astype(np.float32)
    state0 = jstate.init_train_state(student.with_params({**student.params(), "means": jnp.asarray(means)}))
    js, _ = jstep.make_train_step(JOpt(), SPATIAL, MAX_INST, interpret=True)(
        state0, jc.with_gt(jnp.asarray(gt)), jnp.asarray(bg))
    ts, _ = tstep.make_train_step(TOpt(), SPATIAL, MAX_INST)(
        convert.train_state_from_numpy(_jax_state_to_numpy(state0), device="cpu"),
        tc.with_gt(torch.from_numpy(gt)), torch.from_numpy(bg))
    accum = np.asarray(js.xyz_grad_accum)
    assert (accum[:n] > 0).sum() > 0.5 * n
    np.testing.assert_allclose(_np(ts.xyz_grad_accum) / accum.max(), accum / accum.max(), atol=5e-5, rtol=0)
    np.testing.assert_array_equal(_np(ts.denom), np.asarray(js.denom))
