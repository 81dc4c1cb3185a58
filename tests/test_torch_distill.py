"""PyTorch port vs the JAX package: the SH distillation step.

A degree-3 teacher (the JAX suite's 256-Gaussian scene with its
view-dependent colour amplified sixfold, as
tests/test_render_eval.py::test_distill_truncates_and_improves does, and 64
dead slots) and a degree-1 student made from it by `init_student`, with
numpy-seeded noise on colour and position so that the loss is large enough
for a relative tolerance (about 0.1; see tests/test_torch_train_step.py).
Both packages distil from one state carried across
(`convert.train_state_from_numpy`) on the same cameras at 96x64, jittered as
the distillation CLI jitters them (`gaussian_pose`, translation sd 0.05, no
rotation, on 2 of 3 steps), from generators of the same seed. The JAX step
runs its Pallas kernels in interpret mode; the port runs the plain versions
of its kernels.

Tolerances (float32):
- the loss: rel 1e-6 after 1 step and at each of 10 steps;
- Adam's first moment (0.1 x the gradient): 5e-5 after dividing by the JAX
  field's largest magnitude, after 1 and after 10 steps;
- the parameters after 1 step within 2 learning rates everywhere and 1e-3
  learning rates where the gradient is above 1e-3 of its largest (Adam's
  first step is lr times the gradient's sign, which a gradient at rounding
  level may flip); after 10 steps within 20 learning rates, the median at
  most 1e-2 learning rates;
- the frozen fields (scaling, rotation, opacity): bit-unchanged.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgaussian_tpu.config import OptimizationParams as JOpt
from lightgaussian_tpu.models.camera import Camera as JCamera
from lightgaussian_tpu.render import poses as jposes
from lightgaussian_tpu.train import distill as jdistill
from lightgaussian_tpu.train import optim as joptim
from lightgaussian_tpu.train import state as jstate
from lightgaussian_tpu.utils import synthetic as jsyn
from lightgaussian_tpu_torch import convert
from lightgaussian_tpu_torch.config import OptimizationParams as TOpt
from lightgaussian_tpu_torch.models.camera import Camera as TCamera
from lightgaussian_tpu_torch.render import poses as tposes
from lightgaussian_tpu_torch.train import distill as tdistill

torch.set_num_threads(1)

W, H = 96, 64
MAX_INST = 1 << 14
N, CAP = 256, 320
SPATIAL = 1.0
STEPS = 10
PARAMS = ("means", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logits")
FROZEN = ("log_scales", "quats", "opacity_logits")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _state_to_numpy(s) -> dict:
    scene = {k: np.asarray(getattr(s.scene, k)) for k in PARAMS}
    scene.update(alive=np.asarray(s.scene.alive), active_sh_degree=s.scene.active_sh_degree,
                 max_sh_degree=s.scene.max_sh_degree)
    return dict(
        scene=scene, mu={k: np.asarray(v) for k, v in s.opt.mu.items()},
        nu={k: np.asarray(v) for k, v in s.opt.nu.items()}, count=int(s.opt.count), step=int(s.step),
        max_radii2d=np.asarray(s.max_radii2d), xyz_grad_accum=np.asarray(s.xyz_grad_accum),
        denom=np.asarray(s.denom),
    )


class World:
    """The teacher in both packages, the student's start state, the jittered
    cameras of 10 steps and the JAX states after each step."""

    def __init__(self, teacher_fast: bool, steps: int):
        teacher = jsyn.random_scene(n=N, seed=1, capacity=CAP, active_sh_degree=3)
        self.jteacher = dataclasses.replace(teacher, sh_rest=teacher.sh_rest * 6.0)
        self.tteacher = convert.scene_from_numpy(
            {k: np.asarray(getattr(self.jteacher, k)) for k in PARAMS}, np.asarray(self.jteacher.alive),
            3, 3, device="cpu")
        student = jdistill.init_student(self.jteacher, 1)
        rng = np.random.default_rng(11)
        noisy = {}
        for k, sd in (("sh_dc", 0.6), ("means", 0.05)):
            v = np.array(getattr(student, k))
            v[:N] += rng.normal(0.0, sd, v[:N].shape).astype(np.float32)
            noisy[k] = jnp.asarray(v)
        self.state0 = jstate.init_train_state(student.with_params({**student.params(), **noisy}))
        jrng, trng = np.random.default_rng(0), np.random.default_rng(0)
        self.jcams, self.tcams = [], []
        for i in range(steps):
            eye = [3.0 * np.sin(0.7 * i), 0.3, -3.0 * np.cos(0.7 * i)]
            jc = JCamera.look_at(eye=eye, target=[0, 0, 0], width=W, height=H)
            tc = TCamera.look_at(eye=eye, target=[0, 0, 0], width=W, height=H, device="cpu")
            if (i + 1) % 3 != 0:
                jc = jposes.gaussian_pose(jc, jrng, std_translation=0.05, std_rotation=0.0)
                tc = tposes.gaussian_pose(tc, trng, std_translation=0.05, std_rotation=0.0)
            self.jcams.append(jc)
            self.tcams.append(tc)
        self.teacher_fast = teacher_fast
        self.lr = {k: float(f(0)) for k, f in joptim.make_lr_fns(JOpt(), SPATIAL).items()}
        step = jdistill.make_distill_step(JOpt(), SPATIAL, MAX_INST, interpret=True, teacher_fast=teacher_fast)
        self.jstates, self.jmetrics = [self.state0], []
        for cam in self.jcams:
            s, m = step(self.jstates[-1], self.jteacher, cam, jnp.zeros(3))
            self.jstates.append(s)
            self.jmetrics.append(m)

    def port_run(self):
        state = convert.train_state_from_numpy(_state_to_numpy(self.state0), device="cpu")
        step = tdistill.make_distill_step(TOpt(), SPATIAL, MAX_INST, teacher_fast=self.teacher_fast)
        states, metrics = [state], []
        for cam in self.tcams:
            state, m = step(state, self.tteacher, cam, torch.zeros(3))
            states.append(state)
            metrics.append(m)
        return states, metrics


@pytest.fixture(scope="module")
def world():
    w = World(teacher_fast=False, steps=STEPS)
    w.port_states, w.port_metrics = w.port_run()
    return w


def _hold_moments(state, js):
    for k in PARAMS:
        if k in FROZEN:
            continue
        want = np.asarray(js.opt.mu[k])
        scale = np.abs(want).max()
        assert scale > 0, k
        np.testing.assert_allclose(_np(state.opt.mu[k]) / scale, want / scale, atol=5e-5, rtol=0, err_msg=k)


def test_init_student_matches_jax(world):
    tstudent = tdistill.init_student(world.tteacher, 1)
    jstudent = jdistill.init_student(world.jteacher, 1)
    assert (tstudent.max_sh_degree, tstudent.active_sh_degree) == (jstudent.max_sh_degree, jstudent.active_sh_degree)
    assert tuple(tstudent.sh_rest.shape) == (CAP, 3, 3)
    np.testing.assert_array_equal(_np(tstudent.sh_rest), np.asarray(jstudent.sh_rest))


def _hold_one_step(world, states, metrics):
    state, m = states[1], metrics[0]
    jm, js = world.jmetrics[0], world.jstates[1]
    assert float(jm.loss) > 0.05
    assert float(m.loss) == pytest.approx(float(jm.loss), rel=1e-6)
    assert float(m.l1) == pytest.approx(float(jm.l1), rel=1e-6)
    assert float(m.psnr) == pytest.approx(float(jm.psnr), abs=1e-4)
    assert m.num_instances == int(jm.num_instances) and int(m.n_visible) == int(jm.n_visible)
    _hold_moments(state, js)
    for k in PARAMS:
        if k in FROZEN:
            continue
        g = np.abs(np.asarray(js.opt.mu[k]))
        d = np.abs(_np(state.scene.params()[k]) - np.asarray(getattr(js.scene, k)))
        assert d.max() <= 2 * world.lr[k], k
        strong = g > 1e-3 * g.max()
        assert d[strong].max() <= 1e-3 * world.lr[k], k
    assert state.step == 1


def test_one_step_matches_jax(world):
    _hold_one_step(world, world.port_states, world.port_metrics)


def test_one_step_with_the_fast_teacher_matches_jax():
    w = World(teacher_fast=True, steps=1)
    _hold_one_step(w, *w.port_run())


def test_ten_steps_match_jax(world):
    for i, (m, jm) in enumerate(zip(world.port_metrics, world.jmetrics)):
        assert float(m.loss) == pytest.approx(float(jm.loss), rel=1e-6), f"step {i + 1}"
    state, js = world.port_states[-1], world.jstates[-1]
    _hold_moments(state, js)
    for k in PARAMS:
        d = np.abs(_np(state.scene.params()[k]) - np.asarray(getattr(js.scene, k)))
        assert d.max() <= 20 * world.lr[k], k
        assert np.median(d) <= 1e-2 * world.lr[k], k
    assert state.step == STEPS
    # the learning-rate multiplier of the finetune drivers, 0.9 every 500 steps
    from lightgaussian_tpu_torch.utils.general import exponential_decay_every

    fn = exponential_decay_every(0.9, 500)
    assert float(fn(0)) == 1.0 and abs(float(fn(1500)) - 0.9**3) < 1e-6


def test_frozen_fields_stay_and_the_rest_moves(world):
    start = world.port_states[0].scene
    end = world.port_states[-1].scene
    for f in FROZEN:
        assert torch.equal(getattr(end, f), getattr(start, f)), f
        np.testing.assert_array_equal(_np(getattr(end, f)), np.asarray(getattr(world.jstates[-1].scene, f)))
    for f in ("means", "sh_dc", "sh_rest"):
        assert not torch.equal(getattr(end, f), getattr(start, f)), f
    dead = ~_np(end.alive)
    for k in PARAMS:
        np.testing.assert_array_equal(_np(getattr(end, k))[dead], _np(getattr(start, k))[dead])


def test_distillation_lowers_the_loss():
    """The JAX suite's check: on a ring of 4 cameras, the student's last
    epoch beats its first."""
    teacher = jsyn.random_scene(n=200, seed=3, extent=0.8, scale_range=(0.03, 0.1), active_sh_degree=3)
    teacher = convert.scene_from_numpy({k: np.asarray(getattr(teacher, k)) * (6.0 if k == "sh_rest" else 1.0)
                                        for k in PARAMS}, np.asarray(teacher.alive), 3, 3, device="cpu")
    from lightgaussian_tpu_torch.train.state import init_train_state

    state = init_train_state(tdistill.init_student(teacher, 2))
    step = tdistill.make_distill_step(TOpt(), 1.0, MAX_INST)
    cams = [TCamera.look_at((2.5 * math.cos(t), 0.4, 2.5 * math.sin(t)), (0, 0, 0), fovx=0.9, width=64,
                            height=48, device="cpu") for t in np.linspace(0, 2 * np.pi, 4, endpoint=False)]
    seq = []
    for i in range(16):
        state, m = step(state, teacher, cams[i % 4], torch.zeros(3))
        seq.append(float(m.loss))
    assert np.mean(seq[-4:]) < np.mean(seq[:4])
