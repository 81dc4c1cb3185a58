"""Traffic `distill_ring`: SH distillation in a closed loop over a ring.

The configuration's Gaussians at their source SH degree are the teacher;
`train/distill.init_student` truncates them to the configuration's degree
for the student, whose fresh train state `train/distill.make_distill_step`
trains as `cli/distill_train` does with `--augmented_view
--enable_covariance`: opacity frozen, means, SH, scales and rotations
trained, the teacher rendered by the exact blend, the instance cut
`default_max_instances` of the student. Each step takes the next pose of a
fixed pool permuted by the seed (`inputs.pose_order`): every ring camera
`jitter_every` times, once as it is and otherwise with the eye and the point
it looks at moved together by a normal draw of sd `jitter_sd`, the CLI's
translation-only pose jitter on two steps of three. The first `checked` steps
run in set-up through the same call and are held against the reference, as
in `train_ring`.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import inputs, port
from perfbench.counting import step as counting
from perfbench.reference import camera as ref_camera
from perfbench.reference import compare
from perfbench.reference import render as R
from perfbench.reference import train as ref_train
from perfbench.traffic.train_ring import ORDER, Traffic as TrainRing

ORIGIN = np.zeros(3)
FROZEN = ("opacity_logits",)


class Traffic:
    unit = "step"
    gaps = staticmethod(TrainRing.gaps)

    def __init__(self, cfg: dict, spec: dict, seed: int, device: torch.device):
        from lightgaussian_tpu_torch.config import OptimizationParams
        from lightgaussian_tpu_torch.ops.rasterize import default_max_instances
        from lightgaussian_tpu_torch.train import distill
        from lightgaussian_tpu_torch.train.state import init_train_state

        self.cfg, self.spec, self.seed, self.device = cfg, spec, seed, device
        self.degree, self.teacher_degree = cfg["sh_degree"], cfg["source_sh_degree"]
        self.eyes = inputs.ring_eyes(cfg)
        self.extent = inputs.extent(self.eyes)
        self.order = inputs.pose_order(seed, len(self.eyes), ORDER, spec["jitter_sd"], spec["jitter_every"])
        p = inputs.gaussians(cfg, seed, device)
        self.teacher = port.scene(p, self.teacher_degree)
        self.state = init_train_state(distill.init_student(self.teacher, self.degree))
        self.cut = default_max_instances(self.state.scene)
        self.step_fn = distill.make_distill_step(OptimizationParams(), self.extent, self.cut, frozen_fields=FROZEN)
        self.done, self.recorded, self.recording = 0, [], False

        losses_seen = []
        for j in range(spec["checked"]):
            metrics = self._step()
            losses_seen.append(float(metrics.loss))
            if j == 0:
                self.prog_grad = compare.norms(self.state.opt.mu, 1.0 / (1.0 - ref_train.BETA1))
        student0 = inputs.truncate_sh(p, self.degree)
        self.prog = {"loss": losses_seen,
                     "change": compare.norms({k: v - student0[k] for k, v in self.state.scene.params().items()})}
        del p, student0
        for _ in range(spec["warmup"]):
            self._step()

    def eye_target(self, j: int):
        cam_i, d = self.order[j % ORDER]
        return self.eyes[cam_i] + d, ORIGIN + d

    def _step(self):
        eye, target = self.eye_target(self.done)
        if self.recording:
            self.recorded.append((self.state.scene.params(), self.done))
        cam = port.camera(eye, target, self.cfg, self.device)
        self.state, metrics = self.step_fn(self.state, self.teacher, cam, torch.zeros(3, device=self.device))
        self.done += 1
        return metrics

    def one(self) -> None:
        self._step()

    def e2e(self, times: list, wall: float) -> dict:
        return {"train_step_ms": 1e3 * wall / len(times)}

    def record(self, on: bool) -> None:
        self.recording = on

    def view(self, j: int):
        eye, target = self.eye_target(j)
        return ref_camera.look_at(eye, target, self.cfg["cameras"]["fovx"], self.cfg["width"], self.cfg["height"],
                                  self.device)

    def counted(self):
        kernels, total = {}, 0.0
        teacher = (self.teacher.params(), self.teacher_degree)
        for p, j in self.recorded:
            k, t = counting.train_step(p, self.degree, self.view(j), self.cut, moment_planes=15, stats=False,
                                       teacher=teacher)
            for name, s in k.items():
                kernels[name] = kernels.get(name, 0.0) + s
            total += t
        return kernels, total / max(len(self.recorded), 1)

    def close(self) -> None:
        self.state = self.teacher = self.step_fn = None
        self.recorded = []

    def reference(self, q=R.identity, fault: str | None = None) -> ref_train.Trainer:
        """The reference's run of the checked steps, from the same inputs."""
        p = inputs.gaussians(self.cfg, self.seed, self.device)
        student = inputs.truncate_sh(p, self.degree)
        trainer = ref_train.Trainer(student, self.degree, 0, self.extent, R.default_cut(p["means"].shape[0]), q=q,
                                    frozen=FROZEN, fault=fault)
        del student
        teacher = ({k: q(v) for k, v in p.items()}, self.teacher_degree)
        for j in range(self.spec["checked"]):
            trainer.run(self.view(j), None, torch.zeros(3, device=self.device), teacher=teacher)
        return trainer

    def summary(self, trainer: ref_train.Trainer) -> dict:
        s0 = inputs.truncate_sh(inputs.gaussians(self.cfg, self.seed, self.device), self.degree)
        change = compare.norms({k: trainer.p[k] - s0[k] for k in ref_train.FIELDS})
        return {"loss": trainer.losses, "grad": compare.norms(trainer.first_grad), "change": change}

    def check(self) -> dict:
        got = self.gaps({**self.prog, "grad": self.prog_grad}, self.summary(self.reference()))
        return {k: (v, self.spec["limits"][k]) for k, v in got.items()}
