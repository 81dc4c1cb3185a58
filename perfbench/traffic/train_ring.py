"""Traffic `train_ring`: the 3D-GS training step in a closed loop over a ring.

Set-up makes the configuration's Gaussians and the ring's targets from the
seed, gives each camera its target's SSIM moments as the trainer does, and
builds `train/step.make_train_step` as `train/loop.train` builds it: the
default OptimizationParams, the scene extent of the ring, Adam and the
densification statistics every step, the instance cut `default_max_instances`
grown as the loop grows it. The state starts at the cell's iteration with
fresh Adam moments. Each step takes the next camera of a seeded permutation
of the ring. The first `checked` steps run through the same call in set-up;
their losses, the first step's gradient (from Adam's first moment) and the
state after them are what the check holds against the reference, which runs
them again from the same inputs once the window has closed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench import inputs, port
from perfbench.counting import step as counting
from perfbench.reference import camera as ref_camera
from perfbench.reference import compare
from perfbench.reference import render as R
from perfbench.reference import train as ref_train

ORIGIN = np.zeros(3)
ORDER = 4096  # steps of camera order drawn; the window wraps round them


class Traffic:
    unit = "step"

    def __init__(self, cfg: dict, spec: dict, seed: int, device: torch.device):
        from lightgaussian_tpu_torch.config import OptimizationParams
        from lightgaussian_tpu_torch.ops import losses
        from lightgaussian_tpu_torch.ops.rasterize import default_max_instances
        from lightgaussian_tpu_torch.train.state import init_train_state
        from lightgaussian_tpu_torch.train.step import make_train_step

        self.cfg, self.spec, self.seed, self.device = cfg, spec, seed, device
        self.degree = cfg["sh_degree"]
        self.eyes = inputs.ring_eyes(cfg)
        self.extent = inputs.extent(self.eyes)
        self.order = inputs.pose_order(seed, len(self.eyes), ORDER)
        p = inputs.gaussians(cfg, seed, device)
        gts = inputs.targets(cfg, seed, len(self.eyes), device)
        self.cams = []
        for eye, gt in zip(self.eyes, gts):
            cam = port.camera(eye, ORIGIN, cfg, device).with_gt(gt)
            self.cams.append(cam.with_gt_ssim_stats(losses.precompute_ssim_target_stats(cam.gt_image)))
        self.opt = OptimizationParams()
        self.make = make_train_step
        self.state = dataclasses.replace(init_train_state(port.scene(p, self.degree)), step=spec["start_iteration"])
        self.cut = default_max_instances(self.state.scene)
        self.step_fn = self.make(self.opt, self.extent, self.cut, update_densify_stats=True)
        self.done, self.recorded, self.recording = 0, [], False

        losses_seen = []
        for j in range(spec["checked"]):
            metrics = self._step()
            losses_seen.append(float(metrics.loss))
            if j == 0:
                self.prog_grad = compare.norms(self.state.opt.mu, 1.0 / (1.0 - ref_train.BETA1))
        self.prog = {"loss": losses_seen,
                     "change": compare.norms({k: v - p[k] for k, v in self.state.scene.params().items()}),
                     "stats": self._stats(self.state.max_radii2d, self.state.xyz_grad_accum, self.state.denom)}
        del p, gts
        for _ in range(spec["warmup"]):
            self._step()

    @staticmethod
    def _stats(max_radii, accum, denom) -> dict:
        return compare.norms({"max_radii2d": max_radii, "xyz_grad_accum": accum, "denom": denom})

    def _step(self):
        cam_i = self.order[self.done % ORDER][0]
        if self.recording:
            self.recorded.append((self.state.scene.params(), cam_i, self.cut))
        self.state, metrics = self.step_fn(self.state, self.cams[cam_i], torch.zeros(3, device=self.device))
        grown = port.grown_cut(self.cut, metrics.num_instances)
        if grown != self.cut:
            self.cut = grown
            self.step_fn = self.make(self.opt, self.extent, self.cut, update_densify_stats=True)
        self.done += 1
        return metrics

    def one(self) -> None:
        self._step()

    def e2e(self, times: list, wall: float) -> dict:
        return {"train_step_ms": 1e3 * wall / len(times)}

    def record(self, on: bool) -> None:
        self.recording = on

    def view(self, cam_i: int):
        return ref_camera.look_at(self.eyes[cam_i], ORIGIN, self.cfg["cameras"]["fovx"], self.cfg["width"],
                                  self.cfg["height"], self.device)

    def counted(self):
        kernels, total = {}, 0.0
        for p, cam_i, cut in self.recorded:
            k, t = counting.train_step(p, self.degree, self.view(cam_i), cut, moment_planes=9, stats=True)
            for name, s in k.items():
                kernels[name] = kernels.get(name, 0.0) + s
            total += t
        return kernels, total / max(len(self.recorded), 1)

    def close(self) -> None:
        self.state = self.cams = self.step_fn = None
        self.recorded = []

    def reference(self, q=R.identity, fault: str | None = None) -> ref_train.Trainer:
        """The reference's run of the checked steps, from the same inputs."""
        p = inputs.gaussians(self.cfg, self.seed, self.device)
        trainer = ref_train.Trainer(p, self.degree, self.spec["start_iteration"], self.extent,
                                    R.default_cut(p["means"].shape[0]), q=q, grow=True,
                                    fault=fault)
        del p
        gts = inputs.targets(self.cfg, self.seed, len(self.eyes), self.device)
        for j in range(self.spec["checked"]):
            cam_i = self.order[j][0]
            trainer.run(self.view(cam_i), gts[cam_i], torch.zeros(3, device=self.device))
        return trainer

    def summary(self, trainer: ref_train.Trainer) -> dict:
        """A reference run's readings, as the program's are kept."""
        p0 = inputs.gaussians(self.cfg, self.seed, self.device)
        change = compare.norms({k: trainer.p[k] - p0[k] for k in ref_train.FIELDS})
        return {"loss": trainer.losses, "grad": compare.norms(trainer.first_grad), "change": change,
                "stats": self._stats(trainer.max_radii, trainer.accum, trainer.denom)}

    @staticmethod
    def gaps(prog: dict, ref: dict) -> dict:
        """The numbers compared, of `prog`'s readings against `ref`'s."""
        keys = compare.moving(ref["grad"])
        got = {
            "loss_gap": compare.loss_gap(prog["loss"], ref["loss"]),
            "grad_gap": compare.leaf_gap(prog["grad"], ref["grad"], keys),
            "change_gap": compare.leaf_gap(prog["change"], ref["change"], keys),
        }
        if "stats" in ref:
            got["stats_gap"] = compare.leaf_gap(prog["stats"], ref["stats"], list(ref["stats"]))
        return got

    def check(self) -> dict:
        got = self.gaps({**self.prog, "grad": self.prog_grad}, self.summary(self.reference()))
        return {k: (v, self.spec["limits"][k]) for k, v in got.items()}
