"""Traffic `serve_orbit`: one viewer on an orbit, each frame waited for.

Set-up makes the configuration's Gaussians from the seed, truncated to the
served SH degree, and holds them as the render CLI's scene with its instance
cut `default_max_instances`. A frame is `ops/rasterize/api.render(scene,
camera, bg, fast=True)` (the render-only blend, B6) followed by a
synchronise: the frame is complete when its image is finished on the device.
The camera advances `step_radians` a frame round the orbit from
`start_radians`, looking at the centre, so that every seed's window sees the
same views. The check keeps a seeded sample of
`sampled` frames of the window (reservoir sampling over all of them) and holds
each image against the reference's render of the same camera.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import inputs, port
from perfbench.counting import step as counting
from perfbench.reference import camera as ref_camera
from perfbench.reference import compare
from perfbench.reference import render as R

ORIGIN = np.zeros(3)


class Traffic:
    unit = "frame"

    def __init__(self, cfg: dict, spec: dict, seed: int, device: torch.device):
        from lightgaussian_tpu_torch.ops.rasterize import default_max_instances, render

        self.cfg, self.spec, self.seed, self.device = cfg, spec, seed, device
        self.degree = cfg["sh_degree"]
        self.rng = np.random.default_rng(int(seed))
        self.p = inputs.truncate_sh(inputs.gaussians(cfg, seed, device), self.degree)
        self.scene = port.scene(self.p, self.degree)
        self.cut = default_max_instances(self.scene)
        self.render = render
        self.bg = torch.zeros(3, device=device)
        self.done, self.frame_s, self.sample, self.recorded, self.recording = 0, [], [], [], False
        for _ in range(spec["warmup"]):
            self.one()
        self.done, self.frame_s, self.sample = 0, [], []

    def angle(self, i: int) -> float:
        return self.spec["start_radians"] + i * self.spec["step_radians"]

    def one(self) -> None:
        i = self.done
        cam = port.camera(inputs.ring_eye(self.cfg, self.angle(i)), ORIGIN, self.cfg, self.device)
        t0 = time.perf_counter()
        image = self.render(self.scene, cam, self.bg, max_instances=self.cut, fast=True).render
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.frame_s.append(time.perf_counter() - t0)
        if self.recording:
            self.recorded.append(i)
        k = self.spec["sampled"]
        if len(self.sample) < k:
            self.sample.append((i, image))
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < k:
                self.sample[j] = (i, image)
        self.done += 1

    def e2e(self, times: list, wall: float) -> dict:
        return {"frames_per_s": len(times) / wall,
                "frame_ms_p95": 1e3 * float(np.percentile(self.frame_s[:len(times)], 95))}

    def record(self, on: bool) -> None:
        self.recording = on

    def view(self, i: int):
        return ref_camera.look_at(inputs.ring_eye(self.cfg, self.angle(i)), ORIGIN, self.cfg["cameras"]["fovx"],
                                  self.cfg["width"], self.cfg["height"], self.device)

    def counted(self):
        kernels, total = {}, 0.0
        for i in self.recorded:
            k, t = counting.frame(self.p, self.degree, self.view(i), self.cut)
            for name, s in k.items():
                kernels[name] = kernels.get(name, 0.0) + s
            total += t
        return kernels, total / max(len(self.recorded), 1)

    def close(self) -> None:
        self.scene = self.recorded = None
        self.p = None

    def reference(self, q=R.identity) -> list:
        """The reference's frames of the sampled cameras."""
        p = inputs.truncate_sh(inputs.gaussians(self.cfg, self.seed, self.device), self.degree)
        cut = R.default_cut(p["means"].shape[0])
        return [R.render_frame(p, self.degree, self.view(i), self.bg, cut, fast=True, q=q) for i, _ in self.sample]

    def check(self) -> dict:
        ref = self.reference()
        gap = max(compare.image_gap(img, r) for (_, img), r in zip(self.sample, ref))
        return {"image_gap": (gap, self.spec["limits"]["image_gap"])}
