"""Traffic `serve_orbit_uncut`: `serve_orbit`'s viewer on a scene whose every
frame passes the JAX package's 2^24 instances, at the program's default cut.

Set-up draws the configuration's surface-shaped scene (`perfbench/surface.py`)
and holds it as the render CLI's scene. A frame is
`ops/rasterize/api.render(scene, camera, bg, fast=True)` with no cut given,
followed by a synchronise; the orbit and the sampled frames are
`serve_orbit`'s. Set-up bins each warm-up frame once more through
`api.build_binning(scene, camera)`, which takes the same default cut, and
raises `RunError` where that binning holds fewer instances than the frame's
live count: a program that cuts such frames fails in seconds.

The check holds each sampled frame against the reference rendered uncut
(`reference/uncut.py`, `image_gap`); the instances the program's binnings
cut after set-up, from its counters (`binning.INSTANCES`), against 0
(`instances_cut`); and 2^24 over the least live count of the sampled frames
as the reference bins them (`ceiling_ratio`), so that the scene keeps every
checked frame past the old ceiling by the limit's margin.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import core, inputs, port, surface
from perfbench.reference import render as R
from perfbench.reference import uncut
from perfbench.traffic import serve_orbit


class Traffic(serve_orbit.Traffic):
    """`serve_orbit.Traffic` with the scene, the frame's call, the cut of the
    counted pairs (none) and the check replaced."""

    def __init__(self, cfg: dict, spec: dict, seed: int, device: torch.device):
        from lightgaussian_tpu_torch.ops.rasterize import binning, build_binning, render

        self.cfg, self.spec, self.seed, self.device = cfg, spec, seed, device
        self.degree = cfg["sh_degree"]
        self.rng = np.random.default_rng(int(seed))
        self.p = self.gaussians()
        self.scene = port.scene(self.p, self.degree)
        self.cut = uncut.UNCUT  # the counted pairs are the uncut frame's
        self.render = render
        self.counters = getattr(binning, "INSTANCES", None)
        self.bg = torch.zeros(3, device=device)
        self.done, self.frame_s, self.sample, self.recorded, self.recording = 0, [], [], [], False
        self.live: list[int] = []
        for _ in range(spec["warmup"]):
            cam = self.camera(self.done)
            self.one()
            b = build_binning(self.scene, cam)
            if b.inst.shape[0] < b.total:
                raise core.RunError(f"the program bins {b.inst.shape[0]} of the frame's {b.total} live instances "
                                    "at its default cut: it cuts frames this cell renders whole")
            del b
        self.done, self.frame_s, self.sample = 0, [], []
        self.cut_before = self.counters["cut"] if self.counters is not None else None
        self.cut_after = None

    def gaussians(self) -> dict:
        return inputs.truncate_sh(surface.gaussians(self.cfg, self.seed, self.device), self.degree)

    def camera(self, i: int):
        return port.camera(inputs.ring_eye(self.cfg, self.angle(i)), serve_orbit.ORIGIN, self.cfg, self.device)

    def one(self) -> None:
        i = self.done
        cam = self.camera(i)
        t0 = time.perf_counter()
        image = self.render(self.scene, cam, self.bg, fast=True).render
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

    def close(self) -> None:
        if self.counters is not None:
            self.cut_after = self.counters["cut"]
        super().close()

    def reference(self, q=R.identity) -> list:
        """The reference's uncut frames of the sampled cameras; their live counts go to `live`."""
        p = self.gaussians()
        out = [uncut.render_frame(p, self.degree, self.view(i), self.bg, fast=True, q=q) for i, _ in self.sample]
        self.live = [total for _, total in out]
        return [image for image, _ in out]

    def check(self) -> dict:
        lim = self.spec["limits"]
        ref = self.reference()
        gap = max(serve_orbit.compare.image_gap(img, r) for (_, img), r in zip(self.sample, ref))
        cut = float("inf") if self.cut_after is None else float(self.cut_after - self.cut_before)
        ratio = float(R.MAX_CAPACITY) / max(min(self.live), 1)
        return {"image_gap": (gap, lim["image_gap"]), "instances_cut": (cut, lim["instances_cut"]),
                "ceiling_ratio": (ratio, lim["ceiling_ratio"])}
