"""At a tiny size on the CPU, where the port runs its plain versions: the
reference agrees with the port, and the frozen walk counts the pairs by kind
as the port's `blend.WORK_KINDS` counts do."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from lightgaussian_tpu_torch.ops import losses
from lightgaussian_tpu_torch.ops.rasterize import blend as port_blend
from lightgaussian_tpu_torch.ops.rasterize import render
from lightgaussian_tpu_torch.ops.rasterize.binning import bin_splats, make_grid
from lightgaussian_tpu_torch.ops.rasterize.projection import preprocess
from perfbench import inputs, port
from perfbench.reference import camera as ref_camera
from perfbench.reference import render as R
from perfbench.reference import train as ref_train
from perfbench.tests.conftest import tiny_cell

CPU = torch.device("cpu")


def _setup(config: str, seed: int, degree: int | None = None):
    cfg = {**tiny_cell("serve-3dgs-m360-orbit" if config == "3dgs-m360" else "serve-lg-m360-orbit").config}
    p = inputs.gaussians(cfg, seed, CPU)
    deg = cfg["sh_degree"] if degree is None else degree
    p = inputs.truncate_sh(p, deg)
    eye = inputs.ring_eye(cfg, 0.7)
    cam = port.camera(eye, np.zeros(3), cfg, CPU)
    view = ref_camera.look_at(eye, np.zeros(3), cfg["cameras"]["fovx"], cfg["width"], cfg["height"], CPU)
    return cfg, p, deg, cam, view


def test_camera_bit_equal():
    _, _, _, cam, view = _setup("3dgs-m360", 3)
    assert torch.equal(cam.world_view, view.world_view) and torch.equal(cam.full_proj, view.full_proj)
    assert torch.equal(cam.camera_center, view.center) and torch.equal(cam.focal_x, view.focal_x)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("config", ["3dgs-m360", "lg-m360"])
def test_frame_agrees(config, fast):
    _, p, deg, cam, view = _setup(config, 11)
    scene = port.scene(p, deg)
    with torch.no_grad():
        got = render(scene, cam, torch.zeros(3), fast=fast).render
    ref = R.render_frame(p, deg, view, torch.zeros(3), R.default_cut(p["means"].shape[0]), fast=fast)
    assert got.abs().max() > 0.05
    assert float((got - ref).abs().max()) <= 1e-6


@pytest.mark.parametrize("exact", [True, False])
def test_pair_counts_equal_the_ports(exact):
    _, p, deg, cam, view = _setup("3dgs-m360", 5)
    scene = port.scene(p, deg)
    with torch.no_grad():
        b = bin_splats(preprocess(scene, cam), make_grid(cam.width, cam.height), 1 << 16)
        _, _, port_work = port_blend.plain_blend(b.tile_starts, b.inst, make_grid(cam.width, cam.height), exact)
        rb = R.bin_splats(R.preprocess(p, deg, view), R.make_grid(view.width, view.height), 1 << 16)
        _, _, ref_work = R.blend(rb, exact)
    assert port_blend.WORK_KINDS == R.WORK_KINDS
    assert torch.equal(port_work, ref_work)
    assert int(ref_work[:, R.WORK_KINDS.index("applied")].sum()) > 0


def test_gradients_agree():
    cfg, p, deg, cam, view = _setup("3dgs-m360", 9)
    gt = inputs.targets(cfg, 9, 1, CPU)[0]
    params = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    out = render(port.scene(params, deg), cam.with_gt(gt), torch.zeros(3))
    lam = 0.2
    loss = (1 - lam) * losses.l1_loss(out.render, gt) + lam * (1 - losses.ssim(out.render, gt))
    got = torch.autograd.grad(loss, [params[k] for k in ref_train.FIELDS])
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    image, _, _ = R.render_exact(leaves, deg, view, torch.zeros(3), R.default_cut(600))
    ref_loss = ref_train.loss_fn(image, gt)
    ref = torch.autograd.grad(ref_loss, [leaves[k] for k in ref_train.FIELDS])
    assert abs(float(loss.detach()) - float(ref_loss.detach())) <= 1e-6 * float(ref_loss.detach())
    for k, a, b in zip(ref_train.FIELDS, got, ref):
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-12, k
