"""Frames past the JAX package's 2^24-instance ceiling, and the benchmark's
serving traffic that reaches them.

At a small size on the CPU (the port runs the plain versions of its
kernels):

- a surface-shaped scene (`perfbench/surface.py`) rendered by the port,
  fast and exact, against the benchmark's uncut reference
  (`perfbench/reference/uncut.py`): the same live count, images within 2e-5
  (the blends' own tolerance; both walk in one order);
- with the old ceiling (the JAX package's `MAX_CAPACITY`, which the port
  used to copy) set below a frame's live count, `api.render`'s default, the
  trainer's cut growth and `render_trajectory` keep every live instance,
  where the old rules cut or raised;
- binning's counters against the reference cover's live and fallback counts;
- `serve_orbit_uncut`'s set-up refusing a program that cuts.
"""
import numpy as np
import pytest
import torch
from PIL import Image

from lightgaussian_tpu.ops.rasterize import binning as jb
from lightgaussian_tpu_torch.config import OptimizationParams
from lightgaussian_tpu_torch.ops import losses
from lightgaussian_tpu_torch.ops.rasterize import api, binning, render, tiled
from lightgaussian_tpu_torch.ops.rasterize.projection import preprocess
from lightgaussian_tpu_torch.render import sets as tsets
from lightgaussian_tpu_torch.train import loop
from lightgaussian_tpu_torch.train.state import init_train_state
from lightgaussian_tpu_torch.train.step import make_train_step
from perfbench import core, inputs, port, surface
from perfbench.reference import camera as ref_camera
from perfbench.reference import render as R
from perfbench.reference import uncut
from perfbench.reference.train import ALTERED

torch.set_num_threads(1)

CPU = torch.device("cpu")
SEED = 2**31 + 29  # past 32 signed bits, as the benchmark's seeds
UNCUT_CELL = "serve-3dgs-bicycle-4k-orbit"
# 10 x 6 tiles, so that rects of more than 32 tiles (the cover's fallback) occur
TINY = {"num_gaussians": 2500, "width": 320, "height": 192}
ORIGIN = [0.0, 0.0, 0.0]
IMAGE_TOL = 2e-5


def _cell(name: str) -> core.Cell:
    """The cell at a tiny size, its splats scaled with the image, so that
    they cover as many tiles as at the cell's own size."""
    cell = core.Cell(name)
    cfg = cell.config
    scene = {**cfg["scene"], "scale_median": cfg["scene"]["scale_median"] * cfg["width"] / TINY["width"]}
    cell.config = {**cfg, **TINY, "scene": scene}
    return cell


def _surface():
    cfg = _cell(UNCUT_CELL).config
    p = surface.gaussians(cfg, SEED, CPU)
    return cfg, p, port.scene(p, cfg["sh_degree"])


def _views(cfg, angle):
    eye = inputs.ring_eye(cfg, angle)
    return (port.camera(eye, ORIGIN, cfg, CPU),
            ref_camera.look_at(eye, ORIGIN, cfg["cameras"]["fovx"], cfg["width"], cfg["height"], CPU))


@pytest.mark.parametrize("fast", [True, False])
def test_surface_scene_port_equals_the_uncut_reference(fast):
    cfg, p, scene = _surface()
    bg = torch.zeros(3)
    for angle in (0.0, 2.1):
        cam, view = _views(cfg, angle)
        with torch.no_grad():
            out = render(scene, cam, bg, fast=fast)
        want, total = uncut.render_frame(p, cfg["sh_degree"], view, bg, fast=fast)
        assert out.num_instances == total > 0
        assert float((out.render - want).abs().max()) <= IMAGE_TOL


def _pngs(d):
    return [np.asarray(Image.open(f), np.float64) for f in sorted(d.glob("*.png"))]


def test_frames_past_the_old_ceiling_render_whole(monkeypatch, tmp_path, capsys):
    """The old ceiling set under a frame's live count: the port's defaults
    and growth rules no longer read it, and keep every live instance."""
    cfg, _, scene = _surface()
    bg = torch.zeros(3)
    cam, _ = _views(cfg, 0.0)
    n, grid = cfg["num_gaussians"], binning.make_grid(cfg["width"], cfg["height"])
    with torch.no_grad():
        live = render(scene, cam, bg, fast=True, max_instances=1 << 20).num_instances
    old = live // 2 // binning.INST_CHUNK * binning.INST_CHUNK
    monkeypatch.setattr(jb, "MAX_CAPACITY", old)
    # the old rules: a default cut at the ceiling, and a grown cut past it refused
    assert jb.estimate_max_instances(n, jb.make_grid(cfg["width"], cfg["height"])) == old < live
    with pytest.raises(ValueError):
        jb.instance_capacity(jb.snug_capacity(live), grid)

    # api.render with no cut
    binning.reset_instances()
    with torch.no_grad():
        out = render(scene, cam, bg, fast=True)
        whole = render(scene, cam, bg, fast=True, max_instances=live)
        cut = render(scene, cam, bg, fast=True, max_instances=old)
    assert out.num_instances == live and binning.INSTANCES["cut"] == live - old
    assert torch.equal(out.render, whole.render) and not torch.equal(out.render, cut.render)

    # the trainer's growth, then a step at the grown cut
    grown = loop.grown_cut(old, live)
    assert grown >= live > old and grown == binning.snug_capacity(live)
    gt = torch.rand((3, cfg["height"], cfg["width"]), generator=torch.Generator().manual_seed(3))
    cam_gt = cam.with_gt(gt).with_gt_ssim_stats(losses.precompute_ssim_target_stats(gt))
    binning.reset_instances()
    _, metrics = make_train_step(OptimizationParams(), 1.0, grown)(init_train_state(scene), cam_gt, bg)
    assert metrics.num_instances == live and binning.INSTANCES == {
        "live": live, "cut": 0, "fallback": binning.INSTANCES["fallback"]}

    # a trajectory from a cut under its frames' live counts grows past the old ceiling
    frames = tsets.trajectory_frames("circular", [cam], 4, 0.05)
    out_dir = tsets.render_trajectory(tmp_path, "circular", 1, [cam], scene, bg, old, n_frames=4, radius=0.05,
                                      rebin_every=1)
    said = capsys.readouterr().out
    assert "live instances reach the cut" in said and f"MAX_CAPACITY {binning.MAX_CAPACITY}" in said
    for png, c in zip(_pngs(out_dir), frames):
        with torch.no_grad():
            want = render(scene, c, bg, fast=True).render.clamp(0, 1)
        assert np.abs(png - want.numpy().transpose(1, 2, 0) * 255.0).max() <= 1.0 + 1e-3


def test_a_frame_past_the_ceiling_raises(monkeypatch):
    """A frame of more live instances than the port's ceiling raises: it is
    never cut below what the int32 tile ranges hold."""
    cfg, _, scene = _surface()
    cam, _ = _views(cfg, 0.0)
    monkeypatch.setattr(binning, "MAX_CAPACITY", 1024)
    with pytest.raises(ValueError, match="exceed MAX_CAPACITY"):
        with torch.no_grad():
            render(scene, cam, torch.zeros(3), fast=True, max_instances=512)


@pytest.mark.parametrize("cut_share", [None, 3])
def test_binning_counters_equal_the_reference_cover(cut_share):
    cfg, p, scene = _surface()
    counts = {"live": 0, "cut": 0, "fallback": 0}
    binning.reset_instances()
    for angle in (0.0, 1.3):
        cam, view = _views(cfg, angle)
        grid = binning.make_grid(cam.width, cam.height)
        with torch.no_grad():
            splats = preprocess(scene, cam)
        s = R.preprocess(p, cfg["sh_degree"], view)
        count = R._cover(s, R.make_grid(view.width, view.height))[4]
        live = int(count.sum())
        cap = binning.instance_capacity(live // cut_share) if cut_share else binning.MAX_CAPACITY
        b = binning.bin_splats(splats, grid, cap)
        assert b.total == live and b.inst.shape[0] == min(live, cap)
        counts["live"] += live
        counts["cut"] += live - min(live, cap)
        counts["fallback"] += int(count[count > R.MAX_MASK_TILES].sum())
    assert counts["fallback"] > 0 and (counts["cut"] > 0) == bool(cut_share)
    assert binning.INSTANCES == counts


def test_uncut_traffic_refuses_a_program_that_cuts(monkeypatch):
    """A default cut planted under the frames' live counts: set-up raises
    RunError after the first warm-up frame, before any window."""
    cell = _cell(UNCUT_CELL)
    monkeypatch.setattr(api, "MAX_CAPACITY", 1024)
    with pytest.raises(core.RunError, match="default cut"):
        cell.traffic().Traffic(cell.config, cell.spec, SEED, CPU)


def test_uncut_traffic_window_and_check_at_a_tiny_size():
    """A window and the check, as `perfbench/run.py` makes them: frames equal
    the uncut reference and none is cut; at this size the scene stays under
    the ceiling, so `ceiling_ratio` fails."""
    cell = _cell(UNCUT_CELL)
    traffic = cell.traffic().Traffic(cell.config, cell.spec, SEED, CPU)
    times, _ = core.window(traffic, 0.3, CPU)
    traffic.close()
    checks = traffic.check()
    assert len(times) > 0 and set(checks) == {"image_gap", "instances_cut", "ceiling_ratio"}
    assert checks["image_gap"][0] <= IMAGE_TOL and checks["instances_cut"][0] == 0
    assert checks["ceiling_ratio"][0] > checks["ceiling_ratio"][1]
    assert min(traffic.live) > 0 and len(traffic.live) == len(traffic.sample) == min(len(times), 3)


def test_scene_parts_and_draws():
    """The surface scene's parts have the configured sizes and places, and a
    seed draws the same scene again."""
    cfg, p, _ = _surface()
    s = cfg["scene"]
    n_ground, n_obj, n_back = surface.part_sizes(cfg)
    assert n_ground + n_obj + n_back == cfg["num_gaussians"] and n_back > 0
    means = p["means"]
    ground = means[:n_ground]
    assert float((ground[:, 1] - s["ground_height"]).abs().max()) < 10 * s["ground_jitter"]
    assert float(torch.linalg.vector_norm(ground[:, [0, 2]], dim=1).max()) <= s["ground_radius"]
    back = means[n_ground + n_obj:]
    assert float(back[:, 1].min()) >= s["ground_height"] - 10 * s["background_jitter"] * s["background_radius"]
    assert float(torch.linalg.vector_norm(back, dim=1).min()) > s["background_radius"] / 2
    again = surface.gaussians(cfg, SEED, CPU)
    assert all(torch.equal(p[k], again[k]) for k in p)
    assert not torch.equal(p["means"], surface.gaussians(cfg, SEED + 1, CPU)["means"])
    logits = p["opacity_logits"]
    assert 0.4 < float((logits > 0).float().mean()) < 0.6


def _window():
    cell = _cell(UNCUT_CELL)
    traffic = cell.traffic().Traffic(cell.config, cell.spec, SEED, CPU)
    for _ in range(3):
        traffic.one()
    traffic.close()
    return cell, traffic


def test_altered_frame_fails_the_check(monkeypatch):
    """One tile of each frame altered where the image is composed: `image_gap` reads the alteration."""
    compose = tiled._compose

    def altered(tile_rgb, *a):
        tile_rgb = tile_rgb.clone()
        tile_rgb[0] += ALTERED
        return compose(tile_rgb, *a)

    monkeypatch.setattr(tiled, "_compose", altered)
    _, traffic = _window()
    gap, limit = traffic.check()["image_gap"]
    assert gap > limit


def test_precision_control_fails_the_limit():
    """The reference with its stage results held in bfloat16, in the program's place, fails `image_gap`."""
    cell, traffic = _window()
    got = max(float((a - b).abs().max()) for a, b in zip(traffic.reference(q=R.bf16_round), traffic.reference()))
    assert got > cell.spec["limits"]["image_gap"]
