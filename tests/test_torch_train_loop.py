"""PyTorch port vs the JAX package: the training loop and the trainer CLI.

The loop: a 48-Gaussian student in 128 slots trains for 12 iterations on
three 64x64 cameras (ground truth: renders of a target scene, handed to both
packages as the same numpy arrays), `densify=False`, with a GSS prune at 8,
reports at 1 and 12 and a checkpoint at 12, in both packages from one state.
The JAX loop runs its Pallas kernels in interpret mode; the port runs the
plain versions of its kernels. Both draw the camera order from
`random.Random(seed)`.

Tolerances (float32):
- `alive` after the prune: equal; the test first checks that the score gap
  at the threshold is far wider than the packages' difference in scores, so
  that equality is no accident.
- parameters after 12 steps: rel 1e-4 (of the value, or of the field's
  largest magnitude for values near zero); and, on Adam's own scale, within
  24 learning rates everywhere with a median difference of at most 1e-2
  learning rates (a gradient at rounding-noise level may move its parameter
  by a learning rate either way each step; see test_torch_train_step.py).
- `imp_score.npz`: equal length, rtol 1e-4 (atol 1e-4 times the cameras for
  the float sums).
- `metric.csv`: rows equal in `iteration,set`, within 1e-4 in `l1_loss` and
  `ssim` and 1e-3 dB in `psnr` (the file keeps 4 to 6 decimals).

The CLI: the tiny Blender dataset of tests/test_cli.py (40x40, 6 train and 2
test views rendered by the JAX package from a 150-Gaussian scene, a 120-point
cloud), trained by the port's CLI on the CPU.
"""
import csv
import dataclasses
import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lightgaussian_tpu.config import OptimizationParams as JOpt
from lightgaussian_tpu.config import TrainConfig as JTrainConfig
from lightgaussian_tpu.data import ply as jply
from lightgaussian_tpu.models.camera import Camera as JCamera
from lightgaussian_tpu.ops.rasterize import render as jrender
from lightgaussian_tpu.render.poses import c2w_from_camera
from lightgaussian_tpu.train import checkpoint as jckpt
from lightgaussian_tpu.train import gss as jgss
from lightgaussian_tpu.train import loop as jloop
from lightgaussian_tpu.train import optim as joptim
from lightgaussian_tpu.train import state as jstate
from lightgaussian_tpu.utils import synthetic as jsyn
from lightgaussian_tpu.utils.logging import MetricsLogger as JLogger
from lightgaussian_tpu_torch import config as tconfig
from lightgaussian_tpu_torch import convert
from lightgaussian_tpu_torch.cli import render_sets as tcli_render
from lightgaussian_tpu_torch.cli import train_densify_prune as tcli
from lightgaussian_tpu_torch.data import ply as tply
from lightgaussian_tpu_torch.models.camera import Camera as TCamera
from lightgaussian_tpu_torch.train import checkpoint as tckpt
from lightgaussian_tpu_torch.train import loop as tloop
from lightgaussian_tpu_torch.utils import logging as tlogging

torch.set_num_threads(1)

PARAMS = ("means", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logits")
MAX_INST = 1 << 14
EXTENT = 1.5
PRUNE_AT, LAST = 8, 12
PERCENT = 0.3


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


class FakeScene:
    """What `train` reads of a `Scene`, around a scene held in memory."""

    cameras_extent = EXTENT

    def __init__(self, model_path, gaussians, train_cams, test_cams, save_ply):
        self.model_path = str(model_path)
        self.gaussians = gaussians
        self._train, self._test, self._save_ply = train_cams, test_cams, save_ply

    def getTrainCameras(self):
        return self._train

    def getTestCameras(self):
        return self._test

    def save(self, iteration, scene):
        self._save_ply(scene, Path(self.model_path) / "point_cloud" / f"iteration_{iteration}" / "point_cloud.ply")


def _cameras(n, size, with_gt_of=None):
    """`n` cameras on the JAX suite's arc in both packages; with a ground
    truth rendered by the JAX oracle from `with_gt_of`."""
    jcams, tcams = [], []
    for i in range(n):
        eye = [3.0 * np.sin(0.5 * i), 0.4, -3.0 * np.cos(0.5 * i)]
        jc = JCamera.look_at(eye=eye, target=[0, 0, 0], width=size, height=size)
        tc = TCamera.look_at(eye=eye, target=[0, 0, 0], width=size, height=size, device="cpu")
        if with_gt_of is not None:
            gt = np.clip(np.asarray(jrender(with_gt_of, jc, jnp.zeros(3), method="reference").render), 0.0, 1.0)
            jc, tc = jc.with_gt(jnp.asarray(gt)), tc.with_gt(torch.from_numpy(gt.copy()))
        jcams.append(jc)
        tcams.append(tc)
    return jcams, tcams


def _student():
    target = jsyn.random_scene(n=48, seed=3, max_sh_degree=1, scale_range=(0.05, 0.15))
    student = jsyn.random_scene(n=48, seed=4, max_sh_degree=1, scale_range=(0.05, 0.15), capacity=128)
    student = dataclasses.replace(student, means=student.means.at[:48].set(target.means[:48] + 0.05))
    return target, student


class LoopWorld:
    """Both packages' loops run once from the same state."""

    def __init__(self, base: Path):
        target, student = _student()
        jcams, tcams = _cameras(4, 64, with_gt_of=target)
        self.jstate0 = jstate.init_train_state(student)
        tstate0 = convert.train_state_from_numpy(_jax_state_to_numpy(self.jstate0), device="cpu")
        self.tcams = tcams
        kw = dict(test_iterations=[1, LAST], save_iterations=[LAST], checkpoint_iterations=[LAST],
                  prune_iterations=[PRUNE_AT], prune_percent=PERCENT)
        self.jdir, self.tdir = base / "jax", base / "port"
        self.jdir.mkdir()
        self.tdir.mkdir()
        jscene = FakeScene(self.jdir, student, jcams[:3], jcams[3:], jply.save_gaussian_ply)
        tscene = FakeScene(self.tdir, tstate0.scene, tcams[:3], tcams[3:], tply.save_gaussian_ply)
        jcfg = JTrainConfig(opt=JOpt(iterations=LAST, densify_from_iter=999), **kw)
        tcfg = tconfig.TrainConfig(opt=tconfig.OptimizationParams(iterations=LAST, densify_from_iter=999), **kw)
        self.lr = {k: float(f(0)) for k, f in joptim.make_lr_fns(jcfg.opt, EXTENT).items()}
        self.at_prune = None  # the JAX state right after the prune

        def capture(iteration, state, metrics):
            if iteration == PRUNE_AT:
                self.at_prune = state

        self.jfinal = jloop.train(jscene, jcfg, jnp.zeros(3), state=self.jstate0, max_instances=MAX_INST,
                                  densify=False, interpret=True, callbacks=jloop.LoopCallbacks(on_iteration=capture),
                                  logger=JLogger(self.jdir, enable_tensorboard=False), seed=0)
        self.tfinal = tloop.train(tscene, tcfg, torch.zeros(3), state=tstate0, max_instances=MAX_INST,
                                  densify=False, logger=tlogging.MetricsLogger(self.tdir, enable_tensorboard=False),
                                  seed=0)


@pytest.fixture(scope="module")
def loop_world(tmp_path_factory):
    return LoopWorld(tmp_path_factory.mktemp("loop"))


def test_loop_prunes_the_same_gaussians(loop_world):
    w = loop_world
    jalive, talive = np.asarray(w.jfinal.scene.alive), _np(w.tfinal.scene.alive)
    np.testing.assert_array_equal(talive, jalive)
    n0 = int(np.asarray(w.jstate0.scene.alive).sum())
    assert talive.sum() == n0 - (int(np.float32(PERCENT) * np.float32(n0)) + 1)
    # The scores that decided it (the prune leaves the parameters alone, so
    # the state right after it, with the old mask, is the scene that was
    # scored): the gap between the last pruned and the first kept score is
    # far wider than the 1e-4 the packages' scores may differ by.
    jcams = _cameras(3, 64)[0]
    pre = dataclasses.replace(w.at_prune.scene, alive=w.jstate0.scene.alive)
    _, imp = jgss.accumulate_gss(pre, jcams, jnp.zeros(3), MAX_INST, interpret=True)
    v = np.asarray(jgss.calculate_v_imp_score(pre, imp, 0.1))
    alive0 = np.asarray(w.jstate0.scene.alive)
    kept_min, pruned_max = v[jalive].min(), v[alive0 & ~jalive].max()
    assert kept_min > pruned_max and (kept_min - pruned_max) / kept_min > 1e-2
    assert w.tfinal.step == int(w.jfinal.step) == LAST


def test_loop_parameters_match_jax(loop_world):
    w = loop_world
    for k in PARAMS:
        want, got = np.asarray(getattr(w.jfinal.scene, k)), _np(getattr(w.tfinal.scene, k))
        d = np.abs(got - want)
        assert d.max() <= 2 * LAST * w.lr[k], k
        assert np.median(d) <= 1e-2 * w.lr[k], k
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(), err_msg=k)
    # densify=False: the statistics stay as they were
    assert float(w.tfinal.denom.abs().max()) == 0.0 and float(np.asarray(w.jfinal.denom).max()) == 0.0


def test_loop_imp_score_matches_jax(loop_world):
    w = loop_world
    want = np.load(w.jdir / "imp_score.npz")["arr_0"]
    got = np.load(w.tdir / "imp_score.npz")["arr_0"]
    assert got.shape == want.shape == (int(w.tfinal.scene.alive.sum()),)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=3e-4)
    assert got.max() > 1.0
    # the file lines up with the saved PLY's rows
    ply = tply.load_gaussian_ply(w.tdir / "point_cloud" / f"iteration_{LAST}" / "point_cloud.ply", device="cpu")
    assert int(ply.alive.sum()) == got.shape[0]


def test_loop_metric_csv_matches_jax(loop_world):
    w = loop_world
    jrows = list(csv.DictReader(open(w.jdir / "metric.csv")))
    trows = list(csv.DictReader(open(w.tdir / "metric.csv")))
    assert list(trows[0]) == tlogging.CSV_FIELDS == list(jrows[0])
    assert [(r["iteration"], r["set"]) for r in trows] == [(r["iteration"], r["set"]) for r in jrows] == [
        ("1", "test"), ("1", "train"), (str(LAST), "test"), (str(LAST), "train")]
    for jr, tr in zip(jrows, trows):
        assert float(tr["l1_loss"]) == pytest.approx(float(jr["l1_loss"]), abs=1e-4)
        assert float(tr["psnr"]) == pytest.approx(float(jr["psnr"]), abs=1e-3)
        assert float(tr["ssim"]) == pytest.approx(float(jr["ssim"]), abs=1e-4)
        # the same seeded VGG in both packages (utils/threefry.py draws JAX's stream)
        assert float(tr["lpips"]) == pytest.approx(float(jr["lpips"]), abs=1e-4)
        assert tr["lpips_kind"] == jr["lpips_kind"] == "vgg-random"


def test_loop_checkpoint_loads_in_both_packages(loop_world):
    w = loop_world
    tback, it, extent = tckpt.load_checkpoint(w.jdir / f"chkpnt{LAST}.npz", device="cpu")
    jback, jit, jextent = jckpt.load_checkpoint(w.tdir / f"chkpnt{LAST}.npz")
    assert it == jit == LAST and extent == jextent == EXTENT
    np.testing.assert_array_equal(_np(tback.scene.alive), np.asarray(w.jfinal.scene.alive))
    np.testing.assert_array_equal(np.asarray(jback.scene.means), _np(w.tfinal.scene.means))
    np.testing.assert_array_equal(np.asarray(jback.opt.nu["means"]), _np(w.tfinal.opt.nu["means"]))
    assert int(jback.step) == w.tfinal.step == LAST


# ---- the loop's capacity policies --------------------------------------------------

def _port_fake_scene(tmp_path, student, cams):
    return FakeScene(tmp_path, student, cams, [], lambda scene, path: None)


def _port_student_and_cams():
    target, student = _student()
    _, tcams = _cameras(3, 64, with_gt_of=target)
    return convert.train_state_from_numpy(_jax_state_to_numpy(jstate.init_train_state(student)), device="cpu").scene, tcams


def test_instance_buffer_grows_after_one_cut_step(tmp_path, capsys):
    student, cams = _port_student_and_cams()
    # near-opaque, large splats: the 48 Gaussians overflow a cut of 128 instances
    student = dataclasses.replace(
        student, opacity_logits=torch.full_like(student.opacity_logits, 6.0),
        log_scales=torch.full_like(student.log_scales, float(np.log(0.3))),
    )
    cfg = tconfig.TrainConfig(opt=tconfig.OptimizationParams(iterations=4, densify_from_iter=999),
                              test_iterations=[], save_iterations=[], checkpoint_iterations=[], prune_iterations=[])
    tloop.train(_port_fake_scene(tmp_path, student, cams), cfg, torch.zeros(3), max_instances=128, densify=False,
                logger=tlogging.MetricsLogger(tmp_path, enable_tensorboard=False))
    out = capsys.readouterr().out
    assert "instance buffer overflow" in out and "growing to" in out
    # one overflowing step, then the cut lies above every frame's count
    assert out.count("instance buffer overflow") == 1


def test_gaussian_capacity_grows(tmp_path, capsys):
    student, cams = _port_student_and_cams()
    cfg = tconfig.TrainConfig(
        opt=tconfig.OptimizationParams(iterations=8, densify_from_iter=0, densification_interval=1,
                                       densify_until_iter=100, densify_grad_threshold=0.0,
                                       opacity_reset_interval=1000),
        test_iterations=[], save_iterations=[], checkpoint_iterations=[], prune_iterations=[])
    state = tloop.train(_port_fake_scene(tmp_path, student, cams), cfg, torch.zeros(3), max_instances=MAX_INST,
                        densify=True, logger=tlogging.MetricsLogger(tmp_path, enable_tensorboard=False))
    out = capsys.readouterr().out
    assert "gaussians near capacity" in out and "densify: cloned" in out
    assert state.scene.capacity > 128 and state.scene.capacity % 128 == 0
    for k in PARAMS:
        assert torch.isfinite(getattr(state.scene, k)).all()


def test_attach_gt_ssim_stats_budget(capsys, monkeypatch):
    _, cams = _port_student_and_cams()
    out = tloop._attach_gt_ssim_stats(cams, None)
    assert all(c.gt_ssim_stats is not None for c in out)
    assert out[0].gt_ssim_stats[0].shape == cams[0].gt_image.shape
    monkeypatch.setattr(tloop, "_GT_SSIM_CACHE_BUDGET_BYTES", 1)
    out = tloop._attach_gt_ssim_stats(cams, None)
    assert all(c.gt_ssim_stats is None for c in out) and "disabled" in capsys.readouterr().out
    assert all(c.gt_ssim_stats is not None for c in tloop._attach_gt_ssim_stats(cams, True))
    bare = [TCamera.look_at(eye=[0, 0, -3], target=[0, 0, 0], device="cpu")]
    assert tloop._attach_gt_ssim_stats(bare, None)[0].gt_ssim_stats is None
    mixed = tloop._attach_gt_ssim_stats(cams + bare, None)
    assert all(c.gt_ssim_stats is None for c in mixed) and "carry no gt image" in capsys.readouterr().out


def test_profiler_callback_writes_a_trace(tmp_path):
    student, cams = _port_student_and_cams()
    cfg = tconfig.TrainConfig(opt=tconfig.OptimizationParams(iterations=4, densify_from_iter=999),
                              test_iterations=[], save_iterations=[], checkpoint_iterations=[], prune_iterations=[])
    hook = tloop.make_profiler_callback(str(tmp_path / "trace"), start_iter=2, n_steps=2)
    tloop.train(_port_fake_scene(tmp_path, student, cams), cfg, torch.zeros(3), max_instances=MAX_INST,
                densify=False, callbacks=tloop.LoopCallbacks(on_iteration=hook),
                logger=tlogging.MetricsLogger(tmp_path, enable_tensorboard=False))
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert len(trace["traceEvents"]) > 10


def test_config_round_trip_and_logger_schema(tmp_path):
    cfg = tconfig.TrainConfig(opt=tconfig.OptimizationParams(iterations=5), prune_iterations=[3], seed=4)
    tconfig.save_config(cfg, tmp_path / "cfg.json")
    assert tconfig.load_config(tconfig.TrainConfig, tmp_path / "cfg.json") == cfg
    # the JAX package reads the same file
    from lightgaussian_tpu import config as jconfig

    jcfg = jconfig.load_config(jconfig.TrainConfig, tmp_path / "cfg.json")
    assert jcfg.opt.iterations == 5 and jcfg.prune_iterations == [3] and jcfg.seed == 4
    out = tlogging.prepare_output_dir(str(tmp_path / "m"), cfg)
    assert json.loads((out / "cfg_args.json").read_text())["opt"]["iterations"] == 5
    # a metric.csv with other columns is parked, not appended to
    (out / "metric.csv").write_text("iteration,set,l1_loss\n1,test,0.5\n")
    logger = tlogging.MetricsLogger(out, enable_tensorboard=False)
    logger.csv_row(1, "test", 0.1, 20.0, 0.9, math.nan, 0.0, 1.0)
    assert (out / "metric_legacy.csv").exists()
    rows = list(csv.DictReader(open(out / "metric.csv")))
    # the JAX logger writes the same row, and both default the kind to the seeded network's
    (tmp_path / "j").mkdir()
    jlogger = JLogger(tmp_path / "j", enable_tensorboard=False)
    jlogger.csv_row(1, "test", 0.1, 20.0, 0.9, math.nan, 0.0, 1.0)
    assert rows == list(csv.DictReader(open(tmp_path / "j" / "metric.csv")))
    assert list(rows[0]) == tlogging.CSV_FIELDS and rows[0]["lpips_kind"] == "vgg-random"
    timer = tlogging.StepTimer()
    timer.resume()
    timer.pause()
    timer.pause()
    assert timer.total > 0


# ---- the CLI -----------------------------------------------------------------------

SIZE = 40


def _write_blender_dataset(root: Path) -> None:
    scene = jsyn.random_scene(n=150, seed=7, extent=0.8, scale_range=(0.05, 0.13))
    for split, n, phase in (("train", 6, 0.0), ("test", 2, 0.17)):
        d = root / split
        d.mkdir(parents=True, exist_ok=True)
        frames = []
        for i in range(n):
            t = 2 * math.pi * i / n + phase
            cam = JCamera.look_at((2.5 * math.cos(t), 0.5, 2.5 * math.sin(t)), (0, 0, 0),
                                  fovx=0.9, width=SIZE, height=SIZE)
            img = jrender(scene, cam, jnp.zeros(3), max_instances=1 << 16, interpret=True).render
            arr = np.clip(np.asarray(img).transpose(1, 2, 0), 0, 1)
            Image.fromarray((arr * 255 + 0.5).astype(np.uint8)).save(d / f"r_{i}.png")
            c2w = c2w_from_camera(cam, blender=True)
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
        (root / f"transforms_{split}.json").write_text(json.dumps({"camera_angle_x": 0.9, "frames": frames}))
    rng = np.random.default_rng(0)
    xyz = np.asarray(scene.means)[np.asarray(scene.alive)][:120] + rng.normal(0, 0.05, (120, 3))
    jply.store_point_cloud(root / "points3d.ply", xyz, rng.random((120, 3)) * 255)


TRAIN_FLAGS = [
    "--eval", "--quiet", "--iterations", "40",
    "--densify_from_iter", "10", "--densification_interval", "15",
    "--densify_until_iter", "30", "--opacity_reset_interval", "1000",
    "--test_iterations", "1", "40", "--save_iterations", "40", "--checkpoint_iterations", "40",
    "--prune_iterations", "35", "--prune_percent", "0.1", "--position_lr_max_steps", "40", "--seed", "0",
]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    dataset, model = base / "scene", base / "model"
    _write_blender_dataset(dataset)
    tcli.main(["-s", str(dataset), "-m", str(model), "--disable_viewer", "--device", "cpu", *TRAIN_FLAGS])
    return dataset, model


def test_train_cli_artifacts_and_improvement(workspace):
    dataset, model = workspace
    for f in ["cfg_args.json", "cameras.json", "input.ply", "metric.csv", "chkpnt40.npz", "imp_score.npz",
              "point_cloud/iteration_40/point_cloud.ply"]:
        assert (model / f).exists(), f"missing {f}"
    test_rows = [r for r in csv.DictReader(open(model / "metric.csv")) if r["set"] == "test"]
    assert [r["iteration"] for r in test_rows] == ["1", "40"]
    assert float(test_rows[-1]["psnr"]) > float(test_rows[0]["psnr"])
    assert len(json.loads((model / "cameras.json").read_text())) == 8
    assert (model / "input.ply").read_bytes() == (dataset / "points3d.ply").read_bytes()
    cfg = tconfig.load_config(tconfig.TrainConfig, model / "cfg_args.json")
    assert cfg.opt.iterations == 40 and cfg.prune_iterations == [35] and cfg.model.eval


def test_train_cli_files_load_in_the_jax_package(workspace):
    _, model = workspace
    state, iteration, extent = jckpt.load_checkpoint(model / "chkpnt40.npz")
    ply = jply.load_gaussian_ply(model / "point_cloud" / "iteration_40" / "point_cloud.ply")
    n_alive = int(np.asarray(state.scene.alive).sum())
    assert iteration == 40 and extent > 0 and int(state.step) == 40
    assert int(np.asarray(ply.alive).sum()) == n_alive
    # GSS pruned a tenth at 35 and densification added some before: not the 120 it began with
    assert n_alive != 120
    np.testing.assert_allclose(np.asarray(ply.means)[:n_alive],
                               np.asarray(state.scene.means)[np.asarray(state.scene.alive)], atol=1e-6)
    assert np.load(model / "imp_score.npz")["arr_0"].shape == (n_alive,)


def test_train_cli_resumes_and_serves(workspace, tmp_path, capsys):
    dataset, model = workspace
    import shutil

    m = tmp_path / "model"
    shutil.copytree(model, m)
    tcli.main(["-s", str(dataset), "-m", str(m), "--eval", "--quiet", "--device", "cpu",
               "--start_checkpoint", str(m / "chkpnt40.npz"), "--iterations", "44",
               "--densify_until_iter", "30", "--opacity_reset_interval", "1000", "--position_lr_max_steps", "40",
               "--test_iterations", "44", "--save_iterations", "44", "--checkpoint_iterations", "44",
               "--prune_iterations", "999"])
    out = capsys.readouterr().out
    assert "Resumed from" in out and "at iteration 40" in out and "4 iterations" in out
    assert "the live viewer is not ported yet" in out  # no --disable_viewer: one line, and it trains on
    before, _, _ = tckpt.load_checkpoint(m / "chkpnt40.npz", device="cpu")
    after, it, _ = tckpt.load_checkpoint(m / "chkpnt44.npz", device="cpu")
    assert it == 44 and after.step == 44 and before.step == 40
    assert not torch.equal(after.scene.means, before.scene.means)
    rows = list(csv.DictReader(open(m / "metric.csv")))
    assert [r["iteration"] for r in rows if r["set"] == "test"] == ["1", "40", "44"]
    # train -> save -> serve
    tcli_render.main(["-s", str(dataset), "-m", str(m), "--eval", "--quiet", "--skip_train", "--device", "cpu"])
    assert len(list((m / "test" / "ours_44" / "renders").glob("*.png"))) == 2


def test_train_cli_defaults_to_the_card_and_raises_without_one(workspace, tmp_path, monkeypatch):
    dataset, _ = workspace
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["-s", str(dataset), "-m", str(tmp_path / "m"), "--quiet", "--disable_viewer", *TRAIN_FLAGS])
    assert not (tmp_path / "m" / "metric.csv").exists()
    with pytest.raises(NotImplementedError, match="multi-device"):
        tcli.main(["-s", str(dataset), "-m", str(tmp_path / "m2"), "--device", "cpu", "--disable_viewer",
                   "--camera_batch", "2", *TRAIN_FLAGS])
    defaults = tcli.build_parser().parse_args([])
    assert defaults.device == "cuda" and defaults.prune_iterations == [16_000, 24_000]
    assert defaults.checkpoint_iterations == [30_000] and defaults.cache_gt_ssim is None
    assert not hasattr(defaults, "interpret")
