"""PyTorch port vs the JAX package: the GSS pruning, distillation and
trajectory CLIs.

The workspace mirrors tests/test_cli.py: the tiny Blender dataset of
tests/test_torch_train_loop.py (40x40, 6 train and 2 test views rendered by
the JAX package from a 150-Gaussian scene) and, in place of a training run,
a checkpoint at iteration 40 written by the JAX package from a noisy copy of
that scene (SH degree 3, 256 slots), with its PLY. Both packages' CLIs run on
the CPU; the JAX side in interpret mode.

Tolerances (float32):
- `imp_score.npz`: rtol 1e-4 and atol 1e-4 per camera summed (the loop
  test's); hit counts over the train cameras equal;
- the prune: the same Gaussians alive after it;
- distillation: the student's frozen fields bit-equal to the teacher's.
"""
import csv
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgaussian_tpu.cli import prune_finetune as jcli_prune
from lightgaussian_tpu.cli import save_imp_score as jcli_imp
from lightgaussian_tpu.data import ply as jply
from lightgaussian_tpu.data.scene import Scene as JScene
from lightgaussian_tpu.train import checkpoint as jckpt
from lightgaussian_tpu.train import gss as jgss
from lightgaussian_tpu.train import state as jstate
from lightgaussian_tpu.utils import synthetic as jsyn
from lightgaussian_tpu_torch.cli import distill_train as tcli_distill
from lightgaussian_tpu_torch.cli import prune_finetune as tcli_prune
from lightgaussian_tpu_torch.cli import render_video as tcli_video
from lightgaussian_tpu_torch.cli import save_imp_score as tcli_imp
from lightgaussian_tpu_torch.data import ply as tply
from lightgaussian_tpu_torch.data.scene import Scene as TScene
from lightgaussian_tpu_torch.train import checkpoint as tckpt
from lightgaussian_tpu_torch.train import gss as tgss
from test_torch_train_loop import _write_blender_dataset

torch.set_num_threads(1)

START = 40
PARAMS = ("means", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logits")
FROZEN = ("log_scales", "quats", "opacity_logits")
CLIS = {"save_imp_score": tcli_imp, "prune_finetune": tcli_prune, "distill_train": tcli_distill,
        "render_video": tcli_video}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    base = tmp_path_factory.mktemp("prune_cli")
    dataset, model = base / "scene", base / "model"
    _write_blender_dataset(dataset)
    truth = jsyn.random_scene(n=150, seed=7, extent=0.8, scale_range=(0.05, 0.13), capacity=256)
    rng = np.random.default_rng(3)
    noisy = {}
    for k, sd in (("sh_dc", 0.3), ("opacity_logits", 0.5), ("means", 0.02), ("sh_rest", 0.05)):
        v = np.array(getattr(truth, k))
        v[:150] += rng.normal(0.0, sd, v[:150].shape).astype(np.float32)
        noisy[k] = jnp.asarray(v)
    state = jstate.init_train_state(truth.with_params({**truth.params(), **noisy}))
    state = dataclasses.replace(state, step=START)
    jckpt.save_checkpoint(model / f"chkpnt{START}.npz", state, START, 1.5)
    jply.save_gaussian_ply(state.scene, model / "point_cloud" / f"iteration_{START}" / "point_cloud.ply")
    return dataset, model


def _common(dataset, out):
    return ["-s", str(dataset), "-m", str(out), "--eval", "--quiet"]


def test_save_imp_score_cli_matches_jax(workspace, tmp_path, capsys):
    dataset, model = workspace
    ckpt = str(model / f"chkpnt{START}.npz")
    jcli_imp.main([*_common(dataset, tmp_path / "jax"), "--start_checkpoint", ckpt, "--interpret"])
    capsys.readouterr()
    tcli_imp.main([*_common(dataset, tmp_path / "port"), "--start_checkpoint", ckpt, "--device", "cpu",
                   "--show_imp_score", "--get_fps"])
    out = capsys.readouterr().out
    want = np.load(tmp_path / "jax" / "imp_score.npz")["arr_0"]
    got = np.load(tmp_path / "port" / "imp_score.npz")["arr_0"]
    ply = tply.load_gaussian_ply(model / "point_cloud" / f"iteration_{START}" / "point_cloud.ply", device="cpu")
    assert got.shape == want.shape == (int(ply.alive.sum()),) and np.isfinite(got).all() and got.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=6e-4)
    assert "live instances per train camera (cut " in out and "0 above the cut" in out
    assert "imp_score over 150 gaussians" in out and "render FPS over 6 train views" in out
    # the hit counts behind the scores
    jstate_, _, _ = jckpt.load_checkpoint(ckpt)
    tstate_, _, _ = tckpt.load_checkpoint(ckpt, device="cpu")
    jcams = JScene(str(dataset), str(tmp_path / "j2"), eval_split=True).getTrainCameras()
    tcams = TScene(str(dataset), str(tmp_path / "t2"), eval_split=True, device="cpu").getTrainCameras()
    jcnt, _ = jgss.accumulate_gss(jstate_.scene, jcams, jnp.zeros(3), 1 << 14, interpret=True)
    tcnt, _ = tgss.accumulate_gss(tstate_.scene, tcams, torch.zeros(3), 1 << 14)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    assert int(tcnt.sum()) > 0


LAST = START + 2
PRUNE_FLAGS = ["--iterations", str(LAST), "--prune_iterations", str(START + 1), "--prune_percent", "0.3",
               "--prune_type", "v_important_score", "--test_iterations", str(LAST), "--save_iterations",
               str(LAST), "--checkpoint_iterations", str(LAST), "--position_lr_max_steps", str(START)]


def test_prune_finetune_cli_prunes_the_same_gaussians(workspace, tmp_path):
    dataset, model = workspace
    ckpt = ["--start_checkpoint", str(model / f"chkpnt{START}.npz")]
    jcli_prune.main([*_common(dataset, tmp_path / "jax"), *ckpt, *PRUNE_FLAGS, "--interpret"])
    tcli_prune.main([*_common(dataset, tmp_path / "port"), *ckpt, *PRUNE_FLAGS, "--device", "cpu"])
    last = LAST
    jback, jit, _ = jckpt.load_checkpoint(tmp_path / "jax" / f"chkpnt{last}.npz")
    tback, tit, _ = tckpt.load_checkpoint(tmp_path / "port" / f"chkpnt{last}.npz", device="cpu")
    assert jit == tit == tback.step == last
    jalive, talive = np.asarray(jback.scene.alive), tback.scene.alive.numpy()
    np.testing.assert_array_equal(talive, jalive)
    assert talive.sum() == 150 - (int(np.float32(0.3) * np.float32(150)) + 1)
    for out in ("jax", "port"):
        rows = [r for r in csv.DictReader(open(tmp_path / out / "metric.csv")) if r["set"] == "test"]
        assert [r["iteration"] for r in rows] == [str(last)]
        ply = tply.load_gaussian_ply(tmp_path / out / "point_cloud" / f"iteration_{last}" / "point_cloud.ply",
                                     device="cpu")
        assert int(ply.alive.sum()) == int(talive.sum())
    cfg = json.loads((tmp_path / "port" / "cfg_args.json").read_text())
    assert cfg["opt"]["iterations"] == last and cfg["prune_percent"] == 0.3


def test_prune_finetune_cli_starts_from_a_point_cloud(workspace, tmp_path, capsys):
    dataset, model = workspace
    ply = model / "point_cloud" / f"iteration_{START}" / "point_cloud.ply"
    tcli_prune.main([*_common(dataset, tmp_path / "m"), "--start_pointcloud", str(ply), "--iteration_base",
                     str(START), "--iterations", str(START + 2), "--prune_iterations", str(START + 1),
                     "--test_iterations", str(START + 2), "--save_iterations", str(START + 2),
                     "--checkpoint_iterations", str(START + 2), "--device", "cpu"])
    assert "Loaded point cloud" in capsys.readouterr().out
    state, it, _ = tckpt.load_checkpoint(tmp_path / "m" / f"chkpnt{START + 2}.npz", device="cpu")
    assert it == START + 2 and state.scene.num_alive() == 150 - (int(np.float32(0.1) * np.float32(150)) + 1)
    assert tcli_prune.build_parser().parse_args([]).iterations == 30_000  # main() makes it 35,000


def test_distill_cli_artifacts(workspace, tmp_path):
    dataset, model = workspace
    out = tmp_path / "distilled"
    end = START + 6
    tcli_distill.main([*_common(dataset, out), "--start_checkpoint", str(model / f"chkpnt{START}.npz"),
                       "--new_max_sh", "1", "--augmented_view", "--iterations_total", str(end),
                       "--test_iterations", str(end), "--save_iterations", str(end),
                       "--checkpoint_iterations", str(end), "--device", "cpu"])
    ply_path = out / "point_cloud" / f"iteration_{end}" / "point_cloud.ply"
    names = tply.read_ply(ply_path)["vertex"].property_names
    assert sorted(n for n in names if n.startswith("f_rest_")) == sorted(f"f_rest_{i}" for i in range(9))
    teacher = tply.load_gaussian_ply(model / "point_cloud" / f"iteration_{START}" / "point_cloud.ply", device="cpu")
    for student in (tply.load_gaussian_ply(ply_path, device="cpu"), jply.load_gaussian_ply(ply_path)):
        assert student.max_sh_degree == 1 and tuple(student.sh_rest.shape[1:]) == (3, 3)
        alive = np.asarray(student.alive)
        assert alive.sum() == 150
        for f in FROZEN:
            np.testing.assert_array_equal(np.asarray(getattr(student, f))[alive],
                                          getattr(teacher, f).numpy()[teacher.alive.numpy()], err_msg=f)
        assert not np.array_equal(np.asarray(student.sh_dc)[alive], teacher.sh_dc.numpy()[teacher.alive.numpy()])
    state, it, _ = tckpt.load_checkpoint(out / f"chkpnt{end}.npz", device="cpu")
    assert it == end and state.step == end - START  # the student counts its own steps
    scores = np.load(out / "imp_score.npz")["arr_0"]
    assert scores.shape == (150,) and np.isfinite(scores).all() and scores.max() > 0
    rows = [r for r in csv.DictReader(open(out / "metric.csv")) if r["set"] == "test"]
    assert [r["iteration"] for r in rows] == [str(end)] and float(rows[0]["psnr"]) > 5


def test_render_video_cli_frame_counts(workspace, tmp_path):
    import shutil

    dataset, model = workspace
    m = tmp_path / "model"
    shutil.copytree(model, m)
    tcli_video.main([*_common(dataset, m), "--skip_train", "--skip_test", "--video", "--circular", "--radius",
                     "0.01", "--gaussians", "--n_frames", "3", "--device", "cpu"])
    for d in ("video", "circular", "perturbed"):
        assert len(list((m / d / f"ours_{START}").glob("*.png"))) == 3, d
    tcli_video.main([*_common(dataset, m), "--skip_train", "--spiral", "--n_frames", "2", "--device", "cpu"])
    assert len(list((m / "spiral" / f"ours_{START}").glob("*.png"))) == 2
    assert len(list((m / "test" / f"ours_{START}" / "renders").glob("*.png"))) == 2
    with pytest.raises(NotImplementedError, match="compression slice"):
        tcli_video.main([*_common(dataset, m), "--skip_train", "--skip_test", "--load_vq", "--device", "cpu"])


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_keeps_the_jax_flags_and_defaults_to_the_card(name, workspace, tmp_path, monkeypatch):
    import importlib

    jparser = importlib.import_module(f"lightgaussian_tpu.cli.{name}").build_parser()
    tparser = CLIS[name].build_parser()
    jflags = {a.dest: a.default for a in jparser._actions if a.dest != "help"}
    tflags = {a.dest: a.default for a in tparser._actions if a.dest != "help"}
    assert set(tflags) == set(jflags) - {"interpret"} | {"device"}
    # data_device's default names each package's own device
    same = set(tflags) - {"device", "data_device"}
    assert {k: tflags[k] for k in same} == {k: jflags[k] for k in same}
    assert tflags["device"] == "cuda"
    dataset, model = workspace
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CLIS[name].main([*_common(dataset, tmp_path / "m"), "--start_checkpoint", str(model / f"chkpnt{START}.npz")]
                        if name != "render_video" else _common(dataset, model))
