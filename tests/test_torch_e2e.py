"""PyTorch port vs the JAX package: the HARD end-to-end benchmark
(`lightgaussian_tpu_torch/scripts/e2e_hard.py` against `scripts/e2e_hard.py`)
and its seed-variance companion.

- The target scene and the cameras at all three presets: the JAX script is
  loaded in a subprocess (`JAX_PLATFORMS=cpu`, `sys.argv` set to the preset,
  as its own seed-variance script loads it), so that its `jax.config`
  settings stay out of this process; its arrays come back as an npz. The
  Gaussians bit-equal, the cameras' view and projection matrices within
  1e-6.
- The ground-truth PNGs of a tiny preset (96x64, 300 Gaussians) against the
  JAX package's interpret-mode render of the same target and cameras,
  quantised the same way: within 1/255 per pixel.
- The evaluator against the same composition of JAX functions
  (interpret-mode render, `losses.psnr`, `losses.ssim`, `lpips` with the
  seeded vgg-random network): PSNR within 1e-4 dB, SSIM within 1e-6, LPIPS
  within 1e-5 relative.
- A whole run at a tiny preset on the CPU: eleven rows, the criteria table,
  every artifact, each prune keeping 40% of the alive Gaussians to the
  rounding, and one extra seed of the seed-variance script on its checkpoint.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgaussian_tpu.eval import lpips as jlpips
from lightgaussian_tpu.models.camera import Camera as JCamera
from lightgaussian_tpu.models.gaussians import empty_scene as jempty_scene
from lightgaussian_tpu.ops import losses as jlosses
from lightgaussian_tpu.ops.rasterize import render as jrender
from lightgaussian_tpu_torch.scripts import e2e_hard as eh
from lightgaussian_tpu_torch.scripts import e2e_seed_variance as sv
from lightgaussian_tpu_torch.utils import image_io

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("means", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logits", "alive")
TINY = eh.Preset("tiny", 96, 64, 300, 2, 2, 30, 20, 20, 10, 20, 32, 10, 1 << 16, 7e-5,
                 densify_from=10, densification_interval=10)
RUN = eh.Preset("tinyrun", 96, 64, 400, 8, 2, 30, 20, 20, 10, 20, 32, 10, 1 << 16, 7e-5,
                densify_from=10, densification_interval=10)


def _jax_script_arrays(out_path: Path, presets) -> None:
    code = (
        "import importlib.util, sys\n"
        "import numpy as np\n"
        "import jax\n"
        f"script, out_path, presets = {str(REPO / 'scripts' / 'e2e_hard.py')!r}, {str(out_path)!r}, {list(presets)!r}\n"
        "arrays = {}\n"
        "for preset in presets:\n"
        "    sys.argv = ['e2e_hard.py', '--preset', preset]\n"
        "    spec = importlib.util.spec_from_file_location('e2e_hard_' + preset, script)\n"
        "    eh = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(eh)\n"
        "    jax.config.update('jax_enable_compilation_cache', False)\n"
        "    t = eh.make_target()\n"
        f"    for f in {FIELDS!r}:\n"
        "        arrays[f'{preset}/{f}'] = np.asarray(getattr(t, f))\n"
        "    arrays[f'{preset}/active_sh_degree'] = np.asarray(t.active_sh_degree)\n"
        "    train, test = eh.make_cameras()\n"
        "    for split, cams in (('train', train), ('test', test)):\n"
        "        for k in ('world_view', 'full_proj', 'camera_center'):\n"
        "            arrays[f'{preset}/{split}/{k}'] = np.stack([np.asarray(getattr(c, k)) for c in cams])\n"
        "        arrays[f'{preset}/{split}/size'] = np.array([[c.width, c.height] for c in cams])\n"
        "np.savez(out_path, **arrays)\n"
    )
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]


@pytest.fixture(scope="module")
def jax_script(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_e2e") / "arrays.npz"
    _jax_script_arrays(path, list(eh.PRESETS))
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("preset", list(eh.PRESETS))
def test_target_matches_the_jax_script(jax_script, preset):
    t = eh.make_target(eh.PRESETS[preset], device="cpu")
    assert t.capacity == eh.PRESETS[preset].n_target
    assert t.active_sh_degree == int(jax_script[f"{preset}/active_sh_degree"]) == 3
    for f in FIELDS:
        got = getattr(t, f).numpy()
        want = jax_script[f"{preset}/{f}"]
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert np.array_equal(got, want), f"{preset} {f}: not bit-equal"


@pytest.mark.parametrize("preset", list(eh.PRESETS))
def test_cameras_match_the_jax_script(jax_script, preset):
    p = eh.PRESETS[preset]
    train, test = eh.make_cameras(p, device="cpu")
    assert (len(train), len(test)) == (p.n_train_views, p.n_test_views)
    for split, cams in (("train", train), ("test", test)):
        assert np.array_equal(np.array([[c.width, c.height] for c in cams]), jax_script[f"{preset}/{split}/size"])
        for k in ("world_view", "full_proj", "camera_center"):
            got = np.stack([getattr(c, k).numpy() for c in cams])
            np.testing.assert_allclose(got, jax_script[f"{preset}/{split}/{k}"], rtol=0, atol=1e-6,
                                       err_msg=f"{preset} {split} {k}")


def _jax_scene(scene):
    js = jempty_scene(scene.capacity, max_sh_degree=scene.max_sh_degree, active_sh_degree=scene.active_sh_degree)
    return dataclasses.replace(js, **{f: jnp.asarray(getattr(scene, f).numpy()) for f in FIELDS})


def _jax_cameras(preset):
    train, test = eh.camera_eyes(preset)
    cam = lambda e: JCamera.look_at(eye=e, target=list(eh.LOOK_AT), width=preset.width, height=preset.height,
                                    fovx=eh.FOVX)
    return [cam(e) for e in train], [cam(e) for e in test]


def _jax_render_fn(preset):
    bg = jnp.zeros((3,), jnp.float32)
    return jax.jit(lambda s, c: jrender(s, c, bg, method="tiled", max_instances=preset.max_inst,
                                        interpret=True).render)


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    ws = eh.Workspace(tmp_path_factory.mktemp("e2e_tiny"), TINY)
    target = eh.make_target(TINY, device="cpu")
    eh.dump_dataset(target, TINY, ws)
    return ws, target


def test_ground_truth_pngs_match_jax_render(tiny_dataset):
    ws, target = tiny_dataset
    js = _jax_scene(target)
    fn = _jax_render_fn(TINY)
    jtrain, jtest = _jax_cameras(TINY)
    for split, cams in (("train", jtrain), ("test", jtest)):
        for i, cam in enumerate(cams):
            want = np.clip(np.asarray(fn(js, cam)).transpose(1, 2, 0) * 255, 0, 255).astype(np.uint8)
            got = image_io.read_image(ws.scene / f"{split}/r_{i}.png")
            assert got.shape == want.shape
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, f"{split} {i}"
            assert want.std() > 5  # the views see the scene
    assert (ws.scene / "points3d.ply").exists()
    assert (ws.scene / "transforms_train.json").exists() and (ws.scene / "transforms_test.json").exists()


def test_eval_scene_matches_jax_evaluator(tiny_dataset):
    ws, _ = tiny_dataset
    scene = eh.make_target(TINY, seed=12, device="cpu")  # another draw than the ground truth's
    test_cams, gts = eh.load_test_gt(TINY, ws, "cpu")
    got = eh.eval_scene(scene, test_cams, gts, TINY, "port")

    js = _jax_scene(scene)
    fn = _jax_render_fn(TINY)
    lp = jlpips.get_lpips_params()
    _, jtest = _jax_cameras(TINY)
    psnrs, ssims, lps = [], [], []
    for cam, gt in zip(jtest, gts):
        img = jnp.clip(fn(js, cam), 0, 1)
        jgt = jnp.asarray(gt.numpy())
        psnrs.append(float(jlosses.psnr(img, jgt)))
        ssims.append(float(jlosses.ssim(img, jgt)))
        lps.append(float(jlpips.lpips(lp, img, jgt)))
    assert 5.0 < got["PSNR"] < 40.0
    assert got["PSNR"] == pytest.approx(float(np.mean(psnrs)), abs=1e-4)
    assert got["SSIM"] == pytest.approx(float(np.mean(ssims)), abs=1e-6)
    assert got["LPIPS"] == pytest.approx(float(np.mean(lps)), rel=1e-5)
    assert 0 < got["max_instances"] < TINY.max_inst


def test_eval_scene_fails_loudly_at_the_instance_cut(tiny_dataset):
    ws, target = tiny_dataset
    test_cams, gts = eh.load_test_gt(TINY, ws, "cpu")
    cut = dataclasses.replace(TINY, max_inst=64)
    with pytest.raises(RuntimeError, match="instance buffer overflow"):
        eh.eval_scene(target, test_cams, gts, cut, "cut")


@pytest.fixture(scope="module")
def whole_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e_hard_run")
    return root, eh.run(RUN, root, "cpu")


LABELS = ("[1]", "[1b]", "[2c]", "[2d]", "[2s]", "[2t]", "[2]", "[2b]", "[3]", "[4]", "[7]")


def test_whole_run_has_every_row_and_criterion(whole_run):
    root, r = whole_run
    assert [row[0].split(" ")[0] for row in r["rows"]] == list(LABELS)
    for _, m, size, n in r["rows"]:
        assert np.isfinite([m["PSNR"], m["SSIM"], m["LPIPS"]]).all() and size > 0 and n > 0
    assert len(r["criteria"]) == 8 and r["ok"] == all(ok for _, ok, _ in r["criteria"])
    report = r["report"].read_text()
    assert r["report"] == root / "E2E_hard_tinyrun.md"
    for label in LABELS:
        assert f"| {label} " in report
    for name, ok, value in r["criteria"]:
        assert f"| {name} | {'PASS' if ok else 'FAIL'} | {value} |" in report
    stages = [s["stage"] for s in r["stages"]]
    for stage in ("dataset", "[1] train", "[1b] finetune", "[2c] prune", "[2d] prune", "[2s] finetune",
                  "[2t] finetune", "[2] finetune", "[2b] finetune", "[4] distill", "[7] vectree"):
        assert stage in stages
        assert f"| {stage} |" in report


def test_whole_run_writes_every_artifact(whole_run):
    root, r = whole_run
    ws = eh.Workspace(root, RUN)
    t, ft, fts = RUN.train_iters, RUN.train_iters + RUN.ft_iters, RUN.train_iters + RUN.ft_short
    dl_end = ft + RUN.distill_iters
    for p in (ws.scene / "points3d.ply", ws.model / f"chkpnt{t}.npz",
              ws.model / f"point_cloud/iteration_{t}/point_cloud.ply",
              ws.variant("_ctrl") / f"point_cloud/iteration_{ft}/point_cloud.ply",
              ws.variant("_pf_s") / f"point_cloud/iteration_{fts}/point_cloud.ply",
              ws.variant("_pf_op_s") / f"point_cloud/iteration_{fts}/point_cloud.ply",
              ws.variant("_pf") / f"chkpnt{ft}.npz", ws.variant("_pf_op") / f"point_cloud/iteration_{ft}/point_cloud.ply",
              root / "e2e_hard_trunc_tinyrun.ply", ws.variant("_distill") / "imp_score.npz",
              ws.variant("_distill") / f"point_cloud/iteration_{dl_end}/point_cloud.ply",
              ws.variant("_distill") / f"point_cloud/iteration_{dl_end + 1}/extreme_saving.zip"):
        assert p.exists(), p
    assert r["f_rest"] == {"[3]": 24, "[4]": 24}


def test_whole_run_prunes_keep_40_percent(whole_run):
    _, r = whole_run
    n1 = r["rows"][0][3]
    assert n1 > 50
    for label, _, _, n in r["rows"][2:]:
        assert abs(n - (1 - eh.PRUNE_RATIO) * n1) <= 1, f"{label}: {n} of {n1}"
    assert r["rows"][1][3] == n1  # the control never prunes


def test_seed_variance_reruns_a_seed_from_the_checkpoint(whole_run):
    root, r = whole_run
    rows = sv.run(RUN, root, "cpu", seeds=(1,))
    assert [row[0] for row in rows] == [0, 1]
    by = {row[0].split(" ")[0]: row[1]["PSNR"] for row in r["rows"]}
    # seed 0 is e2e_hard's own run, reused from disk
    assert rows[0][1:] == pytest.approx((by["[2s]"], by["[2t]"], by["[1b]"]), abs=1e-9)
    assert np.isfinite(rows[1][1:]).all()
    ws = eh.Workspace(root, RUN)
    assert ws.variant("_pf_s_seed1").is_dir() and ws.variant("_ctrl_seed1").is_dir()
    assert "## Seed-variance footnote (preset tinyrun)" in ws.report.read_text()


def test_seed_variance_needs_the_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="run `python -m lightgaussian_tpu_torch.scripts.e2e_hard"):
        sv.run(RUN, tmp_path, "cpu")
