"""PyTorch port: the end-to-end quality chain, the render-FPS bench, the
roofline tool and the per-scene run scripts of `lightgaussian_tpu_torch/scripts/`.

- `e2e_quality` whole at a tiny preset on the CPU: every stage scored by
  `render_sets` + `metrics`, the bundle served with `--load_vq`, the report.
- `bench_render_fps` at a tiny size on the CPU: its drift-gated schedule (D)
  equals the JAX package's `plan_rebin_schedule` on the same orbit and
  scene, and its reused frames lie above 45 dB against fresh renders (the
  JAX suite's gate).
- `roofline` sections (b) and (c) on the CPU print finite numbers; (c) has
  the step's stages, each with its byte floor.
- Every `python -m` line of the ported `run_*.sh` names a
  `lightgaussian_tpu_torch.cli` module whose parser accepts its flags: each
  script runs under bash with `python` replaced by a recorder.
- Every script's entry point defaults to the card and raises without one
  (the measurement layer's too: `bench` and the four profilers).
"""
import importlib
import math
import os
import stat
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from lightgaussian_tpu.models.camera import Camera as JCamera
from lightgaussian_tpu.render.sets import plan_rebin_schedule as jplan
from lightgaussian_tpu.utils.synthetic import random_scene as jrandom_scene
from lightgaussian_tpu_torch.ops.rasterize.binning import make_grid
from lightgaussian_tpu_torch.ops.rasterize.projection import preprocess
from lightgaussian_tpu_torch.ops.rasterize.tiled import build_binning
from lightgaussian_tpu_torch.scripts import bench_render_fps, e2e_quality, roofline
from lightgaussian_tpu_torch.utils.device import resolve_device
from lightgaussian_tpu_torch.utils.synthetic import default_camera, random_scene

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "lightgaussian_tpu_torch" / "scripts"
RUN_SCRIPTS = ("run_train_densify_prune", "run_prune_finetune", "run_prune_pt_finetune", "run_distill_finetune",
               "run_vectree_quantize")
QUALITY = e2e_quality.Preset("tiny", 64, 48, 300, 6, 30, 45, 60, 20, 16, n_test_views=2, densify_from=10,
                             vq_fit_iters=10)
BENCH = ["--n", "2000", "--width", "96", "--height", "64", "--frames", "12", "--rebin_every", "4",
         "--device", "cpu"]


@pytest.fixture(scope="module")
def quality_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e_quality")
    return root, e2e_quality.run(QUALITY, root, "cpu")


def test_e2e_quality_scores_every_stage(quality_run):
    root, r = quality_run
    names = [s[0] for s in r["stages"]]
    assert names == ["3D-GS train (densify)", "+ GSS prune 60% + finetune", "+ SH distill deg 3->2",
                     "+ VecTree VQ 60%"]
    for _, m, size in r["stages"]:
        assert np.isfinite([m["PSNR"], m["SSIM"], m["LPIPS"]]).all() and m["lpips_kind"] == "vgg-random"
        assert size > 0
    # the bundle is smaller than the distilled PLY, the pruned PLY than the trained one
    sizes = [s[2] for s in r["stages"]]
    assert sizes[3] < sizes[2] < sizes[0] and sizes[1] < sizes[0]
    report = r["report"].read_text()
    assert r["report"] == root / "E2E_quality_tiny.md"
    for name in names:
        assert f"| {name} |" in report


def test_e2e_quality_serves_each_model_and_the_bundle(quality_run):
    root, _ = quality_run
    ws = e2e_quality.Workspace(root, QUALITY)
    for model, it in ((ws.model, QUALITY.train_iters), (ws.variant("_pf"), QUALITY.prune_end),
                      (ws.variant("_distill"), QUALITY.distill_end), (ws.variant("_distill"), QUALITY.distill_end + 1)):
        renders = sorted((model / "test" / f"ours_{it}" / "renders").glob("*.png"))
        assert len(renders) == QUALITY.n_test_views, (model, it)
        assert (model / "results.json").exists()
    assert (ws.variant("_distill") / f"point_cloud/iteration_{QUALITY.distill_end + 1}/extreme_saving").is_dir()


@pytest.fixture(scope="module")
def bench_run():
    args = bench_render_fps.build_parser().parse_args(BENCH)
    return args, bench_render_fps.run(args)


def test_bench_drift_schedule_matches_jax(bench_run):
    args, r = bench_run
    scene = jrandom_scene(n=args.n, seed=0, extent=2.0, scale_range=(0.004, 0.02), active_sh_degree=args.sh_degree)
    step = 2 * math.pi / args.step_div
    cams = [JCamera.look_at(eye=bench_render_fps.orbit_eye(0.2 + i * step), target=[0, 0, 0], width=args.width,
                            height=args.height, fovx=0.9) for i in range(args.frames)]
    want = jplan(scene, cams, args.rebin_every, args.drift_px)
    assert r["flags_d"] == want
    assert 1 < r["n_rebin"] < args.frames  # some frames rebin, some reuse


def test_bench_reused_frames_match_fresh(bench_run):
    args, r = bench_run
    assert r["worst_psnr"]["C"] > 45.0 and r["worst_psnr"]["D"] > 45.0
    assert all(ms > 0 and math.isfinite(ms) for ms in r["ms"].values())
    assert r["cap_snug"] <= r["cap_default"] and 0 < r["total0"] <= r["cap_snug"]
    assert r["cut"] == {"A": [], "B": []}
    assert r["card"].startswith("cpu (host clock")


@pytest.fixture(scope="module")
def tiny_binning():
    scene = random_scene(n=2000, seed=0, extent=2.0, scale_range=(0.004, 0.02), device="cpu")
    return build_binning(preprocess(scene, default_camera(96, 64, 5.0, device="cpu")), 96, 64, 1 << 16)


def test_roofline_stream_and_gathers_are_finite(tiny_binning, capsys):
    m = roofline.stream_and_gather(resolve_device("cpu"), 1 << 22, tiny_binning.gid_sorted, 2000)
    assert m["stream_bytes"] == 2 << 22 and 0 < m["stream_bytes_per_s"] < math.inf
    assert set(m["gathers"]) == {"binning order", "sorted", "identity"}
    for g in m["gathers"].values():
        assert 0 < g["ms"] < math.inf and 0 < g["ns_per_row"] < math.inf and 0 < g["bytes_per_s"] < math.inf
    out = capsys.readouterr().out
    assert "copy_ of 4 MiB" in out and "GB/s" in out


def test_roofline_step_stages_stand_beside_their_floors(capsys):
    s = roofline.step_stages(resolve_device("cpu"), 96, 64, 2000, 1 << 16, 1e10, reps=2)
    names = ("preprocess", "binning", "B1", "compose", "loss forward", "loss backward", "B2 + reduce",
             "preprocess backward", "Adam", "densify statistics + metrics")
    assert tuple(s["stages"]) == names
    for v in s["stages"].values():
        assert 0 <= v["ms"] < math.inf and v["bytes"] > 0
        assert v["floor_ms_stream"] == pytest.approx(1e3 * v["bytes"] / 1e10)
    assert s["live_instances"] > 0 and s["step_ms"] > s["floor_ms"] > 0
    assert "marked step" in capsys.readouterr().out


def test_roofline_stage_bytes_count_each_operand_once():
    t = make_grid(1920, 1080).num_tiles
    b = roofline.stage_bytes(n=300_000, params_b=300_000 * 59 * 4, splat_b=300_000 * 13 * 4, m=750_000, tiles=t,
                             width=1920, height=1080)
    img = 3 * 1920 * 1080 * 4
    assert b["Adam"] == 7 * 300_000 * 59 * 4
    assert b["loss forward"] == 4 * img and b["loss backward"] == 5 * img
    assert b["B1"] == 750_000 * 36 + 4 * (t + 1) + t * 1024 * 16


def _record_run_script(name: str, tmp_path: Path) -> list[list[str]]:
    bindir, rec = tmp_path / "bin", tmp_path / "rec"
    bindir.mkdir()
    rec.mkdir()
    fake = bindir / "python"
    fake.write_text('#!/bin/bash\nprintf "%s\\0" "$@" > "$RECORD_DIR/$$.args"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    env = {**os.environ, "PATH": f"{bindir}:{os.environ['PATH']}", "RECORD_DIR": str(rec),
           "OUT_ROOT": str(tmp_path / "out"), "DATA_ROOT": str(tmp_path / "data"), "MAX_JOBS": "2"}
    proc = subprocess.run(["bash", str(SCRIPTS / f"{name}.sh"), "bicycle", "garden"], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return [p.read_bytes().decode().split("\0")[:-1] for p in sorted(rec.iterdir())]


@pytest.mark.parametrize("name", RUN_SCRIPTS)
def test_run_script_lines_parse_with_the_port_clis(name, tmp_path):
    text = (SCRIPTS / f"{name}.sh").read_text()
    assert "lightgaussian_tpu.cli" not in text and text.count("python -m lightgaussian_tpu_torch.cli.") == 1
    calls = _record_run_script(name, tmp_path)
    assert len(calls) == 2  # one job a scene
    for argv in calls:
        assert argv[0] == "-m" and argv[1].startswith("lightgaussian_tpu_torch.cli.")
        args = importlib.import_module(argv[1]).build_parser().parse_args(argv[2:])
        assert args.device == "cuda"
    # the operating points of the JAX package's script, value for value
    jax_text = (REPO / "scripts" / f"{name}.sh").read_text()
    strip = lambda s: [line for line in s.splitlines() if not line.startswith("#")]
    assert strip(text) == strip(jax_text.replace("lightgaussian_tpu.cli.", "lightgaussian_tpu_torch.cli."))


MAINS = {
    "e2e_hard": ["--preset", "pilot"],
    "e2e_seed_variance": ["--preset", "hard"],
    "e2e_quality": [],
    "bench_render_fps": [],
    "roofline": [],
    "bench": [],
    "profile_step": [],
    "profile_binning": [],
    "profile_binning_infer": [],
    "profile_bwd": [],
}


@pytest.mark.parametrize("name", list(MAINS))
def test_script_defaults_to_the_card_and_raises_without_one(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"lightgaussian_tpu_torch.scripts.{name}")
    argv = MAINS[name] + (["--out_root", str(tmp_path)] if name not in ("bench_render_fps",) else [])
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv)
    assert list(tmp_path.iterdir()) == []
