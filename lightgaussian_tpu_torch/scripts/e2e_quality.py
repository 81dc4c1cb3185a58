"""End-to-end quality run of the whole LightGaussian pipeline on the port.

Port of `scripts/e2e_quality.py`. Builds a synthetic multi-view dataset
(the ground truth is exact renders of a random Gaussian scene), then drives
the port's CLIs in this process:

  train_densify_prune -> prune_finetune (GSS 0.6) -> distill_train (SH 3->2)
  -> vectree VQ (0.6) -> render_sets --load_vq

with `render_sets` and `metrics` after every stage, and reports test
PSNR/SSIM/LPIPS and the model's size after each: on this easy scene prune
and distillation should cost about nothing while the model shrinks. The
stage table goes to `<out_root>/E2E_quality_<preset>.md`.

Usage: python -m lightgaussian_tpu_torch.scripts.e2e_quality [--preset small|large]
           [--device cuda] [--out_root DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from lightgaussian_tpu_torch.cli import distill_train, metrics, prune_finetune, render_sets, \
    train_densify_prune, vectree
from lightgaussian_tpu_torch.data import ply as ply_mod
from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.render.poses import c2w_from_camera
from lightgaussian_tpu_torch.scripts import harness
from lightgaussian_tpu_torch.scripts.e2e_hard import render_checked
from lightgaussian_tpu_torch.utils import image_io
from lightgaussian_tpu_torch.utils.device import resolve_device
from lightgaussian_tpu_torch.utils.synthetic import random_scene


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    width: int
    height: int
    n_target: int
    n_views: int
    train_iters: int
    prune_end: int
    distill_end: int
    densify_until: int
    codebook: int
    n_test_views: int = 4
    densify_from: int = 100
    vq_fit_iters: int = 300


PRESETS = {
    "small": Preset("small", 128, 128, 3000, 16, 800, 1100, 1400, 500, 256),
    "large": Preset("large", 256, 256, 8000, 24, 2000, 2600, 3200, 1200, 1024),
}

FOVX = 0.9
GT_MAX_INSTANCES = 524_288  # the ground truth renders' instance cut


@dataclasses.dataclass(frozen=True)
class Workspace:
    out_root: Path
    preset: Preset

    @property
    def scene(self) -> Path:
        return self.out_root / f"e2e_scene_{self.preset.name}"

    @property
    def model(self) -> Path:
        return self.out_root / f"e2e_model_{self.preset.name}"

    def variant(self, suffix: str) -> Path:
        return Path(str(self.model) + suffix)

    @property
    def report(self) -> Path:
        return self.out_root / f"E2E_quality_{self.preset.name}.md"


def make_dataset(preset: Preset, ws: Workspace, device: torch.device) -> None:
    for p in (ws.scene, ws.model, ws.variant("_pf"), ws.variant("_distill")):
        shutil.rmtree(p, ignore_errors=True)
    target = random_scene(n=preset.n_target, seed=7, max_sh_degree=3, active_sh_degree=3,
                          scale_range=(0.02, 0.08), extent=1.6, device=device)
    def dump(split, n, ang0, elev):
        frames = []
        for i in range(n):
            ang = ang0 + i * (2 * np.pi / n)
            eye = [3.0 * np.sin(ang), elev, -3.0 * np.cos(ang)]
            cam = Camera.look_at(eye=eye, target=[0, 0, 0], width=preset.width, height=preset.height, fovx=FOVX,
                                 device=device)
            out = render_checked(target, cam, GT_MAX_INSTANCES, f"ground truth {split} {i}")
            arr = np.clip(out.render.cpu().numpy().transpose(1, 2, 0) * 255, 0, 255).astype(np.uint8)
            name = f"{split}/r_{i}"
            image_io.write_png(ws.scene / f"{name}.png", arr)
            frames.append({"file_path": f"./{name}", "transform_matrix": c2w_from_camera(cam, blender=True).tolist()})
        (ws.scene / f"transforms_{split}.json").write_text(json.dumps({"camera_angle_x": FOVX, "frames": frames}))

    dump("train", preset.n_views, 0.0, 0.5)
    dump("test", preset.n_test_views, 0.19, 0.7)

    # seed points: subsampled target means (skips the 100k random start)
    idx = np.random.default_rng(0).choice(preset.n_target, preset.n_target // 2, replace=False)
    pts = target.means.cpu().numpy()[idx]
    ply_mod.store_point_cloud(ws.scene / "points3d.ply", pts, np.full((len(idx), 3), 0.5, np.float32))
    print("dataset written", flush=True)


def method_metrics(model_dir: Path, iteration: int) -> dict:
    """The scores of `ours_<iteration>` in the model dir's results.json."""
    return json.loads((model_dir / "results.json").read_text())[f"ours_{iteration}"]


def ply_mb(p: Path) -> float:
    return p.stat().st_size / 1e6


def run(preset: Preset, out_root: Path, device: str | torch.device = "cuda") -> dict:
    """Every stage and the report. Returns {"stages": [(name, metrics, MB)],
    "log": StageLog rows, "report": path}."""
    dev = resolve_device(device)
    flags = ["--device", str(dev), "--quiet"]
    ws = Workspace(Path(out_root), preset)
    log = harness.StageLog(dev)
    t_start = time.time()
    with log.stage("dataset"):
        make_dataset(preset, ws, dev)
    stages = []

    def serve_and_score(model_dir: Path, iteration: int, *extra):
        with log.stage(f"render_sets + metrics ({model_dir.name}, {iteration})"):
            render_sets.main(["-s", str(ws.scene), "-m", str(model_dir), "--iteration", str(iteration),
                              "--eval", "--skip_train", *extra, *flags])
            metrics.main(["-m", str(model_dir), "--device", str(dev)])
        return method_metrics(model_dir, iteration)

    # ---- stage 1: train with densification --------------------------------
    it = preset.train_iters
    with log.stage("train", it):
        train_densify_prune.main([
            "-s", str(ws.scene), "-m", str(ws.model),
            "--iterations", str(it), "--eval",
            "--test_iterations", "1", str(it),
            "--save_iterations", str(it),
            "--checkpoint_iterations", str(it),
            "--densify_from_iter", str(preset.densify_from), "--densification_interval", "100",
            "--densify_until_iter", str(preset.densify_until),
            "--opacity_reset_interval", "10000",
            "--position_lr_max_steps", str(it), "--disable_viewer", *flags,
        ])
    m = serve_and_score(ws.model, it)
    stages.append(("3D-GS train (densify)", m, ply_mb(ws.model / f"point_cloud/iteration_{it}/point_cloud.ply")))
    print("STAGE train:", m, flush=True)

    # ---- stage 2: GSS prune 0.6 + recovery finetune -----------------------
    pf = ws.variant("_pf")
    with log.stage("prune_finetune", preset.prune_end - it):
        prune_finetune.main([
            "-s", str(ws.scene), "-m", str(pf),
            "--start_checkpoint", str(ws.model / f"chkpnt{it}.npz"),
            "--iterations", str(preset.prune_end),
            "--prune_iterations", str(it + 5),
            "--prune_percent", "0.6", "--prune_type", "v_important_score",
            "--eval", "--test_iterations", str(preset.prune_end),
            "--save_iterations", str(preset.prune_end),
            "--checkpoint_iterations", str(preset.prune_end), *flags,
        ])
    m = serve_and_score(pf, preset.prune_end)
    stages.append(("+ GSS prune 60% + finetune", m,
                   ply_mb(pf / f"point_cloud/iteration_{preset.prune_end}/point_cloud.ply")))
    print("STAGE prune:", m, flush=True)

    # ---- stage 3: SH distillation 3 -> 2 ----------------------------------
    dl = ws.variant("_distill")
    with log.stage("distill_train", preset.distill_end - preset.prune_end):
        distill_train.main([
            "-s", str(ws.scene), "-m", str(dl),
            "--start_checkpoint", str(pf / f"chkpnt{preset.prune_end}.npz"),
            "--new_max_sh", "2", "--augmented_view",
            "--iteration_base", str(preset.prune_end),
            "--iterations_total", str(preset.distill_end),
            "--test_iterations", str(preset.distill_end),
            "--save_iterations", str(preset.distill_end),
            "--checkpoint_iterations", str(preset.distill_end),
            "--eval", *flags,
        ])
    dl_ply = dl / f"point_cloud/iteration_{preset.distill_end}/point_cloud.ply"
    m = serve_and_score(dl, preset.distill_end)
    stages.append(("+ SH distill deg 3->2", m, ply_mb(dl_ply)))
    print("STAGE distill:", m, flush=True)

    # ---- stage 4: VecTree VQ 0.6 ------------------------------------------
    vq_dir = dl / f"point_cloud/iteration_{preset.distill_end + 1}"
    with log.stage("vectree", preset.vq_fit_iters):
        vectree.main([
            "--important_score_npz_path", str(dl / "imp_score.npz"),
            "--input_path", str(dl_ply),
            "--save_path", str(vq_dir),
            "--vq_ratio", "0.6", "--codebook_size", str(preset.codebook),
            "--iteration_num", str(preset.vq_fit_iters), "--device", str(dev),
        ])
    m = serve_and_score(dl, preset.distill_end + 1, "--load_vq")
    stages.append(("+ VecTree VQ 60%", m, (vq_dir / "extreme_saving.zip").stat().st_size / 1e6))
    print("STAGE vq:", m, flush=True)

    # ---- report -------------------------------------------------------------
    card = harness.card_line(dev)
    lines = [
        f"# End-to-end quality run, PyTorch/CUDA port (synthetic scene, preset {preset.name})",
        "",
        f"Device: {card}. Dataset: {preset.n_target}-Gaussian synthetic scene, {preset.n_views} train / "
        f"{preset.n_test_views} test views at {preset.width}x{preset.height}; the whole pipeline through the "
        "port's CLIs (`python -m lightgaussian_tpu_torch.scripts.e2e_quality`).",
        "",
        "| Stage | PSNR | SSIM | LPIPS* | model MB |",
        "|---|---|---|---|---|",
    ]
    for name, m, size in stages:
        lines.append(f"| {name} | {m['PSNR']:.2f} | {m['SSIM']:.4f} | {m['LPIPS']:.4f} | {size:.2f} |")
    first_mb, last_mb = stages[0][2], stages[-1][2]
    lines += [
        "",
        f"*LPIPS kind: {stages[-1][1].get('lpips_kind', 'see results.json')}; vgg-random scores are for "
        "relative ordering only, not comparable to published LPIPS values.",
        "",
        f"Compression: {first_mb:.2f} MB -> {last_mb:.2f} MB (**{first_mb / max(last_mb, 1e-9):.1f}x**), "
        f"PSNR {stages[0][1]['PSNR']:.2f} -> {stages[-1][1]['PSNR']:.2f} dB.",
        "",
        "## Stages",
        "",
        *log.table(),
        "",
        f"Total wall-clock: {(time.time() - t_start) / 60:.1f} min ({card}).",
        "",
    ]
    ws.out_root.mkdir(parents=True, exist_ok=True)
    ws.report.write_text("\n".join(lines))
    print("\n".join(lines), flush=True)
    print("E2E QUALITY: ALL OK", flush=True)
    return {"stages": stages, "log": log.rows, "report": ws.report}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="end-to-end quality run of the whole pipeline")
    p.add_argument("--preset", choices=list(PRESETS), default="small")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out_root", type=Path, default=None,
                   help="where the dataset, models and report go (default: the temporary directory)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    run(PRESETS[args.preset], args.out_root or harness.default_out_root(), args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
