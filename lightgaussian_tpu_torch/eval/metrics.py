"""Image-set metrics: the `metrics` CLI's core.

Port of `lightgaussian_tpu/eval/metrics.py`: walks the
`<model>/<set>/ours_<iteration>/{renders,gt}` directories the render CLI
writes, computes SSIM (the five-moment blur B7 through `ops.losses.ssim`),
PSNR and LPIPS per view on the device, and writes `results.json` and
`per_view.json` into each model directory. Images are read by
`utils/image_io` (8-bit PNG without PIL).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from lightgaussian_tpu_torch.eval.lpips import LPIPS, get_lpips_params
from lightgaussian_tpu_torch.ops import losses
from lightgaussian_tpu_torch.utils import image_io
from lightgaussian_tpu_torch.utils.device import resolve_device


def load_image(path: str | Path, device: str | torch.device = "cuda") -> torch.Tensor:
    """An image file as [3, H, W] float32 in [0, 1] on `device`: gray
    repeated, alpha dropped (PIL's convert("RGB"))."""
    arr = image_io.read_image(path)
    rgb = np.repeat(arr[:, :, :1], 3, axis=2) if arr.shape[2] < 3 else arr[:, :, :3]
    return torch.from_numpy(np.ascontiguousarray(rgb.transpose(2, 0, 1))).to(resolve_device(device)).float() / 255.0


@torch.no_grad()
def evaluate_image_pair(render_img: torch.Tensor, gt_img: torch.Tensor, lpips_params: LPIPS | None = None) -> dict:
    lpips_params = lpips_params or get_lpips_params(device=render_img.device)
    return {
        "SSIM": float(losses.ssim(render_img, gt_img)),
        "PSNR": float(losses.psnr(render_img, gt_img)),
        "LPIPS": float(lpips_params(render_img, gt_img)),
    }


def evaluate_method_dir(method_dir: str | Path, lpips_params: LPIPS | None = None,
                        device: str | torch.device = "cuda") -> tuple[dict, dict]:
    """One `ours_<iteration>` directory -> (mean metrics, per-view metrics)."""
    method_dir = Path(method_dir)
    lpips_params = lpips_params or get_lpips_params(device=device)
    per_view = {"SSIM": {}, "PSNR": {}, "LPIPS": {}}
    for name in sorted(p.name for p in (method_dir / "renders").iterdir()):
        m = evaluate_image_pair(load_image(method_dir / "renders" / name, device),
                                load_image(method_dir / "gt" / name, device), lpips_params)
        for k, v in m.items():
            per_view[k][name] = v
    means = {k: float(np.mean(list(v.values()))) for k, v in per_view.items()}
    means["lpips_kind"] = lpips_params.kind
    return means, per_view


def evaluate_model_paths(model_paths: list[str | Path], lpips_weights=None, set_name: str = "test",
                         device: str | torch.device = "cuda") -> dict:
    """Per model directory, every `<set_name>/ours_*` directory; writes
    results.json and per_view.json there."""
    lpips_params = get_lpips_params(lpips_weights, device=device)
    all_results = {}
    for model_path in model_paths:
        model_path = Path(model_path)
        print(f"Scene: {model_path}")
        full, per_view_full = {}, {}
        for method_dir in sorted((model_path / set_name).iterdir()):
            if not method_dir.name.startswith("ours_"):
                continue
            print(f"Method: {method_dir.name}")
            means, per_view = evaluate_method_dir(method_dir, lpips_params, device)
            print(f"  SSIM : {means['SSIM']:.7f}")
            print(f"  PSNR : {means['PSNR']:.7f}")
            print(f"  LPIPS: {means['LPIPS']:.7f}")
            full[method_dir.name] = means
            per_view_full[method_dir.name] = per_view
        (model_path / "results.json").write_text(json.dumps(full, indent=2))
        (model_path / "per_view.json").write_text(json.dumps(per_view_full, indent=2))
        all_results[str(model_path)] = full
    return all_results
