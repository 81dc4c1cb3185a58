"""Observability: the output directory, TensorBoard scalars, metric.csv.

Port of `lightgaussian_tpu/utils/logging.py`. `prepare_output_dir` makes
the model directory (a uuid name when none is given) and keeps the
configuration as JSON; `MetricsLogger` owns an optional TensorBoard writer
and the append-only `metric.csv` with the JAX package's columns;
`training_report` renders the test set and a train sample at a test
iteration and logs the image metrics, LPIPS with the network's kind
(`vgg-random` unless pretrained weights are found, `eval/lpips.py`).
"""
from __future__ import annotations

import csv
import dataclasses
import json
import statistics
import time
import uuid
from pathlib import Path

import torch

CSV_FIELDS = ["iteration", "set", "l1_loss", "psnr", "ssim", "lpips",
              "lpips_kind", "file_size", "elapsed"]


def prepare_output_dir(model_path: str | None, cfg=None) -> Path:
    if not model_path:
        model_path = f"./output/{str(uuid.uuid4())[:10]}"
    out = Path(model_path)
    out.mkdir(parents=True, exist_ok=True)
    if cfg is not None:
        payload = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else dict(cfg)
        (out / "cfg_args.json").write_text(json.dumps(payload, indent=2, default=str))
    print(f"Output folder: {out}")
    return out


class MetricsLogger:
    """TensorBoard scalars (where the package is installed) and metric.csv
    appends."""

    def __init__(self, model_path: str | Path, enable_tensorboard: bool = True):
        self.model_path = Path(model_path)
        self.csv_path = self.model_path / "metric.csv"
        self.tb = None
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(str(self.model_path))
            except ImportError:
                print("[logging] TensorBoard unavailable; scalars go to metric.csv only")
        if self.csv_path.exists():
            # Resuming into a model dir whose metric.csv has other columns
            # must not append rows that misalign with the old header: park
            # the old file instead.
            with open(self.csv_path, newline="") as f:
                header = next(csv.reader(f), [])
            if header != CSV_FIELDS:
                legacy = self.csv_path.with_name("metric_legacy.csv")
                self.csv_path.rename(legacy)
                print(f"[logging] metric.csv schema changed; old rows moved to {legacy.name}")
        if not self.csv_path.exists():
            with open(self.csv_path, "w", newline="") as f:
                csv.writer(f).writerow(CSV_FIELDS)

    def scalar(self, tag: str, value, step: int) -> None:
        if self.tb is not None:
            self.tb.add_scalar(tag, float(value), int(step))

    def csv_row(self, iteration: int, set_name: str, l1: float, psnr: float,
                ssim: float, lpips: float, file_size_mb: float, elapsed_s: float,
                lpips_kind: str = "vgg-random") -> None:
        with open(self.csv_path, "a", newline="") as f:
            csv.writer(f).writerow(
                [iteration, set_name, f"{l1:.6f}", f"{psnr:.4f}", f"{ssim:.6f}",
                 f"{lpips:.6f}", lpips_kind, f"{file_size_mb:.3f}", f"{elapsed_s:.2f}"]
            )

    def close(self) -> None:
        if self.tb is not None:
            self.tb.close()


def training_report(
    logger: MetricsLogger,
    iteration: int,
    scene_state,
    eval_render_fn,
    test_cameras: list,
    train_cameras_sample: list,
    bg: torch.Tensor,
    elapsed_s: float,
    lpips_params=None,
) -> dict:
    """Evaluate every test camera and the train sample through
    `eval_render_fn` (`train.step.make_eval_render`: one exact render and
    one five-moment SSIM per view) and LPIPS against the clipped ground
    truth, and log the means of L1, PSNR, SSIM and LPIPS to TensorBoard and
    metric.csv. The `file_size` column holds 0: the loop reports before it
    saves, and hands the report no file to weigh."""
    from lightgaussian_tpu_torch.eval.lpips import get_lpips_params

    lpips_params = lpips_params or get_lpips_params(device=bg.device)
    results = {}

    for set_name, cams in (("test", test_cameras), ("train", train_cameras_sample)):
        if not cams:
            continue
        per_view = []
        for cam in cams:
            img, l1, psnr, ssim = eval_render_fn(scene_state, cam, bg)
            lp = lpips_params(img, torch.clamp(cam.gt_image, 0.0, 1.0))
            per_view.append(torch.stack([l1, psnr, ssim, lp]))
        # one transfer for the whole set
        l1s, psnrs, ssims, lpipss = torch.stack(per_view).T.tolist()
        row = {
            "l1": statistics.fmean(l1s),
            "psnr": statistics.fmean(psnrs),
            "ssim": statistics.fmean(ssims),
            "lpips": statistics.fmean(lpipss),
        }
        results[set_name] = row
        print(
            f"[ITER {iteration}] Evaluating {set_name}: L1 {row['l1']:.5f} "
            f"PSNR {row['psnr']:.3f} SSIM {row['ssim']:.4f} LPIPS {row['lpips']:.4f}"
        )
        for k, v in row.items():
            logger.scalar(f"{set_name}/loss_viewpoint - {k}", v, iteration)
        logger.csv_row(iteration, set_name, row["l1"], row["psnr"], row["ssim"],
                       row["lpips"], 0.0, elapsed_s, lpips_kind=lpips_params.kind)
    return results


class StepTimer:
    """Wall time spent in the training sections of a loop. The device works
    through a queue, so a per-step host time says little; `resume()` on
    entering a training section and `pause()` around what is excluded (eval
    renders, saves) give the time the training took."""

    def __init__(self):
        self.total = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.total += dt
        self._t0 = None
        return dt

    def resume(self):
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def pause(self):
        if self._t0 is not None:
            self.stop()
