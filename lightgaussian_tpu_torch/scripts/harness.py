"""What the end-to-end scripts share: the card's name, per-call timing, the
kernels' launch counts, and a log of each stage's wall time, iterations and
launches.

Times on a card come from CUDA events; on the CPU (`--device cpu`, for tests
at small sizes) from the host clock, and every report says which: a CPU
number is never a card measurement.
"""
from __future__ import annotations

import contextlib
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from lightgaussian_tpu_torch.ops import losses
from lightgaussian_tpu_torch.ops.rasterize import blend
from lightgaussian_tpu_torch.utils import issue_probe


def default_out_root() -> Path:
    """Where a script writes its datasets, models and reports unless told."""
    return Path(tempfile.gettempdir())


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or what the
    host clock times on the CPU."""
    if device.type != "cuda":
        return "cpu (host clock; not a card measurement)"
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60, check=False)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"{torch.cuda.get_device_name(device)} (nvidia-smi failed: {err})"
    lines = proc.stdout.strip().splitlines()
    index = device.index or 0
    if proc.returncode != 0 or len(lines) <= index:
        return f"{torch.cuda.get_device_name(device)} (nvidia-smi failed: {proc.stderr.strip()})"
    return lines[index]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ms_per_call(fn, device: torch.device, reps: int = 20, warmup: int = 3) -> float:
    """Time per call of `fn` over `reps` back-to-back calls after `warmup`:
    CUDA events on a card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def launch_counts() -> dict:
    """Launches of every hand-written kernel so far (a wrapper counts only
    where it launches its kernel: on the CPU all stay 0)."""
    return {**blend.LAUNCHES, **losses.LAUNCHES, **issue_probe.LAUNCHES}


class StageLog:
    """Each stage's wall time (synchronised), iterations and kernel launches."""

    def __init__(self, device: torch.device):
        self.device = device
        self.rows: list[dict] = []

    @contextlib.contextmanager
    def stage(self, name: str, iterations: int = 0):
        sync(self.device)
        before = launch_counts()
        t0 = time.perf_counter()
        yield
        sync(self.device)
        wall = time.perf_counter() - t0
        after = launch_counts()
        self.rows.append({
            "stage": name,
            "wall_s": wall,
            "iterations": iterations,
            "it_per_s": iterations / wall if iterations else None,
            "launches": {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)},
        })

    def table(self) -> list[str]:
        lines = ["| stage | wall s | iterations | it/s | kernel launches |", "|---|---|---|---|---|"]
        for r in self.rows:
            rate = f"{r['it_per_s']:.2f}" if r["it_per_s"] else ""
            launches = ", ".join(f"{k} {v}" for k, v in sorted(r["launches"].items()))
            lines.append(f"| {r['stage']} | {r['wall_s']:.2f} | {r['iterations'] or ''} | {rate} | {launches} |")
        return lines
