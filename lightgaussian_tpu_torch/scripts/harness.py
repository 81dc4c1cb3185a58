"""What the end-to-end scripts share: the card's name, per-call timing, a log
of each stage's wall time, iterations and kernel launches (the counters of
`utils/cuda_build.py`'s kernel table), and a read-through of a
`torch.profiler` Chrome trace.

Times on a card come from CUDA events; on the CPU (`--device cpu`, for tests
at small sizes) from the host clock, and every report says which: a CPU
number is never a card measurement.
"""
from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from lightgaussian_tpu_torch.utils import cuda_build


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


def host_ms_per_call(fn, device: torch.device, reps: int = 20, warmup: int = 3) -> float:
    """Median host-clock time of `fn` over `reps` calls, each between two
    synchronises, after `warmup`: what a caller that waits for the result
    pays, launch and synchronise latency included."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


class StageLog:
    """Each stage's wall time (synchronised), iterations and kernel launches."""

    def __init__(self, device: torch.device):
        self.device = device
        self.rows: list[dict] = []

    @contextlib.contextmanager
    def stage(self, name: str, iterations: int = 0):
        sync(self.device)
        before = cuda_build.launch_counts()
        t0 = time.perf_counter()
        yield
        sync(self.device)
        wall = time.perf_counter() - t0
        after = cuda_build.launch_counts()
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


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime")
TOP = 10


def trace_summary(trace_json) -> dict:
    """What a reader of a `torch.profiler` Chrome trace writes down, all
    times in microseconds on the trace's clock:

    - `window`: from the first device event's start to the last one's end;
    - `busy`: the union of the kernel, memcpy and memset intervals over all
      streams (the idle share of a step divides it by a step run without the
      profiler, which slows the host: `profile_step` does);
    - `launches`: kernel events by name, and `hand_written` those of the
      thirteen counted kernels of `cuda_build.KERNELS` by launch counter,
      matched by each row's `device_name`;
    - `top_ops`: the TOP device ops by total time, (name, total, count);
    - `gaps`: the TOP longest idle stretches inside the window, (start,
      length, the host op running when it began: the deepest `cpu_op` or
      `cuda_runtime` span enclosing its start, or None).
    """
    events = json.loads(Path(trace_json).read_text())
    events = events.get("traceEvents", []) if isinstance(events, dict) else events
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""))
        if cat in _DEVICE_CATS:
            device.append((*span, cat))
        elif cat in _HOST_CATS:
            host.append(span)
    device.sort()
    merged = []
    for t0, t1, _, _ in device:
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    window = merged[-1][1] - merged[0][0] if merged else 0.0
    busy = sum(t1 - t0 for t0, t1 in merged)

    def host_op_at(t):
        enclosing = [(t0, -(t1 - t0), name) for t0, t1, name in host if t0 <= t < t1]
        return max(enclosing)[2] if enclosing else None

    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]), reverse=True)[:TOP]
    totals, counts, launches = {}, {}, {}
    for t0, t1, name, cat in device:
        totals[name] = totals.get(name, 0.0) + (t1 - t0)
        counts[name] = counts.get(name, 0) + 1
        if cat == "kernel":
            launches[name] = launches.get(name, 0) + 1
    top = sorted(totals, key=totals.get, reverse=True)[:TOP]
    return {
        "window": window,
        "busy": busy,
        "launches": launches,
        "hand_written": {k.name: sum(c for name, c in launches.items() if re.search(k.device_name, name))
                         for k in cuda_build.KERNELS.values() if k.name},
        "top_ops": [(name, totals[name], counts[name]) for name in top],
        "gaps": [(start, length, host_op_at(start)) for length, start in gaps],
    }
