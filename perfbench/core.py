"""What every cell's run shares: finding its files by name, the card, the
measured window, the traced reading, and the result line.

A run is one process: set-up (the traffic's constructor), one window of
`--seconds` in a closed loop, and, with `--trace 1`, after that window a
short window under `torch.profiler` and one with the program's stage marks
on; then the program's state is freed and the traffic's check runs its
reference. The end-to-end numbers come from the host clock around work that
ends in a synchronise; the per-layer ones from the trace, the stage marks
and the counting.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

PERFBENCH = Path(__file__).resolve().parent
ROOT = PERFBENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lightgaussian_tpu")

# Units the traced reading averages over.
PROFILED_UNITS = {"step": 5, "frame": 10}
MARKED_UNITS = {"step": 10, "frame": 20}
TOP = 10
# Seconds a profiler session of a window measured by the device trace lasts.
CHUNK_S = 2.0

# The device name of each blend kernel's main launch, by its launch name (as
# torch.profiler demangles it, or mangled).
KERNELS = {
    "blend_forward": r"blend_tile_kernel<true, false>|blend_tile_kernelILb1ELb0E",
    "blend_forward_fast": r"blend_tile_kernel<false, false>|blend_tile_kernelILb0ELb0E",
    "blend_backward": r"blend_backward_kernel",
}
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime")


class RunError(Exception):
    """A run that cannot give a result; its message goes to standard error."""


def load_module(path: Path):
    """The module in `path`, loaded by its file name (names may hold dots)."""
    if not path.is_file():
        raise RunError(f"{path} not found")
    spec = importlib.util.spec_from_file_location("perfbench_" + re.sub(r"\W", "_", path.stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise RunError(f"{path} not found")
    return json.loads(path.read_text())


class Cell:
    """One entry of BENCHMARK.json's workloads with its files."""

    def __init__(self, name: str):
        self.bench = read_json(ROOT / "BENCHMARK.json")
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            raise RunError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = found[0]
        self.spec = read_json(PERFBENCH / "workloads" / f"{name}.json")
        self.config = read_json(PERFBENCH / "configs" / f"{self.entry['config']}.json")
        self.traffic_path = PERFBENCH / "traffic" / f"{self.entry['traffic']}.py"
        self.e2e = [m for m in self.bench["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.e2e}
        self.per_layer = [m for m in self.bench["per_layer"]
                          if name in m.get("workloads", [name] if m["moves"] in reported else [])]

    def traffic(self):
        return load_module(self.traffic_path)

    def reader(self, metric: str):
        return load_module(PERFBENCH / "metrics" / f"{metric}.py").read


def require_cuda(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        raise RunError("CUDA is not available: the benchmark measures the card and does not fall back to the CPU")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell needs {chips} card(s), {torch.cuda.device_count()} visible")
    return torch.device("cuda", 0)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=False).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi failed: {err}"
    return out.splitlines()[0] if out else "nvidia-smi gave nothing"


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(traffic, seconds: float, device: torch.device):
    """Units back to back until `seconds` have passed, the last one
    included, then a synchronise: (host seconds of each unit's call, wall
    seconds of the whole window)."""
    sync(device)
    times = []
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        t0 = time.perf_counter()
        traffic.one()
        t1 = time.perf_counter()
        times.append(t1 - t0)
        if t1 >= deadline:
            break
    sync(device)
    return times, time.perf_counter() - start


def _session(device: torch.device):
    """A profiler session of `device`'s activity alone (the CPU stands in
    for the card in the tests). The autograd profiler, which
    `torch.profiler.profile` wraps, is used directly: the wrapper's first
    start imports `torch._inductor`, seconds of set-up."""
    on_card = device.type == "cuda"
    return torch.autograd.profiler.profile(use_kineto=True, use_cpu=not on_card,
                                           use_device="cuda" if on_card else None)


def device_busy_s(results, device: torch.device) -> float:
    """Seconds in which an operation ran on `device` in a finished session's
    `kineto_results`: the union of its events' intervals (kernels, memcpys
    and memsets on the card)."""
    kind = torch.autograd.DeviceType.CUDA if device.type == "cuda" else torch.autograd.DeviceType.CPU
    spans = np.array([(e.start_ns(), e.duration_ns()) for e in results.events() if e.device_type() == kind],
                     dtype=np.int64).reshape(-1, 2)
    if not len(spans):
        return 0.0
    spans = spans[np.argsort(spans[:, 0], kind="stable")]
    t0, t1 = spans[:, 0], spans[:, 0] + spans[:, 1]
    reach = np.maximum.accumulate(t1)  # the latest end of the intervals so far
    before = np.concatenate(([t0[0]], reach[:-1]))
    return float(np.sum(np.maximum(reach - np.maximum(t0, before), 0))) * 1e-9


def profiled_window(traffic, seconds: float, device: torch.device, chunk_s: float = CHUNK_S):
    """`window` with every unit under the profiler, the device's activity
    only, in sessions of about `chunk_s` (a session's events are read when it
    stops, which takes about as long again): (host seconds of each unit's
    call, wall seconds of the whole window, seconds the device was busy over
    all the units)."""
    sync(device)
    times, busy = [], 0.0
    start = time.perf_counter()
    deadline = start + seconds
    done = False
    while not done:
        with _session(device) as prof:
            end = time.perf_counter() + chunk_s
            while True:
                t0 = time.perf_counter()
                traffic.one()
                t1 = time.perf_counter()
                times.append(t1 - t0)
                done = t1 >= deadline
                if done or t1 >= end:
                    break
            sync(device)
        busy += device_busy_s(prof.kineto_results, device)
    return times, time.perf_counter() - start, busy


def warm_profiler(traffic, device: torch.device) -> None:
    """One unit under the profiler, so that its first session's start-up
    falls in set-up."""
    with _session(device) as prof:
        traffic.one()
        sync(device)
    device_busy_s(prof.kineto_results, device)


def trace_summary(trace_json: Path) -> dict:
    """From a `torch.profiler` Chrome trace, in seconds: the device's busy
    time (the union of kernel, memcpy and memset intervals), kernel launches,
    each blend kernel's time (`KERNELS`), the top device ops by time, and the
    longest idle gaps with the deepest host op running where each began."""
    events = json.loads(trace_json.read_text())
    events = events.get("traceEvents", []) if isinstance(events, dict) else events
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]), str(e.get("name", "")))
        if cat in _DEVICE_CATS:
            device.append((*span, cat))
        elif cat in _HOST_CATS:
            host.append(span)
    device.sort()
    merged: list[list[float]] = []
    for t0, t1, _, _ in device:
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    totals: dict[str, float] = {}
    launches = 0
    kernel_s = {k: 0.0 for k in KERNELS}
    for t0, t1, name, cat in device:
        totals[name] = totals.get(name, 0.0) + (t1 - t0)
        if cat == "kernel":
            launches += 1
            for k, pat in KERNELS.items():
                if re.search(pat, name):
                    kernel_s[k] += (t1 - t0) * 1e-6

    def host_op_at(t):
        enclosing = [(t0, -(t1 - t0), name) for t0, t1, name in host if t0 <= t < t1]
        return max(enclosing)[2] if enclosing else "no host op"

    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]), reverse=True)[:TOP]
    top = sorted(totals, key=totals.get, reverse=True)[:TOP]
    return {
        "busy_s": sum(t1 - t0 for t0, t1 in merged) * 1e-6,
        "launches": launches,
        "kernel_s": kernel_s,
        "device_ops": [[name, totals[name] * 1e-6] for name in top],
        "idle_gaps": [[host_op_at(start), length * 1e-6] for length, start in gaps],
    }


class Reading:
    """What the per-layer readers read: the unit ("step" or "frame"), the
    unprofiled wall time a unit, the profiled window's trace, the stage
    marks a unit and the counted work of the profiled units."""

    def __init__(self, unit, wall_per_unit_s, profiled_units, window_s, trace, marks, peak_bytes, counted):
        self.unit = unit
        self.peak_bytes = peak_bytes  # the device's peak before the counting ran
        self.wall_per_unit_s = wall_per_unit_s
        self.profiled_units = profiled_units
        self.window_s = window_s
        self.trace = trace
        self.marks = marks  # [{stage: ms}] one a marked unit
        self.kernel_least_s, self.unit_least_s = counted  # {kernel: s} over the profiled units; s a unit

    def stage_ms(self, *stages: str):
        """Mean ms a unit of the marked stages, or None where no marked unit
        has any of them."""
        if not any(s in m for m in self.marks for s in stages):
            return None
        return statistics.fmean(sum(m.get(s, 0.0) for s in stages) for m in self.marks)

    def idle_share(self, unit: str):
        if self.unit != unit:
            return None
        return 100.0 * (1.0 - self.trace["busy_s"] / self.profiled_units / self.wall_per_unit_s)

    def launches(self, unit: str):
        return self.trace["launches"] / self.profiled_units if self.unit == unit else None

    def roofline(self, unit: str, *kernels: str):
        """% of the kernels' device time that their least time is."""
        if self.unit != unit:
            return None
        spent = sum(self.trace["kernel_s"][k] for k in kernels)
        least = sum(self.kernel_least_s.get(k, 0.0) for k in kernels)
        return 100.0 * least / spent if spent > 0 and least > 0 else None

    def mfu(self, unit: str):
        return 100.0 * self.unit_least_s / self.wall_per_unit_s if self.unit == unit else None


def traced(traffic, seconds: float, device: torch.device) -> Reading:
    """The traced run's reading, after an unprofiled window of its own."""
    from lightgaussian_tpu_torch.utils import stage_marks

    times, wall = window(traffic, seconds, device)
    wall_per_unit = wall / len(times)

    k = PROFILED_UNITS[traffic.unit]
    traffic.record(True)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            sync(device)
            t0 = time.perf_counter()
            for _ in range(k):
                traffic.one()
            sync(device)
            window_s = time.perf_counter() - t0
        prof.export_chrome_trace(str(path))
        trace = trace_summary(path)
    traffic.record(False)

    marks = []
    for _ in range(MARKED_UNITS[traffic.unit]):
        stage_marks.start(device)
        traffic.one()
        sync(device)
        per = {}
        for stage, ms in stage_marks.stop():
            per[stage] = per.get(stage, 0.0) + ms
        marks.append(per)
    return Reading(traffic.unit, wall_per_unit, k, window_s, trace, marks, peak_bytes(device), traffic.counted())


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def checks_line(checks: dict) -> dict:
    return {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}


def emit(result: dict, checks: dict) -> None:
    """The checks as the last lines on standard error, and the result as the
    last line on standard output, its checks under the last key."""
    for name, (v, lim) in checks.items():
        print(f"check {name}: {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks_line(checks)}), flush=True)


def env_for_caches() -> None:
    """Kernel caches inside the checkout, at a fixed path: the port builds its
    CUDA libraries into its own `build/`; a Triton kernel would cache here."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
