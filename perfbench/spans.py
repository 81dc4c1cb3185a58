"""The program's spans in a `torch.profiler` Chrome trace, read per unit.

With `utils.stage_marks.trace(True)` the port names each step
`lg/step#<n>` and each frame that no step encloses `lg/frame#<n>`, and
inside a unit puts `lg/binning` around each binning and `lg/projection`,
with `lg/covariance` and `lg/sh` nested in it, around each preprocess
(`user_annotation` events). `read` gives, over the trace's units:

- binning: the device busy time (union of kernel, memcpy and memset
  intervals) and the kernel launches of the work launched inside
  `lg/binning`. A launch (`cuda_runtime` or `cuda_driver` event) is matched
  to its device work by `correlation`.
- each preprocess piece: the device busy time of the work its forward ops
  launched (inside the innermost piece span on the launching thread), and of
  the work launched by the autograd backward nodes linked to those ops. A
  backward node (`autograd::engine::evaluate_function: ...`) carries the
  `Sequence number` of the op that made it; an op that makes no node carries
  the number the next one will take, so a number's maker is the last forward
  op that carries it (one forward thread).

It checks that every unit holds `renders` of `lg/binning` and of each piece.
A trace without units (a program without the spans) reads None.

    python3 -m perfbench.spans --workload <cell> --seed <n> --seconds <s>

from the root of a checkout on a card runs the cell's set-up, then windows
of `--seconds` with the spans off and on in turns (`TURNS`), units with the
stage marks on, and profiled sessions of its units with the spans off and
on in turns. It prints one JSON line: the readings above a unit under the
cell's metric prefix, `<prefix>.binning_idle_ms` (the marks' "binning" less
the busy time in `lg/binning`), the marks' stages, and what the spans cost:
the ms a unit of each window and session, the kernel launches a unit of a
session each way, and the us an empty span takes the host.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import re
import statistics
import sys
import tempfile
import time
from pathlib import Path

PIECES = ("sh", "covariance", "projection")
UNIT = re.compile(r"lg/(step|frame)#\d+$")
_BACKWARD = "autograd::engine::evaluate_function: "
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TURNS = (False, True, True, False, False, True)  # the windows' spans, off and on in turns


def busy_ms(intervals) -> float:
    """ms covered by the union of (start, end) intervals in us."""
    total, reach = 0.0, float("-inf")
    for t0, t1 in sorted(intervals):
        if t1 > reach:
            total += t1 - max(t0, reach)
            reach = t1
    return total * 1e-3


class _Nested:
    """Host intervals of one thread, properly nested: the innermost that
    holds a time."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: s[0])
        self.starts = [s[0] for s in self.spans]
        self.longest = max((t1 - t0 for t0, t1, _ in self.spans), default=0.0)

    def at(self, t):
        i = bisect.bisect_right(self.starts, t)
        while i > 0:
            i -= 1
            t0, t1, what = self.spans[i]
            if t0 < t - self.longest:
                break
            if t < t1:
                return what
        return None


def _events(trace_json: Path) -> list:
    events = json.loads(Path(trace_json).read_text())
    events = events.get("traceEvents", []) if isinstance(events, dict) else events
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def read(trace_json: Path, renders: int) -> dict | None:
    """{"units", "binning_ms", "binning_launches", "piece_ms": {piece: ms}}
    a unit, from the trace's units; None where it has none."""
    units, binning, pieces, backward, launches = [], {}, {}, {}, []
    makers, device = {}, {}
    for e in _events(trace_json):
        cat, name, args = str(e.get("cat", "")).lower(), str(e.get("name", "")), e.get("args") or {}
        t0 = float(e["ts"])
        span = (t0, t0 + float(e["dur"]))
        thread = (e.get("pid"), e.get("tid"))
        if cat == "user_annotation" and name.startswith("lg/"):
            if UNIT.match(name):
                units.append((*span, name))
            elif name == "lg/binning":
                binning.setdefault(thread, []).append((*span, "binning"))
            elif name[3:] in PIECES:
                pieces.setdefault(thread, []).append((*span, name[3:]))
        elif cat == "cpu_op" and "Sequence number" in args:
            seq = args["Sequence number"]
            if name.startswith(_BACKWARD):
                backward.setdefault(thread, []).append((*span, seq))
            elif "Backward" not in name and (seq not in makers or makers[seq][0] <= t0):
                makers[seq] = (t0, thread)
        elif cat in _LAUNCH_CATS and "correlation" in args:
            launches.append((t0, thread, args["correlation"]))
        elif cat in _DEVICE_CATS and "correlation" in args:
            device.setdefault(args["correlation"], []).append((*span, cat))
    if not units:
        return None
    units.sort()
    binning = {k: _Nested(v) for k, v in binning.items()}
    nested = {k: _Nested(v) for k, v in pieces.items()}
    backward = {k: _Nested(v) for k, v in backward.items()}

    def piece_at(thread, t):
        return nested[thread].at(t) if thread in nested else None

    piece_of_seq = {seq: piece_at(thread, t) for seq, (t, thread) in makers.items()}
    _check(units, binning, pieces, renders)

    starts = [u[0] for u in units]
    per = [{"binning": [], "launches": 0, **{p: [] for p in PIECES}} for _ in units]
    for t, thread, corr in launches:
        i = bisect.bisect_right(starts, t) - 1
        if i < 0 or t >= units[i][1] or corr not in device:
            continue
        work = device[corr]
        spans = [(t0, t1) for t0, t1, _ in work]
        if thread in binning and binning[thread].at(t):
            per[i]["binning"] += spans
            per[i]["launches"] += sum(cat == "kernel" for _, _, cat in work)
        piece = piece_at(thread, t)
        if piece is None and thread in backward:
            piece = piece_of_seq.get(backward[thread].at(t))
        if piece is not None:
            per[i][piece] += spans
    return {
        "units": len(units),
        "binning_ms": statistics.fmean(busy_ms(u["binning"]) for u in per),
        "binning_launches": statistics.fmean(u["launches"] for u in per),
        "piece_ms": {p: statistics.fmean(busy_ms(u[p]) for u in per) for p in PIECES},
    }


def _check(units, binning, pieces, renders: int) -> None:
    """Every unit holds `renders` binnings and `renders` of each piece."""
    found = {("binning", u[2]): 0 for u in units}
    found.update({(p, u[2]): 0 for u in units for p in PIECES})
    starts = [u[0] for u in units]
    every = [(s[0], s[2]) for n in binning.values() for s in n.spans]
    every += [(s[0], s[2]) for spans in pieces.values() for s in spans]
    for t, what in every:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < units[i][1]:
            found[(what, units[i][2])] += 1
    wrong = {f"{unit} {what}": n for (what, unit), n in found.items() if n != renders}
    if wrong:
        raise ValueError(f"units without {renders} of each span: {wrong}")


def _marked(traffic, units: int, device, stage_marks, sync):
    """The stage marks of `units` units, each timed on the host to its
    synchronise: ([(stage, ms), ...] a unit, host ms a unit)."""
    runs, host = [], []
    for _ in range(units):
        stage_marks.start(device)
        t0 = time.perf_counter()
        traffic.one()
        sync(device)
        host.append(1e3 * (time.perf_counter() - t0))
        runs.append(stage_marks.stop())
    return runs, host


def _profiled(traffic, units: int, device, sync, path: Path | None = None):
    """`units` units under `torch.profiler`, the trace written to `path` if
    given: ms a unit on the host's clock."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        sync(device)
        t0 = time.perf_counter()
        for _ in range(units):
            traffic.one()
        sync(device)
        unit_ms = 1e3 * (time.perf_counter() - t0) / units
    if path is not None:
        prof.export_chrome_trace(str(path))
    return unit_ms


def span_us(stage_marks, n: int = 5000) -> dict:
    """us of the host's time a span takes with the spans on, an empty one
    entered and left `n` times, without and under a profiler."""
    import torch

    got = {}
    stage_marks.trace(True)
    try:
        for under in (False, True):
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) if under else contextlib.nullcontext():
                t0 = time.perf_counter()
                for _ in range(n):
                    with stage_marks.span("cost"):
                        pass
                got["profiler" if under else "no_profiler"] = 1e6 * (time.perf_counter() - t0) / n
    finally:
        stage_marks.trace(False)
    return got


def measure(cell, traffic, device, seconds: float) -> dict:
    """The spans' readings of `cell` and what they cost (see the module's
    docstring); `traffic` is the cell's, after its set-up."""
    from lightgaussian_tpu_torch.utils import stage_marks

    from perfbench import core

    prefix = next(m["name"][: -len(".binning_ms")] for m in cell.per_layer if m["name"].endswith(".binning_ms"))
    out = {}
    walls = {False: [], True: []}
    for on in TURNS:  # the host's cost of the spans, no profiler running
        stage_marks.trace(on)
        times, wall = core.window(traffic, seconds, device)
        walls[on].append(1e3 * wall / len(times))
    stage_marks.trace(False)
    runs, host = _marked(traffic, core.MARKED_UNITS[traffic.unit], device, stage_marks, core.sync)
    stages = {}
    for run in runs:
        for stage, ms in run:
            stages[stage] = stages.get(stage, 0.0) + ms / len(runs)
    out["stages_ms"] = stages
    out["marked_ms"] = statistics.fmean(sum(ms for _, ms in run) for run in runs)
    out["synced_ms"] = statistics.fmean(host)
    renders = sum(stage == "binning" for stage, _ in runs[0])

    k = core.PROFILED_UNITS[traffic.unit]
    profiled = {False: [], True: []}
    with tempfile.TemporaryDirectory() as tmp:
        kept = {False: Path(tmp) / "off.json", True: Path(tmp) / "on.json"}
        for i, on in enumerate(TURNS):  # the first session (spans off) and the last (on) are kept
            stage_marks.trace(on)
            try:
                path = kept[on] if i in (0, len(TURNS) - 1) else None
                profiled[on].append(_profiled(traffic, k, device, core.sync, path))
            finally:
                stage_marks.trace(False)
        for on, path in kept.items():
            out[f"launches.spans_{'on' if on else 'off'}"] = core.trace_summary(path)["launches"] / k
        if read(kept[False], renders) is not None:
            raise core.RunError("a session with the spans off recorded lg/ units")
        got = read(kept[True], renders)
    if got is None:
        raise core.RunError("the trace holds no lg/ unit: the program makes no spans")
    for on in (False, True):
        tag = "on" if on else "off"
        out[f"wall_ms.spans_{tag}"] = walls[on]
        out[f"profiled_ms.spans_{tag}"] = profiled[on]
    out["span_us"] = span_us(stage_marks)
    out[f"{prefix}.binning_ms"] = stages.get("binning")
    out[f"{prefix}.binning_idle_ms"] = stages.get("binning", 0.0) - got["binning_ms"]
    out[f"{prefix}.binning_launches"] = got["binning_launches"]
    out[f"{prefix}.binning_busy_ms"] = got["binning_ms"]
    for piece, ms in got["piece_ms"].items():
        out[f"{prefix}.{piece}_ms"] = ms
    out["units"], out["renders"] = got["units"], renders
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    from perfbench import core

    core.env_for_caches()
    try:
        cell = core.Cell(args.workload)
        device = core.require_cuda(cell.entry["chips"])
        traffic = cell.traffic().Traffic(cell.config, cell.spec, args.seed, device)
        out = measure(cell, traffic, device, args.seconds)
    except core.RunError as err:
        print(f"perfbench.spans: {err}", file=sys.stderr)
        return 2
    print(f"card and power limit: {core.power_limit()}", file=sys.stderr)
    print(json.dumps({"workload": args.workload, "seed": args.seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
