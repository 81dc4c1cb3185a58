"""The span reader on a hand-written Chrome trace, its operator run at a
tiny size on the CPU, and a traced run's metrics with the distillation
step's marks."""
from __future__ import annotations

import argparse
import json

import pytest
import torch

from perfbench import core, run, spans
from perfbench.tests.conftest import tiny_cell

CPU = torch.device("cpu")
SEED = 2**31 + 23
HOST, AUTOGRAD = 1, 2  # the forward thread and the autograd engine's


def _x(name, cat, ts, dur, tid=HOST, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid, "args": args}


def _launch(ts, corr, tid=HOST, name="cudaLaunchKernel"):
    return _x(name, "cuda_runtime", ts, 2, tid=tid, correlation=corr)


def _kernel(t0, t1, corr, cat="kernel"):
    return _x("k", cat, t0, t1 - t0, tid=7, pid=0, correlation=corr)


def _unit(n, at, second_binning_kernel=True):
    """One step: binning with two kernels (overlapping) and a memcpy, a
    preprocess whose pieces each launch one kernel forward, and backward
    nodes linked by sequence number. `at` shifts every time, `n` every
    correlation."""
    c = 100 * n
    ev = [
        _x(f"lg/step#{n}", "user_annotation", 0, 1000),
        _x("aten::add", "cpu_op", 50, 5, **{"Sequence number": c + 3}),  # outside every piece
        _x("lg/binning", "user_annotation", 100, 200),
        _launch(110, c + 1), _kernel(400, 450, c + 1),
        _launch(200, c + 3, name="cudaMemcpyAsync"), _kernel(510, 520, c + 3, cat="gpu_memcpy"),
        _x("lg/projection", "user_annotation", 500, 300),
        _x("aten::mul", "cpu_op", 510, 4, **{"Sequence number": c + 7}),
        _launch(512, c + 4), _kernel(600, 630, c + 4),
        _x("lg/covariance", "user_annotation", 520, 80),
        _x("aten::exp", "cpu_op", 530, 4, **{"Sequence number": c + 8}),
        _launch(532, c + 5), _kernel(640, 700, c + 5),
        _x("lg/sh", "user_annotation", 600, 100),
        _x("aten::add", "cpu_op", 610, 4, **{"Sequence number": c + 9}),  # makes no node: the next op does
        _x("aten::sum", "cpu_op", 650, 4, **{"Sequence number": c + 9}),
        _launch(652, c + 6), _kernel(700, 705, c + 6),
        _x("autograd::engine::evaluate_function: ExpBackward0", "cpu_op", 850, 50, tid=AUTOGRAD,
           **{"Sequence number": c + 8}),
        _launch(860, c + 7, tid=AUTOGRAD), _kernel(900, 940, c + 7),
        _x("autograd::engine::evaluate_function: SumBackward0", "cpu_op", 900, 50, tid=AUTOGRAD,
           **{"Sequence number": c + 9}),
        _x("SumBackward0", "cpu_op", 901, 40, tid=AUTOGRAD, **{"Sequence number": c + 9}),
        _launch(910, c + 8, tid=AUTOGRAD), _kernel(950, 960, c + 8),
        _x("autograd::engine::evaluate_function: AddBackward0", "cpu_op", 960, 20, tid=AUTOGRAD,
           **{"Sequence number": c + 3}),
        _launch(965, c + 9, tid=AUTOGRAD), _kernel(980, 990, c + 9),
        _x("lg/binning", "gpu_user_annotation", 400, 120, tid=7, pid=0),
    ]
    if second_binning_kernel:
        ev += [_launch(120, c + 2), _kernel(440, 500, c + 2)]
    for e in ev:
        e["ts"] += at
    return ev


def _write(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_read_a_hand_written_trace(tmp_path):
    outside = [_launch(5000, 999), _kernel(5000, 5100, 999)]  # no unit holds its launch
    got = spans.read(_write(tmp_path, _unit(0, 0) + _unit(1, 2000, second_binning_kernel=False) + outside), 1)
    assert got["units"] == 2
    # unit 0: kernels 400-450 and 440-500 and the memcpy 510-520, 110 us; unit 1 without the second kernel, 60 us
    assert got["binning_ms"] == pytest.approx((0.110 + 0.060) / 2)
    assert got["binning_launches"] == 1.5
    # forward 30, 60, 5 us; backward: ExpBackward0 to covariance (40), SumBackward0 to sh (10); AddBackward0's
    # maker lies outside every piece
    assert got["piece_ms"] == pytest.approx({"sh": 0.015, "covariance": 0.100, "projection": 0.030})


def test_read_checks_the_units_and_reads_none_without_them(tmp_path):
    events = _unit(0, 0)
    assert spans.read(_write(tmp_path, [e for e in events if not e["name"].startswith("lg/")]), 1) is None
    with pytest.raises(ValueError, match="lg/step#0 sh"):
        spans.read(_write(tmp_path, [e for e in events if e["name"] != "lg/sh"]), 1)
    with pytest.raises(ValueError, match="binning"):
        spans.read(_write(tmp_path, events), 2)


def test_busy_is_the_union():
    assert spans.busy_ms([(0, 10), (5, 15), (30, 35), (31, 32)]) == pytest.approx(0.020)
    assert spans.busy_ms([]) == 0.0


@pytest.mark.parametrize("cell,renders", [("train-3dgs-m360", 1), ("distill-lg-m360", 2),
                                          ("serve-lg-m360-orbit", 1)])
def test_measure_at_a_tiny_size(cell, renders):
    c = tiny_cell(cell)
    traffic = c.traffic().Traffic(c.config, c.spec, SEED, CPU)
    got = spans.measure(c, traffic, CPU, 0.2)
    prefix = {"train-3dgs-m360": "train", "distill-lg-m360": "distill", "serve-lg-m360-orbit": "serve.compressed"}[cell]
    assert got["units"] == core.PROFILED_UNITS[traffic.unit] and got["renders"] == renders
    assert got[f"{prefix}.binning_launches"] == 0  # no device work on the CPU
    assert got[f"{prefix}.binning_idle_ms"] == got[f"{prefix}.binning_ms"] > 0
    assert {f"{prefix}.{p}_ms" for p in spans.PIECES} <= set(got)
    for key in ("wall_ms.spans_off", "wall_ms.spans_on", "profiled_ms.spans_off", "profiled_ms.spans_on"):
        assert len(got[key]) == spans.TURNS.count(key.endswith("on")) and min(got[key]) > 0
    assert got["synced_ms"] > 0 and set(got["span_us"]) == {"no_profiler", "profiler"}
    assert got["launches.spans_on"] == got["launches.spans_off"] == 0


def test_traced_run_reports_the_distillation_stages():
    args = argparse.Namespace(workload="distill-lg-m360", seed=SEED, seconds=0.2, trace=1)
    result, _ = run.run(args, device=CPU, cell=tiny_cell("distill-lg-m360"))
    wanted = {m["name"] for m in core.Cell("distill-lg-m360").per_layer}
    assert set(result["metrics"]) <= wanted
    assert {"distill.preprocess_ms", "distill.loss_ms", "distill.adam_ms", "distill.binning_ms"} <= set(
        result["metrics"])
