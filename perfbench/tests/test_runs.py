"""Whole runs at a tiny size on the CPU: the result line, the absence of JAX,
the faults the check has to catch, and the precision control."""
from __future__ import annotations

import argparse
import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench import core, inputs, run
from perfbench.reference import render as R
from perfbench.reference.train import ALTERED
from perfbench.tests.conftest import CELLS, tiny_cell

CPU = torch.device("cpu")
SEED = 2**31 + 11  # past 32 signed bits


def _run(name, trace=0, seconds=0.2, seed=SEED):
    args = argparse.Namespace(workload=name, seed=seed, seconds=seconds, trace=trace)
    return run.run(args, device=CPU, cell=tiny_cell(name))


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(trace, capsys):
    result, checks = _run("serve-lg-m360-orbit", trace)
    core.emit(result, checks)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    got = json.loads(line)
    assert list(got)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(got)
    assert got["correct"] is True and got["failed"] == 0 and got["attempted"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(got["device"])
    cell = core.Cell("serve-lg-m360-orbit")
    wanted = {m["name"] for m in (cell.per_layer if trace else cell.e2e)}
    assert set(got["metrics"]) <= wanted
    if not trace:
        assert set(got["metrics"]) == wanted
    for m in got["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in got["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(got["device"]) and set(got["breakdown"]) == {"device_ops", "idle_gaps"}


def test_without_a_card_no_result():
    proc = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "train-3dgs-m360", "--seed", "1",
                           "--seconds", "1"], cwd=core.ROOT, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout.strip() == ""


_IMPORT_CHECK = """
import argparse, sys, torch
sys.path.insert(0, {root!r})
from perfbench import core, inputs, run
from perfbench.tests.conftest import tiny_cell
for name in ("train-3dgs-m360", "serve-lg-m360-orbit", "distill-lg-m360"):
    run.run(argparse.Namespace(workload=name, seed=3, seconds=0.1, trace=0), torch.device("cpu"), tiny_cell(name))
print(",".join(core.forbidden_loaded()) or "none")
"""


def test_no_jax_loaded_by_a_run():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_CHECK.format(root=str(core.ROOT))], cwd=core.ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "none"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_imported_by_perfbench_and_reference_standalone():
    for path in core.PERFBENCH.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in core.FORBIDDEN, (path, mod)
            if "reference" in path.parts or "counting" in path.parts:
                assert mod.split(".")[0] != "lightgaussian_tpu_torch", (path, mod)


def _broken_state(monkeypatch):
    from lightgaussian_tpu_torch.train import distill, step

    make, make_d = step.make_train_step, distill.make_distill_step

    def frozen_train(*a, **k):
        fn = make(*a, **k)
        return lambda state, cam, bg: (state, fn(state, cam, bg)[1])

    def frozen_distill(*a, **k):
        fn = make_d(*a, **k)
        return lambda state, teacher, cam, bg: (state, fn(state, teacher, cam, bg)[1])

    monkeypatch.setattr(step, "make_train_step", frozen_train)
    monkeypatch.setattr(distill, "make_distill_step", frozen_distill)


def _half_batch(monkeypatch):
    """Half of what a step averages over (its image's rows) left out, the mean taken over the rest."""
    from lightgaussian_tpu_torch.ops import losses

    l1, ssim = losses.l1_loss, losses.ssim
    monkeypatch.setattr(losses, "l1_loss", lambda a, b: l1(a[:, : a.shape[1] // 2], b[:, : b.shape[1] // 2]))
    monkeypatch.setattr(losses, "ssim", lambda a, b, target_stats=None: ssim(a[:, : a.shape[1] // 2],
                                                                             b[:, : b.shape[1] // 2]))


def _altered_answer(monkeypatch):
    """An image altered where it is produced: one tile's colour moved by `ALTERED`."""
    from lightgaussian_tpu_torch.ops.rasterize import tiled

    compose = tiled._compose

    def altered(tile_rgb, *a):
        tile_rgb = tile_rgb.clone()
        tile_rgb[0] += ALTERED
        return compose(tile_rgb, *a)

    monkeypatch.setattr(tiled, "_compose", altered)


FAULTS = {"state_unchanged": _broken_state, "half_batch": _half_batch, "altered_answer": _altered_answer}
APPLIES = [("train-3dgs-m360", f) for f in FAULTS] + [("distill-lg-m360", f) for f in FAULTS] + [
    ("serve-lg-m360-orbit", "altered_answer"), ("serve-3dgs-m360-orbit", "altered_answer")]


@pytest.mark.parametrize("cell,fault", APPLIES)
def test_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, checks = _run(cell)
    assert result["correct"] is False, checks


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_correct(cell):
    result, checks = _run(cell, seed=SEED + 1)
    assert result["correct"] is True, checks


@pytest.mark.parametrize("cell", CELLS)
def test_precision_control_fails(cell):
    """The reference with its stage results held in bfloat16, in the
    program's place, fails one of the cell's limits."""
    c = tiny_cell(cell)
    traffic = c.traffic().Traffic(c.config, c.spec, SEED, CPU)
    core.window(traffic, 0.2, CPU)
    traffic.close()
    limits = c.spec["limits"]
    if traffic.unit == "step":
        got = traffic.gaps(traffic.summary(traffic.reference(q=R.bf16_round)), traffic.summary(traffic.reference()))
    else:
        ref, ctl = traffic.reference(), traffic.reference(q=R.bf16_round)
        got = {"image_gap": max(float((a - b).abs().max()) for a, b in zip(ctl, ref))}
    assert any(v > limits[k] for k, v in got.items()), got


def test_pose_order_same_work_for_every_seed():
    """Each block of the distillation's poses is the one fixed pool, in an
    order the seed permutes."""
    n, every = 6, 3
    a = inputs.pose_order(SEED, n, 2 * n * every, 0.05, every)
    b = inputs.pose_order(SEED + 7, n, 2 * n * every, 0.05, every)

    def block(order, k):
        return sorted((i, tuple(d)) for i, d in order[k * n * every:(k + 1) * n * every])

    assert block(a, 0) == block(a, 1) == block(b, 0) == block(b, 1)
    assert [i for i, _ in a] != [i for i, _ in b]
    assert sum(not any(d) for _, d in a[: n * every]) == n


class _Event:
    def __init__(self, kind, start, dur):
        self.kind, self.start, self.dur = kind, start, dur

    def device_type(self):
        return self.kind

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur


def test_device_busy_is_the_union_of_device_intervals():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [_Event(cuda, 0, 10), _Event(cuda, 5, 10), _Event(cuda, 30, 5), _Event(cpu, 0, 1000)]
    results = argparse.Namespace(events=lambda: events)
    assert core.device_busy_s(results, torch.device("cuda", 0)) == pytest.approx(20e-9)
    nested = [_Event(cuda, 0, 100), _Event(cuda, 10, 5), _Event(cuda, 50, 70), _Event(cuda, 200, 1)]
    assert core.device_busy_s(argparse.Namespace(events=lambda: nested), torch.device("cuda", 0)) == \
        pytest.approx(121e-9)


def test_device_trace_window_counts_every_unit():
    """A window measured by the device trace runs its units under the
    profiler, session after session, and reports the busy time of them all."""
    c = tiny_cell("distill-lg-m360")
    traffic = c.traffic().Traffic(c.config, c.spec, SEED, CPU)
    core.warm_profiler(traffic, CPU)
    before = traffic.done
    times, wall, busy = core.profiled_window(traffic, 1.5, CPU, chunk_s=0.3)
    assert traffic.done - before == len(times) >= 2
    assert 0 < busy <= wall
