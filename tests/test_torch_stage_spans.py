"""The port's spans (`utils.stage_marks.trace`) in a CPU profiler's trace,
and the stage marks of the distillation step.

A training step, a distillation step and a served frame at 96x64 over a
256-Gaussian scene. With the spans off, a profiler session records no `lg/`
range and the marks read as before. With them on, each step or frame is one
numbered unit holding one `lg/binning` a render and, a preprocess, an
`lg/projection` with `lg/covariance` and `lg/sh` nested in it; every op of
the preprocess lies in them, and every backward node of the preprocess is
linked by its sequence number to one forward op in one of them.
"""
import importlib.util
import json
import re
from pathlib import Path

import pytest
import torch
from torch.autograd.profiler import record_function

from lightgaussian_tpu_torch.config import OptimizationParams
from lightgaussian_tpu_torch.ops.rasterize import api, render
from lightgaussian_tpu_torch.train.distill import init_student, make_distill_step
from lightgaussian_tpu_torch.train.state import init_train_state
from lightgaussian_tpu_torch.train.step import make_train_step
from lightgaussian_tpu_torch.utils import stage_marks, synthetic

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
MAX_INST = 1 << 14
PIECES = ("lg/sh", "lg/covariance", "lg/projection")
RENDER_STAGES = ("preprocess", "binning", "B1", "compose")
DISTILL_STAGES = RENDER_STAGES * 2 + ("loss forward", "loss backward", "B2 + reduce", "preprocess backward", "Adam")
BACKWARD = "autograd::engine::evaluate_function: "


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.fixture(scope="module")
def units():
    """name -> (a call of one unit, its renders)."""
    scene = synthetic.random_scene(n=256, seed=1, device="cpu")
    cam = synthetic.default_camera(device="cpu")
    bg = torch.zeros(3)
    with torch.no_grad():
        target = render(scene, cam, bg).render.clamp(0.0, 1.0) * 0.9
    cam = cam.with_gt(target)
    state = init_train_state(scene)
    student = init_train_state(init_student(scene, 1))
    step = make_train_step(OptimizationParams(), 1.0, MAX_INST)
    distill = make_distill_step(OptimizationParams(), 1.0, MAX_INST)

    def frame():
        with torch.no_grad():
            render(scene, cam, bg, max_instances=MAX_INST, fast=True)

    return {"train": (lambda: step(state, cam, bg), 1), "distill": (lambda: distill(student, scene, cam, bg), 2),
            "serve": (frame, 1)}


def _trace(fn, tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    return sorted(events, key=lambda e: e["ts"])


def _ranges(events, pattern):
    return [e for e in events if e.get("cat") == "user_annotation" and re.fullmatch(pattern, e["name"])]


def _inside(e, outer):
    return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"] and e is not outer


def _expected_stages(name):
    smoke = _smoke()
    return {"train": smoke.TRAIN_STAGES, "distill": DISTILL_STAGES, "serve": smoke.SERVE_STAGES}[name]


@pytest.mark.parametrize("name", ["train", "distill", "serve"])
def test_spans_off_record_nothing_and_marks_read_as_before(name, units, tmp_path):
    call, _ = units[name]
    stage_marks.trace(False)
    assert not [e for e in _trace(call, tmp_path) if e["name"].startswith("lg/")]
    stage_marks.start("cpu")
    events = _trace(call, tmp_path)
    assert [stage for stage, _ in stage_marks.stop()] == list(_expected_stages(name))
    assert not [e for e in events if e["name"].startswith("lg/")]


def test_distill_step_marks_its_stages_in_order(units):
    stage_marks.start("cpu")
    units["distill"][0]()
    got = stage_marks.stop()
    assert [stage for stage, _ in got] == list(DISTILL_STAGES)
    assert all(ms >= 0.0 for _, ms in got)


@pytest.mark.parametrize("name", ["train", "distill", "serve"])
def test_spans_on_name_units_binning_and_preprocess_pieces(name, units, tmp_path, monkeypatch):
    call, renders = units[name]
    inner = api.preprocess

    def marked_preprocess(*args, **kwargs):
        with record_function("test/preprocess"):
            return inner(*args, **kwargs)

    monkeypatch.setattr(api, "preprocess", marked_preprocess)
    stage_marks.trace(True)
    try:
        stage_marks.start("cpu")
        events = _trace(lambda: (call(), call()), tmp_path)
        flat = [stage for stage, _ in stage_marks.stop()]
    finally:
        stage_marks.trace(False)
    assert flat == list(_expected_stages(name)) * 2  # the spans add no mark
    kind = "frame" if name == "serve" else "step"
    unit_spans = _ranges(events, r"lg/(step|frame)#\d+")
    assert [u["name"] for u in unit_spans] == [f"lg/{kind}#0", f"lg/{kind}#1"]
    preprocesses = _ranges(events, "test/preprocess")
    for unit in unit_spans:
        assert len([b for b in _ranges(events, "lg/binning") if _inside(b, unit)]) == renders
        assert len([p for p in preprocesses if _inside(p, unit)]) == renders
    assert len(preprocesses) == 2 * renders
    for pre in preprocesses:
        pieces = {p: [e for e in _ranges(events, p) if _inside(e, pre)] for p in PIECES}
        assert [len(v) for v in pieces.values()] == [1, 1, 1]
        (outer,) = pieces["lg/projection"]
        assert _inside(pieces["lg/sh"][0], outer) and _inside(pieces["lg/covariance"][0], outer)
        ops = [e for e in events if e.get("cat") == "cpu_op" and _inside(e, pre)]
        assert ops and all(_inside(op, outer) for op in ops)


def _piece_at(pieces, op):
    """The innermost preprocess piece holding `op`, or None."""
    holding = [p for p in pieces if _inside(op, p)]
    return max(holding, key=lambda p: p["ts"])["name"] if holding else None


def _op_name(name):
    return name.split("::")[-1].replace("_", "").lower()


@pytest.mark.parametrize("name", ["train", "distill"])
def test_preprocess_backward_nodes_link_to_one_piece(name, units, tmp_path):
    stage_marks.trace(True)
    try:
        events = _trace(units[name][0], tmp_path)
    finally:
        stage_marks.trace(False)
    pieces = [e for e in events if e.get("cat") == "user_annotation" and e["name"] in PIECES]
    forward, nodes = {}, []
    for e in events:
        seq = e.get("args", {}).get("Sequence number")
        if e.get("cat") != "cpu_op" or seq is None:
            continue
        if e["name"].startswith(BACKWARD):
            nodes.append(e)
        elif "Backward" not in e["name"]:
            forward.setdefault(seq, []).append(e)
    reached = set()
    for node in nodes:
        seq = node["args"]["Sequence number"]
        made = _op_name(node["name"][len(BACKWARD):].split("Backward")[0])
        maker = forward[seq][-1]  # an op that makes no node carries the number the next node takes
        piece = _piece_at(pieces, maker)
        if piece is None:
            assert not [op for op in forward[seq] if _op_name(op["name"]) == made and _piece_at(pieces, op)]
            continue
        assert _op_name(maker["name"]) == made, (node["name"], [op["name"] for op in forward[seq]])
        reached.add(piece)
    assert reached == set(PIECES)
