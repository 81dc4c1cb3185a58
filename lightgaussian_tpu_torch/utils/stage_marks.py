"""CUDA-event marks at the stage boundaries of the render and the training step.

The render and the training step call `mark(name)` where a stage ends. The
marks are off unless a caller turns them on, and then `mark` only tests a
module global. A caller that wants the split of the real step on the card
calls `start()` (which records the origin), runs the step, synchronises,
and reads `stop()`: each stage's time is the elapsed time from the event
before it to its own, on the stream the work ran on, with no synchronise
inside the step.

On the CPU (`start("cpu")`), where each operation has finished when the
next is called, a mark reads the host clock instead.
"""
from __future__ import annotations

import time

import torch

_marks: list | None = None
_host_clock = False


def mark(name: str) -> None:
    """Record a CUDA event (or, on the CPU, the host clock) ending the stage
    `name` on the current stream, if marks are on."""
    if _marks is None:
        return
    if _host_clock:
        _marks.append((name, time.perf_counter()))
        return
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    _marks.append((name, event))


def start(device: str | torch.device = "cuda") -> None:
    """Turn the marks on for work on `device` and record the origin."""
    global _marks, _host_clock
    _host_clock = torch.device(device).type != "cuda"
    _marks = []
    mark("origin")


def stop() -> list[tuple[str, float]]:
    """Turn the marks off; return (stage, ms) for each mark after the origin.
    The caller has synchronised the stream since the last mark."""
    global _marks
    marks, _marks = _marks or [], None
    if _host_clock:
        return [(name, 1e3 * (t1 - t0)) for (_, t0), (name, t1) in zip(marks, marks[1:])]
    return [(name, start_event.elapsed_time(event))
            for (_, start_event), (name, event) in zip(marks, marks[1:])]
