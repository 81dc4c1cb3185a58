"""CUDA-event marks at the stage boundaries of the render and the training
step, and the spans that put the program's layers into a profiler's trace.

The render and the training step call `mark(name)` where a stage ends. The
marks are off unless a caller turns them on, and then `mark` only tests a
module global. A caller that wants the split of the real step on the card
calls `start()` (which records the origin), runs the step, synchronises,
and reads `stop()`: each stage's time is the elapsed time from the event
before it to its own, on the stream the work ran on, with no synchronise
inside the step.

On the CPU (`start("cpu")`), where each operation has finished when the
next is called, a mark reads the host clock instead.

The spans are a second switch, `trace(True)`. While it is on, the span
sites enter `torch.autograd.profiler.record_function` ranges,
which a running `torch.profiler` records as `user_annotation` events on the
kernels' clock. A profiler drops a range's arguments from its Chrome trace,
so the names carry what a reader needs: `lg/step#<n>` around a training or
distillation step and `lg/frame#<n>` around a render that no step encloses
(`in_unit`), `n` counting units since the switch went on; inside a unit
`lg/binning` around each binning and `lg/projection`, `lg/covariance` and
`lg/sh` around the preprocess, the last two nested in the first (`in_span`,
`span`). The autograd backward runs outside these ranges: the profiler links
each backward node to its forward op by the sequence number they share.
While the switch is off a span site only tests a module global.
"""
from __future__ import annotations

import contextlib
import functools
import time

import torch

_marks: list | None = None
_host_clock = False
_trace = False
_units = 0  # units begun since the spans went on
_in_unit = False
_OFF = contextlib.nullcontext()


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


def trace(on: bool) -> None:
    """Turn the spans on (numbering units from 0) or off."""
    global _trace, _units, _in_unit
    _trace, _units, _in_unit = on, 0, False


def span(name: str):
    """The range `lg/<name>` while the spans are on, else a no-op context."""
    if not _trace:
        return _OFF
    return torch.autograd.profiler.record_function("lg/" + name)


def in_span(name: str):
    """Decorator: the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def in_unit(kind: str):
    """Decorator: a call that no other unit encloses is the unit
    `lg/<kind>#<n>` while the spans are on."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            global _units, _in_unit
            if not _trace or _in_unit:
                return fn(*args, **kwargs)
            name, _units, _in_unit = f"lg/{kind}#{_units}", _units + 1, True
            try:
                with torch.autograd.profiler.record_function(name):
                    return fn(*args, **kwargs)
            finally:
                _in_unit = False
        return run
    return wrap
