"""The port's C entry points against the ctypes signatures their loaders register.

Every kernel of `lightgaussian_tpu_torch/csrc/*.cu` is reached through an
`extern "C" int lg_*(...)` entry point, loaded with ctypes; ctypes trusts
the `argtypes` it is given, so a list that no longer matches the C
parameters passes a pointer as a 32-bit int or shifts every argument after
it, and that shows only on a card. Here the loaders run with
`cuda_build.load` replaced by a recorder (nothing is built), and each entry
point's parameters, read from its source, are held against what was
registered for it: their number, and pointer, int or float in each place.
"""
import ctypes
import re

import pytest
import torch

from lightgaussian_tpu_torch.ops import losses
from lightgaussian_tpu_torch.ops.rasterize import binning, blend, projection
from lightgaussian_tpu_torch.utils import cuda_build, issue_probe

torch.set_num_threads(1)

LOADERS = (blend._forward_library, blend._backward_library, blend._unchunk_library, losses._library,
           issue_probe._library, binning._library, projection._library)


def _entry_points() -> dict:
    """symbol -> (source file name, [C parameter declarations])."""
    found = {}
    for path in sorted(cuda_build.CSRC.glob("*.cu")):
        for m in re.finditer(r'extern\s+"C"\s+int\s+(lg_\w+)\s*\(([^)]*)\)', path.read_text()):
            found[m.group(1)] = (path.name, [p.strip() for p in m.group(2).split(",") if p.strip()])
    return found


ENTRY_POINTS = _entry_points()


def _registered(monkeypatch) -> dict:
    """symbol -> (source file name, argtypes) as the loaders register them."""
    seen = {}

    def record(source, signatures):
        for sym, argtypes in signatures.items():
            assert sym not in seen, f"{sym} registered twice"
            seen[sym] = (source.name, list(argtypes))

    monkeypatch.setattr(cuda_build, "load", record)
    for loader in LOADERS:
        loader()
    return seen


def _matches(param: str, argtype) -> bool:
    if "*" in param:
        return argtype is ctypes.c_void_p or issubclass(argtype, ctypes._Pointer)
    kind = param.split()[0]
    return {"int": ctypes.c_int, "float": ctypes.c_float}.get(kind) is argtype


def test_every_source_has_entry_points():
    sources = {src for src, _ in ENTRY_POINTS.values()}
    assert sources == {p.name for p in cuda_build.CSRC.glob("*.cu")}
    assert {"lg_blend_forward", "lg_blend_forward_fast", "lg_blend_count", "lg_blend_backward",
            "lg_ssim_blur", "lg_bin_cover", "lg_preprocess_forward", "lg_preprocess_backward"} <= set(ENTRY_POINTS)


@pytest.mark.parametrize("symbol", sorted(ENTRY_POINTS))
def test_argtypes_match_the_c_parameters(symbol, monkeypatch):
    source, params = ENTRY_POINTS[symbol]
    registered = _registered(monkeypatch)
    assert symbol in registered, f"no loader registers {symbol} of {source}"
    reg_source, argtypes = registered[symbol]
    assert reg_source == source
    assert len(argtypes) == len(params), f"{symbol}: {len(params)} C parameters, {len(argtypes)} argtypes"
    for i, (param, argtype) in enumerate(zip(params, argtypes)):
        assert _matches(param, argtype), f"{symbol} parameter {i} `{param}` registered as {argtype}"


def test_no_loader_registers_a_missing_symbol(monkeypatch):
    registered = _registered(monkeypatch)
    assert set(registered) == set(ENTRY_POINTS)
