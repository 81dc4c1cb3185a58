"""The port's kernel table against the C entry points, and the wrappers'
routes through it.

Every kernel of `lightgaussian_tpu_torch/csrc/*.cu` is reached through an
`extern "C" int lg_*(...)` entry point, loaded with ctypes; ctypes trusts
the `argtypes` it is given, so a list that no longer matches the C
parameters passes a pointer as a 32-bit int or shifts every argument after
it, and that shows only on a card. Here each entry point's parameters, read
from its source, are held against its row of `cuda_build.KERNELS`: their
number, and pointer, int or float in each place. Each public kernel wrapper
refuses a tensor on a device that is neither CUDA nor the CPU, and a reset
zeroes every row's counter.
"""
import ctypes
import dataclasses
import re

import pytest
import torch

from lightgaussian_tpu_torch.ops import losses
from lightgaussian_tpu_torch.ops.rasterize import binning, blend, projection
from lightgaussian_tpu_torch.utils import cuda_build, issue_probe
from lightgaussian_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)


def _entry_points() -> dict:
    """symbol -> (source file name, [C parameter declarations])."""
    found = {}
    for path in sorted(cuda_build.CSRC.glob("*.cu")):
        for m in re.finditer(r'extern\s+"C"\s+int\s+(lg_\w+)\s*\(([^)]*)\)', path.read_text()):
            found[m.group(1)] = (path.name, [p.strip() for p in m.group(2).split(",") if p.strip()])
    return found


ENTRY_POINTS = _entry_points()


def _matches(param: str, argtype) -> bool:
    if "*" in param:
        return argtype is ctypes.c_void_p or issubclass(argtype, ctypes._Pointer)
    kind = param.split()[0]
    return {"int": ctypes.c_int, "float": ctypes.c_float}.get(kind) is argtype


def test_every_source_has_entry_points():
    sources = {src for src, _ in ENTRY_POINTS.values()}
    assert sources == {p.name for p in cuda_build.CSRC.glob("*.cu")} == {p.name for p in cuda_build.SOURCES}
    assert {"lg_blend_forward", "lg_blend_forward_fast", "lg_blend_count", "lg_blend_backward",
            "lg_ssim_blur", "lg_bin_cover", "lg_bin_emit", "lg_preprocess_forward",
            "lg_preprocess_backward"} <= set(ENTRY_POINTS)


@pytest.mark.parametrize("symbol", sorted(ENTRY_POINTS))
def test_argtypes_match_the_c_parameters(symbol):
    source, params = ENTRY_POINTS[symbol]
    assert symbol in cuda_build.KERNELS, f"no row of the kernel table binds {symbol} of {source}"
    kernel = cuda_build.KERNELS[symbol]
    assert kernel.source.name == source
    argtypes = kernel.argtypes
    assert len(argtypes) == len(params), f"{symbol}: {len(params)} C parameters, {len(argtypes)} argtypes"
    for i, (param, argtype) in enumerate(zip(params, argtypes)):
        assert _matches(param, argtype), f"{symbol} parameter {i} `{param}` registered as {argtype}"


def test_no_loader_registers_a_missing_symbol():
    assert set(cuda_build.KERNELS) == set(ENTRY_POINTS)
    counted = [k for k in cuda_build.KERNELS.values() if k.name]
    assert len({k.name for k in counted}) == len(counted) == 13
    assert all(k.device_name for k in counted)
    assert [k.symbol for k in cuda_build.KERNELS.values() if not k.name] == ["lg_instance_cull"]


def _meta_inputs():
    """Each public kernel wrapper, as a call on inputs it takes but on the
    meta device."""
    meta = torch.device("meta")
    grid = binning.make_grid(64, 64)
    t = grid.num_tiles
    starts = torch.zeros(t + 1, dtype=torch.int32, device=meta)
    inst = torch.zeros((256, binning.FEAT_WIDTH), device=meta)
    gid = torch.zeros(256, dtype=torch.int64, device=meta)
    planes = torch.zeros((3, 8, 8), device=meta)
    scene = tsyn.random_scene(n=16, seed=0, device="cpu")
    scene = dataclasses.replace(scene, **{f: getattr(scene, f).to(meta) for f in (*scene.PARAM_FIELDS, "alive")})
    camera = tsyn.default_camera(width=64, height=64, device="cpu")
    camera = dataclasses.replace(camera, **{f: getattr(camera, f).to(meta) for f in projection._CAMERA})
    n = 16
    splats = projection.Splats(
        mean2d=torch.zeros((n, 2), device=meta), conic=torch.zeros((n, 3), device=meta),
        color=torch.zeros((n, 3), device=meta), opacity=torch.zeros(n, device=meta),
        depth=torch.zeros(n, device=meta), radius=torch.zeros(n, dtype=torch.int32, device=meta))
    return {
        "blend_forward": lambda: blend.blend_forward(starts, inst, grid),
        "blend_forward_fast": lambda: blend.blend_forward_fast(starts, inst, grid),
        "blend_backward": lambda: blend.blend_backward(
            starts, inst, gid, torch.zeros((t, 3, blend.PIX), device=meta),
            torch.zeros((t, 1, blend.PIX), device=meta), grid, 16),
        "blend_forward_counting": lambda: blend.blend_forward_counting(starts, inst, gid, grid, 16),
        "unchunk_transpose": lambda: blend.unchunk_transpose(torch.zeros((2, 16, blend.BATCH), device=meta)),
        "instance_cull": lambda: blend.instance_cull(starts, inst, grid),
        "blur": lambda: losses.blur(planes),
        "blur3": lambda: losses.blur3(planes, planes),
        "blur5": lambda: losses.blur5(planes, planes),
        "run_chain": lambda: issue_probe.run_chain(torch.zeros(issue_probe.GRANULE, device=meta), "mul", 1),
        "bin_splats": lambda: binning.bin_splats(splats, grid, 1 << 10),
        "emit": lambda: binning._emit(binning.TileCover(*torch.zeros((5, n), dtype=torch.int64, device=meta)),
                                      torch.zeros(n, dtype=torch.int64, device=meta), splats.depth, n, n, grid),
        "preprocess": lambda: projection.preprocess(scene, camera),
    }


META = _meta_inputs()


@pytest.mark.parametrize("wrapper", sorted(META))
def test_wrapper_refuses_another_device_and_counts_nothing(wrapper, monkeypatch):
    def no_build(*_args):
        raise AssertionError(f"{wrapper} built or launched a kernel")

    monkeypatch.setattr(cuda_build, "load", no_build)
    monkeypatch.setattr(cuda_build.Kernel, "_launch", no_build)
    for k in cuda_build.KERNELS.values():
        k.launches += 1
    cuda_build.reset_launch_counts()
    assert all(k.launches == 0 for k in cuda_build.KERNELS.values())
    with pytest.raises(ValueError, match="meta"):
        META[wrapper]()
    assert all(k.launches == 0 for k in cuda_build.KERNELS.values())
