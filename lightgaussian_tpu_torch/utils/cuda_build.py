"""The port's hand-written kernels: one table of their C entry points, and
the build, load, launch and count of each.

Each `csrc/*.cu` file has a plain C interface: `extern "C" int lg_*(...)`
entry points, each the stream last, each returning the
`cudaGetLastError()` of its launch. `KERNELS` has one row per entry point:
its source, its ctypes argtypes, its launch counter and the device name of
its main launch. A row is the launch: `KERNELS[symbol](like, *args)` runs the
entry point on `like`'s device and current stream, raises on a non-zero
error and counts one launch. A source is compiled for sm_90a at the first
launch of one of its rows, into the package's git-ignored `build/`
directory, one shared library per state of the source and of the
`csrc/*.cuh` headers it includes, and loaded once per process with every row
of it bound; a process that never launches a row of a source never builds
or loads it. `build` compiles several sources at once, one nvcc process
each.

A wrapper asks `on_card` which path its tensors take: the kernel on CUDA,
the plain PyTorch version on the CPU, a `ValueError` elsewhere.

The flags keep each float operation rounded as the plain PyTorch versions
round it: `--fmad=false` (no contraction into FMA) and accurate `expf`.
`-Xptxas=-v` leaves registers, shared memory and spills of each kernel in
`<library>.log`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: dict[str, ctypes.CDLL] = {}  # source path -> loaded library
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAPS = ctypes.POINTER(ctypes.c_float)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the port's kernels are built with the CUDA toolkit")
    return found


def library_path(source: Path) -> Path:
    """Where the library of `source` is built (named by the source, the
    headers beside it that it includes, and the flags)."""
    text = source.read_bytes()
    h = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
    for header in sorted(set(re.findall(rb'#include "(\w+\.cuh)"', text))):
        h.update((source.parent / header.decode()).read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:12]}.so"


def build(*sources: Path) -> list[Path]:
    """Compile each source whose library is missing, all at once, and return
    the libraries' paths. The compiler's report is kept as `<library>.log`."""
    todo = [s for s in sources if not library_path(s).exists()]
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for src in todo:
        out = library_path(src)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=log, stderr=subprocess.STDOUT)
        running.append((src, out, tmp, log, proc))
    errors = []
    for src, out, tmp, log, proc in running:
        proc.wait()
        log.close()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src}:\n{out.with_suffix('.log').read_text()}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [library_path(s) for s in sources]


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of `source`, built if needed, with `argtypes` set
    for each of its rows of `KERNELS` (every entry point returns int)."""
    key = str(source)
    if key not in _LOADED:
        lib = ctypes.CDLL(str(build(source)[0]))
        for k in KERNELS.values():
            if k.source == source:
                fn = getattr(lib, k.symbol)
                fn.argtypes = k.argtypes
                fn.restype = ctypes.c_int
        _LOADED[key] = lib
    return _LOADED[key]


def check(err: int, symbol: str) -> None:
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed with CUDA error {err}")


def on_card(t: torch.Tensor, what: str) -> bool:
    """Whether `what`, given `t`, launches its kernel: True on CUDA, False on
    the CPU (its plain version runs); a ValueError on any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what} runs on CUDA or, as plain torch, on the CPU; got {t.device}")


class Kernel:
    """One entry point: `symbol` of `csrc/<source>`, its ctypes `argtypes`
    (the stream last), its launch counter `name` and `device_name`, a
    pattern of the device name of its main launch as `torch.profiler`
    writes it, demangled or mangled (a wrapper's other device work, zeroing
    an output or the tile-ordering kernel, is not its launch). A row with no
    name is a checking tool: counted by no `launch_counts` and matched in no
    trace."""

    def __init__(self, symbol: str, source: str, argtypes: list, name: str | None = None,
                 device_name: str | None = None):
        self.symbol, self.source, self.argtypes = symbol, CSRC / source, argtypes
        self.name, self.device_name = name, device_name
        self.launches = 0
        self._fn = None

    def __call__(self, like: torch.Tensor, *args) -> None:
        """Launch with `args` (all but the stream) on `like`'s device and
        its current stream; raise if the launch failed; count it."""
        check(self._launch(like, args), self.symbol)
        self.launches += 1

    def _launch(self, like: torch.Tensor, args: tuple) -> int:
        if self._fn is None:
            self._fn = getattr(load(self.source), self.symbol)
        with torch.cuda.device(like.device):
            return self._fn(*args, torch.cuda.current_stream(like.device).cuda_stream)


# The table, by symbol. The argtypes follow the C parameters, which
# tests/test_torch_csrc_signatures.py holds them against.
_BLEND = [_P] * 5 + [_I] * 4 + [_P]
_BLUR_MOMENTS = [_P, _P, _P, _I, _I, _I, _TAPS, _I, _P]
KERNELS = {k.symbol: k for k in (
    Kernel("lg_blend_forward", "blend_forward.cu", _BLEND, "blend_forward",
           r"blend_tile_kernel<true, false>|blend_tile_kernelILb1ELb0E"),
    Kernel("lg_blend_forward_fast", "blend_forward.cu", _BLEND, "blend_forward_fast",
           r"blend_tile_kernel<false, false>|blend_tile_kernelILb0ELb0E"),
    Kernel("lg_blend_count", "blend_forward.cu", [_P] * 8 + [_I] * 4 + [_P], "blend_count",
           r"blend_tile_kernel<true, true>|blend_tile_kernelILb1ELb1E"),
    Kernel("lg_instance_cull", "blend_forward.cu", [_P] * 4 + [_I] * 3 + [_P]),
    Kernel("lg_blend_backward", "blend_backward.cu", [_P] * 7 + [_I] * 4 + [_P], "blend_backward",
           r"blend_backward_kernel"),
    Kernel("lg_ssim_blur", "ssim_blur.cu", [_P, _P, _I, _I, _I, _TAPS, _I, _P], "blur", r"blur_rows_kernel"),
    Kernel("lg_ssim_blur3", "ssim_blur.cu", _BLUR_MOMENTS, "blur3",
           r"moment_rows_kernel<(true|false), 3>|moment_rows_kernelILb[01]ELi3E"),
    Kernel("lg_ssim_blur5", "ssim_blur.cu", _BLUR_MOMENTS, "blur5",
           r"moment_rows_kernel<(true|false), 5>|moment_rows_kernelILb[01]ELi5E"),
    Kernel("lg_unchunk_transpose", "unchunk_transpose.cu", [_P] * 2 + [_I] * 2 + [_P], "unchunk_transpose",
           r"unchunk_transpose_kernel"),
    Kernel("lg_issue_probe", "issue_probe.cu", [_P, _P, _I, _I, _F, _F, _I, _P], "issue_probe", r"probe_kernel"),
    Kernel("lg_bin_cover", "bin_cover.cu", [_P] * 9 + [_I] * 7 + [_P], "bin_cover", r"bin_cover_kernel"),
    # the cover's five rows, cum, depth, key, gid, the range pairs; n, m, depth stride, tiles_x, depth bits, range
    # blocks. Its launch is the emission; the depth-range pass before it is not counted.
    Kernel("lg_bin_emit", "bin_cover.cu", [_P] * 10 + [_I] * 6 + [_P], "bin_emit", r"bin_emit_kernel"),
    # inputs, camera, 6 outputs; a row stride per input; n, K, degree, width, height; scale_modifier
    Kernel("lg_preprocess_forward", "preprocess.cu", [_P] * 21 + [_I] * 15 + [_F, _P], "preprocess_forward",
           r"preprocess_forward_kernel"),
    # inputs, camera, 4 upstream gradients, 9 gradients; the strides of inputs and upstream; n, K, degree,
    # width, height; scale_modifier
    Kernel("lg_preprocess_backward", "preprocess.cu", [_P] * 28 + [_I] * 19 + [_F, _P], "preprocess_backward",
           r"preprocess_backward_kernel"),
)}
SOURCES = tuple(dict.fromkeys(k.source for k in KERNELS.values()))


def launch_counts() -> dict:
    """Launches of every counted kernel since the last reset, by counter (a
    wrapper counts only where it launches its kernel: on the CPU all stay 0)."""
    return {k.name: k.launches for k in KERNELS.values() if k.name}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
