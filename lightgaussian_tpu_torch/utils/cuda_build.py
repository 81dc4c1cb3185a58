"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/*.cu` file has a plain C interface. It is compiled for sm_90a at
first use into the package's git-ignored `build/` directory, one shared
library per state of the source and of the `csrc/*.cuh` headers it
includes, and loaded once per process. `build` compiles several sources at
once, one nvcc process each. Every entry point returns the
`cudaGetLastError()` of its launch; `check` raises on a non-zero one.

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


def load(source: Path, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of `source`, built if needed, with `argtypes` set
    for each entry point of `signatures` (every entry point returns int)."""
    key = str(source)
    if key not in _LOADED:
        lib = ctypes.CDLL(str(build(source)[0]))
        for sym, argtypes in signatures.items():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LOADED[key] = lib
    return _LOADED[key]


def check(err: int, symbol: str) -> None:
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed with CUDA error {err}")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of `t`'s device, as the int ctypes passes."""
    return torch.cuda.current_stream(t.device).cuda_stream
