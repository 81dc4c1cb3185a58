"""Per-tile front-to-back alpha blend: the CUDA kernels, their plain versions,
and their launch counters.

Port of `blend_forward` and `blend_forward_fast` of
`lightgaussian_tpu/ops/rasterize/pallas_blend.py`. The kernels live in
`csrc/blend_forward.cu`; that file says what bounds them and how they are
laid out. They are built with `nvcc` for sm_90a at first use into the
package's own `build/` directory, and bound with `ctypes`.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. The plain versions are pure torch, vectorised
over tiles, with `torch.cumprod` transmittance prefixes (the JAX kernels'
masked-prefix form).

Kernels and plain versions walk a tile's range in the 128-instance chunks of
the instance buffer, aligned to multiples of 128 as the JAX kernels' chunks
are, and test the early exit after each chunk. The render-only blend's naive
T depends on where the walk stops, so with the same chunks it equals the JAX
package's. `chip_smoke.py` holds each kernel against its plain version on the
card.

Inputs: `tile_starts` int32 [T+1] and `inst` float32 [M, FEAT_WIDTH] from
`binning.bin_splats`. Outputs: tile RGB [T, 3, 1024] and tile T [T, 1, 1024].
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from lightgaussian_tpu_torch.ops.rasterize.binning import (
    FEAT_B,
    FEAT_CA,
    FEAT_CB,
    FEAT_CC,
    FEAT_MX,
    FEAT_MY,
    FEAT_OPA,
    FEAT_R,
    FEAT_WIDTH,
    TILE_SIZE,
    TileGrid,
)
from lightgaussian_tpu_torch.ops.rasterize.projection import ALPHA_EPS, MAX_ALPHA, T_EPS

PIX = TILE_SIZE * TILE_SIZE
BATCH = 128  # instances per chunk, in the kernels and in their plain versions

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "blend_forward.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

# Tiles the plain version blends at once: about _TILE_GROUP * BATCH * PIX
# floats per intermediate.
_TILE_GROUP = 256

# Columns of `plain_blend`'s work count: the (instance, in-image pixel) pairs
# a kernel has to evaluate on its inputs, by how far the per-pair code of
# csrc/blend_forward.cu runs for them: rejected at power > 0; rejected at
# alpha < 1/255; eligible and applied; eligible and ending the pixel's blend;
# eligible past that end (only the render-only kernel's naive T walks those).
WORK_KINDS = ("culled", "faint", "applied", "stopping", "past_stop")

# Launches of each kernel since the last reset (the plain versions do not count).
LAUNCHES = {"blend_forward": 0, "blend_forward_fast": 0}
_SYMBOLS = {"blend_forward": "lg_blend_forward", "blend_forward_fast": "lg_blend_forward_fast"}
_LIBRARY = []  # the loaded ctypes library, once built


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the blend kernels are built with the CUDA toolkit")
    return found


def build_library() -> Path:
    """Compile `csrc/blend_forward.cu` (once per source and flag set) and
    return the shared library's path. The compiler's report (registers,
    shared memory, spills) is kept beside it as `<name>.log`."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libblend_forward_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True, check=False,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _library() -> ctypes.CDLL:
    if not _LIBRARY:
        lib = ctypes.CDLL(str(build_library()))
        for sym in _SYMBOLS.values():
            fn = getattr(lib, sym)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIBRARY.append(lib)
    return _LIBRARY[0]


def _check_inputs(tile_starts: torch.Tensor, inst: torch.Tensor, grid: TileGrid) -> None:
    if tile_starts.dtype != torch.int32 or tuple(tile_starts.shape) != (grid.num_tiles + 1,):
        raise ValueError(
            f"tile_starts must be int32 [{grid.num_tiles + 1}], got "
            f"{tile_starts.dtype} {tuple(tile_starts.shape)}"
        )
    if inst.dtype != torch.float32 or inst.dim() != 2 or inst.shape[1] != FEAT_WIDTH:
        raise ValueError(f"inst must be float32 [M, {FEAT_WIDTH}], got {inst.dtype} {tuple(inst.shape)}")
    if tile_starts.device != inst.device:
        raise ValueError(f"tile_starts on {tile_starts.device}, inst on {inst.device}")
    if not (tile_starts.is_contiguous() and inst.is_contiguous()):
        raise ValueError("tile_starts and inst must be contiguous")


def _launch(name: str, tile_starts: torch.Tensor, inst: torch.Tensor, grid: TileGrid):
    dev = inst.device
    t = grid.num_tiles
    rgb = torch.empty((t, 3, PIX), dtype=torch.float32, device=dev)
    t_out = torch.empty((t, 1, PIX), dtype=torch.float32, device=dev)
    fn = getattr(_library(), _SYMBOLS[name])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            tile_starts.data_ptr(), inst.data_ptr(), rgb.data_ptr(), t_out.data_ptr(),
            t, grid.tiles_x, grid.width, grid.height, stream,
        )
    if err != 0:
        raise RuntimeError(f"{_SYMBOLS[name]} launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return rgb, t_out


def _dispatch(name: str, exact: bool, tile_starts, inst, grid):
    _check_inputs(tile_starts, inst, grid)
    if inst.device.type == "cpu":
        rgb, t, _ = plain_blend(tile_starts, inst, grid, exact=exact)
        return rgb, t
    if inst.device.type != "cuda":
        raise ValueError(f"blend kernels run on CUDA or, as plain torch, on the CPU; got {inst.device}")
    return _launch(name, tile_starts, inst, grid)


def blend_forward(tile_starts: torch.Tensor, inst: torch.Tensor, grid: TileGrid):
    """Exact blend (B1). Returns (tile_rgb [T, 3, PIX], tile_T [T, 1, PIX])
    with the applied transmittance."""
    return _dispatch("blend_forward", True, tile_starts, inst, grid)


def blend_forward_fast(tile_starts: torch.Tensor, inst: torch.Tensor, grid: TileGrid):
    """Render-only blend (B6): as `blend_forward`, but tile_T is the naive
    transmittance (differs only on saturated pixels, by under 1e-2)."""
    return _dispatch("blend_forward_fast", False, tile_starts, inst, grid)


def plain_blend(tile_starts: torch.Tensor, inst: torch.Tensor, grid: TileGrid, exact: bool):
    """Plain-torch version of both kernels.

    Returns (tile_rgb [T, 3, PIX], tile_T [T, 1, PIX], work [T, 5]), where
    `work` counts, per tile and per kind of `WORK_KINDS`, the (instance,
    in-image pixel) pairs the kernel has to evaluate on these inputs: the
    exact blend walks a pixel only until its blend ends, the render-only one
    every pixel until the tile exits. It bounds the kernels' time.
    """
    dev = inst.device
    num_tiles = grid.num_tiles
    rgb_out = torch.zeros((num_tiles, 3, PIX), dtype=torch.float32, device=dev)
    t_out = torch.ones((num_tiles, 1, PIX), dtype=torch.float32, device=dev)
    work = torch.zeros((num_tiles, len(WORK_KINDS)), dtype=torch.int64, device=dev)
    m = inst.shape[0]
    if m == 0:
        return rgb_out, t_out, work

    starts = tile_starts[:-1].to(torch.int64)
    ends = tile_starts[1:].to(torch.int64)
    bases = starts // BATCH * BATCH  # each tile's first chunk
    lane = torch.arange(PIX, device=dev)
    tile_ids = torch.arange(num_tiles, device=dev)
    px = ((tile_ids % grid.tiles_x) * TILE_SIZE)[:, None] + (lane % TILE_SIZE)[None, :]
    py = ((tile_ids // grid.tiles_x) * TILE_SIZE)[:, None] + (lane // TILE_SIZE)[None, :]
    pix_valid = (px < grid.width) & (py < grid.height)
    px, py = px.to(torch.float32), py.to(torch.float32)
    rows_in_batch = torch.arange(BATCH, device=dev)

    for g0 in range(0, num_tiles, _TILE_GROUP):
        ids = tile_ids[g0:g0 + _TILE_GROUP]
        # Out-of-image pixels start at 0 so they never hold the exit back.
        t_naive = torch.where(pix_valid[ids], 1.0, 0.0)
        t_act = torch.ones_like(t_naive)
        rgb = torch.zeros((ids.numel(), 3, PIX), dtype=torch.float32, device=dev)
        act = torch.arange(ids.numel(), device=dev)  # group rows still walking
        act = act[ends[ids] > starts[ids]]
        step = 0
        while act.numel():
            tid = ids[act]
            rows = bases[tid][:, None] + step * BATCH + rows_in_batch[None, :]
            row_ok = (rows >= starts[tid][:, None]) & (rows < ends[tid][:, None])
            f = inst[torch.clamp(rows, max=m - 1)]  # [A, BATCH, FEAT_WIDTH]
            dx = px[tid][:, None, :] - f[..., FEAT_MX:FEAT_MX + 1]
            dy = py[tid][:, None, :] - f[..., FEAT_MY:FEAT_MY + 1]
            ca = f[..., FEAT_CA:FEAT_CA + 1]
            cb = f[..., FEAT_CB:FEAT_CB + 1]
            cc = f[..., FEAT_CC:FEAT_CC + 1]
            power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            alpha = torch.clamp(f[..., FEAT_OPA:FEAT_OPA + 1] * torch.exp(power), max=MAX_ALPHA)
            elig = (
                (power <= 0.0) & (alpha >= ALPHA_EPS)
                & pix_valid[tid][:, None, :] & row_ok[:, :, None]
            )
            alpha = torch.where(elig, alpha, 0.0)
            om = 1.0 - alpha
            incl = torch.cumprod(om, dim=1)
            excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
            t_i = t_naive[act][:, None, :] * excl
            apply = (t_i * om) >= T_EPS
            w = torch.where(apply, alpha * t_i, 0.0)
            col = f[..., FEAT_R:FEAT_B + 1]  # [A, BATCH, 3]
            rgb[act] += torch.einsum("abc,abp->acp", col, w)
            t_naive[act] = t_naive[act] * incl[:, -1]
            if exact:
                t_act[act] = t_act[act] * torch.where(apply, incl, 1.0).amin(dim=1)
            # The exact blend walks a pixel only while it still blends (naive
            # T >= T_EPS); the naive T of the render-only one needs every pixel.
            walked = row_ok[:, :, None] & pix_valid[tid][:, None, :]
            blending = t_i >= T_EPS
            if exact:
                walked = walked & blending
            culled = power > 0.0
            kinds = (
                walked & culled,
                walked & ~culled & ~elig,
                walked & elig & apply,
                walked & elig & ~apply & blending,
                walked & elig & ~blending,
            )
            work[tid] += torch.stack([k.sum(dim=(1, 2)) for k in kinds], dim=1)
            step += 1
            more = (bases[tid] + step * BATCH < ends[tid]) & (t_naive[act].amax(dim=1) >= T_EPS)
            act = act[more]
        rgb_out[ids] = rgb
        if exact:
            t_out[ids, 0] = t_act
        else:
            t_out[ids, 0] = torch.where(pix_valid[ids], t_naive, 1.0)
    return rgb_out, t_out, work

