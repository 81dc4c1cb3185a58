"""Issue-rate probe: how fast the card issues the instruction kinds the
port's kernels are made of.

Port of the VPU probe of the JAX package's `scripts/roofline.py`
(`_chain_kernel`, `vpu_chain`, `measure_vpu`). The kernel lives in
`csrc/issue_probe.cu`, which says what each kind's step is. `run_chain`
carries a vector through `passes` dependent steps of one kind: on CUDA
tensors with the kernel, on CPU tensors with `plain_chain`, the same
recurrence in elementwise torch. `measure` times the kernel at two chain
lengths and takes the cost of one pass from the difference, so that launch,
load and store drop out.

The rates are what a bound on a kernel's time may assume at most: a bound
built from a published peak is only a least time if the card can reach
that peak.
"""
from __future__ import annotations

import ctypes

import torch

from lightgaussian_tpu_torch.utils import cuda_build
from lightgaussian_tpu_torch.utils.device import resolve_device

SOURCE = cuda_build.CSRC / "issue_probe.cu"

KINDS = ("mul", "mul_add", "fma", "ex2", "rcp", "shfl_sum", "scan128")
# What a pass issues per element on the unit the kind loads: (unit, instructions).
ISSUED = {
    "mul": ("fp32", 1),
    "mul_add": ("fp32", 2),
    "fma": ("fp32", 1),
    "ex2": ("mufu", 1),
    "rcp": ("mufu", 1),
    "shfl_sum": ("shuffle", 5),
    "scan128": ("shared-memory step", 7),
}
A, B = 0.9999999, 1e-12  # the multiplier and addend of the float chains
BLOCK = 128  # threads of a block, and the width of a scan
CHAINS = 4  # elements per thread
GRANULE = BLOCK * CHAINS  # a vector's length is a multiple of this
BLOCKS_PER_SM = 16  # 64 warps an SM: every scheduler has sixteen to pick from
PASSES = (1024, 4096)  # the two chain lengths `measure` times
REPS = 5  # timed launches per length; the least counts

# Launches of the kernel since the last reset (the plain version does not count).
LAUNCHES = {"issue_probe": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library() -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return cuda_build.load(SOURCE, {"lg_issue_probe": [p, p, i, i, f, f, i, p]})


def start_values(kind: str, n: int, device: str | torch.device = "cuda") -> torch.Tensor:
    """A start vector of `n` floats, from a fixed seed, in the range the
    kind's recurrence keeps bounded."""
    dev = resolve_device(device)
    u = torch.rand(n, generator=torch.Generator().manual_seed(0), dtype=torch.float32)
    x = 1.0 - 1e-3 * u if kind == "scan128" else 0.25 + 0.5 * u
    return x.to(dev)


def plain_chain(x: torch.Tensor, kind: str, passes: int) -> torch.Tensor:
    """Plain-torch version of the kernel: the same recurrence, elementwise,
    over the kernel's layout (element i belongs to thread i mod T of T =
    n / 4 threads, so warps and blocks are runs of 32 and 128 elements)."""
    a = torch.tensor(A, dtype=torch.float32, device=x.device)
    b = torch.tensor(B, dtype=torch.float32, device=x.device)
    for _ in range(passes):
        if kind == "mul":
            x = x * a
        elif kind == "mul_add":
            x = x * a + b
        elif kind == "fma":  # one rounding: the product is exact in float64
            x = (x.double() * a.double() + b.double()).float()
        elif kind == "ex2":
            x = torch.exp2(-x)
        elif kind == "rcp":
            x = 1.0 / (x + 1.0)
        elif kind == "shfl_sum":
            lanes = x.view(-1, 32)
            x = (0.5 * lanes + lanes.sum(dim=1, keepdim=True) * (1.0 / 64.0)).view(-1)
        elif kind == "scan128":
            y = torch.cumprod(x.view(-1, BLOCK), dim=1)
            x = (1.0 + (y - 1.0) * (1.0 / 128.0)).view(-1)
        else:
            raise ValueError(f"unknown probe kind {kind!r}; one of {KINDS}")
    return x


def run_chain(x: torch.Tensor, kind: str, passes: int) -> torch.Tensor:
    """`passes` dependent steps of `kind` over `x` (float32 [n], n a
    multiple of 512)."""
    if kind not in KINDS:
        raise ValueError(f"unknown probe kind {kind!r}; one of {KINDS}")
    if x.dtype != torch.float32 or x.dim() != 1 or x.numel() == 0 or x.numel() % GRANULE:
        raise ValueError(f"x must be float32 [n] with n a positive multiple of {GRANULE}, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if passes < 0:
        raise ValueError(f"passes must not be negative, got {passes}")
    if x.device.type == "cpu":
        return plain_chain(x, kind, passes)
    if x.device.type != "cuda":
        raise ValueError(f"the probe runs on CUDA or, as plain torch, on the CPU; got {x.device}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _library().lg_issue_probe(
            x.data_ptr(), out.data_ptr(), KINDS.index(kind), passes, A, B,
            x.numel() // GRANULE, cuda_build.stream_of(x),
        )
    cuda_build.check(err, "lg_issue_probe")
    LAUNCHES["issue_probe"] += 1
    return out


def measure(device: str | torch.device = "cuda") -> dict:
    """Time every kind on the card at the two chain lengths of `PASSES`
    (CUDA events, the least of `REPS` launches each, after a warm-up).

    Returns {kind: {"unit", "instructions_per_pass", "elements",
    "ns_per_pass", "per_second"}}: `ns_per_pass` is the time of one pass
    over all `elements`, `per_second` the instructions of the kind's unit
    issued per second, per element (a warp instruction counts 32).
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the probe measures a CUDA card; run_chain gives the recurrence on the CPU")
    lo, hi = PASSES
    n = torch.cuda.get_device_properties(dev).multi_processor_count * BLOCKS_PER_SM * GRANULE

    def timed(x, kind, p):
        run_chain(x, kind, p)
        best = float("inf")
        for _ in range(REPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run_chain(x, kind, p)
            end.record()
            torch.cuda.synchronize(dev)
            best = min(best, start.elapsed_time(end))
        return best * 1e-3

    out = {}
    for kind in KINDS:
        x = start_values(kind, n, dev)
        per_pass = (timed(x, kind, hi) - timed(x, kind, lo)) / (hi - lo)
        unit, count = ISSUED[kind]
        out[kind] = {
            "unit": unit,
            "instructions_per_pass": count,
            "elements": n,
            "ns_per_pass": per_pass * 1e9,
            "per_second": n * count / per_pass if per_pass > 0 else float("inf"),
        }
    return out
