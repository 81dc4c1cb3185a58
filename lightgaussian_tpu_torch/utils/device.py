"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """`device` as a torch.device; raises if CUDA is asked for and absent.

    The port never falls back to the CPU on its own: a caller that wants the
    CPU says so (`device="cpu"`)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but CUDA is not available; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    return dev
