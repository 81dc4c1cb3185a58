"""Training checkpoints: the whole TrainState and the iteration in one .npz.

Port of `lightgaussian_tpu/train/checkpoint.py`, in its file layout, so a
checkpoint written by either package loads in the other: `__meta__` (a JSON
string with `iteration`, `capacity`, `active_sh_degree`, `max_sh_degree`,
`spatial_lr_scale`, `format_version` 1) and the flat arrays of
`convert.flatten_train_state`.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from lightgaussian_tpu_torch import convert
from lightgaussian_tpu_torch.ops import sh as sh_ops
from lightgaussian_tpu_torch.train.state import TrainState

FORMAT_VERSION = 1


def save_checkpoint(path: str | Path, state: TrainState, iteration: int, spatial_lr_scale: float = 1.0) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    scene = state.scene
    meta = {
        "iteration": int(iteration),
        "capacity": scene.capacity,
        "active_sh_degree": scene.active_sh_degree,
        "max_sh_degree": scene.max_sh_degree,
        "spatial_lr_scale": float(spatial_lr_scale),
        "format_version": FORMAT_VERSION,
    }
    arrays = convert.flatten_train_state(convert.train_state_to_numpy(state))
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def _expected_shapes(capacity: int, max_sh_degree: int) -> dict:
    k_rest = sh_ops.num_sh_coeffs(max_sh_degree) - 1
    param = {"means": (capacity, 3), "sh_dc": (capacity, 3), "sh_rest": (capacity, k_rest, 3),
             "log_scales": (capacity, 3), "quats": (capacity, 4), "opacity_logits": (capacity,)}
    shapes = {"scene/alive": (capacity,), "opt/count": (), "step": ()}
    for k, shape in param.items():
        shapes[f"scene/{k}"] = shapes[f"opt/mu/{k}"] = shapes[f"opt/nu/{k}"] = shape
    shapes.update({k: (capacity,) for k in convert.STAT_FIELDS})
    return shapes


def load_checkpoint(path: str | Path, device: str | torch.device = "cuda") -> tuple[TrainState, int, float]:
    """Returns (state, iteration, spatial_lr_scale), the state on `device`.
    A missing array raises KeyError, one of another shape ValueError."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    for key, shape in _expected_shapes(meta["capacity"], meta["max_sh_degree"]).items():
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        if tuple(arrays[key].shape) != shape:
            raise ValueError(f"checkpoint leaf {key} shape {arrays[key].shape} != expected {shape}")
    nested = convert.unflatten_train_state(arrays, meta["active_sh_degree"], meta["max_sh_degree"])
    state = convert.train_state_from_numpy(nested, device=device)
    return state, meta["iteration"], meta["spatial_lr_scale"]
