"""Carry scenes, cameras and train states across as host arrays.

The JAX package's `GaussianScene`, `Camera` and `TrainState` are dataclasses
of arrays; a caller that holds one hands its fields over as numpy arrays,
and these functions build the port's counterpart on a device. Both packages
then compute from the same bits. The `*_to_numpy` functions go the other
way, to the same layout.

A train state travels as a dict: "scene" (the scene's parameter arrays,
"alive", "active_sh_degree", "max_sh_degree"), "mu" and "nu" (Adam's moments
by parameter), "count" (Adam's step count), "step", and the densification
statistics "max_radii2d", "xyz_grad_accum" and "denom".

`flatten_train_state` and `unflatten_train_state` turn that dict into the
flat keys of the JAX package's checkpoint files and back
(`train/checkpoint.py` reads and writes the files).

A VQ codebook state travels as its three arrays (`embed`, `embed_avg`,
`cluster_size`); LPIPS weights as the JAX package's `LPIPSParams` fields:
(kernel HWIO, bias) per convolution and the five lin vectors.
"""
from __future__ import annotations

import numpy as np
import torch

from lightgaussian_tpu_torch.compress.vq import CodebookState
from lightgaussian_tpu_torch.eval.lpips import LPIPS
from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.models.gaussians import GaussianScene
from lightgaussian_tpu_torch.train.optim import AdamState
from lightgaussian_tpu_torch.train.state import TrainState
from lightgaussian_tpu_torch.utils.device import resolve_device

STAT_FIELDS = ("max_radii2d", "xyz_grad_accum", "denom")


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def scene_from_numpy(
    arrays: dict,
    alive: np.ndarray,
    active_sh_degree: int,
    max_sh_degree: int,
    device: str | torch.device = "cuda",
) -> GaussianScene:
    """`arrays` maps each of `GaussianScene.PARAM_FIELDS` to a float32 array
    with the capacity as its first axis; `alive` is the bool mask."""
    dev = resolve_device(device)
    missing = set(GaussianScene.PARAM_FIELDS) - set(arrays)
    if missing:
        raise ValueError(f"missing scene arrays: {sorted(missing)}")
    params = {
        k: torch.from_numpy(np.array(arrays[k], dtype=np.float32)).to(dev)
        for k in GaussianScene.PARAM_FIELDS
    }
    return GaussianScene(
        alive=torch.from_numpy(np.asarray(alive, dtype=bool).copy()).to(dev),
        active_sh_degree=int(active_sh_degree),
        max_sh_degree=int(max_sh_degree),
        **params,
    )


def camera_from_numpy(
    world_view: np.ndarray,
    full_proj: np.ndarray,
    camera_center: np.ndarray,
    tan_fovx,
    tan_fovy,
    width: int,
    height: int,
    device: str | torch.device = "cuda",
) -> Camera:
    """A Camera from the fields of another package's camera (float32)."""
    dev = resolve_device(device)

    def f32(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    return Camera(
        world_view=f32(world_view),
        full_proj=f32(full_proj),
        camera_center=f32(camera_center),
        tan_fovx=f32(tan_fovx),
        tan_fovy=f32(tan_fovy),
        width=int(width),
        height=int(height),
    )


def scene_to_numpy(scene: GaussianScene) -> dict:
    """The scene's parameter arrays, "alive" and its SH degrees."""
    out = {k: _np(v) for k, v in scene.params().items()}
    out.update(alive=_np(scene.alive), active_sh_degree=scene.active_sh_degree,
               max_sh_degree=scene.max_sh_degree)
    return out


def train_state_from_numpy(arrays: dict, device: str | torch.device = "cuda") -> TrainState:
    """A TrainState from the dict layout of this module's docstring."""
    dev = resolve_device(device)
    s = arrays["scene"]
    scene = scene_from_numpy(
        {k: s[k] for k in GaussianScene.PARAM_FIELDS}, s["alive"], s["active_sh_degree"],
        s["max_sh_degree"], device=dev,
    )

    def f32(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    opt = AdamState(
        mu={k: f32(arrays["mu"][k]) for k in GaussianScene.PARAM_FIELDS},
        nu={k: f32(arrays["nu"][k]) for k in GaussianScene.PARAM_FIELDS},
        count=int(arrays["count"]),
    )
    return TrainState(scene=scene, opt=opt, step=int(arrays["step"]),
                      **{k: f32(arrays[k]) for k in STAT_FIELDS})


def train_state_to_numpy(state: TrainState) -> dict:
    """The dict layout of this module's docstring, on the host."""
    return dict(
        scene=scene_to_numpy(state.scene),
        mu={k: _np(v) for k, v in state.opt.mu.items()},
        nu={k: _np(v) for k, v in state.opt.nu.items()},
        count=state.opt.count,
        step=state.step,
        **{k: _np(getattr(state, k)) for k in STAT_FIELDS},
    )


def flatten_train_state(arrays: dict) -> dict:
    """The dict layout as the flat arrays of a checkpoint file: the JAX
    package's tree paths "scene/<param>", "scene/alive", "opt/mu/<param>",
    "opt/nu/<param>", "opt/count", "step" (int32 scalars) and the three
    statistics. The SH degrees are no arrays; they travel in the file's
    metadata."""
    flat = {f"scene/{k}": np.asarray(arrays["scene"][k], dtype=np.float32)
            for k in GaussianScene.PARAM_FIELDS}
    flat["scene/alive"] = np.asarray(arrays["scene"]["alive"], dtype=bool)
    for moment in ("mu", "nu"):
        for k in GaussianScene.PARAM_FIELDS:
            flat[f"opt/{moment}/{k}"] = np.asarray(arrays[moment][k], dtype=np.float32)
    flat["opt/count"] = np.asarray(arrays["count"], dtype=np.int32)
    flat["step"] = np.asarray(arrays["step"], dtype=np.int32)
    for k in STAT_FIELDS:
        flat[k] = np.asarray(arrays[k], dtype=np.float32)
    return flat


def unflatten_train_state(flat: dict, active_sh_degree: int, max_sh_degree: int) -> dict:
    """The inverse of `flatten_train_state`; a missing key raises KeyError."""
    scene = {k: flat[f"scene/{k}"] for k in GaussianScene.PARAM_FIELDS}
    scene.update(alive=flat["scene/alive"], active_sh_degree=int(active_sh_degree),
                 max_sh_degree=int(max_sh_degree))
    return dict(
        scene=scene,
        mu={k: flat[f"opt/mu/{k}"] for k in GaussianScene.PARAM_FIELDS},
        nu={k: flat[f"opt/nu/{k}"] for k in GaussianScene.PARAM_FIELDS},
        count=int(flat["opt/count"]),
        step=int(flat["step"]),
        **{k: flat[k] for k in STAT_FIELDS},
    )


def codebook_state_from_numpy(embed, embed_avg, cluster_size,
                              device: str | torch.device = "cuda") -> CodebookState:
    """A CodebookState from another package's three arrays (float32)."""
    dev = resolve_device(device)

    def f32(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    return CodebookState(embed=f32(embed), embed_avg=f32(embed_avg), cluster_size=f32(cluster_size))


def codebook_state_to_numpy(state: CodebookState) -> dict:
    """{"embed", "embed_avg", "cluster_size"} on the host."""
    return {k: _np(getattr(state, k)) for k in ("embed", "embed_avg", "cluster_size")}


def lpips_params_from_numpy(convs, lins, kind: str, device: str | torch.device = "cuda") -> LPIPS:
    """An LPIPS module from (kernel HWIO, bias) per convolution and the
    lin vectors; the kernels become OIHW for `F.conv2d`."""
    dev = resolve_device(device)

    def f32(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    return LPIPS([(f32(w).permute(3, 2, 0, 1).contiguous(), f32(b)) for w, b in convs],
                 [f32(lin) for lin in lins], kind)
