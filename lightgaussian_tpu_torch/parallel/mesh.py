"""Process groups and device meshes for the multi-device paths.

Port of `lightgaussian_tpu/parallel/mesh.py`. The JAX package runs one
controller over every device; the port runs one process per device, as
PyTorch does: NCCL between cards (rank r on `cuda:LOCAL_RANK`), gloo
between CPU processes. A mesh is a `torch.distributed.device_mesh.DeviceMesh`
over the first data x space ranks, laid out row-major as JAX's
`devices[:d*s].reshape(d, s)`:

- ``data``: camera-batch data parallelism (one camera per data rank a
  step; parameter gradients are averaged over this axis);
- ``space``: the image's tile-row strips of one camera (each rank blends a
  horizontal strip; the image is gathered before the loss; parameter
  gradients are summed over this axis).

There is no emulation of several devices in one process: a mesh needs a
process group (`init_from_env` under torchrun, `init_rank` for processes
spawned on one host).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from lightgaussian_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
SPACE_AXIS = "space"


def is_multi_process() -> bool:
    """A default process group of more than one process is running."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _join(device: torch.device, **kwargs) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", device_id=device, **kwargs)
    else:
        dist.init_process_group("gloo", **kwargs)


def init_from_env(device: str | torch.device = "cuda") -> torch.device:
    """Start the default process group from torchrun's environment when
    WORLD_SIZE > 1 (NCCL for cards, this process on `cuda:LOCAL_RANK`;
    gloo for the CPU); do nothing otherwise. Returns the device this
    process works on."""
    device = torch.device(device)
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    _join(device)
    return device


def init_rank(rank: int, world: int, store_path: str, device: str | torch.device = "cuda") -> torch.device:
    """Join a group of `world` processes spawned on one host (for example
    by `torch.multiprocessing.spawn`) through a `FileStore` at
    `store_path`: NCCL with rank r on `cuda:r` (the default; raises
    without CUDA), gloo with `device="cpu"`. Returns this rank's device."""
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rank)
    _join(device, store=dist.FileStore(store_path, world), rank=rank, world_size=world)
    return device


def build_mesh(shape: tuple[int, int], names: tuple[str, str]) -> DeviceMesh:
    """A row-major mesh of `shape` over the first prod(shape) ranks. The
    `DeviceMesh` is built directly: `init_device_mesh` wants the mesh to
    span every process, and a JAX mesh may take fewer devices than there
    are."""
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs a process group: run under torchrun (parallel.mesh.init_from_env) "
            "or join spawned processes with parallel.mesh.init_rank"
        )
    world = dist.get_world_size()
    n = shape[0] * shape[1]
    if n > world:
        raise ValueError(f"mesh {shape[0]}x{shape[1]} > {world} processes")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=names)


def make_mesh(data: int | None = None, space: int = 1) -> DeviceMesh:
    """A (data, space) mesh. With defaults, every process is on the data
    axis. Ranks past data x space are outside the mesh and take no part
    in its programs."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        if world % space:
            raise ValueError(f"{world} processes not divisible by space={space}")
        data = world // space
    return build_mesh((data, space), (DATA_AXIS, SPACE_AXIS))
