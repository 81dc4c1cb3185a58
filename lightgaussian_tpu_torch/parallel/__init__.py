"""Multi-device paths on torch.distributed, one process per device: the
(data, space) strip-parallel training step, the Gaussian-sharded step, the
camera-parallel GSS sweep and the strip renderer.

Port of `lightgaussian_tpu/parallel`, with the same public names. A mesh
is a `torch.distributed.device_mesh.DeviceMesh` over a running process
group (`mesh.init_from_env` under torchrun, `mesh.init_rank` for spawned
processes); a camera batch is a `list[Camera]`.
"""
from lightgaussian_tpu_torch.parallel.mesh import make_mesh, DATA_AXIS, SPACE_AXIS
from lightgaussian_tpu_torch.parallel.train import (
    make_parallel_train_step,
    stack_cameras,
)
from lightgaussian_tpu_torch.parallel.gauss import (
    GAUSS_AXIS,
    gather_state,
    make_gauss_mesh,
    make_gauss_train_step,
    shard_state,
)
from lightgaussian_tpu_torch.parallel.gss import (
    accumulate_gss_sharded,
    make_accumulate_gss_sharded,
    pad_cameras,
)
from lightgaussian_tpu_torch.parallel.render import (
    make_parallel_render,
    parallel_render,
)

__all__ = [
    "make_mesh",
    "DATA_AXIS",
    "SPACE_AXIS",
    "GAUSS_AXIS",
    "make_parallel_train_step",
    "make_gauss_mesh",
    "make_gauss_train_step",
    "shard_state",
    "gather_state",
    "stack_cameras",
    "accumulate_gss_sharded",
    "make_accumulate_gss_sharded",
    "pad_cameras",
    "make_parallel_render",
    "parallel_render",
]
