"""Gaussian-sharded multi-device training, the FSDP/ZeRO analogue for 3D-GS.

Port of `lightgaussian_tpu/parallel/gauss.py`. On a (data, gauss) mesh
every per-Gaussian tensor (parameters, Adam moments, densification
statistics, `alive`) is split along the capacity over ``gauss`` into
contiguous slices, one per rank (`shard_state`; `gather_state` brings them
back). One axis serves two roles, so the blend work is not replicated:

- each rank projects only its own slice of the Gaussians;
- the packed screen-space splats (ten floats each, far fewer than the
  parameters and their moments, which never leave their rank) are
  gathered over ``gauss`` (`comm.gather_shards`);
- each rank bins and blends its own strip of tile rows over the full
  gathered splat set (B1 forward, B2 backward), and the image is gathered
  over ``gauss`` before the loss;
- the backward of the splat gather is a reduce-scatter that sums each
  strip's per-splat gradients and hands every rank its own slice's, so
  the Adam update runs on the slice; parameter gradients are averaged over
  ``data`` only.

Densify and prune stay passes over the whole state: gather it, run them,
shard it again.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from lightgaussian_tpu_torch.config import OptimizationParams
from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.ops.rasterize import tiled as tiled_mod
from lightgaussian_tpu_torch.ops.rasterize.projection import Splats, preprocess
from lightgaussian_tpu_torch.parallel import comm
from lightgaussian_tpu_torch.parallel.mesh import DATA_AXIS, build_mesh
from lightgaussian_tpu_torch.parallel.train import check_batch, finish_step, shift_rows, strip_loss
from lightgaussian_tpu_torch.train import optim
from lightgaussian_tpu_torch.train.optim import AdamState
from lightgaussian_tpu_torch.train.state import TrainState
from lightgaussian_tpu_torch.train.step import adam_step, gradients, param_leaves

GAUSS_AXIS = "gauss"


def make_gauss_mesh(data: int | None = None, gauss: int = 1):
    """A (data, gauss) mesh: camera-batch data parallelism x Gaussian and
    strip sharding."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        if world % gauss:
            raise ValueError(f"{world} processes not divisible by gauss={gauss}")
        data = world // gauss
    return build_mesh((data, gauss), (DATA_AXIS, GAUSS_AXIS))


def _map_gaussians(state: TrainState, fn) -> TrainState:
    """`fn` applied to every per-Gaussian tensor of the state."""
    scene = state.scene
    scene = dataclasses.replace(scene, alive=fn(scene.alive), **{k: fn(v) for k, v in scene.params().items()})
    opt = AdamState(mu={k: fn(v) for k, v in state.opt.mu.items()},
                    nu={k: fn(v) for k, v in state.opt.nu.items()}, count=state.opt.count)
    return dataclasses.replace(state, scene=scene, opt=opt, max_radii2d=fn(state.max_radii2d),
                               xyz_grad_accum=fn(state.xyz_grad_accum), denom=fn(state.denom))


def shard_state(state: TrainState, mesh) -> TrainState:
    """This rank's contiguous slice of every per-Gaussian tensor; scalars
    stay. The capacity must divide by the ``gauss`` axis."""
    n = comm.axis_size(mesh, GAUSS_AXIS)
    cap = state.capacity
    if cap % n:
        raise ValueError(f"capacity {cap} not divisible by gauss={n}")
    k = cap // n
    lo = comm.axis_index(mesh, GAUSS_AXIS) * k
    return _map_gaussians(state, lambda x: x[lo:lo + k].clone())


def gather_state(state: TrainState, mesh) -> TrainState:
    """The whole state from its slices, on every rank (for densify and
    prune, checkpoints, rendering)."""
    def gather(x):
        if x.dtype == torch.bool:
            return comm.all_gather(x.to(torch.uint8), mesh, GAUSS_AXIS).bool()
        return comm.all_gather(x, mesh, GAUSS_AXIS)

    return _map_gaussians(state, gather)


def _gather_splats(local: Splats, mesh) -> Splats:
    """Every rank's splats, concatenated in rank order. The float fields
    travel packed in one [n, 10] gather whose backward is the
    reduce-scatter; depth (which only orders the instances) and the
    integer radius carry no gradient."""
    packed = torch.cat([local.mean2d, local.conic, local.color, local.opacity[:, None],
                        local.depth.detach()[:, None]], 1)
    full = comm.gather_shards(packed, mesh, GAUSS_AXIS)
    return Splats(
        mean2d=full[:, 0:2], conic=full[:, 2:5], color=full[:, 5:8], opacity=full[:, 8], depth=full[:, 9],
        radius=comm.all_gather(local.radius, mesh, GAUSS_AXIS),
    )


def make_gauss_train_step(
    opt_cfg: OptimizationParams,
    spatial_lr_scale: float,
    max_instances: int,
    mesh,
    image_height: int,
    lr_mult_fn=None,
    update_densify_stats: bool = True,
):
    """Build the Gaussian-sharded train_step(state, cameras, bg) ->
    (state, metrics). `state` is this rank's slice (`shard_state`);
    `cameras` is a list of one camera per data rank, with ground truth;
    `max_instances` is the PER-STRIP instance cut (full splat set,
    strip-height grid)."""
    lr_fns = optim.make_lr_fns(opt_cfg, spatial_lr_scale)
    n_gauss = comm.axis_size(mesh, GAUSS_AXIS)
    n_data = comm.axis_size(mesh, DATA_AXIS)
    if image_height % n_gauss:
        raise ValueError(f"image height {image_height} not divisible by gauss={n_gauss}")
    strip_h = image_height // n_gauss
    y0 = comm.axis_index(mesh, GAUSS_AXIS) * strip_h
    d = comm.axis_index(mesh, DATA_AXIS)

    def train_step(state: TrainState, cams: list[Camera], bg: torch.Tensor):
        camera = check_batch(cams, n_data)[d]
        params = param_leaves(state.scene)
        offset = torch.zeros((state.capacity, 2), dtype=torch.float32, device=state.scene.means.device,
                             requires_grad=True)
        local = preprocess(state.scene.with_params(params), camera, mean2d_offset=offset)
        splats = shift_rows(_gather_splats(local, mesh), y0)
        strip, _ft, total = tiled_mod.blend_tiled(splats, bg, camera.width, strip_h, max_instances)
        full = comm.gather_strips(strip, mesh, GAUSS_AXIS, dim=1)
        loss, l1 = strip_loss(opt_cfg, full, camera)
        grads, (offset_grad,) = gradients(loss, params, (), (offset,))

        with torch.no_grad():
            # the slice's gradients arrive summed over the strips; only the camera mean crosses `data`
            grads = {k: comm.pmean(g, mesh, DATA_AXIS) for k, g in grads.items()}
            scene, new_opt = adam_step(state, grads, lr_fns, lr_mult_fn)
        return finish_step(state, scene, new_opt, mesh, GAUSS_AXIS, sharded=True, radius=local.radius,
                           offset_grad=offset_grad, update_densify_stats=update_densify_stats,
                           loss=loss, l1=l1, full=full, camera=camera, total=total)

    return train_step
