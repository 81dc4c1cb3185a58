"""Multi-device training step: data-parallel over cameras x space-parallel
over the image's tile-row strips, one process per device.

Port of `lightgaussian_tpu/parallel/train.py`. On a (data, space) mesh:

- the scene and the optimizer state are replicated; rank (d, s) renders
  the rows [s * strip_h, (s + 1) * strip_h) of camera d through the exact
  blend (B1 forward, B2 backward) on a strip-sized tile grid;
- the full image is gathered over ``space`` before the L1 + D-SSIM loss
  (its 11x11 window crosses strip seams), and the gather's backward hands
  each strip its own rows' gradient (`comm.gather_strips`);
- parameter gradients are summed over ``space`` and averaged over
  ``data``, and every rank makes the same Adam update;
- the densification statistics count as n_data single-camera steps would:
  the largest radius over the cameras, the sum of each camera's
  screen-space gradient norm over the cameras that see a Gaussian, and
  `denom` the number of those cameras.

The camera batch is a `list[Camera]` (`models.camera.stack_cameras`) of
length data, the same list on every rank; rank (d, s) takes camera d.
"""
from __future__ import annotations

import dataclasses

import torch

from lightgaussian_tpu_torch.config import OptimizationParams
from lightgaussian_tpu_torch.models.camera import Camera, stack_cameras
from lightgaussian_tpu_torch.ops import losses
from lightgaussian_tpu_torch.ops.rasterize import tiled as tiled_mod
from lightgaussian_tpu_torch.ops.rasterize.projection import preprocess
from lightgaussian_tpu_torch.parallel import comm
from lightgaussian_tpu_torch.parallel.mesh import DATA_AXIS, SPACE_AXIS
from lightgaussian_tpu_torch.train import optim
from lightgaussian_tpu_torch.train.state import TrainState
from lightgaussian_tpu_torch.train.step import StepMetrics, adam_step, gradients, param_leaves


def shift_rows(splats, y0: int):
    """The splats moved up by `y0` rows, so that row y0 of the image is row
    0 of a strip's grid."""
    shift = torch.tensor([0.0, float(y0)], dtype=torch.float32, device=splats.mean2d.device)
    return dataclasses.replace(splats, mean2d=splats.mean2d - shift)


def render_strip(scene, camera: Camera, bg, y0: int, strip_h: int, max_instances: int,
                 mean2d_offset=None, fast: bool = False):
    """Rows [y0, y0 + strip_h) of the camera's image: (strip [3, strip_h,
    W], final_T [strip_h, W], live instances, splats). `fast` selects the
    render-only blend (B6), else the exact one (B1, differentiable)."""
    splats = preprocess(scene, camera, mean2d_offset=mean2d_offset)
    blend = tiled_mod.blend_tiled_fast if fast else tiled_mod.blend_tiled
    image, final_t, total = blend(shift_rows(splats, y0), bg, camera.width, strip_h, max_instances)
    return image, final_t, total, splats


def strip_loss(opt_cfg: OptimizationParams, full, camera: Camera):
    """(loss, l1) of the gathered image against the camera's ground truth."""
    l1 = losses.l1_loss(full, camera.gt_image)
    ssim_v = losses.ssim(full, camera.gt_image, target_stats=camera.gt_ssim_stats)
    return (1.0 - opt_cfg.lambda_dssim) * l1 + opt_cfg.lambda_dssim * (1.0 - ssim_v), l1


def check_batch(cams: list[Camera], n_data: int) -> list[Camera]:
    """The step's camera list, checked: one resolution, one camera per
    data rank, each with ground truth."""
    cams = stack_cameras(cams)
    if len(cams) != n_data:
        raise ValueError(f"the step takes one camera per data rank ({n_data}), got {len(cams)}")
    if any(c.gt_image is None for c in cams):
        raise ValueError("a training step needs cameras with ground-truth images (camera.with_gt(img))")
    return cams


@torch.no_grad()
def finish_step(state: TrainState, scene, new_opt, mesh, strip_axis: str, *, sharded: bool, radius, offset_grad,
                update_densify_stats: bool, loss, l1, full, camera: Camera, total: int):
    """The new state, with its densification statistics, and the metrics of
    a step over a (data, strip_axis) mesh. `radius` and `offset_grad` are
    this rank's, for the Gaussians it holds: every Gaussian, rendered into
    this rank's strip (`sharded` False), or the slice of them that the
    Gaussian-sharded step keeps on this rank (`sharded` True, where
    `strip_axis` is also the shard axis and the strip gradients arrive
    summed)."""
    radius = torch.clamp(radius, min=0)
    seen = radius > 0
    if not sharded:
        radius = comm.pmax(radius, mesh, strip_axis)
        seen = comm.psum(seen.to(torch.float32), mesh, strip_axis) > 0
        offset_grad = comm.psum(offset_grad, mesh, strip_axis)
    radii = comm.pmax(radius, mesh, DATA_AXIS)
    visible = (radii > 0) & scene.alive
    if update_densify_stats:
        max_radii = torch.where(visible, torch.maximum(state.max_radii2d, radii.to(torch.float32)),
                                state.max_radii2d)
        gnorm = comm.psum(torch.sqrt((offset_grad * offset_grad).sum(dim=-1)), mesh, DATA_AXIS)
        seen_cnt = comm.psum((seen & scene.alive).to(torch.float32), mesh, DATA_AXIS)
        accum = state.xyz_grad_accum + torch.where(seen_cnt > 0, gnorm, 0.0)
        denom = state.denom + seen_cnt
    else:
        max_radii, accum, denom = state.max_radii2d, state.xyz_grad_accum, state.denom
    # a strip's live instances: summed over the strips of one frame (each
    # holds its own), or their largest where every strip blends every splat
    inst = torch.tensor([total], dtype=torch.int64, device=full.device)
    inst = comm.pmax(inst, mesh, strip_axis) if sharded else comm.psum(inst, mesh, strip_axis)
    n_visible = visible.sum()
    metrics = StepMetrics(
        loss=comm.pmean(loss.detach(), mesh, DATA_AXIS),
        l1=comm.pmean(l1.detach(), mesh, DATA_AXIS),
        psnr=comm.pmean(losses.psnr(full.detach(), camera.gt_image), mesh, DATA_AXIS),
        num_instances=int(comm.pmax(inst, mesh, DATA_AXIS)),
        n_visible=comm.psum(n_visible, mesh, strip_axis) if sharded else n_visible,
    )
    new_state = dataclasses.replace(
        state, scene=scene, opt=new_opt, step=state.step + 1,
        max_radii2d=max_radii, xyz_grad_accum=accum, denom=denom,
    )
    return new_state, metrics


def make_parallel_train_step(
    opt_cfg: OptimizationParams,
    spatial_lr_scale: float,
    max_instances: int,
    mesh,
    image_height: int,
    lr_mult_fn=None,
    update_densify_stats: bool = True,
):
    """Build train_step(state, cameras, bg) -> (state, metrics) over the
    (data, space) `mesh`. `cameras` is a list of one camera per data rank,
    with ground truth; `max_instances` is the PER-STRIP instance cut."""
    lr_fns = optim.make_lr_fns(opt_cfg, spatial_lr_scale)
    n_space = comm.axis_size(mesh, SPACE_AXIS)
    n_data = comm.axis_size(mesh, DATA_AXIS)
    if image_height % n_space:
        raise ValueError(f"image height {image_height} not divisible by space={n_space}")
    strip_h = image_height // n_space
    y0 = comm.axis_index(mesh, SPACE_AXIS) * strip_h
    d = comm.axis_index(mesh, DATA_AXIS)

    def train_step(state: TrainState, cams: list[Camera], bg: torch.Tensor):
        camera = check_batch(cams, n_data)[d]
        params = param_leaves(state.scene)
        offset = torch.zeros((state.capacity, 2), dtype=torch.float32, device=state.scene.means.device,
                             requires_grad=True)
        strip, _ft, total, splats = render_strip(
            state.scene.with_params(params), camera, bg, y0, strip_h, max_instances, offset)
        full = comm.gather_strips(strip, mesh, SPACE_AXIS, dim=1)
        loss, l1 = strip_loss(opt_cfg, full, camera)
        grads, (offset_grad,) = gradients(loss, params, (), (offset,))

        with torch.no_grad():
            grads = {k: comm.pmean(comm.psum(g, mesh, SPACE_AXIS), mesh, DATA_AXIS) for k, g in grads.items()}
            scene, new_opt = adam_step(state, grads, lr_fns, lr_mult_fn)
        return finish_step(state, scene, new_opt, mesh, SPACE_AXIS, sharded=False, radius=splats.radius,
                           offset_grad=offset_grad, update_densify_stats=update_densify_stats,
                           loss=loss, l1=l1, full=full, camera=camera, total=total)

    return train_step
