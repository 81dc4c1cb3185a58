"""Space-sharded inference rendering: full frames assembled from each
rank's tile-row strip.

Port of `lightgaussian_tpu/parallel/render.py`. On a (data, space) mesh
each rank projects the (replicated) scene and blends one camera's strip of
rows (`render_strip`, the render-only kernel B6 by default); the frame is
gathered over ``space`` and the frames over ``data``, so a call renders
`data` frames at `space`-way strip parallelism each, and every rank holds
them all. Blending a strip is pixel-exact (every splat that overlaps a
strip's tiles is binned for that strip), so the frames equal the
single-device render up to float32 regrouping.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.ops.rasterize.binning import MAX_CAPACITY
from lightgaussian_tpu_torch.parallel import comm
from lightgaussian_tpu_torch.parallel.mesh import DATA_AXIS, SPACE_AXIS, make_mesh
from lightgaussian_tpu_torch.parallel.train import render_strip


def make_parallel_render(
    mesh,
    image_width: int,
    image_height: int,
    max_instances: int,
    fast: bool = True,
):
    """Build render_batch(scene, cameras, bg) -> (images [n_data, 3, H, W],
    final_T [n_data, H, W]) over `mesh`, the same on every rank.

    `cameras` is a list of one camera per data rank; `max_instances` is
    the PER-STRIP instance cut. The rows are split ceil(H / space) to a
    strip; the last strip renders past the image and is cropped after the
    gather."""
    n_space = comm.axis_size(mesh, SPACE_AXIS)
    n_data = comm.axis_size(mesh, DATA_AXIS)
    strip_h = -(-image_height // n_space)
    y0 = comm.axis_index(mesh, SPACE_AXIS) * strip_h
    d = comm.axis_index(mesh, DATA_AXIS)

    @torch.no_grad()
    def render_batch(scene, cams: list[Camera], bg: torch.Tensor):
        if len(cams) != n_data:
            raise ValueError(f"render_batch takes one camera per data rank ({n_data}), got {len(cams)}")
        camera = cams[d]
        if (camera.width, camera.height) != (image_width, image_height):
            raise ValueError(f"camera {camera.width}x{camera.height} != the mesh program's "
                             f"{image_width}x{image_height}")
        strip, strip_t, _total, _splats = render_strip(scene, camera, bg, y0, strip_h, max_instances,
                                                      fast=fast)
        image = comm.all_gather(strip, mesh, SPACE_AXIS, dim=1)
        final_t = comm.all_gather(strip_t, mesh, SPACE_AXIS, dim=0)
        images = comm.all_gather(image, mesh, DATA_AXIS, dim=0, stack=True)
        ts = comm.all_gather(final_t, mesh, DATA_AXIS, dim=0, stack=True)
        return images[:, :, :image_height], ts[:, :image_height]

    return render_batch


def parallel_render(
    scene,
    cameras: list[Camera],
    bg: torch.Tensor,
    mesh=None,
    max_instances: int | None = None,
    fast: bool = True,
) -> list[torch.Tensor]:
    """Render a list of cameras on a (data, space) mesh; returns the
    [3, H, W] images in camera order, on every rank.

    With `mesh=None` every process is on the ``space`` axis (strip
    parallelism, one frame at a time). The cameras must share one
    resolution. The list is padded to a multiple of the data axis by
    repeating its last camera, and the padded frames are dropped. Without
    `max_instances` every live instance of a strip is rendered."""
    if mesh is None:
        mesh = make_mesh(data=1, space=dist.get_world_size() if dist.is_initialized() else 1)
    cameras = list(cameras)
    if not cameras:
        return []
    w, h = cameras[0].width, cameras[0].height
    for c in cameras:
        if (c.width, c.height) != (w, h):
            raise ValueError(
                f"parallel_render requires a single resolution per call (got {w}x{h} and {c.width}x{c.height})"
            )
    if max_instances is None:
        max_instances = MAX_CAPACITY
    n_data = comm.axis_size(mesh, DATA_AXIS)
    fn = make_parallel_render(mesh, w, h, max_instances, fast)
    out: list[torch.Tensor] = []
    for i in range(0, len(cameras), n_data):
        batch = cameras[i:i + n_data]
        n_real = len(batch)
        batch = batch + [batch[-1]] * (n_data - n_real)
        images, _t = fn(scene, batch, bg)
        out.extend(images[:n_real].unbind(0))
    return out
