"""Camera-parallel Global Significance Score accumulation.

Port of `lightgaussian_tpu/parallel/gss.py`: the training cameras are split
over a mesh axis (``data`` by default), each rank sweeps its block of
cameras through the counting render (kernel B5), and the per-Gaussian hit
counts and importance are summed over the axis. The result, the same on
every rank, equals the sequential `train.gss.accumulate_gss` up to the
float32 regrouping of the importance sums.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import torch

from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.models.gaussians import GaussianScene
from lightgaussian_tpu_torch.ops.rasterize import count_render
from lightgaussian_tpu_torch.parallel import comm
from lightgaussian_tpu_torch.parallel.mesh import DATA_AXIS


def pad_cameras(cams: Sequence[Camera], multiple: int):
    """The cameras padded (by repeating the first) to a multiple of
    `multiple`, and their weights [M_pad] f32: 1 for a real camera, 0 for
    padding."""
    cams = list(cams)
    m = len(cams)
    if m == 0:
        raise ValueError("no cameras to accumulate over")
    m_pad = -(-m // multiple) * multiple
    w = torch.tensor([1.0] * m + [0.0] * (m_pad - m), dtype=torch.float32)
    return cams + [cams[0]] * (m_pad - m), w


def make_accumulate_gss_sharded(mesh, max_instances: int, cams_per_shard: int, axis: str = DATA_AXIS):
    """Build sweep(scene, cameras, weights, bg) -> (counts [CAP] int32,
    importance [CAP] f32) summed over the cameras of weight 1. `cameras`
    and `weights` have mesh.shape[axis] * cams_per_shard entries
    (`pad_cameras`); rank r sweeps entries [r * k, (r + 1) * k). A camera
    of weight 0 is not rendered."""
    r = comm.axis_index(mesh, axis)

    @torch.no_grad()
    def sweep(scene: GaussianScene, cams: list[Camera], w: torch.Tensor, bg: torch.Tensor, live_counts=None):
        dev = scene.means.device
        counts = torch.zeros(scene.capacity, dtype=torch.int32, device=dev)
        imp = torch.zeros(scene.capacity, dtype=torch.float32, device=dev)
        live = []
        for i in range(r * cams_per_shard, (r + 1) * cams_per_shard):
            if float(w[i]) == 0.0:
                continue
            out = count_render(scene, cams[i], bg, max_instances=max_instances)
            counts = counts + out.gaussians_count
            imp = imp + out.important_score
            live.append(out.num_instances)
        if live_counts is not None:
            n_live = torch.tensor(live + [-1] * (cams_per_shard - len(live)), dtype=torch.int64, device=dev)
            live_counts.extend(c for c in comm.all_gather(n_live, mesh, axis).tolist() if c >= 0)
        return comm.psum(counts, mesh, axis), comm.psum(imp, mesh, axis)

    return sweep


def accumulate_gss_sharded(
    mesh,
    scene: GaussianScene,
    cameras: Iterable[Camera],
    bg: torch.Tensor,
    max_instances: int,
    axis: str = DATA_AXIS,
    live_counts: list | None = None,
):
    """Camera-parallel `accumulate_gss`: (hit count int32 [N], importance
    f32 [N]) over `cameras`, split over `mesh`'s `axis`. Each camera's live
    instance count is appended to `live_counts` (in camera order) where one
    is given."""
    n_shards = comm.axis_size(mesh, axis)
    cams, w = pad_cameras(list(cameras), n_shards)
    sweep = make_accumulate_gss_sharded(mesh, int(max_instances), len(cams) // n_shards, axis)
    return sweep(scene, cams, w, bg, live_counts)
