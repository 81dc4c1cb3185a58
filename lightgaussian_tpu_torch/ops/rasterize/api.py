"""Public render API.

Port of `lightgaussian_tpu/ops/rasterize/api.py`: `render(scene, camera, bg)`
returns a RenderOutput with the image, final transmittance, per-Gaussian
radii and visibility. `method` selects "tiled" (binning + the CUDA blend
kernels; plain torch on the CPU) or "reference" (the plain oracle).
`fast=True` selects the render-only kernel for inference callers. The
default exact path is differentiable in the scene's parameters, `bg` and
`mean2d_offset` (the training step's path).

Cached binning (trajectory reuse) and `count_render` (GSS statistics) come
with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.models.gaussians import GaussianScene
from lightgaussian_tpu_torch.ops.rasterize import reference as ref_mod
from lightgaussian_tpu_torch.ops.rasterize import tiled as tiled_mod
from lightgaussian_tpu_torch.ops.rasterize.binning import estimate_max_instances
from lightgaussian_tpu_torch.ops.rasterize.projection import preprocess
from lightgaussian_tpu_torch.utils import stage_marks


@dataclasses.dataclass(frozen=True)
class RenderOutput:
    render: torch.Tensor  # [3, H, W]
    final_T: torch.Tensor  # [H, W] remaining transmittance
    radii: torch.Tensor  # [N] int32
    visibility: torch.Tensor  # [N] bool (radii > 0)
    num_instances: int  # live binned instances (tiled path; 0 for reference)


def default_max_instances(scene: GaussianScene) -> int:
    """The instance budget of a frame of `scene`, from its capacity."""
    return estimate_max_instances(scene.capacity)


def render(
    scene: GaussianScene,
    camera: Camera,
    bg: torch.Tensor,
    scale_modifier: float = 1.0,
    mean2d_offset: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    max_instances: Optional[int] = None,
    method: str = "tiled",
    fast: bool = False,
) -> RenderOutput:
    """`fast=True` selects the render-only kernel: `render`/`final_T` differ
    from the exact path only on early-stopped (saturated) pixels, by under
    1e-2. Training and parity use the default exact path."""
    splats = preprocess(
        scene,
        camera,
        scale_modifier=scale_modifier,
        mean2d_offset=mean2d_offset,
        colors_precomp=colors_precomp,
        cov3d_precomp=cov3d_precomp,
    )
    stage_marks.mark("preprocess")
    if method == "reference":
        image, final_t = ref_mod.blend_reference(splats, camera.width, camera.height, bg)
        total = 0
    elif method == "tiled":
        if max_instances is None:
            max_instances = default_max_instances(scene)
        blend = tiled_mod.blend_tiled_fast if fast else tiled_mod.blend_tiled
        image, final_t, total = blend(splats, bg, camera.width, camera.height, max_instances)
    else:
        raise ValueError(f"unknown render method {method!r}")
    return RenderOutput(
        render=image,
        final_T=final_t,
        radii=splats.radius,
        visibility=splats.radius > 0,
        num_instances=total,
    )
