"""Public render API.

Port of `lightgaussian_tpu/ops/rasterize/api.py`: `render(scene, camera, bg)`
returns a RenderOutput with the image, final transmittance, per-Gaussian
radii and visibility. `method` selects "tiled" (binning + the CUDA blend
kernels; plain torch on the CPU) or "reference" (the plain oracle).
`fast=True` selects the render-only kernel for inference callers. The
default exact path is differentiable in the scene's parameters, `bg` and
`mean2d_offset` (the training step's path). `count_render` adds the
per-Gaussian `gaussians_count` and `important_score`, the inputs of the
Global Significance Score; it has no backward.

`build_binning(scene, camera)` bins a keyframe once, and `render(...,
cached_binning=b)` renders a nearby camera over that order with fresh
features (trajectory frames; forward only).

Given no `max_instances`, a render or binning keeps every live instance (the
cut is `binning.MAX_CAPACITY`, and a frame of more raises): the instance
buffer is sized from the live count, so a high cut holds nothing. Where the
JAX package's default cut would bind, the port renders the frame whole.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.models.gaussians import GaussianScene
from lightgaussian_tpu_torch.ops.rasterize import reference as ref_mod
from lightgaussian_tpu_torch.ops.rasterize import tiled as tiled_mod
from lightgaussian_tpu_torch.ops.rasterize.binning import MAX_CAPACITY, estimate_max_instances
from lightgaussian_tpu_torch.ops.rasterize.projection import preprocess
from lightgaussian_tpu_torch.utils import stage_marks


@dataclasses.dataclass(frozen=True)
class RenderOutput:
    render: torch.Tensor  # [3, H, W]
    final_T: torch.Tensor  # [H, W] remaining transmittance
    radii: torch.Tensor  # [N] int32
    visibility: torch.Tensor  # [N] bool (radii > 0)
    num_instances: int  # live binned instances (tiled path; 0 for reference)
    gaussians_count: Optional[torch.Tensor] = None  # [N] int32 (count_render)
    important_score: Optional[torch.Tensor] = None  # [N] f32 (count_render)


def default_max_instances(scene: GaussianScene) -> int:
    """The trainers' first instance cut for `scene`, from its capacity (the
    JAX package's heuristic; the training loop grows it). Renders given no
    cut keep every live instance instead."""
    return estimate_max_instances(scene.capacity)


def build_binning(
    scene: GaussianScene,
    camera: Camera,
    scale_modifier: float = 1.0,
    max_instances: Optional[int] = None,
):
    """The scene's binning for this camera, for reuse through
    `render(..., cached_binning=...)` on the cameras near it."""
    if max_instances is None:
        max_instances = MAX_CAPACITY
    with torch.no_grad():
        splats = preprocess(scene, camera, scale_modifier=scale_modifier)
    stage_marks.mark("preprocess")
    b = tiled_mod.build_binning(splats, camera.width, camera.height, max_instances)
    stage_marks.mark("binning")
    return b


@stage_marks.in_unit("frame")
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
    cached_binning=None,
) -> RenderOutput:
    """`fast=True` selects the render-only kernel: `render`/`final_T` differ
    from the exact path only on early-stopped (saturated) pixels, by under
    1e-2. Training and parity use the default exact path.

    `cached_binning` (from `build_binning`) renders over a keyframe's order,
    forward only; it fixes the capacity, so `max_instances` must not be
    given with it, and `num_instances` reports the keyframe's total.

    A render that no step encloses is a unit of the spans, a frame
    (`utils.stage_marks.in_unit`)."""
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
    elif method == "tiled" and cached_binning is not None:
        if max_instances is not None:
            raise ValueError(
                "pass either max_instances or cached_binning, not both: the cached "
                "binning fixes the capacity"
            )
        image, final_t, total = tiled_mod.blend_tiled_cached(
            splats, bg, camera.width, camera.height, cached_binning, fast
        )
    elif method == "tiled":
        if max_instances is None:
            max_instances = MAX_CAPACITY
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


@torch.no_grad()
def count_render(
    scene: GaussianScene,
    camera: Camera,
    bg: torch.Tensor,
    scale_modifier: float = 1.0,
    max_instances: Optional[int] = None,
    method: str = "tiled",
) -> RenderOutput:
    """Forward render plus per-Gaussian blending statistics (no gradient)."""
    splats = preprocess(scene, camera, scale_modifier=scale_modifier)
    stage_marks.mark("preprocess")
    if method == "reference":
        image, final_t, cnt, imp = ref_mod.blend_reference(
            splats, camera.width, camera.height, bg, with_counts=True
        )
        total = 0
    elif method == "tiled":
        if max_instances is None:
            max_instances = MAX_CAPACITY
        image, final_t, total, cnt, imp = tiled_mod.blend_tiled_counting(
            splats, bg, camera.width, camera.height, max_instances
        )
    else:
        raise ValueError(f"unknown render method {method!r}")
    return RenderOutput(
        render=image,
        final_T=final_t,
        radii=splats.radius,
        visibility=splats.radius > 0,
        num_instances=total,
        gaussians_count=cnt,
        important_score=imp,
    )
