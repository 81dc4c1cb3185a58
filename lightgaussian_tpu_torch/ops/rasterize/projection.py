"""Per-Gaussian preprocess: frustum cull, EWA projection, conic, radius, SH color.

Port of `lightgaussian_tpu/ops/rasterize/projection.py`. Elementwise over N
Gaussians in plain torch; only the blend stage has a hand-written kernel. The
K=3 products are broadcast sums, as in the JAX package, so `mean2d` rounds
the same way in both.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.models.gaussians import GaussianScene
from lightgaussian_tpu_torch.ops import covariance as cov_ops
from lightgaussian_tpu_torch.ops import sh as sh_ops
from lightgaussian_tpu_torch.utils import stage_marks

NEAR_PLANE = 0.2  # the CUDA reference culls p_view.z <= 0.2
ALPHA_EPS = 1.0 / 255.0  # min alpha to blend
T_EPS = 1e-4  # transmittance early-stop threshold
MAX_ALPHA = 0.99


@dataclasses.dataclass(frozen=True)
class Splats:
    """Screen-space Gaussians ready for blending."""

    mean2d: torch.Tensor  # [N, 2] pixel coords
    conic: torch.Tensor  # [N, 3] inverse 2D covariance (a, b, c)
    color: torch.Tensor  # [N, 3] RGB
    opacity: torch.Tensor  # [N]
    depth: torch.Tensor  # [N] camera-space z (inf = culled)
    radius: torch.Tensor  # [N] int32 pixel radius (0 = culled)


def view_colors(scene: GaussianScene, camera: Camera) -> torch.Tensor:
    """[N, 3] clamped RGB of each Gaussian's SH seen from the camera centre."""
    dirs = scene.means - camera.camera_center
    dirs = dirs / (torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True)) + 1e-12)
    return sh_ops.sh_to_rgb(scene.active_sh_degree, scene.sh_coeffs, dirs)


@stage_marks.in_span("projection")
def preprocess(
    scene: GaussianScene,
    camera: Camera,
    scale_modifier: float = 1.0,
    mean2d_offset: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
) -> Splats:
    """Project all Gaussians to screen space.

    `mean2d_offset` ([N, 2], NDC units) is added to the projected NDC centers
    (the training step differentiates through it for densification).
    `colors_precomp` / `cov3d_precomp` override the SH colors and the
    covariance built from scales and rotations.

    In the spans (`utils.stage_marks`), "covariance" (the 3D and 2D
    covariance, conic and radius) and "sh" (the colour) lie inside
    "projection", which holds the rest: the means' projection and the
    culling.
    """
    means = scene.means
    wv = camera.world_view
    fp = camera.full_proj

    def matvec3(m3):  # rows [3, 3] applied to means -> [N, 3]
        return torch.sum(means[:, None, :] * m3[None, :, :], dim=-1)

    p_view = matvec3(wv[:3, :3]) + wv[:3, 3]
    depth = p_view[:, 2]

    p_hom = matvec3(fp[:3, :3]) + fp[:3, 3]
    p_w = torch.sum(means * fp[3, :3], dim=-1) + fp[3, 3]
    inv_w = 1.0 / (p_w + 1e-7)
    ndc = p_hom[:, :2] * inv_w[:, None]
    if mean2d_offset is not None:
        ndc = ndc + mean2d_offset
    size = torch.tensor([camera.width, camera.height], dtype=torch.float32, device=means.device)
    mean2d = ((ndc + 1.0) * size - 1.0) * 0.5

    with stage_marks.span("covariance"):
        if cov3d_precomp is not None:
            cov3d = cov_ops.unstrip_symmetric(cov3d_precomp)
        else:
            cov3d = cov_ops.build_covariance_3d(scene.scales, scene.quats, scale_modifier)
        Wr = wv[:3, :3]
        # W @ Sigma @ W^T component-wise.
        tmp = torch.sum(Wr[None, :, None, :] * cov3d[:, None, :, :], dim=-1)  # [N,3,3]
        cov_cam = torch.sum(tmp[:, :, None, :] * Wr[None, None, :, :], dim=-1)
        cov2d = cov_ops.ewa_project(
            p_view, cov_cam, camera.focal_x, camera.focal_y, camera.tan_fovx, camera.tan_fovy
        )
        a, b, c = cov2d[:, 0], cov2d[:, 1], cov2d[:, 2]
        det = a * c - b * b
        det_valid = det > 0.0
        inv_det = torch.where(det_valid, 1.0 / torch.where(det_valid, det, 1.0), 0.0)
        conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

        # Pixel radius from the larger eigenvalue (3 sigma).
        mid = 0.5 * (a + c)
        lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        radius_f = torch.ceil(3.0 * torch.sqrt(lambda1))

    with stage_marks.span("sh"):
        color = colors_precomp if colors_precomp is not None else view_colors(scene, camera)

    valid = scene.alive & (depth > NEAR_PLANE) & det_valid
    radius = torch.where(valid, radius_f, 0.0).to(torch.int32)
    opacity = torch.where(valid, scene.opacities, 0.0)

    return Splats(
        mean2d=mean2d,
        conic=conic,
        color=color,
        opacity=opacity,
        depth=torch.where(valid, depth, torch.inf),
        radius=radius,
    )
