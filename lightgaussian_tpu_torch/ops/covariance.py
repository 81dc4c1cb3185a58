"""Quaternion / scaling -> 3D covariance builders, and the EWA 2D projection.

Port of `lightgaussian_tpu/ops/covariance.py`. The K=3 products are written
as elementwise sums, as in the JAX package: a matrix product would compute
the same values in another summation order and move results by ulps.
Everything is vectorized over the leading Gaussian axis.
"""
from __future__ import annotations

import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unnormalized quaternion [..., 4] (w, x, y, z) -> rotation matrix [..., 3, 3]."""
    q = q / (torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True)) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def build_covariance_3d(
    scales: torch.Tensor, quats: torch.Tensor, scale_modifier: float = 1.0
) -> torch.Tensor:
    """(scales [...,3], quats [...,4]) -> full symmetric covariance [..., 3, 3].

    Sigma = R S S^T R^T with S = diag(scale_modifier * scales)."""
    R = quat_to_rotmat(quats)
    L = R * (scale_modifier * scales)[..., None, :]  # R @ diag(s)
    rows = [L[..., i, :] for i in range(3)]
    out = [[torch.sum(rows[i] * rows[j], dim=-1) for j in range(3)] for i in range(3)]
    return torch.stack([torch.stack(r, dim=-1) for r in out], dim=-2)


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """Full [..., 3, 3] -> upper-tri 6-vector (xx, xy, xz, yy, yz, zz)."""
    return torch.stack(
        [
            cov[..., 0, 0],
            cov[..., 0, 1],
            cov[..., 0, 2],
            cov[..., 1, 1],
            cov[..., 1, 2],
            cov[..., 2, 2],
        ],
        dim=-1,
    )


def unstrip_symmetric(c6: torch.Tensor) -> torch.Tensor:
    """Upper-tri 6-vector -> full symmetric [..., 3, 3]."""
    xx, xy, xz, yy, yz, zz = (c6[..., i] for i in range(6))
    return torch.stack(
        [
            torch.stack([xx, xy, xz], dim=-1),
            torch.stack([xy, yy, yz], dim=-1),
            torch.stack([xz, yz, zz], dim=-1),
        ],
        dim=-2,
    )


def ewa_project(
    means_cam: torch.Tensor,
    cov3d: torch.Tensor,
    focal_x,
    focal_y,
    tan_fovx,
    tan_fovy,
) -> torch.Tensor:
    """EWA splat: camera-space covariance -> 2D screen covariance [..., 3].

    Sigma2D = J Sigma_cam J^T, with camera-space x/y clamped to 1.3x the
    frustum half-angles and +0.3 on the diagonal (the 3D-GS low-pass filter).
    `cov3d` is already rotated into camera space. The focal lengths and FoV
    tangents are float32 scalars (0-d tensors or Python floats).

    Returns (cov_xx, cov_xy, cov_yy) stacked on the last axis.
    """
    tx, ty, tz = means_cam[..., 0], means_cam[..., 1], means_cam[..., 2]
    tz = torch.clamp(tz, min=1e-6)
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    txz = torch.clamp(tx / tz, min=-limx, max=limx) * tz
    tyz = torch.clamp(ty / tz, min=-limy, max=limy) * tz

    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    j00 = focal_x * inv_tz
    j02 = -focal_x * txz * inv_tz2
    j11 = focal_y * inv_tz
    j12 = -focal_y * tyz * inv_tz2

    c = cov3d
    a = j00 * (j00 * c[..., 0, 0] + j02 * c[..., 2, 0]) + j02 * (
        j00 * c[..., 0, 2] + j02 * c[..., 2, 2]
    )
    b = j11 * (j00 * c[..., 0, 1] + j02 * c[..., 2, 1]) + j12 * (
        j00 * c[..., 0, 2] + j02 * c[..., 2, 2]
    )
    d = j11 * (j11 * c[..., 1, 1] + j12 * c[..., 2, 1]) + j12 * (
        j11 * c[..., 1, 2] + j12 * c[..., 2, 2]
    )
    return torch.stack([a + 0.3, b, d + 0.3], dim=-1)
