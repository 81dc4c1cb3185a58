"""Camera model: a frozen dataclass of tensors with precomputed view/projection.

Port of `lightgaussian_tpu/models/camera.py`. The matrices are built in
float64 numpy and cast to float32 exactly as the JAX package does, so both
packages hold bit-identical cameras. Column-vector convention:
x_cam = world_view @ x_world; clip = full_proj @ x_world.

The FoV tangents are 0-d float32 tensors, so focal lengths derived from them
are float32 as in the JAX package.

A camera batch (camera-batched training, the multi-device paths) is a plain
`list[Camera]` of one resolution, where the JAX package stacks the cameras
into one pytree; `stack_cameras` checks such a list, and the batched
steps call it on the list they are given.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from lightgaussian_tpu_torch.utils.device import resolve_device


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_view(R: np.ndarray, t: np.ndarray, translate=None, scale: float = 1.0) -> np.ndarray:
    """4x4 world->camera (`getWorld2View2`). `R` is the camera-to-world
    rotation as stored by the loaders, `t` the world->camera translation;
    optional recenter/rescale of the camera center."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else np.asarray(translate)
        C2W = np.linalg.inv(Rt)
        cam_center = (C2W[:3, 3] + translate) * scale
        C2W[:3, 3] = cam_center
        Rt = np.linalg.inv(C2W)
    return Rt.astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """OpenGL-style perspective with z in [0, 1] (`getProjectionMatrix`)."""
    tan_half_y = math.tan(fovy / 2.0)
    tan_half_x = math.tan(fovx / 2.0)
    top = tan_half_y * znear
    bottom = -top
    right = tan_half_x * znear
    left = -right
    P = np.zeros((4, 4), dtype=np.float32)
    z_sign = 1.0
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = z_sign
    P[2, 2] = z_sign * zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


@dataclasses.dataclass(frozen=True)
class Camera:
    """A render-ready camera on one device."""

    world_view: torch.Tensor  # [4, 4] world->camera
    full_proj: torch.Tensor  # [4, 4] world->clip (= proj @ world_view)
    camera_center: torch.Tensor  # [3]
    tan_fovx: torch.Tensor  # 0-d float32
    tan_fovy: torch.Tensor  # 0-d float32
    width: int
    height: int
    # Optional ground-truth image [3, H, W] in [0, 1].
    gt_image: Optional[torch.Tensor] = None
    # Optional SSIM moments (B(gt), B(gt^2)) of the ground truth
    # (`losses.precompute_ssim_target_stats`): the ground truth never
    # changes during training, so its two blur planes are computed once.
    gt_ssim_stats: Optional[tuple] = None

    def with_gt(self, img) -> "Camera":
        gt = torch.as_tensor(img, dtype=torch.float32).to(self.world_view.device)
        return dataclasses.replace(self, gt_image=gt)

    def with_gt_ssim_stats(self, stats) -> "Camera":
        return dataclasses.replace(self, gt_ssim_stats=stats)

    def _pixels(self, n: int) -> torch.Tensor:
        # `int / tensor` is a reciprocal times the int in torch; a true
        # float32 division rounds as the JAX package does.
        return torch.tensor(float(n), dtype=torch.float32, device=self.world_view.device)

    @property
    def focal_x(self) -> torch.Tensor:
        return self._pixels(self.width) / (2.0 * self.tan_fovx)

    @property
    def focal_y(self) -> torch.Tensor:
        return self._pixels(self.height) / (2.0 * self.tan_fovy)

    @classmethod
    def from_Rt(
        cls,
        R: np.ndarray,
        t: np.ndarray,
        fovx: float,
        fovy: float,
        width: int,
        height: int,
        znear: float = 0.01,
        zfar: float = 100.0,
        translate=None,
        scale: float = 1.0,
        device: str | torch.device = "cuda",
    ) -> "Camera":
        """Build from loader-convention R (cam2world rotation) and T."""
        dev = resolve_device(device)
        wv = world_to_view(R, t, translate, scale)
        proj = projection_matrix(znear, zfar, fovx, fovy)
        full = proj @ wv
        cam_center = np.linalg.inv(wv)[:3, 3]
        return cls(
            world_view=torch.from_numpy(wv).to(dev),
            full_proj=torch.from_numpy(full).to(dev),
            camera_center=torch.from_numpy(cam_center.astype(np.float32)).to(dev),
            tan_fovx=torch.tensor(np.float32(math.tan(fovx / 2.0)), device=dev),
            tan_fovy=torch.tensor(np.float32(math.tan(fovy / 2.0)), device=dev),
            width=int(width),
            height=int(height),
        )

    @classmethod
    def look_at(
        cls,
        eye,
        target,
        up=(0.0, 1.0, 0.0),
        fovx: float = math.radians(60),
        fovy: float | None = None,
        width: int = 256,
        height: int = 256,
        device: str | torch.device = "cuda",
    ) -> "Camera":
        """Camera at `eye` looking at `target` (x right, y down, z forward)."""
        eye = np.asarray(eye, np.float64)
        target = np.asarray(target, np.float64)
        up = np.asarray(up, np.float64)
        fwd = target - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, up)
        right = right / np.linalg.norm(right)
        down = np.cross(fwd, right)
        Rwc = np.stack([right, down, fwd], axis=0)
        t = -Rwc @ eye
        if fovy is None:
            fovy = 2.0 * math.atan(math.tan(fovx / 2.0) * height / width)
        return cls.from_Rt(Rwc.T, t, fovx, fovy, width, height, device=device)


def stack_cameras(cams) -> list[Camera]:
    """The cameras as a batch (a list); they must share one resolution."""
    cams = list(cams)
    if len({(c.width, c.height) for c in cams}) > 1:
        raise ValueError("a camera batch takes one resolution; got mixed resolutions")
    return cams
