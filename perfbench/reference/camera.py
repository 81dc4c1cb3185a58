"""Pinhole cameras of the benchmark's inputs, as plain matrices.

A camera is given by its eye, the point it looks at, its horizontal field of
view and its image size. The matrices are built in float64 numpy and rounded
to float32, world->camera with x right, y down and z forward, and an OpenGL
projection with z in [0, 1] (znear 0.01, zfar 100), the 3D-GS conventions.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

ZNEAR, ZFAR = 0.01, 100.0


@dataclasses.dataclass(frozen=True)
class View:
    world_view: torch.Tensor  # [4, 4] f32
    full_proj: torch.Tensor  # [4, 4] f32
    center: torch.Tensor  # [3] f32
    tan_fovx: torch.Tensor  # 0-d f32
    tan_fovy: torch.Tensor  # 0-d f32
    width: int
    height: int

    @property
    def focal_x(self) -> torch.Tensor:
        return torch.tensor(float(self.width), dtype=torch.float32, device=self.world_view.device) / (
            2.0 * self.tan_fovx)

    @property
    def focal_y(self) -> torch.Tensor:
        return torch.tensor(float(self.height), dtype=torch.float32, device=self.world_view.device) / (
            2.0 * self.tan_fovy)


def projection(fovx: float, fovy: float) -> np.ndarray:
    top = math.tan(fovy / 2.0) * ZNEAR
    right = math.tan(fovx / 2.0) * ZNEAR
    p = np.zeros((4, 4), dtype=np.float32)
    p[0, 0] = 2.0 * ZNEAR / (right + right)
    p[1, 1] = 2.0 * ZNEAR / (top + top)
    p[0, 2] = (right - right) / (right + right)
    p[1, 2] = (top - top) / (top + top)
    p[3, 2] = 1.0
    p[2, 2] = ZFAR / (ZFAR - ZNEAR)
    p[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    return p


def look_at(eye, target, fovx: float, width: int, height: int, device) -> View:
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    rot = np.stack([right, down, fwd], axis=0)
    wv = np.zeros((4, 4), dtype=np.float64)
    wv[:3, :3] = rot
    wv[:3, 3] = -rot @ eye
    wv[3, 3] = 1.0
    wv = wv.astype(np.float32)
    fovy = 2.0 * math.atan(math.tan(fovx / 2.0) * height / width)
    full = projection(fovx, fovy) @ wv
    center = np.linalg.inv(wv)[:3, 3].astype(np.float32)
    return View(
        world_view=torch.from_numpy(wv).to(device),
        full_proj=torch.from_numpy(full).to(device),
        center=torch.from_numpy(center).to(device),
        tan_fovx=torch.tensor(np.float32(math.tan(fovx / 2.0)), device=device),
        tan_fovy=torch.tensor(np.float32(math.tan(fovy / 2.0)), device=device),
        width=int(width),
        height=int(height),
    )
