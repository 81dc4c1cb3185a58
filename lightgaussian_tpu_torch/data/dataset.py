"""Dataset readers: Blender/NeRF-synthetic scenes, and cameras on a device.

Port of the Blender half of `lightgaussian_tpu/data/dataset.py`: the
every-camera Blender reader with alpha compositing against the background,
the NeRF++ normalization radius, the >1600 px auto-downscale, and the
`cameras.json` export. Host work is numpy; images go through
`utils/image_io` (PIL only for formats other than 8-bit PNG). COLMAP scenes
come with the data slice.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from lightgaussian_tpu_torch.data import ply
from lightgaussian_tpu_torch.models.camera import Camera, focal2fov, fov2focal, world_to_view
from lightgaussian_tpu_torch.utils import image_io

_WARNED_LARGE = []

COLMAP_NOT_PORTED = (
    "COLMAP scenes are not read by the PyTorch port yet: the COLMAP readers "
    "come with the data slice (ROADMAP.md, queue A, 'Data and the first CLIs')"
)


@dataclasses.dataclass
class CameraInfo:
    """Host-side camera description; the image is read when the camera is
    materialized."""

    uid: int
    R: np.ndarray  # cam-to-world rotation (loader convention)
    T: np.ndarray  # world-to-cam translation
    fovx: float
    fovy: float
    image_path: str
    image_name: str
    width: int
    height: int
    # Blender scenes composite RGBA against this background at load time
    bg: np.ndarray | None = None


@dataclasses.dataclass
class SceneInfo:
    point_cloud: tuple[np.ndarray, np.ndarray, np.ndarray] | None  # (xyz, rgb01, normals)
    train_cameras: list[CameraInfo]
    test_cameras: list[CameraInfo]
    nerf_normalization: dict
    ply_path: str


def nerfpp_norm(cam_infos: list[CameraInfo]) -> dict:
    """Scene radius/translate from camera centers."""
    centers = []
    for cam in cam_infos:
        w2c = world_to_view(cam.R, cam.T)
        centers.append(np.linalg.inv(w2c)[:3, 3])
    centers = np.stack(centers, axis=0)
    avg = centers.mean(axis=0)
    diagonal = float(np.linalg.norm(centers - avg, axis=1).max())
    return {"translate": -avg, "radius": diagonal * 1.1}


def _read_transforms(path: Path, fname: str, white_background: bool) -> list[CameraInfo]:
    with open(path / fname) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    bg = np.ones(3) if white_background else np.zeros(3)

    infos = []
    for idx, frame in enumerate(contents["frames"]):
        image_path = path / (frame["file_path"] + ".png")
        c2w = np.array(frame["transform_matrix"], dtype=np.float64)
        c2w[:3, 1:3] *= -1  # OpenGL/Blender (Y up, Z back) -> COLMAP (Y down, Z fwd)
        w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])
        T = w2c[:3, 3]
        width, height = image_io.image_size(image_path)
        fovy = focal2fov(fov2focal(fovx, width), height)
        infos.append(
            CameraInfo(
                uid=idx, R=R, T=T, fovx=fovx, fovy=fovy,
                image_path=str(image_path), image_name=image_path.stem,
                width=width, height=height, bg=bg,
            )
        )
    return infos


def read_blender_scene(
    path: str | Path, white_background: bool = False, eval_split: bool = False
) -> SceneInfo:
    path = Path(path)
    train = _read_transforms(path, "transforms_train.json", white_background)
    test = _read_transforms(path, "transforms_test.json", white_background)
    if not eval_split:
        train = train + test
        test = []

    ply_path = path / "points3d.ply"
    if not ply_path.exists():
        # no SfM points: random init inside the synthetic bounds
        num_pts = 100_000
        rng = np.random.default_rng(0)
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        shs = rng.random((num_pts, 3)) / 255.0
        rgb = shs * 0.28209479177387814 + 0.5  # SH2RGB
        ply.store_point_cloud(ply_path, xyz, rgb * 255)
    pcd = ply.fetch_point_cloud(ply_path)

    return SceneInfo(pcd, train, test, nerfpp_norm(train), str(ply_path))


def detect_scene_type(path: str | Path) -> str:
    path = Path(path)
    if (path / "sparse").exists():
        return "Colmap"
    if (path / "transforms_train.json").exists():
        return "Blender"
    raise ValueError(f"Could not recognize scene type at {path}")


def read_scene(
    path: str | Path, images_dir: str = "images", white_background: bool = False, eval_split: bool = False
) -> SceneInfo:
    if detect_scene_type(path) == "Colmap":
        raise NotImplementedError(COLMAP_NOT_PORTED)
    return read_blender_scene(path, white_background, eval_split)


def _target_resolution(orig_w: int, orig_h: int, resolution: int, resolution_scale: float) -> tuple[int, int]:
    if resolution in (1, 2, 4, 8):
        return (
            round(orig_w / (resolution_scale * resolution)),
            round(orig_h / (resolution_scale * resolution)),
        )
    if resolution == -1:
        if orig_w > 1600:
            if not _WARNED_LARGE:
                print("[ INFO ] large input images (>1.6K px wide); rescaling to 1.6K. Use --resolution 1 to disable.")
                _WARNED_LARGE.append(True)
            global_down = orig_w / 1600
        else:
            global_down = 1.0
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def load_camera(
    info: CameraInfo,
    resolution: int = -1,
    device: str | torch.device = "cuda",
) -> Camera:
    """Materialize a CameraInfo on `device`: read and resize the gt image,
    build the matrices."""
    w, h = _target_resolution(info.width, info.height, resolution, 1.0)
    cam = Camera.from_Rt(info.R, info.T, info.fovx, info.fovy, w, h, device=device)
    arr = image_io.resize(image_io.read_image(info.image_path), w, h).astype(np.float32) / 255.0
    if arr.shape[2] == 1:
        arr = arr.repeat(3, axis=2)
    if arr.shape[2] == 4:
        rgb, alpha = arr[:, :, :3], arr[:, :, 3:4]
        bg = info.bg if info.bg is not None else np.zeros(3)
        arr = rgb * alpha + bg[None, None, :] * (1.0 - alpha)
    gt = np.clip(np.transpose(arr[:, :, :3], (2, 0, 1)), 0.0, 1.0)
    return cam.with_gt(gt)


def camera_to_json(idx: int, info: CameraInfo) -> dict:
    """`camera_to_JSON` of the reference."""
    w2c = np.eye(4)
    w2c[:3, :3] = info.R.T
    w2c[:3, 3] = info.T
    c2w = np.linalg.inv(w2c)
    return {
        "id": idx,
        "img_name": info.image_name,
        "width": info.width,
        "height": info.height,
        "position": c2w[:3, 3].tolist(),
        "rotation": [row.tolist() for row in c2w[:3, :3]],
        "fy": fov2focal(info.fovy, info.height),
        "fx": fov2focal(info.fovx, info.width),
    }
