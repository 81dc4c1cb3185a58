"""Scene: binds a dataset directory to a GaussianScene.

Port of `lightgaussian_tpu/data/scene.py`: scene-type sniffing, the first
run's `input.ply` copy and `cameras.json` export, camera shuffling, the
NeRF++ `cameras_extent`, and the model's start: from the point cloud for a
fresh run; for a saved iteration `load_ply`, SH-truncating `load_ply_sh`, or
with `load_vq` its `extreme_saving/` bundle (the VecTree-compressed model).
Saving writes `point_cloud/iteration_N/point_cloud.ply` in the reference's
layout.
"""
from __future__ import annotations

import json
import random
import shutil
from pathlib import Path

import torch

from lightgaussian_tpu_torch.compress import vectree
from lightgaussian_tpu_torch.data import dataset as D
from lightgaussian_tpu_torch.data import ply as ply_io
from lightgaussian_tpu_torch.models import gaussians as G
from lightgaussian_tpu_torch.utils.device import resolve_device


class Scene:
    def __init__(
        self,
        source_path: str,
        model_path: str,
        images_dir: str = "images",
        white_background: bool = False,
        eval_split: bool = False,
        resolution: int = -1,
        load_iteration: int | None = None,
        shuffle: bool = True,
        new_sh_degree: int | None = None,
        load_vq: bool = False,
        max_sh_degree: int = 3,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.source_path = Path(source_path)
        self.model_path = Path(model_path)
        self.loaded_iter = None

        if load_iteration is not None:
            if load_iteration == -1:
                self.loaded_iter = max_saved_iteration(self.model_path / "point_cloud")
            else:
                self.loaded_iter = load_iteration
            print(f"Loading trained model at iteration {self.loaded_iter}")

        info = D.read_scene(self.source_path, images_dir, white_background, eval_split)
        self.scene_info = info

        if not self.loaded_iter:
            self.model_path.mkdir(parents=True, exist_ok=True)
            try:
                shutil.copyfile(info.ply_path, self.model_path / "input.ply")
            except OSError:
                pass
            cam_json = [
                D.camera_to_json(i, c)
                for i, c in enumerate(info.test_cameras + info.train_cameras)
            ]
            (self.model_path / "cameras.json").write_text(json.dumps(cam_json))

        if shuffle:
            rng = random.Random(seed)
            rng.shuffle(info.train_cameras)
            rng.shuffle(info.test_cameras)

        self.cameras_extent = info.nerf_normalization["radius"]

        self.train_cameras = [
            D.load_camera(c, resolution, device=self.device) for c in info.train_cameras
        ]
        self.test_cameras = [
            D.load_camera(c, resolution, device=self.device) for c in info.test_cameras
        ]

        if self.loaded_iter:
            it_dir = self.model_path / "point_cloud" / f"iteration_{self.loaded_iter}"
            if load_vq:
                self.gaussians = vectree.load_vq_scene(it_dir / "extreme_saving", device=self.device)
            else:
                self.gaussians = ply_io.load_gaussian_ply(
                    it_dir / "point_cloud.ply", new_sh_degree=new_sh_degree, device=self.device
                )
        else:
            pts, cols, _ = info.point_cloud
            self.gaussians = G.from_point_cloud(pts, cols, max_sh_degree=max_sh_degree, device=self.device)

    def save(self, iteration: int, scene: "G.GaussianScene | None" = None) -> Path:
        out = self.model_path / "point_cloud" / f"iteration_{iteration}" / "point_cloud.ply"
        ply_io.save_gaussian_ply(scene if scene is not None else self.gaussians, out)
        return out

    def getTrainCameras(self):
        return self.train_cameras

    def getTestCameras(self):
        return self.test_cameras


def max_saved_iteration(point_cloud_dir: Path) -> int:
    """`searchForMaxIteration` of the reference."""
    iters = [
        int(p.name.split("_")[-1])
        for p in Path(point_cloud_dir).iterdir()
        if p.name.startswith("iteration_")
    ]
    if not iters:
        raise FileNotFoundError(f"no saved iterations under {point_cloud_dir}")
    return max(iters)
