"""Scene: binds a dataset directory and a saved iteration to a GaussianScene.

Port of `lightgaussian_tpu/data/scene.py` for rendering a saved iteration:
scene-type sniffing, camera shuffling, the NeRF++ `cameras_extent`, and
`load_ply` / SH-truncating `load_ply_sh` loads. A fresh run (initialising
from the point cloud) needs the 3-NN scale initialisation of the training
slice, and `load_vq` the compression slice; both raise until then.
"""
from __future__ import annotations

import random
from pathlib import Path

import torch

from lightgaussian_tpu_torch.data import dataset as D
from lightgaussian_tpu_torch.data import ply as ply_io
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
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.source_path = Path(source_path)
        self.model_path = Path(model_path)
        self.loaded_iter = None
        if load_vq:
            raise NotImplementedError(
                "--load_vq (extreme_saving/ bundles) comes with the compression "
                "slice (ROADMAP.md, queue A, 'Compression')"
            )

        if load_iteration is not None:
            if load_iteration == -1:
                self.loaded_iter = max_saved_iteration(self.model_path / "point_cloud")
            else:
                self.loaded_iter = load_iteration
            print(f"Loading trained model at iteration {self.loaded_iter}")
        if not self.loaded_iter:
            raise NotImplementedError(
                "initialising a scene from its point cloud needs the 3-NN scale "
                "init of the CLI-trainer slice (ROADMAP.md, queue A); pass "
                "load_iteration to render a saved iteration"
            )

        info = D.read_scene(self.source_path, images_dir, white_background, eval_split)
        self.scene_info = info

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

        ply_path = self.model_path / "point_cloud" / f"iteration_{self.loaded_iter}" / "point_cloud.ply"
        self.gaussians = ply_io.load_gaussian_ply(
            ply_path, new_sh_degree=new_sh_degree, device=self.device
        )

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
