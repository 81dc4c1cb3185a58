"""GaussianScene: the model state as fixed-capacity tensors plus an alive mask.

Port of `lightgaussian_tpu/models/gaussians.py`. The scene keeps a capacity
`N_max` and a boolean `alive` mask, as the JAX package does, so states,
checkpoints and renders compare slot for slot. Parameterization: log-scales
(exp activation), logit opacity (sigmoid), unnormalized quaternion
(normalized in the covariance builder), SH split into a DC band and `rest`
coefficients.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lightgaussian_tpu_torch.ops import knn
from lightgaussian_tpu_torch.ops import sh as sh_ops
from lightgaussian_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class GaussianScene:
    means: torch.Tensor  # [N_max, 3]
    sh_dc: torch.Tensor  # [N_max, 3]
    sh_rest: torch.Tensor  # [N_max, K, 3], K = (max_sh+1)^2 - 1
    log_scales: torch.Tensor  # [N_max, 3]
    quats: torch.Tensor  # [N_max, 4] (w, x, y, z)
    opacity_logits: torch.Tensor  # [N_max]
    alive: torch.Tensor  # [N_max] bool
    active_sh_degree: int
    max_sh_degree: int

    PARAM_FIELDS = ("means", "sh_dc", "sh_rest", "log_scales", "quats", "opacity_logits")

    @property
    def capacity(self) -> int:
        return int(self.means.shape[0])

    @property
    def scales(self) -> torch.Tensor:
        return torch.exp(self.log_scales)

    @property
    def opacities(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity_logits)

    @property
    def sh_coeffs(self) -> torch.Tensor:
        """[N, (max_sh+1)^2, 3] full SH tensor (dc ++ rest)."""
        return torch.cat([self.sh_dc[:, None, :], self.sh_rest], dim=1)

    def num_alive(self) -> int:
        return int(self.alive.sum())

    # ---- trainable-parameter view ----
    def params(self) -> dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in self.PARAM_FIELDS}

    def with_params(self, params: dict[str, torch.Tensor]) -> "GaussianScene":
        return dataclasses.replace(self, **params)

    # ---- SH degree schedule ----
    def one_up_sh_degree(self) -> "GaussianScene":
        if self.active_sh_degree < self.max_sh_degree:
            return dataclasses.replace(self, active_sh_degree=self.active_sh_degree + 1)
        return self

    def truncate_sh(self, new_max_degree: int) -> "GaussianScene":
        """Drop SH coefficients above `new_max_degree` (the distillation
        student's start)."""
        k_new = sh_ops.num_sh_coeffs(new_max_degree) - 1
        return dataclasses.replace(
            self,
            sh_rest=self.sh_rest[:, :k_new, :],
            max_sh_degree=new_max_degree,
            active_sh_degree=min(self.active_sh_degree, new_max_degree),
        )


def empty_scene(
    capacity: int,
    max_sh_degree: int = 3,
    active_sh_degree: int = 0,
    device: str | torch.device = "cuda",
) -> GaussianScene:
    dev = resolve_device(device)
    k_rest = sh_ops.num_sh_coeffs(max_sh_degree) - 1
    f32 = dict(dtype=torch.float32, device=dev)
    return GaussianScene(
        means=torch.zeros((capacity, 3), **f32),
        sh_dc=torch.zeros((capacity, 3), **f32),
        sh_rest=torch.zeros((capacity, k_rest, 3), **f32),
        log_scales=torch.zeros((capacity, 3), **f32),
        quats=torch.tensor([1.0, 0.0, 0.0, 0.0], **f32).repeat(capacity, 1),
        opacity_logits=torch.full((capacity,), -10.0, **f32),
        alive=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        active_sh_degree=active_sh_degree,
        max_sh_degree=max_sh_degree,
    )


CAPACITY_GRANULE = 4096


def round_capacity(n: int) -> int:
    """Bucket capacities the way the JAX package does, so that a scene loaded
    by either package has the same slots."""
    g = CAPACITY_GRANULE
    return max(g, ((n + g - 1) // g) * g)


def fill_scene(scene: GaussianScene, arrays: dict, n: int) -> GaussianScene:
    """Copy host arrays into the first `n` slots of `scene` and mark them
    alive. `arrays` maps parameter names to numpy arrays of `n` rows."""
    new = {}
    for k, v in arrays.items():
        buf = getattr(scene, k).clone()
        buf[:n] = torch.from_numpy(np.array(v, dtype=np.float32)).to(buf.device)
        new[k] = buf
    alive = scene.alive.clone()
    alive[:n] = True
    return dataclasses.replace(scene, alive=alive, **new)


def from_point_cloud(
    points: np.ndarray,
    colors: np.ndarray,
    max_sh_degree: int = 3,
    device: str | torch.device = "cuda",
) -> GaussianScene:
    """A scene from an SfM point cloud, as the reference's `create_from_pcd`
    makes it: DC SH from RGB, isotropic log-scale from the square root of
    the mean squared distance to the 3 nearest points, identity rotation,
    opacity 0.1. The 3-NN search runs on `device`."""
    n = points.shape[0]
    scene = empty_scene(round_capacity(n), max_sh_degree, device=device)
    dev = scene.means.device

    pts = torch.from_numpy(np.array(points, dtype=np.float32)).to(dev)
    dist2 = torch.clamp(knn.mean_sq_dist_to_3nn(pts), min=1e-7)
    log_scale = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    sh_dc = sh_ops.rgb_to_sh(torch.from_numpy(np.array(colors, dtype=np.float32)).to(dev))
    opacity_logit = float(np.log(0.1 / (1.0 - 0.1)))

    def fill(buf, vals):
        new = buf.clone()
        new[:n] = vals
        return new

    return dataclasses.replace(
        scene,
        means=fill(scene.means, pts),
        sh_dc=fill(scene.sh_dc, sh_dc),
        log_scales=fill(scene.log_scales, log_scale),
        opacity_logits=fill(scene.opacity_logits, opacity_logit),
        alive=fill(scene.alive, True),
    )


def compact(scene: GaussianScene, new_capacity: int | None = None) -> GaussianScene:
    """Pack alive Gaussians to the front, in their order (one stable sort by
    the dead flag), optionally into another capacity; rows past a smaller
    one are cut."""
    order = torch.argsort((~scene.alive).to(torch.uint8), stable=True)  # alive first
    n_alive = scene.alive.sum()
    cap = scene.capacity if new_capacity is None else new_capacity

    def reorder(x):
        x = x[order]
        if cap <= scene.capacity:
            return x[:cap]
        return torch.nn.functional.pad(x, [0, 0] * (x.dim() - 1) + [0, cap - scene.capacity])

    new = {k: reorder(v) for k, v in scene.params().items()}
    alive = torch.arange(cap, device=scene.alive.device) < n_alive
    return dataclasses.replace(scene, alive=alive, **new)
