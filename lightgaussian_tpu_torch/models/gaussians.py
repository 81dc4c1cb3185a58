"""GaussianScene: the model state as fixed-capacity tensors plus an alive mask.

Port of `lightgaussian_tpu/models/gaussians.py`. The scene keeps a capacity
`N_max` and a boolean `alive` mask, as the JAX package does, so states,
checkpoints and renders compare slot for slot. Parameterization: log-scales
(exp activation), logit opacity (sigmoid), unnormalized quaternion
(normalized in the covariance builder), SH split into a DC band and `rest`
coefficients.

`from_point_cloud` needs the 3-NN scale initialisation (`ops/knn`), which
comes with the CLI-trainer slice (ROADMAP A2).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
