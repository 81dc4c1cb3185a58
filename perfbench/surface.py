"""A scene shaped like a trained 3D-GS capture, drawn from the seed.

`inputs.gaussians` draws a uniform cube of small splats; a trained scene of
an unbounded capture (Mip-NeRF 360's `bicycle`) is made of surfaces: a
ground, an object in the middle, and a far background of large splats,
with heavy-tailed scales and opacities near 0 or 1. `gaussians` draws such
a scene for a configuration whose `scene.kind` is "surface", from the
parameters of its `scene`:

- parts: the shares of `num_gaussians` on a ground disk (radius
  `ground_radius` at height `ground_height`, jittered by `ground_jitter`),
  on an object shell (an ellipsoid of semi-axes `object_axes`, radially
  jittered by `object_jitter` of its radius) and on a background dome (the
  upper half of a sphere of radius `background_radius` standing on the
  ground, radially jittered by `background_jitter` of it);
- scales: log-normal, the same for a Gaussian's three axes, median
  `scale_median` (times `background_scale` on the dome) and sd
  `scale_log_sd` in the log, then one axis times `flatten`; orientations
  uniform (quaternions normal);
- opacity logits: normal of sd `opacity_logit_sd` around one of
  `opacity_logit_modes`, each mode as likely;
- SH: DC normal of sd `sh_dc_sd`, the rest of sd `sh_rest_sd`.

Everything is drawn on the device by `inputs.generator(seed, device)`, in a
few large calls, so the same seed gives the same scene on every run.
"""
from __future__ import annotations

import math

import torch

from perfbench import inputs


def _directions(n: int, f32: dict) -> torch.Tensor:
    d = torch.randn((n, 3), **f32)
    return d / torch.linalg.vector_norm(d, dim=1, keepdim=True).clamp(min=1e-12)


def part_sizes(cfg: dict) -> list[int]:
    """Gaussians on the ground, the object and the background, in that order."""
    n = cfg["num_gaussians"]
    parts = cfg["scene"]["parts"]
    ground = int(round(n * parts["ground"]))
    obj = int(round(n * parts["object"]))
    return [ground, obj, n - ground - obj]


def gaussians(cfg: dict, seed: int, device: torch.device) -> dict:
    """The configuration's surface-shaped scene: the fields `inputs.gaussians` gives."""
    s = cfg["scene"]
    if s.get("kind") != "surface":
        raise ValueError(f"scene kind {s.get('kind')!r} is not 'surface'")
    n = cfg["num_gaussians"]
    n_ground, n_obj, n_back = part_sizes(cfg)
    k = (cfg["source_sh_degree"] + 1) ** 2 - 1
    f32 = dict(dtype=torch.float32, device=device, generator=inputs.generator(seed, device))

    r = s["ground_radius"] * torch.sqrt(torch.rand((n_ground,), **f32))
    theta = 2.0 * math.pi * torch.rand((n_ground,), **f32)
    ground = torch.stack([r * torch.cos(theta), s["ground_height"] + s["ground_jitter"] * torch.randn(
        (n_ground,), **f32), r * torch.sin(theta)], dim=1)

    axes = torch.tensor(s["object_axes"], dtype=torch.float32, device=device)
    obj = _directions(n_obj, f32) * axes * (1.0 + s["object_jitter"] * torch.randn((n_obj, 1), **f32))

    d = _directions(n_back, f32)
    d = torch.cat([d[:, :1], d[:, 1:2].abs(), d[:, 2:]], dim=1)
    back = d * (s["background_radius"] * (1.0 + s["background_jitter"] * torch.randn((n_back, 1), **f32)))
    back = back + torch.tensor([0.0, s["ground_height"], 0.0], device=device)

    log_scale = math.log(s["scale_median"]) + s["scale_log_sd"] * torch.randn((n, 1), **f32)
    log_scale = log_scale + torch.cat([torch.zeros((n_ground + n_obj, 1), device=device),
                                       torch.full((n_back, 1), math.log(s["background_scale"]), device=device)])
    flat = torch.tensor([0.0, 0.0, math.log(s["flatten"])], dtype=torch.float32, device=device)

    lo, hi = s["opacity_logit_modes"]
    mode = torch.where(torch.rand((n,), **f32) < 0.5, lo, hi)
    return {
        "means": torch.cat([ground, obj, back]),
        "sh_dc": torch.randn((n, 3), **f32) * s["sh_dc_sd"],
        "sh_rest": torch.randn((n, k, 3), **f32) * s["sh_rest_sd"],
        "log_scales": (log_scale + flat).contiguous(),
        "quats": torch.randn((n, 4), **f32),
        "opacity_logits": mode + s["opacity_logit_sd"] * torch.randn((n,), **f32),
    }
