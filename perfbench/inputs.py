"""The benchmark's inputs, made from the seed: Gaussians, cameras, targets.

Both sides get these same tensors and camera parameters: the program turns
them into its own scene and camera objects, the reference reads them as
they are. Everything is drawn on the device by a `torch.Generator` seeded
with the run's seed, in a few large calls; the draws that order the cameras
come from a numpy generator on the same seed, their jitter from one fixed
pool.
"""
from __future__ import annotations

import math

import numpy as np
import torch

def generator(seed: int, device: torch.device, stream: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 4 + stream) % (1 << 63))
    return g


def gaussians(cfg: dict, seed: int, device: torch.device) -> dict:
    """The configuration's scene: `num_gaussians` Gaussians with SH of degree
    `source_sh_degree`, means uniform in a cube, log-scales uniform between
    the logs of `scale_range`, SH DC normal (sd `sh_dc_sd`), SH rest normal
    (sd `sh_rest_sd`), quaternions normal, opacity logits uniform."""
    s = cfg["scene"]
    n = cfg["num_gaussians"]
    k = (cfg["source_sh_degree"] + 1) ** 2 - 1
    g = generator(seed, device)
    f32 = dict(dtype=torch.float32, device=device, generator=g)
    lo, hi = (math.log(v) for v in s["scale_range"])
    olo, ohi = s["opacity_logit_range"]
    return {
        "means": (torch.rand((n, 3), **f32) * 2.0 - 1.0) * s["half_width"],
        "sh_dc": torch.randn((n, 3), **f32) * s["sh_dc_sd"],
        "sh_rest": torch.randn((n, k, 3), **f32) * s["sh_rest_sd"],
        "log_scales": lo + torch.rand((n, 3), **f32) * (hi - lo),
        "quats": torch.randn((n, 4), **f32),
        "opacity_logits": olo + torch.rand((n,), **f32) * (ohi - olo),
    }


def truncate_sh(p: dict, degree: int) -> dict:
    """The Gaussians with SH above `degree` dropped."""
    k = (degree + 1) ** 2 - 1
    return {**p, "sh_rest": p["sh_rest"][:, :k, :].contiguous()}


def ring_eye(cfg: dict, angle: float) -> np.ndarray:
    """The eye at `angle` on the configuration's orbit, looking at its centre."""
    c = cfg["cameras"]
    return np.array([c["radius"] * math.sin(angle), c["height"], -c["radius"] * math.cos(angle)])


def ring_eyes(cfg: dict) -> list[np.ndarray]:
    n = cfg["train_views"]
    return [ring_eye(cfg, 2.0 * math.pi * i / n) for i in range(n)]


def extent(eyes: list[np.ndarray]) -> float:
    """The scene extent the trainer scales the means' rate by: 1.1 times the
    largest distance of a camera centre from their mean (NeRF++)."""
    c = np.stack(eyes)
    return float(np.linalg.norm(c - c.mean(axis=0), axis=1).max()) * 1.1


def targets(cfg: dict, seed: int, count: int, device: torch.device) -> torch.Tensor:
    """[count, 3, H, W] smooth images in [0, 1]: a coarse uniform grid per
    image, bilinearly upsampled."""
    h, w = cfg["height"], cfg["width"]
    coarse = torch.rand((count, 3, 12, 18), generator=generator(seed, device, 1), device=device)
    return torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False).contiguous()


def pose_order(seed: int, n: int, steps: int, jitter_sd: float = 0.0, jitter_every: int = 1,
               pool_seed: int = 0):
    """The cameras of `steps` steps, drawn from one fixed pool of poses: each
    of the n ring cameras `jitter_every` times, once as it is and otherwise
    with the eye and the point it looks at moved together by a normal draw of
    sd `jitter_sd` (by default each camera once, unmoved). The draws are made once, from `pool_seed`, and are the
    same for every seed; each block of the pool's size is the whole pool in
    an order the seed permutes, so every seed's window does the same work in
    another order. Returns [(camera index, offset [3])]."""
    rng0 = np.random.default_rng(pool_seed)
    pool = [(i, np.zeros(3) if k == 0 else rng0.normal(0.0, jitter_sd, 3))
            for i in range(n) for k in range(jitter_every)]
    rng = np.random.default_rng(int(seed))
    out = []
    while len(out) < steps:
        out.extend(pool[j] for j in rng.permutation(len(pool)).tolist())
    return out[:steps]
