"""LPIPS perceptual metric: VGG16 features as a torch module.

Port of `lightgaussian_tpu/eval/lpips.py` (the LPIPS v0.1 criterion): five
ReLU-block feature stacks, unit-normalized along channels, the squared
difference weighted by 1x1 "lin" weights, the spatial mean, summed over the
stages. The convolutions are `F.conv2d` (3x3, padding 1) and the pools
`F.max_pool2d` (2x2, stride 2), in float32 with TF32 off inside the call.

The input scaling is the JAX package's (and the reference pipeline's):
the shift/scale constants assume [-1, 1] inputs, but [0, 1] images go in,
and published 3D-GS LPIPS numbers carry that.

Weights: a converted npz (`convert_torch_lpips`: conv{i}_w HWIO,
conv{i}_b, lin{s}) from `eval/weights/lpips_vgg.npz` beside this module,
`$LPIPS_WEIGHTS`, or an argument. Without one, a seeded random VGG whose
convolutions are drawn as the JAX package draws them (`utils/threefry.py`),
so both packages score with the same network; such scores are tagged
`vgg-random` and are not comparable to published LPIPS.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from lightgaussian_tpu_torch.utils import threefry
from lightgaussian_tpu_torch.utils.device import resolve_device

# VGG16 conv layout: (out_channels, n_convs) per block
VGG_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


class LPIPS(torch.nn.Module):
    """The LPIPS distance with fixed weights: `convs` are (weight OIHW,
    bias) per convolution, `lins` the five stages' channel weights, `kind`
    "vgg-pretrained" or "vgg-random"."""

    def __init__(self, convs, lins, kind: str):
        super().__init__()
        self.kind = kind
        for i, (w, b) in enumerate(convs):
            self.register_buffer(f"conv{i}_w", w.to(torch.float32))
            self.register_buffer(f"conv{i}_b", b.to(torch.float32))
        for s, lin in enumerate(lins):
            self.register_buffer(f"lin{s}", lin.to(torch.float32))
        dev = self.conv0_w.device
        self.register_buffer("shift", torch.tensor(LPIPS_SHIFT, dtype=torch.float32, device=dev).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(LPIPS_SCALE, dtype=torch.float32, device=dev).reshape(1, 3, 1, 1))

    def features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: [N, 3, H, W] in [0, 1] -> the five ReLU-slice activations."""
        h = (x - self.shift) / self.scale
        feats = []
        ci = 0
        for b, (_, n_convs) in enumerate(VGG_BLOCKS):
            for _ in range(n_convs):
                h = F.relu(F.conv2d(h, getattr(self, f"conv{ci}_w"), getattr(self, f"conv{ci}_b"), padding=1))
                ci += 1
            feats.append(h)
            if b < len(VGG_BLOCKS) - 1:
                h = F.max_pool2d(h, 2, 2)
        return feats

    @torch.no_grad()
    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The LPIPS distance between [N, 3, H, W] (or [3, H, W]) images in
        [0, 1], averaged over N."""
        if x.dim() == 3:
            x, y = x[None], y[None]
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                         allow_tf32=False):
            total = 0.0
            for s, (f1, f2) in enumerate(zip(self.features(x), self.features(y))):
                d = (_unit_normalize(f1) - _unit_normalize(f2)) ** 2
                weighted = (d * getattr(self, f"lin{s}")[None, :, None, None]).sum(dim=1)
                total = total + weighted.mean(dim=(1, 2))
        return total.mean()


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + eps)


def random_lpips_params(seed: int = 0, device: str | torch.device = "cuda") -> LPIPS:
    """The seeded random VGG16 of the JAX package: He-normal convolutions
    drawn with `jax.random.normal` from split keys, zero biases, uniform lin
    weights."""
    dev = resolve_device(device)
    key = threefry.prng_key(seed)
    convs = []
    c_in = 3
    for c_out, n_convs in VGG_BLOCKS:
        for _ in range(n_convs):
            key, k1 = threefry.split(key)
            w = threefry.normal(k1, (3, 3, c_in, c_out), device=dev) * float(np.float32(np.sqrt(2.0 / (9 * c_in))))
            convs.append((w.permute(3, 2, 0, 1).contiguous(), torch.zeros(c_out, device=dev)))
            c_in = c_out
    lins = [torch.full((c,), float(np.float32(1.0 / c)), dtype=torch.float32, device=dev) for c, _ in VGG_BLOCKS]
    return LPIPS(convs, lins, "vgg-random")


def load_lpips_params(path: str | Path, device: str | torch.device = "cuda") -> LPIPS:
    """Converted pretrained weights from an npz (conv{i}_w HWIO, conv{i}_b,
    lin{s})."""
    from lightgaussian_tpu_torch import convert  # here: convert imports this module

    with np.load(path) as z:
        n_convs = sum(1 for k in z.files if k.endswith("_w"))
        convs = [(z[f"conv{i}_w"], z[f"conv{i}_b"]) for i in range(n_convs)]
        lins = [z[f"lin{s}"] for s in range(len(VGG_BLOCKS))]
    return convert.lpips_params_from_numpy(convs, lins, "vgg-pretrained", device)


def convert_torch_lpips(vgg_state: dict, lin_state: dict, out_path: str | Path) -> None:
    """Write torchvision's VGG16 `features` state_dict (OIHW) and the
    LPIPS `lin` state_dict as the npz layout (HWIO), once, where they are."""
    arrays = {}
    conv_ids = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    for i, lid in enumerate(conv_ids):
        w = np.asarray(vgg_state[f"{lid}.weight"])  # [O, I, H, W]
        arrays[f"conv{i}_w"] = np.transpose(w, (2, 3, 1, 0))  # -> HWIO
        arrays[f"conv{i}_b"] = np.asarray(vgg_state[f"{lid}.bias"])
    for s in range(len(VGG_BLOCKS)):
        arrays[f"lin{s}"] = np.asarray(lin_state[f"lin{s}.model.1.weight"]).reshape(-1)
    np.savez(out_path, **arrays)


DEFAULT_WEIGHTS = Path(__file__).parent / "weights" / "lpips_vgg.npz"
_CACHED: dict[tuple[str, str], LPIPS] = {}


def get_lpips_params(weights_path: str | Path | None = None, device: str | torch.device = "cuda") -> LPIPS:
    """Pretrained weights if a file exists (the argument, $LPIPS_WEIGHTS,
    or the default location), else the seeded random network; one module
    per file and device, made once."""
    dev = resolve_device(device)
    path = weights_path or os.environ.get("LPIPS_WEIGHTS") or DEFAULT_WEIGHTS
    key = (str(path), str(dev))
    if key not in _CACHED:
        _CACHED[key] = load_lpips_params(path, dev) if Path(path).exists() else random_lpips_params(device=dev)
    return _CACHED[key]
