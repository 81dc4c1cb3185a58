"""Image losses: L1, L2, windowed SSIM, PSNR, and the 3D-GS combined loss.

Port of `lightgaussian_tpu/ops/losses.py`. SSIM uses an 11x11 Gaussian
window (sigma 1.5), C1 = 0.01^2, C2 = 0.03^2, zero "same" padding, per-
channel separable blur, mean over all pixels and channels.

The blur runs as a CUDA kernel (`csrc/ssim_blur.cu`) in three forms:
B4 `blur` over C planes, B3 `blur3` forming the x-side SSIM moments B(x),
B(x^2), B(x y) from (x, y) in one pass, and B7 `blur5` forming all five
moments, launched and counted by the rows of `utils/cuda_build.py`'s kernel
table. A wrapper given CPU tensors runs the plain version (`plain_blur`,
the JAX package's `_blur_jnp` in torch, with the same order of operations);
given CUDA tensors it launches its kernel or raises. The window with zero
"same" padding makes the blur self-adjoint, so every backward of the loss
is the blur itself (B4), through three `autograd.Function`s: the blur, the
five-moment pass (with a real `dy`) and the x-side pass of the cached-
target path (whose `dy` is zero by design: the target is a constant there).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from lightgaussian_tpu_torch.utils import cuda_build

_PLANES = {"blur3": 3, "blur5": 5}
WINDOW = 11  # taps of the SSIM window, the width the kernels are compiled for
SIGMA = 1.5


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred - target).mean()


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Peak SNR over the whole image batch, peak 1.0."""
    m = mse(pred, target)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(m, min=1e-20)))


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Masked sum of squares over the mask's mass (`img2mse`)."""
    if mask is None:
        return mse(pred, target)
    d = pred * mask - target * mask
    return (d * d).sum() / (mask.sum() + 1e-5)


def masked_mae(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Masked sum of absolute errors over the mask's mass (`img2mae`)."""
    if mask is None:
        return l1_loss(pred, target)
    return torch.abs(pred * mask - target * mask).sum() / (mask.sum() + 1e-5)


def _gaussian_taps() -> tuple:
    """The window's taps, computed in float64 and rounded to float32."""
    xs = np.arange(WINDOW, dtype=np.float64) - WINDOW // 2
    g = np.exp(-(xs**2) / (2.0 * SIGMA**2))
    return tuple((g / g.sum()).astype(np.float32).tolist())


TAPS = _gaussian_taps()
_C_TAPS = (ctypes.c_float * WINDOW)(*TAPS)


def plain_blur(x: torch.Tensor) -> torch.Tensor:
    """[C, H, W] -> the same-shape separable blur, zero "same" padding:
    shift and add, each pass summing its taps in order, rows first."""
    r = WINDOW // 2
    _, h, w = x.shape
    xp = torch.nn.functional.pad(x, (r, r))
    x = sum(t * xp[:, :, i:i + w] for i, t in enumerate(TAPS))
    xp = torch.nn.functional.pad(x, (0, 0, r, r))
    return sum(t * xp[:, i:i + h, :] for i, t in enumerate(TAPS))


def _interleave(planes: list[torch.Tensor]) -> torch.Tensor:
    """P planes [C, H, W] -> [C * P, H, W], plane k of channel c at c*P + k."""
    return torch.stack(planes, dim=1).reshape(-1, *planes[0].shape[1:])


def plain_blur3(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """B(x), B(x^2), B(x y), channel-major [3C, H, W]."""
    planes = plain_blur(torch.cat([x, x * x, x * y])).chunk(3)
    return _interleave(list(planes))


def plain_blur5(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """B(x), B(y), B(x^2), B(y^2), B(x y), channel-major [5C, H, W]."""
    planes = plain_blur(torch.cat([x, y, x * x, y * y, x * y])).chunk(5)
    return _interleave(list(planes))


def _check(name: str, *xs: torch.Tensor) -> None:
    for x in xs:
        if x.dtype != torch.float32 or x.dim() != 3:
            raise ValueError(f"{name} takes float32 [C, H, W], got {x.dtype} {tuple(x.shape)}")
        if x.shape != xs[0].shape or x.device != xs[0].device:
            raise ValueError(f"{name}: inputs differ in shape or device")


def _dispatch(name: str, plain, *xs: torch.Tensor) -> torch.Tensor:
    _check(name, *xs)
    if not cuda_build.on_card(xs[0], name):
        return plain(*xs)
    xs = tuple(x.contiguous() for x in xs)
    c, h, w = xs[0].shape
    out = torch.empty((c * _PLANES.get(name, 1), h, w), dtype=torch.float32, device=xs[0].device)
    if out.numel() == 0:
        return out
    cuda_build.KERNELS[f"lg_ssim_{name}"](out, *(x.data_ptr() for x in xs), out.data_ptr(), c, h, w, _C_TAPS, WINDOW)
    return out


def blur(x: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur of C planes (B4), [C, H, W] -> [C, H, W]."""
    return _dispatch("blur", plain_blur, x)


def blur3(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x-side SSIM moments (B3): B(x), B(x^2), B(x y), [3C, H, W]."""
    return _dispatch("blur3", plain_blur3, x, y)


def blur5(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """All five SSIM moments (B7): B(x), B(y), B(x^2), B(y^2), B(x y), [5C, H, W]."""
    return _dispatch("blur5", plain_blur5, x, y)


class _Blur(torch.autograd.Function):
    """The blur with its own VJP: the blur is self-adjoint."""

    @staticmethod
    def forward(ctx, x):
        return blur(x)

    @staticmethod
    def backward(ctx, g):
        return blur(g.contiguous())


class _Moments5(torch.autograd.Function):
    """(x, y) -> the five moment planes. Backward: for cotangents g_k of the
    planes, dx = B(g0) + 2x B(g2) + y B(g4), dy = B(g1) + 2y B(g3) + x B(g4)
    (one 5C-plane blur, `losses.py:303-310` of the JAX package). `dy` is
    formed only where y needs a gradient (not for distillation's detached
    teacher image)."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return blur5(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        gb = blur(g.contiguous()).reshape(x.shape[0], 5, *x.shape[1:])
        dx = gb[:, 0] + 2.0 * x * gb[:, 2] + y * gb[:, 4]
        dy = gb[:, 1] + 2.0 * y * gb[:, 3] + x * gb[:, 4] if ctx.needs_input_grad[1] else None
        return dx, dy


class _Moments3(torch.autograd.Function):
    """(x, y) -> B(x), B(x^2), B(x y). Backward blurs the three cotangent
    planes: dx = B(g0) + 2x B(g1) + y B(g2). dy is ZERO by design, not the
    partial x B(g2): the y paths through the precomputed B(y), B(y^2) are
    absent here (the target is a constant in training), and a partial
    cotangent would be a silently wrong gradient for a caller that
    differentiated with respect to y (`losses.py:252-282` of the JAX
    package)."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return blur3(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        gb = blur(g.contiguous()).reshape(x.shape[0], 3, *x.shape[1:])
        dx = gb[:, 0] + 2.0 * x * gb[:, 1] + y * gb[:, 2]
        return dx, torch.zeros_like(y)


def separable_blur(x: torch.Tensor) -> torch.Tensor:
    """The differentiable blur of [C, H, W] (its VJP is the blur)."""
    return _Blur.apply(x)


def precompute_ssim_target_stats(target: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B(y), B(y^2)) of a fixed [C, H, W] target: the two of the five
    moment planes that stay constant over training, computed once per camera
    (B4 over 2C planes)."""
    c = target.shape[0]
    blurred = separable_blur(torch.cat([target, target * target]))
    return blurred[:c], blurred[c:]


def ssim(
    img1: torch.Tensor,
    img2: torch.Tensor,
    target_stats: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Mean SSIM over a [C, H, W] image pair.

    `target_stats`: optional precomputed (B(img2), B(img2^2)) from
    `precompute_ssim_target_stats`; then only the three x-side planes are
    blurred (B3 forward, B4 backward) and gradients flow to img1 only."""
    c, h, w = img1.shape
    if target_stats is not None:
        b = _Moments3.apply(img1, img2.detach()).reshape(c, 3, h, w)
        mu1, s11, s12 = b[:, 0], b[:, 1], b[:, 2]
        mu2, s22 = target_stats
    else:
        b = _Moments5.apply(img1, img2).reshape(c, 5, h, w)
        mu1, mu2, s11, s22, s12 = b[:, 0], b[:, 1], b[:, 2], b[:, 3], b[:, 4]
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = s11 - mu1_sq
    sigma2_sq = s22 - mu2_sq
    sigma12 = s12 - mu1_mu2
    c1 = 0.01**2
    c2 = 0.03**2
    ssim_map = ((2.0 * mu1_mu2 + c1) * (2.0 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return ssim_map.mean()


def gs_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    lambda_dssim: float = 0.2,
    target_stats: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """The 3D-GS training loss: (1 - l) L1 + l (1 - SSIM)."""
    return (1.0 - lambda_dssim) * l1_loss(pred, target) + lambda_dssim * (
        1.0 - ssim(pred, target, target_stats=target_stats)
    )
