"""The random streams of `jax.random`, reproduced on torch tensors.

The JAX package draws the VQ codebook's start, each codebook batch and the
seeded LPIPS network with `jax.random` (threefry2x32 keys). The port draws
the same numbers from the same seed, so that both packages fit the same
codebook and score with the same network. This module follows the
"partitionable" threefry scheme that current JAX uses by default
(`jax_threefry_partitionable`): a key is a pair of uint32 words; `split`
and the bit draws hash a 64-bit counter (high word, low word) per output.

A key is a tuple of two Python ints. The hash is written with `+`, `^`,
`<<`, `>>` and `&` only, so one function runs on Python ints (keys) and on
int64 tensors holding uint32 values (draws, on any device). torch has no
full uint32 arithmetic; int64 masked to 32 bits after each add and shift
gives the same bits.

Draws covered: `PRNGKey`, `split`, 32-bit `random_bits`, `randint` (int32),
`uniform` and `normal` (float32). `normal` is sqrt(2) * erfinv of a uniform
draw on (-1, 1), as in JAX, with XLA's float32 erfinv, log1p, log and
sqrt rebuilt from their polynomials, Newton steps and fused multiply-adds. The uniform draw
under it is bit-equal; a normal value may still differ from the JAX
package's by an ulp where a rounding inside those functions falls the
other way.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (20 rounds) of the counter words (x1, x2)
    under the key words (k1, k2): Python ints or int64 tensors of uint32
    values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def prng_key(seed: int) -> tuple[int, int]:
    """`jax.random.PRNGKey(seed)` for an int32 seed (JAX's default without
    64-bit mode): the high word 0, the low word the seed's 32 bits."""
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} is not an int32")
    return 0, seed & MASK


def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """`jax.random.split(key, num)`: the hash of counters (0, i)."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def random_bits(keys: list[tuple[int, int]], n: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """32-bit draws, `jax.random.bits` of each key: row r holds the first
    `n` words of the stream of `keys[r]` (int64, values < 2**32)."""
    k = torch.tensor(keys, dtype=torch.int64, device=device)
    lo = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    b1, b2 = threefry2x32(k[:, :1], k[:, 1:], 0, lo)
    return b1 ^ b2


def _randint_from_bits(higher: torch.Tensor, lower: torch.Tensor, minval: int, maxval: int) -> torch.Tensor:
    # JAX's two-draw reduction in uint32 arithmetic (wrapping), `_randint`
    span = max(maxval - minval, 1)
    multiplier = ((2**16 % span) ** 2 & MASK) % span
    offset = ((higher % span) * multiplier + lower % span) & MASK
    return minval + offset % span


def _check_int32_range(minval: int, maxval: int) -> None:
    if not (-(2**31) <= minval < 2**31 and -(2**31) <= maxval < 2**31):
        raise ValueError(f"randint bounds [{minval}, {maxval}) are not int32")


def randint_rows(keys: list[tuple[int, int]], n: int, minval: int, maxval: int,
                 device: str | torch.device = "cpu") -> torch.Tensor:
    """`jax.random.randint(key, (n,), minval, maxval)` (int32 draws, as
    int64) for each key in one pass: [len(keys), n]."""
    _check_int32_range(minval, maxval)
    halves = [k for key in keys for k in split(key)]  # randint's own split: high and low draws
    bits = random_bits(halves, n, device)
    return _randint_from_bits(bits[0::2], bits[1::2], minval, maxval)


def randint(key: tuple[int, int], shape, minval: int, maxval: int,
            device: str | torch.device = "cpu") -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)`."""
    shape = tuple(shape)
    return randint_rows([key], math.prod(shape), minval, maxval, device)[0].reshape(shape)


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from 32-bit words: the 23 high bits as a mantissa."""
    one = int(np.float32(1.0).view(np.uint32))
    return ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0


def uniform(key: tuple[int, int], shape, minval: float = 0.0, maxval: float = 1.0,
            device: str | torch.device = "cpu") -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`."""
    shape = tuple(shape)
    lo, hi = np.float32(minval), np.float32(maxval)
    floats = _unit_floats(random_bits([key], math.prod(shape), device)[0])
    # XLA fuses the multiply and the add (one rounding); float64 holds the
    # product of two float32 exactly, so the sum there rounds once too.
    out = (floats.double() * float(np.float32(hi - lo)) + float(lo)).float()
    return torch.clamp(out, min=float(lo)).reshape(shape)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32, as XLA's fused multiply-add:
    float64 holds the product of two float32 exactly."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = _fma(p, x, c)
    return p


# XLA's float32 log (Cephes' polynomial) and log1p (Cephes' rational for
# |x| < sqrt(2) - 1, else log(1 + x)); constants rounded to float32
def _f32(cs) -> tuple:
    return tuple(float(np.float32(c)) for c in cs)


_LOG_P = _f32((7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
               -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOG_Q1, _LOG_Q2, _SQRTHF = _f32((-2.12194440e-4, 0.693359375, 0.707106781186547524))
_LOG1P_NUM = _f32((4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969,
                   2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
                   2.0039553499201281259648e1))
_LOG1P_DEN = _f32((1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
                   3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1))


def _log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log of positive normal x."""
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & ~0x7F800000) | int(np.float32(0.5).view(np.int32))).view(torch.float32)  # in [0.5, 1)
    low = m < _SQRTHF
    e = e - low.float()
    m = (m - 1.0) + torch.where(low, m, 0.0)
    x2 = m * m
    x3 = x2 * m
    y = _fma(_fma(m, _LOG_P[0], _LOG_P[1]), m, _LOG_P[2])
    y1 = _fma(_fma(m, _LOG_P[3], _LOG_P[4]), m, _LOG_P[5])
    y2 = _fma(_fma(m, _LOG_P[6], _LOG_P[7]), m, _LOG_P[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _LOG_Q1 * e)
    return (m - 0.5 * x2) + y + _LOG_Q2 * e


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 sqrt: x * rsqrt(x) and one Newton step, fused."""
    r = torch.rsqrt(x)
    s = x * r
    return _fma(0.5 * r, _fma(-s, s, x), s)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    small = (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + _fma(x2, -0.5, small)
    return torch.where(x.abs() < 0.41421356237309504880, small, _log(x + 1.0))


# Giles, "Approximating the erfinv function": the coefficients XLA uses for
# float32, for w = -log1p(-x^2) below 5 and from 5 up
_ERFINV_LT5 = _f32((2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_ERFINV_GE5 = _f32((-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erfinv of x in (-1, 1), every multiply-add fused as
    XLA compiles it."""
    w = -_log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, _sqrt(w) - 3.0)
    lt5 = torch.tensor(_ERFINV_LT5, dtype=torch.float32, device=x.device)
    ge5 = torch.tensor(_ERFINV_GE5, dtype=torch.float32, device=x.device)
    coeff = torch.where(lt[..., None], lt5, ge5)
    p = coeff[..., 0]
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, coeff[..., i])
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: tuple[int, int], shape, device: str | torch.device = "cpu") -> torch.Tensor:
    """`jax.random.normal(key, shape, float32)`: sqrt(2) erfinv(u) with u
    uniform on the open interval (-1, 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device)
    return _erfinv(u) * float(np.float32(np.sqrt(2.0)))
