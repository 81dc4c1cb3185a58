"""Mean squared distance to the 3 nearest neighbours, for the scale
initialisation of a scene made from a point cloud.

Port of `lightgaussian_tpu/ops/knn.py`: the points are sorted along three
Morton curves (the axes' bit lanes permuted), each point takes its +-`WINDOW`
neighbours along every curve as candidates, and the three nearest distinct
candidates are averaged. Approximate in the way the reference's box search
is: candidates are limited to neighbours in Morton order. The work is torch
ops on the points' device.

The 30-bit codes are held in int64 (torch has no full uint32 arithmetic),
and the sort is stable, as `jnp.argsort` is: points that share a Morton
cell keep their order, so both packages give every point the same window.
"""
from __future__ import annotations

import torch

_PERMS = ((0, 1, 2), (1, 2, 0), (2, 0, 1))
WINDOW = 24  # neighbours taken on each side along every curve


def _expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so that two zero bits lie between each."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(points: torch.Tensor, perm=(0, 1, 2)) -> torch.Tensor:
    """[N, 3] float points -> [N] int64 30-bit Morton codes (10 bits an
    axis). `perm` says which axis gets which bit lane."""
    mins = points.amin(dim=0)
    maxs = points.amax(dim=0)
    scaled = (points - mins) / torch.clamp(maxs - mins, min=1e-12)
    q = torch.clamp((scaled * 1023.0).to(torch.int64), 0, 1023)
    return (
        _expand_bits_10(q[:, perm[0]])
        | (_expand_bits_10(q[:, perm[1]]) << 1)
        | (_expand_bits_10(q[:, perm[2]]) << 2)
    )


def _window_candidates(points: torch.Tensor, perm, window: int) -> torch.Tensor:
    """Candidate neighbour indices [N, 2 * window] from one Morton ordering."""
    n, dev = points.shape[0], points.device
    order = torch.argsort(morton_codes(points, perm), stable=True)
    offs = torch.cat([torch.arange(-window, 0, device=dev), torch.arange(1, window + 1, device=dev)])
    pos = torch.clamp(torch.arange(n, device=dev)[:, None] + offs[None, :], 0, n - 1)
    out = torch.empty((n, offs.numel()), dtype=torch.int64, device=dev)
    out[order] = order[pos]  # row i: the candidates of point order[i]
    return out


@torch.no_grad()
def mean_sq_dist_to_3nn(points: torch.Tensor) -> torch.Tensor:
    """Approximate mean squared distance from each point to its 3 nearest
    neighbours; [N] float32. A point with fewer than 3 distinct candidates
    counts the missing ones as 0."""
    n, dev = points.shape[0], points.device
    idx = torch.cat([_window_candidates(points, p, WINDOW) for p in _PERMS], dim=1)
    idx = torch.sort(idx, dim=1).values  # repeats lie side by side
    dup = torch.cat([torch.zeros((n, 1), dtype=torch.bool, device=dev), idx[:, 1:] == idx[:, :-1]], dim=1)
    d2 = ((points[idx] - points[:, None, :]) ** 2).sum(-1)
    d2 = torch.where(dup | (idx == torch.arange(n, device=dev)[:, None]), torch.inf, d2)
    smallest3 = torch.topk(d2, 3, dim=1, largest=False).values
    return torch.where(torch.isinf(smallest3), 0.0, smallest3).mean(dim=-1)


@torch.no_grad()
def mean_sq_dist_to_3nn_exact(points: torch.Tensor) -> torch.Tensor:
    """The exact O(N^2) version, for tests and small point sets."""
    d2 = ((points[:, None, :] - points[None, :, :]) ** 2).sum(-1)
    d2.fill_diagonal_(torch.inf)
    return torch.topk(d2, 3, dim=1, largest=False).values.mean(dim=-1)
