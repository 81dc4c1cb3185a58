"""Collectives over a mesh axis: the counterparts of the `jax.lax`
collectives that the JAX package calls inside `shard_map`.

Each mesh axis is a process group (`mesh.get_group(axis)`); a rank's index
on the axis is its rank in that group, the order in which an all_gather
concatenates. Two all_gathers carry gradients, and they need different
backwards:

- `gather_strips`, the image gathered over the strip axis: every rank of
  the axis computes the same loss on the same full image, so each holds
  the same cotangent of it; the backward hands each strip the rows it
  rendered, once. (`torch.distributed.nn.functional.all_gather` sums the
  cotangents of all ranks, which would count every strip once per rank.)
  The parameter gradients are summed over the axis after the backward.
- `gather_shards`, per-Gaussian rows gathered over the Gaussian-shard
  axis: each rank's cotangent of the gathered rows differs (its own strip's
  gradient of every Gaussian), so the backward is a reduce-scatter that
  sums them and hands each rank its own shard's rows.

The rest (`psum`, `pmean`, `pmax`, `all_gather`) run without a graph.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def axis_index(mesh, axis: str) -> int:
    """This rank's index on `axis` (`jax.lax.axis_index`)."""
    return dist.get_rank(mesh.get_group(axis))


def axis_size(mesh, axis: str) -> int:
    return dist.get_world_size(mesh.get_group(axis))


def _gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


class _GatherStrips(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim: int):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.index = dist.get_rank(group)
        return torch.cat(_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return torch.cat(_gather(x, group), dim=0)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        out = torch.empty((g.shape[0] // n,) + tuple(g.shape[1:]), dtype=g.dtype, device=g.device)
        dist.reduce_scatter_tensor(out, g.contiguous(), group=ctx.group)
        return out, None


def gather_strips(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Concatenate the axis's equal-shaped strips along `dim`; the
    backward returns this rank's slice of the (identical) cotangent."""
    return _GatherStrips.apply(x, mesh.get_group(axis), dim)


def gather_shards(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Concatenate the axis's equal-length shards along dim 0; the backward
    is a reduce-scatter (sum) of the cotangents."""
    return _GatherShards.apply(x, mesh.get_group(axis))


@torch.no_grad()
def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0, stack: bool = False) -> torch.Tensor:
    """The axis's tensors concatenated (or, with `stack`, stacked) along
    `dim` in axis order, without a graph."""
    parts = _gather(x, mesh.get_group(axis))
    return torch.stack(parts, dim=dim) if stack else torch.cat(parts, dim=dim)


@torch.no_grad()
def _reduced(x: torch.Tensor, mesh, axis: str, op) -> torch.Tensor:
    y = x.detach().clone()
    dist.all_reduce(y, op=op, group=mesh.get_group(axis))
    return y


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _reduced(x, mesh, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _reduced(x, mesh, axis, dist.ReduceOp.MAX)


def pmean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return psum(x, mesh, axis) / axis_size(mesh, axis)
