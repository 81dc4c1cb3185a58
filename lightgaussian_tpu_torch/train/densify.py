"""Densification (clone and split), pruning and opacity reset, as masked
passes over the fixed-capacity tensors.

Port of `lightgaussian_tpu/train/densify.py`. Gaussians whose accumulated
screen-space positional gradient exceeds `max_grad` are cloned (if small:
largest scale <= percent_dense * extent) or split into two samples drawn
from the Gaussian with scales shrunk by 1 / (0.8 * 2) (if large); then low
opacity and, when asked, world-space size prune. New Gaussians go to free
(dead) slots and their Adam moments are zeroed; pruning is `alive &= keep`.

The slots are the JAX package's: clones take the free slots in ascending
order, split children the next ones, and what does not fit is dropped, so a
state carried from one package to the other densifies into the same layout.
The split noise cannot be the same (another generator), so everything after
the draw lives in `densify_with_noise`, which takes the two draws.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from lightgaussian_tpu_torch.ops.covariance import quat_to_rotmat
from lightgaussian_tpu_torch.train.optim import zero_moments_at, zero_moments_field
from lightgaussian_tpu_torch.train.state import TrainState
from lightgaussian_tpu_torch.utils.general import inverse_sigmoid


class DensifyReport(NamedTuple):
    n_cloned: int
    n_split: int
    n_pruned: int
    n_dropped: int  # selections lost to capacity overflow
    n_alive: int


def _scatter_rows(params: dict, src_params: dict, src_mask: torch.Tensor, targets: torch.Tensor) -> dict:
    """Rows `src_mask` of `src_params` written to slots `targets` of
    `params`; a target equal to the capacity drops its row."""
    cap = targets.shape[0]
    placed = src_mask & (targets < cap)
    out = {}
    for k, p in params.items():
        new = p.clone()
        new[targets[placed]] = src_params[k][placed]
        out[k] = new
    return out


@torch.no_grad()
def densify_and_prune(
    state: TrainState,
    max_grad: float,
    min_opacity: float,
    extent: float,
    max_screen_size: int,
    percent_dense: float,
    generator: torch.Generator,
) -> tuple[TrainState, DensifyReport]:
    """One densification pass; `generator` (on the scene's device) draws the
    split children's positions."""
    cap, dev = state.capacity, state.scene.means.device
    eps = torch.randn((2, cap, 3), generator=generator, dtype=torch.float32, device=dev)
    return densify_with_noise(state, max_grad, min_opacity, extent, max_screen_size, percent_dense,
                              eps[0], eps[1])


@torch.no_grad()
def densify_with_noise(
    state: TrainState,
    max_grad: float,
    min_opacity: float,
    extent: float,
    max_screen_size: int,
    percent_dense: float,
    eps_a: torch.Tensor,
    eps_b: torch.Tensor,
) -> tuple[TrainState, DensifyReport]:
    """`densify_and_prune` given its standard-normal draws [cap, 3]: `eps_a`
    places the child that overwrites a split parent, `eps_b` the child that
    takes a free slot."""
    scene = state.scene
    cap = scene.capacity
    dev = scene.means.device
    alive = scene.alive
    params = scene.params()

    grads = torch.where(state.denom > 0, state.xyz_grad_accum / torch.clamp(state.denom, min=1.0), 0.0)
    scales = scene.scales
    max_scale = scales.amax(dim=1)
    hot = alive & (grads >= max_grad)
    small = max_scale <= percent_dense * extent
    clone_sel = hot & small
    split_sel = hot & ~small

    # ascending free slots, padded with `cap`
    slots = torch.arange(cap, device=dev)
    free = torch.sort(torch.where(alive, cap, slots)).values
    n_free = cap - alive.sum()

    def targets(sel, first_rank):
        rank = torch.cumsum(sel, dim=0) - 1 + first_rank
        tgt = torch.where(sel, free[torch.clamp(rank, max=cap - 1)], cap)
        return torch.where(rank < n_free, tgt, cap)

    # clones: copied as they are into free slots
    clone_tgt = targets(clone_sel, 0)
    new_params = _scatter_rows(params, params, clone_sel, clone_tgt)

    # splits: two samples from N(mean, Sigma), scales / (0.8 * 2). Child A
    # overwrites the parent, child B takes a free slot after the clones'.
    rot = quat_to_rotmat(scene.quats)  # [cap, 3, 3]

    def sample(eps):
        return scene.means + torch.einsum("nij,nj->ni", rot, eps * scales)

    child_scale = torch.log(torch.clamp(scales / (0.8 * 2.0), min=1e-30))
    split_tgt = targets(split_sel, clone_sel.sum())
    child_b = dict(params)
    child_b["means"] = sample(eps_b)
    child_b["log_scales"] = child_scale
    new_params = _scatter_rows(new_params, child_b, split_sel, split_tgt)
    smask = split_sel[:, None]
    new_params["means"] = torch.where(smask, sample(eps_a), new_params["means"])
    new_params["log_scales"] = torch.where(smask, child_scale, new_params["log_scales"])

    filled = torch.zeros(cap, dtype=torch.bool, device=dev)
    filled[clone_tgt[clone_tgt < cap]] = True
    filled[split_tgt[split_tgt < cap]] = True
    new_alive = alive | filled

    # Prune: low opacity and, when max_screen_size is set, oversized in world
    # space. The screen-space radius is not used: the reference zeroes it for
    # every point right before its prune reads it.
    prune = torch.sigmoid(new_params["opacity_logits"]) < min_opacity
    if max_screen_size > 0:
        prune = prune | (torch.exp(new_params["log_scales"]).amax(dim=1) > 0.1 * extent)
    pruned = new_alive & prune
    new_alive = new_alive & ~prune

    # Adam's moments: zero on every touched slot (new children and split parents).
    new_opt = zero_moments_at(state.opt, filled | split_sel)

    new_state = dataclasses.replace(
        state,
        scene=dataclasses.replace(scene, alive=new_alive, **new_params),
        opt=new_opt,
        # all three statistics start over, on every slot
        max_radii2d=torch.zeros_like(state.max_radii2d),
        xyz_grad_accum=torch.zeros_like(state.xyz_grad_accum),
        denom=torch.zeros_like(state.denom),
    )
    counts = torch.stack([
        (clone_tgt < cap).sum(), split_sel.sum(), pruned.sum(),
        clone_sel.sum() + split_sel.sum() - (clone_tgt < cap).sum() - (split_tgt < cap).sum(),
        new_alive.sum(),
    ]).tolist()  # one transfer
    return new_state, DensifyReport(*counts)


def prune_only(state: TrainState, min_opacity: float, extent: float, max_screen_size: int) -> TrainState:
    """Prune pass on its own (outside the densify window); the screen-space
    size is not used, see `densify_with_noise`."""
    scene = state.scene
    prune = scene.opacities < min_opacity
    if max_screen_size > 0:
        prune = prune | (scene.scales.amax(dim=1) > 0.1 * extent)
    return dataclasses.replace(state, scene=dataclasses.replace(scene, alive=scene.alive & ~prune))


def reset_opacity(state: TrainState) -> TrainState:
    """Clamp opacity to at most 0.01 and reset its Adam moments."""
    scene = state.scene
    new_logits = inverse_sigmoid(torch.clamp(scene.opacities, max=0.01))
    scene = dataclasses.replace(scene, opacity_logits=new_logits)
    return dataclasses.replace(state, scene=scene, opt=zero_moments_field(state.opt, "opacity_logits"))


def prune_by_mask(state: TrainState, keep: torch.Tensor) -> TrainState:
    """GSS-style pruning: alive &= keep."""
    scene = state.scene
    return dataclasses.replace(state, scene=dataclasses.replace(scene, alive=scene.alive & keep))
