"""Where the step's backward time goes, piece by piece, on real cotangents.

Port of `scripts/profile_bwd.py`, at its operating point: 300,000 Gaussians
(SH 3) at 1920x1080 from the bench's camera, instance cut 1,114,112, the
bench's zero target with its SSIM moments cached. Rows, each between CUDA
events:

  - the loss's image gradient (the loss backward; B4 on the card);
  - B2's seed: `r` and the two per-tile layouts, as `_ExactBlend.backward`
    computes them (`tiled._backward_seed`, the code it calls);
  - `blend.blend_backward` (B2 with its atomic per-Gaussian reduce);
  - the preprocess backward as one autograd call: `torch.autograd.grad` of
    preprocess's differentiable outputs (mean2d, conic, colour, opacity)
    with B2's gradients as their cotangents;
  - the same split where autograd can be cut: the SH colour
    (`projection.view_colors`), the 3D covariance (`build_covariance_3d`)
    and the projection (`preprocess` given the colours and covariances as
    leaves). Summed per parameter, the split's gradients are the single
    call's.

The JAX rows for the unchunk, the segmented reduce and the Pallas
`unchunk_transpose` sweep have no counterpart: the port's backward neither
unchunks nor segment-reduces (B8 keeps its own timing in `chip_smoke.py`).

Usage: python -m lightgaussian_tpu_torch.scripts.profile_bwd [--device cuda] [--out_root DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch

from lightgaussian_tpu_torch.ops import covariance as cov_ops
from lightgaussian_tpu_torch.ops import losses
from lightgaussian_tpu_torch.ops.rasterize import blend, tiled
from lightgaussian_tpu_torch.ops.rasterize.binning import bin_splats, make_grid
from lightgaussian_tpu_torch.ops.rasterize.projection import preprocess, view_colors
from lightgaussian_tpu_torch.scripts import harness
from lightgaussian_tpu_torch.train.step import param_leaves
from lightgaussian_tpu_torch.utils.device import resolve_device
from lightgaussian_tpu_torch.utils.synthetic import default_camera, random_scene

WIDTH, HEIGHT = 1920, 1080
N_GAUSS = 300_000
CAP = 1_114_112
REPS = 10
SPLIT = ("projection", "SH colour", "covariance")  # the split's pieces, in the order their backwards run


@dataclasses.dataclass
class Backward:
    """The step's backward at one point: its inputs and what each piece
    hands the next."""

    scene: object  # the scene over `params`
    camera: object
    params: dict  # name -> leaf that requires a gradient
    splats: object  # preprocess's outputs, with their autograd graph
    binning: object
    grid: object
    image: torch.Tensor
    final_t: torch.Tensor
    target: torch.Tensor
    stats: tuple
    g_image: torch.Tensor  # the loss's gradient of the image
    seed: tuple  # (tile_g, tile_r): B2's inputs
    grads: torch.Tensor  # B2's [N, 9] per-Gaussian gradients


def backward_inputs(dev: torch.device, width: int, height: int, n: int, cap: int) -> Backward:
    """The step's forward at the bench's scene and camera, and its backward
    up to B2's gradients, each piece on the one before it."""
    scene = random_scene(n=n, seed=0, extent=2.0, scale_range=(0.004, 0.02), active_sh_degree=3, device=dev)
    cam = default_camera(width=width, height=height, dist=5.0, device=dev)
    grid = make_grid(width, height)
    params = param_leaves(scene)
    scene = scene.with_params(params)
    splats = preprocess(scene, cam)
    with torch.no_grad():
        b = bin_splats(tiled._detached(splats), grid, cap)
        rgb, t = blend.blend_forward(b.tile_starts, b.inst, grid)
        image, final_t = tiled._compose(rgb, t, torch.zeros(3, device=dev), grid, width, height)
    target = torch.zeros((3, height, width), device=dev)
    stats = losses.precompute_ssim_target_stats(target)
    g_image = image_gradient(image, target, stats)
    seed = tiled._backward_seed(image, final_t, g_image, torch.zeros_like(final_t), grid)
    grads = blend.blend_backward(b.tile_starts, b.inst, b.gid_sorted, *seed, grid, scene.capacity)
    return Backward(scene, cam, params, splats, b, grid, image, final_t, target, stats, g_image, seed, grads)


def image_gradient(image, target, stats) -> torch.Tensor:
    """The loss's gradient of the image, as the step's loss runs."""
    x = image.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(losses.gs_loss(x, target, target_stats=stats), x)
    return g


def _zeros_for_unused(got, inputs) -> list:
    return [torch.zeros_like(x) if g is None else g for g, x in zip(got, inputs)]


def preprocess_grads(bw: Backward) -> dict:
    """The preprocess backward as one autograd call."""
    s = bw.splats
    names = list(bw.params)
    inputs = [bw.params[k] for k in names]
    got = torch.autograd.grad((s.mean2d, s.conic, s.color, s.opacity), inputs, tiled._splat_grads(bw.grads),
                              retain_graph=True, allow_unused=True)
    return dict(zip(names, _zeros_for_unused(got, inputs)))


def split_backward(bw: Backward):
    """The preprocess forward cut at its SH colours and 3D covariances (the
    projection takes both as leaves), and a backward call per piece.
    Returns ({piece: call}, the pieces' gradients summed per parameter).
    The projection runs first: its gradients of the two leaves are the
    other pieces' cotangents."""
    scene, p = bw.scene, bw.params
    color = view_colors(scene, bw.camera)
    cov6 = cov_ops.strip_symmetric(cov_ops.build_covariance_3d(scene.scales, scene.quats))
    color_leaf = color.detach().requires_grad_(True)
    cov_leaf = cov6.detach().requires_grad_(True)
    proj = preprocess(scene, bw.camera, colors_precomp=color_leaf, cov3d_precomp=cov_leaf)
    proj_in = (p["means"], p["opacity_logits"], color_leaf, cov_leaf)
    colour_in = (p["means"], p["sh_dc"], p["sh_rest"])
    cov_in = (p["log_scales"], p["quats"])

    def projection():
        got = torch.autograd.grad((proj.mean2d, proj.conic, proj.color, proj.opacity), proj_in,
                                  tiled._splat_grads(bw.grads), retain_graph=True, allow_unused=True)
        return _zeros_for_unused(got, proj_in)

    g_means, g_opacity, g_color, g_cov = projection()

    def colour():
        return _zeros_for_unused(torch.autograd.grad(color, colour_in, g_color, retain_graph=True,
                                                     allow_unused=True), colour_in)

    def covariance():
        return torch.autograd.grad(cov6, cov_in, g_cov, retain_graph=True)

    g_means_colour, g_dc, g_rest = colour()
    g_scales, g_quats = covariance()
    grads = {"means": g_means + g_means_colour, "sh_dc": g_dc, "sh_rest": g_rest, "log_scales": g_scales,
             "quats": g_quats, "opacity_logits": g_opacity}
    return {"projection": projection, "SH colour": colour, "covariance": covariance}, grads


def run(args) -> dict:
    dev = resolve_device(args.device)
    card = harness.card_line(dev)
    bw = backward_inputs(dev, WIDTH, HEIGHT, N_GAUSS, CAP)
    print(f"profile_bwd on {card}: {N_GAUSS} Gaussians SH 3 at {WIDTH}x{HEIGHT}, {bw.binning.total} live instances, "
          f"cut {CAP}; {REPS} calls a row")
    zeros_t = torch.zeros_like(bw.final_t)
    b, grid = bw.binning, bw.grid
    split, _ = split_backward(bw)
    rows = {}
    for name, fn in (
        ("loss image gradient (loss backward)", lambda: image_gradient(bw.image, bw.target, bw.stats)),
        ("B2 seed (r + per-tile layouts)", lambda: tiled._backward_seed(bw.image, bw.final_t, bw.g_image, zeros_t,
                                                                        grid)),
        ("blend_backward (B2 + atomic reduce)", lambda: blend.blend_backward(
            b.tile_starts, b.inst, b.gid_sorted, *bw.seed, grid, bw.scene.capacity)),
        ("preprocess backward (one autograd call)", lambda: preprocess_grads(bw)),
        *((f"  {k} backward", split[k]) for k in SPLIT),
    ):
        rows[name] = harness.ms_per_call(fn, dev, reps=REPS)
        print(f"  {name:46s} {rows[name]:9.3f} ms", flush=True)
    result = {"card": card, "live": b.total, "cap": CAP, "rows": rows}
    out = Path(args.out_root or harness.default_out_root()) / "profile_bwd.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return {**result, "inputs": bw}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="the step's backward piece by piece, on real cotangents")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out_root", type=Path, default=None, help="where profile_bwd.json goes (default: the "
                   "temporary directory)")
    return p


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
