"""Per-Gaussian preprocess: frustum cull, EWA projection, conic, radius, SH color.

Port of `lightgaussian_tpu/ops/rasterize/projection.py`. On CUDA tensors the
preprocess is two hand-written kernels (`csrc/preprocess.cu`, rows of
`utils/cuda_build.py`'s kernel table, joined by `_PreprocessFn`):
the forward reads the raw parameters and the camera from device memory and
writes every output of the chain in one pass, equal to it bit for bit on the
card; the backward recomputes the forward in registers and writes the
gradients of the parameters autograd asks for. On CPU tensors
`plain_preprocess` runs the chain of torch ops, elementwise over N
Gaussians, and autograd differentiates it. The K=3 products of the chain
are broadcast sums, as in the JAX package, so `mean2d` rounds the same way
in both. `preprocess_backward_plain` is the backward's arithmetic in plain
torch, the kernel's derivation twin (the CPU tests and `chip_smoke.py` run
it).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.models.gaussians import GaussianScene
from lightgaussian_tpu_torch.ops import covariance as cov_ops
from lightgaussian_tpu_torch.ops import sh as sh_ops
from lightgaussian_tpu_torch.utils import cuda_build, stage_marks

NEAR_PLANE = 0.2  # the CUDA reference culls p_view.z <= 0.2
ALPHA_EPS = 1.0 / 255.0  # min alpha to blend
T_EPS = 1e-4  # transmittance early-stop threshold
MAX_ALPHA = 0.99

# sh_rest rows the kernels take: those of SH degree 4.
MAX_SH_REST = sh_ops.num_sh_coeffs(sh_ops.MAX_SH_DEGREE) - 1

# The per-Gaussian inputs in the kernels' order, and the outputs of the backward.
_INPUTS = ("means", "log_scales", "quats", "opacity_logits", "sh_dc", "sh_rest", "alive", "mean2d_offset",
           "colors_precomp", "cov3d_precomp")
_CAMERA = ("world_view", "full_proj", "camera_center", "tan_fovx", "tan_fovy")
_GRADS = ("means", "log_scales", "quats", "opacity_logits", "sh_dc", "sh_rest", "mean2d_offset", "colors_precomp",
          "cov3d_precomp")
@dataclasses.dataclass(frozen=True)
class Splats:
    """Screen-space Gaussians ready for blending."""

    mean2d: torch.Tensor  # [N, 2] pixel coords
    conic: torch.Tensor  # [N, 3] inverse 2D covariance (a, b, c)
    color: torch.Tensor  # [N, 3] RGB
    opacity: torch.Tensor  # [N]
    depth: torch.Tensor  # [N] camera-space z (inf = culled)
    radius: torch.Tensor  # [N] int32 pixel radius (0 = culled)


def view_colors(scene: GaussianScene, camera: Camera) -> torch.Tensor:
    """[N, 3] clamped RGB of each Gaussian's SH seen from the camera centre."""
    dirs = scene.means - camera.camera_center
    dirs = dirs / (torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True)) + 1e-12)
    return sh_ops.sh_to_rgb(scene.active_sh_degree, scene.sh_coeffs, dirs)


def _check_inputs(scene: GaussianScene, camera: Camera, mean2d_offset, colors_precomp, cov3d_precomp) -> None:
    """Raise on what the kernels do not take, before anything is built or
    launched."""
    dev = scene.means.device
    n = scene.means.shape[0] if scene.means.dim() == 2 else -1
    k = scene.sh_rest.shape[1] if scene.sh_rest.dim() == 3 else -1
    per_gaussian = [("means", scene.means, (n, 3)), ("log_scales", scene.log_scales, (n, 3)),
                    ("quats", scene.quats, (n, 4)), ("opacity_logits", scene.opacity_logits, (n,)),
                    ("sh_dc", scene.sh_dc, (n, 3)), ("sh_rest", scene.sh_rest, (n, k, 3)),
                    ("alive", scene.alive, (n,))]
    for name, t, shape in (("mean2d_offset", mean2d_offset, (n, 2)), ("colors_precomp", colors_precomp, (n, 3)),
                           ("cov3d_precomp", cov3d_precomp, (n, 6))):
        if t is not None:
            per_gaussian.append((name, t, shape))
    for name, t, shape in per_gaussian:
        dtype = torch.bool if name == "alive" else torch.float32
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {list(shape)}, got {t.dtype} {list(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, means on {dev}")
        if n > 0 and t.dim() > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride along its last dimension, got {t.stride()}")
    if n > 0 and k > 0 and scene.sh_rest.stride(1) != 3:
        raise ValueError(f"sh_rest's rows must be [K, 3] contiguous, got strides {scene.sh_rest.stride()}")
    degree = scene.active_sh_degree
    if not 0 <= degree <= sh_ops.MAX_SH_DEGREE:
        raise ValueError(f"SH degree {degree} outside [0, {sh_ops.MAX_SH_DEGREE}]")
    least = 0 if colors_precomp is not None else sh_ops.num_sh_coeffs(degree) - 1
    if not least <= k <= MAX_SH_REST:
        raise ValueError(f"sh_rest holds {k} rows; SH degree {degree} needs {least} to {MAX_SH_REST}")
    for name, shape in zip(_CAMERA, ((4, 4), (4, 4), (3,), (), ())):
        t = getattr(camera, name)
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"camera.{name} must be contiguous float32 {list(shape)}, got {t.dtype} "
                             f"{list(t.shape)} strides {t.stride()}")
        if t.device != dev:
            raise ValueError(f"camera.{name} on {t.device}, means on {dev}")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError(f"the preprocess kernels give camera.{name} no gradient")
    if camera.width <= 0 or camera.height <= 0:
        raise ValueError(f"image size must be positive, got {camera.width}x{camera.height}")


@stage_marks.in_span("projection")
def preprocess(
    scene: GaussianScene,
    camera: Camera,
    scale_modifier: float = 1.0,
    mean2d_offset: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
) -> Splats:
    """Project all Gaussians to screen space.

    `mean2d_offset` ([N, 2], NDC units) is added to the projected NDC centers
    (the training step differentiates through it for densification).
    `colors_precomp` / `cov3d_precomp` override the SH colors and the
    covariance built from scales and rotations.

    CUDA tensors go through the kernels (one forward launch; one backward
    launch when autograd differentiates the outputs), after `_check_inputs`
    refuses what the kernels do not take; CPU tensors go through
    `plain_preprocess` as they are. `depth` and `radius` take no gradient.

    In the spans (`utils.stage_marks`), "projection" holds the preprocess.
    On the plain chain "covariance" (the 3D and 2D covariance, conic and
    radius) and "sh" (the colour) lie inside it and hold their ops; the
    kernels compute both in their one launch, so on CUDA tensors there are
    no such spans and "projection" holds the launch.
    """
    if not cuda_build.on_card(scene.means, "preprocess"):
        return plain_preprocess(scene, camera, scale_modifier, mean2d_offset, colors_precomp, cov3d_precomp)
    _check_inputs(scene, camera, mean2d_offset, colors_precomp, cov3d_precomp)
    outs = _PreprocessFn.apply(
        scene.means, scene.log_scales, scene.quats, scene.opacity_logits, scene.sh_dc, scene.sh_rest, scene.alive,
        mean2d_offset, colors_precomp, cov3d_precomp, camera, scene.active_sh_degree, float(scale_modifier))
    return Splats(*outs)


def _row_stride(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.stride(0)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


class _PreprocessFn(torch.autograd.Function):
    """The kernels as one autograd node: the forward kernel, and the
    backward kernel for the inputs that need a gradient. Nothing per
    Gaussian is saved but the inputs."""

    @staticmethod
    def forward(ctx, means, log_scales, quats, opacity_logits, sh_dc, sh_rest, alive, mean2d_offset,
                colors_precomp, cov3d_precomp, camera, degree, scale_modifier):
        inputs = (means, log_scales, quats, opacity_logits, sh_dc, sh_rest, alive, mean2d_offset, colors_precomp,
                  cov3d_precomp)
        n, k = means.shape[0], sh_rest.shape[1]
        f32 = dict(dtype=torch.float32, device=means.device)
        outs = (torch.empty((n, 2), **f32), torch.empty((n, 3), **f32), torch.empty((n, 3), **f32),
                torch.empty((n,), **f32), torch.empty((n,), **f32),
                torch.empty((n,), dtype=torch.int32, device=means.device))
        if n > 0:
            cuda_build.KERNELS["lg_preprocess_forward"](
                means, *(_ptr(t) for t in inputs), *(getattr(camera, c).data_ptr() for c in _CAMERA),
                *(t.data_ptr() for t in outs), *(_row_stride(t) for t in inputs), n, k, degree, camera.width,
                camera.height, scale_modifier)
        ctx.mark_non_differentiable(outs[4], outs[5])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        ctx.camera, ctx.degree, ctx.scale_modifier = camera, degree, scale_modifier
        return outs

    @staticmethod
    def backward(ctx, g_mean2d, g_conic, g_color, g_opacity, _g_depth, _g_radius):
        inputs = ctx.saved_tensors
        means, sh_rest, colors_precomp, cov3d_precomp = inputs[0], inputs[5], inputs[8], inputs[9]
        n, k = means.shape[0], sh_rest.shape[1]
        unused = {"sh_dc", "sh_rest"} if colors_precomp is not None else set()
        if cov3d_precomp is not None:
            unused |= {"log_scales", "quats"}
        need = dict(zip(_INPUTS, ctx.needs_input_grad))
        grads = {name: torch.empty(((n, k, 3) if name == "sh_rest" else inputs[_INPUTS.index(name)].shape),
                                   dtype=torch.float32, device=means.device)
                 for name in _GRADS if need[name] and name not in unused}
        upstream = [None if g is None else g if g.dim() == 1 or g.stride(-1) == 1 else g.contiguous()
                    for g in (g_mean2d, g_conic, g_color, g_opacity)]
        if grads and n > 0 and any(g is not None for g in upstream):
            camera = ctx.camera
            cuda_build.KERNELS["lg_preprocess_backward"](
                means, *(_ptr(t) for t in inputs), *(getattr(camera, c).data_ptr() for c in _CAMERA),
                *(_ptr(g) for g in upstream), *(_ptr(grads.get(name)) for name in _GRADS),
                *(_row_stride(t) for t in inputs), *(_row_stride(g) for g in upstream), n, k, ctx.degree,
                camera.width, camera.height, ctx.scale_modifier)
        else:
            for g in grads.values():
                g.zero_()
        by_input = {name: grads.get(name) for name in _INPUTS}
        return (*(by_input[name] for name in _INPUTS), None, None, None)


def plain_preprocess(
    scene: GaussianScene,
    camera: Camera,
    scale_modifier: float = 1.0,
    mean2d_offset: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
) -> Splats:
    """The preprocess as the chain of torch ops (the CPU path, and on the
    card the kernels' yardstick); autograd differentiates it."""
    means = scene.means
    wv = camera.world_view
    fp = camera.full_proj

    def matvec3(m3):  # rows [3, 3] applied to means -> [N, 3]
        return torch.sum(means[:, None, :] * m3[None, :, :], dim=-1)

    p_view = matvec3(wv[:3, :3]) + wv[:3, 3]
    depth = p_view[:, 2]

    p_hom = matvec3(fp[:3, :3]) + fp[:3, 3]
    p_w = torch.sum(means * fp[3, :3], dim=-1) + fp[3, 3]
    inv_w = 1.0 / (p_w + 1e-7)
    ndc = p_hom[:, :2] * inv_w[:, None]
    if mean2d_offset is not None:
        ndc = ndc + mean2d_offset
    size = torch.tensor([camera.width, camera.height], dtype=torch.float32, device=means.device)
    mean2d = ((ndc + 1.0) * size - 1.0) * 0.5

    with stage_marks.span("covariance"):
        if cov3d_precomp is not None:
            cov3d = cov_ops.unstrip_symmetric(cov3d_precomp)
        else:
            cov3d = cov_ops.build_covariance_3d(scene.scales, scene.quats, scale_modifier)
        Wr = wv[:3, :3]
        # W @ Sigma @ W^T component-wise.
        tmp = torch.sum(Wr[None, :, None, :] * cov3d[:, None, :, :], dim=-1)  # [N,3,3]
        cov_cam = torch.sum(tmp[:, :, None, :] * Wr[None, None, :, :], dim=-1)
        cov2d = cov_ops.ewa_project(
            p_view, cov_cam, camera.focal_x, camera.focal_y, camera.tan_fovx, camera.tan_fovy
        )
        a, b, c = cov2d[:, 0], cov2d[:, 1], cov2d[:, 2]
        det = a * c - b * b
        det_valid = det > 0.0
        inv_det = torch.where(det_valid, 1.0 / torch.where(det_valid, det, 1.0), 0.0)
        conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

        # Pixel radius from the larger eigenvalue (3 sigma).
        mid = 0.5 * (a + c)
        lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        radius_f = torch.ceil(3.0 * torch.sqrt(lambda1))

    with stage_marks.span("sh"):
        color = colors_precomp if colors_precomp is not None else view_colors(scene, camera)

    valid = scene.alive & (depth > NEAR_PLANE) & det_valid
    radius = torch.where(valid, radius_f, 0.0).to(torch.int32)
    opacity = torch.where(valid, scene.opacities, 0.0)

    return Splats(
        mean2d=mean2d,
        conic=conic,
        color=color,
        opacity=opacity,
        depth=torch.where(valid, depth, torch.inf),
        radius=radius,
    )


# ---------------------------------------------------------------- the backward's plain twin


def _sum3(a, b, c):
    """torch.sum over three elements as the card adds them: (a + c) + b."""
    return (a + c) + b


def _sh_basis(degree: int, x, y, z) -> list:
    """The factors P_k of `sh_ops.eval_sh`'s terms P_k * sh[k], k >= 1
    (index 0 unused), in the chain's order of operations; terms 1 and 3
    are subtracted."""
    C1, C2, C3, C4 = sh_ops.C1, sh_ops.C2, sh_ops.C3, sh_ops.C4
    p = [None, C1 * y, C1 * z, C1 * x]
    if degree < 2:
        return p[: sh_ops.num_sh_coeffs(degree)]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    p += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy), C2[3] * xz, C2[4] * (xx - yy)]
    if degree < 3:
        return p
    p += [C3[0] * y * (3.0 * xx - yy), C3[1] * xy * z, C3[2] * y * (4.0 * zz - xx - yy),
          C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy), C3[4] * x * (4.0 * zz - xx - yy), C3[5] * z * (xx - yy),
          C3[6] * x * (xx - 3.0 * yy)]
    if degree < 4:
        return p
    p += [C4[0] * xy * (xx - yy), C4[1] * yz * (3.0 * xx - yy), C4[2] * xy * (7.0 * zz - 1.0),
          C4[3] * yz * (7.0 * zz - 3.0), C4[4] * (zz * (35.0 * zz - 30.0) + 3.0), C4[5] * xz * (7.0 * zz - 3.0),
          C4[6] * (xx - yy) * (7.0 * zz - 1.0), C4[7] * xz * (xx - 3.0 * yy),
          C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy))]
    return p


def _sh_direction_grad(degree: int, x, y, z, v) -> tuple:
    """d/d(x, y, z) of sum_k v_k B_k(x, y, z), B_k the signed basis of
    `eval_sh` (B_1 = -P_1, B_3 = -P_3, else P_k)."""
    C1, C2, C3, C4 = sh_ops.C1, sh_ops.C2, sh_ops.C3, sh_ops.C4
    gx, gy, gz = -C1 * v[3], -C1 * v[1], C1 * v[2]
    if degree < 2:
        return gx, gy, gz
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    gx = gx + (C2[0] * y) * v[4] + (C2[2] * (-2.0 * x)) * v[6] + (C2[3] * z) * v[7] + (C2[4] * (2.0 * x)) * v[8]
    gy = gy + (C2[0] * x) * v[4] + (C2[1] * z) * v[5] + (C2[2] * (-2.0 * y)) * v[6] + (C2[4] * (-2.0 * y)) * v[8]
    gz = gz + (C2[1] * y) * v[5] + (C2[2] * (4.0 * z)) * v[6] + (C2[3] * x) * v[7]
    if degree < 3:
        return gx, gy, gz
    gx = (gx + (C3[0] * (6.0 * xy)) * v[9] + (C3[1] * yz) * v[10] + (C3[2] * (-2.0 * xy)) * v[11]
          + (C3[3] * (-6.0 * xz)) * v[12] + (C3[4] * (4.0 * zz - 3.0 * xx - yy)) * v[13]
          + (C3[5] * (2.0 * xz)) * v[14] + (C3[6] * (3.0 * (xx - yy))) * v[15])
    gy = (gy + (C3[0] * (3.0 * (xx - yy))) * v[9] + (C3[1] * xz) * v[10]
          + (C3[2] * (4.0 * zz - xx - 3.0 * yy)) * v[11] + (C3[3] * (-6.0 * yz)) * v[12]
          + (C3[4] * (-2.0 * xy)) * v[13] + (C3[5] * (-2.0 * yz)) * v[14] + (C3[6] * (-6.0 * xy)) * v[15])
    gz = (gz + (C3[1] * xy) * v[10] + (C3[2] * (8.0 * yz)) * v[11]
          + (C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy)) * v[12] + (C3[4] * (8.0 * xz)) * v[13]
          + (C3[5] * (xx - yy)) * v[14])
    if degree < 4:
        return gx, gy, gz
    gx = (gx + (C4[0] * (y * (3.0 * xx - yy))) * v[16] + (C4[1] * (6.0 * (xy * z))) * v[17]
          + (C4[2] * (y * (7.0 * zz - 1.0))) * v[18] + (C4[5] * (z * (7.0 * zz - 3.0))) * v[21]
          + (C4[6] * ((2.0 * x) * (7.0 * zz - 1.0))) * v[22] + (C4[7] * ((3.0 * z) * (xx - yy))) * v[23]
          + (C4[8] * ((4.0 * x) * (xx - 3.0 * yy))) * v[24])
    gy = (gy + (C4[0] * (x * (xx - 3.0 * yy))) * v[16] + (C4[1] * ((3.0 * z) * (xx - yy))) * v[17]
          + (C4[2] * (x * (7.0 * zz - 1.0))) * v[18] + (C4[3] * (z * (7.0 * zz - 3.0))) * v[19]
          + (C4[6] * ((-2.0 * y) * (7.0 * zz - 1.0))) * v[22] + (C4[7] * (-6.0 * (xy * z))) * v[23]
          + (C4[8] * ((4.0 * y) * (yy - 3.0 * xx))) * v[24])
    gz = (gz + (C4[1] * (y * (3.0 * xx - yy))) * v[17] + (C4[2] * (14.0 * (xy * z))) * v[18]
          + (C4[3] * (y * (21.0 * zz - 3.0))) * v[19] + (C4[4] * (z * (140.0 * zz - 60.0))) * v[20]
          + (C4[5] * (x * (21.0 * zz - 3.0))) * v[21] + (C4[6] * ((14.0 * z) * (xx - yy))) * v[22]
          + (C4[7] * (x * (xx - 3.0 * yy))) * v[23])
    return gx, gy, gz


@torch.no_grad()
def preprocess_backward_plain(
    scene: GaussianScene,
    camera: Camera,
    g_mean2d: torch.Tensor,
    g_conic: torch.Tensor,
    g_color: torch.Tensor,
    g_opacity: torch.Tensor,
    scale_modifier: float = 1.0,
    mean2d_offset: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
) -> dict:
    """The gradients of the preprocess's inputs for the given gradients of
    `mean2d`, `conic`, `color` and `opacity`: the backward kernel's
    arithmetic in plain torch, written once from `plain_preprocess` (not
    from another rasterizer's backward) and held against its autograd.

    It recomputes the forward column by column with the card's sums of
    three ((a + c) + b) and four ((a + c) + (b + d)) and takes autograd's
    masks: a clamp passes the gradient where min <= x <= max, `torch.where`
    only to the branch taken. Returns a dict over the names of `_GRADS`,
    None for an input not given or not used (SH under `colors_precomp`,
    scales and rotations under `cov3d_precomp`)."""
    m = scene.means
    mx, my, mz = m.unbind(-1)
    wv, fp = camera.world_view, camera.full_proj

    def row(mat, i):
        return _sum3(mx * mat[i, 0], my * mat[i, 1], mz * mat[i, 2]) + mat[i, 3]

    px, py, pz = row(wv, 0), row(wv, 1), row(wv, 2)
    h0, h1, pw = row(fp, 0), row(fp, 1), row(fp, 3)
    inv_w = 1.0 / (pw + 1e-7)
    fx, fy = camera.focal_x, camera.focal_y
    W = [[wv[i, j] for j in range(3)] for i in range(3)]
    zero = torch.zeros_like(mx)

    # 3D covariance
    if cov3d_precomp is not None:
        c6 = cov3d_precomp.unbind(-1)
        S = [[c6[0], c6[1], c6[2]], [c6[1], c6[3], c6[4]], [c6[2], c6[4], c6[5]]]
    else:
        s = torch.exp(scene.log_scales).unbind(-1)
        sms = [scale_modifier * v for v in s]
        q = scene.quats.unbind(-1)
        q_norm = torch.sqrt((q[0] * q[0] + q[2] * q[2]) + (q[1] * q[1] + q[3] * q[3]))
        q_den = q_norm + 1e-12
        qw, qx, qy, qz = (v / q_den for v in q)
        R = [[1.0 - 2.0 * (qy * qy + qz * qz), 2.0 * (qx * qy - qw * qz), 2.0 * (qx * qz + qw * qy)],
             [2.0 * (qx * qy + qw * qz), 1.0 - 2.0 * (qx * qx + qz * qz), 2.0 * (qy * qz - qw * qx)],
             [2.0 * (qx * qz - qw * qy), 2.0 * (qy * qz + qw * qx), 1.0 - 2.0 * (qx * qx + qy * qy)]]
        L = [[R[i][j] * sms[j] for j in range(3)] for i in range(3)]
        S = [[_sum3(L[i][0] * L[j][0], L[i][1] * L[j][1], L[i][2] * L[j][2]) for j in range(3)] for i in range(3)]
    # camera-space covariance W S W^T, as the chain's two broadcast sums
    tmp = [[_sum3(W[i][0] * S[k][0], W[i][1] * S[k][1], W[i][2] * S[k][2]) for k in range(3)] for i in range(3)]
    c = [[_sum3(tmp[i][0] * W[l][0], tmp[i][1] * W[l][1], tmp[i][2] * W[l][2]) for l in range(3)] for i in range(3)]

    # EWA
    tz = torch.clamp(pz, min=1e-6)
    limx, limy = 1.3 * camera.tan_fovx, 1.3 * camera.tan_fovy
    rx, ry = px / tz, py / tz
    cx = torch.clamp(rx, min=-limx, max=limx)
    cy = torch.clamp(ry, min=-limy, max=limy)
    txz, tyz = cx * tz, cy * tz
    itz = 1.0 / tz
    itz2 = itz * itz
    nfx, nfy = -fx, -fy
    nfx_txz, nfy_tyz = nfx * txz, nfy * tyz
    j00, j02 = fx * itz, nfx_txz * itz2
    j11, j12 = fy * itz, nfy_tyz * itz2
    u1, u2 = j00 * c[0][0] + j02 * c[2][0], j00 * c[0][2] + j02 * c[2][2]
    v1 = j00 * c[0][1] + j02 * c[2][1]
    w1, w2 = j11 * c[1][1] + j12 * c[2][1], j11 * c[1][2] + j12 * c[2][2]
    A = (j00 * u1 + j02 * u2) + 0.3
    B = j11 * v1 + j12 * u2
    C = (j11 * w1 + j12 * w2) + 0.3
    det = A * C - B * B
    det_valid = det > 0.0
    inv_det = torch.where(det_valid, 1.0 / torch.where(det_valid, det, 1.0), 0.0)
    valid = scene.alive & (pz > NEAR_PLANE) & det_valid

    # opacity: where(valid, sigmoid(l), 0)
    sig = torch.sigmoid(scene.opacity_logits)
    g_logit = torch.where(valid, (g_opacity * (1.0 - sig)) * sig, 0.0)

    # mean2d = ((ndc + 1) * size - 1) * 0.5, ndc = p_hom[:2] / p_w (+ offset)
    g_ndc_x = (g_mean2d[:, 0] * 0.5) * float(camera.width)
    g_ndc_y = (g_mean2d[:, 1] * 0.5) * float(camera.height)
    g_h0, g_h1 = g_ndc_x * inv_w, g_ndc_y * inv_w
    g_inv_w = g_ndc_x * h0 + g_ndc_y * h1
    g_pw = -g_inv_w * (inv_w * inv_w)

    # conic = (C, -B, A) * inv_det
    ga, gb, gc = g_conic.unbind(-1)
    g_inv_det = (ga * C + gb * (-B)) + gc * A
    g_det = torch.where(det_valid, -g_inv_det * (inv_det * inv_det), 0.0)
    gA = gc * inv_det + g_det * C
    gC = ga * inv_det + g_det * A
    t = -g_det * B
    gB = -(gb * inv_det) + (t + t)

    # EWA backward
    gu1, gu2 = gA * j00, gA * j02 + gB * j12
    gv1, gw1, gw2 = gB * j11, gC * j11, gC * j12
    gj00 = ((gA * u1 + gu1 * c[0][0]) + gu2 * c[0][2]) + gv1 * c[0][1]
    gj02 = ((gA * u2 + gu1 * c[2][0]) + gu2 * c[2][2]) + gv1 * c[2][1]
    gj11 = ((gB * v1 + gC * w1) + gw1 * c[1][1]) + gw2 * c[1][2]
    gj12 = ((gB * u2 + gC * w2) + gw1 * c[2][1]) + gw2 * c[2][2]
    gcm = [[gu1 * j00, gv1 * j00, gu2 * j00],
           [zero, gw1 * j11, gw2 * j11],
           [gu1 * j02, gv1 * j02 + gw1 * j12, gu2 * j02 + gw2 * j12]]
    g_itz = gj00 * fx + gj11 * fy
    g_itz2 = gj02 * nfx_txz + gj12 * nfy_tyz
    g_txz, g_tyz = (gj02 * itz2) * nfx, (gj12 * itz2) * nfy
    g_itz = g_itz + (g_itz2 * itz + g_itz2 * itz)
    g_tz = (-g_itz * (itz * itz) + g_txz * cx) + g_tyz * cy
    g_rx = torch.where((rx >= -limx) & (rx <= limx), g_txz * tz, 0.0)
    g_ry = torch.where((ry >= -limy) & (ry <= limy), g_tyz * tz, 0.0)
    g_px, g_py = g_rx / tz, g_ry / tz
    g_tz = (g_tz - g_rx * (rx / tz)) - g_ry * (ry / tz)
    g_pz = torch.where(pz >= 1e-6, g_tz, 0.0)

    # camera-space covariance -> S
    g_tmp = [[(gcm[i][0] * W[0][k] + gcm[i][1] * W[1][k]) + gcm[i][2] * W[2][k] for k in range(3)]
             for i in range(3)]
    gS = [[(g_tmp[0][k] * W[0][j] + g_tmp[1][k] * W[1][j]) + g_tmp[2][k] * W[2][j] for j in range(3)]
          for k in range(3)]
    out = dict.fromkeys(_GRADS)
    if cov3d_precomp is not None:
        out["cov3d_precomp"] = torch.stack([gS[0][0], gS[0][1] + gS[1][0], gS[0][2] + gS[2][0], gS[1][1],
                                            gS[1][2] + gS[2][1], gS[2][2]], dim=-1)
    else:
        G = [[gS[i][j] + gS[j][i] for j in range(3)] for i in range(3)]
        gL = [[(G[a][0] * L[0][k] + G[a][1] * L[1][k]) + G[a][2] * L[2][k] for k in range(3)] for a in range(3)]
        gR = [[gL[i][j] * sms[j] for j in range(3)] for i in range(3)]
        g_sms = [(gL[0][j] * R[0][j] + gL[1][j] * R[1][j]) + gL[2][j] * R[2][j] for j in range(3)]
        out["log_scales"] = torch.stack([(g_sms[j] * scale_modifier) * s[j] for j in range(3)], dim=-1)
        g_qw = 2.0 * ((qy * (gR[0][2] - gR[2][0]) + qz * (gR[1][0] - gR[0][1])) + qx * (gR[2][1] - gR[1][2]))
        g_qx = 2.0 * (((qy * (gR[0][1] + gR[1][0]) + qz * (gR[0][2] + gR[2][0])) + qw * (gR[2][1] - gR[1][2]))
                      - (2.0 * qx) * (gR[1][1] + gR[2][2]))
        g_qy = 2.0 * (((qx * (gR[0][1] + gR[1][0]) + qw * (gR[0][2] - gR[2][0])) + qz * (gR[1][2] + gR[2][1]))
                      - (2.0 * qy) * (gR[0][0] + gR[2][2]))
        g_qz = 2.0 * (((qw * (gR[1][0] - gR[0][1]) + qx * (gR[0][2] + gR[2][0])) + qy * (gR[1][2] + gR[2][1]))
                      - (2.0 * qz) * (gR[0][0] + gR[1][1]))
        g_qn = (g_qw, g_qx, g_qy, g_qz)
        qn = (qw, qx, qy, qz)
        d = [-g_qn[i] * (qn[i] / q_den) for i in range(4)]
        g_qq = ((d[0] + d[2]) + (d[1] + d[3])) / (2.0 * q_norm)
        out["quats"] = torch.stack([g_qn[i] / q_den + (g_qq * q[i] + g_qq * q[i]) for i in range(4)], dim=-1)

    g_m = [((g_h0 * fp[0, j] + g_h1 * fp[1, j]) + g_pw * fp[3, j])
           + ((g_px * W[0][j] + g_py * W[1][j]) + g_pz * W[2][j]) for j in range(3)]

    # colour: clamp(eval_sh(dirs) + 0.5, min=0), dirs = (m - centre) / (|m - centre| + 1e-12)
    if colors_precomp is not None:
        out["colors_precomp"] = g_color.clone()
    else:
        degree = scene.active_sh_degree
        raw = (m - camera.camera_center).unbind(-1)
        nrm = torch.sqrt(_sum3(raw[0] * raw[0], raw[1] * raw[1], raw[2] * raw[2]))
        den = nrm + 1e-12
        x, y, z = (r / den for r in raw)
        p = _sh_basis(degree, x, y, z)
        sh = [scene.sh_dc] + [scene.sh_rest[:, k] for k in range(len(p) - 1)]
        res = scene.sh_dc * sh_ops.C0
        for k in range(1, len(p)):
            term = p[k][:, None] * sh[k]
            res = res - term if k in (1, 3) else res + term
        g_res = torch.where(res + 0.5 >= 0.0, g_color, 0.0)
        out["sh_dc"] = g_res * sh_ops.C0
        g_rest = torch.zeros_like(scene.sh_rest, memory_format=torch.contiguous_format)
        for k in range(1, len(p)):
            g_rest[:, k - 1] = (-g_res if k in (1, 3) else g_res) * p[k][:, None]
        out["sh_rest"] = g_rest
        if degree > 0:
            v = [None] + [_sum3(g_res[:, 0] * sh[k][:, 0], g_res[:, 1] * sh[k][:, 1], g_res[:, 2] * sh[k][:, 2])
                          for k in range(1, len(p))]
            g_dir = _sh_direction_grad(degree, x, y, z, v)
            e = [-g_dir[i] * ((raw[i] / den) / den) for i in range(3)]
            g_n2 = _sum3(*e) / (2.0 * nrm)
            g_m = [g_m[i] + (g_dir[i] / den + (g_n2 * raw[i] + g_n2 * raw[i])) for i in range(3)]
    out["means"] = torch.stack(g_m, dim=-1)
    out["opacity_logits"] = g_logit
    if mean2d_offset is not None:
        out["mean2d_offset"] = torch.stack([g_ndc_x, g_ndc_y], dim=-1)
    return out
