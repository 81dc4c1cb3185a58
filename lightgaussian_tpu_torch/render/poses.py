"""Camera-path generation and pose perturbation.

Port of `lightgaussian_tpu/render/poses.py`, host-side numpy as there:
PCA-normalized ellipse paths with constant-speed resampling, forward-facing
spirals (and the second spiral variant, whose "focal" is the first camera's
FoVx, a quirk of the reference kept as it is), spherical sample paths, the
spherified orbit, Gaussian pose jitter for distillation augmentation and
circular offsets. Trajectory poses are world-to-camera 4x4s, made into
render-ready `Camera`s with a template's intrinsics on the template's
device. The numpy work is the JAX module's, line for line, so both packages
make the same cameras (`gaussian_pose` draws translate first, then angles,
from the caller's generator).
"""
from __future__ import annotations

import math

import numpy as np

from lightgaussian_tpu_torch.models.camera import Camera


def _normalize(v):
    return v / np.linalg.norm(v)


def viewmatrix(z, up, pos):
    """[right, up', z, pos] camera-to-world 3x4 (`pose_utils.py:10-16`)."""
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def camera_Rt(camera: Camera) -> tuple[np.ndarray, np.ndarray]:
    """Recover the loader-convention (R=cam2world rotation, T=w2c translation)
    from a Camera's world_view matrix."""
    wv = camera.world_view.detach().cpu().numpy()
    return wv[:3, :3].T.astype(np.float64), wv[:3, 3].astype(np.float64)


def c2w_from_camera(camera: Camera, blender: bool = False) -> np.ndarray:
    """Camera -> camera-to-world 4x4. With `blender=True`, flips the Y/Z
    columns into the convention `transforms_*.json` stores (which the Blender
    reader undoes). Single source of the pose convention for dataset writers —
    a hand-rolled copy once transposed R and silently misaligned every
    synthetic-gt pose by ~0.1."""
    R, T = camera_Rt(camera)  # R = cam2world rotation, T = w2c translation
    c2w = np.eye(4)
    c2w[:3, :3] = R
    c2w[:3, 3] = -R @ T
    if blender:
        c2w[:3, 1:3] *= -1
    return c2w


def _c2w_poses(cams: list[Camera]) -> np.ndarray:
    """Cameras -> OpenGL-convention camera-to-world 4x4s (the `tmp_view`
    construction of `pose_utils.py:263-269`)."""
    poses = []
    for cam in cams:
        R, T = camera_Rt(cam)
        w2c = np.eye(4)
        w2c[:3, :3] = R.T
        w2c[:3, 3] = T
        c2w = np.linalg.inv(w2c)
        c2w[:, 1:3] *= -1
        poses.append(c2w)
    return np.stack(poses, axis=0)


def pad_poses(p):
    bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
    return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def unpad_poses(p):
    return p[..., :3, :4]


def transform_poses_pca(poses: np.ndarray):
    """Align principal components with XYZ, normalize to the unit cube
    (`pose_utils.py:222-259`)."""
    t = poses[:, :3, 3]
    t_mean = t.mean(axis=0)
    t = t - t_mean
    # eigh (not the reference's eig): guarantees orthonormal eigenvectors even
    # for degenerate spectra (e.g. a symmetric camera ring)
    eigval, eigvec = np.linalg.eigh(t.T @ t)
    inds = np.argsort(eigval)[::-1]
    rot = eigvec[:, inds].T
    if np.linalg.det(rot) < 0:
        rot = np.diag([1, 1, -1.0]) @ rot
    transform = np.concatenate([rot, rot @ -t_mean[:, None]], -1)
    poses_rc = unpad_poses(transform @ pad_poses(poses))
    transform = np.concatenate([transform, np.eye(4)[3:]], axis=0)
    if poses_rc.mean(axis=0)[2, 1] < 0:
        poses_rc = np.diag([1, -1, -1.0]) @ poses_rc
        transform = np.diag([1, -1, -1, 1.0]) @ transform
    scale = 1.0 / np.max(np.abs(poses_rc[:, :3, 3]))
    poses_rc[:, :3, 3] *= scale
    transform = np.diag([scale] * 3 + [1.0]) @ transform
    return poses_rc, transform


def focus_point_fn(poses: np.ndarray) -> np.ndarray:
    """Nearest point to all focal axes (`pose_utils.py:103-109`)."""
    directions, origins = poses[:, :3, 2:3], poses[:, :3, 3:4]
    m = np.eye(3) - directions * np.transpose(directions, [0, 2, 1])
    mt_m = np.transpose(m, [0, 2, 1]) @ m
    return np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]


def _invert_cdf(u, t, w_logits):
    w = np.exp(w_logits) / np.exp(w_logits).sum(axis=-1, keepdims=True)
    cw = np.minimum(1, np.cumsum(w[..., :-1], axis=-1))
    shape = cw.shape[:-1] + (1,)
    cw0 = np.concatenate([np.zeros(shape), cw, np.ones(shape)], axis=-1)
    return np.interp(u, cw0, t)


def _resample_const_speed(t, w_logits, num_samples):
    """Deterministic inverse-CDF resampling (`sample_np`, `pose_utils.py:72-99`)."""
    eps = np.finfo(np.float32).eps
    u = np.linspace(0, 1.0 - eps, num_samples)
    return _invert_cdf(u, t, w_logits)


def generate_ellipse_path(
    cams: list[Camera],
    n_frames: int = 600,
    const_speed: bool = True,
    z_variation: float = 0.0,
    z_phase: float = 0.0,
) -> list[np.ndarray]:
    """Elliptical orbit fit to the training cameras (`pose_utils.py:261-322`).
    Returns world-to-camera 4x4s in the COLMAP convention."""
    poses, transform = transform_poses_pca(_c2w_poses(cams))

    center = focus_point_fn(poses)
    offset = np.array([center[0], center[1], center[2] * 0])
    sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)
    low, high = -sc + offset, sc + offset
    z_low = np.percentile(poses[:, :3, 3], 10, axis=0)
    z_high = np.percentile(poses[:, :3, 3], 90, axis=0)

    def get_positions(theta):
        return np.stack(
            [
                low[0] + (high - low)[0] * (np.cos(theta) * 0.5 + 0.5),
                low[1] + (high - low)[1] * (np.sin(theta) * 0.5 + 0.5),
                z_variation
                * (z_low[2] + (z_high - z_low)[2] * (np.cos(theta + 2 * np.pi * z_phase) * 0.5 + 0.5)),
            ],
            -1,
        )

    theta = np.linspace(0, 2.0 * np.pi, n_frames + 1, endpoint=True)
    positions = get_positions(theta)
    if const_speed:
        lengths = np.linalg.norm(positions[1:] - positions[:-1], axis=-1)
        theta = _resample_const_speed(theta, np.log(lengths), n_frames + 1)
        positions = get_positions(theta)
    positions = positions[:-1]

    avg_up = _normalize(poses[:, :3, 1].mean(0))
    ind_up = np.argmax(np.abs(avg_up))
    up = np.eye(3)[ind_up] * np.sign(avg_up[ind_up])

    out = []
    for p in positions:
        pose = np.eye(4)
        pose[:3] = viewmatrix(p - center, up, p)
        pose = np.linalg.inv(transform) @ pose
        pose[:3, 1:3] *= -1
        out.append(np.linalg.inv(pose))
    return out


def generate_spiral_path(
    cams: list[Camera],
    bounds: np.ndarray,
    n_frames: int = 180,
    n_rots: int = 2,
    zrate: float = 0.5,
) -> np.ndarray:
    """Forward-facing spiral (`pose_utils.py:132-181`)."""
    near_stretch, far_stretch, focus_distance = 0.9, 5.0, 0.75
    poses = _c2w_poses(cams)
    bounds = np.asarray(bounds, np.float64).reshape(1, -1).repeat(poses.shape[0], 0)
    scale = 1.0 / (bounds.min() * 0.75)
    poses[:, :3, 3] *= scale
    bounds = bounds * scale

    near_bound = bounds.min() * near_stretch
    far_bound = bounds.max() * far_stretch
    focal = 1 / ((1 - focus_distance) / near_bound + focus_distance / far_bound)

    positions = poses[:, :3, 3]
    radii = np.concatenate([np.percentile(np.abs(positions), 90, 0), [1.0]])

    z_axis_avg = poses[:, :3, 2].mean(0)
    up = poses[:, :3, 1].mean(0)
    cam2world = viewmatrix(z_axis_avg, up, positions.mean(0))  # 3x4

    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_frames, endpoint=False):
        t = radii * [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]
        position = cam2world @ t
        lookat = cam2world @ [0, 0, -focal, 1.0]
        z_axis = position - lookat
        pose = np.eye(4)
        pose[:3] = viewmatrix(z_axis, up, position)
        pose[:3, 1:3] *= -1
        out.append(np.linalg.inv(pose))
    return np.stack(out, axis=0)


def generate_spiral_path_focal(
    cams: list[Camera],
    zrate: float = 0.0,
    n_rots: int = 1,
    n_frames: int = 600,
) -> np.ndarray:
    """Second spiral variant (`pose_utils.py:518-551`): no scene bounds — the
    look-at distance comes from the cameras themselves. Quirk preserved from
    the reference: its `get_focal` (`pose_utils.py:28-30`) returns `FoVx`
    (radians, not a focal length), and the accumulation loop adds `views[0]`'s
    value len(views) times then divides — so "focal" is exactly the FIRST
    camera's FoVx. Flat orbit by default (zrate=0, one rotation)."""
    poses = _c2w_poses(cams)
    focal = 2.0 * math.atan(float(cams[0].tan_fovx))  # FoVx in radians

    positions = poses[:, :3, 3]
    up = _normalize(poses[:, :3, 1].sum(0))
    cam2world = viewmatrix(poses[:, :3, 2].mean(0), up, positions.mean(0))  # 3x4
    radii = np.concatenate([np.percentile(np.abs(positions), 90, 0), [1.0]])

    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_frames + 1)[:-1]:
        c = cam2world @ (np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]) * radii)
        z_axis = _normalize(c - cam2world @ np.array([0, 0, -focal, 1.0]))
        pose = np.eye(4)
        pose[:3] = viewmatrix(z_axis, up, c)
        pose[:3, 1:3] *= -1
        out.append(np.linalg.inv(pose))
    return np.stack(out, axis=0)


def generate_spherical_sample_path(
    cams: list[Camera], azimuthal_rots: float = 1.0, polar_rots: float = 0.75, n: int = 10
) -> list[np.ndarray]:
    """Spherical sweep around the scene center (`pose_utils.py:475-515`)."""
    poses, transform = transform_poses_pca(_c2w_poses(cams))
    center = focus_point_fn(poses)
    radius = np.percentile(np.linalg.norm(poses[:, :3, 3] - center, axis=1), 70)
    avg_up = _normalize(poses[:, :3, 1].mean(0))
    ind_up = np.argmax(np.abs(avg_up))
    up = np.eye(3)[ind_up] * np.sign(avg_up[ind_up])

    out = []
    for i in range(n):
        az = 2 * np.pi * azimuthal_rots * i / n
        pol = np.pi / 2 * (1 - polar_rots * abs(math.sin(2 * np.pi * i / n)))
        p = center + radius * np.array(
            [np.cos(az) * np.sin(pol), np.sin(az) * np.sin(pol), np.cos(pol)]
        )
        pose = np.eye(4)
        pose[:3] = viewmatrix(p - center, up, p)
        pose = np.linalg.inv(transform) @ pose
        pose[:3, 1:3] *= -1
        out.append(np.linalg.inv(pose))
    return out


def generate_spherify_path(cams: list[Camera], n_frames: int = 120) -> list[np.ndarray]:
    """Spherified inward-facing orbit (`pose_utils.py:325-391` semantics).

    Finds the 3D point with minimum total squared distance to all camera
    optical axes, re-centers/normalizes the rig around it, and emits a circle
    of poses at the cameras' mean height looking at the center. Returns
    world-to-camera 4x4s in the COLMAP convention like the other generators.
    """
    poses = _c2w_poses(cams)  # OpenGL-convention c2w like the reference builds
    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    # Least-squares intersection of the camera viewing lines.
    a_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
    b_i = -a_i @ rays_o
    center = np.squeeze(
        -np.linalg.inv((np.transpose(a_i, [0, 2, 1]) @ a_i).mean(0)) @ b_i.mean(0)
    )

    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = _normalize(up)
    vec1 = _normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = _normalize(np.cross(vec0, vec1))
    c2w = np.eye(4)
    c2w[:3] = np.stack([vec1, vec2, vec0, center], 1)

    poses_reset = np.linalg.inv(c2w) @ pad_poses(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    poses_reset[:, :3, 3] /= rad

    zh = np.mean(poses_reset[:, :3, 3], 0)[2]
    radcircle = np.sqrt(max(1.0 - zh * zh, 1e-12))

    out = []
    for th in np.linspace(0.0, 2.0 * np.pi, n_frames):
        origin = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up_c = np.array([0.0, 0.0, -1.0])
        v2 = _normalize(origin)
        v0 = _normalize(np.cross(v2, up_c))
        v1 = _normalize(np.cross(v2, v0))
        pose = np.eye(4)
        pose[:3] = np.stack([v0, v1, v2, origin], 1)
        # Back to world scale/frame, then to the COLMAP w2c convention.
        pose[:3, 3] *= rad
        pose = c2w @ pose
        pose[:3, 1:3] *= -1
        out.append(np.linalg.inv(pose))
    return out


def camera_from_w2c(w2c: np.ndarray, template: Camera) -> Camera:
    """Materialize a trajectory pose with a template camera's intrinsics — the
    per-frame rebuild of `render_video.py:114-117`."""
    return Camera.from_Rt(
        w2c[:3, :3].T,
        w2c[:3, 3],
        fovx=2.0 * math.atan(float(template.tan_fovx)),
        fovy=2.0 * math.atan(float(template.tan_fovy)),
        width=template.width,
        height=template.height,
        device=template.world_view.device,
    )


def _rot_axis(axis: str, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def gaussian_pose(
    camera: Camera,
    rng: np.random.Generator,
    mean: float = 0.0,
    std_translation: float = 0.03,
    std_rotation: float = 0.01,
) -> Camera:
    """Jittered copy of a camera — distillation's augmented views
    (`pose_utils.py:433-460`, used 2 of 3 iters by `distill_train.py:132-137`)."""
    R, T = camera_Rt(camera)
    translate = rng.normal(mean, std_translation, 3)
    angles = rng.normal(mean, std_rotation, 3)
    rot = _rot_axis("z", angles[2]) @ _rot_axis("y", angles[1]) @ _rot_axis("x", angles[0])
    out = Camera.from_Rt(
        R @ rot,
        T,
        fovx=2.0 * math.atan(float(camera.tan_fovx)),
        fovy=2.0 * math.atan(float(camera.tan_fovy)),
        width=camera.width,
        height=camera.height,
        translate=translate,
        device=camera.world_view.device,
    )
    if camera.gt_image is not None:
        out = out.with_gt(camera.gt_image)
    return out


def circular_pose(camera: Camera, radius: float, angle: float = 0.0) -> Camera:
    """Camera-center offset on a circle (`pose_utils.py:464-473`)."""
    R, T = camera_Rt(camera)
    translate = np.array([radius * np.cos(angle), radius * np.sin(angle), 0.0])
    return Camera.from_Rt(
        R,
        T,
        fovx=2.0 * math.atan(float(camera.tan_fovx)),
        fovy=2.0 * math.atan(float(camera.tan_fovy)),
        width=camera.width,
        height=camera.height,
        translate=translate,
        device=camera.world_view.device,
    )
