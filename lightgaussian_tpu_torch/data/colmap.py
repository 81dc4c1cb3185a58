"""COLMAP sparse-reconstruction parsers (binary and text) and binary writers.

Port of `lightgaussian_tpu/data/colmap.py`: COLMAP's own formats,
`cameras.bin/.txt`, `images.bin/.txt` and `points3D.bin/.txt` under
`sparse/0/`, read with `struct` and numpy on the host. The port has no
native parser: every binary file is read here, and a file that ends early
raises.
"""
from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

# model_id -> (name, num_params), COLMAP's camera models
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # [4] (w, x, y, z)
    tvec: np.ndarray  # [3]
    camera_id: int
    name: str
    xys: np.ndarray  # [M, 2]
    point3D_ids: np.ndarray  # [M]


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """Quaternion (w,x,y,z) -> rotation matrix."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w,x,y,z), largest-eigenvector method."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, fmt: str):
    size = struct.calcsize(fmt)
    data = f.read(size)
    if len(data) != size:
        raise ValueError(f"{f.name}: the file ends {size - len(data)} bytes early")
    return struct.unpack(fmt, data)


def _read_bytes(f, size: int) -> bytes:
    data = f.read(size)
    if len(data) != size:
        raise ValueError(f"{f.name}: the file ends {size - len(data)} bytes early")
    return data


# ---------------------------------------------------------------------------
# Binary readers
# ---------------------------------------------------------------------------

def read_cameras_binary(path: str | Path) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "<" + "d" * n_params))
            cams[cam_id] = ColmapCamera(cam_id, name, int(width), int(height), params)
    return cams


def read_images_binary(path: str | Path) -> dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            vals = _read(f, "<idddddddi")
            image_id, camera_id = vals[0], vals[8]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            name = b""
            while True:
                c = _read_bytes(f, 1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            # packed as (x f64, y f64, point3D_id i64) triples
            buf = _read_bytes(f, 24 * n_pts)
            raw = np.frombuffer(buf, dtype="<f8").reshape(n_pts, 3)
            xys = raw[:, :2].copy()
            ids = np.frombuffer(buf, dtype="<i8").reshape(n_pts, 3)[:, 2].copy()
            images[image_id] = ColmapImage(
                image_id, qvec, tvec, camera_id, name.decode("utf-8"), xys, ids
            )
    return images


def read_points3D_binary(path: str | Path) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (xyz [N,3] f64, rgb [N,3] u8, errors [N,1] f64)."""
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        xyz = np.empty((num, 3))
        rgb = np.empty((num, 3), np.uint8)
        err = np.empty((num, 1))
        for i in range(num):
            vals = _read(f, "<QdddBBBd")
            xyz[i] = vals[1:4]
            rgb[i] = vals[4:7]
            err[i] = vals[7]
            (track_len,) = _read(f, "<Q")
            _read_bytes(f, 8 * track_len)  # (image_id i32, point2D_idx i32) pairs
    return xyz, rgb, err


# ---------------------------------------------------------------------------
# Text readers
# ---------------------------------------------------------------------------

def _data_lines(path):
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            yield line


def read_cameras_text(path: str | Path) -> dict[int, ColmapCamera]:
    cams = {}
    for line in _data_lines(path):
        tok = line.split()
        cam_id = int(tok[0])
        cams[cam_id] = ColmapCamera(
            cam_id, tok[1], int(tok[2]), int(tok[3]), np.array(tuple(map(float, tok[4:])))
        )
    return cams


def read_images_text(path: str | Path) -> dict[int, ColmapImage]:
    """Two lines an image; the second (its 2D points) is empty for an image
    without points, as COLMAP writes it, and is read as such."""
    images = {}
    lines = [line.strip() for line in Path(path).read_text().splitlines()]
    lines = [line for line in lines if not line.startswith("#")]
    i = 0
    while i < len(lines):
        if not lines[i]:
            i += 1
            continue
        tok = lines[i].split()
        image_id = int(tok[0])
        qvec = np.array(tuple(map(float, tok[1:5])))
        tvec = np.array(tuple(map(float, tok[5:8])))
        camera_id = int(tok[8])
        name = tok[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        i += 2
        trip = np.array(tuple(map(float, pts))).reshape(-1, 3) if pts else np.zeros((0, 3))
        images[image_id] = ColmapImage(
            image_id, qvec, tvec, camera_id, name, trip[:, :2], trip[:, 2].astype(np.int64)
        )
    return images


def read_points3D_text(path: str | Path) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    rows = [line.split() for line in _data_lines(path)]
    n = len(rows)
    xyz = np.empty((n, 3))
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty((n, 1))
    for i, tok in enumerate(rows):
        xyz[i] = tuple(map(float, tok[1:4]))
        rgb[i] = tuple(map(int, tok[4:7]))
        err[i] = float(tok[7])
    return xyz, rgb, err


# ---------------------------------------------------------------------------
# Binary writers (test fixtures and dataset tooling)
# ---------------------------------------------------------------------------

def write_cameras_binary(path: str | Path, cams: dict[int, ColmapCamera]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def write_images_binary(path: str | Path, images: dict[int, ColmapImage]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n = len(im.point3D_ids)
            f.write(struct.pack("<Q", n))
            for xy, pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", xy[0], xy[1], int(pid)))


def write_points3D_binary(path: str | Path, xyz: np.ndarray, rgb: np.ndarray, err: np.ndarray | None = None) -> None:
    n = len(xyz)
    err = np.zeros((n, 1)) if err is None else np.reshape(err, (n, 1))
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(struct.pack("<QdddBBBd", i + 1, *xyz[i], *rgb[i].astype(np.uint8), float(err[i, 0])))
            f.write(struct.pack("<Q", 0))
