"""PLY I/O and the Gaussian-splat interchange checkpoint format.

Port of `lightgaussian_tpu/data/ply.py` (the port keeps its own copy; it
imports nothing of the JAX package). The interchange layout is byte-
compatible with the reference's `point_cloud/iteration_N/point_cloud.ply`:
little-endian binary, one `vertex` element with f4 properties
x,y,z,nx,ny,nz,f_dc_0..2,f_rest_0..3K-1,opacity,scale_0..2,rot_0..3, where
f_rest is stored channel-major ([N,3,K] flattened). A file written by either
package loads in the other with identical arrays.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from lightgaussian_tpu_torch.models import gaussians as G

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NP_TO_PLY = {
    "int8": "char", "uint8": "uchar", "int16": "short", "uint16": "ushort",
    "int32": "int", "uint32": "uint", "float32": "float", "float64": "double",
}


@dataclasses.dataclass
class PlyElement:
    name: str
    count: int
    data: np.ndarray  # structured array, one field per property

    @property
    def property_names(self) -> list[str]:
        return list(self.data.dtype.names)

    def __getitem__(self, key: str) -> np.ndarray:
        return self.data[key]


def read_ply(path: str | Path) -> dict[str, PlyElement]:
    """Parse a PLY file (binary_little_endian, binary_big_endian or ascii;
    scalar properties)."""
    raw = Path(path).read_bytes()
    end = raw.find(b"end_header\n")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header = raw[:end].decode("ascii", errors="replace").splitlines()
    body = raw[end + len(b"end_header\n"):]
    if not header or header[0].strip() != "ply":
        raise ValueError(f"{path}: missing 'ply' magic")

    fmt = None
    elements: list[tuple[str, int, list[tuple[str, str]]]] = []
    for line in header[1:]:
        tok = line.strip().split()
        if not tok or tok[0] == "comment":
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                raise ValueError(f"{path}: list properties unsupported")
            elements[-1][2].append((tok[2], _PLY_TO_NP[tok[1]]))

    if fmt not in ("binary_little_endian", "binary_big_endian", "ascii"):
        raise ValueError(f"{path}: unknown format {fmt}")

    out: dict[str, PlyElement] = {}
    offset = 0
    if fmt == "ascii":
        text_rows = body.decode("ascii").split()
        pos = 0
        for name, count, props in elements:
            dtype = np.dtype([(p, t) for p, t in props])
            ncol = len(props)
            flat = np.array(text_rows[pos: pos + count * ncol])
            pos += count * ncol
            data = np.empty(count, dtype=dtype)
            grid = flat.reshape(count, ncol)
            for j, (p, t) in enumerate(props):
                data[p] = grid[:, j].astype(t)
            out[name] = PlyElement(name, count, data)
    else:
        bo = "<" if fmt == "binary_little_endian" else ">"
        for name, count, props in elements:
            dtype = np.dtype([(p, bo + t) for p, t in props])
            nbytes = dtype.itemsize * count
            data = np.frombuffer(body[offset: offset + nbytes], dtype=dtype)
            offset += nbytes
            if bo == ">":
                data = data.astype(dtype.newbyteorder("<"))
            out[name] = PlyElement(name, count, np.ascontiguousarray(data))
    return out


def write_ply(path: str | Path, data: np.ndarray) -> None:
    """Write a structured array as the `vertex` element of a
    binary_little_endian PLY."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    lines = ["ply", "format binary_little_endian 1.0", f"element vertex {len(data)}"]
    for name in data.dtype.names:
        base = data.dtype[name]
        lines.append(f"property {_NP_TO_PLY[base.name]} {name}")
    lines.append("end_header")
    header = ("\n".join(lines) + "\n").encode("ascii")
    le = np.dtype([(n, data.dtype[n].newbyteorder("<")) for n in data.dtype.names])
    with open(path, "wb") as f:
        f.write(header)
        f.write(np.ascontiguousarray(data.astype(le)).tobytes())


def store_point_cloud(path: str | Path, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """`storePly` layout: x,y,z f4 + nx,ny,nz f4 (zeros) + red,green,blue u1."""
    dtype = [(n, "f4") for n in ("x", "y", "z", "nx", "ny", "nz")] + [
        (n, "u1") for n in ("red", "green", "blue")
    ]
    data = np.empty(len(xyz), dtype=dtype)
    xyz = np.asarray(xyz, np.float32)
    for j, n in enumerate(("x", "y", "z")):
        data[n] = xyz[:, j]
    for n in ("nx", "ny", "nz"):
        data[n] = 0.0
    rgb = np.asarray(rgb)
    for j, n in enumerate(("red", "green", "blue")):
        data[n] = rgb[:, j].astype(np.uint8)
    write_ply(path, data)


def fetch_point_cloud(path: str | Path) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """`fetchPly`: returns (points f32 [N,3], colors in [0,1], normals)."""
    v = read_ply(path)["vertex"]
    pts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    cols = np.stack([v["red"], v["green"], v["blue"]], axis=1).astype(np.float32) / 255.0
    if "nx" in v.property_names:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float32)
    else:
        normals = np.zeros_like(pts)
    return pts, cols, normals


def gaussian_ply_fields(sh_rest_coeffs: int) -> list[str]:
    """Property order of the reference's `construct_list_of_attributes`."""
    return (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(3)]
        + [f"f_rest_{i}" for i in range(3 * sh_rest_coeffs)]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )


def save_gaussian_ply(scene, path: str | Path) -> None:
    """Write the scene's alive Gaussians in the interchange layout
    (f_rest flattened channel-major)."""
    def host(t):
        return t.detach().cpu().numpy()

    alive = host(scene.alive)
    xyz = host(scene.means)[alive]
    sh_dc = host(scene.sh_dc)[alive]  # [N, 3]
    sh_rest = host(scene.sh_rest)[alive]  # [N, K, 3]
    n, k = sh_rest.shape[0], sh_rest.shape[1]
    f_rest = np.transpose(sh_rest, (0, 2, 1)).reshape(n, 3 * k)
    opacity = host(scene.opacity_logits)[alive]
    log_scales = host(scene.log_scales)[alive]
    quats = host(scene.quats)[alive]

    cols = np.concatenate(
        [xyz, np.zeros_like(xyz), sh_dc, f_rest, opacity[:, None], log_scales, quats],
        axis=1,
    ).astype(np.float32)
    fields = gaussian_ply_fields(k)
    data = np.empty(n, dtype=[(f, "f4") for f in fields])
    for j, f in enumerate(fields):
        data[f] = cols[:, j]
    write_ply(path, data)


def load_gaussian_ply(
    path: str | Path,
    new_sh_degree: int | None = None,
    capacity: int | None = None,
    device: str | torch.device = "cuda",
):
    """Load an interchange PLY into a GaussianScene on `device`. With
    `new_sh_degree` set, truncates f_rest like the reference's `load_ply_sh`;
    otherwise the active degree is the file's max degree."""
    v = read_ply(path)["vertex"]
    names = v.property_names
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    n = xyz.shape[0]
    sh_dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], axis=1).astype(np.float32)

    rest_names = sorted(
        (nm for nm in names if nm.startswith("f_rest_")), key=lambda s: int(s.split("_")[-1])
    )
    k = len(rest_names) // 3
    max_sh = int(round(np.sqrt(k + 1))) - 1
    if (max_sh + 1) ** 2 - 1 != k:
        raise ValueError(f"{path}: bad f_rest count {len(rest_names)}")
    if k:
        f_rest = np.stack([v[nm] for nm in rest_names], axis=1).astype(np.float32)
        sh_rest = f_rest.reshape(n, 3, k).transpose(0, 2, 1)  # -> [N, K, 3]
    else:
        sh_rest = np.zeros((n, 0, 3), np.float32)

    if new_sh_degree is not None:
        if new_sh_degree > max_sh:
            raise ValueError("Requested max_sh_degree is greater than available in data.")
        sh_rest = sh_rest[:, :(new_sh_degree + 1) ** 2 - 1, :]
        max_sh = new_sh_degree

    arrays = dict(
        means=xyz,
        sh_dc=sh_dc,
        sh_rest=sh_rest,
        log_scales=np.stack([v[f"scale_{i}"] for i in range(3)], axis=1).astype(np.float32),
        quats=np.stack([v[f"rot_{i}"] for i in range(4)], axis=1).astype(np.float32),
        opacity_logits=np.asarray(v["opacity"], np.float32),
    )
    cap = G.round_capacity(n) if capacity is None else capacity
    if cap < n:
        raise ValueError(f"capacity {cap} is below the file's {n} Gaussians")
    scene = G.empty_scene(cap, max_sh_degree=max_sh, active_sh_degree=max_sh, device=device)
    return G.fill_scene(scene, arrays, n)
