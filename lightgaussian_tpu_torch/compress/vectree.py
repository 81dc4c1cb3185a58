"""VecTree quantization: importance-weighted VQ of the SH features and the
`extreme_saving/` compressed-checkpoint bundle.

Port of `lightgaussian_tpu/compress/vectree.py`. The bundle's files and
arrays are the JAX package's (and so the reference's), written and read
with numpy:

    extreme_saving/
      metadata.npz         {input_pc_num, input_pc_dim, codebook_size, codebook_dim}
      non_vq_mask.npz      packbits(bool[N])   (True = kept un-quantized)
      vq_indexs.npz        packbits(MSB-first log2(K)-bit codes, vq rows only)
      codebook.npz         fp16 [K, sh_dim]
      non_vq_feats.npz     fp16 [n_keep, sh_dim]
      other_attribute.npz  fp16 [N, 8]   (opacity, 3 scale, 4 rot)
      xyz.npz              fp32 [N, 3]
    extreme_saving.zip     (size report)

The feature matrix has the interchange PLY's column order:
x,y,z,nx,ny,nz,f_dc(3),f_rest(sh_dim-3),opacity,scale(3),rot(4). The keep
set, the bit packing and the files are numpy; the codebook fit and the
final assignment run on the scene's device (`compress/vq.py`).
"""
from __future__ import annotations

import dataclasses
import math
import zipfile
from pathlib import Path

import numpy as np
import torch

from lightgaussian_tpu_torch.compress import vq as vq_mod
from lightgaussian_tpu_torch.models import gaussians as G
from lightgaussian_tpu_torch.utils import threefry
from lightgaussian_tpu_torch.utils.device import resolve_device

BUNDLE_FILES = ("metadata.npz", "vq_indexs.npz", "codebook.npz", "non_vq_mask.npz", "non_vq_feats.npz",
                "other_attribute.npz", "xyz.npz")


def pack_bits_msb(values: np.ndarray, bits: int) -> np.ndarray:
    """dec2bin (MSB first), then packbits."""
    v = values.astype(np.int64)
    shifts = np.arange(bits - 1, -1, -1)
    bin_rows = ((v[:, None] >> shifts[None, :]) & 1).astype(np.uint8)
    return np.packbits(bin_rows.reshape(-1))


def unpack_bits_msb(packed: np.ndarray, count: int, bits: int) -> np.ndarray:
    flat = np.unpackbits(packed)[: count * bits].reshape(count, bits)
    shifts = np.arange(bits - 1, -1, -1)
    return (flat.astype(np.int64) << shifts[None, :]).sum(axis=1)


@dataclasses.dataclass
class VQConfig:
    """The VecTree settings (the reference's CLI knobs)."""

    sh_degree: int = 2
    vq_ratio: float = 0.6
    codebook_size: int = 2**13
    iterations: int = 1000
    chunk: int = 80_000
    k_expire: int = 10
    no_importance: bool = False
    vq_way: str = "half"  # fp16 storage of residual attributes

    @property
    def sh_dim(self) -> int:
        return {3: 48, 2: 27, 1: 12, 0: 3}[self.sh_degree]


def scene_to_feature_matrix(scene: G.GaussianScene) -> np.ndarray:
    """The alive rows as the full attribute matrix [N, 6 + sh_dim + 8] in
    interchange column order (float32, host)."""
    def host(t):
        return t.detach().cpu().numpy()

    alive = host(scene.alive)
    xyz = host(scene.means)[alive]
    n = xyz.shape[0]
    f_rest = np.transpose(host(scene.sh_rest)[alive], (0, 2, 1)).reshape(n, -1)
    return np.concatenate(
        [xyz, np.zeros_like(xyz), host(scene.sh_dc)[alive], f_rest,
         host(scene.opacity_logits)[alive][:, None], host(scene.log_scales)[alive], host(scene.quats)[alive]],
        axis=1,
    ).astype(np.float32)


def feature_matrix_to_scene(feats: np.ndarray, capacity: int | None = None,
                            device: str | torch.device = "cuda") -> G.GaussianScene:
    """The inverse of `scene_to_feature_matrix`, on `device`."""
    n, d = feats.shape
    k = (d - 6 - 8 - 3) // 3
    max_sh = int(round(math.sqrt(k + 1))) - 1
    cap = G.round_capacity(n) if capacity is None else capacity
    scene = G.empty_scene(cap, max_sh_degree=max_sh, active_sh_degree=max_sh, device=device)
    return G.fill_scene(scene, dict(
        means=feats[:, 0:3],
        sh_dc=feats[:, 6:9],
        sh_rest=feats[:, 9:9 + 3 * k].reshape(n, 3, k).transpose(0, 2, 1),
        opacity_logits=feats[:, d - 8],
        log_scales=feats[:, d - 7:d - 4],
        quats=feats[:, d - 4:d],
    ), n)


@dataclasses.dataclass
class QuantizationResult:
    non_vq_mask: np.ndarray  # [N] bool
    vq_indices: np.ndarray  # [n_vq] int
    codebook: np.ndarray  # [K, sh_dim] fp32 (fp16-rounded values)
    size_mb: float


def quantize_features(
    feats: np.ndarray,
    importance: np.ndarray,
    cfg: VQConfig,
    seed: int = 0,
    device: str | torch.device = "cuda",
    mesh=None,
) -> tuple[QuantizationResult, np.ndarray]:
    """The top (1 - vq_ratio) by importance are kept raw; a codebook is fit
    to the rest's SH features with importance-weighted EMA and k_expire on
    `device`; every row is then assigned in the fp16-rounded codebook.
    With a `mesh` (`parallel.make_mesh`) the fit is split over its data
    axis (`vq.train_codebook_sharded`); every rank passes the same inputs.

    Returns (result, the quantized full feature matrix)."""
    dev = resolve_device(device)
    n, d = feats.shape
    if 6 + cfg.sh_dim + 8 != d:
        raise ValueError(
            f"sh_degree {cfg.sh_degree} (sh_dim {cfg.sh_dim}) does not match the feature width {d} "
            "(expected 6 + sh_dim + 8); pass the model's actual SH degree")
    sh = feats[:, 6:6 + cfg.sh_dim]
    imp = np.ones(n) if cfg.no_importance else np.asarray(importance, np.float64)
    if imp.shape[0] != n:
        raise ValueError(f"importance rows {imp.shape[0]} != features {n}")

    n_keep = int(n * (1.0 - cfg.vq_ratio))
    order = np.argsort(-imp)
    non_vq_mask = np.zeros(n, bool)
    non_vq_mask[order[:n_keep]] = True
    is_percent = imp[non_vq_mask].sum() / max(imp.sum(), 1e-12)
    print(f"IS_percent: {is_percent:.4f}")

    vq_rows = ~non_vq_mask
    sh_vq = torch.from_numpy(np.ascontiguousarray(sh[vq_rows], np.float32)).to(dev)
    imp_vq = torch.from_numpy(imp[vq_rows].astype(np.float32)).to(dev)

    init_key, train_key = threefry.split(threefry.prng_key(seed))
    state = vq_mod.init_codebook(init_key, cfg.codebook_size, cfg.sh_dim, feats=sh_vq, device=dev)
    if mesh is not None:
        state = vq_mod.train_codebook_sharded(mesh, train_key, state, sh_vq, imp_vq, iterations=cfg.iterations,
                                              chunk=cfg.chunk, k_expire=cfg.k_expire)
    else:
        state = vq_mod.train_codebook(train_key, state, sh_vq, imp_vq, iterations=cfg.iterations,
                                      chunk=cfg.chunk, k_expire=cfg.k_expire)
    quant_sh, idx_all = vq_mod.quantize_with_fp16_codebook(
        torch.from_numpy(np.ascontiguousarray(sh, np.float32)).to(dev), state.embed)
    quant_sh = quant_sh.cpu().numpy()
    idx_all = idx_all.cpu().numpy()

    out = feats.copy()
    out[vq_rows, 6:6 + cfg.sh_dim] = quant_sh[vq_rows]
    if cfg.vq_way == "half":
        out[non_vq_mask, 6:6 + cfg.sh_dim] = sh[non_vq_mask].astype(np.float16).astype(np.float32)
        out[:, d - 8:] = out[:, d - 8:].astype(np.float16).astype(np.float32)

    result = QuantizationResult(
        non_vq_mask=non_vq_mask,
        vq_indices=idx_all[vq_rows],
        codebook=state.embed.to(torch.float16).to(torch.float32).cpu().numpy(),
        size_mb=0.0,
    )
    return result, out


def save_extreme(path: str | Path, feats: np.ndarray, result: QuantizationResult, cfg: VQConfig) -> float:
    """Write the `extreme_saving/` bundle and its zip; returns the zip's MB."""
    path = Path(path)
    out = path / "extreme_saving"
    out.mkdir(parents=True, exist_ok=True)
    n, d = feats.shape
    bits = int(math.log2(cfg.codebook_size))

    metadata = {"input_pc_num": n, "input_pc_dim": d, "codebook_size": cfg.codebook_size,
                "codebook_dim": cfg.sh_dim}
    np.savez_compressed(out / "metadata.npz", metadata=np.array(metadata, dtype=object))
    np.savez_compressed(out / "vq_indexs.npz", pack_bits_msb(result.vq_indices, bits))
    np.savez_compressed(out / "codebook.npz", result.codebook.astype(np.float16))
    np.savez_compressed(out / "non_vq_mask.npz", np.packbits(result.non_vq_mask))
    np.savez_compressed(out / "non_vq_feats.npz", feats[result.non_vq_mask, 6:6 + cfg.sh_dim].astype(np.float16))
    np.savez_compressed(out / "other_attribute.npz", feats[:, d - 8:].astype(np.float16))
    np.savez_compressed(out / "xyz.npz", feats[:, 0:3].astype(np.float32))

    zpath = path / "extreme_saving.zip"
    with zipfile.ZipFile(zpath, "w", zipfile.ZIP_DEFLATED) as z:
        for f in sorted(out.iterdir()):
            z.write(f, arcname=f"extreme_saving/{f.name}")
    size_mb = zpath.stat().st_size / 1024.0 / 1024.0
    print(f"Size = {size_mb:.2f} MB")
    return size_mb


def load_extreme(path: str | Path) -> np.ndarray:
    """The full [N, D] feature matrix rebuilt from a bundle directory."""
    path = Path(path)

    def load_f(name, array_name="arr_0", allow_pickle=False):
        with np.load(path / name, allow_pickle=allow_pickle) as z:
            return z[array_name]

    # the metadata is a pickled dict, as the reference writes it
    metadata = load_f("metadata.npz", array_name="metadata", allow_pickle=True).item()
    bits = int(math.log2(metadata["codebook_size"]))
    sh_dim = metadata["codebook_dim"]
    n, d = metadata["input_pc_num"], metadata["input_pc_dim"]

    non_vq_mask = np.unpackbits(load_f("non_vq_mask.npz"))[:n].astype(bool)
    vq_mask = ~non_vq_mask
    codebook = load_f("codebook.npz").astype(np.float32)
    vq_idx = unpack_bits_msb(load_f("vq_indexs.npz"), int(vq_mask.sum()), bits)

    full = np.zeros((n, d), np.float32)
    full[:, 0:3] = load_f("xyz.npz").astype(np.float32)
    full[:, d - 8:] = load_f("other_attribute.npz").astype(np.float32)
    full[vq_mask, 6:6 + sh_dim] = codebook[vq_idx]
    full[non_vq_mask, 6:6 + sh_dim] = load_f("non_vq_feats.npz").astype(np.float32)
    return full


def load_vq_scene(path: str | Path, device: str | torch.device = "cuda") -> G.GaussianScene:
    """A compressed checkpoint (`extreme_saving/`) as a GaussianScene."""
    return feature_matrix_to_scene(load_extreme(path), device=device)


def quantize_scene(
    scene: G.GaussianScene,
    importance: np.ndarray,
    save_path: str | Path,
    cfg: VQConfig | None = None,
    seed: int = 0,
    mesh=None,
):
    """Scene -> VQ on the scene's device -> `extreme_saving` bundle; returns
    (result, the bundle loaded back as a scene). `mesh` splits the fit as
    in `quantize_features`.

    `importance` is indexed over alive rows (what imp_score.npz stores) or
    over the scene's capacity; any other length comes from another scene
    and is refused."""
    cfg = cfg or VQConfig()
    feats = scene_to_feature_matrix(scene)
    n = feats.shape[0]
    imp = np.asarray(importance)
    if imp.shape[0] != n:
        if imp.shape[0] != scene.capacity:
            raise ValueError(
                f"imp_score length {imp.shape[0]} matches neither the scene's alive rows ({n}) nor its "
                f"capacity ({scene.capacity}); the scores were saved from a different checkpoint than input_path")
        imp = imp[scene.alive.cpu().numpy()]
    device = scene.means.device
    result, _ = quantize_features(feats, imp, cfg, seed=seed, device=device, mesh=mesh)
    result.size_mb = save_extreme(save_path, feats, result, cfg)
    return result, load_vq_scene(Path(save_path) / "extreme_saving", device=device)
