"""Importance-weighted vector quantization: the EMA codebook.

Port of `lightgaussian_tpu/compress/vq.py`. The nearest-code search is one
[chunk, D] x [D, K] product (argmin of |x|^2 - 2 x.E^T + |E|^2, float32,
TF32 off); the cluster statistics are `index_add_`; each fit iteration
samples a chunk, takes one weighted EMA step and revives the least-used
codes with the chunk's most important vectors.

The semantics are the JAX package's:
- weights normalised to mean 1 over the chunk; an all-zero chunk counts
  every vector 1;
- EMA (DECAY) of cluster_size and of embed_avg separately, the codebook
  their ratio with Laplace-smoothed sizes (the two-accumulator form);
- k_expire: the k least-used codes become the chunk's k most important
  vectors, with average inertia.

The draws are the JAX package's (`utils/threefry.py`): the same key gives
the same codebook start and the same chunk indices. `jax.lax.top_k` breaks
ties toward the lower index, and ties are common (cluster sizes start at
one, unit weights under `--no_IS`), so both top-k choices are stable sorts.

The fit records stage marks (`utils/stage_marks.py`): "draw" after each
block of index draws, "nearest code" and "EMA + expire" in each step.

`train_codebook_sharded` splits the fit over a mesh axis, one process per
rank (`parallel/`); draw for draw it is the JAX package's sharded fit.
"""
from __future__ import annotations

import dataclasses

import torch

from lightgaussian_tpu_torch.parallel import comm
from lightgaussian_tpu_torch.utils import stage_marks
from lightgaussian_tpu_torch.utils import threefry

DECAY = 0.8
EPS = 1e-5
# index draws for a block of fit iterations are made together, about this
# many indices at a time
DRAW_BLOCK = 1 << 22
# rows of the final assignment per pass: [rows, K] distances at a time
ASSIGN_ROWS = 1 << 16


@dataclasses.dataclass(frozen=True)
class CodebookState:
    embed: torch.Tensor  # [K, D] the codebook (embed_avg over smoothed size)
    embed_avg: torch.Tensor  # [K, D] EMA of weighted assigned-vector sums
    cluster_size: torch.Tensor  # [K] EMA of weighted assignment counts


def init_codebook(key: tuple[int, int], codebook_size: int, dim: int,
                  feats: torch.Tensor | None = None,
                  device: str | torch.device | None = None) -> CodebookState:
    """Codes drawn from `feats`' rows where given, else uniform on [-1, 1];
    cluster sizes start at 1 so that embed == embed_avg / cluster_size."""
    if feats is not None and feats.shape[0] > 0:
        idx = threefry.randint(key, (codebook_size,), 0, feats.shape[0], device=feats.device)
        embed = feats[idx]
    else:
        embed = threefry.uniform(key, (codebook_size, dim), -1.0, 1.0, device=device or "cpu")
    embed = embed.to(torch.float32)
    return CodebookState(embed=embed, embed_avg=embed.clone(),
                         cluster_size=torch.ones(codebook_size, dtype=torch.float32, device=embed.device))


def nearest_code(feats: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """argmin_k |x - e_k|^2 through one matrix product (the first index of
    a tie)."""
    x2 = torch.sum(feats * feats, dim=1, keepdim=True)
    e2 = torch.sum(embed * embed, dim=1)[None, :]
    # (x2 - 2 x.e) + e2 in place: one [rows, K] buffer, the same roundings
    dist = feats @ embed.T
    dist.mul_(-2.0).add_(x2).add_(e2)
    return torch.argmin(dist, dim=1)


def _top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """`jax.lax.top_k(x, k)[1]`: the k largest, ties toward the lower index."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def _ema_step(state: CodebookState, chunk: torch.Tensor, weight: torch.Tensor, k_expire: int,
              mesh=None, axis: str = "data") -> CodebookState:
    """One weighted EMA step on `chunk`, then the expiry. With a `mesh`,
    the chunk is this rank's share: the cluster statistics are summed over
    `axis`, and the expiry's candidates are the best `k_expire` of every
    rank's own best (gathered in rank order), so the codebook stays the
    same on every rank."""
    k_codes = state.embed.shape[0]
    wsum = weight.sum()
    w = torch.where(wsum > 0.0, weight * (weight.numel() / torch.clamp(wsum, min=1e-12)), 1.0)

    idx = nearest_code(chunk, state.embed)
    stage_marks.mark("nearest code")
    cluster_batch = torch.zeros(k_codes, dtype=torch.float32, device=chunk.device).index_add_(0, idx, w)
    embed_sum = torch.zeros_like(state.embed).index_add_(0, idx, chunk * w[:, None])
    if mesh is not None:
        cluster_batch = comm.psum(cluster_batch, mesh, axis)
        embed_sum = comm.psum(embed_sum, mesh, axis)

    cluster_size = state.cluster_size * DECAY + cluster_batch * (1.0 - DECAY)
    embed_avg = state.embed_avg * DECAY + embed_sum * (1.0 - DECAY)
    n = cluster_size.sum()
    smoothed = (cluster_size + EPS) / (n + k_codes * EPS) * n
    embed = embed_avg / torch.clamp(smoothed, min=1e-12)[:, None]

    if k_expire > 0:
        dead = _top_k_indices(-cluster_size, k_expire)
        important = _top_k_indices(w, k_expire)
        cand = chunk[important]
        if mesh is not None:
            wk = comm.all_gather(w[important], mesh, axis)
            cand = comm.all_gather(cand, mesh, axis)[_top_k_indices(wk, k_expire)]
        c0 = torch.clamp(n / k_codes, min=1.0)
        embed[dead] = cand
        embed_avg[dead] = cand * c0
        cluster_size[dead] = c0
    stage_marks.mark("EMA + expire")
    return CodebookState(embed=embed, embed_avg=embed_avg, cluster_size=cluster_size)


def sample_keys(key: tuple[int, int], iterations: int) -> list[tuple[int, int]]:
    """The per-iteration keys of `train_codebook`'s loop: key, sub = split(key)."""
    subs = []
    for _ in range(iterations):
        key, sub = threefry.split(key)
        subs.append(sub)
    return subs


def _fit(key, state: CodebookState, feats: torch.Tensor, importance: torch.Tensor, iterations: int,
         chunk: int, k_expire: int, mesh=None, axis: str = "data") -> CodebookState:
    """The loop of `train_codebook` and `train_codebook_sharded`: the chunk
    indices of a block of iterations are drawn in one pass."""
    k_expire = min(k_expire, state.embed.shape[0])
    subs = sample_keys(key, iterations)
    block = max(1, DRAW_BLOCK // chunk)
    for start in range(0, iterations, block):
        rows = threefry.randint_rows(subs[start:start + block], chunk, 0, feats.shape[0], device=feats.device)
        stage_marks.mark("draw")
        for idx in rows:
            state = _ema_step(state, feats[idx], importance[idx], k_expire, mesh, axis)
    return state


def train_codebook(
    key: tuple[int, int],
    state: CodebookState,
    feats: torch.Tensor,  # [M, D] vectors to be quantized
    importance: torch.Tensor,  # [M]
    iterations: int = 1000,
    chunk: int = 80_000,
    k_expire: int = 10,
) -> CodebookState:
    """`iterations` x (sample a chunk, weighted EMA step, expire)."""
    return _fit(key, state, feats, importance, iterations, chunk, k_expire)


def shard_rows(x: torch.Tensor, n: int, r: int) -> torch.Tensor:
    """Shard r of n contiguous shards of `x`'s rows, `x` padded first to a
    multiple of n by repeating its leading rows. Repeated rows are real
    data: zero rows would carry importance 0, and a chunk drawn all from
    them would fall back to unit weights and pull codes toward zero."""
    pad = (-x.shape[0]) % n
    if pad:
        x = torch.cat([x, x[torch.arange(pad, device=x.device) % x.shape[0]]])
    per = x.shape[0] // n
    return x[r * per:(r + 1) * per]


def train_codebook_sharded(
    mesh,
    key: tuple[int, int],
    state: CodebookState,
    feats: torch.Tensor,
    importance: torch.Tensor,
    iterations: int = 1000,
    chunk: int = 80_000,
    k_expire: int = 10,
    axis: str = "data",
) -> CodebookState:
    """The fit split over `mesh`'s `axis`, one process per rank: rank r
    draws chunk // n indices a step from its shard of the rows, with key
    `threefry.split(key, n)[r]`, and the cluster statistics are summed over
    the axis. Every rank passes the same `state`, `feats` and `importance`
    and returns the same codebook."""
    n = comm.axis_size(mesh, axis)
    r = comm.axis_index(mesh, axis)
    return _fit(threefry.split(key, n)[r], state, shard_rows(feats, n, r), shard_rows(importance, n, r),
                iterations, max(1, chunk // n), k_expire, mesh, axis)


def quantize_with_fp16_codebook(feats: torch.Tensor, embed: torch.Tensor):
    """The final assignment with the fp16-rounded codebook: (quantized
    rows as float32, indices). Rows go ASSIGN_ROWS at a time; each row's
    argmin is its own, so the result is the same as in one pass."""
    embed_h = embed.to(torch.float16).to(torch.float32)
    parts = [nearest_code(feats[i:i + ASSIGN_ROWS], embed_h) for i in range(0, feats.shape[0], ASSIGN_ROWS)]
    idx = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int64, device=feats.device)
    return embed_h[idx], idx
