// Backward of the exact per-tile alpha blend for Hopper (sm_90a).
//
// Entry point (plain C interface, loaded with ctypes by
// lightgaussian_tpu_torch/ops/rasterize/blend.py):
//   lg_blend_backward  replaces the Pallas `_bwd_kernel`
//                      (lightgaussian_tpu/ops/rasterize/pallas_blend.py,
//                      `blend_backward`).
//
// Inputs: the forward's binning (tile_starts int32 [T+1], inst float32
// [M, 9] in (tile, depth) order, gid int64 [M] instance -> Gaussian) and,
// per tile, the image cotangent g [T, 3, 1024] and the remaining-
// contribution seed r [T, 1, 1024] = dot(rendered colour incl. background,
// g) + final_T * g_T. Output: per-Gaussian gradients [N, 9] in the
// instance feature order (mean2d x, y; conic a, b, c; rgb; opacity),
// accumulated with atomicAdd into a buffer the caller zeroed.
//
// Semantics (pallas_blend.py `_bwd_kernel`): the forward's front-to-back
// walk again, per pixel carrying the transmittance T and r. For an
// eligible instance (power <= 0, alpha >= 1/255) that is applied
// (T (1 - alpha) >= 1e-4):
//   w = alpha T,  cw = colour . g,  r_i = r - cw w,
//   d_alpha = cw T - r_i / (1 - alpha),
//   d_power = d_alpha alpha unless the 0.99 clamp is active,
// and d_colour = w g. The first instance that fails the T test ends the
// pixel's walk: it and everything after it get nothing from that pixel.
// Chunks are the buffer's 128-aligned blocks, as in the forward kernels,
// and the block leaves after the first chunk at whose end no pixel is
// still blending; instances past that exit get zero, as in the JAX kernel.
//
// Per instance the kernel sums nine values over the tile's pixels:
// S d_power, S d_power dx, S d_power dy, S d_power dx dx, S d_power dx dy,
// S d_power dy dy and S w g (three colours). The geometric gradients are
// linear in those sums (pallas_blend.py:519-540): d_mx = ca Sx + cb Sy,
// d_my = cc Sy + cb Sx, d_ca = -Sxx/2, d_cb = -Sxy, d_cc = -Syy/2,
// d_opa = S d_power / max(opa, 1e-12).
//
// Design: one block per 32x32 tile, 256 threads, 4 pixels a thread, the
// chunk staged in shared memory as in the forward. Each warp reduces an
// instance's nine sums over its 128 pixels with shuffles (skipped when no
// pixel of the warp applied it) and writes them to its own row of shared
// memory; after the chunk, one thread per instance adds the eight warps'
// rows in a fixed order, forms the nine gradients and adds them to its
// Gaussian's row with atomicAdd. Atomics and not per-instance rows reduced
// outside: one kernel, and 27 MB per view at 1920x1080 neither written nor
// read again, against atomics that rarely collide (a Gaussian's instances
// lie in different tiles). The price is a sum order that varies from run
// to run, so kernel and plain version are held at the normalised 2e-4 of
// bench.py --parity, not the CPU's 5e-5.
//
// Bound on this card: operations. An applied (instance, pixel) pair costs
// about 60 float32 instructions, a division and an exp (chip_smoke.py
// counts them by kind of pair), against 36 bytes read per instance for up
// to 1024 pixels. Accuracy first in this version: expf and IEEE division,
// and the file is built with --fmad=false so each operation rounds as the
// plain PyTorch version's does.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kPix = kTile * kTile;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPixPerThread = kPix / kThreads;
constexpr int kRowsPerStep = kThreads / kTile;  // pixel rows between a thread's pixels
constexpr int kBatch = 128;
constexpr int kFeat = 9;  // mx, my, ca, cb, cc, r, g, b, opa

// The nine per-instance sums over a tile's pixels.
enum { kS0, kSx, kSy, kSxx, kSxy, kSyy, kSr, kSg, kSb, kSums };

constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr float kMaxAlpha = 0.99f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
blend_backward_kernel(const int* __restrict__ tile_starts,
                      const float* __restrict__ inst,
                      const long long* __restrict__ gid,
                      const float* __restrict__ tile_g,  // [T, 3, kPix]
                      const float* __restrict__ tile_r,  // [T, 1, kPix]
                      float* __restrict__ grads,         // [N, kFeat], zeroed
                      int tiles_x, int width, int height) {
  __shared__ float feat[kBatch * kFeat];
  __shared__ float part[kWarps][kBatch][kSums];

  const int tile = blockIdx.x;
  const int start = tile_starts[tile];
  const int end = tile_starts[tile + 1];
  const int ox = (tile % tiles_x) * kTile;
  const int oy = (tile / tiles_x) * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // A thread's pixels share a column: p = threadIdx.x + k * kThreads.
  const int x = ox + threadIdx.x % kTile;
  const float px = static_cast<float>(x);
  float py[kPixPerThread], T[kPixPerThread], r[kPixPerThread];
  float gr[kPixPerThread], gg[kPixPerThread], gb[kPixPerThread];
  bool live[kPixPerThread];
  const float* g = tile_g + static_cast<size_t>(tile) * 3 * kPix;
  const float* r0 = tile_r + static_cast<size_t>(tile) * kPix;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    const int y = oy + threadIdx.x / kTile + k * kRowsPerStep;
    py[k] = static_cast<float>(y);
    live[k] = x < width && y < height;
    T[k] = 1.0f;
    r[k] = r0[p];
    gr[k] = g[p];
    gg[k] = g[kPix + p];
    gb[k] = g[2 * kPix + p];
  }

  for (int base = start / kBatch * kBatch; base < end; base += kBatch) {
    const int lo = max(base, start);
    const int n = min(base + kBatch, end) - lo;
    __syncthreads();  // the previous chunk is no longer read
    const float* src = inst + static_cast<size_t>(lo) * kFeat;
    for (int i = threadIdx.x; i < n * kFeat; i += kThreads) feat[i] = src[i];
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const float* f = feat + j * kFeat;
      const float mx = f[0], my = f[1];
      const float ca = f[2], cb = f[3], cc = f[4];
      const float cr = f[5], cgr = f[6], cbl = f[7];
      const float opa = f[8];
      float s[kSums];
#pragma unroll
      for (int q = 0; q < kSums; ++q) s[q] = 0.0f;
      bool hit = false;
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        if (!live[k]) continue;
        const float dx = px - mx;
        const float dy = py[k] - my;
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
        if (power > 0.0f) continue;
        const float alpha_raw = opa * expf(power);
        const float alpha = fminf(kMaxAlpha, alpha_raw);
        if (alpha < kAlphaEps) continue;
        const float one_minus = 1.0f - alpha;
        const float test = T[k] * one_minus;
        if (test < kTEps) {  // ends the pixel's blend: no gradient from here on
          live[k] = false;
          continue;
        }
        const float cw = cr * gr[k] + cgr * gg[k] + cbl * gb[k];
        const float w = alpha * T[k];
        const float r_i = r[k] - cw * w;
        const float d_alpha = cw * T[k] - r_i / one_minus;
        const float d_power = alpha_raw < kMaxAlpha ? d_alpha * alpha : 0.0f;
        const float q1 = d_power * dx;
        const float q2 = d_power * dy;
        s[kS0] += d_power;
        s[kSx] += q1;
        s[kSy] += q2;
        s[kSxx] += q1 * dx;
        s[kSxy] += q1 * dy;
        s[kSyy] += q2 * dy;
        s[kSr] += w * gr[k];
        s[kSg] += w * gg[k];
        s[kSb] += w * gb[k];
        r[k] = r_i;
        T[k] = test;
        hit = true;
      }
      const bool warp_hit = __any_sync(0xffffffffu, hit);
#pragma unroll
      for (int q = 0; q < kSums; ++q) {
        const float v = warp_hit ? warp_sum(s[q]) : 0.0f;
        if (lane == 0) part[warp][j][q] = v;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < n; i += kThreads) {
      float a[kSums];
      bool any = false;
#pragma unroll
      for (int q = 0; q < kSums; ++q) {
        float v = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += part[w][i][q];
        a[q] = v;
        any |= v != 0.0f;
      }
      if (!any) continue;
      const float* f = feat + i * kFeat;
      const float ca = f[2], cb = f[3], cc = f[4], opa = f[8];
      float* out = grads + static_cast<size_t>(gid[lo + i]) * kFeat;
      atomicAdd(out + 0, ca * a[kSx] + cb * a[kSy]);
      atomicAdd(out + 1, cc * a[kSy] + cb * a[kSx]);
      atomicAdd(out + 2, -0.5f * a[kSxx]);
      atomicAdd(out + 3, -a[kSxy]);
      atomicAdd(out + 4, -0.5f * a[kSyy]);
      atomicAdd(out + 5, a[kSr]);
      atomicAdd(out + 6, a[kSg]);
      atomicAdd(out + 7, a[kSb]);
      atomicAdd(out + 8, a[kS0] / fmaxf(opa, 1e-12f));
    }

    int any_live = 0;
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) any_live |= live[k] ? 1 : 0;
    if (__syncthreads_count(any_live) == 0) break;
  }
}

}  // namespace

extern "C" int lg_blend_backward(const void* tile_starts, const void* inst,
                                 const void* gid, const void* tile_g,
                                 const void* tile_r, void* grads, int num_tiles,
                                 int tiles_x, int width, int height,
                                 void* stream) {
  blend_backward_kernel<<<num_tiles, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_starts), static_cast<const float*>(inst),
      static_cast<const long long*>(gid), static_cast<const float*>(tile_g),
      static_cast<const float*>(tile_r), static_cast<float*>(grads), tiles_x,
      width, height);
  return static_cast<int>(cudaGetLastError());
}
