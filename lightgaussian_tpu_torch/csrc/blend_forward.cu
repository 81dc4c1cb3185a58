// Per-tile front-to-back alpha blend for Hopper (sm_90a): the forward
// rasterizer kernels of the PyTorch/CUDA port.
//
// Entry points (plain C interface, loaded with ctypes by
// lightgaussian_tpu_torch/ops/rasterize/blend.py):
//   lg_blend_forward       replaces the Pallas `_fwd_kernel`
//                          (lightgaussian_tpu/ops/rasterize/pallas_blend.py,
//                          `blend_forward`): writes the applied transmittance.
//   lg_blend_forward_fast  replaces the Pallas `_fast_kernel` (same file,
//                          `blend_forward_fast`): writes the naive
//                          transmittance, the render-only contract.
// Both are one template body, so each keeps its own launch counter.
//
// Semantics (the JAX package's masked-prefix form, reference.py): for each
// pixel, instances are walked in (tile, depth) order. alpha =
// min(0.99, opa * exp(power)); an instance is eligible if power <= 0 and
// alpha >= 1/255. An eligible instance is applied iff T * (1 - alpha) >=
// 1e-4; the first that fails ends the pixel's blending, and since T only
// falls, nothing after it would apply. EXACT writes the T of the applied
// instances. FAST writes the naive T: the product over every eligible
// instance walked before the block exits, the failed one and those after it
// included (the JAX render-only kernel's contract). The two differ only on
// saturated pixels, by under 1e-2. Out-of-image pixels write T = 1.
//
// Design: one block per 32x32 tile, 256 threads, 4 pixels per thread. The
// block reads its own [start, end) from tile_starts and stages, one at a
// time, the part of each 128-instance chunk of the buffer that falls in it
// (9 floats an instance, contiguous in memory, so the copy is coalesced)
// into shared memory. Chunks start at multiples of 128, as the JAX kernels'
// do, so the render-only kernel exits, and stops its naive T, where they do.
// Every thread walks the batch in order for its pixels; all threads read the
// same instance at once, which shared memory serves as a broadcast. After
// each batch the block leaves early
// once no pixel is still blending (__syncthreads_count). Past its stop, an
// EXACT pixel skips the rest of the walk; a FAST pixel keeps multiplying its
// naive T, so FAST does more work than EXACT in partly saturated tiles.
//
// Bound on this card: operations. Each (instance, pixel) pair walked costs
// 12 float32 instructions if power > 0 rejects it, else 21 to 31 more and
// one MUFU exp2 (chip_smoke.py counts them by kind), against 36 bytes read
// per instance for up to 1024 pixels: far above the H100's ratio of float32
// rate to memory rate. The design keeps the pair loop in registers and shared
// memory; nothing but the instances and the outputs touches device memory.
// Accuracy comes first in this version: expf (not __expf), and the file is
// built with --fmad=false so each operation rounds as the plain PyTorch
// version's does.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kPix = kTile * kTile;
constexpr int kThreads = 256;
constexpr int kPixPerThread = kPix / kThreads;
constexpr int kBatch = 128;
constexpr int kFeat = 9;  // mx, my, ca, cb, cc, r, g, b, opa

constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr float kMaxAlpha = 0.99f;

template <bool EXACT>
__global__ void __launch_bounds__(kThreads)
blend_tile_kernel(const int* __restrict__ tile_starts,
                  const float* __restrict__ inst,
                  float* __restrict__ rgb_out,  // [T, 3, kPix]
                  float* __restrict__ t_out,    // [T, 1, kPix]
                  int tiles_x, int width, int height) {
  __shared__ float feat[kBatch * kFeat];

  const int tile = blockIdx.x;
  const int start = tile_starts[tile];
  const int end = tile_starts[tile + 1];
  const int ox = (tile % tiles_x) * kTile;
  const int oy = (tile / tiles_x) * kTile;

  float px[kPixPerThread], py[kPixPerThread], T[kPixPerThread];
  float cr[kPixPerThread], cg[kPixPerThread], cb_[kPixPerThread];
  bool in_image[kPixPerThread], live[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    const int x = ox + p % kTile;
    const int y = oy + p / kTile;
    px[k] = static_cast<float>(x);
    py[k] = static_cast<float>(y);
    in_image[k] = x < width && y < height;
    live[k] = in_image[k];
    T[k] = 1.0f;
    cr[k] = cg[k] = cb_[k] = 0.0f;
  }

  for (int base = start / kBatch * kBatch; base < end; base += kBatch) {
    const int lo = max(base, start);
    const int n = min(base + kBatch, end) - lo;
    __syncthreads();  // the previous batch is no longer read
    const float* src = inst + static_cast<size_t>(lo) * kFeat;
    for (int i = threadIdx.x; i < n * kFeat; i += kThreads) feat[i] = src[i];
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const float* f = feat + j * kFeat;
      const float mx = f[0], my = f[1];
      const float ca = f[2], cb = f[3], cc = f[4];
      const float r = f[5], g = f[6], b = f[7];
      const float opa = f[8];
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        if (EXACT ? !live[k] : !in_image[k]) continue;
        const float dx = px[k] - mx;
        const float dy = py[k] - my;
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
        if (power > 0.0f) continue;
        const float alpha = fminf(kMaxAlpha, opa * expf(power));
        if (alpha < kAlphaEps) continue;
        const float test = T[k] * (1.0f - alpha);
        if (!live[k]) {  // FAST only: the naive T past the stop
          T[k] = test;
          continue;
        }
        if (test < kTEps) {
          live[k] = false;
          if (!EXACT) T[k] = test;
          continue;
        }
        const float w = alpha * T[k];
        cr[k] += w * r;
        cg[k] += w * g;
        cb_[k] += w * b;
        T[k] = test;
      }
    }

    int any_live = 0;
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) any_live |= live[k] ? 1 : 0;
    if (__syncthreads_count(any_live) == 0) break;
  }

  float* rgb = rgb_out + static_cast<size_t>(tile) * 3 * kPix;
  float* t = t_out + static_cast<size_t>(tile) * kPix;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    rgb[p] = cr[k];
    rgb[kPix + p] = cg[k];
    rgb[2 * kPix + p] = cb_[k];
    t[p] = in_image[k] ? T[k] : 1.0f;
  }
}

template <bool EXACT>
int launch(const void* tile_starts, const void* inst, void* rgb, void* t,
           int num_tiles, int tiles_x, int width, int height, void* stream) {
  blend_tile_kernel<EXACT><<<num_tiles, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_starts), static_cast<const float*>(inst),
      static_cast<float*>(rgb), static_cast<float*>(t), tiles_x, width, height);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lg_blend_forward(const void* tile_starts, const void* inst,
                                void* rgb, void* t, int num_tiles, int tiles_x,
                                int width, int height, void* stream) {
  return launch<true>(tile_starts, inst, rgb, t, num_tiles, tiles_x, width,
                      height, stream);
}

extern "C" int lg_blend_forward_fast(const void* tile_starts, const void* inst,
                                     void* rgb, void* t, int num_tiles,
                                     int tiles_x, int width, int height,
                                     void* stream) {
  return launch<false>(tile_starts, inst, rgb, t, num_tiles, tiles_x, width,
                       height, stream);
}
