// Counting blend for Hopper (sm_90a): the exact per-tile alpha blend plus
// per-Gaussian blending statistics, the inputs of the Global Significance
// Score.
//
// Entry point (plain C interface, loaded with ctypes by
// lightgaussian_tpu_torch/ops/rasterize/blend.py):
//   lg_blend_count  replaces the Pallas `_count_kernel`
//                   (lightgaussian_tpu/ops/rasterize/pallas_blend.py,
//                   `blend_forward_counting`) together with the gather and
//                   segmented sum that follow it in the JAX package's
//                   `tiled.blend_tiled_counting`.
//
// Semantics: the image and the applied transmittance are those of
// lg_blend_forward (csrc/blend_forward.cu), computed by the same operations
// in the same order. Besides, every instance has a weight w = alpha * T on
// each pixel it is applied to and 0 elsewhere; the kernel adds, per Gaussian,
// the sum of w over all its instances and pixels to `imp` (float) and the
// number of pixels with w > 0 to `cnt` (int). Both outputs arrive zeroed, so
// a Gaussian in no tile keeps exact zeros.
//
// The early exit of the exact blend is kept. Once every pixel of a tile has
// stopped, no later instance is applied on any pixel: an instance is applied
// iff T * (1 - alpha) >= 1e-4 with T the pixel's transmittance over all
// eligible instances before it, T only falls, and 1 - alpha <= 1, so the
// test cannot hold again after it failed once. Every later instance has
// w = 0 and a count of 0, which is what the zeroed outputs already hold.
//
// Design: lg_blend_forward's block (one per 32x32 tile, 256 threads, 4
// pixels per thread, the tile's range staged in 128-aligned chunks through
// shared memory). Per instance each thread sums w and counts the hits of its
// own pixels; a warp that has a hit reduces both with shuffles (a butterfly
// for the float, so the order is fixed, and the integer reduce instruction
// for the count), and lane 0 leaves the warp's pair in shared memory. After
// the chunk, thread j adds the eight warps' pairs of instance j in warp
// order and issues one atomicAdd per output to the instance's Gaussian.
// Blocks run in any order, so the float sum of a Gaussian that lies in
// several tiles is taken in an order that changes from run to run; the
// integer sum is exact in any order.
//
// Bound on this card: operations, as for lg_blend_forward (chip_smoke.py
// counts the pairs by kind; an applied pair adds the sum and the count).
// Device memory sees the instances, their Gaussian ids, the outputs and at
// most two atomics per instance walked.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kPix = kTile * kTile;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPixPerThread = kPix / kThreads;
constexpr int kBatch = 128;
constexpr int kFeat = 9;  // mx, my, ca, cb, cc, r, g, b, opa
constexpr unsigned kFullMask = 0xffffffffu;

constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr float kMaxAlpha = 0.99f;

__global__ void __launch_bounds__(kThreads)
blend_count_kernel(const int* __restrict__ tile_starts,
                   const float* __restrict__ inst,
                   const long long* __restrict__ gid,  // [M] instance -> Gaussian
                   float* __restrict__ rgb_out,        // [T, 3, kPix]
                   float* __restrict__ t_out,          // [T, 1, kPix]
                   float* __restrict__ imp,            // [N], zeroed
                   int* __restrict__ cnt,              // [N], zeroed
                   int tiles_x, int width, int height) {
  __shared__ float feat[kBatch * kFeat];
  __shared__ float warp_w[kWarps][kBatch];
  __shared__ int warp_hits[kWarps][kBatch];

  const int tile = blockIdx.x;
  const int start = tile_starts[tile];
  const int end = tile_starts[tile + 1];
  const int ox = (tile % tiles_x) * kTile;
  const int oy = (tile / tiles_x) * kTile;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

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
      float w_sum = 0.0f;
      int hits = 0;
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        if (!live[k]) continue;
        const float dx = px[k] - mx;
        const float dy = py[k] - my;
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
        if (power > 0.0f) continue;
        const float alpha = fminf(kMaxAlpha, opa * expf(power));
        if (alpha < kAlphaEps) continue;
        const float test = T[k] * (1.0f - alpha);
        if (test < kTEps) {
          live[k] = false;
          continue;
        }
        const float w = alpha * T[k];
        cr[k] += w * r;
        cg[k] += w * g;
        cb_[k] += w * b;
        T[k] = test;
        w_sum += w;
        hits += w > 0.0f ? 1 : 0;
      }
      // every thread of the warp is here for every j: the walk is uniform
      if (__ballot_sync(kFullMask, hits > 0) != 0u) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) w_sum += __shfl_xor_sync(kFullMask, w_sum, off);
        hits = __reduce_add_sync(kFullMask, hits);
      }
      if (lane == 0) {
        warp_w[warp][j] = w_sum;
        warp_hits[warp][j] = hits;
      }
    }
    __syncthreads();

    if (threadIdx.x < n) {
      const int j = threadIdx.x;
      float w_sum = 0.0f;
      int hits = 0;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) {
        w_sum += warp_w[wp][j];
        hits += warp_hits[wp][j];
      }
      if (hits > 0) {
        const long long gauss = gid[lo + j];
        atomicAdd(imp + gauss, w_sum);
        atomicAdd(cnt + gauss, hits);
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

}  // namespace

extern "C" int lg_blend_count(const void* tile_starts, const void* inst,
                              const void* gid, void* rgb, void* t, void* imp,
                              void* cnt, int num_tiles, int tiles_x, int width,
                              int height, void* stream) {
  blend_count_kernel<<<num_tiles, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_starts), static_cast<const float*>(inst),
      static_cast<const long long*>(gid), static_cast<float*>(rgb),
      static_cast<float*>(t), static_cast<float*>(imp), static_cast<int*>(cnt),
      tiles_x, width, height);
  return static_cast<int>(cudaGetLastError());
}
