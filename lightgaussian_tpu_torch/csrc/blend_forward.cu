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
// Chunks start at multiples of 128, as the JAX kernels' do, and the block
// leaves after the first chunk at whose end no pixel is still blending
// (__syncthreads_count), so the render-only kernel stops its naive T where
// the JAX kernel does.
//
// Bound on this card: float32 instruction rate, not bytes (36 bytes read an instance
// for up to 1024 pixels). A warp pays for the longest branch any of its
// lanes takes, and two thirds of the pairs a tile's range holds are faint
// (alpha < 1/255) and change nothing. The TPU kernel, with vector masks and
// no branches, evaluates every pair; here the design is built around not
// running them (blend_tile.cuh has the geometry, the staging and the cull):
//   - one block per 32x32 tile, 256 threads; each warp owns a compact 16x8
//     rectangle of four 8x4 cells, one pixel of each a lane, so an instance
//     reaches few warps and, within one, few of the four k;
//   - while a chunk is staged, each instance gets the 32-bit set of cells
//     its alpha >= 1/255 level set can reach. A warp reads 32 of those words
//     at once, ballots the instances that reach its rectangle, and walks
//     only those, in order; per k one uniform bit test skips the cell. A
//     cell none of whose pixels is still blending (or in the image) is
//     dropped from the warp's set at the start of each chunk;
//   - the pairs that remain run the arithmetic of the plain version in its
//     order (expf, and the file is built with --fmad=false), so the outputs
//     equal those of a walk over every pair bit for bit;
//   - tiles' ranges differ in length (a dense middle of the frame, thin
//     edges), and a grid in index order ends on whatever tiles come last. The
//     entry points first sort the tiles by falling range length into the
//     `tile_order` scratch the wrapper passes (one small block, a counting
//     sort, blend_tile.cuh) and blocks take their tiles in that order, so the
//     longest start first and short ones fill the last wave.
// Nothing but the instances and the outputs touches device memory.
//
// lg_instance_cull is no blend: it writes, for every instance of the buffer,
// the cells and the level that stage_chunk gives it in its tile, so that the
// device's cull can be held against its plain twins
// (`blend.plain_instance_cull`). No product path calls it.

#include <cuda_runtime.h>

#include "blend_tile.cuh"

namespace {

using namespace lg;

template <bool EXACT>
__global__ void __launch_bounds__(kThreads)
blend_tile_kernel(const int* __restrict__ tile_starts,
                  const int* __restrict__ tile_order,  // [T] block -> tile
                  const float* __restrict__ inst,
                  float* __restrict__ rgb_out,  // [T, 3, kPix]
                  float* __restrict__ t_out,    // [T, 1, kPix]
                  int tiles_x, int width, int height) {
  __shared__ float4 rec[kBatch * kRecVecs];
  __shared__ unsigned cells[kBatch];

  const int tile = tile_order[blockIdx.x];
  const int start = tile_starts[tile];
  const int end = tile_starts[tile + 1];
  const int ox = (tile % tiles_x) * kTile;
  const int oy = (tile / tiles_x) * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float px[kPixPerThread], py[kPixPerThread], T[kPixPerThread];
  float cr[kPixPerThread], cg[kPixPerThread], cb_[kPixPerThread];
  bool in_image[kPixPerThread], live[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int x = ox + pixel_x(warp, lane, k);
    const int y = oy + pixel_y(warp, lane, k);
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
    // the previous chunk is no longer read: every thread passed the count below
    stage_chunk(inst, lo, n, static_cast<float>(ox), static_cast<float>(oy), rec, cells);
    __syncthreads();

    // the warp's cells that still have a pixel to blend
    unsigned bit[kPixPerThread], mine = 0u;
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) {
      bit[k] = __any_sync(kFullMask, EXACT ? live[k] : in_image[k]) ? cell_bit(warp, k) : 0u;
      mine |= bit[k];
    }

    for (int g0 = 0; g0 < n; g0 += 32) {
      unsigned todo = __ballot_sync(kFullMask, (cells[g0 + lane] & mine) != 0u);
      while (todo) {
        const int j = g0 + __ffs(todo) - 1;
        todo &= todo - 1u;
        const unsigned reach = cells[j];
        const Instance f = read_instance(rec, j);
#pragma unroll
        for (int k = 0; k < kPixPerThread; ++k) {
          if (!(reach & bit[k])) continue;  // the whole warp
          if (EXACT ? !live[k] : !in_image[k]) continue;
          const float dx = px[k] - f.mx;
          const float dy = py[k] - f.my;
          const float power = f.ha * dx * dx + f.hc * dy * dy - f.cb * dx * dy;
          if (power > 0.0f || power < f.min_power) continue;  // min_power: alpha < 1/255 for sure
          const float alpha = fminf(kMaxAlpha, f.opa * expf(power));
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
          cr[k] += w * f.r;
          cg[k] += w * f.g;
          cb_[k] += w * f.b;
          T[k] = test;
        }
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
    const int p = pixel_y(warp, lane, k) * kTile + pixel_x(warp, lane, k);
    rgb[p] = cr[k];
    rgb[kPix + p] = cg[k];
    rgb[2 * kPix + p] = cb_[k];
    t[p] = in_image[k] ? T[k] : 1.0f;
  }
}

template <bool EXACT>
int launch(const void* tile_starts, void* tile_order, const void* inst, void* rgb, void* t,
           int num_tiles, int tiles_x, int width, int height, void* stream) {
  int* order = order_tiles(tile_starts, tile_order, num_tiles, stream);
  blend_tile_kernel<EXACT><<<num_tiles, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_starts), order,
      static_cast<const float*>(inst), static_cast<float*>(rgb), static_cast<float*>(t),
      tiles_x, width, height);
  return static_cast<int>(cudaGetLastError());
}

// One thread an instance: its tile by bisection of tile_starts, then the
// cells and the level as stage_chunk computes them.
__global__ void instance_cull_kernel(const int* __restrict__ tile_starts,
                                     const float* __restrict__ inst,
                                     unsigned* __restrict__ cells_out,  // [M]
                                     float* __restrict__ level_out,     // [M]
                                     int num_instances, int num_tiles, int tiles_x) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_instances) return;
  const float* f = inst + static_cast<size_t>(i) * kFeat;
  const float level0 = cull_level(f[8]);
  level_out[i] = level0;
  if (i >= tile_starts[num_tiles]) {  // a row past the last tile's range
    cells_out[i] = 0u;
    return;
  }
  int lo = 0, hi = num_tiles - 1;  // the last tile whose start is <= i
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tile_starts[mid] <= i) lo = mid; else hi = mid - 1;
  }
  const float ox = static_cast<float>((lo % tiles_x) * kTile);
  const float oy = static_cast<float>((lo / tiles_x) * kTile);
  cells_out[i] = cull_cells(f[0], f[1], f[2], f[3], f[4], f[8], level0, ox, oy);
}

}  // namespace

extern "C" int lg_instance_cull(const void* tile_starts, const void* inst, void* cells,
                                void* level, int num_instances, int num_tiles, int tiles_x,
                                void* stream) {
  if (num_instances > 0)
    instance_cull_kernel<<<(num_instances + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(tile_starts), static_cast<const float*>(inst),
        static_cast<unsigned*>(cells), static_cast<float*>(level), num_instances, num_tiles,
        tiles_x);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lg_blend_forward(const void* tile_starts, void* tile_order, const void* inst,
                                void* rgb, void* t, int num_tiles, int tiles_x,
                                int width, int height, void* stream) {
  return launch<true>(tile_starts, tile_order, inst, rgb, t, num_tiles, tiles_x, width,
                      height, stream);
}

extern "C" int lg_blend_forward_fast(const void* tile_starts, void* tile_order,
                                     const void* inst, void* rgb, void* t, int num_tiles,
                                     int tiles_x, int width, int height, void* stream) {
  return launch<false>(tile_starts, tile_order, inst, rgb, t, num_tiles, tiles_x, width,
                       height, stream);
}
