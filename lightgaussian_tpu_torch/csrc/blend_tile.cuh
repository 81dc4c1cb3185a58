// What the tile blend kernels of blend_forward.cu and blend_backward.cu
// share: the tile's geometry, the staging of a chunk of instances into
// shared memory, and the cull that lets a warp skip an instance.
//
// Geometry. A block of 256 threads blends one 32x32 tile. The tile is cut
// into 32 cells of 8x4 pixels, 4 columns by 8 rows, cell (row, col) being
// bit row * 4 + col of a 32-bit word. A warp owns a compact 16x8 rectangle:
// 2x2 cells, one pixel of each a lane (k = 0..3), lane l at (l % 8, l / 8) of
// the cell. So an instance that covers a small part of the tile touches few
// warps, and within a warp few k; a warp's 32 pixels at one k are four rows
// of 32 contiguous bytes in the [1024]-pixel planes, whole sectors.
//
// Staging. The instance buffer holds 9 floats an instance (mx, my, ca, cb,
// cc, r, g, b, opa). Thread j of the first 128 reads instance j of the chunk
// and leaves it as three float4 (mx, my, -ca/2, -cc/2 | cb, opa, r, g | b,
// min_power), so a walking thread reads it with three broadcast loads. Halving
// the conic here is exact, and the power -ca/2 dx dx + -cc/2 dy dy - cb dx dy
// rounds as -0.5 (ca dx dx + cc dy dy) - cb dx dy does, with one multiply
// fewer a pair.
//
// Cull. The same thread computes the instance's cells: a pixel is eligible
// only if alpha = opa exp(power) >= 1/255, that is power >= -log(255 opa),
// and the conic bounds that level set by a rectangle of half-widths
// sqrt(2 L cc / det) and sqrt(2 L ca / det) around the mean. L is raised by
// the rounding the kernels' float32 power can carry over this tile (the
// terms' magnitudes at the tile's farthest pixel times 1e-6) and by 0.01 for
// exp and log; the half-widths grow by 0.1% and one pixel. An instance whose
// level set cannot be boxed (opacity at or under 1/255, a conic that is not
// positive definite or is within 1e-3 of singular, a half-width that is not
// finite) keeps every cell. A pair outside the rectangle fails the kernels'
// own alpha test, so skipping it changes no output. Inside the rectangle the
// same level spares a faint pair its exp: a power under min_power =
// -(log(255 opa) (1 + 1e-4) + 0.01) cannot reach alpha >= 1/255, and where a
// cell's 32 pairs are all that faint the warp goes on after the power. The
// plain twins are `plain_cull_rect` and `plain_cull_level` of
// ops/rasterize/blend.py.

#pragma once

#include <cuda_runtime.h>

namespace lg {

constexpr int kTile = 32;
constexpr int kPix = kTile * kTile;
constexpr int kThreads = 256;
constexpr int kPixPerThread = kPix / kThreads;  // one pixel in each of the warp's four cells
constexpr int kBatch = 128;
constexpr int kFeat = 9;  // mx, my, ca, cb, cc, r, g, b, opa
constexpr int kRecVecs = 3;  // float4 a staged instance
constexpr int kCellW = 8, kCellH = 4;
constexpr int kCellCols = kTile / kCellW;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned kAllCells = 0xffffffffu;

constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr float kMaxAlpha = 0.99f;

// The cull's margins (plain_cull_rect holds the same numbers).
constexpr float kCullMinDet = 1e-3f;      // det / (ca cc) under which the conic counts as singular
constexpr float kCullLevelRel = 1e-4f;    // on log(255 opa)
constexpr float kCullLevelAbs = 0.01f;
constexpr float kCullRounding = 1e-6f;    // times (ca + cc + 2 |cb|) far^2
constexpr float kCullWidthRel = 1.001f;
constexpr float kCullWidthAbs = 1.0f;     // pixels
constexpr float kCullMaxWidth = 1e6f;

// A staged instance, as the walk reads it. A pair whose power is under
// min_power has alpha < 1/255 whatever exp returns.
struct Instance {
  float mx, my, ha, hc, cb, opa, r, g, b, min_power;  // ha = -ca / 2, hc = -cc / 2
};

__device__ __forceinline__ Instance read_instance(const float4* rec, int j) {
  const float4 q0 = rec[kRecVecs * j], q1 = rec[kRecVecs * j + 1], q2 = rec[kRecVecs * j + 2];
  return {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x, q2.y};
}

// The pixel of lane `lane` of warp `warp` at k, tile-local.
__device__ __forceinline__ int cell_col(int warp, int k) { return (warp & 1) * 2 + (k & 1); }
__device__ __forceinline__ int cell_row(int warp, int k) { return (warp >> 1) * 2 + (k >> 1); }
__device__ __forceinline__ unsigned cell_bit(int warp, int k) {
  return 1u << (cell_row(warp, k) * kCellCols + cell_col(warp, k));
}
__device__ __forceinline__ int pixel_x(int warp, int lane, int k) {
  return cell_col(warp, k) * kCellW + (lane & (kCellW - 1));
}
__device__ __forceinline__ int pixel_y(int warp, int lane, int k) {
  return cell_row(warp, k) * kCellH + lane / kCellW;
}

// log(255 opa) with the margin for exp and log: no pair of the instance with
// a power under minus this is eligible.
__device__ __forceinline__ float cull_level(float opa) {
  return logf(255.0f * opa) * (1.0f + kCullLevelRel) + kCullLevelAbs;
}

// The cells of the tile at (ox, oy) in which the instance can have an
// eligible pixel; `level0` is its cull_level.
__device__ __forceinline__ unsigned cull_cells(float mx, float my, float ca, float cb, float cc,
                                               float opa, float level0, float ox, float oy) {
  const float det = ca * cc - cb * cb;
  if (!(opa > kAlphaEps && ca > 0.0f && cc > 0.0f && det > kCullMinDet * (ca * cc))) return kAllCells;
  const float far_x = fmaxf(fabsf(ox - mx), fabsf(ox + (kTile - 1) - mx));
  const float far_y = fmaxf(fabsf(oy - my), fabsf(oy + (kTile - 1) - my));
  const float far = fmaxf(far_x, far_y);
  const float level = level0 + kCullRounding * (ca + cc + 2.0f * fabsf(cb)) * (far * far);
  const float k2 = 2.0f * level / det;
  const float hx = sqrtf(k2 * cc) * kCullWidthRel + kCullWidthAbs;
  const float hy = sqrtf(k2 * ca) * kCullWidthRel + kCullWidthAbs;
  if (!(hx < kCullMaxWidth && hy < kCullMaxWidth)) return kAllCells;
  const float x_lo = mx - hx - ox, x_hi = mx + hx - ox;
  const float y_lo = my - hy - oy, y_hi = my + hy - oy;
  const float last = static_cast<float>(kTile - 1);
  if (!(x_hi >= 0.0f && x_lo <= last && y_hi >= 0.0f && y_lo <= last)) return 0u;
  // the pixels x_lo <= x <= x_hi: from ceil(x_lo) to floor(x_hi)
  const int c0 = static_cast<int>(ceilf(fmaxf(x_lo, 0.0f))) / kCellW;
  const int c1 = static_cast<int>(fminf(x_hi, last)) / kCellW;
  const int r0 = static_cast<int>(ceilf(fmaxf(y_lo, 0.0f))) / kCellH;
  const int r1 = static_cast<int>(fminf(y_hi, last)) / kCellH;
  const unsigned cols = (2u << c1) - (1u << c0);  // bits c0..c1 of a row's four
  const unsigned upto = r1 == kTile / kCellH - 1 ? kAllCells : (1u << (kCellCols * (r1 + 1))) - 1u;
  const unsigned rows = upto & ~((1u << (kCellCols * r0)) - 1u);
  return (cols * 0x11111111u) & rows;
}

// Stage instances [lo, lo + n) of the buffer, n <= kBatch, and their cells;
// cells past n are empty. The caller synchronises around it.
__device__ __forceinline__ void stage_chunk(const float* __restrict__ inst, int lo, int n,
                                            float ox, float oy, float4* rec, unsigned* cells) {
  const int j = threadIdx.x;
  if (j >= kBatch) return;
  if (j >= n) {
    cells[j] = 0u;
    return;
  }
  const float* f = inst + static_cast<size_t>(lo + j) * kFeat;
  const float mx = __ldg(f + 0), my = __ldg(f + 1);
  const float ca = __ldg(f + 2), cb = __ldg(f + 3), cc = __ldg(f + 4);
  const float r = __ldg(f + 5), g = __ldg(f + 6), b = __ldg(f + 7);
  const float opa = __ldg(f + 8);
  rec[kRecVecs * j] = make_float4(mx, my, -0.5f * ca, -0.5f * cc);
  rec[kRecVecs * j + 1] = make_float4(cb, opa, r, g);
  const float level0 = cull_level(opa);
  rec[kRecVecs * j + 2] = make_float4(b, -level0, 0.0f, 0.0f);
  cells[j] = cull_cells(mx, my, ca, cb, cc, opa, level0, ox, oy);
}

// The tiles by falling range length, to a granularity of kOrderStep
// instances: a counting sort in one block. Blocks that take their tiles in
// this order start the longest first, so the last wave is made of short ones.
// Tiles of one bucket land in the order of their atomics.
constexpr int kOrderThreads = 1024;  // one bucket a thread
constexpr int kOrderStep = 4;

__device__ __forceinline__ int order_bucket(const int* __restrict__ tile_starts, int t) {
  return min((tile_starts[t + 1] - tile_starts[t]) / kOrderStep, kOrderThreads - 1);
}

__global__ void __launch_bounds__(kOrderThreads)
tile_order_kernel(const int* __restrict__ tile_starts, int* __restrict__ order, int num_tiles) {
  __shared__ int place[kOrderThreads];  // a bucket's count, then its next free place
  __shared__ int warp_total[32];
  const int b = threadIdx.x, lane = b & 31, warp = b >> 5;
  place[b] = 0;
  __syncthreads();
  for (int t = b; t < num_tiles; t += kOrderThreads) atomicAdd(&place[order_bucket(tile_starts, t)], 1);
  __syncthreads();
  // thread b takes the b-th longest bucket: the tiles before it, by a block scan
  const int mine = place[kOrderThreads - 1 - b];
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int below = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += below;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_total[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int below = __shfl_up_sync(kFullMask, w, off);
      if (lane >= off) w += below;
    }
    warp_total[lane] = w;
  }
  __syncthreads();
  place[kOrderThreads - 1 - b] = incl - mine + (warp ? warp_total[warp - 1] : 0);
  __syncthreads();
  for (int t = b; t < num_tiles; t += kOrderThreads)
    order[atomicAdd(&place[order_bucket(tile_starts, t)], 1)] = t;
}

// Fill `tile_order` (int32 [num_tiles] scratch) on `stream`; returns what the
// blend kernel takes as its block -> tile map.
inline int* order_tiles(const void* tile_starts, void* tile_order, int num_tiles, void* stream) {
  int* order = static_cast<int*>(tile_order);
  tile_order_kernel<<<1, kOrderThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_starts), order, num_tiles);
  return order;
}

}  // namespace lg
