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
// Bound on this card: float32 instruction rate. An applied pair costs about 60
// float32 instructions, a division and an exp; a faint pair a third of
// that for nothing; and every (instance, warp) that applied a pixel has
// nine sums to bring together over its lanes, where a shuffle runs at a
// quarter of the float32 rate. The TPU kernel reduces along vector lanes
// for free and walks every pair; here:
//   - geometry, staging and cull are the forward's (blend_tile.cuh): each
//     warp owns a compact 16x8 rectangle, ballots the instances whose
//     alpha >= 1/255 level set reaches it and walks only those, skipping
//     per k the 8x4 cells the set does not reach or where no pixel blends;
//   - a warp reduces only where one of its lanes applied the instance, and
//     all nine sums together: a transposing butterfly (at each step a lane
//     keeps half of its values and hands the other half to its partner)
//     takes 12 shuffles where nine separate butterflies take 45. Lanes 0,
//     4, .., 28 end with sums 0..7 and lane 2 with the ninth, and add them
//     to the instance's row of shared memory with shared-memory atomics.
//     The row is 9 floats an instance (4.6 KB a block instead of a row a
//     warp, 36.9 KB), nothing is stored for a warp without a hit, and
//     shared memory no longer limits the blocks an SM holds;
//   - after the chunk, thread j turns the row of instance j into the nine
//     gradients and adds them to its Gaussian's row with atomicAdd (rows
//     left at zero are skipped). Atomics and not per-instance rows reduced
//     outside: one kernel, and 27 MB per view at 1920x1080 neither written
//     nor read again, against atomics that rarely collide (a Gaussian's
//     instances lie in different tiles). The price is a sum order that
//     varies from run to run, so kernel and plain version are held at the
//     normalised tolerance of chip_smoke.py, not the CPU's 5e-5.
//   - blocks take the tiles longest range first, as the forward's do (the
//     entry point sorts them into the `tile_order` scratch it is given), and
//     the kernel is held to 64 registers a thread (a few words spilt) so an
//     SM holds four blocks: registers, not shared memory, set the occupancy.
// The pairs that remain run the arithmetic of the plain version: expf and
// IEEE division, and the file is built with --fmad=false.

#include <cuda_runtime.h>

#include "blend_tile.cuh"

namespace {

using namespace lg;

// Registers are what limits the blocks an SM holds: four (64 registers a
// thread, a few words spilt) beat the three the compiler would settle for.
constexpr int kBlocksPerSM = 4;

// The nine per-instance sums over a tile's pixels.
enum { kS0, kSx, kSy, kSxx, kSxy, kSyy, kSr, kSg, kSb, kSums };

// Sums s[0..8] over the warp. Returns, in lanes 0, 4, .., 28, the sum of
// s[lane / 4] and, in lane 2, the sum of s[8]; `q` is the index of the sum
// the lane holds, or -1.
__device__ __forceinline__ float reduce_sums(const float (&s)[kSums], int lane, int& q) {
  const bool u16 = lane & 16, u8 = lane & 8, u4 = lane & 4, u2 = lane & 2;
  float a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)  // the upper half-warp keeps s[4..7], the lower s[0..3]
    a[i] = (u16 ? s[i + 4] : s[i]) + __shfl_xor_sync(kFullMask, u16 ? s[i] : s[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    b[i] = (u8 ? a[i + 2] : a[i]) + __shfl_xor_sync(kFullMask, u8 ? a[i] : a[i + 2], 8);
  const float c = (u4 ? b[1] : b[0]) + __shfl_xor_sync(kFullMask, u4 ? b[0] : b[1], 4);
  float t = s[8];  // the ninth, whole, down to the lanes that share their low two bits
  t += __shfl_xor_sync(kFullMask, t, 16);
  t += __shfl_xor_sync(kFullMask, t, 8);
  t += __shfl_xor_sync(kFullMask, t, 4);
  float d = (u2 ? t : c) + __shfl_xor_sync(kFullMask, u2 ? c : t, 2);
  d += __shfl_xor_sync(kFullMask, d, 1);
  q = (lane & 3) == 0 ? lane >> 2 : (lane == 2 ? 8 : -1);
  return d;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
blend_backward_kernel(const int* __restrict__ tile_starts,
                      const int* __restrict__ tile_order,  // [T] block -> tile
                      const float* __restrict__ inst,
                      const long long* __restrict__ gid,
                      const float* __restrict__ tile_g,  // [T, 3, kPix]
                      const float* __restrict__ tile_r,  // [T, 1, kPix]
                      float* __restrict__ grads,         // [N, kFeat], zeroed
                      int tiles_x, int width, int height) {
  __shared__ float4 rec[kBatch * kRecVecs];
  __shared__ unsigned cells[kBatch];
  __shared__ float acc[kBatch * kSums];  // the chunk's sums, zero between chunks

  const int tile = tile_order[blockIdx.x];
  const int start = tile_starts[tile];
  const int end = tile_starts[tile + 1];
  const int ox = (tile % tiles_x) * kTile;
  const int oy = (tile / tiles_x) * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float px[kPixPerThread], py[kPixPerThread], T[kPixPerThread], r[kPixPerThread];
  float gr[kPixPerThread], gg[kPixPerThread], gb[kPixPerThread];
  bool live[kPixPerThread];
  const float* g = tile_g + static_cast<size_t>(tile) * 3 * kPix;
  const float* r0 = tile_r + static_cast<size_t>(tile) * kPix;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int lx = pixel_x(warp, lane, k), ly = pixel_y(warp, lane, k);
    const int p = ly * kTile + lx;
    px[k] = static_cast<float>(ox + lx);
    py[k] = static_cast<float>(oy + ly);
    live[k] = ox + lx < width && oy + ly < height;
    T[k] = 1.0f;
    r[k] = r0[p];
    gr[k] = g[p];
    gg[k] = g[kPix + p];
    gb[k] = g[2 * kPix + p];
  }
  for (int i = threadIdx.x; i < kBatch * kSums; i += kThreads) acc[i] = 0.0f;

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
      bit[k] = __any_sync(kFullMask, live[k]) ? cell_bit(warp, k) : 0u;
      mine |= bit[k];
    }

    for (int g0 = 0; g0 < n; g0 += 32) {
      unsigned todo = __ballot_sync(kFullMask, (cells[g0 + lane] & mine) != 0u);
      while (todo) {
        const int j = g0 + __ffs(todo) - 1;
        todo &= todo - 1u;
        const unsigned reach = cells[j];
        const Instance f = read_instance(rec, j);
        float s[kSums];
#pragma unroll
        for (int q = 0; q < kSums; ++q) s[q] = 0.0f;
        bool hit = false;
#pragma unroll
        for (int k = 0; k < kPixPerThread; ++k) {
          if (!(reach & bit[k])) continue;  // the whole warp
          if (!live[k]) continue;
          const float dx = px[k] - f.mx;
          const float dy = py[k] - f.my;
          const float power = f.ha * dx * dx + f.hc * dy * dy - f.cb * dx * dy;
          if (power > 0.0f || power < f.min_power) continue;  // min_power: alpha < 1/255 for sure
          const float alpha_raw = f.opa * expf(power);
          const float alpha = fminf(kMaxAlpha, alpha_raw);
          if (alpha < kAlphaEps) continue;
          const float one_minus = 1.0f - alpha;
          const float test = T[k] * one_minus;
          if (test < kTEps) {  // ends the pixel's blend: no gradient from here on
            live[k] = false;
            continue;
          }
          const float cw = f.r * gr[k] + f.g * gg[k] + f.b * gb[k];
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
        if (__any_sync(kFullMask, hit)) {
          int q;
          const float v = reduce_sums(s, lane, q);
          if (q >= 0) atomicAdd(&acc[j * kSums + q], v);
        }
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < n; i += kThreads) {
      float a[kSums];
      bool any = false;
#pragma unroll
      for (int q = 0; q < kSums; ++q) {
        a[q] = acc[i * kSums + q];
        any |= a[q] != 0.0f;
      }
      if (!any) continue;
#pragma unroll
      for (int q = 0; q < kSums; ++q) acc[i * kSums + q] = 0.0f;
      const float4 q0 = rec[kRecVecs * i], q1 = rec[kRecVecs * i + 1];
      const float ca = -2.0f * q0.z, cc = -2.0f * q0.w, cb = q1.x, opa = q1.y;
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

extern "C" int lg_blend_backward(const void* tile_starts, void* tile_order, const void* inst,
                                 const void* gid, const void* tile_g,
                                 const void* tile_r, void* grads, int num_tiles,
                                 int tiles_x, int width, int height,
                                 void* stream) {
  int* order = order_tiles(tile_starts, tile_order, num_tiles, stream);
  blend_backward_kernel<<<num_tiles, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_starts), order,
      static_cast<const float*>(inst),
      static_cast<const long long*>(gid), static_cast<const float*>(tile_g),
      static_cast<const float*>(tile_r), static_cast<float*>(grads), tiles_x,
      width, height);
  return static_cast<int>(cudaGetLastError());
}
