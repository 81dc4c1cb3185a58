// Binning's tile cover and instance emission for Hopper (sm_90a).
//
// Entry points (plain C interface, loaded with ctypes by
// lightgaussian_tpu_torch/utils/cuda_build.py for
// lightgaussian_tpu_torch/ops/rasterize/binning.py):
//   lg_bin_cover  piece (a) of `bin_splats`: `tile_rect` with the conic and
//                 opacity, then `_exact_tile_mask`: each Gaussian's tile
//                 rectangle, its exact ellipse-vs-tile mask and its instance
//                 count, in one pass.
//   lg_bin_emit   pieces (c) and (d): each instance's slot, tile and 32-bit
//                 (tile | depth) sort key, written with its Gaussian id
//                 straight into the slot (`plain_emit`: `_fill_slots` +
//                 `_depth_key`).
// They replace no Pallas kernel: the JAX package computes the same cover,
// slots and keys with XLA ops (lightgaussian_tpu/ops/rasterize/binning.py),
// and the port first ran them as chains of torch ops over [N, 32] and
// int64 [M] temporaries.
//
// The cover. Bound on this card: bytes. A Gaussian reads its mean (8 B),
// conic (12 B), opacity (4 B) and radius (4 B) once and writes five int64
// (40 B): 68 B, or 0.061 ms at 3 M Gaussians and 3.35 TB/s. One thread takes
// one Gaussian, walks the row-major slots of its rect (at most 32, else the
// rect count stands and the mask is 0) in registers and writes each output
// once, as structure of arrays: nothing else touches device memory. Its time
// goes to the slots' arithmetic, four edge minima a slot with an IEEE
// division in each: the walk takes a row's divisions once and skips the
// edges of the box that holds the mean.
//
// The cover's outputs equal the torch chain's bit for bit on the card. Each
// float operation is the chain's, in its order, rounded as it rounds (the
// library is built with --fmad=false, IEEE division and square root, the
// accurate logf, which is torch.log's on the card): a tensor divided by a
// Python float is a multiply by the float's reciprocal, taken in double and
// rounded to float32, as PyTorch's CUDA division by a scalar does (for 1/255
// that is 255, not 1 / float32(1/255)); torch.minimum, maximum and clamp
// keep a NaN, and a float is cast to int64 by truncation, as
// `.to(torch.int64)` does.
//
// The emission. Gaussian i owns slots [cum[i] - count[i], cum[i]) of the
// frame's instances, those below the cut m: the chain's own slot order,
// which the stable sort after it keeps for equal keys. Its k-th slot lies on
// the k-th set bit of the cover's mask (count <= 32), found by a search over
// the mask's halves with __popc in registers, or on the rect's row-major
// slot k on the >32-tile fallback (mask 0). The key is `_depth_key`'s:
// (tile << depth_bits) | ((depth - least) >> shift), with `least` and
// `shift` from the least and greatest int32 bit pattern of the depths of the
// Gaussians that own a slot below m. That range is the first of the entry
// point's two launches: each block of a short grid reduces a strided share
// of the Gaussians and writes its pair, and each block of the emission
// reduces the pairs again before it starts. The key is below 2^32 by
// construction (`sort_key_bits`) and is stored as an int32 with its top bit
// flipped, so that a signed sort orders it as the unsigned key. All of it is
// integer work, so the outputs equal the chain's bit for bit.
//
// Bound: bytes. A Gaussian's cover (40 B), prefix sum (8 B) and depth (4 B)
// are read once, and a slot writes a 4 B key and an 8 B id: at 4K (6.1 M
// Gaussians, 29-30 M slots) 317 + 354 MB, or 0.20 ms at 3.35 TB/s. Load
// balance: at 4K, 56% of the slots come from the fallback, and a rect can
// span thousands of tiles, so a thread a Gaussian would leave one thread
// writing thousands of slots. Instead a warp takes 32 consecutive Gaussians,
// whose slots are one contiguous range, and walks that range 32 slots at a
// time: each lane finds its slot's Gaussian among the warp's 32 by a
// five-step search over their prefix sums (shuffles), then computes its tile
// and key. Every store is coalesced, a warp's time follows its slots and not
// its largest Gaussian's, and a large rect costs one pass of the warp per 32
// of its tiles.

#include <algorithm>
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;         // binning.TILE_SIZE
constexpr int kMaxMaskTiles = 32;  // binning.MAX_MASK_TILES
constexpr float kMarginPx = 0.25f;  // binning._MASK_MARGIN_PX
constexpr double kAlphaEps = 1.0 / 255.0;  // projection.ALPHA_EPS

// torch.minimum / torch.maximum on CUDA: a NaN operand gives NaN.
__device__ __forceinline__ float t_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

__device__ __forceinline__ float t_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

// torch.clamp(v, min=lo): NaN stays NaN.
__device__ __forceinline__ float t_clamp_min(float v, float lo) {
  return (v != v) ? v : fmaxf(v, lo);
}

// `edge` of `tile_rect`: torch.clamp(v, 0, lim).to(torch.int64).
__device__ __forceinline__ long long edge(float v, int lim) {
  const float c = (v != v) ? v : fminf(fmaxf(v, 0.0f), static_cast<float>(lim));
  return static_cast<long long>(c);
}

// q(dx, dy) = ca dx^2 + 2 cb dx dy + cc dy^2 in the chain's order.
__device__ __forceinline__ float quad(float dx, float dy, float ca, float cb, float cc) {
  return (ca * dx + (cb * 2.0f) * dy) * dx + (cc * dy) * dy;
}

__global__ void __launch_bounds__(kThreads)
bin_cover_kernel(const float* __restrict__ mean2d, const float* __restrict__ conic,
                 const float* __restrict__ opacity, const int* __restrict__ radius,
                 long long* __restrict__ lo_x_out, long long* __restrict__ lo_y_out,
                 long long* __restrict__ hi_x_out, long long* __restrict__ mask_out,
                 long long* __restrict__ count_out, int n, int mean_stride, int conic_stride,
                 int opacity_stride, int radius_stride, int tiles_x, int tiles_y) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const float mx = mean2d[static_cast<long long>(g) * mean_stride];
  const float my = mean2d[static_cast<long long>(g) * mean_stride + 1];
  const float ca = conic[static_cast<long long>(g) * conic_stride];
  const float cb = conic[static_cast<long long>(g) * conic_stride + 1];
  const float cc = conic[static_cast<long long>(g) * conic_stride + 2];
  const float opa = opacity[static_cast<long long>(g) * opacity_stride];
  const int rad = radius[static_cast<long long>(g) * radius_stride];

  // tile_rect, tightened by the conic and the opacity.
  const float inv_alpha_eps = static_cast<float>(1.0 / kAlphaEps);
  const float r = static_cast<float>(rad);
  const float det = t_clamp_min(ca * cc - cb * cb, 1e-12f);
  const float q_raw = 2.0f * logf(t_clamp_min(opa, 1e-12f) * inv_alpha_eps);
  const bool alive = rad > 0 && q_raw > 0.0f;
  const float q_max = t_clamp_min(q_raw, 0.0f);
  const float rx = t_min(r, sqrtf((q_max * cc) / det) + 1.0f);
  const float ry = t_min(r, sqrtf((q_max * ca) / det) + 1.0f);
  const float inv_tile = static_cast<float>(1.0 / kTile);
  const long long lo_x = edge(floorf((mx - rx) * inv_tile), tiles_x);
  const long long hi_x = edge(floorf((mx + rx) * inv_tile) + 1.0f, tiles_x);
  const long long lo_y = edge(floorf((my - ry) * inv_tile), tiles_y);
  const long long hi_y = edge(floorf((my + ry) * inv_tile) + 1.0f, tiles_y);
  const long long w_rect = hi_x - lo_x > 0 ? hi_x - lo_x : 0;
  const long long h_rect = hi_y - lo_y > 0 ? hi_y - lo_y : 0;
  const long long rect_count = alive ? w_rect * h_rect : 0;

  // _exact_tile_mask over the rect's row-major slots, against the unclamped q.
  // A slot's tile box [x0, x1] x [y0, y1] keeps the splat iff the least q
  // over its four edges (`edge_x` at x0 and x1, `edge_y` at y0 and y1, each
  // the other coordinate clamped to the box) is at most q, or the mean lies
  // in the box (q_min 0). The terms of `edge_y` that depend on the row alone
  // are taken once a row; the box holding the mean skips the edges.
  long long count = rect_count;
  unsigned int mask = 0u;
  if (rect_count > 0 && rect_count <= kMaxMaskTiles) {
    const int w = static_cast<int>(w_rect);
    const int h = static_cast<int>(h_rect);
    const float ts = static_cast<float>(kTile);
    const float span = ts - 1.0f + 2.0f * kMarginPx;
    const float ca_c = t_clamp_min(ca, 1e-12f);
    const float cc_c = t_clamp_min(cc, 1e-12f);
    int kept = 0;
    for (int row = 0; row < h; ++row) {
      const float y0 = static_cast<float>(lo_y + row) * ts - kMarginPx;
      const float y1 = y0 + span;
      const float dy0 = y0 - my;
      const float dy1 = y1 - my;
      const float sx0 = (-cb * dy0) / ca_c;  // edge_y's unclamped dx at y0, y1
      const float sx1 = (-cb * dy1) / ca_c;
      for (int col = 0; col < w; ++col) {
        const float x0 = static_cast<float>(lo_x + col) * ts - kMarginPx;
        const float x1 = x0 + span;
        float q_min = 0.0f;
        if (!(mx >= x0 && mx <= x1 && my >= y0 && my <= y1)) {
          const float dx0 = x0 - mx;
          const float dx1 = x1 - mx;
          const float e_x0 = quad(dx0, t_min(t_max((-cb * dx0) / cc_c, dy0), dy1), ca, cb, cc);
          const float e_x1 = quad(dx1, t_min(t_max((-cb * dx1) / cc_c, dy0), dy1), ca, cb, cc);
          const float e_y0 = quad(t_min(t_max(sx0, dx0), dx1), dy0, ca, cb, cc);
          const float e_y1 = quad(t_min(t_max(sx1, dx0), dx1), dy1, ca, cb, cc);
          q_min = t_min(t_min(e_x0, e_x1), t_min(e_y0, e_y1));
        }
        if (q_min <= q_raw) {
          mask |= 1u << (row * w + col);
          ++kept;
        }
      }
    }
    count = kept;
  }
  lo_x_out[g] = lo_x;
  lo_y_out[g] = lo_y;
  hi_x_out[g] = hi_x;
  mask_out[g] = static_cast<long long>(mask);
  count_out[g] = count;
}

// ---- the instance emission ----

constexpr int kRangeThreads = 512;
constexpr int kEmitThreads = 256;
constexpr unsigned int kFull = 0xffffffffu;

// The least and greatest of a warp's (lo, hi), in every lane.
__device__ __forceinline__ void warp_range(int& lo, int& hi) {
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, off));
    hi = max(hi, __shfl_xor_sync(kFull, hi, off));
  }
}

// Pass 1: each block's least and greatest depth bit pattern over the
// Gaussians that own a slot below m (INT_MAX, INT_MIN where it has none).
__global__ void __launch_bounds__(kRangeThreads)
bin_depth_range_kernel(const long long* __restrict__ count, const long long* __restrict__ cum,
                       const int* __restrict__ depth, int depth_stride, int n, int m,
                       int* __restrict__ partials) {
  int lo = INT_MAX, hi = INT_MIN;
  const long long stride = static_cast<long long>(gridDim.x) * kRangeThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kRangeThreads + threadIdx.x; i < n; i += stride) {
    const long long c = count[i];
    if (c > 0 && cum[i] - c < m) {
      const int d = depth[i * depth_stride];
      lo = min(lo, d);
      hi = max(hi, d);
    }
  }
  warp_range(lo, hi);
  __shared__ int s_lo[kRangeThreads / 32], s_hi[kRangeThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = lane < kRangeThreads / 32 ? s_lo[lane] : INT_MAX;
    hi = lane < kRangeThreads / 32 ? s_hi[lane] : INT_MIN;
    warp_range(lo, hi);
    if (lane == 0) {
      partials[2 * blockIdx.x] = lo;
      partials[2 * blockIdx.x + 1] = hi;
    }
  }
}

// `_kth_set_bit`: the index of the (k+1)-th set bit of mask, k < popcount.
__device__ __forceinline__ int kth_set_bit(unsigned int mask, int k) {
  int base = 0;
  for (int w = 16; w >= 1; w >>= 1) {
    const unsigned int low = mask & ((1u << w) - 1u);
    const int c = __popc(low);
    if (k >= c) {
      mask >>= w;
      k -= c;
      base += w;
    } else {
      mask = low;
    }
  }
  return base;
}

// Pass 2: a warp a run of 32 Gaussians, emitting their slots below m.
__global__ void __launch_bounds__(kEmitThreads)
bin_emit_kernel(const long long* __restrict__ lo_x, const long long* __restrict__ lo_y,
                const long long* __restrict__ hi_x, const long long* __restrict__ mask,
                const long long* __restrict__ count, const long long* __restrict__ cum,
                const int* __restrict__ depth, int* __restrict__ key_out, long long* __restrict__ gid_out,
                const int* __restrict__ partials, int range_blocks, int n, int m, int depth_stride,
                int tiles_x, int depth_bits) {
  __shared__ int s_range[2];
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int b = lane; b < range_blocks; b += 32) {
      lo = min(lo, partials[2 * b]);
      hi = max(hi, partials[2 * b + 1]);
    }
    warp_range(lo, hi);
    if (lane == 0) {
      s_range[0] = lo;
      s_range[1] = hi;
    }
  }
  __syncthreads();
  // `_depth_key`'s quantization: the range's bit length beyond depth_bits.
  const long long least = s_range[0];
  const long long widest = static_cast<long long>(s_range[1]) - least;
  const int bits_needed = widest > 0 ? 64 - __clzll(widest) : 0;
  const int shift = max(bits_needed - depth_bits, 0);

  const long long g = static_cast<long long>(blockIdx.x) * kEmitThreads + threadIdx.x;
  const long long g0 = g - lane;  // the warp's first Gaussian
  if (g0 >= n) return;
  const long long c = g < n ? count[g] : 0;
  const int end = static_cast<int>(cum[g < n ? g : n - 1]);  // lanes past n own nothing
  const int start = end - static_cast<int>(c);
  const int first = __shfl_sync(kFull, start, 0);
  const int stop = min(__shfl_sync(kFull, end, 31), m);
  if (first >= stop) return;

  unsigned int g_mask = 0u, g_low = 0u;
  int g_lox = 0, g_loy = 0, g_w = 1;
  if (c > 0 && start < m) {
    g_mask = static_cast<unsigned int>(mask[g]);
    g_lox = static_cast<int>(lo_x[g]);
    g_loy = static_cast<int>(lo_y[g]);
    g_w = max(static_cast<int>(hi_x[g] - lo_x[g]), 1);
    g_low = static_cast<unsigned int>((static_cast<long long>(depth[g * depth_stride]) - least) >> shift);
  }
  for (int base = first; base < stop; base += 32) {
    const int s = base + lane;
    int own = 0;  // the first of the warp's Gaussians whose slots end past s
    for (int step = 16; step >= 1; step >>= 1) {
      if (__shfl_sync(kFull, end, own + step - 1) <= s) own += step;
    }
    const int o_start = __shfl_sync(kFull, start, own);
    const unsigned int o_mask = __shfl_sync(kFull, g_mask, own);
    const int o_lox = __shfl_sync(kFull, g_lox, own);
    const int o_loy = __shfl_sync(kFull, g_loy, own);
    const int o_w = __shfl_sync(kFull, g_w, own);
    const unsigned int o_low = __shfl_sync(kFull, g_low, own);
    if (s < stop) {
      const int k = s - o_start;
      const int local = o_mask ? kth_set_bit(o_mask, k) : k;
      const int tile = (o_loy + local / o_w) * tiles_x + o_lox + local % o_w;
      const unsigned int key = (static_cast<unsigned int>(tile) << depth_bits) | o_low;
      key_out[s] = static_cast<int>(key ^ 0x80000000u);
      gid_out[s] = g0 + own;
    }
  }
}

}  // namespace

extern "C" int lg_bin_cover(const void* mean2d, const void* conic, const void* opacity, const void* radius,
                            void* lo_x, void* lo_y, void* hi_x, void* mask, void* count, int n, int mean_stride,
                            int conic_stride, int opacity_stride, int radius_stride, int tiles_x, int tiles_y,
                            void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  bin_cover_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mean2d), static_cast<const float*>(conic), static_cast<const float*>(opacity),
      static_cast<const int*>(radius), static_cast<long long*>(lo_x), static_cast<long long*>(lo_y),
      static_cast<long long*>(hi_x), static_cast<long long*>(mask), static_cast<long long*>(count), n,
      mean_stride, conic_stride, opacity_stride, radius_stride, tiles_x, tiles_y);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lg_bin_emit(const void* lo_x, const void* lo_y, const void* hi_x, const void* mask, const void* count,
                           const void* cum, const void* depth, void* key, void* gid, void* partials, int n, int m,
                           int depth_stride, int tiles_x, int depth_bits, int range_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = std::min(range_blocks, (n + kRangeThreads - 1) / kRangeThreads);
  const long long* count_p = static_cast<const long long*>(count);
  const long long* cum_p = static_cast<const long long*>(cum);
  const int* depth_p = static_cast<const int*>(depth);
  int* partials_p = static_cast<int*>(partials);
  bin_depth_range_kernel<<<blocks, kRangeThreads, 0, s>>>(count_p, cum_p, depth_p, depth_stride, n, m, partials_p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bin_emit_kernel<<<(n + kEmitThreads - 1) / kEmitThreads, kEmitThreads, 0, s>>>(
      static_cast<const long long*>(lo_x), static_cast<const long long*>(lo_y), static_cast<const long long*>(hi_x),
      static_cast<const long long*>(mask), count_p, cum_p, depth_p, static_cast<int*>(key),
      static_cast<long long*>(gid), partials_p, blocks, n, m, depth_stride, tiles_x, depth_bits);
  return static_cast<int>(cudaGetLastError());
}
