// Binning's tile cover for Hopper (sm_90a): each Gaussian's tile rectangle,
// its exact ellipse-vs-tile mask and its instance count, in one pass.
//
// Entry point (plain C interface, loaded with ctypes by
// lightgaussian_tpu_torch/ops/rasterize/binning.py):
//   lg_bin_cover  piece (a) of `bin_splats`: `tile_rect` with the conic and
//                 opacity, then `_exact_tile_mask`. It replaces no Pallas
//                 kernel: the JAX package computes the same cover with XLA
//                 ops (lightgaussian_tpu/ops/rasterize/binning.py,
//                 `tile_rect` and `_exact_tile_mask`), and the port first
//                 ran them as a chain of torch ops over [N, 32] temporaries.
//
// Bound on this card: bytes. A Gaussian reads its mean (8 B), conic (12 B),
// opacity (4 B) and radius (4 B) once and writes five int64 (40 B): 68 B, or
// 0.061 ms at 3 M Gaussians and 3.35 TB/s. One thread takes one Gaussian,
// walks the row-major slots of its rect (at most 32, else the rect count
// stands and the mask is 0) in registers and writes each output once, as
// structure of arrays: nothing else touches device memory. Its time goes to
// the slots' arithmetic, four edge minima a slot with an IEEE division in
// each: the walk takes a row's divisions once and skips the edges of the box
// that holds the mean.
//
// The outputs equal the torch chain's bit for bit on the card. Each float
// operation is the chain's, in its order, rounded as it rounds (the library
// is built with --fmad=false, IEEE division and square root, the accurate
// logf, which is torch.log's on the card): a tensor divided by a Python
// float is a multiply by the float's reciprocal, taken in double and
// rounded to float32, as PyTorch's CUDA division by a scalar does (for
// 1/255 that is 255, not 1 / float32(1/255)); torch.minimum, maximum and
// clamp keep a NaN, and a float is cast to int64 by truncation, as
// `.to(torch.int64)` does.

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
