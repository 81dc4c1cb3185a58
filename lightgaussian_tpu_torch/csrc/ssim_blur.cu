// The SSIM loss's separable Gaussian blur for Hopper (sm_90a).
//
// Entry points (plain C interface, loaded with ctypes by
// lightgaussian_tpu_torch/ops/losses.py), one kernel template:
//   lg_ssim_blur   replaces the Pallas `_blur_kernel`
//                  (lightgaussian_tpu/ops/losses.py, `_blur_pallas_raw`):
//                  the blur of C planes [C, H, W] -> [C, H, W]. The blur is
//                  self-adjoint, so it is also every VJP of the SSIM loss.
//   lg_ssim_blur3  replaces `_blur3_kernel` (`_blur3_pallas_raw`): from x, y
//                  [C, H, W] the planes B(x), B(x^2), B(x y) -> [3C, H, W].
//   lg_ssim_blur5  replaces `_blur5_kernel` (`_blur5_pallas_raw`): B(x),
//                  B(y), B(x^2), B(y^2), B(x y) -> [5C, H, W].
// The derived planes are channel-major: plane k of channel c is output
// plane c * P + k, as in the Pallas kernels.
//
// Semantics (`_blur_jnp`): an 11-tap Gaussian (sigma 1.5; the taps come
// from the caller, computed in float64 and rounded to float32) along each
// row, then along each column, with zero "same" padding. Each pass sums its
// taps in tap order starting from tap 0, the horizontal pass first, so with
// --fmad=false the kernel rounds as the plain PyTorch version does.
//
// Design: one block per 32x32 output tile of one channel, 256 threads. The
// block loads the tile plus a 5-pixel halo of x (and y) into shared memory,
// zero outside the image, forms each derived plane (x^2, y^2, x y) there,
// runs the horizontal pass over the halo rows into shared memory and the
// vertical pass from there to device memory. Device memory sees each input
// element read about (42/32)^2 = 1.7 times, mostly from L2, and each output
// written once. The Pallas tiling (64- or 32-row blocks, 8- and
// 128-aligned slabs) was a TPU constraint and is not kept.
//
// Bound on this card: bytes. An output element costs 11 multiplies and 10
// adds per pass (42 float32 instructions) against 4 bytes written and at
// most 8 read: below the H100's ratio of float32 rate to memory rate.

#include <cuda_runtime.h>

namespace {

constexpr int kRadius = 5;
constexpr int kTaps = 2 * kRadius + 1;
constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kInW = kTileW + 2 * kRadius;
constexpr int kInH = kTileH + 2 * kRadius;
constexpr int kThreads = 256;

struct Taps {
  float t[kTaps];
};

// MODE 0: blur each plane of x. MODE 3: x-side moments. MODE 5: all five.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
ssim_blur_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ out, int height, int width, Taps taps) {
  constexpr int kPlanes = MODE == 0 ? 1 : MODE;
  constexpr int kYRows = MODE == 0 ? 1 : kInH;
  __shared__ float xs[kInH][kInW];
  __shared__ float ys[kYRows][kInW];
  __shared__ float der[kInH][kInW];
  __shared__ float hs[kInH][kTileW];

  const int c = blockIdx.z;
  const int gx0 = blockIdx.x * kTileW;
  const int gy0 = blockIdx.y * kTileH;
  const size_t plane = static_cast<size_t>(height) * width;
  const float* xc = x + c * plane;
  const float* yc = MODE == 0 ? nullptr : y + c * plane;

  for (int i = threadIdx.x; i < kInH * kInW; i += kThreads) {
    const int r = i / kInW, col = i % kInW;
    const int gy = gy0 - kRadius + r, gx = gx0 - kRadius + col;
    const bool in = gy >= 0 && gy < height && gx >= 0 && gx < width;
    const size_t at = static_cast<size_t>(gy) * width + gx;
    xs[r][col] = in ? xc[at] : 0.0f;
    if constexpr (MODE != 0) ys[r][col] = in ? yc[at] : 0.0f;
  }
  __syncthreads();

#pragma unroll 1
  for (int p = 0; p < kPlanes; ++p) {
    // Which plane: 0 x, 1 y, 2 x^2, 3 y^2, 4 x y (MODE 3 takes 0, 2, 4).
    const int kind = MODE == 0 ? 0 : (MODE == 3 ? 2 * p : p);
    const float(*src)[kInW] = xs;
    if constexpr (MODE != 0) {
      if (kind == 1) {
        src = ys;
      } else if (kind >= 2) {
        for (int i = threadIdx.x; i < kInH * kInW; i += kThreads) {
          const int r = i / kInW, col = i % kInW;
          const float a = xs[r][col], b = ys[r][col];
          der[r][col] = kind == 2 ? a * a : (kind == 3 ? b * b : a * b);
        }
        __syncthreads();
        src = der;
      }
    }

    for (int i = threadIdx.x; i < kInH * kTileW; i += kThreads) {
      const int r = i / kTileW, col = i % kTileW;
      float acc = taps.t[0] * src[r][col];
#pragma unroll
      for (int k = 1; k < kTaps; ++k) acc = acc + taps.t[k] * src[r][col + k];
      hs[r][col] = acc;
    }
    __syncthreads();

    float* o = out + (static_cast<size_t>(c) * kPlanes + p) * plane;
    for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
      const int r = i / kTileW, col = i % kTileW;
      const int gy = gy0 + r, gx = gx0 + col;
      if (gy >= height || gx >= width) continue;
      float acc = taps.t[0] * hs[r][col];
#pragma unroll
      for (int k = 1; k < kTaps; ++k) acc = acc + taps.t[k] * hs[r + k][col];
      o[static_cast<size_t>(gy) * width + gx] = acc;
    }
    __syncthreads();  // hs and der are written again for the next plane
  }
}

template <int MODE>
int launch(const void* x, const void* y, void* out, int channels, int height,
           int width, const float* taps, int ntaps, void* stream) {
  if (ntaps != kTaps || channels <= 0 || height <= 0 || width <= 0 ||
      channels > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps t;
  for (int k = 0; k < kTaps; ++k) t.t[k] = taps[k];
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH,
                  channels);
  ssim_blur_kernel<MODE><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), height, width, t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lg_ssim_blur(const void* x, void* out, int channels, int height,
                            int width, const float* taps, int ntaps,
                            void* stream) {
  return launch<0>(x, nullptr, out, channels, height, width, taps, ntaps, stream);
}

extern "C" int lg_ssim_blur3(const void* x, const void* y, void* out,
                             int channels, int height, int width,
                             const float* taps, int ntaps, void* stream) {
  return launch<3>(x, y, out, channels, height, width, taps, ntaps, stream);
}

extern "C" int lg_ssim_blur5(const void* x, const void* y, void* out,
                             int channels, int height, int width,
                             const float* taps, int ntaps, void* stream) {
  return launch<5>(x, y, out, channels, height, width, taps, ntaps, stream);
}
