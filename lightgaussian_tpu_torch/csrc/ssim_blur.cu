// The SSIM loss's separable Gaussian blur for Hopper (sm_90a).
//
// Entry points (plain C interface, loaded with ctypes by
// lightgaussian_tpu_torch/ops/losses.py):
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
// --fmad=false the kernels round as the plain PyTorch version does, and
// equal it bit for bit.
//
// Bound on this card: bytes. An output element costs 11 multiplies and 10
// adds per pass (42 float32 instructions) against 4 bytes written and at
// most 8 read, and the FP32 pipes need about half as long for those as the
// memory for the bytes: below the H100's ratio of float32 rate to memory
// rate, but not by much, so a design that spends many instructions besides
// the arithmetic of each output is held by issue, not by memory.
//
// lg_ssim_blur, row-streaming: a warp owns a strip of 128 columns of one
// plane (four adjacent outputs a lane) over a run of rows. It streams the
// run's input rows, and the 5 rows above and below it, through a ring of
// four rows in shared memory (cp.async, 16 bytes a lane where the rows are
// 16-byte aligned and 4 elsewhere, three rows in flight while one is read;
// rows and columns outside the plane arrive as zeros, which is the blur's
// zero padding, so a row outside the image has a horizontal sum of exactly
// 0). From each staged row a lane reads five float4 (the 20 columns its four
// outputs need) and makes the four horizontal sums, which it keeps in a
// ring of the last 11 rows in registers; the row loop is unrolled by 11, so
// every slot of that ring is a fixed register. Once 11 rows are there each
// new row gives four outputs of the vertical pass, stored as one float4. No
// horizontal result goes through shared memory, and a warp needs no barrier
// but its own. Runs are as short as one wave of the card's resident warps
// allows, and at least kMinRunRows: a run of R rows reads R + 10.
//
// lg_ssim_blur3 and lg_ssim_blur5: one block per 32x32 output tile of one
// channel, 256 threads. The block loads the tile plus a 5-pixel halo of x
// and y into shared memory, zero outside the image, forms each derived
// plane (x^2, y^2, x y) there, runs the horizontal pass over the halo rows
// into shared memory and the vertical pass from there to device memory.
// Device memory sees each input element read about (42/32)^2 = 1.7 times,
// mostly from L2, and each output written once. The Pallas tiling (64- or
// 32-row blocks, 8- and 128-aligned slabs) was a TPU constraint and is not
// kept.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRadius = 5;
constexpr int kTaps = 2 * kRadius + 1;

struct Taps {
  float t[kTaps];
};

// ---- lg_ssim_blur: row-streaming, vertical pass in registers ----

constexpr int kCols = 4;                            // outputs a lane, adjacent
constexpr int kStripW = 32 * kCols;                 // a warp's columns
constexpr int kHalo = 8;                            // staged columns each side: kRadius, rounded to a float4
constexpr int kRowFloats = kStripW + 2 * kHalo;     // 144
constexpr int kRowVecs = kRowFloats / 4;            // 36
constexpr int kLaneVecs = (kCols + 2 * kHalo) / 4;  // the five float4 a lane reads of a row
constexpr int kRing = 4;                            // staged rows a warp
constexpr int kRowWarps = 4;                        // warps a block, each on its own strip and run
constexpr int kMinRunRows = 16;

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// VEC: the plane's rows start 16-byte aligned (width % 4 == 0 and aligned
// pointers), so a float4 of columns lies wholly inside or outside it.
template <bool VEC>
__global__ void __launch_bounds__(kRowWarps * 32)
blur_rows_kernel(const float* __restrict__ x, float* __restrict__ out, int height, int width,
                 int strips, int runs, int run_rows, int items, Taps taps) {
  __shared__ __align__(16) float ring[kRowWarps][kRing][kRowFloats];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int item = blockIdx.x * kRowWarps + warp;
  if (item >= items) return;  // a whole warp: no block barrier follows
  const int strip = item % strips;
  const int run = item / strips % runs;
  const int plane = item / strips / runs;
  const int x0 = strip * kStripW;
  const int y0 = run * run_rows;
  const int rows_in = min(run_rows, height - y0) + 2 * kRadius;
  const size_t plane_at = static_cast<size_t>(plane) * height * width;
  const float* src = x + plane_at;
  float* dst = out + plane_at;
  float(*buf)[kRowFloats] = ring[warp];

  // Input row r of the run (image row y0 - kRadius + r) into buf[r % kRing],
  // staged columns x0 - kHalo .. x0 + kStripW + kHalo - 1. Every lane commits
  // one group a row, empty past the run, so the wait below counts rows.
  auto stage = [&](int r) {
    const int y = y0 - kRadius + r;
    if (r < rows_in) {
      const bool row_in = y >= 0 && y < height;
      const float* row = src + static_cast<size_t>(row_in ? y : 0) * width;
      float* s = buf[r % kRing];
      if (VEC) {
        for (int i = lane; i < kRowVecs; i += 32) {
          const int gx = x0 - kHalo + 4 * i;
          const bool in = row_in && gx >= 0 && gx < width;
          cp_async16(s + 4 * i, in ? row + gx : src, in);
        }
      } else {
        for (int i = lane; i < kRowFloats; i += 32) {
          const int gx = x0 - kHalo + i;
          const bool in = row_in && gx >= 0 && gx < width;
          cp_async4(s + i, in ? row + gx : src, in);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int r = 0; r < kRing - 1; ++r) stage(r);

  const int col = x0 + kCols * lane;  // the lane's first output column
  float h[kTaps][kCols];              // horizontal sums of the last 11 rows; row r in slot r % 11
  for (int r0 = 0; r0 < rows_in; r0 += kTaps) {
#pragma unroll
    for (int s = 0; s < kTaps; ++s) {
      const int r = r0 + s;
      if (r >= rows_in) break;
      __syncwarp();  // every lane has read the slot the next stage() refills
      stage(r + kRing - 1);
      cp_async_wait<kRing - 1>();
      __syncwarp();  // row r is in shared memory for the whole warp
      float v[4 * kLaneVecs];  // staged columns 4 lane .. 4 lane + 19, image columns col - 8 .. col + 11
      const float4* q = reinterpret_cast<const float4*>(buf[r % kRing]) + lane;
#pragma unroll
      for (int i = 0; i < kLaneVecs; ++i) {
        const float4 f = q[i];
        v[4 * i] = f.x;
        v[4 * i + 1] = f.y;
        v[4 * i + 2] = f.z;
        v[4 * i + 3] = f.w;
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {  // output column col + j: image columns col + j - 5 .. + 5
        const float* u = v + (kHalo - kRadius) + j;
        float acc = taps.t[0] * u[0];
#pragma unroll
        for (int k = 1; k < kTaps; ++k) acc = acc + taps.t[k] * u[k];
        h[s][j] = acc;
      }
      if (r < 2 * kRadius) continue;
      float o[kCols];  // image row y0 + r - 10 from rows r - 10 .. r, oldest first
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float acc = taps.t[0] * h[(s + 1) % kTaps][j];
#pragma unroll
        for (int k = 1; k < kTaps; ++k) acc = acc + taps.t[k] * h[(s + 1 + k) % kTaps][j];
        o[j] = acc;
      }
      float* d = dst + static_cast<size_t>(y0 + r - 2 * kRadius) * width + col;
      if (VEC) {
        if (col < width) *reinterpret_cast<float4*>(d) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (col + j < width) d[j] = o[j];
      }
    }
  }
}

// Rows a run: as few as fill one wave of the card's resident warps, at
// least kMinRunRows.
template <bool VEC>
int run_rows_for(int channels, int height, int strips) {
  int device = 0, sms = 0, blocks = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, blur_rows_kernel<VEC>, kRowWarps * 32, 0);
  const long long slots = static_cast<long long>(sms) * blocks * kRowWarps;
  const long long rows = static_cast<long long>(height) * strips * channels;
  const long long per_slot = slots > 0 ? (rows + slots - 1) / slots : height;
  return static_cast<int>(std::min<long long>(height, std::max<long long>(kMinRunRows, per_slot)));
}

template <bool VEC>
int launch_rows(const float* x, float* out, int channels, int height, int width, const Taps& t,
                cudaStream_t stream) {
  const int strips = (width + kStripW - 1) / kStripW;
  const int run_rows = run_rows_for<VEC>(channels, height, strips);
  const int runs = (height + run_rows - 1) / run_rows;
  const long long items = static_cast<long long>(strips) * runs * channels;
  if (items > 0x7fffffffLL - kRowWarps) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((items + kRowWarps - 1) / kRowWarps);
  blur_rows_kernel<VEC><<<blocks, kRowWarps * 32, 0, stream>>>(x, out, height, width, strips, runs, run_rows,
                                                               static_cast<int>(items), t);
  return static_cast<int>(cudaGetLastError());
}

// ---- lg_ssim_blur3, lg_ssim_blur5: 32x32 tiles ----

constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kInW = kTileW + 2 * kRadius;
constexpr int kInH = kTileH + 2 * kRadius;
constexpr int kThreads = 256;

// MODE 3: x-side moments. MODE 5: all five.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
ssim_blur_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ out, int height, int width, Taps taps) {
  constexpr int kPlanes = MODE;
  __shared__ float xs[kInH][kInW];
  __shared__ float ys[kInH][kInW];
  __shared__ float der[kInH][kInW];
  __shared__ float hs[kInH][kTileW];

  const int c = blockIdx.z;
  const int gx0 = blockIdx.x * kTileW;
  const int gy0 = blockIdx.y * kTileH;
  const size_t plane = static_cast<size_t>(height) * width;
  const float* xc = x + c * plane;
  const float* yc = y + c * plane;

  for (int i = threadIdx.x; i < kInH * kInW; i += kThreads) {
    const int r = i / kInW, col = i % kInW;
    const int gy = gy0 - kRadius + r, gx = gx0 - kRadius + col;
    const bool in = gy >= 0 && gy < height && gx >= 0 && gx < width;
    const size_t at = static_cast<size_t>(gy) * width + gx;
    xs[r][col] = in ? xc[at] : 0.0f;
    ys[r][col] = in ? yc[at] : 0.0f;
  }
  __syncthreads();

#pragma unroll 1
  for (int p = 0; p < kPlanes; ++p) {
    // Which plane: 0 x, 1 y, 2 x^2, 3 y^2, 4 x y (MODE 3 takes 0, 2, 4).
    const int kind = MODE == 3 ? 2 * p : p;
    const float(*src)[kInW] = xs;
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

bool bad_shape(int channels, int height, int width, int ntaps) {
  return ntaps != kTaps || channels <= 0 || height <= 0 || width <= 0;
}

Taps copy_taps(const float* taps) {
  Taps t;
  for (int k = 0; k < kTaps; ++k) t.t[k] = taps[k];
  return t;
}

template <int MODE>
int launch(const void* x, const void* y, void* out, int channels, int height,
           int width, const float* taps, int ntaps, void* stream) {
  if (bad_shape(channels, height, width, ntaps) || channels > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH,
                  channels);
  ssim_blur_kernel<MODE><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), height, width, copy_taps(taps));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lg_ssim_blur(const void* x, void* out, int channels, int height,
                            int width, const float* taps, int ntaps,
                            void* stream) {
  if (bad_shape(channels, height, width, ntaps)) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = width % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const auto* xs = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const Taps t = copy_taps(taps);
  return vec ? launch_rows<true>(xs, o, channels, height, width, t, s)
             : launch_rows<false>(xs, o, channels, height, width, t, s);
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
