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
// equal it bit for bit. A derived plane's values (x^2, y^2, x y) are one
// float32 multiply each, rounded once, as the plain version's `x * x`.
//
// Bound on this card: bytes. An output element costs 11 multiplies and 10
// adds per pass (42 float32 instructions), and a derived plane one multiply
// more for each element a lane forms, against 4 bytes written and, read
// once, 4 bytes (lg_ssim_blur) or 8 / P (x and y for P planes). The FP32
// pipes need about half as long for those as the memory for the bytes:
// below the H100's ratio of float32 rate to memory rate, but not by much,
// so a design that spends many instructions besides the arithmetic of each
// output is held by issue, not by memory.
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
// lg_ssim_blur3 and lg_ssim_blur5, the same rows shared by the planes: a
// block of P warps owns a strip of 128 columns of one channel over a run of
// rows, one warp for each output plane. The block streams the run's rows of
// x and y, and the 5 above and below, through one ring in shared memory, as
// lg_ssim_blur streams one plane, so each input row is read once for all P
// planes; a block barrier a row marks a staged row as in and the oldest as
// read by every warp. Each warp forms its plane's values in registers from
// the float4s it reads out of the ring: x or y itself, its square, or x
// times y (a zero of the padding stays zero). Then it runs lg_ssim_blur's
// two passes: horizontal sums into a ring of 11 rows in registers, the
// vertical pass from there, four outputs a lane stored as one float4.
// Runs are as many as fit in one wave of the resident blocks, so no block
// waits for a second wave, and at least kMinRunRows long.

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

// ---- lg_ssim_blur3, lg_ssim_blur5: a block per channel, strip and run, a warp per plane ----

// Rows of x and of y a block's ring holds (all but one in flight while one is
// read) and the blocks an SM its register budget asks for (P 3: 7, P 5: 4):
// the fastest of those measured on the H100 for each P (PERF.md section 6).
// More resident warps hide the barrier and each row's latency better than
// more registers would.
template <int P>
constexpr int kMomentRing = P == 3 ? 8 : 4;

// The planes: 0 x, 1 y, 2 x^2, 3 y^2, 4 x y; plane k of lg_ssim_blur3 is
// kind 2 k (x, x^2, x y), of lg_ssim_blur5 kind k.
template <bool VEC, int P>
__global__ void __launch_bounds__(P * 32, P == 3 ? 7 : 4)
moment_rows_kernel(const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ out, int height,
                   int width, int strips, int runs, int run_rows, Taps taps) {
  constexpr int kSlots = kMomentRing<P>;
  __shared__ __align__(16) float ring[2][kSlots][kRowFloats];  // x, then y

  const int lane = threadIdx.x & 31;
  const int k = threadIdx.x >> 5;
  const int strip = blockIdx.x % strips;
  const int run = blockIdx.x / strips % runs;
  const int channel = blockIdx.x / strips / runs;
  const int kind = P == 3 ? 2 * k : k;
  const int first = kind == 1 || kind == 3 ? 1 : 0;  // the ring of the plane's value, or of its first factor
  const bool square = kind == 2 || kind == 3;
  const bool product = kind == 4;
  const int x0 = strip * kStripW;
  const int y0 = run * run_rows;
  const int rows_in = min(run_rows, height - y0) + 2 * kRadius;
  const size_t plane = static_cast<size_t>(height) * width;
  const float* xc = x + channel * plane;
  const float* yc = y + channel * plane;
  float* dst = out + (static_cast<size_t>(channel) * P + k) * plane;

  // Input row r of the run (image row y0 - kRadius + r) of x and of y into
  // slot r % kSlots of their rings, staged columns x0 - kHalo .. x0 +
  // kStripW + kHalo - 1, shared out over the block's threads. Every thread
  // commits one group a row, empty past the run, so the wait below counts
  // rows.
  auto stage = [&](int r) {
    if (r < rows_in) {
      const int gy = y0 - kRadius + r;
      const bool row_in = gy >= 0 && gy < height;
      const size_t at = static_cast<size_t>(row_in ? gy : 0) * width;
      constexpr int kUnits = VEC ? kRowVecs : kRowFloats;  // cp.async units of a row
      for (int i = threadIdx.x; i < 2 * kUnits; i += P * 32) {
        const bool of_y = i >= kUnits;
        const int j = of_y ? i - kUnits : i;
        const float* from = of_y ? yc : xc;
        float* s = ring[of_y ? 1 : 0][r % kSlots];
        const int gx = x0 - kHalo + (VEC ? 4 * j : j);
        const bool in = row_in && gx >= 0 && gx < width;
        if (VEC) {
          cp_async16(s + 4 * j, in ? from + at + gx : from, in);
        } else {
          cp_async4(s + j, in ? from + at + gx : from, in);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int r = 0; r < kSlots - 1; ++r) stage(r);

  const int col = x0 + kCols * lane;  // the lane's first output column
  float h[kTaps][kCols];              // horizontal sums of the last 11 rows; row r in slot r % 11
  for (int r0 = 0; r0 < rows_in; r0 += kTaps) {
#pragma unroll
    for (int s = 0; s < kTaps; ++s) {
      const int r = r0 + s;
      if (r >= rows_in) break;  // the same row for every warp of the block
      cp_async_wait<kSlots - 2>();
      __syncthreads();  // row r is in for the block, and every warp is done with row r - 1
      stage(r + kSlots - 1);  // into the slot of row r - 1
      // The plane's values at staged columns 4 lane .. 4 lane + 19, image
      // columns col - 8 .. col + 11.
      float v[4 * kLaneVecs];
      const float4* q = reinterpret_cast<const float4*>(ring[first][r % kSlots]) + lane;
      const float4* qy = reinterpret_cast<const float4*>(ring[1][r % kSlots]) + lane;
#pragma unroll
      for (int i = 0; i < kLaneVecs; ++i) {
        float4 f = q[i];
        if (square || product) {
          const float4 g = product ? qy[i] : f;
          f = make_float4(f.x * g.x, f.y * g.y, f.z * g.z, f.w * g.w);
        }
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
        for (int t = 1; t < kTaps; ++t) acc = acc + taps.t[t] * u[t];
        h[s][j] = acc;
      }
      if (r < 2 * kRadius) continue;
      float o[kCols];  // image row y0 + r - 10 from rows r - 10 .. r, oldest first
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float acc = taps.t[0] * h[(s + 1) % kTaps][j];
#pragma unroll
        for (int t = 1; t < kTaps; ++t) acc = acc + taps.t[t] * h[(s + 1 + t) % kTaps][j];
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

// Rows a run: as many runs as one wave of the card's resident blocks holds,
// at least kMinRunRows each.
template <bool VEC, int P>
int moment_run_rows(int channels, int height, int strips) {
  int device = 0, sms = 0, blocks = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, moment_rows_kernel<VEC, P>, P * 32, 0);
  const long long per_run = static_cast<long long>(strips) * channels;  // blocks of one run
  const long long runs = std::max<long long>(1, static_cast<long long>(sms) * blocks / per_run);
  const long long rows = (height + runs - 1) / runs;
  return static_cast<int>(std::min<long long>(height, std::max<long long>(kMinRunRows, rows)));
}

template <bool VEC, int P>
int launch_moments(const float* x, const float* y, float* out, int channels, int height, int width, const Taps& t,
                   cudaStream_t stream) {
  const int strips = (width + kStripW - 1) / kStripW;
  const int run_rows = moment_run_rows<VEC, P>(channels, height, strips);
  const int runs = (height + run_rows - 1) / run_rows;
  const long long blocks = static_cast<long long>(strips) * runs * channels;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  moment_rows_kernel<VEC, P><<<static_cast<int>(blocks), P * 32, 0, stream>>>(x, y, out, height, width, strips,
                                                                             runs, run_rows, t);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int channels, int height, int width, int ntaps) {
  return ntaps != kTaps || channels <= 0 || height <= 0 || width <= 0;
}

Taps copy_taps(const float* taps) {
  Taps t;
  for (int k = 0; k < kTaps; ++k) t.t[k] = taps[k];
  return t;
}

template <int P>
int launch(const void* x, const void* y, void* out, int channels, int height, int width, const float* taps,
           int ntaps, void* stream) {
  if (bad_shape(channels, height, width, ntaps)) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec = width % 4 == 0 && aligned(x) && aligned(y) && aligned(out);
  const auto* xs = static_cast<const float*>(x);
  const auto* ys = static_cast<const float*>(y);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const Taps t = copy_taps(taps);
  return vec ? launch_moments<true, P>(xs, ys, o, channels, height, width, t, s)
             : launch_moments<false, P>(xs, ys, o, channels, height, width, t, s);
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
