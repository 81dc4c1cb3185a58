// Issue-rate probe for Hopper (sm_90a): dependent chains of one operation
// kind, timed at two lengths by utils/issue_probe.py to get the cost of one
// pass.
//
// Entry point (plain C interface, loaded with ctypes by
// lightgaussian_tpu_torch/utils/issue_probe.py):
//   lg_issue_probe  replaces the Pallas `_chain_kernel` of the JAX package's
//                   scripts/roofline.py (`vpu_chain`): there, dependent
//                   passes over a [128, 1024] block in vector memory; here,
//                   dependent passes over registers.
//
// What it measures: the rate at which an SM issues one kind of instruction
// when latency is hidden. Every thread carries four independent elements
// through `passes` dependent steps; blocks of 128 threads, sixteen to an SM
// (64 warps), give each of the SM's four schedulers sixteen warps to choose
// from, far more than the four-cycle latency of the FP32 pipe needs. The
// kinds, one step each:
//   0 mul       v = v * a                        one FMUL
//   1 mul_add   v = v * a + b                    FMUL and FADD: the file is
//               built with --fmad=false like the port's kernels, so the
//               compiler does not contract them
//   2 fma       v = fmaf(v, a, b)                one FFMA
//   3 ex2       v = ex2.approx(-v)               one MUFU.EX2
//   4 rcp       v = rcp.approx(v + 1)            one FADD, one MUFU.RCP
//   5 shfl_sum  s = butterfly sum over the warp (5 SHFL, 5 FADD, the
//               reduction of the blend backward and the counting blend);
//               v = 0.5 v + s / 64
//   6 scan128   y = inclusive prefix product over the block's 128 threads,
//               seven Hillis-Steele steps through shared memory (the
//               transmittance scan of a 128-instance chunk);
//               v = 1 + (y - 1) / 128
// The recurrences stay bounded, so no pass runs on denormals or infinities.
// The result is written out, so the chain cannot be removed, and it is what
// the plain PyTorch recurrence is held against.
//
// Bound: operations, by construction; 16 bytes per thread are read and
// written once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChains = 4;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm volatile("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const float* __restrict__ x, float* __restrict__ out, int passes,
             float a, float b) {
  __shared__ float rows[kChains][kThreads];

  const size_t total = static_cast<size_t>(gridDim.x) * kThreads;
  const size_t tid = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int t = threadIdx.x;
  float v[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) v[k] = x[tid + k * total];

  if (KIND == 6) {
    for (int p = 0; p < passes; ++p) {
      float y[kChains];
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
        y[k] = v[k];
        rows[k][t] = y[k];
      }
#pragma unroll
      for (int off = 1; off < kThreads; off <<= 1) {
        __syncthreads();
        float u[kChains];
#pragma unroll
        for (int k = 0; k < kChains; ++k) u[k] = t >= off ? rows[k][t - off] : 1.0f;
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kChains; ++k) {
          y[k] *= u[k];
          rows[k][t] = y[k];
        }
      }
#pragma unroll
      for (int k = 0; k < kChains; ++k) v[k] = 1.0f + (y[k] - 1.0f) * (1.0f / 128.0f);
    }
  } else {
#pragma unroll 16
    for (int p = 0; p < passes; ++p) {
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
        if (KIND == 0) {
          v[k] = v[k] * a;
        } else if (KIND == 1) {
          v[k] = v[k] * a + b;
        } else if (KIND == 2) {
          v[k] = fmaf(v[k], a, b);
        } else if (KIND == 3) {
          v[k] = ex2_approx(-v[k]);
        } else if (KIND == 4) {
          v[k] = rcp_approx(v[k] + 1.0f);
        } else {
          float s = v[k];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFullMask, s, off);
          v[k] = 0.5f * v[k] + s * (1.0f / 64.0f);
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kChains; ++k) out[tid + k * total] = v[k];
}

template <int KIND>
int launch(const void* x, void* out, int passes, float a, float b, int blocks,
           void* stream) {
  probe_kernel<KIND><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), passes, a, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `x` and `out` hold blocks * 128 * 4 floats. Returns the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for an unknown kind.
extern "C" int lg_issue_probe(const void* x, void* out, int kind, int passes,
                              float a, float b, int blocks, void* stream) {
  switch (kind) {
    case 0: return launch<0>(x, out, passes, a, b, blocks, stream);
    case 1: return launch<1>(x, out, passes, a, b, blocks, stream);
    case 2: return launch<2>(x, out, passes, a, b, blocks, stream);
    case 3: return launch<3>(x, out, passes, a, b, blocks, stream);
    case 4: return launch<4>(x, out, passes, a, b, blocks, stream);
    case 5: return launch<5>(x, out, passes, a, b, blocks, stream);
    case 6: return launch<6>(x, out, passes, a, b, blocks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
