// Chunk-major to instance-major transpose for Hopper (sm_90a).
//
// Entry point (plain C interface, loaded with ctypes by
// lightgaussian_tpu_torch/ops/rasterize/blend.py):
//   lg_unchunk_transpose  replaces the Pallas kernel of `unchunk_transpose`
//                         (lightgaussian_tpu/ops/rasterize/pallas_blend.py):
//                         x [NC, F, 128] -> out [NC * 128, F],
//                         out[c * 128 + i, f] = x[c, f, i].
//
// Bound on this card: bytes. It has no arithmetic; every element is read
// once and written once. The design makes both sides coalesce: a block takes
// one chunk and up to 32 features of it, reads its [32, 128] slab along the
// 128 (each warp a run of 128 consecutive bytes of a feature row at a time)
// into a shared-memory tile whose rows are padded to 129 floats, and writes
// it back with the feature index fastest, so that the threads of a warp
// write runs of consecutive floats of the output rows (whole rows when
// F <= 32). With the padding, the column reads of the tile fall on distinct
// banks.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;
constexpr int kFeatTile = 32;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
unchunk_transpose_kernel(const float* __restrict__ x, float* __restrict__ out,
                         int num_feat) {
  __shared__ float tile[kFeatTile][kChunk + 1];

  const size_t chunk = blockIdx.x;
  const int f0 = blockIdx.y * kFeatTile;
  const int fw = min(kFeatTile, num_feat - f0);

  const float* src = x + (chunk * num_feat + f0) * kChunk;
  for (int idx = threadIdx.x; idx < fw * kChunk; idx += kThreads) {
    tile[idx / kChunk][idx % kChunk] = src[idx];
  }
  __syncthreads();
  float* dst = out + chunk * kChunk * num_feat + f0;
  for (int idx = threadIdx.x; idx < fw * kChunk; idx += kThreads) {
    const int i = idx / fw;
    const int ff = idx % fw;
    dst[static_cast<size_t>(i) * num_feat + ff] = tile[ff][i];
  }
}

}  // namespace

extern "C" int lg_unchunk_transpose(const void* x, void* out, int num_chunks,
                                    int num_feat, void* stream) {
  const dim3 grid(num_chunks, (num_feat + kFeatTile - 1) / kFeatTile);
  unchunk_transpose_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), num_feat);
  return static_cast<int>(cudaGetLastError());
}
