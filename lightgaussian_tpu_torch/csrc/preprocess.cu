// The preprocess for Hopper (sm_90a): each Gaussian's projection, 3D and 2D
// covariance (EWA), conic, radius, cull and SH colour in one forward pass, and
// the gradients of its parameters in one backward pass.
//
// Entry points (plain C interface, loaded with ctypes by
// lightgaussian_tpu_torch/ops/rasterize/projection.py):
//   lg_preprocess_forward   `plain_preprocess` (the chain of torch ops over
//                           projection.py, ops/covariance.py, ops/sh.py and
//                           the activations of models/gaussians.py), one
//                           thread a Gaussian.
//   lg_preprocess_backward  its gradients (the arithmetic of
//                           `projection.preprocess_backward_plain`), one
//                           thread a Gaussian.
// They replace no Pallas kernel: the JAX package's preprocess is XLA ops
// (lightgaussian_tpu/ops/rasterize/projection.py, `preprocess`), and the
// port first ran it as a chain of some 150 torch ops a render, with autograd
// saving their intermediates for a backward of as many more.
//
// Bound on this card: bytes. The forward reads a Gaussian's mean (12 B),
// log-scales (12), quaternion (16), opacity logit (4), DC band (12), rest
// bands (12 K: 180 at SH 3), alive flag (1) and, in training, its offset (8),
// and writes mean2d (8), conic (12), colour (12), opacity (4), depth (4) and
// radius (4): 285 B at SH 3, 0.26 ms at 3 M Gaussians and 3.35 TB/s. The
// backward reads the inputs again and 36 B of upstream gradients and writes
// the parameters' gradients (244 B at SH 3 with the offset's): about 520 B,
// 0.47 ms. One thread takes one Gaussian and keeps every intermediate in
// registers; the backward recomputes the forward rather than reading saved
// intermediates. The camera is read from device memory into shared memory
// once a block, so no host value is read. A block's rows of `sh_rest`
// (12 K bytes a Gaussian, contiguous over the block) are loaded cooperatively
// into shared memory, 16 B a thread with neighbouring threads on neighbouring
// addresses, and each thread reads its own row from there; the backward
// writes its `sh_rest` gradient rows the same way back out. Rows in shared
// memory are padded to an odd number of floats, so a warp's reads of one
// column fall in distinct banks.
//
// The forward's outputs equal the chain's bit for bit on the card. Each float
// operation is the chain's, in its order, rounded as it rounds (the library
// is built with --fmad=false, IEEE division and square root, the accurate
// expf, which is torch.exp's): a Python number is a float32 operand, rounded
// from double; `1.0 / t` is torch's reciprocal; torch.sum over three elements
// adds (a + c) + b on the card and over four (a + c) + (b + d), the lanes of
// its reduction; torch.clamp keeps a NaN. The backward follows
// `preprocess_backward_plain` operation by operation, with autograd's masks: a
// clamp passes the gradient where min <= x <= max, torch.where only to the
// branch taken; `depth` and `radius` take none.
//
// The SH degree is a template parameter (0-4) and K, the rows of `sh_rest`
// (K >= (degree + 1)^2 - 1, at most 24), an argument. Every per-Gaussian
// input is addressed by its row stride (elements), its rows contiguous. The
// nullable inputs are the offset, the precomputed colours and covariances,
// and in the backward the upstream gradients (null reads as zero) and each
// gradient (null is not computed).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRest = 24;  // projection.MAX_SH_REST

// A Python number as the chain's float32 operand.
constexpr float f32(double v) { return static_cast<float>(v); }

constexpr float kNear = f32(0.2);      // projection.NEAR_PLANE
constexpr float kWEps = f32(1e-7);     // p_w + 1e-7
constexpr float kNormEps = f32(1e-12);  // |q| + 1e-12, |dir| + 1e-12
constexpr float kTzMin = f32(1e-6);
constexpr float kFovClamp = f32(1.3);
constexpr float kLowPass = f32(0.3);
constexpr float kLambdaMin = f32(0.1);

constexpr float kC0 = f32(0.28209479177387814);
constexpr float kC1 = f32(0.4886025119029199);
constexpr float kC2_0 = f32(1.0925484305920792);
constexpr float kC2_1 = f32(-1.0925484305920792);
constexpr float kC2_2 = f32(0.31539156525252005);
constexpr float kC2_3 = f32(-1.0925484305920792);
constexpr float kC2_4 = f32(0.5462742152960396);
constexpr float kC3_0 = f32(-0.5900435899266435);
constexpr float kC3_1 = f32(2.890611442640554);
constexpr float kC3_2 = f32(-0.4570457994644658);
constexpr float kC3_3 = f32(0.3731763325901154);
constexpr float kC3_4 = f32(-0.4570457994644658);
constexpr float kC3_5 = f32(1.445305721320277);
constexpr float kC3_6 = f32(-0.5900435899266435);
constexpr float kC4_0 = f32(2.5033429417967046);
constexpr float kC4_1 = f32(-1.7701307697799304);
constexpr float kC4_2 = f32(0.9461746957575601);
constexpr float kC4_3 = f32(-0.6690465435572892);
constexpr float kC4_4 = f32(0.10578554691520431);
constexpr float kC4_5 = f32(-0.6690465435572892);
constexpr float kC4_6 = f32(0.47308734787878004);
constexpr float kC4_7 = f32(-1.7701307697799304);
constexpr float kC4_8 = f32(0.6258357354491761);

// The camera in shared memory: world_view, full_proj (row-major 4x4), centre, tan_fovx, tan_fovy.
constexpr int kWv = 0, kFp = 16, kCc = 32, kTanX = 35, kTanY = 36, kCamFloats = 37;

struct Inputs {
  const float* means;
  const float* log_scales;
  const float* quats;
  const float* opacity_logits;
  const float* sh_dc;
  const float* sh_rest;
  const unsigned char* alive;
  const float* offset;          // nullable
  const float* colors_precomp;  // nullable
  const float* cov3d_precomp;   // nullable
  const float* world_view;
  const float* full_proj;
  const float* camera_center;
  const float* tan_fovx;
  const float* tan_fovy;
  long long means_rs, log_scales_rs, quats_rs, opacity_rs, sh_dc_rs, sh_rest_rs, alive_rs, offset_rs, colors_rs,
      cov3d_rs;
  int n, k_rest, width, height;
  float scale_modifier;
};

struct Outputs {
  float* mean2d;
  float* conic;
  float* color;
  float* opacity;
  float* depth;
  int* radius;
};

struct Upstream {  // each nullable
  const float* mean2d;
  const float* conic;
  const float* color;
  const float* opacity;
  long long mean2d_rs, conic_rs, color_rs, opacity_rs;
};

struct Grads {  // each nullable, rows contiguous
  float* means;
  float* log_scales;
  float* quats;
  float* opacity_logits;
  float* sh_dc;
  float* sh_rest;
  float* offset;
  float* colors_precomp;
  float* cov3d_precomp;
};

__device__ __forceinline__ float sum3(float a, float b, float c) { return (a + c) + b; }

// torch.clamp: a NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) { return (v != v) ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return (v != v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ const float* row(const float* p, long long stride, int g) {
  return p + static_cast<long long>(g) * stride;
}

// The padded row of a block's sh_rest slab in shared memory: an odd number of floats.
__host__ __device__ __forceinline__ int slab_pitch(int k_rest) { return (3 * k_rest) | 1; }

__device__ void load_camera(const Inputs& in, float* cam) {
  const int t = threadIdx.x;
  if (t < 16) {
    cam[kWv + t] = in.world_view[t];
    cam[kFp + t] = in.full_proj[t];
  } else if (t < 19) {
    cam[kCc + t - 16] = in.camera_center[t - 16];
  } else if (t == 19) {
    cam[kTanX] = *in.tan_fovx;
  } else if (t == 20) {
    cam[kTanY] = *in.tan_fovy;
  }
}

// The block's rows [base, base + rows) of sh_rest into `slab` (row pitch `pitch`): float4 loads over the
// contiguous slab where the rows are contiguous and the slab 16 B aligned, else one float a thread.
__device__ void load_slab(const Inputs& in, int base, int rows, int pitch, float* slab) {
  const int width = 3 * in.k_rest;
  const float* src = in.sh_rest + static_cast<long long>(base) * in.sh_rest_rs;
  const int total = rows * width;
  if (in.sh_rest_rs == width && (reinterpret_cast<std::uintptr_t>(src) & 15u) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    const int n4 = total / 4;
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      const float4 v = __ldg(src4 + i);
      int r = (4 * i) / width;
      int c = 4 * i - r * width;
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        slab[r * pitch + c] = e[j];
        if (++c == width) {
          c = 0;
          ++r;
        }
      }
    }
    for (int i = 4 * n4 + threadIdx.x; i < total; i += kThreads) {
      const int r = i / width;
      slab[r * pitch + (i - r * width)] = __ldg(src + i);
    }
  } else {
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int r = i / width;
      const int c = i - r * width;
      slab[r * pitch + c] = __ldg(src + static_cast<long long>(r) * in.sh_rest_rs + c);
    }
  }
}

// The slab's rows out to the contiguous gradient `dst` (rows [base, base + rows)), float4 where aligned.
__device__ void store_slab(const float* slab, int base, int rows, int pitch, int k_rest, float* dst) {
  const int width = 3 * k_rest;
  float* out = dst + static_cast<long long>(base) * width;
  const int total = rows * width;
  if ((reinterpret_cast<std::uintptr_t>(out) & 15u) == 0) {
    float4* out4 = reinterpret_cast<float4*>(out);
    const int n4 = total / 4;
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      int r = (4 * i) / width;
      int c = 4 * i - r * width;
      float e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        e[j] = slab[r * pitch + c];
        if (++c == width) {
          c = 0;
          ++r;
        }
      }
      out4[i] = make_float4(e[0], e[1], e[2], e[3]);
    }
    for (int i = 4 * n4 + threadIdx.x; i < total; i += kThreads) {
      const int r = i / width;
      out[i] = slab[r * pitch + (i - r * width)];
    }
  } else {
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int r = i / width;
      out[i] = slab[r * pitch + (i - r * width)];
    }
  }
}

// The factors P_k of eval_sh's terms P_k * sh[k], k = 1 .. (D+1)^2 - 1 (p[0] unused), in the chain's order.
template <int D>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* p) {
  if constexpr (D < 1) return;
  p[1] = kC1 * y;
  p[2] = kC1 * z;
  p[3] = kC1 * x;
  if constexpr (D < 2) return;
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  p[4] = kC2_0 * xy;
  p[5] = kC2_1 * yz;
  p[6] = kC2_2 * ((2.0f * zz - xx) - yy);
  p[7] = kC2_3 * xz;
  p[8] = kC2_4 * (xx - yy);
  if constexpr (D < 3) return;
  p[9] = (kC3_0 * y) * (3.0f * xx - yy);
  p[10] = (kC3_1 * xy) * z;
  p[11] = (kC3_2 * y) * ((4.0f * zz - xx) - yy);
  p[12] = (kC3_3 * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
  p[13] = (kC3_4 * x) * ((4.0f * zz - xx) - yy);
  p[14] = (kC3_5 * z) * (xx - yy);
  p[15] = (kC3_6 * x) * (xx - 3.0f * yy);
  if constexpr (D < 4) return;
  p[16] = (kC4_0 * xy) * (xx - yy);
  p[17] = (kC4_1 * yz) * (3.0f * xx - yy);
  p[18] = (kC4_2 * xy) * (7.0f * zz - 1.0f);
  p[19] = (kC4_3 * yz) * (7.0f * zz - 3.0f);
  p[20] = kC4_4 * (zz * (35.0f * zz - 30.0f) + 3.0f);
  p[21] = (kC4_5 * xz) * (7.0f * zz - 3.0f);
  p[22] = (kC4_6 * (xx - yy)) * (7.0f * zz - 1.0f);
  p[23] = (kC4_7 * xz) * (xx - 3.0f * yy);
  p[24] = kC4_8 * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
}

// d/d(x, y, z) of sum_k v_k B_k, B_k the signed basis (B_1 = -P_1, B_3 = -P_3): `_sh_direction_grad`.
template <int D>
__device__ __forceinline__ void sh_direction_grad(float x, float y, float z, const float* v, float* g) {
  float gx = -kC1 * v[3], gy = -kC1 * v[1], gz = kC1 * v[2];
  if constexpr (D >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    gx = gx + (kC2_0 * y) * v[4] + (kC2_2 * (-2.0f * x)) * v[6] + (kC2_3 * z) * v[7] +
         (kC2_4 * (2.0f * x)) * v[8];
    gy = gy + (kC2_0 * x) * v[4] + (kC2_1 * z) * v[5] + (kC2_2 * (-2.0f * y)) * v[6] +
         (kC2_4 * (-2.0f * y)) * v[8];
    gz = gz + (kC2_1 * y) * v[5] + (kC2_2 * (4.0f * z)) * v[6] + (kC2_3 * x) * v[7];
    if constexpr (D >= 3) {
      gx = gx + (kC3_0 * (6.0f * xy)) * v[9] + (kC3_1 * yz) * v[10] + (kC3_2 * (-2.0f * xy)) * v[11] +
           (kC3_3 * (-6.0f * xz)) * v[12] + (kC3_4 * ((4.0f * zz - 3.0f * xx) - yy)) * v[13] +
           (kC3_5 * (2.0f * xz)) * v[14] + (kC3_6 * (3.0f * (xx - yy))) * v[15];
      gy = gy + (kC3_0 * (3.0f * (xx - yy))) * v[9] + (kC3_1 * xz) * v[10] +
           (kC3_2 * ((4.0f * zz - xx) - 3.0f * yy)) * v[11] + (kC3_3 * (-6.0f * yz)) * v[12] +
           (kC3_4 * (-2.0f * xy)) * v[13] + (kC3_5 * (-2.0f * yz)) * v[14] + (kC3_6 * (-6.0f * xy)) * v[15];
      gz = gz + (kC3_1 * xy) * v[10] + (kC3_2 * (8.0f * yz)) * v[11] +
           (kC3_3 * ((6.0f * zz - 3.0f * xx) - 3.0f * yy)) * v[12] + (kC3_4 * (8.0f * xz)) * v[13] +
           (kC3_5 * (xx - yy)) * v[14];
    }
    if constexpr (D >= 4) {
      gx = gx + (kC4_0 * (y * (3.0f * xx - yy))) * v[16] + (kC4_1 * (6.0f * (xy * z))) * v[17] +
           (kC4_2 * (y * (7.0f * zz - 1.0f))) * v[18] + (kC4_5 * (z * (7.0f * zz - 3.0f))) * v[21] +
           (kC4_6 * ((2.0f * x) * (7.0f * zz - 1.0f))) * v[22] + (kC4_7 * ((3.0f * z) * (xx - yy))) * v[23] +
           (kC4_8 * ((4.0f * x) * (xx - 3.0f * yy))) * v[24];
      gy = gy + (kC4_0 * (x * (xx - 3.0f * yy))) * v[16] + (kC4_1 * ((3.0f * z) * (xx - yy))) * v[17] +
           (kC4_2 * (x * (7.0f * zz - 1.0f))) * v[18] + (kC4_3 * (z * (7.0f * zz - 3.0f))) * v[19] +
           (kC4_6 * ((-2.0f * y) * (7.0f * zz - 1.0f))) * v[22] + (kC4_7 * (-6.0f * (xy * z))) * v[23] +
           (kC4_8 * ((4.0f * y) * (yy - 3.0f * xx))) * v[24];
      gz = gz + (kC4_1 * (y * (3.0f * xx - yy))) * v[17] + (kC4_2 * (14.0f * (xy * z))) * v[18] +
           (kC4_3 * (y * (21.0f * zz - 3.0f))) * v[19] + (kC4_4 * (z * (140.0f * zz - 60.0f))) * v[20] +
           (kC4_5 * (x * (21.0f * zz - 3.0f))) * v[21] + (kC4_6 * ((14.0f * z) * (xx - yy))) * v[22] +
           (kC4_7 * (x * (xx - 3.0f * yy))) * v[23];
    }
  }
  g[0] = gx;
  g[1] = gy;
  g[2] = gz;
}

// A row of a camera matrix applied to the mean: torch.sum over j of mean[j] * M[i, j], + M[i, 3].
__device__ __forceinline__ float apply_row(const float* mat, int i, const float* m) {
  return sum3(m[0] * mat[4 * i], m[1] * mat[4 * i + 1], m[2] * mat[4 * i + 2]) + mat[4 * i + 3];
}

// What the forward computes of one Gaussian, and the backward reads again.
struct Geometry {
  float m[3];
  float px, py, pz;        // p_view
  float h0, h1, inv_w;     // p_hom[:2], 1 / (p_w + 1e-7)
  float S[3][3];           // 3D covariance
  float s[3], sms[3];      // scales, scale_modifier * scales
  float q[4], q_norm, q_den, qn[4];
  float R[3][3], L[3][3];
  float c[3][3];           // camera-space covariance
  float tz, limx, limy, rx, ry, cx, cy, itz, itz2, nfx_txz, nfy_tyz;
  float j00, j02, j11, j12, u1, u2, v1, w1, w2;
  float A, B, C, det, inv_det;
  bool det_valid;
};

__device__ __forceinline__ void geometry(const Inputs& in, const float* cam, int g, float fx, float fy,
                                         Geometry& o) {
  const float* mp = row(in.means, in.means_rs, g);
  o.m[0] = mp[0];
  o.m[1] = mp[1];
  o.m[2] = mp[2];
  const float* wv = cam + kWv;
  const float* fp = cam + kFp;
  o.px = apply_row(wv, 0, o.m);
  o.py = apply_row(wv, 1, o.m);
  o.pz = apply_row(wv, 2, o.m);
  o.h0 = apply_row(fp, 0, o.m);
  o.h1 = apply_row(fp, 1, o.m);
  o.inv_w = 1.0f / (apply_row(fp, 3, o.m) + kWEps);

  if (in.cov3d_precomp) {
    const float* c6 = row(in.cov3d_precomp, in.cov3d_rs, g);
    o.S[0][0] = c6[0]; o.S[0][1] = c6[1]; o.S[0][2] = c6[2];
    o.S[1][0] = c6[1]; o.S[1][1] = c6[3]; o.S[1][2] = c6[4];
    o.S[2][0] = c6[2]; o.S[2][1] = c6[4]; o.S[2][2] = c6[5];
  } else {
    const float* ls = row(in.log_scales, in.log_scales_rs, g);
    const float* qp = row(in.quats, in.quats_rs, g);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      o.s[j] = expf(ls[j]);
      o.sms[j] = o.s[j] * in.scale_modifier;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) o.q[j] = qp[j];
    o.q_norm = sqrtf((o.q[0] * o.q[0] + o.q[2] * o.q[2]) + (o.q[1] * o.q[1] + o.q[3] * o.q[3]));
    o.q_den = o.q_norm + kNormEps;
#pragma unroll
    for (int j = 0; j < 4; ++j) o.qn[j] = o.q[j] / o.q_den;
    const float w = o.qn[0], x = o.qn[1], y = o.qn[2], z = o.qn[3];
    o.R[0][0] = 1.0f - 2.0f * (y * y + z * z);
    o.R[0][1] = 2.0f * (x * y - w * z);
    o.R[0][2] = 2.0f * (x * z + w * y);
    o.R[1][0] = 2.0f * (x * y + w * z);
    o.R[1][1] = 1.0f - 2.0f * (x * x + z * z);
    o.R[1][2] = 2.0f * (y * z - w * x);
    o.R[2][0] = 2.0f * (x * z - w * y);
    o.R[2][1] = 2.0f * (y * z + w * x);
    o.R[2][2] = 1.0f - 2.0f * (x * x + y * y);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) o.L[i][j] = o.R[i][j] * o.sms[j];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        o.S[i][j] = sum3(o.L[i][0] * o.L[j][0], o.L[i][1] * o.L[j][1], o.L[i][2] * o.L[j][2]);
  }
  // W S W^T as the chain's two broadcast sums: tmp[i][k] = sum_j W[i][j] S[k][j], c[i][l] = sum_k tmp[i][k] W[l][k].
  float tmp[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      tmp[i][k] = sum3(wv[4 * i] * o.S[k][0], wv[4 * i + 1] * o.S[k][1], wv[4 * i + 2] * o.S[k][2]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int l = 0; l < 3; ++l)
      o.c[i][l] = sum3(tmp[i][0] * wv[4 * l], tmp[i][1] * wv[4 * l + 1], tmp[i][2] * wv[4 * l + 2]);

  // ewa_project
  o.tz = clamp_min(o.pz, kTzMin);
  o.limx = kFovClamp * cam[kTanX];
  o.limy = kFovClamp * cam[kTanY];
  o.rx = o.px / o.tz;
  o.ry = o.py / o.tz;
  o.cx = clamp(o.rx, -o.limx, o.limx);
  o.cy = clamp(o.ry, -o.limy, o.limy);
  const float txz = o.cx * o.tz;
  const float tyz = o.cy * o.tz;
  o.itz = 1.0f / o.tz;
  o.itz2 = o.itz * o.itz;
  o.nfx_txz = (-fx) * txz;
  o.nfy_tyz = (-fy) * tyz;
  o.j00 = fx * o.itz;
  o.j02 = o.nfx_txz * o.itz2;
  o.j11 = fy * o.itz;
  o.j12 = o.nfy_tyz * o.itz2;
  o.u1 = o.j00 * o.c[0][0] + o.j02 * o.c[2][0];
  o.u2 = o.j00 * o.c[0][2] + o.j02 * o.c[2][2];
  o.v1 = o.j00 * o.c[0][1] + o.j02 * o.c[2][1];
  o.w1 = o.j11 * o.c[1][1] + o.j12 * o.c[2][1];
  o.w2 = o.j11 * o.c[1][2] + o.j12 * o.c[2][2];
  o.A = (o.j00 * o.u1 + o.j02 * o.u2) + kLowPass;
  o.B = o.j11 * o.v1 + o.j12 * o.u2;
  o.C = (o.j11 * o.w1 + o.j12 * o.w2) + kLowPass;
  o.det = o.A * o.C - o.B * o.B;
  o.det_valid = o.det > 0.0f;
  o.inv_det = o.det_valid ? 1.0f / o.det : 0.0f;
}

// The view direction (m - centre) / (|m - centre| + 1e-12); raw, |raw| and the denominator kept.
struct Direction {
  float raw[3], nrm, den, d[3];
};

__device__ __forceinline__ void direction(const float* m, const float* cam, Direction& o) {
#pragma unroll
  for (int i = 0; i < 3; ++i) o.raw[i] = m[i] - cam[kCc + i];
  o.nrm = sqrtf(sum3(o.raw[0] * o.raw[0], o.raw[1] * o.raw[1], o.raw[2] * o.raw[2]));
  o.den = o.nrm + kNormEps;
#pragma unroll
  for (int i = 0; i < 3; ++i) o.d[i] = o.raw[i] / o.den;
}

// eval_sh of channel c before the +0.5, `rest` the Gaussian's row in the slab.
template <int D>
__device__ __forceinline__ float eval_sh(const float* p, float dc, const float* rest, int c) {
  float r = dc * kC0;
  if constexpr (D >= 1) {
    r = ((r - p[1] * rest[c]) + p[2] * rest[3 + c]) - p[3] * rest[6 + c];
#pragma unroll
    for (int k = 4; k < (D + 1) * (D + 1); ++k) r = r + p[k] * rest[3 * (k - 1) + c];
  }
  return r;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

template <int D>
__global__ void __launch_bounds__(kThreads) preprocess_forward_kernel(Inputs in, Outputs out) {
  extern __shared__ float slab[];
  __shared__ float cam[kCamFloats];
  const int base = blockIdx.x * kThreads;
  const int rows = min(kThreads, in.n - base);
  const int pitch = slab_pitch(in.k_rest);
  const bool use_sh = in.colors_precomp == nullptr;
  load_camera(in, cam);
  if (D > 0 && use_sh) load_slab(in, base, rows, pitch, slab);
  __syncthreads();
  const int g = base + threadIdx.x;
  if (g >= in.n) return;

  const float fx = static_cast<float>(in.width) / (2.0f * cam[kTanX]);
  const float fy = static_cast<float>(in.height) / (2.0f * cam[kTanY]);
  Geometry o;
  geometry(in, cam, g, fx, fy, o);

  float ndc_x = o.h0 * o.inv_w;
  float ndc_y = o.h1 * o.inv_w;
  if (in.offset) {
    const float* off = row(in.offset, in.offset_rs, g);
    ndc_x = ndc_x + off[0];
    ndc_y = ndc_y + off[1];
  }
  out.mean2d[2 * g] = ((ndc_x + 1.0f) * static_cast<float>(in.width) - 1.0f) * 0.5f;
  out.mean2d[2 * g + 1] = ((ndc_y + 1.0f) * static_cast<float>(in.height) - 1.0f) * 0.5f;
  out.conic[3 * g] = o.C * o.inv_det;
  out.conic[3 * g + 1] = (-o.B) * o.inv_det;
  out.conic[3 * g + 2] = o.A * o.inv_det;

  const float mid = 0.5f * (o.A + o.C);
  const float lambda1 = mid + sqrtf(clamp_min(mid * mid - o.det, kLambdaMin));
  const float radius_f = ceilf(3.0f * sqrtf(lambda1));

  if (use_sh) {
    Direction dir;
    direction(o.m, cam, dir);
    float p[(D + 1) * (D + 1)];
    sh_basis<D>(dir.d[0], dir.d[1], dir.d[2], p);
    const float* dc = row(in.sh_dc, in.sh_dc_rs, g);
    const float* rest = slab + threadIdx.x * pitch;
#pragma unroll
    for (int c = 0; c < 3; ++c) out.color[3 * g + c] = clamp_min(eval_sh<D>(p, dc[c], rest, c) + 0.5f, 0.0f);
  } else {
    const float* col = row(in.colors_precomp, in.colors_rs, g);
#pragma unroll
    for (int c = 0; c < 3; ++c) out.color[3 * g + c] = col[c];
  }

  const bool valid = in.alive[static_cast<long long>(g) * in.alive_rs] && o.pz > kNear && o.det_valid;
  out.radius[g] = static_cast<int>(valid ? radius_f : 0.0f);
  out.opacity[g] = valid ? sigmoid(in.opacity_logits[static_cast<long long>(g) * in.opacity_rs]) : 0.0f;
  out.depth[g] = valid ? o.pz : __int_as_float(0x7f800000);
}

__device__ __forceinline__ float up(const float* p, long long stride, int g, int j) {
  return p ? p[static_cast<long long>(g) * stride + j] : 0.0f;
}

template <int D>
__global__ void __launch_bounds__(kThreads) preprocess_backward_kernel(Inputs in, Upstream gin, Grads gout) {
  extern __shared__ float slab[];
  __shared__ float cam[kCamFloats];
  const int base = blockIdx.x * kThreads;
  const int rows = min(kThreads, in.n - base);
  const int pitch = slab_pitch(in.k_rest);
  const bool use_sh = in.colors_precomp == nullptr;
  // The slab holds the block's sh_rest rows wherever a gradient reads the colour (the clamp's mask reads
  // every band); each thread then overwrites its row with its gradient row.
  const bool need_rest = D > 0 && use_sh && (gout.means || gout.sh_rest || gout.sh_dc);
  load_camera(in, cam);
  if (need_rest) load_slab(in, base, rows, pitch, slab);
  __syncthreads();
  const int g = base + threadIdx.x;
  if (g < in.n) {
    const float fx = static_cast<float>(in.width) / (2.0f * cam[kTanX]);
    const float fy = static_cast<float>(in.height) / (2.0f * cam[kTanY]);
    Geometry o;
    geometry(in, cam, g, fx, fy, o);
    const bool valid = in.alive[static_cast<long long>(g) * in.alive_rs] && o.pz > kNear && o.det_valid;

    // The colour, clamp(eval_sh(dir) + 0.5, 0): the SH coefficients' gradients, and the mean's through the
    // view direction (added to the geometry's below).
    float g_col_m[3] = {0.0f, 0.0f, 0.0f};
    bool has_col_m = false;
    if (use_sh && (gout.means || gout.sh_dc || gout.sh_rest)) {
      const float* dc = row(in.sh_dc, in.sh_dc_rs, g);
      float g_res[3];
      if constexpr (D > 0) {
        Direction dir;
        direction(o.m, cam, dir);
        float p[(D + 1) * (D + 1)];
        sh_basis<D>(dir.d[0], dir.d[1], dir.d[2], p);
        float* rest = slab + threadIdx.x * pitch;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float gcol = up(gin.color, gin.color_rs, g, c);
          g_res[c] = eval_sh<D>(p, dc[c], rest, c) + 0.5f >= 0.0f ? gcol : 0.0f;
        }
        if (gout.means) {
          float v[(D + 1) * (D + 1)];
#pragma unroll
          for (int k = 1; k < (D + 1) * (D + 1); ++k) {
            const float* r = rest + 3 * (k - 1);
            v[k] = sum3(g_res[0] * r[0], g_res[1] * r[1], g_res[2] * r[2]);
          }
          float g_dir[3];
          sh_direction_grad<D>(dir.d[0], dir.d[1], dir.d[2], v, g_dir);
          float e[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) e[i] = (-g_dir[i]) * ((dir.raw[i] / dir.den) / dir.den);
          const float g_n2 = sum3(e[0], e[1], e[2]) / (2.0f * dir.nrm);
#pragma unroll
          for (int i = 0; i < 3; ++i) g_col_m[i] = g_dir[i] / dir.den + (g_n2 * dir.raw[i] + g_n2 * dir.raw[i]);
          has_col_m = true;
        }
        if (gout.sh_rest) {
          // the row's coefficients have been read; its gradient row takes their place
#pragma unroll
          for (int k = 1; k < (D + 1) * (D + 1); ++k)
#pragma unroll
            for (int c = 0; c < 3; ++c) rest[3 * (k - 1) + c] = (k == 1 || k == 3 ? -g_res[c] : g_res[c]) * p[k];
          for (int j = 3 * ((D + 1) * (D + 1) - 1); j < 3 * in.k_rest; ++j) rest[j] = 0.0f;
        }
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float gcol = up(gin.color, gin.color_rs, g, c);
          g_res[c] = dc[c] * kC0 + 0.5f >= 0.0f ? gcol : 0.0f;
        }
        if (gout.sh_rest)
          for (int j = 0; j < 3 * in.k_rest; ++j) gout.sh_rest[3ll * in.k_rest * g + j] = 0.0f;
      }
      if (gout.sh_dc) {
#pragma unroll
        for (int c = 0; c < 3; ++c) gout.sh_dc[3 * g + c] = g_res[c] * kC0;
      }
    }

    if (gout.opacity_logits) {
      const float go = up(gin.opacity, gin.opacity_rs, g, 0);
      const float sig = sigmoid(in.opacity_logits[static_cast<long long>(g) * in.opacity_rs]);
      gout.opacity_logits[g] = valid ? (go * (1.0f - sig)) * sig : 0.0f;
    }

    const float g_ndc_x = (up(gin.mean2d, gin.mean2d_rs, g, 0) * 0.5f) * static_cast<float>(in.width);
    const float g_ndc_y = (up(gin.mean2d, gin.mean2d_rs, g, 1) * 0.5f) * static_cast<float>(in.height);
    if (gout.offset) {
      gout.offset[2 * g] = g_ndc_x;
      gout.offset[2 * g + 1] = g_ndc_y;
    }

    if (gout.means || gout.log_scales || gout.quats || gout.cov3d_precomp) {
      const float* wv = cam + kWv;
      const float* fp = cam + kFp;
      const float g_h0 = g_ndc_x * o.inv_w, g_h1 = g_ndc_y * o.inv_w;
      const float g_inv_w = g_ndc_x * o.h0 + g_ndc_y * o.h1;
      const float g_pw = (-g_inv_w) * (o.inv_w * o.inv_w);

      // conic = (C, -B, A) * inv_det
      const float ga = up(gin.conic, gin.conic_rs, g, 0);
      const float gb = up(gin.conic, gin.conic_rs, g, 1);
      const float gc = up(gin.conic, gin.conic_rs, g, 2);
      const float g_inv_det = (ga * o.C + gb * (-o.B)) + gc * o.A;
      const float g_det = o.det_valid ? (-g_inv_det) * (o.inv_det * o.inv_det) : 0.0f;
      const float gA = gc * o.inv_det + g_det * o.C;
      const float gC = ga * o.inv_det + g_det * o.A;
      const float t = (-g_det) * o.B;
      const float gB = (-(gb * o.inv_det)) + (t + t);

      // EWA
      const float gu1 = gA * o.j00, gu2 = gA * o.j02 + gB * o.j12;
      const float gv1 = gB * o.j11, gw1 = gC * o.j11, gw2 = gC * o.j12;
      const float gj00 = ((gA * o.u1 + gu1 * o.c[0][0]) + gu2 * o.c[0][2]) + gv1 * o.c[0][1];
      const float gj02 = ((gA * o.u2 + gu1 * o.c[2][0]) + gu2 * o.c[2][2]) + gv1 * o.c[2][1];
      const float gj11 = ((gB * o.v1 + gC * o.w1) + gw1 * o.c[1][1]) + gw2 * o.c[1][2];
      const float gj12 = ((gB * o.u2 + gC * o.w2) + gw1 * o.c[2][1]) + gw2 * o.c[2][2];
      const float gcm[3][3] = {{gu1 * o.j00, gv1 * o.j00, gu2 * o.j00},
                               {0.0f, gw1 * o.j11, gw2 * o.j11},
                               {gu1 * o.j02, gv1 * o.j02 + gw1 * o.j12, gu2 * o.j02 + gw2 * o.j12}};
      float g_itz = gj00 * fx + gj11 * fy;
      const float g_itz2 = gj02 * o.nfx_txz + gj12 * o.nfy_tyz;
      const float g_txz = (gj02 * o.itz2) * (-fx);
      const float g_tyz = (gj12 * o.itz2) * (-fy);
      g_itz = g_itz + (g_itz2 * o.itz + g_itz2 * o.itz);
      float g_tz = ((-g_itz) * (o.itz * o.itz) + g_txz * o.cx) + g_tyz * o.cy;
      const float g_rx = (o.rx >= -o.limx && o.rx <= o.limx) ? g_txz * o.tz : 0.0f;
      const float g_ry = (o.ry >= -o.limy && o.ry <= o.limy) ? g_tyz * o.tz : 0.0f;
      const float g_px = g_rx / o.tz, g_py = g_ry / o.tz;
      g_tz = (g_tz - g_rx * (o.rx / o.tz)) - g_ry * (o.ry / o.tz);
      const float g_pz = o.pz >= kTzMin ? g_tz : 0.0f;

      // camera-space covariance -> S
      float g_tmp[3][3], gS[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          g_tmp[i][k] = (gcm[i][0] * wv[k] + gcm[i][1] * wv[4 + k]) + gcm[i][2] * wv[8 + k];
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          gS[k][j] = (g_tmp[0][k] * wv[j] + g_tmp[1][k] * wv[4 + j]) + g_tmp[2][k] * wv[8 + j];

      if (in.cov3d_precomp) {
        if (gout.cov3d_precomp) {
          float* o6 = gout.cov3d_precomp + 6ll * g;
          o6[0] = gS[0][0];
          o6[1] = gS[0][1] + gS[1][0];
          o6[2] = gS[0][2] + gS[2][0];
          o6[3] = gS[1][1];
          o6[4] = gS[1][2] + gS[2][1];
          o6[5] = gS[2][2];
        }
      } else if (gout.log_scales || gout.quats) {
        float G[3][3], gL[3][3], gR[3][3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j) G[i][j] = gS[i][j] + gS[j][i];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int k = 0; k < 3; ++k)
            gL[a][k] = (G[a][0] * o.L[0][k] + G[a][1] * o.L[1][k]) + G[a][2] * o.L[2][k];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j) gR[i][j] = gL[i][j] * o.sms[j];
        if (gout.log_scales) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const float g_sms = (gL[0][j] * o.R[0][j] + gL[1][j] * o.R[1][j]) + gL[2][j] * o.R[2][j];
            gout.log_scales[3 * g + j] = (g_sms * in.scale_modifier) * o.s[j];
          }
        }
        if (gout.quats) {
          const float qw = o.qn[0], qx = o.qn[1], qy = o.qn[2], qz = o.qn[3];
          float g_qn[4];
          g_qn[0] = 2.0f * ((qy * (gR[0][2] - gR[2][0]) + qz * (gR[1][0] - gR[0][1])) + qx * (gR[2][1] - gR[1][2]));
          g_qn[1] = 2.0f * (((qy * (gR[0][1] + gR[1][0]) + qz * (gR[0][2] + gR[2][0])) + qw * (gR[2][1] - gR[1][2])) -
                            (2.0f * qx) * (gR[1][1] + gR[2][2]));
          g_qn[2] = 2.0f * (((qx * (gR[0][1] + gR[1][0]) + qw * (gR[0][2] - gR[2][0])) + qz * (gR[1][2] + gR[2][1])) -
                            (2.0f * qy) * (gR[0][0] + gR[2][2]));
          g_qn[3] = 2.0f * (((qw * (gR[1][0] - gR[0][1]) + qx * (gR[0][2] + gR[2][0])) + qy * (gR[1][2] + gR[2][1])) -
                            (2.0f * qz) * (gR[0][0] + gR[1][1]));
          float d[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) d[i] = (-g_qn[i]) * (o.qn[i] / o.q_den);
          const float g_qq = ((d[0] + d[2]) + (d[1] + d[3])) / (2.0f * o.q_norm);
#pragma unroll
          for (int i = 0; i < 4; ++i) gout.quats[4 * g + i] = g_qn[i] / o.q_den + (g_qq * o.q[i] + g_qq * o.q[i]);
        }
      }

      if (gout.means) {
        float g_m[3];
#pragma unroll
        for (int j = 0; j < 3; ++j)
          g_m[j] = ((g_h0 * fp[j] + g_h1 * fp[4 + j]) + g_pw * fp[12 + j]) +
                   ((g_px * wv[j] + g_py * wv[4 + j]) + g_pz * wv[8 + j]);
        if (has_col_m) {
#pragma unroll
          for (int i = 0; i < 3; ++i) g_m[i] = g_m[i] + g_col_m[i];
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) gout.means[3 * g + j] = g_m[j];
      }
    }

    if (!use_sh && gout.colors_precomp) {
#pragma unroll
      for (int c = 0; c < 3; ++c) gout.colors_precomp[3 * g + c] = up(gin.color, gin.color_rs, g, c);
    }
  }
  if (need_rest && gout.sh_rest) {
    __syncthreads();
    store_slab(slab, base, rows, pitch, in.k_rest, gout.sh_rest);
  }
}

Inputs make_inputs(const void* means, const void* log_scales, const void* quats, const void* opacity_logits,
                   const void* sh_dc, const void* sh_rest, const void* alive, const void* offset,
                   const void* colors_precomp, const void* cov3d_precomp, const void* world_view,
                   const void* full_proj, const void* camera_center, const void* tan_fovx, const void* tan_fovy,
                   int means_rs, int log_scales_rs, int quats_rs, int opacity_rs, int sh_dc_rs, int sh_rest_rs,
                   int alive_rs, int offset_rs, int colors_rs, int cov3d_rs, int n, int k_rest, int width,
                   int height, float scale_modifier) {
  Inputs in;
  in.means = static_cast<const float*>(means);
  in.log_scales = static_cast<const float*>(log_scales);
  in.quats = static_cast<const float*>(quats);
  in.opacity_logits = static_cast<const float*>(opacity_logits);
  in.sh_dc = static_cast<const float*>(sh_dc);
  in.sh_rest = static_cast<const float*>(sh_rest);
  in.alive = static_cast<const unsigned char*>(alive);
  in.offset = static_cast<const float*>(offset);
  in.colors_precomp = static_cast<const float*>(colors_precomp);
  in.cov3d_precomp = static_cast<const float*>(cov3d_precomp);
  in.world_view = static_cast<const float*>(world_view);
  in.full_proj = static_cast<const float*>(full_proj);
  in.camera_center = static_cast<const float*>(camera_center);
  in.tan_fovx = static_cast<const float*>(tan_fovx);
  in.tan_fovy = static_cast<const float*>(tan_fovy);
  in.means_rs = means_rs;
  in.log_scales_rs = log_scales_rs;
  in.quats_rs = quats_rs;
  in.opacity_rs = opacity_rs;
  in.sh_dc_rs = sh_dc_rs;
  in.sh_rest_rs = sh_rest_rs;
  in.alive_rs = alive_rs;
  in.offset_rs = offset_rs;
  in.colors_rs = colors_rs;
  in.cov3d_rs = cov3d_rs;
  in.n = n;
  in.k_rest = k_rest;
  in.width = width;
  in.height = height;
  in.scale_modifier = scale_modifier;
  return in;
}

size_t slab_bytes(int degree, const Inputs& in) {
  return degree > 0 && in.colors_precomp == nullptr
             ? static_cast<size_t>(kThreads) * slab_pitch(in.k_rest) * sizeof(float) : 0;
}

}  // namespace

extern "C" int lg_preprocess_forward(
    const void* means, const void* log_scales, const void* quats, const void* opacity_logits, const void* sh_dc,
    const void* sh_rest, const void* alive, const void* offset, const void* colors_precomp,
    const void* cov3d_precomp, const void* world_view, const void* full_proj, const void* camera_center,
    const void* tan_fovx, const void* tan_fovy, void* mean2d, void* conic, void* color, void* opacity, void* depth,
    void* radius, int means_rs, int log_scales_rs, int quats_rs, int opacity_rs, int sh_dc_rs, int sh_rest_rs,
    int alive_rs, int offset_rs, int colors_rs, int cov3d_rs, int n, int k_rest, int degree, int width, int height,
    float scale_modifier, void* stream) {
  if (degree < 0 || degree > 4 || k_rest > kMaxRest) return static_cast<int>(cudaErrorInvalidValue);
  const Inputs in = make_inputs(means, log_scales, quats, opacity_logits, sh_dc, sh_rest, alive, offset,
                                colors_precomp, cov3d_precomp, world_view, full_proj, camera_center, tan_fovx,
                                tan_fovy, means_rs, log_scales_rs, quats_rs, opacity_rs, sh_dc_rs, sh_rest_rs,
                                alive_rs, offset_rs, colors_rs, cov3d_rs, n, k_rest, width, height, scale_modifier);
  Outputs out{static_cast<float*>(mean2d), static_cast<float*>(conic), static_cast<float*>(color),
              static_cast<float*>(opacity), static_cast<float*>(depth), static_cast<int*>(radius)};
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = slab_bytes(degree, in);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
    case 0: preprocess_forward_kernel<0><<<blocks, kThreads, smem, s>>>(in, out); break;
    case 1: preprocess_forward_kernel<1><<<blocks, kThreads, smem, s>>>(in, out); break;
    case 2: preprocess_forward_kernel<2><<<blocks, kThreads, smem, s>>>(in, out); break;
    case 3: preprocess_forward_kernel<3><<<blocks, kThreads, smem, s>>>(in, out); break;
    default: preprocess_forward_kernel<4><<<blocks, kThreads, smem, s>>>(in, out); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lg_preprocess_backward(
    const void* means, const void* log_scales, const void* quats, const void* opacity_logits, const void* sh_dc,
    const void* sh_rest, const void* alive, const void* offset, const void* colors_precomp,
    const void* cov3d_precomp, const void* world_view, const void* full_proj, const void* camera_center,
    const void* tan_fovx, const void* tan_fovy, const void* g_mean2d, const void* g_conic, const void* g_color,
    const void* g_opacity, void* g_means, void* g_log_scales, void* g_quats, void* g_opacity_logits, void* g_sh_dc,
    void* g_sh_rest, void* g_offset, void* g_colors_precomp, void* g_cov3d_precomp, int means_rs,
    int log_scales_rs, int quats_rs, int opacity_rs, int sh_dc_rs, int sh_rest_rs, int alive_rs, int offset_rs,
    int colors_rs, int cov3d_rs, int g_mean2d_rs, int g_conic_rs, int g_color_rs, int g_opacity_rs, int n,
    int k_rest, int degree, int width, int height, float scale_modifier, void* stream) {
  if (degree < 0 || degree > 4 || k_rest > kMaxRest) return static_cast<int>(cudaErrorInvalidValue);
  const Inputs in = make_inputs(means, log_scales, quats, opacity_logits, sh_dc, sh_rest, alive, offset,
                                colors_precomp, cov3d_precomp, world_view, full_proj, camera_center, tan_fovx,
                                tan_fovy, means_rs, log_scales_rs, quats_rs, opacity_rs, sh_dc_rs, sh_rest_rs,
                                alive_rs, offset_rs, colors_rs, cov3d_rs, n, k_rest, width, height, scale_modifier);
  Upstream gin{static_cast<const float*>(g_mean2d), static_cast<const float*>(g_conic),
               static_cast<const float*>(g_color), static_cast<const float*>(g_opacity), g_mean2d_rs, g_conic_rs,
               g_color_rs, g_opacity_rs};
  Grads gout{static_cast<float*>(g_means), static_cast<float*>(g_log_scales), static_cast<float*>(g_quats),
             static_cast<float*>(g_opacity_logits), static_cast<float*>(g_sh_dc), static_cast<float*>(g_sh_rest),
             static_cast<float*>(g_offset), static_cast<float*>(g_colors_precomp),
             static_cast<float*>(g_cov3d_precomp)};
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = slab_bytes(degree, in);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
    case 0: preprocess_backward_kernel<0><<<blocks, kThreads, smem, s>>>(in, gin, gout); break;
    case 1: preprocess_backward_kernel<1><<<blocks, kThreads, smem, s>>>(in, gin, gout); break;
    case 2: preprocess_backward_kernel<2><<<blocks, kThreads, smem, s>>>(in, gin, gout); break;
    case 3: preprocess_backward_kernel<3><<<blocks, kThreads, smem, s>>>(in, gin, gout); break;
    default: preprocess_backward_kernel<4><<<blocks, kThreads, smem, s>>>(in, gin, gout); break;
  }
  return static_cast<int>(cudaGetLastError());
}
