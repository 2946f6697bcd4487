// Building blocks shared by the fused NCSN++ block kernels:
//   - gn_apply_kernel: GroupNorm statistics of a map (two passes, fp32) and
//     then the normalised (+ SiLU) and naively 2x-resampled activation,
//     written once in the compute dtype;
//   - the split-K pass the block GEMMs share (the fp32 one of
//     resblock_f32.cu, the bf16 one of igemm_wgmma.cuh): the K slices'
//     partials summed in slice order, then the epilogue (bias, a
//     per-example row, a residual, a rescale).
//
// Layout: every map is NHWC. A map may be split at a channel seam across
// two tensors (the UNet up-path pair (h, skip)); the loaders index the
// logical concatenation, so the concatenated input is never materialised.
//
// Numerics follow diffpure_tpu/ops/fused_resblock.py: fp32 statistics
// (two-pass here, where the TPU kernel takes E[x^2] - mean^2), operands
// rounded to the compute dtype T before the product (the TPU kernel's pad
// scratch holds T too), products accumulated in fp32 (never TF32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace dp {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;  // threads per block for every kernel here
enum { RS_NONE = 0, RS_DOWN = 1, RS_UP = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and back: the value an operand stored as T would hold.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// VW consecutive elements (VW = 1, 4 or 8) as fp32: one 16-byte access for
// 4 fp32 or 8 bf16 values, 8 bytes for 4 bf16. p is VW-element aligned.
template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VW]) {
  if constexpr (VW == 1) {
    v[0] = *p;
  } else {
#pragma unroll
    for (int k = 0; k < VW; k += 4) {
      const float4 a = load4(p + k);
      v[k] = a.x; v[k + 1] = a.y; v[k + 2] = a.z; v[k + 3] = a.w;
    }
  }
}
template <int VW>
__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[VW]) {
  if constexpr (VW == 1) {
    v[0] = __bfloat162float(*p);
  } else if constexpr (VW == 4) {
    const float4 a = load4(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    static_assert(VW == 8, "bf16 vectors are 1, 4 or 8 wide");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x; v[2 * k + 1] = f.y;
    }
  }
}
template <int VW>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VW]) {
  if constexpr (VW == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int k = 0; k < VW; k += 4) store4(p + k, make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]));
  }
}
template <int VW>
__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[VW]) {
  if constexpr (VW == 1) {
    *p = __float2bfloat16(v[0]);
  } else if constexpr (VW == 4) {
    store4(p, make_float4(v[0], v[1], v[2], v[3]));
  } else {
    static_assert(VW == 8, "bf16 vectors are 1, 4 or 8 wide");
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// An NHWC map of H x W pixels whose channels are c0 from p0 then c1 from p1
// (c1 == 0: one tensor). Stored as T, or as fp32 when f32 != 0.
struct Src {
  const void* p0;
  const void* p1;
  int c0, c1;
  int H, W;
  int f32;
};

// 4 consecutive channels c..c+3 of pixel (y, x) of example n. The caller
// keeps c % 4 == 0 and the seam at a multiple of 4, so the 4 never straddle it.
template <typename T>
__device__ __forceinline__ float4 src_load4(const Src& s, int n, int y, int x, int c) {
  const long pix = ((long)n * s.H + y) * s.W + x;
  const void* base = s.p0;
  long idx = pix * s.c0 + c;
  if (c >= s.c0) {
    base = s.p1;
    idx = pix * s.c1 + (c - s.c0);
  }
  return s.f32 ? load4(static_cast<const float*>(base) + idx)
               : load4(static_cast<const T*>(base) + idx);
}

template <typename T>
__device__ __forceinline__ float src_load1(const Src& s, long pix, int c) {
  const void* base = s.p0;
  long idx = pix * s.c0 + c;
  if (c >= s.c0) {
    base = s.p1;
    idx = pix * s.c1 + (c - s.c0);
  }
  return s.f32 ? static_cast<const float*>(base)[idx]
               : to_f32(static_cast<const T*>(base)[idx]);
}

// ---------------------------------------------------------------------------
// GroupNorm: one block per (group, example). Two passes in fp32 give the
// group's mean and variance; a third writes the group's channels of
//   act = [SiLU]((x - mean) * rstd * gamma + beta)
// at the grid after the naive 2x resample (GN first, then resample, as the
// BigGAN block orders it), in T, NHWC with all C channels. Groups are taken
// over the logical concatenation of a split Src, so a group that straddles
// the seam gets one set of statistics. Normalising here, once per element,
// keeps it out of the conv's inner loop, where each element is read for
// nine taps. With raw != nullptr the pass also writes the resampled raw x
// (the skip branch's input), so every GEMM operand is a plain copy. The 2x2
// mean sums in the TPU kernel's order 0.5 * (0.5 * (v00 + v01) + 0.5 *
// (v10 + v11)).
// ---------------------------------------------------------------------------

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read by the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) t += red[i];
  return t;
}

struct GnArgs {
  Src src;
  int G;
  const float* gamma;
  const float* beta;
  float eps;
  int silu;
  int resample;
  void* act;  // (N, Ho, Wo, C) in T
  void* raw;  // (N, Ho, Wo, C) in T, or nullptr
};

template <typename T>
__global__ void __launch_bounds__(NT) gn_apply_kernel(const __grid_constant__ GnArgs a) {
  __shared__ float red[NT / 32];
  const Src& s = a.src;
  const int g = blockIdx.x, n = blockIdx.y;
  const int C = s.c0 + s.c1, cg = C / a.G, hw = s.H * s.W;
  const long cnt = (long)hw * cg;
  const long pix0 = (long)n * hw;

  float acc = 0.f;
  for (long e = threadIdx.x; e < cnt; e += NT) {
    const long p = e / cg;
    acc += src_load1<T>(s, pix0 + p, g * cg + (int)(e - p * cg));
  }
  const float mean = block_sum(acc, red) / (float)cnt;

  acc = 0.f;
  for (long e = threadIdx.x; e < cnt; e += NT) {
    const long p = e / cg;
    const float d = src_load1<T>(s, pix0 + p, g * cg + (int)(e - p * cg)) - mean;
    acc += d * d;
  }
  const float rstd = rsqrtf(block_sum(acc, red) / (float)cnt + a.eps);

  const int Ho = a.resample == RS_DOWN ? s.H / 2 : (a.resample == RS_UP ? s.H * 2 : s.H);
  const int Wo = a.resample == RS_DOWN ? s.W / 2 : (a.resample == RS_UP ? s.W * 2 : s.W);
  const long out0 = (long)n * Ho * Wo * C;
  for (long e = threadIdx.x; e < (long)Ho * Wo * cg; e += NT) {
    const int p = (int)(e / cg), c = g * cg + (int)(e - (long)p * cg);
    const int oy = p / Wo, ox = p - (p / Wo) * Wo;
    const float scale = rstd * a.gamma[c], shift = a.beta[c];
    auto load = [&](int y, int x) { return src_load1<T>(s, pix0 + (long)y * s.W + x, c); };
    auto norm = [&](float x) {
      const float v = (x - mean) * scale + shift;
      return a.silu ? silu(v) : v;
    };
    float v, r;
    if (a.resample == RS_DOWN) {
      const float x00 = load(2 * oy, 2 * ox), x01 = load(2 * oy, 2 * ox + 1);
      const float x10 = load(2 * oy + 1, 2 * ox), x11 = load(2 * oy + 1, 2 * ox + 1);
      v = 0.5f * (0.5f * (norm(x00) + norm(x01)) + 0.5f * (norm(x10) + norm(x11)));
      r = 0.5f * (0.5f * (x00 + x01) + 0.5f * (x10 + x11));
    } else {
      r = a.resample == RS_UP ? load(oy >> 1, ox >> 1) : load(oy, ox);
      v = norm(r);
    }
    static_cast<T*>(a.act)[out0 + (long)p * C + c] = from_f32<T>(v);
    if (a.raw != nullptr) static_cast<T*>(a.raw)[out0 + (long)p * C + c] = from_f32<T>(r);
  }
}

template <typename T>
cudaError_t launch_gn_apply(const GnArgs& a, int N, cudaStream_t st) {
  gn_apply_kernel<T><<<dim3(a.G, N), NT, 0, st>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The split-K epilogue of the block GEMMs: out[M, Nc] = (the sum of the
// K slices' partials + bias + temb[n] + resid) * oscale, row m being
// output pixel (n, oy, ox) of an Ho x Wo grid; resid is channels col.. of
// the resid source at the row's pixel (an identity skip). Stored as T or
// fp32.
// ---------------------------------------------------------------------------

struct GemmArgs {
  int M, Nc;
  int Ho, Wo;
  const float* bias;
  const void* temb;
  int has_resid;
  Src resid;
  float oscale;
  void* out;
  int out_f32;
  int splits;
  float* ws;  // (splits, M, Nc) partials
};

// (acc + bias + temb[n] + resid) * oscale for 4 columns of one row, stored.
// bias may be nullptr (the backward's transposed convs have none).
template <typename T>
__device__ __forceinline__ void epilogue4(const GemmArgs& a, int row, int col, float4 v) {
  const int hw = a.Ho * a.Wo;
  if (a.bias != nullptr) {
    const float4 b = load4(a.bias + col);
    v.x += b.x; v.y += b.y; v.z += b.z; v.w += b.w;
  }
  if (a.temb != nullptr) {
    const float4 t = load4(static_cast<const T*>(a.temb) + (long)(row / hw) * a.Nc + col);
    v.x += t.x; v.y += t.y; v.z += t.z; v.w += t.w;
  }
  if (a.has_resid) {
    const int n = row / hw, p = row - n * hw, y = p / a.Wo, x = p - y * a.Wo;
    const float4 r = src_load4<T>(a.resid, n, y, x, col);
    v.x += r.x; v.y += r.y; v.z += r.z; v.w += r.w;
  }
  v.x *= a.oscale; v.y *= a.oscale; v.z *= a.oscale; v.w *= a.oscale;
  if (a.out_f32)
    store4(static_cast<float*>(a.out) + (long)row * a.Nc + col, v);
  else
    store4(static_cast<T*>(a.out) + (long)row * a.Nc + col, v);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Sums the K-slices' partials in slice order (deterministic), then the
// epilogue. One thread per 4 outputs.
template <typename T>
__global__ void __launch_bounds__(NT) splitk_epilogue_kernel(const __grid_constant__ GemmArgs a) {
  const long i = ((long)blockIdx.x * NT + threadIdx.x) * 4;
  if (i >= (long)a.M * a.Nc) return;
  const int row = (int)(i / a.Nc), col = (int)(i - (long)row * a.Nc);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z = 0; z < a.splits; ++z) {
    const float4 p = load4(a.ws + ((long)z * a.M + row) * a.Nc + col);
    v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
  }
  epilogue4<T>(a, row, col, v);
}

inline int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

}  // namespace dp
