// GroupNorm (+ SiLU) over one NHWC map, one (example, group) slice at a
// time, fp32 statistics, bf16 or fp32 maps: kernel #10's body
// (group_norm_silu.cu) and the GroupNorm step of #3's fp32 chain
// (attnblock_f32.cu, without the SiLU).
//
//   out = [silu]((x - mean_g) * rstd_g * gamma_c + beta_c)
//
// rounded once, at the store, to the map's dtype. The variance is two-pass,
// sum((x - mean)^2), as the port's plain version takes it.
//
// The launch follows a plan of 5 ints, (route, vw, nv, tps, threads), from
// ops/groupnorm.py gn_silu_plan:
//   route 0 (registers): a slice is held by tps threads (a power of two),
//     each with nv vectors of vw elements (16 bytes: 4 fp32 or 8 bf16 where
//     the group's channels allow) in registers, all loads issued before the
//     first is used. Thread t holds the slice's vectors t, t + tps, ...;
//     neighbouring threads read neighbouring vectors. tps <= 32: a warp
//     holds one or several slices and a block of `threads` holds
//     threads / tps of them, the sums are warp shuffles alone; tps > 32: a
//     block is one slice, its sums are shuffles and one shared-memory round.
//     So the map is read once and written once, with two reductions and no
//     staging between them; the block's gamma and beta are staged in shared
//     memory while the loads are in flight, and the SiLU takes the fast
//     exponential and divide;
//   route 1 (L2): a slice above the register budget (tps = 1024 threads of
//     nv vectors) takes one block of `threads`, which reads it three times
//     (sum, squared deviation, apply), the second and third from L2.
#pragma once

#include "common.cuh"

namespace dp {

struct GnsPlan {
  int route, vw, nv, tps, threads;
};
// The registers route's bounds: vectors a slice (the float index math is
// exact below 2^13) and the staged gamma and beta of a block (bytes, within
// the default dynamic shared memory).
constexpr long GNS_MAX_VECS = 8192, GNS_MAX_SMEM = 48 * 1024;

// The largest nv built for a vector width: 32 elements a thread (vw 4, 8),
// 8 for single elements.
template <int VW> constexpr int gns_nv_max() { return VW == 8 ? 4 : 8; }

// The sum over the tps threads of a slice (tps a power of two). tps > 32:
// the block is one slice (blockDim.x == tps); red holds a float per warp.
__device__ __forceinline__ float slice_sum(float v, int tps, float* red) {
  for (int o = (tps < 32 ? tps : 32) >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  if (tps <= 32) return v;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < (tps >> 5); ++w) t += red[w];
  return t;
}

// SiLU with the fast exponential and divide: within 1e-6 of silu(), where
// the kernel's own tolerance is 1e-4 (fp32) and the store rounds bf16.
__device__ __forceinline__ float silu_fast(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

// A slice's vector i holds channels (i % vpp) * VW.. of the group at pixel
// i / vpp, vpp = (C / G) / VW vectors a pixel. The block's gamma and beta,
// a row of C / G each per slice, are staged in shared memory (gns_gb) while
// the map's loads are in flight.
template <typename T, int VW, int NV, bool SILU>
__device__ __forceinline__ void gns_regs(const T* __restrict__ x, const float* __restrict__ gamma,
                                         const float* __restrict__ beta, int slices, int HW,
                                         int C, int G, int tps, float eps, T* __restrict__ out) {
  extern __shared__ float gns_gb[];  // [slices a block][2][C / G]
  __shared__ float red[2][32];
  const int cg = C / G, vpp = cg / VW, nvec = HW * vpp, spb = blockDim.x / tps;
  const int lt = threadIdx.x & (tps - 1), ls = threadIdx.x / tps;
  const int s0 = blockIdx.x * spb, s = s0 + ls;
  const bool live = s < slices;
  const int n = s / G, g = s - n * G;
  const long base = (long)n * HW * C + (long)g * cg;
  // i / vpp by a float reciprocal: exact for i < 2^13 (the route's bound)
  const float rvpp = 1.f / (float)vpp;
  auto pixel = [&](int i) { return __float2int_rz(((float)i + 0.5f) * rvpp); };
  float v[NV][VW];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lt + k * tps;
    if (live && i < nvec) {
      const int p = pixel(i);
      load_vec<VW>(x + base + (long)p * C + (i - p * vpp) * VW, v[k]);
    } else {
#pragma unroll
      for (int e = 0; e < VW; ++e) v[k][e] = 0.f;
    }
  }
  for (int e = threadIdx.x; e < spb * cg; e += blockDim.x) {
    const int t = e / cg, c = e - t * cg, gt = ((s0 + t) % G) * cg + c;
    gns_gb[2 * t * cg + c] = gamma[gt];
    gns_gb[(2 * t + 1) * cg + c] = beta[gt];
  }
  __syncthreads();
  const float inv_cnt = 1.f / ((float)HW * (float)cg);
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int e = 0; e < VW; ++e) acc += v[k][e];
  const float mean = slice_sum(acc, tps, red[0]) * inv_cnt;
  acc = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (lt + k * tps < nvec) {
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const float d = v[k][e] - mean;
        acc += d * d;
      }
    }
  }
  const float rstd = rsqrtf(slice_sum(acc, tps, red[1]) * inv_cnt + eps);
  if (!live) return;
  const float* gm = gns_gb + 2 * ls * cg;
  const float* bt = gm + cg;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lt + k * tps;
    if (i >= nvec) continue;
    const int p = pixel(i), j = (i - p * vpp) * VW;
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      const float h = (v[k][e] - mean) * (rstd * gm[j + e]) + bt[j + e];
      v[k][e] = SILU ? silu_fast(h) : h;
    }
    store_vec<VW>(out + base + (long)p * C + j, v[k]);
  }
}

template <typename T, int VW, bool SILU>
__device__ __forceinline__ void gns_l2(const T* __restrict__ x, const float* __restrict__ gamma,
                                       const float* __restrict__ beta, int HW, int C, int G,
                                       float eps, T* __restrict__ out) {
  __shared__ float red[2][32];
  constexpr int U = 4;  // vectors in flight a thread
  const int cg = C / G, vpp = cg / VW, bd = blockDim.x;
  const long nvec = (long)HW * vpp;
  const int n = blockIdx.x / G, g = blockIdx.x - n * G;
  const long base = (long)n * HW * C + (long)g * cg;
  auto offset = [&](long i) {
    const long p = i / vpp;
    return base + p * C + (i - p * vpp) * VW;
  };
  auto fetch = [&](long i0, float (&v)[U][VW]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long i = i0 + (long)u * bd;
      if (i < nvec) {
        load_vec<VW>(x + offset(i), v[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VW; ++e) v[u][e] = 0.f;
      }
    }
  };
  const float inv_cnt = 1.f / ((float)HW * (float)cg);
  float acc = 0.f;
  for (long i0 = threadIdx.x; i0 < nvec; i0 += (long)U * bd) {
    float v[U][VW];
    fetch(i0, v);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < VW; ++e) acc += v[u][e];
  }
  const float mean = slice_sum(acc, bd, red[0]) * inv_cnt;
  acc = 0.f;
  for (long i0 = threadIdx.x; i0 < nvec; i0 += (long)U * bd) {
    float v[U][VW];
    fetch(i0, v);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + (long)u * bd >= nvec) continue;
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const float d = v[u][e] - mean;
        acc += d * d;
      }
    }
  }
  const float rstd = rsqrtf(slice_sum(acc, bd, red[1]) * inv_cnt + eps);
  for (long i0 = threadIdx.x; i0 < nvec; i0 += (long)U * bd) {
    float v[U][VW];
    fetch(i0, v);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long i = i0 + (long)u * bd;
      if (i >= nvec) continue;
      const int c0 = g * cg + (int)(i % vpp) * VW;
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const float h = (v[u][e] - mean) * (rstd * gamma[c0 + e]) + beta[c0 + e];
        v[u][e] = SILU ? silu_fast(h) : h;
      }
      store_vec<VW>(out + offset(i), v[u]);
    }
  }
}

// Kernel #10 (with the SiLU) and the GroupNorm alone (#3's fp32 chain),
// under their own names so that a profile tells the two apart.
template <typename T, int VW, int NV>
__global__ void __launch_bounds__(1024, 1)
gnsilu_regs_kernel(const T* x, const float* gamma, const float* beta, int slices, int HW, int C,
                   int G, int tps, float eps, T* out) {
  gns_regs<T, VW, NV, true>(x, gamma, beta, slices, HW, C, G, tps, eps, out);
}
template <typename T, int VW, int NV>
__global__ void __launch_bounds__(1024, 1)
gn_regs_kernel(const T* x, const float* gamma, const float* beta, int slices, int HW, int C,
               int G, int tps, float eps, T* out) {
  gns_regs<T, VW, NV, false>(x, gamma, beta, slices, HW, C, G, tps, eps, out);
}
template <typename T, int VW>
__global__ void __launch_bounds__(1024)
gnsilu_l2_kernel(const T* x, const float* gamma, const float* beta, int HW, int C, int G,
                 float eps, T* out) {
  gns_l2<T, VW, true>(x, gamma, beta, HW, C, G, eps, out);
}
template <typename T, int VW>
__global__ void __launch_bounds__(1024)
gn_l2_kernel(const T* x, const float* gamma, const float* beta, int HW, int C, int G, float eps,
             T* out) {
  gns_l2<T, VW, false>(x, gamma, beta, HW, C, G, eps, out);
}

template <typename T, int VW, bool SILU, int NV>
cudaError_t gns_launch_regs(const GnsPlan& p, const T* x, const float* gamma, const float* beta,
                            int N, int HW, int C, int G, float eps, T* out, cudaStream_t st) {
  if constexpr (NV > gns_nv_max<VW>()) {
    return cudaErrorInvalidValue;
  } else {
    if (p.nv != NV)
      return gns_launch_regs<T, VW, SILU, NV + 1>(p, x, gamma, beta, N, HW, C, G, eps, out, st);
    const int spb = p.threads / p.tps;
    const dim3 grid((unsigned)((N * G + spb - 1) / spb));
    const size_t smem = sizeof(float) * 2 * spb * (C / G);
    if constexpr (SILU)
      gnsilu_regs_kernel<T, VW, NV><<<grid, p.threads, smem, st>>>(x, gamma, beta, N * G, HW, C,
                                                                    G, p.tps, eps, out);
    else
      gn_regs_kernel<T, VW, NV><<<grid, p.threads, smem, st>>>(x, gamma, beta, N * G, HW, C, G,
                                                                p.tps, eps, out);
    return cudaGetLastError();
  }
}

template <typename T, int VW, bool SILU>
cudaError_t gns_launch_vw(const GnsPlan& p, const T* x, const float* gamma, const float* beta,
                          int N, int HW, int C, int G, float eps, T* out, cudaStream_t st) {
  if (p.route == 0)
    return gns_launch_regs<T, VW, SILU, 1>(p, x, gamma, beta, N, HW, C, G, eps, out, st);
  if constexpr (SILU)
    gnsilu_l2_kernel<T, VW><<<N * G, p.threads, 0, st>>>(x, gamma, beta, HW, C, G, eps, out);
  else
    gn_l2_kernel<T, VW><<<N * G, p.threads, 0, st>>>(x, gamma, beta, HW, C, G, eps, out);
  return cudaGetLastError();
}

// Checks the plan against the shape and launches. fp32 maps take vw 4 or 1,
// bf16 vw 8, 4 or 1; vw divides the group's channels.
template <typename T, bool SILU>
cudaError_t gns_launch(const int* plan, const T* x, const float* gamma, const float* beta, int N,
                       int HW, int C, int G, float eps, T* out, cudaStream_t st) {
  if (plan == nullptr || N < 1 || HW < 1 || G < 1 || C % G) return cudaErrorInvalidValue;
  const GnsPlan p = {plan[0], plan[1], plan[2], plan[3], plan[4]};
  const int cg = C / G;
  const bool pow2 = p.tps >= 1 && (p.tps & (p.tps - 1)) == 0;
  if (p.vw < 1 || cg % p.vw || !pow2 || p.threads > 1024 || p.threads % 32 || p.nv < 1 ||
      (p.route == 0 && (p.threads % p.tps || (p.tps > 32 && p.threads != p.tps) ||
                        (long)p.tps * p.nv * p.vw < (long)HW * cg ||
                        (long)p.tps * p.nv > GNS_MAX_VECS ||
                        8L * (p.threads / p.tps) * cg > GNS_MAX_SMEM)) ||
      (p.route == 1 && (p.threads != p.tps || p.tps < 64)) || (p.route != 0 && p.route != 1))
    return cudaErrorInvalidValue;
  if (p.vw == 4) return gns_launch_vw<T, 4, SILU>(p, x, gamma, beta, N, HW, C, G, eps, out, st);
  if (p.vw == 1) return gns_launch_vw<T, 1, SILU>(p, x, gamma, beta, N, HW, C, G, eps, out, st);
  if constexpr (std::is_same<T, bf16>::value) {
    if (p.vw == 8) return gns_launch_vw<T, 8, SILU>(p, x, gamma, beta, N, HW, C, G, eps, out, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace dp
