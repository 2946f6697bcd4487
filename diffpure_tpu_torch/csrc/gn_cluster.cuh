// The fused BigGAN block's GroupNorm passes for Hopper, forward
// (rb_gn_kernel: act = resample(SiLU(GN(x))), and optionally the groups'
// statistics; with no_silu, act = GN(x), the NCSN++ attention block's
// GroupNorm, fused_attnblock.cu) and backward
// (rb_gn_bwd_kernel: the input gradient of that through the resample), one
// thread-block cluster per example. Shared by the block's forward chains
// (fused_resblock.cu's bf16 and resblock_f32.cu's fp32, kernels #1 / #2)
// and its backward chains (fused_resblock_bwd.cu's bf16 and
// resblock_f32.cu's fp32, kernels #4 / #5, which recompute h1 with the
// forward's pass).
#pragma once

#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <utility>

#include "common.cuh"

namespace dp {

namespace cg = cooperative_groups;

// ---------------------------------------------------------------------------
// GroupNorm + SiLU (+ naive 2x resample) pass: act = resample(SiLU(GN(x)))
// in TO and, with raw != nullptr, raw = resample(x) in TO, for x = x1 | x2
// (TI) or h1 (fp32): TI = bf16 or fp32 with TO = bf16 in the bf16 chains,
// TI = TO = fp32 in the fp32 chains (resblock_f32.cu). One cluster
// of CL <= GN_CLUSTER blocks per example
// (blockIdx.y; CL from the map's size, launch_rb_gn); block b of it takes
// input pixels [b HW / CL, (b + 1) HW / CL).
// A thread owns the VEC channels v VEC.. (16 bytes of the input) of every
// rows-th pixel of its block's share, so its loads are whole vectors along
// the contiguous channels and a warp reads contiguous bytes. The first
// GN_RES of its vectors stay in registers from the first pass to the last,
// so a map of up to GN_CLUSTER x GN_THREADS x GN_RES vectors per example
// (32x32 x 256 bf16 or x 128 fp32) is read from memory once; the rest, and
// a down-sampling block's 2x2 windows, are read again. The cluster's blocks
// sum each other's per-group partials in rank order: every block gets the
// same statistics, and a run repeats bit for bit.
// ---------------------------------------------------------------------------

constexpr int GN_CLUSTER = 8;    // at most this many blocks per example (portable)
constexpr int GN_THREADS = 512;
constexpr int GN_RES = 8;        // 16-byte vectors a thread keeps in registers
constexpr int GN_MAX_C = 1024;   // channels the shared scratch holds
constexpr int GN_MAX_G = 64;

template <typename TI> struct GnVec;
template <> struct GnVec<bf16> {
  static constexpr int VEC = 8;
  __device__ static void unpack(const uint4& u, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
};
template <> struct GnVec<float> {
  static constexpr int VEC = 4;
  __device__ static void unpack(const uint4& u, float (&v)[4]) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
};

template <typename TI>
__device__ __forceinline__ void gn_load(const TI* p, float (&v)[GnVec<TI>::VEC]) {
  GnVec<TI>::unpack(*reinterpret_cast<const uint4*>(p), v);
}

struct RbGnArgs {
  const void* x1;  // (N, H, W, c1), TI
  const void* x2;  // (N, H, W, c2), TI, or nullptr (c2 == 0)
  int c1, c2, H, W, G;
  const float* gamma;
  const float* beta;
  float eps;
  int resample;
  void* act;      // (N, Ho, Wo, C), TO
  void* raw;      // (N, Ho, Wo, C), TO, or nullptr
  float2* stats;  // (N, G) (mean, rstd) out, or nullptr
  int cl;         // blocks per example: the cluster's size
  int no_silu;    // 1: act = resample(GN(x)), the affine without the SiLU
};

// Per-channel sums over the block of the per-thread, per-channel partials
// in s (written to part[r][c]), in a fixed order (rows): chan[c].
template <int VEC>
__device__ __forceinline__ void gn_block_chan(const float (&s)[VEC], bool active, int r, int c0,
                                              int rows, int C, float* part, float* chan) {
  if (active) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) part[r * C + c0 + k] = s[k];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += GN_THREADS) {
    float t = 0.f;
    for (int i = 0; i < rows; ++i) t += part[i * C + c];
    chan[c] = t;
  }
  __syncthreads();
}

// Per-group sums over the block: gn_block_chan, then a group's cgs
// channels in order; gout[g] gets group g's sum.
template <int VEC>
__device__ __forceinline__ void gn_block_groups(const float (&s)[VEC], bool active, int r, int c0,
                                                int rows, int C, int cgs, int G, float* part,
                                                float* chan, float* gout) {
  gn_block_chan<VEC>(s, active, r, c0, rows, C, part, chan);
  if (threadIdx.x < G) {
    float t = 0.f;
    for (int c = threadIdx.x * cgs; c < (threadIdx.x + 1) * cgs; ++c) t += chan[c];
    gout[threadIdx.x] = t;
  }
}

template <typename TI, typename TO = bf16>
__global__ void __launch_bounds__(GN_THREADS) rb_gn_kernel(const __grid_constant__ RbGnArgs a) {
  constexpr int VEC = GnVec<TI>::VEC;
  __shared__ float part[GN_THREADS * 8];
  __shared__ float chan[GN_MAX_C];
  __shared__ float gsum[GN_MAX_G], gsq[GN_MAX_G], gmean[GN_MAX_G], grstd[GN_MAX_G];
  __shared__ float gather[GN_CLUSTER * GN_MAX_G];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = (int)cluster.block_rank(), n = blockIdx.y;
  const int C = a.c1 + a.c2, cg_ = C / a.G, hw = a.H * a.W;
  const int vpp = C / VEC, rows = GN_THREADS / vpp;
  const int tid = threadIdx.x, r = tid / vpp, v = tid - r * vpp, c0 = v * VEC;
  const bool active = r < rows;
  // this thread's 16-byte column: channels c0.. of x1 or of x2
  const TI* base = c0 < a.c1
      ? static_cast<const TI*>(a.x1) + (long)n * hw * a.c1 + c0
      : static_cast<const TI*>(a.x2) + (long)n * hw * a.c2 + (c0 - a.c1);
  const int pitch = c0 < a.c1 ? a.c1 : a.c2;
  const int p0 = (int)((long)b * hw / a.cl) + r, p1 = (int)((long)(b + 1) * hw / a.cl);
  const int ptail = p0 + GN_RES * rows;  // this thread's first pixel not kept in registers
  const float cnt = (float)hw * (float)cg_;
  float gamma[VEC], beta[VEC];  // loaded now, used in the last pass
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    gamma[k] = active ? a.gamma[c0 + k] : 0.f;
    beta[k] = active ? a.beta[c0 + k] : 0.f;
  }
  // gout[g] = f(group g's total / cnt), the total of every block's
  // partial gpart[g], gathered in parallel from the cluster's shared
  // memories and summed in rank order
  auto cluster_total = [&](float* gpart, float* gout, bool rstd) {
    cluster.sync();  // every block's gpart is written
    if (tid < a.cl * a.G)
      gather[tid] = cluster.map_shared_rank(gpart, tid / a.G)[tid % a.G];
    __syncthreads();
    if (tid < a.G) {
      float t = 0.f;
      for (int q = 0; q < a.cl; ++q) t += gather[q * a.G + tid];
      gout[tid] = rstd ? rsqrtf(t / cnt + a.eps) : t / cnt;
    }
  };

  // pass 1: the mean; the first GN_RES vectors land in registers
  uint4 xr[GN_RES];
  float s[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s[k] = 0.f;
#pragma unroll
  for (int i = 0; i < GN_RES; ++i) {
    const int p = p0 + i * rows;
    if (active && p < p1) {
      xr[i] = *reinterpret_cast<const uint4*>(base + (long)p * pitch);
    } else {
      xr[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
#pragma unroll
  for (int i = 0; i < GN_RES; ++i) {
    if (active && p0 + i * rows < p1) {
      float x[VEC];
      GnVec<TI>::unpack(xr[i], x);
#pragma unroll
      for (int k = 0; k < VEC; ++k) s[k] += x[k];
    }
  }
  if (active) {
    for (int p = ptail; p < p1; p += rows) {
      float x[VEC];
      gn_load<TI>(base + (long)p * pitch, x);
#pragma unroll
      for (int k = 0; k < VEC; ++k) s[k] += x[k];
    }
  }
  gn_block_groups<VEC>(s, active, r, c0, rows, C, cg_, a.G, part, chan, gsum);
  cluster_total(gsum, gmean, false);
  __syncthreads();
  float mean[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) mean[k] = gmean[(c0 + k) / cg_];

  // pass 2: the variance about the mean (two-pass, as the plain version)
#pragma unroll
  for (int k = 0; k < VEC; ++k) s[k] = 0.f;
  auto add_sq = [&](const float (&x)[VEC]) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float d = x[k] - mean[k];
      s[k] += d * d;
    }
  };
#pragma unroll
  for (int i = 0; i < GN_RES; ++i) {
    if (active && p0 + i * rows < p1) {
      float x[VEC];
      GnVec<TI>::unpack(xr[i], x);
      add_sq(x);
    }
  }
  if (active) {
    for (int p = ptail; p < p1; p += rows) {
      float x[VEC];
      gn_load<TI>(base + (long)p * pitch, x);
      add_sq(x);
    }
  }
  gn_block_groups<VEC>(s, active, r, c0, rows, C, cg_, a.G, part, chan, gsq);
  cluster_total(gsq, grstd, true);
  if (a.stats != nullptr && b == 0 && tid < a.G)
    a.stats[(long)n * a.G + tid] = make_float2(gmean[tid], grstd[tid]);
  cluster.sync();  // no block reads another's shared memory after this
  if (!active) return;
  float scale[VEC], shift[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    scale[k] = grstd[(c0 + k) / cg_] * gamma[k];
    shift[k] = beta[k];
  }
  auto norm = [&](const float (&x)[VEC], float (&o)[VEC]) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float v = (x[k] - mean[k]) * scale[k] + shift[k];
      o[k] = a.no_silu ? v : silu(v);
    }
  };

  // pass 3: the output
  const int Ho = a.resample == RS_DOWN ? a.H / 2 : (a.resample == RS_UP ? a.H * 2 : a.H);
  const int Wo = a.resample == RS_DOWN ? a.W / 2 : (a.resample == RS_UP ? a.W * 2 : a.W);
  const int ohw = Ho * Wo;
  TO* act = static_cast<TO*>(a.act) + (long)n * ohw * C + c0;
  TO* raw = a.raw != nullptr ? static_cast<TO*>(a.raw) + (long)n * ohw * C + c0 : nullptr;
  if (a.resample == RS_DOWN) {
    // output pixels [b OHW / CL, (b + 1) OHW / CL), each from its 2x2 window
    const int q1 = (int)((long)(b + 1) * ohw / a.cl);
    for (int q = (int)((long)b * ohw / a.cl) + r; q < q1; q += rows) {
      const int oy = q / Wo, ox = q - oy * Wo;
      float x00[VEC], x01[VEC], x10[VEC], x11[VEC], n00[VEC], n01[VEC], n10[VEC], n11[VEC];
      float o[VEC], x[VEC];
      const TI* p = base + ((long)(2 * oy) * a.W + 2 * ox) * pitch;
      gn_load<TI>(p, x00);
      gn_load<TI>(p + pitch, x01);
      gn_load<TI>(p + (long)a.W * pitch, x10);
      gn_load<TI>(p + (long)(a.W + 1) * pitch, x11);
      norm(x00, n00);
      norm(x01, n01);
      norm(x10, n10);
      norm(x11, n11);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        o[k] = 0.5f * (0.5f * (n00[k] + n01[k]) + 0.5f * (n10[k] + n11[k]));
        x[k] = 0.5f * (0.5f * (x00[k] + x01[k]) + 0.5f * (x10[k] + x11[k]));
      }
      store_vec<VEC>(act + (long)q * C, o);
      if (raw != nullptr) store_vec<VEC>(raw + (long)q * C, x);
    }
    return;
  }
  // none / up: the output pixels of this thread's input pixels (up: the 2x2
  // block each one is repeated into)
  auto emit = [&](int p, const float (&x)[VEC]) {
    float o[VEC];
    norm(x, o);
    if (a.resample == RS_NONE) {
      store_vec<VEC>(act + (long)p * C, o);
      return;
    }
    const int y = p / a.W, xx = p - y * a.W;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long q = (long)(2 * y + (j >> 1)) * Wo + 2 * xx + (j & 1);
      store_vec<VEC>(act + q * C, o);
      if (raw != nullptr) store_vec<VEC>(raw + q * C, x);
    }
  };
#pragma unroll
  for (int i = 0; i < GN_RES; ++i) {
    const int p = p0 + i * rows;
    if (p < p1) {
      float x[VEC];
      GnVec<TI>::unpack(xr[i], x);
      emit(p, x);
    }
  }
  for (int p = ptail; p < p1; p += rows) {
    float x[VEC];
    gn_load<TI>(base + (long)p * pitch, x);
    emit(p, x);
  }
}

// kernel<<<(cl, N) in clusters of cl, GN_THREADS>>>'s launch configuration
inline cudaLaunchConfig_t gn_cluster_config(int cl, int N, cudaStream_t st,
                                            cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, N);
  cfg.blockDim = dim3(GN_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of cl blocks of `kernel` the card runs at once (cached).
inline int gn_max_clusters(const void* kernel, int cl) {
  static std::mutex lock;
  static std::map<std::pair<const void*, int>, int> seen;
  std::lock_guard<std::mutex> guard(lock);
  const auto key = std::make_pair(kernel, cl);
  const auto it = seen.find(key);
  if (it != seen.end()) return it->second;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = gn_cluster_config(cl, 1, nullptr, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    n = 0;
  }
  seen[key] = n;
  return n;
}

// CL for one cluster per example: a power of two up to GN_CLUSTER, enough
// that each thread keeps at most `res` of the example's `vectors` in
// registers, and else as large as lets all N clusters run at once (a small
// batch's pass is a chain of latencies: on an H100 at batch 8, one block
// per example at 4x4 and 8x8 was slower than eight; at batch 16, eight
// blocks per example took two waves of clusters and twice the time).
inline int gn_cluster_size(const void* kernel, long vectors, int res, int N) {
  int cl = 1;
  while (cl < GN_CLUSTER &&
         (vectors > (long)cl * GN_THREADS * res || N <= gn_max_clusters(kernel, 2 * cl)))
    cl *= 2;
  return cl;
}

// kernel<<<(cl, N) in clusters of cl, GN_THREADS>>>(a)
template <typename Args>
cudaError_t launch_gn_cluster(void (*kernel)(Args), const Args& a, int cl, int N,
                              cudaStream_t st) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = gn_cluster_config(cl, N, st, attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Requires C % VEC == 0 with the seam c1 at a multiple of VEC, C <=
// GN_MAX_C, G <= GN_MAX_G, C % G == 0 (the caller checks).
template <typename TI, typename TO = bf16>
cudaError_t launch_rb_gn(RbGnArgs a, int N, cudaStream_t st) {
  a.cl = gn_cluster_size(reinterpret_cast<const void*>(rb_gn_kernel<TI, TO>),
                         (long)a.H * a.W * (a.c1 + a.c2) / GnVec<TI>::VEC, GN_RES, N);
  return launch_gn_cluster(rb_gn_kernel<TI, TO>, a, a.cl, N, st);
}

// ---------------------------------------------------------------------------
// The GroupNorm + SiLU backward pass, in rb_gn_kernel's layout:
// the input gradient of act = SiLU(GN(x)) through the block's resample,
//   xhat = (x - mean) rstd, y = xhat gamma + beta,
//   dxhat = d silu'(y) gamma,
//   dx = rstd (dxhat - mean_g(dxhat) - xhat mean_g(dxhat xhat)),
// (JAX _gn_silu_bwd_inkernel, diffpure_tpu/ops/fused_resblock.py:140), for
// x = x1 | x2 (bf16 in the bf16 chain) or h1 (fp32; in the fp32 chain x1 |
// x2 too) on the input grid H x W, and d the
// cotangent of act on the output grid, read through the resample's
// transpose (1/4 of the one output pixel of a down block's 2x2 mean, the
// sum of the four copies of an up block's nearest 2x, in JAX's order). The
// output adds add_scale x (add through the same transpose) and is split at
// the seam c1 into out1 | out2 (the concat block's dx1 | dx2; a vector
// never straddles it); with dsum != nullptr, dsum[n, c] = the sum over HW
// of the output before the add (the temb row's cotangent).
// The group statistics come from `stats` (the chain's GN1 recompute wrote
// them: GN1's backward needs no statistics round of its own), or, for GN2,
// from one round of sums and sums of squares (var = E[x^2] - mean^2, as
// JAX's kernel takes them). Then one round for the two dxhat means, and
// the output. One cluster of CL blocks per example (launch_rb_gn_bwd), each
// thread VEC channels of every rows-th pixel of its block's share, its
// first GN_RES_B pixels' x kept in registers (d is read in the dxhat pass
// and again beside `add` in the output pass). Every reduction runs in a
// fixed order (rows, then the group's channels, then the cluster's ranks),
// so a run repeats bit for bit.
// ---------------------------------------------------------------------------

constexpr int GN_RES_B = 4;       // pixels whose x a thread keeps in registers
constexpr int GN_CLUSTER_B = 16;  // at most this many blocks per example (non-portable)

struct RbGnBwdArgs {
  const void* x1;  // (N, H, W, c1), TI
  const void* x2;  // (N, H, W, c2), TI, or nullptr (c2 == 0)
  int c1, c2, H, W, G;
  const float* gamma;
  const float* beta;
  float eps;
  const float2* stats;  // (N, G) (mean, rstd) of x, or nullptr: computed here
  const float* d;       // (N, Ho, Wo, C) fp32
  int resample;         // RS_*: x's grid -> d's
  const void* add;      // (N, Ho, Wo, C), fp32 if add_f32 else bf16, or nullptr
  int add_f32;
  float add_scale;
  void* out1;    // (N, H, W, c1), TO
  void* out2;    // (N, H, W, c2), TO, or nullptr
  float* dsum;   // (N, C) or nullptr
  int cl;        // blocks per example: the cluster's size
};

template <int VEC>
__device__ __forceinline__ void gn_load_f32(const float* p, float (&v)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; k += 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + k);
    v[k] = t.x;
    v[k + 1] = t.y;
    v[k + 2] = t.z;
    v[k + 3] = t.w;
  }
}
template <int VEC>
__device__ __forceinline__ void gn_load_bf16(const bf16* p, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    GnVec<bf16>::unpack(*reinterpret_cast<const uint4*>(p), v);
  } else {
    static_assert(VEC == 4, "bf16 vectors here are 4 or 8 wide");
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
}

// src (fp32, or bf16 with f32 == 0; this example's and thread's channels,
// row pitch C, Ho x Wo) at input pixel (y, x) through the resample's transpose
template <int VEC>
__device__ __forceinline__ void gn_load_transposed(const void* src, int f32, int resample, int C,
                                                   int Wo, int y, int x, float (&v)[VEC]) {
  auto at = [&](long q, float (&o)[VEC]) {
    if (f32)
      gn_load_f32<VEC>(static_cast<const float*>(src) + q * C, o);
    else
      gn_load_bf16<VEC>(static_cast<const bf16*>(src) + q * C, o);
  };
  if (resample == RS_DOWN) {
    at((long)(y >> 1) * Wo + (x >> 1), v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] *= 0.25f;
  } else if (resample == RS_UP) {
    const long q = (long)(2 * y) * Wo + 2 * x;
    float a[VEC], b[VEC], c[VEC];
    at(q, v);
    at(q + 1, a);
    at(q + Wo, b);
    at(q + Wo + 1, c);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = (v[k] + a[k]) + (b[k] + c[k]);
  } else {
    at((long)y * Wo + x, v);
  }
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(GN_THREADS)
    rb_gn_bwd_kernel(const __grid_constant__ RbGnBwdArgs a) {
  constexpr int VEC = GnVec<TI>::VEC;
  __shared__ float part[GN_THREADS * 8];
  __shared__ float chan[GN_MAX_C];
  __shared__ float gp[4][GN_MAX_G];    // this block's partials of the two rounds
  __shared__ float gt[4][GN_MAX_G];    // the example's totals / cnt
  __shared__ float gather[2 * GN_CLUSTER_B * GN_MAX_G];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = (int)cluster.block_rank(), n = blockIdx.y;
  const int C = a.c1 + a.c2, cg_ = C / a.G, hw = a.H * a.W;
  const int Wo = a.resample == RS_DOWN ? a.W / 2 : (a.resample == RS_UP ? a.W * 2 : a.W);
  const int Ho = a.resample == RS_DOWN ? a.H / 2 : (a.resample == RS_UP ? a.H * 2 : a.H);
  const int vpp = C / VEC, rows = GN_THREADS / vpp;
  const int tid = threadIdx.x, r = tid / vpp, v = tid - r * vpp, c0 = v * VEC;
  const bool active = r < rows;
  const bool first = c0 < a.c1;  // this thread's channels lie in x1 (out1), else in x2 (out2)
  const int pitch = first ? a.c1 : a.c2;
  const TI* base = first ? static_cast<const TI*>(a.x1) + (long)n * hw * a.c1 + c0
                         : static_cast<const TI*>(a.x2) + (long)n * hw * a.c2 + (c0 - a.c1);
  TO* obase = first ? static_cast<TO*>(a.out1) + (long)n * hw * a.c1 + c0
                    : static_cast<TO*>(a.out2) + (long)n * hw * a.c2 + (c0 - a.c1);
  const long oex = (long)n * Ho * Wo * C + c0;  // this example's and thread's d / add
  const float* dsrc = a.d + oex;
  const void* asrc = a.add == nullptr ? nullptr
      : a.add_f32 ? static_cast<const void*>(static_cast<const float*>(a.add) + oex)
                  : static_cast<const void*>(static_cast<const bf16*>(a.add) + oex);
  const int p0 = (int)((long)b * hw / a.cl) + r, p1 = (int)((long)(b + 1) * hw / a.cl);
  const int ptail = p0 + GN_RES_B * rows;  // this thread's first pixel not kept in registers
  const float cnt = (float)hw * (float)cg_;
  // the example's totals / cnt of the partial arrays gp[j0], gp[j0 + 1],
  // gathered from the cluster's shared memories and summed in rank order
  auto cluster_totals = [&](int j0) {
    cluster.sync();  // every block's partials are written
    for (int i = tid; i < 2 * a.cl * a.G; i += GN_THREADS) {
      const int j = i / (a.cl * a.G), q = (i / a.G) % a.cl, grp = i % a.G;
      gather[i] = cluster.map_shared_rank(&gp[j0 + j][0], q)[grp];
    }
    __syncthreads();
    for (int i = tid; i < 2 * a.G; i += GN_THREADS) {
      const int j = i / a.G, grp = i % a.G;
      float t = 0.f;
      for (int q = 0; q < a.cl; ++q) t += gather[(j * a.cl + q) * a.G + grp];
      gt[j0 + j][grp] = t / cnt;
    }
    __syncthreads();
  };

  uint4 xr[GN_RES_B];
#pragma unroll
  for (int i = 0; i < GN_RES_B; ++i) {
    const int p = p0 + i * rows;
    xr[i] = active && p < p1 ? *reinterpret_cast<const uint4*>(base + (long)p * pitch)
                             : make_uint4(0u, 0u, 0u, 0u);
  }
  auto each_x = [&](auto&& f) {  // f(p, x) over this thread's pixels
    if (!active) return;
#pragma unroll
    for (int i = 0; i < GN_RES_B; ++i) {
      const int p = p0 + i * rows;
      if (p < p1) {
        float x[VEC];
        GnVec<TI>::unpack(xr[i], x);
        f(p, x);
      }
    }
    for (int p = ptail; p < p1; p += rows) {
      float x[VEC];
      gn_load<TI>(base + (long)p * pitch, x);
      f(p, x);
    }
  };
  auto load_d = [&](int p, float (&dv)[VEC]) {
    const int y = p / a.W;
    gn_load_transposed<VEC>(dsrc, 1, a.resample, C, Wo, y, p - y * a.W, dv);
  };

  // the groups' statistics: given, or one round of sums and squares
  float s[VEC], s2[VEC];
  if (a.stats == nullptr) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) s[k] = s2[k] = 0.f;
    each_x([&](int, const float (&x)[VEC]) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        s[k] += x[k];
        s2[k] += x[k] * x[k];
      }
    });
    gn_block_groups<VEC>(s, active, r, c0, rows, C, cg_, a.G, part, chan, gp[0]);
    gn_block_groups<VEC>(s2, active, r, c0, rows, C, cg_, a.G, part, chan, gp[1]);
    cluster_totals(0);
    if (tid < a.G) {  // gt[0]: the mean, gt[1]: rstd
      const float mean = gt[0][tid];
      gt[1][tid] = rsqrtf(gt[1][tid] - mean * mean + a.eps);
    }
  } else if (tid < a.G) {
    const float2 st = a.stats[(long)n * a.G + tid];
    gt[0][tid] = st.x;
    gt[1][tid] = st.y;
  }
  __syncthreads();
  float mean[VEC], rs[VEC], gamma[VEC], beta[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    mean[k] = gt[0][(c0 + k) / cg_];
    rs[k] = gt[1][(c0 + k) / cg_];
    gamma[k] = active ? a.gamma[c0 + k] : 0.f;
    beta[k] = active ? a.beta[c0 + k] : 0.f;
  }
  // dxhat at a pixel: xh gets xhat
  auto dxhat = [&](const float (&x)[VEC], const float (&dv)[VEC], float (&xh)[VEC],
                   float (&dh)[VEC]) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      xh[k] = (x[k] - mean[k]) * rs[k];
      const float y = xh[k] * gamma[k] + beta[k];
      const float sig = 1.f / (1.f + expf(-y));
      dh[k] = dv[k] * (sig * (1.f + y * (1.f - sig))) * gamma[k];
    }
  };

  // the group means of dxhat and of dxhat xhat
#pragma unroll
  for (int k = 0; k < VEC; ++k) s[k] = s2[k] = 0.f;
  each_x([&](int p, const float (&x)[VEC]) {
    float dv[VEC], xh[VEC], dh[VEC];
    load_d(p, dv);
    dxhat(x, dv, xh, dh);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      s[k] += dh[k];
      s2[k] += dh[k] * xh[k];
    }
  });
  gn_block_groups<VEC>(s, active, r, c0, rows, C, cg_, a.G, part, chan, gp[2]);
  gn_block_groups<VEC>(s2, active, r, c0, rows, C, cg_, a.G, part, chan, gp[3]);
  cluster_totals(2);
  float m1[VEC], m2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    m1[k] = gt[2][(c0 + k) / cg_];
    m2[k] = gt[3][(c0 + k) / cg_];
  }

  // the output (+ the added term), and the per-channel sums
#pragma unroll
  for (int k = 0; k < VEC; ++k) s[k] = 0.f;
  each_x([&](int p, const float (&x)[VEC]) {
    float dv[VEC], av[VEC], xh[VEC], dh[VEC];
    const int y = p / a.W;
    load_d(p, dv);
    if (asrc != nullptr)
      gn_load_transposed<VEC>(asrc, a.add_f32, a.resample, C, Wo, y, p - y * a.W, av);
    dxhat(x, dv, xh, dh);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      dh[k] = rs[k] * (dh[k] - m1[k] - xh[k] * m2[k]);
      s[k] += dh[k];
      if (asrc != nullptr) dh[k] += a.add_scale * av[k];
    }
    store_vec<VEC>(obase + (long)p * pitch, dh);
  });
  if (a.dsum != nullptr) {  // uniform across the cluster
    // chan[c]: this block's sum of channel c; the example's is the sum of
    // the cluster's in rank order, each block taking a share of the channels
    gn_block_chan<VEC>(s, active, r, c0, rows, C, part, chan);
    cluster.sync();
    const int cb = b * C / a.cl, ce = (b + 1) * C / a.cl;
    for (int c = cb + tid; c < ce; c += GN_THREADS) {
      float t = 0.f;
      for (int q = 0; q < a.cl; ++q) t += cluster.map_shared_rank(chan, q)[c];
      a.dsum[(long)n * C + c] = t;
    }
  }
  cluster.sync();  // no block's shared memory is read after it exits
}

// One cluster per example of CL blocks, the largest power of two up to
// GN_CLUSTER_B that lets all N clusters run at once. The pass moves more
// bytes than its forward (fp32 cotangents, read twice) and its blocks work
// through their pixels one after another: on an H100, CL = 1, 2, 4 gave
// 11.8, 8.5, 6.8 ms per evaluation's backward at batch 8 against 6.1 at
// 8, and at batch 16 eight blocks per example that took a second wave of
// clusters lost to four (chip_smoke.py phase 2b). Requires what
// launch_rb_gn does, with the seam c1 a multiple of VEC (the caller checks).
template <typename TI, typename TO>
cudaError_t launch_rb_gn_bwd(RbGnBwdArgs a, int N, cudaStream_t st) {
  static bool non_portable = false;  // clusters above 8 blocks need the opt-in, once
  if (!non_portable) {
    const cudaError_t err = cudaFuncSetAttribute(
        rb_gn_bwd_kernel<TI, TO>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    non_portable = true;
  }
  const void* kernel = reinterpret_cast<const void*>(rb_gn_bwd_kernel<TI, TO>);
  a.cl = 1;
  while (a.cl < GN_CLUSTER_B && N <= gn_max_clusters(kernel, 2 * a.cl)) a.cl *= 2;
  return launch_gn_cluster(rb_gn_bwd_kernel<TI, TO>, a, a.cl, N, st);
}

}  // namespace dp
