// Fused BigGAN residual block (NCSN++ ResnetBlockBigGANpp, eval mode) for
// Hopper, bf16 or fp32 NHWC maps.
//
// Replaces the TPU kernels diffpure_tpu/ops/fused_resblock.py:290
// fused_resblock_pallas (_fused_resblock_kernel :176) and :728
// fused_resblock_cat_pallas (_fused_resblock_cat_kernel :636). The cat
// variant is this same chain with a second input pointer and a seam index.
//
// What bounds it on this card: the block is two 3x3 convs of K = 9 * Cin
// (up to 3456) over N * H * W rows, 0.3-9.7 GFLOP per block at the CIFAR
// shapes and batch 8, with operands small enough to stay in the 50 MB L2:
// products, not bytes, are the work. The TPU kernel kept the whole block
// in 16 MB of VMEM; one 32x32x128 bf16 example is already 256 KB, more
// than an SM's 227 KB of shared memory.
//
// What the design does about it: a chain of four launches (plus a split-K
// pass where a grid is small),
//   1. GN1 over x (statistics across the logical concat of x1 | x2), writing
//      act1 = resample(SiLU(GN1(x))) once in the compute dtype, and, for an
//      up/down block, the skip branch's input xs = resample(x);
//   2. conv0 as an implicit GEMM over act1, whose epilogue adds b0 and the
//      temb row; h1 goes to device memory in fp32 (the TPU kernel also
//      kept this accumulator in fp32 into GN2);
//   3. GN2 over h1, writing act2 = SiLU(GN2(h1));
//   4. conv1 as an implicit GEMM over act2 with the 1x1 skip projection
//      folded in as extra K steps (x, xs, or x1 | x2 against wskip), and an
//      epilogue adding b1 + bskip or the identity skip, times 1/sqrt(2).
// The concat input is never written out. The activations are, once each:
// normalising inside the conv's A loader recomputed GN + SiLU for every one
// of the 9 taps and left the tensor cores waiting on expf (measured: 82% of
// the evaluation in the GEMM at 17 TFLOP/s).
//
// bf16 (resblock_fwd_wgmma): both GEMMs run on igemm_wgmma.cuh (wgmma +
// TMA, tiles and split-K from ops/fused_resblock.py resblock_plan, which
// fills the SMs at batch 8 and 128), and both GroupNorm passes on
// rb_gn_kernel: one thread-block cluster per example, each block a
// contiguous share of the pixels with all channels in 16-byte vectors kept
// in registers from the first pass to the last, two-pass fp32 statistics
// whose per-block partials the cluster's blocks read from each other's
// shared memory and sum in rank order (the same result in every block, and
// from run to run). On an H100 at 700 W, batch 8, this chain takes 2.9 ms
// of device time per NCSN++ evaluation where the PR 1 chain took 9.6 (GEMMs
// 7.4 -> 1.2 ms; GN passes 1.8 -> 1.45 ms: the passes are now latency
// chains of about 10 us each, not bandwidth), and at batch 128 16.8 ms
// where it took 116.6 (chip_smoke.py phase 2, --profile-cifar).
// fp32 (resblock_fwd_f32): the PR 1 chain, common.cuh gn_apply_kernel (one block
// per group and example) and launch_gemm (plain fp32 FMAs, never TF32;
// deterministic split-K).
#include <cooperative_groups.h>

#include "common.cuh"
#include "igemm_wgmma.cuh"

using namespace dp;
namespace cg = cooperative_groups;

// fp32: the GN pass and launch_gemm of common.cuh.
static cudaError_t resblock_fwd_f32(const void* x1, const void* x2, int c1, int c2, int N,
                                    int H, int W, int resample, const void* temb,
                                    const float* gn1s, const float* gn1b, int g1, const void* w0,
                                    const float* b0, const float* gn2s, const float* gn2b,
                                    int g2, const void* w1, const float* bias1, int has_proj,
                                    int cout, float eps, float oscale, void* act1, void* xs,
                                    float* h1, void* act2, float* ws, long ws_elems, void* out,
                                    cudaStream_t st) {
  const int cin = c1 + c2;
  const int Ho = resample == RS_DOWN ? H / 2 : (resample == RS_UP ? H * 2 : H);
  const int Wo = resample == RS_DOWN ? W / 2 : (resample == RS_UP ? W * 2 : W);
  const Src x = {x1, x2, c1, c2, H, W, 0};
  // the skip branch's input on the output grid: x itself, or its resample
  // written by the GN1 pass
  const Src skip = resample == RS_NONE ? x : Src{xs, nullptr, cin, 0, Ho, Wo, 0};
  const GnArgs gn1 = {x, g1, gn1s, gn1b, eps, 1, resample, act1,
                      resample == RS_NONE ? nullptr : xs};
  cudaError_t err = launch_gn_apply<float>(gn1, N, st);
  if (err != cudaSuccess) return err;

  GemmArgs a0 = {};
  a0.M = N * Ho * Wo;
  a0.Nc = cout;
  a0.K = a0.Kmain = 9 * cin;
  a0.Ho = Ho;
  a0.Wo = Wo;
  a0.taps = 9;
  a0.src = Src{act1, nullptr, cin, 0, Ho, Wo, 0};
  a0.w = w0;
  a0.bias = b0;
  a0.temb = temb;
  a0.oscale = 1.f;
  a0.out = h1;
  a0.out_f32 = 1;
  if ((err = launch_gemm<float>(a0, ws, ws_elems, st)) != cudaSuccess) return err;

  const GnArgs gn2 = {Src{h1, nullptr, cout, 0, Ho, Wo, 1}, g2, gn2s, gn2b, eps, 1,
                      RS_NONE, act2, nullptr};
  if ((err = launch_gn_apply<float>(gn2, N, st)) != cudaSuccess) return err;

  GemmArgs a1 = {};
  a1.M = N * Ho * Wo;
  a1.Nc = cout;
  a1.Kmain = 9 * cout;
  a1.K = a1.Kmain + (has_proj ? cin : 0);
  a1.Ho = Ho;
  a1.Wo = Wo;
  a1.taps = 9;
  a1.src = Src{act2, nullptr, cout, 0, Ho, Wo, 0};
  a1.proj = skip;
  a1.w = w1;
  a1.bias = bias1;
  a1.has_resid = !has_proj;  // identity skip (cin == cout)
  a1.resid = skip;
  a1.oscale = oscale;
  a1.out = out;
  a1.out_f32 = 0;
  return launch_gemm<float>(a1, ws, ws_elems, st);
}

// ---------------------------------------------------------------------------
// bf16 GroupNorm + SiLU (+ naive 2x resample) pass: act = resample(SiLU(GN(x)))
// in bf16 and, with raw != nullptr, raw = resample(x) in bf16, for x = x1 | x2
// (bf16) or h1 (fp32). One cluster of CL <= GN_CLUSTER blocks per example
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
  bf16* act;  // (N, Ho, Wo, C)
  bf16* raw;  // (N, Ho, Wo, C) or nullptr
  int cl;     // blocks per example: the cluster's size
};

// Per-group sums over the block of the per-thread, per-channel partials in
// s (written to part[r][c]), in a fixed order: rows, then a group's cgs
// channels; gout[g] gets group g's sum.
template <int VEC>
__device__ __forceinline__ void gn_block_groups(const float (&s)[VEC], bool active, int r, int c0,
                                                int rows, int C, int cgs, int G, float* part,
                                                float* chan, float* gout) {
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
  if (threadIdx.x < G) {
    float t = 0.f;
    for (int c = threadIdx.x * cgs; c < (threadIdx.x + 1) * cgs; ++c) t += chan[c];
    gout[threadIdx.x] = t;
  }
}

template <typename TI>
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
    for (int k = 0; k < VEC; ++k) o[k] = silu((x[k] - mean[k]) * scale[k] + shift[k]);
  };

  // pass 3: the output
  const int Ho = a.resample == RS_DOWN ? a.H / 2 : (a.resample == RS_UP ? a.H * 2 : a.H);
  const int Wo = a.resample == RS_DOWN ? a.W / 2 : (a.resample == RS_UP ? a.W * 2 : a.W);
  const int ohw = Ho * Wo;
  bf16* act = a.act + (long)n * ohw * C + c0;
  bf16* raw = a.raw != nullptr ? a.raw + (long)n * ohw * C + c0 : nullptr;
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

// One cluster per example of CL blocks, a power of two up to GN_CLUSTER:
// enough that each thread keeps at most GN_RES vectors, and enough that
// the batch's blocks outnumber the SMs (a small batch's pass is a chain of
// latencies: on an H100 at batch 8, one block per example at 4x4 and 8x8
// was slower than eight). Requires C % VEC == 0 with the seam c1 at a
// multiple of VEC, C <= GN_MAX_C, G <= GN_MAX_G, C % G == 0 (the caller
// checks).
template <typename TI>
static cudaError_t launch_rb_gn(RbGnArgs a, int N, cudaStream_t st) {
  const long vectors = (long)a.H * a.W * (a.c1 + a.c2) / GnVec<TI>::VEC;
  a.cl = 1;
  while (a.cl < GN_CLUSTER &&
         (vectors > (long)a.cl * GN_THREADS * GN_RES || (long)a.cl * N <= num_sms()))
    a.cl *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cl, N);
  cfg.blockDim = dim3(GN_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, rb_gn_kernel<TI>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The bf16 chain: rb_gn_kernel and the wgmma GEMM. plan: the tile bm x bn,
// the A box (Wo columns x bh rows x bimg images), each conv's K slices
// (splits, steps per slice), as resblock_plan gives them.
static cudaError_t resblock_fwd_wgmma(const bf16* x1, const bf16* x2, int c1, int c2, int N,
                                      int H, int W, int resample, const bf16* temb,
                                      const float* gn1s, const float* gn1b, int g1,
                                      const bf16* w0s, const float* b0, const float* gn2s,
                                      const float* gn2b, int g2, const bf16* w1s,
                                      const float* bias1, int has_proj, int cout, float eps,
                                      float oscale, bf16* act1, bf16* xs, float* h1, bf16* act2,
                                      float* ws, long ws_elems, bf16* out, int bm, int bn, int bh,
                                      int bimg, int splits0, int per0, int splits1, int per1,
                                      cudaStream_t st) {
  const int cin = c1 + c2;
  const int Ho = resample == RS_DOWN ? H / 2 : (resample == RS_UP ? H * 2 : H);
  const int Wo = resample == RS_DOWN ? W / 2 : (resample == RS_UP ? W * 2 : W);
  const long M = (long)N * Ho * Wo;
  if (c1 % WG_KC || c2 % WG_KC || cout % bn || bn % WG_KC || cin > GN_MAX_C ||
      cout > GN_MAX_C || g1 > GN_MAX_G || g2 > GN_MAX_G || cin % g1 || cout % g2 ||
      (long)Wo * bh * bimg != bm || bh > Ho || ((Ho * Wo) % bm && bm % (Ho * Wo)) ||
      (x2 != nullptr && (!has_proj || resample != RS_NONE)) ||
      (splits0 > 1 && splits0 * M * cout > ws_elems) ||
      (splits1 > 1 && splits1 * M * cout > ws_elems))
    return cudaErrorInvalidValue;

  const RbGnArgs gn1 = {x1, x2, c1, c2, H, W, g1, gn1s, gn1b, eps, resample, act1,
                        resample == RS_NONE ? nullptr : xs};
  cudaError_t err = launch_rb_gn<bf16>(gn1, N, st);
  if (err != cudaSuccess) return err;

  // the projection's sources on the output grid: x (x1 | x2), or xs
  const bf16* p1 = resample == RS_NONE ? x1 : xs;
  const int cp1 = resample == RS_NONE ? c1 : cin;
  CUtensorMap m_act1, m_act2, m_p1, m_p2;
  if (!wg_box_map(&m_act1, act1, N, Ho, Wo, cin, bh, bimg) ||
      !wg_box_map(&m_act2, act2, N, Ho, Wo, cout, bh, bimg) ||
      (has_proj && !wg_box_map(&m_p1, p1, N, Ho, Wo, cp1, bh, bimg)) ||
      (has_proj && c2 > 0 && !wg_box_map(&m_p2, x2, N, Ho, Wo, c2, bh, bimg)))
    return cudaErrorInvalidValue;
  if (!has_proj) m_p1 = m_act1;  // never read
  if (!(has_proj && c2 > 0)) m_p2 = m_act1;

  WgConvArgs a0 = {};
  a0.N = N;
  a0.Ho = Ho;
  a0.Wo = Wo;
  a0.M = (int)M;
  a0.cout = cout;
  a0.nconv = cin / WG_KC;
  a0.bh = bh;
  a0.bimg = bimg;
  a0.w = w0s;
  a0.bias = b0;
  a0.temb = temb;
  a0.oscale = 1.f;
  a0.out = h1;
  a0.out_f32 = 1;
  a0.mtiles = (int)((M + bm - 1) / bm);
  a0.ntiles = cout / bn;
  a0.splits = splits0;
  a0.steps_per = per0;
  a0.ws = ws;
  if ((err = launch_wgmma_conv(a0, bm, bn, m_act1, m_p1, m_p2, st)) != cudaSuccess) return err;

  const RbGnArgs gn2 = {h1, nullptr, cout, 0, Ho, Wo, g2, gn2s, gn2b, eps, RS_NONE, act2,
                        nullptr};
  if ((err = launch_rb_gn<float>(gn2, N, st)) != cudaSuccess) return err;

  WgConvArgs a1 = a0;
  a1.nconv = cout / WG_KC;
  a1.nproj1 = has_proj ? cp1 / WG_KC : 0;
  a1.nproj2 = has_proj ? c2 / WG_KC : 0;
  a1.w = w1s;
  a1.bias = bias1;
  a1.temb = nullptr;
  a1.resid = has_proj ? nullptr : p1;  // identity skip (cin == cout): x, or xs
  a1.oscale = oscale;
  a1.out = out;
  a1.out_f32 = 0;
  a1.splits = splits1;
  a1.steps_per = per1;
  return launch_wgmma_conv(a1, bm, bn, m_act2, m_p1, m_p2, st);
}

extern "C" {

// dtype: 0 fp32, 1 bf16. x2 == NULL and c2 == 0 for a single input.
// resample: 0 none, 1 down, 2 up. w0 is (cout, 9*cin); w1 is (cout, 9*cout
// [+ cin]) with the 1x1 projection's columns last when has_proj; column
// (3*dy + dx)*C + c is tap (dy, dx) of input channel c. bias1 = b1 + bskip.
// Scratch: act1 (N, Ho, Wo, cin), xs (the same, only read when resample != 0)
// and act2 (N, Ho, Wo, cout) in the compute dtype, h1 (N, Ho, Wo, cout)
// fp32, ws (ws_elems fp32) for split-K partials.
// bf16 runs on the wgmma chain and reads w0s (9 cin / 64, cout, 64) and w1s
// (9 cout / 64 [+ cin / 64], cout, 64) instead of w0 and w1: the weight
// stages of ops/fused_resblock.py, step (c // 64) * 9 + tap for input
// channel c, the projection's steps last, each row in the 128-byte swizzle;
// and the plan: tile bm x bn, A box bh rows x bimg images (x Wo columns),
// (splits, steps per slice) of conv0 and of conv1. fp32 ignores these.
// Returns cudaGetLastError() of the first failing launch, or
// cudaErrorInvalidValue for a shape or plan the bf16 chain does not take.
int diffpure_resblock_fwd(int dtype, const void* x1, const void* x2, int c1, int c2, int N,
                          int H, int W, int resample, const void* temb, const float* gn1s,
                          const float* gn1b, int g1, const void* w0, const float* b0,
                          const float* gn2s, const float* gn2b, int g2, const void* w1,
                          const float* bias1, int has_proj, int cout, float eps,
                          float oscale, void* act1, void* xs, float* h1, void* act2,
                          float* ws, long ws_elems, void* out, const void* w0s,
                          const void* w1s, int bm, int bn, int bh, int bimg, int splits0,
                          int per0, int splits1, int per1, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return resblock_fwd_wgmma(
        static_cast<const bf16*>(x1), static_cast<const bf16*>(x2), c1, c2, N, H, W, resample,
        static_cast<const bf16*>(temb), gn1s, gn1b, g1, static_cast<const bf16*>(w0s), b0, gn2s,
        gn2b, g2, static_cast<const bf16*>(w1s), bias1, has_proj, cout, eps, oscale,
        static_cast<bf16*>(act1), static_cast<bf16*>(xs), h1, static_cast<bf16*>(act2), ws,
        ws_elems, static_cast<bf16*>(out), bm, bn, bh, bimg, splits0, per0, splits1, per1, st);
  return resblock_fwd_f32(x1, x2, c1, c2, N, H, W, resample, temb, gn1s, gn1b, g1, w0, b0,
                          gn2s, gn2b, g2, w1, bias1, has_proj, cout, eps, oscale, act1, xs, h1,
                          act2, ws, ws_elems, out, st);
}

const char* diffpure_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
