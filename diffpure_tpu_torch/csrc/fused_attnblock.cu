// Fused NCSN++ attention block (AttnBlockpp, eval mode) for Hopper, bf16 or
// fp32 NHWC maps.
//
// Replaces the TPU kernel diffpure_tpu/ops/fused_attnblock.py:106
// fused_attnblock_pallas (_attn_kernel :38): GroupNorm -> q, k, v NIN
// (C x C) -> per-example softmax(q k^T C^-1/2) in fp32 -> @ v -> output NIN
// -> + x, times 1/sqrt(2).
//
// What bounds it on this card: at the CIFAR shapes (HW = 256 or 16, C = 256)
// the four C x C products are 4 * 2 * HW * C^2 = 134 MFLOP per example and
// the two attention products 2 * 2 * HW^2 * C = 67 MFLOP; every operand
// fits in L2, so the products bound it (at batch 128, 25.8 GFLOP against
// 34 MB: 26 us at the bf16 peak), and at small batch the launches'
// latencies do.
//
// bf16 (attnblock_fwd_wgmma): three launches on the tensor cores,
//   1. the GroupNorm pass rb_gn_kernel (gn_cluster.cuh) with no_silu: one
//      thread-block cluster per example, fp32 statistics, h = GN(x) written
//      once in bf16 (where the TPU kernel rounds it too);
//   2. q | k | v as the wgmma GEMM of igemm_wgmma.cuh with projection steps
//      alone (C / 64 K steps of h against the pre-swizzled stages of [Wq |
//      Wk | Wv], 3C outputs), bias in the epilogue, stored in bf16 (the TPU
//      kernel rounds q, k and v before its products too); its tiles and
//      split-K come from ops/fused_attnblock.py attnblock_plan
//      (ops/fused_resblock.py's GEMM planner);
//   3. attn_wgmma_kernel below: the HW x HW core and the output NIN, whose
//      epilogue is (acc + bias + x) * oscale in the TPU kernel's order.
//
// The core (attn_wgmma_kernel<NCH, KEYS>): one block per (64 NWG queries,
// example), NWG consumer warpgroups of 64 queries and a producer warpgroup,
// which gives its registers to them (setmaxnreg: at KEYS = 256, S alone is
// 128 fp32 registers a thread, P 64 more, a's four chunks 128; at the 168
// a thread of three even warpgroups the core spilled). KEYS = 256 (NWG = 2)
// takes HW <= 256, KEYS = 64 (NWG = 1) HW <= 64, so the middle block's
// 4 x 4 map does not pay for 256 keys and 128 queries. A warpgroup holds a
// whole score row of every key in registers and keeps the TPU kernel's
// order of arithmetic rather than an online softmax: S = q k^T * C^-1/2
// accumulated in fp32 (wgmma m64nKEYSk16, both operands in shared memory:
// Q and one 64-channel chunk of K per C / 64 steps), the row max over the
// example's keys (keys past HW masked), exp, the row sum, p = e / sum
// rounded to bf16, a = p v in fp32 (wgmma m64n64k16 with P from registers:
// the accumulator layout of S is the register layout of wgmma's A operand;
// V MN-major, the descriptor's transpose bit), rounded to bf16 in registers
// (the C / 64 chunks of P V are issued back to back); then the output NIN
// from registers too: a's accumulators are wgmma's A fragments as P's were,
// against Wout's pre-swizzled stages, 64 output channels at a time, so a
// never goes to device memory. One example's K and V are 256 KB at HW =
// 256, more than an SM's shared memory: the producer brings them by TMA in
// boxes of 64 channels x KEYS keys through a ring of AT_STAGES on
// mbarriers, K's C / 64 boxes, then V's, then Wout's C / 64 stages by bulk
// copy, while Q stays. The tensor maps see q | k | v as (N, HW, 3C): a box
// never leaves its example, and its rows past HW (queries and keys) are the
// tensor unit's zeros, so no example reads another's values, finite or not.
//
// fp32 (attnblock_fwd_f32, attnblock_f32.cu): three launches on the FMA
// units (never TF32); that file says what bounds them and what they do.
// No cuBLAS, no library attention: every product is a kernel in this
// directory.
#include "common.cuh"
#include "gn_cluster.cuh"
#include "hopper.cuh"
#include "igemm_wgmma.cuh"

using namespace dp;

namespace dp {
// the fp32 chain, in attnblock_f32.cu
cudaError_t attnblock_fwd_f32(const float* x, int N, int H, int W, int C, const float* gns,
                              const float* gnb, int G, const float* wqkv, const float* bqkv,
                              const float* wo, const float* bo, float eps, float oscale,
                              float* h, float* qkv, float* ws, long ws_elems, float* out,
                              const int* plan, cudaStream_t st);
}  // namespace dp

namespace {

// ---------------------------------------------------------------------------
// bf16: the core on wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int AT_STAGES = 4;

// NCH = C / 64 <= 4 chunks of Q, K and V; KEYS keys a score row (64 or
// 256), NWG consumer warpgroups of 64 queries
template <int NCH, int KEYS> struct AtCore {
  static constexpr int NWG = KEYS > 64 ? 2 : 1;
  static constexpr int THREADS = 128 * (NWG + 1);  // + a producer warpgroup
  static constexpr int QBYTES = NWG * 64 * 128;     // a Q chunk: 64 NWG queries x 64 channels
  static constexpr int BOX = KEYS * 128;            // a K or V box: KEYS keys x 64 channels
  static constexpr int STAGE = (KEYS > 64 * NCH ? KEYS : 64 * NCH) * 128;  // or a Wout stage
  static constexpr size_t SMEM = 1024 + (size_t)NCH * QBYTES + (size_t)AT_STAGES * STAGE +
                                 (1 + 2 * AT_STAGES) * sizeof(uint64_t);
  static_assert(SMEM <= 232448, "the core's shared memory must fit an SM");
};
constexpr int AT_PRODUCER_REGS = 24, AT_CONSUMER_REGS = 240;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// qkv: the (N, HW, 3C) bf16 tensor q | k | v, read through two tensor maps
// of it (128-byte swizzle, zeros past HW): tq in boxes of 64 channels x 64
// rows, tkv of 64 channels x KEYS rows. wos: Wout's stages (C / 64, C,
// 64), bo: its fp32 bias; x and out: (N HW, C) bf16.
// Shared memory: Q [chunk][64 NWG queries][64], then the ring [stage][KEYS
// keys or C outputs][64]; every box starts 1024-aligned.
template <int NCH, int KEYS>
__global__ void __launch_bounds__(AtCore<NCH, KEYS>::THREADS, 1)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tkv,
                  const bf16* __restrict__ wos, const float* __restrict__ bo,
                  const bf16* __restrict__ x, float oscale, int hw, float sm_scale,
                  bf16* __restrict__ out) {
  using L = AtCore<NCH, KEYS>;
  constexpr int C = 64 * NCH, NWG = L::NWG, KS = KEYS / 16;  // KS: 16-key steps
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ring = Qs + NCH * L::QBYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + AT_STAGES * L::STAGE);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + AT_STAGES;
  const int tid = threadIdx.x, n = blockIdx.y, q0 = blockIdx.x * 64 * NWG, row0 = n * hw;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < AT_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128 * NWG) {
    // ---- producer warpgroup: one thread issues the copies ----
    reg_dealloc<AT_PRODUCER_REGS>();
    if (tid == 128 * NWG) {
      mbar_arrive_expect_tx(q_full, NCH * L::QBYTES);
      // warpgroup w's 64 queries from pixel q0 + 64 w of example n (past
      // HW: zeros, computed and not stored)
      for (int w = 0; w < NWG; ++w)
        for (int j = 0; j < NCH; ++j)
          tma_load_4d(Qs + j * L::QBYTES + w * 64 * 128, &tq, 64 * j, 0, q0 + 64 * w, n, q_full);
      for (int g = 0; g < 3 * NCH; ++g) {  // K's chunks, V's, then Wout's stages
        const int s = g % AT_STAGES;
        mbar_wait(&empty[s], ((g / AT_STAGES) & 1) ^ 1);
        if (g < 2 * NCH) {
          mbar_arrive_expect_tx(&full[s], L::BOX);
          tma_load_4d(ring + s * L::STAGE, &tkv, C + 64 * g, 0, 0, n, &full[s]);
        } else {
          mbar_arrive_expect_tx(&full[s], C * 128);
          bulk_g2s(ring + s * L::STAGE, wos + (long)(g - 2 * NCH) * C * 64, C * 128, &full[s]);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 queries each ----
  reg_alloc<AT_CONSUMER_REGS>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g8 = lane >> 2, t2 = (lane & 3) * 2;
  float s[KEYS / 2];  // S[16 warp + g8 + 8 h][8 i + t2 + e] = s[4 i + 2 h + e]
#pragma unroll
  for (int i = 0; i < KEYS / 2; ++i) s[i] = 0.f;
  reg_fence(s);
  mbar_wait(q_full, 0);
  int prev = -1;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int st = j % AT_STAGES;
    mbar_wait(&full[st], (j / AT_STAGES) & 1);
    const uint64_t dq = sw128_desc(Qs + j * L::QBYTES + wg * 64 * 128);
    const uint64_t dk = sw128_desc(ring + st * L::STAGE);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(s, dq + 2 * kk, dk + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();  // the previous chunk's wgmmas are done with its stage
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = st;
  }
  wgmma_wait<0>();
  reg_fence(s);
  if (lane == 0) mbar_arrive(&empty[prev]);

  // softmax of rows g8 (h = 0) and g8 + 8 (h = 1) in fp32, in the TPU
  // kernel's order; a row's KEYS scores lie across the 4 threads of a quad
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < KEYS / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = 8 * i + t2 + e < hw ? s[4 * i + 2 * h + e] * sm_scale : -INFINITY;
        s[4 * i + 2 * h + e] = v;
        mx = fmaxf(mx, v);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < KEYS / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float ex = expf(s[4 * i + 2 * h + e] - mx);
        s[4 * i + 2 * h + e] = ex;
        sum += ex;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
#pragma unroll
    for (int i = 0; i < KEYS / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) s[4 * i + 2 * h + e] = s[4 * i + 2 * h + e] / sum;
  }
  // P as wgmma's A fragments: 16-key step kk takes S blocks 2 kk, 2 kk + 1
  uint32_t p[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }

  // a = P V, 64 channels per chunk: V's chunk j is the ring's box NCH + j
  float o[NCH][32];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
    reg_fence(o[j]);
  }
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int g = NCH + j, st = g % AT_STAGES;
    mbar_wait(&full[st], (g / AT_STAGES) & 1);
    // 16 keys are 16 rows of 128 bytes: 128 in the descriptor's 16-byte units
    const uint64_t dv = sw128_desc(ring + st * L::STAGE);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_rs<1>(o[j], p[kk], dv + kk * 128);
    wgmma_commit();
  }
  wgmma_wait<0>();
  // a rounded to bf16 as wgmma's A fragments: 16-channel step kk of chunk j
  uint32_t af[NCH][4][4];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    reg_fence(o[j]);
    if (lane == 0) mbar_arrive(&empty[(NCH + j) % AT_STAGES]);  // V's chunk j is read
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      af[j][kk][0] = pack_bf16(o[j][8 * kk], o[j][8 * kk + 1]);
      af[j][kk][1] = pack_bf16(o[j][8 * kk + 2], o[j][8 * kk + 3]);
      af[j][kk][2] = pack_bf16(o[j][8 * kk + 4], o[j][8 * kk + 5]);
      af[j][kk][3] = pack_bf16(o[j][8 * kk + 6], o[j][8 * kk + 7]);
    }
  }

  // out = (a Wout + bout + x) * oscale, 64 output channels at a time; Wout's
  // stage j (its input channels 64 j..) is the ring's box 2 NCH + j
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int g = 2 * NCH + j;
    mbar_wait(&full[g % AT_STAGES], (g / AT_STAGES) & 1);
  }
  const int r0 = q0 + wg * 64 + warp * 16 + g8;
#pragma unroll 1
  for (int jo = 0; jo < NCH; ++jo) {
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      // rows 64 jo.. of the stage: 64 output channels x 64 input channels
      const uint64_t dw =
          sw128_desc(ring + ((2 * NCH + j) % AT_STAGES) * L::STAGE + jo * 64 * 128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<0>(acc, af[j][kk], dw + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= hw) continue;
      const long o0 = ((long)row0 + r) * C + 64 * jo + t2;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 b = *reinterpret_cast<const float2*>(bo + 64 * jo + t2 + 8 * i);
        const float2 xr =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + o0 + 8 * i));
        const float v0 = (acc[4 * i + 2 * h] + b.x + xr.x) * oscale;
        const float v1 = (acc[4 * i + 2 * h + 1] + b.y + xr.y) * oscale;
        *reinterpret_cast<__nv_bfloat162*>(out + o0 + 8 * i) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// The core over (N, HW, 3C) q | k | v: KEYS = 64 for HW <= 64, else 256.
template <int NCH, int KEYS>
cudaError_t launch_core_keys(const bf16* qkv, const bf16* wos, const float* bo, const bf16* x,
                             float oscale, int N, int hw, bf16* out, cudaStream_t st) {
  using L = AtCore<NCH, KEYS>;
  static bool opted_in = false;  // the shared-memory opt-in, once per process
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_wgmma_kernel<NCH, KEYS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  // a box of rows of one example as a 4-D box {64, 1, rows, 1} of (N, HW,
  // 1, 3C): the rows past HW are out of the map and read as zeros
  CUtensorMap tq, tkv;
  if (!wg_box_map(&tq, qkv, N, hw, 1, 192 * NCH, 64, 1) ||
      !wg_box_map(&tkv, qkv, N, hw, 1, 192 * NCH, KEYS, 1))
    return cudaErrorInvalidValue;
  attn_wgmma_kernel<NCH, KEYS><<<dim3((hw + 64 * L::NWG - 1) / (64 * L::NWG), N), L::THREADS,
                                  L::SMEM, st>>>(tq, tkv, wos, bo, x, oscale, hw,
                                                 1.0f / sqrtf(64.f * NCH), out);
  return cudaGetLastError();
}

template <int NCH>
cudaError_t launch_core(const bf16* qkv, const bf16* wos, const float* bo, const bf16* x,
                        float oscale, int N, int hw, bf16* out, cudaStream_t st) {
  return hw <= 64 ? launch_core_keys<NCH, 64>(qkv, wos, bo, x, oscale, N, hw, out, st)
                  : launch_core_keys<NCH, 256>(qkv, wos, bo, x, oscale, N, hw, out, st);
}

// The bf16 chain. plan: (bm, bn, bh, bimg, splits, per) of the q|k|v GEMM
// (ops/fused_attnblock.py attnblock_plan).
cudaError_t attnblock_fwd_wgmma(const bf16* x, int N, int H, int W, int C, const float* gns,
                                const float* gnb, int G, const bf16* wqkvs, const float* bqkv,
                                const bf16* wos, const float* bo, float eps, float oscale,
                                bf16* h, bf16* qkv, float* ws, long ws_elems, bf16* out,
                                const int* plan, cudaStream_t st) {
  const int hw = H * W;
  const long M = (long)N * hw;
  if (plan == nullptr || C % 64 || C > 4 * 64 || hw > 256 || G > GN_MAX_G || C % G ||
      3 * C % plan[1] || (long)W * plan[2] * plan[3] != plan[0] || plan[2] > H ||
      (hw % plan[0] && plan[0] % hw) || (plan[4] > 1 && plan[4] * M * 3 * C > ws_elems))
    return cudaErrorInvalidValue;

  RbGnArgs gn = {x, nullptr, C, 0, H, W, G, gns, gnb, eps, RS_NONE, h, nullptr};
  gn.no_silu = 1;
  cudaError_t err = launch_rb_gn<bf16>(gn, N, st);
  if (err != cudaSuccess) return err;

  // q | k | v = h [Wq | Wk | Wv] + b: C / 64 projection steps, 3C outputs
  CUtensorMap m_h;
  if (!wg_box_map(&m_h, h, N, H, W, C, plan[2], plan[3])) return cudaErrorInvalidValue;
  WgConvArgs a = {};
  a.N = N;
  a.Ho = H;
  a.Wo = W;
  a.M = (int)M;
  a.cout = 3 * C;
  a.nproj1 = C / WG_KC;
  a.bh = plan[2];
  a.bimg = plan[3];
  a.w = wqkvs;
  a.bias = bqkv;
  a.oscale = 1.f;
  a.out = qkv;
  a.mtiles = (int)((M + plan[0] - 1) / plan[0]);
  a.ntiles = 3 * C / plan[1];
  a.splits = plan[4];
  a.steps_per = plan[5];
  a.ws = ws;
  if ((err = launch_wgmma_conv(a, plan[0], plan[1], m_h, m_h, m_h, st)) != cudaSuccess)
    return err;

  switch (C / 64) {
    case 1: return launch_core<1>(qkv, wos, bo, x, oscale, N, hw, out, st);
    case 2: return launch_core<2>(qkv, wos, bo, x, oscale, N, hw, out, st);
    case 3: return launch_core<3>(qkv, wos, bo, x, oscale, N, hw, out, st);
    default: return launch_core<4>(qkv, wos, bo, x, oscale, N, hw, out, st);
  }
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16. Scratch: h (N*H*W, C) and qkv (N*H*W, 3C) in the
// compute dtype, ws (ws_elems fp32) for split-K partials. bqkv (3C) and bo
// (C) are fp32. fp32 reads wqkv (3C, C) = [Wq | Wk | Wv]^T (one row per
// output channel) and wo (C, C) = Wout^T, and plan (11 ints: the GroupNorm
// pass's (route, vw, nv, tps, threads), the core's (kj, kjo, ck, osplit),
// the q|k|v GEMM's K slices and the core's ring stages), and requires H*W
// <= 256 and C % 32 == 0. bf16 reads wqkvs (C /
// 64, 3C, 64) and wos (C / 64, C, 64), the weight stages of
// ops/fused_attnblock.py (step j: input channels 64 j.., each row in the
// 128-byte swizzle), and plan (6 ints: (bm, bn, bh, bimg, splits, per) of
// the q|k|v GEMM), and requires C % 64 == 0, C <= 256, H*W <= 256 with the
// GEMM's boxes tiling the map. Returns cudaGetLastError() of the first
// failing step, or cudaErrorInvalidValue for a shape or plan the chain
// does not take.
int diffpure_attnblock_fwd(int dtype, const void* x, int N, int H, int W, int C,
                           const float* gns, const float* gnb, int G, const void* wqkv,
                           const float* bqkv, const void* wo, const float* bo, float eps,
                           float oscale, void* h, void* qkv, float* ws, long ws_elems, void* out,
                           const void* wqkvs, const void* wos, const int* plan, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return attnblock_fwd_wgmma(static_cast<const bf16*>(x), N, H, W, C, gns, gnb, G,
                               static_cast<const bf16*>(wqkvs), bqkv,
                               static_cast<const bf16*>(wos), bo, eps, oscale,
                               static_cast<bf16*>(h), static_cast<bf16*>(qkv), ws, ws_elems,
                               static_cast<bf16*>(out), plan, st);
  return attnblock_fwd_f32(static_cast<const float*>(x), N, H, W, C, gns, gnb, G,
                           static_cast<const float*>(wqkv), bqkv, static_cast<const float*>(wo),
                           bo, eps, oscale, static_cast<float*>(h), static_cast<float*>(qkv), ws,
                           ws_elems, static_cast<float*>(out), plan, st);
}

}  // extern "C"
