// Flash (online-softmax) attention for the ADM's 1024-token blocks, bf16 or
// fp32, (BH, T, D) with D = 32, 64, 128 or 256 (the ImageNet-256 ADM's
// heads are 64 wide; other ADM widths and head counts give other D). bf16
// also runs any width dt <= D with dt % 8 == 0 on the kernel for D: its
// tensor maps span the dt channels a row holds and give zeros for the
// channels past them, which add exactly 0 to every score, and the
// epilogue stores only the dt channels. Other widths, and fp32's, the
// wrapper (ops/flash_attention.py) zero-pads to the next D and slices
// back.
//
// Replaces the TPU kernel diffpure_tpu/ops/flash_attention.py:145
// _flash_forward (_flash_kernel :35): out = softmax(q k^T * scale^2) v with
// the softmax state (m, l, acc) in fp32 and the T x T scores never written.
// JAX scales q and k each by scale = ch^-1/4 in fp32; here the operands go
// into the products unscaled and the fp32 scores are multiplied by scale^2
// (= ch^-1/2), so no scaled operand is rounded back to bf16.
//
// What bounds it on this card: at the ADM-256 shape (BH = 8 per image,
// T = 1024, D = 64) a call is 4 * T^2 * D = 0.27 GFLOP per head against
// 0.5 MB moved: the products, on the tensor cores in bf16 and on the FMA
// units in fp32 (the JAX reference is full fp32: never TF32).
//
// bf16 (flash_wgmma_kernel<D>): one block per (128 queries, bh), two
// consumer warpgroups of 64 queries and one producer warp. The producer
// brings the block's Q once and K and V 64 keys at a time by TMA into a
// ring of 3 stages on mbarriers. A row of shared memory is one swizzle
// span of CW = min(D, 64) channels: the 128-byte swizzle for D >= 64 (D =
// 128 and 256 arrive as two and four 64-channel boxes per tile, stored as
// chunks), the 64-byte swizzle for D = 32 (the tensor map and wgmma's
// descriptor agree on it). Each consumer runs S = Q K^T as wgmma m64n64k16 over D / 16 K
// steps with both operands in shared memory, the online softmax on the
// accumulators in registers (exp2, fp32 state), and O += P V as wgmma
// m64nCWk16 per chunk of CW output channels with P in registers: the
// accumulator layout of S is the register layout of wgmma's A operand, so P
// never touches shared memory. V, stored [key][d], is read as an MN-major B
// (the descriptor's transpose bit); no transposed copy is made. 8 x 32 =
// 256 blocks at the census shape, two resident per SM (one at D = 128,
// whose ring takes 128 KB and whose O takes 64 registers a thread). D =
// 256: O is 128 registers a consumer thread, S 32 and P 16 more, so the
// producer is a whole warpgroup that gives its registers up (setmaxnreg:
// 24 a thread) and the consumers take 240; Q (64 KB) and two stages of K
// and V (64 KB each) fill 192 KB of shared memory.
//
// fp32 (flash_f32_kernel<D>): one block per (64 queries, bh), 256 threads,
// a register-tiled product on the FMA units. Q^T and each step's K^T
// (d-major) and V sit in shared memory; a thread owns a 4 x 4 tile of S (4
// queries x 4 keys) from float4 outer products, 8 FMAs per shared load; the
// row max and sum go across the 16 threads that share a row by shuffles; P
// goes through shared memory into a second register-tiled product for O (4
// queries x D / 16 channels, in vectors of 4, or 2 at D = 32). The next
// step's K and V are loaded into registers while this step computes (up to
// D = 128; at D = 256 they would take 128 registers a thread, so each
// step loads its own into shared memory).
#include "common.cuh"
#include "hopper.cuh"

using namespace dp;

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int BQ = 128, BKV = 64;

template <int D> struct FaTile {
  static constexpr int CW = D < 64 ? D : 64;  // channels of a shared-memory row: one swizzle span
  static constexpr int NC = D / CW;           // row chunks of a tile
  static constexpr int QTILE = BQ * D;        // bf16 elements of the block's Q
  static constexpr int KVTILE = BKV * D;      // of one K or V stage
  static constexpr int STAGES = D == 256 ? 2 : 3;
  // two consumer warpgroups + a producer warp; at D = 256 a producer
  // warpgroup whose registers the consumers take (setmaxnreg)
  static constexpr bool REALLOC = D == 256;
  static constexpr int THREADS = REALLOC ? 384 : 288;
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
  static constexpr size_t SMEM =
      1024 + (size_t)(QTILE + 2 * STAGES * KVTILE) * sizeof(bf16) + (1 + 2 * STAGES) * 8;
  static constexpr int MIN_BLOCKS = D >= 128 ? 1 : 2;
  __device__ static uint64_t desc(const void* p) { return CW == 64 ? sw128_desc(p) : sw64_desc(p); }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared memory: Q [chunk][128 queries][CW], then per stage K and V
// [chunk][64 keys][CW]; every chunk starts 1024-aligned.
template <int D>
__global__ void __launch_bounds__(FaTile<D>::THREADS, FaTile<D>::MIN_BLOCKS)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, int T, int dt, float sm_scale,
                   bf16* __restrict__ out) {
  using L = FaTile<D>;
  constexpr int CW = L::CW, NC = L::NC, KV_STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* Ks = Qs + L::QTILE;                 // [KV_STAGES][NC][64 keys][CW]
  bf16* Vs = Ks + KV_STAGES * L::KVTILE;    // [KV_STAGES][NC][64 keys][CW]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + KV_STAGES * L::KVTILE);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + KV_STAGES;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * T;  // this head's first row of the (BH * T, D) view
  const int q0 = blockIdx.x * BQ, nkv = T / BKV;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {  // producer warp (warpgroup)
    if constexpr (L::REALLOC) reg_dealloc<L::PRODUCER_REGS>();
    if (tid == 256) {
      mbar_arrive_expect_tx(q_full, L::QTILE * 2);
      for (int h = 0; h < NC; ++h)
        for (int r = 0; r < BQ; r += BKV)
          tma_load_2d(Qs + (h * BQ + r) * CW, &tq, h * CW, row0 + q0 + r, q_full);
      for (int it = 0; it < nkv; ++it) {
        const int s = it % KV_STAGES;
        mbar_wait(&kv_empty[s], ((it / KV_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&kv_full[s], 2 * L::KVTILE * 2);
        for (int h = 0; h < NC; ++h) {
          tma_load_2d(Ks + s * L::KVTILE + h * BKV * CW, &tk, h * CW, row0 + it * BKV,
                      &kv_full[s]);
          tma_load_2d(Vs + s * L::KVTILE + h * BKV * CW, &tv, h * CW, row0 + it * BKV,
                      &kv_full[s]);
        }
      }
    }
    return;
  }

  if constexpr (L::REALLOC) reg_alloc<L::CONSUMER_REGS>();
  const int cw = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const float c = sm_scale * LOG2E;  // scores in log2 units
  float o[NC][CW / 2], sc[32];
#pragma unroll
  for (int h = 0; h < NC; ++h)
#pragma unroll
    for (int i = 0; i < CW / 2; ++i) o[h][i] = 0.f;
#pragma unroll
  for (int h = 0; h < NC; ++h) reg_fence(o[h]);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  for (int it = 0; it < nkv; ++it) {
    const int s = it % KV_STAGES;
    mbar_wait(&kv_full[s], (it / KV_STAGES) & 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    reg_fence(sc);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < NC; ++h) {
      const uint64_t dq = L::desc(Qs + (h * BQ + cw * 64) * CW);
      const uint64_t dk = L::desc(Ks + s * L::KVTILE + h * BKV * CW);
#pragma unroll
      for (int kk = 0; kk < CW / 16; ++kk) wgmma_ss(sc, dq + 2 * kk, dk + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);

    // online softmax of rows g (sc[4i], sc[4i + 1]) and g + 8 (sc[4i + 2],
    // sc[4i + 3]); a row's 64 scores lie across the 4 threads of a quad
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sc[4 * i + 2 * hr] *= c;
        sc[4 * i + 2 * hr + 1] *= c;
        mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * hr], sc[4 * i + 2 * hr + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float alpha = exp2f(m[hr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sc[4 * i + 2 * hr] = exp2f(sc[4 * i + 2 * hr] - m_new);
        sc[4 * i + 2 * hr + 1] = exp2f(sc[4 * i + 2 * hr + 1] - m_new);
        sum += sc[4 * i + 2 * hr] + sc[4 * i + 2 * hr + 1];
      }
#pragma unroll
      for (int h = 0; h < NC; ++h)
#pragma unroll
        for (int i = 0; i < CW / 8; ++i) {
          o[h][4 * i + 2 * hr] *= alpha;
          o[h][4 * i + 2 * hr + 1] *= alpha;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hr] = l[hr] * alpha + sum;
      m[hr] = m_new;
    }

    // O += P V: 16-key step kk takes S blocks 2kk, 2kk + 1 as its A fragment
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < NC; ++h) {
      // 16 keys are 16 rows of CW * 2 bytes: 2 CW in the descriptor's 16-byte units
      const uint64_t dv = L::desc(Vs + s * L::KVTILE + h * BKV * CW);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(o[h], pa[kk], dv + kk * 2 * CW);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < NC; ++h) reg_fence(o[h]);
    reg_fence(pa);
    if ((tid & 127) == 0) mbar_arrive(&kv_empty[s]);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float inv = 1.f / l[hr];
    bf16* dst = out + (long)(row0 + q0 + cw * 64 + warp * 16 + g + 8 * hr) * dt + t2;
#pragma unroll
    for (int h = 0; h < NC; ++h)
#pragma unroll
      for (int i = 0; i < CW / 8; ++i)
        if (h * CW + 8 * i < dt)  // dt % 8 == 0: whole 8-channel groups
          *reinterpret_cast<__nv_bfloat162*>(dst + h * CW + 8 * i) = __floats2bfloat162_rn(
              o[h][4 * i + 2 * hr] * inv, o[h][4 * i + 2 * hr + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// fp32: register-tiled FMA products
// ---------------------------------------------------------------------------

constexpr int FQ = 64, FK = 64;  // queries per block, keys per step

template <int D> struct FaF32 {
  static constexpr int VW = D >= 64 ? 4 : 2;    // O channels per vector
  static constexpr int NJ = D / (16 * VW);      // O vectors per thread and row
  static constexpr int LD = FQ * D / 4 / NT;    // float4s of a 64-row tile per thread
  static constexpr bool PREFETCH = D <= 128;    // the next step's K and V in registers
  static constexpr size_t SMEM = (size_t)(3 * FQ * D + FQ * FK) * sizeof(float);
  static constexpr int MIN_BLOCKS = D >= 128 ? 1 : 2;
};

template <int VW> struct FVec;
template <> struct FVec<4> {
  __device__ static void load(const float* p, float* v) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct FVec<2> {
  __device__ static void load(const float* p, float* v) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};

template <int D>
__global__ void __launch_bounds__(NT, FaF32<D>::MIN_BLOCKS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, int T, float sm_scale, float* __restrict__ out) {
  using L = FaF32<D>;
  constexpr int VW = L::VW, NJ = L::NJ, D4 = D / 4;
  extern __shared__ __align__(16) float fsm[];
  float* Qt = fsm;          // [d][query]
  float* Kt = Qt + D * FQ;  // [d][key]
  float* Vs = Kt + D * FK;  // [key][d]
  float* Ps = Vs + FK * D;  // [query][key]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long base = (long)blockIdx.y * T * D;
  const int q0 = blockIdx.x * FQ;
  const float c = sm_scale * LOG2E;

  // item i of a 64-row tile: K^T and Q^T by (row i & 63, channels 4 (i >> 6)..)
  // so that a warp writes one transposed row; V by (row i / D4, channels
  // 4 (i % D4)..)
  for (int i = tid; i < FQ * D4; i += NT) {
    const int r = i & 63, d4 = (i >> 6) * 4;
    const float4 t = load4(q + base + (long)(q0 + r) * D + d4);
    Qt[(d4 + 0) * FQ + r] = t.x;
    Qt[(d4 + 1) * FQ + r] = t.y;
    Qt[(d4 + 2) * FQ + r] = t.z;
    Qt[(d4 + 3) * FQ + r] = t.w;
  }
  // item i of a step: K^T by (key i & 63, channels 4 (i >> 6)..), V by (key
  // i / D4, channels 4 (i % D4)..)
  auto put = [&](int i, const float4& kv4, const float4& vv4) {
    const int r = i & 63, d4 = (i >> 6) * 4;
    Kt[(d4 + 0) * FK + r] = kv4.x;
    Kt[(d4 + 1) * FK + r] = kv4.y;
    Kt[(d4 + 2) * FK + r] = kv4.z;
    Kt[(d4 + 3) * FK + r] = kv4.w;
    store4(Vs + (i / D4) * D + (i % D4) * 4, vv4);
  };
  auto kload = [&](int kb, int i) { return load4(k + base + (long)(kb + (i & 63)) * D + (i >> 6) * 4); };
  auto vload = [&](int kb, int i) { return load4(v + base + (long)(kb + i / D4) * D + (i % D4) * 4); };
  constexpr int NR = L::PREFETCH ? L::LD : 1;  // registers of the next step's K and V
  float4 kr[NR], vr[NR];
  auto fetch = [&](int kb) {
#pragma unroll
    for (int u = 0; u < NR; ++u) {
      kr[u] = kload(kb, tid + u * NT);
      vr[u] = vload(kb, tid + u * NT);
    }
  };
  if constexpr (L::PREFETCH) fetch(0);

  float o[4][NJ * VW], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ * VW; ++j) o[i][j] = 0.f;
  }

  for (int kb = 0; kb < T; kb += FK) {
    __syncthreads();  // the previous step's reads of Kt, Vs and Ps are done
    if constexpr (L::PREFETCH) {
#pragma unroll
      for (int u = 0; u < L::LD; ++u) put(tid + u * NT, kr[u], vr[u]);
    } else {
#pragma unroll 4
      for (int u = 0; u < L::LD; ++u) put(tid + u * NT, kload(kb, tid + u * NT), vload(kb, tid + u * NT));
    }
    __syncthreads();
    if constexpr (L::PREFETCH)
      if (kb + FK < T) fetch(kb + FK);  // in flight during this step's products

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * FQ + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(Kt + d * FK + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // online softmax: row 4 ty + i spans the 16 threads tx of a half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= c;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int j = 0; j < NJ * VW; ++j) o[i][j] *= alpha;
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
      store4(Ps + (4 * ty + i) * FK + 4 * tx, make_float4(s[i][0], s[i][1], s[i][2], s[i][3]));
    }
    __syncthreads();

    // O += P V: 4 keys per step, 4 P rows as float4s against 4 V rows;
    // thread tx owns channels 16 VW j + VW tx .. + VW - 1
#pragma unroll 4
    for (int k4 = 0; k4 < FK; k4 += 4) {
      float pv[4][4], vv[4][NJ * VW];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(Ps + (4 * ty + i) * FK + k4);
        pv[i][0] = p.x; pv[i][1] = p.y; pv[i][2] = p.z; pv[i][3] = p.w;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          FVec<VW>::load(Vs + (k4 + i) * D + 16 * VW * j + VW * tx, &vv[i][VW * j]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ * VW; ++j) o[i][j] = fmaf(pv[i][kk], vv[kk][j], o[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / l[i];
    float r[NJ * VW];
#pragma unroll
    for (int j = 0; j < NJ * VW; ++j) r[j] = o[i][j] * inv;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      FVec<VW>::store(out + base + (long)(q0 + 4 * ty + i) * D + 16 * VW * j + VW * tx,
                      &r[VW * j]);
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// A (rows, dt) bf16 view in boxes of CW channels x 64 rows, in the swizzle
// of CW * 2 bytes (128 for D >= 64, 64 for D = 32); channels from dt to
// the box's end read as zeros.
template <int D>
bool tile_map(CUtensorMap* map, const void* p, long rows, int dt) {
  constexpr int CW = FaTile<D>::CW;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)dt, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {dt * sizeof(bf16)};
  const cuuint32_t box[2] = {CW, BKV};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, int BH, int T, int dt,
                        float sm_scale, void* out, cudaStream_t st) {
  if (T % BQ != 0 || dt % 8 || dt > D) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  const long rows = (long)BH * T;
  if (!tile_map<D>(&tq, q, rows, dt) || !tile_map<D>(&tk, k, rows, dt) ||
      !tile_map<D>(&tv, v, rows, dt))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FaTile<D>::SMEM);
  if (err != cudaSuccess) return err;
  flash_wgmma_kernel<D><<<dim3(T / BQ, BH), FaTile<D>::THREADS, FaTile<D>::SMEM, st>>>(
      tq, tk, tv, T, dt, sm_scale, static_cast<bf16*>(out));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, int BH, int T,
                       float sm_scale, void* out, cudaStream_t st) {
  if (T % FQ != 0) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FaF32<D>::SMEM);
  if (err != cudaSuccess) return err;
  flash_f32_kernel<D><<<dim3(T / FQ, BH), NT, FaF32<D>::SMEM, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      T, sm_scale, static_cast<float*>(out));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, int BH, int T, int dt,
                   float sm_scale, void* out, cudaStream_t st) {
  if (dtype == 1) return launch_bf16<D>(q, k, v, BH, T, dt, sm_scale, out, st);
  return dt == D ? launch_f32<D>(q, k, v, BH, T, sm_scale, out, st) : cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16. q, k, v, out (BH, T, dt) contiguous, run on the
// kernel for D; sm_scale multiplies q k^T (scale^2 of the JAX kernel).
// Requires D in {32, 64, 128, 256}, dt == D (fp32) or dt <= D with dt % 8
// == 0 (bf16), and T % 128 == 0 (bf16) or T % 64 == 0 (fp32) (the wrapper
// checks, and pads other widths). Returns a cudaError_t.
int diffpure_flash_attention(int dtype, const void* q, const void* k, const void* v, int BH,
                             int T, int D, int dt, float sm_scale, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(dtype, q, k, v, BH, T, dt, sm_scale, out, st);
    case 64: return launch<64>(dtype, q, k, v, BH, T, dt, sm_scale, out, st);
    case 128: return launch<128>(dtype, q, k, v, BH, T, dt, sm_scale, out, st);
    case 256: return launch<256>(dtype, q, k, v, BH, T, dt, sm_scale, out, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
