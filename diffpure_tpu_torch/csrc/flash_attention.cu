// Flash (online-softmax) attention for the ADM's 1024-token blocks, bf16 or
// fp32, (BH, T, D) with D = 64.
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
// bf16 (flash_wgmma_kernel): one block per (128 queries, bh), two consumer
// warpgroups of 64 queries and one producer warp. The producer brings the
// block's Q once and K and V 64 keys at a time by TMA (tensor maps, 128-byte
// swizzle) into a ring of 3 stages on mbarriers. Each consumer runs S = Q K^T
// as wgmma m64n64k16 with both operands in shared memory, the online
// softmax on the accumulators in registers (exp2, fp32 state), and O += P V
// as wgmma with P in registers: the accumulator layout of S is the register
// layout of wgmma's A operand, so P never touches shared memory. V, stored
// [key][d], is read as an MN-major B (the descriptor's transpose bit); no
// transposed copy is made. 8 x 32 = 256 blocks at the census shape, two
// resident per SM.
//
// fp32 (flash_f32_kernel): one block per (64 queries, bh), 256 threads, a
// register-tiled product on the FMA units. Q^T and each step's K^T (d-major)
// and V sit in shared memory; a thread owns a 4 x 4 tile of S (4 queries x
// 4 keys) from float4 outer products, 8 FMAs per shared load; the row max
// and sum go across the 16 threads that share a row by shuffles; P goes
// through shared memory into a second 4 x 4 register-tiled product for O
// (4 queries x 4 channels), again 8 FMAs per load. The next step's K and V
// are loaded into registers while this step computes.
#include "common.cuh"
#include "hopper.cuh"

using namespace dp;

namespace {

constexpr int FD = 64;  // head channels
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int BQ = 128, BKV = 64, KV_STAGES = 3;
constexpr int FA_THREADS = 288;  // two consumer warpgroups + a producer warp
constexpr int TILE = BKV * FD;   // bf16 elements of one 64 x 64 tile (8 KB)
constexpr size_t FA_SMEM =
    1024 + (size_t)(2 * TILE + 2 * KV_STAGES * TILE) * sizeof(bf16) + (1 + 2 * KV_STAGES) * 8;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(FA_THREADS, 2)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, int T, float sm_scale,
                   bf16* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* Ks = Qs + 2 * TILE;           // [KV_STAGES][64 keys][64]
  bf16* Vs = Ks + KV_STAGES * TILE;   // [KV_STAGES][64 keys][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + KV_STAGES * TILE);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + KV_STAGES;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * T;  // this head's first row of the (BH * T, 64) view
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

  if (tid >= 256) {  // producer warp
    if (tid == 256) {
      mbar_arrive_expect_tx(q_full, 2 * TILE * 2);
      tma_load_2d(Qs, &tq, 0, row0 + q0, q_full);
      tma_load_2d(Qs + TILE, &tq, 0, row0 + q0 + 64, q_full);
      for (int it = 0; it < nkv; ++it) {
        const int s = it % KV_STAGES;
        mbar_wait(&kv_empty[s], ((it / KV_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&kv_full[s], 2 * TILE * 2);
        tma_load_2d(Ks + s * TILE, &tk, 0, row0 + it * BKV, &kv_full[s]);
        tma_load_2d(Vs + s * TILE, &tv, 0, row0 + it * BKV, &kv_full[s]);
      }
    }
    return;
  }

  const int cw = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const float c = sm_scale * LOG2E;  // scores in log2 units
  float o[32], sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  reg_fence(o);
  mbar_wait(q_full, 0);
  const uint64_t dq = sw128_desc(Qs + cw * TILE);

  for (int it = 0; it < nkv; ++it) {
    const int s = it % KV_STAGES;
    mbar_wait(&kv_full[s], (it / KV_STAGES) & 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    reg_fence(sc);
    wgmma_fence();
    const uint64_t dk = sw128_desc(Ks + s * TILE);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc, dq + 2 * kk, dk + 2 * kk);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);

    // online softmax of rows g (sc[4i], sc[4i + 1]) and g + 8 (sc[4i + 2],
    // sc[4i + 3]); a row's 64 scores lie across the 4 threads of a quad
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sc[4 * i + 2 * h] *= c;
        sc[4 * i + 2 * h + 1] *= c;
        mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * h], sc[4 * i + 2 * h + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float alpha = exp2f(m[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sc[4 * i + 2 * h] = exp2f(sc[4 * i + 2 * h] - m_new);
        sc[4 * i + 2 * h + 1] = exp2f(sc[4 * i + 2 * h + 1] - m_new);
        sum += sc[4 * i + 2 * h] + sc[4 * i + 2 * h + 1];
        o[4 * i + 2 * h] *= alpha;
        o[4 * i + 2 * h + 1] *= alpha;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[h] = l[h] * alpha + sum;
      m[h] = m_new;
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
    const uint64_t dv = sw128_desc(Vs + s * TILE);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(o, pa[kk], dv + kk * (16 * 128 / 16));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
    reg_fence(pa);
    if ((tid & 127) == 0) mbar_arrive(&kv_empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float inv = 1.f / l[h];
    bf16* dst = out + (long)(row0 + q0 + cw * 64 + warp * 16 + g + 8 * h) * FD + t2;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) =
          __floats2bfloat162_rn(o[4 * i + 2 * h] * inv, o[4 * i + 2 * h + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// fp32: register-tiled FMA products
// ---------------------------------------------------------------------------

constexpr int FQ = 64, FK = 64;  // queries per block, keys per step
constexpr size_t F32_SMEM = 4 * FQ * FD * sizeof(float);

__global__ void __launch_bounds__(NT, 2)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, int T, float sm_scale, float* __restrict__ out) {
  extern __shared__ __align__(16) float fsm[];
  float* Qt = fsm;          // [d][query]
  float* Kt = Qt + FD * FQ;  // [d][key]
  float* Vs = Kt + FD * FK;  // [key][d]
  float* Ps = Vs + FK * FD;  // [query][key]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long base = (long)blockIdx.y * T * FD;
  const int q0 = blockIdx.x * FQ;
  const float c = sm_scale * LOG2E;

  // item i of a 64 x 64 tile: K^T and Q^T by (row i & 63, channels 4 (i >> 6)..)
  // so that a warp writes one transposed row; V by (row i >> 4, channels 4 (i & 15)..)
  for (int i = tid; i < FQ * FD / 4; i += NT) {
    const int r = i & 63, d4 = (i >> 6) * 4;
    const float4 t = load4(q + base + (long)(q0 + r) * FD + d4);
    Qt[(d4 + 0) * FQ + r] = t.x;
    Qt[(d4 + 1) * FQ + r] = t.y;
    Qt[(d4 + 2) * FQ + r] = t.z;
    Qt[(d4 + 3) * FQ + r] = t.w;
  }
  float4 kr[4], vr[4];
  auto fetch = [&](int kb) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = tid + u * NT;
      kr[u] = load4(k + base + (long)(kb + (i & 63)) * FD + (i >> 6) * 4);
      vr[u] = load4(v + base + (long)(kb + (i >> 4)) * FD + (i & 15) * 4);
    }
  };
  fetch(0);

  float o[4][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }

  for (int kb = 0; kb < T; kb += FK) {
    __syncthreads();  // the previous step's reads of Kt, Vs and Ps are done
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = tid + u * NT, r = i & 63, d4 = (i >> 6) * 4;
      Kt[(d4 + 0) * FK + r] = kr[u].x;
      Kt[(d4 + 1) * FK + r] = kr[u].y;
      Kt[(d4 + 2) * FK + r] = kr[u].z;
      Kt[(d4 + 3) * FK + r] = kr[u].w;
      store4(Vs + (i >> 4) * FD + (i & 15) * 4, vr[u]);
    }
    __syncthreads();
    if (kb + FK < T) fetch(kb + FK);  // in flight during this step's products

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < FD; ++d) {
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
        o[i][j] *= alpha;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
      store4(Ps + (4 * ty + i) * FK + 4 * tx, make_float4(s[i][0], s[i][1], s[i][2], s[i][3]));
    }
    __syncthreads();

    // O += P V: 4 keys per step, 4 P rows and 4 V rows as float4s
#pragma unroll 4
    for (int k4 = 0; k4 < FK; k4 += 4) {
      float pv[4][4], vv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(Ps + (4 * ty + i) * FK + k4);
        pv[i][0] = p.x; pv[i][1] = p.y; pv[i][2] = p.z; pv[i][3] = p.w;
        const float4 w = *reinterpret_cast<const float4*>(Vs + (k4 + i) * FD + 4 * tx);
        vv[i][0] = w.x; vv[i][1] = w.y; vv[i][2] = w.z; vv[i][3] = w.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) o[i][j] = fmaf(pv[i][kk], vv[kk][j], o[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / l[i];
    store4(out + base + (long)(q0 + 4 * ty + i) * FD + 4 * tx,
           make_float4(o[i][0] * inv, o[i][1] * inv, o[i][2] * inv, o[i][3] * inv));
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// A (rows, 64) bf16 view in 64 x 64 boxes with the 128-byte swizzle.
bool tile_map(CUtensorMap* map, const void* p, long rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {FD, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {FD * sizeof(bf16)};
  const cuuint32_t box[2] = {FD, BKV};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16. q, k, v, out (BH, T, D) contiguous; sm_scale
// multiplies q k^T (scale^2 of the JAX kernel). Requires D == 64 and
// T % 128 == 0 (bf16) or T % 64 == 0 (fp32) (the wrapper checks). Returns
// a cudaError_t.
int diffpure_flash_attention(int dtype, const void* q, const void* k, const void* v, int BH,
                             int T, int D, float sm_scale, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != FD) return cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 1) {
    if (T % BQ != 0) return cudaErrorInvalidValue;
    CUtensorMap tq, tk, tv;
    const long rows = (long)BH * T;
    if (!tile_map(&tq, q, rows) || !tile_map(&tk, k, rows) || !tile_map(&tv, v, rows))
      return cudaErrorInvalidValue;
    if ((err = cudaFuncSetAttribute(flash_wgmma_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)FA_SMEM)) != cudaSuccess)
      return err;
    flash_wgmma_kernel<<<dim3(T / BQ, BH), FA_THREADS, FA_SMEM, st>>>(
        tq, tk, tv, T, sm_scale, static_cast<bf16*>(out));
  } else {
    if (T % FQ != 0) return cudaErrorInvalidValue;
    if ((err = cudaFuncSetAttribute(flash_f32_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)F32_SMEM)) != cudaSuccess)
      return err;
    flash_f32_kernel<<<dim3(T / FQ, BH), NT, F32_SMEM, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), T, sm_scale, static_cast<float*>(out));
  }
  return cudaGetLastError();
}

}  // extern "C"
