// The fp32 chain of the fused NCSN++ attention block (kernel #3, the score
// DDPM's path): GroupNorm -> q, k, v NIN -> per-example softmax(q k^T
// C^-1/2) in fp32 -> @ v -> output NIN -> + x (times oscale), as
// fused_attnblock.cu's bf16 chain and the TPU kernel
// diffpure_tpu/ops/fused_attnblock.py:106 fused_attnblock_pallas compute
// it. Its own file so that it compiles beside the bf16 chain.
//
// attnblock_fwd_f32: three launches on the FMA units (never TF32),
//   1. the GroupNorm pass gn_regs_kernel (gn_silu.cuh: kernel #10's body
//      without its SiLU), each (example, group) slice in registers between
//      its one read and its one write;
//   2. q | k | v as attn_qkv_f32_kernel below, a projection-only GEMM;
//   3. attn_f32_kernel below: the HW x HW core and the output NIN.
// What bounds them on this card: at the DDPM's 16 x 16 x 256 (batch 8) the
// two attention products and the output NIN are 403 M FMAs and the q | k |
// v GEMM 201 M, 14 us and 7 us at the FMA units' 67 TFLOP/s. An SM
// serves 128 bytes of shared memory a clock, a 16-byte load a quarter-warp
// at a time, against 128 FMAs a clock: a thread's register tile must feed
// about 16 FMAs per 16-byte load, 8 x 8 outputs, for the FMAs and not the
// loads to set the pace. What the design does: the GEMM takes 128 x 96
// tiles (128 blocks), two groups of 192 threads that split each 32-k step,
// 8 x 8 outputs a thread; the core one block per (16 queries, example)
// (128 blocks), 8 warps each holding 8 queries x 8 R keys (or output or a
// channels) and a quarter of each chunk's contraction, the quarters'
// partials summed in a fixed order through shared memory (af_reduce). K,
// V and Wout^T (and the GEMM's h and W rows) stream from L2 by cp.async
// through four-stage rings, one barrier a chunk, each thread's copies from
// fixed pointers. S = q k^T * C^-1/2 as whole rows in shared memory, the
// softmax in the TPU kernel's order (max, exp, sum, divide; no online
// softmax), a = P V into the buffer that held Q, then out = (a Wout + bo
// + x) * oscale from a on chip: no att scratch, no second GEMM. Keys past
// HW are zero rows (cp.async zero-fill) with p = 0, so no block reads
// another example's rows. Where the grid is far below the SMs (the 4 x 4
// map at batch 8: 8 query tiles) the output channels split over
// blockIdx.z and the GEMM's K over slices (attnblock_f32_plan's osplit,
// ksplit). Measured on an H100 (PERF.md): the GEMM at about 46% of the FMA
// peak, the core at about 30%: 8 warps an SM leave the FMA loop at an IPC
// near 0.6, and the chunks' bookkeeping, the reductions and the first
// chunks' burst from L2 take about half of the core's time.
// No cuBLAS, no library attention: every product is a kernel here.
#include "common.cuh"
#include "gn_silu.cuh"

using namespace dp;

namespace {

constexpr int AF_QT = 16;        // queries a block
constexpr int AF_THREADS = 256;  // 8 warps: 2 query groups x 4 quarters of the contraction
constexpr int AF_CK = 32;  // channels (S, out NIN) or keys (P V) a streamed chunk
// a ring stage: 256 rows of AF_CK channels (K, Wout^T; padded to AF_LDR
// floats: conflict-free), or AF_CK keys of V's 256 channels
constexpr int AF_LDR = AF_CK + 4, AF_STAGE = 256 * AF_LDR;
constexpr int AF_RED = 256 + 4;  // a row of the split-contraction partials

__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

// q | k | v = h [Wq | Wk | Wv] + b on the FMA units: out (M, Nout), h (M,
// K), w (Nout, K) (a row per output channel), K % 16 == 0, Nout % 96 == 0
// (3C with C % 32 == 0). A 128 x 96 tile a block (128 blocks at the
// DDPM's 16 x 16 x 256, batch 8); K in steps of 32 through a QK_STAGES-deep
// cp.async ring (rows padded: conflict-free); 384 threads, two groups that
// each take half of every step's k, of 16 x 12 threads with 8 x 8 outputs:
// per 4 k, 8 + 8 16-byte shared loads (the rows' near-broadcasts, the
// columns' on consecutive padded rows) for 256 FMAs. The two groups'
// sums meet in shared memory at the end. Where the tiles leave most SMs
// idle (the 4 x 4 map) K also splits over blockIdx.z, each slice's
// partial sums to ws, summed by attn_qkv_sum_kernel in slice order.
constexpr int QK_BM = 128, QK_BN = 96, QK_BK = 32, QK_LD = QK_BK + 4, QK_STAGES = 4;
constexpr int QK_THREADS = 2 * (QK_BM / 8) * (QK_BN / 8);  // 2 x 16 x 12
constexpr int QK_STAGE = (QK_BM + QK_BN) * QK_LD;          // floats a stage
constexpr int QK_RED = QK_BN + 4;
constexpr size_t QK_SMEM = sizeof(float) * QK_STAGES * QK_STAGE;
static_assert(QK_BM * QK_RED <= QK_STAGES * QK_STAGE, "the groups' sums fit the ring");

__global__ void __launch_bounds__(QK_THREADS, 1)
attn_qkv_f32_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const float* __restrict__ bias, int M, int Nout, int K, int kper,
                    float* __restrict__ out, float* __restrict__ ws) {
  extern __shared__ float4 qk_smem4[];
  float* ring = reinterpret_cast<float*>(qk_smem4);
  const int tid = threadIdx.x, kz = tid / 192, t = tid - kz * 192, ty = t / 12, tx = t - ty * 12;
  const int m0 = blockIdx.x * QK_BM, n0 = blockIdx.y * QK_BN;
  const int kbeg = blockIdx.z * kper, nk = (min(K, kbeg + kper) - kbeg) / QK_BK;
  // a thread's part of a step (8 float4 a row of 32 k): rows tid / 8 + 48 u
  // of the stage's 128 A rows (h) then 96 B rows (w), at k 4 (tid % 8);
  // fixed pointers: a step is 5 copies and a few adds a thread
  const int lr = tid >> 3, lc = (tid & 7) * 4;
  auto fill = [&](int kc) {  // step kc into its stage
    float* A = ring + (kc % QK_STAGES) * QK_STAGE;
    const int k0 = kbeg + kc * QK_BK + lc;
#pragma unroll
    for (int u = 0; u < 5; ++u) {
      const int r = lr + 48 * u;
      if (r < QK_BM) {
        const bool ok = m0 + r < M;
        cp_async16_zfill(A + r * QK_LD + lc, ok ? h + (long)(m0 + r) * K + k0 : h, ok);
      } else if (r < QK_BM + QK_BN) {
        cp_async16_zfill(A + r * QK_LD + lc, w + (long)(n0 + r - QK_BM) * K + k0, true);
      }
    }
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int kc = 0; kc < QK_STAGES - 1; ++kc) {
    if (kc < nk) fill(kc);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    // wait for step kc; every thread being past step kc - 1, refill its stage
    cp_async_wait<QK_STAGES - 2>();
    __syncthreads();
    if (kc + QK_STAGES - 1 < nk) fill(kc + QK_STAGES - 1);
    cp_async_commit();
    const float* A = ring + (kc % QK_STAGES) * QK_STAGE;
    const float* B = A + QK_BM * QK_LD;
#pragma unroll
    for (int kk = 0; kk < QK_BK / 2; kk += 4) {
      const int k = (QK_BK / 2) * kz + kk;
      float4 a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * QK_LD + k);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = *reinterpret_cast<const float4*>(B + (tx + 12 * j) * QK_LD + k);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
  }
  cp_async_wait<0>();
  float bv[8];  // the bias, in flight across the groups' reduction
#pragma unroll
  for (int j = 0; j < 8; ++j) bv[j] = gridDim.z > 1 ? 0.f : bias[n0 + tx + 12 * j];
  __syncthreads();  // every thread is done with the ring
  // group 1's sums to shared memory, group 0 adds them and stores
  float* red = ring;
  if (kz == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[(ty + 16 * i) * QK_RED + tx + 12 * j] = acc[i][j];
  }
  __syncthreads();
  if (kz == 1) return;
  float* dst = gridDim.z > 1 ? ws + (long)blockIdx.z * M * Nout : out;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i, m = m0 + r;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 12 * j;
      dst[(long)m * Nout + n] = acc[i][j] + red[r * QK_RED + tx + 12 * j] + bv[j];
    }
  }
}

// The K slices' partials of attn_qkv_f32_kernel summed in slice order, plus
// the bias; a thread per 4 outputs.
__global__ void __launch_bounds__(256)
attn_qkv_sum_kernel(const float* __restrict__ ws, const float* __restrict__ bias, int M, int Nout,
                    int slices, float* __restrict__ out) {
  const long i = ((long)blockIdx.x * 256 + threadIdx.x) * 4, total = (long)M * Nout;
  if (i >= total) return;
  float4 v = *reinterpret_cast<const float4*>(bias + i % Nout);
  for (int z = 0; z < slices; ++z) {
    const float4 p = *reinterpret_cast<const float4*>(ws + z * total + i);
    v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
  }
  *reinterpret_cast<float4*>(out + i) = v;
}

// The core's warp tile: acc[i][r] += A[8 qg + i][c0 + c] * B[lane + 32 r][c]
// over the 8 channels c of a chunk that quarter kq takes: A in shared
// memory (row stride lda: Q, a), B the chunk's rows (row stride AF_LDR:
// K, Wout^T). Per 4 channels 8 + R 16-byte shared loads (A's broadcasts,
// B's conflict-free) feed 32 R FMAs.
template <int R>
__device__ __forceinline__ void af_rowdot(float (&acc)[8][R], const float* A, int lda, int c0,
                                          const float* B, int qg, int kq, int lane) {
#pragma unroll
  for (int cc = 0; cc < AF_CK / 4; cc += 4) {
    const int c = (AF_CK / 4) * kq + cc;
    float4 a[8], b[R];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (8 * qg + i) * lda + c0 + c);
#pragma unroll
    for (int r = 0; r < R; ++r)
      b[r] = *reinterpret_cast<const float4*>(B + (lane + 32 * r) * AF_LDR + c);
    // channel by channel across the 8 R accumulators: consecutive FMAs
    // are independent (each accumulator's four would wait on each other)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[i][r] = fmaf(a[i].x, b[r].x, acc[i][r]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[i][r] = fmaf(a[i].y, b[r].y, acc[i][r]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[i][r] = fmaf(a[i].z, b[r].z, acc[i][r]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[i][r] = fmaf(a[i].w, b[r].w, acc[i][r]);
  }
}

// The four quarters' partials summed, (q0 + q2) + (q1 + q3), into the
// registers of quarter 0, through red (a free ring stage): deterministic.
template <int R>
__device__ __forceinline__ void af_reduce(float (&acc)[8][R], float* red, int qg, int kq,
                                          int lane) {
  auto at = [&](int slot, int i, int r) { return red + (slot * AF_QT + 8 * qg + i) * AF_RED + lane + 32 * r; };
  __syncthreads();  // every warp is done with the phase's last chunk, in red's stage
  if (kq >= 2) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int r = 0; r < R; ++r) *at(kq - 2, i, r) = acc[i][r];
  }
  __syncthreads();
  if (kq < 2) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[i][r] += *at(kq, i, r);
  }
  __syncthreads();
  if (kq == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int r = 0; r < R; ++r) *at(0, i, r) = acc[i][r];
  }
  __syncthreads();
  if (kq == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[i][r] += *at(0, i, r);
  }
  __syncthreads();
}

// The S and out NIN stream: rows [0, 128 KJ) of src (row stride ld), the
// AF_CK channels from c0, rows past `valid` as zeros. A thread copies the
// 16 bytes at channel 4 (tid % 8) of rows tid / 8 + 32 u (fixed pointers:
// a few adds a copy).
template <int KJ>
__device__ __forceinline__ void af_load_rows(float* buf, const float* src, long ld, int valid,
                                             int c0) {
  const int r0 = threadIdx.x >> 3, c = (threadIdx.x & 7) * 4;
  const float* p = src + r0 * ld + c0 + c;
  float* d = buf + r0 * AF_LDR + c;
#pragma unroll
  for (int u = 0; u < 4 * KJ; ++u) {
    const bool ok = r0 + 32 * u < valid;
    cp_async16_zfill(d + 32 * u * AF_LDR, ok ? p + 32 * u * ld : src, ok);
  }
}

// The core and the output NIN of #3's fp32 chain: one block per (16
// queries, example, output slice); see the file's header.
// qkv: (N, hw, 3C) = q | k | v; wo: Wout^T (C, C), a row per output
// channel; bo (C); x, out: (N, hw, C). KJ = 1 (hw <= 128) or 2 (hw <=
// 256): 128 KJ keys a score row; KJO = 1 or 2: 128 KJO output channels a
// pass of the output NIN over the block's ocols. Warp w takes queries 8 (w
// & 1).. and the quarter w >> 1 of each chunk's contraction, its lanes 4
// KJ keys (or output channels) lane + 32 r, or 8 channels of a; the
// quarters' partials meet in af_reduce. Shared memory (floats): QA [16][C
// + 4] (Q, then a), P [16][128 KJ + 4], the ring [stages][AF_STAGE].
template <int KJ, int KJO>
__global__ void __launch_bounds__(AF_THREADS, 1)
attn_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ wo,
                const float* __restrict__ bo, const float* __restrict__ x, float oscale, int hw,
                int C, int ocols, int stages, float sm_scale, float* __restrict__ out) {
  extern __shared__ float4 af_smem4[];
  float* QA = reinterpret_cast<float*>(af_smem4);
  const int lda = C + 4, ldp = 128 * KJ + 4;
  float* P = QA + AF_QT * lda;
  float* ring = P + AF_QT * ldp;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qg = warp & 1, kq = warp >> 1;
  const int n = blockIdx.y, q0 = blockIdx.x * AF_QT, o0 = blockIdx.z * ocols;
  const long row3 = 3L * C;
  const float* ex = qkv + (long)n * hw * row3;  // the example's q | k | v rows
  const int nq = min(AF_QT, hw - q0);

  // the chunks in order: C / AF_CK of K; per pass of 256 channels of v,
  // ceil(hw / AF_CK) of V; per pass of 128 KJO output channels, C / AF_CK
  // of Wout^T
  const int nS = C / AF_CK, nK = (hw + AF_CK - 1) / AF_CK, npv = (C + 255) / 256;
  const int nop = (ocols + 128 * KJO - 1) / (128 * KJO);
  const int total = nS + npv * nK + nop * nS;
  // the copy cursor: the next chunk to copy, its phase (0 K, 1 V, 2 Wout^T),
  // its pass and its index in the pass (no divisions a chunk)
  int gi = 0, ph = 0, pass = 0, idx = 0;
  auto fill = [&]() {
    float* buf = ring + (gi % stages) * AF_STAGE;
    if (ph == 0) {
      af_load_rows<KJ>(buf, ex + C, row3, hw, idx * AF_CK);
    } else if (ph == 1) {  // V: AF_CK keys x 256 channels, row stride 256
      const int cb = pass * 256, j0 = idx * AF_CK;
      const int j = tid >> 6, c = (tid & 63) * 4;  // keys j + 4 u, channels c..
      const bool cok = cb + c < C;
      const float* p = ex + (long)(j0 + j) * row3 + 2 * C + cb + c;
#pragma unroll
      for (int u = 0; u < AF_CK / 4; ++u) {
        const bool ok = cok && j0 + j + 4 * u < hw;
        cp_async16_zfill(buf + (j + 4 * u) * 256 + c, ok ? p + 4 * u * row3 : ex, ok);
      }
    } else {
      const int ob = o0 + pass * 128 * KJO;
      af_load_rows<KJO>(buf, wo + (long)ob * C, C, min(128 * KJO, o0 + ocols - ob), idx * AF_CK);
    }
    ++gi;
    const int n_idx = ph == 1 ? nK : nS, n_pass = ph == 0 ? 1 : ph == 1 ? npv : nop;
    if (++idx == n_idx) {
      idx = 0;
      if (++pass == n_pass) {
        pass = 0;
        ++ph;
      }
    }
  };
  int g = 0;
  // wait for chunk g; then, every thread being past chunk g - 1, refill its
  // stage with chunk g + stages - 1: one barrier a chunk
  auto next = [&]() {
    if (stages == 4)
      cp_async_wait<2>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (gi < total) fill();  // chunk g + stages - 1
    cp_async_commit();
    return ring + (g % stages) * AF_STAGE;
  };
  auto done = [&]() { ++g; };
  // after a phase's last chunk (and af_reduce's first barrier): the stage
  // it used is free until the next next()
  auto free_stage = [&]() { return ring + ((g - 1) % stages) * AF_STAGE; };

  // Q (rows past hw: zeros) with the first chunk, then the next stages - 2
  for (int e = tid; e < AF_QT * (C / 4); e += AF_THREADS) {
    const int i = e / (C / 4), c = (e % (C / 4)) * 4;
    const bool ok = i < nq;
    cp_async16_zfill(QA + i * lda + c, ok ? ex + (long)(q0 + i) * row3 + c : ex, ok);
  }
  for (int k = 0; k < stages - 1; ++k) {
    if (gi < total) fill();
    cp_async_commit();
  }
  // (groups in flight before next(): chunks g .. g + stages - 2)

  // S = q k^T over the example's keys (past hw: zero rows, masked below)
  {
    float s[8][4 * KJ];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int r = 0; r < 4 * KJ; ++r) s[i][r] = 0.f;
    for (int j = 0; j < nS; ++j) {
      af_rowdot<4 * KJ>(s, QA, lda, j * AF_CK, next(), qg, kq, lane);
      done();
    }
    af_reduce<4 * KJ>(s, free_stage(), qg, kq, lane);
    if (kq == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int r = 0; r < 4 * KJ; ++r) P[(8 * qg + i) * ldp + lane + 32 * r] = s[i][r] * sm_scale;
    }
  }
  __syncthreads();
  // softmax over each row's hw keys in fp32, in the TPU kernel's order:
  // max, exp, sum, divide; a warp a row; keys past hw get p = 0
  for (int i = warp; i < AF_QT; i += AF_THREADS / 32) {
    float* row = P + i * ldp;
    float mx = -INFINITY;
    for (int j = lane; j < hw; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int j = lane; j < hw; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < 128 * KJ; j += 32) row[j] = j < hw ? row[j] / sum : 0.f;
  }
  __syncthreads();

  // a = P V, 256 channels a pass, into QA (Q is done with): lane takes
  // channels 4 lane.. and 128 + 4 lane.., quarter kq the keys 8 kq.. of
  // each chunk; per 4 keys 8 broadcast loads of P and 8 of V feed 256 FMAs
  for (int pc = 0; pc < npv; ++pc) {
    float a[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int r = 0; r < 8; ++r) a[i][r] = 0.f;
    for (int kc = 0; kc < nK; ++kc) {
      const float* V = next();
#pragma unroll
      for (int jj = 0; jj < AF_CK / 4; jj += 4) {
        const int j = (AF_CK / 4) * kq + jj;
        float4 p[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          p[i] = *reinterpret_cast<const float4*>(P + (8 * qg + i) * ldp + kc * AF_CK + j);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float4 v0 = *reinterpret_cast<const float4*>(V + (j + t) * 256 + 4 * lane);
          const float4 v1 = *reinterpret_cast<const float4*>(V + (j + t) * 256 + 128 + 4 * lane);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float pk = t == 0 ? p[i].x : t == 1 ? p[i].y : t == 2 ? p[i].z : p[i].w;
            a[i][0] = fmaf(pk, v0.x, a[i][0]);
            a[i][1] = fmaf(pk, v0.y, a[i][1]);
            a[i][2] = fmaf(pk, v0.z, a[i][2]);
            a[i][3] = fmaf(pk, v0.w, a[i][3]);
            a[i][4] = fmaf(pk, v1.x, a[i][4]);
            a[i][5] = fmaf(pk, v1.y, a[i][5]);
            a[i][6] = fmaf(pk, v1.z, a[i][6]);
            a[i][7] = fmaf(pk, v1.w, a[i][7]);
          }
        }
      }
      done();
    }
    af_reduce<8>(a, free_stage(), qg, kq, lane);
    if (kq == 0) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int c = pc * 256 + 128 * h2 + 4 * lane;
        if (c >= C) continue;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          *reinterpret_cast<float4*>(QA + (8 * qg + i) * lda + c) =
              make_float4(a[i][4 * h2], a[i][4 * h2 + 1], a[i][4 * h2 + 2], a[i][4 * h2 + 3]);
      }
    }
  }

  // out = (a Wout + bo + x) * oscale, 128 KJO output channels a pass (the
  // next chunk's wait orders a's stores before the first read)
  for (int op = 0; op < nop; ++op) {
    float acc[8][4 * KJO];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int r = 0; r < 4 * KJO; ++r) acc[i][r] = 0.f;
    for (int j = 0; j < nS; ++j) {
      af_rowdot<4 * KJO>(acc, QA, lda, j * AF_CK, next(), qg, kq, lane);
      done();
    }
    // the epilogue's operands, all in flight across the reduction (loaded
    // one by one after each store, each would wait out its own latency)
    float xr[8][4 * KJO], br[4 * KJO];
    const int ob = o0 + op * 128 * KJO + lane;
    if (kq == 0) {
#pragma unroll
      for (int r = 0; r < 4 * KJO; ++r) br[r] = ob + 32 * r < o0 + ocols ? bo[ob + 32 * r] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long r0 = ((long)n * hw + q0 + 8 * qg + i) * C;
#pragma unroll
        for (int r = 0; r < 4 * KJO; ++r)
          xr[i][r] = 8 * qg + i < nq && ob + 32 * r < o0 + ocols ? x[r0 + ob + 32 * r] : 0.f;
      }
    }
    af_reduce<4 * KJO>(acc, free_stage(), qg, kq, lane);
    if (kq != 0) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = 8 * qg + i;
      if (q >= nq) continue;
      const long r0 = ((long)n * hw + q0 + q) * C;
#pragma unroll
      for (int r = 0; r < 4 * KJO; ++r) {
        const int o = ob + 32 * r;
        if (o < o0 + ocols) out[r0 + o] = (acc[i][r] + br[r] + xr[i][r]) * oscale;
      }
    }
  }
}

template <int KJ, int KJO>
cudaError_t launch_af(const float* qkv, const float* wo, const float* bo, const float* x,
                      float oscale, int N, int hw, int C, int osplit, int stages, float* out,
                      cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)AF_QT * (C + 4) + (size_t)AF_QT * (128 * KJ + 4) +
                                       (size_t)stages * AF_STAGE);
  static size_t opted = 0;  // the shared-memory opt-in this instance has, per process
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_f32_kernel<KJ, KJO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  attn_f32_kernel<KJ, KJO><<<dim3((hw + AF_QT - 1) / AF_QT, N, osplit), AF_THREADS, smem, st>>>(
      qkv, wo, bo, x, oscale, hw, C, C / osplit, stages, 1.0f / sqrtf((float)C), out);
  return cudaGetLastError();
}

}  // namespace

namespace dp {

// The fp32 chain. plan: 11 ints, the GroupNorm pass's 5 (ops/groupnorm.py
// gn_silu_plan), the core's (kj, kjo, ck, osplit), the q | k | v GEMM's K
// slices and the core's ring stages (ops/fused_attnblock.py
// attnblock_f32_plan).
cudaError_t attnblock_fwd_f32(const float* x, int N, int H, int W, int C, const float* gns,
                              const float* gnb, int G, const float* wqkv, const float* bqkv,
                              const float* wo, const float* bo, float eps, float oscale,
                              float* h, float* qkv, float* ws, long ws_elems, float* out,
                              const int* plan, cudaStream_t st) {
  const int hw = H * W;
  if (plan == nullptr || hw > 256 || C % AF_CK || G < 1 || C % G) return cudaErrorInvalidValue;
  const int kj = plan[5], kjo = plan[6], ck = plan[7], osplit = plan[8], ksplit = plan[9],
            stages = plan[10];
  if ((kj != 1 && kj != 2) || 128 * kj < hw || (kjo != 1 && kjo != 2) || ck != AF_CK ||
      osplit < 1 || C % osplit || (C / osplit) % 4 || ksplit < 1 || C % (ksplit * QK_BK) ||
      (stages != 2 && stages != 4) ||
      (ksplit > 1 && (long)ksplit * N * hw * 3 * C > ws_elems))
    return cudaErrorInvalidValue;
  cudaError_t err = gns_launch<float, false>(plan, x, gns, gnb, N, hw, C, G, eps, h, st);
  if (err != cudaSuccess) return err;

  const int M = N * hw, kper = C / ksplit;
  static bool qk_opted = false;  // the shared-memory opt-in, once per process
  if (!qk_opted) {
    if ((err = cudaFuncSetAttribute(attn_qkv_f32_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)QK_SMEM)) != cudaSuccess)
      return err;
    qk_opted = true;
  }
  attn_qkv_f32_kernel<<<dim3((M + QK_BM - 1) / QK_BM, 3 * C / QK_BN, ksplit), QK_THREADS,
                        QK_SMEM, st>>>(h, wqkv, bqkv, M, 3 * C, C, kper, qkv, ws);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (ksplit > 1) {
    attn_qkv_sum_kernel<<<(unsigned)(((long)M * 3 * C / 4 + 255) / 256), 256, 0, st>>>(
        ws, bqkv, M, 3 * C, ksplit, qkv);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  if (kj == 1)
    return kjo == 1 ? launch_af<1, 1>(qkv, wo, bo, x, oscale, N, hw, C, osplit, stages, out, st)
                    : launch_af<1, 2>(qkv, wo, bo, x, oscale, N, hw, C, osplit, stages, out, st);
  return kjo == 1 ? launch_af<2, 1>(qkv, wo, bo, x, oscale, N, hw, C, osplit, stages, out, st)
                  : launch_af<2, 2>(qkv, wo, bo, x, oscale, N, hw, C, osplit, stages, out, st);
}

}  // namespace dp
