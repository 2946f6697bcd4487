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
// fits in L2, so the products bound it, and at HW = 16 launch latency does
// (measured on an H100 at 700 W: 0.18 ms at HW = 256 and 0.06 ms at HW = 16
// for batch 8 in bf16, the fp32-FMA attention kernel about 0.1 ms of it).
//
// What the design does about it: four launches,
//   1. GroupNorm (common.cuh), writing h = GN(x) in the compute dtype;
//   2. one GEMM for q|k|v against the packed [Wq | Wk | Wv] weight with the
//      bias epilogue; q, k, v are stored in the compute dtype, where the
//      TPU kernel also rounds them;
//   3. the attention kernel below: one block per (example, 16 queries),
//      holding the full fp32 score rows of HW <= 256 keys in shared memory,
//      a warp-per-row softmax, and P @ V with each thread owning a channel;
//   4. one GEMM for the output NIN whose epilogue adds bias and the
//      residual x and rescales.
// No cuBLAS, no library attention: every product is a kernel in this
// directory. The two GEMMs run bf16 on the tensor cores (common.cuh); the
// attention products are fp32 FMAs on operands rounded to the compute dtype.
#include "common.cuh"

using namespace dp;

namespace {

constexpr int QT = 16;   // queries per block
constexpr int KCH = 32;  // channels of K staged in shared memory at a time

template <typename T>
__global__ void __launch_bounds__(NT)
attn_kernel(const T* __restrict__ qkv, int hw, int C, float sm_scale, T* __restrict__ att) {
  extern __shared__ __align__(16) float sm[];
  float* S = sm;            // [QT][hw] scores, then probabilities
  float* Q = S + QT * hw;   // [QT][C]
  float* Kc = Q + QT * C;   // [hw][KCH + 1], padded against bank conflicts
  const int tid = threadIdx.x, n = blockIdx.y, q0 = blockIdx.x * QT;
  const int nq = min(QT, hw - q0);
  const long row = 3L * C;
  const T* base = qkv + (long)n * hw * row;

  for (int e = tid; e < QT * C; e += NT) {
    const int i = e / C, c = e - i * C;
    Q[e] = i < nq ? to_f32(base[(q0 + i) * row + c]) : 0.f;
  }

  // scores: thread j owns key j (hw <= NT), K staged KCH channels at a time
  float s[QT];
#pragma unroll
  for (int i = 0; i < QT; ++i) s[i] = 0.f;
  for (int c0 = 0; c0 < C; c0 += KCH) {
    __syncthreads();
    for (int e = tid; e < hw * KCH; e += NT) {
      const int j = e / KCH, cc = e - j * KCH;
      Kc[j * (KCH + 1) + cc] = to_f32(base[j * row + C + c0 + cc]);
    }
    __syncthreads();
    if (tid < hw) {
#pragma unroll 4
      for (int cc = 0; cc < KCH; ++cc) {
        const float kv = Kc[tid * (KCH + 1) + cc];
#pragma unroll
        for (int i = 0; i < QT; ++i) s[i] = fmaf(Q[i * C + c0 + cc], kv, s[i]);
      }
    }
  }
  if (tid < hw) {
#pragma unroll
    for (int i = 0; i < QT; ++i) S[i * hw + tid] = s[i] * sm_scale;
  }
  __syncthreads();

  // softmax in fp32, one warp per query row; p rounds to T as in the TPU kernel
  const int lane = tid & 31;
  for (int i = tid >> 5; i < nq; i += NT / 32) {
    float* r = S + i * hw;
    float mx = -INFINITY;
    for (int j = lane; j < hw; j += 32) mx = fmaxf(mx, r[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int j = lane; j < hw; j += 32) {
      const float e = expf(r[j] - mx);
      r[j] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < hw; j += 32) r[j] = round_to<T>(r[j] / sum);
  }
  __syncthreads();

  // a = P @ V: thread owns channel c; V rows are read coalesced across threads
  for (int c = tid; c < C; c += NT) {
    float o[QT];
#pragma unroll
    for (int i = 0; i < QT; ++i) o[i] = 0.f;
    for (int j = 0; j < hw; ++j) {
      const float v = to_f32(base[j * row + 2 * C + c]);
#pragma unroll
      for (int i = 0; i < QT; ++i) o[i] = fmaf(S[i * hw + j], v, o[i]);
    }
    for (int i = 0; i < nq; ++i) att[((long)n * hw + q0 + i) * C + c] = from_f32<T>(o[i]);
  }
}

template <typename T>
cudaError_t attnblock_fwd(const void* x, int N, int H, int W, int C, const float* gns,
                          const float* gnb, int G, const void* wqkv, const float* bqkv,
                          const void* wo, const float* bo, float eps, float oscale,
                          void* h, void* qkv, void* att, float* ws, long ws_elems,
                          void* out, cudaStream_t st) {
  const int hw = H * W;
  const Src xs = {x, nullptr, C, 0, H, W, 0};
  const GnArgs gn = {xs, G, gns, gnb, eps, 0, RS_NONE, h, nullptr};
  cudaError_t err = launch_gn_apply<T>(gn, N, st);
  if (err != cudaSuccess) return err;

  GemmArgs q = {};
  q.M = N * hw;
  q.Nc = 3 * C;
  q.K = q.Kmain = C;
  q.Ho = H;
  q.Wo = W;
  q.taps = 1;
  q.src = Src{h, nullptr, C, 0, H, W, 0};
  q.w = wqkv;
  q.bias = bqkv;
  q.oscale = 1.f;
  q.out = qkv;
  q.out_f32 = 0;
  if ((err = launch_gemm<T>(q, ws, ws_elems, st)) != cudaSuccess) return err;

  const size_t smem = sizeof(float) * ((size_t)QT * hw + (size_t)QT * C + (size_t)hw * (KCH + 1));
  if ((err = cudaFuncSetAttribute(attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  attn_kernel<T><<<dim3((hw + QT - 1) / QT, N), NT, smem, st>>>(
      static_cast<const T*>(qkv), hw, C, 1.0f / sqrtf((float)C), static_cast<T*>(att));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  GemmArgs o = {};
  o.M = N * hw;
  o.Nc = C;
  o.K = o.Kmain = C;
  o.Ho = H;
  o.Wo = W;
  o.taps = 1;
  o.src = Src{att, nullptr, C, 0, H, W, 0};
  o.w = wo;
  o.bias = bo;
  o.has_resid = 1;
  o.resid = xs;
  o.oscale = oscale;
  o.out = out;
  o.out_f32 = 0;
  return launch_gemm<T>(o, ws, ws_elems, st);
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16. wqkv is (3C, C) = [Wq | Wk | Wv]^T (one row per
// output channel), bqkv (3C); wo (C, C) = Wout^T. Scratch: h (N*H*W, C),
// qkv (N*H*W, 3C) and att (N*H*W, C) in the compute dtype, ws (ws_elems fp32)
// for split-K partials. Requires H*W <= 256 and C % 32 == 0. Returns
// cudaGetLastError() of the first failing step.
int diffpure_attnblock_fwd(int dtype, const void* x, int N, int H, int W, int C,
                           const float* gns, const float* gnb, int G, const void* wqkv,
                           const float* bqkv, const void* wo, const float* bo, float eps,
                           float oscale, void* h, void* qkv, void* att,
                           float* ws, long ws_elems, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return attnblock_fwd<bf16>(x, N, H, W, C, gns, gnb, G, wqkv, bqkv, wo, bo, eps, oscale,
                               h, qkv, att, ws, ws_elems, out, st);
  return attnblock_fwd<float>(x, N, H, W, C, gns, gnb, G, wqkv, bqkv, wo, bo, eps, oscale,
                              h, qkv, att, ws, ws_elems, out, st);
}

}  // extern "C"
