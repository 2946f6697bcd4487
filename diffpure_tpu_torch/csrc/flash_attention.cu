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
// 0.5 MB moved: the products, on the tensor cores in bf16.
//
// What the design does: one block per (64 queries, bh). bf16: 4 warps, each
// holding 16 query rows as mma.sync A fragments in registers for the whole
// call; K and V stream through shared memory 64 keys at a time (V stored
// transposed, so both products read 32-bit fragments); S = Q K^T and
// O += P V on mma.sync m16n8k16 with fp32 accumulators; the online-softmax
// state lives in registers, P is rounded to bf16 only as the second
// product's operand. fp32: 4 threads per query, each owning 16 of the 64
// channels, scores summed across the 4 by shuffles, full fp32 FMAs.
#include "common.cuh"

using namespace dp;

namespace {

constexpr int FQ = 64;        // queries per block
constexpr int FK = 64;        // keys per step
constexpr int FD = 64;        // head channels
constexpr int FP = FK + 8;    // bf16 pitch of the K and V^T tiles (144 bytes)
constexpr int FNT = 128;      // bf16 kernel: 4 warps of 16 queries

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(FNT)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, int T, float sm_scale, bf16* __restrict__ out) {
  __shared__ __align__(16) bf16 Ks[FK][FP];  // [key][channel]
  __shared__ __align__(16) bf16 Vt[FD][FP];  // [channel][key]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const long base = (long)blockIdx.y * T * FD;
  const int row0 = blockIdx.x * FQ + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  uint32_t qf[FD / 16][4];
#pragma unroll
  for (int kk = 0; kk < FD / 16; ++kk) {
    const bf16* r0 = q + base + (long)row0 * FD + kk * 16 + t2;
    const bf16* r1 = r0 + 8 * FD;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(r1);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[FD / 8][4];
#pragma unroll
  for (int dn = 0; dn < FD / 8; ++dn)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[dn][r] = 0.f;

  for (int kb = 0; kb < T; kb += FK) {
    __syncthreads();  // the previous step's reads of Ks / Vt are done
    for (int i = tid; i < FK * FD / 8; i += FNT) {
      const int key = i / (FD / 8), c8 = (i % (FD / 8)) * 8;
      const long src = base + (long)(kb + key) * FD + c8;
      *reinterpret_cast<uint4*>(&Ks[key][c8]) = *reinterpret_cast<const uint4*>(k + src);
      const uint4 vv = *reinterpret_cast<const uint4*>(v + src);
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[c8 + e][key] = ve[e];
    }
    __syncthreads();

    float s[FK / 8][4];
#pragma unroll
    for (int ni = 0; ni < FK / 8; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[ni][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < FD / 16; ++kk)
#pragma unroll
      for (int ni = 0; ni < FK / 8; ++ni) {
        const uint32_t b[2] = {lds32(&Ks[ni * 8 + g][kk * 16 + t2]),
                               lds32(&Ks[ni * 8 + g][kk * 16 + t2 + 8])};
        mma_bf16_16816(s[ni], qf[kk], b);
      }

    // online softmax of rows g (s[.][0..1]) and g + 8 (s[.][2..3]); a row's
    // 64 scores lie across the 4 threads of a quad
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int ni = 0; ni < FK / 8; ++ni) {
        s[ni][2 * h] *= sm_scale;
        s[ni][2 * h + 1] *= sm_scale;
        mx = fmaxf(mx, fmaxf(s[ni][2 * h], s[ni][2 * h + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float alpha = expf(m[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int ni = 0; ni < FK / 8; ++ni) {
        s[ni][2 * h] = expf(s[ni][2 * h] - m_new);
        s[ni][2 * h + 1] = expf(s[ni][2 * h + 1] - m_new);
        sum += s[ni][2 * h] + s[ni][2 * h + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[h] = l[h] * alpha + sum;
      m[h] = m_new;
#pragma unroll
      for (int dn = 0; dn < FD / 8; ++dn) {
        o[dn][2 * h] *= alpha;
        o[dn][2 * h + 1] *= alpha;
      }
    }

    // O += P V: P's accumulator tiles are the A fragments of 16-key steps
#pragma unroll
    for (int kk = 0; kk < FK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < FD / 8; ++dn) {
        const uint32_t b[2] = {lds32(&Vt[dn * 8 + g][kk * 16 + t2]),
                               lds32(&Vt[dn * 8 + g][kk * 16 + t2 + 8])};
        mma_bf16_16816(o[dn], pa, b);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float inv = 1.f / l[h];
    bf16* dst = out + base + (long)(row0 + 8 * h) * FD + t2;
#pragma unroll
    for (int dn = 0; dn < FD / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(dst + dn * 8) =
          __floats2bfloat162_rn(o[dn][2 * h] * inv, o[dn][2 * h + 1] * inv);
  }
}

__global__ void __launch_bounds__(NT)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, int T, float sm_scale, float* __restrict__ out) {
  __shared__ __align__(16) float Ks[FK][FD];
  __shared__ __align__(16) float Vs[FK][FD];
  const int tid = threadIdx.x, sub = tid & 3, d0 = sub * 16;
  const long base = (long)blockIdx.y * T * FD;
  const long row = base + (long)(blockIdx.x * FQ + (tid >> 2)) * FD + d0;

  float qr[16], o[16];
#pragma unroll
  for (int i = 0; i < 16; i += 4) {
    const float4 t = load4(q + row + i);
    qr[i] = t.x; qr[i + 1] = t.y; qr[i + 2] = t.z; qr[i + 3] = t.w;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int kb = 0; kb < T; kb += FK) {
    __syncthreads();
    for (int i = tid; i < FK * FD / 4; i += NT) {
      const int key = i / (FD / 4), c4 = (i % (FD / 4)) * 4;
      const long src = base + (long)(kb + key) * FD + c4;
      store4(&Ks[key][c4], load4(k + src));
      store4(&Vs[key][c4], load4(v + src));
    }
    __syncthreads();

    float s[FK];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < FK; ++j) {
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < 16; i += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(&Ks[j][d0 + i]);
        p = fmaf(qr[i], kv.x, p);
        p = fmaf(qr[i + 1], kv.y, p);
        p = fmaf(qr[i + 2], kv.z, p);
        p = fmaf(qr[i + 3], kv.w, p);
      }
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      s[j] = p * sm_scale;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] *= alpha;
#pragma unroll
    for (int j = 0; j < FK; ++j) {
      const float p = expf(s[j] - m_new);
      sum += p;
#pragma unroll
      for (int i = 0; i < 16; i += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[j][d0 + i]);
        o[i] = fmaf(p, vv.x, o[i]);
        o[i + 1] = fmaf(p, vv.y, o[i + 1]);
        o[i + 2] = fmaf(p, vv.z, o[i + 2]);
        o[i + 3] = fmaf(p, vv.w, o[i + 3]);
      }
    }
    l = l * alpha + sum;
    m = m_new;
  }

  const float inv = 1.f / l;
#pragma unroll
  for (int i = 0; i < 16; i += 4)
    store4(out + row + i, make_float4(o[i] * inv, o[i + 1] * inv, o[i + 2] * inv, o[i + 3] * inv));
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16. q, k, v, out (BH, T, D) contiguous; sm_scale
// multiplies q k^T (scale^2 of the JAX kernel). Requires D == 64 and
// T % 64 == 0 (the wrapper checks). Returns cudaGetLastError().
int diffpure_flash_attention(int dtype, const void* q, const void* k, const void* v, int BH,
                             int T, int D, float sm_scale, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != FD || T % FQ != 0) return cudaErrorInvalidValue;
  const dim3 grid(T / FQ, BH);
  if (dtype == 1)
    flash_bf16_kernel<<<grid, FNT, 0, st>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                            static_cast<const bf16*>(v), T, sm_scale,
                                            static_cast<bf16*>(out));
  else
    flash_f32_kernel<<<grid, NT, 0, st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                          static_cast<const float*>(v), T, sm_scale,
                                          static_cast<float*>(out));
  return cudaGetLastError();
}

}  // extern "C"
