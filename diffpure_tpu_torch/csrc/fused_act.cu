// Fused bias + leaky ReLU + gain, elementwise, bf16 or fp32:
//   y = where(x + b >= 0, x + b, slope * (x + b)) * scale
// with b broadcast over the last axis (or no bias), in fp32 with one
// rounding at the store.
//
// Replaces diffpure_tpu/ops/fused_act.py:47 fused_leaky_relu_pallas (kernel
// _flr_kernel :41), itself the TPU counterpart of the score_sde reference's
// fused_bias_act CUDA op. No model of the repository calls it at runtime.
//
// What bounds it on this card: bytes. Three operations per element against
// one read and one write, so the kernel is as fast as it keeps HBM busy:
// enough 16-byte loads in flight on every SM, no integer division per
// element and no 64-bit division at all (a toy size pays its setup in
// full).
// The launch plan (route, threads, grid, rows) is computed in Python
// (ops/fused_act.py flr_plan); this file takes its numbers. Routes:
//   - registers (C a multiple of the 16-byte vector width VW, at most 1024
//     vectors a row): x is viewed as (rows, C); a CTA of (C / VW) x lanes
//     threads takes a run of U x lanes rows a trip (U = FLR_UNROLL, or 1),
//     its trips a grid apart, each thread one channel vector of every
//     lanes-th row. The thread loads its bias vector into registers once;
//     its loop adds a fixed stride to two pointers and keeps FLR_UNROLL
//     loads in flight.
//   - shared (any other C): a flat pass over 16-byte vectors, FLR_UNROLL in
//     flight a thread; the bias row is staged in shared memory as fp32 and
//     extended by VW (sb[j] = b[j % C]), so a vector's channels c..c+VW-1
//     read sb[c..c+VW-1] without a wrap test, and each in-flight vector's
//     channel advances by a fixed addition and one conditional subtract.
//     Past 48 KB of bias (C > 12280) the bias is read from global memory.
//     The count's remainder modulo VW is a scalar tail.
//   (Measured against the registers route and not kept, PERF.md §6: a
//   cp.async.bulk ring over a persistent grid, and streaming cache hints.)
// The grid is sized to the bytes: a vector a thread while the CTAs the SMs
// hold at once take them all, so a toy size launches a single short wave
// as wide as it can be; past that those CTAs, looping.
#include "common.cuh"

using namespace dp;

namespace {

enum { FLR_REGISTERS = 0, FLR_SHARED = 1 };
// Independent 16-byte loads a thread keeps in flight: FLR_UNROLL, or 1 where
// the plan gives each thread a single vector (a guarded slot left empty
// would still issue its predicated arithmetic).
constexpr int FLR_UNROLL = 4;
constexpr int FLR_SMEM_BIAS_MAX = 48 * 1024;

// Element counts are below 2^31 (the wrapper checks), so every index is a
// 32-bit int: a 64-bit division or remainder costs a call of some hundred
// cycles, which a toy size's kernel would pay in full.
struct FlrArgs {
  const void* x;
  const void* bias;  // (C,) in x's dtype, or nullptr
  void* out;
  int total, C, R;   // R = total / C rows
  float slope, scale;
  int rows;  // rows a CTA takes a trip (registers)
  int smem;  // dynamic shared bytes: the staged bias row (shared; 0: the
             // bias from global memory)
};

__device__ __forceinline__ void unpack16(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ uint4 pack16(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack16(const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  return u;
}

__device__ __forceinline__ float flr(float h, float slope, float scale) {
  return (h >= 0.f ? h : h * slope) * scale;
}

// The activation of one 16-byte vector; without a bias nothing is added
// (x = -0 stays -0, as in the plain version).
template <int VW>
__device__ __forceinline__ uint4 act16(const uint4& u, const float (&b)[VW], bool has_bias,
                                       float slope, float scale) {
  float v[VW];
  unpack16(u, v);
#pragma unroll
  for (int k = 0; k < VW; ++k) v[k] = flr(has_bias ? v[k] + b[k] : v[k], slope, scale);
  return pack16(v);
}

// A CTA of (C / VW) x lanes threads: threadIdx.x the channel vector,
// threadIdx.y the row lane. A trip of the CTA takes a.rows = U x lanes
// consecutive rows; its trips are gridDim.x trips apart, so the grid sweeps
// the tensor front to back together (DRAM pages stay open for all CTAs).
template <typename T, int U>
__global__ void __launch_bounds__(1024) flr_rows_kernel(const __grid_constant__ FlrArgs a) {
  constexpr int VW = 16 / sizeof(T);
  const int lanes = blockDim.y, col = threadIdx.x;
  const bool has_bias = a.bias != nullptr;
  float b[VW] = {};
  if (has_bias) load_vec<VW>(static_cast<const T*>(a.bias) + col * VW, b);
  const int step = lanes * a.C;                       // elements between a thread's rows
  const int dr = gridDim.x * a.rows;                  // rows between a CTA's trips
  const long stride = (long)dr * a.C;
  int r = blockIdx.x * a.rows + threadIdx.y;
  const T* xp = static_cast<const T*>(a.x) + (long)r * a.C + col * VW;
  T* op = static_cast<T*>(a.out) + (long)r * a.C + col * VW;
  for (; r < a.R; r += dr, xp += stride, op += stride) {
    uint4 u[U];
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (r + k * lanes < a.R) u[k] = *reinterpret_cast<const uint4*>(xp + k * step);
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (r + k * lanes < a.R)
        *reinterpret_cast<uint4*>(op + k * step) =
            act16<VW>(u[k], b, has_bias, a.slope, a.scale);
  }
}

template <typename T, int U>
__global__ void __launch_bounds__(1024) flr_flat_kernel(const __grid_constant__ FlrArgs a) {
  constexpr int VW = 16 / sizeof(T);
  extern __shared__ float sb[];  // sb[j] = bias[j % C], j < C + VW
  const T* x = static_cast<const T*>(a.x);
  const T* bias = static_cast<const T*>(a.bias);
  T* out = static_cast<T*>(a.out);
  const int C = a.C;
  const bool has_bias = bias != nullptr, staged = has_bias && a.smem > 0;
  const int nvec = a.total / VW, G = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  // the first trip's loads (and the tail's) are issued before the bias is
  // staged, so the two reads overlap
  uint4 u[U];
#pragma unroll
  for (int k = 0; k < U; ++k)
    if (first + k * G < nvec)
      u[k] = *reinterpret_cast<const uint4*>(x + (first + k * G) * VW);
  const bool tail = first < a.total - nvec * VW;  // fewer than VW elements
  const int e = nvec * VW + first;
  const float xe = tail ? to_f32(x[e]) : 0.f;
  if (staged) {
    for (int j = threadIdx.x; j < C + VW; j += blockDim.x)
      sb[j] = to_f32(bias[(unsigned)j % (unsigned)C]);
    __syncthreads();
  }
  // the channel of each in-flight vector's first element, and its advance a trip
  int c[U] = {};
  int dc = 0;
  if (has_bias) {
#pragma unroll
    for (int k = 0; k < U; ++k) c[k] = (unsigned)((first + k * G) * VW) % (unsigned)C;
    dc = (unsigned)(U * G * VW) % (unsigned)C;
  }
  for (int i = first; i < nvec; i += U * G) {
    if (i != first) {
#pragma unroll
      for (int k = 0; k < U; ++k)
        if (i + k * G < nvec)
          u[k] = *reinterpret_cast<const uint4*>(x + (i + k * G) * VW);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (i + k * G >= nvec) continue;
      float b[VW] = {};
      if (staged) {
#pragma unroll
        for (int j = 0; j < VW; ++j) b[j] = sb[c[k] + j];
      } else if (has_bias) {  // C > 12280 >= VW: one wrap at most
#pragma unroll
        for (int j = 0; j < VW; ++j) {
          const int cj = c[k] + j;
          b[j] = to_f32(bias[cj >= C ? cj - C : cj]);
        }
      }
      *reinterpret_cast<uint4*>(out + (i + k * G) * VW) =
          act16<VW>(u[k], b, has_bias, a.slope, a.scale);
    }
    if (has_bias) {
#pragma unroll
      for (int k = 0; k < U; ++k) {
        c[k] += dc;
        c[k] -= c[k] >= C ? C : 0;
      }
    }
  }
  if (tail) {
    const float v = has_bias ? xe + to_f32(bias[(unsigned)e % (unsigned)C]) : xe;
    out[e] = from_f32<T>(flr(v, a.slope, a.scale));
  }
}

template <typename T>
cudaError_t launch(const FlrArgs& a, const int* plan, cudaStream_t st) {
  constexpr int VW = 16 / sizeof(T);
  const int route = plan[0], threads = plan[1], grid = plan[2], one = plan[5] == 1;
  if (threads < 1 || threads > 1024 || grid < 1 || (plan[5] != 1 && plan[5] != FLR_UNROLL))
    return cudaErrorInvalidValue;
  if (route == FLR_REGISTERS) {
    if (a.C % VW || threads % (a.C / VW) || a.rows != threads / (a.C / VW) * plan[5])
      return cudaErrorInvalidValue;
    const dim3 block(a.C / VW, threads / (a.C / VW));
    if (one)
      flr_rows_kernel<T, 1><<<grid, block, 0, st>>>(a);
    else
      flr_rows_kernel<T, FLR_UNROLL><<<grid, block, 0, st>>>(a);
  } else if (route == FLR_SHARED) {
    if (a.smem != 0 && (a.smem < (a.C + VW) * 4 || a.smem > FLR_SMEM_BIAS_MAX))
      return cudaErrorInvalidValue;
    if (a.smem == 0 && a.bias != nullptr && a.C < VW) return cudaErrorInvalidValue;
    const int smem = a.bias != nullptr ? a.smem : 0;
    if (one)
      flr_flat_kernel<T, 1><<<grid, threads, smem, st>>>(a);
    else
      flr_flat_kernel<T, FLR_UNROLL><<<grid, threads, smem, st>>>(a);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out = leaky_relu(x + bias, slope) * scale over x of `total` elements whose
// last axis has C; bias (C,) in x's dtype (0 fp32, 1 bf16) or NULL. plan:
// the 6 ints of ops/fused_act.py flr_plan (route, threads, grid, rows,
// smem, unroll). Requires 16-byte aligned x, bias and out. Returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for a plan
// that does not fit the shape.
int diffpure_fused_leaky_relu(int dtype, const void* x, const void* bias, long total, int C,
                              float slope, float scale, void* out, const int* plan,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (total < 1 || total >= (1L << 31) || C < 1 || total % C) return cudaErrorInvalidValue;
  const FlrArgs a{x, bias, out, (int)total, C, (int)(total / C), slope, scale, plan[3], plan[4]};
  if (dtype == 1) return launch<bf16>(a, plan, st);
  return launch<float>(a, plan, st);
}

}  // extern "C"
