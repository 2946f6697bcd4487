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
// one read and one write. What the design does: a grid-stride pass over
// 16-byte vectors (4 fp32 or 8 bf16 values; neighbouring threads on
// neighbouring vectors), about 8 blocks per SM; the bias row is read through
// the cache, as a vector when the channel count is a multiple of the vector
// width (each vector then holds consecutive channels of one row), element by
// element otherwise. The count's remainder modulo the width is a scalar tail.
#include "common.cuh"

using namespace dp;

namespace {

template <typename T, int VW>
__global__ void __launch_bounds__(NT)
flr_kernel(const T* __restrict__ x, const T* __restrict__ bias, long total, int C, float slope,
           float scale, T* __restrict__ out) {
  const long nvec = total / VW, stride = (long)gridDim.x * NT;
  const long first = (long)blockIdx.x * NT + threadIdx.x;
  auto act = [&](float v) { return (v >= 0.f ? v : v * slope) * scale; };
  for (long i = first; i < nvec; i += stride) {
    const long e = i * VW;
    float v[VW];
    load_vec<VW>(x + e, v);
    if (bias != nullptr) {
      if (C % VW == 0) {
        float b[VW];
        load_vec<VW>(bias + e % C, b);
#pragma unroll
        for (int k = 0; k < VW; ++k) v[k] += b[k];
      } else {
#pragma unroll
        for (int k = 0; k < VW; ++k) v[k] += to_f32(bias[(e + k) % C]);
      }
    }
#pragma unroll
    for (int k = 0; k < VW; ++k) v[k] = act(v[k]);
    store_vec<VW>(out + e, v);
  }
  for (long e = nvec * VW + first; e < total; e += stride) {
    float v = to_f32(x[e]);
    if (bias != nullptr) v += to_f32(bias[e % C]);
    out[e] = from_f32<T>(act(v));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* bias, long total, int C, float slope, float scale,
                   void* out, cudaStream_t st) {
  constexpr int VW = 16 / sizeof(T);
  const long work = std::max(total / VW, 1L);
  const int blocks = (int)std::min<long>((work + NT - 1) / NT, 8L * num_sms());
  flr_kernel<T, VW><<<blocks, NT, 0, st>>>(static_cast<const T*>(x),
                                           static_cast<const T*>(bias), total, C, slope, scale,
                                           static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out = leaky_relu(x + bias, slope) * scale over x of `total` elements whose
// last axis has C; bias (C,) in x's dtype (0 fp32, 1 bf16) or NULL. Requires
// 16-byte aligned x, bias and out.
int diffpure_fused_leaky_relu(int dtype, const void* x, const void* bias, long total, int C,
                              float slope, float scale, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<bf16>(x, bias, total, C, slope, scale, out, st);
  return launch<float>(x, bias, total, C, slope, scale, out, st);
}

}  // extern "C"
