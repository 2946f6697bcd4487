// Tiled GroupNorm(+FiLM)(+SiLU) for the large maps of the 256-px UNets,
// bf16 or fp32 NHWC maps.
//
// Replaces two TPU kernels of diffpure_tpu/ops/tiled_groupnorm.py:
//   - group_stats_affine (:52, kernel _stats_kernel :37): per-(example,
//     row tile, channel) sums of x and x^2 in fp32. The tiny combine into
//     the per-(example, channel) affine A, B stays plain tensor code, as
//     the JAX combine is plain XLA outside the kernel (:98-133);
//   - group_norm_film_silu_tiled (:136, kernel _norm_kernel :44):
//     out = [silu](x * A + B), one read and one write of the map.
//
// What bounds them on this card: both move bytes and do ~2 operations per
// element (the stats read a 256^2 x 256 bf16 map of 134 MB at batch 4,
// 40 us at 3.35 TB/s; apply reads and writes it). What the design does:
//   - stats: one block per (row tile, example, 256-channel chunk); each
//     thread owns 4 channels of one of 4 pixel lanes and sums its lane's
//     pixels, the 4 lanes are then added in a fixed order in shared memory
//     (deterministic, no atomics). Neighbouring threads read neighbouring
//     channels of one pixel (coalesced). The wrapper picks the rows per
//     tile so that about 1024 blocks are in flight;
//   - apply: a grid-stride elementwise pass, 4 channels per thread, A and B
//     read through L1 (one (N, C) row per example), fp32 math, one store in
//     the map's dtype.
#include "common.cuh"

using namespace dp;

namespace {

constexpr int QUADS = 64;            // channel quads per stats block (256 channels)
constexpr int LANES = NT / QUADS;    // pixel lanes per stats block

template <typename T>
__global__ void __launch_bounds__(NT)
stats_kernel(const T* __restrict__ x, int H, int W, int C, int rows, float* __restrict__ sums,
             float* __restrict__ sqs) {
  __shared__ float4 red_s[LANES][QUADS];
  __shared__ float4 red_q[LANES][QUADS];
  const int tile = blockIdx.x, n = blockIdx.y;
  const int q = threadIdx.x % QUADS, lane = threadIdx.x / QUADS;
  const int c = (blockIdx.z * QUADS + q) * 4;
  const int y0 = tile * rows, y1 = min(H, y0 + rows);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f), sq = s;
  if (c < C && y0 < y1) {
    const long npix = (long)(y1 - y0) * W;
    const T* base = x + ((long)n * H + y0) * W * C + c;
#pragma unroll 4
    for (long p = lane; p < npix; p += LANES) {
      const float4 v = load4(base + p * C);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      sq.x += v.x * v.x; sq.y += v.y * v.y; sq.z += v.z * v.z; sq.w += v.w * v.w;
    }
  }
  red_s[lane][q] = s;
  red_q[lane][q] = sq;
  __syncthreads();
  if (lane != 0 || c >= C) return;
#pragma unroll
  for (int l = 1; l < LANES; ++l) {
    const float4 a = red_s[l][q], b = red_q[l][q];
    s.x += a.x; s.y += a.y; s.z += a.z; s.w += a.w;
    sq.x += b.x; sq.y += b.y; sq.z += b.z; sq.w += b.w;
  }
  const long o = ((long)n * gridDim.x + tile) * C + c;
  store4(sums + o, s);
  store4(sqs + o, sq);
}

template <typename T>
__global__ void __launch_bounds__(NT)
apply_kernel(const T* __restrict__ x, const float* __restrict__ A, const float* __restrict__ B,
             long quads, int C, long hwc, int apply_silu, T* __restrict__ out) {
  for (long i = (long)blockIdx.x * NT + threadIdx.x; i < quads; i += (long)gridDim.x * NT) {
    const long e = i * 4;
    const long n = e / hwc;
    const int c = (int)(e % C);
    const float4 v = load4(x + e);
    const float4 a = load4(A + n * C + c), b = load4(B + n * C + c);
    float4 h = make_float4(v.x * a.x + b.x, v.y * a.y + b.y, v.z * a.z + b.z, v.w * a.w + b.w);
    if (apply_silu) h = make_float4(silu(h.x), silu(h.y), silu(h.z), silu(h.w));
    store4(out + e, h);
  }
}

}  // namespace

extern "C" {

// Partial sums of x (N, H, W, C) over tiles of `rows` image rows: sums and
// sqs are (N, tiles, C) fp32 with tiles = ceil(H / rows). Requires C % 4 == 0.
int diffpure_group_stats(int dtype, const void* x, int N, int H, int W, int C, int rows,
                         float* sums, float* sqs, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((H + rows - 1) / rows, N, (C + 4 * QUADS - 1) / (4 * QUADS));
  if (dtype == 1)
    stats_kernel<bf16><<<grid, NT, 0, st>>>(static_cast<const bf16*>(x), H, W, C, rows, sums, sqs);
  else
    stats_kernel<float><<<grid, NT, 0, st>>>(static_cast<const float*>(x), H, W, C, rows, sums,
                                             sqs);
  return cudaGetLastError();
}

// out = [silu](x * A[n] + B[n]) over x (N, H, W, C); A, B (N, C) fp32.
// Requires C % 4 == 0.
int diffpure_gn_apply(int dtype, const void* x, const float* A, const float* B, int N, int H,
                      int W, int C, int apply_silu, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long hwc = (long)H * W * C, quads = (long)N * hwc / 4;
  const int blocks = (int)std::min<long>((quads + NT - 1) / NT, 8L * num_sms());
  if (dtype == 1)
    apply_kernel<bf16><<<blocks, NT, 0, st>>>(static_cast<const bf16*>(x), A, B, quads, C, hwc,
                                              apply_silu, static_cast<bf16*>(out));
  else
    apply_kernel<float><<<blocks, NT, 0, st>>>(static_cast<const float*>(x), A, B, quads, C, hwc,
                                               apply_silu, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // extern "C"
