// GroupNorm + SiLU over one NHWC map, bf16 or fp32:
//   out = silu((x - mean_g) * rstd_g * gamma_c + beta_c)
// with the statistics, the normalisation, the affine and the SiLU in fp32
// and one rounding, at the store, to the map's dtype.
//
// Replaces diffpure_tpu/ops/groupnorm.py:81 group_norm_silu_pallas (kernel
// _gn_silu_kernel :59), the norm + activation of the DDPM++ residual block
// (GNSiLU, diffpure_tpu/models/layers.py:71). The TPU kernel holds one
// example's whole map in VMEM per grid step and takes the group sums as
// matmuls with a one-hot (C, G) matrix, to keep the 128 lanes intact.
//
// What bounds it on this card: bytes and launches. It does ~10 operations
// per element and must read the map once and write it once; on the score
// DDPM at batch 8 that is 186 MB per evaluation in fp32 over 44 calls
// (~55 us at 3.35 TB/s), so most calls (4^2 and 8^2 maps of 64-512 KB) are
// bound by the launch. What the design does:
//   - one block per (group, example): 32 x 8 = 256 blocks on the path;
//   - the block reads its group's cg x H x W slice once, in VW-element
//     vectors (16 bytes: 4 fp32 or 8 bf16, when cg allows; neighbouring
//     threads read neighbouring vectors), sums it and stages it as fp32 in
//     shared memory (48 KB at the widest path shape, 32^2 x 384, cg 12);
//   - the variance is two-pass, sum((x - mean)^2) over the staged slice,
//     where the TPU kernel takes E[x^2] - mean^2; the second pass costs no
//     extra bytes. Block sums are warp shuffles, then one shared array;
//   - the apply pass reads the staged slice and writes the output once.
// A slice above the staging budget (96 KB, two blocks per SM) is read
// again from global memory (L2) for the second and third passes: every
// shape and batch is taken, none gives way to the plain version.
#include "common.cuh"

using namespace dp;

namespace {

constexpr long STAGE_MAX = 96 * 1024;  // bytes of fp32 staging per block

template <typename T, int VW>
__global__ void __launch_bounds__(NT)
gn_silu_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, int HW, int C, int G, float eps, int staged,
               T* __restrict__ out) {
  extern __shared__ float4 stage4[];
  float* stage = reinterpret_cast<float*>(stage4);
  __shared__ float red[NT / 32];
  const int g = blockIdx.x, n = blockIdx.y;
  const int cg = C / G, vpp = cg / VW;  // vectors per pixel
  const long nvec = (long)HW * vpp;
  const long base = (long)n * HW * C + (long)g * cg;
  const float inv_cnt = 1.f / ((float)HW * (float)cg);
  // vector i holds channels j0..j0+VW-1 (of the group) of pixel p; staged at i * VW
  auto offset = [&](long i) {
    const long p = i / vpp;
    return base + p * C + (i - p * vpp) * VW;
  };
  auto fetch = [&](long i, float (&v)[VW]) {
    if (!staged) {
      load_vec<VW>(x + offset(i), v);
    } else if constexpr (VW % 4 == 0) {
#pragma unroll
      for (int k = 0; k < VW; k += 4) {
        const float4 a = stage4[(i * VW + k) / 4];
        v[k] = a.x; v[k + 1] = a.y; v[k + 2] = a.z; v[k + 3] = a.w;
      }
    } else {
      v[0] = stage[i];
    }
  };

  float acc = 0.f;
  for (long i = threadIdx.x; i < nvec; i += NT) {
    float v[VW];
    load_vec<VW>(x + offset(i), v);
#pragma unroll
    for (int k = 0; k < VW; ++k) acc += v[k];
    if (staged) {
      if constexpr (VW % 4 == 0) {
#pragma unroll
        for (int k = 0; k < VW; k += 4)
          stage4[(i * VW + k) / 4] = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
      } else {
        stage[i] = v[0];
      }
    }
  }
  const float mean = block_sum(acc, red) * inv_cnt;

  acc = 0.f;
  for (long i = threadIdx.x; i < nvec; i += NT) {
    float v[VW];
    fetch(i, v);
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      const float d = v[k] - mean;
      acc += d * d;
    }
  }
  const float rstd = rsqrtf(block_sum(acc, red) * inv_cnt + eps);

  for (long i = threadIdx.x; i < nvec; i += NT) {
    float v[VW];
    fetch(i, v);
    const int c0 = g * cg + (int)(i % vpp) * VW;
#pragma unroll
    for (int k = 0; k < VW; ++k)
      v[k] = silu((v[k] - mean) * rstd * gamma[c0 + k] + beta[c0 + k]);
    store_vec<VW>(out + offset(i), v);
  }
}

template <typename T, int VW>
cudaError_t launch(const void* x, const float* gamma, const float* beta, int N, int HW, int C,
                   int G, float eps, void* out, cudaStream_t st) {
  const long slice = (long)HW * (C / G) * (long)sizeof(float);
  const int staged = slice <= STAGE_MAX;
  const size_t smem = staged ? (size_t)slice : 0;
  // the 48 KB default covers static and dynamic shared memory together;
  // opt in well before it (per call: the attribute is per device)
  if (smem > 32 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gn_silu_kernel<T, VW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)STAGE_MAX);
    if (err != cudaSuccess) return err;
  }
  gn_silu_kernel<T, VW><<<dim3(G, N), NT, smem, st>>>(
      static_cast<const T*>(x), gamma, beta, HW, C, G, eps, staged, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out = silu(GroupNorm(x)) over x (N, H, W, C) with HW = H * W, G groups of
// C / G contiguous channels; gamma, beta (C,) fp32; out has x's dtype
// (0 fp32, 1 bf16). Requires C % G == 0 and 16-byte aligned x and out.
int diffpure_gn_silu(int dtype, const void* x, const float* gamma, const float* beta, int N,
                     int HW, int C, int G, float eps, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cg = C / G;
  if (dtype == 1) {
    if (cg % 8 == 0) return launch<bf16, 8>(x, gamma, beta, N, HW, C, G, eps, out, st);
    if (cg % 4 == 0) return launch<bf16, 4>(x, gamma, beta, N, HW, C, G, eps, out, st);
    return launch<bf16, 1>(x, gamma, beta, N, HW, C, G, eps, out, st);
  }
  if (cg % 4 == 0) return launch<float, 4>(x, gamma, beta, N, HW, C, G, eps, out, st);
  return launch<float, 1>(x, gamma, beta, N, HW, C, G, eps, out, st);
}

}  // extern "C"
