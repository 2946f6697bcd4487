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
// What bounds it on this card: bytes and latency. It does ~10 operations
// per element and must read the map once and write it once; on the score
// DDPM at batch 8 that is 186 MB per evaluation in fp32 over 44 calls
// (~55 us at 3.35 TB/s), and most calls (4^2 and 8^2 maps of 64-512 KB)
// are bound by the launch and by the chain of dependent steps inside it:
// load, reduce, reduce again, store. What the design does (gn_silu.cuh,
// gnsilu_regs_kernel): each (example, group) slice lives in registers
// between its one read and its one write, with every load of a thread in
// flight at once; the planner (ops/groupnorm.py gn_silu_plan) gives small
// slices a warp or less, so their sums are shuffles alone, several slices
// to a block, and large ones a block of up to 1024 threads (32^2 x 384
// fp32, the widest DDPM slice: 512 threads of 24 values, one wave on 132
// SMs at batch 8). Above the register budget (128 KB of fp32 a slice)
// gnsilu_l2_kernel reads the slice again from L2 for the variance and the
// apply pass: every shape and batch is taken, none gives way to the plain
// version.
#include "gn_silu.cuh"

using namespace dp;

extern "C" {

// out = silu(GroupNorm(x)) over x (N, H, W, C) with HW = H * W, G groups of
// C / G contiguous channels; gamma, beta (C,) fp32; out has x's dtype
// (0 fp32, 1 bf16). plan: the 5 ints of ops/groupnorm.py gn_silu_plan.
// Requires C % G == 0 and 16-byte aligned x and out. Returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for a plan
// that does not fit the shape.
int diffpure_gn_silu(int dtype, const void* x, const float* gamma, const float* beta, int N,
                     int HW, int C, int G, float eps, void* out, const int* plan, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return gns_launch<bf16, true>(plan, static_cast<const bf16*>(x), gamma, beta, N, HW, C, G,
                                  eps, static_cast<bf16*>(out), st);
  return gns_launch<float, true>(plan, static_cast<const float*>(x), gamma, beta, N, HW, C, G,
                                 eps, static_cast<float*>(out), st);
}

}  // extern "C"
