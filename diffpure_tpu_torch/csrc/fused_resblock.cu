// Fused BigGAN residual block (NCSN++ ResnetBlockBigGANpp, eval mode) for
// Hopper, bf16 or fp32 NHWC maps.
//
// Replaces the TPU kernels diffpure_tpu/ops/fused_resblock.py:290
// fused_resblock_pallas (_fused_resblock_kernel :176) and :728
// fused_resblock_cat_pallas (_fused_resblock_cat_kernel :636). The cat
// variant is this same chain with a second input pointer and a seam index.
//
// What bounds it on this card: the block is two 3x3 convs of K = 9 * Cin
// (up to 3456) over N * H * W rows, 0.3-9.7 GFLOP per block at the CIFAR
// shapes and batch 8, with operands small enough to stay in the 50 MB L2:
// products, not bytes, are the work. The TPU kernel kept the whole block
// in 16 MB of VMEM; one 32x32x128 bf16 example is already 256 KB, more
// than an SM's 227 KB of shared memory.
//
// What the design does about it: a chain of four launches (plus a split-K
// pass where a grid is small),
//   1. GN1 over x (statistics across the logical concat of x1 | x2), writing
//      act1 = resample(SiLU(GN1(x))) once in the compute dtype, and, for an
//      up/down block, the skip branch's input xs = resample(x);
//   2. conv0 as an implicit GEMM over act1, whose epilogue adds b0 and the
//      temb row; h1 goes to device memory in fp32 (the TPU kernel also
//      kept this accumulator in fp32 into GN2);
//   3. GN2 over h1, writing act2 = SiLU(GN2(h1));
//   4. conv1 as an implicit GEMM over act2 with the 1x1 skip projection
//      folded in as extra K steps (x, xs, or x1 | x2 against wskip), and an
//      epilogue adding b1 + bskip or the identity skip, times 1/sqrt(2).
// The concat input is never written out. The activations are, once each:
// normalising inside the conv's A loader recomputed GN + SiLU for every one
// of the 9 taps and left the tensor cores waiting on expf (measured: 82% of
// the evaluation in the GEMM at 17 TFLOP/s).
//
// bf16 (resblock_fwd_wgmma): both GEMMs run on igemm_wgmma.cuh (wgmma +
// TMA, tiles and split-K from ops/fused_resblock.py resblock_plan, which
// fills the SMs at batch 8 and 128), and both GroupNorm passes on
// rb_gn_kernel: one thread-block cluster per example, each block a
// contiguous share of the pixels with all channels in 16-byte vectors kept
// in registers from the first pass to the last, two-pass fp32 statistics
// whose per-block partials the cluster's blocks read from each other's
// shared memory and sum in rank order (the same result in every block, and
// from run to run). On an H100 at 700 W, batch 8, this chain takes 2.9 ms
// of device time per NCSN++ evaluation where the PR 1 chain took 9.6 (GEMMs
// 7.4 -> 1.2 ms; GN passes 1.8 -> 1.45 ms: the passes are now latency
// chains of about 10 us each, not bandwidth), and at batch 128 16.8 ms
// where it took 116.6 (chip_smoke.py phase 2, --profile-cifar).
// fp32 (resblock_fwd_f32, resblock_f32.cu): the same four steps on the FMA
// units (never TF32): rb_gn_kernel<float, float> for both GroupNorm passes
// and f32conv_kernel, a 128 x 128 (or 128 x 64) tile of 8 x 8 outputs a
// thread over a cp.async ring, tiles and split-K from ops/fused_resblock.py
// resblock_f32_plan.
#include "common.cuh"
#include "gn_cluster.cuh"
#include "igemm_wgmma.cuh"

using namespace dp;

namespace dp {
// the fp32 chain, resblock_f32.cu
cudaError_t resblock_fwd_f32(const float* x1, const float* x2, int c1, int c2, int N, int H,
                             int W, int resample, const float* temb, const float* gn1s,
                             const float* gn1b, int g1, const float* w0, const float* b0,
                             const float* gn2s, const float* gn2b, int g2, const float* w1,
                             const float* bias1, int has_proj, int cout, float eps,
                             float oscale, float* act1, float* xs, float* h1, float* act2,
                             float* ws, long ws_elems, float* out, const int* plan,
                             cudaStream_t st);
}  // namespace dp

// The bf16 chain: rb_gn_kernel and the wgmma GEMM. plan: the tile bm x bn,
// the A box (Wo columns x bh rows x bimg images), each conv's K slices
// (splits, steps per slice), as resblock_plan gives them.
static cudaError_t resblock_fwd_wgmma(const bf16* x1, const bf16* x2, int c1, int c2, int N,
                                      int H, int W, int resample, const bf16* temb,
                                      const float* gn1s, const float* gn1b, int g1,
                                      const bf16* w0s, const float* b0, const float* gn2s,
                                      const float* gn2b, int g2, const bf16* w1s,
                                      const float* bias1, int has_proj, int cout, float eps,
                                      float oscale, bf16* act1, bf16* xs, float* h1, bf16* act2,
                                      float* ws, long ws_elems, bf16* out, const int* plan,
                                      cudaStream_t st) {
  if (plan == nullptr) return cudaErrorInvalidValue;
  const int bm = plan[0], bn = plan[1], bh = plan[2], bimg = plan[3], splits0 = plan[4],
            per0 = plan[5], splits1 = plan[6], per1 = plan[7];
  const int cin = c1 + c2;
  const int Ho = resample == RS_DOWN ? H / 2 : (resample == RS_UP ? H * 2 : H);
  const int Wo = resample == RS_DOWN ? W / 2 : (resample == RS_UP ? W * 2 : W);
  const long M = (long)N * Ho * Wo;
  if (c1 % WG_KC || c2 % WG_KC || cout % bn || bn % WG_KC || cin > GN_MAX_C ||
      cout > GN_MAX_C || g1 > GN_MAX_G || g2 > GN_MAX_G || cin % g1 || cout % g2 ||
      (long)Wo * bh * bimg != bm || bh > Ho || ((Ho * Wo) % bm && bm % (Ho * Wo)) ||
      (x2 != nullptr && (!has_proj || resample != RS_NONE)) ||
      (splits0 > 1 && splits0 * M * cout > ws_elems) ||
      (splits1 > 1 && splits1 * M * cout > ws_elems))
    return cudaErrorInvalidValue;

  const RbGnArgs gn1 = {x1, x2, c1, c2, H, W, g1, gn1s, gn1b, eps, resample, act1,
                        resample == RS_NONE ? nullptr : xs};
  cudaError_t err = launch_rb_gn<bf16>(gn1, N, st);
  if (err != cudaSuccess) return err;

  // the projection's sources on the output grid: x (x1 | x2), or xs
  const bf16* p1 = resample == RS_NONE ? x1 : xs;
  const int cp1 = resample == RS_NONE ? c1 : cin;
  CUtensorMap m_act1, m_act2, m_p1, m_p2;
  if (!wg_box_map(&m_act1, act1, N, Ho, Wo, cin, bh, bimg) ||
      !wg_box_map(&m_act2, act2, N, Ho, Wo, cout, bh, bimg) ||
      (has_proj && !wg_box_map(&m_p1, p1, N, Ho, Wo, cp1, bh, bimg)) ||
      (has_proj && c2 > 0 && !wg_box_map(&m_p2, x2, N, Ho, Wo, c2, bh, bimg)))
    return cudaErrorInvalidValue;
  if (!has_proj) m_p1 = m_act1;  // never read
  if (!(has_proj && c2 > 0)) m_p2 = m_act1;

  WgConvArgs a0 = {};
  a0.N = N;
  a0.Ho = Ho;
  a0.Wo = Wo;
  a0.M = (int)M;
  a0.cout = cout;
  a0.nconv = cin / WG_KC;
  a0.bh = bh;
  a0.bimg = bimg;
  a0.w = w0s;
  a0.bias = b0;
  a0.temb = temb;
  a0.oscale = 1.f;
  a0.out = h1;
  a0.out_f32 = 1;
  a0.mtiles = (int)((M + bm - 1) / bm);
  a0.ntiles = cout / bn;
  a0.splits = splits0;
  a0.steps_per = per0;
  a0.ws = ws;
  if ((err = launch_wgmma_conv(a0, bm, bn, m_act1, m_p1, m_p2, st)) != cudaSuccess) return err;

  const RbGnArgs gn2 = {h1, nullptr, cout, 0, Ho, Wo, g2, gn2s, gn2b, eps, RS_NONE, act2,
                        nullptr};
  if ((err = launch_rb_gn<float>(gn2, N, st)) != cudaSuccess) return err;

  WgConvArgs a1 = a0;
  a1.nconv = cout / WG_KC;
  a1.nproj1 = has_proj ? cp1 / WG_KC : 0;
  a1.nproj2 = has_proj ? c2 / WG_KC : 0;
  a1.w = w1s;
  a1.bias = bias1;
  a1.temb = nullptr;
  a1.resid = has_proj ? nullptr : p1;  // identity skip (cin == cout): x, or xs
  a1.oscale = oscale;
  a1.out = out;
  a1.out_f32 = 0;
  a1.splits = splits1;
  a1.steps_per = per1;
  return launch_wgmma_conv(a1, bm, bn, m_act2, m_p1, m_p2, st);
}

extern "C" {

// dtype: 0 fp32, 1 bf16. x2 == NULL and c2 == 0 for a single input.
// resample: 0 none, 1 down, 2 up. w0 is (cout, 9*cin); w1 is (cout, 9*cout
// [+ cin]) with the 1x1 projection's columns last when has_proj; column
// (3*dy + dx)*C + c is tap (dy, dx) of input channel c. bias1 = b1 + bskip.
// Scratch: act1 (N, Ho, Wo, cin), xs (the same, only read when resample != 0)
// and act2 (N, Ho, Wo, cout) in the compute dtype, h1 (N, Ho, Wo, cout)
// fp32, ws (ws_elems fp32) for split-K partials.
// bf16 runs on the wgmma chain and reads w0s (9 cin / 64, cout, 64) and w1s
// (9 cout / 64 [+ cin / 64], cout, 64) instead of w0 and w1: the weight
// stages of ops/fused_resblock.py, step (c // 64) * 9 + tap for input
// channel c, the projection's steps last, each row in the 128-byte swizzle
// (fp32 ignores w0s, w1s). plan: 8 ints, resblock_plan's for bf16 (tile bm,
// bn, A box bh rows x bimg images (x Wo columns), then (splits, steps per
// slice) of conv0 and of conv1), resblock_f32_plan's for fp32 (128, bn,
// ring stages, 0, the same splits).
// Returns cudaGetLastError() of the first failing launch, or
// cudaErrorInvalidValue for a shape or plan the chain does not take.
int diffpure_resblock_fwd(int dtype, const void* x1, const void* x2, int c1, int c2, int N,
                          int H, int W, int resample, const void* temb, const float* gn1s,
                          const float* gn1b, int g1, const void* w0, const float* b0,
                          const float* gn2s, const float* gn2b, int g2, const void* w1,
                          const float* bias1, int has_proj, int cout, float eps,
                          float oscale, void* act1, void* xs, float* h1, void* act2,
                          float* ws, long ws_elems, void* out, const void* w0s,
                          const void* w1s, const int* plan, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return resblock_fwd_wgmma(
        static_cast<const bf16*>(x1), static_cast<const bf16*>(x2), c1, c2, N, H, W, resample,
        static_cast<const bf16*>(temb), gn1s, gn1b, g1, static_cast<const bf16*>(w0s), b0, gn2s,
        gn2b, g2, static_cast<const bf16*>(w1s), bias1, has_proj, cout, eps, oscale,
        static_cast<bf16*>(act1), static_cast<bf16*>(xs), h1, static_cast<bf16*>(act2), ws,
        ws_elems, static_cast<bf16*>(out), plan, st);
  return resblock_fwd_f32(
      static_cast<const float*>(x1), static_cast<const float*>(x2), c1, c2, N, H, W, resample,
      static_cast<const float*>(temb), gn1s, gn1b, g1, static_cast<const float*>(w0), b0, gn2s,
      gn2b, g2, static_cast<const float*>(w1), bias1, has_proj, cout, eps, oscale,
      static_cast<float*>(act1), static_cast<float*>(xs), h1, static_cast<float*>(act2), ws,
      ws_elems, static_cast<float*>(out), plan, st);
}

const char* diffpure_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
