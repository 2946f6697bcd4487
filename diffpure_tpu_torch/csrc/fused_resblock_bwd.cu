// Input-gradient backward of the fused BigGAN residual block (NCSN++
// ResnetBlockBigGANpp, eval mode) for Hopper, bf16 or fp32 NHWC maps:
// (dx, dtemb_row), or (dx1, dx2, dtemb_row) for the concat-input block.
//
// Replaces the TPU kernels diffpure_tpu/ops/fused_resblock.py:506
// fused_resblock_bwd_pallas (_fused_resblock_bwd_kernel :373) and :941
// fused_resblock_cat_bwd_pallas (_fused_resblock_cat_bwd_kernel :803).
// Weight cotangents are not computed here (the caller takes them from
// autodiff of the plain version, only when asked, as the JAX custom_vjp does).
//
// What bounds it on this card: three 3x3 convs of the block's size (the
// recompute of conv0, conv1 transposed, conv0 transposed) plus the 1x1 skip
// adjoint, 0.9-29 GFLOP per block at the CIFAR shapes and batch 8, on
// operands that fit the 50 MB L2: products, as in the forward. The TPU
// kernel holds one example's whole map in VMEM; an SM's 227 KB of shared
// memory holds less than one 32x32x128 bf16 map.
//
// What the design does about it: a chain of launches, nothing but act1,
// h1, d_a2, d_c1, d_h and the skip adjoint going through memory (L2 at
// these sizes) between them:
//   1. GN1 + SiLU (+ resample) of x -> act1, the forward's GN pass;
//   2. conv0 over act1 + b0 + temb -> h1 in fp32 (the GN2 input, c1 in JAX);
//   3. conv1^T: g against the flipped, channel-transposed w1, times the
//      output scale 1/sqrt(2) in the epilogue -> d_a2 in fp32;
//   4. GN2 + SiLU backward from h1 and d_a2: d_c1 in the compute dtype (the
//      next GEMM's operand, as JAX feeds the conv in compute_dtype) and
//      dtemb = sum over HW of d_c1 in fp32, summed in a fixed order;
//   5. conv0^T: d_c1 against the flipped, transposed w0 -> d_h (cin
//      channels) in fp32;
//   6. the skip adjoint: g against wskip^T (1x1, times 1/sqrt(2)) when the
//      block projects, else g itself;
//   7. GN1 + SiLU backward over x, reading d_h and the skip adjoint through
//      the resample's transpose (x1/4 nearest-up for a down block, a 2x2
//      sum for an up block), writing dx in fp32 -- split at the seam into
//      dx1 | dx2 for the concat block, whose GN1 groups may straddle it.
// bf16 (resblock_bwd_wgmma): the four products run on the forward's wgmma
// + TMA implicit GEMM (igemm_wgmma.cuh; A = act1, g or d_c1 by one TMA box
// per tap, B = the weight stages w0s, w1ts, w0ts, wskipts of
// ops/fused_resblock.py, tiles and split-K from resblock_bwd_plan; the skip
// adjoint is a GEMM of projection steps alone), the GN passes in the
// cluster layout of gn_cluster.cuh (rb_gn_kernel for the recompute,
// rb_gn_bwd_kernel for both backward passes: one cluster per example, x
// kept in registers across its passes, sums in rank order; GN1's backward
// takes its statistics from the recompute, GN2's takes one round for them).
// fp32 (resblock_bwd_f32, resblock_f32.cu): the same seven steps on the
// FMA units (never TF32): the products on the fp32 forward's f32conv_kernel
// (a cp.async ring, 8 x 16 or 8 x 8 outputs a thread, split-K summed in
// slice order; w1t, w0t and wskipt as its (Nc, K) operand), the GN passes
// on rb_gn_kernel<float, float> and rb_gn_bwd_kernel<float, float>, tiles
// and splits from ops/fused_resblock.py resblock_bwd_f32_plan.
#include "common.cuh"
#include "gn_cluster.cuh"
#include "igemm_wgmma.cuh"

using namespace dp;

namespace dp {
// the fp32 chain, resblock_f32.cu
cudaError_t resblock_bwd_f32(const float* x1, const float* x2, int c1, int c2, int N, int H,
                             int W, int resample, const float* temb, const float* g,
                             const float* gn1s, const float* gn1b, int g1, const float* w0,
                             const float* b0, const float* gn2s, const float* gn2b, int g2,
                             const float* w1t, const float* w0t, const float* wskipt, int cout,
                             float eps, float oscale, float* act1, float* h1, float* da2,
                             float* dc1, float* dh, float* dskip, float* ws, long ws_elems,
                             float* dx1, float* dx2, float* dtemb, float2* gn1_stats,
                             const int* plan, cudaStream_t st);
}  // namespace dp

namespace {

// The bf16 chain: every product on the wgmma GEMM (igemm_wgmma.cuh), every
// GroupNorm pass in the cluster layout (gn_cluster.cuh). plan: for each of
// the four GEMMs (conv0's recompute, conv1^T, conv0^T, the skip adjoint;
// BWD_GEMMS of them) the tile bm x bn, the A box (Wo columns x bh rows x
// bimg images) and the K slices (splits, steps per slice), as
// ops/fused_resblock.py resblock_bwd_plan gives them.
constexpr int BWD_GEMMS = 4, PLAN_INTS = 6;

cudaError_t resblock_bwd_wgmma(const bf16* x1, const bf16* x2, int c1, int c2, int N, int H,
                               int W, int resample, const bf16* temb, const bf16* g,
                               const float* gn1s, const float* gn1b, int g1, const bf16* w0s,
                               const float* b0, const float* gn2s, const float* gn2b, int g2,
                               const bf16* w1ts, const bf16* w0ts, const bf16* wskipts, int cout,
                               float eps, float oscale, bf16* act1, float* h1, float* da2,
                               bf16* dc1, float* dh, float* dskip, float* ws, long ws_elems,
                               float* dx1, float* dx2, float* dtemb, float2* gn1_stats,
                               const int* plan, cudaStream_t st) {
  const int cin = c1 + c2;
  const int Ho = resample == RS_DOWN ? H / 2 : (resample == RS_UP ? H * 2 : H);
  const int Wo = resample == RS_DOWN ? W / 2 : (resample == RS_UP ? W * 2 : W);
  const long M = (long)N * Ho * Wo;
  const bool proj = wskipts != nullptr;
  // each GEMM's output width
  const int nout[BWD_GEMMS] = {cout, cout, cin, cin};
  if (c1 % WG_KC || c2 % WG_KC || cout % WG_KC || cin > GN_MAX_C || cout > GN_MAX_C ||
      g1 > GN_MAX_G || g2 > GN_MAX_G || cin % g1 || cout % g2 ||
      (x2 != nullptr && (!proj || resample != RS_NONE)) || (!proj && cin != cout))
    return cudaErrorInvalidValue;
  for (int i = 0; i < (proj ? BWD_GEMMS : BWD_GEMMS - 1); ++i) {
    const int* p = plan + PLAN_INTS * i;
    const int bm = p[0], bn = p[1], bh = p[2], bimg = p[3], splits = p[4];
    if (nout[i] % bn || bn % WG_KC || (long)Wo * bh * bimg != bm || bh > Ho ||
        ((Ho * Wo) % bm && bm % (Ho * Wo)) || (splits > 1 && splits * M * nout[i] > ws_elems))
      return cudaErrorInvalidValue;
  }
  auto gemm_args = [&](int i, int nconv, int nproj, const bf16* w, int n_out, float scale,
                       float* out) {
    const int* p = plan + PLAN_INTS * i;
    WgConvArgs a = {};
    a.N = N;
    a.Ho = Ho;
    a.Wo = Wo;
    a.M = (int)M;
    a.cout = n_out;
    a.nconv = nconv;
    a.nproj1 = nproj;
    a.bh = p[2];
    a.bimg = p[3];
    a.w = w;
    a.oscale = scale;
    a.out = out;
    a.out_f32 = 1;
    a.mtiles = (int)((M + p[0] - 1) / p[0]);
    a.ntiles = n_out / p[1];
    a.splits = p[4];
    a.steps_per = p[5];
    a.ws = ws;
    return a;
  };
  // the map of a (N, Ho, Wo, C) operand in GEMM i's box
  auto box_map = [&](CUtensorMap* m, const bf16* t, int C, int i) {
    return wg_box_map(m, t, N, Ho, Wo, C, plan[PLAN_INTS * i + 2], plan[PLAN_INTS * i + 3]);
  };

  // 1-2: recompute h1 = conv0(resample(SiLU(GN1(x)))) + b0 + temb, as the forward
  const RbGnArgs gn1 = {x1, x2, c1, c2, H, W, g1, gn1s, gn1b, eps, resample, act1, nullptr,
                        gn1_stats};
  cudaError_t err = launch_rb_gn<bf16>(gn1, N, st);
  if (err != cudaSuccess) return err;
  CUtensorMap m_act1;
  if (!box_map(&m_act1, act1, cin, 0)) return cudaErrorInvalidValue;
  WgConvArgs a0 = gemm_args(0, cin / WG_KC, 0, w0s, cout, 1.f, h1);
  a0.bias = b0;
  a0.temb = temb;
  if ((err = launch_wgmma_conv(a0, plan[0], plan[1], m_act1, m_act1, m_act1, st)) != cudaSuccess)
    return err;

  // 3: d_a2 = conv1^T(g) * oscale
  CUtensorMap m_g;
  if (!box_map(&m_g, g, cout, 1)) return cudaErrorInvalidValue;
  const WgConvArgs a1 = gemm_args(1, cout / WG_KC, 0, w1ts, cout, oscale, da2);
  if ((err = launch_wgmma_conv(a1, plan[PLAN_INTS], plan[PLAN_INTS + 1], m_g, m_g, m_g, st)) !=
      cudaSuccess)
    return err;

  // 4: through SiLU(GN2(h1)): d_c1 (bf16) and dtemb
  RbGnBwdArgs b2 = {};
  b2.x1 = h1;
  b2.c1 = cout;
  b2.H = Ho;
  b2.W = Wo;
  b2.G = g2;
  b2.gamma = gn2s;
  b2.beta = gn2b;
  b2.eps = eps;
  b2.d = da2;
  b2.resample = RS_NONE;
  b2.out1 = dc1;
  b2.dsum = dtemb;
  if ((err = launch_rb_gn_bwd<float, bf16>(b2, N, st)) != cudaSuccess) return err;

  // 5: d_h = conv0^T(d_c1), cin channels on the output grid
  CUtensorMap m_dc1;
  if (!box_map(&m_dc1, dc1, cout, 2)) return cudaErrorInvalidValue;
  const WgConvArgs a2 = gemm_args(2, cout / WG_KC, 0, w0ts, cin, 1.f, dh);
  if ((err = launch_wgmma_conv(a2, plan[2 * PLAN_INTS], plan[2 * PLAN_INTS + 1], m_dc1, m_dc1,
                               m_dc1, st)) != cudaSuccess)
    return err;

  // 6: the skip adjoint g wskip^T * oscale: projection steps alone
  if (proj) {
    CUtensorMap m_gs;
    if (!box_map(&m_gs, g, cout, 3)) return cudaErrorInvalidValue;
    const WgConvArgs a3 = gemm_args(3, 0, cout / WG_KC, wskipts, cin, oscale, dskip);
    if ((err = launch_wgmma_conv(a3, plan[3 * PLAN_INTS], plan[3 * PLAN_INTS + 1], m_gs, m_gs,
                                 m_gs, st)) != cudaSuccess)
      return err;
  }

  // 7: dx = GN1+SiLU backward of resample^T(d_h) + resample^T(the skip
  // adjoint, or g * oscale for an identity skip), split at the seam
  RbGnBwdArgs b1 = {};
  b1.x1 = x1;
  b1.x2 = x2;
  b1.c1 = c1;
  b1.c2 = c2;
  b1.H = H;
  b1.W = W;
  b1.G = g1;
  b1.gamma = gn1s;
  b1.beta = gn1b;
  b1.eps = eps;
  b1.stats = gn1_stats;  // the recompute's
  b1.d = dh;
  b1.resample = resample;
  b1.add = proj ? static_cast<const void*>(dskip) : static_cast<const void*>(g);
  b1.add_f32 = proj;
  b1.add_scale = proj ? 1.f : oscale;
  b1.out1 = dx1;
  b1.out2 = dx2;
  return launch_rb_gn_bwd<bf16, float>(b1, N, st);
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16. x2 == NULL and c2 == 0 for a single input; then dx2
// is unused and dx1 gets all cin channels. resample: 0 none, 1 down, 2 up.
// g is d(loss)/d(out), (N, Ho, Wo, cout) in the compute dtype. w0/b0 as the
// forward takes them; w1t is (cout, 9*cout) and w0t (cin, 9*cout), column
// (3*dy + dx)*cout + o = w[o, c, 2 - dy, 2 - dx]; wskipt (cin, cout), or
// NULL for an identity skip. oscale is the output's scale (1/sqrt(2)).
// Scratch: act1 (N, Ho, Wo, cin) and dc1 (N, Ho, Wo, cout) in the compute
// dtype; h1, da2 (N, Ho, Wo, cout), dh and dskip (N, Ho, Wo, cin) in fp32
// (dskip only read with a projection); ws (ws_elems fp32) for split-K
// partials. Outputs in fp32: dx1 (N, H, W, c1), dx2 (N, H, W, c2), dtemb
// (N, cout).
// bf16 runs on the wgmma chain and reads, instead of w0, w1t, w0t and
// wskipt, the weight stages of ops/fused_resblock.py (64-channel steps,
// rows in the 128-byte swizzle): w0s (9 cin / 64, cout, 64), the forward's;
// w1ts (9 cout / 64, cout, 64) and w0ts (9 cout / 64, cin, 64), the
// flipped, channel-transposed 3x3 weights; wskipts (cout / 64, cin, 64) or
// NULL; and plan, 24 ints: (bm, bn, bh, bimg, splits, steps per slice) of
// conv0's recompute, conv1^T, conv0^T and the skip adjoint. fp32 reads w0,
// w1t, w0t and wskipt and a plan of 16 ints: (tn, stages, splits, per) of
// the same four GEMMs (resblock_bwd_f32_plan). Both take gn1_stats, (N, g1)
// float2 scratch for GN1's (mean, rstd). Returns cudaGetLastError() of the
// first failing launch, or cudaErrorInvalidValue for a shape or plan the
// chain does not take.
int diffpure_resblock_bwd(int dtype, const void* x1, const void* x2, int c1, int c2, int N,
                          int H, int W, int resample, const void* temb, const void* g,
                          const float* gn1s, const float* gn1b, int g1, const void* w0,
                          const float* b0, const float* gn2s, const float* gn2b, int g2,
                          const void* w1t, const void* w0t, const void* wskipt, int cout,
                          float eps, float oscale, void* act1, float* h1, float* da2, void* dc1,
                          float* dh, float* dskip, float* ws, long ws_elems, float* dx1,
                          float* dx2, float* dtemb, const void* w0s, const void* w1ts,
                          const void* w0ts, const void* wskipts, void* gn1_stats,
                          const int* plan, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return resblock_bwd_wgmma(
        static_cast<const bf16*>(x1), static_cast<const bf16*>(x2), c1, c2, N, H, W, resample,
        static_cast<const bf16*>(temb), static_cast<const bf16*>(g), gn1s, gn1b, g1,
        static_cast<const bf16*>(w0s), b0, gn2s, gn2b, g2, static_cast<const bf16*>(w1ts),
        static_cast<const bf16*>(w0ts), static_cast<const bf16*>(wskipts), cout, eps, oscale,
        static_cast<bf16*>(act1), h1, da2, static_cast<bf16*>(dc1), dh, dskip, ws, ws_elems,
        dx1, dx2, dtemb, static_cast<float2*>(gn1_stats), plan, st);
  return resblock_bwd_f32(
      static_cast<const float*>(x1), static_cast<const float*>(x2), c1, c2, N, H, W, resample,
      static_cast<const float*>(temb), static_cast<const float*>(g), gn1s, gn1b, g1,
      static_cast<const float*>(w0), b0, gn2s, gn2b, g2, static_cast<const float*>(w1t),
      static_cast<const float*>(w0t), static_cast<const float*>(wskipt), cout, eps, oscale,
      static_cast<float*>(act1), h1, da2, static_cast<float*>(dc1), dh, dskip, ws, ws_elems, dx1,
      dx2, dtemb, static_cast<float2*>(gn1_stats), plan, st);
}

// Encodings of the wgmma GEMM's tensor maps since the library was loaded
// (its cache's misses).
long diffpure_wg_map_misses() { return wg_map_misses(); }

}  // extern "C"
