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
// fp32 (resblock_bwd_f32): the PR 2 chain: common.cuh's gn_apply_kernel and
// launch_gemm (plain fp32 FMAs, never TF32; deterministic split-K) and
// gn_silu_bwd_kernel below (one block per (group, example), four passes).
#include "common.cuh"
#include "gn_cluster.cuh"
#include "igemm_wgmma.cuh"

using namespace dp;

namespace {

// d(loss)/d(act) at pixel (y, x) of the GN input's grid, read from a map on
// the grid after the block's resample, through the resample's transpose.
template <typename T>
__device__ __forceinline__ float read_transposed(const Src& s, int resample, int n, int y,
                                                 int x, int c) {
  const long row = (long)n * s.H;
  if (resample == RS_DOWN)  // 2x2 mean -> each input pixel got 1/4 of one output
    return 0.25f * src_load1<T>(s, (row + (y >> 1)) * s.W + (x >> 1), c);
  if (resample == RS_UP) {  // nearest 2x -> the sum of the four copies (JAX's order)
    const long p0 = (row + 2 * y) * s.W + 2 * x, p1 = p0 + s.W;
    return (src_load1<T>(s, p0, c) + src_load1<T>(s, p0 + 1, c)) +
           (src_load1<T>(s, p1, c) + src_load1<T>(s, p1 + 1, c));
  }
  return src_load1<T>(s, (row + y) * s.W + x, c);
}

struct GnBwdArgs {
  Src x;         // the GN's input, H x W
  Src d;         // d(loss)/d(SiLU(GN(x))), on the grid after `resample`
  int resample;  // RS_*: how x's grid maps onto d's
  int G;
  const float* gamma;
  const float* beta;
  float eps;
  Src add;          // added to the output through the same transpose; p0 == nullptr: none
  float add_scale;  // times add
  void* out0;       // channels [0, oc0), row pitch oc0
  void* out1;       // channels [oc0, C), row pitch C - oc0 (the cat block's dx2)
  int oc0;
  int out_f32;   // output stored as fp32, else as T
  float* dsum;   // (N, C) sum over HW of the output before `add`, or nullptr
};

// GroupNorm + SiLU backward, one block per (group, example):
//   xhat = (x - mean) * rstd, y = xhat * gamma + beta,
//   dxhat = d * silu'(y) * gamma,
//   dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),
// the means over the group (JAX _gn_silu_bwd_inkernel :140). Threads
// [0, nthr) each keep one channel of the group (nthr is a multiple of the
// group's width), so the per-channel sum for dtemb needs no atomics.
template <typename T>
__global__ void __launch_bounds__(NT) gn_silu_bwd_kernel(const __grid_constant__ GnBwdArgs a) {
  __shared__ float red[NT / 32];
  __shared__ float part[NT];
  const Src& s = a.x;
  const int g = blockIdx.x, n = blockIdx.y;
  const int C = s.c0 + s.c1, cg = C / a.G, hw = s.H * s.W;
  const int nthr = (NT / cg) * cg, pstep = nthr / cg;
  const bool active = threadIdx.x < nthr;
  const int c = g * cg + (int)(threadIdx.x % cg);
  const int pbeg = active ? (int)(threadIdx.x / cg) : hw;
  const long pix0 = (long)n * hw;
  const float cnt = (float)((long)hw * cg);

  float acc = 0.f;
  for (int p = pbeg; p < hw; p += pstep) acc += src_load1<T>(s, pix0 + p, c);
  const float mean = block_sum(acc, red) / cnt;
  acc = 0.f;
  for (int p = pbeg; p < hw; p += pstep) {
    const float v = src_load1<T>(s, pix0 + p, c) - mean;
    acc += v * v;
  }
  const float rstd = rsqrtf(block_sum(acc, red) / cnt + a.eps);
  const float gam = a.gamma[c], bet = a.beta[c];

  // dxhat at pixel p; xh gets xhat
  auto dxhat = [&](int p, float& xh) {
    const int y = p / s.W, x = p - y * s.W;
    xh = (src_load1<T>(s, pix0 + p, c) - mean) * rstd;
    const float yv = xh * gam + bet;
    const float sig = 1.f / (1.f + expf(-yv));
    return read_transposed<T>(a.d, a.resample, n, y, x, c) * (sig * (1.f + yv * (1.f - sig))) *
           gam;
  };
  float s1 = 0.f, s2 = 0.f;
  for (int p = pbeg; p < hw; p += pstep) {
    float xh;
    const float dh = dxhat(p, xh);
    s1 += dh;
    s2 += dh * xh;
  }
  const float m1 = block_sum(s1, red) / cnt;
  const float m2 = block_sum(s2, red) / cnt;

  float csum = 0.f;
  for (int p = pbeg; p < hw; p += pstep) {
    float xh;
    float v = rstd * (dxhat(p, xh) - m1 - xh * m2);
    csum += v;
    if (a.add.p0 != nullptr) {
      const int y = p / s.W, x = p - y * s.W;
      v += a.add_scale * read_transposed<T>(a.add, a.resample, n, y, x, c);
    }
    const long pix = pix0 + p;
    void* base = a.out0;
    long idx = pix * a.oc0 + c;
    if (c >= a.oc0) {
      base = a.out1;
      idx = pix * (C - a.oc0) + (c - a.oc0);
    }
    if (a.out_f32)
      static_cast<float*>(base)[idx] = v;
    else
      static_cast<T*>(base)[idx] = from_f32<T>(v);
  }
  if (a.dsum != nullptr) {  // uniform across the block
    part[threadIdx.x] = csum;
    __syncthreads();
    if (threadIdx.x < cg) {
      float t = 0.f;
      for (int j = threadIdx.x; j < nthr; j += cg) t += part[j];  // in thread order
      a.dsum[(long)n * C + g * cg + threadIdx.x] = t;
    }
  }
}

template <typename T>
cudaError_t launch_gn_bwd(const GnBwdArgs& a, int N, cudaStream_t st) {
  const int C = a.x.c0 + a.x.c1;
  if (C % a.G != 0 || C / a.G > NT) return cudaErrorInvalidValue;
  gn_silu_bwd_kernel<T><<<dim3(a.G, N), NT, 0, st>>>(a);
  return cudaGetLastError();
}

// The fp32 chain (T = float).
template <typename T>
cudaError_t resblock_bwd_f32(const void* x1, const void* x2, int c1, int c2, int N, int H, int W,
                         int resample, const void* temb, const void* g, const float* gn1s,
                         const float* gn1b, int g1, const void* w0, const float* b0,
                         const float* gn2s, const float* gn2b, int g2, const void* w1t,
                         const void* w0t, const void* wskipt, int cout, float eps, float oscale,
                         void* act1, float* h1, float* da2, void* dc1, float* dh, float* dskip,
                         float* ws, long ws_elems, float* dx1, float* dx2, float* dtemb,
                         cudaStream_t st) {
  const int cin = c1 + c2;
  const int Ho = resample == RS_DOWN ? H / 2 : (resample == RS_UP ? H * 2 : H);
  const int Wo = resample == RS_DOWN ? W / 2 : (resample == RS_UP ? W * 2 : W);
  const int M = N * Ho * Wo;
  const Src x = {x1, x2, c1, c2, H, W, 0};
  const Src gsrc = {g, nullptr, cout, 0, Ho, Wo, 0};

  // 1-2: recompute h1 = conv0(resample(silu(gn1(x)))) + b0 + temb, as the forward
  const GnArgs gn1 = {x, g1, gn1s, gn1b, eps, 1, resample, act1, nullptr};
  cudaError_t err = launch_gn_apply<T>(gn1, N, st);
  if (err != cudaSuccess) return err;
  GemmArgs a0 = {};
  a0.M = M;
  a0.Nc = cout;
  a0.K = a0.Kmain = 9 * cin;
  a0.Ho = Ho;
  a0.Wo = Wo;
  a0.taps = 9;
  a0.src = Src{act1, nullptr, cin, 0, Ho, Wo, 0};
  a0.w = w0;
  a0.bias = b0;
  a0.temb = temb;
  a0.oscale = 1.f;
  a0.out = h1;
  a0.out_f32 = 1;
  if ((err = launch_gemm<T>(a0, ws, ws_elems, st)) != cudaSuccess) return err;

  // 3: d_a2 = conv1^T(g) * oscale
  GemmArgs a1 = {};
  a1.M = M;
  a1.Nc = cout;
  a1.K = a1.Kmain = 9 * cout;
  a1.Ho = Ho;
  a1.Wo = Wo;
  a1.taps = 9;
  a1.src = gsrc;
  a1.w = w1t;
  a1.oscale = oscale;
  a1.out = da2;
  a1.out_f32 = 1;
  if ((err = launch_gemm<T>(a1, ws, ws_elems, st)) != cudaSuccess) return err;

  // 4: through SiLU(GN2(h1)): d_c1 (T) and dtemb
  const GnBwdArgs b2 = {Src{h1, nullptr, cout, 0, Ho, Wo, 1}, Src{da2, nullptr, cout, 0, Ho, Wo, 1},
                        RS_NONE, g2, gn2s, gn2b, eps, Src{}, 0.f, dc1, nullptr, cout, 0, dtemb};
  if ((err = launch_gn_bwd<T>(b2, N, st)) != cudaSuccess) return err;

  // 5: d_h = conv0^T(d_c1), cin channels on the output grid
  GemmArgs a2 = {};
  a2.M = M;
  a2.Nc = cin;
  a2.K = a2.Kmain = 9 * cout;
  a2.Ho = Ho;
  a2.Wo = Wo;
  a2.taps = 9;
  a2.src = Src{dc1, nullptr, cout, 0, Ho, Wo, 0};
  a2.w = w0t;
  a2.oscale = 1.f;
  a2.out = dh;
  a2.out_f32 = 1;
  if ((err = launch_gemm<T>(a2, ws, ws_elems, st)) != cudaSuccess) return err;

  // 6: the skip adjoint, on the output grid
  Src add = gsrc;
  float add_scale = oscale;
  if (wskipt != nullptr) {
    GemmArgs a3 = {};
    a3.M = M;
    a3.Nc = cin;
    a3.K = a3.Kmain = cout;
    a3.Ho = Ho;
    a3.Wo = Wo;
    a3.taps = 1;
    a3.src = gsrc;
    a3.w = wskipt;
    a3.oscale = oscale;
    a3.out = dskip;
    a3.out_f32 = 1;
    if ((err = launch_gemm<T>(a3, ws, ws_elems, st)) != cudaSuccess) return err;
    add = Src{dskip, nullptr, cin, 0, Ho, Wo, 1};
    add_scale = 1.f;
  }

  // 7: dx = GN1+SiLU backward of resample^T(d_h) + resample^T(skip adjoint)
  const GnBwdArgs b1 = {x,        Src{dh, nullptr, cin, 0, Ho, Wo, 1}, resample, g1, gn1s, gn1b,
                        eps,      add, add_scale, dx1, dx2, c1, 1, nullptr};
  return launch_gn_bwd<T>(b1, N, st);
}


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
// NULL; gn1_stats, (N, g1) float2 scratch for GN1's (mean, rstd); and
// plan, 24 ints: (bm, bn, bh, bimg, splits, steps per slice) of conv0's
// recompute, conv1^T, conv0^T and the skip adjoint. fp32 ignores these. Returns cudaGetLastError() of the first failing launch, or
// cudaErrorInvalidValue for a shape or plan the bf16 chain does not take.
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
  return resblock_bwd_f32<float>(x1, x2, c1, c2, N, H, W, resample, temb, g, gn1s, gn1b, g1, w0,
                                 b0, gn2s, gn2b, g2, w1t, w0t, wskipt, cout, eps, oscale, act1,
                                 h1, da2, dc1, dh, dskip, ws, ws_elems, dx1, dx2, dtemb, st);
}

// Encodings of the wgmma GEMM's tensor maps since the library was loaded
// (its cache's misses).
long diffpure_wg_map_misses() { return wg_map_misses(); }

}  // extern "C"
