// The fp32 chains of the fused BigGAN residual block, forward (kernels #1
// and #2, fused_resblock.cu's entry point dispatches here) and input
// gradient (kernels #4 and #5, from fused_resblock_bwd.cu's): the precision
// of every CIFAR-10 run script, as --precision defaults to fp32, and of
// every attack step they differentiate.
//
// Replaces, in fp32, the TPU kernels diffpure_tpu/ops/fused_resblock.py:290
// fused_resblock_pallas and :728 fused_resblock_cat_pallas; the block it
// computes is fused_resblock.cu's (GN1 + SiLU over x1 | x2, the resample,
// conv0 + b0 + temb, GN2 + SiLU, conv1 with the 1x1 skip projection folded
// in as extra K, (skip + h) * oscale). And :506 fused_resblock_bwd_pallas
// and :941 fused_resblock_cat_bwd_pallas: (dx, or dx1 | dx2 split at the
// concat seam, and dtemb) for an output cotangent g, as
// fused_resblock_bwd.cu describes them.
//
// What bounds it on this card: the block's products on the FMA units (fp32
// never runs on TF32 here). Forward: two 3x3 convs, 0.3-9.7 GFLOP per block
// at batch 8: at 67 TFLOP/s, 1.77 ms (#1) and 2.44 ms (#2) per NCSN++
// evaluation at batch 8. Backward: conv0 again, conv1 and conv0
// transposed, the 1x1 skip adjoint: 2.63 ms (#4) and 3.96 ms (#5) per
// evaluation's backward at batch 8. An SM issues one warp instruction a
// clock per scheduler (128 FMAs) and its shared memory serves 128 bytes a
// clock: one float a lane a clock, whatever the broadcast. A thread with an
// R x C register tile reads R + C floats per k for R C FMAs, so 8 x 8 keeps
// shared memory exactly as busy as the FMA units, and measured on an H100
// the kernel then ran at 57% of the FMA peak (its FMA-ablated copy took 64%
// of its time).
//
// What the design does about it. The forward, a chain of four launches
// (plus a split-K pass where the grid is small):
//   1. GN1: gn_cluster.cuh's rb_gn_kernel<float, float> (one cluster per
//      example, the map in registers across its passes, sums in rank
//      order), writing act1 and, for an up/down block, xs = resample(x);
//   2. conv0: f32conv_kernel below over act1, + b0 + temb -> h1 (fp32);
//   3. GN2: rb_gn_kernel<float, float> over h1 -> act2;
//   4. conv1: f32conv_kernel over act2, the projection's K steps reading x1
//      | x2 (or xs) at the row's pixel, + bias1 or the identity skip,
//      times oscale.
// The backward, seven launches (six for an identity skip; plus a split-K
// pass where a GEMM's grid is small), every product on the same GEMM: a
// transposed 3x3 SAME conv of stride 1 is a 3x3 conv with the flipped,
// channel-transposed weights (ops/fused_resblock.py's w1t, w0t: the (Nc, K)
// tap-major operand the GEMM reads), so nothing but act1, h1, d_a2, d_c1,
// d_h and the skip adjoint goes through memory (L2 at these sizes):
//   1. GN1 recompute: rb_gn_kernel<float, float> over x1 | x2 -> act1, and
//      GN1's (mean, rstd);
//   2. conv0 recompute: f32conv_kernel over act1, + b0 + temb -> h1;
//   3. conv1^T: f32conv_kernel over g (cout channels) with w1t, times
//      oscale -> d_a2;
//   4. GN2 + SiLU backward: gn_cluster.cuh's rb_gn_bwd_kernel<float, float>
//      from h1 and d_a2 -> d_c1 and dtemb (sums in a fixed order);
//   5. conv0^T: f32conv_kernel over d_c1 with w0t -> d_h (cin channels);
//   6. the skip adjoint, projected blocks only: f32conv_kernel of
//      projection steps alone (Kmain = 0) over g with wskipt, times oscale;
//   7. GN1 + SiLU backward: rb_gn_bwd_kernel<float, float> with the
//      recompute's statistics, reading d_h and the skip adjoint (an
//      identity skip: g times oscale, fp32) through the resample's
//      transpose, writing dx1 | dx2.
// f32conv_kernel: out[M, Nc] = A[M, K] W[Nc, K]^T on 128 x 128 tiles, 8 x
// 16 outputs a thread (shared memory at 75% of the FMA units' time; 128
// threads, two blocks an SM) or, where K would be cut into slices too
// short for that tile's longer steps, 8 x 8 (256 threads, one block an
// SM); K in steps of 32. A's rows (the 9 taps of an output pixel, then the
// projection's channels) and W's rows are copied by cp.async, 16 bytes at
// a time from pointers each thread computes once a step (one divide for
// the tap), into a ring of `stages` steps in dynamic shared memory,
// zero-filled outside the map (SAME padding), past M, past Nc and past the
// K slice. Both operands stay k-inner in shared memory ([row][k], rows
// padded to 36 floats: conflict-free), so no transpose is stored; per 4 k
// a thread reads 8 + TN 16-byte vectors (rows 4 apart, columns 8 apart)
// for 32 TN FMAs. Where the tiles leave SMs idle, K splits over blockIdx.z
// into slices whose partials common.cuh's splitk_epilogue_kernel sums in
// slice order (a run repeats bit for bit). Tiles, thread tiles, stages and
// splits come from ops/fused_resblock.py resblock_f32_plan and
// resblock_bwd_f32_plan. Shapes beyond the cluster GN passes' scratch (more
// than GN_MAX_C channels or GN_MAX_G groups; none in the NCSN++ census)
// take common.cuh's gn_apply_kernel and gn_silu_bwd_kernel below for that
// pass, by shape alone.
#include "common.cuh"
#include "gn_cluster.cuh"

using namespace dp;

namespace {

constexpr int FC_BM = 128, FC_BN = 128, FC_BK = 32, FC_LD = FC_BK + 4;
constexpr int FC_STAGE = (FC_BM + FC_BN) * FC_LD;  // floats

// The two thread tiles, 8 rows x TN columns: TN = 16, 128 threads (4 warps
// of 32 rows x 128 columns), two blocks an SM, 3 ring steps each, the k
// loop unrolled 2x (fully unrolled, its 68 KB of code ran 30% slower); TN =
// 8, 256 threads (8 warps of 32 x 64), one block an SM, 4 steps, unrolled
// fully.
template <int TN> struct FcTile {
  static constexpr int THREADS = 128 * 16 / TN;
  static constexpr int BLOCKS_PER_SM = TN / 8;
  static constexpr int MAX_STAGES = TN == 16 ? 3 : 4;
  static constexpr int KU = TN == 16 ? 2 : 8;
  static constexpr int ROWS = THREADS / 8;     // rows one round of copies covers
  static constexpr int COPIES = FC_BM / ROWS;  // of A and of W, a thread a step
};

// fp32 implicit GEMM operands. Row m is output pixel m of the (N, Ho, Wo)
// grid; A's columns [0, Kmain) are (tap, channel) of act (C channels, on
// the output grid, a 3x3 SAME window), [Kmain, K) the channels of p1 (c1)
// then p2 (c2) at the row's pixel. w is (Nc, K), k contiguous.
struct F32ConvArgs {
  int M, Nc, K, Kmain, Ho, Wo, C;
  const float* act;
  const float* p1;
  const float* p2;
  int c1, c2;
  const float* w;
  const float* bias;   // (Nc,) or nullptr
  const float* temb;   // (N, Nc) or nullptr
  const float* resid;  // (M, Nc) or nullptr: an identity skip
  float oscale;
  float* out;          // (M, Nc)
  int splits, kper;    // K slices (blockIdx.z) of kper columns, a multiple of FC_BK
  float* ws;           // (splits, M, Nc) partials when splits > 1
};

__device__ __forceinline__ void fc_cp16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void fc_wait(int stages) {
  if (stages >= 4)
    cp_async_wait<2>();
  else if (stages == 3)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// acc[i][j] += a[i] . b over 4 k for one column j. ABL (chip_smoke.py's
// ablations, never on the block's path): 1 keeps 4 of the 32 FMAs (each
// loaded vector still read), 2 reads A's vectors and one of W's once a
// step instead of 8 + TN every 4 k (every FMA kept).
// One k at a time over the 8 rows: consecutive FMAs share b's component
// (the operand reuse cache) and update 8 different sums (no dependent
// FMA within 8).
template <int TN, int ABL>
__device__ __forceinline__ void fc_fma(float (&acc)[8][TN], const float4 (&a)[8], float4 b,
                                       int j) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (ABL != 1 || i == j % 8) acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (ABL != 1 || i == j % 8) acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (ABL != 1 || i == j % 8) acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (ABL != 1 || i == j % 8) acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
}

template <int TN, int ABL, int KU = FcTile<TN>::KU>
__global__ void __launch_bounds__(FcTile<TN>::THREADS, FcTile<TN>::BLOCKS_PER_SM)
f32conv_kernel(const __grid_constant__ F32ConvArgs a, const int stages) {
  using L = FcTile<TN>;
  extern __shared__ float4 fc_smem4[];
  float* ring = reinterpret_cast<float*>(fc_smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * FC_BM, n0 = blockIdx.y * FC_BN;
  const int kbeg = blockIdx.z * a.kper, kend = min(a.K, kbeg + a.kper);
  const int nk = (kend - kbeg + FC_BK - 1) / FC_BK;
  const int hw = a.Ho * a.Wo;

  // this thread's copies: 4 k at lc of A rows and W rows lr + ROWS u
  const int lr = tid >> 3, lc = (tid & 7) * 4;
  int am[L::COPIES], ay[L::COPIES], ax[L::COPIES];
#pragma unroll
  for (int u = 0; u < L::COPIES; ++u) {
    const int m = m0 + lr + L::ROWS * u;
    am[u] = m < a.M ? m : -1;
    const int rem = m - (m / hw) * hw;
    ay[u] = rem / a.Wo;
    ax[u] = rem - ay[u] * a.Wo;
  }
  auto fill = [&](int kc, int slot) {
    float* As = ring + slot * FC_STAGE;
    float* Bs = As + FC_BM * FC_LD;
    const int k = kbeg + kc * FC_BK + lc;
    const bool kok = k < kend;
    if (k < a.Kmain) {
      const int tap = k / a.C, c = k - tap * a.C, dy = tap / 3 - 1, dx = tap - (tap / 3) * 3 - 1;
      const long off = ((long)dy * a.Wo + dx) * a.C + c;
#pragma unroll
      for (int u = 0; u < L::COPIES; ++u) {
        const bool ok = kok && am[u] >= 0 && (unsigned)(ay[u] + dy) < (unsigned)a.Ho &&
                        (unsigned)(ax[u] + dx) < (unsigned)a.Wo;
        fc_cp16(As + (lr + L::ROWS * u) * FC_LD + lc,
                ok ? a.act + (long)am[u] * a.C + off : a.act, ok);
      }
    } else {
      const int cp = k - a.Kmain;
      const bool second = cp >= a.c1;
      const float* base = second ? a.p2 : a.p1;
      const int pitch = second ? a.c2 : a.c1, c = second ? cp - a.c1 : cp;
#pragma unroll
      for (int u = 0; u < L::COPIES; ++u) {
        const bool ok = kok && am[u] >= 0;
        fc_cp16(As + (lr + L::ROWS * u) * FC_LD + lc,
                ok ? base + (long)am[u] * pitch + c : a.act, ok);
      }
    }
#pragma unroll
    for (int u = 0; u < L::COPIES; ++u) {
      const int n = n0 + lr + L::ROWS * u;
      const bool ok = kok && n < a.Nc;
      fc_cp16(Bs + (lr + L::ROWS * u) * FC_LD + lc, ok ? a.w + (long)n * a.K + k : a.w, ok);
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int kc = 0; kc < stages - 1; ++kc) {
    if (kc < nk) fill(kc, kc);
    cp_async_commit();
  }
  // the warp's 32 x 8 TN share of the tile: rows 32 wm + lm + 4 i, columns
  // 8 TN wn + ln + 8 j (a column's 4 k at one 16-byte load: 8 lanes on 8
  // padded rows)
  const int lm = lane >> 3, ln = lane & 7, arow = (warp & 3) * 32 + lm;
  const int bcol = (warp >> 2) * 8 * TN + ln;
  int slot = 0, fslot = stages - 1;
  for (int kc = 0; kc < nk; ++kc) {
    // step kc has landed; every thread is past step kc - 1, whose slot the
    // refill below takes
    fc_wait(stages);
    __syncthreads();
    if (kc + stages - 1 < nk) fill(kc + stages - 1, fslot);
    cp_async_commit();
    fslot = fslot + 1 == stages ? 0 : fslot + 1;
    const float* Ar = ring + slot * FC_STAGE + arow * FC_LD;
    const float* Br = ring + slot * FC_STAGE + (FC_BM + bcol) * FC_LD;
    slot = slot + 1 == stages ? 0 : slot + 1;
    float4 av[8], bv[TN];
#pragma unroll KU
    for (int kk = 0; kk < FC_BK; kk += 4) {
      if (ABL != 2 || kk == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          av[i] = *reinterpret_cast<const float4*>(Ar + 4 * i * FC_LD + kk);
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        if (ABL != 2 || (kk == 0 && j == 0))
          bv[ABL == 2 ? 0 : j] = *reinterpret_cast<const float4*>(Br + 8 * j * FC_LD + kk);
        fc_fma<TN, ABL>(acc, av, bv[ABL == 2 ? 0 : j], j);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + arow + 4 * i;
    if (row >= a.M) continue;
    const long o = (long)row * a.Nc;
    const int nimg = row / hw;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + bcol + 8 * j;
      if (col >= a.Nc) continue;
      if (a.splits > 1) {
        a.ws[(long)blockIdx.z * a.M * a.Nc + o + col] = acc[i][j];
        continue;
      }
      float v = acc[i][j];
      if (a.bias != nullptr) v += a.bias[col];
      if (a.temb != nullptr) v += a.temb[(long)nimg * a.Nc + col];
      if (a.resid != nullptr) v += a.resid[o + col];
      a.out[o + col] = v * a.oscale;
    }
  }
}

template <int TN, int ABL>
cudaError_t launch_fc_tile(const F32ConvArgs& a, int mtiles, int ntiles, int stages,
                           cudaStream_t st) {
  using L = FcTile<TN>;
  static const cudaError_t opted = cudaFuncSetAttribute(  // once per process
      f32conv_kernel<TN, ABL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * L::MAX_STAGES * FC_STAGE));
  if (opted != cudaSuccess) return opted;
  f32conv_kernel<TN, ABL><<<dim3(mtiles, ntiles, a.splits), L::THREADS,
                            sizeof(float) * stages * FC_STAGE, st>>>(a, stages);
  return cudaGetLastError();
}

// What launch_f32conv takes: thread tile tn 16 or 8, 2 .. its ring's
// stages, K in `splits` slices of `per` steps of FC_BK (all full but the
// last), channel counts and the seam at multiples of 4 (16-byte copies),
// A's columns 9 C of taps then the projection's c1 + c2 (Kmain = C = 0: a
// GEMM of projection steps alone), partials that fit ws_elems.
bool f32conv_ok(const F32ConvArgs& a, int tn, int stages, int splits, int per, long ws_elems) {
  const int steps = (a.K + FC_BK - 1) / FC_BK;
  const int max_stages = tn == 16 ? FcTile<16>::MAX_STAGES : FcTile<8>::MAX_STAGES;
  return (tn == 16 || tn == 8) && stages >= 2 && stages <= max_stages && splits >= 1 &&
         per >= 1 && (long)(splits - 1) * per < steps && (long)splits * per >= steps &&
         a.C % 4 == 0 && a.c1 % 4 == 0 && a.c2 % 4 == 0 && a.Nc % 4 == 0 && a.K > 0 &&
         a.Kmain == 9 * a.C && a.K == a.Kmain + a.c1 + a.c2 &&
         (splits == 1 || (long)splits * a.M * a.Nc <= ws_elems);
}

// The GEMM on 128 x 128 tiles of 8 x tn outputs a thread (tn 16 or 8) in
// `stages` ring steps, K in `splits` slices of `per` steps of FC_BK, then,
// for a split K, the slices' ordered sum and the epilogue. ablate (tn 16
// only): 0 the kernel, 1 / 2 fc_fma's ablations.
cudaError_t launch_f32conv(F32ConvArgs a, int tn, int stages, int splits, int per, int ablate,
                           long ws_elems, cudaStream_t st) {
  if (!f32conv_ok(a, tn, stages, splits, per, ws_elems) || ablate < 0 || ablate > 2 ||
      (ablate != 0 && tn != 16))
    return cudaErrorInvalidValue;
  a.splits = splits;
  a.kper = per * FC_BK;
  const int mtiles = (a.M + FC_BM - 1) / FC_BM, ntiles = (a.Nc + FC_BN - 1) / FC_BN;
  cudaError_t err;
  if (tn == 8)
    err = launch_fc_tile<8, 0>(a, mtiles, ntiles, stages, st);
  else if (ablate == 1)
    err = launch_fc_tile<16, 1>(a, mtiles, ntiles, stages, st);
  else if (ablate == 2)
    err = launch_fc_tile<16, 2>(a, mtiles, ntiles, stages, st);
  else
    err = launch_fc_tile<16, 0>(a, mtiles, ntiles, stages, st);
  if (err != cudaSuccess || splits == 1) return err;
  GemmArgs e = {};
  e.M = a.M;
  e.Nc = a.Nc;
  e.Ho = a.Ho;
  e.Wo = a.Wo;
  e.bias = a.bias;
  e.temb = a.temb;
  e.has_resid = a.resid != nullptr;
  e.resid = Src{a.resid, nullptr, a.Nc, 0, a.Ho, a.Wo, 1};
  e.oscale = a.oscale;
  e.out = a.out;
  e.out_f32 = 1;
  e.splits = splits;
  e.ws = a.ws;
  const long quads = (long)a.M * a.Nc / 4;
  splitk_epilogue_kernel<float><<<(unsigned)((quads + NT - 1) / NT), NT, 0, st>>>(e);
  return cudaGetLastError();
}

// Whether a GroupNorm pass of C channels in G groups fits the cluster
// kernels' shared scratch (gn_cluster.cuh); the shapes beyond it (none in
// the NCSN++ census) take the one-block-per-group kernels, chosen by shape
// alone.
bool gn_on_cluster(int C, int G) { return C <= GN_MAX_C && G <= GN_MAX_G; }

// GroupNorm + SiLU (+ resample) of x1 | x2 into act (and xs), with stats !=
// nullptr also the groups' (mean, rstd): rb_gn_kernel<float, float>, or
// beyond its scratch gn_apply_kernel (which writes no stats: the backward
// pass of that shape takes its own).
cudaError_t f32_gn(const float* x1, const float* x2, int c1, int c2, int N, int H, int W, int G,
                   const float* gamma, const float* beta, float eps, int resample, float* act,
                   float* xs, float2* stats, cudaStream_t st) {
  if (gn_on_cluster(c1 + c2, G)) {
    const RbGnArgs g = {x1, x2, c1, c2, H, W, G, gamma, beta, eps, resample, act, xs, stats};
    return launch_rb_gn<float, float>(g, N, st);
  }
  const GnArgs g = {Src{x1, x2, c1, c2, H, W, 1}, G, gamma, beta, eps, 1, resample, act, xs};
  return launch_gn_apply<float>(g, N, st);
}

// d(loss)/d(act) at pixel (y, x) of the GN input's grid, read from an fp32
// map on the grid after the block's resample, through the resample's
// transpose.
__device__ __forceinline__ float read_transposed(const Src& s, int resample, int n, int y,
                                                 int x, int c) {
  const long row = (long)n * s.H;
  if (resample == RS_DOWN)  // 2x2 mean -> each input pixel got 1/4 of one output
    return 0.25f * src_load1<float>(s, (row + (y >> 1)) * s.W + (x >> 1), c);
  if (resample == RS_UP) {  // nearest 2x -> the sum of the four copies (JAX's order)
    const long p0 = (row + 2 * y) * s.W + 2 * x, p1 = p0 + s.W;
    return (src_load1<float>(s, p0, c) + src_load1<float>(s, p0 + 1, c)) +
           (src_load1<float>(s, p1, c) + src_load1<float>(s, p1 + 1, c));
  }
  return src_load1<float>(s, (row + y) * s.W + x, c);
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
  float* out0;      // channels [0, oc0), row pitch oc0
  float* out1;      // channels [oc0, C), row pitch C - oc0 (the cat block's dx2)
  int oc0;
  float* dsum;  // (N, C) sum over HW of the output before `add`, or nullptr
};

// GroupNorm + SiLU backward beyond the cluster kernels' scratch, one block
// per (group, example), fp32:
//   xhat = (x - mean) * rstd, y = xhat * gamma + beta,
//   dxhat = d * silu'(y) * gamma,
//   dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),
// the means over the group (JAX _gn_silu_bwd_inkernel :140), its own
// statistics in two passes. Threads [0, nthr) each keep one channel of the
// group (nthr is a multiple of the group's width), so the per-channel sum
// for dtemb needs no atomics.
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
  for (int p = pbeg; p < hw; p += pstep) acc += src_load1<float>(s, pix0 + p, c);
  const float mean = block_sum(acc, red) / cnt;
  acc = 0.f;
  for (int p = pbeg; p < hw; p += pstep) {
    const float v = src_load1<float>(s, pix0 + p, c) - mean;
    acc += v * v;
  }
  const float rstd = rsqrtf(block_sum(acc, red) / cnt + a.eps);
  const float gam = a.gamma[c], bet = a.beta[c];

  // dxhat at pixel p; xh gets xhat
  auto dxhat = [&](int p, float& xh) {
    const int y = p / s.W, x = p - y * s.W;
    xh = (src_load1<float>(s, pix0 + p, c) - mean) * rstd;
    const float yv = xh * gam + bet;
    const float sig = 1.f / (1.f + expf(-yv));
    return read_transposed(a.d, a.resample, n, y, x, c) * (sig * (1.f + yv * (1.f - sig))) * gam;
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
    const float dh = dxhat(p, xh);  // sets xh
    float v = rstd * (dh - m1 - xh * m2);
    csum += v;
    if (a.add.p0 != nullptr) {
      const int y = p / s.W, x = p - y * s.W;
      v += a.add_scale * read_transposed(a.add, a.resample, n, y, x, c);
    }
    const long pix = pix0 + p;
    if (c < a.oc0)
      a.out0[pix * a.oc0 + c] = v;
    else
      a.out1[pix * (C - a.oc0) + (c - a.oc0)] = v;
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

// GroupNorm + SiLU backward of x1 | x2 (H x W) for the cotangent d of its
// activation on the resampled grid, plus add_scale x add (or nothing) through
// the same transpose, split at the seam c1 into out1 | out2, with dsum !=
// nullptr the per-channel sums of the output before the add. The statistics
// come from stats (the recompute's) or, with stats == nullptr, from a round
// of the pass itself. rb_gn_bwd_kernel<float, float>, or beyond its scratch
// gn_silu_bwd_kernel.
cudaError_t f32_gn_bwd(const float* x1, const float* x2, int c1, int c2, int N, int H, int W,
                       int G, const float* gamma, const float* beta, float eps,
                       const float2* stats, const float* d, int resample, const float* add,
                       float add_scale, float* out1, float* out2, float* dsum, cudaStream_t st) {
  const int C = c1 + c2;
  if (gn_on_cluster(C, G)) {
    RbGnBwdArgs b = {};
    b.x1 = x1;
    b.x2 = x2;
    b.c1 = c1;
    b.c2 = c2;
    b.H = H;
    b.W = W;
    b.G = G;
    b.gamma = gamma;
    b.beta = beta;
    b.eps = eps;
    b.stats = stats;
    b.d = d;
    b.resample = resample;
    b.add = add;
    b.add_f32 = 1;  // fp32 in this chain, the identity skip's g too
    b.add_scale = add_scale;
    b.out1 = out1;
    b.out2 = out2;
    b.dsum = dsum;
    return launch_rb_gn_bwd<float, float>(b, N, st);
  }
  if (C / G > NT) return cudaErrorInvalidValue;
  const int Ho = resample == RS_DOWN ? H / 2 : (resample == RS_UP ? H * 2 : H);
  const int Wo = resample == RS_DOWN ? W / 2 : (resample == RS_UP ? W * 2 : W);
  GnBwdArgs b = {};
  b.x = Src{x1, x2, c1, c2, H, W, 1};
  b.d = Src{d, nullptr, C, 0, Ho, Wo, 1};
  b.resample = resample;
  b.G = G;
  b.gamma = gamma;
  b.beta = beta;
  b.eps = eps;
  if (add != nullptr) b.add = Src{add, nullptr, C, 0, Ho, Wo, 1};
  b.add_scale = add_scale;
  b.out0 = out1;
  b.out1 = out2;
  b.oc0 = c1;
  b.dsum = dsum;
  gn_silu_bwd_kernel<<<dim3(G, N), NT, 0, st>>>(b);
  return cudaGetLastError();
}

}  // namespace

namespace dp {

// The fp32 chain (fused_resblock.cu's diffpure_resblock_fwd, dtype 0).
// plan: resblock_f32_plan's 8 ints, (tn, stages, splits, per) of conv0 and
// of conv1.
cudaError_t resblock_fwd_f32(const float* x1, const float* x2, int c1, int c2, int N, int H,
                             int W, int resample, const float* temb, const float* gn1s,
                             const float* gn1b, int g1, const float* w0, const float* b0,
                             const float* gn2s, const float* gn2b, int g2, const float* w1,
                             const float* bias1, int has_proj, int cout, float eps,
                             float oscale, float* act1, float* xs, float* h1, float* act2,
                             float* ws, long ws_elems, float* out, const int* plan,
                             cudaStream_t st) {
  const int cin = c1 + c2;
  const int Ho = resample == RS_DOWN ? H / 2 : (resample == RS_UP ? H * 2 : H);
  const int Wo = resample == RS_DOWN ? W / 2 : (resample == RS_UP ? W * 2 : W);
  if (plan == nullptr || c1 % 4 || c2 % 4 || cout % 4 || g1 < 1 ||
      g2 < 1 || cin % g1 || cout % g2 || (x2 != nullptr && (!has_proj || resample != RS_NONE)) ||
      (!has_proj && cin != cout))
    return cudaErrorInvalidValue;
  cudaError_t err = f32_gn(x1, x2, c1, c2, N, H, W, g1, gn1s, gn1b, eps, resample, act1,
                           resample == RS_NONE ? nullptr : xs, nullptr, st);
  if (err != cudaSuccess) return err;

  F32ConvArgs a0 = {};
  a0.M = N * Ho * Wo;
  a0.Nc = cout;
  a0.K = a0.Kmain = 9 * cin;
  a0.Ho = Ho;
  a0.Wo = Wo;
  a0.C = cin;
  a0.act = act1;
  a0.w = w0;
  a0.bias = b0;
  a0.temb = temb;
  a0.oscale = 1.f;
  a0.out = h1;
  a0.ws = ws;
  if ((err = launch_f32conv(a0, plan[0], plan[1], plan[2], plan[3], 0, ws_elems, st)) !=
      cudaSuccess)
    return err;

  if ((err = f32_gn(h1, nullptr, cout, 0, N, Ho, Wo, g2, gn2s, gn2b, eps, RS_NONE, act2,
                    nullptr, nullptr, st)) != cudaSuccess)
    return err;

  // the skip on the output grid: x1 | x2, or xs (the resampled x)
  const float* s1 = resample == RS_NONE ? x1 : xs;
  F32ConvArgs a1 = a0;
  a1.Kmain = 9 * cout;
  a1.C = cout;
  a1.act = act2;
  if (has_proj) {
    a1.p1 = s1;
    a1.c1 = resample == RS_NONE ? c1 : cin;
    a1.p2 = resample == RS_NONE ? x2 : nullptr;
    a1.c2 = resample == RS_NONE ? c2 : 0;
  }
  a1.K = a1.Kmain + a1.c1 + a1.c2;
  a1.w = w1;
  a1.bias = bias1;
  a1.temb = nullptr;
  a1.resid = has_proj ? nullptr : s1;
  a1.oscale = oscale;
  a1.out = out;
  return launch_f32conv(a1, plan[4], plan[5], plan[6], plan[7], 0, ws_elems, st);
}


// One GEMM of the backward on the output grid (N, Ho, Wo): out[M, nout] =
// A[M, 9 C] W[nout, 9 C]^T * scale, A the 3x3 taps of act (C channels).
F32ConvArgs bwd_gemm(int N, int Ho, int Wo, int C, const float* act, const float* w, int nout,
                     float scale, float* out, float* ws) {
  F32ConvArgs a = {};
  a.M = N * Ho * Wo;
  a.Nc = nout;
  a.K = a.Kmain = 9 * C;
  a.Ho = Ho;
  a.Wo = Wo;
  a.C = C;
  a.act = act;
  a.w = w;
  a.oscale = scale;
  a.out = out;
  a.ws = ws;
  return a;
}

// The fp32 backward chain (fused_resblock_bwd.cu's diffpure_resblock_bwd,
// dtype 0), the steps of the note above. plan: resblock_bwd_f32_plan's 16
// ints, (tn, stages, splits, per) of conv0's recompute, conv1^T, conv0^T
// and the skip adjoint (zeros for an identity skip). gn1_stats: (N, g1)
// scratch for GN1's (mean, rstd). Every GEMM's plan is checked before the
// first launch.
cudaError_t resblock_bwd_f32(const float* x1, const float* x2, int c1, int c2, int N, int H,
                             int W, int resample, const float* temb, const float* g,
                             const float* gn1s, const float* gn1b, int g1, const float* w0,
                             const float* b0, const float* gn2s, const float* gn2b, int g2,
                             const float* w1t, const float* w0t, const float* wskipt, int cout,
                             float eps, float oscale, float* act1, float* h1, float* da2,
                             float* dc1, float* dh, float* dskip, float* ws, long ws_elems,
                             float* dx1, float* dx2, float* dtemb, float2* gn1_stats,
                             const int* plan, cudaStream_t st) {
  const int cin = c1 + c2;
  const int Ho = resample == RS_DOWN ? H / 2 : (resample == RS_UP ? H * 2 : H);
  const int Wo = resample == RS_DOWN ? W / 2 : (resample == RS_UP ? W * 2 : W);
  const bool proj = wskipt != nullptr;
  if (plan == nullptr || c1 % 4 || c2 % 4 || cout % 4 || g1 < 1 || g2 < 1 || cin % g1 ||
      cout % g2 || (x2 != nullptr && (!proj || resample != RS_NONE)) || (!proj && cin != cout))
    return cudaErrorInvalidValue;
  // conv0's recompute, conv1^T, conv0^T (cin crosses the seam) and the
  // skip adjoint (projection steps alone; act = g only as the copies'
  // source where they fill zeros), each checked before the first launch
  F32ConvArgs a[4];
  a[0] = bwd_gemm(N, Ho, Wo, cin, act1, w0, cout, 1.f, h1, ws);
  a[1] = bwd_gemm(N, Ho, Wo, cout, g, w1t, cout, oscale, da2, ws);
  a[2] = bwd_gemm(N, Ho, Wo, cout, dc1, w0t, cin, 1.f, dh, ws);
  a[3] = bwd_gemm(N, Ho, Wo, 0, g, wskipt, cin, oscale, dskip, ws);
  a[0].bias = b0;
  a[0].temb = temb;
  a[3].p1 = g;
  a[3].c1 = cout;
  a[3].K = cout;
  const int* p = plan;
  for (int i = 0; i < (proj ? 4 : 3); ++i)
    if (!f32conv_ok(a[i], p[4 * i], p[4 * i + 1], p[4 * i + 2], p[4 * i + 3], ws_elems))
      return cudaErrorInvalidValue;

  // 1-2: recompute h1 = conv0(resample(SiLU(GN1(x)))) + b0 + temb, as the
  // forward, keeping GN1's statistics
  cudaError_t err = f32_gn(x1, x2, c1, c2, N, H, W, g1, gn1s, gn1b, eps, resample, act1, nullptr,
                           gn1_stats, st);
  if (err != cudaSuccess ||
      (err = launch_f32conv(a[0], p[0], p[1], p[2], p[3], 0, ws_elems, st)) != cudaSuccess)
    return err;
  // 3: d_a2 = conv1^T(g) * oscale
  if ((err = launch_f32conv(a[1], p[4], p[5], p[6], p[7], 0, ws_elems, st)) != cudaSuccess)
    return err;
  // 4: through SiLU(GN2(h1)): d_c1 and dtemb
  if ((err = f32_gn_bwd(h1, nullptr, cout, 0, N, Ho, Wo, g2, gn2s, gn2b, eps, nullptr, da2,
                        RS_NONE, nullptr, 0.f, dc1, nullptr, dtemb, st)) != cudaSuccess)
    return err;
  // 5: d_h = conv0^T(d_c1); 6: the skip adjoint g wskip^T * oscale
  if ((err = launch_f32conv(a[2], p[8], p[9], p[10], p[11], 0, ws_elems, st)) != cudaSuccess ||
      (proj && (err = launch_f32conv(a[3], p[12], p[13], p[14], p[15], 0, ws_elems, st)) !=
                   cudaSuccess))
    return err;
  // 7: dx = GN1+SiLU backward of resample^T(d_h) + resample^T(the skip
  // adjoint, or g * oscale for an identity skip), split at the seam
  return f32_gn_bwd(x1, x2, c1, c2, N, H, W, g1, gn1s, gn1b, eps, gn1_stats, dh, resample,
                    proj ? dskip : g, proj ? 1.f : oscale, dx1, dx2, nullptr, st);
}

}  // namespace dp

extern "C" {

// The fp32 3x3 SAME conv of the chain alone, for chip_smoke.py's timings
// and ablations (on no path of the port): out (N, H, W, cout) = conv(act
// (N, H, W, C), w (cout, 9 C)), no bias, on the 8 x tn thread tile, K in
// splits slices of per steps. ablate (tn 16): 0 the kernel, 1 one FMA in
// eight, 2 the shared-memory reads once a step. Returns a cudaError_t.
int diffpure_f32conv(const float* act, int N, int H, int W, int C, const float* w, int cout,
                     float* out, float* ws, long ws_elems, int tn, int stages, int splits,
                     int per, int ablate, void* stream) {
  F32ConvArgs a = {};
  a.M = N * H * W;
  a.Nc = cout;
  a.K = a.Kmain = 9 * C;
  a.Ho = H;
  a.Wo = W;
  a.C = C;
  a.act = act;
  a.w = w;
  a.oscale = 1.f;
  a.out = out;
  a.ws = ws;
  return launch_f32conv(a, tn, stages, splits, per, ablate, ws_elems,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
