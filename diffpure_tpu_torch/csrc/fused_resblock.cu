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
// than an SM's 227 KB of shared memory. As built here (measured on an H100
// at 700 W), the GEMM's K-steps wait on L2 latency: one step of prefetch,
// 2 blocks per SM; the 32x32 block runs at about 24 TFLOP/s in bf16.
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
//      folded in as extra K columns (x or xs against wskip), and an epilogue
//      adding b1 + bskip or the identity skip, times 1/sqrt(2).
// The concat input is never written out. The
// activations are, once each: normalising inside the conv's A loader
// recomputed GN + SiLU for every one of the 9 taps and left the tensor
// cores waiting on expf (measured: 82% of the evaluation in the GEMM at
// 17 TFLOP/s). The 4x4 and 8x8 levels give grids of 8-32 tiles, too
// few for 132 SMs: there the GEMM splits K across blocks and a second pass
// sums the fp32 partials in order (common.cuh launch_gemm). Operands are
// rounded to the compute dtype on the way in; bf16 products run on the
// tensor cores (mma.sync, fp32 accumulate), fp32 ones as plain fp32 FMAs
// (never TF32).
#include "common.cuh"

using namespace dp;

template <typename T>
static cudaError_t resblock_fwd(const void* x1, const void* x2, int c1, int c2, int N,
                                int H, int W, int resample, const void* temb,
                                const float* gn1s, const float* gn1b, int g1, const void* w0,
                                const float* b0, const float* gn2s, const float* gn2b, int g2,
                                const void* w1, const float* bias1, int has_proj, int cout,
                                float eps, float oscale, void* act1, void* xs, float* h1,
                                void* act2, float* ws, long ws_elems, void* out,
                                cudaStream_t st) {
  const int cin = c1 + c2;
  const int Ho = resample == RS_DOWN ? H / 2 : (resample == RS_UP ? H * 2 : H);
  const int Wo = resample == RS_DOWN ? W / 2 : (resample == RS_UP ? W * 2 : W);
  const Src x = {x1, x2, c1, c2, H, W, 0};
  // the skip branch's input on the output grid: x itself, or its resample
  // written by the GN1 pass
  const Src skip = resample == RS_NONE ? x : Src{xs, nullptr, cin, 0, Ho, Wo, 0};
  const GnArgs gn1 = {x, g1, gn1s, gn1b, eps, 1, resample, act1,
                      resample == RS_NONE ? nullptr : xs};
  cudaError_t err = launch_gn_apply<T>(gn1, N, st);
  if (err != cudaSuccess) return err;

  GemmArgs a0 = {};
  a0.M = N * Ho * Wo;
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

  const GnArgs gn2 = {Src{h1, nullptr, cout, 0, Ho, Wo, 1}, g2, gn2s, gn2b, eps, 1,
                      RS_NONE, act2, nullptr};
  if ((err = launch_gn_apply<T>(gn2, N, st)) != cudaSuccess) return err;

  GemmArgs a1 = {};
  a1.M = N * Ho * Wo;
  a1.Nc = cout;
  a1.Kmain = 9 * cout;
  a1.K = a1.Kmain + (has_proj ? cin : 0);
  a1.Ho = Ho;
  a1.Wo = Wo;
  a1.taps = 9;
  a1.src = Src{act2, nullptr, cout, 0, Ho, Wo, 0};
  a1.proj = skip;
  a1.w = w1;
  a1.bias = bias1;
  a1.has_resid = !has_proj;  // identity skip (cin == cout)
  a1.resid = skip;
  a1.oscale = oscale;
  a1.out = out;
  a1.out_f32 = 0;
  return launch_gemm<T>(a1, ws, ws_elems, st);
}

extern "C" {

// dtype: 0 fp32, 1 bf16. x2 == NULL and c2 == 0 for a single input.
// resample: 0 none, 1 down, 2 up. w0 is (cout, 9*cin); w1 is (cout, 9*cout
// [+ cin]) with the 1x1 projection's columns last when has_proj; column
// (3*dy + dx)*C + c is tap (dy, dx) of input channel c. bias1 = b1 + bskip.
// Scratch: act1 (N, Ho, Wo, cin), xs (the same, only read when resample != 0)
// and act2 (N, Ho, Wo, cout) in the compute dtype, h1 (N, Ho, Wo, cout)
// fp32, ws (ws_elems fp32) for split-K partials.
// Returns cudaGetLastError() of the first failing launch.
int diffpure_resblock_fwd(int dtype, const void* x1, const void* x2, int c1, int c2, int N,
                          int H, int W, int resample, const void* temb, const float* gn1s,
                          const float* gn1b, int g1, const void* w0, const float* b0,
                          const float* gn2s, const float* gn2b, int g2, const void* w1,
                          const float* bias1, int has_proj, int cout, float eps,
                          float oscale, void* act1, void* xs, float* h1, void* act2,
                          float* ws, long ws_elems, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return resblock_fwd<bf16>(x1, x2, c1, c2, N, H, W, resample, temb, gn1s, gn1b, g1, w0,
                              b0, gn2s, gn2b, g2, w1, bias1, has_proj, cout, eps, oscale,
                              act1, xs, h1, act2, ws, ws_elems, out, st);
  return resblock_fwd<float>(x1, x2, c1, c2, N, H, W, resample, temb, gn1s, gn1b, g1, w0,
                             b0, gn2s, gn2b, g2, w1, bias1, has_proj, cout, eps, oscale,
                             act1, xs, h1, act2, ws, ws_elems, out, st);
}

const char* diffpure_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
