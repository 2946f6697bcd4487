// Fused normalise + SiLU + 3x3 SAME conv (+ identity or projected skip) for
// the large maps of the 256-px UNets, bf16 or fp32 NHWC maps.
//
// Replaces the TPU kernel diffpure_tpu/ops/halo_conv.py:168
// gn_silu_conv3x3_halo_pallas (_halo_conv_kernel :73):
//   out = conv3x3(silu(x * A + B), w) + bias [+ skip | + skip @ w_proj]
// with A, B the per-(example, channel) affine of the GroupNorm stats pass
// (tiled_groupnorm.cu), GN scale/bias and FiLM already folded in. SAME
// padding pads the activation: window positions outside the image are 0
// after the activation (silu(0 * A + B) is not 0).
//
// What bounds it on this card: the products. At the ImageNet-256 shapes a
// call is 2 * 9 * cin * cout multiply-adds per pixel (0.3 TFLOP for a
// 256^2 x 256 -> 256 conv at batch 4) against ~0.3 GB moved: about 1000
// operations per byte, far above the card's ~295 (bf16), so a fast
// version is a tensor-core GEMM with its operands staged well.
//
// What the design does: one launch computes the whole function and never
// writes the activation to device memory. A block owns an output tile of
// TR x TC pixels and HBN output channels. For each chunk of HBK input
// channels it stages the (TR+2) x (TC+2) halo window of x in shared memory,
// applying x * A + B and SiLU there once per element (rounded to the compute
// dtype, as the TPU kernel's pad scratch is); the nine taps then read
// shifted views of that one window, so nothing is normalised nine times.
// The skip projection runs as extra K chunks on the same accumulator, its
// source staged at the window's centre and read by the centre tap only; the
// bias and an identity skip are added in the epilogue, and the result is
// rounded once to the output dtype. bf16: mma.sync m16n8k16 (fp32
// accumulate), weights double-buffered by cp.async, and the next chunk's
// raw window loaded into registers while this chunk's products run. fp32:
// the same tiling on the FMA units (full fp32, never TF32), single-buffered.
// The TPU kernel's whole-row tiles and manual double-buffered DMA exist
// because BlockSpecs cannot overlap; here each block simply reads its halo.
#include "common.cuh"

using namespace dp;

namespace {

constexpr int TR = 4, TC = 32;           // output tile: TR rows x TC columns
constexpr int WR = TR + 2, WC = TC + 2;  // halo window
constexpr int WPIX = WR * WC;            // 204 window pixels
constexpr int HBN = 64;                  // output channels per block
constexpr int HBK = 32;                  // input channels per K chunk
constexpr int WIN_QUADS = WPIX * HBK / 4;
constexpr int QPT = (WIN_QUADS + NT - 1) / NT;  // window quads per thread
static_assert(QPT <= 32, "validity mask is one word");

struct HaloArgs {
  const void* x;  // (N, H, W, cin) in T
  int N, H, W, cin;
  const float* A;  // (N, cin)
  const float* B;
  const void* w;  // bf16: (cout, 9 * cin), [n][tap][c]; fp32: (9 * cin, cout)
  const float* bias;  // (cout)
  const void* skip;   // (N, H, W, cr) in T, or nullptr
  int cr, has_proj;
  const void* wproj;  // bf16: (cout, cr); fp32: (cr, cout)
  int cout;
  void* out;  // (N, H, W, cout) in T
};

struct TileCoord {
  int y0, x0, n0, n, nconv, nchunks;
  __device__ TileCoord(const HaloArgs& a) {
    const int tiles_x = a.W / TC;
    y0 = (blockIdx.x / tiles_x) * TR;
    x0 = (blockIdx.x % tiles_x) * TC;
    n0 = blockIdx.y * HBN;
    n = blockIdx.z;
    nconv = a.cin / HBK;
    nchunks = nconv + (a.has_proj ? a.cr / HBK : 0);
  }
};

// Where window quad e (pixel e / 8, channels (e % 8) * 4..) of chunk j
// reads from, or nullptr where the window holds 0: outside the image for a
// conv chunk, outside the tile for a projection chunk.
template <typename T>
__device__ __forceinline__ const T* window_src(const HaloArgs& a, const TileCoord& tc, int j,
                                               int e) {
  const int pix = e >> 3, kq = e & 7;
  const int wr = pix / WC, wc = pix - wr * WC;
  const int yy = tc.y0 - 1 + wr, xx = tc.x0 - 1 + wc;
  const long p = ((long)tc.n * a.H + yy) * a.W + xx;
  if (j < tc.nconv) {
    if (yy < 0 || yy >= a.H || xx < 0 || xx >= a.W) return nullptr;
    return static_cast<const T*>(a.x) + p * a.cin + j * HBK + kq * 4;
  }
  if (wr < 1 || wr > TR || wc < 1 || wc > TC) return nullptr;
  return static_cast<const T*>(a.skip) + p * a.cr + (j - tc.nconv) * HBK + kq * 4;
}

// The window value of quad e of chunk j from its raw value v: the
// activation silu(v * A + B) for a conv chunk, v itself for a projection.
__device__ __forceinline__ float4 window_value(const HaloArgs& a, const TileCoord& tc, int j,
                                               int e, float4 v) {
  if (j >= tc.nconv) return v;
  const int c = j * HBK + (e & 7) * 4;
  const float4 s = load4(a.A + (long)tc.n * a.cin + c), b = load4(a.B + (long)tc.n * a.cin + c);
  return make_float4(silu(v.x * s.x + b.x), silu(v.y * s.y + b.y), silu(v.z * s.z + b.z),
                     silu(v.w * s.w + b.w));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// ---------------------------------------------------------------------------
// bf16: 8 warps, warp (wm, wn) owns tile row wm (32 pixels) x 32 output
// channels = 2 x 4 mma tiles of 16 x 8.
// ---------------------------------------------------------------------------

constexpr int PITCH = HBK + 8;  // bf16 row pitch: 80 bytes, conflict-free fragment reads
constexpr int WIN_ELEMS = WPIX * PITCH;
constexpr int WSLAB = HBN * PITCH;  // one tap's weights
constexpr size_t BF16_SMEM = (size_t)(WIN_ELEMS + 2 * 9 * WSLAB) * sizeof(bf16);

__global__ void __launch_bounds__(NT, 2) halo_bf16_kernel(const __grid_constant__ HaloArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* win = reinterpret_cast<bf16*>(smem);
  bf16* Ws = win + WIN_ELEMS;  // [2][9][HBN][PITCH]
  const TileCoord tc(a);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int wm = warp >> 1, wn = (warp & 1) * 32;

  uint2 raw[QPT];
  unsigned valid = 0;
  auto load_raw = [&](int j) {
    valid = 0;
#pragma unroll
    for (int s = 0; s < QPT; ++s) {
      raw[s] = make_uint2(0u, 0u);
      const int e = tid + s * NT;
      if (e >= WIN_QUADS) continue;
      const bf16* p = window_src<bf16>(a, tc, j, e);
      if (p == nullptr) continue;
      raw[s] = *reinterpret_cast<const uint2*>(p);
      valid |= 1u << s;
    }
  };
  auto store_window = [&](int j) {
#pragma unroll
    for (int s = 0; s < QPT; ++s) {
      const int e = tid + s * NT;
      if (e >= WIN_QUADS) continue;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid & (1u << s)) {
        const uint2 u = raw[s];
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
        v = window_value(a, tc, j, e, make_float4(lo.x, lo.y, hi.x, hi.y));
      }
      store4(win + (e >> 3) * PITCH + (e & 7) * 4, v);
    }
  };
  auto issue_weights = [&](int j, int buf) {
    bf16* dst = Ws + buf * 9 * WSLAB;
    if (j < tc.nconv) {
      const bf16* w = static_cast<const bf16*>(a.w);
      const long rowlen = 9L * a.cin;
      for (int i = tid; i < 9 * HBN * 4; i += NT) {
        const int q = i & 3, row = i >> 2, tap = row / HBN, nn = row - tap * HBN;
        cp_async16(dst + row * PITCH + q * 8,
                   w + (long)(tc.n0 + nn) * rowlen + tap * a.cin + j * HBK + q * 8);
      }
    } else {
      const bf16* w = static_cast<const bf16*>(a.wproj);
      for (int i = tid; i < HBN * 4; i += NT) {
        const int q = i & 3, nn = i >> 2;
        cp_async16(dst + nn * PITCH + q * 8,
                   w + (long)(tc.n0 + nn) * a.cr + (j - tc.nconv) * HBK + q * 8);
      }
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  issue_weights(0, 0);
  cp_async_commit();
  load_raw(0);
  for (int j = 0; j < tc.nchunks; ++j) {
    const int buf = j & 1;
    __syncthreads();  // the previous chunk's products are done with win and Ws[buf ^ 1]
    store_window(j);
    if (j + 1 < tc.nchunks) issue_weights(j + 1, buf ^ 1);
    cp_async_commit();
    if (j + 1 < tc.nchunks) load_raw(j + 1);  // in flight during this chunk's products
    cp_async_wait<1>();  // this chunk's weights have landed
    __syncthreads();     // ... for every thread, and the window is written
    const bool conv = j < tc.nconv;
    const int tap0 = conv ? 0 : 4, tap1 = conv ? 9 : 5;
    for (int tap = tap0; tap < tap1; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const bf16* wsl = Ws + (buf * 9 + (conv ? tap : 0)) * WSLAB;
#pragma unroll
      for (int ks = 0; ks < HBK; ks += 16) {
        uint32_t af[2][4], bfr[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const bf16* p0 = win + ((wm + dy) * WC + mi * 16 + g + dx) * PITCH + ks + t2;
          const bf16* p1 = p0 + 8 * PITCH;
          af[mi][0] = lds32(p0);
          af[mi][1] = lds32(p1);
          af[mi][2] = lds32(p0 + 8);
          af[mi][3] = lds32(p1 + 8);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const bf16* q = wsl + (wn + ni * 8 + g) * PITCH + ks + t2;
          bfr[ni][0] = lds32(q);
          bfr[ni][1] = lds32(q + 8);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni]);
      }
    }
  }
  cp_async_wait<0>();

  const bool identity = a.skip != nullptr && !a.has_proj;
  const int yy = tc.y0 + wm;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = tc.n0 + wn + ni * 8 + t2;
      const float b0 = a.bias[col], b1 = a.bias[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long p = ((long)tc.n * a.H + yy) * a.W + tc.x0 + mi * 16 + g + h * 8;
        float v0 = acc[mi][ni][2 * h] + b0, v1 = acc[mi][ni][2 * h + 1] + b1;
        if (identity) {
          const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              static_cast<const bf16*>(a.skip) + p * a.cout + col));
          v0 += r.x;
          v1 += r.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.out) + p * a.cout + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
}

// ---------------------------------------------------------------------------
// fp32: thread (ty, tx) owns 8 consecutive pixels of one tile row (ty / 4,
// columns (ty % 4) * 8..) x 4 output channels (tx * 4..); window and weights
// in shared memory, 4 channels per step as float4 reads.
// ---------------------------------------------------------------------------

constexpr int FPITCH = HBK + 4;  // fp32 window pitch (16-byte rows)
constexpr size_t F32_SMEM = (size_t)(WPIX * FPITCH + 9 * HBK * HBN) * sizeof(float);

__global__ void __launch_bounds__(NT, 2) halo_f32_kernel(const __grid_constant__ HaloArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* win = reinterpret_cast<float*>(smem);  // [WPIX][FPITCH]
  float* Ws = win + WPIX * FPITCH;              // [9][HBK][HBN]
  const TileCoord tc(a);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r = ty / 4, c0 = (ty % 4) * 8;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

  for (int j = 0; j < tc.nchunks; ++j) {
    __syncthreads();  // the previous chunk's products are done with win and Ws
    for (int e = tid; e < WIN_QUADS; e += NT) {
      const float* p = window_src<float>(a, tc, j, e);
      const float4 v = p != nullptr ? window_value(a, tc, j, e, load4(p))
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
      store4(win + (e >> 3) * FPITCH + (e & 7) * 4, v);
    }
    const bool conv = j < tc.nconv;
    if (conv) {
      const float* w = static_cast<const float*>(a.w);
      for (int i = tid; i < 9 * HBK * HBN / 4; i += NT) {
        const int q = i % (HBN / 4), row = i / (HBN / 4), tap = row / HBK, k = row - tap * HBK;
        cp_async16(Ws + row * HBN + q * 4,
                   w + ((long)tap * a.cin + j * HBK + k) * a.cout + tc.n0 + q * 4);
      }
    } else {
      const float* w = static_cast<const float*>(a.wproj);
      for (int i = tid; i < HBK * HBN / 4; i += NT) {
        const int q = i % (HBN / 4), k = i / (HBN / 4);
        cp_async16(Ws + k * HBN + q * 4,
                   w + ((long)(j - tc.nconv) * HBK + k) * a.cout + tc.n0 + q * 4);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int tap0 = conv ? 0 : 4, tap1 = conv ? 9 : 5;
    for (int tap = tap0; tap < tap1; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const float* wsl = Ws + (conv ? tap : 0) * HBK * HBN + tx * 4;
      const float* wrow = win + ((r + dy) * WC + c0 + dx) * FPITCH;
      for (int k = 0; k < HBK; k += 4) {
        float4 wv[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wv[kk] = *reinterpret_cast<const float4*>(wsl + (k + kk) * HBN);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 av = *reinterpret_cast<const float4*>(wrow + i * FPITCH + k);
          const float ak[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            acc[i][0] = fmaf(ak[kk], wv[kk].x, acc[i][0]);
            acc[i][1] = fmaf(ak[kk], wv[kk].y, acc[i][1]);
            acc[i][2] = fmaf(ak[kk], wv[kk].z, acc[i][2]);
            acc[i][3] = fmaf(ak[kk], wv[kk].w, acc[i][3]);
          }
        }
      }
    }
  }

  const bool identity = a.skip != nullptr && !a.has_proj;
  const int col = tc.n0 + tx * 4;
  const float4 b = load4(a.bias + col);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long p = ((long)tc.n * a.H + tc.y0 + r) * a.W + tc.x0 + c0 + i;
    float4 v = make_float4(acc[i][0] + b.x, acc[i][1] + b.y, acc[i][2] + b.z, acc[i][3] + b.w);
    if (identity) {
      const float4 s = load4(static_cast<const float*>(a.skip) + p * a.cout + col);
      v.x += s.x; v.y += s.y; v.z += s.z; v.w += s.w;
    }
    store4(static_cast<float*>(a.out) + p * a.cout + col, v);
  }
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16. x (N, H, W, cin); A, B (N, cin) fp32; w and wproj
// packed as HaloArgs says; bias (cout) fp32; skip (N, H, W, cr) or NULL,
// with wproj NULL for an identity skip (cr == cout); out (N, H, W, cout).
// Requires H % 4 == 0, W % 32 == 0, cin % 32 == 0, cr % 32 == 0 and
// cout % 64 == 0 (the wrapper checks). Returns cudaGetLastError().
int diffpure_halo_conv(int dtype, const void* x, int N, int H, int W, int cin, const float* A,
                       const float* B, const void* w, const float* bias, const void* skip, int cr,
                       const void* wproj, int cout, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  HaloArgs a;
  a.x = x;
  a.N = N;
  a.H = H;
  a.W = W;
  a.cin = cin;
  a.A = A;
  a.B = B;
  a.w = w;
  a.bias = bias;
  a.skip = skip;
  a.cr = cr;
  a.has_proj = skip != nullptr && wproj != nullptr;
  a.wproj = wproj;
  a.cout = cout;
  a.out = out;
  const dim3 grid((H / TR) * (W / TC), cout / HBN, N);
  cudaError_t err;
  if (dtype == 1) {
    if ((err = cudaFuncSetAttribute(halo_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)BF16_SMEM)) != cudaSuccess)
      return err;
    halo_bf16_kernel<<<grid, NT, BF16_SMEM, st>>>(a);
  } else {
    if ((err = cudaFuncSetAttribute(halo_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)F32_SMEM)) != cudaSuccess)
      return err;
    halo_f32_kernel<<<grid, NT, F32_SMEM, st>>>(a);
  }
  return cudaGetLastError();
}

}  // extern "C"
