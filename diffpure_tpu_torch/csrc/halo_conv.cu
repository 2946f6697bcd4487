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
// version is a tensor-core GEMM with its operands staged well. Within the
// block the weights are the scarce operand: each 64 x BN stage feeds only
// the tile's ROWS x 32 pixels, so at the large shapes the stream of weight
// stages from L2, not the tensor cores, sets this kernel's pace (a cluster
// multicasting each stage to two blocks would halve it).
//
// bf16 (halo_wgmma_kernel): an implicit GEMM on wgmma. A block owns an
// output tile of ROWS x 32 pixels (ROWS = 4 or 2) and BN output channels
// (256 or 128); ops/halo_conv.py:halo_plan picks the tile per shape so
// that the grid fills the card's SMs. K runs as (64-channel chunk, tap), the
// projection's chunks after the conv's as extra K on the same accumulator.
// Three warpgroups:
//   - warp 0 of the producer warpgroup streams the weights: one 64 x BN
//     stage per (chunk, tap), a single TMA bulk copy each, into a ring of 3
//     (BN = 256) or 5 stages on mbarriers. pack_halo_weights stores them
//     already in the 128-byte swizzle that wgmma's shared-memory descriptor
//     reads, so no tensor map is needed;
//   - warps 1-3 activate the window: each chunk's raw (ROWS+2) x 34-pixel
//     x 64-channel halo box comes by one 4-D TMA copy (zeros outside the
//     map) into a double-buffered raw window, two chunks ahead; they
//     activate it once per block into a double-buffered window (rounded
//     once to bf16; 0 outside the image) and hand it over on an mbarrier.
//     With BN = 256 each window element is activated once per 256 output
//     channels (the mma.sync kernel this replaces did it once per 64);
//   - two consumer warpgroups (64 pixels x BN, or all ROWS x 32 pixels x
//     BN / 2 each) run wgmma m64nNk16 with fp32 accumulators.
// The kernel is persistent: one block per SM walks the tiles, and the rings
// run on from tile to tile, so the next tile's weights and window load while
// this tile's epilogue stores.
// The activated window cannot be a wgmma shared-memory operand: a tap's
// dx = +-1 shift starts the tile one row into an 8-row core matrix. So A
// comes from registers (route (a)): each warp ldmatrix-es its 16 pixel rows
// at any shift from one window whose 144-byte row pitch keeps ldmatrix
// free of bank conflicts. Three copies of the window (route (b)) would
// cost 3x the activation and shared memory. A's registers rotate over 3
// buffers, so one tap's wgmmas run while the next tap's fragments load.
// Epilogue: bias plus an identity skip, rounded once to bf16, stored from
// the accumulators.
//
// fp32 (halo_f32_kernel): the same tile walk on the FMA units (full fp32,
// never TF32), 4 x 32 pixels x 64 channels per block, single-buffered; it
// runs at about half its bound and is left as it is.
// The TPU kernel's whole-row tiles and manual double-buffered DMA exist
// because BlockSpecs cannot overlap; here each block simply reads its halo.
#include "common.cuh"
#include "hopper.cuh"

using namespace dp;

namespace {

constexpr int TR = 4, TC = 32;           // fp32 output tile: TR rows x TC columns
constexpr int WR = TR + 2, WC = TC + 2;  // its halo window
constexpr int WPIX = WR * WC;            // 204 window pixels
constexpr int HBN = 64;                  // output channels per block
constexpr int HBK = 32;                  // input channels per K chunk
constexpr int WIN_QUADS = WPIX * HBK / 4;

struct HaloArgs {
  const void* x;  // (N, H, W, cin) in T
  int N, H, W, cin;
  const float* A;  // (N, cin)
  const float* B;
  const void* w;  // bf16: (steps, cout, 64) swizzled; fp32: (9 * cin, cout)
  const float* bias;  // (cout)
  const void* skip;   // (N, H, W, cr) in T, or nullptr
  int cr, has_proj;
  const void* wproj;  // bf16: the projection's steps of w; fp32: (cr, cout)
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
// bf16: wgmma + TMA, warp-specialised (see the note at the top).
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int KC = 64;           // input channels per K chunk: one 128-byte row
constexpr int APITCH = KC + 8;   // activated window pitch (bf16): 144 bytes
constexpr int ACT_THREADS = 96;  // warps 1-3 activate the window
constexpr int PRODUCER_REGS = 72, CONSUMER_REGS = 216;

template <int ROWS, int BN> struct HaloTile {
  static constexpr int WROWS = ROWS + 2, WCOLS = TC + 2, WPIXELS = WROWS * WCOLS;
  static constexpr int BNW = ROWS == 4 ? BN : BN / 2;  // channels per consumer warpgroup
  static constexpr int STAGES = BN == 256 ? 3 : 5;     // weight ring, one (chunk, tap) each
  static constexpr int STAGE = BN * KC;                // bf16 elements per weight stage
  static constexpr int ACT = WPIXELS * APITCH;
  static constexpr int RAW = WPIXELS * KC;  // one TMA box: (ROWS + 2) x 34 pixels x 64
  static constexpr size_t SMEM = 1024 +
                                 (size_t)(STAGES * STAGE + 2 * ACT + 2 * RAW) * sizeof(bf16) +
                                 (2 * STAGES + 6) * sizeof(uint64_t);
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// silu(v * s + b) of 8 bf16 channels, rounded to bf16.
__device__ __forceinline__ uint4 activate8(uint4 v, const float (&s)[8], const float (&b)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  uint32_t o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    const float u0 = fmaf(f.x, s[2 * k], b[2 * k]), u1 = fmaf(f.y, s[2 * k + 1], b[2 * k + 1]);
    o[k] = pack_bf16x2(__fdividef(u0, 1.f + __expf(-u0)), __fdividef(u1, 1.f + __expf(-u1)));
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// One output tile: example n, pixels (y0.., x0..), channels n0.. The tiles
// of one channel block are consecutive, so the blocks on the card at a time
// share their weights in L2.
struct HaloTileCoord {
  int n, y0, x0, n0;
};

template <int ROWS>
__device__ __forceinline__ HaloTileCoord halo_tile(const HaloArgs& a, int tile, int BN) {
  const int tiles_x = a.W / TC, tiles_y = a.H / ROWS, mtiles = a.N * tiles_y * tiles_x;
  int m = tile % mtiles;
  HaloTileCoord c;
  c.n0 = (tile / mtiles) * BN;
  c.x0 = (m % tiles_x) * TC;
  m /= tiles_x;
  c.y0 = (m % tiles_y) * ROWS;
  c.n = m / tiles_y;
  return c;
}

// tx: x as (N, H, W, cin) in boxes of (ROWS + 2) x 34 pixels x 64 channels;
// tskip the same over the projected skip (N, H, W, cr).
template <int ROWS, int BN>
__global__ void __launch_bounds__(WG_THREADS, 1)
    halo_wgmma_kernel(const __grid_constant__ HaloArgs a, const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tskip) {
  using L = HaloTile<ROWS, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* ring = reinterpret_cast<bf16*>(base);  // [STAGES][BN][KC], 128-byte swizzle
  bf16* act = ring + L::STAGES * L::STAGE;     // [2][WPIXELS][APITCH]
  bf16* raw = act + 2 * L::ACT;                // [2][WPIXELS][KC]
  uint64_t* full = reinterpret_cast<uint64_t*>(raw + 2 * L::RAW);
  uint64_t* empty = full + L::STAGES;
  uint64_t* raw_full = empty + L::STAGES;
  uint64_t* win_full = raw_full + 2;
  uint64_t* win_empty = win_full + 2;

  const int ntiles = a.N * (a.H / ROWS) * (a.W / TC) * (a.cout / BN);
  const int nconv = a.cin / KC, nproj = a.has_proj ? a.cr / KC : 0;
  const int nchunks = nconv + nproj;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&raw_full[b], 1);
      mbar_init(&win_full[b], ACT_THREADS);
      mbar_init(&win_empty[b], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Persistent: block b takes tiles b, b + gridDim.x, ... The rings' counters
  // run on across tiles, so the next tile's weights and window load while
  // this tile's epilogue stores.
  if (tid < 128) {
    // ---- producer warpgroup ----
    reg_dealloc<PRODUCER_REGS>();
    if (tid == 0) {
      // weight step `it` of a tile is (chunk it / 9, tap it % 9), then the
      // projection's chunks: the order the consumers take them and the pack's
      const bf16* w = static_cast<const bf16*>(a.w);
      const int steps = 9 * nconv + nproj;
      int g = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int n0 = halo_tile<ROWS>(a, tile, BN).n0;
        for (int it = 0; it < steps; ++it, ++g) {
          const int s = g % L::STAGES;
          mbar_wait(&empty[s], ((g / L::STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], L::STAGE * 2);
          bulk_g2s(ring + s * L::STAGE, w + ((long)it * a.cout + n0) * KC, L::STAGE * 2,
                   &full[s]);
        }
      }
    } else if (tid >= 32) {
      // Window count c is (tile blockIdx.x + (c / nchunks) gridDim.x, chunk
      // c % nchunks). Its raw box lands in raw[c & 1] by TMA (zeros outside
      // the map), two windows ahead of its activation into act[c & 1].
      const int at = tid - 32, c8 = at & 7;  // a thread's items all hold channels c8 * 8..
      auto coord = [&](int c, HaloTileCoord& tc, int& j) {
        const int tile = blockIdx.x + (c / nchunks) * gridDim.x;
        j = c % nchunks;
        if (tile >= ntiles) return false;
        tc = halo_tile<ROWS>(a, tile, BN);
        return true;
      };
      auto load_raw = [&](int c) {
        HaloTileCoord tc;
        int j;
        if (!coord(c, tc, j)) return;
        uint64_t* bar = &raw_full[c & 1];
        mbar_arrive_expect_tx(bar, L::RAW * 2);
        // the projection's box is read at the centre tap's pixels only
        tma_load_4d(raw + (c & 1) * L::RAW, j < nconv ? &tx : &tskip,
                    (j < nconv ? j : j - nconv) * KC, tc.x0 - 1, tc.y0 - 1, tc.n, bar);
      };
      if (at == 0) {
        load_raw(0);
        load_raw(1);
      }
      HaloTileCoord tc;
      int j;
      for (int c = 0; coord(c, tc, j); ++c) {
        const int b = c & 1;
        const bool conv = j < nconv;
        float s[8], t[8];
        if (conv) {
          const long ch = (long)tc.n * a.cin + j * KC + c8 * 8;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            s[k] = a.A[ch + k];
            t[k] = a.B[ch + k];
          }
        }
        mbar_wait(&raw_full[b], (c >> 1) & 1);
        mbar_wait(&win_empty[b], ((c >> 1) & 1) ^ 1);  // window c - 2 is done with act[b]
        const bf16* src = raw + b * L::RAW;
        bf16* dst = act + b * L::ACT;
        for (int item = at; item < L::WPIXELS * 8; item += ACT_THREADS) {
          const int pix = item >> 3, wr = pix / L::WCOLS, wc = pix - wr * L::WCOLS;
          const uint4 v = *reinterpret_cast<const uint4*>(src + item * 8);
          uint4 o = make_uint4(0u, 0u, 0u, 0u);
          if (conv) {
            const int yy = tc.y0 - 1 + wr, xx = tc.x0 - 1 + wc;
            if (yy >= 0 && yy < a.H && xx >= 0 && xx < a.W) o = activate8(v, s, t);
          } else if (wr >= 1 && wr <= ROWS && wc >= 1 && wc <= TC) {
            o = v;  // the projection's source, read by the centre tap only
          } else {
            continue;
          }
          *reinterpret_cast<uint4*>(dst + pix * APITCH + c8 * 8) = o;
        }
        named_bar_sync(1, ACT_THREADS);  // every thread is done reading raw[b]
        if (at == 0) load_raw(c + 2);
        mbar_arrive(&win_full[b]);
      }
    }
  } else {
    // ---- consumer warpgroups ----
    reg_alloc<CONSUMER_REGS>();
    const int cw = (tid - 128) >> 7, t = (tid - 128) & 127, warp = t >> 5, lane = t & 31;
    const int pbase = (ROWS == 4 ? 64 * cw : 0) + 16 * warp;  // the warp's first tile pixel
    const int trow = pbase / TC, tcol = pbase % TC;
    const int ncol = ROWS == 4 ? 0 : cw * L::BNW;  // the warpgroup's first block channel
    const int lrow = lane & 15, lk = (lane >> 4) * 8;  // this lane's ldmatrix row address
    const bool identity = a.skip != nullptr && !a.has_proj;
    const int g = lane >> 2, t2 = (lane & 3) * 2;

    float acc[L::BNW / 2];
    uint32_t af[3][4][4];
#pragma unroll
    for (int u = 0; u < 3; ++u)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) af[u][kk][r] = 0u;
    int s = 0, ph = 0, prev = -1, c = 0;  // weight stage, its parity; window count

    // One (window c, tap) step into A buffer f; fp is the previous step's
    // buffer, whose wgmmas have completed once wgmma_wait<1> returns.
    auto step = [&](int tap, uint32_t (&f)[4][4], uint32_t (&fp)[4][4], bool last) {
      const int dy = tap / 3, dx = tap - dy * 3;
      const bf16* win =
          act + (c & 1) * L::ACT + ((trow + dy) * L::WCOLS + tcol + dx + lrow) * APITCH + lk;
      mbar_wait(&full[s], ph);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(f[kk], win + kk * 16);
      wgmma_fence();
      const uint64_t desc = sw128_desc(ring + s * L::STAGE + ncol * KC);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<0>(acc, f[kk], desc + 2 * kk);
      wgmma_commit();
      // this warp's ldmatrix reads of the window have landed in f
      if (last && lane == 0) mbar_arrive(&win_empty[c & 1]);
      wgmma_wait<1>();  // the previous step's wgmmas (the whole warpgroup's) are done
      reg_fence(fp);
      if (prev >= 0 && t == 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == L::STAGES) {
        s = 0;
        ph ^= 1;
      }
    };

    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const HaloTileCoord tc = halo_tile<ROWS>(a, tile, BN);
#pragma unroll
      for (int i = 0; i < L::BNW / 2; ++i) acc[i] = 0.f;
      reg_fence(acc);
      for (int j = 0; j < nconv; ++j, ++c) {
        mbar_wait(&win_full[c & 1], (c >> 1) & 1);
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) step(tap, af[tap % 3], af[(tap + 2) % 3], tap == 8);
      }
      for (int jp = 0; jp < nproj; jp += 3) {
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          if (jp + u < nproj) {
            mbar_wait(&win_full[c & 1], (c >> 1) & 1);
            step(4, af[u], af[(u + 2) % 3], true);
            ++c;
          }
        }
      }
      wgmma_wait<0>();
      reg_fence(acc);
      if (t == 0) mbar_arrive(&empty[prev]);  // the tile's last stage
      prev = -1;

      // epilogue: accumulator (row g + 8h, columns 8i + t2, +1) of the warp
      const int c0 = tc.n0 + ncol + t2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pt = pbase + g + 8 * h;
        const long p = ((long)tc.n * a.H + tc.y0 + pt / TC) * a.W + tc.x0 + pt % TC;
        bf16* orow = static_cast<bf16*>(a.out) + p * a.cout + c0;
        const bf16* srow =
            identity ? static_cast<const bf16*>(a.skip) + p * a.cout + c0 : nullptr;
#pragma unroll
        for (int i = 0; i < L::BNW / 8; ++i) {
          float v0 = acc[4 * i + 2 * h] + a.bias[c0 + 8 * i];
          float v1 = acc[4 * i + 2 * h + 1] + a.bias[c0 + 8 * i + 1];
          if (identity) {
            const float2 r =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(srow + 8 * i));
            v0 += r.x;
            v1 += r.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// A (N, H, W, C) bf16 map in boxes of `rows` + 2 rows x 34 columns x 64
// channels, no swizzle (the window's rows are read by the activation
// threads, not by wgmma); coordinates outside the map read as zeros.
bool window_map(CUtensorMap* map, const void* p, int N, int H, int W, int C, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)C * sizeof(bf16), (cuuint64_t)W * C * sizeof(bf16),
                                 (cuuint64_t)H * W * C * sizeof(bf16)};
  const cuuint32_t box[4] = {KC, TC + 2, (cuuint32_t)rows + 2, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int ROWS, int BN>
cudaError_t launch_wgmma(const HaloArgs& a, cudaStream_t st) {
  using L = HaloTile<ROWS, BN>;
  CUtensorMap tx, tskip;
  if (!window_map(&tx, a.x, a.N, a.H, a.W, a.cin, ROWS) ||
      !window_map(&tskip, a.has_proj ? a.skip : a.x, a.N, a.H, a.W, a.has_proj ? a.cr : a.cin,
                  ROWS))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(halo_wgmma_kernel<ROWS, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = a.N * (a.H / ROWS) * (a.W / TC) * (a.cout / BN);
  halo_wgmma_kernel<ROWS, BN><<<std::min(tiles, num_sms()), WG_THREADS, L::SMEM, st>>>(a, tx, tskip);
  return cudaGetLastError();
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

// dtype: 0 fp32, 1 bf16. x (N, H, W, cin); A, B (N, cin) fp32; bias (cout)
// fp32; skip (N, H, W, cr) or NULL, with wproj NULL for an identity skip
// (cr == cout); out (N, H, W, cout). Weights as ops/halo_conv.py packs them:
// bf16 w (9 cin / 64 + cr / 64, cout, 64), the projection's steps last and
// wproj pointing at them; fp32 w (9 cin, cout), wproj (cr, cout).
// tile_rows x tile_n is the bf16 tile (halo_plan: 4 or 2 rows, 256 or 128
// channels); the fp32 kernel's is fixed. Requires W % 32 == 0 and, bf16,
// H % tile_rows == 0, cin and cr % 64 == 0, cout % tile_n == 0; fp32, H % 4
// == 0, cin and cr % 32 == 0, cout % 64 == 0 (the wrapper checks). Returns
// a cudaError_t.
int diffpure_halo_conv(int dtype, const void* x, int N, int H, int W, int cin, const float* A,
                       const float* B, const void* w, const float* bias, const void* skip, int cr,
                       const void* wproj, int cout, void* out, int tile_rows, int tile_n,
                       void* stream) {
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
  if (dtype == 1) {
    if (W % TC || cin % KC || (a.has_proj && cr % KC) || H % tile_rows || cout % tile_n)
      return cudaErrorInvalidValue;
    if (tile_rows == 4 && tile_n == 256) return launch_wgmma<4, 256>(a, st);
    if (tile_rows == 4 && tile_n == 128) return launch_wgmma<4, 128>(a, st);
    if (tile_rows == 2 && tile_n == 256) return launch_wgmma<2, 256>(a, st);
    if (tile_rows == 2 && tile_n == 128) return launch_wgmma<2, 128>(a, st);
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(halo_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)F32_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((H / TR) * (W / TC), cout / HBN, N);
  halo_f32_kernel<<<grid, NT, F32_SMEM, st>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
