// Implicit-GEMM 3x3 SAME conv with a folded 1x1 projection on wgmma + TMA
// for Hopper (sm_90a): bf16 operands, fp32 accumulators.
//
// It carries the two convs of the bf16 forward of the fused BigGAN block
// (fused_resblock.cu; kernels #1 and #2, replacing the TPU kernels
// diffpure_tpu/ops/fused_resblock.py:290 fused_resblock_pallas and :728
// fused_resblock_cat_pallas). It is a header so that other conv chains
// (the backward's transposed 3x3 convs) can run on it as they are.
//
// What bounds it on this card: the products. A CIFAR NCSN++ block is 2 x 9
// x cin x cout multiply-adds per output pixel against operands that stay in
// the 50 MB L2, so the GEMM has to keep the tensor cores fed from L2. What
// the old kernel (common.cuh igemm_bf16_kernel: mma.sync, 64 x 64 tiles,
// 8-byte cp.async with per-element address arithmetic) left on the table is
// what this one is built around.
//
//   out[M, cout] = epilogue(sum over K steps k of A_k[M, 64] B_k[64, cout])
//
// Row m of A is output pixel (n, y, x) of the output grid Ho x Wo, in NHWC
// order. A K step is 64 input channels:
//   - conv steps k = chunk * 9 + tap, tap = 3 dy + dx, of the source map src
//     (N, Ho, Wo, C), which already lies on the output grid (the GroupNorm
//     pass wrote it there, activated): A_k[m] = src[n, y + dy - 1, x + dx -
//     1, chunk * 64 ..], zero outside the map (SAME padding in activation
//     space);
//   - then projection steps from p1 (N, Ho, Wo, c1) and then p2 (c2) at the
//     pixel itself: the 1x1 skip projection on the same accumulator (p2 is
//     the concat block's second input, the seam at a chunk boundary).
// An M tile of BM rows is a box of Wo columns x bh rows x bimg images, so
// A_k's tile is ONE 4-D TMA box {64 channels, Wo, bh, bimg} at (chunk * 64,
// dx - 1, y0 + dy - 1, n0): the tensor unit applies the tap's shift in its
// coordinates and reads zeros outside the map, and the 128-byte swizzle
// lands the box as the K-major layout wgmma's shared-memory descriptor
// reads (rows of 128 bytes, 8-row groups 1024 bytes apart). (The halo conv,
// halo_conv.cu, activates its window in the kernel, so its shift broke the
// descriptor; here the activation is in memory and each tap is its own
// box.) The cost is A read 9 times from L2 rather than once. B_k's BN rows
// are one contiguous stage of the weight pack (ops/fused_resblock.py: the
// halo conv's (steps, cout, 64) layout, each row pre-swizzled): one bulk
// copy.
//
// Block: one producer warp, whose first thread issues both copies of each
// step into a ring of STAGES on mbarriers, and two consumer warpgroups
// running wgmma m64nNk16 from shared memory (BM = 128: 64 rows x BN each;
// BM = 64: 64 rows x BN / 2 each). Each consumer warp releases a stage
// itself after its wgmma_wait: one warp past its wait does not mean its
// warpgroup has finished reading. Persistent: min(items, SMs) blocks walk
// the work items (K slice, M tile, N tile), and the ring runs on from item
// to item, so the next item's operands load while this one's epilogue
// stores.
//
// Split-K where the tiles alone leave SMs idle (ops/fused_resblock.py
// resblock_plan picks it): slice z of K writes its fp32 partials to ws[z]
// and splitk_epilogue_kernel (common.cuh) sums them in slice order and
// applies the epilogue. No atomics: a result repeats bit for bit.
// Epilogue from the accumulators' registers: (acc + bias + temb[n] +
// resid) * oscale, in epilogue4's order, stored as fp32 or bf16.
#pragma once

#include <mutex>

#include "common.cuh"
#include "hopper.cuh"

namespace dp {

constexpr int WG_KC = 64;            // input channels per K step: one 128-byte row
constexpr int WG_THREADS = 288;      // two consumer warpgroups + a producer warp
constexpr int WG_RING_BYTES = 196608;  // shared memory for the ring

struct WgConvArgs {
  int N, Ho, Wo, M, cout;
  int nconv;           // 64-channel chunks of src: 9 * nconv conv steps
  int nproj1, nproj2;  // then projection chunks of p1, then of p2
  int bh, bimg;        // the A box: Wo columns x bh rows x bimg images
  const bf16* w;       // (steps, cout, 64), rows in the 128-byte swizzle
  const float* bias;   // (cout) or nullptr
  const bf16* temb;    // (N, cout) or nullptr
  const bf16* resid;   // (M, cout), an identity skip, or nullptr
  float oscale;
  void* out;  // (M, cout): fp32 if out_f32, else bf16
  int out_f32;
  int mtiles, ntiles, splits, steps_per;
  float* ws;  // (splits, M, cout) partials when splits > 1
};

template <int BM, int BN> struct WgTile {
  static constexpr int A_BYTES = BM * 128, B_BYTES = BN * 128;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = WG_RING_BYTES / STAGE < 6 ? WG_RING_BYTES / STAGE : 6;
  static constexpr int NW = BM == 128 ? BN : BN / 2;  // columns per consumer warpgroup
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE + 2 * STAGES * sizeof(uint64_t);
};

template <int BM, int BN>
__global__ void __launch_bounds__(WG_THREADS, 1)
    rb_wgmma_kernel(const __grid_constant__ WgConvArgs a, const __grid_constant__ CUtensorMap tsrc,
                    const __grid_constant__ CUtensorMap tp1,
                    const __grid_constant__ CUtensorMap tp2) {
  using L = WgTile<BM, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* As = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* Bs = As + L::STAGES * L::A_BYTES;  // [STAGES][BN rows of 128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + L::STAGES * L::B_BYTES);
  uint64_t* empty = full + L::STAGES;
  const int tid = threadIdx.x;
  const int nconv_steps = 9 * a.nconv, nsteps = nconv_steps + a.nproj1 + a.nproj2;
  const int items = a.mtiles * a.ntiles * a.splits, hw = a.Ho * a.Wo;

  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // item -> K slice z (fastest), M tile, N tile
  auto coords = [&](int item, int& m0, int& n0, int& z, int& kb, int& ke) {
    z = item % a.splits;
    const int r = item / a.splits;
    m0 = (r % a.mtiles) * BM;
    n0 = (r / a.mtiles) * BN;
    kb = z * a.steps_per;
    ke = min(nsteps, kb + a.steps_per);
  };

  if (tid >= 256) {
    // ---- producer warp: one thread issues the copies ----
    if (tid == 256) {
      int g = 0;  // steps issued by this block: ring slot g % STAGES
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        int m0, n0, z, kb, ke;
        coords(item, m0, n0, z, kb, ke);
        const int img = m0 / hw, y0 = (m0 - img * hw) / a.Wo;
        for (int k = kb; k < ke; ++k, ++g) {
          const int s = g % L::STAGES;
          mbar_wait(&empty[s], ((g / L::STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], L::STAGE);
          unsigned char* as = As + s * L::A_BYTES;
          if (k < nconv_steps) {
            const int j = k / 9, tap = k - 9 * j, dy = tap / 3, dx = tap - 3 * dy;
            tma_load_4d(as, &tsrc, j * WG_KC, dx - 1, y0 + dy - 1, img, &full[s]);
          } else {
            const int j = k - nconv_steps;
            if (j < a.nproj1)
              tma_load_4d(as, &tp1, j * WG_KC, 0, y0, img, &full[s]);
            else
              tma_load_4d(as, &tp2, (j - a.nproj1) * WG_KC, 0, y0, img, &full[s]);
          }
          bulk_g2s(Bs + s * L::B_BYTES, a.w + ((long)k * a.cout + n0) * WG_KC, L::B_BYTES,
                   &full[s]);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;
  const int row_off = BM == 128 ? 64 * wg : 0, col_off = BM == 128 ? 0 : wg * L::NW;
  const int g8 = lane >> 2, t2 = (lane & 3) * 2;
  float acc[L::NW / 2];
  int g = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int m0, n0, z, kb, ke;
    coords(item, m0, n0, z, kb, ke);
#pragma unroll
    for (int i = 0; i < L::NW / 2; ++i) acc[i] = 0.f;
    reg_fence(acc);
    int prev = -1;
    for (int k = kb; k < ke; ++k, ++g) {
      const int s = g % L::STAGES;
      mbar_wait(&full[s], (g / L::STAGES) & 1);
      const uint64_t da = sw128_desc(As + s * L::A_BYTES + row_off * 128);
      const uint64_t db = sw128_desc(Bs + s * L::B_BYTES + col_off * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's wgmmas are done with its stage
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    reg_fence(acc);
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

    // accumulator (row 16 warp + g8 + 8 h, columns 8 i + t2, + 1) of the warpgroup
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + row_off + 16 * warp + g8 + 8 * h;
      if (m >= a.M) continue;  // past the last image of a box that spans images
      const int c0 = n0 + col_off + t2;
      if (a.splits > 1) {
        float* dst = a.ws + ((long)z * a.M + m) * a.cout + c0;
#pragma unroll
        for (int i = 0; i < L::NW / 8; ++i)
          *reinterpret_cast<float2*>(dst + 8 * i) =
              make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
        continue;
      }
      const bf16* trow = a.temb != nullptr ? a.temb + (long)(m / hw) * a.cout + c0 : nullptr;
      const bf16* rrow = a.resid != nullptr ? a.resid + (long)m * a.cout + c0 : nullptr;
      const long o = (long)m * a.cout + c0;
#pragma unroll
      for (int i = 0; i < L::NW / 8; ++i) {
        float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
        if (a.bias != nullptr) {
          const float2 b = *reinterpret_cast<const float2*>(a.bias + c0 + 8 * i);
          v0 += b.x;
          v1 += b.y;
        }
        if (trow != nullptr) {
          const float2 t =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(trow + 8 * i));
          v0 += t.x;
          v1 += t.y;
        }
        if (rrow != nullptr) {
          const float2 r =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rrow + 8 * i));
          v0 += r.x;
          v1 += r.y;
        }
        v0 *= a.oscale;
        v1 *= a.oscale;
        if (a.out_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + o + 8 * i) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.out) + o + 8 * i) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// A (N, H, W, C) bf16 map in boxes of {64 channels, W, bh rows, bimg
// images}, 128-byte swizzle; coordinates outside the map read as zeros.
// Encoding a map costs the host microseconds, and a block call needs four:
// the last WG_MAP_CACHE maps are kept by (address, shape), which repeat
// from call to call as the caching allocator hands out the same blocks.
constexpr int WG_MAP_CACHE = 256;

inline bool wg_box_map(CUtensorMap* map, const void* p, int N, int H, int W, int C, int bh,
                       int bimg) {
  struct Key {
    const void* p;
    int N, H, W, C, bh, bimg;
  };
  static Key keys[WG_MAP_CACHE];
  static CUtensorMap maps[WG_MAP_CACHE];
  static std::mutex lock;
  const Key k = {p, N, H, W, C, bh, bimg};
  const size_t slot = ((reinterpret_cast<uintptr_t>(p) >> 8) ^ (size_t)C * 131 ^ (size_t)H * 31 ^
                       (size_t)N * 7 ^ (size_t)bh * 3 ^ (size_t)bimg) % WG_MAP_CACHE;
  std::lock_guard<std::mutex> guard(lock);
  const Key& c = keys[slot];
  if (c.p == p && c.N == N && c.H == H && c.W == W && c.C == C && c.bh == bh &&
      c.bimg == bimg) {
    *map = maps[slot];
    return true;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)C * sizeof(bf16), (cuuint64_t)W * C * sizeof(bf16),
                                 (cuuint64_t)H * W * C * sizeof(bf16)};
  const cuuint32_t box[4] = {WG_KC, (cuuint32_t)W, (cuuint32_t)bh, (cuuint32_t)bimg};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides, box,
         elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  keys[slot] = k;
  maps[slot] = *map;
  return true;
}

template <int BM, int BN>
cudaError_t launch_wg_tile(const WgConvArgs& a, const CUtensorMap& tsrc, const CUtensorMap& tp1,
                           const CUtensorMap& tp2, cudaStream_t st) {
  using L = WgTile<BM, BN>;
  static bool opted_in = false;  // the shared-memory opt-in, once per process
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        rb_wgmma_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int items = a.mtiles * a.ntiles * a.splits;
  rb_wgmma_kernel<BM, BN>
      <<<std::min(items, num_sms()), WG_THREADS, L::SMEM, st>>>(a, tsrc, tp1, tp2);
  return cudaGetLastError();
}

// The GEMM with a bm x bn tile (128 x 256, 128 x 128, 64 x 128 or 128 x
// 64), then, for a split K, the ordered sum of the slices' partials
// and the epilogue. The caller keeps the shapes to what the plan allows
// (cout % bn == 0, the box tiling the map, the partials fitting ws).
inline cudaError_t launch_wgmma_conv(const WgConvArgs& a, int bm, int bn, const CUtensorMap& tsrc,
                                     const CUtensorMap& tp1, const CUtensorMap& tp2,
                                     cudaStream_t st) {
  cudaError_t err;
  if (bm == 128 && bn == 256)
    err = launch_wg_tile<128, 256>(a, tsrc, tp1, tp2, st);
  else if (bm == 128 && bn == 128)
    err = launch_wg_tile<128, 128>(a, tsrc, tp1, tp2, st);
  else if (bm == 64 && bn == 128)
    err = launch_wg_tile<64, 128>(a, tsrc, tp1, tp2, st);
  else if (bm == 128 && bn == 64)
    err = launch_wg_tile<128, 64>(a, tsrc, tp1, tp2, st);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess || a.splits == 1) return err;
  GemmArgs e = {};
  e.M = a.M;
  e.Nc = a.cout;
  e.Ho = a.Ho;
  e.Wo = a.Wo;
  e.bias = a.bias;
  e.temb = a.temb;
  e.has_resid = a.resid != nullptr;
  e.resid = Src{a.resid, nullptr, a.cout, 0, a.Ho, a.Wo, 0};
  e.oscale = a.oscale;
  e.out = a.out;
  e.out_f32 = a.out_f32;
  e.splits = a.splits;
  e.ws = a.ws;
  const long quads = (long)a.M * a.cout / 4;
  splitk_epilogue_kernel<bf16><<<(unsigned)((quads + NT - 1) / NT), NT, 0, st>>>(e);
  return cudaGetLastError();
}

}  // namespace dp
