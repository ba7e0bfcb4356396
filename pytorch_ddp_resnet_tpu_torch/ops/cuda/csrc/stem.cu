// The stem conv emitting the channel-major layout, written for Hopper
// (sm_90a) and bound to Python through a plain C interface
// (ops/cuda/stem.py loads this file's library with ctypes).
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/stem.py,
// stem_conv_lane):
//   stem_fwd_launch       <- _fwd_call -> _fwd_kernel: 3x3 stride-1 SAME
//                            conv of x [Cin <= 8, N] bf16 to [Cout, N], f32
//                            sums, rounded to bf16, then + bf16(bias) in bf16
//   stem_wgrad_launch     <- _wgrad_call -> _wgrad_kernel: dW [Cout, 9*Cin]
//                            and db [Cout] as f32 sums over the N positions
//   stem_wgrad_sum_launch <- the sums the TPU kernel carries across its grid
//
// What bounds them on an H100: at WRN-28-10, batch 128 (N = 131,072,
// Cin = 3, Cout = 160), each moves about 42 MB (the [160, N] bf16 output
// or cotangent; x is 0.8 MB): 12.8 us at 3.35 TB/s, which is the bound
// (the 1.1 GFLOP of bf16 products take 1.1 us at the tensor cores' peak).
//
// Forward: no tensor cores (the contraction is 27 deep). A thread per
// position gathers its 9 * Cin taps once (zero where the tap leaves the
// image), then walks a slice of the output channels with the weights in
// shared memory, summing in the fixed order tap-major, channel-minor.
// Every product of two bf16 values is exact in f32, so the sum rounds only
// at the additions and its plain PyTorch version repeats it bit for bit.
//
// Weight gradient: a tensor-core GEMM over positions, M = Cout (dy's rows,
// K-contiguous as they lie), N = the 9 * Cin tap rows of x, then a row of
// ones (db), padded with zero rows to a multiple of 16, K = positions. Each
// block takes a contiguous run of K steps of 64 positions (the runs split
// K so that every SM has work: ops/cuda/stem.py stem_wgrad_plan). Per step
// it streams dy's [Cout, 64] tile into a ring of shared memory (cp.async,
// 16 bytes a thread, 16-byte padded rows so that ldmatrix's rows fall in
// distinct banks) and builds the [NP, 64] bf16 tap tile once from x: zeros
// off the image, the ones and the pad rows written once. Each warp owns up
// to two 16-row tiles of dy and all NP columns: ldmatrix.x4 into mma.sync
// m16n8k16 (bf16 x bf16 -> f32). The tensor cores' f32 accumulation does
// not round to nearest, so a step's MMAs start from zero and their 64
// positions' sums are added into f32 registers with __fadd_rn. Each block
// writes its [Cout, 9 * Cin + 1] tile to its slot of a partial buffer, and
// stem_wgrad_sum (common::tile_sum) adds the slots in a fixed order (runs of
// consecutive slots, each in order, then the runs in order):
// deterministic; the f32 sums differ from the reference's only in their
// order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"        // tile_sum
#include "wgrad_staged.cuh"  // cp.async, mma.sync bf16

namespace {

using wgrad_staged::cp_async16;
using wgrad_staged::cp_async_commit;
using wgrad_staged::cp_async_wait;
using wgrad_staged::mma_bf16;
using wgrad_staged::smem_u32;

constexpr int THREADS = 256;
constexpr int FWD_COS = 40;     // output channels per forward thread
// the weight gradient
constexpr int WG_KC = 64;                // positions a K step
constexpr int WG_ROW = 2 * WG_KC + 16;   // bytes a staged row, padded
constexpr int WG_STAGES = 4;             // dy's ring
constexpr int WG_WARPS = THREADS / 32;
constexpr int WG_MT = 2;                 // 16-row tiles of dy a warp
constexpr int WG_COUT_MAX = WG_WARPS * WG_MT * 16;

// Names the weight gradient's slot sum in a profile.
struct StemWgradSum {};

// The GEMM's N: the taps, the ones row, zero rows to a multiple of 16.
template <int CIN>
struct Wg {
  static constexpr int K = 9 * CIN + 1;
  static constexpr int NP = (K + 15) / 16 * 16;
  static constexpr int NT = NP / 8;  // n8 tiles
};

// Dynamic shared memory of the weight gradient's block: dy's ring of
// STAGES [mp][WG_ROW] tiles (mp: Cout rounded up to 16), then two [NP]
// [WG_ROW] tap tiles.
inline int wg_smem(int np, int cout) {
  return (WG_STAGES * ((cout + 15) / 16 * 16) + 2 * np) * WG_ROW;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the 9 * CIN taps of position p (zero outside the image), tap-major
template <int CIN>
__device__ __forceinline__ void gather(const __nv_bfloat16* __restrict__ x,
                                       int n, int h, int wi, int p,
                                       float (&v)[9 * CIN]) {
  const int hw = h * wi;
  const int hh = (p % hw) / wi;
  const int ww = p % wi;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int sh = hh + tap / 3 - 1, sw = ww + tap % 3 - 1;
    const bool ok = sh >= 0 && sh < h && sw >= 0 && sw < wi;
    const int src = p + (tap / 3 - 1) * wi + (tap % 3 - 1);
#pragma unroll
    for (int c = 0; c < CIN; ++c)
      v[tap * CIN + c] = ok ? __bfloat162float(x[(size_t)c * n + src]) : 0.f;
  }
}

template <int CIN>
__global__ void __launch_bounds__(THREADS)
stem_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ b, __nv_bfloat16* __restrict__ y,
                int cout, int n, int h, int wi) {
  constexpr int K = 9 * CIN;
  __shared__ float ws[FWD_COS][K];
  __shared__ __nv_bfloat16 bs[FWD_COS];
  const int co0 = blockIdx.y * FWD_COS;
  const int cos = min(FWD_COS, cout - co0);
  for (int i = threadIdx.x; i < cos * K; i += THREADS)
    ws[i / K][i % K] = __bfloat162float(w[(size_t)(co0 + i / K) * K + i % K]);
  for (int i = threadIdx.x; i < cos; i += THREADS)
    bs[i] = __float2bfloat16_rn(b[co0 + i]);
  __syncthreads();
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= n) return;
  float v[K];
  gather<CIN>(x, n, h, wi, p, v);
  for (int c = 0; c < cos; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) acc = __fadd_rn(acc, __fmul_rn(ws[c][k], v[k]));
    const float yb = __bfloat162float(__float2bfloat16_rn(acc));
    y[(size_t)(co0 + c) * n + p] =
        __float2bfloat16_rn(__fadd_rn(yb, __bfloat162float(bs[c])));
  }
}

// Block b walks K steps [b * per, b * per + per) (of n / WG_KC), every warp
// all of them; warp w owns dy's 16-row tiles w and w + WG_WARPS. Writes the
// block's [cout][K] f32 sums to part[b].
template <int CIN>
__global__ void __launch_bounds__(THREADS, CIN <= 4 ? 2 : 1)
stem_wgrad_tc_kernel(const __nv_bfloat16* __restrict__ dy,
                     const __nv_bfloat16* __restrict__ x,
                     float* __restrict__ part, int cout, int n, int h, int wi,
                     int per) {
  using G = Wg<CIN>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int mp = (cout + 15) / 16 * 16;
  unsigned char* ring = smem;                           // [STAGES][mp][ROW]
  unsigned char* taps = smem + WG_STAGES * mp * WG_ROW;  // [2][NP][ROW]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int k0 = blockIdx.x * per;
  const int nk = min(per, n / WG_KC - k0);
  const int hw = h * wi;

  // rows past Cout of dy's tiles, and the tap tiles' ones and pad rows,
  // written once (the steps rewrite only the tap rows)
  for (int u = tid; u < WG_STAGES * (mp - cout) * (WG_KC / 8); u += THREADS) {
    const int s = u / ((mp - cout) * (WG_KC / 8));
    const int r = cout + u / (WG_KC / 8) % (mp - cout);
    *reinterpret_cast<uint4*>(ring + (s * mp + r) * WG_ROW +
                              16 * (u % (WG_KC / 8))) = make_uint4(0, 0, 0, 0);
  }
  for (int u = tid; u < 2 * (G::NP - G::K + 1) * WG_KC; u += THREADS) {
    const int q = u % WG_KC, r = G::K - 1 + u / WG_KC % (G::NP - G::K + 1);
    const int t = u / (WG_KC * (G::NP - G::K + 1));
    *reinterpret_cast<__nv_bfloat16*>(taps + (t * G::NP + r) * WG_ROW +
                                      2 * q) =
        __float2bfloat16_rn(r == G::K - 1 ? 1.f : 0.f);
  }

  // K step i's dy tile into slot i % STAGES: 16 bytes a thread
  auto load = [&](int i) {
    const int s = i % WG_STAGES;
    const size_t p0 = (size_t)(k0 + i) * WG_KC;
    for (int u = tid; u < cout * (WG_KC / 8); u += THREADS) {
      const int r = u / (WG_KC / 8), k = u % (WG_KC / 8);
      cp_async16(smem_u32(ring + (s * mp + r) * WG_ROW + 16 * k),
                 dy + (size_t)r * n + p0 + 8 * k, true);
    }
  };
  // K step i's tap rows into tile i % 2: a thread a (tap, position)
  auto build = [&](int i) {
    unsigned char* tb = taps + (i % 2) * G::NP * WG_ROW;
    const int p0 = (k0 + i) * WG_KC;
    for (int u = tid; u < 9 * WG_KC; u += THREADS) {
      const int tap = u / WG_KC, q = u % WG_KC, p = p0 + q;
      const int hh = (p % hw) / wi + tap / 3 - 1, ww = p % wi + tap % 3 - 1;
      const bool ok = hh >= 0 && hh < h && ww >= 0 && ww < wi;
      const int src = p + (tap / 3 - 1) * wi + tap % 3 - 1;
#pragma unroll
      for (int c = 0; c < CIN; ++c)
        *reinterpret_cast<__nv_bfloat16*>(tb + (tap * CIN + c) * WG_ROW +
                                          2 * q) =
            ok ? x[(size_t)c * n + src] : __float2bfloat16_rn(0.f);
    }
  };

  float sum[WG_MT][G::NT][4];
#pragma unroll
  for (int mt = 0; mt < WG_MT; ++mt)
#pragma unroll
    for (int j = 0; j < G::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[mt][j][e] = 0.f;

  for (int i = 0; i < WG_STAGES - 1; ++i) {
    if (i < nk) load(i);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    build(i);
    cp_async_wait<WG_STAGES - 2>();  // step i's dy landed
    __syncthreads();  // and every tap row; step i - 1's slot is free
    if (i + WG_STAGES - 1 < nk) load(i + WG_STAGES - 1);
    cp_async_commit();
    const unsigned char* as = ring + (i % WG_STAGES) * mp * WG_ROW;
    const unsigned char* bs = taps + (i % 2) * G::NP * WG_ROW;
    float acc[WG_MT][G::NT][4];
#pragma unroll
    for (int mt = 0; mt < WG_MT; ++mt)
#pragma unroll
      for (int j = 0; j < G::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < WG_KC / 16; ++ks) {
      // B fragments of every n8 tile: matrices (n 0-7, k 0-7), (n 0-7,
      // k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15) of each pair of tiles
      uint32_t b[G::NT][2];
#pragma unroll
      for (int j = 0; j < G::NT / 2; ++j) {
        uint32_t r[4];
        const int row = 16 * j + (lane / 16) * 8 + lane % 8;
        ldmatrix_x4(r, smem_u32(bs + row * WG_ROW + ((lane / 8) % 2) * 16 +
                                ks * 32));
        b[2 * j][0] = r[0];
        b[2 * j][1] = r[1];
        b[2 * j + 1][0] = r[2];
        b[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < WG_MT; ++mt) {
        const int tile = warp + WG_WARPS * mt;
        if (tile * 16 >= cout) continue;  // warp-uniform
        uint32_t a[4];
        const int row = tile * 16 + ((lane / 8) % 2) * 8 + lane % 8;
        ldmatrix_x4(a, smem_u32(as + row * WG_ROW + (lane / 16) * 16 +
                                ks * 32));
#pragma unroll
        for (int j = 0; j < G::NT; ++j) mma_bf16(acc[mt][j], a, b[j][0],
                                                 b[j][1]);
      }
    }
    // the step's sums, rounded to nearest into the running sums
#pragma unroll
    for (int mt = 0; mt < WG_MT; ++mt)
#pragma unroll
      for (int j = 0; j < G::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sum[mt][j][e] = __fadd_rn(sum[mt][j][e], acc[mt][j][e]);
  }

  // value e of n8 tile j: row 16 tile + lane / 4 + 8 (e / 2), column 8 j +
  // 2 (lane % 4) + e % 2
  float* out = part + (size_t)blockIdx.x * cout * G::K;
#pragma unroll
  for (int mt = 0; mt < WG_MT; ++mt) {
    const int tile = warp + WG_WARPS * mt;
#pragma unroll
    for (int j = 0; j < G::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = tile * 16 + lane / 4 + 8 * (e / 2);
        const int col = 8 * j + 2 * (lane % 4) + e % 2;
        if (row < cout && col < G::K) out[row * G::K + col] = sum[mt][j][e];
      }
  }
}

#define STEM_CASES(F) \
  F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8)

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

extern "C" {

// x [cin, n] bf16 (1 <= cin <= 8), w [cout, 9 * cin] bf16 (taps row-major
// in (dh, dw), then input channel), b [cout] f32, y [cout, n] bf16.
int stem_fwd_launch(const void* x, const void* w, const void* b, void* y,
                    int cin, int cout, int n, int h, int wi, void* stream) {
  const dim3 grid((n + THREADS - 1) / THREADS, (cout + FWD_COS - 1) / FWD_COS);
  const auto* xx = static_cast<const __nv_bfloat16*>(x);
  const auto* ww = static_cast<const __nv_bfloat16*>(w);
  const auto* bb = static_cast<const float*>(b);
  auto* yy = static_cast<__nv_bfloat16*>(y);
  switch (cin) {
#define CASE(C)                                                              \
  case C:                                                                    \
    stem_fwd_kernel<C><<<grid, THREADS, 0, as_stream(stream)>>>(           \
        xx, ww, bb, yy, cout, n, h, wi);                                     \
    break;
    STEM_CASES(CASE)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dy [cout, n] bf16, x [cin, n] bf16 (n % 64 == 0, cout <= 256); part
// [ceil(n / 64 / per)][cout][9 * cin + 1] f32: per block of `per` K steps of
// 64 positions, the sums of dy * tap (columns in (dh, dw, ci) order) and,
// last, of dy.
int stem_wgrad_launch(const void* dy, const void* x, void* part, int cin,
                      int cout, int n, int h, int wi, int per, void* stream) {
  if (n % WG_KC || cout < 1 || cout > WG_COUT_MAX || per < 1 || h < 1 ||
      wi < 1 || n % (h * wi))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n / WG_KC + per - 1) / per;
  const auto* dd = static_cast<const __nv_bfloat16*>(dy);
  const auto* xx = static_cast<const __nv_bfloat16*>(x);
  auto* pp = static_cast<float*>(part);
  switch (cin) {
#define CASE(C)                                                              \
  case C: {                                                                  \
    const int smem = wg_smem(Wg<C>::NP, cout);                              \
    const cudaError_t err = cudaFuncSetAttribute(                           \
        stem_wgrad_tc_kernel<C>,                                             \
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);                  \
    if (err != cudaSuccess) return static_cast<int>(err);                    \
    stem_wgrad_tc_kernel<C><<<blocks, THREADS, smem, as_stream(stream)>>>(  \
        dd, xx, pp, cout, n, h, wi, per);                                    \
    break;                                                                   \
  }
    STEM_CASES(CASE)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out [m] f32 = the sum over the slots of part [slots][m] f32 in
// common::tile_sum's fixed order
int stem_wgrad_sum_launch(const void* part, void* out, int slots, int m,
                          void* stream) {
  return common::tile_sum<StemWgradSum>(static_cast<const float*>(part),
                                        static_cast<float*>(out), slots, m,
                                        as_stream(stream));
}

}  // extern "C"
