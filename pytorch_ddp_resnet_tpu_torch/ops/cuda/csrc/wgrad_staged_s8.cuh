// The staged weight-gradient mainloop for int8 slabs, written for Hopper
// (sm_90a): per chunk, S = sum over its positions of int8(a, shifted)^T .
// int8(g), one exact s32 tile per (M tile, N tile, chunk, split) block.
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/bneck_nv_train.py:928,
// _wgrad1x1_kernel / _wgrad3x3_kernel with quant_bwd=True, the int8 body):
// the TPU kernel quantizes each chunk's slab once, halo rows included, at
// the chunk's scale (_quantize_chunk) and contracts it at the 9 tap shifts,
// each one constant row offset of its [h, wp, N, C] carrier (shift_rows).
// Here a prepass (bneck_nv_train.cu, nvt_wgrad_pre_kernel) writes each
// chunk's int8 slabs once, channel-major with K contiguous, in the layout
// of ops/cuda/bneck_nv_train.py wgrad_int8_layout: position (r, c, i) of a
// chunk (image i padded to n16 = 16 * ceil(n / 16), column c of a row of
// wq = w + 1, whose last column is zero) sits at k = (r * wq + c) * n16 + i;
// the g slab [chunks][cout][lg] holds the chunk's rows, the a slab
// [chunks][cin][la] also the halo rows (3x3: at the chunk's scale, zero
// outside the image) and n16 zero guard bytes at each end. Tap (dy, dx)
// reads a at k + shift[tap], shift = guard + (dy * wq + dx - 1) * n16, a
// multiple of 16 bytes: the zero column is the left neighbour of column 0
// and the right one of column w - 1, so the mainloop has no masks. The
// sum of the split tiles, then of the chunks at their scales, is
// bneck_nv_train.cu's nvt_wgrad_sum_kernel.
//   M = (tap, ci) rows of dW, N = Cout, K = the lg positions of one chunk,
//   split over blocks in runs of whole K steps of K_STEP positions.
//
// What bounds it on an H100: at ResNet-50's stages 1-2 (batch 128) the
// function's bytes (x, res, dy, y in, dW out: 23-153 us a call at 3.35
// TB/s) outweigh its 13-30 G int8 operations (6.7-15 us at 1979 TOP/s);
// the 3x3 of stage 3 is bound by operations. What the design
// does about it: the prologue, the fold and the quantization run once per
// slab element (the prepass), not once per (tap, N tile) that reads it;
// the mainloop only copies slab rows as they lie in memory (cp.async.cg,
// 16 bytes a thread, a ring of STAGES tiles in dynamic shared memory, one
// barrier per K step) into K-contiguous shared rows that plain ldmatrix.x4
// feeds to mma.sync m16n8k32 s8 -> s32; each A row's source offset (tap
// shift and channel) is constant over K and worked out once a thread, so a
// tile may straddle taps (Cin = 64 with BM = 128); a 128-wide N tile reads
// A ceil(Cout / 128) times; blocks with neighbouring blockIdx.x share
// their (chunk, split) and so read the same g rows and overlapping a rows
// through L2. The slabs are K-major, as wgmma's s8 operands must be.
//
// Shared-memory tiles: A as [BM rows][K_STEP bytes + 16], B as [BN rows]
// [K_STEP bytes + 16]; the 16-byte pad puts the eight 16-byte rows an
// ldmatrix reads in distinct banks. Rows of M past taps * cin and of N past
// cout are zero-filled (cp.async src-size 0).
//
// Left for later: wgmma and TMA on the K-major slabs (the mainloop is
// mma.sync with cp.async), clusters, one launch per pass (the split tiles
// go to device memory and a second kernel adds them in order), and the
// prepass's bytes (the slabs are written once and read back).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgrad_staged.cuh"  // cp.async helpers, THREADS, SMEM_PER_BLOCK

namespace wgrad_staged_s8 {

using wgrad_staged::cp_async16;
using wgrad_staged::cp_async_commit;
using wgrad_staged::cp_async_wait;
using wgrad_staged::smem_u32;
using wgrad_staged::SMEM_PER_BLOCK;
using wgrad_staged::THREADS;

// positions (int8 bytes) a K step (the planner's WGRAD_S8_BK)
constexpr int K_STEP = 128;

struct Args {
  const signed char* a;  // [chunks][cin][la] int8 slabs
  const signed char* g;  // [chunks][cout][lg]
  int* part;             // [chunks][splits][taps * cin][cout] s32
  int cin, cout, taps;
  int la, lg;            // bytes of a slab row
  int steps;             // K steps of a chunk (lg / K_STEP)
  int per;               // K steps per split (the last may have fewer)
  int splits;
  // tap (dy, dx)'s a offset of position 0: shift0 + dy * shift_row + dx *
  // shift_col (the layout's shifts; the 1x1's tap is (0, 0))
  int shift0, shift_row, shift_col;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Tile geometry: K_STEP bytes a K step, a ring of STAGES steps (4 where two
// blocks' rings still fit on one SM, else 3); 8 warps, BM / 32 along M (32
// rows each), the rest along N. K_STEP / 16 threads copy each row, the
// block's 256 threads RPP rows at once, PA (PB) pieces of A (B) each.
template <int BM, int BN>
struct Tile {
  static constexpr int ROW = K_STEP + 16;  // bytes per padded row
  static constexpr int A_BYTES = BM * ROW;
  static constexpr int STAGE_BYTES = (BM + BN) * ROW;
  static constexpr int STAGES = 4 * STAGE_BYTES <= SMEM_PER_BLOCK ? 4 : 3;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
  static constexpr int WARPS_M = BM / 32;
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int WN = BN / WARPS_N;  // columns per warp
  static constexpr int NI = WN / 8;        // n8 fragments per warp
  static constexpr int PPR = K_STEP / 16;  // 16-byte pieces a row
  static constexpr int RPP = THREADS / PPR;
  static constexpr int PA = BM / RPP;
  static constexpr int PB = BN / RPP;
  static_assert(BM == 64 || BM == 128, "BM");
  static_assert(BN == 64 || BN == 128, "BN");
  static_assert(BM % RPP == 0 && BN % RPP == 0, "whole pieces a thread");
  static_assert(WN % 16 == 0, "a warp takes pairs of n8 fragments");
  static_assert(STAGES * STAGE_BYTES <= SMEM_PER_BLOCK, "two blocks an SM");
};

// Grid (ceil(taps*cin / BM), ceil(cout / BN), chunks * splits): block z
// takes K steps [split * per, min(steps, (split + 1) * per)) of chunk
// z / splits and writes its s32 tile to part[z].
template <int BM, int BN>
__global__ void __launch_bounds__(THREADS, 2) wgrad_staged_s8_kernel(Args p) {
  using T = Tile<BM, BN>;
  constexpr int STAGES = T::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int M = p.taps * p.cin;
  const int chunk = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const int kt0 = split * p.per;
  const int kt1 = min(p.steps, kt0 + p.per);

  // This thread's copies: piece tid % PPR of rows tid / PPR + RPP * i. An
  // A row's source is its channel's slab row at its tap's shift (a 32-bit
  // offset: the wrapper keeps a slab under 2 GB), a B row's its output
  // channel's, RPP slab rows apart; both then advance by K_STEP a step.
  const int piece = tid % T::PPR, r0 = tid / T::PPR;
  uint32_t a_off[T::PA];
  bool a_ok[T::PA];
#pragma unroll
  for (int i = 0; i < T::PA; ++i) {
    const int m = m0 + r0 + T::RPP * i;
    a_ok[i] = m < M;
    const int tap = a_ok[i] ? m / p.cin : 0;
    const int ci = a_ok[i] ? m - tap * p.cin : 0;
    a_off[i] = (uint32_t)(chunk * p.cin + ci) * p.la + p.shift0 +
               tap / 3 * p.shift_row + tap % 3 * p.shift_col + piece * 16;
  }
  const signed char* b_src =
      p.g + ((size_t)chunk * p.cout + n0 + r0) * p.lg + piece * 16;
  const int b_rows = p.cout - n0 - r0;  // piece i is live while RPP*i < this
  const uint32_t s0 = smem_u32(smem);
  const uint32_t a_dst = r0 * T::ROW + piece * 16;
  const uint32_t b_dst = T::A_BYTES + a_dst;

  auto load = [&](int kt, int stage) {
    const uint32_t st = s0 + stage * T::STAGE_BYTES;
    const size_t off = (size_t)kt * K_STEP;
#pragma unroll
    for (int i = 0; i < T::PA; ++i)
      cp_async16(st + a_dst + i * T::RPP * T::ROW,
                 a_ok[i] ? p.a + a_off[i] + off : p.a, a_ok[i]);
#pragma unroll
    for (int i = 0; i < T::PB; ++i) {
      const bool ok = T::RPP * i < b_rows;
      cp_async16(st + b_dst + i * T::RPP * T::ROW,
                 ok ? b_src + (size_t)i * T::RPP * p.lg + off : p.g, ok);
    }
  };

  // ldmatrix.x4 lanes: lane l addresses row (l % 8) of matrix l / 8. A (m16
  // x k32 bytes): (m 0-7, k 0-15), (m 8-15, k 0-15), (m 0-7, k 16-31),
  // (m 8-15, k 16-31) = a0..a3 of m16n8k32. B (n16 x k32): (n 0-7, k 0-15),
  // (n 0-7, k 16-31), (n 8-15, k 0-15), (n 8-15, k 16-31) = b0, b1 of n8
  // fragment 0, then of fragment 1.
  const int q = lane / 8, j = lane % 8;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const uint32_t a_ld = (wm * 32 + (q & 1) * 8 + j) * T::ROW + (q >> 1) * 16;
  const uint32_t b_ld =
      T::A_BYTES + (wn * T::WN + (q >> 1) * 8 + j) * T::ROW + (q & 1) * 16;

  int acc[2][T::NI][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (kt0 + s < kt1) load(kt0 + s, s);
    cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step kt's tile landed; step kt-1's reads are done
    const int next = kt + STAGES - 1;
    if (next < kt1) load(next, (next - kt0) % STAGES);
    cp_async_commit();
    const uint32_t st = s0 + ((kt - kt0) % STAGES) * T::STAGE_BYTES;
#pragma unroll
    for (int ks = 0; ks < K_STEP / 32; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], st + a_ld + mi * 16 * T::ROW + ks * 32);
#pragma unroll
      for (int nj = 0; nj < T::NI / 2; ++nj) {
        uint32_t bf[4];
        ldmatrix_x4(bf, st + b_ld + nj * 16 * T::ROW + ks * 32);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_s8(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
          mma_s8(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the s32 tile: fragment (mi, ni) holds rows g, g + 8 and columns 2t, 2t + 1
  int* out = p.part + (size_t)blockIdx.z * M * p.cout;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni) {
      const int n = n0 + wn * T::WN + ni * 8 + (lane % 4) * 2;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = m0 + wm * 32 + mi * 16 + lane / 4 + hr * 8;
        if (m < M && n < p.cout)
          *reinterpret_cast<int2*>(out + (size_t)m * p.cout + n) =
              make_int2(acc[mi][ni][2 * hr], acc[mi][ni][2 * hr + 1]);
      }
    }
}

}  // namespace wgrad_staged_s8
