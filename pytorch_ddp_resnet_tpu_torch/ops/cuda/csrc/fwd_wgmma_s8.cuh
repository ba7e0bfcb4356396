// The fused int8 block-half's forward GEMM, written for Hopper (sm_90a):
// y = bf16(f32(conv3x3(d_q, w_q)) * (ws[co] * amax_g / 127)) (+ res in
// bf16) in the channel-major layout [Cout, B*H*W], and per 128-row tile
// the f32 sums of the stored y and y^2, from the int8 slab its prepass
// wrote (fused_block.cu, fwd_slab_kernel).
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/fused_block.py:380,
// _fwd_call -> _fwd_kernel with quant=True, the int8 body): per lane tile
// (a scale group) the TPU kernel quantizes the prologue d in VMEM,
// contracts it at the nine taps with rolls of the tile on the MXU into s32,
// and dequantizes with the group's absmax and the weights' per-channel
// scales. Here the prepass writes the codes once, position-major, into the
// padded slab of ops/cuda/fused_block.py fused_fwd_layout (the bf16
// forward's, one byte a channel): past guard = W + 2 zero positions, image
// i takes (H + 1) * (W + 1) positions, a zero row above it and a zero
// column at the start of each row; zeros trail to whole 128-row tiles and a
// second guard. Tap (dh, dw) of M row m is slab row m + guard + (dh - 1) *
// (W + 1) + (dw - 1) for every row, image and width: one row offset, no
// masks, no shift in shared memory.
//   M = those padded positions in 128-row tiles, N = Cout, K = (tap,
//   channel), the packed weights' order ([Cout, 9 * Cin] int8, K-major).
//
// What bounds it on an H100: operations (2 * 9 * Cin * Cout * N: 60.4 GOP
// a call at each WRN-28-10 stage, batch 128, 0.0305 ms at 1,979 TOP/s; its
// operands are 21-32 MB). What the design does about it: the product is
// wgmma.mma_async m64nBNk32 s32 += s8 * s8, both operands K-major from
// swizzled shared memory (integer wgmma has no transposed operands), fed
// by TMA and an mbarrier ring so that copies and MMAs overlap.
// - K steps. No step spans two taps: each tap's Cin bytes are cut into
//   128-byte boxes, then one 64- and/or one 32-byte box for the rest (160 =
//   128 + 32, 320 = 2 * 128 + 64, 640 = 5 * 128, 96 = 64 + 32;
//   fused_fwd_int8_plan), so no channel is padded. A box of w bytes lands
//   in the w-byte swizzle (128, 64, 32) as TMA writes it, and the step's
//   descriptors name that swizzle: w / 32 k32 wgmmas a step.
// - A: a 2D map over the slab [slab_len, Cin], one box of 128 rows x w
//   bytes at (channel offset, m0 + shift[tap]): the guards keep every row
//   inside the slab, and every channel offset is a multiple of 16 bytes,
//   so TMA moves exactly what wgmma reads. B: a 2D map over the weights
//   [Cout, 9 * Cin], one box of BN rows x w bytes at (tap * Cin + offset,
//   n0); rows past Cout read as zeros. One pair of maps for each width.
// - Pipeline: a ring of STAGES slots (A then B), two mbarriers a slot:
//   `full` (TMA's bytes, expect_tx by the thread that starts the loads)
//   and `empty` (the block's 256 threads arrive once their warpgroup's
//   wgmmas that read the slot have retired). Two warpgroups of 64 rows
//   each, one wgmma group in flight; thread 0 also starts the loads, two a
//   step: the first STAGES steps up front, then each slot again as soon as
//   both warpgroups have freed it (a producer warp of its own would cost
//   the registers that a second block an SM needs: at 288 threads ptxas
//   finds 96 a thread for m64n160's 80 accumulators). BN = 160 wherever
//   Cout % 160 == 0 (every WRN-28-10 width: no column padded), else 128 or
//   64 with a masked ragged last tile. Two blocks an SM, three slots at BN
//   = 160, so one block's epilogue overlaps the other's mainloop (one block
//   an SM with a six-slot ring was 1.2x slower on an H100). The tap's box
//   mix (Cin % 128) and the residual are template parameters, so every
//   wgmma has its width at compile time (ptxas serializes wgmmas chosen on
//   a runtime branch: note C7520) and the epilogue without a residual keeps
//   its registers.
// - Epilogue (fwd_wgmma_bf16.cuh's, with a dequantization in front): each
//   M row's lane and scale group (a 128-row tile may span two groups: 1,089
//   / 289 / 81 padded positions an image at the three stages), the row's
//   scale amax_g * (1/127), then y = bf16(f32(acc) * (ws[co] * rowscale))
//   (the reference's order, two __fmul_rn, no FMA) staged channel-major in
//   the ring's memory; the residual added in the same 16-byte runs as y is
//   written (bf16(f32(res) + f32(y)); the residual's vectors copied by
//   cp.async into the ring's memory while the accumulators are staged);
//   the staged final values summed per channel in a fixed order
//   (fwd_staged_s8.cuh's sums_cm) into part[tile]. fused_block.cu's
//   tile_sum adds the tiles in a fixed order (runs of tiles, then the
//   runs): y is bit-equal to the plain version and its sums the same bit
//   for bit every run.
//
// The kernel with that epilogue (fwd_s8_kernel) and its launchers live in
// fused_block.cu, their one caller, so that the files that include this
// header for its mainloop do not build them. The mainloop (mainloop<BN,
// REM>, with tap_rows and encode_maps on the host) is shared with the int8
// serving conv, requant_wgmma_s8.cuh, which runs it on the same slab
// layout with a requantizing epilogue; with the lane transition's FQT
// dgrad (transition.cu), which walks one parity class's range of taps at a
// time at BN = 80 (two accumulators a thread); and with the NV halves' FQT
// dgrad (nv_dgrad_wgmma_s8.cuh), which walks the 3x3's taps mirrored, or
// the 1x1's one tap, over all the row chunks' slabs of one map.
//
// Left for later: persistent blocks, clusters and TMA multicast of the A
// boxes across the N tiles of one M tile, the pad rows (6.3% at 32x32).

#pragma once

#include <cuda.h>  // CUtensorMap (types only: the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"            // kInv127
#include "fwd_staged_s8.cuh"     // CM_OS, sums_cm
#include "fwd_wgmma_bf16.cuh"    // live_before, write_res_cm, wgmma fences
#include "wgrad_wgmma_bf16.cuh"  // mbarriers, TMA loads, the map encoder
#include "wgrad_wgmma_s8.cuh"    // wgmma_s8<BN>, fence_acc

namespace fwd_wgmma_s8 {

using fwd_staged_s8::CM_OS;
using fwd_wgmma_bf16::live_before;
using fwd_wgmma_bf16::wgmma_commit;
using fwd_wgmma_bf16::wgmma_fence;
using fwd_wgmma_bf16::wgmma_wait;
using wgrad_staged::cp_async16;
using wgrad_staged::cp_async_commit;
using wgrad_staged::cp_async_wait;
using wgrad_staged::smem_u32;
using wgrad_wgmma_bf16::EncodeTiled;
using wgrad_wgmma_bf16::encoder;
using wgrad_wgmma_bf16::mbar_arrive;
using wgrad_wgmma_bf16::mbar_arrive_tx;
using wgrad_wgmma_bf16::mbar_init;
using wgrad_wgmma_bf16::mbar_wait;
using wgrad_wgmma_bf16::tma_load_2d;
using wgrad_wgmma_s8::fence_acc;
using wgrad_wgmma_s8::wgmma_s8;

constexpr int THREADS = 256;                // two consumer warpgroups
constexpr int BM = 128;                     // M rows a tile, 64 a warpgroup
constexpr int BK = 128;                     // bytes of the widest K step
constexpr int ALIGN = 1024;                 // a 128-byte swizzle atom
static_assert(THREADS == fwd_wgmma_bf16::THREADS &&
                  THREADS == wgrad_staged::THREADS,
              "the epilogue's loops take the block's threads");
static_assert(BM == fwd_staged_s8::BM, "the staged tile's rows");

// One BN-wide tile's shared memory at two blocks an SM: a ring of STAGES
// slots, each A (BM rows) then B (BN rows) of up to 128 bytes, a box of w
// bytes taking the first BM * w / BN * w bytes of its part; after the
// mainloop the staged bf16 tile [BN][CM_OS], each row's place in the run
// (at[]) and its scale, and the residual's tile [BN][CM_OS] reuse it; then
// the full and empty mbarriers, and room to align the ring.
template <int BN>
struct Tile {
  static constexpr int A_BYTES = BM * BK;
  static constexpr int STAGE_BYTES = (BM + BN) * BK;
  static constexpr int BUDGET = wgrad_staged::SMEM_PER_BLOCK;
  static constexpr int STAGES = (BUDGET - ALIGN - 128) / STAGE_BYTES;
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int SMEM = RING + 16 * STAGES + ALIGN;
  static constexpr int NACC = BN / 2;  // s32 accumulators a thread
  static constexpr int AT_OFF = BN * CM_OS * 2;
  static constexpr int RES_OFF = AT_OFF + 2 * BM * 4;  // the residual tile
  static_assert(STAGES >= 2 && STAGES <= 8, "a ring");
  static_assert(SMEM <= BUDGET, "the block's shared memory");
  static_assert(STAGE_BYTES % ALIGN == 0 && A_BYTES % ALIGN == 0, "atoms");
  static_assert(RES_OFF % 16 == 0 && RES_OFF + BN * CM_OS * 2 <= RING,
                "the epilogue fits the ring");
};

// The maps of one launch, a pair for each K-step width (128, 64, 32
// bytes: index 0, 1, 2).
struct Maps {
  CUtensorMap a[3];  // the slab [slab_len][cin]
  CUtensorMap b[3];  // the weights [cout][9 * cin]
};

// A shared-memory matrix descriptor: K-major, the w-byte swizzle (w = 128
// >> sel; layout type 1, 2, 3), 8-row groups 8 * w bytes apart (the stride
// byte offset), start address in 16s.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int sel) {
  const uint64_t sbo = (uint64_t)(64 >> sel);  // 8 * w / 16
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (sbo << 32) |
         ((uint64_t)(sel + 1) << 62);
}

// The K steps of a tile: tap after tap, each tap's Cin bytes in n128
// boxes of 128 bytes, then (REM = Cin % 128) one of 64 where REM & 64 and
// one of 32 where REM & 32. Step k's tap, byte offset and width selector
// (w = 128 >> sel).
template <int REM>
__device__ __forceinline__ void step_at(int k, int n128, int& t, int& o,
                                        int& sel) {
  const int per = n128 + ((REM & 64) != 0) + ((REM & 32) != 0);
  t = k / per;
  const int j = k - t * per;
  o = j < n128 ? 128 * j : 128 * n128 + (j > n128 ? 64 : 0);
  sel = j < n128 ? 0 : ((REM & 64) && j == n128 ? 1 : 2);
}

// Thread 0 starts step k's two TMA loads into its slot (shift[t]: the
// slab row of the walk's tap t for M row 0; its weights are tap t0 + t's).
template <int BN, int A_BYTES, int REM>
__device__ __forceinline__ void issue(const Maps& mp, int cin,
                                      const int* shift, int t0, int k,
                                      int n128, uint32_t st, uint32_t bar,
                                      int m0, int n0) {
  int t, o, sel;
  step_at<REM>(k, n128, t, o, sel);
  mbar_arrive_tx(bar, (BM + BN) * (BK >> sel));
  tma_load_2d(st, &mp.a[sel], bar, o, m0 + shift[t]);
  tma_load_2d(st + A_BYTES, &mp.b[sel], bar, (t0 + t) * cin + o, n0);
}

// One K step of W bytes (W / 32 k32 wgmmas in the W-byte swizzle): wait
// for the slot's bytes, issue and commit, wait until this warpgroup's
// previous step retired and free its slot; thread 0 then waits until both
// warpgroups have freed it and refills it with the step S ahead of that
// one. The wgmmas sit on no runtime branch (a compile-time W each), so
// ptxas keeps them in flight.
template <int BN, int W, int S, int STAGE_BYTES, int A_BYTES, int REM>
__device__ __forceinline__ void k_step(int (&acc)[BN / 2], int& i,
                                       int steps, int n128, uint32_t ring,
                                       uint32_t full, uint32_t empty,
                                       const Maps& mp, int cin,
                                       const int* shift, int t0, int m0,
                                       int n0) {
  constexpr int SEL = W == 128 ? 0 : (W == 64 ? 1 : 2);
  const int s = i % S;
  mbar_wait(full + 8 * s, (i / S) & 1);
  const uint32_t st = ring + s * STAGE_BYTES;
  const uint64_t da = smem_desc(st + (threadIdx.x / 128) * 64 * W, SEL);
  const uint64_t db = smem_desc(st + A_BYTES, SEL);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < W / 32; ++k)
    wgmma_s8<BN>(acc, da + 2 * k, db + 2 * k, 1);
  wgmma_commit();
  wgmma_wait<1>();  // this warpgroup's step i - 1 retired
  if (i > 0) {
    const int j = i - 1, sj = j % S;
    mbar_arrive(empty + 8 * sj);
    if (threadIdx.x == 0 && j + S < steps) {
      mbar_wait(empty + 8 * sj, (j / S) & 1);  // both warpgroups' too
      issue<BN, A_BYTES, REM>(mp, cin, shift, t0, j + S, n128,
                              ring + sj * STAGE_BYTES, full + 8 * sj, m0,
                              n0);
    }
  }
  ++i;
}

// acc = the products of M tile m0 (128 slab rows from m0) and the BN
// weight rows from n0 over every K step of a tap range's boxes: ntaps
// taps, the walk's tap t reading slab rows from shift[t] (for M row 0)
// against the weight columns of tap t0 + t (REM = Cin % 128 names a tap's
// last boxes). The 3x3 convs walk all nine taps (t0 = 0, ntaps = 9, a
// count the compiler sees); the stride-2 transition's dgrad walks one
// parity class's taps, a range of the plane-major weights. The mbarriers
// are set up at ring + RING (a block that runs the mainloop again on the
// ring ends them first: ring_inval), thread 0 starts the first STAGES
// steps' loads, then k_step after k_step. Returns with every wgmma of both
// warpgroups retired and every thread past its last read of the ring,
// which the epilogue may then reuse.
template <int BN, int REM>
__device__ __forceinline__ void mainloop(const Maps& mp, int cin,
                                         const int* shift, uint32_t ring,
                                         int m0, int n0, int (&acc)[BN / 2],
                                         int t0 = 0, int ntaps = 9) {
  using T = Tile<BN>;
  constexpr int S = T::STAGES;
  const uint32_t full = ring + T::RING, empty = full + 8 * S;
  const int n128 = cin / BK;
  const int steps =
      ntaps * (n128 + ((REM & 64) != 0) + ((REM & 32) != 0));

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < S && k < steps; ++k)
      issue<BN, T::A_BYTES, REM>(mp, cin, shift, t0, k, n128,
                                 ring + k * T::STAGE_BYTES, full + 8 * k, m0,
                                 n0);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < T::NACC; ++i) acc[i] = 0;
  int i = 0;
  for (int t = 0; t < ntaps; ++t) {
    for (int j = 0; j < n128; ++j)
      k_step<BN, 128, S, T::STAGE_BYTES, T::A_BYTES, REM>(
          acc, i, steps, n128, ring, full, empty, mp, cin, shift, t0, m0,
          n0);
    if constexpr ((REM & 64) != 0)
      k_step<BN, 64, S, T::STAGE_BYTES, T::A_BYTES, REM>(
          acc, i, steps, n128, ring, full, empty, mp, cin, shift, t0, m0,
          n0);
    if constexpr ((REM & 32) != 0)
      k_step<BN, 32, S, T::STAGE_BYTES, T::A_BYTES, REM>(
          acc, i, steps, n128, ring, full, empty, mp, cin, shift, t0, m0,
          n0);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  __syncthreads();  // every wgmma of both warpgroups retired: the ring is free
}

// Ends the ring's mbarriers after a mainloop (every thread past it, every
// load landed), so that a second mainloop on the same ring may set them up
// again.
template <int BN>
__device__ __forceinline__ void ring_inval(uint32_t ring) {
  using T = Tile<BN>;
  if (threadIdx.x == 0)
    for (int s = 0; s < 2 * T::STAGES; ++s)
      asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(
                       ring + T::RING + 8 * s)
                   : "memory");
}

// --- the host side: tensor maps --------------------------------------------

// The map of t [rows][cols] int8 (row-major, cols % 16 == 0) in boxes of
// box_rows rows x w bytes in the w-byte swizzle (w = 128, 64 or 32).
// Out-of-bounds bytes read as zero. Returns false where the encoder is
// missing or refuses.
inline bool encode(CUtensorMap* map, const void* t, long rows, int cols,
                   int box_rows, int w) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)w, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1u, 1u};
  const CUtensorMapSwizzle sw =
      w == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
               : (w == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B);
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(t),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Slab row of tap t for M row 0 (guard = wi + 2): one row offset for every
// M row, image and width.
inline void tap_rows(int (&shift)[9], int wi) {
  for (int t = 0; t < 9; ++t)
    shift[t] = wi + 2 + (t / 3 - 1) * (wi + 1) + t % 3 - 1;
}

// The maps of one launch over the slab [slab_len][cin] and the weights
// [cout][taps * cin] in boxes of BM and bn rows: only the widths the K
// steps take (a box wider than the channels is never encoded); the others
// stay zero and are never read. False where the encoder is missing or
// refuses.
inline bool encode_maps(Maps* mp, const void* slab, long slab_len,
                        const void* w, int cin, int cout, int bn,
                        int taps) {
  *mp = Maps{};
  for (int sel = 0; sel < 3; ++sel) {
    const int wd = BK >> sel;
    const bool used = sel == 0 ? cin >= BK : ((cin % BK) & wd) != 0;
    if (used && (!encode(&mp->a[sel], slab, slab_len, cin, BM, wd) ||
                 !encode(&mp->b[sel], w, cout, taps * cin, bn, wd)))
      return false;
  }
  return true;
}

}  // namespace fwd_wgmma_s8
