// The FQT (int8) weight gradients of the lane transition and of the fused
// block-half, written for Hopper (sm_90a): TMA reads the quantized
// activation d (the transition's four parity planes, the fused half's one
// plane) and the quantized cotangent g where they lie, a shifter warpgroup
// moves each tap's plane by the tap's row and column shift in shared
// memory, and two consumer warpgroups run s8 wgmma into s32 tiles that each
// block folds, scale group after scale group, into an f32 tile of dW, or
// (split over the scale groups) writes group by group to slots that
// launch_slot_sum folds in group order.
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/transition.py:619,
// transition_half_int8's backward -> _bwd_kernel with quant_bwd=True, its
// wgrad): per tile of output lanes (a scale group) the TPU kernel builds
// the nine taps' patches of the int8 planes in VMEM, contracts them with the
// int8 cotangent on the MXU into s32, and adds the group's f32 contribution
// (the s32 sum times (d_amax * g_amax) / 127^2) into dW across its
// sequential grid (_w_init / _w_acc); the fused half's
// (pytorch_ddp_resnet_tpu/ops/pallas/fused_block.py:763 _wgrad_call ->
// _wgrad_kernel, and the wgrad half of _bwd_kernel) does the same at the
// nine stride-1 taps of one plane. Here one GEMM over output positions,
//   dW[(tap, ci), co] = sum over groups g, in order, of
//     f32(sum_{p in g} d[plane(tap)][ci, p + shift(tap)] * g[co, p]) * ts_g,
//   M = taps * Cin rows in (tap, ci) order, N = Cout, K = positions,
// both operands K-major as they lie (d [4][Cin][N'], g [Cout][N'] int8).
//
// What bounds it on an H100: operations (2 * 9 * Cin * Cout * N': 30.2 GOP
// a call at both WRN-28-10 transitions, batch 128, 0.0153 ms at 1,979
// TOP/s). What the design does about it: the product is wgmma.mma_async
// m64nBNk32 s32 += s8 * s8 from K-major, 128-byte-swizzled shared memory
// (integer wgmma has no transposed operands: both tiles are K-major), fed by
// TMA and an mbarrier ring so that copies and MMAs overlap; the s32 tile is
// exact within a group, and at each group's end the consumers fold it into
// an f32 running tile with the reference's roundings (__int2float_rn, then
// __fmul_rn by ts_g, then __fadd_rn in group order; never an FMA), so dW is
// bit-equal to the plain version and between calls in one launch, with no
// partial buffer. Measured on an H100 (PERF.md): 200-450 TOP/s at
// the two transitions; the blocks are paced by their TMA boxes (without
// the shifting and the wgmmas a block takes 80% of its time), not by the
// tensor cores.
// - The A tile. A K step is 128 positions, 128 bytes of a d row: the
//   128-byte swizzle and the descriptors of fwd_wgmma_bf16.cuh carry over
//   in bytes. TMA cannot start a box at an innermost offset that is not a
//   multiple of 16 bytes, and a tap's shift is rs * OW + cs bytes (rs, cs
//   in {-1, 0, 1}: one byte for a column, OW for a row, and a K step may
//   span images). So for each 32-channel piece of the M tile (32 rows of one
//   tap) the producer stages, through a flat [planes * Cin, N'] map, the
//   step's 128 bytes of the tap's plane and the 16-byte unit before them,
//   moved by the shift rounded down to 16 bytes (XROW = 144 bytes a row;
//   coordinates before the tensor read as zeros). A shifter warp is one
//   piece, so the shift is the same across it; a lane owns one 16-byte
//   unit of the step (the same 16 positions) in 8 of the piece's rows: it
//   takes the unit's 16 bytes at the shift's remainder (0-15 bytes) from
//   two neighbouring staged units (byte permutes; the word offset is a
//   template parameter), zeroes the bytes whose source falls off the
//   output pixel's image (row 0 of each image where rs = -1, the last row
//   where rs = 1, column 0 where cs = -1, the last column where cs = 1:
//   this also masks the bytes that come from a neighbouring image or from
//   outside the tensor, which TMA fills with zeros; one mask a step for the
//   unit, from its place in the image carried step to step), and stores
//   them at the 128-byte swizzle's place.
// - The B tile: g viewed (N', Cout), one box a step of BN rows of 128
//   bytes, lands in the 128-byte swizzle as it is.
// - Pipeline, a ring of STAGES slots (A, B, staged d), three mbarriers a
//   slot: `load` (TMA's bytes, expect_tx by the producer), `full` (the live
//   pieces' shifters arrive after a fence.proxy.async that orders their
//   shared-memory writes before wgmma's reads), `empty` (the 256 consumer
//   threads arrive once their warpgroup's wgmmas that read the slot have
//   retired). One producer warp in which one thread starts the loads (live
//   pieces + 1 a step), the shifter warpgroup, two consumer warpgroups of
//   64 rows each, four k32 wgmmas a K step, one group in flight except at a
//   scale group's end, where the consumers wait for all of theirs, fold,
//   and the next step's first wgmma starts the s32 tile afresh (scale-d 0).
//   One block an SM (the ring takes the shared memory).
// - Grid (N tiles, M tiles, runs): without SLOTS one run, and each block
//   walks every K step of every group of its (128, BN) tile of dW and
//   writes the finished f32 tile once, in dW's [taps * Cin][Cout] order
//   (JAX's HWIO). With SLOTS the scale groups are split into runs of gpb,
//   a block each, where the tiles alone leave SMs idle: f32 addition does
//   not associate, so a run cannot fold its groups into one partial; each
//   group's f32 contribution (the same __int2float_rn and __fmul_rn) goes
//   to the group's slot, in the fragment's order (float4 stores, no
//   branch), and launch_slot_sum's kernel adds the slots in group order
//   into dW: the same roundings in the same order, so the same bits.
//
// Tried on an H100 and dropped (PERF.md): an A ring apart from an
// 8-deep TMA ring (no faster); boxes of 128-byte rows in the 128-byte
// swizzle from the shift rounded up, the bytes before the step taken from
// the previous step's box and the unshifted taps' boxes landing in A (TMA
// 23% faster, the shifting slower: no faster in all, with one or two
// shifter warpgroups). Left for later: clusters and TMA multicast of the
// staged rows across a cluster's N tiles (each block loads its boxes
// itself, and each d row once a tap), persistent blocks.

#pragma once

#include <cuda.h>  // CUtensorMap (types only: the encoder is fetched at run time)
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"            // kInv16129
#include "wgrad_wgmma_bf16.cuh"  // mbarriers, TMA loads, the encoder, wgmma

namespace wgrad_wgmma_s8 {

using fwd_wgmma_bf16::smem_desc;
using fwd_wgmma_bf16::wgmma_commit;
using fwd_wgmma_bf16::wgmma_fence;
using fwd_wgmma_bf16::wgmma_wait;
using wgrad_staged::smem_u32;
using wgrad_wgmma_bf16::EncodeTiled;
using wgrad_wgmma_bf16::encoder;
using wgrad_wgmma_bf16::mbar_arrive;
using wgrad_wgmma_bf16::mbar_arrive_tx;
using wgrad_wgmma_bf16::mbar_init;
using wgrad_wgmma_bf16::mbar_wait;
using wgrad_wgmma_bf16::tma_load_2d;

constexpr int CONSUMERS = wgrad_wgmma_bf16::CONSUMERS;  // two warpgroups
constexpr int SHIFTERS = wgrad_wgmma_bf16::SHIFTERS;    // one M row each
constexpr int THREADS = wgrad_wgmma_bf16::THREADS;      // and the producer
constexpr int BM = 128;        // M rows a tile, 64 a consumer warpgroup
constexpr int BK = 128;        // positions (bytes) a K step
constexpr int PIECE = 32;      // M rows (channels of one tap) a staged box
constexpr int XROW = BK + 16;  // bytes a staged row: a unit before the step
constexpr int XPIECE = PIECE * XROW;
constexpr int ALIGN = 1024;    // a 128-byte swizzle atom
constexpr int SMEM_MAX = wgrad_wgmma_bf16::SMEM_MAX;
constexpr int MAX_TAPS = 9;
static_assert(SHIFTERS == 4 * PIECE && BM == 4 * PIECE, "a warp a piece");

// One BN-wide tile's shared memory: a ring of STAGES slots, each A (BM
// rows), B (BN rows), both 128-byte-swizzled, and d staged for A's four
// pieces; folding in the block at BN >= 128, the f32 running tile
// (OUT_SMEM: a thread's 64 s32 accumulators and 64 f32 sums would take all
// of the 128 registers a thread of 416 gets, and ptxas then serializes the
// wgmmas; with SLOTS there is no running tile); then STAGES load, full and
// empty mbarriers, and room to align the ring.
template <int BN, bool SLOTS = false>
struct Tile {
  static constexpr int A_BYTES = BM * BK;
  static constexpr int B_BYTES = BN * BK;
  static constexpr int X_OFF = A_BYTES + B_BYTES;
  static constexpr int STAGE_BYTES = X_OFF + 4 * XPIECE;
  static constexpr bool OUT_SMEM = !SLOTS && BN >= 128;
  static constexpr bool OUT_REGS = !SLOTS && !OUT_SMEM;
  static constexpr int OUT_BYTES = OUT_SMEM ? BM * BN * 4 : 0;
  static constexpr int FIT =
      (SMEM_MAX - ALIGN - 128 - OUT_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT > 6 ? 6 : FIT;
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int SMEM = RING + OUT_BYTES + 24 * STAGES + ALIGN;
  static constexpr int NACC = BN / 2;  // s32 (and f32) accumulators a thread
  static_assert(STAGES >= 2, "a ring");
  static_assert(SMEM <= SMEM_MAX, "the block's shared memory");
  static_assert(X_OFF % ALIGN == 0 && STAGE_BYTES % ALIGN == 0, "atoms");
};

struct Args {
  float* dw;             // [taps * cin][cout] f32, or with SLOTS the slots
                         // [groups][M tiles][N tiles][BM * BN] f32
  const float* g_amax;   // [groups]
  const float* d_amax;   // [groups]
  int cin, cout;         // cin % 32 == 0, cout % 8 == 0
  int ow, ohw;           // output row width, positions an image (% 16)
  int steps, spg;        // K steps in all, K steps a scale group
  int gpb;               // scale groups a block (a run: blockIdx.z)
  int taps;              // M = taps * cin rows, in (tap, ci) order
  // tap t reads plane plane[t] moved by rs[t] rows and cs[t] columns (each
  // -1, 0 or 1): d[plane][ci][(r + rs, c + cs)], zero off the image
  int plane[MAX_TAPS], rs[MAX_TAPS], cs[MAX_TAPS];
};

// d (64 x BN s32, per warpgroup) = (scale_d ? d : 0) + A (64 x 32 s8,
// K-major) * B (BN x 32 s8, K-major)^T. The fragment of thread t (warp w
// of its warpgroup, lane l): d[4 j + 2 h + e] is row 16 w + l / 4 + 8 h,
// column 8 j + 2 (l % 4) + e (as the f32 wgmma's).
template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t a,
                                         uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<80>(int (&d)[40], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39}, %40, %41, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<160>(int (&d)[80], uint64_t a,
                                            uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79}, %80, %81, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Keeps the compiler from moving a read of the accumulators above the
// wgmma_wait that makes them final.
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The 16 bytes at byte 4 W + o of the 32 bytes lo, hi (o = 0-3, sel =
// 0x3210 + 0x1111 o: a byte permute's selector).
template <int W>
__device__ __forceinline__ uint4 bytes_at(uint4 lo, uint4 hi, uint32_t sel) {
  const uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  return make_uint4(
      __byte_perm(v[W], v[W + 1], sel), __byte_perm(v[W + 1], v[W + 2], sel),
      __byte_perm(v[W + 2], v[W + 3], sel),
      __byte_perm(v[W + 3], v[W + 4], sel));
}

// A byte mask from 4 bits: byte k is 0xFF where bit k of n is set.
__device__ __forceinline__ uint32_t byte_mask(uint32_t n) {
  return ((n * 0x00204081u) & 0x01010101u) * 0xFFu;
}

// The shifter warpgroup: warp q copies piece q (32 rows of one tap) of each
// of the block's nk K steps (from position p0) of staged d into the A
// tile. Lane l takes the 16-byte unit k = l % 8 of rows l / 8 + 4 r, r < 8:
// the unit's 16 bytes at the tap's shift from two staged units (their word
// offset W a template parameter, so no selects), the bytes whose source
// falls off the image zeroed. Those depend on the unit's 16 positions
// alone (one image: ohw % 16 == 0), so a lane computes its keep mask once a
// step, from the place t in the image and the column c of the unit's first
// position, both carried from step to step without a division: row 0 of
// the image where rs < 0 (t < ow), its last row where rs > 0 (t + j >= ohw
// - ow), column 0 where cs < 0 (every ow-th byte from the first at column
// 0), the last column where cs > 0 (from the first at column ow - 1). POS:
// the tap may shift by +1 (the last row's and column's terms are built
// in; without it the lane transition's taps run the mask as before).
template <int W, bool POS, int STAGES, int STAGE_BYTES, int X_OFF>
__device__ __forceinline__ void shift_steps(const Args& p,
                                            unsigned char* ring_p,
                                            uint32_t load, uint32_t full,
                                            int q, int lane, int rs, int cs,
                                            uint32_t sel, long p0, int nk) {
  const int k = lane % 8, rg = lane / 8;
  const int ow = p.ow, ohw = p.ohw;
  // each step moves the unit BK positions on: BK % ohw < ohw and BK % ow
  // < ow, so one conditional subtraction keeps t and c in range
  const int dt = BK % ohw, dc = BK % ow;
  int t = (int)((p0 + 16 * k) % ohw), c = (int)((p0 + 16 * k) % ow);
  // bit j of colpat: j a multiple of ow (the column-0 bytes from c = 0)
  uint32_t colpat = 0;
  for (int j = 0; j < 16; j += ow) colpat |= 1u << j;
  const unsigned char* src0 =
      ring_p + X_OFF + q * XPIECE + rg * XROW + 16 * k;
  unsigned char* dst0 = ring_p + (q * PIECE + rg) * BK;
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    const int j0 = c == 0 ? 0 : ow - c;  // the unit's first column-0 byte
    uint32_t z =
        (rs < 0 && t < ow ? (ow - t >= 16 ? 0xFFFFu : (1u << (ow - t)) - 1u)
                          : 0u) |
        (cs < 0 && j0 < 16 ? (colpat << j0) & 0xFFFFu : 0u);
    if constexpr (POS) {
      const int j1 = ow - 1 - c;    // the unit's first last-column byte
      const int tl = ohw - ow - t;  // its first byte in the last row
      z |= (rs > 0 && tl < 16 ? (tl <= 0 ? 0xFFFFu : (0xFFFFu << tl) & 0xFFFFu)
                              : 0u) |
           (cs > 0 && j1 < 16 ? (colpat << j1) & 0xFFFFu : 0u);
    }
    const uint4 keep =
        make_uint4(~byte_mask(z & 15u), ~byte_mask((z >> 4) & 15u),
                   ~byte_mask((z >> 8) & 15u), ~byte_mask(z >> 12));
    t += dt;
    if (t >= ohw) t -= ohw;
    c += dc;
    if (c >= ow) c -= ow;
    mbar_wait(load + 8 * s, (i / STAGES) & 1);
    const unsigned char* src = src0 + s * STAGE_BYTES;
    unsigned char* dst = dst0 + s * STAGE_BYTES;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = rg + 4 * r;  // of the piece; of the tile: + 32 q
      const uint4 lo = *reinterpret_cast<const uint4*>(src + 4 * r * XROW);
      const uint4 hi =
          *reinterpret_cast<const uint4*>(src + 4 * r * XROW + 16);
      uint4 v = bytes_at<W>(lo, hi, sel);
      v.x &= keep.x;
      v.y &= keep.y;
      v.z &= keep.z;
      v.w &= keep.w;
      *reinterpret_cast<uint4*>(dst + 4 * r * BK + ((k ^ (row & 7)) << 4)) = v;
    }
    // the generic writes ordered before wgmma's reads (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(full + 8 * s);
  }
}

// Grid (ceil(cout / BN), ceil(taps * cin / BM), runs): block (x, y, z)
// computes output channels [x * BN, x * BN + BN) of dW rows [y * BM, y * BM
// + BM) over the K steps of scale groups [z * gpb, z * gpb + gpb), folding
// each group's s32 tile in order (or, with SLOTS, writing each group's f32
// contribution to its slot). tx: d flat as (N', planes * Cin), boxes of
// 144 bytes x 32 rows, unswizzled; tg: g as (N', Cout), boxes of 128 bytes
// x BN rows in the 128-byte swizzle. Tag names the user's instantiation in
// a profile.
template <int BN, bool SLOTS, typename Tag>
__global__ void __launch_bounds__(THREADS, 1)
    wgrad_s8_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tg,
                    const __grid_constant__ Args p) {
  using T = Tile<BN, SLOTS>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (ALIGN - raw % ALIGN) % ALIGN;
  unsigned char* ring_p = smem_raw + pad;
  const uint32_t ring = raw + pad;
  const uint32_t load = ring + T::RING + T::OUT_BYTES,
                 full = load + 8 * T::STAGES, empty = full + 8 * T::STAGES;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int cpt = p.cin / PIECE;                         // pieces a tap
  const int live = min(BM, p.taps * p.cin - m0) / PIECE;  // pieces inside dW
  // the block's run of scale groups [g0, g1), K steps [s0, s0 + nk)
  const int g0 = blockIdx.z * p.gpb;
  const int g1 = min(g0 + p.gpb, p.steps / p.spg);
  const int s0 = g0 * p.spg, nk = (g1 - g0) * p.spg;

  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(load + 8 * s, 1);
      mbar_init(full + 8 * s, live * PIECE);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS + SHIFTERS) {  // the producer warp: one thread
    if (tid == CONSUMERS + SHIFTERS) {
      const int bytes = live * XPIECE + T::B_BYTES;
      // each live piece's box: its tap's shift (rs * ow + cs, either sign)
      // rounded down to 16 bytes, and its first row of d (plane p's
      // channel c is row p * cin + c)
      int lead[4], row[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int piece = m0 / PIECE + q;
        const int tap = min(piece / cpt, p.taps - 1);
        lead[q] = -((p.ow * -p.rs[tap] - p.cs[tap] + 15) & ~15);
        row[q] = p.plane[tap] * p.cin + (piece - tap * cpt) * PIECE;
      }
      for (int i = 0; i < nk; ++i) {
        const int s = i % T::STAGES;
        const uint32_t st = ring + s * T::STAGE_BYTES, bar = load + 8 * s;
        // the slot's previous step has been read by both warpgroups
        if (i >= T::STAGES) mbar_wait(empty + 8 * s, (i / T::STAGES - 1) & 1);
        mbar_arrive_tx(bar, bytes);
        const int pos = (s0 + i) * BK;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < live)
            tma_load_2d(st + T::X_OFF + q * XPIECE, &tx, bar, pos + lead[q],
                        row[q]);
        tma_load_2d(st + T::A_BYTES, &tg, bar, pos, n0);
      }
    }
    return;
  }

  if (tid >= CONSUMERS) {  // the shifters: staged d -> A
    const int q = (tid - CONSUMERS) / PIECE;
    if (q >= live) return;
    const int tap = (m0 / PIECE + q) / cpt;
    const int rs = p.rs[tap], cs = p.cs[tap];
    // the staged row starts at the tap's shift (delta bytes) rounded down
    // to 16 bytes, so the A row's bytes start at off (0-15) in it
    const int delta = rs * p.ow + cs;
    const int off = delta + ((-delta + 15) & ~15);
    const uint32_t sel = 0x3210u + 0x1111u * (off & 3);
    constexpr int S = T::STAGES, SB = T::STAGE_BYTES, XO = T::X_OFF;
    const int lane = tid % 32;
    const long p0 = (long)s0 * BK;
    // the word offset and whether the tap shifts by +1, as template
    // parameters: no selects in the steps' loop
    switch ((off >> 2) + (rs > 0 || cs > 0 ? 4 : 0)) {
#define SHIFT_CASE(C, W, POS)                                                 \
  case C:                                                                    \
    shift_steps<W, POS, S, SB, XO>(p, ring_p, load, full, q, lane, rs, cs,   \
                                   sel, p0, nk);                             \
    break;
      SHIFT_CASE(0, 0, false)
      SHIFT_CASE(1, 1, false)
      SHIFT_CASE(2, 2, false)
      SHIFT_CASE(3, 3, false)
      SHIFT_CASE(4, 0, true)
      SHIFT_CASE(5, 1, true)
      SHIFT_CASE(6, 2, true)
      SHIFT_CASE(7, 3, true)
#undef SHIFT_CASE
    }
    return;
  }

  int acc[T::NACC];
  // the f32 running tile: in registers (OUT_REGS), or (OUT_SMEM) thread
  // tid's values 4 j .. 4 j + 3 at float4 j * CONSUMERS + tid past the ring
  float out[T::OUT_REGS ? T::NACC : 1];
  float4* out_s = reinterpret_cast<float4*>(ring_p + T::RING) + tid;
  // with SLOTS: the tile's slot of group 0, in the same float4 order
  const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  float4* slot = reinterpret_cast<float4*>(p.dw) + tile * (BM * BN / 4) + tid;
  const size_t slot_stride = (size_t)gridDim.y * gridDim.x * (BM * BN / 4);
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) acc[i] = 0;
#pragma unroll
  for (int i = 0; i < (T::OUT_REGS ? T::NACC : 1); ++i) out[i] = 0.f;
  const uint32_t a_row = (tid / 128) * 64 * BK;  // this warpgroup's rows
  // a loop over the groups, then over each group's steps: the waits and
  // the fold sit on no branch (wgmma's accumulators read on a divergent
  // path make ptxas serialize the wgmmas)
  for (int g = g0; g < g1; ++g) {
    // the group's scale, read while its steps run
    const float ts = __fmul_rn(__fmul_rn(p.d_amax[g], p.g_amax[g]),
                               common::kInv16129);
    for (int k = 0; k < p.spg; ++k) {
      const int i = (g - g0) * p.spg + k, s = i % T::STAGES;
      mbar_wait(load + 8 * s, (i / T::STAGES) & 1);  // B landed
      mbar_wait(full + 8 * s, (i / T::STAGES) & 1);  // A shifted in
      const uint64_t da = smem_desc(ring + s * T::STAGE_BYTES + a_row);
      const uint64_t db = smem_desc(ring + s * T::STAGE_BYTES + T::A_BYTES);
      wgmma_fence();
      // the group's first wgmma starts the s32 tile afresh (scale-d 0)
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk, k > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // this warpgroup's step i - 1 retired: free its slot
      if (k > 0) mbar_arrive(empty + 8 * ((i - 1) % T::STAGES));
    }
    // the group's end: every wgmma of the group retired, the s32 tile
    // exact; fold it as the reference does (_w_init, then _w_acc)
    wgmma_wait<0>();
    fence_acc(acc);
    mbar_arrive(empty + 8 * (((g - g0 + 1) * p.spg - 1) % T::STAGES));
    if constexpr (SLOTS) {
#pragma unroll
      for (int j = 0; j < T::NACC / 4; ++j)
        slot[g * slot_stride + j * CONSUMERS] =
            make_float4(__fmul_rn(__int2float_rn(acc[4 * j]), ts),
                        __fmul_rn(__int2float_rn(acc[4 * j + 1]), ts),
                        __fmul_rn(__int2float_rn(acc[4 * j + 2]), ts),
                        __fmul_rn(__int2float_rn(acc[4 * j + 3]), ts));
    } else if constexpr (T::OUT_SMEM) {
#pragma unroll
      for (int j = 0; j < T::NACC / 4; ++j) {
        float4 c = make_float4(__fmul_rn(__int2float_rn(acc[4 * j]), ts),
                               __fmul_rn(__int2float_rn(acc[4 * j + 1]), ts),
                               __fmul_rn(__int2float_rn(acc[4 * j + 2]), ts),
                               __fmul_rn(__int2float_rn(acc[4 * j + 3]), ts));
        // selects, not a branch (the first group reads r and drops it)
        const float4 r = out_s[j * CONSUMERS];
        if (g > g0)
          c = make_float4(__fadd_rn(r.x, c.x), __fadd_rn(r.y, c.y),
                          __fadd_rn(r.z, c.z), __fadd_rn(r.w, c.w));
        out_s[j * CONSUMERS] = c;
      }
    } else {
#pragma unroll
      for (int j = 0; j < T::NACC; ++j) {
        const float c = __fmul_rn(__int2float_rn(acc[j]), ts);
        out[j] = g == g0 ? c : __fadd_rn(out[j], c);
      }
    }
  }

  if constexpr (!SLOTS) {  // with SLOTS, launch_slot_sum folds the slots
    // the tile's value 4 j + 2 h + e: row 16 w + l / 4 + 8 h of the
    // warpgroup's 64, column 8 j + 2 (l % 4) + e
    const int m = p.taps * p.cin;
    const int warp = tid / 32, lane = tid % 32;
    const int row = m0 + (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col >= p.cout) continue;
      float4 v;
      if constexpr (T::OUT_SMEM)
        v = out_s[j * CONSUMERS];
      else
        v = make_float4(out[4 * j], out[4 * j + 1], out[4 * j + 2],
                        out[4 * j + 3]);
      if (row < m)
        *reinterpret_cast<float2*>(p.dw + (size_t)row * p.cout + col) =
            make_float2(v.x, v.y);
      if (row + 8 < m)
        *reinterpret_cast<float2*>(p.dw + (size_t)(row + 8) * p.cout + col) =
            make_float2(v.z, v.w);
    }
  }
}

template <int BN, bool SLOTS, typename Tag>
inline cudaError_t launch_tile(const CUtensorMap& tx, const CUtensorMap& tg,
                               const Args& p, cudaStream_t stream) {
  constexpr int smem = Tile<BN, SLOTS>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      wgrad_s8_kernel<BN, SLOTS, Tag>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int groups = p.steps / p.spg;
  const dim3 grid((p.cout + BN - 1) / BN, (p.taps * p.cin + BM - 1) / BM,
                  (groups + p.gpb - 1) / p.gpb);
  wgrad_s8_kernel<BN, SLOTS, Tag><<<grid, THREADS, smem, stream>>>(tx, tg, p);
  return cudaGetLastError();
}

// dW [m][cout] f32 = the slots [groups][m_tiles][n_tiles][BM * BN] f32 of a
// SLOTS launch added in group order (__fadd_rn, as the block's fold): a
// thread a float4 of a tile's fragment order (value 4 j + 2 h + e of thread
// tid: row 64 (tid / 128) + 16 ((tid / 32) % 4) + (tid % 32) / 4 + 8 h,
// column 8 j + 2 (tid % 4) + e), written where it lies inside dW.
template <typename Tag>
__global__ void __launch_bounds__(256)
    slot_sum_kernel(const float4* __restrict__ part, float* __restrict__ dw,
                    int groups, int m, int cout, int bn, int n_tiles,
                    int tiles) {
  const int per = BM * bn / 4;  // float4s a tile
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)tiles * per) return;
  const int tile = (int)(idx / per), f = (int)(idx % per);
  float4 v = part[idx];
  for (int g = 1; g < groups; ++g) {
    const float4 c = part[(long)g * tiles * per + idx];
    v = make_float4(__fadd_rn(v.x, c.x), __fadd_rn(v.y, c.y),
                    __fadd_rn(v.z, c.z), __fadd_rn(v.w, c.w));
  }
  const int j = f / CONSUMERS, tid = f % CONSUMERS;
  const int warp = tid / 32, lane = tid % 32;
  const int row = (tile / n_tiles) * BM + (warp / 4) * 64 + (warp % 4) * 16 +
                  lane / 4;
  const int col = (tile % n_tiles) * bn + 8 * j + 2 * (lane % 4);
  if (col >= cout) return;
  if (row < m)
    *reinterpret_cast<float2*>(dw + (size_t)row * cout + col) =
        make_float2(v.x, v.y);
  if (row + 8 < m)
    *reinterpret_cast<float2*>(dw + (size_t)(row + 8) * cout + col) =
        make_float2(v.z, v.w);
}

// --- the host side: tensor maps, and one call that encodes and launches ----

// The map of t [rows][n] int8 (the planes' channels, plane after plane),
// in boxes of d's staged rows: XROW bytes of 32 rows, unswizzled.
// Out-of-bounds bytes read as zero. Returns false where the encoder is
// missing or refuses.
inline bool encode_d(CUtensorMap* map, const void* t, int rows, int n) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)n};
  const cuuint32_t box[2] = {(cuuint32_t)XROW, (cuuint32_t)PIECE};
  const cuuint32_t unit[2] = {1u, 1u};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(t),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of t [c][n] int8 viewed (N, C), in boxes of g's rows: 128
// positions of bn channels, in the 128-byte swizzle.
inline bool encode_g(CUtensorMap* map, const void* t, int c, int n, int bn) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)c};
  const cuuint64_t strides[1] = {(cuuint64_t)n};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)bn};
  const cuuint32_t unit[2] = {1u, 1u};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(t),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// dW [taps * cin][cout] f32 of d [planes][cin][n] and g [cout][n] int8 (n
// = b * oh * ow output positions, 16-byte aligned) with g_amax, d_amax
// [n / tile] f32, one scale group a tile positions: tap t reads plane tab[3
// t], moved by tab[3 t + 1] rows and tab[3 t + 2] columns (host memory;
// each -1, 0 or 1); a bn-wide N tile (128, 64 or 32), the groups folded in
// each block. With SPLITS, gpb > 0 splits the groups into runs of gpb, a
// block each: dw is then the slots [groups][m_tiles][n_tiles][BM * bn] f32
// (bn 160 or 128), which launch_slot_sum adds in order. Tag names the
// kernel in a profile.
template <typename Tag = void, bool SPLITS = false>
inline cudaError_t launch_taps(const void* d, int planes, const void* g,
                               const float* g_amax, const float* d_amax,
                               float* dw, const int* tab, int taps, int cin,
                               int cout, int n, int oh, int ow, int tile,
                               int bn, int gpb, cudaStream_t stream) {
  const int ohw = oh * ow;
  if (taps < 1 || taps > MAX_TAPS || cin % PIECE || cout % 8 || ohw % 16 ||
      n % ohw || tile % BK || tile < BK || n % tile || gpb < 0 ||
      (gpb > 0 && !SPLITS))
    return cudaErrorInvalidValue;
  Args p{dw,        g_amax, d_amax, cin, cout, ow, ohw, n / BK, tile / BK,
         gpb > 0 ? gpb : n / tile, taps, {}, {}, {}};
  for (int t = 0; t < taps; ++t) {
    p.plane[t] = tab[3 * t];
    p.rs[t] = tab[3 * t + 1];
    p.cs[t] = tab[3 * t + 2];
    if (p.plane[t] < 0 || p.plane[t] >= planes || p.rs[t] < -1 ||
        p.rs[t] > 1 || p.cs[t] < -1 || p.cs[t] > 1)
      return cudaErrorInvalidValue;
  }
  CUtensorMap tx, tg;
  if (!encode_d(&tx, d, planes * cin, n) || !encode_g(&tg, g, cout, n, bn))
    return cudaErrorInvalidValue;
  if constexpr (SPLITS) {
    if (gpb > 0) {
      if (bn == 160) return launch_tile<160, true, Tag>(tx, tg, p, stream);
      if (bn == 128) return launch_tile<128, true, Tag>(tx, tg, p, stream);
      return cudaErrorInvalidValue;
    }
  }
  if (bn == 128) return launch_tile<128, false, Tag>(tx, tg, p, stream);
  if (bn == 64) return launch_tile<64, false, Tag>(tx, tg, p, stream);
  if (bn == 32) return launch_tile<32, false, Tag>(tx, tg, p, stream);
  return cudaErrorInvalidValue;
}

// dw [m][cout] f32 from the slots [groups][m_tiles][n_tiles][BM * bn] f32
// of a split launch_taps, added in group order (slot_sum_kernel).
template <typename Tag = void>
inline cudaError_t launch_slot_sum(const float* part, float* dw, int groups,
                                   int m, int cout, int bn,
                                   cudaStream_t stream) {
  if (groups < 1 || bn % 8 || bn < 8) return cudaErrorInvalidValue;
  const int tiles = ((m + BM - 1) / BM) * ((cout + bn - 1) / bn);
  const long threads = (long)tiles * (BM * bn / 4);
  slot_sum_kernel<Tag><<<(unsigned)((threads + 255) / 256), 256, 0,
                         stream>>>(reinterpret_cast<const float4*>(part), dw,
                                   groups, m, cout, bn,
                                   (cout + bn - 1) / bn, tiles);
  return cudaGetLastError();
}

}  // namespace wgrad_wgmma_s8
