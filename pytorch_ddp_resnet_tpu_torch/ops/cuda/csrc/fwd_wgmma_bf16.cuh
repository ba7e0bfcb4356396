// The fused bf16 block-half's forward GEMM, written for Hopper (sm_90a):
// y = bf16(conv3x3(d, w)) (+ res in bf16) in the channel-major layout
// [Cout, B*H*W], and per 128-row tile the f32 sums of the stored y and
// y^2, from the slab its prepass wrote (fused_block_bf16.cu,
// fused_fwd_pre_kernel).
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/fused_block.py:380,
// _fwd_call -> _fwd_kernel with quant=False, the bf16 body): the TPU kernel
// computes the prologue d = dropout(relu(bf16(x * scale + shift))) in VMEM
// and contracts it at the nine taps with rolls of its lane tile. Here the
// prepass writes d once, position-major, into a padded slab (the layout of
// ops/cuda/fused_block.py fused_fwd_layout): past guard = W + 2 zero
// positions, image i takes (H + 1) * (W + 1) positions, a zero row above it
// and a zero column at the start of each row, live pixel (i, r, c) at M
// row i * (H + 1) * (W + 1) + (r + 1) * (W + 1) + c + 1 (slab position
// guard + that); zeros trail to whole 128-row tiles and a second guard.
// Tap (dh, dw) is then the one offset (dh - 1) * (W + 1) + (dw - 1) for
// every row, image and width: no masks and no width rule.
//   M = those padded positions in 128-row tiles, N = Cout, K = (tap,
//   channel), the packed weights' order ([Cout, 9 * Cin], K-major).
//
// What bounds it on an H100: operations (2 * 9 * Cin * Cout * N: 60.4
// GFLOP a call at WRN-28-10's stage 1, batch 128, 0.061 ms at 989 TFLOP/s;
// its operands are 42-45 MB, 0.013 ms at 3.35 TB/s). What the design does
// about it: the product is Hopper's warpgroup MMA, wgmma.mma_async
// m64nBNk16 f32 += bf16 * bf16, both operands K-major from shared memory
// in the 128-byte swizzle, the only route to the card's full bf16 rate
// (the repo's mma.sync mainloops run at 165-225 TFLOP/s, PERF.md). A block
// is two consumer warpgroups of 64 rows over one BN-wide N tile: BN = 160
// wherever Cout % 160 == 0 (every WRN-28-10 width: one tile at 160, two at
// 320, four at 640, no column padded), else 128 or 64 with a masked ragged
// last tile. K steps are 128 bytes (64 channels, one swizzle row); the
// block's 256 threads copy each step's A and B rows as 16-byte cp.async
// pieces, each piece at its own tap (Cin need not divide a step; the
// weights' K bytes past 9 * Cin read as zeros), into a ring of three
// stages of (128 + BN) * 128 bytes (108 KB at BN = 160: two blocks an SM),
// each piece's destination XOR-swizzled as wgmma's 128-byte layout reads
// it. Per step: the copies land (cp.async.wait, fence.proxy.async, a
// barrier), each warpgroup issues its four k16 wgmmas (the descriptors
// advanced 32 bytes each) and commits them, waits until one group is left
// in flight, and after a second barrier (both warpgroups have retired the
// previous step's group, so its slot is free) the block copies the step two
// ahead into that slot. The epilogue stages bf16(acc) channel-major in the
// ring's memory (a tile's live rows are one run of output lanes, as
// fwd_staged_s8.cuh's stage_cm), adds res read in the same 16-byte runs
// as y is written (bf16(f32(res) + f32(y)), rounding before the add), and
// sums the staged final values per channel in a fixed order into
// part[tile] (fwd_staged_s8.cuh's sums_cm); partial_sum adds the tiles in
// order, so y and its sums are the same bit for bit every run.
//
// The kernel's launchers live in fused_block_bf16.cu, its one caller, so
// that the files that include this header for the mainloop do not build
// the kernel. The mainloop walks a range of taps (TapWalk): the nine of
// the 3x3 conv here and in dgrad_wgmma_bf16.cuh; in the lane transition's
// straight-through dgrad (transition.cu) one parity class's taps of the
// plane-major weights at BN = 80, and its projection's one unshifted tap.
//
// Left for later: TMA and an mbarrier producer warp, persistent blocks,
// clusters; the pad rows (6.3% at 32x32 images) and the slab's bytes
// (written once, read back).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fwd_staged_s8.cuh"  // CM_OS, sums_cm (the channel-major epilogue)
#include "wgrad_staged.cuh"   // cp.async helpers, SMEM_PER_BLOCK

namespace fwd_wgmma_bf16 {

using fwd_staged_s8::CM_OS;
using wgrad_staged::cp_async16;
using wgrad_staged::cp_async_commit;
using wgrad_staged::cp_async_wait;
using wgrad_staged::smem_u32;

constexpr int THREADS = 256;  // two consumer warpgroups
constexpr int BM = 128;       // M rows a tile, 64 a warpgroup
constexpr int BK = 128;       // bytes a K step: one 128-byte swizzle row
constexpr int STAGES = 3;
constexpr int ALIGN = 1024;   // a swizzle atom: 8 rows of 128 bytes
static_assert(BM == fwd_staged_s8::BM, "the staged tile's rows");

// One BN-wide tile's shared memory: a ring of STAGES steps of A (BM rows)
// then B (BN rows), 128 bytes a row; after the mainloop the staged bf16
// tile [BN][CM_OS] and each row's place in the run (at[]) reuse it. Each
// thread copies piece tid % 8 of rows tid / 8 + 32 i: PA of A, PB of B
// (the last of B only up to row BN: 80 is the transition dgrad's width).
template <int BN>
struct Tile {
  static constexpr int A_BYTES = BM * BK;
  static constexpr int STAGE_BYTES = (BM + BN) * BK;
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int PA = BM / 32;
  static constexpr int PB = (BN + 31) / 32;
  static constexpr int NACC = BN / 2;  // f32 accumulators a thread
  static constexpr int AT_OFF = BN * CM_OS * 2;
  static constexpr int SMEM = RING + ALIGN;  // room to align the ring
  static_assert(BN % 16 == 0 && BN <= 256, "BN");
  static_assert(AT_OFF + BM * 4 <= RING, "the epilogue fits in the ring");
  static_assert(SMEM <= wgrad_staged::SMEM_PER_BLOCK, "two blocks an SM");
};

struct Args {
  const __nv_bfloat16* slab;  // [slab_len][cin], fused_fwd_layout
  const __nv_bfloat16* w;     // [cout][9 * cin], K in (dh, dw, ci) order
  const __nv_bfloat16* res;   // [cout][n] or null
  __nv_bfloat16* y;           // [cout][n]
  float* part;                // [tiles][2 * cout] or null (no stats)
  int cin, cout, n, b, h, wi, guard;
};

// A shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row
// groups 1,024 bytes apart (the stride byte offset), start address in 16s.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// The cp.async copies (generic proxy) made visible to wgmma (async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving a read of the accumulators above the
// wgmma_wait that makes them final.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x BN f32, per warpgroup) += A (64 x 16, K-major) * B (BN x 16,
// K-major)^T. The fragment of thread t (warp w of its warpgroup, lane l):
// d[4 j + 2 h + e] is row 16 w + l / 4 + 8 h, column 8 j + 2 (l % 4) + e.
template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t a,
                                      uint64_t b);

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<80>(float (&d)[40], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<160>(float (&d)[80], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79}, %80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(a), "l"(b), "r"(1));
}

// The live rows before M row m: M row m is the padded position (image i,
// row r, column c) of m = i * (h + 1) * (wi + 1) + r * (wi + 1) + c, live
// where r, c >= 1 and i < b, and the live rows in order are the output
// lanes in order.
__device__ __forceinline__ int live_before(int m, int b, int h, int wi,
                                           int n) {
  const int wp = wi + 1, per = (h + 1) * wp;
  const int i = m / per;
  if (i >= b) return n;
  const int rem = m - i * per, r = rem / wp, c = rem - r * wp;
  return i * h * wi + (r == 0 ? 0 : (r - 1) * wi + max(c - 1, 0));
}

__device__ __forceinline__ int live_before(const Args& p, int m) {
  return live_before(m, p.b, p.h, p.wi, p.n);
}

// The taps a mainloop walks: `count` taps from weight tap `first` (weight
// rows of `row_taps` taps of Cin channels each), the walk's tap t reading
// the slab rows from guard + m + off(t) for M row m. The 3x3 conv walks
// its nine taps (Conv3x3Taps); the stride-2 transition's dgrad one parity
// class's range of its plane-major weights, and its projection one
// unshifted tap of Wp^T.
template <typename Off>
struct TapWalk {
  int first, count, row_taps;
  Off off;
};

// tap t = (dh, dw) row-major of the 3x3 conv: one row offset for every
// row, image and width
struct Conv3x3Taps {
  int wi;
  __device__ __forceinline__ int operator()(int t) const {
    return (t / 3 - 1) * (wi + 1) + t % 3 - 1;
  }
};

// acc += the tile's products over every K step (see the head of the file)
// of the taps of `walk`; returns with every copy landed, every wgmma
// retired and every warp past its last read of the ring.
template <int BN, typename Off>
__device__ __forceinline__ void mainloop(const Args& p,
                                         const TapWalk<Off>& walk,
                                         uint32_t ring, int m0, int n0,
                                         float (&acc)[BN / 2]) {
  using T = Tile<BN>;
  const int tid = threadIdx.x;
  const int piece = tid % 8, r0 = tid / 8;
  // rows r0 + 32 i all have r0 % 8 as their row in the swizzle atom
  const uint32_t dst = r0 * BK + ((piece ^ (r0 % 8)) << 4);
  const int pitch = 2 * p.cin;                 // bytes a slab position
  const int ldb = walk.row_taps * pitch;       // bytes a weight row
  const int kbytes = walk.count * pitch;       // K bytes walked
  const int steps = (kbytes + BK - 1) / BK;
  const unsigned char* a_src = reinterpret_cast<const unsigned char*>(p.slab) +
                               (size_t)(p.guard + m0 + r0) * pitch;
  const unsigned char* w0 = reinterpret_cast<const unsigned char*>(p.w);
  const unsigned char* b_src = w0 + (size_t)(n0 + r0) * ldb +
                               (size_t)walk.first * pitch + piece * 16;
  const int b_rows = p.cout - n0 - r0;  // B piece i is live while 32 i < this
  // this piece's (tap, byte of the tap) at the next step to load (the
  // loads come in step order)
  int s_tap = 0, s_c = piece * 16;
  for (; s_c >= pitch; s_c -= pitch) ++s_tap;

  auto load = [&](int kt, int stage) {
    // past the walk's last tap (the last step's tail) the A piece reads the
    // last tap's slab bytes, finite, against zeros
    const int tap = min(s_tap, walk.count - 1);
    const long off = (long)walk.off(tap) * pitch + s_c;
    for (s_c += BK; s_c >= pitch; s_c -= pitch) ++s_tap;
    const uint32_t st = ring + stage * T::STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < T::PA; ++i)
      cp_async16(st + dst + i * 32 * BK, a_src + off + (size_t)i * 32 * pitch,
                 true);
    const bool k_ok = kt * BK + piece * 16 < kbytes;
#pragma unroll
    for (int i = 0; i < T::PB; ++i) {
      if (BN % 32 != 0 && 32 * i + r0 >= BN) continue;  // past the tile
      const bool ok = 32 * i < b_rows && k_ok;
      cp_async16(st + T::A_BYTES + dst + i * 32 * BK,
                 ok ? b_src + (size_t)i * 32 * ldb + kt * BK : w0, ok);
    }
  };

  const uint32_t a_off = (tid / 128) * 64 * BK;  // this warpgroup's rows
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<STAGES - 2>();  // step kt's pieces of this thread landed
    fence_async_shared();
    __syncthreads();  // ... and every thread's
    const uint32_t st = ring + (kt % STAGES) * T::STAGE_BYTES;
    const uint64_t da = smem_desc(st + a_off);
    const uint64_t db = smem_desc(st + T::A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 32; ++k) wgmma<BN>(acc, da + 2 * k, db + 2 * k);
    wgmma_commit();
    wgmma_wait<1>();  // this warpgroup's step kt - 1 retired
    __syncthreads();  // both warpgroups': its slot may be refilled
    if (kt + STAGES - 1 < steps)
      load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the epilogue
}

// The 3x3 conv's mainloop: its nine taps.
template <int BN>
__device__ __forceinline__ void mainloop(const Args& p, uint32_t ring,
                                         int m0, int n0,
                                         float (&acc)[BN / 2]) {
  mainloop<BN>(p, TapWalk<Conv3x3Taps>{0, 9, 9, {p.wi}}, ring, m0, n0, acc);
}

// Column n (< cols) of the staged tile, its run [lead, lead + count), to
// dst + n * ld, with res (same strides) added first where res is not null:
// bf16(f32(res) + f32(y)), written back to the staged tile so that the
// sums read the final values. Whole vectors as 16-byte loads and stores,
// the run's ragged ends element by element (dst, res 16-byte aligned at
// the run's first vector; ld a multiple of 8).
template <int BN>
__device__ __forceinline__ void write_res_cm(__nv_bfloat16* out, int lead,
                                             int count, int cols,
                                             __nv_bfloat16* dst,
                                             const __nv_bfloat16* res,
                                             size_t ld) {
  const int end = lead + count;
  const int vpc = (end + 7) / 8;  // vectors a column
  for (int idx = threadIdx.x; idx < BN * vpc; idx += THREADS) {
    const int n = idx / vpc, j0 = (idx - n * vpc) * 8;
    if (n >= cols) continue;
    __nv_bfloat16* src = out + n * CM_OS + j0;
    __nv_bfloat16* d = dst + n * ld + j0;
    const bool whole = j0 >= lead && j0 + 8 <= end;
    if (whole) {
      uint4 v = *reinterpret_cast<const uint4*>(src);
      if (res != nullptr) {
        const uint4 r = *reinterpret_cast<const uint4*>(res + n * ld + j0);
        __nv_bfloat16* ve = reinterpret_cast<__nv_bfloat16*>(&v);
        const __nv_bfloat16* re = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          ve[e] = __float2bfloat16_rn(
              __fadd_rn(__bfloat162float(re[e]), __bfloat162float(ve[e])));
        *reinterpret_cast<uint4*>(src) = v;
      }
      *reinterpret_cast<uint4*>(d) = v;
    } else {
      for (int e = 0; e < 8; ++e) {
        if (j0 + e < lead || j0 + e >= end) continue;
        __nv_bfloat16 o = src[e];
        if (res != nullptr) {
          o = __float2bfloat16_rn(__fadd_rn(
              __bfloat162float(res[n * ld + j0 + e]), __bfloat162float(o)));
          src[e] = o;
        }
        d[e] = o;
      }
    }
  }
}

// Grid (ceil(cout / BN), tiles): block (x, y) computes output channels [x
// * BN, x * BN + BN) of M tile y (the N tiles of one M tile neighbours, so
// they read its A rows through L2) and writes its sums to part[y].
template <int BN>
__global__ void __launch_bounds__(THREADS, 2)
    fused_fwd_gemm_kernel(const __grid_constant__ Args p) {
  using T = Tile<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (ALIGN - raw % ALIGN) % ALIGN;
  unsigned char* smem = smem_raw + pad;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  float acc[T::NACC];
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) acc[i] = 0.f;
  mainloop<BN>(p, raw + pad, m0, n0, acc);

  // this tile's run of lanes [lane0, lane0 + count) and each row's place
  // in it, or -1 (a pad row or column, or the tail)
  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(smem);
  int* at = reinterpret_cast<int*>(smem + T::AT_OFF);
  const int lane0 = live_before(p, m0);
  const int count = live_before(p, m0 + BM) - lane0;
  const int lead = lane0 % 8;
  if (tid < BM) {
    const int m = m0 + tid, k = live_before(p, m);
    at[tid] = live_before(p, m + 1) > k ? k - lane0 : -1;
  }
  __syncthreads();

  // y = bf16(acc), staged channel-major: out[n][lead + at[row]]
  const int row = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
  const int at0 = at[row], at1 = at[row + 8];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (at0 >= 0)
        out[(col + e) * CM_OS + lead + at0] =
            __float2bfloat16_rn(acc[4 * j + e]);
      if (at1 >= 0)
        out[(col + e) * CM_OS + lead + at1] =
            __float2bfloat16_rn(acc[4 * j + 2 + e]);
    }
  }
  __syncthreads();

  const int cols = min(BN, p.cout - n0);
  const size_t off = (size_t)n0 * p.n + lane0 - lead;
  write_res_cm<BN>(out, lead, count, cols, p.y + off,
                   p.res != nullptr ? p.res + off : nullptr, p.n);
  if (p.part != nullptr) {
    __syncthreads();  // the residual's sums read what the writes staged
    fwd_staged_s8::sums_cm<BN>(out, lead, count, cols,
                               p.part + (size_t)blockIdx.y * 2 * p.cout,
                               p.cout, n0);
  }
}

}  // namespace fwd_wgmma_bf16
