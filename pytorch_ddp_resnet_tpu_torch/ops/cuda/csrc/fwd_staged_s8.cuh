// The staged forward mainloop of the int8 NV training halves, written for
// Hopper (sm_90a): per chunk, y = bf16(f32(sum over (tap, ci) of int8(a,
// shifted) . int8(w)) * f32(ws * scale)), and per output tile the f32 sums
// of y and y^2 over its positions.
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/bneck_nv_train.py:797,
// _fwd1x1_kernel / _fwd3x3_kernel with quant=True, the int8 body): the TPU
// kernel quantizes each row chunk's activation once, halo rows included, at
// the chunk's scale (_quantize_chunk) and contracts it at the 9 tap shifts,
// each one constant row offset of its [h, wp, N, C] carrier (shift_rows).
// Here a prepass (bneck_nv_train.cu, nvt_fwd_pre_kernel) writes each chunk's
// int8 slab once, position-major with each position's channels contiguous,
// in the layout of ops/cuda/bneck_nv_train.py fwd_int8_layout: output
// position (r, c, i) of a chunk (row r < rch, column c of a row of wq
// columns, image i < n) is M row m = (r * wq + c) * n + i for the 3x3
// (images innermost) and m = (i * rch + r) * w + c for the 1x1; the
// slab [chunks][slab_len][cp] holds guard zero positions, the rch + 2 * halo
// rows from image row k * rch - halo (3x3: the halo rows at the chunk's
// scale, zero outside the image), guard more, then the tile tail; channels
// are padded to cp (a multiple of the K step) with zeros. Tap (dy, dx)
// reads position m + shift[tap], shift = guard + (dy * wq + dx - 1) * n for
// the 3x3 (wq = w + 1: the zero column is the left neighbour of column 0 and
// the right one of column w - 1), 0 for the 1x1 (wq = w). Every A row of
// every tap is one 16-byte-aligned copy inside the slab: no masks.
//   M = the chunk's rch * wq * n output positions, in whole 128-row tiles
//   (a tile lies in one chunk and has one scale), N = Cout, K = (tap,
//   channel) in steps of BK bytes of one tap's channels.
//
// What bounds it on an H100: bytes, at every ResNet-50 stage (PERF.md's
// footnote: x (and res) in, y out, against 2 * positions * taps * Cin *
// Cout int8 operations). What the design does about it: the prologue and
// the quantization run once per slab element (the prepass), not once per
// (tap, N tile) that reads it; the mainloop copies slab rows and weight rows
// as they lie (cp.async.cg, 16 bytes a thread, a ring of STAGES K steps in
// dynamic shared memory, one barrier a step) into K-contiguous shared rows
// that plain ldmatrix.x4 feeds to mma.sync m16n8k32 s8 -> s32; a 128-wide N
// tile (Cout >= 128) reads A ceil(Cout / 128) times, and the N tiles of one
// M tile are neighbours in the grid, so they read it through L2; the tap
// shifts of neighbouring tiles overlap in L2 too. The epilogue dequantizes
// with the block's one scale, stages the bf16 tile in the ring's shared
// memory, writes y in 16-byte vectors per output row (skipping the pad
// column and the tile tail) and sums f32(y) and y^2 per channel over the
// valid rows in a fixed order into part[tile], which nvt_sum reduces in a
// fixed tree: y and its sums are the same bit for bit every run.
//
// Tried and dropped (tools/bench_nv_fwd_int8.py on an H100 80GB HBM3 at
// 700 W, ResNet-50's 30 halves a step): persistent
// blocks that overlap one tile's epilogue with the next tile's loads (the
// 1x1 halves have 1-8 K steps a tile) ran no faster with the staged
// epilogue and 1.8x slower with y stored from the accumulators; sums from
// the accumulators by warp butterflies ran no faster than the staged
// column loop; 3x3 K steps of 128 bytes spanning two taps of 64 channels
// saved 3% of those halves' mainloop; three blocks an SM for the 64-wide
// tile (80 registers, no spills) ran no faster.
//
// The mainloop is shared (mainloop<T, BN, BK, SPAN>): its operands are byte
// rows; its tap shifts are the linear form above (the NV halves) or, with
// SPAN, a table of up to 9 position offsets, each 16-byte piece of a K
// step at its own tap (so the K step need not divide a tap's channels) and
// the weights' K bytes past their row read as zeros; its element type only
// picks the mma.sync (s8 m16n8k32 -> s32, or bf16 m16n8k16 -> f32: the
// fragments are the same bytes). transition.cu's stride-2 forward runs it
// twice a tile, on its int8 parity-plane slab and on its bf16 even-even
// slab, with the channel-major epilogue below (stage_cm, write_cm, sums_cm:
// outputs [Cout, lanes], each row at its own scale, each tile's live rows
// one run of lanes); the fused bf16 forward's wgmma GEMM
// (fwd_wgmma_bf16.cuh) sums its staged tile with sums_cm too.
//
// Left for later: wgmma and TMA (the slabs are K-major, as wgmma's s8
// operands must be), clusters, and the slab's bytes (written once by the
// prepass, read back).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"           // chunk_amax, kInv127
#include "wgrad_staged.cuh"     // cp.async helpers, THREADS, SMEM_PER_BLOCK
#include "wgrad_staged_s8.cuh"  // ldmatrix_x4, mma_s8

namespace fwd_staged_s8 {

using wgrad_staged::cp_async16;
using wgrad_staged::cp_async_commit;
using wgrad_staged::cp_async_wait;
using wgrad_staged::mma_bf16;
using wgrad_staged::smem_u32;
using wgrad_staged::SMEM_PER_BLOCK;
using wgrad_staged::THREADS;
using wgrad_staged_s8::ldmatrix_x4;
using wgrad_staged_s8::mma_s8;

constexpr int BM = 128;     // output positions a tile (the layout's bm)

struct Args {
  const signed char* slab;  // [chunks][slab_len][cp] int8
  const signed char* wt;    // [cout][taps * cp] int8, pad channels zero
  const float* ws;          // [cout]
  const float* rowmax;      // [h]: max |a| per image row
  __nv_bfloat16* y;         // [n, h, w, cout]
  float* part;              // [chunks * tiles][2 * cout]
  int n, h, w, cout, taps, rch, halo;
  int cp, wq, tiles, slab_len;
  // tap (dy, dx)'s slab position offset: shift0 + dy * shift_row + dx *
  // shift_col (the layout's shifts; the 1x1's tap is (0, 0))
  int shift0, shift_row, shift_col;
};

// The product of the element type: s8 m16n8k32 into s32, bf16 m16n8k16
// into f32 (the same fragment bytes).
template <typename T>
struct Mma;

template <>
struct Mma<signed char> {
  using Acc = int;
  static __device__ __forceinline__ void run(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    mma_s8(d, a, b0, b1);
  }
};

template <>
struct Mma<__nv_bfloat16> {
  using Acc = float;
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    mma_bf16(d, a, b0, b1);
  }
};

// Tile geometry: BK bytes a K step, a ring of STAGES steps (4 where two
// blocks' rings fit on one SM, else 3); 8 warps, 4 along M (32 rows each)
// and 2 along N. BK / 16 threads copy each row, the block's 256 threads RPP
// rows at once, PA (PB) pieces of A (B) each. The epilogue reuses the ring:
// the bf16 tile [BM][OS] (8 pad elements a row: conflict-free fragment
// stores), each row's y position, and the sums' partials.
template <int BN, int BK>
struct Tile {
  static constexpr int ROW = BK + 16;  // bytes per padded row
  static constexpr int A_BYTES = BM * ROW;
  static constexpr int STAGE_BYTES = (BM + BN) * ROW;
  static constexpr int STAGES = 4 * STAGE_BYTES <= SMEM_PER_BLOCK ? 4 : 3;
  static constexpr int WARPS_N = 2;
  static constexpr int WN = BN / WARPS_N;  // columns per warp
  static constexpr int NI = WN / 8;        // n8 fragments per warp
  static constexpr int PPR = BK / 16;      // 16-byte pieces a row
  static constexpr int RPP = THREADS / PPR;
  static constexpr int PA = BM / RPP;
  static constexpr int PB = BN / RPP;
  static constexpr int OS = BN + 8;        // staged bf16 elements a row
  static constexpr int PARTS = THREADS / BN;  // threads summing a column
  static constexpr int POS_OFF = BM * OS * 2;
  static constexpr int RED_OFF = POS_OFF + BM * 4;
  static constexpr int EPI_BYTES = RED_OFF + 2 * PARTS * BN * 4;
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int SMEM = RING > EPI_BYTES ? RING : EPI_BYTES;
  static_assert(BN == 64 || BN == 128, "BN");
  static_assert(BK == 64 || BK == 128, "BK");
  static_assert(BM % RPP == 0 && BN % RPP == 0, "whole pieces a thread");
  static_assert(WN % 16 == 0, "a warp takes pairs of n8 fragments");
  static_assert(SMEM <= SMEM_PER_BLOCK, "two blocks an SM");
};

// One mainloop's operands, in bytes: K is (tap, byte of the tap's pitch)
// in krow / BK steps; B row n (output column n0 + n) is b + n * b_ld + kt *
// BK (B rows at or past b_rows are zero). A row r of the tile at K byte k =
// (tap t, byte c) is a + (r + shift(t)) * pitch + c. With SPAN (the
// transition's forward) each 16-byte piece of a step finds its own tap in
// the table `shift`, so a step may span taps where the pitch (a multiple
// of 16) is not a multiple of BK; krow is the weights' b_ld bytes rounded
// up to BK, and the pieces at K bytes at or past b_ld read zeros for B
// (and any A row). Without SPAN (the NV halves' 3x3 and 1x1: pitch a
// multiple of BK, krow = b_ld = taps * pitch) a step lies in one tap,
// found by a division, its shift sh0 + dy * sh_row + dx * sh_col. Every A
// row of every tap is one 16-byte-aligned copy: no masks.
struct Operands {
  const unsigned char* a;  // the tile's first row, before the tap shift
  const unsigned char* b;  // the block's first output column's weights
  const int* shift;        // SPAN: [taps]
  int sh0, sh_row, sh_col;  // without SPAN
  int pitch;               // bytes a position
  int taps;
  int b_rows;              // output columns from n0 to the end
  int krow;                // K bytes walked (a multiple of BK)
  int b_ld;                // bytes a weight row
};

// acc += the tile's products over every K step, through a cp.async ring of
// STAGES K steps into plain ldmatrix.x4 and mma.sync; returns with every
// copy landed and every warp past its last read of the ring.
template <typename T, int BN, int BK, bool SPAN>
__device__ __forceinline__ void mainloop(
    const Operands& o, unsigned char* smem,
    typename Mma<T>::Acc (&acc)[2][Tile<BN, BK>::NI][4]) {
  using Tl = Tile<BN, BK>;
  constexpr int STAGES = Tl::STAGES;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int steps = o.krow / BK;
  const int ldb = o.b_ld;  // bytes a weight row

  // This thread's copies: piece tid % PPR of rows tid / PPR + RPP * i. A
  // row m's source is position m (+ the step's tap shift), a B row's its
  // output column's weights; both advance with the step's K.
  const int piece = tid % Tl::PPR, r0 = tid / Tl::PPR;
  const unsigned char* a_src =
      o.a + (size_t)r0 * o.pitch + (SPAN ? 0 : piece * 16);
  const unsigned char* b_src = o.b + (size_t)r0 * ldb + piece * 16;
  const int b_rows = o.b_rows - r0;  // piece i is live while RPP*i < this
  const uint32_t s0 = smem_u32(smem);
  const uint32_t a_dst = r0 * Tl::ROW + piece * 16;
  const uint32_t b_dst = Tl::A_BYTES + a_dst;
  // SPAN: this piece's (tap, byte of the tap) at the next step to load
  // (the loads come in step order); else the step's tap
  int s_tap = 0, s_c = piece * 16;
  if (SPAN)
    for (; s_c >= o.pitch; s_c -= o.pitch) ++s_tap;
  const int cps = o.pitch / BK;

  auto load = [&](int kt, int stage) {
    const unsigned char* a;
    if (SPAN) {
      const int tap = min(s_tap, o.taps - 1);
      a = a_src + (long)o.shift[tap] * o.pitch + s_c;
      for (s_c += BK; s_c >= o.pitch; s_c -= o.pitch) ++s_tap;
    } else {
      const int tap = kt / cps;
      const int shift = o.sh0 + tap / 3 * o.sh_row + tap % 3 * o.sh_col;
      a = a_src + (long)shift * o.pitch + (kt - tap * cps) * BK;
    }
    const uint32_t st = s0 + stage * Tl::STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < Tl::PA; ++i)
      cp_async16(st + a_dst + i * Tl::RPP * Tl::ROW,
                 a + (size_t)i * Tl::RPP * o.pitch, true);
    // SPAN: K bytes past the weight row's read as zeros
    const bool k_ok = !SPAN || kt * BK + piece * 16 < ldb;
#pragma unroll
    for (int i = 0; i < Tl::PB; ++i) {
      const bool ok = Tl::RPP * i < b_rows && k_ok;
      cp_async16(st + b_dst + i * Tl::RPP * Tl::ROW,
                 ok ? b_src + (size_t)i * Tl::RPP * ldb + kt * BK : o.b, ok);
    }
  };

  // ldmatrix.x4 lanes as in wgrad_staged_s8.cuh: A (m16 x k32 bytes) gives
  // a0..a3 of the mma, B (n16 x k32 bytes) b0, b1 of two n8 fragments.
  const int q = lane / 8, j = lane % 8;
  const int wm = warp / Tl::WARPS_N, wn = warp % Tl::WARPS_N;
  const uint32_t a_ld = (wm * 32 + (q & 1) * 8 + j) * Tl::ROW + (q >> 1) * 16;
  const uint32_t b_ld =
      Tl::A_BYTES + (wn * Tl::WN + (q >> 1) * 8 + j) * Tl::ROW + (q & 1) * 16;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step kt's tile landed; step kt-1's reads are done
    const int next = kt + STAGES - 1;
    if (next < steps) load(next, next % STAGES);
    cp_async_commit();
    const uint32_t st = s0 + (kt % STAGES) * Tl::STAGE_BYTES;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], st + a_ld + mi * 16 * Tl::ROW + ks * 32);
#pragma unroll
      for (int nj = 0; nj < Tl::NI / 2; ++nj) {
        uint32_t bf[4];
        ldmatrix_x4(bf, st + b_ld + nj * 16 * Tl::ROW + ks * 32);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          Mma<T>::run(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
          Mma<T>::run(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp's last reads of the ring are done
}

// The y position (image i, row chunk * rch + r, column c) of M row m of a
// chunk, or -1 for the pad column (c == w) and the tile tail: the 3x3's
// rows are m = (r * wq + c) * n + i (images innermost, so every tap is one
// position offset), the 1x1's m = (i * rch + r) * w + c (runs of rch * w
// positions contiguous in x and y).
__device__ __forceinline__ int y_pos(const Args& p, int chunk, int m) {
  int i, site;
  if (p.halo) {
    site = m / p.n;
    i = m - site * p.n;
  } else {
    const int per = p.rch * p.w;
    i = m / per;
    site = m - i * per;
    if (i >= p.n) return -1;
  }
  const int r = site / p.wq, c = site - r * p.wq;
  return (r < p.rch && c < p.w) ? (i * p.h + chunk * p.rch + r) * p.w + c
                                : -1;
}

// Grid (ceil(cout / BN), chunks * tiles): block (x, y) computes output
// columns [x * BN, x * BN + BN) of M tile y % tiles of chunk y / tiles, and
// writes its sums to part[y].
template <int BN, int BK>
__global__ void __launch_bounds__(THREADS, 2)
    fwd_staged_s8_kernel(Args p) {
  using T = Tile<BN, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * BN;
  const int chunk = blockIdx.y / p.tiles;
  const int m0 = (blockIdx.y - chunk * p.tiles) * BM;  // chunk-local
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;

  int acc[2][T::NI][4] = {};
  const Operands o{
      reinterpret_cast<const unsigned char*>(p.slab) +
          ((size_t)chunk * p.slab_len + m0) * p.cp,
      reinterpret_cast<const unsigned char*>(p.wt) +
          (size_t)n0 * p.taps * p.cp,
      nullptr, p.shift0, p.shift_row, p.shift_col, p.cp, p.taps,
      p.cout - n0, p.taps * p.cp, p.taps * p.cp};
  mainloop<signed char, BN, BK, false>(o, smem, acc);

  // The epilogue on the ring's memory: y = bf16(f32(acc) * f32(ws * sc)),
  // sc = the chunk's amax * f32(1/127), staged as [BM][OS] bf16.
  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(smem);
  int* pos = reinterpret_cast<int*>(smem + T::POS_OFF);
  float* red = reinterpret_cast<float*>(smem + T::RED_OFF);
  const float sc =
      __fmul_rn(common::chunk_amax(p.rowmax, chunk, p.rch, p.halo, p.h),
                common::kInv127);
#pragma unroll
  for (int ni = 0; ni < T::NI; ++ni) {
    const int nl = wn * T::WN + ni * 8 + (lane % 4) * 2;
    const int n = n0 + nl;  // cout % 8 == 0: n + 1 < cout where n < cout
    const float f0 = n < p.cout ? __fmul_rn(p.ws[n], sc) : 0.f;
    const float f1 = n < p.cout ? __fmul_rn(p.ws[n + 1], sc) : 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int ml = wm * 32 + mi * 16 + lane / 4 + hr * 8;
        *reinterpret_cast<__nv_bfloat162*>(out + ml * T::OS + nl) =
            __floats2bfloat162_rn(
                __fmul_rn(__int2float_rn(acc[mi][ni][2 * hr]), f0),
                __fmul_rn(__int2float_rn(acc[mi][ni][2 * hr + 1]), f1));
      }
  }
  // each tile row's y position, or -1 for the pad column (c == w) and the
  // tile tail
  if (tid < BM) pos[tid] = y_pos(p, chunk, m0 + tid);
  __syncthreads();

  // y in 16-byte vectors, a row's BN columns contiguous in device memory
  constexpr int VPR = BN / 8;
  const int cols = min(BN, p.cout - n0);
  for (int idx = tid; idx < BM * VPR; idx += THREADS) {
    const int ml = idx / VPR, v = idx % VPR;
    const int at = pos[ml];
    if (at >= 0 && v * 8 < cols)
      *reinterpret_cast<uint4*>(p.y + (size_t)at * p.cout + n0 + v * 8) =
          *reinterpret_cast<const uint4*>(out + ml * T::OS + v * 8);
  }

  // the sums: thread (part, col) adds its BM / PARTS rows in order, then
  // the parts in order
  const int col = tid % BN, pr = tid / BN;
  float s1 = 0.f, s2 = 0.f;
  for (int ml = pr * (BM / T::PARTS); ml < (pr + 1) * (BM / T::PARTS);
       ++ml) {
    if (pos[ml] < 0) continue;
    const float v = __bfloat162float(out[ml * T::OS + col]);
    s1 = __fadd_rn(s1, v);
    s2 = __fadd_rn(s2, __fmul_rn(v, v));
  }
  red[pr * BN + col] = s1;
  red[(T::PARTS + pr) * BN + col] = s2;
  __syncthreads();
  if (tid < 2 * BN) {
    const int qq = tid / BN, cc = tid % BN;
    if (n0 + cc < p.cout) {
      const float* r = red + qq * T::PARTS * BN + cc;
      float v = r[0];
      for (int k = 1; k < T::PARTS; ++k) v = __fadd_rn(v, r[k * BN]);
      p.part[(size_t)blockIdx.y * 2 * p.cout + qq * p.cout + n0 + cc] = v;
    }
  }
}

// --- the channel-major epilogue (outputs [Cout, lanes]) ----------------------

// A tile's live rows, in order, are one run of output lanes [lane0, lane0 +
// count) of every output column; at[ml] is row ml's place in the run, or -1
// (a row thrown away). The bf16 tile is staged channel-major, [BN][CM_OS],
// each column's run from element lead = lane0 % 8, so that its 16-byte
// vectors lie on 16-byte boundaries of device memory (rows of lanes a
// multiple of 8). CM_OS = BM + 8: room for the lead, a row stride of 68
// words (4 banks), so the fragment stores of a warp's 4 column pairs fall
// in distinct banks.
constexpr int CM_OS = BM + 8;

__device__ __forceinline__ float to_f32(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// out[n][lead + at[m]] = bf16(f32(acc(m, n)) * f32(col(n) * row[m])) for
// the live rows, col(n) the column's factor (n < BN, block-local), row[m]
// the row's (shared memory; null: 1). The caller syncs before reading out.
template <int BN, int BK, typename Acc, typename Col>
__device__ __forceinline__ void stage_cm(
    const Acc (&acc)[2][Tile<BN, BK>::NI][4], const int* at, int lead,
    const Col& col, const float* row, __nv_bfloat16* out) {
  using Tl = Tile<BN, BK>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / Tl::WARPS_N, wn = warp % Tl::WARPS_N;
  int dst[2][2];
  float rf[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int ml = wm * 32 + mi * 16 + lane / 4 + hr * 8;
      dst[mi][hr] = at[ml];
      rf[mi][hr] = row != nullptr ? row[ml] : 1.f;
    }
#pragma unroll
  for (int ni = 0; ni < Tl::NI; ++ni) {
    const int nl = wn * Tl::WN + ni * 8 + (lane % 4) * 2;
    const float c[2] = {col(nl), col(nl + 1)};
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        if (dst[mi][hr] < 0) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          out[(nl + e) * CM_OS + lead + dst[mi][hr]] = __float2bfloat16_rn(
              __fmul_rn(to_f32(acc[mi][ni][2 * hr + e]),
                        __fmul_rn(c[e], rf[mi][hr])));
      }
  }
}

// Column n (< cols) of the staged tile to dst + n * ld, elements [lead, lead
// + count) of dst's row (dst + lead is the run's first lane; dst 16-byte
// aligned, ld a multiple of 8): whole vectors as 16-byte stores, the run's
// ragged ends element by element.
template <int BN>
__device__ __forceinline__ void write_cm(const __nv_bfloat16* out, int lead,
                                         int count, int cols,
                                         __nv_bfloat16* dst, size_t ld) {
  const int end = lead + count;
  const int vpc = (end + 7) / 8;  // vectors a column
  for (int idx = threadIdx.x; idx < BN * vpc; idx += THREADS) {
    const int n = idx / vpc, j0 = (idx - n * vpc) * 8;
    if (n >= cols) continue;
    const __nv_bfloat16* src = out + n * CM_OS + j0;
    __nv_bfloat16* d = dst + n * ld + j0;
    if (j0 >= lead && j0 + 8 <= end) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8; ++e)
        if (j0 + e >= lead && j0 + e < end) d[e] = src[e];
    }
  }
}

// The staged columns' sums of f32(y) and y^2 over their run, into
// part[0][n0 + n] and part[0][cout + n0 + n] (columns n < cols): lane (c,
// q) of warp w takes column w * 8 + c (and + 64 while < BN) and sums words
// [17q, 17q + 17) of its staged row (the whole row: 4 x 17 words = CM_OS
// elements), masked to the run, in order; the four parts are added by a
// fixed butterfly. The row stride (68 words) and the part stride (17)
// put a warp's 32 reads in 32 banks. No barrier.
template <int BN>
__device__ __forceinline__ void sums_cm(const __nv_bfloat16* out, int lead,
                                        int count, int cols, float* part,
                                        int cout, int n0) {
  constexpr int W = CM_OS / 8;  // words a part
  static_assert(4 * W * 2 == CM_OS, "four parts cover a staged row");
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = lane % 8, q = lane / 8;
  for (int n = warp * 8 + c; n < BN; n += THREADS / 4) {
    const uint32_t* row =
        reinterpret_cast<const uint32_t*>(out + n * CM_OS) + q * W;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const uint32_t two = row[k];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // outside the run a zero, which leaves the sums as they are
        const int j = 2 * (q * W + k) + e;
        const float v = (unsigned)(j - lead) < (unsigned)count
                            ? __uint_as_float((two >> (16 * e)) << 16)
                            : 0.f;
        s1 = __fadd_rn(s1, v);
        s2 = __fadd_rn(s2, __fmul_rn(v, v));
      }
    }
#pragma unroll
    for (int o = 8; o < 32; o *= 2) {
      s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, o));
      s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, o));
    }
    if (q == 0 && n < cols) {
      part[n0 + n] = s1;
      part[cout + n0 + n] = s2;
    }
  }
}

}  // namespace fwd_staged_s8
