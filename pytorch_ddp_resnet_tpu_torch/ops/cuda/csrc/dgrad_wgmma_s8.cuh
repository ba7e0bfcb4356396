// The fused int8 block-half's input gradient GEMM in fully quantized
// training, written for Hopper (sm_90a): acc = the transposed 3x3 conv of
// the cotangent's codes g_q with the dgrad-packed int8 weights, exact in
// s32; v = f32(acc) * (ws_in[ci] * g_amax_g / 127); then through the
// prologue's masks dx = bf16(dn * scale) in the channel-major layout [Cin,
// B*H*W], and per 128-row tile the f32 sums of dn * x and dn. It reads the
// padded slab its prepass wrote (fused_half.cuh's slab_copy: g_q's codes
// copied once, unchanged).
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/fused_block.py:588,
// _dgrad_call -> _dgrad_kernel with quant=True, the int8 body, and the
// dgrad half of the fused backward at :992): per lane tile (a scale group)
// the TPU kernel quantizes the folded cotangent, contracts it at the nine
// taps with rolls of the tile on the MXU into s32, dequantizes with the
// group's absmax and the weights' per-input-channel scales and applies the
// relu and dropout masks recomputed from x. The input gradient is the
// forward conv of g with w_dg[ci, (dh, dw, co)] = w[co, ci, 2 - dh, 2 - dw]
// (rot180, in and out swapped: fused_block.py quantize_pack_weights_dgrad),
// so the slab is the int8 forward's (ops/cuda/fused_block.py
// fused_fwd_int8_plan with Cin = the half's Cout, Cout = its Cin) and the
// mainloop is fwd_wgmma_s8.cuh's, unchanged: every tap one TMA box of 128,
// 64 or 32 bytes at one row offset, any image width.
//   M = the padded positions in 128-row tiles, N = the half's Cin (BN =
//   160 at every WRN-28-10 width), K = (tap, the half's Cout channel),
//   w_dg's order ([Cin, 9 * Cout]); REM = Cout % 128 names a tap's last
//   boxes (32, 64, 0 at C = 160, 320, 640).
//
// What bounds it on an H100: operations (2 * 9 * Cin * Cout * N: 60.4 GOP
// a call at each WRN-28-10 stage, batch 128, 0.0305 ms at 1,979 TOP/s;
// the slab, x, the bits and dx are 30-50 MB, 0.009-0.015 ms at 3.35 TB/s).
// What the design does about it: the forward's TMA-fed s8 wgmma mainloop
// (m64nBNk32 from two consumer warpgroups, thread 0 starting the loads,
// three ring slots at BN = 160, two blocks an SM) on a kernel of its own
// with dgrad_wgmma_bf16.cuh's masking epilogue after a dequantization:
// - each M row's lane and scale group from live_before (at[], and the
//   row's scale g_amax_g * (1/127) in rs[]: a 128-row tile spans two
//   groups wherever a group boundary falls inside it);
// - v = f32(acc) * (ws_in[ci] * rs[row]) (the reference's order, each
//   product rounded: __fmul_rn, no FMA), staged channel-major in f32 in
//   the ring's memory, [BN][CF_OS] (89,600 bytes at BN = 160, inside the
//   s8 ring's 110,592 once the mainloop drained);
// - mask_units: each channel's run in 8-lane units, x and the bits read as
//   16 and 8 bytes (or the mask rebuilt from the seed at the element's
//   global (channel, lane)), live = fma(x, scale, shift) > 0 and bits <
//   thresh, dn = live ? v * keep : 0, dx = bf16(dn * scale) written as 16
//   bytes, each unit's sums of dn * x and dn in lane order; channel_sums
//   adds a channel's units in lane order into part[tile]; common::tile_sum
//   (fused_block.cu's `.sum`) adds the tiles in a fixed order. dx is
//   bit-equal to the plain version and the sums the same bits every run.
// The kernel is instantiated here, not through fwd_wgmma_s8.cuh's launch(),
// so only fused_block.cu compiles it.
//
// Left for later: g_q's slab written by the quantizer itself (a transpose
// through shared memory that fused_half.cuh's quant_kernel, shared with the
// transition's quantizer, does not have), persistent blocks, the pad rows
// (6.3% at 32x32), the wave tails (1,089 / 578 / 324 blocks at the three
// stages on 264 slots).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"            // kInv127
#include "dgrad_wgmma_bf16.cuh"  // Epi, CF_OS, mask_units, channel_sums
#include "fwd_wgmma_s8.cuh"      // mainloop, Tile, Maps, encode_maps

namespace dgrad_wgmma_s8 {

using dgrad_wgmma_bf16::CF_OS;
using dgrad_wgmma_bf16::Epi;
using fwd_wgmma_bf16::live_before;
using fwd_wgmma_s8::ALIGN;
using fwd_wgmma_s8::BK;
using fwd_wgmma_s8::BM;
using fwd_wgmma_s8::Maps;
using fwd_wgmma_s8::THREADS;
using fwd_wgmma_s8::Tile;
using wgrad_staged::smem_u32;

// The epilogue's use of the ring after the mainloop: the staged f32 tile
// [BN][CF_OS], each M row's place in the run (at) and scale (rs), each
// channel's weight scale (wsc).
template <int BN>
struct Stage {
  static constexpr int AT_OFF = BN * CF_OS * 4;
  static constexpr int RS_OFF = AT_OFF + BM * 4;
  static constexpr int WS_OFF = RS_OFF + BM * 4;
  static constexpr int BYTES = WS_OFF + BN * 4;
  static_assert(BYTES <= Tile<BN>::RING, "the epilogue fits the ring");
};

// The GEMM's shapes: cin its K channels (the half's Cout, the slab's), cout
// its N (the half's Cin).
struct Args {
  const float* g_amax;  // [n / lanes] the cotangent groups' absmax
  const float* ws_in;   // [cout] per-input-channel weight scales
  int cin, cout, n, b, h, wi;
  int lanes;            // lanes a scale group
  int tap[9];           // slab row of tap t for M row 0
};

// The epilogue's reads on their way to L2 while the mainloop runs: x
// (and a bits tensor) over the lanes [base, base + lanes) of each of the
// block's channels [n0, n0 + cols), one prefetch a 128-byte line, the
// block's threads taking the lines in turn. The mask pass then waits on
// L2, not on device memory.
__device__ __forceinline__ void prefetch_run(const Epi& e, int n0, int cols,
                                             int base, int lanes, int n) {
  if (lanes <= 0) return;
  const int xl = (2 * lanes + 127) / 128 + 1;  // lines a run may touch
  const int bl = e.bits.bits != nullptr ? (lanes + 127) / 128 + 1 : 0;
  const int per = xl + bl;
  for (int i = threadIdx.x; i < cols * per; i += THREADS) {
    const int c = i / per, k = i - c * per;
    const size_t at = (size_t)(n0 + c) * n + base;
    const uintptr_t lo =
        k < xl ? reinterpret_cast<uintptr_t>(e.x + at)
               : reinterpret_cast<uintptr_t>(e.bits.bits + at);
    const uintptr_t hi = lo + (k < xl ? 2 * lanes : lanes) - 1;
    const uintptr_t line =
        (lo & ~uintptr_t(127)) + 128 * (k < xl ? k : k - xl);
    if (line <= hi)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(line));
  }
}

// Grid (ceil(cout / BN), tiles): block (x, y) computes the half's input
// channels [x * BN, x * BN + BN) of M tile y (the N tiles of one M tile
// neighbours, so they read its A boxes through L2) and writes their sums
// to part[y]. REM = cin % 128 names the tap's last boxes.
template <int BN, int REM>
__global__ void __launch_bounds__(THREADS, 2)
    dgrad_s8_kernel(const __grid_constant__ Maps mp,
                    const __grid_constant__ Args p,
                    const __grid_constant__ Epi e) {
  using S = Stage<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (ALIGN - raw % ALIGN) % ALIGN;
  unsigned char* smem = smem_raw + pad;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  // this tile's run of lanes [lane0, lane0 + count), read by the
  // epilogue in 8-lane units from lane0 - lead
  const int lane0 = live_before(m0, p.b, p.h, p.wi, p.n);
  const int count = live_before(m0 + BM, p.b, p.h, p.wi, p.n) - lane0;
  const int lead = lane0 % 8;
  const int cols = min(BN, p.cout - n0);
  prefetch_run(e, n0, cols, lane0 - lead, (lead + count + 7) / 8 * 8, p.n);
  int acc[BN / 2];
  fwd_wgmma_s8::mainloop<BN, REM>(mp, p.cin, p.tap, raw + pad, m0, n0, acc);

  // each row's place in the run or -1 (a pad row or column, or the tail),
  // each live row's scale g_amax_g * (1/127) (its own group's), the
  // channels' weight scales
  float* out = reinterpret_cast<float*>(smem);
  int* at = reinterpret_cast<int*>(smem + S::AT_OFF);
  float* rs = reinterpret_cast<float*>(smem + S::RS_OFF);
  float* wsc = reinterpret_cast<float*>(smem + S::WS_OFF);
  if (tid < BM) {
    const int m = m0 + tid, k = live_before(m, p.b, p.h, p.wi, p.n);
    const bool live = live_before(m + 1, p.b, p.h, p.wi, p.n) > k;
    at[tid] = live ? k - lane0 : -1;
    rs[tid] = live ? __fmul_rn(p.g_amax[k / p.lanes], common::kInv127) : 0.f;
  }
  if (tid < BN) wsc[tid] = tid < cols ? p.ws_in[n0 + tid] : 0.f;
  __syncthreads();

  // v = f32(acc) * (ws_in[ci] * rs[row]) staged channel-major in f32:
  // out[n][lead + at[row]]; acc[4 j + 2 h + e] is row 16 w + l / 4 + 8 h
  // of the warpgroup's 64, column 8 j + 2 (l % 4) + e
  const int row = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
  const int at0 = at[row], at1 = at[row + 8];
  const float rs0 = rs[row], rs1 = rs[row + 8];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float w = wsc[col + h];
      if (at0 >= 0)
        out[(col + h) * CF_OS + lead + at0] =
            __fmul_rn(__int2float_rn(acc[4 * j + h]), __fmul_rn(w, rs0));
      if (at1 >= 0)
        out[(col + h) * CF_OS + lead + at1] =
            __fmul_rn(__int2float_rn(acc[4 * j + 2 + h]), __fmul_rn(w, rs1));
    }
  }
  __syncthreads();

  dgrad_wgmma_bf16::mask_units<BN>(out, lead, count, cols, n0, lane0 - lead,
                                   p.n, e);
  __syncthreads();
  dgrad_wgmma_bf16::channel_sums(
      out, lead, count, cols, e.part + (size_t)blockIdx.y * 2 * p.cout + n0,
      p.cout);
}

template <int BN, int REM>
inline cudaError_t launch_kernel(const Maps& mp, const Args& p, const Epi& e,
                                 int tiles, cudaStream_t stream) {
  constexpr int smem = Tile<BN>::SMEM;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dgrad_s8_kernel<BN, REM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((p.cout + BN - 1) / BN, tiles);
  dgrad_s8_kernel<BN, REM><<<grid, THREADS, smem, stream>>>(mp, p, e);
  return cudaGetLastError();
}

template <int BN>
inline cudaError_t launch_tile(const Maps& mp, const Args& p, const Epi& e,
                               int tiles, cudaStream_t stream) {
  switch (p.cin % BK) {
    case 0: return launch_kernel<BN, 0>(mp, p, e, tiles, stream);
    case 32: return launch_kernel<BN, 32>(mp, p, e, tiles, stream);
    case 64: return launch_kernel<BN, 64>(mp, p, e, tiles, stream);
    default: return launch_kernel<BN, 96>(mp, p, e, tiles, stream);
  }
}

// dx [cout][n] bf16 and part [tiles][2 * cout] f32 (e) from the slab
// [slab_len][cin] int8 of fused_fwd_layout (guard = wi + 2, h x wi images)
// and w_dg [cout][9 * cin] int8 (dgrad-packed), on `tiles` 128-row M tiles
// and bn-wide N tiles (160, 128 or 64). cin % 32 == 0, cout % 8 == 0, n
// % 8 == 0, whole images; lanes tiles n.
inline cudaError_t launch(const void* slab, const void* w, const Args& args,
                          const Epi& e, long slab_len, int tiles, int bn,
                          cudaStream_t stream) {
  Args p = args;
  if (p.cin < 32 || p.cin % 32 || p.cout < 8 || p.cout % 8 || p.n < 8 ||
      p.n % 8 || p.h < 1 || p.wi < 1 || p.n % (p.h * p.wi) ||
      p.b != p.n / (p.h * p.wi) || p.lanes < 1 || p.n % p.lanes ||
      tiles < 1 || tiles > 65535 ||
      slab_len < 2L * (p.wi + 2) + (long)tiles * BM || e.part == nullptr ||
      (bn != 160 && bn != 128 && bn != 64))
    return cudaErrorInvalidValue;
  fwd_wgmma_s8::tap_rows(p.tap, p.wi);
  Maps mp;
  if (!fwd_wgmma_s8::encode_maps(&mp, slab, slab_len, w, p.cin, p.cout, bn,
                                 9))
    return cudaErrorInvalidValue;
  if (bn == 160) return launch_tile<160>(mp, p, e, tiles, stream);
  if (bn == 128) return launch_tile<128>(mp, p, e, tiles, stream);
  return launch_tile<64>(mp, p, e, tiles, stream);
}

}  // namespace dgrad_wgmma_s8
