// The fused bf16 block-half's input gradient GEMM, written for Hopper
// (sm_90a): acc = the transposed 3x3 conv of g with the dgrad-packed
// weights, then through the prologue's masks dx = bf16(dn * scale) in the
// channel-major layout [Cin, B*H*W] and per 128-row tile the f32 sums of
// dn * x and dn, from the slab its prepass wrote (fused_block_bf16.cu,
// fused_dgrad_pre_kernel: g = bf16(gf) once per element).
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/fused_block.py:588,
// _dgrad_call -> _dgrad_kernel with quant=False, the bf16 body): the TPU
// kernel folds the stats cotangents into g in VMEM, contracts it at the
// nine taps with rolls of its lane tile and applies the relu and dropout
// masks recomputed from x. The input gradient is the forward conv of g
// with w_dg[ci, (dh, dw, co)] = w[co, ci, 2 - dh, 2 - dw] (rot180, in and
// out swapped: ops/cuda/conv3x3.py pack_weights_dgrad), so the slab is the
// forward's (ops/cuda/fused_block.py fused_fwd_layout with Cin = the
// half's Cout) and the mainloop is fwd_wgmma_bf16.cuh's, unchanged: every
// tap one row offset, any image width.
//   M = the padded positions in 128-row tiles, N = the half's Cin, K =
//   (tap, the half's Cout channel), w_dg's order ([Cin, 9 * Cout]).
//
// What bounds it on an H100: operations (2 * 9 * Cin * Cout * N: 60.4
// GFLOP a call at each WRN-28-10 stage, batch 128, 0.061 ms at 989
// TFLOP/s; the slab, x, the bits and dx are 40-60 MB, 0.012-0.018 ms at
// 3.35 TB/s). What the design does about it: the forward's wgmma mainloop
// (cp.async ring in the 128-byte swizzle, m64nBNk16 from two warpgroups,
// two blocks an SM) on a second kernel with its own epilogue; the
// forward's kernel and epilogue are untouched. The epilogue:
// - stages the f32 accumulators channel-major in the ring's memory,
//   [BN][CF_OS] (a tile's live rows are one run of output lanes, each
//   row's place in it from live_before, as the forward's epilogue);
// - walks each channel's run in 8-lane units, a thread each, neighbours
//   on neighbouring units: x and the bits read as 16 and 8 bytes (or the
//   bits rebuilt from the seed at the element's global (channel, lane),
//   seed_bits.cuh), live = fma(x, scale, shift) > 0 (f32, unrounded) and
//   bits < thresh, dn = live ? acc * keep : 0 (__fmul_rn), dx = bf16(dn *
//   scale) written as 16 bytes (element by element at the run's ragged
//   ends), and the unit's sums of dn * x and dn, in lane order, into the
//   unit's own staged slots;
// - then one thread a channel adds its units' sums in lane order into
//   part[tile]; fused_block_bf16.cu's sum adds the tiles in a fixed order
//   (common::tile_sum), so dx and the sums are the same bit for bit every
//   run.
// The fused int8 dgrad (dgrad_wgmma_s8.cuh) runs the same epilogue
// (mask_units, channel_sums) on its dequantized accumulators.
//
// Left for later: TMA and a producer warp, persistent blocks, the pad rows
// (6.3% at 32x32 images), the wave tails (1,089 / 289 / 81 M tiles at the
// three WRN-28-10 stages), sharing the prepass's g with the weight
// gradient's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_half.cuh"      // load8, pack8
#include "fwd_wgmma_bf16.cuh"  // Args, Tile, mainloop, live_before
#include "seed_bits.cuh"

namespace dgrad_wgmma_bf16 {

using fwd_wgmma_bf16::ALIGN;
using fwd_wgmma_bf16::Args;
using fwd_wgmma_bf16::BM;
using fwd_wgmma_bf16::live_before;
using fwd_wgmma_bf16::THREADS;
using fwd_wgmma_bf16::Tile;
using wgrad_staged::smem_u32;

// f32 words a staged channel: room for the lead (< 8) and the run (<= BM);
// a row stride of 140 words (12 banks) puts the fragment stores of a
// warp's 4 column pairs x 8 rows in 32 distinct banks, and keeps every
// unit's 8 words 16-byte aligned
constexpr int CF_OS = BM + 12;
static_assert(CF_OS % 4 == 0 && CF_OS >= BM + 8, "the staged row");

// The masks' operands and the outputs (GEMM column c is the half's input
// channel c)
struct Epi {
  const __nv_bfloat16* x;  // [cout][n]
  const float* scale;      // [cout]
  const float* shift;      // [cout]
  dropout::DropBits bits;  // [cout][n] uint8, a seed, or none
  __nv_bfloat16* dx;       // [cout][n]
  float* part;             // [tiles][2 * cout]
  int thresh;
  float keep;              // f32(256 / thresh)
};

// Unit idx (column c = idx / vpc, 8 staged lanes from j0 = idx % vpc * 8)
// of the staged tile: dn through the masks, dx written where the lanes
// lie in the run [lead, lead + count), the unit's sums of dn * x and dn
// (in lane order) left in its first two staged words. base is the lane of
// staged element 0 (a multiple of 8, so every 16-byte vector of a row
// lies on a 16-byte boundary and inside the row).
template <int BN>
__device__ __forceinline__ void mask_units(float* out, int lead, int count,
                                           int cols, int n0, int base,
                                           int n, const Epi& e) {
  const int end = lead + count;
  const int vpc = (end + 7) / 8;  // units a column
  const bool drop = e.bits.active();
  for (int idx = threadIdx.x; idx < BN * vpc; idx += THREADS) {
    const int c = idx / vpc, j0 = (idx - c * vpc) * 8;
    if (c >= cols) continue;
    const int ci = n0 + c, lane = base + j0;
    const size_t g = (size_t)ci * n + lane;
    float* src = out + c * CF_OS + j0;
    const float4 a0 = *reinterpret_cast<const float4*>(src);
    const float4 a1 = *reinterpret_cast<const float4*>(src + 4);
    const float acc[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float xv[8];
    fused_half::load8(e.x, g, xv);
    unsigned char b[8];
    e.bits.load8(ci, lane, b);
    const float sc = e.scale[ci], sh = e.shift[ci];
    __nv_bfloat16 d[8];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const bool in_run = j0 + k >= lead && j0 + k < end;
      bool live = in_run && __fmaf_rn(xv[k], sc, sh) > 0.f;
      float v = acc[k];
      if (drop) {
        live = live && b[k] < e.thresh;
        v = __fmul_rn(v, e.keep);
      }
      const float dn = live ? v : 0.f;
      d[k] = __float2bfloat16_rn(__fmul_rn(dn, sc));
      s1 = __fadd_rn(s1, __fmul_rn(dn, xv[k]));
      s2 = __fadd_rn(s2, dn);
    }
    if (j0 >= lead && j0 + 8 <= end) {
      *reinterpret_cast<uint4*>(e.dx + g) = fused_half::pack8(d);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (j0 + k >= lead && j0 + k < end) e.dx[g + k] = d[k];
    }
    src[0] = s1;
    src[1] = s2;
  }
}

// After mask_units (and a sync): each channel c < cols of the staged tile
// adds its units' sums in lane order into part[c] and part[cout + c] (the
// tile's row of [tiles][2 * cout], from channel n0), a thread a channel.
__device__ __forceinline__ void channel_sums(const float* out, int lead,
                                             int count, int cols,
                                             float* part, int cout) {
  const int tid = threadIdx.x;
  if (tid >= cols) return;
  const int vpc = (lead + count + 7) / 8;
  const float* col = out + tid * CF_OS;
  float s1 = 0.f, s2 = 0.f;
  for (int u = 0; u < vpc; ++u) {
    s1 = __fadd_rn(s1, col[8 * u]);
    s2 = __fadd_rn(s2, col[8 * u + 1]);
  }
  part[tid] = s1;
  part[cout + tid] = s2;
}

// Grid (ceil(cout / BN), tiles): block (x, y) computes input channels [x *
// BN, x * BN + BN) of M tile y (the N tiles of one M tile neighbours, so
// they read its A rows through L2) and writes their sums to part[y].
template <int BN>
__global__ void __launch_bounds__(THREADS, 2)
    fused_dgrad_gemm_kernel(const __grid_constant__ Args p,
                            const __grid_constant__ Epi e) {
  using T = Tile<BN>;
  static_assert(BN * CF_OS * 4 + BM * 4 <= T::RING,
                "the epilogue fits in the ring");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (ALIGN - raw % ALIGN) % ALIGN;
  unsigned char* smem = smem_raw + pad;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  float acc[T::NACC];
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) acc[i] = 0.f;
  fwd_wgmma_bf16::mainloop<BN>(p, raw + pad, m0, n0, acc);

  // this tile's run of lanes [lane0, lane0 + count) and each row's place
  // in it, or -1 (a pad row or column, or the tail)
  float* out = reinterpret_cast<float*>(smem);
  int* at = reinterpret_cast<int*>(smem + BN * CF_OS * 4);
  const int lane0 = live_before(p, m0);
  const int count = live_before(p, m0 + BM) - lane0;
  const int lead = lane0 % 8;
  if (tid < BM) {
    const int m = m0 + tid, k = live_before(p, m);
    at[tid] = live_before(p, m + 1) > k ? k - lane0 : -1;
  }
  __syncthreads();

  // acc staged channel-major in f32: out[n][lead + at[row]]
  const int row = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
  const int at0 = at[row], at1 = at[row + 8];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (at0 >= 0) out[(col + h) * CF_OS + lead + at0] = acc[4 * j + h];
      if (at1 >= 0) out[(col + h) * CF_OS + lead + at1] = acc[4 * j + 2 + h];
    }
  }
  __syncthreads();

  const int cols = min(BN, p.cout - n0);
  mask_units<BN>(out, lead, count, cols, n0, lane0 - lead, p.n, e);
  __syncthreads();
  channel_sums(out, lead, count, cols,
               e.part + (size_t)blockIdx.y * 2 * p.cout + n0, p.cout);
}

template <int BN>
inline cudaError_t launch_tile(const Args& p, const Epi& e, int tiles,
                               cudaStream_t stream) {
  constexpr int smem = Tile<BN>::SMEM;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_dgrad_gemm_kernel<BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((p.cout + BN - 1) / BN, tiles);
  fused_dgrad_gemm_kernel<BN><<<grid, THREADS, smem, stream>>>(p, e);
  return cudaGetLastError();
}

// The GEMM on `tiles` 128-row M tiles with a bn-wide N tile (160, 128 or
// 64). p.cin (the slab's channels) % 8 == 0, p.cout % 8 == 0, p.n % 8 ==
// 0; p.y, p.res and p.part are not read.
inline cudaError_t launch(const Args& p, const Epi& e, int tiles, int bn,
                          cudaStream_t stream) {
  if (p.cin % 8 || p.cout % 8 || p.n % 8 || tiles < 1 || tiles > 65535 ||
      e.part == nullptr)
    return cudaErrorInvalidValue;
  if (bn == 160) return launch_tile<160>(p, e, tiles, stream);
  if (bn == 128) return launch_tile<128>(p, e, tiles, stream);
  if (bn == 64) return launch_tile<64>(p, e, tiles, stream);
  return cudaErrorInvalidValue;
}

}  // namespace dgrad_wgmma_bf16
