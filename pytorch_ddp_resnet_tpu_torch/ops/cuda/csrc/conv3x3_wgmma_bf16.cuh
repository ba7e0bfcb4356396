// The bf16 stride-1 SAME 3x3 conv, written for Hopper (sm_90a): y [Cout,
// N] = bf16(conv3x3(x, w)) in the channel-major layout, x [Cin, N] bf16, w
// [Cout, 9 * Cin] bf16 (taps row-major in (dh, dw), then input channel),
// f32 accumulation. conv3x3_same's forward and input gradient (the latter
// with the rot180, in/out-swapped packing) and the float calibration pass
// of int8 serving run it. Two launches: fused_half.cuh's slab_copy_kernel,
// then conv3x3_bf16_kernel.
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/conv.py:185,
// conv3x3_lanes -> _conv_kernel): per lane tile the TPU kernel contracts x
// at the nine taps with rolls and border masks of the tile on the MXU. Here:
// - the prepass (fused_half.cuh's slab_copy, the one slab copy, which the
//   int8 serving conv and the fused int8 dgrad launch on int8 codes) copies
//   x, unchanged, into the padded position-major slab of
//   ops/cuda/fused_block.py fused_fwd_layout (the fused bf16 forward's):
//   each pixel at its position, zeros at every guard, pad row, pad column
//   and tail position, so every tap (dh, dw) of M row m is slab row m +
//   shift[tap] for any image width;
// - conv3x3_bf16_kernel is fwd_wgmma_bf16.cuh's mainloop, unchanged (a
//   three-stage cp.async ring into 128-byte-swizzled shared memory, wgmma
//   m64nBNk16 from two consumer warpgroups, two blocks an SM, BN = 160
//   where Cout % 160 == 0, else 128, or 64 up to Cout = 64), then a plain
//   epilogue: each M row's lane from live_before (at[]), y = bf16(acc)
//   staged channel-major from each channel's own 16-byte lead, and each
//   channel's run of live lanes written to [Cout, N] in 16-byte vectors
//   (requant_wgmma_s8.cuh's write_runs), so any N and any Cout. No
//   residual, no sums, no third launch.
//
// What bounds it on an H100: operations (2 * 9 * Cin * Cout * N: 60.4
// GFLOP a call at each WRN-28-10 stage, batch 128, 0.061 ms at 989
// TFLOP/s); the prepass by its bytes (x read and the slab written: 87 / 45
// / 25 MB at the three stages).
//
// Grid: one dimension, ceil(Cout / BN) N tiles x M tiles, the N tiles of
// one M tile neighbours (they read its A rows through L2); no limit of
// 65,535 M tiles.
//
// Left for later: TMA for the bf16 mainloop (it would move the fused bf16
// forward, its dgrad and the transition's dgrad at once), the pad rows
// (27% of the M rows at 8x8 images: 81 positions an image for 64 pixels)
// and the wave tail (324 blocks on 264 slots at 8x8, batch 128).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_half.cuh"        // slab_copy
#include "fwd_wgmma_bf16.cuh"    // the mainloop, Tile, Args, live_before
#include "requant_wgmma_s8.cuh"  // write_runs

namespace conv3x3_wgmma_bf16 {

using fwd_staged_s8::CM_OS;
using fwd_wgmma_bf16::ALIGN;
using fwd_wgmma_bf16::Args;
using fwd_wgmma_bf16::BM;
using fwd_wgmma_bf16::live_before;
using fwd_wgmma_bf16::THREADS;
using fwd_wgmma_bf16::Tile;
using requant_wgmma_s8::write_runs;
using wgrad_staged::smem_u32;

// --- the prepass: x into the padded slab -------------------------------------

// slab [slab_len][cin] bf16 (fused_fwd_layout: guard = wi + 2 zero
// positions, per image of h x wi a zero row and a zero column, zeros to
// slab_len) from x [cin][n] bf16: fused_half.cuh's slab_copy, one launch.
// cin % 32 == 0, n a multiple of h * wi.
inline cudaError_t pre_launch(const void* x, void* slab, int cin, int n,
                              int h, int wi, long slab_len,
                              cudaStream_t stream) {
  return fused_half::slab_copy(static_cast<const __nv_bfloat16*>(x),
                               static_cast<__nv_bfloat16*>(slab), cin, cin,
                               n, h, wi, slab_len, stream);
}

// --- the GEMM ----------------------------------------------------------------

// Grid (n_tiles * tiles): block i computes output channels [x * BN, x * BN
// + BN) of M tile y, x = i % n_tiles, y = i / n_tiles.
template <int BN>
__global__ void __launch_bounds__(THREADS, 2)
    conv3x3_bf16_kernel(const __grid_constant__ Args p, int n_tiles) {
  using T = Tile<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (ALIGN - raw % ALIGN) % ALIGN;
  unsigned char* smem = smem_raw + pad;
  const int tid = threadIdx.x;
  const int n0 = (int)(blockIdx.x % n_tiles) * BN;
  const int m0 = (int)(blockIdx.x / n_tiles) * BM;

  float acc[T::NACC];
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) acc[i] = 0.f;
  fwd_wgmma_bf16::mainloop<BN>(p, raw + pad, m0, n0, acc);

  // this tile's run of lanes [lane0, lane0 + count) and each row's place
  // in it, or -1 (a pad row or column, or the tail)
  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(smem);
  int* at = reinterpret_cast<int*>(smem + T::AT_OFF);
  const int lane0 = live_before(p, m0);
  const int count = live_before(p, m0 + BM) - lane0;
  if (tid < BM) {
    const int m = m0 + tid, k = live_before(p, m);
    at[tid] = live_before(p, m + 1) > k ? k - lane0 : -1;
  }
  __syncthreads();

  // y = bf16(acc): acc[4 j + 2 h + e] is row 16 w + l / 4 + 8 h of the
  // warpgroup's 64, column 8 j + 2 (l % 4) + e, staged at its channel's
  // lead + at[row] (columns past Cout are staged and never written). The
  // lead of channel co, (co * n + lane0) % 8 (lead_of<8>), is (co * (n %
  // 8) + lane0) % 8, the same for columns 8 apart: a thread's columns take
  // two leads, one for each e.
  const int warp = tid / 32, lane = tid % 32;
  const int row = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
  const int at0 = at[row], at1 = at[row + 8];
  const unsigned nm = (unsigned)p.n % 8;
  const unsigned lead0 = (unsigned)(n0 + 2 * (lane % 4)) * nm + lane0;
  const int lead[2] = {(int)(lead0 % 8), (int)((lead0 + nm) % 8)};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      __nv_bfloat16* o =
          out + (8 * j + 2 * (lane % 4) + e) * CM_OS + lead[e];
      if (at0 >= 0) o[at0] = __float2bfloat16_rn(acc[4 * j + e]);
      if (at1 >= 0) o[at1] = __float2bfloat16_rn(acc[4 * j + 2 + e]);
    }
  }
  __syncthreads();

  write_runs(out, CM_OS, lane0, count, min(BN, p.cout - n0), n0, p.n, p.y);
}

template <int BN>
inline cudaError_t launch_tile(const Args& p, int n_tiles, long blocks,
                               cudaStream_t stream) {
  constexpr int smem = Tile<BN>::SMEM;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_bf16_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  conv3x3_bf16_kernel<BN><<<(unsigned)blocks, THREADS, smem, stream>>>(
      p, n_tiles);
  return cudaGetLastError();
}

// y [cout][n] bf16 from the slab [slab_len][cin] bf16 of fused_fwd_layout
// (pre_launch) and w [cout][9 * cin] bf16, on `tiles` 128-row M tiles and
// bn-wide N tiles (160, 128 or 64). cin % 32 == 0; any cout and n of
// whole images.
inline cudaError_t launch(const void* slab, const void* w, void* y, int cin,
                          int cout, int n, int h, int wi, long slab_len,
                          int tiles, int bn, cudaStream_t stream) {
  if (cin < 32 || cin % 32 || cout < 1 || n < 1 || h < 1 || wi < 1 ||
      n % (h * wi) || tiles < 1 ||
      (long)tiles * BM < (long)(n / (h * wi)) * (h + 1) * (wi + 1) ||
      slab_len < 2L * (wi + 2) + (long)tiles * BM ||
      (bn != 160 && bn != 128 && bn != 64))
    return cudaErrorInvalidValue;
  const int n_tiles = (cout + bn - 1) / bn;
  const long blocks = (long)n_tiles * tiles;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  Args p{};
  p.slab = static_cast<const __nv_bfloat16*>(slab);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.cin = cin;
  p.cout = cout;
  p.n = n;
  p.b = n / (h * wi);
  p.h = h;
  p.wi = wi;
  p.guard = wi + 2;
  if (bn == 160) return launch_tile<160>(p, n_tiles, blocks, stream);
  if (bn == 128) return launch_tile<128>(p, n_tiles, blocks, stream);
  return launch_tile<64>(p, n_tiles, blocks, stream);
}

}  // namespace conv3x3_wgmma_bf16
