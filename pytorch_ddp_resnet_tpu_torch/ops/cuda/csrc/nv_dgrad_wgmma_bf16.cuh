// The NV training halves' input gradient in straight-through (QAT)
// training, written for Hopper (sm_90a): acc = the f32 correlation of the
// cotangent's bf16 slab with the per-input-channel bf16 weights (the 3x3's
// taps mirrored), da = acc (entry mode: __fadd_rn(acc, dx_res)), then the
// prologue's backward: dx = bf16(da) (identity), else du = fma(x, s, t)
// (+ res) > 0 ? da : 0, dx = bf16(du * s), dres = bf16(du) (entry), and
// per 128-row tile the f32 sums of du * x and du. It reads the slab its
// prepass wrote (bneck_nv_train.cu, nvt_fwd_pre_kernel<Cot, Bf16Out>: the
// folded cotangent g = fma(2y, dzssq, dy + dzsum) rounded to bf16 once).
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/bneck_nv_train.py:866,
// _dgrad_call -> _dgrad1x1_kernel (:461), _dgrad3x3_kernel (:525) with
// quant_bwd=False): the TPU kernel rounds each chunk's folded cotangent to
// bf16 and contracts it at the 9 mirrored tap shifts of its [h, wp, N, C]
// carrier in f32, then runs the prologue's backward. The bf16 body has no
// scale groups, so its slab is one chunk of h rows in the int8 body's
// layout (ops/cuda/bneck_nv_train.py fwd_int8_layout(n, h, w, Cout, taps,
// h), bf16 elements, cp channels a position): output position (r, c, i)
// at M row m = (r * wq + c) * n + i (3x3: images innermost, wq = w + 1, a
// zero column after each row, guards of n positions, no halo row twice)
// or (i * h + r) * w + c (1x1: plain NHWC and the tile tail). Forward tap
// t reads slab row m + shifts[t]; the input gradient's tap t reads g(r -
// dy + 1, c - dx + 1), the mirror's row m + shifts[8 - t], in closed form
// guard + ((2 - t / 3) * wq + 1 - t % 3) * n (MirrorTaps); the zero
// column and the guards cover both image borders: no masks.
//   M = the image's positions in 128-row tiles, N = the half's Cin, K =
//   (tap, the half's Cout channel): wb_dg's order ([Cin, taps * cp] bf16,
//   forward tap coordinates, pad channels zero).
//
// What bounds it on an H100: bytes, at every ResNet-50 stage (the slab,
// x (and res, dx_res) in, dx (and dres) out, against 2 * positions * taps
// * Cin * Cout bf16 operations). What the design does about it: the fold
// and the rounding run once per element in the prepass, not once per
// (tap, N tile) that reads it; the GEMM is fwd_wgmma_bf16.cuh's mainloop
// unchanged (a cp.async ring of 128-byte K steps into 128-byte-swizzled
// shared memory, each 16-byte piece at its own tap, wgmma m64nBNk16 from
// two consumer warpgroups, two blocks an SM) walking the mirrored taps
// (TapWalk) at BN = 128 where Cin >= 128 (the slab read ceil(Cin / 128)
// times, the N tiles of one M tile neighbours in the grid so that they
// share its rows in L2), else 64; the epilogue is the int8 body's
// (nv_dgrad_epilogue.cuh's prologue_bwd at the value policy Bf16Acc):
// f32(acc) staged row-major in the drained ring, 16-byte NHWC vectors, the
// sums in a fixed order into part[tile], and common::tile_sum adds the
// tiles in a fixed order, so the sums are the same bits every run.
//
// The kernel and its launcher are built in bneck_nv_train.cu alone, its
// one caller.
//
// Left for later: the slab's bytes (written once, read back through L2 by
// each N tile; at the 1x1 halves the same bf16(g) that the bf16 wgrad's
// prepass writes again); TMA and persistent blocks; the pad column's rows
// at the 3x3 (1 / (w + 1) of the tiles' rows).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fwd_staged_s8.cuh"      // fwd_staged_s8::Args: the layout's rows
#include "fwd_wgmma_bf16.cuh"     // mainloop, TapWalk, Tile
#include "nv_dgrad_epilogue.cuh"  // prologue_bwd, Bf16Acc, Mode

namespace nv_dgrad_wgmma_bf16 {

using fwd_wgmma_bf16::ALIGN;
using fwd_wgmma_bf16::BM;
using fwd_wgmma_bf16::TapWalk;
using fwd_wgmma_bf16::THREADS;
using fwd_wgmma_bf16::Tile;
using nv_dgrad::IDENTITY;
using wgrad_staged::smem_u32;

typedef __nv_bfloat16 bf16;
static_assert(THREADS == nv_dgrad::THREADS && BM == nv_dgrad::BM,
              "the epilogue's block and tile");

// The walk's tap t at (2 - t / 3) * row + (1 - t % 3) * col positions past
// the guard: the mirror of forward tap t (3x3: row = wq * n, col = n; the
// 1x1's one tap: row = col = 0).
struct MirrorTaps {
  int row, col;
  __device__ __forceinline__ int operator()(int t) const {
    return (2 - t / 3) * row + (1 - t % 3) * col;
  }
};

struct Args {
  // the mainloop's operands: slab [slab_len][cp] (cin = cp), weights
  // [cin of the half][taps * cp] (cout = the half's Cin), guard
  fwd_wgmma_bf16::Args gemm;
  const bf16* x;      // [n, h, w, cin] the half's input
  const bf16* res;    // entry: [n, h, w, cin]
  const bf16* dxout;  // entry: the x_res cotangent [n, h, w, cin]
  const float* s;     // [cin] (not identity)
  const float* t;
  bf16* dx;           // [n, h, w, cin]
  bf16* dres;         // entry: [n, h, w, cin]
  float* part;        // [tiles][2 * cin] (not identity)
  // the layout's rows (n, h, w, rch = h, halo, wq) for fwd_staged_s8::y_pos
  fwd_staged_s8::Args rows;
  int cin;            // the GEMM's N: the half's input channels
  int taps, tiles, mode;
  MirrorTaps mirror;
};

// Grid (ceil(cin / BN), tiles): block (x, y) computes input channels [x *
// BN, x * BN + BN) of M tile y (the N tiles of one M tile neighbours, so
// they read its A rows through L2) and writes its sums to part[y].
template <int BN>
__global__ void __launch_bounds__(THREADS, 2)
    nvt_dgrad_bf16_kernel(const __grid_constant__ Args p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (ALIGN - raw % ALIGN) % ALIGN;
  unsigned char* smem = smem_raw + pad;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fwd_wgmma_bf16::mainloop<BN>(
      p.gemm, TapWalk<MirrorTaps>{0, p.taps, p.taps, p.mirror}, raw + pad,
      m0, n0, acc);
  nv_dgrad::prologue_bwd<BN, Tile<BN>::RING>(p, nv_dgrad::Bf16Acc{}, acc,
                                             smem, 0, m0, n0);
}

template <int BN>
inline cudaError_t launch_kernel(const Args& p, cudaStream_t stream) {
  constexpr int smem = Tile<BN>::SMEM;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        nvt_dgrad_bf16_kernel<BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((p.cin + BN - 1) / BN, p.tiles);
  nvt_dgrad_bf16_kernel<BN><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// dx (and dres, part) from the slab [slab_len][cp] bf16 of fwd_int8_layout
// at one chunk of h rows and w [cin][taps * cp] bf16 (forward tap
// coordinates, pad channels zero), on 128-row M tiles and bn-wide N tiles
// (128 or 64). cp % 8 == 0, cin % 8 == 0; every tap's shifted rows of
// every tile inside the slab (slab_len positions).
inline cudaError_t launch(const Args& p, int slab_len, int bn,
                          cudaStream_t stream) {
  if (p.gemm.cin < 8 || p.gemm.cin % 8 || p.cin < 8 || p.cin % 8 ||
      p.gemm.cout != p.cin || (p.taps != 1 && p.taps != 9) || p.tiles < 1 ||
      p.tiles > 65535 || (bn != 128 && bn != 64) ||
      (p.mode != IDENTITY && p.part == nullptr))
    return cudaErrorInvalidValue;
  for (int t = 0; t < p.taps; ++t) {
    const long first = (long)p.gemm.guard + p.mirror.row * (2 - t / 3) +
                       p.mirror.col * (1 - t % 3);
    if (first < 0 || first + (long)p.tiles * BM > slab_len)
      return cudaErrorInvalidValue;
  }
  return bn == 128 ? launch_kernel<128>(p, stream)
                   : launch_kernel<64>(p, stream);
}

}  // namespace nv_dgrad_wgmma_bf16
