// The NV training halves' input gradient in fully quantized training,
// written for Hopper (sm_90a): per row chunk, acc = the exact s32
// correlation of the cotangent's codes with the per-input-channel int8
// weights (the 3x3's taps mirrored), da = f32(acc) * f32(ws_in * scale)
// (entry mode: fma(f32(acc), ws_in * scale, dx_res)), then the prologue's
// backward: dx = bf16(da) (identity), else du = fma(x, s, t) (+ res) > 0 ?
// da : 0, dx = bf16(du * s), dres = bf16(du) (entry), and per 128-row tile
// the f32 sums of du * x and du. It reads the slab its prepass wrote
// (bneck_nv_train.cu, nvt_fwd_pre_kernel<Cot>: each chunk's folded
// cotangent g quantized once at the chunk's scale, halo rows included).
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/bneck_nv_train.py:866,
// _dgrad_call -> _dgrad1x1_kernel (:461), _dgrad3x3_kernel (:525) with
// quant_bwd=True): the TPU kernel quantizes each row chunk's cotangent,
// halo rows included, at the chunk's scale and contracts it at the 9
// mirrored tap shifts of its [h, wp, N, C] carrier, then runs the
// prologue's backward. Here the slab is the int8 forward's
// (ops/cuda/bneck_nv_train.py fwd_int8_layout at Cin = the half's Cout):
// [chunks][slab_len][cp], position-major, output position (r, c, i) of a
// chunk at M row m = (r * wq + c) * n + i (3x3, images innermost, wq = w
// + 1: a zero column after each row) or (i * rch + r) * w + c (1x1); a
// tile of 128 M rows lies in one chunk, so it has one scale. The layout is
// symmetric: forward tap t reads slab row m + shifts[t], so the mirrored
// tap the input gradient needs, g(r - dy + 1, c - dx + 1), is row m +
// shifts[8 - t], and the zero column and guards cover both image borders:
// no masks.
//   M = the chunk's positions in 128-row tiles, N = the half's Cin, K =
//   (tap, the half's Cout channel): w_dg's order ([Cin, taps * cp], int8,
//   forward tap coordinates, pad channels zero).
//
// What bounds it on an H100: bytes, at every ResNet-50 stage (the slab,
// x (and res, dx_res) in, dx (and dres) out, against 2 * positions * taps
// * Cin * Cout int8 operations). What the design does about it: the fold,
// the chunk's scale and the quantization run once per slab element in the
// prepass, not once per (tap, N tile) that reads it; the GEMM is
// fwd_wgmma_s8.cuh's mainloop unchanged (TMA boxes of 128 or 64 bytes a
// tap from one 2D map over all the chunks' slabs, [chunks * slab_len, cp],
// tile row m0 = chunk * slab_len + tile * 128; s8 wgmma m64nBNk32 from two
// consumer warpgroups, thread 0 starting the loads; two blocks an SM) at BN
// = 128 where Cin >= 128 (the slab read ceil(Cin / 128) times, the N tiles
// of one M tile neighbours in the grid so that they share its boxes in
// L2), else 64; the epilogue (nv_dgrad_epilogue.cuh's prologue_bwd,
// shared with the bf16 body, at the value policy S8Dequant) stages
// f32(acc) row-major in the drained ring's memory and walks the tile in
// 16-byte vectors of 8 channels along each NHWC row (x, res and dx_res
// read, dx and dres written, each once), each thread keeping its 8
// channels' factors in registers and issuing two (BN = 128) or four (BN =
// 64) rows' loads together; its sums go in a fixed order (per thread in
// row order, then the row groups in order) into part[tile], and
// common::tile_sum adds the tiles in a fixed order: dx and dres are
// bit-equal to the plain version and the sums the same bits every run.
//
// Left for later: the prepass's bytes (the codes written once and read
// back through L2 by each N tile), persistent blocks that overlap one
// tile's epilogue with the next tile's loads, the pad column's rows at the
// 3x3 (1 / (w + 1) of the tiles' rows).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fwd_staged_s8.cuh"      // fwd_staged_s8::Args: the layout's rows
#include "fwd_wgmma_s8.cuh"       // mainloop, Tile, Maps, encode_maps
#include "nv_dgrad_epilogue.cuh"  // prologue_bwd, S8Dequant, Mode

namespace nv_dgrad_wgmma_s8 {

using fwd_wgmma_s8::ALIGN;
using fwd_wgmma_s8::BK;
using fwd_wgmma_s8::BM;
using fwd_wgmma_s8::Maps;
using fwd_wgmma_s8::THREADS;
using fwd_wgmma_s8::Tile;
using wgrad_staged::smem_u32;

using nv_dgrad::IDENTITY;

typedef __nv_bfloat16 bf16;
static_assert(THREADS == nv_dgrad::THREADS && BM == nv_dgrad::BM,
              "the epilogue's block and tile");

struct Args {
  const float* ws_in;   // [cin] per-input-channel weight scales
  const float* rowmax;  // [h] the row maxima of |g|
  const bf16* x;        // [n, h, w, cin] the half's input
  const bf16* res;      // entry: [n, h, w, cin]
  const bf16* dxout;    // entry: the x_res cotangent [n, h, w, cin]
  const float* s;       // [cin] (not identity)
  const float* t;
  bf16* dx;             // [n, h, w, cin]
  bf16* dres;           // entry: [n, h, w, cin]
  float* part;          // [chunks * tiles][2 * cin] (not identity)
  // the layout's rows (n, h, w, rch, halo, wq) for fwd_staged_s8::y_pos
  fwd_staged_s8::Args rows;
  int cin;              // the GEMM's N: the half's input channels
  int cp;               // bytes a slab position (K a tap)
  int taps, tiles, slab_len, mode;
  int shift[9];         // slab row of the walk's tap t for M row 0
};

// Grid (ceil(cin / BN), chunks * tiles): block (x, y) computes input
// channels [x * BN, x * BN + BN) of M tile y % tiles of chunk y / tiles
// (the N tiles of one M tile neighbours, so they read its A boxes through
// L2) and writes its sums to part[y]. REM = cp % 128 names a tap's last
// box.
template <int BN, int REM>
__global__ void __launch_bounds__(THREADS, 2)
    nvt_dgrad_s8_kernel(const __grid_constant__ Maps mp,
                        const __grid_constant__ Args p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (ALIGN - raw % ALIGN) % ALIGN;
  unsigned char* smem = smem_raw + pad;
  const int n0 = blockIdx.x * BN;
  const int chunk = blockIdx.y / p.tiles;
  const int m0 = (blockIdx.y - chunk * p.tiles) * BM;  // chunk-local
  int acc[BN / 2];
  fwd_wgmma_s8::mainloop<BN, REM>(mp, p.cp, p.shift, raw + pad,
                                  chunk * p.slab_len + m0, n0, acc, 0,
                                  p.taps);
  nv_dgrad::prologue_bwd<BN, Tile<BN>::RING>(
      p,
      nv_dgrad::S8Dequant(p.ws_in, p.rowmax, chunk, p.rows.rch, p.rows.halo,
                          p.rows.h),
      acc, smem, chunk, m0, n0);
}

template <int BN, int REM>
inline cudaError_t launch_kernel(const Maps& mp, const Args& p, int chunks,
                                 cudaStream_t stream) {
  constexpr int smem = Tile<BN>::SMEM;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        nvt_dgrad_s8_kernel<BN, REM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((p.cin + BN - 1) / BN, chunks * p.tiles);
  nvt_dgrad_s8_kernel<BN, REM><<<grid, THREADS, smem, stream>>>(mp, p);
  return cudaGetLastError();
}

// dx (and dres, part) from the slabs [chunks][slab_len][cp] int8 of
// fwd_int8_layout and w [cin][taps * cp] int8 (forward tap coordinates,
// pad channels zero), on 128-row M tiles (`tiles` a chunk) and bn-wide N
// tiles (128 or 64). cp % 64 == 0, cin % 8 == 0; every tap's shifted rows
// of every tile inside its chunk's slab.
inline cudaError_t launch(const void* slab, const void* w, const Args& p,
                          int chunks, int bn, cudaStream_t stream) {
  if (p.cp < 64 || p.cp % 64 || p.cin < 8 || p.cin % 8 ||
      (p.taps != 1 && p.taps != 9) || p.tiles < 1 || chunks < 1 ||
      (long)chunks * p.tiles > 65535 || (bn != 128 && bn != 64) ||
      (p.mode != IDENTITY && p.part == nullptr))
    return cudaErrorInvalidValue;
  for (int t = 0; t < p.taps; ++t)
    if (p.shift[t] < 0 || p.shift[t] + (long)p.tiles * BM > p.slab_len)
      return cudaErrorInvalidValue;
  Maps mp;
  if (!fwd_wgmma_s8::encode_maps(&mp, slab, (long)chunks * p.slab_len, w,
                                 p.cp, p.cin, bn, p.taps))
    return cudaErrorInvalidValue;
  const bool rem = p.cp % BK != 0;  // a tap's last box of 64 bytes
  if (bn == 128)
    return rem ? launch_kernel<128, 64>(mp, p, chunks, stream)
               : launch_kernel<128, 0>(mp, p, chunks, stream);
  return rem ? launch_kernel<64, 64>(mp, p, chunks, stream)
             : launch_kernel<64, 0>(mp, p, chunks, stream);
}

}  // namespace nv_dgrad_wgmma_s8
