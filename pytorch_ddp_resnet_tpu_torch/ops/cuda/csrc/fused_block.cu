// Fused preact block-half with an int8 conv core and a fully quantized
// backward, in the channel-major layout [C, B*H*W], written for Hopper
// (sm_90a) and bound to Python through a plain C interface
// (ops/cuda/fused_block.py loads this file's library with ctypes).
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/fused_block.py,
// fused_half_int8 with quant_bwd=True):
//   fwd_amax, fwd_pre, fwd_gemm,    <- _fwd_call -> _fwd_kernel (quant)
//   tile_sum                           (the GEMM lives in fwd_wgmma_s8.cuh)
//   bwd_amax, bwd_quant             <- the cotangent fold and per-tile
//                                      quantization that _bwd_kernel,
//                                      _dgrad_kernel and _wgrad_kernel
//                                      each begin with (one shared copy)
//   dgrad_pre, dgrad_gemm,          <- _dgrad_call -> _dgrad_kernel, and
//   tile_sum                           the dgrad half of _bwd_kernel (the
//                                      GEMM lives in dgrad_wgmma_s8.cuh)
//
// Scale groups: the activations and cotangents are quantized per group of
// `tile` lanes (whole images, the JAX pickers' tile), each with its own
// absmax. An absmax must be complete before any element of its group is
// quantized, and the card has no sequential grid, so each quantization is
// two launches: *_amax writes one partial maximum per (group, slice) block,
// then fwd_pre (the forward) or bwd_quant (the backward) reduces its
// group's partials, quantizes into an int8 buffer and records the group's
// absmax. The convs then read int8.
//
// What bounds them on an H100 (WRN-28-10, batch 128, C = 160/320/640):
// each conv is 60.4 G int8 operations (30.5 us at 1,979 TOP/s) against
// 21-45 MB of operands; the amax and quantizing passes are memory passes
// over x (bf16), bits (uint8) and the int8 result.
//
// Design:
// - The forward is four launches: fwd_amax; fwd_pre (fwd_slab_kernel),
//   which reduces each group's partials, computes each element of the
//   prologue once, quantizes it at its group's scale and writes the codes
//   position-major into the padded slab of ops/cuda/fused_block.py
//   fused_fwd_layout (the bf16 forward's, one byte a channel: every 3x3
//   tap one row offset, any image width), transposed through shared
//   memory, with zeros at every pad position; fwd_gemm, fwd_wgmma_s8.cuh's
//   TMA-fed s8 wgmma GEMM with the dequantization, bf16 output, residual
//   add and each tile's sums in its epilogue; and tile_sum over the tiles'
//   sums, in a fixed order.
// - The dgrad is three launches on the forward's layout of the transposed
//   conv (Cin = the half's Cout): dgrad_pre, fused_half.cuh's slab_copy
//   (g_q's codes copied once, unchanged, into the padded slab: every tap
//   one row offset, any image width); dgrad_gemm, the forward's TMA-fed s8
//   wgmma mainloop with a dequantizing, masking epilogue
//   (dgrad_wgmma_s8.cuh: dx, each tile's sums of dn * x and dn); and
//   tile_sum over the tiles' sums, in a fixed order.
// - The weight gradient, the other consumer of bwd_quant's codes, is
//   fused_wgrad_s8.cu (the TMA + s8 wgmma mainloop of wgrad_wgmma_s8.cuh).
//
// Dropout bits are read from a [C, N] uint8 tensor or, in seed mode,
// computed in registers from one int32 seed at the element's global
// (channel, lane) (seed_bits.cuh), so every kernel rebuilds the same mask
// whatever its blocking. The bf16 core of the same half (the backward of
// QAT included) is fused_block_bf16.cu; fused_half.cuh holds what the two
// share.
//
// Rounding points (the reference as XLA computes it on the CPU, where the
// tests run it; tests/test_torch_fused_block.py pins each): the prologue
// x * scale + shift is one fma; dropout keeps r * f32(256/thresh); the
// stats fold (dy + dysum) + (2y) * dyssq is one fma; every other product
// and sum rounds on its own (__fmul_rn / __fadd_rn, so nvcc cannot
// contract them), rintf rounds half to even, and s32 -> f32 rounds to
// nearest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "dgrad_wgmma_s8.cuh"  // the dgrad's GEMM and epilogue
#include "fused_half.cuh"      // the quantizers, slab_copy
#include "fwd_wgmma_s8.cuh"    // the forward's GEMM and epilogue

using common::quant_s8;
using namespace fused_half;
using dropout::DropBits;

namespace {

// --- the forward's prepass: the codes into the padded slab -----------------

constexpr int PRE_G = PRE_P / 8 + 1;  // scale groups a tile may touch

// The forward's int8 slab, one launch. Blocks [0, tiles_d) each take PRE_C
// channels x PRE_P positions (channel group fastest): first each scale
// group the tile touches has its amax partials reduced (exact in any
// order) and its inverse scale 127 / max(amax, floor) kept (the block that
// holds a group's first lane in its first channels records amax[g]); then
// thread (cp, pg) computes the prologue of channels 2cp, 2cp + 1 at
// positions 8pg .. 8pg + 7 (one group: tile % 8 == 0), quantizes them
// (quant_body's rounding: s8(clip(rint(d * inv)))) and keeps each
// position's two codes as one 16-bit word of the shared tile; each thread
// then writes one 16-byte run of a position's 32 codes to the position's
// slab row (store_runs). The other blocks write 16-byte zeros at every pad
// position (zero_pad_vec: pad_vecs vectors of 16 channels, a thread each).
__global__ void __launch_bounds__(256)
fwd_slab_kernel(Prologue pro, const float* __restrict__ part, int slices,
                int lanes, signed char* __restrict__ slab,
                float* __restrict__ amax, SlabPos live, PadPos pads, int cin,
                int n, int tiles_d, long pad_vecs) {
  if ((int)blockIdx.x >= tiles_d) {
    zero_pad_vec(slab, pads, cin,
                 (long)(blockIdx.x - tiles_d) * 256 + threadIdx.x, pad_vecs);
    return;
  }
  __shared__ float inv[PRE_G];
  // a position's 32 codes, 16-bit words of two channels; 9 words a row
  __shared__ __align__(16) unsigned short codes[PRE_P][PRE_C / 2 + 2];
  const int cgs = cin / PRE_C;
  const int c0 = blockIdx.x % cgs * PRE_C;
  const long p0 = (long)(blockIdx.x / cgs) * PRE_P;
  const int g0 = (int)(p0 / lanes);
  const int g1 = (int)((min(p0 + PRE_P, (long)n) - 1) / lanes);
  for (int g = g0; g <= g1; ++g) {
    float a = 0.f;
    for (int k = threadIdx.x; k < slices; k += blockDim.x)
      a = fmaxf(a, part[g * slices + k]);
    a = block_max(a);
    if (threadIdx.x == 0) {
      inv[g - g0] = __fdiv_rn(127.f, fmaxf(a, kFwdFloor));
      if (c0 == 0 && (long)g * lanes >= p0) amax[g] = a;
    }
    __syncthreads();  // block_max's scratch is taken again
  }
  const int cp = threadIdx.x / 16, pg = threadIdx.x % 16;
  const long pos = p0 + 8 * pg;
  if (pos < n) {
    float v[2][8];
    pro(c0 + 2 * cp, n, pos, v[0]);
    pro(c0 + 2 * cp + 1, n, pos, v[1]);
    const float s = inv[pos / lanes - g0];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      codes[8 * pg + k][cp] =
          (unsigned short)((unsigned char)quant_s8(__fmul_rn(v[0][k], s)) |
                           ((unsigned char)quant_s8(__fmul_rn(v[1][k], s))
                            << 8));
  }
  __syncthreads();
  store_runs(codes, slab, cin, c0, p0, n, live);
}


cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

template <typename T>
const T* in(const void* p) {
  return static_cast<const T*>(p);
}

DropBits drop_bits(const void* bits, const void* seed, int n) {
  return DropBits{in<unsigned char>(bits), in<int>(seed), n};
}

Prologue prologue(const void* x, const void* scale, const void* shift,
                  const void* bits, const void* seed, int n, int thresh,
                  float keep) {
  return Prologue{in<__nv_bfloat16>(x), in<float>(scale), in<float>(shift),
                  drop_bits(bits, seed, n), thresh, keep};
}

}  // namespace

extern "C" {

// Shapes: x [c, n] bf16, bits [c, n] uint8 or null, seed one int32 on the
// device or null (at most one of the two), scale/shift [c] f32; n a
// multiple of tile, tile a multiple of 8; part [n / tile * slices].
int fwd_amax_launch(const void* x, const void* scale, const void* shift,
                    const void* bits, const void* seed, void* part, int c,
                    int n, int tile, int slices, int thresh, float keep,
                    void* stream) {
  const Prologue pr = prologue(x, scale, shift, bits, seed, n, thresh, keep);
  const GroupWalk walk{n, tile, slices};
  amax_kernel<<<dim3(slices, n / tile, 1), 256, 0, as_stream(stream)>>>(
      pr, c, walk, pr, c, walk, static_cast<float*>(part));
  return static_cast<int>(cudaGetLastError());
}

// The forward's slab: slab [slab_len, c] int8 (fused_fwd_layout: guard
// zero positions, then per image of h x wi a zero row and a zero column,
// then zeros to slab_len) = the prologue of x quantized at each lane's
// group scale (the group's partials from fwd_amax), amax [n / tile] f32.
// c % 32 == 0, tile % 8 == 0, n a multiple of tile and of h * wi.
int fwd_pre_launch(const void* x, const void* scale, const void* shift,
                   const void* bits, const void* seed, const void* part,
                   void* slab, void* amax, int c, int n, int tile,
                   int slices, int h, int wi, int guard, long slab_len,
                   int thresh, float keep, void* stream) {
  if (c % PRE_C || tile % 8 || tile < 8 || n % tile || h < 1 || wi < 1 ||
      n % (h * wi) || guard != wi + 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = (h + 1) * (wi + 1);
  const long b = n / (h * wi);
  const long pads = slab_len - n;
  if (pads < guard + b * (wi + 1 + h) + guard)
    return static_cast<int>(cudaErrorInvalidValue);
  const long tiles_d = (long)((n + PRE_P - 1) / PRE_P) * (c / PRE_C);
  const long pad_vecs = pads * (c / 16);
  const long blocks = tiles_d + (pad_vecs + 255) / 256;
  fwd_slab_kernel<<<(unsigned)blocks, 256, 0, as_stream(stream)>>>(
      prologue(x, scale, shift, bits, seed, n, thresh, keep), in<float>(part),
      slices, tile, static_cast<signed char*>(slab),
      static_cast<float*>(amax), SlabPos{h * wi, wi, per, guard},
      PadPos{guard, wi, h, per, b * (wi + 1 + h), b * per}, c, n,
      (int)tiles_d, pad_vecs);
  return static_cast<int>(cudaGetLastError());
}

// The forward's GEMM (fwd_wgmma_s8.cuh): y [cout, n] bf16 =
// bf16(f32(conv3x3 of the slab with w [cout, 9 * cin] int8 (packed)) *
// (ws[co] * amax[g] / 127)) (+ res [cout, n] bf16, or null), part [tiles][2
// * cout] f32 (each 128-row tile's sums of y and y^2, or null: no stats),
// on `tiles` M tiles and bn-wide N tiles (160, 128 or 64); g = lane /
// tile.
int fwd_gemm_launch(const void* slab, const void* w, const void* amax,
                    const void* ws, const void* res, void* y, void* part,
                    int cin, int cout, int n, int h, int wi, int tile,
                    long slab_len, int tiles, int bn, void* stream) {
  if (h < 1 || wi < 1 || n % (h * wi))
    return static_cast<int>(cudaErrorInvalidValue);
  const fwd_wgmma_s8::Args args{
      in<float>(amax), in<float>(ws), in<__nv_bfloat16>(res),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(part), cin, cout,
      n, n / (h * wi), h, wi, tile, {}};
  return static_cast<int>(fwd_wgmma_s8::launch(slab, w, args, slab_len,
                                               wi + 2, tiles, bn,
                                               as_stream(stream)));
}

// The backward's amax pass over both quantized operands: the cotangent
// gf [cout, n] (y/dysum/dyssq null: no stats cotangents) and the
// recomputed activation [cin, n]; part [2][n / tile][slices].
int bwd_amax_launch(const void* dy, const void* y, const void* dysum,
                    const void* dyssq, const void* x, const void* scale,
                    const void* shift, const void* bits, const void* seed,
                    void* part, int cout, int cin, int n, int tile,
                    int slices, int thresh, float keep, void* stream) {
  const Cotangent ct{in<__nv_bfloat16>(dy), in<__nv_bfloat16>(y),
                     in<float>(dysum), in<float>(dyssq)};
  const GroupWalk walk{n, tile, slices};
  amax_kernel<<<dim3(slices, n / tile, 2), 256, 0, as_stream(stream)>>>(
      ct, cout, walk, prologue(x, scale, shift, bits, seed, n, thresh, keep),
      cin, walk, static_cast<float*>(part));
  return static_cast<int>(cudaGetLastError());
}

// g_q [cout, n], d_q [cin, n] int8; g_amax, d_amax [n / tile] f32 (the
// cotangent's and the activation's group absmax); dres [cout, n] bf16 =
// bf16(gf), or null.
int bwd_quant_launch(const void* dy, const void* y, const void* dysum,
                     const void* dyssq, const void* x, const void* scale,
                     const void* shift, const void* bits, const void* seed,
                     const void* part, void* g_q, void* d_q, void* g_amax,
                     void* d_amax, void* dres, int cout, int cin, int n,
                     int tile, int slices, int thresh, float keep,
                     void* stream) {
  const Cotangent ct{in<__nv_bfloat16>(dy), in<__nv_bfloat16>(y),
                     in<float>(dysum), in<float>(dyssq)};
  const QuantOut g_out{kBwdFloor, static_cast<signed char*>(g_q),
                       static_cast<float*>(g_amax),
                       static_cast<__nv_bfloat16*>(dres)};
  const QuantOut d_out{kBwdFloor, static_cast<signed char*>(d_q),
                       static_cast<float*>(d_amax), nullptr};
  const GroupWalk walk{n, tile, slices};
  quant_kernel<<<dim3(slices, n / tile, 2), 256, 0, as_stream(stream)>>>(
      ct, cout, walk, g_out,
      prologue(x, scale, shift, bits, seed, n, thresh, keep), cin, walk,
      d_out, in<float>(part));
  return static_cast<int>(cudaGetLastError());
}

// The dgrad's prepass: slab [slab_len, cout] int8 (fused_fwd_layout of the
// transposed conv, Cin = the half's Cout: guard zero positions, then per
// image of h x wi a zero row and a zero column, then zeros to slab_len) =
// g_q [cout, n]'s codes at each pixel's position. cout % 32 == 0, n a
// multiple of h * wi.
int dgrad_pre_launch(const void* g_q, void* slab, int cout, int n, int h,
                     int wi, long slab_len, void* stream) {
  return static_cast<int>(slab_copy(in<signed char>(g_q),
                                    static_cast<signed char*>(slab), cout,
                                    cout, n, h, wi, slab_len,
                                    as_stream(stream)));
}

// The dgrad's GEMM (dgrad_wgmma_s8.cuh): dx [cin, n] bf16 = bf16(dn *
// scale), dn = the masks of (x [cin, n] bf16, scale/shift [cin], bits
// [cin, n] uint8 or null, seed or null) applied to f32(conv3x3 of the slab
// with w_dg [cin, 9 * cout] int8) * (ws_in[ci] * g_amax[g] / 127), g =
// lane / tile; part [tiles][2 * cin] f32, each 128-row tile's sums of dn *
// x and dn; on `tiles` M tiles and bn-wide N tiles (160, 128 or 64).
int dgrad_gemm_launch(const void* slab, const void* w_dg, const void* g_amax,
                      const void* ws_in, const void* x, const void* scale,
                      const void* shift, const void* bits, const void* seed,
                      void* dx, void* part, int cout, int cin, int n, int h,
                      int wi, int tile, long slab_len, int tiles, int bn,
                      int thresh, float keep, void* stream) {
  if (h < 1 || wi < 1 || n % (h * wi))
    return static_cast<int>(cudaErrorInvalidValue);
  const dgrad_wgmma_s8::Args args{in<float>(g_amax), in<float>(ws_in), cout,
                                  cin, n, n / (h * wi), h, wi, tile, {}};
  const dgrad_wgmma_bf16::Epi epi{
      in<__nv_bfloat16>(x), in<float>(scale), in<float>(shift),
      drop_bits(bits, seed, n), static_cast<__nv_bfloat16*>(dx),
      static_cast<float*>(part), thresh, keep};
  return static_cast<int>(dgrad_wgmma_s8::launch(
      slab, w_dg, args, epi, slab_len, tiles, bn, as_stream(stream)));
}

// out[i] = the tiles' sums of part [tiles][m] f32 in common::tile_sum's
// fixed order (the forward's and the dgrad's `.sum`)
int tile_sum_launch(const void* part, void* out, int tiles, int m,
                    void* stream) {
  return common::tile_sum(in<float>(part), static_cast<float*>(out), tiles,
                          m, as_stream(stream));
}

}  // extern "C"
