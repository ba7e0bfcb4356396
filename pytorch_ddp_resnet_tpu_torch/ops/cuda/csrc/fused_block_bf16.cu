// Fused preact block-half with a bf16 conv core, forward and backward, in
// the channel-major layout [C, B*H*W], written for Hopper (sm_90a) and
// bound to Python through a plain C interface (ops/cuda/fused_block.py
// loads this file's library with ctypes).
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/fused_block.py, the
// bf16 bodies, quant=False: fused_half, and the straight-through backward
// of fused_half_int8 with quant_bwd=False):
//   fused_fwd_pre_launch, then  <- _fwd_call -> _fwd_kernel
//   fused_fwd_gemm_launch,         (the mainloop and epilogue live in
//   partial_sum                    fwd_wgmma_bf16.cuh)
//   dgrad_launch     <- _dgrad_call -> _dgrad_kernel
//   wgrad_pre_launch, then  <- _wgrad_call -> _wgrad_kernel
//   wgrad_gemm_launch,         (the mainloop and its ordered sum live in
//   wgrad_sum_launch           wgrad_staged.cuh, shared with the NV halves)
//   partial_sum      <- the TPU kernels' sums carried across their grid
//   seed_bits_expand <- _seed_bits written out as [C, N] uint8, only for
//                       the card check of seed_bits.cuh
//
// One half: d = dropout(relu(bf16(x * scale + shift))) in bf16, y =
// bf16(conv3x3(d, w)) (+ res in bf16) and the per-channel f32 sums of y;
// the backward folds the stats cotangents into gf, takes g = bf16(gf),
// runs the transposed conv of g against the rot180/swapped weights, masks
// it with (x * scale + shift > 0, in f32, unrounded) and bits < thresh,
// and sums d(scale) and d(shift); the weight gradient contracts g with
// the recomputed bf16 d over every position, in f32.
//
// What bounds them on an H100 (WRN-28-10, batch 128, C = 160/320/640):
// each conv is 2 * 9 * C^2 * N = 60.4 GFLOP (0.061 ms at 989 TFLOP/s of
// bf16); the operands are 6-17 MB (0.044 ms at most at 3.35 TB/s). They
// are bound by operations. The weight gradient's prepass alone is bound by
// its bytes: x, dy (and y, bits) in, d_b and g_b out, 231 MB a call at C =
// 160 with stats and bits (0.069 ms at 3.35 TB/s).
//
// Design:
// - fwd is three launches. fused_fwd_pre_kernel computes each element of
//   d once (the Bf16Prologue the wgrad's prepass uses) and writes it
//   position-major into a padded slab, transposed through shared memory
//   as the wgrad's prepass does but to each pixel's slab position, and
//   zeros into every pad position (ops/cuda/fused_block.py
//   fused_fwd_layout: every 3x3 tap one position offset, any image
//   width). fwd_wgmma_bf16.cuh's GEMM contracts the slab with the packed
//   weights on wgmma and writes y channel-major with the residual added
//   and each tile's sums; partial_sum adds the tiles' sums in order.
// - dgrad is the row-tile implicit GEMM of conv3x3_rows.cuh (the bf16
//   serving conv's mainloop, mma.sync m16n8k16 with f32 accumulation)
//   with an operand loader that computes the cotangent fold and its bf16
//   rounding while it stages the halo tile, so g is never written to
//   device memory, and an epilogue on the block's accumulator tile: the
//   masks, dx and the d(scale)/d(shift) sums. The loader also writes dres
//   = bf16(gf) for the (channel, position) it owns. Per-block sums go to
//   the block's slot of a partial buffer and partial_sum adds the slots
//   in order.
// - wgrad is three launches. A contraction reads each operand element
//   once per (tap, tile) that uses it, so the prologue and the fold are
//   not recomputed there: fused_wgrad_pre_kernel computes each element of
//   d and g = bf16(gf) once (the functors the forward and the dgrad use,
//   so the rounding points are theirs) and writes both position-major,
//   NHWC bf16 (d_b [N, Cin], g_b [N, Cout]), transposed through shared
//   memory: 16-byte loads along positions, 16-byte stores along channels.
//   Then wgrad_staged.cuh's mainloop contracts them, dW[(tap, ci), co] =
//   sum over positions of d_b[pos + shift(tap), ci] * g_b[pos, co], with
//   the whole image as one chunk (a cp.async ring into ldmatrix.trans and
//   mma.sync, per-piece tap offsets and border bits: no row or width
//   limits), split over blocks by ops/cuda/bneck_nv_train.py
//   wgrad_bf16_plan; its ordered sum adds the split tiles in order.
// - Dropout bits are read from a [C, N] uint8 tensor or computed in
//   registers from a seed (seed_bits.cuh) at the element's global
//   (channel, lane): every kernel, whatever its tiling, sees one mask.
//
// Rounding points (the reference as XLA computes it on the CPU, where the
// tests run it; tests/test_torch_fused_half_bf16.py pins them): x * scale
// + shift is one fma, rounded to bf16; the dropout keeps bf16(r * f32(256
// / thresh)) (the same bf16 as the reference's division for every bf16 r
// and threshold); the stats fold is one fma; dn = acc * f32(256 / thresh);
// products and sums of the epilogues round on their own (__fmul_rn,
// __fadd_rn).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "conv3x3_rows.cuh"
#include "fused_half.cuh"
#include "fwd_wgmma_bf16.cuh"  // the forward's GEMM and epilogue
#include "seed_bits.cuh"
#include "wgrad_staged.cuh"  // the weight gradient's mainloop and ordered sum

using namespace conv3x3;
using namespace fused_half;
using dropout::DropBits;

namespace {

using V8 = uint4;  // 8 bf16

// the dgrad's operand: g = bf16(gf); the owner of each element also
// stores it as dres (the residual's cotangent) when dres is not null
struct DgradLoad {
  Cotangent ct;
  __nv_bfloat16* dres;
  int n;
  __device__ __forceinline__ V8 operator()(int ch, int pos, bool own) const {
    float gf[8];
    ct(ch, n, pos, gf);
    __nv_bfloat16 g[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) g[k] = __float2bfloat16_rn(gf[k]);
    const V8 v = pack8(g);
    if (own && dres != nullptr)
      *reinterpret_cast<V8*>(dres + (size_t)ch * n + pos) = v;
    return v;
  }
};

// live = x * scale + shift > 0 (one fma, f32, unrounded) and bits <
// thresh; dn = live ? acc * keep : 0; dx = bf16(dn * scale); sums of
// dn * x and dn
struct DgradEpi {
  const __nv_bfloat16* x;
  const float* scale;
  const float* shift;
  DropBits bits;
  __nv_bfloat16* dx;
  float* part;  // [n / BN][2 * Cin]
  int thresh;
  float keep;

  __device__ __forceinline__ void tile(const float* Cs, int cld, int bn,
                                       int m0, int n0, int cin,
                                       int n) const {
    tile_sums(bn, m0, cin, n - n0, blockIdx.x, part,
              [&](int r, int c, float& s1, float& s2) {
      const int ci = m0 + r;
      const size_t idx = (size_t)ci * n + n0 + c;
      float v = Cs[r * cld + c];
      const float xf = __bfloat162float(x[idx]);
      bool live = __fmaf_rn(xf, scale[ci], shift[ci]) > 0.f;
      if (bits.active()) {
        live = live && bits.at(ci, n0 + c) < thresh;
        v = __fmul_rn(v, keep);
      }
      const float dn = live ? v : 0.f;
      dx[idx] = __float2bfloat16_rn(__fmul_rn(dn, scale[ci]));
      s1 = __fmul_rn(dn, xf);
      s2 = dn;
    });
  }
};

// g = bf16(gf), 8 positions of one channel
struct GLoad {
  Cotangent ct;
  int n;
  __device__ __forceinline__ void operator()(int co, int pos,
                                             __nv_bfloat16 (&g)[8]) const {
    float gf[8];
    ct(co, n, pos, gf);
#pragma unroll
    for (int k = 0; k < 8; ++k) g[k] = __float2bfloat16_rn(gf[k]);
  }
};

// Output positions of the prepasses: the wgrad's operands keep the input
// position; the forward's slab puts each at its slab position (SlabPos,
// PadPos: fused_half.cuh).
struct SamePos {
  __device__ __forceinline__ long operator()(long p) const { return p; }
};

// One prepass tile: PRE_C channels x PRE_P positions of a channel-major
// operand [c, n] (src(ch, pos, v): 8 bf16 at positions pos .. pos + 7 of
// channel ch), written position-major to out [at(p), c]. Tile id -> (position
// group, channel group), channel group fastest, so blocks running together
// write whole position rows. Thread (cp, pg) takes channels 2cp, 2cp + 1
// at positions 8pg .. 8pg + 7 (16 threads read 256 contiguous bytes of a
// channel row; both channels' loads are issued before their math) and
// keeps each position's two values as one 32-bit word of the shared tile;
// then each thread writes 16-byte runs of 8 channels of one position.
// c % 8 == 0 and n % 8 == 0: a run or a load is whole or out of range.
template <typename Src, typename At>
__device__ __forceinline__ void pre_tile(const Src& src,
                                         __nv_bfloat16* __restrict__ out,
                                         int c, int n, int tile,
                                         uint32_t (*words)[PRE_C / 2 + 1],
                                         const At& at) {
  const int cgs = (c + PRE_C - 1) / PRE_C;
  const int c0 = tile % cgs * PRE_C;
  const long p0 = (long)(tile / cgs) * PRE_P;
  const int cp = threadIdx.x / 16, pg = threadIdx.x % 16;
  const int ch = c0 + 2 * cp;
  const long pos = p0 + 8 * pg;
  __nv_bfloat16 v[2][8];
  if (ch < c && pos < n) {
    src(ch, (int)pos, v[0]);
    src(ch + 1, (int)pos, v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[0][k] = v[1][k] = __float2bfloat16_rn(0.f);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    __nv_bfloat162 two;
    two.x = v[0][k];
    two.y = v[1][k];
    words[8 * pg + k][cp] = *reinterpret_cast<uint32_t*>(&two);
  }
  __syncthreads();
  store_runs(words, out, c, c0, p0, n, at);
}

// d_b (tiles [0, tiles_d)) then g_b, one launch
__global__ void __launch_bounds__(256)
fused_wgrad_pre_kernel(Bf16Prologue pro, GLoad gl,
                       __nv_bfloat16* __restrict__ d_b,
                       __nv_bfloat16* __restrict__ g_b, int cin, int cout,
                       int n, int tiles_d) {
  __shared__ uint32_t words[PRE_P][PRE_C / 2 + 1];
  if ((int)blockIdx.x < tiles_d)
    pre_tile(pro, d_b, cin, n, blockIdx.x, words, SamePos{});
  else
    pre_tile(gl, g_b, cout, n, blockIdx.x - tiles_d, words, SamePos{});
}

// The forward's slab, one launch: d at each pixel's slab position (tiles
// [0, tiles_d)), then 16-byte zeros at every pad position (pad_vecs
// vectors of 8 channels, a thread each).
__global__ void __launch_bounds__(256)
fused_fwd_pre_kernel(Bf16Prologue pro, __nv_bfloat16* __restrict__ slab,
                     SlabPos live, PadPos pads, int cin, int n, int tiles_d,
                     long pad_vecs) {
  __shared__ uint32_t words[PRE_P][PRE_C / 2 + 1];
  if ((int)blockIdx.x < tiles_d) {
    pre_tile(pro, slab, cin, n, blockIdx.x, words, live);
    return;
  }
  zero_pad_vec(slab, pads, cin,
               (long)(blockIdx.x - tiles_d) * 256 + threadIdx.x, pad_vecs);
}

__global__ void seed_bits_kernel(const int* __restrict__ seed,
                                 unsigned char* __restrict__ out, int c,
                                 int n) {
  const DropBits b{nullptr, seed, n};
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < (size_t)c * n) out[i] = (unsigned char)b.at((int)(i / n), (int)(i % n));
}

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

template <typename T>
const T* in(const void* p) {
  return static_cast<const T*>(p);
}

Bf16Prologue prologue(const void* x, const void* scale, const void* shift,
                      const void* bits, const void* seed, int n, int thresh,
                      float keep) {
  return Bf16Prologue{in<__nv_bfloat16>(x), in<float>(scale),
                      in<float>(shift),
                      DropBits{in<unsigned char>(bits), in<int>(seed), n},
                      thresh, keep, n};
}

Cotangent cotangent(const void* dy, const void* y, const void* dysum,
                    const void* dyssq) {
  return Cotangent{in<__nv_bfloat16>(dy), in<__nv_bfloat16>(y),
                   in<float>(dysum), in<float>(dyssq)};
}

}  // namespace

extern "C" {

// The forward, three launches. fused_fwd_pre: slab [slab_len, cin] bf16
// (fused_fwd_layout: guard zero positions, then per image of h x wi a zero
// row and a zero column, then zeros to slab_len) = the prologue's d from
// x [cin, n] bf16, scale/shift [cin] f32, bits [cin, n] uint8 or null,
// seed one int32 on the device or null (at most one of the two), each
// element once. cin % 8 == 0, n % 8 == 0, n a multiple of h * wi.
int fused_fwd_pre_launch(const void* x, const void* scale, const void* shift,
                         const void* bits, const void* seed, void* slab,
                         int cin, int n, int h, int wi, int guard,
                         long slab_len, int thresh, float keep,
                         void* stream) {
  if (cin % 8 || n % 8 || h < 1 || wi < 1 || n % (h * wi))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = (h + 1) * (wi + 1);
  const long b = n / (h * wi);
  const long pads = slab_len - n;
  if (pads < guard + b * (wi + 1 + h))
    return static_cast<int>(cudaErrorInvalidValue);
  const long tiles_d =
      (long)((n + PRE_P - 1) / PRE_P) * ((cin + PRE_C - 1) / PRE_C);
  const long pad_vecs = pads * (cin / 8);
  const long blocks = tiles_d + (pad_vecs + 255) / 256;
  fused_fwd_pre_kernel<<<(unsigned)blocks, 256, 0, as_stream(stream)>>>(
      prologue(x, scale, shift, bits, seed, n, thresh, keep),
      static_cast<__nv_bfloat16*>(slab), SlabPos{h * wi, wi, per, guard},
      PadPos{guard, wi, h, per, b * (wi + 1 + h), b * per}, cin, n,
      (int)tiles_d, pad_vecs);
  return static_cast<int>(cudaGetLastError());
}

// fused_fwd_gemm: y [cout, n] bf16 = bf16(conv3x3 of the slab with w [cout,
// 9 * cin] bf16 (packed)) (+ res [cout, n] bf16, or null), and part
// [tiles][2 * cout] f32 (each 128-row tile's sums of y and y^2, or null:
// no stats), on `tiles` M tiles and bn-wide N tiles (160, 128 or 64).
int fused_fwd_gemm_launch(const void* slab, const void* w, const void* res,
                          void* y, void* part, int cin, int cout, int n,
                          int h, int wi, int guard, int tiles, int bn,
                          void* stream) {
  if (h < 1 || wi < 1 || n % (h * wi))
    return static_cast<int>(cudaErrorInvalidValue);
  const fwd_wgmma_bf16::Args args{
      in<__nv_bfloat16>(slab), in<__nv_bfloat16>(w), in<__nv_bfloat16>(res),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(part), cin, cout,
      n, n / (h * wi), h, wi, guard};
  return static_cast<int>(
      fwd_wgmma_bf16::launch(args, tiles, bn, as_stream(stream)));
}

// dy [cout, n] bf16; y [cout, n] bf16, dysum/dyssq [cout] f32 or all
// null (no stats cotangents); w_dg [cin, 9 * cout] bf16 (dgrad-packed);
// x [cin, n] bf16, scale/shift [cin], bits or seed as above; dx [cin, n]
// bf16, part [n / BN][2 * cin] f32, dres [cout, n] bf16 = bf16(gf) or
// null. cout % 32 == 0, wi % 8 == 0.
int dgrad_launch(const void* dy, const void* y, const void* dysum,
                 const void* dyssq, const void* w_dg, const void* x,
                 const void* scale, const void* shift, const void* bits,
                 const void* seed, void* dx, void* part, void* dres,
                 int cout, int cin, int n, int h, int wi, int thresh,
                 float keep, void* stream) {
  const DgradLoad load{cotangent(dy, y, dysum, dyssq),
                       static_cast<__nv_bfloat16*>(dres), n};
  const DgradEpi epi{in<__nv_bfloat16>(x), in<float>(scale), in<float>(shift),
                     DropBits{in<unsigned char>(bits), in<int>(seed), n},
                     static_cast<__nv_bfloat16*>(dx),
                     static_cast<float*>(part), thresh, keep};
  return launch_row_tiles_with<__nv_bfloat16>(load, w_dg, epi, cout, cin, n,
                                              h, wi, as_stream(stream));
}

// The weight gradient, three launches. wgrad_pre: d_b [n, cin] bf16 = the
// prologue's d from x/scale/shift/bits/seed (as the forward's), g_b [n,
// cout] bf16 = bf16(gf) from dy/y/dysum/dyssq (as the dgrad's), each
// element once, position-major. cin % 8 == 0, cout % 8 == 0, n % 8 == 0.
int wgrad_pre_launch(const void* x, const void* scale, const void* shift,
                     const void* bits, const void* seed, const void* dy,
                     const void* y, const void* dysum, const void* dyssq,
                     void* d_b, void* g_b, int cin, int cout, int n,
                     int thresh, float keep, void* stream) {
  const long pt = (n + PRE_P - 1) / PRE_P;
  const long tiles_d = pt * ((cin + PRE_C - 1) / PRE_C);
  const long tiles = tiles_d + pt * ((cout + PRE_C - 1) / PRE_C);
  fused_wgrad_pre_kernel<<<(unsigned)tiles, 256, 0, as_stream(stream)>>>(
      prologue(x, scale, shift, bits, seed, n, thresh, keep),
      GLoad{cotangent(dy, y, dysum, dyssq), n},
      static_cast<__nv_bfloat16*>(d_b), static_cast<__nv_bfloat16*>(g_b),
      cin, cout, n, (int)tiles_d);
  return static_cast<int>(cudaGetLastError());
}

// wgrad_gemm: part [splits][9 * cin][cout] f32 <- the per-split products
// of d_b (at each tap's shift) and g_b over b images of h x wi, one chunk
// of h rows, on a (bm, bn) tile, each split ``per`` K steps of bk positions
// (the plan of ops/cuda/bneck_nv_train.py wgrad_bf16_plan). wgrad_sum:
// dW [9 * cin][cout] f32 <- the splits added in order.
int wgrad_gemm_launch(const void* d_b, const void* g_b, void* part, int b,
                      int h, int wi, int cin, int cout, int bm, int bn,
                      int bk, int per, int splits, void* stream) {
  const wgrad_staged::Args args{in<__nv_bfloat16>(d_b),
                                in<__nv_bfloat16>(g_b),
                                static_cast<float*>(part), b, h, wi, cin,
                                cout, 9, h, per, splits};
  return static_cast<int>(
      wgrad_staged::launch(args, bm, bn, bk, as_stream(stream)));
}

int wgrad_sum_launch(const void* part, void* dw, int cin, int cout,
                     int splits, void* stream) {
  return static_cast<int>(wgrad_staged::launch_sum(
      in<float>(part), static_cast<float*>(dw), 9L * cin * cout, 1, splits,
      as_stream(stream)));
}

// out [c, n] uint8: the bits seed_bits.cuh computes from *seed
int seed_bits_expand_launch(const void* seed, void* out, int c, int n,
                            void* stream) {
  const size_t total = (size_t)c * n;
  seed_bits_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                     as_stream(stream)>>>(
      in<int>(seed), static_cast<unsigned char*>(out), c, n);
  return static_cast<int>(cudaGetLastError());
}

// out[i] = sum over k < j of part[k][i], in order (part [j][m] f32)
int partial_sum_launch(const void* part, void* out, int j, int m,
                       void* stream) {
  return common::partial_sum(in<float>(part), static_cast<float*>(out), j, m,
                             as_stream(stream));
}

}  // extern "C"
