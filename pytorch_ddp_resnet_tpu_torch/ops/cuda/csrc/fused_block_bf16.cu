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
//   dgrad_pre_launch, then      <- _dgrad_call -> _dgrad_kernel
//   dgrad_gemm_launch,             (the forward's mainloop with a masking
//   dgrad_sum_launch               epilogue: dgrad_wgmma_bf16.cuh)
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
// are bound by operations. The prepasses alone are bound by their bytes:
// the weight gradient's (x, dy (and y, bits) in, d_b and g_b out) 231 MB
// a call at C = 160 with stats and bits (0.069 ms at 3.35 TB/s); the
// dgrad's (dy and y in, the slab and dres out) 128-170 MB (0.038-0.051
// ms).
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
// - dgrad is three launches. The input gradient is the forward conv of g
//   with the dgrad-packed weights, so fused_dgrad_pre_kernel writes g =
//   bf16(gf) once per element into the forward's slab (the layout at Cin
//   = the half's Cout; dres = g channel-major from the same read where
//   asked), and dgrad_wgmma_bf16.cuh runs the forward's mainloop on it
//   with an epilogue that applies the masks (x and the bits read, or the
//   bits rebuilt from the seed), writes dx and each tile's sums of dn * x
//   and dn; the sum adds the tiles in common::tile_sum's fixed order.
//   The masks act on the contraction's result, so the prepass needs
//   neither x nor the bits.
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
#include "dgrad_wgmma_bf16.cuh"  // the dgrad's GEMM and masking epilogue
#include "fused_half.cuh"
#include "fwd_wgmma_bf16.cuh"  // the forward's GEMM and epilogue
#include "seed_bits.cuh"
#include "wgrad_staged_launch.cuh"  // the weight gradient, its ordered sum

// The bf16 forward GEMM's launchers (its kernel is fwd_wgmma_bf16.cuh's
// fused_fwd_gemm_kernel): here, in its one caller's file, so that the
// files that include that header for the mainloop do not build the
// kernel.
namespace fwd_wgmma_bf16 {

template <int BN>
inline cudaError_t launch_tile(const Args& p, int tiles,
                               cudaStream_t stream) {
  constexpr int smem = Tile<BN>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_fwd_gemm_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.cout + BN - 1) / BN, tiles);
  fused_fwd_gemm_kernel<BN><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The GEMM on `tiles` 128-row M tiles with a bn-wide N tile (160, 128 or
// 64). cin % 8 == 0, cout % 8 == 0, n % 8 == 0.
inline cudaError_t launch(const Args& p, int tiles, int bn,
                          cudaStream_t stream) {
  if (p.cin % 8 || p.cout % 8 || p.n % 8 || tiles < 1 || tiles > 65535)
    return cudaErrorInvalidValue;
  if (bn == 160) return launch_tile<160>(p, tiles, stream);
  if (bn == 128) return launch_tile<128>(p, tiles, stream);
  if (bn == 64) return launch_tile<64>(p, tiles, stream);
  return cudaErrorInvalidValue;
}

}  // namespace fwd_wgmma_bf16

using namespace fused_half;
using dropout::DropBits;

namespace {

// g = bf16(gf), 8 positions of one channel; also written channel-major
// to dres (the residual's cotangent) when dres is not null
struct GLoad {
  Cotangent ct;
  int n;
  __nv_bfloat16* dres;  // [cout][n] or null
  __device__ __forceinline__ void operator()(int co, int pos,
                                             __nv_bfloat16 (&g)[8]) const {
    float gf[8];
    ct(co, n, pos, gf);
#pragma unroll
    for (int k = 0; k < 8; ++k) g[k] = __float2bfloat16_rn(gf[k]);
    if (dres != nullptr)
      *reinterpret_cast<uint4*>(dres + (size_t)co * n + pos) = pack8(g);
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

// The forward's or the dgrad's slab, one launch: src's operand at each
// pixel's slab position (tiles [0, tiles_d)), then 16-byte zeros at every
// pad position (pad_vecs vectors of 8 channels, a thread each).
template <typename Src>
__device__ __forceinline__ void slab_pre(const Src& src,
                                         __nv_bfloat16* __restrict__ slab,
                                         const SlabPos& live,
                                         const PadPos& pads, int c, int n,
                                         int tiles_d, long pad_vecs) {
  __shared__ uint32_t words[PRE_P][PRE_C / 2 + 1];
  if ((int)blockIdx.x < tiles_d) {
    pre_tile(src, slab, c, n, blockIdx.x, words, live);
    return;
  }
  zero_pad_vec(slab, pads, c,
               (long)(blockIdx.x - tiles_d) * 256 + threadIdx.x, pad_vecs);
}

// d, the prologue's
__global__ void __launch_bounds__(256)
fused_fwd_pre_kernel(Bf16Prologue pro, __nv_bfloat16* __restrict__ slab,
                     SlabPos live, PadPos pads, int cin, int n, int tiles_d,
                     long pad_vecs) {
  slab_pre(pro, slab, live, pads, cin, n, tiles_d, pad_vecs);
}

// g = bf16(gf), and dres = g where gl.dres is not null
__global__ void __launch_bounds__(256)
fused_dgrad_pre_kernel(GLoad gl, __nv_bfloat16* __restrict__ slab,
                       SlabPos live, PadPos pads, int cout, int n,
                       int tiles_g, long pad_vecs) {
  slab_pre(gl, slab, live, pads, cout, n, tiles_g, pad_vecs);
}

__global__ void seed_bits_kernel(const int* __restrict__ seed,
                                 unsigned char* __restrict__ out, int c,
                                 int n) {
  const DropBits b{nullptr, seed, n};
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < (size_t)c * n) out[i] = (unsigned char)b.at((int)(i / n), (int)(i % n));
}

// names the dgrad's tile sum in a profile
struct FusedDgradSum {};

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

// One launch of a slab prepass (fused_fwd_layout: guard zero positions,
// then per image of h x wi a zero row and a zero column, then zeros to
// slab_len) over src's [c, n] operand. c % 8 == 0, n % 8 == 0, n a
// multiple of h * wi.
template <typename Src>
int slab_pre_launch(void (*kernel)(Src, __nv_bfloat16*, SlabPos, PadPos,
                                   int, int, int, long),
                    const Src& src, void* slab, int c, int n, int h, int wi,
                    int guard, long slab_len, void* stream) {
  if (c % 8 || n % 8 || h < 1 || wi < 1 || n % (h * wi))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = (h + 1) * (wi + 1);
  const long b = n / (h * wi);
  const long pads = slab_len - n;
  if (pads < guard + b * (wi + 1 + h))
    return static_cast<int>(cudaErrorInvalidValue);
  const long tiles =
      (long)((n + PRE_P - 1) / PRE_P) * ((c + PRE_C - 1) / PRE_C);
  const long pad_vecs = pads * (c / 8);
  const long blocks = tiles + (pad_vecs + 255) / 256;
  kernel<<<(unsigned)blocks, 256, 0, as_stream(stream)>>>(
      src, static_cast<__nv_bfloat16*>(slab), SlabPos{h * wi, wi, per, guard},
      PadPos{guard, wi, h, per, b * (wi + 1 + h), b * per}, c, n, (int)tiles,
      pad_vecs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The forward, three launches. fused_fwd_pre: slab [slab_len, cin] bf16
// (fused_fwd_layout) = the prologue's d from x [cin, n] bf16, scale/shift
// [cin] f32, bits [cin, n] uint8 or null, seed one int32 on the device or
// null (at most one of the two), each element once. cin % 8 == 0, n % 8
// == 0, n a multiple of h * wi.
int fused_fwd_pre_launch(const void* x, const void* scale, const void* shift,
                         const void* bits, const void* seed, void* slab,
                         int cin, int n, int h, int wi, int guard,
                         long slab_len, int thresh, float keep,
                         void* stream) {
  return slab_pre_launch(fused_fwd_pre_kernel,
                         prologue(x, scale, shift, bits, seed, n, thresh,
                                  keep),
                         slab, cin, n, h, wi, guard, slab_len, stream);
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

// The input gradient, three launches. dgrad_pre: slab [slab_len, cout]
// bf16 (fused_fwd_layout at Cin = cout) = g = bf16(gf) from dy [cout, n]
// bf16 and y [cout, n] bf16, dysum/dyssq [cout] f32 (or all three null:
// no stats cotangents), each element once; dres [cout, n] bf16 = g, or
// null. cout % 8 == 0, n % 8 == 0, n a multiple of h * wi.
int dgrad_pre_launch(const void* dy, const void* y, const void* dysum,
                     const void* dyssq, void* slab, void* dres, int cout,
                     int n, int h, int wi, int guard, long slab_len,
                     void* stream) {
  return slab_pre_launch(
      fused_dgrad_pre_kernel,
      GLoad{cotangent(dy, y, dysum, dyssq), n,
            static_cast<__nv_bfloat16*>(dres)},
      slab, cout, n, h, wi, guard, slab_len, stream);
}

// dgrad_gemm: dx [cin, n] bf16 and part [tiles][2 * cin] f32 (each
// 128-row tile's sums of dn * x and dn) from the slab and w_dg [cin, 9 *
// cout] bf16 (dgrad-packed), through the masks of x [cin, n] bf16,
// scale/shift [cin] f32 and bits [cin, n] uint8 or seed (or neither), on
// `tiles` M tiles and bn-wide N tiles (160, 128 or 64). dgrad_sum: out
// [m] f32 = the tiles' sums of part [tiles][m] in common::tile_sum's order.
int dgrad_gemm_launch(const void* slab, const void* w_dg, const void* x,
                      const void* scale, const void* shift, const void* bits,
                      const void* seed, void* dx, void* part, int cout,
                      int cin, int n, int h, int wi, int guard, int tiles,
                      int bn, int thresh, float keep, void* stream) {
  if (h < 1 || wi < 1 || n % (h * wi))
    return static_cast<int>(cudaErrorInvalidValue);
  const fwd_wgmma_bf16::Args args{
      in<__nv_bfloat16>(slab), in<__nv_bfloat16>(w_dg), nullptr, nullptr,
      nullptr, cout, cin, n, n / (h * wi), h, wi, guard};
  const dgrad_wgmma_bf16::Epi epi{
      in<__nv_bfloat16>(x), in<float>(scale), in<float>(shift),
      DropBits{in<unsigned char>(bits), in<int>(seed), n},
      static_cast<__nv_bfloat16*>(dx), static_cast<float*>(part), thresh,
      keep};
  return static_cast<int>(
      dgrad_wgmma_bf16::launch(args, epi, tiles, bn, as_stream(stream)));
}

int dgrad_sum_launch(const void* part, void* out, int tiles, int m,
                     void* stream) {
  return common::tile_sum<FusedDgradSum>(in<float>(part),
                                         static_cast<float*>(out), tiles, m,
                                         as_stream(stream));
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
      GLoad{cotangent(dy, y, dysum, dyssq), n, nullptr},
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
