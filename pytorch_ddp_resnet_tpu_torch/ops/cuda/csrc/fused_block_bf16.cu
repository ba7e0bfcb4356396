// Fused preact block-half with a bf16 conv core, forward and backward, in
// the channel-major layout [C, B*H*W], written for Hopper (sm_90a) and
// bound to Python through a plain C interface (ops/cuda/fused_block.py
// loads this file's library with ctypes).
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/fused_block.py, the
// bf16 bodies, quant=False: fused_half, and the straight-through backward
// of fused_half_int8 with quant_bwd=False):
//   fwd_launch       <- _fwd_call -> _fwd_kernel
//   dgrad_launch     <- _dgrad_call -> _dgrad_kernel
//   wgrad_launch     <- _wgrad_call -> _wgrad_kernel
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
// are bound by operations.
//
// Design:
// - fwd and dgrad are the row-tile implicit GEMM of conv3x3_rows.cuh (the
//   bf16 serving conv's mainloop, mma.sync m16n8k16 with f32
//   accumulation) with an operand loader that computes the prologue (fwd:
//   the BatchNorm affine, relu and dropout; dgrad: the cotangent fold and
//   its bf16 rounding) while it stages the halo tile, so neither d nor g
//   is ever written to device memory, and new epilogues on the block's
//   accumulator tile: bf16 rounding, the residual add and the next
//   BatchNorm's sums (fwd); the masks, dx and the d(scale)/d(shift) sums
//   (dgrad). The dgrad's loader also writes dres = bf16(gf) for the
//   (channel, position) it owns. Per-block sums go to the block's slot of
//   a partial buffer and partial_sum adds the slots in order.
// - wgrad is the position-split GEMM of wgrad_bf16.cuh (shared with
//   conv3x3_wgrad.cu), dW[co, (tap, ci)] = sum_n g[co, n] * d[ci, n +
//   shift(tap)], whose operand loads compute g = bf16(gf) and the
//   prologue's d while they stage; partial_sum adds the splits in order.
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
#include "seed_bits.cuh"
#include "wgrad_bf16.cuh"

using namespace conv3x3;
using namespace fused_half;
using dropout::DropBits;

namespace {

using V8 = uint4;  // 8 bf16

// the forward's operand: the prologue computed while the halo is staged
struct FwdLoad {
  Bf16Prologue pro;
  __device__ __forceinline__ V8 operator()(int ch, int pos, bool) const {
    __nv_bfloat16 d[8];
    pro(ch, pos, d);
    return pack8(d);
  }
};

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

// y = bf16(acc) (+ res in bf16); sums of y and y^2 of the stored values
struct FwdEpi {
  const __nv_bfloat16* res;
  __nv_bfloat16* y;
  float* part;  // [n / BN][2 * Cout] or null (no stats)

  __device__ __forceinline__ void tile(const float* Cs, int cld, int bn,
                                       int m0, int n0, int cout,
                                       int n) const {
    tile_sums(bn, m0, cout, n - n0, blockIdx.x, part,
              [&](int r, int c, float& s1, float& s2) {
      const size_t idx = (size_t)(m0 + r) * n + n0 + c;
      __nv_bfloat16 o = __float2bfloat16_rn(Cs[r * cld + c]);
      if (res != nullptr)
        o = __float2bfloat16_rn(
            __fadd_rn(__bfloat162float(res[idx]), __bfloat162float(o)));
      y[idx] = o;
      const float f = __bfloat162float(o);
      s1 = f;
      s2 = __fmul_rn(f, f);
    });
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

// the wgrad's operands: g = bf16(gf), and the recomputed prologue d
struct WgradG {
  Cotangent ct;
  int n;
  __device__ __forceinline__ V8 operator()(int co, size_t pos) const {
    float gf[8];
    ct(co, n, pos, gf);
    __nv_bfloat16 g[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) g[k] = __float2bfloat16_rn(gf[k]);
    return pack8(g);
  }
};

struct WgradD {
  Bf16Prologue pro;
  __device__ __forceinline__ V8 operator()(int ci, int pos) const {
    __nv_bfloat16 d[8];
    pro(ci, pos, d);
    return pack8(d);
  }
};

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

// x [cin, n] bf16, w [cout, 9 * cin] bf16 (packed), scale/shift [cin] f32,
// bits [cin, n] uint8 or null, seed one int32 on the device or null (at
// most one of the two), res [cout, n] bf16 or null; y [cout, n] bf16,
// part [n / BN][2 * cout] f32 or null (no stats). cin % 32 == 0,
// wi % 8 == 0, n a multiple of h * wi.
int fwd_launch(const void* x, const void* w, const void* scale,
               const void* shift, const void* bits, const void* seed,
               const void* res, void* y, void* part, int cin, int cout,
               int n, int h, int wi, int thresh, float keep, void* stream) {
  const FwdLoad load{prologue(x, scale, shift, bits, seed, n, thresh, keep)};
  const FwdEpi epi{in<__nv_bfloat16>(res), static_cast<__nv_bfloat16*>(y),
                   static_cast<float*>(part)};
  return launch_row_tiles_with<__nv_bfloat16>(load, w, epi, cin, cout, n, h,
                                              wi, as_stream(stream));
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

// dy/y/dysum/dyssq as the dgrad's; x/scale/shift/bits/seed as the
// forward's; part [splits][cout][9 * cin] f32, split s covering positions
// [s * span, (s + 1) * span). cin % 32 == 0, wi % 8 == 0, wi <= 32, span
// a multiple of 256, and 256 a multiple of h * wi or the reverse.
int wgrad_launch(const void* dy, const void* y, const void* dysum,
                 const void* dyssq, const void* x, const void* scale,
                 const void* shift, const void* bits, const void* seed,
                 void* part, int cout, int cin, int n, int h, int wi,
                 int splits, int thresh, float keep, void* stream) {
  return wgrad_bf16::launch(
      WgradG{cotangent(dy, y, dysum, dyssq), n},
      WgradD{prologue(x, scale, shift, bits, seed, n, thresh, keep)},
      static_cast<float*>(part), cout, cin, n, h, wi, splits,
      as_stream(stream));
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
