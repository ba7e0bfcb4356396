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
// - wgrad is a GEMM over positions, dW[co, (tap, ci)] = sum_n g[co, n] *
//   d[ci, n + shift(tap)], as the int8 wgrad of fused_block.cu: a block
//   owns 64 output channels x (9 taps x 32 input channels) and walks its
//   split of the positions in chunks of 256, staging g [64][256] and, for
//   its 32 input channels, three copies of the chunk's rows of d with a
//   halo row above and below, each shifted by one column (dw = 0, 1, 2)
//   with zeros where the column leaves the image; every tap is then an
//   aligned 4-byte read at a row offset. Each split's f32 tile goes to its
//   slot of a partial buffer and partial_sum adds the splits in order.
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

// --- wgrad: a GEMM over the positions of each split ----------------------

constexpr int WG_CI = 32;                  // input channels per block
constexpr int WG_KC = 256;                 // positions per staging chunk
constexpr int WG_APITCH = 2 * WG_KC + 16;  // bytes per row of the g tile

// Chunk geometry: rc image rows of ic images (rc * wi * ic == WG_KC).
struct Chunk {
  int rc, ic;
};

__host__ __device__ inline Chunk chunk_of(int h, int wi) {
  const int hw = h * wi;
  return hw >= WG_KC ? Chunk{WG_KC / wi, 1} : Chunk{h, WG_KC / hw};
}

// bytes per (dw, ci) row of the shifted copies: ic * (rc + 2) rows of wi
// bf16, padded to 4 mod 32 words so the fragment reads of a warp hit
// distinct banks
__host__ __device__ inline int copy_pitch(Chunk k, int wi) {
  int words = k.ic * (k.rc + 2) * wi / 2;
  words += (4 - words % 32 + 32) % 32;
  return words * 4;
}

inline int wgrad_smem_bytes(int h, int wi) {
  return BM * WG_APITCH + 3 * WG_CI * copy_pitch(chunk_of(h, wi), wi);
}

__global__ void __launch_bounds__(THREADS)
wgrad_kernel(Cotangent ct, Bf16Prologue pro, float* __restrict__ part,
             int cout, int cin, int n, int h, int wi, int span) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Chunk ck = chunk_of(h, wi);
  const int bpitch = copy_pitch(ck, wi);
  unsigned char* As = smem;                          // [BM][WG_APITCH]
  unsigned char* Bs = smem + BM * WG_APITCH;         // [3][WG_CI][bpitch]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int warp_m = warp / 4;
  const int warp_n = warp % 4;
  const int ci0 = blockIdx.x * WG_CI;
  const int m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int hw = h * wi;
  const int slot_rows = ck.rc + 2;

  // ldmatrix rows of A (as conv3x3_rows.cuh) and the shifted-copy byte
  // address of each of this warp's 9 B fragments (fragment F = tap * 4 +
  // ci octet; lane / 4 picks the column, (lane % 4) * 2 the position pair)
  const int q = lane / 8;
  const int a_row = warp_m * 32 + (q & 1) * 8 + lane % 8;
  const int a_byte = (q >> 1) * 16;
  int b_base[9];
#pragma unroll
  for (int f = 0; f < 9; ++f) {
    const int F = warp_n * 9 + f;
    const int tap = F / 4;
    const int dh = tap / 3, dw = tap % 3;
    b_base[f] = (dw * WG_CI + (F % 4) * 8 + lane / 4) * bpitch +
                2 * dh * wi + (lane % 4) * 4;
  }

  float acc[2][9][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int f = 0; f < 9; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][f][e] = 0.f;

  for (int p0 = split * span; p0 < (split + 1) * span; p0 += WG_KC) {
    __syncthreads();
    // g chunk: [64 output channels][256 positions], 8 per unit
    for (int i = tid; i < BM * (WG_KC / 8); i += THREADS) {
      const int row = i / (WG_KC / 8);
      const int piece = i % (WG_KC / 8);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + row < cout) {
        float gf[8];
        ct(m0 + row, n, (size_t)p0 + piece * 8, gf);
        __nv_bfloat16 g[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) g[k] = __float2bfloat16_rn(gf[k]);
        v = pack8(g);
      }
      *reinterpret_cast<uint4*>(As + row * WG_APITCH + piece * 16) = v;
    }
    // shifted copies of d: unit = (ci, image slot row); each computes one
    // image row (wi bf16) of the prologue and writes it shifted by dw - 1
    // columns, zero-filled
    const int img0 = p0 / hw;
    const int row0 = (p0 - img0 * hw) / wi;
    const int nw = wi / 2;  // 32-bit words per image row
    const int units = WG_CI * ck.ic * slot_rows;
    for (int i = tid; i < units; i += THREADS) {
      const int sr = i % (ck.ic * slot_rows);
      const int ci = i / (ck.ic * slot_rows);
      const int img = img0 + sr / slot_rows;
      const int ir = row0 - 1 + sr % slot_rows;
      // w[1 + k] = columns 2k, 2k+1 of the row; w[0], w[nw + 1] = 0
      uint32_t w[18];
#pragma unroll
      for (int k = 0; k < 18; ++k) w[k] = 0;
      if (ir >= 0 && ir < h) {
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (8 * s < wi) {
            __nv_bfloat16 d[8];
            pro(ci0 + ci, img * hw + ir * wi + 8 * s, d);
            const uint4 v = pack8(d);
            w[1 + 4 * s] = v.x;
            w[2 + 4 * s] = v.y;
            w[3 + 4 * s] = v.z;
            w[4 + 4 * s] = v.w;
          }
      }
      unsigned char* dst = Bs + ci * bpitch + 2 * sr * wi;
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (k < nw) {
          // dw = 0 reads column c - 1, dw = 2 column c + 1 (little endian:
          // the low half of a word is its even column)
          *reinterpret_cast<uint32_t*>(dst + 4 * k) =
              __funnelshift_l(w[k], w[k + 1], 16);
          *reinterpret_cast<uint32_t*>(dst + WG_CI * bpitch + 4 * k) = w[k + 1];
          *reinterpret_cast<uint32_t*>(dst + 2 * WG_CI * bpitch + 4 * k) =
              __funnelshift_r(w[k + 1], w[k + 2], 16);
        }
    }
    __syncthreads();

#pragma unroll 1
    for (int ks = 0; ks < WG_KC / 16; ++ks) {
      // positions ks*16 .. ks*16+15 lie in one image slot of the copies
      const int k0 = ks * 16;
      const int koff = 2 * (k0 + (k0 / (ck.rc * wi)) * 2 * wi);
      uint32_t a[2][4];
      const uint32_t a_base = smem_addr(As + a_row * WG_APITCH + a_byte) +
                              ks * 32;
      ldmatrix_x4(a[0], a_base);
      ldmatrix_x4(a[1], a_base + 16 * WG_APITCH);
#pragma unroll
      for (int f = 0; f < 9; ++f) {
        const unsigned char* bp = Bs + b_base[f] + koff;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 16);
        mma_step(acc[0][f], a[0], b0, b1);
        mma_step(acc[1][f], a[1], b0, b1);
      }
    }
  }

  // the split's tile into its slot of the partial buffer; columns (dh, dw,
  // ci) as JAX's [Cout, 9 * Cin] weight-gradient layout
  const size_t kdim = (size_t)9 * cin;
  float* out = part + (size_t)split * cout * kdim;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int f = 0; f < 9; ++f) {
      const int F = warp_n * 9 + f;
      const int col = (F / 4) * cin + ci0 + (F % 4) * 8 + (lane % 4) * 2;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = m0 + warp_m * 32 + mi * 16 + lane / 4 + hi * 8;
        if (row < cout) {
          out[row * kdim + col] = acc[mi][f][2 * hi];
          out[row * kdim + col + 1] = acc[mi][f][2 * hi + 1];
        }
      }
    }
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
  static int smem_set = 0;
  const int bytes = wgrad_smem_bytes(h, wi);
  if (bytes > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = bytes;
  }
  const dim3 grid(cin / WG_CI, (cout + BM - 1) / BM, splits);
  wgrad_kernel<<<grid, THREADS, bytes, as_stream(stream)>>>(
      cotangent(dy, y, dysum, dyssq),
      prologue(x, scale, shift, bits, seed, n, thresh, keep),
      static_cast<float*>(part), cout, cin, n, h, wi, n / splits);
  return static_cast<int>(cudaGetLastError());
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
