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
// L2), else 64; the epilogue stages f32(acc) row-major in the drained
// ring's memory and walks the tile in 16-byte vectors of 8 channels along
// each NHWC row (x, res and dx_res read, dx and dres written, each once),
// each thread keeping its 8 channels' factors in registers and issuing
// two (BN = 128) or four (BN = 64) rows' loads together; its sums go in a
// fixed order (per thread in row order, then the row groups in order)
// into part[tile], and common::tile_sum adds the tiles in a fixed order:
// dx and dres are bit-equal to the plain version and the sums the same
// bits every run.
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

#include "common.cuh"         // chunk_amax, kInv127
#include "fwd_staged_s8.cuh"  // y_pos: the layout's M row -> NHWC position
#include "fwd_wgmma_s8.cuh"   // mainloop, Tile, Maps, encode_maps

namespace nv_dgrad_wgmma_s8 {

using fwd_wgmma_s8::ALIGN;
using fwd_wgmma_s8::BK;
using fwd_wgmma_s8::BM;
using fwd_wgmma_s8::Maps;
using fwd_wgmma_s8::THREADS;
using fwd_wgmma_s8::Tile;
using wgrad_staged::smem_u32;

typedef __nv_bfloat16 bf16;

enum Mode { IDENTITY = 0, AFFINE = 1, ENTRY = 2 };

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

// The epilogue's use of the drained ring: the f32 tile [BM][OS] row-major
// (OS = BN + 8 words: a warp's fragment stores of 4 rows x 4 column pairs
// fall in distinct banks, and a row's 8-channel vectors are 16-byte
// aligned), each row's NHWC position (pos), and the sums' partials of the
// RS row groups [2][RS][BN]. Thread tid takes the vector v = tid % VPR of
// rows tid / VPR + RS * k.
template <int BN>
struct Stage {
  static constexpr int OS = BN + 8;
  static constexpr int VPR = BN / 8;        // 8-channel vectors a row
  static constexpr int RS = THREADS / VPR;  // rows the block takes at once
  static constexpr int ROWS = BM / RS;      // rows a thread
  // rows whose loads go together: at BN = 128 four take 128 registers
  // and a 48-byte stack, two take 120 and none (the GEMM 8% faster)
  static constexpr int U = BN == 128 ? 2 : 4;
  static constexpr int POS_OFF = BM * OS * 4;
  static constexpr int RED_OFF = POS_OFF + BM * 4;
  static constexpr int BYTES = RED_OFF + 2 * RS * BN * 4;
  static_assert(BM % RS == 0 && ROWS % U == 0, "whole rows a thread");
  static_assert(BYTES <= Tile<BN>::RING, "the epilogue fits the ring");
};

// 8 bf16 of a 16-byte vector as f32
__device__ __forceinline__ void unpack8(const uint4& raw, float (&v)[8]) {
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(e[k]);
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint4 out;
  bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int k = 0; k < 8; ++k) o[k] = __float2bfloat16_rn(v[k]);
  return out;
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Grid (ceil(cin / BN), chunks * tiles): block (x, y) computes input
// channels [x * BN, x * BN + BN) of M tile y % tiles of chunk y / tiles
// (the N tiles of one M tile neighbours, so they read its A boxes through
// L2) and writes its sums to part[y]. REM = cp % 128 names a tap's last
// box.
template <int BN, int REM>
__global__ void __launch_bounds__(THREADS, 2)
    nvt_dgrad_s8_kernel(const __grid_constant__ Maps mp,
                        const __grid_constant__ Args p) {
  using S = Stage<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (ALIGN - raw % ALIGN) % ALIGN;
  unsigned char* smem = smem_raw + pad;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * BN;
  const int chunk = blockIdx.y / p.tiles;
  const int m0 = (blockIdx.y - chunk * p.tiles) * BM;  // chunk-local
  int acc[BN / 2];
  fwd_wgmma_s8::mainloop<BN, REM>(mp, p.cp, p.shift, raw + pad,
                                  chunk * p.slab_len + m0, n0, acc, 0,
                                  p.taps);

  // f32(acc) staged row-major: acc[4 j + 2 h + e] is row 16 w + l / 4 + 8
  // h of the warpgroup's 64, column 8 j + 2 (l % 4) + e; each row's NHWC
  // position, or -1 (the pad column, the tile tail)
  float* out = reinterpret_cast<float*>(smem);
  int* pos = reinterpret_cast<int*>(smem + S::POS_OFF);
  float* red = reinterpret_cast<float*>(smem + S::RED_OFF);
  const int row = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(out + row * S::OS + col) = make_float2(
        __int2float_rn(acc[4 * j]), __int2float_rn(acc[4 * j + 1]));
    *reinterpret_cast<float2*>(out + (row + 8) * S::OS + col) = make_float2(
        __int2float_rn(acc[4 * j + 2]), __int2float_rn(acc[4 * j + 3]));
  }
  if (tid < BM) pos[tid] = fwd_staged_s8::y_pos(p.rows, chunk, m0 + tid);
  __syncthreads();

  // this thread's 8 channels (cin % 8 == 0: all live or none): their
  // factors ws_in * scale (the tile's one scale, the chunk's amax *
  // f32(1/127)) and the prologue's s and t
  const int v = tid % S::VPR, r0 = tid / S::VPR;
  const int c0 = n0 + 8 * v;
  const bool live = c0 < p.cin;
  const float sc = __fmul_rn(
      common::chunk_amax(p.rowmax, chunk, p.rows.rch, p.rows.halo, p.rows.h),
      common::kInv127);
  float fac[8], sv[8] = {}, tv[8] = {};
  if (live) {
    load8(p.ws_in + c0, fac);
#pragma unroll
    for (int e = 0; e < 8; ++e) fac[e] = __fmul_rn(fac[e], sc);
    if (p.mode != IDENTITY) {
      load8(p.s + c0, sv);
      load8(p.t + c0, tv);
    }
  }
  float s1[8] = {}, s2[8] = {};  // sums of du * x and du, in row order
  for (int k0 = 0; k0 < S::ROWS; k0 += S::U) {
    // the U rows' NHWC loads issued together, then their math
    int at[S::U];
    uint4 xr[S::U], rr[S::U], orr[S::U];
#pragma unroll
    for (int u = 0; u < S::U; ++u) {
      at[u] = live ? pos[r0 + S::RS * (k0 + u)] : -1;
      if (at[u] < 0 || p.mode == IDENTITY) continue;
      const size_t i = (size_t)at[u] * p.cin + c0;
      xr[u] = *reinterpret_cast<const uint4*>(p.x + i);
      if (p.mode == ENTRY) {
        rr[u] = *reinterpret_cast<const uint4*>(p.res + i);
        orr[u] = *reinterpret_cast<const uint4*>(p.dxout + i);
      }
    }
#pragma unroll
    for (int u = 0; u < S::U; ++u) {
      if (at[u] < 0) continue;
      const size_t i = (size_t)at[u] * p.cin + c0;
      float a[8], da[8];
      load8(out + (r0 + S::RS * (k0 + u)) * S::OS + 8 * v, a);
      if (p.mode == IDENTITY) {
#pragma unroll
        for (int e = 0; e < 8; ++e) da[e] = __fmul_rn(a[e], fac[e]);
        *reinterpret_cast<uint4*>(p.dx + i) = pack8(da);
        continue;
      }
      float xv[8], rv[8], ov[8], dx[8];
      unpack8(xr[u], xv);
      if (p.mode == ENTRY) {
        unpack8(rr[u], rv);
        unpack8(orr[u], ov);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float uu = __fmaf_rn(xv[e], sv[e], tv[e]);
        float d;
        if (p.mode == ENTRY) {
          uu = __fadd_rn(uu, rv[e]);
          d = __fmaf_rn(a[e], fac[e], ov[e]);
        } else {
          d = __fmul_rn(a[e], fac[e]);
        }
        da[e] = uu > 0.f ? d : 0.f;   // du
        dx[e] = __fmul_rn(da[e], sv[e]);
        s1[e] = __fadd_rn(s1[e], __fmul_rn(da[e], xv[e]));
        s2[e] = __fadd_rn(s2[e], da[e]);
      }
      *reinterpret_cast<uint4*>(p.dx + i) = pack8(dx);
      if (p.mode == ENTRY)
        *reinterpret_cast<uint4*>(p.dres + i) = pack8(da);
    }
  }
  if (p.mode == IDENTITY) return;

  // the row groups' sums in order: red[q][r0][col]
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[r0 * BN + 8 * v + e] = s1[e];
    red[(S::RS + r0) * BN + 8 * v + e] = s2[e];
  }
  __syncthreads();
  if (tid < 2 * BN) {
    const int q = tid / BN, col = tid % BN;
    if (n0 + col < p.cin) {
      const float* r = red + q * S::RS * BN + col;
      float sum = r[0];
      for (int k = 1; k < S::RS; ++k) sum = __fadd_rn(sum, r[k * BN]);
      p.part[(size_t)blockIdx.y * 2 * p.cin + q * p.cin + n0 + col] = sum;
    }
  }
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
