// The NV training halves' input-gradient epilogue, shared by both bodies'
// GEMMs (nv_dgrad_wgmma_s8.cuh: the int8 body on fwd_wgmma_s8.cuh's
// mainloop; nv_dgrad_wgmma_bf16.cuh: the bf16 body on fwd_wgmma_bf16.cuh's):
// from a 128-row tile's wgmma accumulators, da by the body's value policy,
// then the prologue's backward: dx = bf16(da) (identity), else du =
// fma(x, s, t) (+ res) > 0 ? da : 0, dx = bf16(du * s), dres = bf16(du)
// (entry), and the tile's f32 sums of du * x and du into part[tile].
//
// The accumulator fragment of wgmma m64nBNk16 (f32) and m64nBNk32 (s32) is
// the same: acc[4 j + 2 h + e] of thread t (warp w of its warpgroup, lane
// l) is row 16 w + l / 4 + 8 h of the warpgroup's 64, column 8 j + 2 (l %
// 4) + e. The epilogue stages f32(acc) row-major in the drained ring, maps
// each row to its NHWC position (fwd_staged_s8::y_pos over the layout's
// rows, -1 for the pad column and the tile tail), then walks the tile in
// 16-byte vectors of 8 channels along each NHWC row (x, res and dx_res
// read, dx and dres written, each once), each thread keeping its 8
// channels' s and t (and the policy's factors) in registers and issuing U
// rows' loads together. Its sums go in a fixed order (per thread in row
// order, then the row groups in order) into part[blockIdx.y], so that
// common::tile_sum gives the same bits every run.
//
// The value policies (da from f32(acc), and in entry mode with dx_res):
//   int8 (S8Dequant): f32(acc) * (ws_in * scale), or one fma with dx_res;
//   bf16 (Bf16Acc):   acc, or __fadd_rn(acc, dx_res).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"         // chunk_amax, kInv127
#include "fwd_staged_s8.cuh"  // y_pos: the layout's M row -> NHWC position

namespace nv_dgrad {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;  // two consumer warpgroups
constexpr int BM = 128;       // M rows a tile

enum Mode { IDENTITY = 0, AFFINE = 1, ENTRY = 2 };

// The epilogue's use of the drained ring (RING bytes): the f32 tile [BM][OS]
// row-major (OS = BN + 8 words: a warp's fragment stores of 4 rows x 4
// column pairs fall in distinct banks, and a row's 8-channel vectors are
// 16-byte aligned), each row's NHWC position (pos), and the sums' partials
// of the RS row groups [2][RS][BN]. Thread tid takes the vector v = tid %
// VPR of rows tid / VPR + RS * k.
template <int BN, int RING>
struct Stage {
  static constexpr int OS = BN + 8;
  static constexpr int VPR = BN / 8;        // 8-channel vectors a row
  static constexpr int RS = THREADS / VPR;  // rows the block takes at once
  static constexpr int ROWS = BM / RS;      // rows a thread
  // rows whose loads go together: at BN = 128 four take 128 registers
  // and a 48-byte stack in the int8 body, two take 120 and none (its GEMM
  // 8% faster)
  static constexpr int U = BN == 128 ? 2 : 4;
  static constexpr int POS_OFF = BM * OS * 4;
  static constexpr int RED_OFF = POS_OFF + BM * 4;
  static constexpr int BYTES = RED_OFF + 2 * RS * BN * 4;
  static_assert(BM % RS == 0 && ROWS % U == 0, "whole rows a thread");
  static_assert(BYTES <= RING, "the epilogue fits the ring");
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

__device__ __forceinline__ float to_f32(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// The int8 body's da: f32(acc) * fac, fac = ws_in * scale (the tile's one
// scale, its chunk's amax * f32(1/127), rounded before it meets the
// accumulator); entry mode one fma with dx_res.
struct S8Dequant {
  const float* ws_in;
  const float* rowmax;
  int chunk, rch, halo, h;
  float sc;
  float fac[8];  // set by load() for live channels only
  __device__ __forceinline__ S8Dequant(const float* ws_in_,
                                       const float* rowmax_, int chunk_,
                                       int rch_, int halo_, int h_)
      : ws_in(ws_in_), rowmax(rowmax_), chunk(chunk_), rch(rch_),
        halo(halo_), h(h_) {}
  __device__ __forceinline__ void begin() {
    sc = __fmul_rn(common::chunk_amax(rowmax, chunk, rch, halo, h),
                   common::kInv127);
  }
  __device__ __forceinline__ void load(int c0) {
    load8(ws_in + c0, fac);
#pragma unroll
    for (int e = 0; e < 8; ++e) fac[e] = __fmul_rn(fac[e], sc);
  }
  __device__ __forceinline__ float da(int e, float a) const {
    return __fmul_rn(a, fac[e]);
  }
  __device__ __forceinline__ float da_entry(int e, float a, float o) const {
    return __fmaf_rn(a, fac[e], o);
  }
};

// The bf16 body's da: the f32 accumulator itself; entry mode a plain add
// of dx_res.
struct Bf16Acc {
  __device__ __forceinline__ void begin() {}
  __device__ __forceinline__ void load(int) {}
  __device__ __forceinline__ float da(int, float a) const { return a; }
  __device__ __forceinline__ float da_entry(int, float a, float o) const {
    return __fadd_rn(a, o);
  }
};

// The epilogue of block (blockIdx.x, blockIdx.y): N tile n0, M tile m0 of
// chunk `chunk`, from the accumulators `acc` (Acc int or float), the ring
// at `smem` drained (every warp past its last read). P holds the
// prologue's operands and outputs: x, res, dxout, s, t, dx, dres, part,
// rows (fwd_staged_s8::Args), cin, mode.
template <int BN, int RING, typename P, typename Policy, typename Acc>
__device__ __forceinline__ void prologue_bwd(const P& p, Policy pol,
                                             const Acc (&acc)[BN / 2],
                                             unsigned char* smem, int chunk,
                                             int m0, int n0) {
  using S = Stage<BN, RING>;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  // f32(acc) staged row-major; each row's NHWC position, or -1 (the pad
  // column, the tile tail)
  float* out = reinterpret_cast<float*>(smem);
  int* pos = reinterpret_cast<int*>(smem + S::POS_OFF);
  float* red = reinterpret_cast<float*>(smem + S::RED_OFF);
  const int row = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(out + row * S::OS + col) =
        make_float2(to_f32(acc[4 * j]), to_f32(acc[4 * j + 1]));
    *reinterpret_cast<float2*>(out + (row + 8) * S::OS + col) =
        make_float2(to_f32(acc[4 * j + 2]), to_f32(acc[4 * j + 3]));
  }
  if (tid < BM) pos[tid] = fwd_staged_s8::y_pos(p.rows, chunk, m0 + tid);
  __syncthreads();

  // this thread's 8 channels (cin % 8 == 0: all live or none): the
  // policy's factors and the prologue's s and t
  const int v = tid % S::VPR, r0 = tid / S::VPR;
  const int c0 = n0 + 8 * v;
  const bool live = c0 < p.cin;
  pol.begin();
  float sv[8] = {}, tv[8] = {};
  if (live) {
    pol.load(c0);
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
        for (int e = 0; e < 8; ++e) da[e] = pol.da(e, a[e]);
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
          d = pol.da_entry(e, a[e], ov[e]);
        } else {
          d = pol.da(e, a[e]);
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

}  // namespace nv_dgrad
