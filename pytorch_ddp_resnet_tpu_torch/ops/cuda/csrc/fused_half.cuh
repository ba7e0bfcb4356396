// Pieces shared by the fused block-half kernels (fused_block.cu, the int8
// conv core; fused_block_bf16.cu, the bf16 one): 8-wide bf16 loads, the
// stats-cotangent fold, and the deterministic per-channel sums of an
// epilogue tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "conv3x3_rows.cuh"
#include "seed_bits.cuh"

namespace fused_half {

using conv3x3::BM;
using conv3x3::THREADS;

// 8 consecutive bf16 as f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, size_t off,
                                      float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p + off);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(e[k]);
}

// 8 bf16 values packed into 16 bytes
__device__ __forceinline__ uint4 pack8(const __nv_bfloat16 (&v)[8]) {
  uint4 raw;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) e[k] = v[k];
  return raw;
}

// gf = (dy + dysum) + (2y) * dyssq (one fma), or dy without stats
// cotangents, in f32
struct Cotangent {
  const __nv_bfloat16* dy;
  const __nv_bfloat16* y;  // null: no stats cotangents
  const float* dysum;
  const float* dyssq;

  __device__ __forceinline__ void operator()(int row, int n, size_t off,
                                             float (&v)[8]) const {
    load8(dy, (size_t)row * n + off, v);
    if (y == nullptr) return;
    float yv[8];
    load8(y, (size_t)row * n + off, yv);
    const float s = dysum[row], q = dyssq[row];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = __fmaf_rn(2.f * yv[k], q, __fadd_rn(v[k], s));
  }
};

// Per-channel sums of two values over the block's tile, deterministically:
// each warp's 32 consecutive elements lie in one row (bn % 32 == 0), so a
// warp butterfly and then the warps' slots in order. Row r's sums go to
// part[blockIdx.x][m0 + r] and part[blockIdx.x][cout + m0 + r].
template <typename Elem>
__device__ __forceinline__ void tile_with_sums(int bn, int m0, int n0,
                                               int cout, int n,
                                               float* __restrict__ part,
                                               const Elem& elem) {
  __shared__ float red[2][BM][8];
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < BM * bn; i += THREADS) {
    const int r = i / bn;
    const int c = i - r * bn;
    float s1 = 0.f, s2 = 0.f;
    if (m0 + r < cout && n0 + c < n) elem(r, c, s1, s2);
    s1 = common::warp_sum(s1);
    s2 = common::warp_sum(s2);
    if (lane == 0 && part != nullptr) {
      red[0][r][c / 32] = s1;
      red[1][r][c / 32] = s2;
    }
  }
  if (part == nullptr) return;
  __syncthreads();
  const int r = threadIdx.x;
  if (r < BM && m0 + r < cout) {
    float s1 = red[0][r][0], s2 = red[1][r][0];
    for (int k = 1; k < bn / 32; ++k) {
      s1 = __fadd_rn(s1, red[0][r][k]);
      s2 = __fadd_rn(s2, red[1][r][k]);
    }
    part[(size_t)blockIdx.x * 2 * cout + m0 + r] = s1;
    part[(size_t)blockIdx.x * 2 * cout + cout + m0 + r] = s2;
  }
}

}  // namespace fused_half
