// Pieces shared by the fused block-half kernels (fused_block.cu, the int8
// conv core; fused_block_bf16.cu, the bf16 one) and the stage-transition
// half (transition.cu): 8-wide bf16 loads, the stats-cotangent fold, the
// deterministic per-channel sums of an epilogue tile, the f32 and bf16
// prologues, the per-group int8 quantizer (amax pass, quant pass), and
// where the forwards' prepasses put each lane in their padded slab.

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

// Per-channel sums of two values over the block's [BM, bn] tile,
// deterministically: each warp's 32 consecutive elements lie in one row
// (bn % 32 == 0), so a warp butterfly and then the warps' slots in order.
// elem(r, c, s1, s2) runs for rows m0 + r < rows and columns c < cols; row
// r's sums go to slot `slot` of part ([slots][2 * rows]): part[slot][m0 +
// r] and part[slot][rows + m0 + r]. part null: elem runs, no sums. The
// caller syncs the block before, when elem reads what other threads wrote.
template <typename Elem>
__device__ __forceinline__ void tile_sums(int bn, int m0, int rows, int cols,
                                          size_t slot,
                                          float* __restrict__ part,
                                          const Elem& elem) {
  __shared__ float red[2][BM][8];
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < BM * bn; i += THREADS) {
    const int r = i / bn;
    const int c = i - r * bn;
    float s1 = 0.f, s2 = 0.f;
    if (m0 + r < rows && c < cols) elem(r, c, s1, s2);
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
  if (r < BM && m0 + r < rows) {
    float s1 = red[0][r][0], s2 = red[1][r][0];
    for (int k = 1; k < bn / 32; ++k) {
      s1 = __fadd_rn(s1, red[0][r][k]);
      s2 = __fadd_rn(s2, red[1][r][k]);
    }
    part[slot * 2 * rows + m0 + r] = s1;
    part[slot * 2 * rows + rows + m0 + r] = s2;
  }
}

// --- elementwise operands of the quantizers ------------------------------

// d = dropout(relu(x * scale + shift)) in f32; no bits: no dropout
struct Prologue {
  const __nv_bfloat16* x;
  const float* scale;
  const float* shift;
  dropout::DropBits bits;
  int thresh;
  float keep;  // f32(256 / thresh)

  __device__ __forceinline__ void operator()(int row, int n, size_t off,
                                             float (&v)[8]) const {
    float xv[8];
    unsigned char b[8];
    load8(x, (size_t)row * n + off, xv);
    bits.load8(row, (int)off, b);
    const float sc = scale[row], sh = shift[row];
    const bool drop = bits.active();
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float r = fmaxf(__fmaf_rn(xv[k], sc, sh), 0.f);
      v[k] = !drop ? r : (b[k] < thresh ? __fmul_rn(r, keep) : 0.f);
    }
  }
};

// The (row, 8-lane chunk) units of one scale group: group g covers lanes
// [g * tile, (g + 1) * tile) of every row; block s of `slices` takes every
// slices-th unit.
struct GroupWalk {
  int n, tile, slices;
  __device__ __forceinline__ long units(int rows) const {
    return (long)rows * (tile / 8);
  }
  __device__ __forceinline__ void at(long u, int g, int& row,
                                     size_t& off) const {
    const int per_row = tile / 8;
    row = (int)(u / per_row);
    off = (size_t)g * tile + (size_t)(u % per_row) * 8;
  }
};

__device__ __forceinline__ float block_max(float m) {
  __shared__ float red[8];
  m = common::warp_max(m);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  float r = red[0];
  for (int k = 1; k < (int)blockDim.x / 32; ++k) r = fmaxf(r, red[k]);
  return r;
}

// partial maxima of |f| per (group, slice) block: part[g * slices + s]
template <typename Fn>
__device__ __forceinline__ void amax_body(const Fn& fn, int rows,
                                          const GroupWalk& walk,
                                          float* __restrict__ part) {
  const int s = blockIdx.x, g = blockIdx.y;
  float m = 0.f;
  for (long u = (long)s * blockDim.x + threadIdx.x; u < walk.units(rows);
       u += (long)walk.slices * blockDim.x) {
    int row;
    size_t off;
    walk.at(u, g, row, off);
    float v[8];
    fn(row, walk.n, off, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) m = fmaxf(m, fabsf(v[k]));
  }
  m = block_max(m);
  if (threadIdx.x == 0) part[g * walk.slices + s] = m;
}

// Where quant_body puts a unit's 8 codes (row, lanes [off, off + 8) of a
// [rows, n] operand): in the same lane layout, q[row * n + off].
struct LaneStore {
  __device__ __forceinline__ void operator()(signed char* q, int row, int n,
                                             size_t off, uint2 v) const {
    *reinterpret_cast<uint2*>(q + (size_t)row * n + off) = v;
  }
};

// q = s8(clip(rint(f * 127 / max(amax, floor)))) per group, the group's
// absmax into amax[g], and bf16(f) into copy when it is not null; each
// unit's codes placed by `store`
template <typename Fn, typename Store = LaneStore>
__device__ __forceinline__ void quant_body(const Fn& fn, int rows,
                                           const GroupWalk& walk,
                                           const float* __restrict__ part,
                                           float floor,
                                           signed char* __restrict__ q,
                                           float* __restrict__ amax,
                                           __nv_bfloat16* __restrict__ copy,
                                           const Store& store = Store()) {
  const int s = blockIdx.x, g = blockIdx.y;
  float a = part[g * walk.slices];
  for (int k = 1; k < walk.slices; ++k)
    a = fmaxf(a, part[g * walk.slices + k]);
  const float inv = __fdiv_rn(127.f, fmaxf(a, floor));
  if (s == 0 && threadIdx.x == 0) amax[g] = a;
  for (long u = (long)s * blockDim.x + threadIdx.x; u < walk.units(rows);
       u += (long)walk.slices * blockDim.x) {
    int row;
    size_t off;
    walk.at(u, g, row, off);
    float v[8];
    fn(row, walk.n, off, v);
    uint2 packed;
    signed char* o = reinterpret_cast<signed char*>(&packed);
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = conv3x3::quant_s8(__fmul_rn(v[k], inv));
    store(q, row, walk.n, off, packed);
    if (copy != nullptr) {
      const size_t idx = (size_t)row * walk.n + off;
      uint4 raw;
      __nv_bfloat16* c = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int k = 0; k < 8; ++k) c[k] = __float2bfloat16_rn(v[k]);
      *reinterpret_cast<uint4*>(copy + idx) = raw;
    }
  }
}

// One launch quantizes one or two operands over the same scale groups
// (group g of each operand covers the same images; its lanes per group may
// differ, as the stride-2 transition's input and output do): blockIdx.z
// selects the operand (z = 0: fn0 over rows0 and walk0; z = 1: fn1). Both
// walks take the grid's slices.
template <typename Fn0, typename Fn1>
__global__ void __launch_bounds__(256)
amax_kernel(Fn0 fn0, int rows0, GroupWalk walk0, Fn1 fn1, int rows1,
            GroupWalk walk1, float* __restrict__ part) {
  const int groups = gridDim.y;
  if (blockIdx.z == 0)
    amax_body(fn0, rows0, walk0, part);
  else
    amax_body(fn1, rows1, walk1, part + groups * walk0.slices);
}

struct QuantOut {
  float floor;
  signed char* q;
  float* amax;
  __nv_bfloat16* copy;
};

template <typename Fn0, typename Fn1>
__global__ void __launch_bounds__(256)
quant_kernel(Fn0 fn0, int rows0, GroupWalk walk0, QuantOut out0, Fn1 fn1,
             int rows1, GroupWalk walk1, QuantOut out1,
             const float* __restrict__ part) {
  const int groups = gridDim.y;
  if (blockIdx.z == 0)
    quant_body(fn0, rows0, walk0, part, out0.floor, out0.q, out0.amax,
               out0.copy);
  else
    quant_body(fn1, rows1, walk1, part + groups * walk0.slices, out1.floor,
               out1.q, out1.amax, out1.copy);
}

// Where the forward's prepasses (the bf16 one in fused_block_bf16.cu, the
// int8 one in fused_block.cu) and the bf16 dgrad's (fused_block_bf16.cu,
// g at Cin = the half's Cout) write: input lane p (image i, row r, column
// c of h x wi images) at slab position guard + i * (h + 1) * (wi + 1) + (r
// + 1) * (wi + 1) + c + 1 (ops/cuda/fused_block.py fused_fwd_layout).
struct SlabPos {
  int hw, wi, per, guard;
  __device__ __forceinline__ long operator()(long p) const {
    const long i = p / hw;
    const int rem = (int)(p - i * hw), r = rem / wi, c = rem - r * wi;
    return guard + i * per + (r + 1) * (wi + 1) + c + 1;
  }
};

// The slab's k-th position that holds no pixel: the lead guard, then per
// image its zero row (wi + 1 positions) and the zero column of rows 1..h,
// then the tail (whole tiles and the trailing guard).
struct PadPos {
  int guard, wi, h, per;
  long img_pads, m_valid;  // b * (wi + 1 + h); b * per
  __device__ __forceinline__ long operator()(long k) const {
    if (k < guard) return k;
    k -= guard;
    if (k < img_pads) {
      const long i = k / (wi + 1 + h);
      const int j = (int)(k - i * (wi + 1 + h));
      return guard + i * per + (j <= wi ? j : (j - wi) * (wi + 1));
    }
    return guard + m_valid + (k - img_pads);
  }
};

// The prepasses' tiles: PRE_C channels x PRE_P positions, 256 threads
constexpr int PRE_C = 32;
constexpr int PRE_P = 128;

// Pad vector v of the slab [.., c] of T (16 bytes of channels of the
// pads(v / vectors a position)-th pad position) set to zero, a thread
// each; v >= pad_vecs does nothing. c * sizeof(T) % 16 == 0.
template <typename T>
__device__ __forceinline__ void zero_pad_vec(T* __restrict__ slab,
                                             const PadPos& pads, int c,
                                             long v, long pad_vecs) {
  if (v >= pad_vecs) return;
  constexpr int PER = 16 / sizeof(T);
  const int vpp = c / PER;
  const long k = v / vpp;
  *reinterpret_cast<uint4*>(slab + pads(k) * c + (v - k * vpp) * PER) =
      make_uint4(0u, 0u, 0u, 0u);
}

// A prepass tile's second half: the shared tile holds position p's PRE_C
// channels of T in row words[p], two channels a Word (sizeof(Word) == 2 *
// sizeof(T)); each thread writes 16-byte runs of a position's row to out
// [at(p0 + p), c] at channel c0 + run * 16 / sizeof(T). A run or position
// past c or n is skipped. Call after the tile's writes are synced.
template <typename T, typename Word, int PITCH, typename At>
__device__ __forceinline__ void store_runs(Word (*words)[PITCH],
                                           T* __restrict__ out, int c,
                                           int c0, long p0, int n,
                                           const At& at) {
  static_assert(sizeof(Word) == 2 * sizeof(T), "two channels a word");
  constexpr int PER = 16 / sizeof(T);      // channels a run
  constexpr int RUNS = PRE_C / PER;        // runs a position
#pragma unroll
  for (int r = 0; r < PRE_P * RUNS / 256; ++r) {
    const int idx = threadIdx.x + 256 * r;
    const int p = idx / RUNS, run = idx % RUNS;
    const int cc = c0 + PER * run;
    if (cc < c && p0 + p < n) {
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(words[p]) + 4 * run;
      *reinterpret_cast<uint4*>(out + at(p0 + p) * c + cc) =
          make_uint4(src[0], src[1], src[2], src[3]);
    }
  }
}

constexpr float kFwdFloor = 1e-12f;
constexpr float kBwdFloor = 1e-30f;

// d = dropout(relu(bf16(x * scale + shift))) in bf16, 8 at a time
struct Bf16Prologue {
  const __nv_bfloat16* x;
  const float* scale;
  const float* shift;
  dropout::DropBits bits;
  int thresh;
  float keep;  // f32(256 / thresh)
  int n;

  __device__ __forceinline__ void operator()(int ch, int pos,
                                             __nv_bfloat16 (&d)[8]) const {
    float xv[8];
    unsigned char b[8];
    load8(x, (size_t)ch * n + pos, xv);
    bits.load8(ch, pos, b);
    const float sc = scale[ch], sh = shift[ch];
    const bool drop = bits.active();
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float r = fmaxf(
          __bfloat162float(__float2bfloat16_rn(__fmaf_rn(xv[k], sc, sh))),
          0.f);
      d[k] = __float2bfloat16_rn(
          !drop ? r : (b[k] < thresh ? __fmul_rn(r, keep) : 0.f));
    }
  }
};

}  // namespace fused_half
