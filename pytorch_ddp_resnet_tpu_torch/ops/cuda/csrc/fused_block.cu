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
#include "fwd_wgmma_s8.cuh"    // the forward's mainloop

// The fused int8 forward's GEMM kernel and its launchers, on
// fwd_wgmma_s8.cuh's mainloop: here, in its one caller's file, so that
// the files that include that header for the mainloop do not build it.
namespace fwd_wgmma_s8 {

struct Args {
  const float* amax;          // [groups] the forward groups' absmax
  const float* ws;            // [cout] per-output-channel weight scales
  const __nv_bfloat16* res;   // [cout][n] or null
  __nv_bfloat16* y;           // [cout][n]
  float* part;                // [tiles][2 * cout] or null (no stats)
  int cin, cout, n, b, h, wi;
  int lanes;                  // lanes a scale group
  int shift[9];               // slab row of tap t for M row 0
};

// The residual's whole 16-byte vectors of the tile's run, copied by
// cp.async into res_s, a tile [BN][CM_OS] shaped as the staged one, while
// the accumulators are staged: no registers held, every copy in flight at
// once (read one vector after another, each a trip to device memory, they
// took a quarter of the GEMM's time at C = 160).
template <int BN>
__device__ __forceinline__ void load_res(uint32_t res_s, int lead, int count,
                                         int cols, const __nv_bfloat16* res,
                                         size_t ld) {
  const int end = lead + count;
  const int vpc = (end + 7) / 8;  // vectors a column
  for (int idx = threadIdx.x; idx < BN * vpc; idx += THREADS) {
    const int n = idx / vpc, j0 = (idx - n * vpc) * 8;
    if (n < cols && j0 >= lead && j0 + 8 <= end)
      cp_async16(res_s + (n * CM_OS + j0) * 2, res + n * ld + j0, true);
  }
  cp_async_commit();
}

// fwd_wgmma_bf16.cuh's write_res_cm with the residual's whole vectors
// from res_s (load_res; the caller waited for them and synced): column n
// (< cols) of the staged tile, its run [lead, lead + count), to dst + n *
// ld as bf16(f32(res) + f32(y)), written back to the staged tile for the
// sums; the run's ragged ends element by element from res.
template <int BN>
__device__ __forceinline__ void write_res_staged(
    __nv_bfloat16* out, const __nv_bfloat16* res_s, int lead, int count,
    int cols, __nv_bfloat16* dst, const __nv_bfloat16* res, size_t ld) {
  const int end = lead + count;
  const int vpc = (end + 7) / 8;
  for (int idx = threadIdx.x; idx < BN * vpc; idx += THREADS) {
    const int n = idx / vpc, j0 = (idx - n * vpc) * 8;
    if (n >= cols) continue;
    __nv_bfloat16* src = out + n * CM_OS + j0;
    __nv_bfloat16* d = dst + n * ld + j0;
    if (j0 >= lead && j0 + 8 <= end) {
      uint4 v = *reinterpret_cast<const uint4*>(src);
      const uint4 r =
          *reinterpret_cast<const uint4*>(res_s + n * CM_OS + j0);
      __nv_bfloat16* ve = reinterpret_cast<__nv_bfloat16*>(&v);
      const __nv_bfloat16* re = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        ve[e] = __float2bfloat16_rn(
            __fadd_rn(__bfloat162float(re[e]), __bfloat162float(ve[e])));
      *reinterpret_cast<uint4*>(src) = v;
      *reinterpret_cast<uint4*>(d) = v;
    } else {
      for (int e = 0; e < 8; ++e) {
        if (j0 + e < lead || j0 + e >= end) continue;
        const __nv_bfloat16 o = __float2bfloat16_rn(__fadd_rn(
            __bfloat162float(res[n * ld + j0 + e]), __bfloat162float(src[e])));
        src[e] = o;
        d[e] = o;
      }
    }
  }
}

// Grid (ceil(cout / BN), tiles): block (x, y) computes output channels [x *
// BN, x * BN + BN) of M tile y (the N tiles of one M tile neighbours, so
// they read its A boxes through L2) and writes its sums to part[y]. REM =
// Cin % 128 names the tap's last boxes; RES, whether p.res is added.
template <int BN, int REM, bool RES>
__global__ void __launch_bounds__(THREADS, 2)
    fwd_s8_kernel(const __grid_constant__ Maps mp,
                  const __grid_constant__ Args p) {
  using T = Tile<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (ALIGN - raw % ALIGN) % ALIGN;
  unsigned char* ring_p = smem_raw + pad;
  const uint32_t ring = raw + pad;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  int acc[T::NACC];
  mainloop<BN, REM>(mp, p.cin, p.shift, ring, m0, n0, acc);

  // this tile's run of lanes [lane0, lane0 + count) (its residual's
  // vectors start on their way to res_s), each row's place in it or -1 (a
  // pad row or column, or the tail), and each live row's scale amax_g *
  // (1/127), g the scale group of its lane
  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(ring_p);
  int* at = reinterpret_cast<int*>(ring_p + T::AT_OFF);
  float* rowscale = reinterpret_cast<float*>(ring_p + T::AT_OFF + BM * 4);
  const int lane0 = live_before(m0, p.b, p.h, p.wi, p.n);
  const int count = live_before(m0 + BM, p.b, p.h, p.wi, p.n) - lane0;
  const int lead = lane0 % 8;
  const int cols = min(BN, p.cout - n0);
  const size_t off = (size_t)n0 * p.n + lane0 - lead;
  if constexpr (RES)
    load_res<BN>(ring + T::RES_OFF, lead, count, cols, p.res + off, p.n);
  if (tid < BM) {
    const int m = m0 + tid, k = live_before(m, p.b, p.h, p.wi, p.n);
    const bool live = live_before(m + 1, p.b, p.h, p.wi, p.n) > k;
    at[tid] = live ? k - lane0 : -1;
    rowscale[tid] =
        live ? __fmul_rn(p.amax[k / p.lanes], common::kInv127) : 0.f;
  }
  __syncthreads();

  // y = bf16(f32(acc) * (ws[co] * rowscale)), staged channel-major:
  // out[n][lead + at[row]]; acc[4 j + 2 h + e] is row 16 w + l / 4 + 8 h of
  // the warpgroup's 64, column 8 j + 2 (l % 4) + e
  const int warp = tid / 32, lane = tid % 32;
  const int row = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
  const int at0 = at[row], at1 = at[row + 8];
  const float rs0 = rowscale[row], rs1 = rowscale[row + 8];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = n0 + col + e;
      const float wsc = co < p.cout ? p.ws[co] : 0.f;
      if (at0 >= 0)
        out[(col + e) * CM_OS + lead + at0] = __float2bfloat16_rn(
            __fmul_rn(__int2float_rn(acc[4 * j + e]), __fmul_rn(wsc, rs0)));
      if (at1 >= 0)
        out[(col + e) * CM_OS + lead + at1] =
            __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 + e]),
                                          __fmul_rn(wsc, rs1)));
    }
  }
  if constexpr (RES) cp_async_wait<0>();  // this thread's res copies
  __syncthreads();

  if constexpr (RES)
    write_res_staged<BN>(
        out,
        reinterpret_cast<const __nv_bfloat16*>(ring_p + T::RES_OFF), lead,
        count, cols, p.y + off, p.res + off, p.n);
  else
    fwd_wgmma_bf16::write_res_cm<BN>(out, lead, count, cols, p.y + off,
                                     nullptr, p.n);
  if (p.part != nullptr) {
    __syncthreads();  // the residual's sums read what the writes staged
    fwd_staged_s8::sums_cm<BN>(out, lead, count, cols,
                               p.part + (size_t)blockIdx.y * 2 * p.cout,
                               p.cout, n0);
  }
}

template <int BN, int REM, bool RES>
inline cudaError_t launch_kernel(const Maps& mp, const Args& p, int tiles,
                                 cudaStream_t stream) {
  constexpr int smem = Tile<BN>::SMEM;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fwd_s8_kernel<BN, REM, RES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((p.cout + BN - 1) / BN, tiles);
  fwd_s8_kernel<BN, REM, RES><<<grid, THREADS, smem, stream>>>(mp, p);
  return cudaGetLastError();
}

template <int BN, int REM>
inline cudaError_t launch_rem(const Maps& mp, const Args& p, int tiles,
                              cudaStream_t stream) {
  return p.res != nullptr
             ? launch_kernel<BN, REM, true>(mp, p, tiles, stream)
             : launch_kernel<BN, REM, false>(mp, p, tiles, stream);
}

template <int BN>
inline cudaError_t launch_tile(const Maps& mp, const Args& p, int tiles,
                               cudaStream_t stream) {
  switch (p.cin % BK) {
    case 0: return launch_rem<BN, 0>(mp, p, tiles, stream);
    case 32: return launch_rem<BN, 32>(mp, p, tiles, stream);
    case 64: return launch_rem<BN, 64>(mp, p, tiles, stream);
    default: return launch_rem<BN, 96>(mp, p, tiles, stream);
  }
}

// y [cout][n] bf16 (+ res), part [tiles][2 * cout] f32 or null, from the
// slab [slab_len][cin] int8 of fused_fwd_layout (guard, h x wi images) and
// w [cout][9 * cin] int8 (packed), amax [n / lanes], ws [cout] f32, on
// `tiles` 128-row M tiles and bn-wide N tiles (160, 128 or 64). cin % 32
// == 0, cout % 8 == 0, n % 8 == 0.
inline cudaError_t launch(const void* slab, const void* w, const Args& args,
                          long slab_len, int guard, int tiles, int bn,
                          cudaStream_t stream) {
  Args p = args;
  if (p.cin % 32 || p.cout % 8 || p.n % 8 || p.lanes < 1 || tiles < 1 ||
      tiles > 65535 || guard != p.wi + 2 ||
      slab_len < 2L * guard + (long)tiles * BM)
    return cudaErrorInvalidValue;
  tap_rows(p.shift, p.wi);
  Maps mp;
  if (!encode_maps(&mp, slab, slab_len, w, p.cin, p.cout, bn, 9))
    return cudaErrorInvalidValue;
  if (bn == 160) return launch_tile<160>(mp, p, tiles, stream);
  if (bn == 128) return launch_tile<128>(mp, p, tiles, stream);
  if (bn == 64) return launch_tile<64>(mp, p, tiles, stream);
  return cudaErrorInvalidValue;
}

}  // namespace fwd_wgmma_s8

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
