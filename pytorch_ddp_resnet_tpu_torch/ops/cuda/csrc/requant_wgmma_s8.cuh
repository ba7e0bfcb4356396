// The int8 serving 3x3 conv with its requantization epilogue, written for
// Hopper (sm_90a): out [Cout, N] = requant(conv3x3(x_q, w_q)) in the
// channel-major layout, int8 or bf16, and out2 [Cout, N] int8 in dual mode
// (requant.cuh says what requant computes and where it rounds). Two
// launches: fused_half.cuh's slab_copy_kernel, then requant_s8_kernel.
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/conv.py:314,
// conv3x3_lanes_requant -> _requant_kernel): per lane tile the TPU kernel
// contracts x_q at the nine taps with rolls and masks of the tile on the
// MXU into s32 and applies the epilogue in VMEM. Here:
// - the prepass (fused_half.cuh's slab_copy, shared with the fused int8
//   dgrad's) copies x_q's codes, unchanged, into the padded
//   position-major slab of ops/cuda/fused_block.py fused_fwd_layout (the
//   fused int8 forward's, one byte a channel): each pixel at its position,
//   zeros at every guard, pad row, pad column and tail position, so every
//   tap (dh, dw) of M row m is slab row m + shift[tap] for any image width.
//   A block takes 32 channels x 128 positions; thread (c, g) reads 16
//   positions of channel c as one 16-byte load where the run is aligned
//   (byte loads where N leaves a channel's row off 16 bytes), the tile is
//   transposed through shared memory, and store_runs writes each
//   position's 32 codes as two 16-byte runs of its slab row; zero_pad_vec
//   zeros the pad positions in 16-byte vectors.
// - requant_s8_kernel is fwd_wgmma_s8.cuh's mainloop, unchanged (TMA boxes
//   of 128, 64 and 32 bytes a tap in their own swizzles, s8 wgmma
//   m64nBNk32 from two consumer warpgroups, two blocks an SM, BN by the
//   layout's rule), with a requantizing epilogue: each M row's lane from
//   live_before (at[]), the element function in registers from the s32
//   accumulators, and each channel's run of live lanes written to [Cout, N]
//   in 16-byte vectors (16 lanes int8, 8 bf16).
//
// What bounds it on an H100: operations (2 * 9 * Cin * Cout * N: 60.4 GOP
// a call at each WRN-28-10 stage, batch 128, 0.0305 ms at 1,979 TOP/s); the
// prepass by its bytes (x_q read, the slab written: 43 / 22 / 12 MB at the
// three stages).
//
// The epilogue (after the mainloop the ring's 110,592 bytes at BN = 160 are
// free; an f32 staged tile, 87,040 bytes, and the bf16 residual's, 43,520,
// would not both fit): the residual's run comes in by cp.async, every
// 16-byte vector it touches, into a bf16 tile [BN][CM_OS] while at[] and
// the channels' scale, shift, sb and tb are set up; each thread applies
// requant_y / requant_q / requant_dual to its accumulators in registers
// and stages only the outputs: bf16 out in place of its residual in that
// tile, int8 out or out2 in an int8 tile [BN][NARROW_OS]. 67,072 bytes at
// BN = 160 (43,520 + 23,040 + 2,560 + 512). A channel's run of lanes
// [lane0, lane0 + count) starts at co * N + lane0, which need not be a
// multiple of 8 or 16 (N = 108 at 6x6, batch 3): each channel is staged
// from its own lead, (co * N + lane0) % V with V the lanes of a 16-byte
// vector, so that staged vector j0 is the aligned vector at co * N + lane0
// - lead + j0; the run's whole vectors are written as 16-byte stores, its
// head and tail in the widest aligned pieces. The epilogue's modes (int8
// or bf16 out, residual, dual, relu) are runtime flags: they sit after the
// last wgmma, where ptxas's serialization of wgmmas on a runtime branch
// (C7520) does not apply.
//
// Grid: one dimension, ceil(Cout / BN) N tiles x M tiles, the N tiles of
// one M tile neighbours (they read its A boxes through L2); no limit of
// 65,535 M tiles.
//
// Left for later: writing the next conv's slab directly from the
// producing epilogue (the int8 outputs feed only the next conv), and the
// wave tails (1,089 / 289 / 81 M tiles at the three stages).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_half.cuh"     // slab_copy
#include "fwd_wgmma_s8.cuh"   // the mainloop, Tile, Maps, encode
#include "requant.cuh"        // requant_y, requant_q, requant_dual

namespace requant_wgmma_s8 {

using conv3x3::requant_dual;
using conv3x3::requant_q;
using conv3x3::requant_y;
using fwd_staged_s8::CM_OS;
using fwd_wgmma_bf16::live_before;
using fwd_wgmma_s8::ALIGN;
using fwd_wgmma_s8::BK;
using fwd_wgmma_s8::BM;
using fwd_wgmma_s8::Maps;
using fwd_wgmma_s8::THREADS;
using fwd_wgmma_s8::Tile;
using wgrad_staged::cp_async16;
using wgrad_staged::cp_async_commit;
using wgrad_staged::cp_async_wait;
using wgrad_staged::smem_u32;

// int8 lanes a staged channel: a run's 128 lanes after a lead of up to
// 15, in whole vectors
constexpr int NARROW_OS = 144;
static_assert(CM_OS >= BM + 7 && CM_OS % 8 == 0, "a bf16 run and its lead");
static_assert(NARROW_OS >= BM + 15 && NARROW_OS % 16 == 0,
              "an int8 run and its lead");

// The epilogue's use of the ring after the mainloop: the bf16 tile [BN]
// [CM_OS] (the residual in, bf16 out in its place), the int8 tile [BN]
// [NARROW_OS] (int8 out or out2), each channel's scale, shift, sb, tb
// [4][BN] and each M row's place in the run at[BM].
template <int BN>
struct Stage {
  static constexpr int WIDE_OFF = 0;
  static constexpr int NARROW_OFF = BN * CM_OS * 2;
  static constexpr int PAR_OFF = NARROW_OFF + BN * NARROW_OS;
  static constexpr int AT_OFF = PAR_OFF + 4 * BN * 4;
  static constexpr int BYTES = AT_OFF + BM * 4;
  static_assert(NARROW_OFF % 16 == 0 && PAR_OFF % 16 == 0, "vectors");
  static_assert(BYTES <= Tile<BN>::RING, "the epilogue fits the ring");
  static_assert(BN <= THREADS, "a thread a channel's parameters");
};

struct Args {
  const float* scale;        // [cout]
  const float* shift;        // [cout]
  const __nv_bfloat16* res;  // [cout][n] or null
  const float* sb;           // [cout], dual mode (out2 non-null)
  const float* tb;
  void* out;                 // [cout][n] int8 when out_int8, else bf16
  signed char* out2;         // [cout][n] or null
  int cin, cout, n, b, h, wi;
  int relu, out_int8;
  float inv_out_scale;
  int n_tiles;               // ceil(cout / BN)
  int tap[9];                // slab row of tap t for M row 0
};

// --- the prepass: x_q's codes into the padded slab ---------------------------

// slab [slab_len][cin] int8 (fused_fwd_layout: guard = wi + 2 zero
// positions, per image of h x wi a zero row and a zero column, zeros to
// slab_len) from x [cin][n] int8: fused_half.cuh's slab_copy, one launch.
// cin % 32 == 0, n a multiple of h * wi.
inline cudaError_t pre_launch(const void* x, void* slab, int cin, int n,
                              int h, int wi, long slab_len,
                              cudaStream_t stream) {
  return fused_half::slab_copy(static_cast<const signed char*>(x),
                               static_cast<signed char*>(slab), cin, cin, n,
                               h, wi, slab_len, stream);
}

// --- the GEMM's epilogue ------------------------------------------------------

// The lead of channel co's run: where lane lane0 of the channel lies in
// its 16-byte vector of V lanes.
template <int V>
__device__ __forceinline__ int lead_of(int co, int n, int lane0) {
  return (int)(((size_t)co * n + lane0) % V);
}

// Vectors a channel's run may touch: a run of up to BM lanes after a lead
// of up to V - 1, for V lanes a vector.
template <int V>
constexpr int kRunVectors = (V - 1 + BM + V - 1) / V;

// The residual's run of each channel c < cols (channel n0 + c of res
// [cout][n], total = cout * n elements) into the bf16 tile at wide (shared
// address wide_s), staged from the channel's lead: every 16-byte vector
// the run touches by cp.async (no registers held, every copy in flight at
// once; a vector's lanes outside the run land in slots nothing reads),
// element by element only where the vector would pass the tensor's end.
// The caller waits for the copies and syncs.
__device__ __forceinline__ void load_res(__nv_bfloat16* wide,
                                         uint32_t wide_s, int lane0,
                                         int count, int cols, int n0, int n,
                                         size_t total,
                                         const __nv_bfloat16* res) {
  constexpr int V = 8;
  constexpr int VPC = kRunVectors<V>;
  for (int idx = threadIdx.x; idx < cols * VPC; idx += THREADS) {
    const int c = idx / VPC, j0 = (idx - c * VPC) * V;
    const int lead = lead_of<V>(n0 + c, n, lane0);
    if (j0 >= lead + count) continue;
    const size_t at = (size_t)(n0 + c) * n + lane0 - lead + j0;
    if (at + V <= total) {
      cp_async16(wide_s + (c * CM_OS + j0) * 2, res + at, true);
    } else {
      for (int e = 0; e < V; ++e)
        if (j0 + e >= lead && j0 + e < lead + count)
          wide[c * CM_OS + j0 + e] = res[at + e];
    }
  }
  cp_async_commit();
}

// Bytes [lo, hi) of a 16-byte vector from src (shared) to dst (global),
// both 16-byte aligned, in the widest aligned pieces (at most four
// stores where byte by byte would take up to fifteen).
__device__ __forceinline__ void store_part(unsigned char* dst,
                                           const unsigned char* src, int lo,
                                           int hi) {
  while (lo < hi) {
    if (!(lo & 7) && lo + 8 <= hi) {
      *reinterpret_cast<uint2*>(dst + lo) =
          *reinterpret_cast<const uint2*>(src + lo);
      lo += 8;
    } else if (!(lo & 3) && lo + 4 <= hi) {
      *reinterpret_cast<uint32_t*>(dst + lo) =
          *reinterpret_cast<const uint32_t*>(src + lo);
      lo += 4;
    } else if (!(lo & 1) && lo + 2 <= hi) {
      *reinterpret_cast<uint16_t*>(dst + lo) =
          *reinterpret_cast<const uint16_t*>(src + lo);
      lo += 2;
    } else {
      dst[lo] = src[lo];
      lo += 1;
    }
  }
}

// Each channel c < cols of the staged tile st (os elements a channel, its
// run from its lead) to dst [cout][n] at channel n0 + c, lanes [lane0,
// lane0 + count): the run's whole vectors of V = 16 / sizeof(E) lanes as
// 16-byte stores, its head and tail by store_part.
template <typename E>
__device__ __forceinline__ void write_runs(const E* st, int os, int lane0,
                                           int count, int cols, int n0,
                                           int n, E* dst) {
  constexpr int V = 16 / sizeof(E);
  constexpr int VPC = kRunVectors<V>;
  for (int idx = threadIdx.x; idx < cols * VPC; idx += THREADS) {
    const int c = idx / VPC, j0 = (idx - c * VPC) * V;
    const int lead = lead_of<V>(n0 + c, n, lane0);
    if (j0 >= lead + count) continue;
    const E* src = st + c * os + j0;
    E* d = dst + (size_t)(n0 + c) * n + lane0 - lead + j0;
    if (j0 >= lead && j0 + V <= lead + count)
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(src);
    else
      store_part(reinterpret_cast<unsigned char*>(d),
                 reinterpret_cast<const unsigned char*>(src),
                 max(lead - j0, 0) * (int)sizeof(E),
                 min(lead + count - j0, V) * (int)sizeof(E));
  }
}

// Grid (n_tiles * tiles): block i computes output channels [x * BN, x * BN
// + BN) of M tile y, x = i % n_tiles, y = i / n_tiles. REM = Cin % 128
// names the tap's last boxes.
template <int BN, int REM>
__global__ void __launch_bounds__(THREADS, 2)
    requant_s8_kernel(const __grid_constant__ Maps mp,
                      const __grid_constant__ Args p) {
  using E = Stage<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (ALIGN - raw % ALIGN) % ALIGN;
  unsigned char* ring_p = smem_raw + pad;
  const uint32_t ring = raw + pad;
  const int tid = threadIdx.x;
  const int n0 = (int)(blockIdx.x % p.n_tiles) * BN;
  const int m0 = (int)(blockIdx.x / p.n_tiles) * BM;
  int acc[BN / 2];
  fwd_wgmma_s8::mainloop<BN, REM>(mp, p.cin, p.tap, ring, m0, n0, acc);

  // this tile's run of lanes [lane0, lane0 + count) (the residual's runs
  // start on their way), each row's place in it or -1 (a pad row or
  // column, or the tail), and the tile's channels' parameters
  __nv_bfloat16* wide = reinterpret_cast<__nv_bfloat16*>(ring_p + E::WIDE_OFF);
  signed char* narrow = reinterpret_cast<signed char*>(ring_p + E::NARROW_OFF);
  float* par = reinterpret_cast<float*>(ring_p + E::PAR_OFF);
  int* at = reinterpret_cast<int*>(ring_p + E::AT_OFF);
  const int lane0 = live_before(m0, p.b, p.h, p.wi, p.n);
  const int count = live_before(m0 + BM, p.b, p.h, p.wi, p.n) - lane0;
  const int cols = min(BN, p.cout - n0);
  const bool has_res = p.res != nullptr, dual = p.out2 != nullptr;
  if (has_res)
    load_res(wide, ring + E::WIDE_OFF, lane0, count, cols, n0, p.n,
             (size_t)p.cout * p.n, p.res);
  if (tid < BM) {
    const int m = m0 + tid, k = live_before(m, p.b, p.h, p.wi, p.n);
    at[tid] = live_before(m + 1, p.b, p.h, p.wi, p.n) > k ? k - lane0 : -1;
  }
  if (tid < BN) {
    const int co = n0 + tid;
    const bool ok = tid < cols;
    par[tid] = ok ? p.scale[co] : 0.f;
    par[BN + tid] = ok ? p.shift[co] : 0.f;
    par[2 * BN + tid] = ok && dual ? p.sb[co] : 0.f;
    par[3 * BN + tid] = ok && dual ? p.tb[co] : 0.f;
  }
  if (has_res) cp_async_wait<0>();  // this thread's residual copies
  __syncthreads();

  // the element function on the accumulators: acc[4 j + 2 h + e] is row
  // 16 w + l / 4 + 8 h of the warpgroup's 64, column 8 j + 2 (l % 4) + e;
  // each output staged at its channel's lead + at[row]
  const int warp = tid / 32, lane = tid % 32;
  const int row = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
  const int at_h[2] = {at[row], at[row + 8]};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * (lane % 4) + e;
      if (col >= cols) continue;
      const int co = n0 + col;
      __nv_bfloat16* w_row = wide + col * CM_OS + lead_of<8>(co, p.n, lane0);
      signed char* q_row =
          narrow + col * NARROW_OS + lead_of<16>(co, p.n, lane0);
      const float sc = par[col], sh = par[BN + col];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = at_h[h];
        if (a < 0) continue;
        const float y = requant_y(
            acc[4 * j + 2 * h + e], sc, sh, has_res,
            has_res ? __bfloat162float(w_row[a]) : 0.f, p.relu);
        if (p.out_int8)
          q_row[a] = requant_q(y, p.inv_out_scale);
        else
          w_row[a] = __float2bfloat16_rn(y);
        if (dual) q_row[a] = requant_dual(y, par[2 * BN + col],
                                          par[3 * BN + col]);
      }
    }
  }
  __syncthreads();

  if (p.out_int8)
    write_runs(narrow, NARROW_OS, lane0, count, cols, n0, p.n,
               static_cast<signed char*>(p.out));
  else
    write_runs(wide, CM_OS, lane0, count, cols, n0, p.n,
               static_cast<__nv_bfloat16*>(p.out));
  if (dual) write_runs(narrow, NARROW_OS, lane0, count, cols, n0, p.n, p.out2);
}

template <int BN, int REM>
inline cudaError_t launch_kernel(const Maps& mp, const Args& p, long blocks,
                                 cudaStream_t stream) {
  constexpr int smem = Tile<BN>::SMEM;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        requant_s8_kernel<BN, REM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  requant_s8_kernel<BN, REM><<<(unsigned)blocks, THREADS, smem, stream>>>(
      mp, p);
  return cudaGetLastError();
}

template <int BN>
inline cudaError_t launch_tile(const Maps& mp, const Args& p, long blocks,
                               cudaStream_t stream) {
  switch (p.cin % BK) {
    case 0: return launch_kernel<BN, 0>(mp, p, blocks, stream);
    case 32: return launch_kernel<BN, 32>(mp, p, blocks, stream);
    case 64: return launch_kernel<BN, 64>(mp, p, blocks, stream);
    default: return launch_kernel<BN, 96>(mp, p, blocks, stream);
  }
}

// out (and out2) from the slab [slab_len][cin] int8 of fused_fwd_layout
// (pre_launch) and w [cout][9 * cin] int8 (packed), on `tiles` 128-row M
// tiles and bn-wide N tiles (160, 128 or 64). cin % 32 == 0; any cout and
// n of whole images; int8 out and dual exclude each other.
inline cudaError_t launch(const void* slab, const void* w, const Args& args,
                          long slab_len, int tiles, int bn,
                          cudaStream_t stream) {
  Args p = args;
  const int guard = p.wi + 2;
  if (p.cin < 32 || p.cin % 32 || p.cout < 1 || p.n < 1 || p.h < 1 ||
      p.wi < 1 || p.n % (p.h * p.wi) || p.b != p.n / (p.h * p.wi) ||
      tiles < 1 || slab_len < 2L * guard + (long)tiles * BM ||
      (p.out_int8 && p.out2 != nullptr) ||
      (p.out2 != nullptr && (p.sb == nullptr || p.tb == nullptr)) ||
      (bn != 160 && bn != 128 && bn != 64))
    return cudaErrorInvalidValue;
  p.n_tiles = (p.cout + bn - 1) / bn;
  const long blocks = (long)p.n_tiles * tiles;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  fwd_wgmma_s8::tap_rows(p.tap, p.wi);
  Maps mp;
  if (!fwd_wgmma_s8::encode_maps(&mp, slab, slab_len, w, p.cin, p.cout, bn,
                                 9))
    return cudaErrorInvalidValue;
  if (bn == 160) return launch_tile<160>(mp, p, blocks, stream);
  if (bn == 128) return launch_tile<128>(mp, p, blocks, stream);
  return launch_tile<64>(mp, p, blocks, stream);
}

}  // namespace requant_wgmma_s8
