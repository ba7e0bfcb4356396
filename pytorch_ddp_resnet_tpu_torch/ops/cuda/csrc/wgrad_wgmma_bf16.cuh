// The bf16 weight gradient of a 3x3 convolution whose every tap reads one
// plane of x at a shift of at most one row and one column, in the
// channel-major layout [C, B*H*W], written for Hopper (sm_90a): TMA reads x
// and dy where they lie into a warp-specialized wgmma mainloop. Two users:
// - conv3x3_same's stride-1 SAME wgrad (conv3x3_wgrad.cu): one plane, tap
//   (dh, dw) moved by dh - 1 rows and dw - 1 columns;
// - the lane transition's stride-2 wgrad and its projection's (dWp)
//   (transition_wgrad.cu): x is the prologue d as its four parity planes at
//   the output geometry, tap (dh, dw) reads plane 2 [dh != 1] + [dw != 1]
//   one row up where dh = 0 and one column left where dw = 0 (the JAX
//   kernel's _tap_info); dWp is one tap of the raw even-even plane.
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/conv.py:412,
// conv3x3_wgrad_lanes -> _wgrad_kernel; ops/pallas/transition.py:619,
// _bwd_kernel's wgrad and dWp): the TPU kernels build each lane tile's
// patches in VMEM with rolls and masks (from the parity planes at stride 2)
// and contract them with dy on the MXU, carrying dW across their
// sequential grid. Here one GEMM over positions,
//   dW[(tap, ci), co] = sum_p x[plane(tap)][ci, p + shift(tap)] * dy[co, p],
//   M = taps * Cin rows in (tap, ci) order, N = Cout, K = positions,
// and both operands, x [planes][Cin, N] and dy [Cout, N], are already
// K-major for it: positions are contiguous. No prepass writes a slab.
//
// What bounds it on an H100: operations (conv3x3_same: 2 * 9 * Cin * Cout
// * N, 60.4 GFLOP a call at each WRN-28-10 stage, batch 128, 0.061 ms at
// 989 TFLOP/s; the transition: 30.2 GFLOP, and 3.4 for dWp). What the
// design does about it: the product is wgmma.mma_async m64nBNk16 f32 +=
// bf16 * bf16 from K-major, 128-byte-swizzled shared memory, fed by TMA
// and an mbarrier ring, so that copies and MMAs overlap.
// - What TMA can and cannot do here (settled on the card with a probe of
//   boxes in each swizzle while this kernel was designed; the card test
//   test_tma_swizzle_probe keeps holding the layouts read below to
//   conv3x3_wgrad_probe_launch): an innermost coordinate must be a multiple
//   of 16 bytes (a box at column +-1 stops the kernel with an illegal
//   instruction), so TMA cannot make a tap's column shift; a box whose
//   rows are narrower than its swizzle lands each row on a line of the
//   swizzle's width; and boxes of narrow rows are slow (rows of 16 bytes
//   held a first version of this kernel to 146 TFLOP/s at W = 8).
// - So TMA moves 128-byte rows and the column shift is a copy in shared
//   memory. A K step is 64 positions of one image: 64 / W whole rows (W =
//   8, 16, 32; H a multiple of 64 / W) or 64 columns of one row (W a
//   multiple of 64). x is viewed as (HW, B, planes * C), innermost first
//   (plane p's channel c is row p * C + c): for each 32-channel piece of A
//   (32 rows of one tap; a 128-row M tile is four, and may straddle taps,
//   as at Cin = 160) one box stages the step's 64 positions of the tap's
//   plane moved by its row shift times W, unswizzled; positions before the
//   image's first or past its last read as zeros, which is the border in
//   h. Where W >= 64 the box is 80 positions from 8 before the step, so
//   that the step's neighbours ride along. A shifter warpgroup copies each
//   16-byte piece of each staged row into the A tile, moved by the tap's
//   column shift (a funnel shift with its neighbour, zero at the image's
//   side), at the 128-byte swizzle's place. dy, viewed as (N, C), needs no
//   shift: one box a step of BN rows of 128 bytes lands in the 128-byte
//   swizzle as it is.
// - Pipeline, a ring of STAGES slots (A, B, staged x), three mbarriers a
//   slot: `load` (TMA's bytes, expect_tx by the producer warp), `full` (the
//   128 shifters arrive after a fence.proxy.async that orders their
//   shared-memory writes before wgmma's reads) and `empty` (the 256
//   consumer threads arrive once their warpgroup's wgmmas that read the
//   slot have retired). One producer warp in which one thread starts the
//   loads (live pieces + 1 a step), the shifter warpgroup, two consumer
//   warpgroups of 64 rows each, four k16 wgmmas a K step from the fused
//   forward's descriptors (fwd_wgmma_bf16.cuh), one group in flight. One block an
//   SM: at two, m64n160's 80 accumulators do not fit the registers a
//   thread would get (ptxas refused at 96), so the ring takes the shared
//   memory instead (4 stages at BN = 160).
// - Output: block (n tile, m tile, split) writes its f32 tile to
//   part[split][taps * Cin][Cout] (JAX's HWIO order for the 3x3s);
//   common::partial_sum adds the splits in order. No atomics: dW is the
//   same bit for bit every run.
//
// Left for later: persistent blocks, clusters and TMA multicast (each block
// reads its boxes from L2 itself, and each x row once a tap), TMA straight
// into A for the taps without a column shift, one launch (the split tiles
// go to device memory and a second kernel adds them).

#pragma once

#include <cuda.h>  // CUtensorMap (types only: the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fwd_wgmma_bf16.cuh"  // smem_desc, wgmma<BN>, its fences and waits

namespace wgrad_wgmma_bf16 {

using fwd_wgmma_bf16::fence_acc;
using fwd_wgmma_bf16::smem_desc;
using fwd_wgmma_bf16::wgmma;
using fwd_wgmma_bf16::wgmma_commit;
using fwd_wgmma_bf16::wgmma_fence;
using fwd_wgmma_bf16::wgmma_wait;
using wgrad_staged::smem_u32;

constexpr int CONSUMERS = 256;  // two consumer warpgroups
constexpr int SHIFTERS = 128;   // the warpgroup that shifts x into A
constexpr int THREADS = CONSUMERS + SHIFTERS + 32;  // and the producer warp
constexpr int BM = 128;         // M rows a tile, 64 a consumer warpgroup
constexpr int BK = 64;          // positions a K step
constexpr int ROW = 2 * BK;     // bytes of a tile row a K step
constexpr int PIECE = 32;       // M rows (channels) a staged box of x
constexpr int XROW = 160;       // bytes a staged channel row, at most
constexpr int XPIECE = PIECE * XROW;
constexpr int ALIGN = 1024;     // a 128-byte swizzle atom
constexpr int SMEM_MAX = 232448;  // shared memory a block may take

// One BN-wide tile's shared memory: a ring of STAGES slots, each A (BM
// rows), B (BN rows), both 128-byte-swizzled, and x staged for A's four
// pieces; then STAGES load, full and empty mbarriers, and room to align the
// ring.
template <int BN>
struct Tile {
  static constexpr int A_BYTES = BM * ROW;
  static constexpr int B_BYTES = BN * ROW;
  static constexpr int X_OFF = A_BYTES + B_BYTES;
  static constexpr int STAGE_BYTES = X_OFF + 4 * XPIECE;
  static constexpr int FIT = (SMEM_MAX - ALIGN - 128) / STAGE_BYTES;
  static constexpr int STAGES = FIT > 6 ? 6 : FIT;
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int SMEM = RING + 24 * STAGES + ALIGN;
  static constexpr int NACC = BN / 2;  // f32 accumulators a thread
  static_assert(STAGES >= 2, "a ring");
  static_assert(SMEM <= SMEM_MAX, "the block's shared memory");
  static_assert(X_OFF % ALIGN == 0 && STAGE_BYTES % ALIGN == 0, "atoms");
};

constexpr int MAX_TAPS = 9;

struct Args {
  float* part;     // [splits][taps * cin][cout] f32
  int cin, cout;   // cin % 32 == 0, cout % 8 == 0
  int wi, hw;      // image width, positions an image
  int steps, per;  // K steps in all, K steps a split (the last may have fewer)
  int taps;        // M = taps * cin rows, in (tap, ci) order
  // tap t reads x plane plane[t], moved by rs[t] rows and cs[t] columns
  // (each -1, 0 or 1): x[plane][ci][(r + rs, c + cs)], zero off the image
  int plane[MAX_TAPS], rs[MAX_TAPS], cs[MAX_TAPS];
};

// --- mbarriers and TMA ----------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// The box of `map` at element coordinates (c0, c1[, c2]), innermost
// first (c0 * 2 bytes a multiple of 16), to shared memory at dst;
// out-of-bounds elements read as zero. The box's bytes complete a
// transaction of the barrier.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// --- the kernel -------------------------------------------------------------

// 8 bf16 (v) moved by s positions: s = -1 takes `side` (the element
// before) in front, s = +1 takes it (the element after) behind.
__device__ __forceinline__ uint4 shift8(uint4 v, int s, uint32_t side) {
  if (s < 0)
    return make_uint4(__byte_perm(side << 16, v.x, 0x5432),
                      __byte_perm(v.x, v.y, 0x5432),
                      __byte_perm(v.y, v.z, 0x5432),
                      __byte_perm(v.z, v.w, 0x5432));
  if (s > 0)
    return make_uint4(__byte_perm(v.x, v.y, 0x5432),
                      __byte_perm(v.y, v.z, 0x5432),
                      __byte_perm(v.z, v.w, 0x5432),
                      __byte_perm(v.w, side, 0x5432));
  return v;
}

// Grid (ceil(cout / BN), ceil(taps * cin / BM), splits): block (x, y, z)
// computes output channels [x * BN, x * BN + BN) of dW rows [y * BM, y * BM
// + BM) over the K steps of split z, and writes them to part[z]. tx: x as
// (HW, B, planes * C), boxes of 64 positions (80 where W >= 64) x 1 x 32
// channels, unswizzled; tdy: dy as (N, C), boxes of 64 positions x BN
// channels in the 128-byte swizzle. Tag names the user's instantiation in
// a profile.
template <int BN, typename Tag>
__global__ void __launch_bounds__(THREADS, 1)
    wgrad_tma_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tdy,
                     const __grid_constant__ Args p) {
  using T = Tile<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (ALIGN - raw % ALIGN) % ALIGN;
  unsigned char* ring_p = smem_raw + pad;
  const uint32_t ring = raw + pad;
  const uint32_t load = ring + T::RING, full = load + 8 * T::STAGES,
                 empty = full + 8 * T::STAGES;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int m = p.taps * p.cin, cpt = p.cin / PIECE;  // pieces a tap
  const int live = min(BM, m - m0) / PIECE;      // pieces of A inside dW
  const int kt0 = blockIdx.z * p.per;
  const int nk = min(p.steps - kt0, p.per);
  const bool wide = p.wi >= BK;  // a K step is part of one image row

  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(load + 8 * s, 1);
      mbar_init(full + 8 * s, SHIFTERS);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS + SHIFTERS) {  // the producer warp: one thread
    if (tid == CONSUMERS + SHIFTERS) {
      const int bytes = live * PIECE * (wide ? XROW : ROW) + T::B_BYTES;
      // each live piece's box: its tap's row shift in positions, and its
      // first row of x (plane p's channel c is row p * cin + c)
      int dpos[4], row[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int piece = m0 / PIECE + q;
        const int tap = min(piece / cpt, p.taps - 1);
        dpos[q] = p.rs[tap] * p.wi;
        row[q] = p.plane[tap] * p.cin + (piece - tap * cpt) * PIECE;
      }
      for (int i = 0; i < nk; ++i) {
        const int s = i % T::STAGES;
        const uint32_t st = ring + s * T::STAGE_BYTES, bar = load + 8 * s;
        // the slot's previous step has been read by both warpgroups
        if (i >= T::STAGES) mbar_wait(empty + 8 * s, (i / T::STAGES - 1) & 1);
        mbar_arrive_tx(bar, bytes);
        const int pos = (kt0 + i) * BK, b = pos / p.hw;
        const int at = pos - b * p.hw - (wide ? 8 : 0);  // in the image
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < live)
            tma_load_3d(st + T::X_OFF + q * XPIECE, &tx, bar, at + dpos[q],
                        b, row[q]);
        tma_load_2d(st + T::A_BYTES, &tdy, bar, pos, n0);
      }
    }
    return;
  }

  if (tid >= CONSUMERS) {  // the shifters: staged x -> A, moved by cs[tap]
    const int u = tid - CONSUMERS, k8 = u % 8, rg = u / 8;
    // rows rg + 16 r of the tile, r < 8: piece r / 2, channel rg + 16 (r %
    // 2); each live piece's column shift
    int sh[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      sh[q] = q < live ? p.cs[(m0 / PIECE + q) / cpt] : 0;
    for (int i = 0; i < nk; ++i) {
      const int s = i % T::STAGES;
      // this 16-byte piece's column, and whether it opens or ends a row
      const int col = ((kt0 + i) * BK + 8 * k8) % p.wi;
      const bool first = col == 0, last = col + 8 == p.wi;
      mbar_wait(load + 8 * s, (i / T::STAGES) & 1);
      unsigned char* st = ring_p + s * T::STAGE_BYTES;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int q = r / 2, ch = rg + 16 * (r % 2), row = q * PIECE + ch;
        if (q >= live) continue;
        const unsigned char* src = st + T::X_OFF + q * XPIECE +
                                   (wide ? ch * XROW + 16 : ch * ROW) +
                                   16 * k8;
        const uint4 v = *reinterpret_cast<const uint4*>(src);
        const int sq = sh[q];
        uint32_t side = 0;
        if (sq < 0 && !first)
          side = *reinterpret_cast<const unsigned short*>(src - 2);
        if (sq > 0 && !last)
          side = *reinterpret_cast<const unsigned short*>(src + 16);
        *reinterpret_cast<uint4*>(st + row * ROW + ((k8 ^ (row & 7)) << 4)) =
            shift8(v, sq, side);
      }
      // the generic writes ordered before wgmma's reads (async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full + 8 * s);
    }
    return;
  }

  float acc[T::NACC];
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) acc[i] = 0.f;
  const uint32_t a_row = (tid / 128) * 64 * ROW;  // this warpgroup's rows
  for (int i = 0; i < nk; ++i) {
    const int s = i % T::STAGES;
    mbar_wait(load + 8 * s, (i / T::STAGES) & 1);  // B landed
    mbar_wait(full + 8 * s, (i / T::STAGES) & 1);  // A shifted in
    const uint64_t da = smem_desc(ring + s * T::STAGE_BYTES + a_row);
    const uint64_t db = smem_desc(ring + s * T::STAGE_BYTES + T::A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < ROW / 32; ++k) wgmma<BN>(acc, da + 2 * k, db + 2 * k);
    wgmma_commit();
    wgmma_wait<1>();  // this warpgroup's step i - 1 retired: free its slot
    if (i > 0) mbar_arrive(empty + 8 * ((i - 1) % T::STAGES));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // acc[4 j + 2 h + e]: row 16 w + l / 4 + 8 h of the warpgroup's 64,
  // column 8 j + 2 (l % 4) + e
  const int warp = tid / 32, lane = tid % 32;
  const int row = m0 + (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
  float* out = p.part + (size_t)blockIdx.z * m * p.cout;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= p.cout) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row + 8 * h < m)
        *reinterpret_cast<float2*>(out + (size_t)(row + 8 * h) * p.cout +
                                   col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

template <int BN, typename Tag>
inline cudaError_t launch_tile(const CUtensorMap& tx, const CUtensorMap& tdy,
                               const Args& p, int splits,
                               cudaStream_t stream) {
  constexpr int smem = Tile<BN>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      wgrad_tma_kernel<BN, Tag>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.cout + BN - 1) / BN, (p.taps * p.cin + BM - 1) / BM,
                  splits);
  wgrad_tma_kernel<BN, Tag><<<grid, THREADS, smem, stream>>>(tx, tdy, p);
  return cudaGetLastError();
}

// The mainloop on the maps of x and dy (see wgrad_tma_kernel), with a
// bn-wide N tile (160, 128 or 64) and `splits` runs of p.per K steps.
template <typename Tag>
inline cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& tdy,
                          const Args& p, int bn, int splits,
                          cudaStream_t stream) {
  if (p.cin % PIECE || p.cout % 8 || p.per < 1 || splits < 1 ||
      splits > 65535 || (long)(splits - 1) * p.per >= p.steps ||
      p.taps < 1 || p.taps > MAX_TAPS)
    return cudaErrorInvalidValue;
  if (bn == 160) return launch_tile<160, Tag>(tx, tdy, p, splits, stream);
  if (bn == 128) return launch_tile<128, Tag>(tx, tdy, p, splits, stream);
  if (bn == 64) return launch_tile<64, Tag>(tx, tdy, p, splits, stream);
  return cudaErrorInvalidValue;
}

// --- the host side: tensor maps, and one call that encodes and launches ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime's
// entry-point query (so the library links no libcuda); null if missing.
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of t [rows][n = b * h * wi] bf16 (the planes' channels, plane
// after plane) viewed (HW, B, rows), innermost first, in boxes of x's
// staged rows: the step's 64 positions (80 from 8 before where W >= 64)
// of 32 rows, unswizzled. Out-of-bounds elements read as zero. Returns
// false where the encoder is missing or refuses.
inline bool encode_x(CUtensorMap* map, const void* t, int rows, int n, int h,
                     int wi) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr || wi < 1 || h < 1 || n % (h * wi)) return false;
  const cuuint64_t hw = (cuuint64_t)h * wi;
  const cuuint64_t dims[3] = {hw, n / hw, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {2ull * hw, 2ull * n};
  const cuuint32_t box[3] = {(cuuint32_t)(wi >= BK ? XROW / 2 : BK), 1u,
                             (cuuint32_t)PIECE};
  const cuuint32_t unit[3] = {1u, 1u, 1u};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(t),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of t [c, n] bf16 viewed (N, C), in boxes of dy's rows: 64
// positions of bn channels, in the 128-byte swizzle.
inline bool encode_dy(CUtensorMap* map, const void* t, int c, int n, int bn) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)c};
  const cuuint64_t strides[1] = {2ull * n};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)bn};
  const cuuint32_t unit[2] = {1u, 1u};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(t),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// dW of x [planes][cin][n] and dy [cout][n] bf16 (n = b * h * wi, 16-byte
// aligned) into part [splits][taps * cin][cout] f32: tap t reads plane
// tab[3 t], moved by tab[3 t + 1] rows and tab[3 t + 2] columns (host
// memory); a bn-wide N tile, split s covering K steps [s * per, min(steps,
// (s + 1) * per)) of 64 positions. Tag names the kernel in a profile.
template <typename Tag = void>
inline cudaError_t launch_taps(const void* x, int planes, const void* dy,
                               float* part, const int* tab, int taps,
                               int cin, int cout, int n, int h, int wi,
                               int bn, int per, int splits,
                               cudaStream_t stream) {
  if (taps < 1 || taps > MAX_TAPS) return cudaErrorInvalidValue;
  Args p{part, cin, cout, wi, h * wi, n / BK, per, taps, {}, {}, {}};
  for (int t = 0; t < taps; ++t) {
    p.plane[t] = tab[3 * t];
    p.rs[t] = tab[3 * t + 1];
    p.cs[t] = tab[3 * t + 2];
    if (p.plane[t] < 0 || p.plane[t] >= planes || p.rs[t] < -1 ||
        p.rs[t] > 1 || p.cs[t] < -1 || p.cs[t] > 1)
      return cudaErrorInvalidValue;
  }
  CUtensorMap tx, tdy;
  if (!encode_x(&tx, x, planes * cin, n, h, wi) ||
      !encode_dy(&tdy, dy, cout, n, bn))
    return cudaErrorInvalidValue;
  return launch<Tag>(tx, tdy, p, bn, splits, stream);
}

}  // namespace wgrad_wgmma_bf16
