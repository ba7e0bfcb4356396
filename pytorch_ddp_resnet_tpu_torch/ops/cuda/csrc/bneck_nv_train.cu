// Training halves of the post-act bottleneck trunk (forward, input
// gradient, weight gradient), int8 and bf16 bodies, written for Hopper
// (sm_90a) and bound to Python through a plain C interface
// (ops/cuda/bneck_nv_train.py loads this file's shared library with ctypes).
//
// What they replace (pytorch_ddp_resnet_tpu/ops/pallas/bneck_nv_train.py):
//   rowmax_act, fwd_pre, then <- _fwd_call -> _fwd1x1_kernel, _fwd3x3_kernel
//   fwd_s8, sum                  (quant=True: the int8 body; the mainloop
//                                lives in fwd_staged_s8.cuh, which says how
//                                it works)
//   fwd_bf16                  <- the same kernels' quant=False body
//   rowmax_cot, dgrad_pre,    <- _dgrad_call -> _dgrad1x1_kernel,
//   then dgrad_s8, dgrad_sum     _dgrad3x3_kernel (quant_bwd=True; the
//                                GEMM lives in nv_dgrad_wgmma_s8.cuh,
//                                which says how it works)
//   dgrad_pre_bf16, then      <- the same kernels' quant_bwd=False body
//   dgrad_bf16, dgrad_bf16_sum   (the GEMM lives in nv_dgrad_wgmma_bf16.cuh,
//                                which says how it works)
//   wgrad_pre, then           <- _wgrad_call -> _wgrad1x1_kernel,
//   wgrad_s8, wgrad_sum          _wgrad3x3_kernel (quant_bwd=True; the
//                                mainloop lives in wgrad_staged_s8.cuh,
//                                which says how it works)
//   wgrad_pre_bf16, then      <- the same kernels' quant_bwd=False body
//   wgrad_staged_bf16, _sum      (the mainloop and its ordered sum live in
//                                wgrad_staged.cuh, which says how it works)
//   sum                       <- the TPU kernels' sums carried across
//                                their sequential grid
//
// Tensors are NHWC bf16 [N, h, w, C] with no border columns (the TPU
// kernels' [h, wp, N, C] carrier, halo slivers and column masks serve
// Mosaic). A position outside the image is zero AFTER the prologue.
//
// Scale groups (int8 bodies): chunk k of a stage is image rows [k*rch,
// (k+1)*rch) of every image; a 3x3 stage's activation (fwd, wgrad) or
// cotangent (dgrad) group adds the halo rows k*rch-1 and (k+1)*rch inside
// the image. So one image row is quantized at two scales where two chunks
// share it, and no single int8 copy of an operand can serve a 3x3 stage:
// the int8 fwd's, dgrad's and wgrad's prepasses write each chunk's
// operands once, at its scale, halo rows included, into slabs of the
// chunk's own. The absmax of a group is exact in any order:
// rowmax_* writes the maximum of |value| per image row (atomicMax on the
// float's bits, which order as integers for values >= 0), and each kernel
// reduces its group's rows. The bf16 bodies have no groups: they round
// the prologue's (or the fold's) f32 value to bf16 once.
//
// The GEMM core of the bf16 fwd (the template's operand type is bf16
// alone; a tested op that no path runs is its last user): a 128x64 output
// tile per block, 8 warps (4 along M x 2 along N), ldmatrix + mma.sync
// bf16 m16n8k16 -> f32 in registers, K walked 32 bytes (16 values) at a
// time through two shared-memory buffers. The producer loads step k+1's
// bf16 operands into registers while the tensor cores run step k, then
// applies the prologue, rounds them and stores them: M = positions, N =
// Cout, K = (tap, ci); a gathered at (r + dy - 1, c + dx - 1).
// The int8 fwd and both dgrads do not use this core: their prepass
// (nvt_fwd_pre_kernel<Act or Cot, CodesOut or Bf16Out>) writes each
// chunk's activation or cotangent once into a slab, position-major with
// each position's channels contiguous (the 3x3's images innermost, so
// that every tap is one constant position offset; fwd_int8_layout):
// int8 codes at the chunk's scale (a tile of 128 rows lies in one chunk,
// so it has one scale), or for the bf16 dgrad bf16(g) in one chunk of h
// rows. The fwd's GEMM is fwd_staged_s8.cuh's cp.async ring into plain
// ldmatrix and s8 mma.sync; the int8 dgrad's, nv_dgrad_wgmma_s8.cuh, runs
// fwd_wgmma_s8.cuh's TMA-fed s8 wgmma mainloop and the bf16 dgrad's,
// nv_dgrad_wgmma_bf16.cuh, fwd_wgmma_bf16.cuh's cp.async-fed bf16 one,
// both with the 3x3's taps mirrored (the layout is symmetric) and the
// prologue's backward of nv_dgrad_epilogue.cuh.
// The wgrads do not use this core either (M = (tap, ci), N = Cout, K = a run of
// the positions of one chunk, grid z = (chunk, split)). The bf16 one: a
// prepass rounds its operands once into NHWC bf16 scratch, and
// wgrad_staged.cuh's cp.async ring feeds them to ldmatrix.trans. The int8
// one: mma.sync wants K contiguous, NHWC keeps channels contiguous and
// ldmatrix.trans moves only 16-bit elements, so its prepass
// (nvt_wgrad_pre_kernel) quantizes each chunk's operands once and writes
// them channel-major with K contiguous (transposed through shared memory),
// in slabs where every tap shift is one offset of a multiple of 16 bytes;
// wgrad_staged_s8.cuh's cp.async ring copies their rows as they lie into
// plain ldmatrix and s8 mma.sync.
// The core's epilogue runs on the accumulators in registers: the bf16
// outputs and per-block per-channel sums (warp butterflies, then the four
// M-warps in order) into a partial buffer that nvt_sum reduces in a fixed
// tree (the int8 fwd and the dgrads stage their tiles in shared memory and
// sum them in a fixed order into the same kind of buffer; the dgrads'
// tiles go to common::tile_sum). The wgrads
// split each chunk's positions over blocks; the int8 sum adds each chunk's f32(exact s32 over its
// splits) * (amax_a * amax_g / 127^2), the bf16 sum each chunk's f32 split
// tiles in split order, into dW in chunk order, as the TPU kernel's
// sequential grid does: dW is reproducible bit for bit.
//
// What bounds them on an H100: at ResNet-50's stages 1-3 (batch 128) a
// half is 2*N*h*w*taps*Cin*Cout operations, 3.3-30 G, 1.7-15 us at 1979
// int8 TOP/s or 3.4-30 us at 989 bf16 TFLOP/s, against 2-4 bf16 tensors of
// 51-205 MB in and out, 15-120 us at 3.35 TB/s: the 1x1 halves and the
// stage-1 halves are bound by bytes. What the design does about it: each
// operand is read once per output tile column (N / 64 times, N / 128 in
// the int8 fwd and the dgrads where N >= 128), the rounded operands of the
// bf16 fwd never reach device memory, the prepasses' slabs do once
// (written, read back), and no accumulator does (but the wgrads' split
// tiles).
// Left for later: in the bf16 fwd, the producer's synchronous loads (no
// cp.async/TMA ring), a 64-wide N tile that re-reads A Cout/64 times, and
// the halo rows' recomputed prologue; mma.sync instead of wgmma but in the
// dgrads; the wgrads' second launch; the prepasses' bytes (their operands
// written once and read back).
//
// Rounding points (the reference as XLA computes it on the CPU, where the
// tests run it; tests/test_torch_bneck_nv_train.py and
// tests/test_torch_bneck_nv_train_bf16.py pin each): x*s + t is one fma and
// + res rounds on its own; the fold (dy + dzsum) + (2y)*dzssq is one fma;
// int8: ws * scale rounds before it meets f32(acc), and the entry dgrad's
// f32(acc) * (ws * scale) + dx_res is one fma; the wgrad's chunk scale is
// (amax_a * amax_g) * f32(1/127^2) (XLA reassociates the two 1/127
// factors); bf16: the gathered operands round to bf16 once, the products
// accumulate in f32, and the entry dgrad's da + dx_res is a plain add;
// every other product and sum rounds on its own (__fmul_rn / __fadd_rn,
// so nvcc cannot contract them); rintf rounds half to even; s32 -> f32
// rounds to nearest; bf16 outputs round the f32 value once more
// (__float2bfloat16_rn).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_sync.cuh"  // ldmatrix_x4, mma_step, smem_addr, quant_s8
#include "wgrad_staged_launch.cuh"  // the bf16 wgrad and its ordered sum
#include "wgrad_staged_s8.cuh"  // the int8 wgrad's mainloop
#include "fwd_staged_s8.cuh"  // the int8 forward's mainloop
#include "nv_dgrad_wgmma_s8.cuh"  // the int8 input gradient's GEMM
#include "nv_dgrad_wgmma_bf16.cuh"  // the bf16 input gradient's GEMM

using common::chunk_amax;
using conv3x3::ldmatrix_x4;
using conv3x3::mma_step;
using conv3x3::quant_s8;
using conv3x3::smem_addr;

// The launchers of the staged int8 mainloops, here with their only caller
// (in their headers they would build every instantiation wherever the
// headers reach).
namespace fwd_staged_s8 {

template <int BN, int BK>
inline cudaError_t launch_tile(const Args& p, int chunks,
                               cudaStream_t stream) {
  constexpr int smem = Tile<BN, BK>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_staged_s8_kernel<BN, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.cout + BN - 1) / BN, chunks * p.tiles);
  fwd_staged_s8_kernel<BN, BK><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The GEMM with the tile the caller planned: bn in {64, 128}, K steps of bk
// in {64, 128} bytes (cp a multiple of bk).
inline cudaError_t launch(const Args& p, int chunks, int bn, int bk,
                          cudaStream_t stream) {
  if (p.cp % bk) return cudaErrorInvalidValue;
  if (bn == 128 && bk == 128) return launch_tile<128, 128>(p, chunks, stream);
  if (bn == 128 && bk == 64) return launch_tile<128, 64>(p, chunks, stream);
  if (bn == 64 && bk == 128) return launch_tile<64, 128>(p, chunks, stream);
  if (bn == 64 && bk == 64) return launch_tile<64, 64>(p, chunks, stream);
  return cudaErrorInvalidValue;
}

}  // namespace fwd_staged_s8

namespace wgrad_staged_s8 {

template <int BM, int BN>
inline cudaError_t launch_tile(const Args& p, int chunks,
                               cudaStream_t stream) {
  constexpr int smem = Tile<BM, BN>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_staged_s8_kernel<BM, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.taps * p.cin + BM - 1) / BM, (p.cout + BN - 1) / BN,
                  chunks * p.splits);
  wgrad_staged_s8_kernel<BM, BN><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The GEMM with the tile the caller planned: bm, bn in {64, 128}, K steps
// of bk = K_STEP positions.
inline cudaError_t launch(const Args& p, int chunks, int bm, int bn, int bk,
                          cudaStream_t stream) {
  if (bk != K_STEP) return cudaErrorInvalidValue;
  if (bm == 128 && bn == 128) return launch_tile<128, 128>(p, chunks, stream);
  if (bm == 128 && bn == 64) return launch_tile<128, 64>(p, chunks, stream);
  if (bm == 64 && bn == 128) return launch_tile<64, 128>(p, chunks, stream);
  if (bm == 64 && bn == 64) return launch_tile<64, 64>(p, chunks, stream);
  return cudaErrorInvalidValue;
}

}  // namespace wgrad_staged_s8

namespace {

constexpr int BM = 128;       // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // contraction bytes per step
constexpr int ROW = BK + 16;  // smem row stride: conflict-free ldmatrix
constexpr int THREADS = 256;
constexpr int A_BYTES = BM * ROW;
constexpr int TILE_BYTES = (BM + BN) * ROW;  // one buffer: A then B
constexpr float kFloor = 1e-30f;

// the halves' modes: one enum for every kernel of the file and the header
using nv_dgrad::ENTRY;
using nv_dgrad::IDENTITY;

typedef __nv_bfloat16 bf16;

// --- bf16 vectors -----------------------------------------------------------

template <int VN> struct BfVec;
template <> struct BfVec<8> { using type = uint4; };

template <int VN>
struct Raw {  // two bf16 vectors of VN channels (x & res, or dy & y)
  typename BfVec<VN>::type a, b;
};

template <int VN>
__device__ __forceinline__ typename BfVec<VN>::type ld_bf(const bf16* p) {
  return *reinterpret_cast<const typename BfVec<VN>::type*>(p);
}

template <int VN>
__device__ __forceinline__ void unpack(const typename BfVec<VN>::type& raw,
                                       float (&v)[VN]) {
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int k = 0; k < VN; ++k) v[k] = __bfloat162float(e[k]);
}

// VN consecutive f32 of a per-channel vector (16-byte aligned: c0 % 4 == 0)
template <int VN>
__device__ __forceinline__ void ld_f32(const float* p, float (&v)[VN]) {
#pragma unroll
  for (int k = 0; k < VN; k += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + k);
    v[k] = q.x;
    v[k + 1] = q.y;
    v[k + 2] = q.z;
    v[k + 3] = q.w;
  }
}

// --- value sources: the quantized operands before quantization --------------

// a = x | relu(fma(x, s, t)) | relu(fma(x, s, t) + res)
struct Act {
  const bf16* x;
  const bf16* res;
  const float* s;
  const float* t;
  int c;
  int mode;

  template <int VN>
  __device__ __forceinline__ void fetch(size_t p, int c0, Raw<VN>& r) const {
    r.a = ld_bf<VN>(x + p * c + c0);
    if (mode == ENTRY) r.b = ld_bf<VN>(res + p * c + c0);
  }
  template <int VN>
  __device__ __forceinline__ void value(const Raw<VN>& r, int c0,
                                        float (&v)[VN]) const {
    unpack<VN>(r.a, v);
    if (mode == IDENTITY) return;
    float rv[VN], sv[VN], tv[VN];
    if (mode == ENTRY) unpack<VN>(r.b, rv);
    ld_f32<VN>(s + c0, sv);
    ld_f32<VN>(t + c0, tv);
#pragma unroll
    for (int k = 0; k < VN; ++k) {
      float u = __fmaf_rn(v[k], sv[k], tv[k]);
      if (mode == ENTRY) u = __fadd_rn(u, rv[k]);
      v[k] = fmaxf(u, 0.f);
    }
  }
};

// g = fma(2y, dzssq, dy + dzsum)
struct Cot {
  const bf16* dy;
  const bf16* y;
  const float* dzsum;
  const float* dzssq;
  int c;

  template <int VN>
  __device__ __forceinline__ void fetch(size_t p, int c0, Raw<VN>& r) const {
    r.a = ld_bf<VN>(dy + p * c + c0);
    r.b = ld_bf<VN>(y + p * c + c0);
  }
  template <int VN>
  __device__ __forceinline__ void value(const Raw<VN>& r, int c0,
                                        float (&v)[VN]) const {
    float yv[VN], sv[VN], qv[VN];
    unpack<VN>(r.a, v);
    unpack<VN>(r.b, yv);
    ld_f32<VN>(dzsum + c0, sv);
    ld_f32<VN>(dzssq + c0, qv);
#pragma unroll
    for (int k = 0; k < VN; ++k)
      v[k] = __fmaf_rn(2.f * yv[k], qv[k], __fadd_rn(v[k], sv[k]));
  }
};

// --- scale groups -----------------------------------------------------------

__device__ __forceinline__ float inv_of(float amax) {
  return __fdiv_rn(127.f, fmaxf(amax, kFloor));
}

__device__ __forceinline__ uint32_t pack4(float a, float b, float c,
                                          float d) {
  return (uint32_t)(uint8_t)quant_s8(a) |
         ((uint32_t)(uint8_t)quant_s8(b) << 8) |
         ((uint32_t)(uint8_t)quant_s8(c) << 16) |
         ((uint32_t)(uint8_t)quant_s8(d) << 24);
}

// --- row absmax (and the entry mode's x_res) --------------------------------

// rowmax[r] = max |value| over images, columns and channels of row r;
// copy (not null) = bf16(value). Grid (h, slices); rowmax zeroed before.
template <typename Src>
__global__ void __launch_bounds__(256)
nvt_rowmax_kernel(Src src, int n, int h, int w, int c,
                  bf16* __restrict__ copy, float* __restrict__ rowmax) {
  const int r = blockIdx.x;
  const int groups = c / 8;
  const long units = (long)n * w * groups;
  float m = 0.f;
  for (long u = (long)blockIdx.y * blockDim.x + threadIdx.x; u < units;
       u += (long)gridDim.y * blockDim.x) {
    const int g = (int)(u % groups);
    const long pc = u / groups;  // image * w + column
    const int img = (int)(pc / w);
    const size_t p = ((size_t)img * h + r) * w + (pc - (long)img * w);
    Raw<8> raw;
    float v[8];
    src.template fetch<8>(p, 8 * g, raw);
    src.template value<8>(raw, 8 * g, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) m = fmaxf(m, fabsf(v[k]));
    if (copy != nullptr) {
      uint4 out;
      bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = __float2bfloat16_rn(v[k]);
      *reinterpret_cast<uint4*>(copy + p * c + 8 * g) = out;
    }
  }
  __shared__ float red[8];
  m = common::warp_max(m);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < (int)blockDim.x / 32; ++k) m = fmaxf(m, red[k]);
    m = fmaxf(red[0], m);
    atomicMax(reinterpret_cast<int*>(rowmax) + r, __float_as_int(m));
  }
}

// --- the GEMM core ----------------------------------------------------------

// The operand type T (signed char: the int8 bodies, bf16: the bf16 ones)
// sets the accumulator (s32 / f32), the mma.sync shape and the values per
// 32-byte step; the shared-memory layout is the same bytes for both.
template <typename T> using AccT = typename conv3x3::Acc<T>::type;
template <typename T>
__host__ __device__ constexpr int kvals() { return BK / (int)sizeof(T); }

// acc += A[BM][32 bytes] . B[BN][32 bytes]^T of one buffer (A rows, then B
// rows); the fragments of s8 m16n8k32 and bf16 m16n8k16 hold the same
// bytes, so one ldmatrix layout serves both.
template <typename Acc>
__device__ __forceinline__ void mma_tile(Acc (&acc)[2][4][4],
                                         const unsigned char* buf) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int q = lane / 8;
  const int j = lane % 8;
  const uint32_t st = smem_addr(buf);
  const uint32_t a_off = ((warp / 2) * 32 + (q & 1) * 8 + j) * ROW +
                         (q >> 1) * 16;
  const uint32_t b_off = A_BYTES + ((warp % 2) * 32 + (q >> 1) * 8 + j) * ROW +
                         (q & 1) * 16;
  uint32_t af[2][4];
  ldmatrix_x4(af[0], st + a_off);
  ldmatrix_x4(af[1], st + a_off + 16 * ROW);
#pragma unroll
  for (int f2 = 0; f2 < 2; ++f2) {
    uint32_t bf[4];
    ldmatrix_x4(bf, st + b_off + f2 * 16 * ROW);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      mma_step(acc[mi][2 * f2], af[mi], bf[0], bf[1]);
      mma_step(acc[mi][2 * f2 + 1], af[mi], bf[2], bf[3]);
    }
  }
}

// The block's product over steps [kt0, kt1); the loader's fetch(kt, regs)
// issues step kt's global loads, store(regs, buf) converts them into a
// buffer. Step kt+1 is fetched before step kt's products and stored after.
template <typename Acc, typename Loader>
__device__ __forceinline__ void gemm(Acc (&acc)[2][4][4], const Loader& ld,
                                     unsigned char* smem, int kt0, int kt1) {
  typename Loader::Regs regs;
  ld.fetch(kt0, regs);
  ld.store(regs, smem);
  __syncthreads();
  for (int kt = kt0; kt < kt1; ++kt) {
    const bool more = kt + 1 < kt1;
    if (more) ld.fetch(kt + 1, regs);
    mma_tile(acc, smem + ((kt - kt0) & 1) * TILE_BYTES);
    if (more) ld.store(regs, smem + ((kt - kt0 + 1) & 1) * TILE_BYTES);
    __syncthreads();
  }
}

// --- conv loader (the bf16 fwd): M = positions, K = (tap, channel) ---------

struct ConvGeo {
  int n, h, w;
  int c;       // channels of the gathered operand (the contraction's)
  int taps;    // 1 or 9
  int nout;    // output channels (rows of the weights)
};

__device__ __forceinline__ int conv_steps(const ConvGeo& g, int kv) {
  return g.taps * ((g.c + kv - 1) / kv);
}

// Each row of a step holds 32 bytes of K, two threads 16 bytes each: one
// 8-channel vector of the prologue's a rounded to bf16 a thread, gathered
// at (r + dy - 1, c + dx - 1).
template <typename T>
struct ConvLoader {
  static_assert(sizeof(T) == 2, "the bf16 bodies");
  static constexpr int KV = kvals<T>();
  static constexpr int NV = 2 / (int)sizeof(T);  // 8-channel vectors a thread
  using WVec = typename conv3x3::Vec8<T>::type;
  Act src;
  const T* wt;  // [nout][taps * c]
  ConvGeo g;
  bf16* copy;   // bf16 forward, entry mode: x_res = bf16(a) (1x1 only)
  // per thread
  int img, oy, ox, r, half;
  bool row_ok;
  const T* b_row;
  bool b_ok;
  int csteps;

  struct Regs {
    Raw<8> a[NV];
    bool av[NV];
    int c0;
    WVec b[NV];
  };

  __device__ ConvLoader(const Act& s, const T* w, const ConvGeo& geo, int m0,
                        int n0, bf16* copy_ = nullptr)
      : src(s), wt(w), g(geo), copy(copy_) {
    const int tid = threadIdx.x;
    r = tid >> 1;
    half = tid & 1;
    const int m = m0 + r;
    const int M = g.n * g.h * g.w;
    row_ok = m < M;
    const int mm = row_ok ? m : 0;
    img = mm / (g.h * g.w);
    const int rem = mm - img * g.h * g.w;
    oy = rem / g.w;
    ox = rem - oy * g.w;
    const int rb = n0 + r;
    b_ok = tid < 2 * BN && rb < g.nout;
    b_row = wt + (size_t)(b_ok ? rb : 0) * g.taps * g.c;
    csteps = (g.c + KV - 1) / KV;
  }

  __device__ __forceinline__ void fetch(int kt, Regs& rg) const {
    const int tap = kt / csteps;
    const int cs = kt - tap * csteps;
    const int dy = g.taps == 9 ? tap / 3 : 1;
    const int dx = g.taps == 9 ? tap % 3 : 1;
    const int iy = oy + dy - 1;
    const int ix = ox + dx - 1;
    const bool ok = row_ok && (unsigned)iy < (unsigned)g.h &&
                    (unsigned)ix < (unsigned)g.w;
    const size_t p = ((size_t)img * g.h + iy) * g.w + ix;
    rg.c0 = cs * KV + half * 8 * NV;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int cj = rg.c0 + 8 * j;
      rg.av[j] = ok && cj < g.c;
      if (rg.av[j]) src.template fetch<8>(p, cj, rg.a[j]);
      const bool bv = b_ok && cj < g.c;
      rg.b[j] = bv ? *reinterpret_cast<const WVec*>(b_row + tap * g.c + cj)
                   : WVec{};
    }
  }

  __device__ __forceinline__ void store(const Regs& rg,
                                        unsigned char* buf) const {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      WVec q{};
      if (rg.av[j]) {
        float v[8];
        src.template value<8>(rg.a[j], rg.c0 + 8 * j, v);
        bf16* e = reinterpret_cast<bf16*>(&q);
#pragma unroll
        for (int k = 0; k < 8; ++k) e[k] = __float2bfloat16_rn(v[k]);
        // the 1x1 gathers each position once per column of blocks
        if (copy != nullptr && blockIdx.y == 0)
          *reinterpret_cast<WVec*>(
              copy + (((size_t)img * g.h + oy) * g.w + ox) * g.c + rg.c0) =
              q;
      }
      const int off = r * ROW + half * 16 + j * (int)sizeof(WVec);
      *reinterpret_cast<WVec*>(buf + off) = q;
      if (threadIdx.x < 2 * BN)
        *reinterpret_cast<WVec*>(buf + A_BYTES + off) = rg.b[j];
    }
  }
};

// --- epilogue helpers -------------------------------------------------------

// Visit the block's outputs: fn(m, n, acc(m, n), acc(m, n + 1)) for the
// thread's valid rows m and column pairs (n, n + 1).
template <typename Acc, typename Fn>
__device__ __forceinline__ void each_pair(const Acc (&acc)[2][4][4], int m0,
                                          int n0, int M, int nout, Fn&& fn) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = n0 + (warp % 2) * 32 + ni * 8 + (lane % 4) * 2;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = m0 + (warp / 2) * 32 + mi * 16 + lane / 4 + hr * 8;
        if (m < M && n < nout)
          fn(mi, ni, hr, m, n, acc[mi][ni][2 * hr], acc[mi][ni][2 * hr + 1]);
      }
    }
}

// Per-channel sums of two quantities over the block's rows, in a fixed
// order: s[q][ni][e] holds the thread's sums (its 4 rows) for column
// (ni, e); warp butterflies over the 8 row lanes, then the 4 M-warps in
// order; part[blockIdx.x][n] and part[blockIdx.x][nout + n].
__device__ __forceinline__ void block_sums(float (&s)[2][4][2], int n0,
                                           int nout, float* __restrict__ part) {
  __shared__ float red[2][4][BN];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = s[q][ni][e];
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 4));
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 8));
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 16));
        if (lane < 4)
          red[q][warp / 2][(warp % 2) * 32 + ni * 8 + lane * 2 + e] = v;
      }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < 2 * BN) {
    const int q = t / BN, col = t % BN;
    if (n0 + col < nout) {
      float v = red[q][0][col];
      for (int k = 1; k < 4; ++k) v = __fadd_rn(v, red[q][k][col]);
      part[(size_t)blockIdx.x * 2 * nout + q * nout + n0 + col] = v;
    }
  }
}

// --- forward ----------------------------------------------------------------

struct FwdArgs {
  Act act;
  const void* w;           // [cout][taps * cin] bf16
  bf16* y;                 // [M][cout]
  float* part;             // [M / BM][2 * cout]
  bf16* x_res;             // entry mode: [M][cin]
  ConvGeo g;
};

// The bf16 body (the int8 one is fwd_staged_s8.cuh's): y = bf16(acc); sums
// of f32(y) and its square
template <typename T>
__global__ void __launch_bounds__(THREADS) nvt_fwd_kernel(FwdArgs args) {
  static_assert(sizeof(T) == 2, "the bf16 forward");
  __shared__ __align__(128) unsigned char smem[2 * TILE_BYTES];
  const ConvGeo g = args.g;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int M = g.n * g.h * g.w;
  AccT<T> acc[2][4][4] = {};
  const ConvLoader<T> ld(args.act, static_cast<const T*>(args.w), g, m0, n0,
                         args.x_res);
  gemm(acc, ld, smem, 0, conv_steps(g, kvals<T>()));

  float s[2][4][2] = {};
  each_pair(acc, m0, n0, M, g.nout,
            [&](int, int ni, int, int m, int n, AccT<T> v0, AccT<T> v1) {
    const float y0 = __bfloat162float(__float2bfloat16_rn(v0));
    const float y1 = __bfloat162float(__float2bfloat16_rn(v1));
    *reinterpret_cast<__nv_bfloat162*>(args.y + (size_t)m * g.nout + n) =
        __floats2bfloat162_rn(y0, y1);
    s[0][ni][0] = __fadd_rn(s[0][ni][0], y0);
    s[0][ni][1] = __fadd_rn(s[0][ni][1], y1);
    s[1][ni][0] = __fadd_rn(s[1][ni][0], __fmul_rn(y0, y0));
    s[1][ni][1] = __fadd_rn(s[1][ni][1], __fmul_rn(y1, y1));
  });
  block_sums(s, n0, g.nout, args.part);
}

// --- the int8 forward's and input gradient's operand -----------------------

// Where ops/cuda/bneck_nv_train.py fwd_int8_layout puts the quantized
// operand (the forward's activation, the dgrad's cotangent, cin its
// channels; the bf16 dgrad's rounded cotangent in one chunk of h rows):
// chunk k's slab is slab_len positions of cp elements at k * slab_len *
// cp; past guard zero positions, slab row ra (image row k * rch
// - halo + ra), column col (< wq; col >= w is zero) and image i sit at
// position (ra * wq + col) * n + i (3x3: images innermost) or (i * rch +
// ra) * w + col (1x1), channels cin..cp zero; the rest of the slab is
// zero.
struct FwdSlabGeo {
  int n, h, w, cin, rch, halo;
  int cp, wq, guard, slab_len;
};

constexpr int FWD_PRE_U = 4;  // slab units (8 channels of a position) a thread

// The prepass's output, 8 channels a unit: int8 codes at the chunk's scale
// (q = clip(rint(v * inv)), 8 bytes), or bf16 (16 bytes, no scale).
struct CodesOut {
  using Unit = uint2;
  signed char* slab;
  const float* rowmax;
  float inv;
  __device__ __forceinline__ Unit* chunk(int k, const FwdSlabGeo& s) const {
    return reinterpret_cast<Unit*>(slab + (size_t)k * s.slab_len * s.cp);
  }
  __device__ __forceinline__ void begin(int k, const FwdSlabGeo& s) {
    inv = inv_of(chunk_amax(rowmax, k, s.rch, s.halo, s.h));
  }
  __device__ __forceinline__ Unit pack(const float (&v)[8]) const {
    return make_uint2(pack4(__fmul_rn(v[0], inv), __fmul_rn(v[1], inv),
                            __fmul_rn(v[2], inv), __fmul_rn(v[3], inv)),
                      pack4(__fmul_rn(v[4], inv), __fmul_rn(v[5], inv),
                            __fmul_rn(v[6], inv), __fmul_rn(v[7], inv)));
  }
};

struct Bf16Out {
  using Unit = uint4;
  bf16* slab;
  __device__ __forceinline__ Unit* chunk(int k, const FwdSlabGeo& s) const {
    return reinterpret_cast<Unit*>(slab + (size_t)k * s.slab_len * s.cp);
  }
  __device__ __forceinline__ void begin(int, const FwdSlabGeo&) {}
  __device__ __forceinline__ Unit pack(const float (&v)[8]) const {
    Unit out;
    bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = __float2bfloat16_rn(v[k]);
    return out;
  }
};

// Every chunk's slab, one launch: block row blockIdx.y is chunk k. A unit
// is 8 channels of one slab position, channels fastest, so a warp reads
// whole 16-byte vectors of consecutive channels of the source's tensors
// and writes 256 contiguous slab bytes; each thread takes FWD_PRE_U units
// 256 apart, issues all their loads, then (CodesOut) reduces the chunk's
// scale while they are in flight. It computes the value in f32
// (Src::value: Act the forward's prologue, x*s + t one fma, + res on its
// own, then relu, entry mode recomputing it from x and res, never from
// x_res; Cot the dgrad's fold, (dy + dzsum) + (2y)*dzssq one fma), then
// Out::pack quantizes it at the chunk's scale (8 bytes a unit) or rounds
// it to bf16 (16 bytes); positions outside the image, the pad column, pad
// channels, guards and the tile tail get zeros. A 3x3 image row that two
// chunks share is written into both slabs, at their two scales.
template <typename Src, typename Out>
__global__ void __launch_bounds__(256)
nvt_fwd_pre_kernel(Src src, Out dst, FwdSlabGeo s) {
  const int k = blockIdx.y;
  const int groups = s.cp / 8;
  const int units = s.slab_len * groups;
  const int span = (s.rch + 2 * s.halo) * s.wq * s.n;
  typename Out::Unit* out = dst.chunk(k, s);
  const int u0 = blockIdx.x * 256 * FWD_PRE_U + threadIdx.x;
  Raw<8> raw[FWD_PRE_U];
  unsigned live = 0;
#pragma unroll
  for (int j = 0; j < FWD_PRE_U; ++j) {
    const int u = u0 + 256 * j;
    const int c0 = 8 * (u % groups);
    const int o = u / groups - s.guard;
    if (u < units && c0 < s.cin && o >= 0 && o < span) {
      // 3x3: o = (ra * wq + col) * n + i; 1x1: o = (i * rch + ra) * w + col
      const int per = s.halo ? s.n : s.rch * s.w;
      const int i0 = o / per, r0 = o - i0 * per;
      const int site = s.halo ? i0 : r0, i = s.halo ? r0 : i0;
      const int ra = site / s.wq, col = site - ra * s.wq;
      const int row = k * s.rch - s.halo + ra;
      if (col < s.w && (unsigned)row < (unsigned)s.h) {
        src.template fetch<8>(((size_t)i * s.h + row) * s.w + col, c0,
                              raw[j]);
        live |= 1u << j;
      }
    }
  }
  // the chunk's scale (int8) while the loads are in flight
  dst.begin(k, s);
#pragma unroll
  for (int j = 0; j < FWD_PRE_U; ++j) {
    const int u = u0 + 256 * j;
    if (u >= units) break;
    const int c0 = 8 * (u % groups);
    typename Out::Unit q{};
    if (live >> j & 1u) {
      float v[8];
      src.template value<8>(raw[j], c0, v);
      q = dst.pack(v);
    }
    out[u] = q;
  }
}

// --- the int8 weight gradient -----------------------------------------------

// Where ops/cuda/bneck_nv_train.py wgrad_int8_layout puts one operand's
// positions: chunk k's slab row of channel ch is len bytes at (k * c + ch)
// * len; past guard zero bytes, slab row ra (image row k * rch - halo + ra),
// column col (< wq; col == w is zero) and image i (< n16; i >= n is zero)
// sit at (ra * wq + col) * n16 + i; the rest of the row is zero.
struct SlabGeo {
  int n, h, w, rch, halo;
  int n16, wq, guard;
  int len;  // bytes of a slab row
  int c;    // channels
};

constexpr int PRE_CB = 64;    // channels a prepass block
constexpr int PRE_POS = 128;  // slab row bytes (positions) a prepass block

// One prepass block: PRE_CB channels x PRE_POS positions of one chunk's
// slab rows (tile id -> (chunk, position group, channel group), channel
// group fastest, so blocks running together read whole NHWC positions).
// Thread (cv, iq) reads the 16-byte channel vector cv of four consecutive
// positions (four images at one row and column), reduces the chunk's
// scale from the row maxima while those loads are in flight, runs the
// prologue or the fold in f32 (Src::value, the gather's rounding points),
// quantizes at the chunk's scale and packs each channel's four positions
// into one 32-bit word of the shared transpose; then each thread writes
// 16-byte runs of 16 positions of one channel. Positions outside the
// image (halo rows past its edges, the zero column, pad images, the
// guards and the K tail) are zero.
template <typename Src>
__device__ __forceinline__ void slab_tile(
    const Src& src, const float* __restrict__ rowmax,
    signed char* __restrict__ slab, const SlabGeo& s, int tile,
    uint32_t (*words)[PRE_POS / 4 + 1]) {
  const int ut = (s.len + PRE_POS - 1) / PRE_POS;
  const int cgs = (s.c + PRE_CB - 1) / PRE_CB;
  const int cg = tile % cgs;
  const int u = tile / cgs % ut;
  const int k = tile / cgs / ut;
  const int cv = threadIdx.x % 8, iq = threadIdx.x / 8;
  const int c0 = cg * PRE_CB + 8 * cv;
  const int o = u * PRE_POS + 4 * iq - s.guard;  // past the front guard
  const int span = (s.rch + 2 * s.halo) * s.wq * s.n16;
  int live = 0;  // positions of the thread's four inside the image
  Raw<8> raw[4];
  if (c0 < s.c && o >= 0 && o < span) {
    const int site = o / s.n16, i0 = o - site * s.n16;
    const int ra = site / s.wq, col = site - ra * s.wq;
    const int row = k * s.rch - s.halo + ra;
    if (col < s.w && (unsigned)row < (unsigned)s.h) live = min(4, s.n - i0);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < live)
        src.template fetch<8>(((size_t)(i0 + e) * s.h + row) * s.w + col,
                              c0, raw[e]);
  }
  // the chunk's scale while the loads are in flight
  const float inv = inv_of(chunk_amax(rowmax, k, s.rch, s.halo, s.h));
  float v[4][8] = {};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < live) src.template value<8>(raw[e], c0, v[e]);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    words[8 * cv + j][iq] =
        pack4(__fmul_rn(v[0][j], inv), __fmul_rn(v[1][j], inv),
              __fmul_rn(v[2][j], inv), __fmul_rn(v[3][j], inv));
  __syncthreads();
  constexpr int RUNS = PRE_POS / 16;  // 16-byte runs of a channel's row
#pragma unroll
  for (int r = 0; r < PRE_CB * RUNS / 256; ++r) {
    const int idx = threadIdx.x + 256 * r;
    const int ch = idx / RUNS, run = idx % RUNS;
    const int cc = cg * PRE_CB + ch;
    const int ob = u * PRE_POS + run * 16;
    if (cc < s.c && ob < s.len)
      *reinterpret_cast<uint4*>(slab + ((size_t)k * s.c + cc) * s.len + ob) =
          make_uint4(words[ch][4 * run], words[ch][4 * run + 1],
                     words[ch][4 * run + 2], words[ch][4 * run + 3]);
  }
}

// The slabs of every chunk, a's (tiles [0, tiles_a)) then g's, one launch.
// A block loads, quantizes and stores in turn, so three blocks an SM keep
// the loads of one in flight while the others work.
__global__ void __launch_bounds__(256, 3)
nvt_wgrad_pre_kernel(Act act, Cot cot, const float* __restrict__ rowmax_a,
                     const float* __restrict__ rowmax_g,
                     signed char* __restrict__ a_slab,
                     signed char* __restrict__ g_slab, SlabGeo sa,
                     SlabGeo sg, int tiles_a) {
  __shared__ uint32_t words[PRE_CB][PRE_POS / 4 + 1];
  if ((int)blockIdx.x < tiles_a)
    slab_tile(act, rowmax_a, a_slab, sa, blockIdx.x, words);
  else
    slab_tile(cot, rowmax_g, g_slab, sg, blockIdx.x - tiles_a, words);
}

// dW[i] = sum over chunks k in order of f32(S_k[i]) * ts_k, S_k[i] the
// exact s32 sum of chunk k's split tiles (any order: integers) and ts_k =
// (amax_a * amax_g) * f32(1/127^2), amax_a over the chunk's rows (+ halo)
// of |a|; four consecutive elements a thread (mn % 4 == 0). Block (32, 8)
// as wgrad_staged_sum_kernel's: the 8 rows of threads take the chunks in
// turn (independent loads in flight), row 0 adds them in chunk order,
// SUM_WIN chunks at a time.
__global__ void __launch_bounds__(256)
nvt_wgrad_sum_kernel(const int4* __restrict__ part,
                     const float* __restrict__ rowmax_a,
                     const float* __restrict__ rowmax_g,
                     float4* __restrict__ out, long mn4, int chunks,
                     int splits, int h, int rch, int halo_a) {
  constexpr int WIN = wgrad_staged::SUM_WIN;
  __shared__ float4 cs[WIN][32];
  const int x = threadIdx.x, y = threadIdx.y;
  const long i = (long)blockIdx.x * 32 + x;
  const bool live = i < mn4;
  float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < chunks; k0 += WIN) {
    const int kn = min(WIN, chunks - k0);
    if (live)
      for (int k = y; k < kn; k += 8) {
        const int chunk = k0 + k;
        const int4* src = part + (size_t)chunk * splits * mn4 + i;
        int4 c = src[0];
#pragma unroll 4
        for (int sp = 1; sp < splits; ++sp) {
          const int4 e = src[(size_t)sp * mn4];
          c.x += e.x;
          c.y += e.y;
          c.z += e.z;
          c.w += e.w;
        }
        const float ts = __fmul_rn(
            __fmul_rn(chunk_amax(rowmax_a, chunk, rch, halo_a, h),
                      chunk_amax(rowmax_g, chunk, rch, 0, h)),
            common::kInv16129);
        cs[k][x] = make_float4(__fmul_rn(__int2float_rn(c.x), ts),
                               __fmul_rn(__int2float_rn(c.y), ts),
                               __fmul_rn(__int2float_rn(c.z), ts),
                               __fmul_rn(__int2float_rn(c.w), ts));
      }
    __syncthreads();
    if (y == 0 && live)
      for (int k = 0; k < kn; ++k)
        d = k0 + k == 0 ? cs[k][x] : wgrad_staged::add4(d, cs[k][x]);
    __syncthreads();
  }
  if (y == 0 && live) out[i] = d;
}

// --- the bf16 weight gradient's operands -----------------------------------

// a_b = bf16(a) (none in identity mode, where a is x itself) and g_b =
// bf16(g), NHWC, each 8-channel vector once: 16-byte loads, the gather's
// f32 prologue or fold (Act::value, Cot::value), one rounding, a 16-byte
// store. Units [0, units_a) are a's vectors, the rest g's.
__global__ void __launch_bounds__(256)
nvt_wgrad_pre_bf16_kernel(Act act, Cot cot, bf16* __restrict__ a_b,
                          bf16* __restrict__ g_b, long units_a,
                          long units_g) {
  for (long u = (long)blockIdx.x * blockDim.x + threadIdx.x;
       u < units_a + units_g; u += (long)gridDim.x * blockDim.x) {
    const bool is_a = u < units_a;
    const long e = 8 * (is_a ? u : u - units_a);  // element offset
    const int c = is_a ? act.c : cot.c;
    const size_t p = e / c;
    const int c0 = (int)(e - (long)p * c);
    Raw<8> raw;
    float v[8];
    if (is_a) {
      act.fetch<8>(p, c0, raw);
      act.value<8>(raw, c0, v);
    } else {
      cot.fetch<8>(p, c0, raw);
      cot.value<8>(raw, c0, v);
    }
    uint4 out;
    bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = __float2bfloat16_rn(v[k]);
    *reinterpret_cast<uint4*>((is_a ? a_b : g_b) + e) = out;
  }
}

// --- sums across blocks -----------------------------------------------------

// out[i] = sum over k < j of part[k][i] in a fixed tree: 16 strided
// partial sums per column, then those in order.
__global__ void nvt_sum_kernel(const float* __restrict__ part,
                               float* __restrict__ out, int j, int m) {
  __shared__ float red[16][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (col < m)
    for (int k = threadIdx.y; k < j; k += 16)
      s = __fadd_rn(s, part[(size_t)k * m + col]);
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < m) {
    float t = red[0][threadIdx.x];
    for (int y = 1; y < 16; ++y) t = __fadd_rn(t, red[y][threadIdx.x]);
    out[col] = t;
  }
}

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

// nvt_fwd_pre_kernel over every chunk's slab of the layout g
template <typename Src, typename Out>
int fwd_pre_launch(const Src& src, const Out& dst, const FwdSlabGeo& g,
                   cudaStream_t stream) {
  const long units = (long)g.slab_len * (g.cp / 8);  // a chunk's
  if (units >= (1L << 31) || g.rch < 1 || g.h % g.rch)
    return static_cast<int>(cudaErrorInvalidValue);
  const long per = (units + 256 * FWD_PRE_U - 1) / (256 * FWD_PRE_U);
  nvt_fwd_pre_kernel<<<dim3((unsigned)per, g.h / g.rch), 256, 0, stream>>>(
      src, dst, g);
  return static_cast<int>(cudaGetLastError());
}

// the tile sums of the int8 and the bf16 input gradient (tags of their
// own, so that a profile can tell whose sum it is)
struct NvtDgradSum {};
struct NvtDgradSumBf16 {};

template <typename T>
const T* in(const void* p) {
  return static_cast<const T*>(p);
}

Act act_of(const void* x, const void* res, const void* s, const void* t,
           int c, int mode) {
  return Act{in<bf16>(x), in<bf16>(res), in<float>(s), in<float>(t), c,
             mode};
}

Cot cot_of(const void* dy, const void* y, const void* dzsum,
           const void* dzssq, int c) {
  return Cot{in<bf16>(dy), in<bf16>(y), in<float>(dzsum), in<float>(dzssq),
             c};
}

dim3 conv_grid(int m, int nout) {
  return dim3((m + BM - 1) / BM, (nout + BN - 1) / BN);
}

}  // namespace

extern "C" {

// Every channel count a multiple of 8; pointers 16-byte aligned; tensors
// contiguous. mode: 0 identity, 1 affine, 2 entry. Each returns the
// launch's cudaError_t.

// rowmax [h] f32, zeroed by the caller, <- max |a| per image row of
// x [n, h, w, c] bf16 (res [n, h, w, c] in entry mode, s/t [c] f32 unless
// identity); copy [n, h, w, c] bf16 = bf16(a) or null.
int nvt_rowmax_act_launch(const void* x, const void* res, const void* s,
                          const void* t, int mode, void* copy, void* rowmax,
                          int n, int h, int w, int c, int slices,
                          void* stream) {
  nvt_rowmax_kernel<<<dim3(h, slices), 256, 0, as_stream(stream)>>>(
      act_of(x, res, s, t, c, mode), n, h, w, c, static_cast<bf16*>(copy),
      static_cast<float*>(rowmax));
  return static_cast<int>(cudaGetLastError());
}

// rowmax [h] <- max |g| per image row, g = fma(2y, dzssq, dy + dzsum).
int nvt_rowmax_cot_launch(const void* dy, const void* y, const void* dzsum,
                          const void* dzssq, void* rowmax, int n, int h,
                          int w, int c, int slices, void* stream) {
  nvt_rowmax_kernel<<<dim3(h, slices), 256, 0, as_stream(stream)>>>(
      cot_of(dy, y, dzsum, dzssq, c), n, h, w, c, nullptr,
      static_cast<float*>(rowmax));
  return static_cast<int>(cudaGetLastError());
}

// The int8 forward, three launches after the row maxima. nvt_fwd_pre: slab
// [h / rch][slab_len][cp] int8 <- the activation (from x/res/s/t), each
// chunk's quantized at its scale (rowmax [h] of |a|), in the layout (halo,
// cp, wq, guard, slab_len) of ops/cuda/bneck_nv_train.py fwd_int8_layout.
int nvt_fwd_pre_launch(const void* x, const void* res, const void* s,
                       const void* t, int mode, const void* rowmax,
                       void* slab, int n, int h, int w, int cin, int rch,
                       int halo, int cp, int wq, int guard, int slab_len,
                       void* stream) {
  return fwd_pre_launch(act_of(x, res, s, t, cin, mode),
                        CodesOut{static_cast<signed char*>(slab),
                                 in<float>(rowmax), 0.f},
                        FwdSlabGeo{n, h, w, cin, rch, halo, cp, wq, guard,
                                   slab_len},
                        as_stream(stream));
}

// nvt_fwd_s8: y [n, h, w, cout] bf16 and part [h / rch * tiles][2 * cout]
// f32 (each M tile's sums of y and y^2) <- the slab's products with wp
// [cout][taps * cp] int8 (pad channels zero), a read at shift[tap] (host
// memory, taps positions), dequantized by ws [cout] and the chunk's scale
// from rowmax, on (128, bn) tiles with K steps of bk bytes.
int nvt_fwd_s8_launch(const void* slab, const void* wp, const void* ws,
                      const void* rowmax, void* y, void* part,
                      const int* shift, int n, int h, int w, int cout,
                      int taps, int rch, int cp, int wq, int tiles,
                      int slab_len, int bn, int bk, void* stream) {
  // the 3x3's shifts are shift[0] + dy * row + dx * col
  const int row = taps == 9 ? shift[3] - shift[0] : 0;
  const int col = taps == 9 ? shift[1] - shift[0] : 0;
  if (taps != 1 && taps != 9) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < taps; ++i)
    if (shift[i] != shift[0] + i / 3 * row + i % 3 * col)
      return static_cast<int>(cudaErrorInvalidValue);
  const fwd_staged_s8::Args args{
      in<signed char>(slab), in<signed char>(wp), in<float>(ws),
      in<float>(rowmax), static_cast<bf16*>(y), static_cast<float*>(part), n,
      h, w, cout, taps, rch, taps == 9 ? 1 : 0, cp, wq, tiles, slab_len,
      shift[0], row, col};
  return static_cast<int>(
      fwd_staged_s8::launch(args, h / rch, bn, bk, as_stream(stream)));
}

// The bf16 body: y [n, h, w, cout] bf16 and part [ceil(n*h*w / 128)][2 *
// cout] f32 (the per-block sums of y and y^2), and in entry mode (1x1)
// x_res [n, h, w, cin] = bf16(a), from wb [cout][taps * cin] bf16.
int nvt_fwd_bf16_launch(const void* x, const void* res, const void* s,
                        const void* t, int mode, const void* wb, void* y,
                        void* part, void* x_res, int n, int h, int w, int cin,
                        int cout, int taps, void* stream) {
  FwdArgs args{act_of(x, res, s, t, cin, mode), wb,
               static_cast<bf16*>(y), static_cast<float*>(part),
               static_cast<bf16*>(x_res), ConvGeo{n, h, w, cin, taps, cout}};
  nvt_fwd_kernel<bf16><<<conv_grid(n * h * w, cout), THREADS, 0,
                         as_stream(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// The int8 input gradient, four launches after the row maxima of |g|
// (nvt_rowmax_cot). nvt_dgrad_pre: slab [h / rch][slab_len][cp] int8 <-
// the cotangent g = fma(2y, dzssq, dy + dzsum) (dy/y [n, h, w, cout] bf16,
// dzsum/dzssq [cout] f32), each chunk's quantized at its scale (rowmax [h]
// of |g|), in the layout (halo, cp, wq, guard, slab_len) of
// ops/cuda/bneck_nv_train.py fwd_int8_layout at Cin = cout.
int nvt_dgrad_pre_launch(const void* dy, const void* y, const void* dzsum,
                         const void* dzssq, const void* rowmax, void* slab,
                         int n, int h, int w, int cout, int rch, int halo,
                         int cp, int wq, int guard, int slab_len,
                         void* stream) {
  return fwd_pre_launch(cot_of(dy, y, dzsum, dzssq, cout),
                        CodesOut{static_cast<signed char*>(slab),
                                 in<float>(rowmax), 0.f},
                        FwdSlabGeo{n, h, w, cout, rch, halo, cp, wq, guard,
                                   slab_len},
                        as_stream(stream));
}

// nvt_dgrad_s8: dx [n, h, w, cin] bf16 (dres likewise in entry mode; part
// [h / rch * tiles][2 * cin] f32, each M tile's sums of du * x and du,
// unless identity) <- the slab's products with wp [cin][taps * cp] int8
// (forward tap coordinates, pad channels zero), the walk's tap t reading
// the slab at shift[t] (host memory, taps positions: the layout's shifts
// mirrored), dequantized by ws_in [cin] and the chunk's scale from rowmax,
// then the prologue's backward from x/res/dxout [n, h, w, cin] and s/t
// [cin], on (128, bn) tiles.
int nvt_dgrad_s8_launch(const void* slab, const void* wp, const void* ws_in,
                        const void* rowmax, const void* x, const void* res,
                        const void* dxout, const void* s, const void* t,
                        int mode, void* dx, void* dres, void* part,
                        const int* shift, int n, int h, int w, int cin,
                        int cp, int taps, int rch, int wq, int tiles,
                        int slab_len, int bn, void* stream) {
  if ((taps != 1 && taps != 9) || rch < 1 || h % rch)
    return static_cast<int>(cudaErrorInvalidValue);
  const int halo = taps == 9 ? 1 : 0;
  nv_dgrad_wgmma_s8::Args args{
      in<float>(ws_in), in<float>(rowmax), in<bf16>(x), in<bf16>(res),
      in<bf16>(dxout), in<float>(s), in<float>(t), static_cast<bf16*>(dx),
      static_cast<bf16*>(dres), static_cast<float*>(part), {}, cin, cp,
      taps, tiles, slab_len, mode, {}};
  args.rows.n = n;
  args.rows.h = h;
  args.rows.w = w;
  args.rows.rch = rch;
  args.rows.halo = halo;
  args.rows.wq = wq;
  for (int i = 0; i < taps; ++i) args.shift[i] = shift[i];
  return static_cast<int>(nv_dgrad_wgmma_s8::launch(
      slab, wp, args, h / rch, bn, as_stream(stream)));
}

// nvt_dgrad_sum: out [m] f32 = the tiles' sums of part [tiles][m] in
// common::tile_sum's fixed order (d(s) then d(t)).
int nvt_dgrad_sum_launch(const void* part, void* out, int tiles, int m,
                         void* stream) {
  return common::tile_sum<NvtDgradSum>(in<float>(part),
                                       static_cast<float*>(out), tiles, m,
                                       as_stream(stream));
}

// The bf16 input gradient, three launches. nvt_dgrad_pre_bf16: slab
// [slab_len][cp] bf16 <- bf16(g), g = fma(2y, dzssq, dy + dzsum) (dy/y [n,
// h, w, cout] bf16, dzsum/dzssq [cout] f32), in the layout (halo, cp, wq,
// guard, slab_len) of ops/cuda/bneck_nv_train.py fwd_int8_layout at Cin =
// cout and one chunk of h rows.
int nvt_dgrad_pre_bf16_launch(const void* dy, const void* y,
                              const void* dzsum, const void* dzssq,
                              void* slab, int n, int h, int w, int cout,
                              int halo, int cp, int wq, int guard,
                              int slab_len, void* stream) {
  return fwd_pre_launch(cot_of(dy, y, dzsum, dzssq, cout),
                        Bf16Out{static_cast<bf16*>(slab)},
                        FwdSlabGeo{n, h, w, cout, h, halo, cp, wq, guard,
                                   slab_len},
                        as_stream(stream));
}

// nvt_dgrad_bf16: dx [n, h, w, cin] bf16 (dres likewise in entry mode;
// part [tiles][2 * cin] f32, each M tile's sums of du * x and du, unless
// identity) <- the slab's f32 products with wb [cin][taps * cp] bf16
// (forward tap coordinates, pad channels zero), the walk's tap t at the
// mirror of forward tap t (guard + ((2 - t / 3) * wq + 1 - t % 3) * n for
// the 3x3), dx_res added in entry mode, then the prologue's backward from
// x/res/dxout [n, h, w, cin] and s/t [cin], on (128, bn) tiles.
int nvt_dgrad_bf16_launch(const void* slab, const void* wb, const void* x,
                          const void* res, const void* dxout, const void* s,
                          const void* t, int mode, void* dx, void* dres,
                          void* part, int n, int h, int w, int cin, int cp,
                          int taps, int wq, int guard, int tiles,
                          int slab_len, int bn, void* stream) {
  if (taps != 1 && taps != 9) return static_cast<int>(cudaErrorInvalidValue);
  nv_dgrad_wgmma_bf16::Args args{};
  args.gemm.slab = in<bf16>(slab);
  args.gemm.w = in<bf16>(wb);
  args.gemm.cin = cp;
  args.gemm.cout = cin;
  args.gemm.guard = guard;
  args.x = in<bf16>(x);
  args.res = in<bf16>(res);
  args.dxout = in<bf16>(dxout);
  args.s = in<float>(s);
  args.t = in<float>(t);
  args.dx = static_cast<bf16*>(dx);
  args.dres = static_cast<bf16*>(dres);
  args.part = static_cast<float*>(part);
  args.rows.n = n;
  args.rows.h = h;
  args.rows.w = w;
  args.rows.rch = h;
  args.rows.halo = taps == 9 ? 1 : 0;
  args.rows.wq = wq;
  args.cin = cin;
  args.taps = taps;
  args.tiles = tiles;
  args.mode = mode;
  args.mirror = taps == 9 ? nv_dgrad_wgmma_bf16::MirrorTaps{wq * n, n}
                          : nv_dgrad_wgmma_bf16::MirrorTaps{0, 0};
  return static_cast<int>(nv_dgrad_wgmma_bf16::launch(
      args, slab_len, bn, as_stream(stream)));
}

// nvt_dgrad_bf16_sum: out [m] f32 = the tiles' sums of part [tiles][m] in
// common::tile_sum's fixed order (d(s) then d(t)).
int nvt_dgrad_bf16_sum_launch(const void* part, void* out, int tiles, int m,
                              void* stream) {
  return common::tile_sum<NvtDgradSumBf16>(in<float>(part),
                                           static_cast<float*>(out), tiles,
                                           m, as_stream(stream));
}

// The weight gradient, three launches. nvt_wgrad_pre: a_slab [h / rch]
// [cin][la] and g_slab [h / rch][cout][lg] int8 <- the activation (from
// x/res/s/t as the forward computes it) and the cotangent (from
// dy/y/dzsum/dzssq), each chunk's quantized at its scale (rowmax_a /
// rowmax_g [h] their row absmaxes), in the layout (halo, n16, wq, guard,
// la, lg) of ops/cuda/bneck_nv_train.py wgrad_int8_layout.
int nvt_wgrad_pre_launch(const void* x, const void* res, const void* s,
                         const void* t, int mode, const void* rowmax_a,
                         const void* dy, const void* y, const void* dzsum,
                         const void* dzssq, const void* rowmax_g,
                         void* a_slab, void* g_slab, int n, int h, int w,
                         int cin, int cout, int rch, int halo, int n16,
                         int wq, int guard, int la, int lg, void* stream) {
  const SlabGeo sa{n, h, w, rch, halo, n16, wq, guard, la, cin};
  const SlabGeo sg{n, h, w, rch, 0, n16, wq, 0, lg, cout};
  const long chunks = h / rch;
  const long tiles_a = chunks * ((cin + PRE_CB - 1) / PRE_CB) *
                       ((la + PRE_POS - 1) / PRE_POS);
  const long tiles_g = chunks * ((cout + PRE_CB - 1) / PRE_CB) *
                       ((lg + PRE_POS - 1) / PRE_POS);
  nvt_wgrad_pre_kernel<<<(unsigned)(tiles_a + tiles_g), 256, 0,
                         as_stream(stream)>>>(
      act_of(x, res, s, t, cin, mode), cot_of(dy, y, dzsum, dzssq, cout),
      in<float>(rowmax_a), in<float>(rowmax_g),
      static_cast<signed char*>(a_slab), static_cast<signed char*>(g_slab),
      sa, sg, (int)tiles_a);
  return static_cast<int>(cudaGetLastError());
}

// nvt_wgrad_s8: part [h / rch][splits][taps * cin][cout] s32 <- the
// per-(chunk, split) products of the slabs, a read at shift[tap] (host
// memory, taps values), on a (bm, bn) tile, each split ``per`` of the
// chunk's ``steps`` K steps of bk positions (the plan of
// ops/cuda/bneck_nv_train.py wgrad_int8_plan). nvt_wgrad_sum: dW [taps *
// cin][cout] f32 (rows (dy, dx, ci)) <- the chunks' scaled sums, in chunk
// order.
int nvt_wgrad_s8_launch(const void* a_slab, const void* g_slab, void* part,
                        const int* shift, int cin, int cout, int taps, int la,
                        int lg, int chunks, int bm, int bn, int bk, int steps,
                        int per, int splits, void* stream) {
  // the 3x3's shifts are shift[0] + dy * row + dx * col
  const int row = taps == 9 ? shift[3] - shift[0] : 0;
  const int col = taps == 9 ? shift[1] - shift[0] : 0;
  if (taps != 1 && taps != 9) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < taps; ++i)
    if (shift[i] != shift[0] + i / 3 * row + i % 3 * col)
      return static_cast<int>(cudaErrorInvalidValue);
  const wgrad_staged_s8::Args args{
      in<signed char>(a_slab), in<signed char>(g_slab),
      static_cast<int*>(part), cin, cout, taps, la, lg, steps, per, splits,
      shift[0], row, col};
  return static_cast<int>(
      wgrad_staged_s8::launch(args, chunks, bm, bn, bk, as_stream(stream)));
}

int nvt_wgrad_sum_launch(const void* part, const void* rowmax_a,
                         const void* rowmax_g, void* dw, int h, int cin,
                         int cout, int taps, int rch, int splits,
                         void* stream) {
  const long mn4 = (long)taps * cin * cout / 4;
  nvt_wgrad_sum_kernel<<<(unsigned)((mn4 + 31) / 32), dim3(32, 8), 0,
                         as_stream(stream)>>>(
      static_cast<const int4*>(part), in<float>(rowmax_a),
      in<float>(rowmax_g), static_cast<float4*>(dw), mn4, h / rch, splits, h,
      rch, taps == 9 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 body, three launches. nvt_wgrad_pre_bf16: a_b [n, h, w, cin]
// bf16 = bf16(a) from x/res/s/t (a_b unused, may be null, in identity mode),
// g_b [n, h, w, cout] bf16 = bf16(g) from dy/y/dzsum/dzssq.
int nvt_wgrad_pre_bf16_launch(const void* x, const void* res, const void* s,
                              const void* t, int mode, const void* dy,
                              const void* y, const void* dzsum,
                              const void* dzssq, void* a_b, void* g_b, int n,
                              int h, int w, int cin, int cout,
                              void* stream) {
  const long p = (long)n * h * w;
  const long units_a = mode == IDENTITY ? 0 : p * cin / 8;
  const long units = units_a + p * cout / 8;
  const long blocks = (units + 255) / 256 < 132L * 16 ? (units + 255) / 256
                                                      : 132L * 16;
  nvt_wgrad_pre_bf16_kernel<<<(unsigned)blocks, 256, 0, as_stream(stream)>>>(
      act_of(x, res, s, t, cin, mode), cot_of(dy, y, dzsum, dzssq, cout),
      static_cast<bf16*>(a_b), static_cast<bf16*>(g_b), units_a,
      units - units_a);
  return static_cast<int>(cudaGetLastError());
}

// nvt_wgrad_staged_bf16: part [h / rch][splits][taps * cin][cout] f32 <- the
// per-(chunk, split) products of a_b (x itself in identity mode) and g_b on
// a (bm, bn) tile, each split ``per`` K steps of bk positions (the plan of
// ops/cuda/bneck_nv_train.py wgrad_bf16_plan). nvt_wgrad_staged_bf16_sum:
// dW [taps * cin][cout] f32 <- per chunk its splits in order, the chunks in
// order.
int nvt_wgrad_staged_bf16_launch(const void* a_b, const void* g_b, void* part,
                                 int n, int h, int w, int cin, int cout,
                                 int taps, int rch, int bm, int bn, int bk,
                                 int per, int splits, void* stream) {
  const wgrad_staged::Args args{in<bf16>(a_b), in<bf16>(g_b),
                                static_cast<float*>(part), n, h, w, cin,
                                cout, taps, rch, per, splits};
  return static_cast<int>(
      wgrad_staged::launch(args, bm, bn, bk, as_stream(stream)));
}

int nvt_wgrad_staged_bf16_sum_launch(const void* part, void* dw, int h,
                                     int cin, int cout, int taps, int rch,
                                     int splits, void* stream) {
  return static_cast<int>(wgrad_staged::launch_sum(
      in<float>(part), static_cast<float*>(dw), (long)taps * cin * cout,
      h / rch, splits, as_stream(stream)));
}

// out[i] = sum over k < j of part[k][i] (part [j][m] f32), fixed tree.
int nvt_sum_launch(const void* part, void* out, int j, int m, void* stream) {
  nvt_sum_kernel<<<(m + 31) / 32, dim3(32, 16), 0, as_stream(stream)>>>(
      in<float>(part), static_cast<float*>(out), j, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
