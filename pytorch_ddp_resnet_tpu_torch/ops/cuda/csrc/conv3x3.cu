// Stride-1 SAME 3x3 convolutions in the channel-major layout [C, B*H*W],
// written for Hopper (sm_90a), bound to Python through a plain C interface
// (ops/cuda/conv3x3.py loads this file's shared library with ctypes).
//
// What they replace (pytorch_ddp_resnet_tpu/ops/pallas/conv.py):
//   conv3x3_bf16_launch          <- conv3x3_lanes, body _conv_kernel
//                                   (bf16 in, f32 accumulate, bf16 out; the
//                                   float calibration pass of int8 serving
//                                   and conv3x3_same's forward and dgrad)
//   conv3x3_int8_requant_pre_launch,
//   conv3x3_int8_requant_gemm_launch
//                                <- conv3x3_lanes_requant, body
//                                   _requant_kernel (s8 x s8 -> s32, then
//                                   y = acc*scale + shift (+res), relu,
//                                   int8 requantize or bf16 out, and the
//                                   dual int8 output for the next block)
//
// What bounds them on an H100: at the WRN-28-10 serving shapes (C = 160,
// 320, 640 at 32x32, 16x16, 8x8, batch 128) one launch is 60.4 G multiply-
// adds*2 against 42-126 MB of activations, so both sit near the card's
// balance point: the bf16 conv is bound by tensor-core operations
// (61 us at 989 TFLOP/s vs 25 us of bytes), the int8 conv by operations in
// its int8-out mode and by bytes once the bf16 residual, bf16 carrier and
// dual int8 output are streamed (38 us of bytes vs 31 us of int8 ops).
//
// The int8 conv (requant_wgmma_s8.cuh): a prepass lays x_q's codes into
// the fused int8 forward's padded position-major slab (every tap one row
// offset, any image width), then fwd_wgmma_s8.cuh's TMA-fed s8 wgmma
// mainloop with a requantizing epilogue in registers, each channel's run
// of lanes written in 16-byte vectors from its own lead (any N).
//
// The bf16 conv (the row-tile mainloop lives in conv3x3_rows.cuh, shared
// with fused_block.cu's int8 dgrad): an implicit GEMM, out[Cout, N] =
// W[Cout, 9*Cin] x patches[9*Cin, N], on the tensor cores (mma.sync, f32
// accumulators in registers); the patch matrix is never written, and the
// epilogue runs on the accumulator tile in shared memory. Two tilings:
//
// - Row tiles (the WRN shapes: W % 8 == 0). A block owns 64 output
//   channels x R whole image rows (64, 128 or 256 positions). For each
//   32-channel chunk it copies the rows it needs, plus one halo row above
//   and below, into shared memory once, channels innermost and with a zero
//   column on each side; every tap is then a pure address shift into that
//   tile (no masks), read with ldmatrix. The weights of all nine taps of
//   the chunk are staged beside it, so a chunk costs two barriers for nine
//   taps of tensor-core work.
// - General (any other W): the first version, kept for shapes the row
//   tiles cannot cover. Per 32-row contraction slice it gathers each
//   tap's shifted, border-masked columns from device memory element by
//   element (WMMA 16x16x16 tiles). Measured far slower (PERF.md).
//
// The TPU kernel's 640-lane tap grouping and roll-and-mask patches are MXU
// and VMEM choices and are not carried over. Not done yet for the bf16
// conv (later work): wgmma, TMA and a multi-stage shared-memory pipeline.
//
// Rounding follows the JAX reference at its rounding points (requant.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "conv3x3_rows.cuh"
#include "requant.cuh"           // PerElement (the bf16 conv's epilogue)
#include "requant_wgmma_s8.cuh"  // the int8 conv's prepass and GEMM

using namespace nvcuda;
using namespace conv3x3;

namespace {

// --- epilogues: one output element from its accumulator ----------------------

struct Bf16Out : PerElement<Bf16Out> {
  __nv_bfloat16* out;
  __device__ __forceinline__ void operator()(float acc, int, size_t idx) const {
    out[idx] = __float2bfloat16_rn(acc);
  }
};

// --- general: per-slice gather from device memory, WMMA ----------------------

constexpr int GBN = 128;       // spatial positions per block
constexpr int GCLD = GBN + 4;  // row stride of the accumulator tile

// Operand tiles are stored in 16-wide column blocks so every WMMA fragment
// starts on a 32-byte boundary for both element types:
//   A: [BK/16][BM][16] (row m, contraction k)
//   B: [GBN/16][BK][16] (contraction k, column n)
template <typename T>
struct Tiles {
  static constexpr int kABytes = BK * BM * sizeof(T);
  static constexpr int kBBytes = BK * GBN * sizeof(T);
  static constexpr int kCBytes = BM * GCLD * 4;
  static constexpr int kBytes = (kABytes + kBBytes > kCBytes)
                                    ? kABytes + kBBytes : kCBytes;
};

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ __nv_bfloat16 zero_of() {
  return __float2bfloat16_rn(0.f);
}

template <typename T, typename Epi>
__global__ void __launch_bounds__(THREADS)
conv3x3_general_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       Epi epi, int cin, int cout, int n, int h, int wi) {
  using AccT = typename Acc<T>::type;
  using V = typename Vec8<T>::type;
  __shared__ __align__(128) unsigned char smem[Tiles<T>::kBytes];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + Tiles<T>::kABytes);
  AccT* Cs = reinterpret_cast<AccT*>(smem);
  const int n0 = blockIdx.x * GBN;
  const int m0 = blockIdx.y * BM;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warp_m = warp / 4;  // 0..1 -> rows warp_m*32
  const int warp_n = warp % 4;  // 0..3 -> cols warp_n*32
  const int kdim = 9 * cin;

  // A loader: one row, 8 contiguous contraction elements per thread
  const int a_row = tid / 4;
  const int a_k = (tid % 4) * 8;
  const bool a_ok = (m0 + a_row) < cout;
  const T* a_src = w + (size_t)(m0 + a_row) * kdim + a_k;
  T* a_dst = As + ((a_k / 16) * BM + a_row) * 16 + (a_k % 16);

  // B loader: one column, rows b_r0, b_r0 + 2, ... of the 32-row slice
  const int b_col = tid % GBN;
  const int b_r0 = tid / GBN;
  const int col_n = n0 + b_col;
  const bool col_ok = col_n < n;
  const int hw = h * wi;
  const int pos = col_ok ? col_n % hw : 0;
  const int hh = pos / wi;
  const int ww = pos % wi;
  T* b_dst = Bs + ((b_col / 16) * BK + b_r0) * 16 + (b_col % 16);

  wmma::fragment<wmma::accumulator, 16, 16, 16, AccT> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], (AccT)0);

  const T zero = zero_of<T>();
  for (int tap = 0; tap < 9; ++tap) {
    const int dh = tap / 3 - 1;
    const int dw = tap % 3 - 1;
    const bool valid = col_ok && (unsigned)(hh + dh) < (unsigned)h &&
                       (unsigned)(ww + dw) < (unsigned)wi;
    const long src = (long)col_n + dh * wi + dw;
    for (int c0 = 0; c0 < cin; c0 += BK) {
      V av = {};
      if (a_ok) av = *reinterpret_cast<const V*>(a_src + tap * cin + c0);
      *reinterpret_cast<V*>(a_dst) = av;
      const T* xs = x + (size_t)(c0 + b_r0) * n + src;
#pragma unroll
      for (int r = 0; r < BK / 2; ++r)
        b_dst[r * 2 * 16] = valid ? xs[(size_t)r * 2 * n] : zero;
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(
              fa[i], As + (kk * BM + warp_m * 32 + i * 16) * 16, 16);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(
              fb[j], Bs + ((warp_n * 2 + j) * BK + kk * 16) * 16, 16);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          Cs + (warp_m * 32 + i * 16) * GCLD + warp_n * 32 + j * 16,
          acc[i][j], GCLD, wmma::mem_row_major);
  __syncthreads();
  epilogue(Cs, GCLD, GBN, m0, n0, cout, n, epi);
}

template <typename T, typename Epi>
int launch(const void* x, const void* w, const Epi& epi, int cin, int cout,
           int n, int h, int wi, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int rc = launch_row_tiles<T>(x, w, epi, cin, cout, n, h, wi, stream);
  if (rc >= 0) return rc;
  const dim3 grid((n + GBN - 1) / GBN, (cout + BM - 1) / BM);
  conv3x3_general_kernel<T, Epi><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), epi, cin, cout, n,
      h, wi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [cin, n] bf16, w [cout, 9*cin] bf16 (taps row-major in (dh, dw), then
// input channel), out [cout, n] bf16; n a multiple of h*wi. cin % 32 == 0;
// the pointers to x and w are 16-byte aligned. Returns the launch's
// cudaError_t.
int conv3x3_bf16_launch(const void* x, const void* w, void* out, int cin,
                        int cout, int n, int h, int wi, void* stream) {
  Bf16Out epi;
  epi.out = static_cast<__nv_bfloat16*>(out);
  return launch<__nv_bfloat16>(x, w, epi, cin, cout, n, h, wi, stream);
}

// The int8 conv's prepass: slab [slab_len, cin] int8 (fused_fwd_layout:
// guard = wi + 2 zero positions, per image of h x wi a zero row and a zero
// column, zeros to slab_len) from x [cin, n] int8; cin % 32 == 0, n a
// multiple of h * wi. Returns the launch's cudaError_t.
int conv3x3_int8_requant_pre_launch(const void* x, void* slab, int cin,
                                    int n, int h, int wi, long slab_len,
                                    void* stream) {
  return static_cast<int>(requant_wgmma_s8::pre_launch(
      x, slab, cin, n, h, wi, slab_len, static_cast<cudaStream_t>(stream)));
}

// The int8 conv's GEMM from the prepass's slab and w [cout, 9*cin] int8
// (taps row-major in (dh, dw), then input channel): scale/shift [cout]
// f32, res [cout, n] bf16 or null, sb/tb [cout] f32 or null (dual mode:
// out2 [cout, n] int8), out [cout, n] int8 when out_int8 else bf16; on
// `tiles` 128-row M tiles and bn-wide N tiles (160, 128 or 64).
int conv3x3_int8_requant_gemm_launch(const void* slab, const void* w,
                                     const void* scale, const void* shift,
                                     const void* res, const void* sb,
                                     const void* tb, void* out, void* out2,
                                     int cin, int cout, int n, int h, int wi,
                                     long slab_len, int tiles, int bn,
                                     int relu, int out_int8,
                                     float inv_out_scale, void* stream) {
  if (h < 1 || wi < 1 || n % (h * wi))
    return static_cast<int>(cudaErrorInvalidValue);
  requant_wgmma_s8::Args args{};
  args.scale = static_cast<const float*>(scale);
  args.shift = static_cast<const float*>(shift);
  args.res = static_cast<const __nv_bfloat16*>(res);
  args.sb = static_cast<const float*>(sb);
  args.tb = static_cast<const float*>(tb);
  args.out = out;
  args.out2 = static_cast<signed char*>(out2);
  args.cin = cin;
  args.cout = cout;
  args.n = n;
  args.b = n / (h * wi);
  args.h = h;
  args.wi = wi;
  args.relu = relu;
  args.out_int8 = out_int8;
  args.inv_out_scale = inv_out_scale;
  return static_cast<int>(requant_wgmma_s8::launch(
      slab, w, args, slab_len, tiles, bn, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
