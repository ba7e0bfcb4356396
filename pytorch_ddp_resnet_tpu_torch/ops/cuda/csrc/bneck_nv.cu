// Int8 post-act bottleneck blocks for serving, written for Hopper
// (sm_90a), bound to Python through a plain C interface
// (ops/cuda/bneck_nv.py loads this file's shared library with ctypes).
//
// What they replace (pytorch_ddp_resnet_tpu/ops/pallas/bneck_nv.py):
//   bneck_block_nv       <- bneck_block_nv, body _nv_kernel (identity
//                           block)
//   bneck_transition_nv  <- bneck_transition_nv, body
//                           _nv_transition_kernel with _sel_stride2
//                           (stride 1 or 2, 1x1 projection shortcut)
// Each block is three launches of one int8 GEMM kernel template:
//   conv1: a1 = requant(x[M, Cin] . w1[W, Cin]^T, p1, q1), every input
//          position;
//   conv2: a2 = requant(conv3x3(a1, w2, stride, padding 1), p2, q2), an
//          implicit GEMM whose gather zero-fills positions outside the
//          image (conv2's padding is zeros of a1, not requant of zero);
//   out:   y = acc3*p3 + q3 (acc3 = a2 . w3^T), then relu(x*r + y) for
//          the identity block or relu(accP*pp + y) for the transition
//          (accP = x[::s, ::s] . wp^T, a second contraction in the same
//          kernel), emitted as int8 (the next block's carrier) or bf16
//          (the run's exit).
// The carrier is int8 NHWC [N, h, w, C] with no border columns; the TPU
// kernel's NV layout, halo slivers, row-parity selects and tile pickers
// serve Mosaic's layout and VMEM and are not carried over.
//
// What bounds them on an H100: at ResNet-50's stage shapes (batch 128) a
// block is 2*N*(h*w*Cin*W + oh*ow*(9*W^2 + W*Cout [+ Cin*Cout])) int8
// operations, 0.05-0.20 ms at 1979 TOP/s, against 1-2 B per position and
// channel of int8 carrier in and out, 0.01-0.06 ms at 3.35 TB/s: the
// tensor cores bound the block, as they bind a GEMM of these sizes.
//
// What the design does about it: the products run on the tensor cores
// (ldmatrix + mma.sync m16n8k32 s8, s32 accumulators in registers), fed
// by a 4-stage cp.async pipeline of 128x32 and 64x32 byte tiles, and every
// epilogue runs on the accumulators in registers, so no s32 accumulator
// reaches device memory. What is left on the table (later work): a1 and
// a2 make one int8 round trip each through device memory (the TPU kernel
// keeps them in VMEM and recomputes conv1 on the halo rows); wgmma, TMA
// and larger tiles; the stage-1 conv1 re-reads its input once per 64
// output channels.
//
// Rounding follows the reference (tests/test_torch_bneck_nv.py pins each
// point): s32 -> f32 with __int2float_rn; acc*p + q, x*r + y and
// accP*pp + y are single FMAs (__fmaf_rn), as XLA contracts them; round
// half to even (rintf) and clip to +-127; the bf16 exit with
// __float2bfloat16_rn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"  // ldmatrix_x4, mma_step, smem_addr, quant_s8

using conv3x3::ldmatrix_x4;
using conv3x3::mma_step;
using conv3x3::quant_s8;
using conv3x3::smem_addr;

namespace {

constexpr int BM = 128;       // output positions per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // contraction bytes per pipeline stage
constexpr int ROW = BK + 16;  // smem row stride: conflict-free ldmatrix
constexpr int STAGES = 4;
constexpr int THREADS = 256;  // 8 warps: 4 along positions x 2 along channels
constexpr int A_BYTES = BM * ROW;
constexpr int STAGE_BYTES = (BM + BN) * ROW;

enum AMode { DENSE = 0, CONV3X3 = 1, SUBSAMPLE = 2 };

// The A operand of one contraction: row m of the GEMM is output position
// m of an [nimg, oh, ow] plane; K is the contraction length in bytes.
struct AOp {
  const signed char* ptr;
  int k;       // DENSE: row length; CONV3X3: 9*c; SUBSAMPLE: c
  int c;       // channels of the NHWC source (CONV3X3, SUBSAMPLE)
  int h, w;    // source plane
  int oh, ow;  // output plane
  int stride;
};

__device__ __forceinline__ void cp_async16(unsigned char* dst,
                                           const void* src, bool valid) {
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One thread's 16-byte piece of the A tile: row tid / 2, half tid % 2.
template <int MODE>
struct ALoader {
  const signed char* base;  // DENSE / SUBSAMPLE: the row's first byte
  int img, oy, ox;          // CONV3X3: the output position
  bool row_ok;

  __device__ ALoader(const AOp& a, int m, int M, int half) {
    row_ok = m < M;
    const int mm = row_ok ? m : 0;
    const int plane = a.oh * a.ow;
    img = mm / plane;
    const int rem = mm - img * plane;
    oy = rem / a.ow;
    ox = rem - oy * a.ow;
    if (MODE == DENSE) {
      base = a.ptr + (size_t)mm * a.k + half * 16;
    } else if (MODE == SUBSAMPLE) {
      base = a.ptr +
             ((size_t)(img * a.h + oy * a.stride) * a.w + ox * a.stride) *
                 a.c +
             half * 16;
    } else {
      base = a.ptr + half * 16;
    }
  }

  __device__ __forceinline__ const signed char* src(const AOp& a, int k0,
                                                    bool& ok) const {
    if (MODE != CONV3X3) {
      ok = row_ok;
      return base + k0;
    }
    const int tap = k0 / a.c;
    const int c0 = k0 - tap * a.c;
    const int iy = oy * a.stride + tap / 3 - 1;
    const int ix = ox * a.stride + tap % 3 - 1;
    ok = row_ok && (unsigned)iy < (unsigned)a.h && (unsigned)ix < (unsigned)a.w;
    if (!ok) return a.ptr;
    return base + ((size_t)(img * a.h + iy) * a.w + ix) * a.c + c0;
  }
};

// acc[mi][ni][e] += A[m0 + 128 rows, K] . B[n0 + 64 rows, K]^T over the
// whole contraction, through the STAGES-deep cp.async ring in smem.
template <int MODE>
__device__ __forceinline__ void mainloop(int (&acc)[2][4][4],
                                         unsigned char* smem, const AOp& a,
                                         const signed char* __restrict__ b,
                                         int M, int nout, int m0, int n0) {
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp / 2;  // 32-row slice of the tile
  const int wn = warp % 2;  // 32-channel slice of the tile
  const int half = tid & 1;
  const int r = tid >> 1;
  const ALoader<MODE> al(a, m0 + r, M, half);
  const bool b_thread = r < BN;
  const bool b_ok = b_thread && n0 + r < nout;
  const signed char* b_src =
      b + (size_t)(b_ok ? n0 + r : 0) * a.k + half * 16;
  const int kt_total = a.k / BK;

  auto load = [&](int stage, int kt) {
    unsigned char* st = smem + stage * STAGE_BYTES;
    bool ok;
    const signed char* s = al.src(a, kt * BK, ok);
    cp_async16(st + r * ROW + half * 16, s, ok);
    if (b_thread)
      cp_async16(st + A_BYTES + r * ROW + half * 16, b_src + kt * BK, b_ok);
  };

  // ldmatrix lanes: A rows (two m16 tiles), B rows (two n8 pairs)
  const int q = lane / 8;
  const int j = lane % 8;
  const int a_off = (wm * 32 + (q & 1) * 8 + j) * ROW + (q >> 1) * 16;
  const int b_off = A_BYTES + (wn * 32 + (q >> 1) * 8 + j) * ROW +
                    (q & 1) * 16;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_total) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_total; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < kt_total) load(nk % STAGES, nk);
    cp_async_commit();
    const uint32_t st = smem_addr(smem + (kt % STAGES) * STAGE_BYTES);
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
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for a second contraction
}

// --- epilogues: two adjacent channels (n, n + 1) of output row m ----------

struct Requant {  // conv1 / conv2: int8 a = requant(acc, p, q)
  const float* p;
  const float* q;
  signed char* out;
  int nout;

  __device__ __forceinline__ signed char one(int acc, int n) const {
    return quant_s8(fmaxf(__fmaf_rn(__int2float_rn(acc), p[n], q[n]), 0.f));
  }
  __device__ __forceinline__ void operator()(int m, int n, int v0, int v1,
                                             int, int) const {
    char2 o;
    o.x = one(v0, n);
    o.y = one(v1, n + 1);
    *reinterpret_cast<char2*>(out + (size_t)m * nout + n) = o;
  }
};

struct BlockOut {  // conv3 + residual or projection, relu, int8 or bf16
  const float* p3;
  const float* q3;
  const signed char* x;  // identity: the block input [M, nout]
  const float* pp;       // transition: the projection dequant [nout]
  float r;
  void* out;
  int nout;
  int out_int8;

  __device__ __forceinline__ float one(int m, int n, int acc,
                                       int accp) const {
    const float y = __fmaf_rn(__int2float_rn(acc), p3[n], q3[n]);
    const float o =
        pp != nullptr
            ? __fmaf_rn(__int2float_rn(accp), pp[n], y)
            : __fmaf_rn((float)x[(size_t)m * nout + n], r, y);
    return fmaxf(o, 0.f);
  }
  __device__ __forceinline__ void operator()(int m, int n, int v0, int v1,
                                             int p0, int p1) const {
    const float o0 = one(m, n, v0, p0);
    const float o1 = one(m, n + 1, v1, p1);
    const size_t i = (size_t)m * nout + n;
    if (out_int8) {
      char2 o;
      o.x = quant_s8(o0);
      o.y = quant_s8(o1);
      *reinterpret_cast<char2*>(static_cast<signed char*>(out) + i) = o;
    } else {
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                         i) =
          __halves2bfloat162(__float2bfloat16_rn(o0),
                             __float2bfloat16_rn(o1));
    }
  }
};

// out[M, nout] = epi(A . B^T [, Ap . Bp^T]): grid (M / BM, nout / BN)
template <int MODE, bool PROJ, typename Epi>
__global__ void __launch_bounds__(THREADS)
bneck_gemm_kernel(AOp a, const signed char* __restrict__ b, AOp ap,
                  const signed char* __restrict__ bp, int M, int nout,
                  Epi epi) {
  __shared__ __align__(128) unsigned char smem[STAGES * STAGE_BYTES];
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  int acc[2][4][4] = {};
  int accp[2][4][4] = {};
  mainloop<MODE>(acc, smem, a, b, M, nout, m0, n0);
  if constexpr (PROJ)
    mainloop<SUBSAMPLE>(accp, smem, ap, bp, M, nout, m0, n0);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int t2 = (lane % 4) * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = n0 + (warp % 2) * 32 + ni * 8 + t2;
      if (n >= nout) continue;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = m0 + (warp / 2) * 32 + mi * 16 + g + hr * 8;
        if (m < M)
          epi(m, n, acc[mi][ni][2 * hr], acc[mi][ni][2 * hr + 1],
              accp[mi][ni][2 * hr], accp[mi][ni][2 * hr + 1]);
      }
    }
}

template <int MODE, bool PROJ, typename Epi>
int launch(const AOp& a, const void* b, const AOp& ap, const void* bp,
           int M, int nout, const Epi& epi, void* stream) {
  const dim3 grid((M + BM - 1) / BM, (nout + BN - 1) / BN);
  bneck_gemm_kernel<MODE, PROJ, Epi>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          a, static_cast<const signed char*>(b), ap,
          static_cast<const signed char*>(bp), M, nout, epi);
  return static_cast<int>(cudaGetLastError());
}

AOp plane(const void* ptr, int k, int c, int h, int w, int stride) {
  AOp a;
  a.ptr = static_cast<const signed char*>(ptr);
  a.k = k;
  a.c = c;
  a.h = h;
  a.w = w;
  a.stride = stride;
  a.oh = (h - 1) / stride + 1;
  a.ow = (w - 1) / stride + 1;
  return a;
}

}  // namespace

extern "C" {

// Every channel count is a multiple of 32; every pointer 16-byte aligned;
// tensors contiguous. Each returns the launch's cudaError_t.

// conv1: x [m, cin] int8, w [wdt, cin] int8, p/q [wdt] f32 -> out [m, wdt]
// int8.
int bneck_conv1_launch(const void* x, const void* w, const void* p,
                       const void* q, void* out, int m, int cin, int wdt,
                       void* stream) {
  const AOp a = plane(x, cin, cin, m, 1, 1);
  const Requant epi{static_cast<const float*>(p),
                    static_cast<const float*>(q),
                    static_cast<signed char*>(out), wdt};
  return launch<DENSE, false>(a, w, a, w, m, wdt, epi, stream);
}

// conv2: a1 [nimg, h, w, wdt] int8, w2 [wdt, 9*wdt] int8 (taps row-major
// in (dy, dx), then input channel), p/q [wdt] -> out [nimg, oh, ow, wdt]
// int8, oh = (h - 1) / stride + 1.
int bneck_conv2_launch(const void* a1, const void* w2, const void* p,
                       const void* q, void* out, int nimg, int h, int w,
                       int wdt, int stride, void* stream) {
  const AOp a = plane(a1, 9 * wdt, wdt, h, w, stride);
  const Requant epi{static_cast<const float*>(p),
                    static_cast<const float*>(q),
                    static_cast<signed char*>(out), wdt};
  return launch<CONV3X3, false>(a, w2, a, w2, nimg * a.oh * a.ow, wdt, epi,
                                stream);
}

// conv3 and the block's output: a2 [nimg, oh, ow, wdt] int8, w3 [cout,
// wdt], p3/q3 [cout]; x [nimg, h, w, cin] int8 the block input. Identity
// (wp null): cin == cout, stride 1, out = relu(x*r + y). Transition: wp
// [cout, cin] int8, pp [cout] f32, out = relu(accP*pp + y) with accP over
// x[::stride, ::stride]. out [nimg, oh, ow, cout], int8 when out_int8
// else bf16.
int bneck_out_launch(const void* a2, const void* w3, const void* p3,
                     const void* q3, const void* x, const void* wp,
                     const void* pp, float r, void* out, int nimg, int h,
                     int w, int cin, int wdt, int cout, int stride,
                     int out_int8, void* stream) {
  AOp a = plane(a2, wdt, wdt, h, w, stride);
  const AOp ap = plane(x, cin, cin, h, w, stride);
  const int m = nimg * a.oh * a.ow;
  const BlockOut epi{static_cast<const float*>(p3),
                     static_cast<const float*>(q3),
                     static_cast<const signed char*>(x),
                     static_cast<const float*>(pp), r, out, cout, out_int8};
  if (wp == nullptr) return launch<DENSE, false>(a, w3, a, w3, m, cout, epi,
                                                 stream);
  return launch<DENSE, true>(a, w3, ap, wp, m, cout, epi, stream);
}

}  // extern "C"
