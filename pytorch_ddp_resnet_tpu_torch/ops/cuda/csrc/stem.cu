// The stem conv emitting the channel-major layout, written for Hopper
// (sm_90a) and bound to Python through a plain C interface
// (ops/cuda/stem.py loads this file's library with ctypes).
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/stem.py,
// stem_conv_lane):
//   stem_fwd_launch    <- _fwd_call -> _fwd_kernel: 3x3 stride-1 SAME conv
//                         of x [Cin <= 8, N] bf16 to [Cout, N], f32 sums,
//                         rounded to bf16, then + bf16(bias) in bf16
//   stem_wgrad_launch  <- _wgrad_call -> _wgrad_kernel: dW [Cout, 9*Cin]
//                         and db [Cout] as f32 sums over the N positions
//   partial_sum_launch <- the sums the TPU kernel carries across its grid
//
// What bounds them on an H100: at WRN-28-10, batch 128 (N = 131,072,
// Cin = 3, Cout = 160), each moves about 42 MB (the [160, N] bf16 output
// or cotangent; x is 0.8 MB): 12.8 us at 3.35 TB/s, which is the bound
// (the 1.1 GFLOP of bf16 products take 1.1 us at the tensor cores' peak).
// This design sums in f32 on the CUDA cores, in a fixed order, so its own
// limit is that arithmetic: 17 us at the f32 rate.
//
// Design: no tensor cores (the contraction is 27 deep). Forward: a thread
// per position gathers its 9 * Cin taps once (zero where the tap leaves
// the image), then walks a slice of the output channels with the weights
// in shared memory, summing in the fixed order tap-major, channel-minor.
// Every product of two bf16 values is exact in f32, so the sum rounds
// only at the additions and its plain PyTorch version repeats it bit for
// bit. Weight gradient: a block takes 4096 positions and 4 output
// channels; each thread keeps the 4 x (9 * Cin + 1) sums of its positions
// in registers, the block reduces them with warp butterflies and then
// warp by warp, and writes them to the block's slot of a partial buffer,
// which partial_sum adds slot by slot in order (deterministic; the f32
// sums differ from the reference's only in their order).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int FWD_COS = 40;     // output channels per forward thread
constexpr int WG_POS = 4096;    // positions per weight-gradient block
constexpr int WG_COS = 4;       // output channels per weight-gradient block

// the 9 * CIN taps of position p (zero outside the image), tap-major
template <int CIN>
__device__ __forceinline__ void gather(const __nv_bfloat16* __restrict__ x,
                                       int n, int h, int wi, int p,
                                       float (&v)[9 * CIN]) {
  const int hw = h * wi;
  const int hh = (p % hw) / wi;
  const int ww = p % wi;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int sh = hh + tap / 3 - 1, sw = ww + tap % 3 - 1;
    const bool ok = sh >= 0 && sh < h && sw >= 0 && sw < wi;
    const int src = p + (tap / 3 - 1) * wi + (tap % 3 - 1);
#pragma unroll
    for (int c = 0; c < CIN; ++c)
      v[tap * CIN + c] = ok ? __bfloat162float(x[(size_t)c * n + src]) : 0.f;
  }
}

template <int CIN>
__global__ void __launch_bounds__(THREADS)
stem_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ b, __nv_bfloat16* __restrict__ y,
                int cout, int n, int h, int wi) {
  constexpr int K = 9 * CIN;
  __shared__ float ws[FWD_COS][K];
  __shared__ __nv_bfloat16 bs[FWD_COS];
  const int co0 = blockIdx.y * FWD_COS;
  const int cos = min(FWD_COS, cout - co0);
  for (int i = threadIdx.x; i < cos * K; i += THREADS)
    ws[i / K][i % K] = __bfloat162float(w[(size_t)(co0 + i / K) * K + i % K]);
  for (int i = threadIdx.x; i < cos; i += THREADS)
    bs[i] = __float2bfloat16_rn(b[co0 + i]);
  __syncthreads();
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= n) return;
  float v[K];
  gather<CIN>(x, n, h, wi, p, v);
  for (int c = 0; c < cos; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) acc = __fadd_rn(acc, __fmul_rn(ws[c][k], v[k]));
    const float yb = __bfloat162float(__float2bfloat16_rn(acc));
    y[(size_t)(co0 + c) * n + p] =
        __float2bfloat16_rn(__fadd_rn(yb, __bfloat162float(bs[c])));
  }
}

template <int CIN>
__global__ void __launch_bounds__(THREADS)
stem_wgrad_kernel(const __nv_bfloat16* __restrict__ dy,
                  const __nv_bfloat16* __restrict__ x,
                  float* __restrict__ part, int cout, int n, int h, int wi) {
  constexpr int K = 9 * CIN + 1;  // the taps, then the bias
  __shared__ float red[THREADS / 32][WG_COS * K];
  const int co0 = blockIdx.y * WG_COS;
  const int p0 = blockIdx.x * WG_POS;
  float acc[WG_COS][K];
#pragma unroll
  for (int c = 0; c < WG_COS; ++c)
#pragma unroll
    for (int k = 0; k < K; ++k) acc[c][k] = 0.f;
  for (int p = p0 + threadIdx.x; p < min(p0 + WG_POS, n); p += THREADS) {
    float v[9 * CIN];
    gather<CIN>(x, n, h, wi, p, v);
#pragma unroll
    for (int c = 0; c < WG_COS; ++c) {
      if (co0 + c >= cout) break;
      const float g = __bfloat162float(dy[(size_t)(co0 + c) * n + p]);
#pragma unroll
      for (int k = 0; k < K - 1; ++k) acc[c][k] = __fmaf_rn(g, v[k], acc[c][k]);
      acc[c][K - 1] = __fadd_rn(acc[c][K - 1], g);
    }
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int c = 0; c < WG_COS; ++c)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float s = common::warp_sum(acc[c][k]);
      if (lane == 0) red[warp][c * K + k] = s;
    }
  __syncthreads();
  const int m = cout * K;
  for (int i = threadIdx.x; i < WG_COS * K; i += THREADS) {
    if (co0 + i / K >= cout) continue;
    float s = red[0][i];
    for (int r = 1; r < THREADS / 32; ++r) s = __fadd_rn(s, red[r][i]);
    part[(size_t)blockIdx.x * m + (size_t)co0 * K + i] = s;
  }
}

#define STEM_CASES(F) \
  F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8)

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

extern "C" {

// x [cin, n] bf16 (1 <= cin <= 8), w [cout, 9 * cin] bf16 (taps row-major
// in (dh, dw), then input channel), b [cout] f32, y [cout, n] bf16.
int stem_fwd_launch(const void* x, const void* w, const void* b, void* y,
                    int cin, int cout, int n, int h, int wi, void* stream) {
  const dim3 grid((n + THREADS - 1) / THREADS, (cout + FWD_COS - 1) / FWD_COS);
  const auto* xx = static_cast<const __nv_bfloat16*>(x);
  const auto* ww = static_cast<const __nv_bfloat16*>(w);
  const auto* bb = static_cast<const float*>(b);
  auto* yy = static_cast<__nv_bfloat16*>(y);
  switch (cin) {
#define CASE(C)                                                              \
  case C:                                                                    \
    stem_fwd_kernel<C><<<grid, THREADS, 0, as_stream(stream)>>>(           \
        xx, ww, bb, yy, cout, n, h, wi);                                     \
    break;
    STEM_CASES(CASE)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dy [cout, n] bf16, x [cin, n] bf16; part [ceil(n / 4096)][cout][9*cin+1]
// f32: per block of 4096 positions, the sums of dy * tap (columns in
// (dh, dw, ci) order) and, last, of dy.
int stem_wgrad_launch(const void* dy, const void* x, void* part, int cin,
                      int cout, int n, int h, int wi, void* stream) {
  const dim3 grid((n + WG_POS - 1) / WG_POS, (cout + WG_COS - 1) / WG_COS);
  const auto* dd = static_cast<const __nv_bfloat16*>(dy);
  const auto* xx = static_cast<const __nv_bfloat16*>(x);
  auto* pp = static_cast<float*>(part);
  switch (cin) {
#define CASE(C)                                                              \
  case C:                                                                    \
    stem_wgrad_kernel<C><<<grid, THREADS, 0, as_stream(stream)>>>(         \
        dd, xx, pp, cout, n, h, wi);                                         \
    break;
    STEM_CASES(CASE)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[i] = sum over k < j of part[k][i], in order (part [j][m] f32)
int partial_sum_launch(const void* part, void* out, int j, int m,
                       void* stream) {
  return common::partial_sum(static_cast<const float*>(part),
                             static_cast<float*>(out), j, m,
                             as_stream(stream));
}

}  // extern "C"
