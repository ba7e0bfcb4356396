// Weight gradient of a stride-1 SAME 3x3 convolution in the channel-major
// layout [C, B*H*W], bf16 operands and f32 sums, written for Hopper
// (sm_90a) and bound to Python through a plain C interface
// (ops/cuda/conv3x3.py loads this file's shared library with ctypes).
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/conv.py):
//   conv3x3_wgrad_launch  <- conv3x3_wgrad_lanes, body _wgrad_kernel: dW
//                            [Cout, 9*Cin] = dy [Cout, N] x patches(x)
//                            [9*Cin, N]^T, f32 sums over every position
//   partial_sum_launch    <- the TPU kernel's sum carried across its grid
//
// What bounds it on an H100: at the WRN-28-10 shapes (C = 160, 320, 640 at
// 32x32, 16x16, 8x8, batch 128) one call is 2 * 9 * C^2 * N = 60.4 GFLOP
// (0.061 ms at 989 TFLOP/s of bf16) against 36-85 MB of operands and dW
// (0.025 ms at 3.35 TB/s at most): it is bound by operations.
//
// Design: the position-split GEMM of wgrad_bf16.cuh (the same mainloop as
// the fused bf16 half's wgrad of fused_block_bf16.cu) with raw operand
// loads: g is dy as it is, d is x as it is (no prologue, no folded
// cotangent). The grid splits the positions so that some 500 blocks are
// in flight; each split's f32 tile goes to its slot of a partial buffer,
// and partial_sum adds the slots in order, so the result does not depend
// on which block finished first. The TPU kernel's 640-lane tap groups and
// roll-and-mask patches are MXU and VMEM choices and are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "wgrad_bf16.cuh"

namespace {

// 8 bf16 of one row of t [C, n], as they are
struct RawRows {
  const __nv_bfloat16* t;
  int n;
  __device__ __forceinline__ uint4 operator()(int ch, size_t pos) const {
    return *reinterpret_cast<const uint4*>(t + (size_t)ch * n + pos);
  }
};

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

extern "C" {

// x [cin, n] bf16, dy [cout, n] bf16, part [splits][cout][9 * cin] f32,
// split s covering positions [s * n / splits, (s + 1) * n / splits).
// cin % 32 == 0, wi % 8 == 0, wi <= 32, n / splits a multiple of 256,
// and 256 a multiple of h * wi or the reverse; the pointers 16-byte
// aligned. Returns the launch's cudaError_t.
int conv3x3_wgrad_launch(const void* x, const void* dy, void* part, int cin,
                         int cout, int n, int h, int wi, int splits,
                         void* stream) {
  const RawRows g{static_cast<const __nv_bfloat16*>(dy), n};
  const RawRows d{static_cast<const __nv_bfloat16*>(x), n};
  return wgrad_bf16::launch(g, d, static_cast<float*>(part), cout, cin, n, h,
                            wi, splits, as_stream(stream));
}

// out[i] = sum over k < j of part[k][i], in order (part [j][m] f32)
int partial_sum_launch(const void* part, void* out, int j, int m,
                       void* stream) {
  return common::partial_sum<RawRows>(static_cast<const float*>(part),
                             static_cast<float*>(out), j, m,
                             as_stream(stream));
}

}  // extern "C"
