// The lane transition's weight gradients and its projection's weight
// gradient, in the channel-major layout, written for Hopper (sm_90a) and
// bound to Python through a plain C interface (ops/cuda/transition.py
// loads this file's shared library with ctypes).
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/transition.py:619,
// transition_half_int8's backward -> _bwd_kernel: its wgrad in both bodies
// and its dWp):
//   transition_wgrad_s8_launch <- the FQT wgrad: per scale group the int8
//                                 contraction dW[co, (tap, ci)] = sum over
//                                 the group's output positions p of
//                                 g_q[co, p] * d_q[ci, src(p, tap)] in s32,
//                                 times (d_amax * g_amax) / 127^2, added in
//                                 group order (wgrad_wgmma_s8.cuh)
//   transition_wgrad_launch    <- the straight-through wgrad (the nine taps)
//                                 and dWp = dres . x_ee^T (one tap), f32
//                                 sums (wgrad_wgmma_bf16.cuh)
//   partial_sum_launch         <- the TPU kernel's sums carried across its
//                                 grid (the bf16 mainloop's splits)
//
// The design: the operand passes of transition.cu write the prologue d as
// its four parity planes [4][Cin][N'] at the output geometry (the FQT
// quantizer in int8 at each group's scale, bwd_quant_kernel; the
// straight-through fold in bf16, bwd_fold_kernel), and the raw even-even
// plane of x [Cin][N']; then every tap of the stride-2 conv is one plane
// read at a shift of at most one row and one column (tab: the JAX kernel's
// _tap_info, from ops/cuda/transition.py TAP_TABLE), which TMA stages and a
// shifter warpgroup moves in shared memory, and two consumer warpgroups run
// wgmma against the cotangent g [Cout][N'] (dres for dWp), K-major as it
// lies. What bounds them on an H100: operations (30.2 GOP a call at both
// WRN-28-10 transitions, batch 128: int8 for the FQT dW, bf16 for the
// straight-through one; dWp 3.4 GFLOP). Deterministic: the FQT dW folds its
// groups in order inside each tile, in one launch; the bf16 splits' f32
// tiles are added in order by partial_sum.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "wgrad_wgmma_bf16.cuh"
#include "wgrad_wgmma_s8.cuh"

namespace {

// Name the mainloops' and the ordered sum's kernels in a profile.
struct TransitionWgrad {};
struct TransitionWgradSum {};
struct TransitionWgradS8 {};

}  // namespace

extern "C" {

// x [planes][cin][n] and g [cout][n] bf16 (n = b * oh * ow output
// positions, 16-byte aligned), part [splits][taps * cin][cout] f32; tab
// [taps][3] (host memory): each tap's plane, row shift and column shift.
// The geometry is ops/cuda/transition.py check_wgrad_geometry's. Returns a
// cudaError_t.
int transition_wgrad_launch(const void* x, const void* g, void* part,
                            int planes, const int* tab, int taps, int cin,
                            int cout, int n, int oh, int ow, int bn, int per,
                            int splits, void* stream) {
  return static_cast<int>(wgrad_wgmma_bf16::launch_taps<TransitionWgrad>(
      x, planes, g, static_cast<float*>(part), tab, taps, cin, cout, n, oh,
      ow, bn, per, splits, static_cast<cudaStream_t>(stream)));
}

// The FQT dW: d [planes][cin][n] and g [cout][n] int8 (n = b * oh * ow
// output positions, 16-byte aligned), g_amax and d_amax [n / tile] f32
// (one scale group a tile positions, a multiple of 128), dw [taps *
// cin][cout] f32; tab [taps][3] (host memory): each tap's plane, row shift
// and column shift (-1 or 0); a bn-wide N tile (128, 64 or 32:
// ops/cuda/transition.py wgrad_s8_plan). One launch. Returns a cudaError_t.
int transition_wgrad_s8_launch(const void* d, const void* g,
                               const void* g_amax, const void* d_amax,
                               void* dw, int planes, const int* tab, int taps,
                               int cin, int cout, int n, int oh, int ow,
                               int tile, int bn, void* stream) {
  return static_cast<int>(wgrad_wgmma_s8::launch_taps<TransitionWgradS8>(
      d, planes, g, static_cast<const float*>(g_amax),
      static_cast<const float*>(d_amax), static_cast<float*>(dw), tab, taps,
      cin, cout, n, oh, ow, tile, bn, 0, static_cast<cudaStream_t>(stream)));
}

// out[i] = sum over k < j of part[k][i], in order (part [j][m] f32)
int partial_sum_launch(const void* part, void* out, int j, int m,
                       void* stream) {
  return common::partial_sum<TransitionWgradSum>(
      static_cast<const float*>(part), static_cast<float*>(out), j, m,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
