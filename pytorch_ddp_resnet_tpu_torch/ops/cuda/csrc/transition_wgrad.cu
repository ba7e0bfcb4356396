// The lane transition's straight-through (bf16) weight gradient and its
// projection's weight gradient, in the channel-major layout, written for
// Hopper (sm_90a) and bound to Python through a plain C interface
// (ops/cuda/transition.py loads this file's shared library with ctypes).
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/transition.py:619,
// transition_half_int8's backward -> _bwd_kernel, its wgrad with
// quant_bwd=False and its dWp; the FQT body's int8 wgrad stays in
// transition.cu):
//   transition_wgrad_launch <- dW[co, (tap, ci)] = sum over output
//                              positions p of g[co, p] * d[ci, src(p, tap)]
//                              (the stride-2 3x3's nine taps), and dWp =
//                              dres . x_ee^T (one tap), f32 sums
//   partial_sum_launch      <- the TPU kernel's sums carried across its grid
//
// The design: the transition's fold (transition.cu bwd_fold_kernel) writes
// the recomputed prologue d as its four parity planes [4][Cin][N'] at the
// output geometry, and the raw even-even plane of x [Cin][N']; then every
// tap of the stride-2 conv is one plane read at a shift of at most one row
// and one column (tab: the JAX kernel's _tap_info, from
// ops/cuda/transition.py TAP_TABLE), which is wgrad_wgmma_bf16.cuh's
// problem: TMA stages the tap's plane at its row (zero fill above the
// image), a shifter warpgroup moves it by its column, two consumer
// warpgroups run wgmma against the cotangent g [Cout][N'] (dres for dWp),
// K-major as it lies. What bounds it on an H100: operations (30.2 GFLOP a
// call at both WRN-28-10 transitions, batch 128; dWp 3.4 GFLOP).
// Deterministic: f32 split tiles added in order by partial_sum.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "wgrad_wgmma_bf16.cuh"

namespace {

// Name the mainloop's and the ordered sum's kernels in a profile.
struct TransitionWgrad {};
struct TransitionWgradSum {};

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

// out[i] = sum over k < j of part[k][i], in order (part [j][m] f32)
int partial_sum_launch(const void* part, void* out, int j, int m,
                       void* stream) {
  return common::partial_sum<TransitionWgradSum>(
      static_cast<const float*>(part), static_cast<float*>(out), j, m,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
