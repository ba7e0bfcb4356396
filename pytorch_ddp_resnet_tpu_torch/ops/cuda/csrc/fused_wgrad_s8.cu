// The fused block-half's FQT (int8) weight gradient, written for Hopper
// (sm_90a) and bound to Python through a plain C interface
// (ops/cuda/fused_block.py loads this file's shared library with ctypes).
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/fused_block.py:763,
// _wgrad_call -> _wgrad_kernel, and the wgrad half of _bwd_kernel at :992,
// quant_bwd=True): per scale group of `tile` lanes the int8 contraction
//   dW[(tap, ci), co] = sum over groups g, in order, of
//     f32(sum_{p in g} d_q[ci, p + shift(tap)] * g_q[co, p]) * ts_g,
//   ts_g = (d_amax_g * g_amax_g) / 127^2, shift(tap) = (dh - 1) * W + (dw -
//   1), zero where the tap leaves the image,
// with g_q [Cout, N] and d_q [Cin, N] the int8 codes of fused_block.cu's
// bwd_quant, channel-major as they lie.
//
// What bounds it on an H100: operations (2 * 9 * Cin * Cout * N: 60.4 GOP
// a call at each WRN-28-10 stage, batch 128; 0.0305 ms at 1,979 TOP/s).
// The design is the lane transition's mainloop (wgrad_wgmma_s8.cuh: TMA
// boxes of 144-byte rows at each tap's shift rounded down to 16 bytes, a
// shifter warpgroup, two consumer warpgroups on s8 wgmma into s32 tiles,
// each group folded with __int2float_rn / __fmul_rn / __fadd_rn in group
// order) on one plane at the nine stride-1 taps (row and column shifts of
// -1, 0 and 1). Where the (128, bn) tiles of dW alone leave SMs idle
// (WRN-28-10's stages 1 and 2: 12 and 46 tiles for 132 SMs), the scale
// groups are split into runs, a block each, and every group's f32
// contribution goes to its slot, which launch_slot_sum adds in group order:
// the same roundings in the same order as the in-block fold, so dW is
// bit-equal to the plain version either way (ops/cuda/fused_block.py
// fused_wgrad_s8_plan picks the tile width and the runs).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgrad_wgmma_s8.cuh"

namespace {

// Name the mainloop's and the slots' sum kernels in a profile.
struct FusedWgradS8 {};
struct FusedWgradS8Sum {};

// the nine stride-1 taps of one plane, (plane, row shift, column shift) in
// (dh, dw) order
constexpr int kTaps[27] = {0, -1, -1, 0, -1, 0, 0, -1, 1,
                           0, 0,  -1, 0, 0,  0, 0, 0,  1,
                           0, 1,  -1, 0, 1,  0, 0, 1,  1};

}  // namespace

extern "C" {

// d_q [cin][n] and g_q [cout][n] int8 (n = b * h * wi positions, 16-byte
// aligned), g_amax and d_amax [n / tile] f32 (one scale group a tile
// positions, a multiple of 128); out: with gpb == 0, dW [9 * cin][cout]
// f32 (HWIO), the groups folded in each block (bn 128, 64 or 32); with gpb
// > 0, the slots [n / tile][m_tiles][n_tiles][128 * bn] f32 of runs of gpb
// groups (bn 160 or 128), for fused_wgrad_s8_sum_launch. Returns a
// cudaError_t.
int fused_wgrad_s8_launch(const void* d_q, const void* g_q,
                          const void* g_amax, const void* d_amax, void* out,
                          int cin, int cout, int n, int h, int wi, int tile,
                          int bn, int gpb, void* stream) {
  return static_cast<int>(
      wgrad_wgmma_s8::launch_taps<FusedWgradS8, true>(
          d_q, 1, g_q, static_cast<const float*>(g_amax),
          static_cast<const float*>(d_amax), static_cast<float*>(out), kTaps,
          9, cin, cout, n, h, wi, tile, bn, gpb,
          static_cast<cudaStream_t>(stream)));
}

// dW [9 * cin][cout] f32 = the slots of fused_wgrad_s8_launch (gpb > 0)
// added in group order. Returns a cudaError_t.
int fused_wgrad_s8_sum_launch(const void* part, void* dw, int groups,
                              int cin, int cout, int bn, void* stream) {
  return static_cast<int>(
      wgrad_wgmma_s8::launch_slot_sum<FusedWgradS8Sum>(
          static_cast<const float*>(part), static_cast<float*>(dw), groups,
          9 * cin, cout, bn, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
