// The requantization epilogue of the int8 convolutions, one output element
// from its s32 accumulator, shared by conv3x3.cu's serving conv (its GEMM's
// epilogue in requant_wgmma_s8.cuh) and conv1x1.cu:
//
//   y = acc * scale[co] + shift[co] (+ res)
//   if relu: y = max(y, 0)
//   out = s8(clip(rint(y * inv_out_scale)))  or  bf16(y)
//   out2 = s8(clip(rint(max(y * sb[co] + tb[co], 0))))   (dual mode)
//
// Rounding follows the JAX reference as XLA computes it on the CPU, where
// the tests run it (probed by tests/test_torch_conv1x1.py and
// tests/test_torch_conv3x3.py): acc * scale + shift and y * sb + tb are
// each one fused multiply-add (__fmaf_rn), the residual add and the output
// scaling round on their own (__fadd_rn, __fmul_rn), rint rounds half to
// even as jnp.round, and s32 -> f32 rounds to nearest. requant_y,
// requant_q and requant_dual are the one copy of those rounding points.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sync.cuh"

namespace conv3x3 {

// y = acc * scale + shift (one fma) (+ res, f32 of the bf16 residual: its
// own rounding), then relu
__device__ __forceinline__ float requant_y(int acc, float scale, float shift,
                                           bool has_res, float res,
                                           bool relu) {
  float y = __fmaf_rn(__int2float_rn(acc), scale, shift);
  if (has_res) y = __fadd_rn(y, res);
  return relu ? fmaxf(y, 0.f) : y;
}

// the int8 output: s8(clip(rint(y * inv_out_scale)))
__device__ __forceinline__ signed char requant_q(float y,
                                                 float inv_out_scale) {
  return quant_s8(__fmul_rn(y, inv_out_scale));
}

// the dual output: s8(clip(rint(max(y * sb + tb, 0)))) (one fma)
__device__ __forceinline__ signed char requant_dual(float y, float sb,
                                                   float tb) {
  return quant_s8(fmaxf(__fmaf_rn(y, sb, tb), 0.f));
}

// The tile epilogue (mma_sync.cuh ``epilogue``) of a per-element
// functor.
template <typename Derived>
struct PerElement {
  template <typename AccT>
  __device__ __forceinline__ void tile(const AccT* Cs, int cld, int bn,
                                       int m0, int n0, int cout,
                                       int n) const {
    epilogue(Cs, cld, bn, m0, n0, cout, n, static_cast<const Derived&>(*this));
  }
};

struct Requant : PerElement<Requant> {
  const float* scale;
  const float* shift;
  const __nv_bfloat16* res;  // or null
  const float* sb;           // dual mode: sb, tb, out2 non-null
  const float* tb;
  void* out;                 // int8 when out_int8, else bf16
  signed char* out2;
  int relu;
  int out_int8;
  float inv_out_scale;

  __device__ __forceinline__ void operator()(int acc, int co,
                                             size_t idx) const {
    const float y = requant_y(
        acc, scale[co], shift[co], res != nullptr,
        res != nullptr ? __bfloat162float(res[idx]) : 0.f, relu);
    if (out_int8) {
      static_cast<signed char*>(out)[idx] = requant_q(y, inv_out_scale);
    } else {
      static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(y);
    }
    if (out2 != nullptr) out2[idx] = requant_dual(y, sb[co], tb[co]);
  }
};

// The epilogue's arguments as the C interfaces take them.
inline Requant make_requant(const void* scale, const void* shift,
                            const void* res, const void* sb, const void* tb,
                            void* out, void* out2, int relu, int out_int8,
                            float inv_out_scale) {
  Requant epi;
  epi.scale = static_cast<const float*>(scale);
  epi.shift = static_cast<const float*>(shift);
  epi.res = static_cast<const __nv_bfloat16*>(res);
  epi.sb = static_cast<const float*>(sb);
  epi.tb = static_cast<const float*>(tb);
  epi.out = out;
  epi.out2 = static_cast<signed char*>(out2);
  epi.relu = relu;
  epi.out_int8 = out_int8;
  epi.inv_out_scale = inv_out_scale;
  return epi;
}

}  // namespace conv3x3
