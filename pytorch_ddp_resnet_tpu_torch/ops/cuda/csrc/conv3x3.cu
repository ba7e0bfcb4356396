// Stride-1 SAME 3x3 convolutions in the channel-major layout [C, B*H*W],
// written for Hopper (sm_90a), bound to Python through a plain C interface
// (ops/cuda/conv3x3.py loads this file's shared library with ctypes).
//
// What they replace (pytorch_ddp_resnet_tpu/ops/pallas/conv.py):
//   conv3x3_bf16_pre_launch,
//   conv3x3_bf16_gemm_launch     <- conv3x3_lanes, body _conv_kernel
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
// Both convs take one route: a prepass (fused_half.cuh's slab_copy, the
// one slab copy) lays x, or x_q's codes, into the padded position-major
// slab of ops/cuda/fused_block.py fused_fwd_layout (every tap one row
// offset, any image width), then a wgmma mainloop and an epilogue in
// registers, each channel's run of lanes written in 16-byte vectors from
// its own lead (any N, any Cout):
// - the bf16 conv (conv3x3_wgmma_bf16.cuh): fwd_wgmma_bf16.cuh's cp.async
//   ring and bf16 wgmma, then y = bf16(acc);
// - the int8 conv (requant_wgmma_s8.cuh): fwd_wgmma_s8.cuh's TMA-fed s8
//   wgmma, then the requantizing epilogue.
//
// The TPU kernel's 640-lane tap grouping and roll-and-mask patches are MXU
// and VMEM choices and are not carried over.
//
// Rounding follows the JAX reference at its rounding points (requant.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_wgmma_bf16.cuh"  // the bf16 conv's prepass and GEMM
#include "requant_wgmma_s8.cuh"    // the int8 conv's prepass and GEMM

extern "C" {

// The bf16 conv's prepass: slab [slab_len, cin] bf16 (fused_fwd_layout:
// guard = wi + 2 zero positions, per image of h x wi a zero row and a zero
// column, zeros to slab_len) from x [cin, n] bf16; cin % 32 == 0, n a
// multiple of h * wi. Returns the launch's cudaError_t.
int conv3x3_bf16_pre_launch(const void* x, void* slab, int cin, int n,
                            int h, int wi, long slab_len, void* stream) {
  return static_cast<int>(conv3x3_wgmma_bf16::pre_launch(
      x, slab, cin, n, h, wi, slab_len, static_cast<cudaStream_t>(stream)));
}

// The bf16 conv's GEMM from the prepass's slab and w [cout, 9*cin] bf16
// (taps row-major in (dh, dw), then input channel): out [cout, n] bf16 =
// bf16(acc), on `tiles` 128-row M tiles and bn-wide N tiles (160, 128 or
// 64). Returns the launch's cudaError_t.
int conv3x3_bf16_gemm_launch(const void* slab, const void* w, void* out,
                             int cin, int cout, int n, int h, int wi,
                             long slab_len, int tiles, int bn, void* stream) {
  return static_cast<int>(conv3x3_wgmma_bf16::launch(
      slab, w, out, cin, cout, n, h, wi, slab_len, tiles, bn,
      static_cast<cudaStream_t>(stream)));
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
