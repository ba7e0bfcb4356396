// Fused gather + augmentation of a batch from a resident uint8 dataset,
// written for Hopper (sm_90a), bound to Python through a plain C interface
// (ops/cuda/augment.py loads this file's shared library with ctypes).
//
// What it replaces: pytorch_ddp_resnet_tpu/ops/pallas/augment.py
// pallas_augment, body _augment_kernel. Per sample b of the batch:
//   x = data[idx[b]] (uint8, H x W x C)
//   x = fma(x, 1/255, -mean) * inv_std                  (f32, per pixel)
//   x = flip[b] ? x[:, ::-1] : x                        (horizontal)
//   x = pad(x, pad, zero | reflect)                     (edge not repeated)
//   out[b] = bf16(x[top[b] : top[b]+crop, left[b] : left[b]+crop])
// The random draws (idx, top, left, flip) are made outside the kernel, as
// in the TPU version.
//
// What bounds it on an H100: at the WRN-28-10 training batch (B = 128,
// 32x32x3, pad 4, crop 32) it reads 393 KB of gathered uint8 and 24.6 KB of
// mean/inv_std and writes 786 KB of bf16, 1.2 MB in all: 0.36 us at
// 3.35 TB/s, well under the few microseconds of a kernel launch. It is
// launch-bound, and nothing in it is tuned.
//
// What the design does about it: one launch for the whole batch and one
// thread per output element (NHWC, so neighbouring threads write
// neighbouring bf16 values). Each thread maps its crop position back
// through the padding (reflect or zero) and the flip to a source pixel and
// gathers it straight from the resident set; nothing is staged. The TPU
// kernel's CHW-planar layout and its antidiagonal and one-hot matmuls (a
// flip, a reflection and a dynamic lane offset that Mosaic could not
// express) do not carry over: here the output is NHWC, the model's layout.
//
// Rounding follows the reference as the tests run it: XLA on the CPU
// contracts x * (1/255) - mean into one fused multiply-add, so the kernel
// states that FMA explicitly (__fmaf_rn) and multiplies by inv_std
// separately (__fmul_rn), leaving nvcc no contraction to choose; the
// result rounds to bf16 to nearest even (__float2bfloat16_rn). Zero
// padding pads the normalized image with 0.0, as the reference does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// Reflect an index into [0, n) without repeating the edge (valid for
// -n < i < 2n - 1), then clamp so that no draw out of range reads outside
// the image.
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);
}

__global__ void augment_kernel(const uint8_t* __restrict__ data,
                               const int* __restrict__ idx,
                               const int* __restrict__ top,
                               const int* __restrict__ left,
                               const int* __restrict__ flip,
                               const float* __restrict__ mean,
                               const float* __restrict__ inv_std,
                               __nv_bfloat16* __restrict__ out, int n, int b,
                               int h, int w, int c, int pad, int crop,
                               int mirror, float scale) {
  const long long total = static_cast<long long>(b) * crop * crop * c;
  const long long hwc = static_cast<long long>(h) * w * c;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int ch = static_cast<int>(e % c);
    long long t = e / c;
    const int j = static_cast<int>(t % crop);
    t /= crop;
    const int i = static_cast<int>(t % crop);
    const int s = static_cast<int>(t / crop);
    // position in the flipped, unpadded image
    int r = top[s] + i - pad;
    int q = left[s] + j - pad;
    float v = 0.0f;
    bool inside = r >= 0 && r < h && q >= 0 && q < w;
    if (mirror) {
      r = reflect(r, h);
      q = reflect(q, w);
      inside = true;
    }
    if (inside) {
      if (flip[s]) q = w - 1 - q;  // the source column before the flip
      const int row = min(max(idx[s], 0), n - 1);
      const long long p = (static_cast<long long>(r) * w + q) * c + ch;
      const float x = static_cast<float>(data[row * hwc + p]);
      v = __fmul_rn(__fmaf_rn(x, scale, -mean[p]), inv_std[p]);
    }
    out[e] = __float2bfloat16_rn(v);
  }
}

}  // namespace

extern "C" {

// data [n, h, w, c] uint8; idx, top, left, flip [b] int32; mean, inv_std
// [h, w, c] f32; out [b, crop, crop, c] bf16. scale is f32(1/255). With
// mirror, pad < h and pad < w; top and left lie in [0, h + 2*pad - crop].
// Returns the launch's cudaError_t.
int augment_batch_launch(const void* data, const void* idx, const void* top,
                         const void* left, const void* flip,
                         const void* mean, const void* inv_std, void* out,
                         int n, int b, int h, int w, int c, int pad,
                         int crop, int mirror, float scale, void* stream) {
  const long long total = static_cast<long long>(b) * crop * crop * c;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks =
      std::min<long long>((total + threads - 1) / threads, 1 << 16);
  augment_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int*>(idx),
      static_cast<const int*>(top), static_cast<const int*>(left),
      static_cast<const int*>(flip), static_cast<const float*>(mean),
      static_cast<const float*>(inv_std),
      static_cast<__nv_bfloat16*>(out), n, b, h, w, c, pad, crop, mirror,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
