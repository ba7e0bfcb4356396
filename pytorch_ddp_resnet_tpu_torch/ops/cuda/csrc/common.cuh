// Small pieces shared by fused_block.cu and stem.cu.

#pragma once

#include <cuda_runtime.h>

namespace common {

// The reference's f32 constants (Python floats are weak-typed f32 in JAX).
constexpr float kInv127 = 0x1.020408p-7f;      // f32(1 / 127)
constexpr float kInv16129 = 0x1.040c2p-14f;    // f32(1 / (127 * 127))

// Sum over the warp with a fixed butterfly: the same order every run.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The absmax of a scale group: the maximum of the row maxima over rows
// [k * rch - halo, (k + 1) * rch + halo) inside the plane (exact in any
// order).
__device__ __forceinline__ float chunk_amax(const float* __restrict__ rowmax,
                                            int k, int rch, int halo, int h) {
  const int r0 = max(k * rch - halo, 0);
  const int r1 = min((k + 1) * rch + halo, h);
  float m = rowmax[r0];
  for (int r = r0 + 1; r < r1; ++r) m = fmaxf(m, rowmax[r]);
  return m;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// out[i] = part[0][i] + part[1][i] + ... in order, in f32: the second pass
// of every cross-block sum, so the result does not depend on which block
// finished first. ``Tag`` only names the kernel, so that a profile can
// tell whose sum it is.
template <typename Tag>
__global__ void partial_sum_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, int j, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float s = part[i];
  for (int k = 1; k < j; ++k) s = __fadd_rn(s, part[(size_t)k * m + i]);
  out[i] = s;
}

template <typename Tag = void>
inline int partial_sum(const float* part, float* out, int j, int m,
                       cudaStream_t stream) {
  partial_sum_kernel<Tag><<<(m + 255) / 256, 256, 0, stream>>>(part, out, j,
                                                               m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace common
