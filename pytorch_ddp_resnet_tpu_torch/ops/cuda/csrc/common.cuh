// Small pieces shared by the kernels of ops/cuda/csrc/.

#pragma once

#include <cuda_runtime.h>

namespace common {

// The reference's f32 constants (Python floats are weak-typed f32 in JAX).
constexpr float kInv127 = 0x1.020408p-7f;      // f32(1 / 127)
constexpr float kInv16129 = 0x1.040c2p-14f;    // f32(1 / (127 * 127))

// s8(clip(rint(v), -127, 127)): rint rounds half to even, as jnp.round;
// every int8 quantizer of the package rounds through it.
__device__ __forceinline__ signed char quant_s8(float v) {
  const float q = fminf(fmaxf(rintf(v), -127.f), 127.f);
  return (signed char)__float2int_rn(q);
}

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

// out[i] = the sum over SUM_RUNS runs of consecutive slots of part
// [slots][m] f32, each run summed in order, then the runs in order: a
// fixed order, so the same bits every run, and SUM_RUNS threads a column
// where one thread walking the slots would be latency-bound (fused_block.cu's
// forward sums its 1,089 tiles at C = 160 so: 0.017 ms a call against
// 0.03). Block: SUM_COLS columns x SUM_RUNS runs. ``Tag`` names the kernel.
constexpr int SUM_COLS = 8;
constexpr int SUM_RUNS = 32;

template <typename Tag>
__global__ void __launch_bounds__(SUM_COLS * SUM_RUNS)
    tile_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                    int slots, int m) {
  __shared__ float run[SUM_RUNS][SUM_COLS];
  const int c = threadIdx.x % SUM_COLS, q = threadIdx.x / SUM_COLS;
  const int col = blockIdx.x * SUM_COLS + c;
  const int per = (slots + SUM_RUNS - 1) / SUM_RUNS;
  float s = 0.f;
  if (col < m)
    for (int t = q * per; t < min(slots, (q + 1) * per); ++t)
      s = __fadd_rn(s, part[(size_t)t * m + col]);
  run[q][c] = s;
  __syncthreads();
  if (q == 0 && col < m) {
    float v = run[0][c];
    for (int k = 1; k < SUM_RUNS; ++k) v = __fadd_rn(v, run[k][c]);
    out[col] = v;
  }
}

template <typename Tag = void>
inline int tile_sum(const float* part, float* out, int slots, int m,
                    cudaStream_t stream) {
  tile_sum_kernel<Tag><<<(m + SUM_COLS - 1) / SUM_COLS, SUM_COLS * SUM_RUNS,
                         0, stream>>>(part, out, slots, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace common
