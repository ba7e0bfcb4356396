// The launchers of wgrad_staged.cuh's mainloop and its ordered sum of the
// split tiles (wgrad_staged_sum_kernel). They sit apart from the mainloop so
// that only the files that launch them compile their kernels: the header
// itself reaches every wgmma file through fwd_wgmma_bf16.cuh's includes
// (its cp.async helpers), and a non-template launcher naming every
// instantiation would build all of them there. Included by
// fused_block_bf16.cu (the fused halves' bf16 wgrad) and bneck_nv_train.cu
// (the NV halves' bf16 wgrad).

#pragma once

#include <cuda_runtime.h>

#include "wgrad_staged.cuh"

namespace wgrad_staged {

constexpr int SUM_WIN = 64;  // chunks a block holds in shared memory at once

// dW[i] = sum over chunks k in order of (chunk k's split tiles added in
// split order), in f32, four consecutive elements a thread (mn % 4 == 0).
// Block (32, 8): column x is one float4 of dW; the 8 rows of threads take
// the chunks' split sums in turn (chunk y, y + 8, ...: independent loads in
// flight at once) into shared memory, then row 0 adds them in chunk order,
// SUM_WIN chunks at a time.
__global__ void __launch_bounds__(256)
wgrad_staged_sum_kernel(const float4* __restrict__ part,
                        float4* __restrict__ out, long mn4, int chunks,
                        int splits) {
  __shared__ float4 cs[SUM_WIN][32];
  const int x = threadIdx.x, y = threadIdx.y;
  const long i = (long)blockIdx.x * 32 + x;
  const bool live = i < mn4;
  float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < chunks; k0 += SUM_WIN) {
    const int kn = min(SUM_WIN, chunks - k0);
    if (live)
      for (int k = y; k < kn; k += 8) {
        const float4* src = part + (size_t)(k0 + k) * splits * mn4 + i;
        float4 c = src[0];
#pragma unroll 4
        for (int sp = 1; sp < splits; ++sp)
          c = add4(c, src[(size_t)sp * mn4]);
        cs[k][x] = c;
      }
    __syncthreads();
    if (y == 0 && live)
      for (int k = 0; k < kn; ++k)
        d = k0 + k == 0 ? cs[k][x] : add4(d, cs[k][x]);
    __syncthreads();
  }
  if (y == 0 && live) out[i] = d;
}

template <int BM, int BN>
inline cudaError_t launch_tile(const Args& p, cudaStream_t stream) {
  constexpr int smem = Tile<BM, BN, K_STEP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_staged_kernel<BM, BN, K_STEP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int chunks = p.h / p.rch;
  const dim3 grid((p.taps * p.cin + BM - 1) / BM, (p.cout + BN - 1) / BN,
                  chunks * p.splits);
  wgrad_staged_kernel<BM, BN, K_STEP><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The GEMM with the tile the caller planned: bm, bn in {64, 128}, K steps
// of bk = K_STEP positions.
inline cudaError_t launch(const Args& p, int bm, int bn, int bk,
                          cudaStream_t stream) {
  if (bk != K_STEP) return cudaErrorInvalidValue;
  if (bm == 128 && bn == 128) return launch_tile<128, 128>(p, stream);
  if (bm == 128 && bn == 64) return launch_tile<128, 64>(p, stream);
  if (bm == 64 && bn == 128) return launch_tile<64, 128>(p, stream);
  if (bm == 64 && bn == 64) return launch_tile<64, 64>(p, stream);
  return cudaErrorInvalidValue;
}

inline cudaError_t launch_sum(const float* part, float* dw, long mn,
                              int chunks, int splits, cudaStream_t stream) {
  const long mn4 = mn / 4;
  wgrad_staged_sum_kernel<<<(unsigned)((mn4 + 31) / 32), dim3(32, 8), 0,
                            stream>>>(reinterpret_cast<const float4*>(part),
                                      reinterpret_cast<float4*>(dw), mn4,
                                      chunks, splits);
  return cudaGetLastError();
}

}  // namespace wgrad_staged
