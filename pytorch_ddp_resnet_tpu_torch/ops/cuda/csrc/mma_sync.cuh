// The mma.sync helpers of the repo's older tensor-core kernels: the int8
// 1x1 conv (conv1x1.cu, with requant.cuh's per-element epilogue) and the
// NV bottleneck kernels (bneck_nv.cu, bneck_nv_train.cu). Each of them
// stages its operands in shared memory, reads them with ldmatrix and
// accumulates with mma.sync in registers; conv1x1.cu then hands its
// accumulator tile [BM][bn] in shared memory to ``epilogue``.
//
// The namespace keeps the name these helpers had when they lived beside
// the row-tile 3x3 mainloop, so the kernels that take them compile to the
// same code under the same symbols.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"  // quant_s8

namespace conv3x3 {

constexpr int BM = 64;        // output channels per block
constexpr int THREADS = 256;  // 8 warps: 2 along channels x 4 along positions

template <typename T> struct Acc;
template <> struct Acc<__nv_bfloat16> { using type = float; };
template <> struct Acc<signed char> { using type = int; };

// 8 contiguous elements: 16 bytes of bf16 or 8 bytes of int8
template <typename T> struct Vec8;
template <> struct Vec8<__nv_bfloat16> { using type = uint4; };
template <> struct Vec8<signed char> { using type = uint2; };

using common::quant_s8;

// Apply a per-element epilogue epi(acc, co, idx) to a [BM, bn] accumulator
// tile Cs (row stride cld) whose column c is position n0 + c; threads walk
// the tile along positions so the stores coalesce.
template <typename AccT, typename Epi>
__device__ __forceinline__ void epilogue(const AccT* Cs, int cld, int bn,
                                         int m0, int n0, int cout, int n,
                                         const Epi& epi) {
  for (int i = threadIdx.x; i < BM * bn; i += THREADS) {
    const int r = i / bn;
    const int c = i - r * bn;
    const int co = m0 + r;
    if (co < cout && n0 + c < n)
      epi(Cs[r * cld + c], co, (size_t)co * n + n0 + c);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// One 32-byte step of the contraction: 16 bf16 or 32 int8 channels.
__device__ __forceinline__ void mma_step(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_step(int (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace conv3x3
