// Counter-based uint8 dropout bits computed in registers, bit for bit the
// TPU kernels' hash (pytorch_ddp_resnet_tpu/ops/pallas/fused_block.py
// _seed_bits): murmur3's fmix32 over the element's GLOBAL index
// row * N + lane of the [C, N] lane layout, with the seed added after the
// golden-ratio spread and a finalized copy of it xor-ed in before both
// multiplies; the top byte is the result. uint32 arithmetic wraps exactly
// as the reference's int32 arithmetic with logical shifts does.
//
// The value depends on the global coordinate only, never on a kernel's
// tiling or memory layout, so the forward, dgrad and wgrad kernels rebuild
// the same mask from one int32 seed and no [C, N] bits tensor reaches
// device memory. The reference indexes in int32: callers keep C * N < 2^31.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dropout {

// the seed's own murmur3 finalizer
__host__ __device__ __forceinline__ uint32_t seed_mix(uint32_t s) {
  s ^= s >> 16;
  s *= 0x85EBCA6Bu;
  s ^= s >> 13;
  s *= 0xC2B2AE35u;
  s ^= s >> 16;
  return s;
}

// the bits of element (row, lane) of a [C, n_total] tensor; ``mixed`` is
// seed_mix(seed)
__host__ __device__ __forceinline__ unsigned char seed_bits(
    uint32_t seed, uint32_t mixed, int row, int lane, int n_total) {
  uint32_t h = (uint32_t)row * (uint32_t)n_total + (uint32_t)lane;
  h = h * 0x9E3779B1u + seed;
  h ^= h >> 16;
  h ^= mixed;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return (unsigned char)(h >> 24);
}

// A dropout mask's bits: materialized ([C, n] uint8), from a seed held in
// device memory (read by pointer, so the host never waits for it), or
// none.
struct DropBits {
  const unsigned char* bits;  // [C, n] uint8, or null
  const int* seed;            // one int32 on the device, or null
  int n;                      // lanes per row (the global N)

  __device__ __forceinline__ bool active() const {
    return bits != nullptr || seed != nullptr;
  }

  // 8 consecutive bits of row ``row`` from lane ``lane`` (0 when none)
  __device__ __forceinline__ void load8(int row, int lane,
                                        unsigned char (&v)[8]) const {
    if (seed != nullptr) {
      const uint32_t s = (uint32_t)*seed;
      const uint32_t m = seed_mix(s);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = seed_bits(s, m, row, lane + k, n);
    } else if (bits != nullptr) {
      const uint2 raw = *reinterpret_cast<const uint2*>(
          bits + (size_t)row * n + lane);
      const unsigned char* e = reinterpret_cast<const unsigned char*>(&raw);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = e[k];
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = 0;
    }
  }

  // one element's bits
  __device__ __forceinline__ int at(int row, int lane) const {
    if (seed != nullptr) {
      const uint32_t s = (uint32_t)*seed;
      return seed_bits(s, seed_mix(s), row, lane, n);
    }
    return bits != nullptr ? bits[(size_t)row * n + lane] : 0;
  }
};

}  // namespace dropout
