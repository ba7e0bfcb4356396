// The row-tile implicit-GEMM mainloop of the stride-1 SAME 3x3 convolution
// in the channel-major layout [C, B*H*W] (W % 8 == 0), the mainloop of
// conv3x3.cu's bf16 conv (conv1x1.cu and the NV files take its helpers).
// See conv3x3.cu for the design: a block owns 64 output channels x R
// whole image rows, stages each 32-channel chunk of those rows plus a
// one-row halo in shared memory (channels innermost, zero border columns),
// reads every tap as an address shift with ldmatrix, and accumulates with
// mma.sync in registers.
//
// The epilogue is a functor: after the contraction the block's accumulator
// tile [64][BN] sits in shared memory and the kernel calls
// epi.tile(Cs, cld, bn, m0, n0, cout, n), where column c of row r is
// output channel m0 + r at position n0 + c.
//
// The operand load is a functor too: load(ch, pos, own) returns the 8
// elements of input channel ch at positions pos .. pos + 7 (one image row
// segment). RawLoad reads them from x; a fused kernel computes them (a
// BatchNorm/relu/dropout prologue, a cotangent fold). ``own`` is true for
// exactly one load of each (channel, position) over the whole grid: the
// tile's own rows (not its halo), in the blocks of the first channel
// tile, so a loader may also store what it computed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"  // quant_s8

namespace conv3x3 {

constexpr int BM = 64;        // output channels per block
constexpr int BK = 32;        // input channels per contraction chunk
constexpr int THREADS = 256;  // 8 warps: 2 along channels x 4 along positions

template <typename T> struct Acc;
template <> struct Acc<__nv_bfloat16> { using type = float; };
template <> struct Acc<signed char> { using type = int; };

// 8 contiguous elements: 16 bytes of bf16 or 8 bytes of int8
template <typename T> struct Vec8;
template <> struct Vec8<__nv_bfloat16> { using type = uint4; };
template <> struct Vec8<signed char> { using type = uint2; };

using common::quant_s8;

// The default operand load: 8 contiguous elements of x [C, n].
template <typename T>
struct RawLoad {
  const T* x;
  int n;
  __device__ __forceinline__ typename Vec8<T>::type operator()(
      int ch, int pos, bool) const {
    return *reinterpret_cast<const typename Vec8<T>::type*>(
        x + (size_t)ch * n + pos);
  }
};

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

// bytes per position in the halo tile and per row of the weight tile: the
// chunk's 32 channels plus 16 bytes, which makes the 8 rows of every
// ldmatrix fall in distinct banks
template <typename T>
__host__ __device__ constexpr int row_bytes() {
  return BK * (int)sizeof(T) + 16;
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

// Shared memory: the nine taps' weights [9][BM][row], then the halo tile
// [(R + 2) rows][(W + 2) cols][row] with zero borders; the accumulator
// tile [BM][BN + 4] reuses the same bytes after the contraction.
template <typename T, int BN>
int row_tile_smem_bytes(int wi) {
  const int a = 9 * BM * row_bytes<T>();
  const int x = (BN / wi + 2) * (wi + 2) * row_bytes<T>();
  const int c = BM * (BN + 4) * 4;
  return a + x > c ? a + x : c;
}

template <typename T, int BN, typename Epi, typename Load>
__global__ void __launch_bounds__(THREADS)
conv3x3_rows_kernel(Load load, const T* __restrict__ w,
                    Epi epi, int cin, int cout, int n, int h, int wi) {
  using AccT = typename Acc<T>::type;
  using V8 = typename Vec8<T>::type;
  constexpr int ROW = row_bytes<T>();
  constexpr int NF = BN / 32;                 // n8 fragments per warp
  constexpr int KSTEPS = BK * sizeof(T) / 32;  // 32-byte mma steps per chunk
  constexpr int CPW = 4 / sizeof(T);          // channels per 32-bit word
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* As = smem;
  unsigned char* Xs = smem + 9 * BM * ROW;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int warp_m = warp / 4;
  const int warp_n = warp % 4;
  const int rows = BN / wi;                   // image rows in the tile
  const int pw = wi + 2;                      // padded row length
  const int hw = h * wi;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int img0 = (n0 / hw) * hw;            // first position of the image
  const int r0 = (n0 - img0) / wi;            // first image row of the tile
  const int kdim = 9 * cin;

  // zero the halo tile once: its border cells are never written again
  const int x_bytes = (rows + 2) * pw * ROW;
  for (int i = tid * 16; i < x_bytes; i += THREADS * 16)
    *reinterpret_cast<uint4*>(Xs + i) = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // this lane's ldmatrix rows: A rows, and the padded halo position of the
  // B rows (output positions) of each pair of n8 fragments
  const int q = lane / 8;
  const int j = lane % 8;
  const int a_row = warp_m * 32 + (q & 1) * 8 + j;
  const int a_byte = (q >> 1) * 16;
  const int b_byte = (q & 1) * 16;
  int b_pos[NF / 2];
#pragma unroll
  for (int f2 = 0; f2 < NF / 2; ++f2) {
    const int p = warp_n * (BN / 4) + (2 * f2 + (q >> 1)) * 8 + j;
    b_pos[f2] = (p / wi) * pw + p % wi;
  }

  AccT acc[2][NF][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][f][e] = 0;

  for (int c0 = 0; c0 < cin; c0 += BK) {
    // weights of the nine taps: 16-byte pieces of each row's chunk
    constexpr int PIECES = BK * sizeof(T) / 16;
    for (int i = tid; i < 9 * BM * PIECES; i += THREADS) {
      const int piece = i % PIECES;
      const int row = (i / PIECES) % BM;
      const int tap = i / (PIECES * BM);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + row < cout)
        v = *(reinterpret_cast<const uint4*>(
                  w + (size_t)(m0 + row) * kdim + tap * cin + c0) + piece);
      *reinterpret_cast<uint4*>(As + (tap * BM + row) * ROW + piece * 16) = v;
    }
    // halo tile: CPW channels x 8 positions per unit, transposed to one
    // 32-bit word (CPW channels) per position
    const int units = (BK / CPW) * (rows + 2) * (wi / 8);
    for (int i = tid; i < units; i += THREADS) {
      const int seg = i % (wi / 8);
      const int pr = (i / (wi / 8)) % (rows + 2);
      const int g = i / ((wi / 8) * (rows + 2));
      const int ir = r0 - 1 + pr;            // image row
      if (ir < 0 || ir >= h) continue;       // stays zero
      const int pos = img0 + ir * wi + seg * 8;
      const bool own = blockIdx.y == 0 && pr >= 1 && pr <= rows;
      uint32_t word[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
        // 8 elements of this channel: 16 bytes of bf16 or 8 bytes of int8
        const V8 v = load(c0 + g * CPW + c, pos, own);
        const unsigned char* e = reinterpret_cast<const unsigned char*>(&v);
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          uint32_t bits = 0;
#pragma unroll
          for (int b = 0; b < (int)sizeof(T); ++b)
            bits |= (uint32_t)e[p * sizeof(T) + b] << (8 * b);
          word[p] |= bits << (8 * sizeof(T) * c);
        }
      }
      unsigned char* dst = Xs + (pr * pw + 1 + seg * 8) * ROW + g * 4;
#pragma unroll
      for (int p = 0; p < 8; ++p)
        *reinterpret_cast<uint32_t*>(dst + p * ROW) = word[p];
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * pw + tap % 3;
      const uint32_t a_base = smem_addr(As + (tap * BM + a_row) * ROW + a_byte);
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t a[2][4];
        ldmatrix_x4(a[0], a_base + ks * 32);
        ldmatrix_x4(a[1], a_base + 16 * ROW + ks * 32);
#pragma unroll
        for (int f2 = 0; f2 < NF / 2; ++f2) {
          uint32_t b[4];
          ldmatrix_x4(b, smem_addr(Xs + (b_pos[f2] + shift) * ROW + b_byte) +
                             ks * 32);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_step(acc[mi][2 * f2], a[mi], b[0], b[1]);
            mma_step(acc[mi][2 * f2 + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();
  }

  // accumulators -> shared tile -> epilogue
  constexpr int CLD = BN + 4;
  AccT* Cs = reinterpret_cast<AccT*>(smem);
  const int g = lane / 4;
  const int t2 = (lane % 4) * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int row = warp_m * 32 + mi * 16 + g;
      const int col = warp_n * (BN / 4) + f * 8 + t2;
      Cs[row * CLD + col] = acc[mi][f][0];
      Cs[row * CLD + col + 1] = acc[mi][f][1];
      Cs[(row + 8) * CLD + col] = acc[mi][f][2];
      Cs[(row + 8) * CLD + col + 1] = acc[mi][f][3];
    }
  __syncthreads();
  epi.tile(Cs, CLD, BN, m0, n0, cout, n);
}

// Largest row tile (64, 128 or 256 positions of whole rows of one image)
// for this geometry, or 0 when there is none (W % 8 != 0). The port's
// Python side mirrors it (ops/cuda/fused_block.py _conv_blocks).
inline int row_tile(int h, int wi) {
  if (wi % 8 != 0) return 0;
  int best = 0;
  for (int r = 1; r <= h; ++r) {
    const int bn = r * wi;
    if (h % r == 0 && (bn == 64 || bn == 128 || bn == 256) && bn > best)
      best = bn;
  }
  return best;
}

template <typename T, int BN, typename Epi, typename Load>
int launch_rows(const Load& load, const void* w, const Epi& epi, int cin,
                int cout, int n, int h, int wi, cudaStream_t stream) {
  static int smem_set = 0;  // dynamic shared memory opted into so far
  const int bytes = row_tile_smem_bytes<T, BN>(wi);
  if (bytes > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_rows_kernel<T, BN, Epi, Load>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = bytes;
  }
  const dim3 grid(n / BN, (cout + BM - 1) / BM);
  conv3x3_rows_kernel<T, BN, Epi, Load><<<grid, THREADS, bytes, stream>>>(
      load, static_cast<const T*>(w), epi, cin, cout, n, h, wi);
  return static_cast<int>(cudaGetLastError());
}

// The row-tile launch for this geometry with the operand loader ``load``,
// or -1 when W % 8 != 0.
template <typename T, typename Epi, typename Load>
int launch_row_tiles_with(const Load& load, const void* w, const Epi& epi,
                          int cin, int cout, int n, int h, int wi,
                          cudaStream_t stream) {
  switch (row_tile(h, wi)) {
    case 256:
      return launch_rows<T, 256>(load, w, epi, cin, cout, n, h, wi, stream);
    case 128:
      return launch_rows<T, 128>(load, w, epi, cin, cout, n, h, wi, stream);
    case 64:
      return launch_rows<T, 64>(load, w, epi, cin, cout, n, h, wi, stream);
    default:
      return -1;
  }
}

// ... reading the operand x [cin, n] as it is.
template <typename T, typename Epi>
int launch_row_tiles(const void* x, const void* w, const Epi& epi, int cin,
                     int cout, int n, int h, int wi, cudaStream_t stream) {
  return launch_row_tiles_with<T>(RawLoad<T>{static_cast<const T*>(x), n},
                                  w, epi, cin, cout, n, h, wi, stream);
}

}  // namespace conv3x3
