// The bf16 weight gradient of a stride-1 SAME 3x3 convolution in the
// channel-major layout [C, B*H*W]. It has one user, conv3x3_wgrad.cu (raw
// operands); the fused block-half's wgrad (fused_block_bf16.cu), its other
// user until then, now writes its operands once and contracts them on
// wgrad_staged.cuh's mainloop, where conv3x3_wgrad.cu can follow with a
// transposing prepass.
//
// A GEMM over positions, dW[co, (tap, ci)] = sum_n g[co, n] * d[ci, n +
// shift(tap)], on the tensor cores (mma.sync m16n8k16, f32 accumulators in
// registers): a block owns 64 output channels x (9 taps x 32 input
// channels) and walks its split of the positions in chunks of 256,
// staging g [64][256] and, for its 32 input channels, three copies of the
// chunk's rows of d with a halo row above and below, each shifted by one
// column (dw = 0, 1, 2) with zeros where the column leaves the image;
// every tap is then an aligned 4-byte read at a row offset. Each split's
// f32 tile goes to its slot of a partial buffer; the caller adds the
// slots in order (common.cuh partial_sum), so the sum's order is fixed.
//
// The operands are functors returning 8 bf16 (one uint4) at 8 consecutive
// positions of one channel:
//   gload(co, pos)  -> g[co, pos .. pos + 7]
//   dload(ci, pos)  -> d[ci, pos .. pos + 7]
// Geometry: cin % 32 == 0, wi % 8 == 0, wi <= 32, the split's span a
// multiple of 256, and 256 a multiple of h * wi or the reverse.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_rows.cuh"

namespace wgrad_bf16 {

using conv3x3::BM;
using conv3x3::THREADS;

constexpr int WG_CI = 32;                  // input channels per block
constexpr int WG_KC = 256;                 // positions per staging chunk
constexpr int WG_APITCH = 2 * WG_KC + 16;  // bytes per row of the g tile

// Chunk geometry: rc image rows of ic images (rc * wi * ic == WG_KC).
struct Chunk {
  int rc, ic;
};

__host__ __device__ inline Chunk chunk_of(int h, int wi) {
  const int hw = h * wi;
  return hw >= WG_KC ? Chunk{WG_KC / wi, 1} : Chunk{h, WG_KC / hw};
}

// bytes per (dw, ci) row of the shifted copies: ic * (rc + 2) rows of wi
// bf16, padded to 4 mod 32 words so the fragment reads of a warp hit
// distinct banks
__host__ __device__ inline int copy_pitch(Chunk k, int wi) {
  int words = k.ic * (k.rc + 2) * wi / 2;
  words += (4 - words % 32 + 32) % 32;
  return words * 4;
}

inline int smem_bytes(int h, int wi) {
  return BM * WG_APITCH + 3 * WG_CI * copy_pitch(chunk_of(h, wi), wi);
}

template <typename GLoad, typename DLoad>
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(GLoad gload, DLoad dload, float* __restrict__ part, int cout,
             int cin, int n, int h, int wi, int span) {
  using conv3x3::ldmatrix_x4;
  using conv3x3::mma_step;
  using conv3x3::smem_addr;
  extern __shared__ __align__(128) unsigned char smem[];
  const Chunk ck = chunk_of(h, wi);
  const int bpitch = copy_pitch(ck, wi);
  unsigned char* As = smem;                          // [BM][WG_APITCH]
  unsigned char* Bs = smem + BM * WG_APITCH;         // [3][WG_CI][bpitch]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int warp_m = warp / 4;
  const int warp_n = warp % 4;
  const int ci0 = blockIdx.x * WG_CI;
  const int m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int hw = h * wi;
  const int slot_rows = ck.rc + 2;

  // ldmatrix rows of A (as conv3x3_rows.cuh) and the shifted-copy byte
  // address of each of this warp's 9 B fragments (fragment F = tap * 4 +
  // ci octet; lane / 4 picks the column, (lane % 4) * 2 the position pair)
  const int q = lane / 8;
  const int a_row = warp_m * 32 + (q & 1) * 8 + lane % 8;
  const int a_byte = (q >> 1) * 16;
  int b_base[9];
#pragma unroll
  for (int f = 0; f < 9; ++f) {
    const int F = warp_n * 9 + f;
    const int tap = F / 4;
    const int dh = tap / 3, dw = tap % 3;
    b_base[f] = (dw * WG_CI + (F % 4) * 8 + lane / 4) * bpitch +
                2 * dh * wi + (lane % 4) * 4;
  }

  float acc[2][9][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int f = 0; f < 9; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][f][e] = 0.f;

  for (int p0 = split * span; p0 < (split + 1) * span; p0 += WG_KC) {
    __syncthreads();
    // g chunk: [64 output channels][256 positions], 8 per unit
    for (int i = tid; i < BM * (WG_KC / 8); i += THREADS) {
      const int row = i / (WG_KC / 8);
      const int piece = i % (WG_KC / 8);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + row < cout) v = gload(m0 + row, (size_t)p0 + piece * 8);
      *reinterpret_cast<uint4*>(As + row * WG_APITCH + piece * 16) = v;
    }
    // shifted copies of d: unit = (ci, image slot row); each loads one
    // image row (wi bf16) and writes it shifted by dw - 1 columns,
    // zero-filled
    const int img0 = p0 / hw;
    const int row0 = (p0 - img0 * hw) / wi;
    const int nw = wi / 2;  // 32-bit words per image row
    const int units = WG_CI * ck.ic * slot_rows;
    for (int i = tid; i < units; i += THREADS) {
      const int sr = i % (ck.ic * slot_rows);
      const int ci = i / (ck.ic * slot_rows);
      const int img = img0 + sr / slot_rows;
      const int ir = row0 - 1 + sr % slot_rows;
      // w[1 + k] = columns 2k, 2k+1 of the row; w[0], w[nw + 1] = 0
      uint32_t w[18];
#pragma unroll
      for (int k = 0; k < 18; ++k) w[k] = 0;
      if (ir >= 0 && ir < h) {
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (8 * s < wi) {
            const uint4 v = dload(ci0 + ci, img * hw + ir * wi + 8 * s);
            w[1 + 4 * s] = v.x;
            w[2 + 4 * s] = v.y;
            w[3 + 4 * s] = v.z;
            w[4 + 4 * s] = v.w;
          }
      }
      unsigned char* dst = Bs + ci * bpitch + 2 * sr * wi;
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (k < nw) {
          // dw = 0 reads column c - 1, dw = 2 column c + 1 (little endian:
          // the low half of a word is its even column)
          *reinterpret_cast<uint32_t*>(dst + 4 * k) =
              __funnelshift_l(w[k], w[k + 1], 16);
          *reinterpret_cast<uint32_t*>(dst + WG_CI * bpitch + 4 * k) = w[k + 1];
          *reinterpret_cast<uint32_t*>(dst + 2 * WG_CI * bpitch + 4 * k) =
              __funnelshift_r(w[k + 1], w[k + 2], 16);
        }
    }
    __syncthreads();

#pragma unroll 1
    for (int ks = 0; ks < WG_KC / 16; ++ks) {
      // positions ks*16 .. ks*16+15 lie in one image slot of the copies
      const int k0 = ks * 16;
      const int koff = 2 * (k0 + (k0 / (ck.rc * wi)) * 2 * wi);
      uint32_t a[2][4];
      const uint32_t a_base = smem_addr(As + a_row * WG_APITCH + a_byte) +
                              ks * 32;
      ldmatrix_x4(a[0], a_base);
      ldmatrix_x4(a[1], a_base + 16 * WG_APITCH);
#pragma unroll
      for (int f = 0; f < 9; ++f) {
        const unsigned char* bp = Bs + b_base[f] + koff;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 16);
        mma_step(acc[0][f], a[0], b0, b1);
        mma_step(acc[1][f], a[1], b0, b1);
      }
    }
  }

  // the split's tile into its slot of the partial buffer; columns (dh, dw,
  // ci) as JAX's [Cout, 9 * Cin] weight-gradient layout
  const size_t kdim = (size_t)9 * cin;
  float* out = part + (size_t)split * cout * kdim;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int f = 0; f < 9; ++f) {
      const int F = warp_n * 9 + f;
      const int col = (F / 4) * cin + ci0 + (F % 4) * 8 + (lane % 4) * 2;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = m0 + warp_m * 32 + mi * 16 + lane / 4 + hi * 8;
        if (row < cout) {
          out[row * kdim + col] = acc[mi][f][2 * hi];
          out[row * kdim + col + 1] = acc[mi][f][2 * hi + 1];
        }
      }
    }
}

// part [splits][cout][9 * cin] f32, split s covering positions [s * span,
// (s + 1) * span) with span = n / splits. Returns the launch's cudaError_t.
template <typename GLoad, typename DLoad>
int launch(const GLoad& gload, const DLoad& dload, float* part, int cout,
           int cin, int n, int h, int wi, int splits, cudaStream_t stream) {
  static int smem_set = 0;  // dynamic shared memory opted into so far
  const int bytes = smem_bytes(h, wi);
  if (bytes > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgrad_kernel<GLoad, DLoad>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = bytes;
  }
  const dim3 grid(cin / WG_CI, (cout + BM - 1) / BM, splits);
  wgrad_kernel<GLoad, DLoad><<<grid, THREADS, bytes, stream>>>(
      gload, dload, part, cout, cin, n, h, wi, n / splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgrad_bf16
