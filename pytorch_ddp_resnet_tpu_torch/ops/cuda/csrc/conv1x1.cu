// Int8 1x1 convolution (a pointwise matrix product) with the
// requantization epilogue, in the channel-major layout [C, B*H*W], written
// for Hopper (sm_90a) and bound to Python through a plain C interface
// (ops/cuda/conv1x1.py loads this file's shared library with ctypes).
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/conv1x1.py):
//   conv1x1_requant_launch <- conv1x1_lanes_requant, body
//                             _mm_requant_kernel: out[Cout, N] = W[Cout,
//                             Cin] x x[Cin, N], s8 x s8 -> s32, then the
//                             epilogue of requant.cuh (scale, shift, the
//                             bf16 residual, relu, int8 at inv_out_scale or
//                             bf16, and the dual int8 output)
//
// What bounds it on an H100: at ResNet-50's 1x1 shapes (batch 128) one
// call is 2 * Cin * Cout * N = 3.3-13.2 GOP (at most 0.0067 ms at 1979
// TOP/s of int8) against 26-130 MB of activations (0.008-0.039 ms at 3.35
// TB/s): it is bound by bytes. So the design reads x and writes the output
// once, and keeps the s32 accumulator out of device memory.
//
// Design: a block owns 64 output channels x 128 positions and contracts in
// chunks of 64 input channels with mma.sync m16n8k32 (s8, s32
// accumulators in registers; 8 warps, 2 along channels x 4 along
// positions). The tensor cores take B with the contraction innermost, and
// x has the positions innermost, so the staging transposes x: each thread
// reads 8 positions of 4 channels and writes 8 32-bit words, one per
// position, of 4 channels each. The next chunk is loaded into registers
// while the tensor cores work on this one (two shared buffers, one barrier
// per chunk). After the contraction the accumulator tile goes through
// shared memory to the per-element epilogue, so the stores coalesce along
// positions. The TPU kernel's 128-lane tiles (pick_tile_dense) are VMEM
// choices and are not carried over. Not done yet (later work): cp.async or
// TMA staging, wgmma, vectorized epilogue stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"  // BM, THREADS, ldmatrix_x4, mma_step, epilogue
#include "requant.cuh"

using namespace conv3x3;

namespace {

constexpr int BN = 128;           // positions per block
constexpr int KC = 64;            // input channels per chunk
constexpr int ROW = KC + 16;      // bytes per staged row: banks apart
constexpr int A_BYTES = BM * ROW;
constexpr int B_BYTES = BN * ROW;
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int CLD = BN + 4;       // row stride of the accumulator tile
constexpr int SMEM = (2 * STAGE > BM * CLD * 4) ? 2 * STAGE : BM * CLD * 4;

// One thread's share of a chunk: 16 bytes of W and 4 channels x 8
// positions of x.
struct ChunkRegs {
  uint4 a;
  uint2 b[4];
};

__device__ __forceinline__ void load_chunk(ChunkRegs& r,
                                           const signed char* __restrict__ w,
                                           const signed char* __restrict__ x,
                                           int c0, int m0, int n0, int cin,
                                           int cout, int n) {
  const int tid = threadIdx.x;
  // W: row tid / 4, bytes (tid % 4) * 16 of the chunk (cin % 32 == 0, so a
  // 16-byte piece lies wholly inside or outside the contraction)
  const int row = tid / 4;
  const int k = c0 + (tid % 4) * 16;
  r.a = make_uint4(0, 0, 0, 0);
  if (m0 + row < cout && k < cin)
    r.a = *reinterpret_cast<const uint4*>(w + (size_t)(m0 + row) * cin + k);
  // x: channel group tid % 16 (4 channels), position octet tid / 16
  const int ch = c0 + (tid % 16) * 4;
  const int pos = n0 + (tid / 16) * 8;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    r.b[c] = make_uint2(0, 0);
    if (ch + c < cin)
      r.b[c] = *reinterpret_cast<const uint2*>(x + (size_t)(ch + c) * n + pos);
  }
}

__device__ __forceinline__ void store_chunk(const ChunkRegs& r,
                                            unsigned char* stage) {
  const int tid = threadIdx.x;
  *reinterpret_cast<uint4*>(stage + (tid / 4) * ROW + (tid % 4) * 16) = r.a;
  // transpose 4 channels x 8 positions into one word per position
  unsigned char* bs = stage + A_BYTES;
  const int g = tid % 16;
  const int p0 = (tid / 16) * 8;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int half = p / 4;
    const int sh = 8 * (p % 4);
    uint32_t word = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t v = half ? r.b[c].y : r.b[c].x;
      word |= ((v >> sh) & 0xffu) << (8 * c);
    }
    *reinterpret_cast<uint32_t*>(bs + (p0 + p) * ROW + g * 4) = word;
  }
}

template <typename Epi>
__global__ void __launch_bounds__(THREADS)
conv1x1_kernel(const signed char* __restrict__ x,
               const signed char* __restrict__ w, Epi epi, int cin, int cout,
               int n) {
  constexpr int NF = BN / 32;  // n8 fragments per warp
  __shared__ __align__(128) unsigned char smem[SMEM];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int warp_m = warp / 4;
  const int warp_n = warp % 4;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  // this lane's ldmatrix rows: A rows, B positions
  const int q = lane / 8;
  const int j = lane % 8;
  const int a_off = (warp_m * 32 + (q & 1) * 8 + j) * ROW + (q >> 1) * 16;
  int b_off[NF / 2];
#pragma unroll
  for (int f2 = 0; f2 < NF / 2; ++f2)
    b_off[f2] = A_BYTES +
                (warp_n * (BN / 4) + (2 * f2 + (q >> 1)) * 8 + j) * ROW +
                (q & 1) * 16;

  int acc[2][NF][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][f][e] = 0;

  ChunkRegs regs;
  load_chunk(regs, w, x, 0, m0, n0, cin, cout, n);
  store_chunk(regs, smem);
  __syncthreads();
  const int chunks = (cin + KC - 1) / KC;
  for (int kc = 0; kc < chunks; ++kc) {
    unsigned char* cur = smem + (kc % 2) * STAGE;
    if (kc + 1 < chunks)
      load_chunk(regs, w, x, (kc + 1) * KC, m0, n0, cin, cout, n);
    const uint32_t base = smem_addr(cur);
#pragma unroll
    for (int ks = 0; ks < KC / 32; ++ks) {
      uint32_t a[2][4];
      ldmatrix_x4(a[0], base + a_off + ks * 32);
      ldmatrix_x4(a[1], base + a_off + 16 * ROW + ks * 32);
#pragma unroll
      for (int f2 = 0; f2 < NF / 2; ++f2) {
        uint32_t b[4];
        ldmatrix_x4(b, base + b_off[f2] + ks * 32);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_step(acc[mi][2 * f2], a[mi], b[0], b[1]);
          mma_step(acc[mi][2 * f2 + 1], a[mi], b[2], b[3]);
        }
      }
    }
    if (kc + 1 < chunks) store_chunk(regs, smem + ((kc + 1) % 2) * STAGE);
    __syncthreads();
  }

  // accumulators -> shared tile -> epilogue
  int* Cs = reinterpret_cast<int*>(smem);
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

}  // namespace

extern "C" {

// x [cin, n] int8, w [cout, cin] int8, scale/shift [cout] f32, res [cout,
// n] bf16 or null, sb/tb [cout] f32 or null (dual mode: out2 [cout, n]
// int8), out [cout, n] int8 when out_int8 else bf16. cin % 32 == 0, n %
// 128 == 0; the pointers 16-byte aligned. Returns the launch's
// cudaError_t.
int conv1x1_requant_launch(const void* x, const void* w, const void* scale,
                           const void* shift, const void* res, const void* sb,
                           const void* tb, void* out, void* out2, int cin,
                           int cout, int n, int relu, int out_int8,
                           float inv_out_scale, void* stream) {
  const Requant epi = make_requant(scale, shift, res, sb, tb, out, out2,
                                   relu, out_int8, inv_out_scale);
  const dim3 grid(n / BN, (cout + BM - 1) / BM);
  conv1x1_kernel<Requant><<<grid, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(x), static_cast<const signed char*>(w),
      epi, cin, cout, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
