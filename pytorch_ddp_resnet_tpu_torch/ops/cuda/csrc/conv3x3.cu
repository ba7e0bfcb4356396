// Stride-1 SAME 3x3 convolutions in the channel-major layout [C, B*H*W],
// written for Hopper (sm_90a), bound to Python through a plain C interface
// (ops/cuda/conv3x3.py loads this file's shared library with ctypes).
//
// What they replace (pytorch_ddp_resnet_tpu/ops/pallas/conv.py):
//   conv3x3_bf16_launch          <- conv3x3_lanes, body _conv_kernel
//                                   (bf16 in, f32 accumulate, bf16 out; the
//                                   float calibration pass of int8 serving)
//   conv3x3_int8_requant_launch  <- conv3x3_lanes_requant, body
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
// What the design does about it: an implicit GEMM, out[Cout, N] =
// W[Cout, 9*Cin] x patches[9*Cin, N], on the tensor cores (mma.sync, f32
// or s32 accumulators in registers); the patch matrix is never written,
// and the whole epilogue runs on the accumulator tile in shared memory, so
// the s32 accumulator never reaches device memory (the round trip the TPU
// kernel's fused epilogue also removes). Two tilings:
//
// - Row tiles (the WRN shapes: W % 8 == 0). A block owns 64 output
//   channels x R whole image rows (64, 128 or 256 positions). For each
//   32-channel chunk it copies the rows it needs, plus one halo row above
//   and below, into shared memory once, channels innermost and with a zero
//   column on each side; every tap is then a pure address shift into that
//   tile (no masks), read with ldmatrix. The weights of all nine taps of
//   the chunk are staged beside it, so a chunk costs two barriers for nine
//   taps of tensor-core work.
// - General (any other W): the first version, kept for shapes the row
//   tiles cannot cover. Per 32-row contraction slice it gathers each
//   tap's shifted, border-masked columns from device memory element by
//   element (WMMA 16x16x16 tiles). Measured far slower (PERF.md).
//
// The TPU kernel's 640-lane tap grouping and roll-and-mask patches are MXU
// and VMEM choices and are not carried over. Not done yet (later work):
// wgmma, TMA and a multi-stage shared-memory pipeline.
//
// Rounding follows the JAX reference: the epilogue multiplies and adds with
// __fmul_rn/__fadd_rn (no FMA contraction, as the reference's separate
// f32 ops), rounds half to even with rintf, and converts s32 -> f32 with
// round-to-nearest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

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

// --- epilogues: one output element from its accumulator ----------------------

struct Bf16Out {
  __nv_bfloat16* out;
  __device__ __forceinline__ void operator()(float acc, int, size_t idx) const {
    out[idx] = __float2bfloat16_rn(acc);
  }
};

__device__ __forceinline__ signed char quant_s8(float v) {
  const float q = fminf(fmaxf(rintf(v), -127.f), 127.f);
  return (signed char)__float2int_rn(q);
}

struct Requant {
  const float* scale;
  const float* shift;
  const __nv_bfloat16* res;  // or null
  const float* sb;           // dual mode: sb, tb, out2 non-null
  const float* tb;
  void* out;                 // int8 when out_int8, else bf16
  signed char* out2;
  int relu;
  int out_int8;
  float inv_out_scale;

  __device__ __forceinline__ void operator()(int acc, int co,
                                             size_t idx) const {
    float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale[co]), shift[co]);
    if (res != nullptr) y = __fadd_rn(y, __bfloat162float(res[idx]));
    if (relu) y = fmaxf(y, 0.f);
    if (out_int8) {
      static_cast<signed char*>(out)[idx] =
          quant_s8(__fmul_rn(y, inv_out_scale));
    } else {
      static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(y);
    }
    if (out2 != nullptr)
      out2[idx] = quant_s8(fmaxf(__fadd_rn(__fmul_rn(y, sb[co]), tb[co]), 0.f));
  }
};

// Apply the epilogue to a [BM, bn] accumulator tile Cs (row stride cld)
// whose column c is position n0 + c; threads walk the tile along positions
// so the stores coalesce.
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

// --- row tiles: halo tile in shared memory, ldmatrix + mma.sync --------------

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

template <typename T, int BN, typename Epi>
__global__ void __launch_bounds__(THREADS)
conv3x3_rows_kernel(const T* __restrict__ x, const T* __restrict__ w,
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
      const T* src = x + (size_t)(c0 + g * CPW) * n + img0 + ir * wi + seg * 8;
      uint32_t word[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
        // 8 elements of this channel: 16 bytes of bf16 or 8 bytes of int8
        const V8 v = *reinterpret_cast<const V8*>(src + (size_t)c * n);
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
  epilogue(Cs, CLD, BN, m0, n0, cout, n, epi);
}

// Largest row tile (64, 128 or 256 positions of whole rows of one image)
// for this geometry, or 0 when there is none (W % 8 != 0).
int row_tile(int h, int wi) {
  if (wi % 8 != 0) return 0;
  int best = 0;
  for (int r = 1; r <= h; ++r) {
    const int bn = r * wi;
    if (h % r == 0 && (bn == 64 || bn == 128 || bn == 256) && bn > best)
      best = bn;
  }
  return best;
}

template <typename T, int BN, typename Epi>
int launch_rows(const void* x, const void* w, const Epi& epi, int cin,
                int cout, int n, int h, int wi, cudaStream_t stream) {
  static int smem_set = 0;  // dynamic shared memory opted into so far
  const int bytes = row_tile_smem_bytes<T, BN>(wi);
  if (bytes > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_rows_kernel<T, BN, Epi>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = bytes;
  }
  const dim3 grid(n / BN, (cout + BM - 1) / BM);
  conv3x3_rows_kernel<T, BN, Epi><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), epi, cin, cout, n,
      h, wi);
  return static_cast<int>(cudaGetLastError());
}

// --- general: per-slice gather from device memory, WMMA ----------------------

constexpr int GBN = 128;       // spatial positions per block
constexpr int GCLD = GBN + 4;  // row stride of the accumulator tile

// Operand tiles are stored in 16-wide column blocks so every WMMA fragment
// starts on a 32-byte boundary for both element types:
//   A: [BK/16][BM][16] (row m, contraction k)
//   B: [GBN/16][BK][16] (contraction k, column n)
template <typename T>
struct Tiles {
  static constexpr int kABytes = BK * BM * sizeof(T);
  static constexpr int kBBytes = BK * GBN * sizeof(T);
  static constexpr int kCBytes = BM * GCLD * 4;
  static constexpr int kBytes = (kABytes + kBBytes > kCBytes)
                                    ? kABytes + kBBytes : kCBytes;
};

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ __nv_bfloat16 zero_of() {
  return __float2bfloat16_rn(0.f);
}
template <> __device__ __forceinline__ signed char zero_of() { return 0; }

template <typename T, typename Epi>
__global__ void __launch_bounds__(THREADS)
conv3x3_general_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       Epi epi, int cin, int cout, int n, int h, int wi) {
  using AccT = typename Acc<T>::type;
  using V = typename Vec8<T>::type;
  __shared__ __align__(128) unsigned char smem[Tiles<T>::kBytes];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + Tiles<T>::kABytes);
  AccT* Cs = reinterpret_cast<AccT*>(smem);
  const int n0 = blockIdx.x * GBN;
  const int m0 = blockIdx.y * BM;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warp_m = warp / 4;  // 0..1 -> rows warp_m*32
  const int warp_n = warp % 4;  // 0..3 -> cols warp_n*32
  const int kdim = 9 * cin;

  // A loader: one row, 8 contiguous contraction elements per thread
  const int a_row = tid / 4;
  const int a_k = (tid % 4) * 8;
  const bool a_ok = (m0 + a_row) < cout;
  const T* a_src = w + (size_t)(m0 + a_row) * kdim + a_k;
  T* a_dst = As + ((a_k / 16) * BM + a_row) * 16 + (a_k % 16);

  // B loader: one column, rows b_r0, b_r0 + 2, ... of the 32-row slice
  const int b_col = tid % GBN;
  const int b_r0 = tid / GBN;
  const int col_n = n0 + b_col;
  const bool col_ok = col_n < n;
  const int hw = h * wi;
  const int pos = col_ok ? col_n % hw : 0;
  const int hh = pos / wi;
  const int ww = pos % wi;
  T* b_dst = Bs + ((b_col / 16) * BK + b_r0) * 16 + (b_col % 16);

  wmma::fragment<wmma::accumulator, 16, 16, 16, AccT> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], (AccT)0);

  const T zero = zero_of<T>();
  for (int tap = 0; tap < 9; ++tap) {
    const int dh = tap / 3 - 1;
    const int dw = tap % 3 - 1;
    const bool valid = col_ok && (unsigned)(hh + dh) < (unsigned)h &&
                       (unsigned)(ww + dw) < (unsigned)wi;
    const long src = (long)col_n + dh * wi + dw;
    for (int c0 = 0; c0 < cin; c0 += BK) {
      V av = {};
      if (a_ok) av = *reinterpret_cast<const V*>(a_src + tap * cin + c0);
      *reinterpret_cast<V*>(a_dst) = av;
      const T* xs = x + (size_t)(c0 + b_r0) * n + src;
#pragma unroll
      for (int r = 0; r < BK / 2; ++r)
        b_dst[r * 2 * 16] = valid ? xs[(size_t)r * 2 * n] : zero;
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(
              fa[i], As + (kk * BM + warp_m * 32 + i * 16) * 16, 16);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(
              fb[j], Bs + ((warp_n * 2 + j) * BK + kk * 16) * 16, 16);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          Cs + (warp_m * 32 + i * 16) * GCLD + warp_n * 32 + j * 16,
          acc[i][j], GCLD, wmma::mem_row_major);
  __syncthreads();
  epilogue(Cs, GCLD, GBN, m0, n0, cout, n, epi);
}

template <typename T, typename Epi>
int launch(const void* x, const void* w, const Epi& epi, int cin, int cout,
           int n, int h, int wi, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (row_tile(h, wi)) {
    case 256:
      return launch_rows<T, 256>(x, w, epi, cin, cout, n, h, wi, stream);
    case 128:
      return launch_rows<T, 128>(x, w, epi, cin, cout, n, h, wi, stream);
    case 64:
      return launch_rows<T, 64>(x, w, epi, cin, cout, n, h, wi, stream);
    default:
      break;
  }
  const dim3 grid((n + GBN - 1) / GBN, (cout + BM - 1) / BM);
  conv3x3_general_kernel<T, Epi><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), epi, cin, cout, n,
      h, wi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [cin, n] bf16, w [cout, 9*cin] bf16 (taps row-major in (dh, dw), then
// input channel), out [cout, n] bf16; n a multiple of h*wi. cin % 32 == 0;
// the pointers to x and w are 16-byte aligned. Returns the launch's
// cudaError_t.
int conv3x3_bf16_launch(const void* x, const void* w, void* out, int cin,
                        int cout, int n, int h, int wi, void* stream) {
  const Bf16Out epi{static_cast<__nv_bfloat16*>(out)};
  return launch<__nv_bfloat16>(x, w, epi, cin, cout, n, h, wi, stream);
}

// x [cin, n] int8, w [cout, 9*cin] int8, scale/shift [cout] f32, res
// [cout, n] bf16 or null, sb/tb [cout] f32 or null (dual mode: out2
// [cout, n] int8), out [cout, n] int8 when out_int8 else bf16.
int conv3x3_int8_requant_launch(const void* x, const void* w,
                                const void* scale, const void* shift,
                                const void* res, const void* sb,
                                const void* tb, void* out, void* out2,
                                int cin, int cout, int n, int h, int wi,
                                int relu, int out_int8, float inv_out_scale,
                                void* stream) {
  const Requant epi{static_cast<const float*>(scale),
                    static_cast<const float*>(shift),
                    static_cast<const __nv_bfloat16*>(res),
                    static_cast<const float*>(sb),
                    static_cast<const float*>(tb),
                    out,
                    static_cast<signed char*>(out2),
                    relu,
                    out_int8,
                    inv_out_scale};
  return launch<signed char>(x, w, epi, cin, cout, n, h, wi, stream);
}

}  // extern "C"
