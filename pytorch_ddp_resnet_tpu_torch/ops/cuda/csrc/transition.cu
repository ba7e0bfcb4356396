// Stage-transition half with an int8 stride-2 conv core, forward and both
// backward bodies, in the channel-major layout [C, B*H*W], written for
// Hopper (sm_90a) and bound to Python through a plain C interface
// (ops/cuda/transition.py loads this file's library with ctypes).
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/transition.py,
// transition_half_int8):
//   fwd_launch             <- _fwd_call -> _fwd_kernel (site :357), after
//                             the prologue's quantization, which is the
//                             fused half's fwd_amax/fwd_quant
//                             (fused_block.cu) run with the
//                             transition's scale groups
//   bwd_amax, bwd_quant    <- the cotangent fold and the per-tile
//                             quantizers of _bwd_kernel (site :619, FQT)
//   bwd_fold               <- its straight-through cotangent fold and bf16
//                             prologue recomputation
//   dgrad_launch           <- its per-plane dgrad, masks, norm1 chain,
//                             shortcut cotangent and d(scale)/d(shift)
//   wgrad_launch           <- its wgrad (both bodies) and dWp
//   partial_sum            <- the TPU kernels' sums carried across their
//                             sequential grid
//
// The reference splits the input into four parity planes so that every
// tap of the stride-2 conv becomes a lane roll on the TPU. Here the taps
// are indexed directly:
// - The forward is a row-tile implicit GEMM (mma.sync, as
//   conv3x3_rows.cuh) whose block owns 64 output channels x R whole output
//   rows of one image (64 or 128 positions, so that two blocks share an
//   SM); it stages the 2R + 1 input rows those rows read
//   (with zero borders) per 32-channel chunk, and output position (r, c)
//   reads tap (dh, dw) at staged cell (2r + dh, 2c + dw): every ldmatrix
//   row address is per lane, so the stride costs nothing but the staging.
//   The same block then contracts the 1x1 projection of the even-even
//   pixels (bf16, one centre tap of the same geometry), or copies them
//   (option A), and sums z and z^2 per channel.
// - The dgrad is the same contraction per parity class of input pixel
//   (blockIdx.z = 2 * (ih % 2) + (iw % 2)): a pixel of class p receives
//   the 1, 2, 2 or 4 taps of that class, each from the cotangent at the
//   output pixel (i + sh, j + sw), sh, sw in {0, 1}; so the block is a
//   stride-1 contraction at the output geometry over just those taps. Its
//   epilogue recomputes the relu/dropout masks and the norm1 chain from x,
//   adds the shortcut's cotangent on class 0 (a second bf16 contraction
//   of Wp^T @ dres, or dres itself for option A) and sums d(scale) and
//   d(shift).
// - The wgrad is a GEMM over output positions, dW[co, (tap, ci)] =
//   sum_p g[co, p] * d[ci, src(p, tap)]: a block owns 64 output channels
//   x (taps x 32 input channels) and walks its span of positions in
//   chunks, staging g and gathering the taps' source values (the int8 d
//   of the FQT quantizer, the bf16 d of the straight-through fold, or the
//   raw even-even x for dWp) through a per-chunk table of each (tap,
//   position)'s source lane, zero outside the image. Each span's f32 tile
//   goes to its slot of a partial buffer (FQT: one span per scale group,
//   its s32 sum times the group's scale) and partial_sum adds the slots
//   in order.
//
// Scale groups: the quantizers take one absmax per group of whole images
// (the reference's transition_tile of output lanes; 4x as many input
// lanes). They are fused_half.cuh's amax and quant kernels, which
// fused_block.cu runs too, each operand walking its own group width:
// *_amax writes partial maxima per (group, slice) block, *_quant reduces
// them and quantizes.
//
// Rounding points (the reference as XLA computes it on the CPU, where the
// tests run it; tests/test_torch_transition.py pins them): the prologue
// x * scale + shift and the mask's affine are one fma each; dropout keeps
// r * f32(256 / thresh); the stats fold (dz + dzsum) + (2z) * dzssq is one
// fma; the even-even dx is fma(dn, scale, shortcut cotangent); every
// other product and sum rounds on its own (__fmul_rn / __fadd_rn).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "conv3x3_rows.cuh"
#include "fused_half.cuh"
#include "seed_bits.cuh"

using namespace conv3x3;
using dropout::DropBits;
using fused_half::Bf16Prologue;
using fused_half::Cotangent;
using fused_half::GroupWalk;
using fused_half::kBwdFloor;
using fused_half::load8;
using fused_half::pack8;
using fused_half::Prologue;
using fused_half::QuantOut;
using fused_half::tile_sums;

namespace {

typedef __nv_bfloat16 bf16;

// --- the strided implicit-GEMM contraction ----------------------------------

// Output position (r, c) of the block's grid reads tap t of the source
// image (sh x sw) at (S * (r0 + r) + dr[t], S * c + dc[t]); the tap's
// weights start at column wcol[t] of w (rows of kdim elements).
struct Taps {
  int n;
  int dr[9], dc[9], wcol[9];
};

struct Geo {
  int S;       // stride of the output grid in the source
  int sh, sw;  // source image
  int ow;      // output grid width
};

// staged source rows and the bytes of one contraction's shared memory
__host__ __device__ inline int staged_rows(int S, int rows) {
  return S * (rows - 1) + 3;
}

template <typename T>
__host__ __device__ inline int stage_bytes(int ntaps, int S, int rows,
                                           int sw) {
  return ntaps * BM * row_bytes<T>() +
         staged_rows(S, rows) * (sw + 2) * row_bytes<T>();
}

// acc[mi][f][e] += the block's tile of sum over taps and channels of
// w[m0 + row][wcol[t] + k] * src[k][cell(position, t)], the 64 x BN tile of
// rows m0.. of w against the block's BN positions (R = BN / ow rows from
// row r0 of image img), staged through smem (weights, then the halo).
template <typename T, int BN, typename Load>
__device__ __forceinline__ void contract(
    const Load& load, const T* __restrict__ w, int kdim, int ck, int m_rows,
    int m0, const Taps& taps, const Geo& g, int img, int r0,
    unsigned char* smem, typename Acc<T>::type (&acc)[2][BN / 32][4]) {
  constexpr int ROW = row_bytes<T>();
  constexpr int NF = BN / 32;
  constexpr int KSTEPS = BK * sizeof(T) / 32;
  constexpr int CPW = 4 / sizeof(T);
  unsigned char* As = smem;
  unsigned char* Xs = smem + taps.n * BM * ROW;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int warp_m = warp / 4;
  const int warp_n = warp % 4;
  const int rows = BN / g.ow;
  const int srows = staged_rows(g.S, rows);
  const int pw = g.sw + 2;
  const int row_lo = g.S * r0 - 1;  // source row of staged row 0
  const int img_pos = img * g.sh * g.sw;

  __syncthreads();  // the previous user of smem is done
  const int x_bytes = srows * pw * ROW;
  for (int i = tid * 16; i < x_bytes; i += THREADS * 16)
    *reinterpret_cast<uint4*>(Xs + i) = make_uint4(0, 0, 0, 0);

  const int q = lane / 8;
  const int j = lane % 8;
  const int a_row = warp_m * 32 + (q & 1) * 8 + j;
  const int a_byte = (q >> 1) * 16;
  const int b_byte = (q & 1) * 16;
  int b_pos[NF / 2];
#pragma unroll
  for (int f2 = 0; f2 < NF / 2; ++f2) {
    const int p = warp_n * (BN / 4) + (2 * f2 + (q >> 1)) * 8 + j;
    b_pos[f2] = g.S * (p / g.ow) * pw + g.S * (p % g.ow);
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][f][e] = 0;

  for (int c0 = 0; c0 < ck; c0 += BK) {
    __syncthreads();
    constexpr int PIECES = BK * sizeof(T) / 16;
    for (int i = tid; i < taps.n * BM * PIECES; i += THREADS) {
      const int piece = i % PIECES;
      const int row = (i / PIECES) % BM;
      const int t = i / (PIECES * BM);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + row < m_rows)
        v = *(reinterpret_cast<const uint4*>(
                  w + (size_t)(m0 + row) * kdim + taps.wcol[t] + c0) +
              piece);
      *reinterpret_cast<uint4*>(As + (t * BM + row) * ROW + piece * 16) = v;
    }
    const int segs = g.sw / 8;
    const int units = (BK / CPW) * srows * segs;
    for (int i = tid; i < units; i += THREADS) {
      const int seg = i % segs;
      const int pr = (i / segs) % srows;
      const int grp = i / (segs * srows);
      const int ir = row_lo + pr;
      if (ir < 0 || ir >= g.sh) continue;  // stays zero
      const int pos = img_pos + ir * g.sw + seg * 8;
      uint32_t word[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
        const typename Vec8<T>::type v = load(c0 + grp * CPW + c, pos);
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
      unsigned char* dst = Xs + (pr * pw + 1 + seg * 8) * ROW + grp * 4;
#pragma unroll
      for (int p = 0; p < 8; ++p)
        *reinterpret_cast<uint32_t*>(dst + p * ROW) = word[p];
    }
    __syncthreads();

#pragma unroll 1
    for (int t = 0; t < taps.n; ++t) {
      const int shift = (taps.dr[t] + 1) * pw + taps.dc[t] + 1;
      const uint32_t a_base = smem_addr(As + (t * BM + a_row) * ROW + a_byte);
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
  }
}

// the accumulators into the tile Cs [BM][BN + 4]
template <typename AccT, int BN>
__device__ __forceinline__ void store_tile(const AccT (&acc)[2][BN / 32][4],
                                           AccT* Cs) {
  constexpr int CLD = BN + 4;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int t2 = (lane % 4) * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int f = 0; f < BN / 32; ++f) {
      const int row = (warp / 4) * 32 + mi * 16 + g;
      const int col = (warp % 4) * (BN / 4) + f * 8 + t2;
      Cs[row * CLD + col] = acc[mi][f][0];
      Cs[row * CLD + col + 1] = acc[mi][f][1];
      Cs[(row + 8) * CLD + col] = acc[mi][f][2];
      Cs[(row + 8) * CLD + col + 1] = acc[mi][f][3];
    }
}

template <typename T>
struct RawLoad {
  const T* x;
  int n;
  __device__ __forceinline__ typename Vec8<T>::type operator()(int ch,
                                                               int pos) const {
    return *reinterpret_cast<const typename Vec8<T>::type*>(
        x + (size_t)ch * n + pos);
  }
};

// --- forward -----------------------------------------------------------------

struct FwdArgs {
  const signed char* dq;  // [cin, n] quantized prologue
  const signed char* wq;  // [cout, 9 * cin] packed int8 weights
  const float* amax;      // [n / 4 / tile] group absmax
  const float* ws;        // [cout] weight scales
  const bf16* x;          // [cin, n] raw input
  const bf16* wp;         // [cout, cin] projection, or null (option A)
  bf16* z;                // [cout, n / 4]
  bf16* res;              // [cout, n / 4]
  float* part;            // [n / 4 / BN][2 * cout]
  int cin, cout, n, h, w, tile;
};

template <int BN>
__host__ __device__ inline int fwd_cs_bytes() {
  return BM * (BN + 4) * 4;
}

template <int BN>
__global__ void __launch_bounds__(THREADS) fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int oh = a.h / 2, ow = a.w / 2, ohw = oh * ow;
  const int n_out = a.n / 4;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int img = n0 / ohw;
  const int r0 = (n0 - img * ohw) / ow;
  unsigned char* stage = smem + fwd_cs_bytes<BN>();
  const Geo geo{2, a.h, a.w, ow};
  constexpr int CLD = BN + 4;

  {  // z = conv_s2(dq, wq) dequantized, and its sums
    Taps taps;
    taps.n = 9;
    for (int t = 0; t < 9; ++t) {
      taps.dr[t] = t / 3 - 1;
      taps.dc[t] = t % 3 - 1;
      taps.wcol[t] = t * a.cin;
    }
    int acc[2][BN / 32][4];
    contract<signed char, BN>(RawLoad<signed char>{a.dq, a.n}, a.wq,
                              9 * a.cin, a.cin, a.cout, m0, taps, geo, img,
                              r0, stage, acc);
    int* Cs = reinterpret_cast<int*>(smem);
    store_tile<int, BN>(acc, Cs);
    __syncthreads();
    const float s = __fmul_rn(a.amax[n0 / a.tile], common::kInv127);
    tile_sums(BN, m0, a.cout, BN, blockIdx.x, a.part,
              [&](int r, int c, float& s1, float& s2) {
      const int co = m0 + r;
      const float v = __fmul_rn(__int2float_rn(Cs[r * CLD + c]),
                                __fmul_rn(a.ws[co], s));
      const bf16 o = __float2bfloat16_rn(v);
      a.z[(size_t)co * n_out + n0 + c] = o;
      const float f = __bfloat162float(o);
      s1 = f;
      s2 = __fmul_rn(f, f);
    });
  }

  // the shortcut at (2 oh, 2 ow)
  float* Ps = reinterpret_cast<float*>(smem);
  if (a.wp != nullptr) {
    Taps taps;
    taps.n = 1;
    taps.dr[0] = taps.dc[0] = taps.wcol[0] = 0;
    float acc[2][BN / 32][4];
    contract<bf16, BN>(RawLoad<bf16>{a.x, a.n}, a.wp, a.cin, a.cin, a.cout,
                       m0, taps, geo, img, r0, stage, acc);
    __syncthreads();  // the sums' reads of Cs are done
    store_tile<float, BN>(acc, Ps);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN;
    const int c = i - r * BN;
    const int co = m0 + r;
    if (co >= a.cout) continue;
    bf16 o;
    if (a.wp != nullptr) {
      o = __float2bfloat16_rn(Ps[r * CLD + c]);
    } else if (co < a.cin) {
      const int p = n0 + c - img * ohw;
      o = a.x[(size_t)co * a.n + img * a.h * a.w + 2 * (p / ow) * a.w +
              2 * (p % ow)];
    } else {
      o = __float2bfloat16_rn(0.f);
    }
    a.res[(size_t)co * n_out + n0 + c] = o;
  }
}

template <int BN>
int fwd_smem_bytes(int h, int w) {
  const int rows = BN / (w / 2);
  const int s8 = stage_bytes<signed char>(9, 2, rows, w);
  const int s16 = stage_bytes<bf16>(1, 2, rows, w);
  return fwd_cs_bytes<BN>() + (s8 > s16 ? s8 : s16);
}

// --- the straight-through fold (FQT quantizes through fused_half.cuh) -------

// The straight-through backward's two bf16 operands, 8 lanes per thread:
// blockIdx.y = 0: g = bf16((dz + dzsum) + (2z) * dzssq) [cout, n_out];
// 1: the prologue d [cin, 4 * n_out]
__global__ void bwd_fold_kernel(Cotangent ct, int cout, int n_out,
                                Bf16Prologue pro, int cin,
                                bf16* __restrict__ g, bf16* __restrict__ d) {
  const int n = blockIdx.y == 0 ? n_out : 4 * n_out;
  const int rows = blockIdx.y == 0 ? cout : cin;
  for (long u = (long)blockIdx.x * blockDim.x + threadIdx.x;
       u < (long)rows * (n / 8); u += (long)gridDim.x * blockDim.x) {
    const int row = (int)(u / (n / 8));
    const size_t off = (size_t)(u % (n / 8)) * 8;
    bf16 o[8];
    if (blockIdx.y == 0) {
      float v[8];
      ct(row, n, off, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = __float2bfloat16_rn(v[k]);
      *reinterpret_cast<uint4*>(g + (size_t)row * n + off) = pack8(o);
    } else {
      pro(row, (int)off, o);
      *reinterpret_cast<uint4*>(d + (size_t)row * n + off) = pack8(o);
    }
  }
}

// --- dgrad -----------------------------------------------------------------

struct DgradArgs {
  const void* g;          // [cout, n / 4] int8 (FQT) or bf16
  const void* wdg;        // [cin, 9 * cout] plane-major, int8 or bf16
  const float* g_amax;    // [groups] (FQT)
  const float* ws_in;     // [cin] (FQT)
  const bf16* x;          // [cin, n]
  const float* scale;
  const float* shift;
  DropBits bits;          // [cin, n] lane order
  const bf16* dres;       // [cout, n / 4]
  const bf16* wpt;        // [cin, cout] or null (option A)
  bf16* dx;               // [cin, n]
  float* part;            // [4 * n / 4 / BN][2 * cin]
  int cout, cin, n, h, w, tile, thresh;
  float keep;
};

template <int BN>
__host__ __device__ inline int dgrad_cs_bytes() {
  return 2 * BM * (BN + 4) * 4;
}

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS) dgrad_kernel(DgradArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using AccT = typename Acc<T>::type;
  constexpr int CLD = BN + 4;
  constexpr bool kQuant = sizeof(T) == 1;
  const int oh = a.h / 2, ow = a.w / 2, ohw = oh * ow;
  const int n_out = a.n / 4;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int cls = blockIdx.z;
  const int ph = cls / 2, pw = cls % 2;
  const int img = n0 / ohw;
  const int r0 = (n0 - img * ohw) / ow;
  AccT* Cs = reinterpret_cast<AccT*>(smem);
  float* Ps = reinterpret_cast<float*>(smem + BM * CLD * 4);
  unsigned char* stage = smem + dgrad_cs_bytes<BN>();
  const Geo geo{1, oh, ow, ow};

  // the taps of this class, row-major, and the column of each in the
  // plane-major weights (classes hold 1, 2, 2, 4 taps)
  Taps taps;
  taps.n = 0;
  int col = 0;
  for (int dh = 0; dh < 3; ++dh)
    for (int dw = 0; dw < 3; ++dw) {
      const int c = 2 * (dh != 1) + (dw != 1);
      if (c < cls) {
        ++col;
      } else if (c == cls) {
        taps.dr[taps.n] = (ph == 1 && dh == 0) ? 1 : 0;
        taps.dc[taps.n] = (pw == 1 && dw == 0) ? 1 : 0;
        ++taps.n;
      }
    }
  for (int t = 0; t < taps.n; ++t) taps.wcol[t] = (col + t) * a.cout;

  {
    AccT acc[2][BN / 32][4];
    contract<T, BN>(RawLoad<T>{static_cast<const T*>(a.g), n_out},
                    static_cast<const T*>(a.wdg), 9 * a.cout, a.cout, a.cin,
                    m0, taps, geo, img, r0, stage, acc);
    store_tile<AccT, BN>(acc, Cs);
  }
  const bool proj = cls == 0 && a.wpt != nullptr;
  if (proj) {
    Taps t1;
    t1.n = 1;
    t1.dr[0] = t1.dc[0] = t1.wcol[0] = 0;
    float acc[2][BN / 32][4];
    contract<bf16, BN>(RawLoad<bf16>{a.dres, n_out}, a.wpt, a.cout, a.cout,
                       a.cin, m0, t1, geo, img, r0, stage, acc);
    store_tile<float, BN>(acc, Ps);
  }
  __syncthreads();
  const float gs = kQuant ? __fmul_rn(a.g_amax[n0 / a.tile], common::kInv127)
                          : 0.f;
  tile_sums(BN, m0, a.cin, BN, (size_t)cls * gridDim.x + blockIdx.x, a.part,
            [&](int r, int c, float& s1, float& s2) {
    const int ci = m0 + r;
    const int p = n0 + c - img * ohw;
    const size_t idx = (size_t)ci * a.n + (size_t)img * a.h * a.w +
                       (2 * (p / ow) + ph) * a.w + 2 * (p % ow) + pw;
    float v = kQuant ? __fmul_rn(__int2float_rn((int)Cs[r * CLD + c]),
                                 __fmul_rn(a.ws_in[ci], gs))
                     : (float)Cs[r * CLD + c];
    const float xf = __bfloat162float(a.x[idx]);
    bool live = __fmaf_rn(xf, a.scale[ci], a.shift[ci]) > 0.f;
    if (a.bits.active()) {
      live = live && a.bits.at(ci, (int)(idx - (size_t)ci * a.n)) < a.thresh;
      v = __fmul_rn(v, a.keep);
    }
    const float dn = live ? v : 0.f;
    float dxv;
    if (cls != 0) {
      dxv = __fmul_rn(dn, a.scale[ci]);
    } else {
      const float sc =
          proj ? Ps[r * CLD + c]
               : __bfloat162float(a.dres[(size_t)ci * n_out + n0 + c]);
      dxv = __fmaf_rn(dn, a.scale[ci], sc);
    }
    a.dx[idx] = __float2bfloat16_rn(dxv);
    s1 = __fmul_rn(dn, xf);
    s2 = dn;
  });
}

template <typename T, int BN>
int dgrad_smem_bytes(int h, int w) {
  const int ow = w / 2, rows = BN / ow;
  const int s = stage_bytes<T>(4, 1, rows, ow);
  const int p = stage_bytes<bf16>(1, 1, rows, ow);
  return dgrad_cs_bytes<BN>() + (s > p ? s : p);
}

// --- wgrad: a GEMM over output positions ---------------------------------------

constexpr int WG_CI = 32;            // input channels per block
constexpr int WG_KB = 128;           // bytes of positions per staged chunk
constexpr int WG_PITCH = WG_KB + 16;  // bytes per staged row

// NTAPS = 9: the 3x3 taps; 1: the projection's (dh, dw) = (1, 1). a is
// the cotangent [cout, n_out] (g or dres), b the operand the taps read at
// the input geometry [cin, 4 * n_out] (int8 d, the bf16 prologue d, or the
// raw x of the projection). part[span][cout][NTAPS * cin]; FQT (T =
// int8): one span per scale group, scaled by (d_amax * g_amax) / 127^2.
template <typename T, int NTAPS>
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(const T* __restrict__ a, const T* __restrict__ b,
             const float* __restrict__ g_amax,
             const float* __restrict__ d_amax, float* __restrict__ part,
             int cout, int cin, int n_out, int h, int w, int span) {
  extern __shared__ __align__(128) unsigned char smem[];
  using AccT = typename Acc<T>::type;
  constexpr int E = 4 / sizeof(T);          // positions per 32-bit word
  constexpr int KC = WG_KB / sizeof(T);     // positions per chunk
  constexpr int NROWS = NTAPS * WG_CI;      // staged B rows
  unsigned char* As = smem;                    // [BM][WG_PITCH]
  unsigned char* Bs = smem + BM * WG_PITCH;    // [NROWS][WG_PITCH]
  // [NTAPS][KC]: the source lane of each (tap, position) of the chunk,
  // or -1 outside the image
  int* Ts = reinterpret_cast<int*>(Bs + NROWS * WG_PITCH);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int warp_m = warp / 4;
  const int warp_n = warp % 4;
  const int ci0 = blockIdx.x * WG_CI;
  const int m0 = blockIdx.y * BM;
  const int z = blockIdx.z;
  const int oh = h / 2, ow = w / 2, ohw = oh * ow;
  const size_t n = (size_t)4 * n_out;

  const int q = lane / 8;
  const int a_row = warp_m * 32 + (q & 1) * 8 + lane % 8;
  const int a_byte = (q >> 1) * 16;

  AccT acc[2][NTAPS][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int f = 0; f < NTAPS; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][f][e] = 0;

  for (int p0 = z * span; p0 < (z + 1) * span; p0 += KC) {
    __syncthreads();
    for (int i = tid; i < BM * (WG_KB / 16); i += THREADS) {
      const int row = i / (WG_KB / 16);
      const int piece = i % (WG_KB / 16);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + row < cout)
        v = *reinterpret_cast<const uint4*>(a + (size_t)(m0 + row) * n_out +
                                            p0 + piece * (16 / sizeof(T)));
      *reinterpret_cast<uint4*>(As + row * WG_PITCH + piece * 16) = v;
    }
    for (int i = tid; i < NTAPS * KC; i += THREADS) {
      const int tap = NTAPS == 9 ? i / KC : 4;
      const int p = p0 + i % KC;
      const int img = p / ohw;
      const int rem = p - img * ohw;
      const int ih = 2 * (rem / ow) + tap / 3 - 1;
      const int iw = 2 * (rem % ow) + tap % 3 - 1;
      Ts[i] = (ih >= 0 && ih < h && iw >= 0 && iw < w)
                  ? img * h * w + ih * w + iw
                  : -1;
    }
    __syncthreads();
    // B rows (tap, ci): E consecutive positions per 32-bit word
    for (int i = tid; i < NROWS * (WG_KB / 4); i += THREADS) {
      const int wd = i % (WG_KB / 4);
      const int nrow = i / (WG_KB / 4);
      const int* offs = Ts + (nrow / WG_CI) * KC + wd * E;
      // the elements' bits: zero is all-zero bits in int8 and bf16
      using Raw = std::conditional_t<sizeof(T) == 1, uint8_t, uint16_t>;
      const Raw* src = reinterpret_cast<const Raw*>(b) +
                       (size_t)(ci0 + nrow % WG_CI) * n;
      Raw v[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int off = offs[e];
        v[e] = off >= 0 ? src[off] : Raw(0);
      }
      *reinterpret_cast<uint32_t*>(Bs + nrow * WG_PITCH + wd * 4) =
          *reinterpret_cast<const uint32_t*>(v);
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < WG_KB / 32; ++ks) {
      uint32_t af[2][4];
      const uint32_t a_base =
          smem_addr(As + a_row * WG_PITCH + a_byte) + ks * 32;
      ldmatrix_x4(af[0], a_base);
      ldmatrix_x4(af[1], a_base + 16 * WG_PITCH);
#pragma unroll
      for (int f = 0; f < NTAPS; ++f) {
        const int F = warp_n * NTAPS + f;
        const unsigned char* bp =
            Bs + (F * 8 + lane / 4) * WG_PITCH + ks * 32 + (lane % 4) * 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 16);
        mma_step(acc[0][f], af[0], b0, b1);
        mma_step(acc[1][f], af[1], b0, b1);
      }
    }
  }

  const float ts = d_amax != nullptr
                       ? __fmul_rn(__fmul_rn(d_amax[z], g_amax[z]),
                                   common::kInv16129)
                       : 1.f;
  const size_t kdim = (size_t)NTAPS * cin;
  float* out = part + (size_t)z * cout * kdim;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int f = 0; f < NTAPS; ++f) {
      const int F = warp_n * NTAPS + f;
      const int c = (F / 4) * cin + ci0 + (F % 4) * 8 + (lane % 4) * 2;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = m0 + warp_m * 32 + mi * 16 + lane / 4 + hi * 8;
        if (row < cout) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const AccT v = acc[mi][f][2 * hi + e];
            out[row * kdim + c + e] =
                d_amax != nullptr ? __fmul_rn(__int2float_rn((int)v), ts)
                                  : (float)v;
          }
        }
      }
    }
}

template <typename T, int NTAPS>
int launch_wgrad(const T* a, const T* b, const float* g_amax,
                 const float* d_amax, float* part, int cout, int cin,
                 int n_out, int h, int w, int spans, cudaStream_t stream) {
  static int smem_set = 0;
  const int bytes = (BM + NTAPS * WG_CI) * WG_PITCH +
                    NTAPS * (WG_KB / (int)sizeof(T)) * 4;
  if (bytes > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgrad_kernel<T, NTAPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = bytes;
  }
  const dim3 grid(cin / WG_CI, (cout + BM - 1) / BM, spans);
  wgrad_kernel<T, NTAPS><<<grid, THREADS, bytes, stream>>>(
      a, b, g_amax, d_amax, part, cout, cin, n_out, h, w, n_out / spans);
  return static_cast<int>(cudaGetLastError());
}

// --- launch helpers --------------------------------------------------------------

// Largest row tile (64 or 128 output positions of whole rows of one
// image), or 0 when there is none (ops/cuda/transition.py row_tile). 128
// positions keep two blocks of the forward and the dgrad on an SM.
inline int out_row_tile(int oh, int ow) {
  if (ow % 8 != 0) return 0;
  int best = 0;
  for (int r = 1; r <= oh; ++r) {
    const int bn = r * ow;
    if (oh % r == 0 && (bn == 64 || bn == 128) && bn > best) best = bn;
  }
  return best;
}

template <typename K, typename Args>
int launch_conv(K kernel, int bytes, dim3 grid, const Args& args,
                cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, bytes, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  const dim3 grid(a.n / 4 / BN, (a.cout + BM - 1) / BM);
  return launch_conv(fwd_kernel<BN>, fwd_smem_bytes<BN>(a.h, a.w), grid, a,
                     stream);
}

template <typename T, int BN>
int launch_dgrad(const DgradArgs& a, cudaStream_t stream) {
  const dim3 grid(a.n / 4 / BN, (a.cin + BM - 1) / BM, 4);
  return launch_conv(dgrad_kernel<T, BN>, dgrad_smem_bytes<T, BN>(a.h, a.w),
                     grid, a, stream);
}

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

template <typename T>
const T* in(const void* p) {
  return static_cast<const T*>(p);
}

Cotangent cotangent(const void* dz, const void* z, const void* dzsum,
                    const void* dzssq) {
  return Cotangent{in<bf16>(dz), in<bf16>(z), in<float>(dzsum),
                   in<float>(dzssq)};
}

}  // namespace

extern "C" {

// d_q [cin, n] int8 (the prologue quantized per group of 4 * tile input
// lanes), w_q [cout, 9 * cin] int8, amax [n / 4 / tile], ws [cout] f32,
// x [cin, n] bf16, wp [cout, cin] bf16 or null (option A: cout >= cin);
// z, res [cout, n / 4] bf16, part [n / 4 / BN][2 * cout] f32. cin and
// cout multiples of 32, h and w even, w % 16 == 0, a row tile for
// (h / 2, w / 2).
int fwd_launch(const void* d_q, const void* w_q, const void* amax,
               const void* ws, const void* x, const void* wp, void* z,
               void* res, void* part, int cin, int cout, int n, int h, int w,
               int tile, void* stream) {
  const FwdArgs a{in<signed char>(d_q), in<signed char>(w_q), in<float>(amax),
                  in<float>(ws),        in<bf16>(x),          in<bf16>(wp),
                  static_cast<bf16*>(z), static_cast<bf16*>(res),
                  static_cast<float*>(part), cin, cout, n, h, w, tile};
  switch (out_row_tile(h / 2, w / 2)) {
    case 128: return launch_fwd<128>(a, as_stream(stream));
    case 64: return launch_fwd<64>(a, as_stream(stream));
    default: return -1;
  }
}

// The FQT backward's amax pass: the folded cotangent [cout, n_out] in
// groups of tile lanes and the recomputed activation [cin, 4 * n_out] in
// groups of 4 * tile lanes (bits [cin, 4 * n_out] uint8 or null); part
// [2][n_out / tile][slices].
int bwd_amax_launch(const void* dz, const void* z, const void* dzsum,
                    const void* dzssq, const void* x, const void* scale,
                    const void* shift, const void* bits, void* part, int cout,
                    int cin, int n_out, int tile, int slices, int thresh,
                    float keep, void* stream) {
  const int n = 4 * n_out;
  const Prologue pro{in<bf16>(x), in<float>(scale), in<float>(shift),
                     DropBits{in<unsigned char>(bits), nullptr, n}, thresh,
                     keep};
  fused_half::amax_kernel<<<dim3(slices, n_out / tile, 2), 256, 0,
                            as_stream(stream)>>>(
      cotangent(dz, z, dzsum, dzssq), cout, GroupWalk{n_out, tile, slices},
      pro, cin, GroupWalk{n, 4 * tile, slices}, static_cast<float*>(part));
  return static_cast<int>(cudaGetLastError());
}

// g_q [cout, n_out], d_q [cin, 4 * n_out] int8; g_amax, d_amax
// [n_out / tile] f32; floor 1e-30.
int bwd_quant_launch(const void* dz, const void* z, const void* dzsum,
                     const void* dzssq, const void* x, const void* scale,
                     const void* shift, const void* bits, const void* part,
                     void* g_q, void* d_q, void* g_amax, void* d_amax,
                     int cout, int cin, int n_out, int tile, int slices,
                     int thresh, float keep, void* stream) {
  const int n = 4 * n_out;
  const Prologue pro{in<bf16>(x), in<float>(scale), in<float>(shift),
                     DropBits{in<unsigned char>(bits), nullptr, n}, thresh,
                     keep};
  const QuantOut g_out{kBwdFloor, static_cast<signed char*>(g_q),
                       static_cast<float*>(g_amax), nullptr};
  const QuantOut d_out{kBwdFloor, static_cast<signed char*>(d_q),
                       static_cast<float*>(d_amax), nullptr};
  fused_half::quant_kernel<<<dim3(slices, n_out / tile, 2), 256, 0,
                             as_stream(stream)>>>(
      cotangent(dz, z, dzsum, dzssq), cout, GroupWalk{n_out, tile, slices},
      g_out, pro, cin, GroupWalk{n, 4 * tile, slices}, d_out,
      in<float>(part));
  return static_cast<int>(cudaGetLastError());
}

// The straight-through operands: g [cout, n_out] bf16 = bf16((dz + dzsum)
// + (2z) * dzssq), d [cin, 4 * n_out] bf16 = the bf16 prologue of x (bits
// [cin, 4 * n_out] uint8 or null); n_out % 8 == 0.
int bwd_fold_launch(const void* dz, const void* z, const void* dzsum,
                    const void* dzssq, const void* x, const void* scale,
                    const void* shift, const void* bits, void* g, void* d,
                    int cout, int cin, int n_out, int thresh, float keep,
                    void* stream) {
  const Bf16Prologue pro{in<bf16>(x), in<float>(scale), in<float>(shift),
                         DropBits{in<unsigned char>(bits), nullptr,
                                  4 * n_out},
                         thresh, keep, 4 * n_out};
  bwd_fold_kernel<<<dim3(528, 2), 256, 0, as_stream(stream)>>>(
      cotangent(dz, z, dzsum, dzssq), cout, n_out, pro, cin,
      static_cast<bf16*>(g), static_cast<bf16*>(d));
  return static_cast<int>(cudaGetLastError());
}

// g [cout, n / 4] and w_dg [cin, 9 * cout] (plane-major) int8 with g_amax
// [n / 4 / tile] and ws_in [cin] (quant = 1), or both bf16 (quant = 0);
// x [cin, n] bf16, scale/shift [cin] f32, bits [cin, n] uint8 or null;
// dres [cout, n / 4] bf16, wpt [cin, cout] bf16 or null (option A); dx
// [cin, n] bf16, part [4 * (n / 4 / BN)][2 * cin] f32. Shape needs as
// fwd_launch's, and tile a multiple of BN.
int dgrad_launch(const void* g, const void* w_dg, const void* g_amax,
                 const void* ws_in, const void* x, const void* scale,
                 const void* shift, const void* bits, const void* dres,
                 const void* wpt, void* dx, void* part, int quant, int cout,
                 int cin, int n, int h, int w, int tile, int thresh,
                 float keep, void* stream) {
  const DgradArgs a{g,
                    w_dg,
                    in<float>(g_amax),
                    in<float>(ws_in),
                    in<bf16>(x),
                    in<float>(scale),
                    in<float>(shift),
                    DropBits{in<unsigned char>(bits), nullptr, n},
                    in<bf16>(dres),
                    in<bf16>(wpt),
                    static_cast<bf16*>(dx),
                    static_cast<float*>(part),
                    cout, cin, n, h, w, tile, thresh, keep};
  const cudaStream_t st = as_stream(stream);
  switch (out_row_tile(h / 2, w / 2) * (quant ? 1 : -1)) {
    case 128: return launch_dgrad<signed char, 128>(a, st);
    case 64: return launch_dgrad<signed char, 64>(a, st);
    case -128: return launch_dgrad<bf16, 128>(a, st);
    case -64: return launch_dgrad<bf16, 64>(a, st);
    default: return -1;
  }
}

// mode 0 (FQT): a = g_q [cout, n_out] int8, b = d_q [cin, 4 * n_out]
// int8, g_amax/d_amax [spans] (one span per scale group); mode 1
// (straight-through): a = g, b = d, both bf16; part [spans][cout][9 *
// cin]. mode 2 (dWp): a = dres, b = x, both bf16; part [spans][cout][cin].
// cin % 32 == 0, w % 2 == 0, n_out a multiple of spans * (128 positions
// for int8, 64 for bf16).
int wgrad_launch(const void* a, const void* b, const void* g_amax,
                 const void* d_amax, void* part, int mode, int cout, int cin,
                 int n_out, int h, int w, int spans, void* stream) {
  float* out = static_cast<float*>(part);
  const cudaStream_t st = as_stream(stream);
  switch (mode) {
    case 0:
      return launch_wgrad<signed char, 9>(
          in<signed char>(a), in<signed char>(b), in<float>(g_amax),
          in<float>(d_amax), out, cout, cin, n_out, h, w, spans, st);
    case 1:
      return launch_wgrad<bf16, 9>(in<bf16>(a), in<bf16>(b), nullptr,
                                   nullptr, out, cout, cin, n_out, h, w,
                                   spans, st);
    case 2:
      return launch_wgrad<bf16, 1>(in<bf16>(a), in<bf16>(b), nullptr,
                                   nullptr, out, cout, cin, n_out, h, w,
                                   spans, st);
    default:
      return -1;
  }
}

// out[i] = sum over k < j of part[k][i], in order (part [j][m] f32)
int partial_sum_launch(const void* part, void* out, int j, int m,
                       void* stream) {
  return common::partial_sum(in<float>(part), static_cast<float*>(out), j, m,
                             as_stream(stream));
}

}  // extern "C"
