// Stage-transition half with an int8 stride-2 conv core, forward and both
// backward bodies, in the channel-major layout [C, B*H*W], written for
// Hopper (sm_90a) and bound to Python through a plain C interface
// (ops/cuda/transition.py loads this file's library with ctypes).
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/transition.py,
// transition_half_int8):
//   fwd_amax, fwd_pre,     <- _fwd_call -> _fwd_kernel (site :357): its
//   fwd_gemm                  prologue, its joint absmax per tile over the
//                             four parity planes, their quantization, the
//                             int8 stride-2 conv, the shortcut and the sums
//   bwd_amax, bwd_quant    <- the cotangent fold and the per-tile
//                             quantizers of _bwd_kernel (site :619, FQT;
//                             the activation's codes as parity planes);
//                             bwd_quant also writes x's even-even plane
//   bwd_fold               <- its straight-through cotangent fold and bf16
//                             prologue recomputation (as parity planes),
//                             and the even-even plane of x for dWp
//   dgrad_launch           <- its per-plane dgrad, masks, norm1 chain,
//                             shortcut cotangent and d(scale)/d(shift)
//   partial_sum            <- the TPU kernels' sums carried across their
//                             sequential grid
// (its wgrad in both bodies and dWp: transition_wgrad.cu)
//
// The forward keeps the reference's parity planes, as a layout in which
// every tap of the stride-2 conv is one position offset
// (ops/cuda/transition.py transition_fwd_layout):
// - fwd_amax is fused_half.cuh's amax pass at the transition's scale
//   groups (whole images: the reference's joint absmax over a tile's four
//   planes).
// - fwd_pre_kernel reduces each group's partial maxima, recomputes the
//   prologue once per element, quantizes it at its group's scale and
//   writes the four planes of the whole batch into an int8 slab,
//   position-major with the channels contiguous (padded to cp, a multiple
//   of 32): plane p's position (image i, padded row r', padded column c')
//   holds input (2(r'-1) + p / 2, 2(c'-1) + p % 2), with a zero row r' = 0
//   above and a zero column c' = 0 left of each image, a guard of zero
//   positions before and the last 128-row tile's tail after. Tap (dh, dw)
//   reads plane 2 * (dh != 1) + (dw != 1) at a shift of -1 row where dh ==
//   0 and -1 column where dw == 0 (the reference's _tap_info): nine
//   position offsets, no masks. The same blocks write the raw even-even
//   plane once into a bf16 slab in the same position order (the
//   projection's operand, and option A's copy).
// - fwd_gemm_kernel is fwd_staged_s8.cuh's mainloop (cp.async ring,
//   ldmatrix, s8 mma.sync) over the nine shifts, then the same block runs
//   the bf16 instantiation on the even-even slab against Wp (or copies it,
//   option A), each product through the channel-major epilogue: the tile
//   staged in shared memory, each row at its group's scale (a tile may
//   span groups), written [Cout, lanes] in 16-byte vectors (the pad rows
//   and columns skipped: a tile's live rows are one run of lanes), z's
//   sums per channel in a fixed order into part[tile].
// What bounds it on an H100: bytes at 160 -> 320 (x and the bits in, z and
// res out), int8 operations at 320 -> 640 (chip_smoke.py phase 15). The
// prepass makes each operand element once (the old kernel re-staged the
// quantized input per 32-channel chunk for every 64 output channels and
// the raw x at all four parities for the projection), the mainloop
// overlaps copies with tensor-core work, and the pad rows and columns
// (13% of the M positions at 32x32 inputs, 27% at 16x16) are computed and
// thrown away. Tried on an H100 and dropped: each scale group padded to
// whole 128-row tiles, one scale a tile (11% more M rows at 32x32 inputs,
// 18% more at 16x16: the mainloop + sum 10% slower at 32x32 and no faster
// at 16x16, where both fill two waves of blocks), 64-wide N tiles
// (slower than 128 at both WRN-28-10 transitions), K steps of 64 bytes for
// the projection (slower than 128), the column factors prefetched into
// shared memory (no faster).
//
// The backward:
// - The dgrad indexes the stride-2 taps directly: the same contraction
//   per parity class of input pixel (blockIdx.z = 2 * (ih % 2) + (iw %
//   2)): a pixel of class p receives the 1, 2, 2 or 4 taps of that
//   class, each from the cotangent at the output pixel (i + sh, j + sw),
//   sh, sw in {0, 1}; so the block is a stride-1 contraction at the
//   output geometry over just those taps. Its epilogue recomputes the
//   relu/dropout masks and the norm1 chain from x, adds the shortcut's
//   cotangent on class 0 (a second bf16 contraction of Wp^T @ dres, or
//   dres itself for option A) and sums d(scale) and d(shift).
// - Both bodies' wgrad and dWp run in transition_wgrad.cu on the parity
//   planes of d and the even-even plane of x that the operand passes write:
//   the FQT quantizer (bwd_quant_kernel) stores the activation's int8
//   codes as the four planes [4][Cin][N'] (the even columns of each 8-lane
//   unit into plane 2 ph, the odd ones into 2 ph + 1: the same bytes as the
//   lane layout, the JAX kernel's d_ref rows p * Cin + ci), the
//   straight-through fold (bwd_fold_kernel) the bf16 prologue likewise.
//
// Scale groups: the quantizers take one absmax per group of whole images
// (the reference's transition_tile of output lanes; 4x as many input
// lanes). They are fused_half.cuh's amax and quant kernels, which
// fused_block.cu runs too, each operand walking its own group width:
// *_amax writes partial maxima per (group, slice) block, *_quant (or the
// forward's prepass) reduces them and quantizes.
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

#include "common.cuh"
#include "conv3x3_rows.cuh"
#include "fused_half.cuh"
#include "fwd_staged_s8.cuh"  // the forward's mainloop and epilogue
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

// Where ops/cuda/transition.py transition_fwd_layout puts the four parity
// planes: plane p is plane_len positions of cp bytes at p * plane_len * cp
// of the int8 slab; past guard zero positions, image i (< the batch),
// padded row r' (< oh + 1) and padded column c' (< ow + 1) sit at i * (oh
// + 1) * (ow + 1) + r' * (ow + 1) + c', input (2(r'-1) + p / 2, 2(c'-1) + p
// % 2) of image i where r', c' >= 1, zero elsewhere (and at channels
// cin..cp), quantized at the scale of its group (imgs images). The bf16
// slab holds plane 0's raw x at the same positions, plane_len positions of
// cpb channels.
struct PreGeo {
  int cin, n, h, w;   // x [cin, n], images h x w
  int oh, ow, imgs;   // output geometry, images a group
  int groups, guard, m_valid, plane_len;
  int cp, cpb;
};

constexpr int PRE_PB = 128;  // slab positions a block (2 threads each)
constexpr int PRE_CH = 32;   // channels a block (grid z: cp / PRE_CH)
constexpr int PRE_LD = 8;    // loads in flight a thread

// Block (x, 0, z) writes positions [x * PRE_PB, (x + 1) * PRE_PB) of the
// four planes at channels [z * 32, z * 32 + 32) of the int8 slab, and (for
// channels < cpb) of the bf16 even-even slab. First the groups its
// positions meet (a run g_lo..) reduce their partial maxima into shared
// memory (block (0, 0, 0) also writes every group's amax). Thread (ph, k)
// takes position k of input row parity ph: per channel one 4-byte load of
// x (the two columns 2c' - 2, 2c' - 1 of that row: planes (ph, 0) and (ph,
// 1)) and one 2-byte load of the bits, so a warp reads runs of consecutive
// lanes. It runs the prologue (x * scale + shift one fma, relu, the
// dropout's keep r * f32(256 / thresh)), quantizes at its group's scale (q
// = clip(rint(d * (127 / max(amax, 1e-12))))), and packs 4 channels a word
// into shared memory (rows of 9 words: conflict-free); then the block
// writes 32 contiguous bytes a position. Pad positions, guards, the tail
// and pad channels get zeros. On an H100 six blocks an SM (at most 42
// registers) ran faster than five, eight (32 registers) slower, and more
// loads in flight a thread (16, 32), with fewer blocks, slower too.
__global__ void __launch_bounds__(256, 6)
fwd_pre_kernel(Prologue pro, const float* __restrict__ part, int slices,
               float* __restrict__ amax, signed char* __restrict__ slab,
               bf16* __restrict__ ee, PreGeo s) {
  __shared__ uint32_t qs[4][PRE_PB][PRE_CH / 4 + 1];
  __shared__ uint32_t es[PRE_PB][PRE_CH / 2 + 1];
  __shared__ float ginv[PRE_PB];  // 127 / max(amax, floor) of g_lo + j
  const int c0 = blockIdx.z * PRE_CH;
  const int tid = threadIdx.x;
  const int ph = tid / PRE_PB, k = tid % PRE_PB;
  const int pos0 = blockIdx.x * PRE_PB;
  const int pos = pos0 + k;
  const int pw = s.ow + 1, per = (s.oh + 1) * pw, gm = s.imgs * per;

  // the input lane of this thread's pair and its group, or -1 (a zero
  // position)
  int lane = -1, grp = 0;
  const int m = pos - s.guard;
  if (m >= 0 && m < s.m_valid) {
    const int i = m / per, rem = m - i * per;
    const int r = rem / pw, c = rem - r * pw;
    grp = i / s.imgs;
    if (r > 0 && c > 0)
      lane = i * s.h * s.w + (2 * (r - 1) + ph) * s.w + 2 * (c - 1);
  }
  // the groups of the block's rows: g_lo .. g_lo + ng - 1 (<= PRE_PB)
  const int m_lo = min(max(pos0 - s.guard, 0), s.m_valid - 1);
  const int m_hi = min(max(pos0 + PRE_PB - 1 - s.guard, 0), s.m_valid - 1);
  const int g_lo = m_lo / gm, ng = m_hi / gm - g_lo + 1;
  for (int j = tid; j < ng; j += 256) {
    const float* pr = part + (size_t)(g_lo + j) * slices;
    float a = pr[0];
    for (int q = 1; q < slices; ++q) a = fmaxf(a, pr[q]);
    ginv[j] = __fdiv_rn(127.f, fmaxf(a, fused_half::kFwdFloor));
  }
  if (blockIdx.x == 0 && blockIdx.z == 0)
    for (int g = tid; g < s.groups; g += 256) {
      const float* pr = part + (size_t)g * slices;
      float a = pr[0];
      for (int q = 1; q < slices; ++q) a = fmaxf(a, pr[q]);
      amax[g] = a;
    }
  __syncthreads();
  const float inv = lane >= 0 ? ginv[grp - g_lo] : 0.f;
  const bool drop = pro.bits.bits != nullptr;

#pragma unroll 1
  for (int cb = 0; cb < PRE_CH; cb += PRE_LD) {
    uint32_t xv[PRE_LD];
    uint32_t bv[PRE_LD];
#pragma unroll
    for (int u = 0; u < PRE_LD; ++u) {
      const int ch = c0 + cb + u;
      xv[u] = 0u;
      bv[u] = 0u;
      if (lane >= 0 && ch < s.cin) {
        const size_t at = (size_t)ch * s.n + lane;
        xv[u] = *reinterpret_cast<const uint32_t*>(pro.x + at);
        if (drop)
          bv[u] = *reinterpret_cast<const uint16_t*>(pro.bits.bits + at);
      }
    }
    uint32_t w0[PRE_LD / 4] = {}, w1[PRE_LD / 4] = {}, e[PRE_LD / 2] = {};
#pragma unroll
    for (int u = 0; u < PRE_LD; ++u) {
      const int ch = c0 + cb + u;
      if (lane < 0 || ch >= s.cin) continue;
      const float sc = pro.scale[ch], sh = pro.shift[ch];
      uint32_t q[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const uint16_t raw = (uint16_t)(xv[u] >> (16 * h2));
        const float xf = __bfloat162float(__ushort_as_bfloat16(raw));
        float d = fmaxf(__fmaf_rn(xf, sc, sh), 0.f);
        if (drop)
          d = ((bv[u] >> (8 * h2)) & 0xffu) < (uint32_t)pro.thresh
                  ? __fmul_rn(d, pro.keep)
                  : 0.f;
        q[h2] = (uint8_t)quant_s8(__fmul_rn(d, inv));
      }
      w0[u / 4] |= q[0] << (8 * (u % 4));
      w1[u / 4] |= q[1] << (8 * (u % 4));
      e[u / 2] |= (xv[u] & 0xffffu) << (16 * (u % 2));
    }
#pragma unroll
    for (int v = 0; v < PRE_LD / 4; ++v) {
      qs[2 * ph][k][(cb / 4) + v] = w0[v];
      qs[2 * ph + 1][k][(cb / 4) + v] = w1[v];
    }
    if (ph == 0)
#pragma unroll
      for (int v = 0; v < PRE_LD / 2; ++v) es[k][cb / 2 + v] = e[v];
  }
  __syncthreads();

  const int npos = min(PRE_PB, s.plane_len - pos0);
  constexpr int WPP = PRE_CH / 4;  // words a position
  for (int idx = tid; idx < 4 * PRE_PB * WPP; idx += 256) {
    const int p = idx / (PRE_PB * WPP);
    const int kk = idx / WPP % PRE_PB, j = idx % WPP;
    if (kk >= npos) continue;
    const size_t off =
        ((size_t)p * s.plane_len + pos0 + kk) * s.cp + c0 + 4 * j;
    *reinterpret_cast<uint32_t*>(slab + off) = qs[p][kk][j];
  }
  if (c0 < s.cpb) {  // cpb % 32 == 0: the whole chunk
    constexpr int EPP = PRE_CH / 2;
    for (int idx = tid; idx < PRE_PB * EPP; idx += 256) {
      const int kk = idx / EPP, j = idx % EPP;
      if (kk >= npos) continue;
      const size_t off = ((size_t)pos0 + kk) * s.cpb + c0 + 2 * j;
      *reinterpret_cast<uint32_t*>(ee + off) = es[kk][j];
    }
  }
}

// The forward GEMM's operands and outputs (transition_fwd_layout).
struct GemmArgs {
  const signed char* slab;  // [4 * plane_len][cp]
  const signed char* wt;    // [cout][kw], pad channels zero
  const float* ws;          // [cout]
  const float* amax;        // [groups]
  const bf16* ee;           // [plane_len][cpb]
  const bf16* wp;           // [cout][kw_p / 2]; null: option A
  bf16* z;                  // [cout][n_out]
  bf16* res;                // [cout][n_out]
  float* part;              // [tiles][2 * cout]
  int cout, cp, cpb, imgs, oh, ow, b_imgs, n_out;
  int kw, krow;      // bytes a weight row (9 * cp), K bytes walked (krow %
                     // BK == 0)
  int kw_p, krow_p;  // bytes a projection row, K bytes walked (% PROJ_BK)
  int shift[9];      // tap (dh, dw)'s position offset in the int8 slab
  int ee_shift;      // the even-even slab's (its guard)
};

// The live rows before M row m: every row m is a padded position (image
// i, r', c'), live where r', c' >= 1 and i < b_imgs, and the live rows in
// order are the output lanes in order.
__device__ __forceinline__ int live_before(const GemmArgs& p, int m) {
  const int pw = p.ow + 1, per = (p.oh + 1) * pw, ohw = p.oh * p.ow;
  const int i = m / per;
  if (i >= p.b_imgs) return p.n_out;
  const int rem = m - i * per, r = rem / pw, c = rem - r * pw;
  return i * ohw + (r == 0 ? 0 : (r - 1) * p.ow + max(c - 1, 0));
}

constexpr int PROJ_BK = 128;  // bytes a K step of the projection

// Dynamic shared memory of the GEMM: the larger ring (or the staged
// tile), then each tile row's place in the run and its scale.
template <int BN, int BK>
struct GemmSmem {
  static constexpr int A = fwd_staged_s8::Tile<BN, BK>::RING;
  static constexpr int B = fwd_staged_s8::Tile<BN, PROJ_BK>::RING;
  static constexpr int C = BN * fwd_staged_s8::CM_OS * 2;  // staged tile
  static constexpr int M = A > B ? A : B;
  static constexpr int AT = M > C ? M : C;  // the tables' offset
  static constexpr int SC = AT + fwd_staged_s8::BM * 4;
  static constexpr int BYTES = SC + fwd_staged_s8::BM * 4;
};

// Grid (ceil(cout / BN), tiles): block (x, y) computes output channels [x
// * BN, x * BN + BN) of M tile y: z from the int8 slab at the nine shifts
// (K steps of BK bytes, each 16-byte piece at its own tap: cp need not be
// a multiple of BK), each row dequantized at its group's scale, its sums
// into part[y], then res from the bf16 slab (K steps of PROJ_BK bytes) or
// option A's copy. A tile may span groups and images: its live rows are
// one run of lanes.
template <int BN, int BK>
__global__ void __launch_bounds__(fwd_staged_s8::THREADS, 2)
    fwd_gemm_kernel(const __grid_constant__ GemmArgs p) {
  namespace fs = fwd_staged_s8;
  using T = fs::Tile<BN, BK>;
  using TB = fs::Tile<BN, PROJ_BK>;
  constexpr int BMT = fs::BM;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BMT;
  const int cols = min(BN, p.cout - n0);
  int* at = reinterpret_cast<int*>(smem + GemmSmem<BN, BK>::AT);
  float* rsc = reinterpret_cast<float*>(smem + GemmSmem<BN, BK>::SC);
  bf16* out = reinterpret_cast<bf16*>(smem);

  // this tile's run of lanes [lane0, lane0 + count), each live row's place
  // in it and its group's scale amax * f32(1/127)
  const int lane0 = live_before(p, m0);
  const int count = live_before(p, m0 + BMT) - lane0;
  const int lead = lane0 % 8;
  if (tid < BMT) {
    const int m = m0 + tid, k = live_before(p, m + 1);
    const bool lv = k > live_before(p, m);
    at[tid] = lv ? k - 1 - lane0 : -1;
    rsc[tid] = lv ? __fmul_rn(p.amax[(k - 1) / (p.imgs * p.oh * p.ow)],
                              common::kInv127)
                  : 0.f;
  }
  const size_t row0 = (size_t)lane0 - lead;

  {  // z = bf16(f32(acc) * f32(ws * amax * f32(1/127)))
    int acc[2][T::NI][4] = {};
    const fs::Operands o{
        reinterpret_cast<const unsigned char*>(p.slab) + (size_t)m0 * p.cp,
        reinterpret_cast<const unsigned char*>(p.wt) + (size_t)n0 * p.kw,
        p.shift, 0, 0, 0, p.cp, 9, p.cout - n0, p.krow, p.kw};
    fs::mainloop<signed char, BN, BK, true>(o, smem, acc);
    fs::stage_cm<BN, BK>(acc, at, lead, [&](int nl) {
      return n0 + nl < p.cout ? p.ws[n0 + nl] : 0.f;
    }, rsc, out);
    __syncthreads();
    fs::write_cm<BN>(out, lead, count, cols, p.z + (size_t)n0 * p.n_out + row0,
                     p.n_out);
    fs::sums_cm<BN>(out, lead, count, cols,
                    p.part + (size_t)blockIdx.y * 2 * p.cout, p.cout, n0);
    __syncthreads();  // the ring's next user overwrites the staged tile
  }

  if (p.wp != nullptr) {  // res = bf16(f32 sum of Wp x_ee)
    float acc[2][TB::NI][4] = {};
    const int pitch = 2 * p.cpb;
    const fs::Operands o{
        reinterpret_cast<const unsigned char*>(p.ee) + (size_t)m0 * pitch,
        reinterpret_cast<const unsigned char*>(p.wp) + (size_t)n0 * p.kw_p,
        &p.ee_shift, 0, 0, 0, pitch, 1, p.cout - n0, p.krow_p, p.kw_p};
    fs::mainloop<bf16, BN, PROJ_BK, true>(o, smem, acc);
    fs::stage_cm<BN, PROJ_BK>(acc, at, lead, [](int) { return 1.f; },
                              nullptr, out);
  } else {  // option A: x_ee's channels, zero past them
    // thread (v, row): 8 channels of one row, read as 16 bytes (cpb % 32
    // == 0: a group of 8 lies in the slab or past it), a warp's 2-byte
    // stores along one staged row
    const bf16* src = p.ee + ((size_t)p.ee_shift + m0) * p.cpb;
    const int ml = tid % BMT, k = at[ml];
    for (int v = tid / BMT; v < BN / 8 && k >= 0; v += fs::THREADS / BMT) {
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + 8 * v < p.cpb)
        raw = *reinterpret_cast<const uint4*>(src + (size_t)ml * p.cpb + n0 +
                                              8 * v);
      const bf16* e8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        out[(8 * v + e) * fs::CM_OS + lead + k] = e8[e];
    }
  }
  __syncthreads();
  fs::write_cm<BN>(out, lead, count, cols, p.res + (size_t)n0 * p.n_out + row0,
                   p.n_out);
}

template <int BN, int BK>
int launch_gemm(const GemmArgs& a, int tiles, cudaStream_t stream) {
  constexpr int bytes = GemmSmem<BN, BK>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      fwd_gemm_kernel<BN, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.cout + BN - 1) / BN, tiles);
  fwd_gemm_kernel<BN, BK><<<grid, fwd_staged_s8::THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// --- the backward's operand passes ------------------------------------------

// The input lane of output lane q's pixel at row parity ph, column parity
// 0 (output rows of ow pixels, images of h x w input pixels).
__device__ __forceinline__ int in_pos(int q, int ph, int h, int w) {
  const int ow = w / 2, ohw = (h / 2) * ow;
  const int img = q / ohw, rem = q - img * ohw, r = rem / ow;
  return img * h * w + (2 * r + ph) * w + 2 * (rem - r * ow);
}

// The 8 even lanes of x[off, off + 16) (bf16, 16-byte aligned).
__device__ __forceinline__ uint4 even16(const bf16* x, size_t off) {
  const uint4 a = *reinterpret_cast<const uint4*>(x + off);
  const uint4 b = *reinterpret_cast<const uint4*>(x + off + 8);
  return make_uint4(__byte_perm(a.x, a.y, 0x5410),
                    __byte_perm(a.z, a.w, 0x5410),
                    __byte_perm(b.x, b.y, 0x5410),
                    __byte_perm(b.z, b.w, 0x5410));
}

// The straight-through backward's bf16 operands, 8 output lanes a thread
// (output rows of ow % 8 == 0 pixels, so 8 lanes lie in one row):
// blockIdx.y = 0: g = bf16((dz + dzsum) + (2z) * dzssq) [cout, n_out];
// 1: the prologue d of the 16 input pixels of row parity ph under them,
// its even columns into parity plane 2 ph and its odd ones into 2 ph + 1
// of d [4][cin][n_out] (ops/cuda/transition.py parity_planes), and for ph
// = 0 the raw x of the even columns into x_ee [cin][n_out].
__global__ void bwd_fold_kernel(Cotangent ct, int cout, int n_out,
                                Bf16Prologue pro, int cin, int h, int w,
                                bf16* __restrict__ g, bf16* __restrict__ d,
                                bf16* __restrict__ x_ee) {
  const long per = n_out / 8;
  const long units = blockIdx.y == 0 ? cout * per : 2 * cin * per;
  for (long u = (long)blockIdx.x * blockDim.x + threadIdx.x; u < units;
       u += (long)gridDim.x * blockDim.x) {
    if (blockIdx.y == 0) {
      const int row = (int)(u / per);
      const size_t off = (size_t)(u % per) * 8;
      float v[8];
      ct(row, n_out, off, v);
      bf16 o[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = __float2bfloat16_rn(v[k]);
      *reinterpret_cast<uint4*>(g + (size_t)row * n_out + off) = pack8(o);
      continue;
    }
    const int ci = (int)(u / (2 * per));
    const long rem = u - (long)ci * 2 * per;
    const int ph = (int)(rem / per);
    const int q = (int)(rem - ph * per) * 8;
    const int pos = in_pos(q, ph, h, w);
    bf16 a[8], b[8], e[8], o[8];
    pro(ci, pos, a);
    pro(ci, pos + 8, b);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      e[k] = a[2 * k];
      o[k] = a[2 * k + 1];
      e[4 + k] = b[2 * k];
      o[4 + k] = b[2 * k + 1];
    }
    const size_t at = ((size_t)2 * ph * cin + ci) * n_out + q;
    *reinterpret_cast<uint4*>(d + at) = pack8(e);
    *reinterpret_cast<uint4*>(d + at + (size_t)cin * n_out) = pack8(o);
    if (ph == 0)
      *reinterpret_cast<uint4*>(x_ee + (size_t)ci * n_out + q) =
          even16(pro.x, (size_t)ci * 4 * n_out + pos);
  }
}

// Where the activation's quantizer puts a unit's 8 codes (8 input lanes of
// one row from an even column, images of h x w, w % 16 == 0): the 4 even
// columns' into parity plane 2 ph and the 4 odd ones' into 2 ph + 1 of d_q
// [4][cin][n_out], at the output lanes under them (ops/cuda/transition.py
// parity_planes).
struct PlaneStore {
  int h, w, cin, n_out;
  __device__ __forceinline__ void operator()(signed char* q, int row, int,
                                             size_t off, uint2 v) const {
    // 32-bit index arithmetic (a lane offset is below 4 * n_out < 2^31)
    const int o = (int)off, hw = h * w;
    const int img = o / hw, rem = o - img * hw;
    const int ih = rem / w, iw = rem - ih * w;
    const size_t at = ((size_t)2 * (ih & 1) * cin + row) * n_out +
                      img * (hw / 4) + (ih / 2) * (w / 2) + iw / 2;
    *reinterpret_cast<uint32_t*>(q + at) = __byte_perm(v.x, v.y, 0x6420);
    *reinterpret_cast<uint32_t*>(q + at + (size_t)cin * n_out) =
        __byte_perm(v.x, v.y, 0x7531);
  }
};

// The FQT quantizers of fused_half.cuh (blockIdx.z 0: the folded
// cotangent, in the lane layout; 1: the recomputed activation, as parity
// planes), and in the same launch (z = 2) the raw even-even plane of x
// [cin, 4 * n_out] into x_ee [cin][n_out] for dWp, walking the cotangent's
// scale groups (8 output lanes a unit, ow % 8 == 0).
template <typename Fn0, typename Fn1>
__global__ void __launch_bounds__(256)
bwd_quant_kernel(Fn0 fn0, int rows0, GroupWalk walk0, QuantOut out0,
                 Fn1 fn1, int rows1, GroupWalk walk1, QuantOut out1,
                 const float* __restrict__ part, int h, int w,
                 bf16* __restrict__ x_ee) {
  const int groups = gridDim.y;
  if (blockIdx.z == 0) {
    fused_half::quant_body(fn0, rows0, walk0, part, out0.floor, out0.q,
                           out0.amax, out0.copy);
  } else if (blockIdx.z == 1) {
    fused_half::quant_body(fn1, rows1, walk1, part + groups * walk0.slices,
                           out1.floor, out1.q, out1.amax, out1.copy,
                           PlaneStore{h, w, rows1, walk0.n});
  } else {
    for (long u = (long)blockIdx.x * blockDim.x + threadIdx.x;
         u < walk0.units(rows1); u += (long)walk0.slices * blockDim.x) {
      int ci;
      size_t q;
      walk0.at(u, blockIdx.y, ci, q);
      *reinterpret_cast<uint4*>(x_ee + (size_t)ci * walk0.n + q) = even16(
          fn1.x, (size_t)ci * walk1.n + in_pos((int)q, 0, h, w));
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

// The forward's amax pass: part [n / tile4][slices] f32, the partial
// maxima of |d| (d = the prologue of x [cin, n] bf16, bits [cin, n] uint8
// or null) per group of tile4 input lanes.
int fwd_amax_launch(const void* x, const void* scale, const void* shift,
                    const void* bits, void* part, int cin, int n, int tile4,
                    int slices, int thresh, float keep, void* stream) {
  const Prologue pro{in<bf16>(x), in<float>(scale), in<float>(shift),
                     DropBits{in<unsigned char>(bits), nullptr, n}, thresh,
                     keep};
  const GroupWalk walk{n, tile4, slices};
  fused_half::amax_kernel<<<dim3(slices, n / tile4, 1), 256, 0,
                            as_stream(stream)>>>(
      pro, cin, walk, pro, cin, walk, static_cast<float*>(part));
  return static_cast<int>(cudaGetLastError());
}

// The forward's prepass: slab [4 * plane_len][cp] int8 and ee [plane_len]
// [cpb] bf16 (transition_fwd_layout) from x [cin, n] bf16, scale/shift
// [cin] f32, bits [cin, n] uint8 or null and part [groups][slices]
// (fwd_amax); amax [groups] f32 out. cp % 32 == 0, cpb % 32 == 0, h and w
// even.
int fwd_pre_launch(const void* x, const void* scale, const void* shift,
                   const void* bits, const void* part, void* amax, void* slab,
                   void* ee, int cin, int n, int h, int w, int imgs,
                   int groups, int slices, int guard, int m_valid,
                   int plane_len, int cp, int cpb, int thresh, float keep,
                   void* stream) {
  if (cp % PRE_CH || cpb % PRE_CH || w % 2 || h % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Prologue pro{in<bf16>(x), in<float>(scale), in<float>(shift),
                     DropBits{in<unsigned char>(bits), nullptr, n}, thresh,
                     keep};
  const PreGeo g{cin, n, h, w, h / 2, w / 2, imgs, groups, guard, m_valid,
                 plane_len, cp, cpb};
  const dim3 grid((plane_len + PRE_PB - 1) / PRE_PB, 1, cp / PRE_CH);
  fwd_pre_kernel<<<grid, 256, 0, as_stream(stream)>>>(
      pro, in<float>(part), slices, static_cast<float*>(amax),
      static_cast<signed char*>(slab), static_cast<bf16*>(ee), g);
  return static_cast<int>(cudaGetLastError());
}

// The forward GEMM: z, res [cout, n_out] bf16 and part [tiles][2 * cout]
// f32 (each M tile's sums of z and z^2) from the prepass's slabs, wt
// [cout][kw] int8 (the nine taps' cp channels, pad channels zero; kw = 9 *
// cp) with ws [cout] and amax [groups] (groups of imgs images), and wp
// [cout][kw_p / 2] bf16 (cin channels, kw_p % 16 == 0) or null (option A:
// cout >= cin); krow and krow_p are the K bytes walked, kw and kw_p
// rounded up to bk and 128, the bytes past a row reading as zeros; shift
// [9] (host memory) the taps' offsets, ee_shift the even-even slab's;
// (128, bn) tiles with int8 K steps of bk bytes.
int fwd_gemm_launch(const void* slab, const void* wt, const void* ws,
                    const void* amax, const void* ee, const void* wp, void* z,
                    void* res, void* part, const int* shift, int ee_shift,
                    int cout, int cp, int cpb, int kw, int krow, int kw_p,
                    int krow_p, int tiles, int imgs, int b_imgs, int h,
                    int w, int n_out, int bn, int bk, void* stream) {
  if (cp % 16 || kw != 9 * cp || krow % bk || krow < kw || kw_p % 16 ||
      kw_p > 2 * cpb || cpb % 32 || krow_p % PROJ_BK || krow_p < 2 * cpb ||
      cout % 8 || n_out % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  GemmArgs a{in<signed char>(slab), in<signed char>(wt), in<float>(ws),
             in<float>(amax), in<bf16>(ee), in<bf16>(wp),
             static_cast<bf16*>(z), static_cast<bf16*>(res),
             static_cast<float*>(part), cout, cp, cpb, imgs, h / 2, w / 2,
             b_imgs, n_out, kw, krow, kw_p, krow_p, {}, ee_shift};
  for (int t = 0; t < 9; ++t) a.shift[t] = shift[t];
  const cudaStream_t st = as_stream(stream);
  if (bn == 128 && bk == 128) return launch_gemm<128, 128>(a, tiles, st);
  if (bn == 128 && bk == 64) return launch_gemm<128, 64>(a, tiles, st);
  if (bn == 64 && bk == 128) return launch_gemm<64, 128>(a, tiles, st);
  if (bn == 64 && bk == 64) return launch_gemm<64, 64>(a, tiles, st);
  return static_cast<int>(cudaErrorInvalidValue);
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

// g_q [cout, n_out] int8, d_q [4][cin][n_out] int8 (the activation's
// codes as parity planes); g_amax, d_amax [n_out / tile] f32; floor 1e-30;
// x_ee [cin][n_out] bf16, the raw x at the even-even pixels (images of h x
// w, w % 16 == 0).
int bwd_quant_launch(const void* dz, const void* z, const void* dzsum,
                     const void* dzssq, const void* x, const void* scale,
                     const void* shift, const void* bits, const void* part,
                     void* g_q, void* d_q, void* g_amax, void* d_amax,
                     void* x_ee, int cout, int cin, int n_out, int tile,
                     int slices, int h, int w, int thresh, float keep,
                     void* stream) {
  const int n = 4 * n_out;
  if (w % 16 || h % 2 || n % (h * w) || tile % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const Prologue pro{in<bf16>(x), in<float>(scale), in<float>(shift),
                     DropBits{in<unsigned char>(bits), nullptr, n}, thresh,
                     keep};
  const QuantOut g_out{kBwdFloor, static_cast<signed char*>(g_q),
                       static_cast<float*>(g_amax), nullptr};
  const QuantOut d_out{kBwdFloor, static_cast<signed char*>(d_q),
                       static_cast<float*>(d_amax), nullptr};
  bwd_quant_kernel<<<dim3(slices, n_out / tile, 3), 256, 0,
                     as_stream(stream)>>>(
      cotangent(dz, z, dzsum, dzssq), cout, GroupWalk{n_out, tile, slices},
      g_out, pro, cin, GroupWalk{n, 4 * tile, slices}, d_out,
      in<float>(part), h, w, static_cast<bf16*>(x_ee));
  return static_cast<int>(cudaGetLastError());
}

// The straight-through operands: g [cout, n_out] bf16 = bf16((dz + dzsum)
// + (2z) * dzssq), d [4][cin][n_out] bf16 = the bf16 prologue of x (bits
// [cin, 4 * n_out] uint8 or null) as its parity planes at the output
// geometry, x_ee [cin][n_out] bf16 = x at the even-even pixels; images of
// h x w, w % 16 == 0 (output rows of 8-pixel multiples).
int bwd_fold_launch(const void* dz, const void* z, const void* dzsum,
                    const void* dzssq, const void* x, const void* scale,
                    const void* shift, const void* bits, void* g, void* d,
                    void* x_ee, int cout, int cin, int n_out, int h, int w,
                    int thresh, float keep, void* stream) {
  if (w % 16 || h % 2 || (4 * n_out) % (h * w))
    return static_cast<int>(cudaErrorInvalidValue);
  const Bf16Prologue pro{in<bf16>(x), in<float>(scale), in<float>(shift),
                         DropBits{in<unsigned char>(bits), nullptr,
                                  4 * n_out},
                         thresh, keep, 4 * n_out};
  bwd_fold_kernel<<<dim3(528, 2), 256, 0, as_stream(stream)>>>(
      cotangent(dz, z, dzsum, dzssq), cout, n_out, pro, cin, h, w,
      static_cast<bf16*>(g), static_cast<bf16*>(d), static_cast<bf16*>(x_ee));
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

// out[i] = sum over k < j of part[k][i], in order (part [j][m] f32)
int partial_sum_launch(const void* part, void* out, int j, int m,
                       void* stream) {
  return common::partial_sum(in<float>(part), static_cast<float*>(out), j, m,
                             as_stream(stream));
}

}  // extern "C"
