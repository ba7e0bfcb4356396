// Int8 post-act bottleneck blocks for serving, written for Hopper
// (sm_90a), bound to Python through a plain C interface
// (ops/cuda/bneck_nv.py loads this file's shared library with ctypes).
//
// What they replace (pytorch_ddp_resnet_tpu/ops/pallas/bneck_nv.py):
//   bneck_block_nv       <- bneck_block_nv, body _nv_kernel (identity
//                           block)
//   bneck_transition_nv  <- bneck_transition_nv, body
//                           _nv_transition_kernel with _sel_stride2
//                           (stride 1 or 2, 1x1 projection shortcut)
// Each block is three launches:
//   conv1: a1 = requant(x[M, Cin] . w1[W, Cin]^T, p1, q1), every input
//          position;
//   conv2: a2 = requant(conv3x3(a1, w2, stride, padding 1), p2, q2)
//          (conv2's padding is zeros of a1, not requant of zero);
//   out:   y = acc3*p3 + q3 (acc3 = a2 . w3^T), then relu(x*r + y) for
//          the identity block or relu(accP*pp + y) for the transition
//          (accP = x[::s, ::s] . wp^T, a second contraction in the same
//          kernel), emitted as int8 (the next block's carrier) or bf16
//          (the run's exit).
// The carrier is int8 NHWC [N, h, w, C] with no border columns; the TPU
// kernel's NV layout, halo slivers, row-parity selects and tile pickers
// serve Mosaic's layout and VMEM and are not carried over.
//
// What bounds them on an H100: at ResNet-50's stage shapes (batch 128) an
// identity block is 55.9 GOP (0.028 ms at 1979 TOP/s) against about M *
// (3 * Cin + 4 * W) bytes on the route below (x read twice, a1 and a2
// written and read once each, the output written: 411 / 206 / 103 / 51 MB,
// 0.123 / 0.061 / 0.031 / 0.015 ms at 3.35 TB/s at stages 1-4): the bytes
// bound it; conv1 and conv3 are short-K GEMMs (one to sixteen K steps of
// 128 bytes), mostly epilogue. A stride-2 transition also writes and reads
// x's even-even positions once (xs, below).
//
// Both blocks (namespace bneck_wgmma) run every product on
// fwd_wgmma_s8.cuh's mainloop, unchanged (TMA boxes of 128, 64 and 32
// bytes in their own swizzles, s8 wgmma m64nBNk32 from two consumer
// warpgroups, thread 0 starting the loads, two blocks an SM), each with an
// epilogue of its own that stages the tile in the drained ring and writes
// it in 16-byte vectors:
// - conv1 reads x [n*h*w, Cin] (one tap, rows past M read as zeros) and
//   writes a1 straight into the padded slab of ops/cuda/bneck_nv.py
//   serve_slab_layout: images innermost, a zero column after each row (wq
//   = w + 1), a zero halo row above and below, n guard rows at each end,
//   zeros to whole 128-row tiles, W bytes a position. Position (y, x) of
//   image i is slab row guard + ((y + 1) * wq + x) * n + i. The same
//   launch writes every pad byte of the slab, zero, exactly once: each
//   position also writes the pads attached to it (its right-hand pad
//   column where x = w - 1, its halo-row twins where y = 0 or h - 1, guard
//   slot i at (0, 0), its share of the back guard and tail at (h - 1, w -
//   1)), each N tile its own channels. No memset, no zeroed buffer kept
//   across calls.
// - At stride 2 (conv1_planes_kernel) the slab is four parity planes, each
//   serve_slab_layout's at the output size (oh, ow) = (ceil(h / 2),
//   ceil(w / 2)), one after another: input position (y, x) lies in plane
//   2 (y % 2) + x % 2 at plane position (y / 2, x / 2), and the rule of
//   attached pads holds in each plane. Where h or w is odd, the odd
//   planes' last row or column lies past the image: the position of plane
//   0 or 1 (or 0) at the same plane position writes it, zero, with its
//   attached pads. The same launch copies xs = x[:, ::2, ::2] [n*oh*ow,
//   Cin] for the projection: each even-even row's Cin bytes, read again
//   just after its boxes landed, split over the M tile's N tiles.
// - conv2 walks the nine taps over the slab: tap (dy, dx) of M row m is
//   slab row m + guard + (dy * wq + dx - 1) * n for every row, image and
//   border (the zero column is the left neighbour of column 0 and the
//   right one of column w - 1). At stride 2 it is row m + p * slab_len +
//   guard + ([dy != 0] * wq - [dx == 0]) * n of plane p = 2 [dy != 1] +
//   [dx != 1]: the zero column is the left neighbour that dx = 0 needs, the
//   top halo row the row above that dy = 0 needs. M is one plane's padded
//   positions, m = (r * wq + c) * n + i, in whole tiles; the epilogue
//   writes the live rows (c < ow, r < oh) to a2 [n, oh, ow, W] and drops
//   the pad column and the tail.
// - The identity's out reads a2 [n*h*w, W] (one tap); its epilogue stages
//   y = fma(f32(acc3), p3, q3) as f32 row-major and each thread takes 16
//   channels of a row: one 16-byte load of x, then 16 int8 bytes or 32 bf16
//   bytes. The transition's (out_proj_kernel) runs two mainloops on one
//   ring, conv3 over a2 [n*oh*ow, W], then the projection over x (stride
//   1) or xs, both accumulators in registers (BN = 64: 32 + 32 s32 a
//   thread, as many as one BN = 128 tile), and stages fma(f32(accP), pp,
//   y) in the same epilogue.
// BN = 64 where the N extent is at most 64, else 128 (a masked ragged last
// tile); the grid is one dimension with the N tiles of one M tile
// neighbours, so that they read its A boxes through L2. Left for later: a1
// and a2 kept on chip (the TPU kernel keeps them in VMEM and recomputes
// conv1 on the halo rows), conv2 and conv3 fused, persistent blocks.
//
// Rounding follows the reference (tests/test_torch_bneck_nv.py pins each
// point): s32 -> f32 with __int2float_rn; acc*p + q, x*r + y and
// accP*pp + y are single FMAs (__fmaf_rn), as XLA contracts them; round
// half to even (rintf) and clip to +-127; the bf16 exit with
// __float2bfloat16_rn.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "common.cuh"        // quant_s8
#include "fwd_wgmma_s8.cuh"  // mainloop, ring_inval, Tile, Maps, encode_maps

namespace bneck_wgmma {

using common::quant_s8;
using fwd_wgmma_s8::ALIGN;
using fwd_wgmma_s8::BK;
using fwd_wgmma_s8::BM;
using fwd_wgmma_s8::Maps;
using fwd_wgmma_s8::THREADS;
using fwd_wgmma_s8::Tile;
using wgrad_staged::smem_u32;

// The slab's geometry (ops/cuda/bneck_nv.py serve_slab_layout): position
// (y, x) of image i at row guard + ((y + 1) * wq + x) * n + i; `back`
// rows of back guard and tail from row `end`.
struct Geo {
  int n, h, w, wq, guard, end, back;
};

struct Conv1Args {
  const float* p;      // [wdt]
  const float* q;
  signed char* slab;   // [slab_len][wdt]
  Geo g;
  int m;               // n * h * w rows of x
  int cin, wdt, n_tiles;
  int shift[1];        // the one tap's row offset: 0
};

// conv1 at stride 2: a1 into the four parity planes, xs besides
struct Conv1PlanesArgs {
  const float* p;          // [wdt]
  const float* q;
  signed char* slab;       // [4 * plane][wdt]: the planes one after another
  const signed char* x;    // [m][cin]
  signed char* xs;         // [n * g.h * g.w][cin]: x[:, ::2, ::2]
  Geo g;                   // one plane's, at the output size (oh, ow)
  int plane;               // rows a plane (its slab_len)
  int h, w;                // the input image
  int m;                   // n * h * w rows of x
  int cin, wdt, n_tiles;
  int shift[1];            // the one tap's row offset: 0
};

struct Conv2Args {
  const float* p;      // [wdt]
  const float* q;
  signed char* a2;     // [n, h, w, wdt]
  Geo g;
  int wdt, n_tiles;
  int shift[9];        // slab row of tap t for M row 0
};

struct OutArgs {
  const float* p3;        // [cout]
  const float* q3;
  const signed char* x;   // [m][cout]: the block input
  void* out;              // [m][cout] int8 (out_int8) or bf16
  float r;
  int m, wdt, cout, out_int8, n_tiles;
  int shift[1];           // the one tap's row offset: 0
};

struct OutProjArgs {
  const float* p3;        // [cout]
  const float* q3;
  const float* pp;        // [cout]: the projection's dequant
  void* out;              // [m][cout] int8 (out_int8) or bf16
  int m, wdt, cin, cout, out_int8, n_tiles;
  int shift[1];           // the one tap's row offset: 0
};

// The int8 epilogues' use of the drained ring: the requantized tile [BM]
// [OS] (OS = BN + 16 bytes: a warp's char2 fragment stores of 8 rows fall
// in distinct banks, and each row's vectors stay 16-byte aligned), the
// channels' p and q [2][BN], each row's target row (at) and pad flags.
template <int BN>
struct Stage8 {
  static constexpr int OS = BN + 16;
  static constexpr int PAR_OFF = BM * OS;
  static constexpr int AT_OFF = PAR_OFF + 2 * BN * 4;
  static constexpr int FLAG_OFF = AT_OFF + BM * 4;
  static constexpr int BYTES = FLAG_OFF + BM * 4;
  static_assert(PAR_OFF % 16 == 0, "vectors");
  static_assert(BYTES <= Tile<BN>::RING, "the epilogue fits the ring");
};

// The output epilogue's: y [BM][OS] f32, p3 and q3 [2][BN]. Column c of
// a row lies at word at(c) = c + 4 (c / 16): the 16-channel vectors that
// 8 lanes read at once start 20 words apart, in distinct banks; OS = BN +
// BN / 4 + 8 words puts a half-warp's float2 fragment stores of 4 rows in
// distinct banks too.
template <int BN>
struct StageOut {
  static constexpr int OS = BN + BN / 4 + 8;
  static constexpr int PAR_OFF = BM * OS * 4;
  static constexpr int BYTES = PAR_OFF + 2 * BN * 4;
  static constexpr int VPR = BN / 16;        // 16-channel vectors a row
  static constexpr int RS = THREADS / VPR;   // rows the block takes at once
  static constexpr int ROWS = BM / RS;       // rows a thread
  static_assert(BM % RS == 0 && OS % 4 == 0, "whole rows, aligned vectors");
  static_assert(BYTES <= Tile<BN>::RING, "the epilogue fits the ring");
  __device__ static __forceinline__ int at(int c) { return c + 4 * (c / 16); }
};

__device__ __forceinline__ signed char requant1(int acc, float p, float q) {
  return quant_s8(fmaxf(__fmaf_rn(__int2float_rn(acc), p, q), 0.f));
}

// The channels [n0, n0 + BN) of p and q into par[2][BN] (zero past cols).
template <int BN>
__device__ __forceinline__ void load_par(float* par, const float* p,
                                         const float* q, int n0, int cols) {
  const int tid = threadIdx.x;
  if (tid < BN) {
    par[tid] = tid < cols ? p[n0 + tid] : 0.f;
    par[BN + tid] = tid < cols ? q[n0 + tid] : 0.f;
  }
}

// requant(acc) staged int8 row-major: acc[4 j + 2 h + e] of thread t (warp
// w, lane l) is row 64 (w / 4) + 16 (w % 4) + l / 4 + 8 h of the tile,
// column 8 j + 2 (l % 4) + e.
template <int BN>
__device__ __forceinline__ void stage_requant(const int (&acc)[BN / 2],
                                              const float* par,
                                              signed char* tile) {
  using S = Stage8<BN>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    const float p0 = par[col], p1 = par[col + 1];
    const float q0 = par[BN + col], q1 = par[BN + col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      char2 v;
      v.x = requant1(acc[4 * j + 2 * h], p0, q0);
      v.y = requant1(acc[4 * j + 2 * h + 1], p1, q1);
      *reinterpret_cast<char2*>(tile + (row + 8 * h) * S::OS + col) = v;
    }
  }
}

__device__ __forceinline__ void put16(signed char* base, int row, int wdt,
                                      uint4 v) {
  *reinterpret_cast<uint4*>(base + (size_t)row * wdt) = v;
}

// Pad flags of a position: the pads it writes besides its own row
enum Pads { RIGHT = 1, TOP = 2, BOTTOM = 4, FRONT = 8, BACK = 16 };

// The pads attached to position (y, x) of a slab of geometry g.
__device__ __forceinline__ int pad_flags(const Geo& g, int y, int x) {
  return (x == g.w - 1 ? RIGHT : 0) | (y == 0 ? TOP : 0) |
         (y == g.h - 1 ? BOTTOM : 0) | (x == 0 && y == 0 ? FRONT : 0) |
         (x == g.w - 1 && y == g.h - 1 ? BACK : 0);
}

// Zeros to the pads (flags f) attached to slab row `row`, base the slab's
// first row at the vector's channels.
__device__ __forceinline__ void put_pads(signed char* base, int row, int wdt,
                                         int f, const Geo& g, uint4 zero) {
  const int up = g.wq * g.n;  // rows between vertical neighbours
  if (f & RIGHT) put16(base, row + g.n, wdt, zero);
  if (f & TOP) {
    put16(base, row - up, wdt, zero);
    if (f & RIGHT) put16(base, row - up + g.n, wdt, zero);
  }
  if (f & BOTTOM) {
    put16(base, row + up, wdt, zero);
    if (f & RIGHT) put16(base, row + up + g.n, wdt, zero);
  }
  if (f & FRONT) put16(base, row - up - g.guard, wdt, zero);
  if (f & BACK)
    for (int j = (row - g.guard) % g.n; j < g.back; j += g.n)
      put16(base, g.end + j, wdt, zero);
}

// Grid (n_tiles * ceil(m / BM)): block i computes channels [j * BN, j * BN
// + BN) of a1 at the NHWC rows [k * BM, k * BM + BM), j = i % n_tiles, k =
// i / n_tiles, and writes them and their attached pads to the slab. REM =
// Cin % 128 names the tap's last boxes.
template <int BN, int REM>
__global__ void __launch_bounds__(THREADS, 2)
    conv1_kernel(const __grid_constant__ Maps mp,
                 const __grid_constant__ Conv1Args p) {
  using S = Stage8<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (ALIGN - raw % ALIGN) % ALIGN;
  unsigned char* ring = smem_raw + pad;
  const int tid = threadIdx.x;
  const int n0 = (int)(blockIdx.x % p.n_tiles) * BN;
  const int m0 = (int)(blockIdx.x / p.n_tiles) * BM;
  int acc[BN / 2];
  fwd_wgmma_s8::mainloop<BN, REM>(mp, p.cin, p.shift, raw + pad, m0, n0, acc,
                                  0, 1);

  signed char* tile = reinterpret_cast<signed char*>(ring);
  float* par = reinterpret_cast<float*>(ring + S::PAR_OFF);
  int* at = reinterpret_cast<int*>(ring + S::AT_OFF);
  int* flags = reinterpret_cast<int*>(ring + S::FLAG_OFF);
  const Geo& g = p.g;
  const int cols = min(BN, p.wdt - n0);
  load_par<BN>(par, p.p, p.q, n0, cols);
  if (tid < BM) {
    const int m = m0 + tid;
    int row = -1, f = 0;
    if (m < p.m) {
      const int hw = g.h * g.w, i = m / hw, rem = m - i * hw;
      const int y = rem / g.w, x = rem - y * g.w;
      row = g.guard + ((y + 1) * g.wq + x) * g.n + i;
      f = pad_flags(g, y, x);
    }
    at[tid] = row;
    flags[tid] = f;
  }
  __syncthreads();
  stage_requant<BN>(acc, par, tile);
  __syncthreads();

  // each row's vectors to its slab row, and zeros to its pads
  constexpr int VPR = BN / 16;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = tid; idx < BM * VPR; idx += THREADS) {
    const int r = idx / VPR, v = idx - r * VPR;
    const int row = at[r];
    if (row < 0 || 16 * v >= cols) continue;
    signed char* base = p.slab + n0 + 16 * v;
    put16(base, row, p.wdt,
          *reinterpret_cast<const uint4*>(tile + r * S::OS + 16 * v));
    const int f = flags[r];
    if (f == 0) continue;
    put_pads(base, row, p.wdt, f, g, zero);
  }
}

// Plane flags of an input position at stride 2 (above the Pads bits): its
// plane (2 bits) and the planes past an odd w (BESIDE: plane + 1) and an
// odd h (BELOW: plane + 2) that it also writes at its plane position.
enum PlaneFlags { PLANE_SHIFT = 5, BESIDE = 1 << 7, BELOW = 1 << 8 };

// conv1_kernel at stride 2: the same blocks and product; each row's
// vectors to its plane's slab row with the pads attached to its plane
// position, and zeros (with their pads) to the positions past an odd h or
// w that it stands for; then the M tile's even-even rows of x copied to xs,
// each N tile its share of their 16-byte vectors.
template <int BN, int REM>
__global__ void __launch_bounds__(THREADS, 2)
    conv1_planes_kernel(const __grid_constant__ Maps mp,
                        const __grid_constant__ Conv1PlanesArgs p) {
  using S = Stage8<BN>;
  static_assert(S::BYTES + BM * 4 <= Tile<BN>::RING, "xs rows fit");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (ALIGN - raw % ALIGN) % ALIGN;
  unsigned char* ring = smem_raw + pad;
  const int tid = threadIdx.x;
  const int nt = (int)(blockIdx.x % p.n_tiles);
  const int n0 = nt * BN;
  const int m0 = (int)(blockIdx.x / p.n_tiles) * BM;
  int acc[BN / 2];
  fwd_wgmma_s8::mainloop<BN, REM>(mp, p.cin, p.shift, raw + pad, m0, n0, acc,
                                  0, 1);

  signed char* tile = reinterpret_cast<signed char*>(ring);
  float* par = reinterpret_cast<float*>(ring + S::PAR_OFF);
  int* at = reinterpret_cast<int*>(ring + S::AT_OFF);
  int* flags = reinterpret_cast<int*>(ring + S::FLAG_OFF);
  int* xs_at = reinterpret_cast<int*>(ring + S::BYTES);
  const Geo& g = p.g;
  const int cols = min(BN, p.wdt - n0);
  load_par<BN>(par, p.p, p.q, n0, cols);
  if (tid < BM) {
    const int m = m0 + tid;
    int row = -1, f = 0, xr = -1;
    if (m < p.m) {
      const int hw = p.h * p.w, i = m / hw, rem = m - i * hw;
      const int y = rem / p.w, x = rem - y * p.w;
      const int r = y >> 1, c = x >> 1;
      row = g.guard + ((r + 1) * g.wq + c) * g.n + i;
      f = pad_flags(g, r, c) | ((2 * (y & 1) + (x & 1)) << PLANE_SHIFT) |
          ((x & 1) == 0 && x == p.w - 1 ? BESIDE : 0) |
          ((y & 1) == 0 && y == p.h - 1 ? BELOW : 0);
      if (((y | x) & 1) == 0) xr = (i * g.h + r) * g.w + c;
    }
    at[tid] = row;
    flags[tid] = f;
    xs_at[tid] = xr;
  }
  __syncthreads();
  stage_requant<BN>(acc, par, tile);
  __syncthreads();

  constexpr int VPR = BN / 16;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = tid; idx < BM * VPR; idx += THREADS) {
    const int r = idx / VPR, v = idx - r * VPR;
    const int row = at[r];
    if (row < 0 || 16 * v >= cols) continue;
    const int f = flags[r];
    const int ext = (f & BESIDE ? 1 : 0) | (f & BELOW ? 2 : 0);
    signed char* base = p.slab + n0 + 16 * v +
                        (size_t)((f >> PLANE_SHIFT) & 3) * p.plane * p.wdt;
    const uint4 val =
        *reinterpret_cast<const uint4*>(tile + r * S::OS + 16 * v);
    for (int k = 0; k < 4; ++k) {  // plane + k: itself, then past w or h
      if ((k & ext) != k) continue;
      signed char* b = base + (size_t)k * p.plane * p.wdt;
      put16(b, row, p.wdt, k == 0 ? val : zero);
      put_pads(b, row, p.wdt, f, g, zero);
    }
  }

  // xs: this N tile's share [v0, v1) of each even-even row's Cin / 16
  // vectors
  const int vecs = p.cin / 16, per = (vecs + p.n_tiles - 1) / p.n_tiles;
  const int v0 = nt * per, v1 = min(vecs, v0 + per);
  if (v0 >= v1) return;
  for (int idx = tid; idx < BM * (v1 - v0); idx += THREADS) {
    const int r = idx / (v1 - v0), v = v0 + idx - r * (v1 - v0);
    const int xr = xs_at[r];
    if (xr >= 0)
      *reinterpret_cast<uint4*>(p.xs + (size_t)xr * p.cin + 16 * v) =
          __ldg(reinterpret_cast<const uint4*>(
              p.x + (size_t)(m0 + r) * p.cin + 16 * v));
  }
}

// The NHWC row of conv2's M row m (slab position (r, c, i), m = (r * wq +
// c) * n + i), or -1 for the pad column and the tail: fwd_staged_s8.cuh
// y_pos's rule at one chunk of h rows.
__device__ __forceinline__ int nhwc_row(const Geo& g, int m) {
  const int site = m / g.n, i = m - site * g.n;
  const int r = site / g.wq, c = site - r * g.wq;
  return (r < g.h && c < g.w) ? (i * g.h + r) * g.w + c : -1;
}

// Grid (n_tiles * tiles): block i computes channels [j * BN, j * BN + BN)
// of a2 at the slab's M rows [k * BM, k * BM + BM). REM = W % 128.
template <int BN, int REM>
__global__ void __launch_bounds__(THREADS, 2)
    conv2_kernel(const __grid_constant__ Maps mp,
                 const __grid_constant__ Conv2Args p) {
  using S = Stage8<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (ALIGN - raw % ALIGN) % ALIGN;
  unsigned char* ring = smem_raw + pad;
  const int tid = threadIdx.x;
  const int n0 = (int)(blockIdx.x % p.n_tiles) * BN;
  const int m0 = (int)(blockIdx.x / p.n_tiles) * BM;
  int acc[BN / 2];
  fwd_wgmma_s8::mainloop<BN, REM>(mp, p.wdt, p.shift, raw + pad, m0, n0,
                                  acc);

  signed char* tile = reinterpret_cast<signed char*>(ring);
  float* par = reinterpret_cast<float*>(ring + S::PAR_OFF);
  int* at = reinterpret_cast<int*>(ring + S::AT_OFF);
  const int cols = min(BN, p.wdt - n0);
  load_par<BN>(par, p.p, p.q, n0, cols);
  if (tid < BM) at[tid] = nhwc_row(p.g, m0 + tid);
  __syncthreads();
  stage_requant<BN>(acc, par, tile);
  __syncthreads();

  constexpr int VPR = BN / 16;
  for (int idx = tid; idx < BM * VPR; idx += THREADS) {
    const int r = idx / VPR, v = idx - r * VPR;
    const int row = at[r];
    if (row >= 0 && 16 * v < cols)
      put16(p.a2 + n0 + 16 * v, row, p.wdt,
            *reinterpret_cast<const uint4*>(tile + r * S::OS + 16 * v));
  }
}

// Grid (n_tiles * ceil(m / BM)): block i computes output channels [j * BN,
// j * BN + BN) of the rows [k * BM, k * BM + BM). REM = W % 128.
template <int BN, int REM>
__global__ void __launch_bounds__(THREADS, 2)
    out_kernel(const __grid_constant__ Maps mp,
               const __grid_constant__ OutArgs p) {
  using S = StageOut<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (ALIGN - raw % ALIGN) % ALIGN;
  unsigned char* ring = smem_raw + pad;
  const int tid = threadIdx.x;
  const int n0 = (int)(blockIdx.x % p.n_tiles) * BN;
  const int m0 = (int)(blockIdx.x / p.n_tiles) * BM;
  int acc[BN / 2];
  fwd_wgmma_s8::mainloop<BN, REM>(mp, p.wdt, p.shift, raw + pad, m0, n0, acc,
                                  0, 1);

  // y = fma(f32(acc), p3, q3) staged f32 row-major
  float* ys = reinterpret_cast<float*>(ring);
  float* par = reinterpret_cast<float*>(ring + S::PAR_OFF);
  const int cols = min(BN, p.cout - n0);
  load_par<BN>(par, p.p3, p.q3, n0, cols);
  __syncthreads();
  {
    const int warp = tid / 32, lane = tid % 32;
    const int row = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      const float p0 = par[col], p1 = par[col + 1];
      const float q0 = par[BN + col], q1 = par[BN + col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* y = ys + (row + 8 * h) * S::OS + S::at(col);
        *reinterpret_cast<float2*>(y) = make_float2(
            __fmaf_rn(__int2float_rn(acc[4 * j + 2 * h]), p0, q0),
            __fmaf_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), p1, q1));
      }
    }
  }
  __syncthreads();

  // thread (r0, v): channels n0 + 16 v of rows r0 + RS k; the x loads of
  // its rows issued together, then relu(fma(f32(x), r, y)) stored as 16
  // int8 or bf16
  const int v = tid % S::VPR, r0 = tid / S::VPR;
  if (16 * v >= cols) return;
  const int c0 = n0 + 16 * v;
  int m[S::ROWS];
  uint4 xr[S::ROWS];
#pragma unroll
  for (int k = 0; k < S::ROWS; ++k) {
    m[k] = m0 + r0 + S::RS * k;
    if (m[k] < p.m)
      xr[k] = *reinterpret_cast<const uint4*>(p.x + (size_t)m[k] * p.cout +
                                              c0);
  }
#pragma unroll
  for (int k = 0; k < S::ROWS; ++k) {
    if (m[k] >= p.m) continue;
    const float* y = ys + (r0 + S::RS * k) * S::OS + S::at(16 * v);
    const signed char* xb = reinterpret_cast<const signed char*>(&xr[k]);
    float o[16];
#pragma unroll
    for (int e = 0; e < 16; e += 4) {
      const float4 yv = *reinterpret_cast<const float4*>(y + e);
      o[e] = fmaxf(__fmaf_rn((float)xb[e], p.r, yv.x), 0.f);
      o[e + 1] = fmaxf(__fmaf_rn((float)xb[e + 1], p.r, yv.y), 0.f);
      o[e + 2] = fmaxf(__fmaf_rn((float)xb[e + 2], p.r, yv.z), 0.f);
      o[e + 3] = fmaxf(__fmaf_rn((float)xb[e + 3], p.r, yv.w), 0.f);
    }
    const size_t at = (size_t)m[k] * p.cout + c0;
    if (p.out_int8) {
      uint4 q;
      signed char* qb = reinterpret_cast<signed char*>(&q);
#pragma unroll
      for (int e = 0; e < 16; ++e) qb[e] = quant_s8(o[e]);
      *reinterpret_cast<uint4*>(static_cast<signed char*>(p.out) + at) = q;
    } else {
      uint4 b[2];
      __nv_bfloat16* bb = reinterpret_cast<__nv_bfloat16*>(b);
#pragma unroll
      for (int e = 0; e < 16; ++e) bb[e] = __float2bfloat16_rn(o[e]);
      uint4* dst = reinterpret_cast<uint4*>(
          static_cast<__nv_bfloat16*>(p.out) + at);
      dst[0] = b[0];
      dst[1] = b[1];
    }
  }
}

// The transition's output. Grid (n_tiles * ceil(m / BM)): block i computes
// output channels [j * BN, j * BN + BN) of the rows [k * BM, k * BM + BM):
// conv3 on mp3 (a2, w3; REM3 = W % 128), then on the same ring the
// projection on mpp (x or xs, wp; REMP = Cin % 128), both accumulators in
// registers; o = fma(f32(accP), pp, fma(f32(acc3), p3, q3)) staged f32 as
// out_kernel stages y, then relu(o) stored as 16 int8 or bf16 a thread.
template <int BN, int REM3, int REMP>
__global__ void __launch_bounds__(THREADS, 2)
    out_proj_kernel(const __grid_constant__ Maps mp3,
                    const __grid_constant__ Maps mpp,
                    const __grid_constant__ OutProjArgs p) {
  using S = StageOut<BN>;
  static_assert(S::PAR_OFF + 3 * BN * 4 <= Tile<BN>::RING, "pp fits");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (ALIGN - raw % ALIGN) % ALIGN;
  unsigned char* ring = smem_raw + pad;
  const int tid = threadIdx.x;
  const int n0 = (int)(blockIdx.x % p.n_tiles) * BN;
  const int m0 = (int)(blockIdx.x / p.n_tiles) * BM;
  int acc3[BN / 2], accp[BN / 2];
  fwd_wgmma_s8::mainloop<BN, REM3>(mp3, p.wdt, p.shift, raw + pad, m0, n0,
                                   acc3, 0, 1);
  fwd_wgmma_s8::ring_inval<BN>(raw + pad);
  fwd_wgmma_s8::mainloop<BN, REMP>(mpp, p.cin, p.shift, raw + pad, m0, n0,
                                   accp, 0, 1);

  float* os = reinterpret_cast<float*>(ring);
  float* par = reinterpret_cast<float*>(ring + S::PAR_OFF);
  const int cols = min(BN, p.cout - n0);
  load_par<BN>(par, p.p3, p.q3, n0, cols);
  if (tid < BN) par[2 * BN + tid] = tid < cols ? p.pp[n0 + tid] : 0.f;
  __syncthreads();
  {
    const int warp = tid / 32, lane = tid % 32;
    const int row = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      const float p0 = par[col], p1 = par[col + 1];
      const float q0 = par[BN + col], q1 = par[BN + col + 1];
      const float s0 = par[2 * BN + col], s1 = par[2 * BN + col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        float* o = os + (row + 8 * h) * S::OS + S::at(col);
        *reinterpret_cast<float2*>(o) = make_float2(
            __fmaf_rn(__int2float_rn(accp[i]), s0,
                      __fmaf_rn(__int2float_rn(acc3[i]), p0, q0)),
            __fmaf_rn(__int2float_rn(accp[i + 1]), s1,
                      __fmaf_rn(__int2float_rn(acc3[i + 1]), p1, q1)));
      }
    }
  }
  __syncthreads();

  // thread (r0, v): channels n0 + 16 v of rows r0 + RS k
  const int v = tid % S::VPR, r0 = tid / S::VPR;
  if (16 * v >= cols) return;
  const int c0 = n0 + 16 * v;
#pragma unroll
  for (int k = 0; k < S::ROWS; ++k) {
    const int m = m0 + r0 + S::RS * k;
    if (m >= p.m) continue;
    const float* ov = os + (r0 + S::RS * k) * S::OS + S::at(16 * v);
    float o[16];
#pragma unroll
    for (int e = 0; e < 16; e += 4) {
      const float4 f = *reinterpret_cast<const float4*>(ov + e);
      o[e] = fmaxf(f.x, 0.f);
      o[e + 1] = fmaxf(f.y, 0.f);
      o[e + 2] = fmaxf(f.z, 0.f);
      o[e + 3] = fmaxf(f.w, 0.f);
    }
    const size_t at = (size_t)m * p.cout + c0;
    if (p.out_int8) {
      uint4 q;
      signed char* qb = reinterpret_cast<signed char*>(&q);
#pragma unroll
      for (int e = 0; e < 16; ++e) qb[e] = quant_s8(o[e]);
      *reinterpret_cast<uint4*>(static_cast<signed char*>(p.out) + at) = q;
    } else {
      uint4 b[2];
      __nv_bfloat16* bb = reinterpret_cast<__nv_bfloat16*>(b);
#pragma unroll
      for (int e = 0; e < 16; ++e) bb[e] = __float2bfloat16_rn(o[e]);
      uint4* dst = reinterpret_cast<uint4*>(
          static_cast<__nv_bfloat16*>(p.out) + at);
      dst[0] = b[0];
      dst[1] = b[1];
    }
  }
}

// --- the host side ---------------------------------------------------------

// The launches' maps, encoded before the first launch.
struct Plan {
  Maps conv1;  // x [m][cin], w1 [wdt][cin]
  Maps conv2;  // the slab [planes * slab_len][wdt], w2 [wdt][9 * wdt]
  Maps out;    // a2 [m_out][wdt], w3 [cout][wdt]
  Maps proj;   // the transition's: x or xs [m_out][cin], wp [cout][cin]
};

// One launch of kernel (its dynamic shared memory raised once: smem_set)
template <typename K, typename... A>
inline cudaError_t start(K kernel, int smem, bool& smem_set, long blocks,
                         cudaStream_t stream, const A&... args) {
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

// fn(REM) at compile time for k % 128 (k % 32 == 0): every tap its boxes
// at compile time.
template <typename Fn>
inline cudaError_t dispatch_rem(int k, Fn&& fn) {
  using std::integral_constant;
  switch (k % BK) {
    case 0: return fn(integral_constant<int, 0>{});
    case 32: return fn(integral_constant<int, 32>{});
    case 64: return fn(integral_constant<int, 64>{});
    default: return fn(integral_constant<int, 96>{});
  }
}

// fn(BN, REM) at compile time for bn (64 or 128) and k % 128: every wgmma
// has its width too.
template <typename Fn>
inline cudaError_t dispatch(int bn, int k, Fn&& fn) {
  using std::integral_constant;
  return dispatch_rem(k, [&](auto r) {
    return bn == 64 ? fn(integral_constant<int, 64>{}, r)
                    : fn(integral_constant<int, 128>{}, r);
  });
}

inline bool tile_ok(int bn) { return bn == 64 || bn == 128; }

inline bool chans_ok(int c) { return c >= 32 && c % 32 == 0; }

// The slab's geometry and row count from (n, h, w, wdt), or false where
// the rows would pass 32-bit indices.
inline bool geometry(int n, int h, int w, Geo* g, long* slab_len,
                     int* tiles) {
  if (n < 1 || h < 1 || w < 1) return false;
  const long wq = w + 1, m_valid = (long)h * wq * n;
  const long t = (m_valid + BM - 1) / BM;
  const long len = 2L * n + (h + 2L) * wq * n + t * BM - m_valid;
  if (len >= 0x7fffffffL || (long)n * h * w >= 0x7fffffffL) return false;
  *g = Geo{n, h, w, (int)wq, n, (int)(n + (h + 2L) * wq * n),
           (int)(len - (n + (h + 2L) * wq * n))};
  *slab_len = len;
  *tiles = (int)t;
  return true;
}

// A block of input (h, w) at stride 1 or 2: one plane's geometry (the
// slab's at the output size), its rows and tiles, and the planes (1, or 4
// at stride 2); false where the planes' rows or the input's would pass
// 32-bit indices.
inline bool block_geometry(int n, int h, int w, int stride, Geo* g,
                           long* plane, int* tiles, int* planes) {
  if ((stride != 1 && stride != 2) || h < 1 || w < 1) return false;
  *planes = stride == 1 ? 1 : 4;
  return geometry(n, (h - 1) / stride + 1, (w - 1) / stride + 1, g, plane,
                  tiles) &&
         *planes * *plane < 0x7fffffffL && (long)n * h * w < 0x7fffffffL;
}

// conv2's slab row of tap t for M row 0 (ops/cuda/bneck_nv.py
// _block_plan's shifts): at stride 1 the tap's neighbour in the one slab,
// at stride 2 in its parity plane.
inline void conv2_shifts(const Geo& g, long plane, int stride,
                         int (&shift)[9]) {
  for (int t = 0; t < 9; ++t) {
    const int dy = t / 3, dx = t % 3;
    shift[t] = stride == 1
                   ? g.guard + (dy * g.wq + dx - 1) * g.n
                   : (2 * (dy != 1) + (dx != 1)) * (int)plane + g.guard +
                         ((dy != 0) * g.wq - (dx == 0)) * g.n;
  }
}

inline void tile_copy(Maps* dst, const void* plan, size_t off) {
  memcpy(dst, static_cast<const unsigned char*>(plan) + off, sizeof(Maps));
}

inline int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace bneck_wgmma

extern "C" {

// --- both blocks: the maps first, then three launches ----------------------
//
// x [n, h, w, cin] int8; w1 [wdt][cin], w2 [wdt][9 * wdt] (taps row-major
// in (dy, dx), then input channel), w3 [cout][wdt] int8; stride 1 or 2,
// (oh, ow) = ((h - 1) / stride + 1, (w - 1) / stride + 1); the slab
// [planes * slab_len][wdt] int8 (ops/cuda/bneck_nv.py _block_plan:
// serve_slab_layout(n, oh, ow, wdt), four parity planes at stride 2), a2
// [n, oh, ow, wdt] int8, out [n, oh, ow, cout] int8 or bf16; the
// transition's wp [cout][cin] int8 and pp [cout] f32, and xp its input
// [n * oh * ow][cin] (x at stride 1, xs at stride 2, which conv1 writes);
// cin, wdt, cout multiples of 32; bn1, bn2, bn3 the N tiles (64 or 128)
// of conv1 (wdt), conv2 (wdt) and out (cout; the transition's 64). Each
// returns a cudaError_t: cudaErrorInvalidValue where the arguments do not
// fit or the map encoder is missing or refuses.

int bneck_block_plan_bytes(void) {
  return static_cast<int>(sizeof(bneck_wgmma::Plan));
}

// Encodes the launches' maps into plan (a host buffer of
// bneck_block_plan_bytes() bytes): conv1, conv2 and conv3, and for the
// transition (wp not null) the projection's; the identity block (wp null)
// has cout == cin and stride 1.
int bneck_block_plan(void* plan, const void* x, const void* w1,
                     const void* slab, const void* w2, const void* a2,
                     const void* w3, const void* xp, const void* wp, int n,
                     int h, int w, int cin, int wdt, int cout, int stride,
                     int bn1, int bn2, int bn3) {
  using namespace bneck_wgmma;
  Geo g;
  long plane;
  int tiles, planes;
  if (!block_geometry(n, h, w, stride, &g, &plane, &tiles, &planes) ||
      !chans_ok(cin) || !chans_ok(wdt) || !chans_ok(cout) ||
      !tile_ok(bn1) || !tile_ok(bn2) || !tile_ok(bn3) ||
      (wp == nullptr && (cout != cin || stride != 1)) ||
      (wp != nullptr && bn3 != 64))
    return invalid();
  const long m = (long)n * h * w, m_out = (long)n * g.h * g.w;
  Plan pl{};
  if (!fwd_wgmma_s8::encode_maps(&pl.conv1, x, m, w1, cin, wdt, bn1, 1) ||
      !fwd_wgmma_s8::encode_maps(&pl.conv2, slab, planes * plane, w2, wdt,
                                 wdt, bn2, 9) ||
      !fwd_wgmma_s8::encode_maps(&pl.out, a2, m_out, w3, wdt, cout, bn3,
                                 1) ||
      (wp != nullptr && !fwd_wgmma_s8::encode_maps(&pl.proj, xp, m_out, wp,
                                                   cin, cout, bn3, 1)))
    return invalid();
  memcpy(plan, &pl, sizeof(Plan));
  return 0;
}

// conv1: a1 = requant(x . w1^T, p1, q1) into the slab (stride 1) or the
// four planes (stride 2), every pad byte zero; at stride 2 also xs [n *
// oh * ow][cin] = x[:, ::2, ::2].
int bneck_block_conv1_launch(const void* plan, const void* p1,
                             const void* q1, void* slab, const void* x,
                             void* xs, int n, int h, int w, int cin, int wdt,
                             int stride, int bn, void* stream) {
  using namespace bneck_wgmma;
  Geo g;
  long plane;
  int tiles, planes;
  if (!block_geometry(n, h, w, stride, &g, &plane, &tiles, &planes) ||
      !chans_ok(cin) || !chans_ok(wdt) || !tile_ok(bn))
    return invalid();
  const int m = n * h * w, n_tiles = (wdt + bn - 1) / bn;
  const long blocks = (long)n_tiles * ((m + BM - 1) / BM);
  Maps mp;
  tile_copy(&mp, plan, offsetof(Plan, conv1));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(p1);
  const float* q = static_cast<const float*>(q1);
  signed char* s = static_cast<signed char*>(slab);
  if (stride == 1) {
    const Conv1Args a{p, q, s, g, m, cin, wdt, n_tiles, {0}};
    return static_cast<int>(dispatch(bn, cin, [&](auto b, auto r) {
      constexpr int B = decltype(b)::value, R = decltype(r)::value;
      static bool smem_set = false;  // once per kernel
      return start(conv1_kernel<B, R>, Tile<B>::SMEM, smem_set, blocks, st,
                   mp, a);
    }));
  }
  const Conv1PlanesArgs a{p, q, s, static_cast<const signed char*>(x),
                          static_cast<signed char*>(xs), g, (int)plane, h, w,
                          m, cin, wdt, n_tiles, {0}};
  return static_cast<int>(dispatch(bn, cin, [&](auto b, auto r) {
    constexpr int B = decltype(b)::value, R = decltype(r)::value;
    static bool smem_set = false;  // once per kernel
    return start(conv1_planes_kernel<B, R>, Tile<B>::SMEM, smem_set, blocks,
                 st, mp, a);
  }));
}

// conv2: a2 = requant(conv3x3(a1, w2, stride), p2, q2) from the slab or
// the planes.
int bneck_block_conv2_launch(const void* plan, const void* p2,
                             const void* q2, void* a2, int n, int h, int w,
                             int wdt, int stride, int bn, void* stream) {
  using namespace bneck_wgmma;
  Conv2Args a;
  long plane;
  int tiles, planes;
  if (!block_geometry(n, h, w, stride, &a.g, &plane, &tiles, &planes) ||
      !chans_ok(wdt) || !tile_ok(bn))
    return invalid();
  a.p = static_cast<const float*>(p2);
  a.q = static_cast<const float*>(q2);
  a.a2 = static_cast<signed char*>(a2);
  a.wdt = wdt;
  a.n_tiles = (wdt + bn - 1) / bn;
  conv2_shifts(a.g, plane, stride, a.shift);
  Maps mp;
  tile_copy(&mp, plan, offsetof(Plan, conv2));
  const long blocks = (long)a.n_tiles * tiles;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(bn, wdt, [&](auto b, auto r) {
    constexpr int B = decltype(b)::value, R = decltype(r)::value;
    static bool smem_set = false;  // once per kernel
    return start(conv2_kernel<B, R>, Tile<B>::SMEM, smem_set, blocks, st,
                 mp, a);
  }));
}

// The identity block's output: out = relu(x * r + fma(f32(a2 . w3^T), p3,
// q3)), int8 when out_int8 else bf16; m = n * h * w rows.
int bneck_id_out_launch(const void* plan, const void* p3, const void* q3,
                        const void* x, float r, void* out, int m, int wdt,
                        int cout, int out_int8, int bn, void* stream) {
  using namespace bneck_wgmma;
  if (m < 1 || !chans_ok(wdt) || !chans_ok(cout) || !tile_ok(bn))
    return invalid();
  OutArgs a;
  a.p3 = static_cast<const float*>(p3);
  a.q3 = static_cast<const float*>(q3);
  a.x = static_cast<const signed char*>(x);
  a.out = out;
  a.r = r;
  a.m = m;
  a.wdt = wdt;
  a.cout = cout;
  a.out_int8 = out_int8;
  a.n_tiles = (cout + bn - 1) / bn;
  a.shift[0] = 0;
  Maps mp;
  tile_copy(&mp, plan, offsetof(Plan, out));
  const long blocks = (long)a.n_tiles * ((m + BM - 1) / BM);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(bn, wdt, [&](auto b, auto rr) {
    constexpr int B = decltype(b)::value, R = decltype(rr)::value;
    static bool smem_set = false;  // once per kernel
    return start(out_kernel<B, R>, Tile<B>::SMEM, smem_set, blocks, st, mp,
                 a);
  }));
}

// The transition's output: out = relu(fma(f32(accP), pp, fma(f32(a2 .
// w3^T), p3, q3))), accP = xp . wp^T, int8 when out_int8 else bf16; m = n *
// oh * ow rows; bn 64.
int bneck_tr_out_launch(const void* plan, const void* p3, const void* q3,
                        const void* pp, void* out, int m, int wdt, int cin,
                        int cout, int out_int8, int bn, void* stream) {
  using namespace bneck_wgmma;
  if (m < 1 || !chans_ok(wdt) || !chans_ok(cin) || !chans_ok(cout) ||
      bn != 64)
    return invalid();
  OutProjArgs a;
  a.p3 = static_cast<const float*>(p3);
  a.q3 = static_cast<const float*>(q3);
  a.pp = static_cast<const float*>(pp);
  a.out = out;
  a.m = m;
  a.wdt = wdt;
  a.cin = cin;
  a.cout = cout;
  a.out_int8 = out_int8;
  a.n_tiles = (cout + bn - 1) / bn;
  a.shift[0] = 0;
  Maps m3, mpj;
  tile_copy(&m3, plan, offsetof(Plan, out));
  tile_copy(&mpj, plan, offsetof(Plan, proj));
  const long blocks = (long)a.n_tiles * ((m + BM - 1) / BM);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_rem(wdt, [&](auto r3) {
    return dispatch_rem(cin, [&](auto rp) {
      constexpr int R3 = decltype(r3)::value, RP = decltype(rp)::value;
      static bool smem_set = false;  // once per kernel
      return start(out_proj_kernel<64, R3, RP>, Tile<64>::SMEM, smem_set,
                   blocks, st, m3, mpj, a);
    });
  }));
}

}  // extern "C"
