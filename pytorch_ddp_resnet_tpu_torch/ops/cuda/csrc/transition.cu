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
//   bwd_quant              <- the cotangent fold and the per-tile
//                             quantizers of _bwd_kernel (site :619, FQT;
//                             the activation's codes as parity planes, at
//                             the forward's absmax); it also writes x's
//                             even-even plane
//   bwd_fold               <- its straight-through cotangent fold and bf16
//                             prologue recomputation (as parity planes),
//                             and the even-even plane of x for dWp
//   dgrad_pre, dgrad_gemm, <- its per-plane dgrad, masks, norm1 chain,
//   dgrad_sum                 shortcut cotangent and d(scale)/d(shift)
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
// - The dgrad is three launches (ops/cuda/transition.py
//   transition_dgrad_layout). Input pixel (2r + ph, 2c + pw) is of parity
//   class p = 2 ph + pw and receives the 1, 2, 2 or 4 taps (dh, dw) of
//   that class, each from the cotangent at output pixel (r + sh, c + sw),
//   sh = (ph == 1 && dh == 0), sw = (pw == 1 && dw == 0): a stride-1
//   contraction at the output geometry over the class's taps, which are
//   consecutive in the plane-major weights w_dg [Cin, 9 * Cout].
//   dgrad_pre_kernel writes g (int8 codes, or bf16 for the straight-
//   through body) once into the fused forward's padded slab at the output
//   geometry (fused_block.py fused_fwd_layout: a zero row above and a zero
//   column left of each image, guards of ow + 2 zero positions), Cout
//   padded to 32 channels for the int8 body's 32-byte K steps; where a
//   projection runs, dres into a bf16 slab of the same layout. Output
//   pixel (r, c)'s M row m then reads tap (dh, dw) at slab row guard + m +
//   sh * (ow + 1) + sw: past the image that is the next image's zero row
//   or the next row's zero column, so no masks and any even H and W.
//   dgrad_kernel (grid: 2 row parities x Cin / 80 N tiles x 128-row M
//   tiles) runs a row parity's two column classes as tap ranges on
//   fwd_wgmma_s8.cuh's TMA-fed s8 mainloop (FQT) or fwd_wgmma_bf16.cuh's
//   cp.async one (straight-through), one accumulator each (80 registers a
//   thread at BN = 80: two blocks an SM), the ring's mbarriers ended
//   between the two s8 walks. On the even-even pixels (ph = 0) the block
//   first runs the shortcut sc = Wp^T dres as one unshifted tap of the
//   bf16 mainloop over the dres slab and parks it, f32, in a [Cin, N']
//   scratch at its lanes: sc stays apart from dn (dx = fma(dn, scale,
//   sc)), and three accumulators would not fit two blocks an SM. The
//   epilogue stages both classes' values (FQT: f32(acc) * f32(ws_in *
//   f32(g_amax / 127)), each row at its own group's scale) as pairs,
//   channel-major from the run's lead, so that a unit of 4 output lanes is
//   8 consecutive input lanes of one input row; a thread a unit reads x
//   and the bits as 16 and 8 bytes and writes dx as 16 (pair by pair
//   where rows of ow % 4 != 0 pixels split a unit), recomputes the
//   relu/dropout masks, and sums dn * x and dn per unit in lane order,
//   then per channel over the units into part[tile, ph]; dgrad_sum adds
//   the slots in common::tile_sum's fixed order. dx and the sums are the
//   same bit for bit every run.
// - Both bodies' wgrad and dWp run in transition_wgrad.cu on the parity
//   planes of d and the even-even plane of x that the operand passes write:
//   the FQT quantizer (bwd_quant_kernel) stores the activation's int8
//   codes as the four planes [4][Cin][N'] (the JAX kernel's d_ref rows p *
//   Cin + ci), the straight-through fold (bwd_fold_kernel) the bf16
//   prologue likewise. Both walk the activation in units of 8 output lanes
//   of one plane row, each lane reading its own input pair (one 4-byte
//   load of x, two bytes of bits), so any even H and W; where the output
//   rows hold whole units (ow % 8 == 0) a unit's 16 input pixels are
//   consecutive and move as 16-byte vectors. x_ee comes from the same
//   loads.
//
// Scale groups: the quantizers take one absmax per group of whole images
// (the reference's transition_tile of output lanes; 4x as many input
// lanes). The forward's is fused_half.cuh's amax pass and the prepass
// above. The FQT backward is one launch (bwd_quant_kernel) that reads each
// operand from device memory once, with two kinds of blocks: a
// thread-block cluster per group of the folded cotangent (fused_half.cuh
// cluster_quant_body: each block folds its share and takes its partial
// absmax, the cluster reduces them through distributed shared memory,
// then each block folds its share again from L2 and quantizes it), and
// blocks that quantize the recomputed activation at the forward's group
// absmax, the same number bit for bit (the same f32 prologue, bits and
// groups; a maximum is exact in any order), so no pass recomputes it. What
// bounds it on an H100: bytes (dz, z, x and the bits in once; g_q, d_q's
// planes and x_ee out once; chip_smoke.py phase 15).
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
#include "fused_half.cuh"
#include "fwd_staged_s8.cuh"  // the forward's mainloop and epilogue
#include "fwd_wgmma_s8.cuh"   // the dgrad's mainloops (s8 and bf16)
#include "seed_bits.cuh"

using common::quant_s8;
using dropout::DropBits;
using fused_half::Bf16Prologue;
using fused_half::Cotangent;
using fused_half::GroupWalk;
using fused_half::kBwdFloor;
using fused_half::pack8;
using fused_half::Prologue;

namespace {

typedef __nv_bfloat16 bf16;

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

// The activation's units: unit u is 8 consecutive output lanes q0 .. q0 +
// 7 (q0 % 8 == 0) of input channel ci at row parity ph, u = (ci * 2 + ph)
// * (n_out / 8) + q0 / 8, neighbouring threads on neighbouring units of
// one plane row. Output lane q (image i, output row r, column c) reads the
// input pair (2r + ph, 2c .. 2c + 1) of image i: plane 2 ph + 0 takes the
// pair's first pixel, plane 2 ph + 1 its second (ops/cuda/transition.py
// parity_planes). n_out % 8 == 0, so a unit lies in one plane row, and in
// one scale group (tile % 8 == 0).
struct UnitGeo {
  int cin, n_out, h, w;
  __host__ __device__ __forceinline__ long units() const {
    return (long)cin * 2 * (n_out / 8);
  }
  __device__ __forceinline__ void at(long u, int& ci, int& ph,
                                     int& q0) const {
    const long per = n_out / 8;
    ci = (int)(u / (2 * per));
    const long rem = u - (long)ci * 2 * per;
    ph = (int)(rem / per);
    q0 = (int)(rem - ph * per) * 8;
  }
};

// The unit's 8 input pairs of channel ci (x [cin, 4 * n_out] bf16, bits
// [cin, 4 * n_out] uint8 or null): xv[k] the pair of output lane q0 + k as
// one bf16x2 word (its first pixel in the low half), bv[k] its two bits
// (the first in the low byte). ROWS (output rows of ow % 8 == 0 pixels:
// the unit's 8 lanes lie in one output row, its 16 input pixels are
// consecutive): two 16-byte loads of x and one of the bits. Else each
// lane walks its own (image, row, column), one 4-byte load of x and one
// 2-byte load of the bits a lane.
template <bool ROWS>
__device__ __forceinline__ void load_unit(const bf16* __restrict__ x,
                                          const unsigned char* __restrict__
                                              bits,
                                          const UnitGeo& s, int ci, int ph,
                                          int q0, uint32_t (&xv)[8],
                                          uint32_t (&bv)[8]) {
  const size_t row = (size_t)ci * 4 * s.n_out;
  if constexpr (ROWS) {
    const size_t at = row + in_pos(q0, ph, s.h, s.w);
    const uint4 a = *reinterpret_cast<const uint4*>(x + at);
    const uint4 b = *reinterpret_cast<const uint4*>(x + at + 8);
    xv[0] = a.x, xv[1] = a.y, xv[2] = a.z, xv[3] = a.w;
    xv[4] = b.x, xv[5] = b.y, xv[6] = b.z, xv[7] = b.w;
    const uint4 m = bits != nullptr
                        ? *reinterpret_cast<const uint4*>(bits + at)
                        : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t mw[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) bv[k] = (mw[k / 2] >> (16 * (k % 2))) & 0xffffu;
  } else {
    const int ow = s.w / 2, oh = s.h / 2, ohw = oh * ow;
    int img = q0 / ohw;
    const int rem = q0 - img * ohw;
    int r = rem / ow, c = rem - r * ow;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const size_t at =
          row + (size_t)img * s.h * s.w + (2 * r + ph) * s.w + 2 * c;
      xv[k] = *reinterpret_cast<const uint32_t*>(x + at);
      bv[k] = bits != nullptr ? *reinterpret_cast<const uint16_t*>(bits + at)
                              : 0u;
      if (++c == ow) {
        c = 0;
        if (++r == oh) {
          r = 0;
          ++img;
        }
      }
    }
  }
}

// x_ee's 8 values of a unit at row parity 0: each pair's first pixel
__device__ __forceinline__ uint4 even_of(const uint32_t (&xv)[8]) {
  return make_uint4(__byte_perm(xv[0], xv[1], 0x5410),
                    __byte_perm(xv[2], xv[3], 0x5410),
                    __byte_perm(xv[4], xv[5], 0x5410),
                    __byte_perm(xv[6], xv[7], 0x5410));
}

__device__ __forceinline__ float bf16_half(uint32_t w, int h) {
  return __bfloat162float(__ushort_as_bfloat16((uint16_t)(w >> (16 * h))));
}

// The straight-through backward's bf16 operands: blockIdx.y = 0: g =
// bf16((dz + dzsum) + (2z) * dzssq) [cout, n_out], 8 lanes of a row a
// thread; 1: the activation's units (UnitGeo, load_unit), the bf16
// prologue d = bf16(dropout(relu(bf16(x * scale + shift)))) of each pair
// into parity planes 2 ph and 2 ph + 1 of d [4][cin][n_out], and at ph = 0
// the pairs' first pixels' raw x into x_ee [cin][n_out].
template <bool ROWS>
__global__ void bwd_fold_kernel(Cotangent ct, int cout, int n_out,
                                Bf16Prologue pro, UnitGeo s,
                                bf16* __restrict__ g, bf16* __restrict__ d,
                                bf16* __restrict__ x_ee) {
  const long per = n_out / 8;
  const long units = blockIdx.y == 0 ? cout * per : s.units();
  const bool drop = pro.bits.active();
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
    int ci, ph, q0;
    s.at(u, ci, ph, q0);
    uint32_t xv[8], bv[8];
    load_unit<ROWS>(pro.x, pro.bits.bits, s, ci, ph, q0, xv, bv);
    const float sc = pro.scale[ci], sh = pro.shift[ci];
    bf16 e[2][8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int pw = 0; pw < 2; ++pw)
        e[pw][k] = pro.one(bf16_half(xv[k], pw), sc, sh, drop,
                           (int)((bv[k] >> (8 * pw)) & 0xffu));
    const size_t at = ((size_t)2 * ph * s.cin + ci) * n_out + q0;
    *reinterpret_cast<uint4*>(d + at) = pack8(e[0]);
    *reinterpret_cast<uint4*>(d + at + (size_t)s.cin * n_out) = pack8(e[1]);
    if (ph == 0)
      *reinterpret_cast<uint4*>(x_ee + (size_t)ci * n_out + q0) = even_of(xv);
  }
}

// The FQT operands in one launch (clusters of kClusterCtas blocks, 256
// threads each). Clusters 0 .. groups - 1: the folded cotangent's scale
// group of that index (cout rows x tile lanes), fused_half.cuh's
// cluster_quant_body: g_q [cout][n_out] int8 and g_amax [groups]. The
// other blocks: one activation unit a thread (UnitGeo, load_unit), the f32
// prologue d = dropout(relu(x * scale + shift)) of each pair quantized at
// its group's scale from the forward's absmax (d_amax [groups], groups of
// 4 * tile input lanes: the same images), q = s8(clip(rint(d * (127 /
// max(amax, 1e-30))))), the pairs' first pixels' codes into parity plane
// 2 ph of d_q [4][cin][n_out] and their second's into 2 ph + 1 (8 bytes
// each), and at ph = 0 the first pixels' raw x into x_ee [cin][n_out]
// from the same loads (16 bytes). Each lane loads its own pair at every
// geometry: at WRN-28-10's transitions, whose output rows hold whole
// units, the 16-byte row loads ran 2-3% slower here on an H100 (the fold
// keeps them: 15% faster there).
__global__ void __cluster_dims__(fused_half::kClusterCtas, 1, 1)
    __launch_bounds__(256)
    bwd_quant_kernel(Cotangent ct, int cout, GroupWalk walk, int groups,
                     signed char* __restrict__ g_q, float* __restrict__ g_amax,
                     Prologue pro, UnitGeo s, const float* __restrict__ d_amax,
                     signed char* __restrict__ d_q, bf16* __restrict__ x_ee) {
  constexpr int CL = fused_half::kClusterCtas;
  const int cl = blockIdx.x / CL;
  if (cl < groups) {
    fused_half::cluster_quant_body(ct, cout, walk, cl, kBwdFloor, g_q,
                                   g_amax);
    return;
  }
  const long u = (long)(blockIdx.x - groups * CL) * blockDim.x + threadIdx.x;
  if (u >= s.units()) return;
  int ci, ph, q0;
  s.at(u, ci, ph, q0);
  uint32_t xv[8], bv[8];
  load_unit<false>(pro.x, pro.bits.bits, s, ci, ph, q0, xv, bv);
  const float sc = pro.scale[ci], sh = pro.shift[ci];
  const float inv =
      __fdiv_rn(127.f, fmaxf(d_amax[q0 / walk.tile], kBwdFloor));
  const bool drop = pro.bits.active();
  uint32_t q[2][2] = {};
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int pw = 0; pw < 2; ++pw) {
      const float v = pro.one(bf16_half(xv[k], pw), sc, sh, drop,
                              (int)((bv[k] >> (8 * pw)) & 0xffu));
      q[pw][k / 4] |= (uint32_t)(uint8_t)quant_s8(__fmul_rn(v, inv))
                      << (8 * (k % 4));
    }
  const size_t at = ((size_t)2 * ph * s.cin + ci) * s.n_out + q0;
  *reinterpret_cast<uint2*>(d_q + at) = make_uint2(q[0][0], q[0][1]);
  *reinterpret_cast<uint2*>(d_q + at + (size_t)s.cin * s.n_out) =
      make_uint2(q[1][0], q[1][1]);
  if (ph == 0)
    *reinterpret_cast<uint4*>(x_ee + (size_t)ci * s.n_out + q0) = even_of(xv);
}

// --- dgrad --------------------------------------------------------------------
//
// The input gradient, three launches (ops/cuda/transition.py dgrad):
// dgrad_pre_kernel writes g (and dres, where a projection runs) once
// into the fused forward's padded slab at the output geometry
// (transition_dgrad_layout); dgrad_kernel runs each parity class of input
// pixel as a range of taps on the wgmma mainloops and writes dx through
// the masks with each tile's sums; dgrad_sum adds the tiles' sums in
// common::tile_sum's fixed order.

namespace dgrad {

namespace wb = fwd_wgmma_bf16;
namespace ws8 = fwd_wgmma_s8;
using fused_half::PadPos;
using fused_half::PRE_C;
using fused_half::PRE_P;
using fused_half::SlabPos;

constexpr int BN = 80;        // input channels a block
constexpr int BM = 128;       // M rows a tile, 64 a warpgroup
constexpr int THREADS = 256;  // two consumer warpgroups
constexpr int ALIGN = 1024;   // a 128-byte swizzle atom
// f32 words a staged channel: the tile's run of pairs after a lead of up
// to 3 output lanes; 2 * VP % 32 == 8 puts a warp's float2 stores (4
// column pairs x 4 rows a half-warp) in 32 distinct banks
constexpr int VP = 276;
static_assert(ws8::BM == BM && wb::BM == BM && ws8::THREADS == THREADS &&
                  wb::THREADS == THREADS,
              "the mainloops' tiles and threads");
static_assert(VP >= 2 * (3 + BM) && VP % 16 == 4, "the staged row");

// Shared memory: the ring (the s8 one is the larger: four slots of 128 +
// 80 rows of 128 bytes, then its mbarriers), which the staged pairs [BN]
// [VP] f32 reuse after the mainloops; past both, each M row's place in
// the tile's run (at), its scale (rs), the block's channels' scale, shift
// and int8 weight scale (par), its two classes' slab rows (rows) and the
// epilogue's units' input lanes (ulane).
struct Smem {
  static constexpr int RING =
      ws8::Tile<BN>::RING + 16 * ws8::Tile<BN>::STAGES;
  static constexpr int STAGED = BN * VP * 4;
  static constexpr int AT = RING;
  static constexpr int RS = AT + BM * 4;
  static constexpr int PAR = RS + BM * 4;
  static constexpr int ROWS = PAR + 3 * BN * 4;
  static constexpr int ULANE = ROWS + 8 * 4;
  static constexpr int BYTES = ULANE + (BM + 8) / 4 * 4 + ALIGN;
  static_assert(STAGED <= ws8::Tile<BN>::RING &&
                    wb::Tile<BN>::RING <= ws8::Tile<BN>::RING,
                "the staged pairs and the bf16 ring fit the s8 ring");
  static_assert(BYTES <= wgrad_staged::SMEM_PER_BLOCK, "two blocks an SM");
};

struct Args {
  const bf16* x;                // [cin, n]
  const float* scale;           // [cin]
  const float* shift;           // [cin]
  const unsigned char* bits;    // [cin, n] or null
  const float* g_amax;          // [n_out / tile] (FQT)
  const float* ws_in;           // [cin] (FQT)
  const bf16* dres;             // [cout, n_out]: option A's shortcut
  float* sc;                    // [cin, n_out] the projection's, or null
  bf16* dx;                     // [cin, n]
  float* part;                  // [2 * tiles][2 * cin]
  int cin, cp, n_out, b, oh, ow, tile, thresh;
  float keep;                   // f32(256 / thresh)
  int first[4], count[4];       // class p's weight taps first[p] ..
  int off[4][4];                // its tap j at slab row guard + m + off
};

// slab row offsets of a class's (at most four) taps, in registers
struct TableOff {
  int o0, o1, o2, o3;
  __device__ __forceinline__ int operator()(int t) const {
    return t == 0 ? o0 : (t == 1 ? o1 : (t == 2 ? o2 : o3));
  }
};

// the projection's one unshifted tap
struct NoOff {
  __device__ __forceinline__ int operator()(int) const { return 0; }
};

// acc = class cls's contraction of the M tile at m0 with input channels
// n0.. : its taps, a range of the plane-major weights, on the s8 (FQT, TMA
// maps mp; rows, the taps' slab rows in shared memory) or the bf16 (gp)
// mainloop.
template <bool QUANT, int REM, typename A>
__device__ __forceinline__ void class_gemm(const ws8::Maps& mp,
                                           const wb::Args& gp, const Args& a,
                                           int cls, const int* rows,
                                           uint32_t ring, int m0, int n0,
                                           A (&acc)[BN / 2]) {
  if constexpr (QUANT) {
    ws8::mainloop<BN, REM>(mp, a.cp, rows, ring, m0, n0, acc, a.first[cls],
                           a.count[cls]);
  } else {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    const int* o = a.off[cls];
    wb::mainloop<BN>(gp, wb::TapWalk<TableOff>{a.first[cls], a.count[cls],
                                               9, {o[0], o[1], o[2], o[3]}},
                     ring, m0, n0, acc);
  }
}

// Grid (2 * ceil(cin / BN), tiles): block (x, y) computes input channels
// [x / 2 * BN, + BN) of M tile y for the input pixels of row parity ph = x
// % 2, both column parities (classes 2 ph and 2 ph + 1), and writes their
// sums to part[2 y + ph]. The blocks of one M tile neighbour, so they read
// its slab rows through L2.
template <bool QUANT, int REM>
__global__ void __launch_bounds__(THREADS, 2)
    dgrad_kernel(const __grid_constant__ ws8::Maps mp,
                 const __grid_constant__ wb::Args gp,
                 const __grid_constant__ wb::Args pp,
                 const __grid_constant__ Args a) {
  using Acc = typename std::conditional<QUANT, int, float>::type;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wgrad_staged::smem_u32(smem_raw);
  const uint32_t pad = (ALIGN - raw % ALIGN) % ALIGN;
  unsigned char* sm = smem_raw + pad;
  const uint32_t ring = raw + pad;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ph = blockIdx.x % 2;
  const int n0 = (int)(blockIdx.x / 2) * BN, m0 = blockIdx.y * BM;
  // the launch's scalars and pointers, read once (the mainloops take the
  // parameter by address)
  const int cin = a.cin, n_out = a.n_out, oh = a.oh, ow = a.ow, b = a.b;
  const int thresh = a.thresh;
  const float keep = a.keep;
  const bf16* const xg = a.x;
  const unsigned char* const bits = a.bits;
  const bf16* const dres = a.dres;
  float* const sc_g = a.sc;
  bf16* const dx = a.dx;
  const int cols = min(BN, cin - n0);
  int* at = reinterpret_cast<int*>(sm + Smem::AT);
  float* rs = reinterpret_cast<float*>(sm + Smem::RS);
  float* par = reinterpret_cast<float*>(sm + Smem::PAR);
  int* rows = reinterpret_cast<int*>(sm + Smem::ROWS);
  int* ulane = reinterpret_cast<int*>(sm + Smem::ULANE);

  // the tile's run of output lanes [lane0, lane0 + count), each M row's
  // place in it or -1 (a pad row or column, or the tail), each live row's
  // scale g_amax * (1/127) (its own group's: a tile may span groups)
  const int lane0 = wb::live_before(m0, b, oh, ow, n_out);
  const int count = wb::live_before(m0 + BM, b, oh, ow, n_out) -
                    lane0;
  const int lead = lane0 % 4;
  if (tid < BM) {
    const int m = m0 + tid, k = wb::live_before(m, b, oh, ow, n_out);
    const bool live = wb::live_before(m + 1, b, oh, ow, n_out) > k;
    at[tid] = live ? k - lane0 : -1;
    rs[tid] = QUANT && live
                  ? __fmul_rn(a.g_amax[k / a.tile], common::kInv127)
                  : 0.f;
  }
  if (tid < BN) {
    const bool ok = tid < cols;
    par[tid] = ok ? a.scale[n0 + tid] : 0.f;
    par[BN + tid] = ok ? a.shift[n0 + tid] : 0.f;
    par[2 * BN + tid] = ok && QUANT ? a.ws_in[n0 + tid] : 0.f;
  }
  if (tid < 8) rows[tid] = ow + 2 + a.off[2 * ph + tid / 4][tid % 4];
  __syncthreads();
  // acc[4 j + 2 h + e] is row 16 w + l / 4 + 8 h of the warpgroup's 64,
  // column 8 j + 2 (l % 4) + e
  const int row = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
  const int at_h[2] = {at[row], at[row + 8]};

  if (ph == 0 && sc_g != nullptr) {
    // the shortcut sc = Wp^T dres of the even-even pixels, f32, kept apart
    // from the masked dn (dx = fma(dn, scale, sc)): one unshifted tap of
    // the bf16 mainloop over the dres slab, into the scratch at its lanes
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    wb::mainloop<BN>(pp, wb::TapWalk<NoOff>{0, 1, 1, {}}, ring, m0, n0, acc);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * (lane % 4) + e;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (at_h[h] >= 0 && col < cols)
            sc_g[(size_t)(n0 + col) * n_out + lane0 + at_h[h]] =
                acc[4 * j + 2 * h + e];
      }
    if constexpr (QUANT) {  // the ring's cp.async bytes, then TMA's writes
      wb::fence_async_shared();
      __syncthreads();
    }
  }
  Acc acc0[BN / 2], acc1[BN / 2];
  class_gemm<QUANT, REM>(mp, gp, a, 2 * ph, rows, ring, m0, n0, acc0);
  if constexpr (QUANT) ws8::ring_inval<BN>(ring);
  class_gemm<QUANT, REM>(mp, gp, a, 2 * ph + 1, rows + 4, ring, m0, n0,
                         acc1);

  // v (FQT: f32(acc) * (ws_in * rowscale), the reference's order) of both
  // classes staged as pairs, channel-major from the lead: vs[col][2 (lead +
  // at) + pw], pw the column parity (input lanes 2c and 2c + 1)
  float* vs = reinterpret_cast<float*>(sm);
  const float rs_h[2] = {rs[row], rs[row + 8]};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * (lane % 4) + e;
      const float wsc = par[2 * BN + col];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (at_h[h] < 0) continue;
        const int i = 4 * j + 2 * h + e;
        float v0, v1;
        if constexpr (QUANT) {
          const float f = __fmul_rn(wsc, rs_h[h]);
          v0 = __fmul_rn(__int2float_rn(acc0[i]), f);
          v1 = __fmul_rn(__int2float_rn(acc1[i]), f);
        } else {
          v0 = acc0[i];
          v1 = acc1[i];
        }
        *reinterpret_cast<float2*>(vs + col * VP + 2 * (lead + at_h[h])) =
            make_float2(v0, v1);
      }
    }
  __syncthreads();

  // Units of 4 output lanes (8 input lanes of one input row where the
  // output rows hold whole units: ow % 4 == 0), neighbouring threads on
  // neighbouring units of one channel: x, the bits and dx move as 16, 8
  // and 16 bytes, elsewhere pair by pair (4, 2 and 4 bytes); live =
  // fma(x, scale, shift) > 0 and bits < thresh, dn = live ? v * keep : 0,
  // dx = bf16(dn * scale), or bf16(fma(dn, scale, sc)) on the even-even
  // pixels; the unit's sums of dn * x and dn, in lane order, into its first
  // two staged words. A whole unit's input lane is the same for every
  // channel: the table ulane holds it (-1: the unit is not whole), so the
  // walk over (channel, unit) divides nothing.
  const int vpc = (lead + count + 3) / 4;
  const int h = 2 * oh, w = 2 * ow;
  const size_t n = (size_t)4 * n_out;
  const bool drop = bits != nullptr, proj = sc_g != nullptr;
  for (int u = tid; u < vpc; u += THREADS) {
    const int k0 = 4 * u;
    ulane[u] = ow % 4 == 0 && k0 >= lead && k0 + 4 <= lead + count
                   ? in_pos(lane0 - lead + k0, ph, h, w)
                   : -1;
  }
  __syncthreads();
  int c = vpc > 0 ? tid / vpc : cols, u = vpc > 0 ? tid % vpc : 0;
  const int dc = vpc > 0 ? THREADS / vpc : 0, du = vpc > 0 ? THREADS % vpc : 0;
  for (; c < cols; c += dc, u += du) {
    if (u >= vpc) {
      u -= vpc;
      if (++c >= cols) break;
    }
    const int ci = n0 + c;
    float* st = vs + c * VP + 8 * u;
    const float4 lo = *reinterpret_cast<const float4*>(st);
    const float4 hi = *reinterpret_cast<const float4*>(st + 4);
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const float scl = par[c], shf = par[BN + c];
    const int k0 = 4 * u, q0 = lane0 - lead + k0;
    float s1 = 0.f, s2 = 0.f;
    // element e = 2 i + pw of the unit (output lane q0 + i)
    auto elem = [&](int e, float xf, int bt, float sc) {
      bool live = __fmaf_rn(xf, scl, shf) > 0.f;
      float vv = v[e];
      if (drop) {
        live = live && bt < thresh;
        vv = __fmul_rn(vv, keep);
      }
      const float dn = live ? vv : 0.f;
      s1 = __fadd_rn(s1, __fmul_rn(dn, xf));
      s2 = __fadd_rn(s2, dn);
      return __float2bfloat16_rn(ph == 0 && (e & 1) == 0
                                     ? __fmaf_rn(dn, scl, sc)
                                     : __fmul_rn(dn, scl));
    };
    // the shortcut's cotangent at output lane q (the even-even pixels)
    auto shortcut = [&](int q) {
      const size_t i = (size_t)ci * n_out + q;
      return proj ? sc_g[i] : __bfloat162float(dres[i]);
    };
    const int base = ulane[u];
    if (base >= 0) {
      const size_t gi = (size_t)ci * n + base;
      const uint4 xr = *reinterpret_cast<const uint4*>(xg + gi);
      const uint2 br =
          drop ? *reinterpret_cast<const uint2*>(bits + gi) : make_uint2(0u, 0u);
      float scv[4] = {0.f, 0.f, 0.f, 0.f};
      if (ph == 0 && proj) {
        const float4 t = *reinterpret_cast<const float4*>(
            sc_g + (size_t)ci * n_out + q0);
        scv[0] = t.x, scv[1] = t.y, scv[2] = t.z, scv[3] = t.w;
      } else if (ph == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) scv[k] = shortcut(q0 + k);
      }
      const bf16* x8 = reinterpret_cast<const bf16*>(&xr);
      const unsigned char* b8 = reinterpret_cast<const unsigned char*>(&br);
      bf16 d[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = elem(e, __bfloat162float(x8[e]), b8[e], scv[e / 2]);
      *reinterpret_cast<uint4*>(dx + gi) = pack8(d);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + i;
        if (k < lead || k >= lead + count) continue;
        const int q = q0 + i;
        const size_t gi = (size_t)ci * n + in_pos(q, ph, h, w);
        const __nv_bfloat162 x2 =
            *reinterpret_cast<const __nv_bfloat162*>(xg + gi);
        const int b0 = drop ? bits[gi] : 0, b1 = drop ? bits[gi + 1] : 0;
        const float sc = ph == 0 ? shortcut(q) : 0.f;
        __nv_bfloat162 o;
        o.x = elem(2 * i, __low2float(x2), b0, sc);
        o.y = elem(2 * i + 1, __high2float(x2), b1, sc);
        *reinterpret_cast<__nv_bfloat162*>(dx + gi) = o;
      }
    }
    st[0] = s1;
    st[1] = s2;
  }
  __syncthreads();

  // each channel's units' sums, in lane order
  if (tid < cols) {
    const float* col = vs + tid * VP;
    float s1 = 0.f, s2 = 0.f;
    for (int u = 0; u < vpc; ++u) {
      s1 = __fadd_rn(s1, col[8 * u]);
      s2 = __fadd_rn(s2, col[8 * u + 1]);
    }
    float* pt = a.part + (size_t)(2 * blockIdx.y + ph) * 2 * cin + n0 + tid;
    pt[0] = s1;
    pt[cin] = s2;
  }
}

template <bool QUANT, int REM>
cudaError_t launch_kernel(const ws8::Maps& mp, const wb::Args& gp,
                          const wb::Args& pp, const Args& a, int tiles,
                          cudaStream_t stream) {
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dgrad_kernel<QUANT, REM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem::BYTES);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid(2 * ((a.cin + BN - 1) / BN), tiles);
  dgrad_kernel<QUANT, REM><<<grid, THREADS, Smem::BYTES, stream>>>(mp, gp,
                                                                    pp, a);
  return cudaGetLastError();
}

// Blocks [0, tiles_g): g [cout][n] into its slab [.., cp] (cp - cout zero
// channels); then [tiles_g, + tiles_d): dres [cout][n] bf16 into its slab;
// then 16-byte zeros at every pad position of each slab, a thread each.
template <typename U>
__global__ void __launch_bounds__(256)
    dgrad_pre_kernel(const U* __restrict__ g, U* __restrict__ gslab,
                     const unsigned short* __restrict__ dres,
                     unsigned short* __restrict__ dslab, SlabPos live,
                     PadPos pads, int cout, int cp, int n, int tiles_g,
                     int tiles_d, long pad_g, long pad_d) {
  __shared__ __align__(16) unsigned char buf[
      fused_half::kCopyTileBytes<unsigned short>];
  const long blk = blockIdx.x;
  if (blk < tiles_g) {
    fused_half::copy_tile(g, cout, gslab, cp, n, blk, live, buf);
    return;
  }
  if (blk < tiles_g + tiles_d) {
    fused_half::copy_tile(dres, cout, dslab, cout, n, blk - tiles_g, live,
                          buf);
    return;
  }
  const long v = (blk - tiles_g - tiles_d) * 256 + threadIdx.x;
  if (v < pad_g)
    fused_half::zero_pad_vec(gslab, pads, cp, v, pad_g);
  else
    fused_half::zero_pad_vec(dslab, pads, cout, v - pad_g, pad_d);
}

// names the dgrad's tile sum in a profile
struct TransitionDgradSum {};

}  // namespace dgrad

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

// The FQT operands, one launch: g_q [cout, n_out] int8 and g_amax
// [n_out / tile] f32 (the folded cotangent's groups of tile lanes, floor
// 1e-30); d_q [4][cin][n_out] int8 (the activation's codes as parity
// planes) at the forward's group absmax d_amax [n_out / tile] (groups of 4
// * tile input lanes, floor 1e-30), read only; x_ee [cin][n_out] bf16, the
// raw x at the even-even pixels. x [cin, 4 * n_out] bf16 of h x w images
// (h, w even), bits [cin, 4 * n_out] uint8 or null.
int bwd_quant_launch(const void* dz, const void* z, const void* dzsum,
                     const void* dzssq, const void* x, const void* scale,
                     const void* shift, const void* bits, const void* d_amax,
                     void* g_q, void* d_q, void* g_amax, void* x_ee, int cout,
                     int cin, int n_out, int tile, int h, int w, int thresh,
                     float keep, void* stream) {
  const int n = 4 * n_out;
  if (cout < 1 || cin < 1 || h % 2 || w % 2 || h < 2 || w < 2 ||
      n % (h * w) || tile < 8 || tile % 8 || n_out % tile)
    return static_cast<int>(cudaErrorInvalidValue);
  const Prologue pro{in<bf16>(x), in<float>(scale), in<float>(shift),
                     DropBits{in<unsigned char>(bits), nullptr, n}, thresh,
                     keep};
  const UnitGeo s{cin, n_out, h, w};
  const int groups = n_out / tile;
  constexpr int CL = fused_half::kClusterCtas;
  const long act = (s.units() + 255) / 256;
  const long blocks = (long)groups * CL + (act + CL - 1) / CL * CL;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  bwd_quant_kernel<<<(unsigned)blocks, 256, 0, as_stream(stream)>>>(
      cotangent(dz, z, dzsum, dzssq), cout,
      GroupWalk{n_out, tile, CL}, groups, static_cast<signed char*>(g_q),
      static_cast<float*>(g_amax), pro, s, in<float>(d_amax),
      static_cast<signed char*>(d_q), static_cast<bf16*>(x_ee));
  return static_cast<int>(cudaGetLastError());
}

// The straight-through operands: g [cout, n_out] bf16 = bf16((dz + dzsum)
// + (2z) * dzssq), d [4][cin][n_out] bf16 = the bf16 prologue of x (bits
// [cin, 4 * n_out] uint8 or null) as its parity planes at the output
// geometry, x_ee [cin][n_out] bf16 = x at the even-even pixels; images of
// h x w (h, w even), n_out % 8 == 0; rows: the 16-byte unit loads (output
// rows of ow % 8 == 0 pixels).
int bwd_fold_launch(const void* dz, const void* z, const void* dzsum,
                    const void* dzssq, const void* x, const void* scale,
                    const void* shift, const void* bits, void* g, void* d,
                    void* x_ee, int cout, int cin, int n_out, int h, int w,
                    int rows, int thresh, float keep, void* stream) {
  if (h % 2 || w % 2 || h < 2 || w < 2 || (4 * n_out) % (h * w) ||
      n_out % 8 || (rows && (w / 2) % 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const Bf16Prologue pro{in<bf16>(x), in<float>(scale), in<float>(shift),
                         DropBits{in<unsigned char>(bits), nullptr,
                                  4 * n_out},
                         thresh, keep, 4 * n_out};
  const UnitGeo s{cin, n_out, h, w};
  const dim3 grid(528, 2);
  if (rows)
    bwd_fold_kernel<true><<<grid, 256, 0, as_stream(stream)>>>(
        cotangent(dz, z, dzsum, dzssq), cout, n_out, pro, s,
        static_cast<bf16*>(g), static_cast<bf16*>(d),
        static_cast<bf16*>(x_ee));
  else
    bwd_fold_kernel<false><<<grid, 256, 0, as_stream(stream)>>>(
        cotangent(dz, z, dzsum, dzssq), cout, n_out, pro, s,
        static_cast<bf16*>(g), static_cast<bf16*>(d),
        static_cast<bf16*>(x_ee));
  return static_cast<int>(cudaGetLastError());
}

// The dgrad's prepass: gslab [slab_len][cp] (g [cout][n_out], int8 where
// quant, else bf16; zero channels cout..cp) and, where dres is not null,
// dslab [slab_len][cout] bf16 (dres [cout][n_out]), both in the fused
// forward's padded layout at the output geometry (oh x ow images, guard =
// ow + 2 zero positions, a zero row and column an image, zeros to
// slab_len). cout % 8 == 0; cp % 32 == 0 where quant, else cp == cout.
int dgrad_pre_launch(const void* g, const void* dres, void* gslab,
                     void* dslab, int quant, int cout, int cp, int n_out,
                     int oh, int ow, long slab_len, void* stream) {
  using namespace dgrad;
  if (cout < 8 || cout % 8 || cp < cout || (quant ? cp % 32 : cp != cout) ||
      oh < 1 || ow < 1 || n_out < 1 || n_out % (oh * ow))
    return static_cast<int>(cudaErrorInvalidValue);
  const int guard = ow + 2, per = (oh + 1) * (ow + 1);
  const long b = n_out / (oh * ow);
  const long pads = slab_len - n_out;
  if (pads < guard + b * (ow + 1 + oh) + guard)
    return static_cast<int>(cudaErrorInvalidValue);
  const long pos_tiles = (n_out + PRE_P - 1) / PRE_P;
  const long tiles_g = pos_tiles * ((cp + PRE_C - 1) / PRE_C);
  const long tiles_d = dres != nullptr ? pos_tiles * ((cout + PRE_C - 1) /
                                                      PRE_C)
                                       : 0;
  const long pad_g = pads * (cp / (quant ? 16 : 8));
  const long pad_d = dres != nullptr ? pads * (cout / 8) : 0;
  const long blocks = tiles_g + tiles_d + (pad_g + pad_d + 255) / 256;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  const SlabPos live{oh * ow, ow, per, guard};
  const PadPos pp{guard, ow, oh, per, b * (ow + 1 + oh), b * per};
  const auto* d = static_cast<const unsigned short*>(dres);
  auto* ds = static_cast<unsigned short*>(dslab);
  if (quant)
    dgrad_pre_kernel<<<(unsigned)blocks, 256, 0, as_stream(stream)>>>(
        static_cast<const unsigned char*>(g),
        static_cast<unsigned char*>(gslab), d, ds, live, pp, cout, cp,
        n_out, (int)tiles_g, (int)tiles_d, pad_g, pad_d);
  else
    dgrad_pre_kernel<<<(unsigned)blocks, 256, 0, as_stream(stream)>>>(
        static_cast<const unsigned short*>(g),
        static_cast<unsigned short*>(gslab), d, ds, live, pp, cout, cp,
        n_out, (int)tiles_g, (int)tiles_d, pad_g, pad_d);
  return static_cast<int>(cudaGetLastError());
}

// The dgrad's GEMM: dx [cin, 4 * n_out] bf16 and part [2 * tiles][2 * cin]
// f32 (each (M tile, row parity)'s sums of dn * x and dn) from gslab
// [slab_len][cp] (dgrad_pre) and w_dg [cin][9 * cp] (plane-major, each
// tap's channels padded to cp), int8 with g_amax [n_out / tile] and ws_in
// [cin] (quant), or bf16 (cp == cout); through the masks of x [cin, 4 *
// n_out] bf16, scale/shift [cin] f32 and bits [cin, 4 * n_out] uint8 or
// null; the even-even pixels' shortcut from dslab [slab_len][cout] bf16
// and wpt [cin][cout] bf16 through the scratch sc [cin][n_out] f32, or
// (all three null, option A) from dres [cout][n_out] bf16. table [4][6]
// (host memory): each class's first weight tap, tap count and up to four
// slab row offsets (past guard + m). cin % 8 == 0, cout % 8 == 0.
int dgrad_gemm_launch(const void* gslab, const void* dslab, const void* w_dg,
                      const void* wpt, const void* g_amax,
                      const void* ws_in, const void* x, const void* scale,
                      const void* shift, const void* bits, const void* dres,
                      void* sc, void* dx, void* part, const int* table,
                      int quant, int cin, int cout, int cp, int n_out,
                      int oh, int ow, int tile, int tiles, long slab_len,
                      int thresh, float keep, void* stream) {
  using namespace dgrad;
  const int guard = ow + 2;
  if (cin < 1 || cin % 8 || cout % 8 || cp < cout ||
      (quant ? cp % 32 : cp != cout) || oh < 1 || ow < 1 ||
      n_out % (oh * ow) || tile < 1 || n_out % tile || tiles < 1 ||
      tiles > 65535 || slab_len < 2L * guard + (long)tiles * BM ||
      (wpt == nullptr) != (sc == nullptr) ||
      (wpt == nullptr) != (dslab == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{in<bf16>(x), in<float>(scale), in<float>(shift),
         in<unsigned char>(bits), in<float>(g_amax), in<float>(ws_in),
         in<bf16>(dres), static_cast<float*>(sc), static_cast<bf16*>(dx),
         static_cast<float*>(part), cin, cp, n_out, n_out / (oh * ow), oh,
         ow, tile, thresh, keep, {}, {}, {}};
  for (int p = 0; p < 4; ++p) {
    const int* t = table + 6 * p;
    if (t[1] < 1 || t[1] > 4 || t[0] < 0 || t[0] + t[1] > 9)
      return static_cast<int>(cudaErrorInvalidValue);
    a.first[p] = t[0];
    a.count[p] = t[1];
    for (int j = 0; j < 4; ++j) {
      if (j < t[1] && (t[2 + j] < 0 || t[2 + j] > ow + 2))
        return static_cast<int>(cudaErrorInvalidValue);
      a.off[p][j] = j < t[1] ? t[2 + j] : 0;
    }
  }
  const int b = n_out / (oh * ow);
  const fwd_wgmma_bf16::Args gp{in<bf16>(gslab), in<bf16>(w_dg), nullptr,
                                nullptr, nullptr, cp, cin, n_out, b, oh, ow,
                                guard};
  const fwd_wgmma_bf16::Args pp{in<bf16>(dslab), in<bf16>(wpt), nullptr,
                                nullptr, nullptr, cout, cin, n_out, b, oh,
                                ow, guard};
  const cudaStream_t st = as_stream(stream);
  fwd_wgmma_s8::Maps mp{};
  if (!quant) return static_cast<int>(
      launch_kernel<false, 0>(mp, gp, pp, a, tiles, st));
  if (!fwd_wgmma_s8::encode_maps(&mp, gslab, slab_len, w_dg, cp, cin, BN,
                                   9))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (cp % 128) {
    case 0: return static_cast<int>(launch_kernel<true, 0>(mp, gp, pp, a,
                                                            tiles, st));
    case 32: return static_cast<int>(launch_kernel<true, 32>(mp, gp, pp, a,
                                                              tiles, st));
    case 64: return static_cast<int>(launch_kernel<true, 64>(mp, gp, pp, a,
                                                              tiles, st));
    default: return static_cast<int>(launch_kernel<true, 96>(mp, gp, pp, a,
                                                              tiles, st));
  }
}

// out[i] = the sum over the slots of part [slots][m] f32 in
// common::tile_sum's fixed order (the dgrad's d(scale) and d(shift))
int dgrad_sum_launch(const void* part, void* out, int slots, int m,
                     void* stream) {
  return common::tile_sum<dgrad::TransitionDgradSum>(
      in<float>(part), static_cast<float*>(out), slots, m, as_stream(stream));
}

// out[i] = sum over k < j of part[k][i], in order (part [j][m] f32)
int partial_sum_launch(const void* part, void* out, int j, int m,
                       void* stream) {
  return common::partial_sum(in<float>(part), static_cast<float*>(out), j, m,
                             as_stream(stream));
}

}  // extern "C"
