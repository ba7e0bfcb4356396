// Pieces shared by the fused block-half kernels (fused_block.cu, the int8
// conv core; fused_block_bf16.cu, the bf16 one), the stage-transition
// half (transition.cu) and the int8 serving conv (requant_wgmma_s8.cuh):
// 8-wide bf16 loads, the stats-cotangent fold, the f32 and bf16
// prologues, the per-group int8 quantizer (amax pass, quant pass; and one
// scale group a thread-block cluster, in one pass), where
// the forwards' prepasses put each lane in their padded slab, and the one
// copy of codes (or bf16) into that slab.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "seed_bits.cuh"

namespace fused_half {

// 8 consecutive bf16 as f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, size_t off,
                                      float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p + off);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(e[k]);
}

// 8 bf16 values packed into 16 bytes
__device__ __forceinline__ uint4 pack8(const __nv_bfloat16 (&v)[8]) {
  uint4 raw;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) e[k] = v[k];
  return raw;
}

// gf = (dy + dysum) + (2y) * dyssq (one fma), or dy without stats
// cotangents, in f32
struct Cotangent {
  const __nv_bfloat16* dy;
  const __nv_bfloat16* y;  // null: no stats cotangents
  const float* dysum;
  const float* dyssq;

  __device__ __forceinline__ void operator()(int row, int n, size_t off,
                                             float (&v)[8]) const {
    load8(dy, (size_t)row * n + off, v);
    if (y == nullptr) return;
    float yv[8];
    load8(y, (size_t)row * n + off, yv);
    const float s = dysum[row], q = dyssq[row];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = __fmaf_rn(2.f * yv[k], q, __fadd_rn(v[k], s));
  }
};

// --- elementwise operands of the quantizers ------------------------------

// d = dropout(relu(x * scale + shift)) in f32; no bits: no dropout
struct Prologue {
  const __nv_bfloat16* x;
  const float* scale;
  const float* shift;
  dropout::DropBits bits;
  int thresh;
  float keep;  // f32(256 / thresh)

  // One lane: xv of a channel of scale sc and shift sh, at dropout byte b
  // (read only where drop, bits.active()). The one place the prologue
  // rounds: operator() below and the transition's backward units, whose
  // codes are scaled by the absmax that operator() took in the forward.
  __device__ __forceinline__ float one(float xv, float sc, float sh,
                                       bool drop, int b) const {
    const float r = fmaxf(__fmaf_rn(xv, sc, sh), 0.f);
    return !drop ? r : (b < thresh ? __fmul_rn(r, keep) : 0.f);
  }

  __device__ __forceinline__ void operator()(int row, int n, size_t off,
                                             float (&v)[8]) const {
    float xv[8];
    unsigned char b[8];
    load8(x, (size_t)row * n + off, xv);
    bits.load8(row, (int)off, b);
    const float sc = scale[row], sh = shift[row];
    const bool drop = bits.active();
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = one(xv[k], sc, sh, drop, b[k]);
  }
};

// The (row, 8-lane chunk) units of one scale group: group g covers lanes
// [g * tile, (g + 1) * tile) of every row; block s of `slices` takes every
// slices-th unit.
struct GroupWalk {
  int n, tile, slices;
  __device__ __forceinline__ long units(int rows) const {
    return (long)rows * (tile / 8);
  }
  __device__ __forceinline__ void at(long u, int g, int& row,
                                     size_t& off) const {
    const int per_row = tile / 8;
    row = (int)(u / per_row);
    off = (size_t)g * tile + (size_t)(u % per_row) * 8;
  }
};

__device__ __forceinline__ float block_max(float m) {
  __shared__ float red[8];
  m = common::warp_max(m);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  float r = red[0];
  for (int k = 1; k < (int)blockDim.x / 32; ++k) r = fmaxf(r, red[k]);
  return r;
}

// partial maxima of |f| per (group, slice) block: part[g * slices + s]
template <typename Fn>
__device__ __forceinline__ void amax_body(const Fn& fn, int rows,
                                          const GroupWalk& walk,
                                          float* __restrict__ part) {
  const int s = blockIdx.x, g = blockIdx.y;
  float m = 0.f;
  for (long u = (long)s * blockDim.x + threadIdx.x; u < walk.units(rows);
       u += (long)walk.slices * blockDim.x) {
    int row;
    size_t off;
    walk.at(u, g, row, off);
    float v[8];
    fn(row, walk.n, off, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) m = fmaxf(m, fabsf(v[k]));
  }
  m = block_max(m);
  if (threadIdx.x == 0) part[g * walk.slices + s] = m;
}

// Where quant_body puts a unit's 8 codes (row, lanes [off, off + 8) of a
// [rows, n] operand): in the same lane layout, q[row * n + off].
struct LaneStore {
  __device__ __forceinline__ void operator()(signed char* q, int row, int n,
                                             size_t off, uint2 v) const {
    *reinterpret_cast<uint2*>(q + (size_t)row * n + off) = v;
  }
};

// q = s8(clip(rint(f * 127 / max(amax, floor)))) per group, the group's
// absmax into amax[g], and bf16(f) into copy when it is not null; each
// unit's codes placed by `store`
template <typename Fn, typename Store = LaneStore>
__device__ __forceinline__ void quant_body(const Fn& fn, int rows,
                                           const GroupWalk& walk,
                                           const float* __restrict__ part,
                                           float floor,
                                           signed char* __restrict__ q,
                                           float* __restrict__ amax,
                                           __nv_bfloat16* __restrict__ copy,
                                           const Store& store = Store()) {
  const int s = blockIdx.x, g = blockIdx.y;
  float a = part[g * walk.slices];
  for (int k = 1; k < walk.slices; ++k)
    a = fmaxf(a, part[g * walk.slices + k]);
  const float inv = __fdiv_rn(127.f, fmaxf(a, floor));
  if (s == 0 && threadIdx.x == 0) amax[g] = a;
  for (long u = (long)s * blockDim.x + threadIdx.x; u < walk.units(rows);
       u += (long)walk.slices * blockDim.x) {
    int row;
    size_t off;
    walk.at(u, g, row, off);
    float v[8];
    fn(row, walk.n, off, v);
    uint2 packed;
    signed char* o = reinterpret_cast<signed char*>(&packed);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      o[k] = common::quant_s8(__fmul_rn(v[k], inv));
    store(q, row, walk.n, off, packed);
    if (copy != nullptr) {
      const size_t idx = (size_t)row * walk.n + off;
      uint4 raw;
      __nv_bfloat16* c = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int k = 0; k < 8; ++k) c[k] = __float2bfloat16_rn(v[k]);
      *reinterpret_cast<uint4*>(copy + idx) = raw;
    }
  }
}

// One launch quantizes one or two operands over the same scale groups
// (group g of each operand covers the same images; its lanes per group may
// differ, as the stride-2 transition's input and output do): blockIdx.z
// selects the operand (z = 0: fn0 over rows0 and walk0; z = 1: fn1). Both
// walks take the grid's slices.
template <typename Fn0, typename Fn1>
__global__ void __launch_bounds__(256)
amax_kernel(Fn0 fn0, int rows0, GroupWalk walk0, Fn1 fn1, int rows1,
            GroupWalk walk1, float* __restrict__ part) {
  const int groups = gridDim.y;
  if (blockIdx.z == 0)
    amax_body(fn0, rows0, walk0, part);
  else
    amax_body(fn1, rows1, walk1, part + groups * walk0.slices);
}

struct QuantOut {
  float floor;
  signed char* q;
  float* amax;
  __nv_bfloat16* copy;
};

// --- one scale group quantized by one thread-block cluster ------------------
//
// The amax pass and the quant pass above are two launches, and the second
// reads every operand again from device memory. A cluster of kClusterCtas
// blocks, co-scheduled on one GPC, quantizes a whole group in one launch
// that reads its operands from device memory once (the second pass finds
// them in L2): each block folds its share of the group's units (fn) and
// takes its partial absmax, the cluster reduces the partial maxima through
// distributed shared memory (barrier.cluster, ld.shared::cluster), then
// each block quantizes its share at the group's scale. No block waits on
// a flag in global memory: only a cluster's blocks are sure to run
// together.

constexpr int kClusterCtas = 8;

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// barrier.cluster's two halves: arrive (release) and wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// the float at `p` (this block's shared memory) in block `rank` of the
// cluster
__device__ __forceinline__ float cluster_load(const float* p, int rank) {
  const uint32_t local = (uint32_t)__cvta_generic_to_shared(p);
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// Group g quantized by the calling block's cluster, as quant_body
// quantizes it after amax_body: block rank s of the cluster's
// kClusterCtas takes units s * blockDim + t, + kClusterCtas * blockDim,
// ... (amax_body's split at slices = kClusterCtas; walk.slices is not
// read), folds each (fn) and takes the absmax of its share;
// the cluster's maximum is the group's absmax, written to amax[g] by rank
// 0; then each unit's codes s8(clip(rint(f * (127 / max(amax, floor)))))
// are placed by `store`. The second pass calls fn again on the block's
// units, whose operands the first pass brought into L2 a moment before.
// Tried on an H100 and dropped: holding the fold in the cluster's shared
// memory (160 KiB a block at WRN-28-10's groups) left the launch's other
// blocks one an SM, 1.8x slower; four or eight units' loads in flight a
// thread raised the registers of every block of the launch (64, 74 from
// 40) and ran 8% and 25% slower. Every thread of the cluster calls it.
template <typename Fn, typename Store = LaneStore>
__device__ __forceinline__ void cluster_quant_body(
    const Fn& fn, int rows, const GroupWalk& walk, int g, float floor,
    signed char* __restrict__ q, float* __restrict__ amax,
    const Store& store = Store()) {
  __shared__ float slot;
  const int s = cluster_rank();
  const long units = walk.units(rows);
  const long step = (long)kClusterCtas * blockDim.x;
  const long u0 = (long)s * blockDim.x + threadIdx.x;
  float m = 0.f;
  for (long u = u0; u < units; u += step) {
    int row;
    size_t off;
    walk.at(u, g, row, off);
    float v[8];
    fn(row, walk.n, off, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) m = fmaxf(m, fabsf(v[k]));
  }
  m = block_max(m);
  if (threadIdx.x == 0) slot = m;
  cluster_arrive();
  cluster_wait();  // every block's slot is written
  float a = 0.f;
  for (int r = 0; r < kClusterCtas; ++r)
    a = fmaxf(a, cluster_load(&slot, r));
  cluster_arrive();  // this block has read its peers' slots
  const float inv = __fdiv_rn(127.f, fmaxf(a, floor));
  if (s == 0 && threadIdx.x == 0) amax[g] = a;
  for (long u = u0; u < units; u += step) {
    int row;
    size_t off;
    walk.at(u, g, row, off);
    float v[8];
    fn(row, walk.n, off, v);
    uint2 packed;
    signed char* o = reinterpret_cast<signed char*>(&packed);
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = common::quant_s8(__fmul_rn(v[k], inv));
    store(q, row, walk.n, off, packed);
  }
  cluster_wait();  // no block leaves while a peer may still read its slot
}

template <typename Fn0, typename Fn1>
__global__ void __launch_bounds__(256)
quant_kernel(Fn0 fn0, int rows0, GroupWalk walk0, QuantOut out0, Fn1 fn1,
             int rows1, GroupWalk walk1, QuantOut out1,
             const float* __restrict__ part) {
  const int groups = gridDim.y;
  if (blockIdx.z == 0)
    quant_body(fn0, rows0, walk0, part, out0.floor, out0.q, out0.amax,
               out0.copy);
  else
    quant_body(fn1, rows1, walk1, part + groups * walk0.slices, out1.floor,
               out1.q, out1.amax, out1.copy);
}

// Where the forward's prepasses (the bf16 one in fused_block_bf16.cu, the
// int8 one in fused_block.cu) and the dgrads' (fused_block_bf16.cu and
// fused_block.cu, g at Cin = the half's Cout; slab_copy) write: input
// lane p (image i, row r, column c of h x wi images) at slab position
// guard + i * (h + 1) * (wi + 1) + (r + 1) * (wi + 1) + c + 1
// (ops/cuda/fused_block.py fused_fwd_layout).
struct SlabPos {
  int hw, wi, per, guard;
  __device__ __forceinline__ long operator()(long p) const {
    const long i = p / hw;
    const int rem = (int)(p - i * hw), r = rem / wi, c = rem - r * wi;
    return guard + i * per + (r + 1) * (wi + 1) + c + 1;
  }
};

// The slab's k-th position that holds no pixel: the lead guard, then per
// image its zero row (wi + 1 positions) and the zero column of rows 1..h,
// then the tail (whole tiles and the trailing guard).
struct PadPos {
  int guard, wi, h, per;
  long img_pads, m_valid;  // b * (wi + 1 + h); b * per
  __device__ __forceinline__ long operator()(long k) const {
    if (k < guard) return k;
    k -= guard;
    if (k < img_pads) {
      const long i = k / (wi + 1 + h);
      const int j = (int)(k - i * (wi + 1 + h));
      return guard + i * per + (j <= wi ? j : (j - wi) * (wi + 1));
    }
    return guard + m_valid + (k - img_pads);
  }
};

// The prepasses' tiles: PRE_C channels x PRE_P positions, 256 threads
constexpr int PRE_C = 32;
constexpr int PRE_P = 128;

// Pad vector v of the slab [.., c] of T (16 bytes of channels of the
// pads(v / vectors a position)-th pad position) set to zero, a thread
// each; v >= pad_vecs does nothing. c * sizeof(T) % 16 == 0.
template <typename T>
__device__ __forceinline__ void zero_pad_vec(T* __restrict__ slab,
                                             const PadPos& pads, int c,
                                             long v, long pad_vecs) {
  if (v >= pad_vecs) return;
  constexpr int PER = 16 / sizeof(T);
  const int vpp = c / PER;
  const long k = v / vpp;
  *reinterpret_cast<uint4*>(slab + pads(k) * c + (v - k * vpp) * PER) =
      make_uint4(0u, 0u, 0u, 0u);
}

// A prepass tile's second half: the shared tile holds position p's PRE_C
// channels of T in row words[p], two channels a Word (sizeof(Word) == 2 *
// sizeof(T)); each thread writes 16-byte runs of a position's row to out
// [at(p0 + p), c] at channel c0 + run * 16 / sizeof(T). A run or position
// past c or n is skipped. Call after the tile's writes are synced.
template <typename T, typename Word, int PITCH, typename At>
__device__ __forceinline__ void store_runs(Word (*words)[PITCH],
                                           T* __restrict__ out, int c,
                                           int c0, long p0, int n,
                                           const At& at) {
  static_assert(sizeof(Word) == 2 * sizeof(T), "two channels a word");
  constexpr int PER = 16 / sizeof(T);      // channels a run
  constexpr int RUNS = PRE_C / PER;        // runs a position
#pragma unroll
  for (int r = 0; r < PRE_P * RUNS / 256; ++r) {
    const int idx = threadIdx.x + 256 * r;
    const int p = idx / RUNS, run = idx % RUNS;
    const int cc = c0 + PER * run;
    if (cc < c && p0 + p < n) {
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(words[p]) + 4 * run;
      *reinterpret_cast<uint4*>(out + at(p0 + p) * c + cc) =
          make_uint4(src[0], src[1], src[2], src[3]);
    }
  }
}

// Shared bytes of one copy_tile of U: a position's PRE_C channels, two a
// word, and a spare word a row
template <typename U>
constexpr int kCopyTileBytes = PRE_P * (PRE_C / 2 + 2) * 2 * sizeof(U);

// One prepass tile of PRE_C channels x PRE_P positions of src [c_src][n]
// (U: the element's bits, 1 or 2 bytes; channels past c_src read as
// zeros) into the slab [.., c] at each pixel's position (live): thread
// (ch, g) reads 16 positions of one channel (16-byte loads where the run
// lies whole in n and is aligned, else element by element), the tile is
// transposed through shared memory (buf, kCopyTileBytes<U> bytes, 16-byte
// aligned), and store_runs writes each position's channels as 16-byte
// runs of its slab row. Tiles run channel group fastest (tile t: group t
// % ceil(c / PRE_C), positions from t / ceil(c / PRE_C) * PRE_P), so
// blocks running together write whole slab rows.
template <typename U>
__device__ __forceinline__ void copy_tile(const U* __restrict__ src,
                                          int c_src, U* __restrict__ slab,
                                          int c, int n, long tile,
                                          const SlabPos& live, void* buf) {
  static_assert(PRE_C == 32 && PRE_P == 8 * 16, "the threads' runs");
  using Word = typename std::conditional<sizeof(U) == 1, unsigned short,
                                         uint32_t>::type;
  constexpr int PITCH = PRE_C / 2 + 2;
  Word(*words)[PITCH] = reinterpret_cast<Word(*)[PITCH]>(buf);
  const int cgs = (c + PRE_C - 1) / PRE_C;
  const int c0 = (int)(tile % cgs) * PRE_C;
  const long p0 = tile / cgs * PRE_P;
  const int ch = threadIdx.x / 8, g = threadIdx.x % 8;
  const long pos = p0 + 16 * g;
  const bool in = c0 + ch < c_src;
  const U* s = src + (size_t)(in ? c0 + ch : 0) * n + pos;
  alignas(16) U v[16];
  if (in && pos + 16 <= n && reinterpret_cast<uintptr_t>(s) % 16 == 0) {
#pragma unroll
    for (int k = 0; k < (int)sizeof(U); ++k)
      reinterpret_cast<uint4*>(v)[k] = reinterpret_cast<const uint4*>(s)[k];
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = in && pos + k < n ? s[k] : U(0);
  }
  U* t = reinterpret_cast<U*>(&words[0][0]);
#pragma unroll
  for (int k = 0; k < 16; ++k) t[(16 * g + k) * 2 * PITCH + ch] = v[k];
  __syncthreads();
  store_runs(words, slab, c, c0, p0, n, live);
}

// The one copy of an operand into the padded slab: blocks [0, tiles) each
// copy_tile one tile of src [c_src][n] into slab [.., c]; the others
// write 16-byte zeros at every pad position (zero_pad_vec), a thread
// each. The int8 serving conv's prepass (codes x_q) and the fused int8
// dgrad's (g's codes) launch it as it is.
template <typename U>
__global__ void __launch_bounds__(256)
    slab_copy_kernel(const U* __restrict__ src, U* __restrict__ slab,
                     SlabPos live, PadPos pads, int c_src, int c, int n,
                     int tiles, long pad_vecs) {
  __shared__ __align__(16) unsigned char buf[kCopyTileBytes<U>];
  if ((long)blockIdx.x < tiles) {
    copy_tile(src, c_src, slab, c, n, blockIdx.x, live, buf);
    return;
  }
  zero_pad_vec(slab, pads, c, (long)(blockIdx.x - tiles) * 256 + threadIdx.x,
               pad_vecs);
}

// slab [slab_len][c] of ops/cuda/fused_block.py fused_fwd_layout (guard =
// wi + 2 zero positions, per image of h x wi a zero row and a zero column,
// zeros to slab_len; channels past c_src zero) from src [c_src][n]: each
// pixel's channels at its position. c a multiple of PRE_C, c_src <= c, n
// whole images. One launch.
template <typename U>
inline cudaError_t slab_copy(const U* src, U* slab, int c_src, int c, int n,
                             int h, int wi, long slab_len,
                             cudaStream_t stream) {
  if (c < PRE_C || c % PRE_C || c_src < 1 || c_src > c || h < 1 || wi < 1 ||
      n < 1 || n % (h * wi))
    return cudaErrorInvalidValue;
  const int guard = wi + 2, per = (h + 1) * (wi + 1);
  const long b = n / (h * wi);
  const long pads = slab_len - n;
  if (pads < guard + b * (wi + 1 + h) + guard) return cudaErrorInvalidValue;
  const long tiles = (long)((n + PRE_P - 1) / PRE_P) * (c / PRE_C);
  const long pad_vecs = pads * (c * (long)sizeof(U) / 16);
  const long blocks = tiles + (pad_vecs + 255) / 256;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  slab_copy_kernel<U><<<(unsigned)blocks, 256, 0, stream>>>(
      src, slab, SlabPos{h * wi, wi, per, guard},
      PadPos{guard, wi, h, per, b * (wi + 1 + h), b * per}, c_src, c, n,
      (int)tiles, pad_vecs);
  return cudaGetLastError();
}

constexpr float kFwdFloor = 1e-12f;
constexpr float kBwdFloor = 1e-30f;

// d = dropout(relu(bf16(x * scale + shift))) in bf16, 8 at a time
struct Bf16Prologue {
  const __nv_bfloat16* x;
  const float* scale;
  const float* shift;
  dropout::DropBits bits;
  int thresh;
  float keep;  // f32(256 / thresh)
  int n;

  // One lane of operator()'s prologue at the same rounding points, for
  // the transition's straight-through units (held bit-equal to
  // bwd_fold_plain on the card). operator() keeps its own loop: routed
  // through one(), two of fused_block_bf16.cu's kernels compiled to other
  // SASS (tools/compare_sass.py on an H100).
  __device__ __forceinline__ __nv_bfloat16 one(float xv, float sc, float sh,
                                               bool drop, int b) const {
    const float r = fmaxf(
        __bfloat162float(__float2bfloat16_rn(__fmaf_rn(xv, sc, sh))), 0.f);
    return __float2bfloat16_rn(
        !drop ? r : (b < thresh ? __fmul_rn(r, keep) : 0.f));
  }

  __device__ __forceinline__ void operator()(int ch, int pos,
                                             __nv_bfloat16 (&d)[8]) const {
    float xv[8];
    unsigned char b[8];
    load8(x, (size_t)ch * n + pos, xv);
    bits.load8(ch, pos, b);
    const float sc = scale[ch], sh = shift[ch];
    const bool drop = bits.active();
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float r = fmaxf(
          __bfloat162float(__float2bfloat16_rn(__fmaf_rn(xv[k], sc, sh))),
          0.f);
      d[k] = __float2bfloat16_rn(
          !drop ? r : (b[k] < thresh ? __fmul_rn(r, keep) : 0.f));
    }
  }
};

}  // namespace fused_half
