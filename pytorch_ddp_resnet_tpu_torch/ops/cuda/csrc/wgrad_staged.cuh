// The staged weight-gradient mainloop for 16-bit NHWC operands, written for
// Hopper (sm_90a): dW = sum over positions of a(shifted)^T . g, one f32 tile
// per (M tile, N tile, chunk, split) block.
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/bneck_nv_train.py:928,
// _wgrad1x1_kernel / _wgrad3x3_kernel with quant_bwd=False, the bf16 body):
// the TPU kernel builds each chunk's prologued slab once and contracts it at
// the 9 tap shifts with the folded cotangent, carrying dW across its
// sequential grid. Here a prepass (bneck_nv_train.cu,
// nvt_wgrad_pre_bf16_kernel) writes the rounded operands a_b and g_b once,
// NHWC bf16, and this mainloop contracts them:
//   M = (tap, ci) rows of dW, N = Cout, K = the positions of one chunk (image
//   rows [k*rch, (k+1)*rch) of every image), split over blocks in runs of
//   whole K steps of BK positions.
//
// What bounds it on an H100: at ResNet-50's stages 1-2 (batch 128) the
// function's bytes (x, res, dy, y in, dW out: 51-256 MB a call, 15-77 us at
// 3.35 TB/s) outweigh its 13-30 GFLOP (13-30 us at 989 TFLOP/s bf16); the
// stage-3 3x3 is bound by operations. What the design does about it: the
// prologue and fold run once per element (the prepass, 16-byte loads and
// stores), not once per (tap, N tile) that reads it; the mainloop only
// copies rows of a_b and g_b as they lie in memory (cp.async.cg, 16 bytes a
// thread, a ring of STAGES tiles in dynamic shared memory, one barrier per K
// step) and transposes them on the way into the tensor cores
// (ldmatrix.x4.trans: channel-contiguous rows become the K-contiguous
// fragments of mma.sync m16n8k16); a 128-wide N tile reads A ceil(Cout/128)
// times; blocks with neighbouring blockIdx.x share their (chunk, split) and
// so read the same g_b rows and overlapping a_b rows through L2.
//
// Shared-memory tiles: A as [BK positions][BM channels], B as [BK
// positions][BN channels], each row padded by 16 bytes so that the eight
// 16-byte rows an ldmatrix reads fall in distinct banks. For tap (dy, dx)
// row kk of A holds a_b at (r + dy - 1, c + dx - 1) of the image of position
// kk; outside the image the copy's src-size is 0 (16 zero bytes). A halo row
// inside the image is read from the neighbouring chunk's rows, as the TPU
// slab's halo pieces are. Positions past the chunk's last are zero in both
// operands. Every 16-byte piece of an A row carries its own tap, so a tile
// may straddle taps (Cin = 64 with BM = 128).
//
// Left for later: wgmma and TMA (the mainloop is mma.sync with cp.async),
// clusters, and one launch per pass (the split tiles go to device memory and
// a second kernel adds them in order).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgrad_staged {

constexpr int THREADS = 256;
constexpr int K_STEP = 64;  // positions a K step (the planner's WGRAD_BK)

struct Args {
  const __nv_bfloat16* a;  // [n, h, w, cin] bf16, NHWC
  const __nv_bfloat16* g;  // [n, h, w, cout] bf16, NHWC
  float* part;             // [h / rch][splits][taps * cin][cout] f32
  int n, h, w, cin, cout, taps, rch;
  int per;                 // K steps per split (the last may have fewer)
  int splits;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two blocks' rings on one SM: 228 KB of shared memory, 1 KB reserved a
// block.
constexpr int SMEM_PER_BLOCK = 232448 / 2 - 1024;

// Tile geometry: BK positions a K step, a ring of STAGES steps (4 where two
// blocks' rings still fit on one SM, else 3); 8 warps, BM / 32 along M (32
// rows each), the rest along N. 256 / BK threads copy each K row, PA (PB)
// 16-byte pieces of A (B) each.
template <int BM, int BN, int BK>
struct Tile {
  static constexpr int ROW_A = BM * 2 + 16;  // bytes per padded A row
  static constexpr int ROW_B = BN * 2 + 16;
  static constexpr int A_BYTES = BK * ROW_A;
  static constexpr int STAGE_BYTES = BK * (ROW_A + ROW_B);
  static constexpr int STAGES = 4 * STAGE_BYTES <= SMEM_PER_BLOCK ? 4 : 3;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
  static constexpr int WARPS_M = BM / 32;
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int WN = BN / WARPS_N;  // columns per warp
  static constexpr int NI = WN / 8;        // n8 fragments per warp
  static constexpr int TPR = THREADS / BK;  // threads per K row
  static constexpr int PA = BM / 8 / TPR;
  static constexpr int PB = BN / 8 / TPR;
  static_assert(BM == 64 || BM == 128, "BM");
  static_assert(BN == 64 || BN == 128, "BN");
  static_assert(THREADS % BK == 0 && BM / 8 % (THREADS / BK) == 0 &&
                    BN / 8 % (THREADS / BK) == 0, "whole pieces a thread");
  static_assert(WN % 16 == 0, "a warp takes pairs of n8 fragments");
};

// Border bits of a position: which neighbours lie inside the image.
constexpr int kUp = 1, kDown = 2, kLeft = 4, kRight = 8;

// Grid (ceil(taps*cin / BM), ceil(cout / BN), chunks * splits): block z
// takes K steps [split * per, min(steps, (split + 1) * per)) of chunk
// z / splits and writes its f32 tile to part[z].
template <int BM, int BN, int BK>
__global__ void __launch_bounds__(THREADS, 2) wgrad_staged_kernel(Args p) {
  using T = Tile<BM, BN, BK>;
  constexpr int STAGES = T::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int M = p.taps * p.cin;
  const int chunk = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const int per_img = p.rch * p.w;
  const int total = p.n * per_img;  // positions of the chunk
  const int steps = (total + BK - 1) / BK;
  const int kt0 = split * p.per;
  const int kt1 = min(steps, kt0 + p.per);

  // This thread's copies: one K row (position kk = kt * BK + kr) and PA / PB
  // 16-byte pieces of it. An A piece's source is the position's element
  // offset plus its own rel (tap shift and channel); it needs the border
  // bits in need (32: a row of M past taps * cin, never copied).
  const int kr = tid / T::TPR;
  int a_rel[T::PA], a_need[T::PA];
#pragma unroll
  for (int i = 0; i < T::PA; ++i) {
    const int m = m0 + 8 * (tid % T::TPR + T::TPR * i);
    const int tap = m < M ? m / p.cin : 0;
    const int dy = p.taps == 9 ? tap / 3 - 1 : 0;
    const int dx = p.taps == 9 ? tap % 3 - 1 : 0;
    a_rel[i] = (dy * p.w + dx) * p.cin + (m - tap * p.cin);
    a_need[i] = m >= M ? 32 : (dy < 0 ? kUp : 0) | (dy > 0 ? kDown : 0) |
                                  (dx < 0 ? kLeft : 0) | (dx > 0 ? kRight : 0);
  }
  const uint32_t s0 = smem_u32(smem);
  const uint32_t a_dst = kr * T::ROW_A + (tid % T::TPR) * 16;
  const uint32_t b_dst = T::A_BYTES + kr * T::ROW_B + (tid % T::TPR) * 16;

  auto load = [&](int kt, int stage) {
    const uint32_t st = s0 + stage * T::STAGE_BYTES;
    const int kk = kt * BK + kr;
    const bool in = kk < total;
    const int kc = in ? kk : 0;
    const int img = kc / per_img;
    const int rem = kc - img * per_img;
    const int r = rem / p.w;
    const int c = rem - r * p.w;
    const int ry = chunk * p.rch + r;
    const long pos = ((long)img * p.h + ry) * p.w + c;
    const int have = in ? (ry > 0 ? kUp : 0) | (ry < p.h - 1 ? kDown : 0) |
                              (c > 0 ? kLeft : 0) | (c < p.w - 1 ? kRight : 0)
                        : 0;
    const __nv_bfloat16* a_pos = p.a + pos * p.cin;
#pragma unroll
    for (int i = 0; i < T::PA; ++i) {
      const bool ok = in && (a_need[i] & ~have) == 0;
      cp_async16(st + a_dst + i * T::TPR * 16, ok ? a_pos + a_rel[i] : p.a,
                 ok);
    }
    const __nv_bfloat16* g_pos = p.g + pos * p.cout + n0;
#pragma unroll
    for (int i = 0; i < T::PB; ++i) {
      const int n = 8 * (tid % T::TPR + T::TPR * i);
      const bool ok = in && n0 + n < p.cout;
      cp_async16(st + b_dst + i * T::TPR * 16, ok ? g_pos + n : p.g, ok);
    }
  };

  // ldmatrix.x4.trans lanes: lane l addresses row (l / 8) of one of four
  // 8x8 matrices. A (m16 x k16, stored k-major): matrices (m 0-7, k 0-7),
  // (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15) = a0..a3. B (k16 x
  // n16, stored k-major): (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
  // (k 8-15, n 8-15) = b0, b1 of n8 fragment 0, then of fragment 1.
  const int q = lane / 8, j = lane % 8;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const uint32_t a_ld =
      ((q >> 1) * 8 + j) * T::ROW_A + (wm * 32 + (q & 1) * 8) * 2;
  const uint32_t b_ld = T::A_BYTES + ((q & 1) * 8 + j) * T::ROW_B +
                        (wn * T::WN + (q >> 1) * 8) * 2;

  float acc[2][T::NI][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (kt0 + s < kt1) load(kt0 + s, s);
    cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step kt's tile landed; step kt-1's reads are done
    const int next = kt + STAGES - 1;
    if (next < kt1) load(next, (next - kt0) % STAGES);
    cp_async_commit();
    const uint32_t st = s0 + ((kt - kt0) % STAGES) * T::STAGE_BYTES;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4_trans(af[mi], st + a_ld + ks * 16 * T::ROW_A + mi * 32);
#pragma unroll
      for (int nj = 0; nj < T::NI / 2; ++nj) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, st + b_ld + ks * 16 * T::ROW_B + nj * 32);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the f32 tile: fragment (mi, ni) holds rows g, g + 8 and columns 2t, 2t + 1
  float* out = p.part + (size_t)blockIdx.z * M * p.cout;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni) {
      const int n = n0 + wn * T::WN + ni * 8 + (lane % 4) * 2;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = m0 + wm * 32 + mi * 16 + lane / 4 + hr * 8;
        if (m < M && n < p.cout)
          *reinterpret_cast<float2*>(out + (size_t)m * p.cout + n) =
              make_float2(acc[mi][ni][2 * hr], acc[mi][ni][2 * hr + 1]);
      }
    }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

}  // namespace wgrad_staged
