// Weight gradient of a stride-1 SAME 3x3 convolution in the channel-major
// layout [C, B*H*W], bf16 operands and f32 sums, written for Hopper
// (sm_90a) and bound to Python through a plain C interface
// (ops/cuda/conv3x3.py loads this file's shared library with ctypes).
//
// What it replaces (pytorch_ddp_resnet_tpu/ops/pallas/conv.py):
//   conv3x3_wgrad_launch  <- conv3x3_wgrad_lanes, body _wgrad_kernel: dW
//                            [9*Cin, Cout] (HWIO) = patches(x) [9*Cin, N] x
//                            dy [Cout, N]^T, f32 sums over every position
//   partial_sum_launch    <- the TPU kernel's sum carried across its grid
//
// What bounds it on an H100, and the design: wgrad_wgmma_bf16.cuh (TMA
// reads x and dy where they lie, x at each tap's row with zero fill at the
// border; a shifter warpgroup moves x by each tap's column; a wgmma
// mainloop; f32 split tiles), on one plane of x with tap (dh, dw) moved by
// dh - 1 rows and dw - 1 columns. The header encodes the two tensor maps on
// the host and passes them by value as __grid_constant__ kernel
// parameters.
//
// conv3x3_wgrad_probe_launch is no part of the gradient: it loads one box
// through the map the kernel reads x or dy with and copies the shared
// memory it landed in back out, so that a test on the card can hold the
// layout to the one the mainloop's descriptors assume.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "wgrad_wgmma_bf16.cuh"

namespace {

namespace wg = wgrad_wgmma_bf16;

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

// Names the ordered sum's kernel in a profile.
struct WgradTmaSum {};

// One box of `map` (x's map where dy is 0, dy's where 1) at (x0, y0[,
// row0]) into zeroed shared memory, then its `bytes` bytes to out as they
// lie, and at out[bytes] 1 if the barrier saw them land, 0 if it gave up
// waiting. The wait is bounded, so that a box whose bytes are not `bytes`
// cannot hang the card.
__global__ void tma_probe_kernel(const __grid_constant__ CUtensorMap map,
                                 int dy, unsigned char* out, int bytes,
                                 int x0, int y0, int row0) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t pad = (wg::ALIGN - raw % wg::ALIGN) % wg::ALIGN;
  unsigned char* buf = smem_raw + pad;
  __shared__ uint64_t bar_mem;
  const uint32_t bar = wg::smem_u32(&bar_mem);
  for (int i = threadIdx.x; i < bytes; i += blockDim.x) buf[i] = 0;
  // the zeros (generic proxy) ordered before TMA's writes (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (threadIdx.x == 0) {
    wg::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    wg::mbar_arrive_tx(bar, bytes);
    if (dy)
      wg::tma_load_2d(raw + pad, &map, bar, x0, y0);
    else
      wg::tma_load_3d(raw + pad, &map, bar, x0, y0, row0);
  }
  uint32_t done = 0;
  for (int spin = 0; spin < (1 << 20) && !done; ++spin)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  for (int i = threadIdx.x; i < bytes; i += blockDim.x) out[i] = buf[i];
  if (threadIdx.x == 0) out[bytes] = done;
}

}  // namespace

extern "C" {

// x [cin, n] bf16, dy [cout, n] bf16 (n = b * h * wi, 16-byte aligned),
// part [splits][9 * cin][cout] f32, split s covering K steps [s * per,
// min(steps, (s + 1) * per)) of 64 positions; bn the N tile. The geometry
// is ops/cuda/conv3x3.py check_wgrad_geometry's. Returns a cudaError_t.
int conv3x3_wgrad_launch(const void* x, const void* dy, void* part, int cin,
                         int cout, int n, int h, int wi, int bn, int per,
                         int splits, void* stream) {
  int tab[3 * 9];  // tap (dh, dw): plane 0, dh - 1 rows, dw - 1 columns
  for (int t = 0; t < 9; ++t) {
    tab[3 * t] = 0;
    tab[3 * t + 1] = t / 3 - 1;
    tab[3 * t + 2] = t % 3 - 1;
  }
  return static_cast<int>(wg::launch_taps(
      x, 1, dy, static_cast<float*>(part), tab, 9, cin, cout, n, h, wi, bn,
      per, splits, as_stream(stream)));
}

// out[i] = sum over k < j of part[k][i], in order (part [j][m] f32)
int partial_sum_launch(const void* part, void* out, int j, int m,
                       void* stream) {
  return common::partial_sum<WgradTmaSum>(static_cast<const float*>(part),
                                          static_cast<float*>(out), j, m,
                                          as_stream(stream));
}

// One box of t [planes][c][n] bf16 (h x wi images) through the map the
// kernels read x with (dy = 0: box at position x0 of image y0 of plane
// `plane`, channels from 0) or of t [c][n] through dy's (dy = 1: box of bn
// channels at position x0, channel y0), loaded into zeroed,
// 1024-byte-aligned shared memory: the box's bytes to out as they landed,
// then a byte: 1 if they completed the barrier.
int conv3x3_wgrad_probe_launch(const void* t, void* out, int planes, int c,
                               int n, int h, int wi, int dy, int bn, int x0,
                               int y0, int plane, void* stream) {
  CUtensorMap map;
  const int bytes = dy ? 2 * wg::BK * bn
                       : 2 * (wi >= wg::BK ? wg::XROW / 2 : wg::BK) * wg::PIECE;
  if (!(dy ? wg::encode_dy(&map, t, c, n, bn)
           : wg::encode_x(&map, t, planes * c, n, h, wi)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = bytes + wg::ALIGN;
  cudaError_t err = cudaFuncSetAttribute(
      tma_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tma_probe_kernel<<<1, 256, smem, as_stream(stream)>>>(
      map, dy, static_cast<unsigned char*>(out), bytes, x0, y0, plane * c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
