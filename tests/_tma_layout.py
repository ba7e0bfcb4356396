"""How ``conv3x3_wgrad``'s kernel expects TMA to lay its boxes into shared
memory (ops/cuda/csrc/wgrad_wgmma_bf16.cuh), in plain torch: what the card
probe ``conv3x3.tma_box_probe`` must return (tests/test_torch_cuda_kernels.py)
and the swizzle the CPU model of the kernel's reads applies
(tests/test_torch_conv3x3_wgrad_tma.py). Imports no JAX: the card runs
it."""

import torch

BK, PIECE = 64, 32  # positions a K step, channels a staged box of x


def swizzle_offset(off, swizzle: int):
    """Byte ``off`` of a 1024-byte-aligned tile moved as the ``swizzle``-
    byte swizzle moves it (128, 64, 32; 16: not at all): the 16-byte chunk
    index XORed with the row of 128 bytes, modulo swizzle / 16 (CuTe's
    Swizzle<log2(swizzle / 16), 4, 3>). Takes ints or integer arrays."""
    mask = swizzle // 16 - 1
    return off ^ (((off >> 7) & mask) << 4)


def tma_box_probe_plain(t, *, h: int, w_img: int, dy: bool,
                        at: tuple, bn: int = 64,
                        plane: int = 0) -> torch.Tensor:
    """What ``tma_box_probe`` returns if TMA lands the box dense, channel
    rows one after another, zeros outside the view's bounds and past the
    channels, then moves each byte as the box's swizzle moves its address:
    x's box (``dy`` False) of t [C, N], or of plane ``plane`` of t [P, C,
    N], viewed (HW, B, C), 64 positions (80 where W >= 64) from position
    ``at[0]`` of image ``at[1]``, 32 channels, unswizzled; dy's box viewed
    (N, C), 64 positions from ``at[0]``, ``bn`` channels from ``at[1]``,
    in the 128-byte swizzle. uint8 on the CPU."""
    t = t.detach().cpu()
    if t.dim() == 3:
        t = t[plane]
    c, n = t.shape
    hw = h * w_img
    if dy:
        bw, bc, c0, base, end, swizzle = BK, bn, at[1], 0, n, 128
    else:
        bw = BK if w_img < BK else BK + 16
        bc, c0, base, end, swizzle = PIECE, 0, at[1] * hw, hw, 16
        if at[1] >= n // hw:
            base, end = 0, 0  # an image past the batch: all zeros
    ch = torch.arange(c0, c0 + bc)[:, None]
    q = torch.arange(bw)[None, :] + at[0]
    ok = (q >= 0) & (q < end) & (ch < c)
    vals = t[ch.clamp(max=c - 1), base + q.clamp(0, max(end - 1, 0))]
    src = torch.where(ok, vals, torch.zeros((), dtype=t.dtype))
    src = src.contiguous().view(torch.uint8).reshape(-1)
    out = torch.zeros(src.numel(), dtype=torch.uint8)
    out[swizzle_offset(torch.arange(src.numel()), swizzle)] = src
    return out
