"""A numpy model of the TMA + wgmma weight gradient's reads
(ops/cuda/csrc/wgrad_wgmma_bf16.cuh ``wgrad_tma_kernel``), shared by the
CPU tests of its two users: ``conv3x3_same``'s wgrad
(tests/test_torch_conv3x3_wgrad_tma.py) and the lane transition's
straight-through wgrad and dWp (tests/test_torch_transition_wgrad_tma.py).

Per block (n tile, m tile, split) and K step: every TMA box gathered at the
producer's coordinates (x viewed as (HW, B, planes x C), dy as (N, C)) with
zeros out of bounds and laid into the stage as the card lays it (dense,
then the swizzle applied by address); the shifter warpgroup's copy of each
16-byte piece of staged x into the 128-byte-swizzled A tile, moved by its
tap's column shift; every k16 of both operands read back through the
consumers' wgmma descriptors (K-major, 128-byte swizzle); each split's tile
contracted in float64 and rounded to f32, the splits added in order in
f32. Numpy only (with ``_tma_layout``'s swizzle).
"""

import numpy as np

from _tma_layout import swizzle_offset

# csrc/wgrad_wgmma_bf16.cuh
BM, BK, PIECE, ROW, XROW, XPIECE = 128, 64, 32, 128, 160, 32 * 160

# conv3x3_same's taps (dh, dw): plane 0, moved by dh - 1 rows and dw - 1
# columns (conv3x3_wgrad.cu)
SAME_TABLE = tuple((0, dh - 1, dw - 1) for dh in range(3) for dw in range(3))


def _gather(t, index, ok):
    """t at the clipped index arrays, zeros where not ok."""
    idx = tuple(np.clip(i, 0, d - 1) for i, d in zip(index, t.shape))
    return np.where(ok, t[idx], 0.0)


def x_box(x3, coords, box):
    """TMA's box of one plane of x viewed (HW, B, C) innermost first: x3
    [C, B, HW] at (position in the image, image, channel) with extents
    (positions, 1, channels): [channels, positions], zeros outside the
    image. The position must be a multiple of 8 (16 bytes), as the card
    demands."""
    x0, b, c0 = coords
    bw, _, bc = box
    assert x0 % 8 == 0
    c, nb, hw = x3.shape
    ch = np.arange(c0, c0 + bc)[:, None]
    q = np.arange(x0, x0 + bw)[None, :]
    ok = (ch < c) & (q >= 0) & (q < hw) & (b < nb)
    return _gather(x3, (ch, b, q), ok)


def dy_box(dy, coords, box):
    """TMA's box of dy viewed (N, C): at (position, channel), extents
    (positions, channels): [channels, positions], zeros out of bounds."""
    x0, c0 = coords
    bw, bc = box
    assert x0 % 8 == 0
    c, n = dy.shape
    ch = np.arange(c0, c0 + bc)[:, None]
    q = np.arange(x0, x0 + bw)[None, :]
    return _gather(dy, (ch, q), (ch < c) & (q >= 0) & (q < n))


def land(smem, dst, vals, swizzle):
    """A box landing at byte dst: dense in box order, each element's byte
    address then swizzled (elements are 2 bytes; the swizzle keeps bits
    0-3)."""
    off = dst + 2 * np.arange(vals.size)
    smem[swizzle_offset(off, swizzle) // 2] = vals.reshape(-1)


def _read(smem, start, rows):
    """A k16 (rows x 16 elements) read through a K-major 128-byte-swizzle
    descriptor at byte ``start`` (rows 128 bytes apart, 8-row groups 1,024
    apart; the start advanced 32 bytes a k16 within the row)."""
    r = np.arange(rows)[:, None]
    kk = np.arange(16)[None, :]
    off = start + r * ROW + kk * 2
    return smem[swizzle_offset(off, 128) // 2]


def shift8(v, s, side):
    """8 elements moved by s columns, ``side`` coming in (the kernel's
    shift8)."""
    if s < 0:
        return np.concatenate([[side], v[:7]])
    if s > 0:
        return np.concatenate([v[1:], [side]])
    return v


def model(x, dy, h, w, plan, table=SAME_TABLE, shift=None):
    """dW [taps * Cin, Cout] as the kernel computes it on ``plan``: x
    [Cin, N] or its planes [P, Cin, N], dy [Cout, N] (N = B * h * w); tap
    t reads plane table[t][0], moved by table[t][1] rows and table[t][2]
    columns. ``shift``: the shifters' funnel shift (default ``shift8``; a
    test hands in a wrong one)."""
    shift = shift or shift8
    x = x[None] if x.ndim == 2 else x
    planes, cin, n = x.shape
    cout = dy.shape[0]
    hw, m, bn = h * w, len(table) * cin, plan.bn
    wide = w >= BK
    x4 = x.reshape(planes, cin, n // hw, hw).astype(np.float64)
    dy64 = dy.astype(np.float64)
    a_bytes, x_off = BM * ROW, BM * ROW + bn * ROW
    cpt = cin // PIECE
    parts = np.zeros((plan.splits, m, cout), np.float32)
    for z in range(plan.splits):
        kt0 = z * plan.per
        nk = min(plan.steps - kt0, plan.per)
        assert nk > 0
        for y in range(plan.m_tiles):
            m0 = y * BM
            live = min(BM, m - m0) // PIECE
            taps = [(m0 // PIECE + q) // cpt for q in range(live)]
            for xt in range(plan.n_tiles):
                n0 = xt * bn
                acc = np.zeros((BM, bn))
                for i in range(nk):
                    smem = np.full((x_off + 4 * XPIECE) // 2, np.nan)
                    pos = (kt0 + i) * BK
                    b = pos // hw
                    at = pos - b * hw - (8 if wide else 0)
                    # the producer warp's boxes
                    for q in range(live):
                        plane, rs, _ = table[taps[q]]
                        ci0 = (m0 // PIECE + q - taps[q] * cpt) * PIECE
                        vals = x_box(x4[plane], (at + rs * w, b, ci0),
                                     (80 if wide else BK, 1, PIECE))
                        land(smem, x_off + q * XPIECE, vals, 16)
                    land(smem, a_bytes, dy_box(dy64, (pos, n0), (BK, bn)),
                         128)
                    # the shifters: staged x -> A, moved by the column shift
                    for row in range(live * PIECE):
                        q, ch = divmod(row, PIECE)
                        sq = table[taps[q]][2]
                        for k8 in range(8):
                            col = (pos + 8 * k8) % w
                            src = x_off + q * XPIECE + (
                                ch * XROW + 16 if wide else ch * ROW) + 16 * k8
                            v = smem[src // 2:src // 2 + 8]
                            side = 0.0
                            if sq < 0 and col > 0:
                                side = smem[(src - 2) // 2]
                            if sq > 0 and col + 8 < w:
                                side = smem[(src + 16) // 2]
                            dst = row * ROW + ((k8 ^ (row & 7)) << 4)
                            smem[dst // 2:dst // 2 + 8] = shift(v, sq, side)
                    # the consumers' k16s
                    for wg in range(2):
                        for kk in range(4):
                            a = _read(smem, wg * 64 * ROW + 32 * kk, 64)
                            bt = _read(smem, a_bytes + 32 * kk, bn)
                            acc[wg * 64:wg * 64 + 64] += a @ bt.T
                # pieces past M are never written: only their rows are NaN
                rows = min(BM, m - m0)
                cols = min(bn, cout - n0)
                assert np.isfinite(acc[:rows]).all()
                parts[z, m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
    out = parts[0].copy()
    for z in range(1, plan.splits):
        out = out + parts[z]
    return out
