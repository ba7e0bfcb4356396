"""A numpy model of the FQT weight gradients on the card
(ops/cuda/csrc/wgrad_wgmma_s8.cuh ``wgrad_s8_kernel``: the lane
transition's on four parity planes, the fused int8 half's on one plane at
the nine stride-1 taps, its scale groups folded in each block or split into
runs whose slots ``slot_sum_kernel`` adds in group order) and of the
quantizer's parity-plane stores (ops/cuda/csrc/transition.cu
``bwd_quant_kernel``, its units of 8 output lanes through ``load_unit``),
for tests/test_torch_transition_wgrad_s8.py,
tests/test_torch_transition_operands.py and
tests/test_torch_fused_wgrad_s8.py.

Per block (n tile, m tile) and K step of 128 positions: the producer's box
of each live 32-channel piece through the flat [4 * Cin, N'] map (144
bytes from the step's start moved by the tap's shift rounded down to 16
bytes, zeros out of bounds), landing dense; the shifter warp of that piece
taking each output unit's 16 bytes at the shift's remainder from two
staged units (the kernel's byte permutes at the shift's word offset),
zeroing the bytes whose source falls off the image (the kernel's mask of
each unit, from the place in the image and the column carried from step
to step as the kernel carries them), storing at the 128-byte swizzle's
place; B's box landing in the 128-byte swizzle; every k32 of both operands
read back through the consumers' K-major descriptors; the s32 tile exact
within a scale group, and at each group's end folded into the f32 tile as
the kernel folds it (int to f32, times the group's scale, added in group
order, each rounded to f32). Numpy only (with ``_tma_layout``'s swizzle).
"""

import numpy as np

from _tma_layout import swizzle_offset

# csrc/wgrad_wgmma_s8.cuh
BM, BK, PIECE, XROW, CONSUMERS = 128, 128, 32, 144, 256
# the fused half's taps: one plane, (dh - 1, dw - 1) in (dh, dw) order
# (csrc/fused_wgrad_s8.cu kTaps)
FUSED_TAPS = tuple((0, dh - 1, dw - 1) for dh in range(3) for dw in range(3))
INV_16129 = np.float32(1.0 / (127.0 * 127.0))   # common::kInv16129


def byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 arrays: byte k of the result is byte
    (s >> 4k) & 7 of the 8 bytes y:x (x the low four)."""
    pool = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(
        x, np.uint64)
    out = np.zeros(np.shape(pool), np.uint64)
    for k in range(4):
        sel = np.uint64((s >> (4 * k)) & 7)
        out |= ((pool >> (np.uint64(8) * sel)) & np.uint64(0xFF)) << (
            np.uint64(8 * k))
    return out.astype(np.uint32)


def bytes_at(lo, hi, off):
    """The kernel's bytes_at on rows of 16-byte units lo, hi ([rows, 16]
    uint8): the 16 bytes at byte ``off`` (0-15) of lo:hi, by a word select
    and four byte permutes."""
    v = np.concatenate([lo, hi], axis=1).view(np.uint32)   # [rows, 8]
    w, sel = off >> 2, 0x3210 + 0x1111 * (off & 3)
    t = v[:, w:w + 5]
    out = np.stack([byte_perm(t[:, i], t[:, i + 1], sel) for i in range(4)],
                   axis=1)
    return np.ascontiguousarray(out).view(np.uint8)


def lead(rs, cs, ow):
    """Where the producer's box starts against the step: the tap's shift
    rs * ow + cs (either sign) rounded down to 16 bytes."""
    return -((ow * -rs - cs + 15) & ~15)


def d_box(flat, x0, row0):
    """TMA's box of d flat [rows, N'] (uint8) at (position x0, row row0):
    [32, 144], zeros out of bounds. x0 must be a multiple of 16 bytes, as
    the card demands."""
    assert x0 % 16 == 0
    n = flat.shape[1]
    q = np.arange(x0, x0 + XROW)
    ok = (q >= 0) & (q < n)
    out = np.zeros((PIECE, XROW), np.uint8)
    out[:, ok] = flat[row0:row0 + PIECE, q[ok]]
    return out


def unit_mask(t, c, rs, cs, ow, ohw):
    """The kernel's mask of one 16-byte unit (first position at place t in
    its image of ohw positions, column c), branch-free as the kernel
    computes it: which of its 16 positions read a source off the image
    (row 0 where rs < 0, the last row where rs > 0, every ow-th byte from
    the first at column 0 where cs < 0, from the first at column ow - 1
    where cs > 0)."""
    colpat = sum(1 << j for j in range(0, 16, ow))
    j0 = 0 if c == 0 else ow - c
    j1 = ow - 1 - c
    tl = ohw - ow - t
    z = ((((0xFFFF if ow - t >= 16 else (1 << (ow - t)) - 1))
          if rs < 0 and t < ow else 0)
         | ((0xFFFF if tl <= 0 else (0xFFFF << tl) & 0xFFFF)
            if rs > 0 and tl < 16 else 0)
         | ((colpat << j0) & 0xFFFF if cs < 0 and j0 < 16 else 0)
         | ((colpat << j1) & 0xFFFF if cs > 0 and j1 < 16 else 0))
    return np.array([(z >> j) & 1 for j in range(16)], bool)


class Shifter:
    """One shifter warp (one piece: 32 rows of one tap) across its block's
    K steps in order, from position p0: the lane of unit k carries the
    place in the image and the column of the unit's first position from
    step to step as the kernel does (starting from p0 + 16 k, moved BK on a
    step, one conditional subtraction). ``masks`` False: the shifter
    without its zeroing (a test's mutation)."""

    def __init__(self, rs, cs, ow, ohw, masks=True, p0=0):
        self.rs, self.cs, self.ow, self.ohw = rs, cs, ow, ohw
        self.off = rs * ow + cs - lead(rs, cs, ow)
        assert 0 <= self.off < 16
        self.t = [(p0 + 16 * k) % ohw for k in range(BK // 16)]
        self.c = [(p0 + 16 * k) % ow for k in range(BK // 16)]
        self.masks = masks

    def step(self, staged):
        """[32, 144] staged bytes -> the piece's [32, 128] A rows."""
        out = np.empty((PIECE, BK), np.uint8)
        for k in range(BK // 16):
            v = bytes_at(staged[:, 16 * k:16 * k + 16],
                         staged[:, 16 * k + 16:16 * k + 32], self.off)
            if self.masks:
                v[:, unit_mask(self.t[k], self.c[k], self.rs, self.cs,
                               self.ow, self.ohw)] = 0
            out[:, 16 * k:16 * k + 16] = v
            self.t[k] += BK % self.ohw
            if self.t[k] >= self.ohw:
                self.t[k] -= self.ohw
            self.c[k] += BK % self.ow
            if self.c[k] >= self.ow:
                self.c[k] -= self.ow
        return out


def a_rows(d, table, oh, ow, masks=True, lead_fn=lead):
    """The A operand as the producer and the shifters build it, every K
    step in order, unswizzled: [taps * Cin, N'] int8 from d [planes, Cin,
    N'] int8 (``lead_fn``: the producer's box start, a test's mutation)."""
    planes, cin, n = d.shape
    flat = np.ascontiguousarray(d).view(np.uint8).reshape(planes * cin, n)
    out = np.empty((len(table) * cin, n), np.uint8)
    for tap, (plane, rs, cs) in enumerate(table):
        for ci0 in range(0, cin, PIECE):
            sh = Shifter(rs, cs, ow, oh * ow, masks)
            row0 = plane * cin + ci0
            for i in range(n // BK):
                out[tap * cin + ci0:tap * cin + ci0 + PIECE,
                    i * BK:(i + 1) * BK] = sh.step(
                        d_box(flat, i * BK + lead_fn(rs, cs, ow), row0))
    return out.view(np.int8)


def _read(smem, start, rows):
    """A k32 (rows x 32 bytes) read through a K-major 128-byte-swizzle
    descriptor at byte ``start`` (rows 128 bytes apart, 8-row groups 1,024
    apart; the start advanced 32 bytes a k32 within the row)."""
    r = np.arange(rows)[:, None]
    off = start + r * BK + np.arange(32)[None, :]
    return smem[swizzle_offset(off, 128)]


def fragment_rc(bn):
    """(row, column) in a (BM, bn) tile of each value of a tile's slot, in
    the kernel's float4 order: float4 j * CONSUMERS + tid holds thread
    tid's values 4 j .. 4 j + 3; value 4 j + 2 h + e is row 64 (tid / 128)
    + 16 ((tid / 32) % 4) + (tid % 32) / 4 + 8 h, column 8 j + 2 (tid % 4)
    + e. Two [bn / 8 * CONSUMERS * 4] arrays."""
    j, tid, v = np.meshgrid(np.arange(bn // 8), np.arange(CONSUMERS),
                            np.arange(4), indexing="ij")
    lane = tid % 32
    rows = (64 * (tid // 128) + 16 * ((tid // 32) % 4) + lane // 4
            + 8 * (v // 2))
    cols = 8 * j + 2 * (lane % 4) + v % 2
    return rows.reshape(-1), cols.reshape(-1)


def slot_sum(slots, m, cout, bn, n_tiles):
    """slot_sum_kernel: dW [m, Cout] f32 from slots [groups][tiles][BM *
    bn] f32 (each tile in fragment order), added in group order, written
    where each value lies inside dW."""
    out = slots[0].copy()
    for g in range(1, slots.shape[0]):
        out = out + slots[g]
    rows, cols = fragment_rc(bn)
    dw = np.zeros((m, cout), np.float32)
    for tile in range(slots.shape[1]):
        r = (tile // n_tiles) * BM + rows
        c = (tile % n_tiles) * bn + cols
        keep = (r < m) & (c < cout)
        dw[r[keep], c[keep]] = out[tile][keep]
    return dw


def _block(flat, gb, pieces, n0, bn, cout, s0, s1, spg, g_amax, d_amax,
           oh, ow, rng):
    """One block's K steps [s0, s1) of its (BM, bn) tile: yields each scale
    group's f32 contribution (the s32 tile to f32, times the group's
    scale) at the group's end, as the consumers fold it."""
    shifters = [Shifter(rs, cs, ow, oh * ow, p0=s0 * BK)
                for _, _, (rs, cs) in pieces]
    acc = np.zeros((BM, bn), np.int64)
    for i in range(s0, s1):
        # rows past dW's are never written: garbage there
        a_smem = rng.integers(0, 256, BM * BK).astype(np.uint8)
        for q, ((row0, ld, _), sh) in enumerate(zip(pieces, shifters)):
            rows = sh.step(d_box(flat, i * BK + ld, row0))
            r = q * PIECE + np.arange(PIECE)[:, None]
            k = np.arange(BK)[None, :]
            a_smem[r * BK + (((k // 16) ^ (r & 7)) << 4) + k % 16] = rows
        box = np.zeros((bn, BK), np.uint8)
        hi = min(bn, cout - n0)
        box[:hi] = gb[n0:n0 + hi, i * BK:(i + 1) * BK]
        b_smem = np.empty(bn * BK, np.uint8)
        b_smem[swizzle_offset(np.arange(bn * BK), 128)] = box.reshape(-1)
        if i % spg == 0:
            acc[:] = 0
        for wg in range(2):
            for kk in range(BK // 32):
                a = _read(a_smem, wg * 64 * BK + 32 * kk, 64)
                bt = _read(b_smem, 32 * kk, bn)
                acc[wg * 64:wg * 64 + 64] += (
                    a.view(np.int8).astype(np.int64)
                    @ bt.view(np.int8).astype(np.int64).T)
        if (i + 1) % spg == 0:
            grp = i // spg
            ts = np.float32(np.float32(d_amax[grp] * g_amax[grp])
                            * INV_16129)
            yield grp, acc.astype(np.float32) * ts


def model(d, g, g_amax, d_amax, tile, oh, ow, plan, table):
    """dW [taps * Cin, Cout] f32 as the kernel computes it on ``plan``
    (``transition.wgrad_s8_plan``, or ``fused_block.fused_wgrad_s8_plan``,
    whose ``gpb`` may split the scale groups into runs: then each run's
    block writes every group's contribution to the group's slot, in
    fragment order, and ``slot_sum`` adds them): d [planes, Cin, N'] and g
    [Cout, N'] int8, g_amax and d_amax [N' / tile] f32."""
    planes, cin, n = d.shape
    cout = g.shape[0]
    m, bn, spg = len(table) * cin, plan.bn, tile // BK
    assert plan.spg == spg and plan.steps * BK == n
    groups = n // tile
    gpb = getattr(plan, "gpb", groups)
    flat = np.ascontiguousarray(d).view(np.uint8).reshape(planes * cin, n)
    gb = np.ascontiguousarray(g).view(np.uint8)
    rng = np.random.default_rng(0)
    dw = np.zeros((m, cout), np.float32)
    slots = np.zeros((groups, plan.m_tiles * plan.n_tiles, BM * bn),
                     np.float32)
    frows, fcols = fragment_rc(bn)
    for y in range(plan.m_tiles):
        m0 = y * BM
        live = min(BM, m - m0) // PIECE
        pieces = []
        for q in range(live):
            tap, ci0 = divmod(m0 + q * PIECE, cin)
            plane, rs, cs = table[tap]
            pieces.append((plane * cin + ci0, lead(rs, cs, ow), (rs, cs)))
        for x in range(plan.n_tiles):
            n0 = x * bn
            out = np.zeros((BM, bn), np.float32)
            for g0 in range(0, groups, gpb):   # a block each
                for grp, c in _block(flat, gb, pieces, n0, bn, cout,
                                     g0 * spg,
                                     min(groups, g0 + gpb) * spg, spg,
                                     g_amax, d_amax, oh, ow, rng):
                    if gpb < groups:
                        slots[grp, y * plan.n_tiles + x] = c[frows, fcols]
                    else:
                        out = c if grp == 0 else out + c
            hi, wd = min(BM, m - m0), min(bn, cout - n0)
            dw[m0:m0 + hi, n0:n0 + wd] = out[:hi, :wd]
    if gpb < groups:
        return slot_sum(slots, m, cout, bn, plan.n_tiles)
    return dw


def in_pos(q, ph, h, w):
    """csrc/transition.cu ``in_pos``: output lane q's input lane at row
    parity ph, column parity 0."""
    ow, ohw = w // 2, (h // 2) * (w // 2)
    img, rem = q // ohw, q % ohw
    r = rem // ow
    return img * h * w + (2 * r + ph) * w + 2 * (rem - r * ow)


def unit_pair_lanes(h, w, ph, q0, rows):
    """csrc/transition.cu ``load_unit``: the input lane of the first pixel
    of each unit's 8 pairs [units, 8] (unit: output lanes q0 .. q0 + 7 at
    row parity ph). ``rows`` (output rows of ow % 8 == 0 pixels): the
    unit's 16 consecutive pixels from in_pos(q0), which starts on 16 (the
    16-byte loads); else each lane from its own (image, row, column),
    stepped lane by lane as the kernel steps them."""
    oh, ow = h // 2, w // 2
    q0 = np.asarray(q0)
    ph = np.broadcast_to(ph, q0.shape)
    if rows:
        base = in_pos(q0, ph, h, w)
        assert ow % 8 == 0 and (base % 16 == 0).all()
        return base[:, None] + 2 * np.arange(8)[None, :]
    at = np.empty((len(q0), 8), dtype=np.int64)
    img = q0 // (oh * ow)
    rem = q0 - img * oh * ow
    r, c = rem // ow, rem % ow
    for k in range(8):
        at[:, k] = img * h * w + (2 * r + ph) * w + 2 * c
        c = c + 1
        wrap = c == ow
        c[wrap] = 0
        r = r + wrap
        wrap = r == oh
        r[wrap] = 0
        img = img + wrap
    return at


def plane_store(q, h, w, rows=False):
    """The operand passes' parity-plane stores (csrc/transition.cu
    ``bwd_quant_kernel``'s, each lane loading its own pair, and
    ``bwd_fold_kernel``'s, also with the 16-byte row loads: ``rows``),
    here of the lane-layout codes q [Cin, N] int8 (images of h x w, h and
    w even): each unit of 8 output lanes q0 .. of a channel at row parity
    ph takes its lanes' input pairs (``unit_pair_lanes``), the first
    pixels' codes into plane 2 ph and the second's into 2 ph + 1 at the
    unit's lanes; d_q [4, Cin, N / 4]."""
    cin, n = q.shape
    n_out = n // 4
    q0 = np.arange(0, n_out, 8)
    lanes = q0[:, None] + np.arange(8)[None, :]
    out = np.zeros((4, cin, n_out), np.int8)
    for ph in (0, 1):
        at = unit_pair_lanes(h, w, ph, q0, rows)
        out[2 * ph][:, lanes] = q[:, at]
        out[2 * ph + 1][:, lanes] = q[:, at + 1]
    return out