"""The identity NV block's route on the card (ops/cuda/bneck_nv.py
``serve_slab_layout``, ``identity_plan``, ``bneck_block_nv``; kernels in
csrc/bneck_nv.cu, namespace ``bneck_wgmma``), on the CPU:

- the slab's geometry is ``bneck_nv_train.fwd_int8_layout(n, h, w, W, 9,
  h)``'s, and its shifts read every tap of every M row inside the slab, at
  the neighbour the tap names or at a zero pad;
- a numpy emulation of conv1 (128-row tiles of NHWC rows, N tiles of 64
  or 128 channels, K boxes of 128, 64 and 32 bytes in the mainloop's
  order, rows past M read as zeros; each row's vectors at its slab row and
  the pads attached to its position) writes every slab byte exactly once
  and builds, over a slab of nonzero bytes, the slab that
  ``bneck_nv_train._place``'s rule places;
- an emulation of conv2's walk (the slab's 128-row tiles, the nine shifted
  A boxes, the K boxes at ``step_at``'s order, ``y_pos``'s row map) gives
  the requant of the float64 conv that ``bneck_block_nv_plain`` computes,
  and catches a wrong tap, a wrong shift and a pad left unwritten;
- the emulated block (conv1's slab, conv2's walk, the output epilogue)
  equals ``bneck_block_nv_plain`` in int8 and bf16, and JAX's
  ``bneck_block_nv`` run in interpret mode;
- the plan (N tiles, grids, the slab's size, every box inside its map,
  the epilogues' room in the ring) holds at every identity geometry the
  NV gate admits for ResNet-50 and WRN-50-2.

Inputs are made with numpy from a seed. Tolerance: none (exact s32 sums,
the plain version's rounding points).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv as tnv
from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv_train as nvt
from pytorch_ddp_resnet_tpu_torch.ops.cuda.conv3x3 import fma_f32, quant_s8
from pytorch_ddp_resnet_tpu_torch.ops.cuda.nv_common import requant
from test_torch_bneck_nv import _jax, _port_weights, _rand_ops, _rand_x
from test_torch_nv_wgrad_staged import MODELS

BM = 128            # M rows a tile (csrc/fwd_wgmma_s8.cuh BM)
BK = 128            # bytes of the widest K box (BK)
THREADS = 256       # the block (THREADS)
RING_BUDGET = 232448 // 2 - 1024   # wgrad_staged.cuh SMEM_PER_BLOCK

# (n, h, w, Cin, W): h != w, N of 2, 3 and 5, W of 32, 64 and 96, Cin of
# 64 and 96; a one-row and a one-column plane (a position that is both
# borders)
CASES = [(2, 4, 5, 64, 32), (3, 5, 3, 96, 64), (5, 3, 4, 64, 96),
         (3, 1, 6, 96, 32), (2, 6, 1, 64, 64)]


def _boxes(k):
    """One tap's K boxes (byte offset, width) in fwd_wgmma_s8.cuh
    ``step_at``'s order: 128-byte boxes, then one of 64 where k % 128 &
    64, then one of 32 where k % 128 & 32."""
    rem = k % BK
    out = [(o, BK) for o in range(0, k - rem, BK)]
    if rem & 64:
        out.append((k - rem, 64))
    if rem & 32:
        out.append((k - rem + (64 if rem & 64 else 0), 32))
    return out


def _box(t, r0, rows, c0, wd, inside):
    """A TMA box of t [rows, cols]: rows past the end read as zeros
    (``inside``: none may)."""
    out = np.zeros((rows, wd), np.int64)
    r1 = min(r0 + rows, t.shape[0])
    assert 0 <= r0 and c0 % 16 == 0
    if inside:
        assert r1 == r0 + rows, (r0, rows, t.shape)
    out[:r1 - r0] = t[r0:r1, c0:c0 + wd]
    return out


def _walk(a_map, b, k, m0, n0, bn, shifts, inside=False):
    """The mainloop of one block: acc [BM, bn] over the walk's taps (A rows
    from m0 + shifts[t], B columns t * k + o) and each tap's K boxes, in
    integers; B rows past its end read as zeros."""
    acc = np.zeros((BM, bn), np.int64)
    for t, sh in enumerate(shifts):
        for o, wd in _boxes(k):
            a = _box(a_map, m0 + sh, BM, o, wd, inside)
            bb = _box(b, n0, bn, t * k + o, wd, False)
            acc += a @ bb.T
    assert np.abs(acc).max() < 2 ** 31   # an s32 accumulator
    return acc


def _row(lay, y, x, i):
    """Slab row of position (y, x) of image i (y, x may name the halo rows
    -1 and h, and the pad column w)."""
    return lay.guard + ((y + 1) * lay.wq + x) * lay.n + i


def _end(lay):
    """First row of the back guard and tail."""
    return lay.guard + (lay.h + 2) * lay.wq * lay.n


def _requant(acc, p, q):
    return requant(torch.from_numpy(acc), p, q).numpy()


def _blocks(m_tiles, c, bn):
    """The one-dimensional grid: (n0, m0) of block i, the N tiles of one M
    tile neighbours."""
    nt = -(-c // bn)
    return [((i % nt) * bn, (i // nt) * BM) for i in range(nt * m_tiles)]


def _emulate_conv1(x, w1, p1, q1, lay, fill=90, skip=()):
    """conv1 on the card: a1's tiles written to their slab rows and every
    pad attached to a position written zero, over a slab of ``fill``
    bytes. Returns (slab, count of writes to each byte). ``skip`` leaves
    out pads by name (a mutation)."""
    n, h, w, cin = x.shape
    wdt = w1.shape[0]
    bn = tnv.serve_tile(wdt)
    xm = x.reshape(-1, cin).astype(np.int64)
    m_rows = n * h * w
    slab = np.full((lay.slab_len, wdt), fill, np.int8)
    count = np.zeros(slab.shape, np.int32)
    up = lay.wq * n
    for n0, m0 in _blocks(-(-m_rows // BM), wdt, bn):
        acc = _walk(xm, w1.numpy(), cin, m0, n0, bn, (0,))
        cols = min(bn, wdt - n0)
        a1 = _requant(acc[:, :cols], p1[n0:n0 + cols], q1[n0:n0 + cols])
        cs = slice(n0, n0 + cols)   # the block's 16-byte vectors

        def put(row, val):
            slab[row, cs] = val
            count[row, cs] += 1

        for r in range(BM):
            m = m0 + r
            if m >= m_rows:
                continue
            i, rem = divmod(m, h * w)
            y, xx = divmod(rem, w)
            row = _row(lay, y, xx, i)
            put(row, a1[r])
            right = xx == w - 1 and "right" not in skip
            if right:
                put(row + n, 0)
            if y == 0 and "top" not in skip:
                put(row - up, 0)
                if right:
                    put(row - up + n, 0)
            if y == h - 1 and "bottom" not in skip:
                put(row + up, 0)
                if right:
                    put(row + up + n, 0)
            if y == 0 and xx == 0 and "front" not in skip:
                put(row - up - lay.guard, 0)
            if y == h - 1 and xx == w - 1 and "back" not in skip:
                for j in range((row - lay.guard) % n,
                               lay.slab_len - _end(lay), n):
                    put(_end(lay) + j, 0)
    return slab, count


def _nhwc_row(lay, m):
    """y_pos's rule: the NHWC row of the slab's M row m, or -1."""
    site, i = divmod(m, lay.n)
    r, c = divmod(site, lay.wq)
    return (i * lay.h + r) * lay.w + c if r < lay.h and c < lay.w else -1


def _emulate_conv2(slab, w2, p2, q2, lay, shifts=None):
    """conv2 on the card: the slab's M tiles, the nine shifted A boxes
    (every row inside the slab), the requantized tile's live rows to a2
    [n, h, w, W]."""
    shifts = lay.shifts if shifts is None else shifts
    wdt = lay.cp
    bn = tnv.serve_tile(wdt)
    a2 = np.zeros((lay.n * lay.h * lay.w, wdt), np.int8)
    count = np.zeros(a2.shape, np.int32)
    for n0, m0 in _blocks(lay.tiles, wdt, bn):
        acc = _walk(slab.astype(np.int64), w2.numpy(), wdt, m0, n0, bn,
                    shifts, inside=True)
        cols = min(bn, wdt - n0)
        a = _requant(acc[:, :cols], p2[n0:n0 + cols], q2[n0:n0 + cols])
        for r in range(BM):
            pos = _nhwc_row(lay, m0 + r)
            if pos >= 0:
                a2[pos, n0:n0 + cols] = a[r]
                count[pos, n0:n0 + cols] += 1
    assert (count == 1).all()
    return a2.reshape(lay.n, lay.h, lay.w, wdt)


def _emulate_out(a2, w3, p3, q3, x, r, out_int8):
    """The output launch on the card: the one-tap walk over a2's rows,
    y = fma(f32(acc), p3, q3) staged, then each 16-channel vector of a row
    relu(fma(f32(x), r, y)) as int8 or bf16."""
    n, h, w, wdt = a2.shape
    cout = w3.shape[0]
    bn = tnv.serve_tile(cout)
    m_rows = n * h * w
    am = a2.reshape(-1, wdt).astype(np.int64)
    xf = torch.from_numpy(x.reshape(-1, cout)).to(torch.float32)
    out = torch.zeros((m_rows, cout),
                      dtype=torch.int8 if out_int8 else torch.bfloat16)
    for n0, m0 in _blocks(-(-m_rows // BM), cout, bn):
        acc = _walk(am, w3.numpy(), wdt, m0, n0, bn, (0,))
        cols = min(bn, cout - n0)
        rows = min(BM, m_rows - m0)
        cs = slice(n0, n0 + cols)
        y = fma_f32(torch.from_numpy(acc[:rows, :cols]).to(torch.float32),
                    p3[cs], q3[cs])
        o = torch.clamp_min(fma_f32(xf[m0:m0 + rows, cs], r, y), 0.0)
        out[m0:m0 + rows, cs] = quant_s8(o) if out_int8 else o.to(
            torch.bfloat16)
    return out.reshape(n, h, w, cout)


def _operands(seed, n, h, w, cin, wdt):
    """x [n, h, w, Cin] int8 (numpy), the port's weights and the folded
    vectors (requants across the whole int8 range), r."""
    rng = np.random.default_rng(seed)
    ops = _rand_ops(rng, cin, wdt, cin, proj=False)
    x = _rand_x(rng, h, w, cin, n=n)
    vec = [torch.from_numpy(v) for v in ops["vec"]]
    return x, _port_weights(ops), vec, ops["res"], ops


def _a2_plain(a1, w2, p2, q2):
    """conv2 as ``bneck_block_nv_plain`` computes it: the float64 conv of
    a1, requantized."""
    wdt = a1.shape[-1]
    k = w2.to(torch.float64).reshape(wdt, 3, 3, wdt).permute(0, 3, 1, 2)
    acc = F.conv2d(torch.from_numpy(a1).to(torch.float64).permute(
        0, 3, 1, 2), k, padding=1).permute(0, 2, 3, 1)
    return requant(acc, p2, q2).numpy()


@pytest.mark.parametrize("n,h,w,cin,wdt", CASES)
def test_slab_layout_is_the_nv_geometry(n, h, w, cin, wdt):
    lay = tnv.serve_slab_layout(n, h, w, wdt)
    ref = nvt.fwd_int8_layout(n, h, w, wdt, 9, h)
    for key in ("wq", "guard", "m_valid", "tiles", "slab_len", "shifts",
                "bm"):
        assert getattr(lay, key) == getattr(ref, key), key
    assert lay.cin == lay.cp == wdt and (ref.cp == wdt) == (wdt % 64 == 0)
    # every tap of every M row reads inside the slab: the neighbour the
    # tap names, or a pad position (its column w, a halo row)
    assert min(lay.shifts) == 0
    assert max(lay.shifts) + lay.tiles * BM == lay.slab_len
    for m in range(lay.tiles * BM):
        site, i = divmod(m, n)
        r, c = divmod(site, lay.wq)
        for t, sh in enumerate(lay.shifts):
            dy, dx = divmod(t, 3)
            assert 0 <= m + sh < lay.slab_len
            if r < h and c < w:
                assert m + sh == _row(lay, r + dy - 1, c + dx - 1, i)


@pytest.mark.parametrize("n,h,w,cin,wdt", CASES)
def test_conv1_writes_every_slab_byte_once(n, h, w, cin, wdt):
    x, (w1, _, _), vec, _, _ = _operands(n + h + wdt, n, h, w, cin, wdt)
    lay = tnv.serve_slab_layout(n, h, w, wdt)
    slab, count = _emulate_conv1(x, w1, vec[0], vec[1], lay)
    assert (count == 1).all()   # the pads written, not inherited
    # bneck_nv_train._place's rule: each image row at its chunk position,
    # zero halo rows, pad column, guards and tail
    xt = torch.from_numpy(x)
    a1 = requant(xt.to(torch.float64) @ w1.to(torch.float64).T, vec[0],
                 vec[1])
    assert len(np.unique(a1.numpy())) > 20
    ref_lay = nvt.fwd_int8_layout(n, h, w, wdt, 9, h)
    placed = nvt._place(F.pad(a1, (0, 0, 0, 0, 1, 1))[None], ref_lay)[0]
    assert not placed[:, wdt:].any()
    np.testing.assert_array_equal(slab, placed[:, :wdt].numpy())
    np.testing.assert_array_equal(slab, tnv.serve_slab_plain(a1, lay).numpy())
    np.testing.assert_array_equal(
        slab, tnv.identity_slab_plain(xt, w1, vec[0], vec[1], lay).numpy())


@pytest.mark.parametrize("n,h,w,cin,wdt", CASES)
def test_conv2_walk_equals_plain_conv(n, h, w, cin, wdt):
    x, (w1, w2, _), vec, _, _ = _operands(2 * n + w, n, h, w, cin, wdt)
    lay = tnv.serve_slab_layout(n, h, w, wdt)
    slab, _ = _emulate_conv1(x, w1, vec[0], vec[1], lay)
    a1 = requant(torch.from_numpy(x).to(torch.float64)
                 @ w1.to(torch.float64).T, vec[0], vec[1]).numpy()
    want = _a2_plain(a1, w2, vec[2], vec[3])
    assert len(np.unique(want)) > 20
    np.testing.assert_array_equal(
        _emulate_conv2(slab, w2, vec[2], vec[3], lay), want)


def test_emulation_catches_a_wrong_tap_shift_or_pad():
    """The emulation is sharp: the taps mirrored, one tap a column off, or
    a pad that conv1 leaves unwritten (the slab's old bytes read as a1)
    change a2."""
    n, h, w, cin, wdt = 3, 5, 4, 64, 64
    x, (w1, w2, _), vec, _, _ = _operands(7, n, h, w, cin, wdt)
    lay = tnv.serve_slab_layout(n, h, w, wdt)
    slab, _ = _emulate_conv1(x, w1, vec[0], vec[1], lay)
    want = _emulate_conv2(slab, w2, vec[2], vec[3], lay)
    mirrored = lay.shifts[::-1]
    assert not np.array_equal(
        _emulate_conv2(slab, w2, vec[2], vec[3], lay, mirrored), want)
    off = list(lay.shifts)
    off[5] += n   # tap (1, 2) reads two columns right
    assert not np.array_equal(
        _emulate_conv2(slab, w2, vec[2], vec[3], lay, tuple(off)), want)
    for pad in ("right", "top", "bottom"):
        stale, count = _emulate_conv1(x, w1, vec[0], vec[1], lay,
                                      skip=(pad,))
        assert (count == 0).any()
        assert not np.array_equal(
            _emulate_conv2(stale, w2, vec[2], vec[3], lay), want), pad


@pytest.mark.parametrize("n,h,w,cin,wdt", CASES)
@pytest.mark.parametrize("out_int8", [True, False])
def test_emulated_block_equals_plain(n, h, w, cin, wdt, out_int8):
    x, (w1, w2, w3), vec, r, _ = _operands(3 * n + h + cin, n, h, w, cin,
                                           wdt)
    lay = tnv.serve_slab_layout(n, h, w, wdt)
    slab, _ = _emulate_conv1(x, w1, vec[0], vec[1], lay)
    a2 = _emulate_conv2(slab, w2, vec[2], vec[3], lay)
    got = _emulate_out(a2, w3, vec[4], vec[5], x, r, out_int8)
    want = tnv.bneck_block_nv_plain(torch.from_numpy(x), w1, w2, w3, *vec,
                                    r, out_int8=out_int8)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert want.unique().numel() > 20
    assert torch.equal(got, want)


def test_emulated_block_equals_jax():
    """conv1's slab -> conv2's walk -> the output epilogue, against JAX's
    ``bneck_block_nv`` in interpret mode on its NV carrier (``to_nv``,
    ``from_nv``): int8 and bf16 outputs equal."""
    n, h, w, cin, wdt = 32, 5, 4, 64, 32   # the JAX kernel's batch rule
    x, (w1, w2, w3), vec, r, ops = _operands(11, n, h, w, cin, wdt)
    lay = tnv.serve_slab_layout(n, h, w, wdt)
    slab, count = _emulate_conv1(x, w1, vec[0], vec[1], lay)
    assert (count == 1).all()
    a2 = _emulate_conv2(slab, w2, vec[2], vec[3], lay)
    for out_int8 in (True, False):
        got = _emulate_out(a2, w3, vec[4], vec[5], x, r, out_int8)
        want = _jax(x, ops, out_int8=out_int8)
        assert len(np.unique(want)) > 50
        np.testing.assert_array_equal(got.float().numpy(), want)


def _ring(bn):
    """fwd_wgmma_s8.cuh Tile<bn>::RING: the ring's bytes at two blocks an
    SM."""
    stage = (BM + bn) * BK
    return (RING_BUDGET - 1024 - 128) // stage * stage


@pytest.mark.parametrize("model", sorted(MODELS))
def test_plan_holds_at_every_gate_geometry(model):
    """Every identity block of the model at every batch the NV gate admits
    (a power of two and a multiple of 32) up to 512."""
    seen = 0
    for h, cin, wdt, cout in MODELS[model]:
        for n in (32, 64, 128, 256, 512):
            plan = tnv.identity_plan(n, h, h, cin, wdt, cout)
            lay = plan.lay
            assert lay == tnv.serve_slab_layout(n, h, h, wdt)
            m = n * h * h
            assert plan.m == m
            # the N tiles: 64 at W = 64, else 128; conv3's 128
            assert (plan.bn1, plan.bn2) == ((64, 64) if wdt == 64
                                            else (128, 128))
            assert plan.bn3 == 128
            mt = -(-m // BM)
            assert plan.blocks == (mt * -(-wdt // plan.bn1),
                                   lay.tiles * -(-wdt // plan.bn2),
                                   mt * -(-cout // plan.bn3))
            assert max(plan.blocks) <= 65535, (model, h, n, plan.blocks)
            assert lay.slab_len * wdt < 2 ** 31
            # every box inside its map: conv2's nine shifted boxes of
            # every tile inside the slab; conv1's and the output's boxes
            # start inside x and a2 (rows past M read as zeros)
            assert min(lay.shifts) >= 0
            assert max(lay.shifts) + lay.tiles * BM <= lay.slab_len
            assert (mt - 1) * BM < m
            for k, taps in ((cin, 1), (wdt, 9), (wdt, 1)):
                boxes = _boxes(k)
                assert sum(wd for _, wd in boxes) == k
                assert all((t * k + o) % 16 == 0 for t in range(taps)
                           for o, _ in boxes)
            # the epilogues' room in the drained ring, their threads
            for bn in {plan.bn1, plan.bn2}:
                assert BM * (bn + 16) + 2 * bn * 4 + 2 * BM * 4 <= _ring(bn)
            bn = plan.bn3
            assert BM * (bn + bn // 4 + 8) * 4 + 2 * bn * 4 <= _ring(bn)
            vpr = bn // 16
            assert THREADS % vpr == 0 and BM % (THREADS // vpr) == 0
            assert cout % 16 == 0 and wdt % 16 == 0
            seen += 1
    assert seen == 20


def test_plan_refuses_32_bit_overflow():
    with pytest.raises(ValueError, match="32-bit"):
        tnv.identity_plan(2 ** 20, 56, 56, 256, 64, 256)


def test_profile_kinds_count_the_new_kernels_as_the_nv_blocks():
    """chip_smoke.py's kernel kinds by demangled name: the identity block's
    three wgmma kernels and the transition's output kernel are the NV
    blocks'."""
    import chip_smoke

    for name in (
            "void bneck_wgmma::conv1_kernel<64, 0>(fwd_wgmma_s8::Maps, "
            "bneck_wgmma::Conv1Args)",
            "void bneck_wgmma::conv2_kernel<128, 0>(fwd_wgmma_s8::Maps, "
            "bneck_wgmma::Conv2Args)",
            "void bneck_wgmma::out_kernel<128, 64>(fwd_wgmma_s8::Maps, "
            "bneck_wgmma::OutArgs)",
            "void bneck_wgmma::out_proj_kernel<64, 0, 0>(fwd_wgmma_s8::Maps, "
            "fwd_wgmma_s8::Maps, bneck_wgmma::OutProjArgs)"):
        assert chip_smoke.kernel_kind(name) == "bneck nv (port)", name
    assert set(chip_smoke.NV_ID_PARTS) == {"conv1", "conv2", "out"}


@pytest.mark.parametrize("h,w,cin,wdt,cout", [
    (56, 56, 256, 64, 256), (28, 28, 512, 128, 512),
    (14, 14, 1024, 256, 1024), (7, 7, 2048, 512, 2048),
    (7, 7, 2048, 1024, 2048)])
def test_part_bounds_count_a1_codes_not_slab_pads(h, w, cin, wdt, cout,
                                                  monkeypatch):
    """chip_smoke.py's part bounds of the identity block count a1 as its
    n*h*w*W codes (conv1's write, conv2's read), not the slab's pad column,
    halo rows, guards and tail; a part the profiler missed is None."""
    import chip_smoke

    n, ops, bw = chip_smoke.BATCH, 1.979e15, 3.35e12
    plan = tnv.identity_plan(n, h, w, cin, wdt, cout)
    m = n * h * w
    assert plan.lay.codes == m * wdt < plan.lay.slab_len * wdt
    monkeypatch.setattr(chip_smoke, "kernel_split_ms",
                        lambda *a, **k: None)
    got = chip_smoke.nv_identity_parts(None, plan, cin, wdt, cout, True,
                                       ops, bw)
    vecs = 8 * wdt
    assert got["conv1_bound_ms"] == pytest.approx(
        (m * cin + m * wdt + wdt * cin + vecs) / bw * 1e3, rel=1e-12)
    c2_ops = 2 * m * 9 * wdt * wdt / ops * 1e3
    c2_bytes = (2 * m * wdt + 9 * wdt * wdt + vecs) / bw * 1e3
    assert got["conv2_bound_ms"] == pytest.approx(max(c2_ops, c2_bytes),
                                                  rel=1e-12)
    assert got["dev_ms"] is None and got["conv1_dev_ms"] is None


def test_summed_times_stay_none_where_a_shape_was_not_measured():
    """A per-batch or per-step sum over shapes is None where one shape's
    time is (the profiler saw none), never a sum that counts it as 0."""
    import chip_smoke

    tot = dict(ms=0.0, dev_ms=0.0)
    chip_smoke.add_scaled(tot, dict(ms=1.0, dev_ms=2.0), 3)
    assert tot == dict(ms=3.0, dev_ms=6.0)
    chip_smoke.add_scaled(tot, dict(ms=1.0, dev_ms=None), 2)
    assert tot == dict(ms=5.0, dev_ms=None)
    chip_smoke.add_scaled(tot, dict(ms=1.0, dev_ms=4.0), 1)
    assert tot == dict(ms=6.0, dev_ms=None)
