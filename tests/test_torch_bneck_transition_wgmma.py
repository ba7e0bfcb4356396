"""The transition NV block's route on the card (ops/cuda/bneck_nv.py
``transition_plan``, ``bneck_transition_nv``; kernels in csrc/bneck_nv.cu,
namespace ``bneck_wgmma``), on the CPU:

- at stride 2 a1's slab is four parity planes, each of
  ``serve_slab_layout(n, oh, ow, W)``'s geometry, and the plan's nine
  shifts read every tap of every M row inside the planes, at the input
  position the tap names or at a pad;
- a numpy emulation of conv1 at stride 2 (``conv1_planes_kernel``: the
  identity's tiles and K boxes, each row's vectors to its plane, the pads
  attached to its plane position, the positions past an odd h or w
  written zero by the position beside them; x's even-even rows copied to
  xs, each N tile its share) writes every byte of the planes and of xs
  exactly once, builds over nonzero bytes the planes that
  ``block_slab_plain`` places, and xs = x[:, ::2, ::2];
- an emulation of conv2's walk over the planes (the identity's walk at
  the plan's shifts) gives the requant of the float64 stride-2 conv that
  ``bneck_transition_nv_plain`` computes, and catches a wrong plane, tap
  or shift and a pad left unwritten;
- the emulated block (conv1, conv2, the output's two mainloops at BN =
  64) equals ``bneck_transition_nv_plain`` at both strides in int8 and
  bf16, and JAX's ``bneck_transition_nv`` run in interpret mode;
- the plan (N tiles, grids, the planes' size, every box inside its map,
  the epilogues' room in the ring) holds at every transition geometry the
  NV gate admits for ResNet-50 and WRN-50-2, and refuses 32-bit overflow.

Inputs are made with numpy from a seed. Tolerance: none (exact s32 sums,
the plain version's rounding points).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv as tnv
from pytorch_ddp_resnet_tpu_torch.ops.cuda.conv3x3 import fma_f32, quant_s8
from pytorch_ddp_resnet_tpu_torch.ops.cuda.nv_common import requant
from test_torch_bneck_nv import _jax, _port_weights, _rand_ops, _rand_x
from test_torch_bneck_nv_wgmma import (
    BK,
    BM,
    THREADS,
    _blocks,
    _boxes,
    _emulate_conv1,
    _emulate_conv2,
    _end,
    _requant,
    _ring,
    _row,
    _walk,
)

f32, f64 = torch.float32, torch.float64

# (n, h, w, Cin, W, Cout, stride): h != w, odd h and odd w at stride 2, N
# of 2, 3 and 5, W of 32, 64 and 96, Cin != Cout; a one-row image at
# stride 2 (one plane row, its odd planes all past the image)
CASES = [(2, 5, 7, 64, 32, 128, 2), (3, 6, 5, 96, 64, 64, 2),
         (5, 4, 6, 32, 96, 64, 2), (3, 7, 7, 64, 32, 96, 2),
         (5, 1, 7, 64, 32, 64, 2), (2, 6, 5, 32, 64, 96, 1),
         (3, 4, 6, 96, 32, 64, 1)]
S2 = [c for c in CASES if c[-1] == 2]

# (h, Cin, W, Cout, stride) of every transition block: ResNet-50 and
# WRN-50-2 (the NV gate admits each at every batch it admits)
TRANSITIONS = {
    "resnet-50": [(56, 64, 64, 256, 1), (56, 256, 128, 512, 2),
                  (28, 512, 256, 1024, 2), (14, 1024, 512, 2048, 2)],
    "wrn-50-2": [(56, 64, 128, 256, 1), (56, 256, 256, 512, 2),
                 (28, 512, 512, 1024, 2), (14, 1024, 1024, 2048, 2)],
}


def _operands(seed, n, h, w, cin, wdt, cout):
    """x [n, h, w, Cin] int8 (numpy), the port's four weights, the folded
    vectors (requants across the whole int8 range) and pp, and the JAX
    operands."""
    rng = np.random.default_rng(seed)
    ops = _rand_ops(rng, cin, wdt, cout, proj=True)
    x = _rand_x(rng, h, w, cin, n=n)
    vec = [torch.from_numpy(v) for v in ops["vec"]]
    return x, _port_weights(ops), vec, torch.from_numpy(ops["res"]), ops


def _pads(put, lay, row, y, x, skip=()):
    """The pads attached to position (y, x) of a slab of layout ``lay``
    (its row ``row`` from the slab's first row), written zero by ``put``:
    csrc/bneck_nv.cu pad_flags and put_pads."""
    n, h, w = lay.n, lay.h, lay.w
    up = lay.wq * n
    right = x == w - 1 and "right" not in skip
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
    if y == 0 and x == 0 and "front" not in skip:
        put(row - up - lay.guard, 0)
    if y == h - 1 and x == w - 1 and "back" not in skip:
        for j in range((row - lay.guard) % n, lay.slab_len - _end(lay), n):
            put(_end(lay) + j, 0)


def _emulate_conv1_planes(x, w1, p1, q1, plan, fill=90, skip=()):
    """conv1 at stride 2 on the card: a1's tiles to their planes, every pad
    attached to a plane position written zero, the positions past an odd h
    or w (plane + 1 beside, plane + 2 below, plane + 3 both) written zero
    with their pads by the position of the same plane position; x's
    even-even rows copied to xs, N tile j its share [j*per, (j+1)*per) of
    each row's Cin/16 vectors. Over planes and an xs of ``fill`` bytes.
    Returns (planes, count of writes to each byte, xs, xs's count).
    ``skip`` leaves out pads by name, "past" the positions past the image
    (a mutation)."""
    n, h, w, cin = x.shape
    wdt = w1.shape[0]
    lay, bn = plan.lay, plan.bn1
    oh, ow = lay.h, lay.w
    xm = x.reshape(-1, cin)
    m_rows = n * h * w
    slab = np.full((plan.slab_rows, wdt), fill, np.int8)
    count = np.zeros(slab.shape, np.int32)
    xs = np.full((plan.m_out, cin), fill, np.int8)
    xs_count = np.zeros(xs.shape, np.int32)
    nt = -(-wdt // bn)
    vecs = cin // 16
    per = -(-vecs // nt)
    for n0, m0 in _blocks(-(-m_rows // BM), wdt, bn):
        acc = _walk(xm.astype(np.int64), w1.numpy(), cin, m0, n0, bn, (0,))
        cols = min(bn, wdt - n0)
        a1 = _requant(acc[:, :cols], p1[n0:n0 + cols], q1[n0:n0 + cols])
        cs = slice(n0, n0 + cols)

        def put(row, val):
            slab[row, cs] = val
            count[row, cs] += 1

        v0, v1 = (n0 // bn) * per, min(vecs, (n0 // bn + 1) * per)
        for r in range(BM):
            m = m0 + r
            if m >= m_rows:
                continue
            i, rem = divmod(m, h * w)
            y, xx = divmod(rem, w)
            pr, pc = y // 2, xx // 2
            plane = 2 * (y % 2) + xx % 2
            row = _row(lay, pr, pc, i)
            ext = ((1 if xx % 2 == 0 and xx == w - 1 else 0)
                   | (2 if y % 2 == 0 and y == h - 1 else 0))
            for k in range(4):
                if k & ext != k or (k and "past" in skip):
                    continue
                base = (plane + k) * lay.slab_len
                put(base + row, a1[r] if k == 0 else 0)
                _pads(lambda rr, v: put(base + rr, v), lay, row, pr, pc,
                      skip)
            if y % 2 == 0 and xx % 2 == 0 and v0 < v1:
                xr = (i * oh + pr) * ow + pc
                xs[xr, 16 * v0:16 * v1] = xm[m, 16 * v0:16 * v1]
                xs_count[xr, 16 * v0:16 * v1] += 1
    return slab, count, xs, xs_count


def _emulate_out_proj(a2, w3, p3, q3, xp, wp, pp, out_int8):
    """The transition's output launch on the card: at BN = 64, conv3's
    one-tap walk over a2's rows and the projection's over xp's (x, or xs
    at stride 2), o = fma(f32(accP), pp, fma(f32(acc3), p3, q3)) staged,
    then relu(o) of each 16-channel vector as int8 or bf16."""
    n, oh, ow, wdt = a2.shape
    cout, cin = wp.shape
    m_rows = n * oh * ow
    am = a2.reshape(-1, wdt).astype(np.int64)
    xpm = xp.reshape(-1, cin).astype(np.int64)
    assert xpm.shape[0] == m_rows
    out = torch.zeros((m_rows, cout),
                      dtype=torch.int8 if out_int8 else torch.bfloat16)
    for n0, m0 in _blocks(-(-m_rows // BM), cout, 64):
        acc3 = _walk(am, w3.numpy(), wdt, m0, n0, 64, (0,))
        accp = _walk(xpm, wp.numpy(), cin, m0, n0, 64, (0,))
        cols = min(64, cout - n0)
        rows = min(BM, m_rows - m0)
        cs = slice(n0, n0 + cols)

        def f(a):
            return torch.from_numpy(a[:rows, :cols]).to(f32)

        o = fma_f32(f(accp), pp[cs], fma_f32(f(acc3), p3[cs], q3[cs]))
        o = torch.clamp_min(o, 0.0)
        out[m0:m0 + rows, cs] = quant_s8(o) if out_int8 else o.to(
            torch.bfloat16)
    return out.reshape(n, oh, ow, cout)


def _a1(x, w1, p1, q1):
    return requant(torch.from_numpy(x).to(f64) @ w1.to(f64).T, p1, q1)


def _emulate_block(x, ws, vec, pp, stride, out_int8, plan):
    """conv1's slab or planes -> conv2's walk -> the output's two
    mainloops, as the card runs them."""
    w1, w2, w3, wp = ws
    if stride == 1:
        slab, _ = _emulate_conv1(x, w1, vec[0], vec[1], plan.lay)
        xp = x
    else:
        slab, _, xp, _ = _emulate_conv1_planes(x, w1, vec[0], vec[1], plan)
    a2 = _emulate_conv2(slab, w2, vec[2], vec[3], plan.lay, plan.shifts)
    return _emulate_out_proj(a2, w3, vec[4], vec[5], xp, wp, pp, out_int8)


def _slab_ids(plan, n, h, w):
    """Each slab row's a1 position id ((i*h + y)*w + x), -1 at a pad."""
    lay = plan.lay
    ids = np.full(plan.slab_rows, -1, np.int64)
    s = plan.planes - 1   # 0 at stride 1, 3 (parity bits) at stride 2
    step = 2 if s else 1
    for i in range(n):
        for y in range(h):
            for x in range(w):
                plane = (2 * (y % 2) + x % 2) if s else 0
                ids[plane * lay.slab_len
                    + _row(lay, y // step, x // step, i)] = (i * h + y) * w + x
    return ids


@pytest.mark.parametrize("n,h,w,cin,wdt,cout,stride", CASES)
def test_planes_geometry_and_shifts_name_every_tap(n, h, w, cin, wdt, cout,
                                                   stride):
    plan = tnv.transition_plan(n, h, w, cin, wdt, cout, stride)
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    lay = plan.lay
    assert lay == tnv.serve_slab_layout(n, oh, ow, wdt)
    assert plan.planes == (4 if stride == 2 else 1)
    assert plan.slab_rows == plan.planes * lay.slab_len
    assert (plan.m, plan.m_out) == (n * h * w, n * oh * ow)
    if stride == 1:
        assert plan.shifts == lay.shifts
    ids = _slab_ids(plan, n, h, w)
    assert (np.sort(ids[ids >= 0]) == np.arange(n * h * w)).all()
    for m in range(lay.tiles * BM):
        site, i = divmod(m, n)
        r, c = divmod(site, lay.wq)
        for t, sh in enumerate(plan.shifts):
            dy, dx = divmod(t, 3)
            assert 0 <= m + sh < plan.slab_rows   # inside the map
            if r < oh and c < ow:
                iy, ix = stride * r + dy - 1, stride * c + dx - 1
                inside = 0 <= iy < h and 0 <= ix < w
                assert ids[m + sh] == ((i * h + iy) * w + ix if inside
                                       else -1), (m, t)


@pytest.mark.parametrize("n,h,w,cin,wdt,cout,stride", S2)
def test_conv1_writes_every_plane_byte_once_and_xs(n, h, w, cin, wdt, cout,
                                                   stride):
    x, ws, vec, _, _ = _operands(n + h + wdt, n, h, w, cin, wdt, cout)
    plan = tnv.transition_plan(n, h, w, cin, wdt, cout, stride)
    slab, count, xs, xs_count = _emulate_conv1_planes(x, ws[0], vec[0],
                                                      vec[1], plan)
    assert (count == 1).all()      # the pads written, not inherited
    assert (xs_count == 1).all()
    a1 = _a1(x, ws[0], vec[0], vec[1])
    assert len(np.unique(a1.numpy())) > 20
    np.testing.assert_array_equal(slab, tnv.block_slab_plain(a1,
                                                             plan).numpy())
    np.testing.assert_array_equal(slab, tnv.transition_slab_plain(
        torch.from_numpy(x), ws[0], vec[0], vec[1], plan).numpy())
    np.testing.assert_array_equal(
        xs, np.ascontiguousarray(x[:, ::2, ::2]).reshape(-1, cin))


@pytest.mark.parametrize("n,h,w,cin,wdt,cout,stride", CASES)
def test_conv2_walk_equals_plain_stride_conv(n, h, w, cin, wdt, cout,
                                             stride):
    x, ws, vec, _, _ = _operands(2 * n + w, n, h, w, cin, wdt, cout)
    plan = tnv.transition_plan(n, h, w, cin, wdt, cout, stride)
    if stride == 1:
        slab, _ = _emulate_conv1(x, ws[0], vec[0], vec[1], plan.lay)
    else:
        slab, _, _, _ = _emulate_conv1_planes(x, ws[0], vec[0], vec[1], plan)
    a1 = _a1(x, ws[0], vec[0], vec[1])
    k = ws[1].to(f64).reshape(wdt, 3, 3, wdt).permute(0, 3, 1, 2)
    acc = F.conv2d(a1.to(f64).permute(0, 3, 1, 2), k, stride=stride,
                   padding=1).permute(0, 2, 3, 1)
    want = requant(acc, vec[2], vec[3]).numpy()
    assert len(np.unique(want)) > 20
    np.testing.assert_array_equal(
        _emulate_conv2(slab, ws[1], vec[2], vec[3], plan.lay, plan.shifts),
        want)


def test_emulation_catches_a_wrong_plane_tap_shift_or_pad():
    """The emulation is sharp: tap (0, 0) in the plane of tap (0, 1), the
    taps mirrored, one tap a column off, or a pad that conv1 leaves
    unwritten (the planes' old bytes read as a1) change a2."""
    n, h, w, cin, wdt, cout = 3, 5, 7, 64, 64, 128
    x, ws, vec, _, _ = _operands(7, n, h, w, cin, wdt, cout)
    plan = tnv.transition_plan(n, h, w, cin, wdt, cout, 2)
    slab, _, _, _ = _emulate_conv1_planes(x, ws[0], vec[0], vec[1], plan)

    def a2(s, shifts=plan.shifts):
        return _emulate_conv2(s, ws[1], vec[2], vec[3], plan.lay, shifts)

    want = a2(slab)
    plane = list(plan.shifts)
    plane[0] -= plan.lay.slab_len   # plane 2 instead of 3
    mirrored = plan.shifts[::-1]
    off = list(plan.shifts)
    off[5] += n   # tap (1, 2) reads one plane column right
    for shifts in (plane, mirrored, off):
        assert not np.array_equal(a2(slab, tuple(shifts)), want)
    for pad in ("right", "top", "past"):
        stale, count, _, _ = _emulate_conv1_planes(x, ws[0], vec[0], vec[1],
                                                   plan, skip=(pad,))
        assert (count == 0).any()
        assert not np.array_equal(a2(stale), want), pad


@pytest.mark.parametrize("n,h,w,cin,wdt,cout,stride", CASES)
@pytest.mark.parametrize("out_int8", [True, False])
def test_emulated_block_equals_plain(n, h, w, cin, wdt, cout, stride,
                                     out_int8):
    x, ws, vec, pp, _ = _operands(3 * n + h + cin, n, h, w, cin, wdt, cout)
    plan = tnv.transition_plan(n, h, w, cin, wdt, cout, stride)
    got = _emulate_block(x, ws, vec, pp, stride, out_int8, plan)
    want = tnv.bneck_transition_nv_plain(torch.from_numpy(x), *ws, *vec, pp,
                                         stride=stride, out_int8=out_int8)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert want.unique().numel() > 20
    assert torch.equal(got, want)


@pytest.mark.parametrize("h,w,stride", [(6, 6, 2), (6, 5, 1)])
def test_emulated_block_equals_jax(h, w, stride):
    """conv1's slab or planes -> conv2's walk -> the output's two
    mainloops, against JAX's ``bneck_transition_nv`` in interpret mode on
    its NV carrier: int8 and bf16 outputs equal."""
    n, cin, wdt, cout = 32, 32, 32, 64   # the JAX kernel's batch rule
    x, ws, vec, pp, ops = _operands(11 + stride, n, h, w, cin, wdt, cout)
    plan = tnv.transition_plan(n, h, w, cin, wdt, cout, stride)
    for out_int8 in (True, False):
        got = _emulate_block(x, ws, vec, pp, stride, out_int8, plan)
        want = _jax(x, ops, stride=stride, out_int8=out_int8)
        assert len(np.unique(want)) > 50
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("model", sorted(TRANSITIONS))
def test_plan_holds_at_every_gate_geometry(model):
    """Every transition block of the model at every batch the NV gate
    admits (a power of two and a multiple of 32) up to 512."""
    seen = 0
    for h, cin, wdt, cout, stride in TRANSITIONS[model]:
        oh = (h - 1) // stride + 1
        for n in (32, 64, 128, 256, 512):
            plan = tnv.transition_plan(n, h, h, cin, wdt, cout, stride)
            lay = plan.lay
            assert lay == tnv.serve_slab_layout(n, oh, oh, wdt)
            m, m_out = n * h * h, n * oh * oh
            assert (plan.m, plan.m_out) == (m, m_out)
            # the N tiles: 64 at W = 64, else 128; the output's 64
            assert (plan.bn1, plan.bn2) == ((64, 64) if wdt == 64
                                            else (128, 128))
            assert plan.bn3 == 64
            mt, mo = -(-m // BM), -(-m_out // BM)
            assert plan.blocks == (mt * -(-wdt // plan.bn1),
                                   lay.tiles * -(-wdt // plan.bn2),
                                   mo * -(-cout // 64))
            assert max(plan.blocks) <= 65535, (model, h, n, plan.blocks)
            # the planes (or the slab) under 2 GB, 32-bit rows
            assert plan.slab_rows * wdt < 2 ** 31
            # every box inside its map: conv2's nine shifted boxes of
            # every tile inside the planes; conv1's, conv3's and the
            # projection's start inside x, a2 and x or xs
            assert min(plan.shifts) >= 0
            assert max(plan.shifts) + lay.tiles * BM <= plan.slab_rows
            assert (mt - 1) * BM < m and (mo - 1) * BM < m_out
            for k, taps in ((cin, 1), (wdt, 9), (wdt, 1)):
                boxes = _boxes(k)
                assert sum(wd for _, wd in boxes) == k
                assert all((t * k + o) % 16 == 0 for t in range(taps)
                           for o, _ in boxes)
            assert all(wd <= BK for _, wd in _boxes(cin))
            # the epilogues' room in the drained ring: conv1's and conv2's
            # int8 tiles, row maps and flags (conv1 at stride 2 also its
            # xs rows); the output's f32 tile and p3, q3 and pp at BN = 64
            for bn in {plan.bn1, plan.bn2}:
                assert (BM * (bn + 16) + 2 * bn * 4 + 3 * BM * 4
                        <= _ring(bn))
            assert BM * (64 + 64 // 4 + 8) * 4 + 3 * 64 * 4 <= _ring(64)
            assert THREADS % 4 == 0 and BM % (THREADS // 4) == 0
            assert cout % 16 == 0 and cin % 16 == 0
            seen += 1
    assert seen == 20


def test_plan_refuses_32_bit_overflow():
    with pytest.raises(ValueError, match="32-bit"):
        tnv.transition_plan(2 ** 20, 56, 56, 256, 128, 512, 2)
    with pytest.raises(ValueError, match="32-bit"):
        tnv.transition_plan(2 ** 20, 56, 56, 64, 64, 256, 1)


@pytest.mark.parametrize("h,cin,wdt,cout,stride",
                         TRANSITIONS["resnet-50"]
                         + TRANSITIONS["wrn-50-2"][-1:])
def test_part_bounds_count_codes_not_planes_pads(h, cin, wdt, cout, stride,
                                                 monkeypatch):
    """chip_smoke.py's part bounds of the transition count a1 as its
    n*h*w*W codes (conv1's write, conv2's read), not the slab's or the
    planes' pads, and xs once each way at stride 2; each is the larger of
    its operations and its bytes; a part the profiler missed is None."""
    import chip_smoke

    n, ops, bw = chip_smoke.BATCH, 1.979e15, 3.35e12
    plan = tnv.transition_plan(n, h, h, cin, wdt, cout, stride)
    m, m_out = plan.m, plan.m_out
    assert m * wdt < plan.slab_rows * wdt
    monkeypatch.setattr(chip_smoke, "kernel_split_ms",
                        lambda *a, **k: None)
    got = chip_smoke.nv_transition_parts(None, plan, cin, wdt, cout, True,
                                         ops, bw)
    xs = m_out * cin if stride == 2 else 0
    want = dict(
        conv1=(2 * m * cin * wdt,
               m * cin + m * wdt + xs + wdt * cin + 8 * wdt),
        conv2=(2 * m_out * 9 * wdt * wdt,
               m * wdt + m_out * wdt + 9 * wdt * wdt + 8 * wdt),
        out=(2 * m_out * cout * (wdt + cin),
             m_out * (wdt + cin + cout) + cout * (wdt + cin) + 12 * cout))
    for part, (o, b) in want.items():
        o, b = o / ops * 1e3, b / bw * 1e3
        assert got[f"{part}_bound_ms"] == pytest.approx(max(o, b),
                                                        rel=1e-12)
        assert got[f"{part}_bound_by"] == ("operations" if o >= b
                                           else "bytes")
        assert got[f"{part}_dev_ms"] is None
    assert got["dev_ms"] is None
