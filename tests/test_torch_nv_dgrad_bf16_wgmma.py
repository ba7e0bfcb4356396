"""The bf16 input gradient of the NV training halves
(ops/cuda/bneck_nv_train.py ``dgrad_bf16_pre``, ``dgrad_bf16_gemm``,
``dgrad_conv_bf16``; kernels in csrc/bneck_nv_train.cu,
csrc/nv_dgrad_wgmma_bf16.cuh and csrc/nv_dgrad_epilogue.cuh), on the CPU:

- the prepass's plain version writes bf16(g) once into
  ``dgrad_bf16_layout``'s slab (the int8 forward's layout at Cin = the
  half's Cout and one chunk of h rows), with zeros at the pad column, pad
  channels, guards, the halo rows outside the image and the tile tail:
  held against a slab built element by element from its definition;
- an emulation of the card kernel (128-row tiles, 128-byte K steps whose
  16-byte pieces each sit at their own tap, the mirrored walk's closed-form
  offsets, the NHWC row map, the epilogue's vectors and its fixed order of
  sums) and the vectorized ``dgrad_bf16_gemm_plain`` both reproduce
  ``dgrad_conv_bf16_plain``'s dx and dres bit for bit, and its d(s) and
  d(t) within 1e-5; a wrong tap or offset changes dx;
- the layout and the GEMM's plan (N tile, grid, slab under 2 GB, every
  shifted read of every tile inside the slab, the epilogue inside the ring)
  hold at every geometry the NV gate admits for ResNet-50 and WRN-50-2;
- the slab route holds against JAX's interpret-mode QAT input gradient.

Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv_train as nvt
from test_torch_bneck_nv_train import _oihw
from test_torch_bneck_nv_train_bf16 import H, W, _jax_half, _operands
from test_torch_nv_dgrad_int8_wgmma import _dgrad_halves
from test_torch_nv_wgrad_staged import MODELS

BK = 128        # bytes a K step (csrc/fwd_wgmma_bf16.cuh BK)
THREADS = 256   # the GEMM's block (csrc/fwd_wgmma_bf16.cuh THREADS)
STAGES = 3      # the mainloop's ring (csrc/fwd_wgmma_bf16.cuh STAGES)


def _mirror(lay):
    """The walk's offsets past the guard in closed form (csrc/
    nv_dgrad_wgmma_bf16.cuh MirrorTaps): tap t at (2 - t/3) * wq * n + (1 -
    t%3) * n for the 3x3, 0 for the 1x1."""
    row, col = (lay.wq * lay.n, lay.n) if lay.taps == 9 else (0, 0)
    return [(2 - t // 3) * row + (1 - t % 3) * col for t in range(lay.taps)]


def _ring(bn):
    """Bytes of the mainloop's ring and of the epilogue's stage in it
    (csrc/nv_dgrad_epilogue.cuh Stage)."""
    rs = THREADS // (bn // 8)
    return (STAGES * (128 + bn) * BK,
            128 * (bn + 8) * 4 + 128 * 4 + 2 * rs * bn * 4)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_layout_and_plan_hold_at_every_gate_geometry(model):
    halves = _dgrad_halves(model)
    assert len(halves) >= 40, len(halves)
    # stage 4's 7x7: ResNet-50's at batch 64, WRN-50-2's at 32
    assert any(h == 7 and n == (64 if model == "resnet-50" else 32)
               for n, h, *_ in halves)
    for n, h, w, cin, cout, taps, _ in halves:
        lay = nvt.dgrad_bf16_layout(n, h, w, cout, taps)
        assert lay.chunks == 1 and lay.rch == h and lay.cp == cout
        assert lay.bm == 128 and cin % 8 == 0
        assert (lay.tiles - 1) * lay.bm < lay.m_valid <= lay.tiles * lay.bm
        assert lay.slab_len * lay.cp * 2 < 2 ** 31, lay   # one bf16 slab
        # the N tile and the grid: the N tiles of one M tile neighbours
        bn = nvt.dgrad_tile(cin)
        assert bn == (128 if cin >= 128 else 64) and cin % bn == 0
        assert lay.tiles <= 65535, lay
        ring, stage = _ring(bn)
        assert stage <= ring
        # K: each 16-byte piece of a 128-byte step lies in one tap
        pitch = 2 * lay.cp
        assert pitch % 16 == 0 and (taps * pitch) % BK == 0
        # the walk's tap t reads the mirror of forward tap t at the closed
        # form; every row of every tile, shifted, stays inside the slab
        walk = [lay.guard + o for o in _mirror(lay)]
        assert walk == list(lay.shifts[::-1])
        assert min(walk) >= 0
        assert max(walk) + lay.tiles * lay.bm <= lay.slab_len, lay
        # the epilogue's threads: whole rows a thread, a vector's 8
        # channels all live or none
        vpr = bn // 8
        assert THREADS % vpr == 0 and lay.bm % (THREADS // vpr) == 0


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(
            torch.bfloat16)


def _args(rng, n, h, w, cin, cout, conv, mode):
    """The bf16 input gradient's arguments (dy, y, dzsum, dzssq, wb_dg, x,
    s, t, res, dxout)."""
    dy = _bf16(rng, n, h, w, cout)
    y = _bf16(rng, n, h, w, cout)
    dzsum = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)
                             * 0.1)
    dzssq = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)
                             * 0.01)
    k = 3 if conv == "3x3" else 1
    wt = torch.from_numpy(rng.standard_normal((cout, cin, k, k)).astype(
        np.float32))
    x = _bf16(rng, n, h, w, cin)
    aff = mode != "identity"
    s = (torch.from_numpy(rng.standard_normal(cin).astype(np.float32) * 0.5
                          + 1.0) if aff else None)
    t = (torch.from_numpy(rng.standard_normal(cin).astype(np.float32) * 0.2)
         if aff else None)
    res = _bf16(rng, n, h, w, cin) if mode == "entry" else None
    dxout = _bf16(rng, n, h, w, cin, scale=10.0) if mode == "entry" else None
    return (dy, y, dzsum, dzssq, nvt.pack_w_bf16_dgrad(wt),
            x.abs() if mode == "identity" else x, s, t, res, dxout)


def _expected_slab(g, lay):
    """The slab built element by element from its definition: bf16 [1,
    slab_len, cp], bf16(g) of image row ra - halo, column col and image i
    at position guard + (ra*wq + col)*n + i (3x3) or (i*h + ra)*w + col
    (1x1), channels < Cout; zero elsewhere."""
    n, h, w, cout = g.shape
    gb = g.to(torch.bfloat16)
    out = torch.zeros((1, lay.slab_len, lay.cp), dtype=torch.bfloat16)
    for ra in range(h + 2 * lay.halo):
        row = ra - lay.halo
        if not 0 <= row < h:
            continue
        for col in range(w):
            if lay.halo:
                p = lay.guard + (ra * lay.wq + col) * n
                out[0, p:p + n, :cout] = gb[:, row, col]
            else:
                for i in range(n):
                    out[0, (i * h + ra) * w + col, :cout] = gb[i, row, col]
    return out


@pytest.mark.parametrize("conv,n,h,w,cout", [
    ("3x3", 3, 6, 5, 40), ("3x3", 2, 4, 7, 64),
    ("1x1", 3, 6, 5, 40), ("1x1", 4, 4, 3, 136)])
def test_prepass_plain_writes_the_rounded_cotangent_once(conv, n, h, w,
                                                         cout):
    rng = np.random.default_rng(cout + h)
    args = _args(rng, n, h, w, 16, cout, conv, "affine")
    slab = nvt.dgrad_bf16_pre(*args[:4], conv=conv)  # plain on the CPU
    taps = 9 if conv == "3x3" else 1
    lay = nvt.dgrad_bf16_layout(n, h, w, cout, taps)
    assert lay == nvt.fwd_int8_layout(n, h, w, cout, taps, h)
    assert slab.dtype == torch.bfloat16
    assert slab.shape == (1, lay.slab_len, lay.cp)
    assert lay.cp == -(-cout // 64) * 64
    g = nvt.fold_plain(*args[:4])
    assert torch.equal(slab, _expected_slab(g, lay))
    # the values the prepass must write: every image row once
    assert lay.codes == n * h * w * cout < slab.numel()
    # the pad channels, the guards and the tile tail are zero
    span = (h + 2 * lay.halo) * lay.wq * n
    body = slab[0, lay.guard:lay.guard + span]
    body = (body.reshape(h + 2, lay.wq, n, lay.cp) if lay.halo
            else body.reshape(n, h, w, lay.cp))
    assert not slab[..., cout:].any()
    assert not slab[0, :lay.guard].any()
    assert not slab[0, lay.guard + span:].any()
    assert body[..., :cout].any()
    if conv == "3x3":
        assert not body[:, w].any()   # the pad column
        # the halo rows above and below the image
        assert not body[0].any() and not body[-1].any()


def _emulate(slab, wb_dg, x, s, t, res, dxout, lay, mode, offsets=None):
    """The card kernel on the slab: per 128-row tile, per N tile of BN
    channels, per 128-byte K step, each 16-byte piece at its own tap (read
    at guard + m + offsets[tap], no masks) against the weights' piece of
    the same K bytes, in float64 (each bf16 product exact); then each
    live row's NHWC position (the pad column and the tail dropped) and the
    epilogue's 8-channel vectors: da = f32(acc) (entry: + dx_res in f32),
    u = fma(x, s, t) (+ res), du, dx = bf16(du * s), dres = bf16(du); each
    thread's sums over its rows in order, the row groups in order, then
    the tiles in common::tile_sum's order (runs of slots, then the runs)."""
    sl = slab[0].double().numpy()
    cin = x.shape[-1]
    wt = nvt._pack_w_fwd(wb_dg, lay).double().numpy()
    offsets = _mirror(lay) if offsets is None else offsets
    bn = nvt.dgrad_tile(cin)
    rs = THREADS // (bn // 8)   # the epilogue's row groups
    pitch = 2 * lay.cp          # bytes a slab position
    kbytes = lay.taps * pitch
    xf = x.float().reshape(-1, cin).numpy()
    aff = mode != "identity"
    if aff:
        sv, tv = s.numpy().astype(np.float32), t.numpy().astype(np.float32)
    if mode == "entry":
        rf = res.float().reshape(-1, cin).numpy()
        of = dxout.float().reshape(-1, cin).numpy()
    dx = np.zeros((lay.n * lay.h * lay.w, cin), dtype=np.float32)
    dres = np.zeros_like(dx)
    part = []
    for tile in range(lay.tiles):
        m0 = tile * lay.bm
        m = m0 + np.arange(lay.bm)
        if lay.halo:   # images innermost
            i, site = m % lay.n, m // lay.n
        else:
            i, site = m // (lay.h * lay.w), m % (lay.h * lay.w)
        r, c = site // lay.wq, site % lay.wq
        live = (r < lay.h) & (c < lay.w) & (i < lay.n)
        pos = np.where(live, (i * lay.h + r) * lay.w + c, -1)
        sums = np.zeros((2, cin), dtype=np.float32)
        for n0 in range(0, cin, bn):
            cols = min(bn, cin - n0)
            acc = np.zeros((lay.bm, cols))
            for kt in range(-(-kbytes // BK)):
                for piece in range(BK // 16):
                    kb = kt * BK + piece * 16
                    tap = min(kb // pitch, lay.taps - 1)
                    ch = (kb - tap * pitch) // 2
                    first = lay.guard + m0 + offsets[tap]
                    a = sl[first:first + lay.bm, ch:ch + 8]
                    assert first >= 0 and a.shape == (lay.bm, 8)
                    if kb < kbytes:
                        b = wt[n0:n0 + cols, kb // 2:kb // 2 + 8]
                        acc += a @ b.T
            af = acc.astype(np.float32)
            s1 = np.zeros((rs, cols), dtype=np.float32)
            s2 = np.zeros((rs, cols), dtype=np.float32)
            cs = slice(n0, n0 + cols)
            for ml in range(lay.bm):
                p = pos[ml]
                if p < 0:
                    continue
                d = af[ml] + of[p, cs] if mode == "entry" else af[ml]
                if not aff:
                    dx[p, cs] = d
                    continue
                u = (xf[p, cs].astype(np.float64) * sv[cs]
                     + tv[cs]).astype(np.float32)
                if mode == "entry":
                    u = (u + rf[p, cs]).astype(np.float32)
                du = np.where(u > 0, d, np.float32(0))
                dx[p, cs] = du * sv[cs]
                dres[p, cs] = du
                s1[ml % rs] += du * xf[p, cs]
                s2[ml % rs] += du
            for grp in range(rs):   # the row groups in order
                sums[0, cs] += s1[grp]
                sums[1, cs] += s2[grp]
        part.append(sums.reshape(-1))
    # common::tile_sum: 32 runs of consecutive slots, each in order, then
    # the runs in order
    part = np.stack(part)
    per = -(-part.shape[0] // 32)
    total = np.zeros(part.shape[1], dtype=np.float32)
    for q in range(32):
        run = np.zeros(part.shape[1], dtype=np.float32)
        for slot in range(q * per, min(part.shape[0], (q + 1) * per)):
            run += part[slot]
        total += run
    shape = (lay.n, lay.h, lay.w, cin)
    out_dx = torch.from_numpy(dx.reshape(shape)).to(torch.bfloat16)
    if not aff:
        return out_dx, None, None, None
    return (out_dx, torch.from_numpy(total[:cin].copy()),
            torch.from_numpy(total[cin:].copy()),
            torch.from_numpy(dres.reshape(shape)).to(torch.bfloat16)
            if mode == "entry" else None)


def _close(got, want, rel=1e-5):
    assert (got.double() - want.double()).abs().max().item() <= \
        rel * want.double().abs().max().item()


def _agree(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None, i
        elif i in (1, 2):   # d(s), d(t): f32 sums in another order
            _close(a, b)
        else:
            assert torch.equal(a, b), i


# (conv, mode, n, h, w, Cin, Cout, rch): planes of 7 x 6, 6 x 7, 5 x 4 and
# 6 x 5 (h != w, tile tails, tiles across rows and images); n = 3 and 32;
# Cout = 24 (the channel pad), 128 and 192 (three 128-byte steps a tap);
# Cin = 40 (one 64-wide N tile, ragged) and 136 (two 128-wide N tiles, the
# second ragged); the plain version's sums in several chunks (rch); every
# mode, the 3x3 in identity mode too
EMULATED = [("3x3", "affine", 3, 7, 6, 40, 24, 7),
            ("3x3", "identity", 32, 6, 7, 40, 24, 2),
            ("3x3", "affine", 3, 5, 4, 136, 128, 1),
            ("1x1", "entry", 3, 6, 5, 40, 24, 3),
            ("1x1", "identity", 32, 7, 6, 40, 24, 7),
            ("1x1", "affine", 3, 6, 7, 136, 192, 2)]


@pytest.mark.parametrize("conv,mode,n,h,w,cin,cout,rch", EMULATED)
def test_emulated_kernel_reproduces_plain_bit_for_bit(conv, mode, n, h, w,
                                                      cin, cout, rch):
    args = _args(np.random.default_rng(cin + cout + h), n, h, w, cin, cout,
                 conv, mode)
    taps = 9 if conv == "3x3" else 1
    lay = nvt.dgrad_bf16_layout(n, h, w, cout, taps)
    kw = dict(conv=conv, mode=mode, rch=rch)
    want = nvt.dgrad_conv_bf16_plain(*args, **kw)
    assert want[0].shape == (n, h, w, cin)
    assert want[0].float().abs().max().item() > 0
    slab = nvt.dgrad_bf16_pre(*args[:4], conv=conv)
    _agree(_emulate(slab, *args[4:], lay, mode), want)
    # the vectorized plain version of the GEMM, and the CPU wrappers
    _agree(nvt.dgrad_bf16_gemm(slab, *args[4:], lay, mode=mode), want)
    _agree(nvt.dgrad_conv_bf16(*args, **kw), want)


@pytest.mark.parametrize("conv,mode", [("3x3", "affine"), ("1x1", "entry")])
def test_emulation_catches_a_wrong_tap_or_offset(conv, mode):
    """The emulation is sharp: the forward's shifts in place of their
    mirrors, a column step of the wrong sign, or the 1x1 read one position
    off, change dx."""
    n, h, w, cin, cout = 3, 6, 5, 40, 24
    args = _args(np.random.default_rng(5), n, h, w, cin, cout, conv, mode)
    taps = 9 if conv == "3x3" else 1
    lay = nvt.dgrad_bf16_layout(n, h, w, cout, taps)
    slab = nvt.dgrad_bf16_pre(*args[:4], conv=conv)
    want = nvt.dgrad_conv_bf16_plain(*args, conv=conv, mode=mode, rch=2)
    if conv == "3x3":
        unmirrored = [sh - lay.guard for sh in lay.shifts]
        got = _emulate(slab, *args[4:], lay, mode, unmirrored)
        assert not torch.equal(got[0], want[0])
        col_flipped = [(2 - t // 3) * lay.wq * n + (t % 3 - 1) * n
                       for t in range(9)]
        got = _emulate(slab, *args[4:], lay, mode, col_flipped)
        assert not torch.equal(got[0], want[0])
        got = nvt.dgrad_bf16_gemm(slab, *args[4:],
                                  lay._replace(shifts=lay.shifts[::-1]),
                                  mode=mode)
        assert not torch.equal(got[0], want[0])
    else:   # one position off, the slab given a tile of zeros to read
        padded = torch.nn.functional.pad(slab, (0, 0, 0, lay.bm))
        got = _emulate(padded, *args[4:], lay, mode, [1])
        assert not torch.equal(got[0], want[0])


@pytest.mark.parametrize("conv,mode", [("1x1", "entry"), ("3x3", "affine"),
                                       ("1x1", "identity")])
def test_slab_route_matches_jax(conv, mode):
    """The plain prepass and GEMM on JAX's QAT forward y (the int8
    forward, equal to the port's) against JAX's interpret-mode bf16 input
    gradient: dx and dres within 2 bf16 ulps of their largest value, d(s)
    and d(t) within 1e-4 (tests/test_torch_bneck_nv_train_bf16.py's
    tolerances)."""
    op, ct = _operands(len(conv) * 10 + len(mode) + 2, conv, mode)
    fwd, grads = _jax_half(op, ct, conv, mode, 2, True, False)
    entry, affine = mode == "entry", mode != "identity"

    def bf(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    dy, y = bf(ct["dy"]), bf(fwd[0])
    dzsum, dzssq = f32(ct["dzsum"]), f32(ct["dzssq"])
    wb = nvt.pack_w_bf16_dgrad(torch.from_numpy(_oihw(op["w"], conv)))
    x = bf(op["x"])
    s, t = (f32(op["s"]), f32(op["t"])) if affine else (None, None)
    res = bf(op["res"]) if entry else None
    dxout = bf(ct["dxout"]) if entry else None
    taps = 9 if conv == "3x3" else 1
    lay = nvt.dgrad_bf16_layout(dy.shape[0], H, W, dy.shape[-1], taps)
    slab = nvt.dgrad_bf16_pre_plain(dy, y, dzsum, dzssq, conv=conv)
    dx, ds, dt, dres = nvt.dgrad_bf16_gemm_plain(slab, wb, x, s, t, res,
                                                 dxout, lay, mode=mode)
    want = dict(dx=grads[0], dres=grads[1], ds=grads[3], dt=grads[4])
    got = dict(dx=dx, dres=dres, ds=ds, dt=dt)
    for k, ref in want.items():
        if ref is None:
            assert got[k] is None, k
            continue
        out = got[k].float().numpy()
        scale = np.abs(ref).max()
        assert scale > 0, k
        tol = 2 * 2.0 ** -7 if k in ("dx", "dres") else 1e-4
        assert np.abs(out - ref).max() <= tol * scale, k


def test_profile_kinds_count_the_new_kernels_as_the_nv_halves():
    """chip_smoke.py's kernel kinds by demangled name: the bf16 dgrad's
    prepass, wgmma GEMM and tiles' sum are the NV training halves'."""
    import chip_smoke

    for name in (
            "void nv_dgrad_wgmma_bf16::nvt_dgrad_bf16_kernel<128>("
            "nv_dgrad_wgmma_bf16::Args)",
            "void nv_dgrad_wgmma_bf16::nvt_dgrad_bf16_kernel<64>("
            "nv_dgrad_wgmma_bf16::Args)",
            "void (anonymous namespace)::nvt_fwd_pre_kernel<(anonymous "
            "namespace)::Cot, (anonymous namespace)::Bf16Out>((anonymous "
            "namespace)::Cot, (anonymous namespace)::Bf16Out, (anonymous "
            "namespace)::FwdSlabGeo)",
            "void common::tile_sum_kernel<(anonymous namespace)::"
            "NvtDgradSumBf16>(float const*, float*, int, int)"):
        assert chip_smoke.kernel_kind(name) == "nv train halves (port)", name
