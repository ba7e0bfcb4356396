"""The int8 input gradient of the NV training halves
(ops/cuda/bneck_nv_train.py ``dgrad_pre``, ``dgrad_gemm``, ``dgrad_conv``;
kernels in csrc/bneck_nv_train.cu and csrc/nv_dgrad_wgmma_s8.cuh), on the
CPU:

- the prepass's plain version writes each chunk's folded cotangent (halo
  rows included) at the chunk's scale into ``fwd_int8_layout``'s slab at
  Cin = the half's Cout, a 3x3 boundary row into both chunks at their two
  scales, and zeros at the pad column, pad channels, guards, halo rows
  outside the image and tile tail: held against a slab built element by
  element from its definition;
- an emulation of the card kernel (chunk -> 128-row tile -> the walk's
  tap, read at the mirrored shift -> K boxes of 128 and 64 bytes, s32
  accumulators, one scale a tile, the NHWC row map, the epilogue's vectors
  and its fixed order of sums) and the vectorized ``dgrad_gemm_plain``
  both reproduce ``dgrad_conv_plain``'s dx and dres bit for bit, and its
  d(s) and d(t) within 1e-5;
- the layout and the GEMM's plan (N tile, a tap's last box, grid, box
  offsets on 16-byte boundaries, every shifted read of every tile inside
  its chunk's slab) hold at every geometry the NV gate admits for
  ResNet-50 and WRN-50-2.

JAX's interpret-mode int8 input gradient is held against ``dgrad_conv``
in tests/test_torch_bneck_nv_train.py. Inputs are made with numpy from a
seed.
"""

import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv_train as nvt
from test_torch_nv_wgrad_staged import MODELS

BK = 128        # bytes of the widest K box (csrc/fwd_wgmma_s8.cuh BK)
THREADS = 256   # the GEMM's block (csrc/fwd_wgmma_s8.cuh THREADS)


def _dgrad_halves(model):
    """(n, h, w, Cin, Cout, taps, dgrad row chunk) of every half of every
    identity block the NV gate admits, batches 32 to 256."""
    out = []
    for h, cin, cb, cout in MODELS[model]:
        for n in (32, 64, 128, 256):
            if not nvt.nv_train_fits(h, h, n, cin, cb, cout):
                continue
            for conv, mode, ci, co in (("1x1", "identity", cin, cb),
                                       ("1x1", "entry", cin, cb),
                                       ("3x3", "affine", cb, cb),
                                       ("1x1", "affine", cb, cout)):
                rch = nvt.pick_chunk_rows(h, h, n, ci, co, conv, mode)[1]
                out.append((n, h, h, ci, co, 9 if conv == "3x3" else 1,
                            rch))
    return out


def _boxes(cp):
    """A tap's K boxes (byte offset, width) as the mainloop walks them: cp
    // 128 boxes of 128 bytes, then one of 64 where cp % 128 == 64."""
    out = [(o, BK) for o in range(0, cp - cp % BK, BK)]
    if cp % BK:
        out.append((cp - cp % BK, cp % BK))
    return out


@pytest.mark.parametrize("model", sorted(MODELS))
def test_layout_and_plan_hold_at_every_gate_geometry(model):
    halves = _dgrad_halves(model)
    assert len(halves) >= 40, len(halves)
    for n, h, w, cin, cout, taps, rch in halves:
        lay = nvt.fwd_int8_layout(n, h, w, cout, taps, rch)
        assert cin % 8 == 0 and lay.cp % 64 == 0 and lay.cp == cout
        assert lay.chunks == h // rch and lay.bm == nvt.FWD_BM == 128
        assert (lay.tiles - 1) * lay.bm < lay.m_valid <= lay.tiles * lay.bm
        # the GEMM's N tile, a tap's last box, the grid
        bn = nvt.dgrad_tile(cin)
        assert bn == (128 if cin >= 128 else 64) and cin % bn == 0
        assert lay.cp % BK in (0, 64)
        grid = (-(-cin // bn), lay.chunks * lay.tiles)
        assert grid[1] <= 65535, (grid, lay)
        # every box starts on a 16-byte boundary: A at (byte o, row m0 +
        # shift), B at (byte t * cp + o, row n0)
        boxes = _boxes(lay.cp)
        assert sum(wd for _, wd in boxes) == lay.cp
        assert all(o % 16 == 0 and wd in (BK, 64) for o, wd in boxes)
        assert all((t * lay.cp + o) % 16 == 0 for t in range(taps)
                   for o, _ in boxes)
        # the walk's tap t reads the mirror of forward tap t; every row of
        # every tile, shifted, stays inside its own chunk's slab of the one
        # map [chunks * slab_len, cp]
        walk = lay.shifts[::-1]
        assert len(walk) == taps
        assert min(walk) >= 0
        assert max(walk) + lay.tiles * lay.bm <= lay.slab_len, lay
        if taps == 9:
            assert walk[4] == lay.shifts[4] == lay.guard + lay.wq * n
            assert walk[0] == lay.shifts[8]
        # the epilogue's threads: whole rows a thread, its vector's 8
        # channels all live or none
        vpr = bn // 8
        assert THREADS % vpr == 0 and lay.bm % (THREADS // vpr) == 0


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(
            torch.bfloat16)


def _args(rng, n, h, w, cin, cout, conv, mode, rising=False):
    """The input gradient's arguments (dy, y, dzsum, dzssq, rowmax_g,
    wq_dg, ws_in, x, s, t, res, dxout), each image row's cotangent scaled by
    its own factor so that neighbouring chunks get different scales (with
    ``rising``, factors that grow row by row, so that every chunk's group
    has its own absmax)."""
    f = (np.exp(np.arange(h) * 0.5) if rising
         else np.exp(rng.standard_normal(h)))
    rows = torch.from_numpy(f.astype(np.float32))[None, :, None, None]
    dy = (_bf16(rng, n, h, w, cout).float() * rows).to(torch.bfloat16)
    y = _bf16(rng, n, h, w, cout)
    dzsum = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)
                             * 0.1)
    dzssq = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)
                             * 0.01)
    k = 3 if conv == "3x3" else 1
    wt = torch.from_numpy(rng.standard_normal((cout, cin, k, k)).astype(
        np.float32))
    wq_dg, ws_in = (nvt.quantize_w_3x3_dgrad if k == 3
                    else nvt.quantize_w_1x1_dgrad)(wt)
    x = _bf16(rng, n, h, w, cin)
    aff = mode != "identity"
    s = (torch.from_numpy(rng.standard_normal(cin).astype(np.float32) * 0.5
                          + 1.0) if aff else None)
    t = (torch.from_numpy(rng.standard_normal(cin).astype(np.float32) * 0.2)
         if aff else None)
    res = _bf16(rng, n, h, w, cin) if mode == "entry" else None
    dxout = _bf16(rng, n, h, w, cin, scale=10.0) if mode == "entry" else None
    rowmax_g = nvt.bwd_rowmax(dy, y, dzsum, dzssq)
    return (dy, y, dzsum, dzssq, rowmax_g, wq_dg, ws_in,
            x.abs() if mode == "identity" else x, s, t, res, dxout)


def _expected_slab(g, inv, lay):
    """The slab built element by element from its definition: int8 [K,
    slab_len, cp], q(g * inv_k) of image row k*rch - halo + ra, column col
    and image i at position guard + (ra*wq + col)*n + i (3x3) or (i*rch +
    ra)*w + col (1x1), channels < Cout; zero elsewhere."""
    n, h, w, cout = g.shape
    gn = g.numpy()
    out = np.zeros((lay.chunks, lay.slab_len, lay.cp), dtype=np.int8)
    for k in range(lay.chunks):
        inv_k = np.float32(inv[k].item())
        for ra in range(lay.rch + 2 * lay.halo):
            row = k * lay.rch - lay.halo + ra
            if not 0 <= row < h:
                continue
            for col in range(w):
                q = np.clip(np.rint(gn[:, row, col, :] * inv_k), -127, 127)
                if lay.halo:
                    p = lay.guard + (ra * lay.wq + col) * n
                    out[k, p:p + n, :cout] = q.astype(np.int8)
                else:
                    p = np.arange(n) * lay.rch * w + ra * w + col
                    out[k, p, :cout] = q.astype(np.int8)
    return torch.from_numpy(out)


@pytest.mark.parametrize("conv,n,h,w,cout,rch", [
    ("3x3", 3, 6, 5, 40, 2), ("3x3", 2, 7, 4, 72, 7),
    ("1x1", 3, 6, 5, 40, 3), ("1x1", 4, 4, 3, 136, 1)])
def test_prepass_plain_writes_each_chunk_at_its_scale(conv, n, h, w, cout,
                                                      rch):
    rng = np.random.default_rng(cout + h)
    args = _args(rng, n, h, w, 16, cout, conv, "affine", rising=True)
    slab = nvt.dgrad_pre(*args[:5], conv=conv, rch=rch)  # plain on the CPU
    taps = 9 if conv == "3x3" else 1
    lay = nvt.fwd_int8_layout(n, h, w, cout, taps, rch)
    assert slab.dtype == torch.int8
    assert slab.shape == (lay.chunks, lay.slab_len, lay.cp)
    assert lay.cp == -(-cout // 64) * 64
    inv = nvt._quant_params(nvt.chunk_amax(args[4], rch, lay.halo))[0]
    g = nvt.fold_plain(*args[:4])
    assert torch.equal(slab, _expected_slab(g, inv, lay))
    # the codes the prepass must write: the chunks' rows inside the image
    rows = sum(0 <= k * rch - lay.halo + ra < h for k in range(lay.chunks)
               for ra in range(rch + 2 * lay.halo))
    assert lay.codes == rows * n * w * cout < slab.numel()
    # the pad channels, the guards and the tile tail are zero
    span = (rch + 2 * lay.halo) * lay.wq * n
    body = slab[:, lay.guard:lay.guard + span]
    body = (body.reshape(lay.chunks, rch + 2, lay.wq, n, lay.cp)
            if lay.halo else body.reshape(lay.chunks, n, rch, w, lay.cp))
    assert not slab[..., cout:].any()
    assert not slab[:, :lay.guard].any()
    assert not slab[:, lay.guard + span:].any()
    assert body[..., :cout].any()
    if conv == "3x3":
        assert not body[:, :, w].any()   # the pad column
        # chunk 0's upper halo row and the last chunk's lower one lie
        # outside the image
        assert not body[0, 0].any() and not body[-1, -1].any()
        if lay.chunks > 1:
            # image row rch - 1 closes chunk 0 (slab row rch) and is chunk
            # 1's upper halo row (slab row 0), each at its chunk's scale
            def q(k):
                return torch.clamp(torch.round(
                    g[:, rch - 1].permute(1, 0, 2) * inv[k]), -127,
                    127).to(torch.int8)
            assert inv[0] != inv[1]
            assert torch.equal(body[0, rch, :w, :, :cout], q(0))
            assert torch.equal(body[1, 0, :w, :, :cout], q(1))
            assert not torch.equal(q(0), q(1))


def _emulate(slab, rowmax_g, wq_dg, ws_in, x, s, t, res, dxout, lay, mode):
    """The card kernel on the slab: per chunk, per 128-row tile, per N tile
    of BN channels, per tap of the walk (read at shifts[taps - 1 - t]), per
    K box of 128 or 64 bytes, the A rows (row m copied from slab row m0 + m
    + shift, no masks) against the weights' box columns, in integers; then
    the tile's one scale, each live row's NHWC position (the pad column
    and the tail dropped), and the epilogue's 8-channel vectors: da =
    f32(acc) * f32(ws_in * sc) (entry: one fused multiply-add with dx_res),
    u = fma(x, s, t) (+ res), du, dx = bf16(du * s), dres = bf16(du); each
    thread's sums over its rows in order, the row groups in order, then
    the tiles in common::tile_sum's order (runs of slots, then the runs)."""
    sl = slab.numpy().astype(np.int64)
    cin = x.shape[-1]
    wt = nvt._pack_w_fwd(wq_dg, lay).numpy().astype(np.int64)
    amax = nvt.chunk_amax(rowmax_g, lay.rch, lay.halo).numpy()
    bn = nvt.dgrad_tile(cin)
    rs = THREADS // (bn // 8)   # the epilogue's row groups
    walk = lay.shifts[::-1]
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
    for k in range(lay.chunks):
        sc = np.float32(np.float32(amax[k]) * np.float32(nvt.INV_127))
        fac_all = (ws_in.numpy().astype(np.float32) * sc).astype(np.float32)
        for tile in range(lay.tiles):
            m0 = tile * lay.bm
            m = m0 + np.arange(lay.bm)
            if lay.halo:   # images innermost
                i, site = m % lay.n, m // lay.n
            else:
                i, site = m // (lay.rch * lay.w), m % (lay.rch * lay.w)
            r, c = site // lay.wq, site % lay.wq
            live = (r < lay.rch) & (c < lay.w) & (i < lay.n)
            pos = np.where(live, (i * lay.h + k * lay.rch + r) * lay.w + c, -1)
            sums = np.zeros((2, cin), dtype=np.float32)
            for n0 in range(0, cin, bn):
                cols = min(bn, cin - n0)
                acc = np.zeros((lay.bm, cols), dtype=np.int64)
                for ti, sh in enumerate(walk):
                    for o, wd in _boxes(lay.cp):
                        a = sl[k, m0 + sh:m0 + sh + lay.bm, o:o + wd]
                        assert a.shape == (lay.bm, wd)   # inside the slab
                        kc = ti * lay.cp + o
                        acc += a @ wt[n0:n0 + cols, kc:kc + wd].T
                assert np.abs(acc).max() < 2 ** 31   # an s32 accumulator
                af = acc.astype(np.float32)
                fac = fac_all[n0:n0 + cols]
                s1 = np.zeros((rs, cols), dtype=np.float32)
                s2 = np.zeros((rs, cols), dtype=np.float32)
                for ml in range(lay.bm):
                    p = pos[ml]
                    if p < 0:
                        continue
                    cs = slice(n0, n0 + cols)
                    if mode == "entry":   # one rounding of a*fac + dx_res
                        d = (af[ml].astype(np.float64) * fac
                             + of[p, cs]).astype(np.float32)
                    else:
                        d = (af[ml] * fac).astype(np.float32)
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
                for g in range(rs):   # the row groups in order
                    sums[0, n0:n0 + cols] += s1[g]
                    sums[1, n0:n0 + cols] += s2[g]
            part.append(sums.reshape(-1))
    # common::tile_sum: SUM_RUNS runs of consecutive slots, each in order,
    # then the runs in order
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


# (conv, mode, n, h, w, Cin, Cout, rch): planes of 7 x 6, 6 x 7, 6 x 5 and
# 5 x 5; n = 3 (tile tails, tiles across rows and images) and 32; Cout =
# 24 (the channel pad, one 64-byte box a tap), 128 (one 128-byte box) and
# 192 (a 128- and a 64-byte box); Cin = 40 (one 64-wide N tile, ragged)
# and 136 (two 128-wide N tiles, the second ragged); one chunk or several
# (h not equal to rch in four); every mode, the 3x3 in identity mode too
EMULATED = [("3x3", "affine", 3, 7, 6, 40, 24, 7),
            ("3x3", "identity", 32, 6, 7, 40, 24, 2),
            ("3x3", "affine", 3, 5, 5, 136, 128, 1),
            ("1x1", "entry", 3, 6, 5, 40, 24, 3),
            ("1x1", "identity", 32, 7, 6, 40, 24, 7),
            ("1x1", "affine", 3, 6, 7, 136, 192, 2)]


@pytest.mark.parametrize("conv,mode,n,h,w,cin,cout,rch", EMULATED)
def test_emulated_kernel_reproduces_plain_bit_for_bit(conv, mode, n, h, w,
                                                      cin, cout, rch):
    args = _args(np.random.default_rng(cin + cout + h), n, h, w, cin, cout,
                 conv, mode)
    taps = 9 if conv == "3x3" else 1
    lay = nvt.fwd_int8_layout(n, h, w, cout, taps, rch)
    kw = dict(conv=conv, mode=mode, rch=rch)
    want = nvt.dgrad_conv_plain(*args, **kw)
    assert want[0].shape == (n, h, w, cin)
    assert want[0].float().abs().max().item() > 0
    slab = nvt.dgrad_pre(*args[:5], conv=conv, rch=rch)
    _agree(_emulate(slab, *args[4:], lay, mode), want)
    # the vectorized plain version of the GEMM, and the CPU wrappers
    _agree(nvt.dgrad_gemm(slab, *args[4:], lay, mode=mode), want)
    _agree(nvt.dgrad_conv(*args, **kw), want)


@pytest.mark.parametrize("conv,mode", [("3x3", "affine"), ("1x1", "entry")])
def test_emulation_catches_a_wrong_tap_or_scale(conv, mode):
    """The emulation is sharp: the forward's shifts in place of their
    mirrors, or the scale of the neighbouring chunk, change dx."""
    n, h, w, cin, cout, rch = 3, 6, 5, 40, 24, 2
    args = _args(np.random.default_rng(5), n, h, w, cin, cout, conv, mode)
    taps = 9 if conv == "3x3" else 1
    lay = nvt.fwd_int8_layout(n, h, w, cout, taps, rch)
    slab = nvt.dgrad_pre(*args[:5], conv=conv, rch=rch)
    want = nvt.dgrad_conv_plain(*args, conv=conv, mode=mode, rch=rch)
    if conv == "3x3":
        unmirrored = lay._replace(shifts=lay.shifts[::-1])
        got = nvt.dgrad_gemm(slab, *args[4:], unmirrored, mode=mode)
        assert not torch.equal(got[0], want[0])
    rowmax = args[4].clone()
    rowmax[:rch] = rowmax[rch:2 * rch].amax()   # chunk 0 at chunk 1's scale
    got = nvt.dgrad_gemm(slab, rowmax, *args[5:], lay, mode=mode)
    assert not torch.equal(got[0], want[0])


def test_profile_kinds_count_the_new_kernels_as_the_nv_halves():
    """chip_smoke.py's kernel kinds by demangled name: the int8 dgrad's
    prepass, wgmma GEMM and tiles' sum are the NV training halves'; the
    fused int8 half keeps its own GEMM and sum."""
    import chip_smoke

    want = {
        "void nv_dgrad_wgmma_s8::nvt_dgrad_s8_kernel<128, 0>("
        "fwd_wgmma_s8::Maps, nv_dgrad_wgmma_s8::Args)":
        "nv train halves (port)",
        "void nv_dgrad_wgmma_s8::nvt_dgrad_s8_kernel<64, 64>("
        "fwd_wgmma_s8::Maps, nv_dgrad_wgmma_s8::Args)":
        "nv train halves (port)",
        "void (anonymous namespace)::nvt_fwd_pre_kernel<(anonymous "
        "namespace)::Cot>((anonymous namespace)::Cot, float const*, signed "
        "char*, (anonymous namespace)::FwdSlabGeo)": "nv train halves (port)",
        "void common::tile_sum_kernel<(anonymous namespace)::NvtDgradSum>("
        "float const*, float*, int, int)": "nv train halves (port)",
        "void dgrad_wgmma_s8::dgrad_s8_kernel<160, 32>(fwd_wgmma_s8::Maps, "
        "dgrad_wgmma_s8::Args, dgrad_wgmma_bf16::Epi)":
        "fused int8 half (port)",
        "void common::tile_sum_kernel<void>(float const*, float*, int, int)":
        "fused int8 half (port)",
    }
    for name, kind in want.items():
        assert chip_smoke.kernel_kind(name) == kind, name
