"""The staged int8 forward of the NV training halves
(ops/cuda/bneck_nv_train.py ``fwd_int8_layout``, ``fwd_pre``, ``fwd_gemm``;
kernels in csrc/bneck_nv_train.cu and csrc/fwd_staged_s8.cuh), on the CPU:

- the slab layout puts every A row of every tap on a 16-byte boundary,
  keeps every shifted read of every M tile inside the slab and every M tile
  inside one chunk, at every geometry the NV gate admits for ResNet-50 and
  WRN-50-2;
- the prepass's plain version writes each chunk's activation (halo rows
  included) at the chunk's scale, a 3x3 boundary row into both chunks at
  their two scales, and zeros at the pad column, pad channels, guards, halo
  rows outside the image and tile tail;
- an emulation of the card kernel on the slab (chunk -> 128-row tile ->
  tap -> K step of bk bytes, each A row read at its tap's shift with no
  masks, s32 accumulators, the pad column and tail dropped, one scale a
  tile) reproduces ``fwd_conv_plain``'s y bit for bit and its sums within
  1e-5, as the vectorized ``fwd_gemm_plain`` does.

JAX's interpret-mode int8 forward is held against ``fwd_conv`` in
tests/test_torch_bneck_nv_train.py. Inputs are made with numpy from a
seed.
"""

import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv_train as nvt
from test_torch_nv_wgrad_staged import MODELS


def _fwd_halves(model):
    """(n, h, w, Cin, taps, forward row chunk) of every half of every
    identity block the NV gate admits, batches 32 to 128."""
    out = []
    for h, cin, cb, cout in MODELS[model]:
        for n in (32, 64, 128):
            if not nvt.nv_train_fits(h, h, n, cin, cb, cout):
                continue
            for conv, mode, ci, co in (("1x1", "identity", cin, cb),
                                       ("1x1", "entry", cin, cb),
                                       ("3x3", "affine", cb, cb),
                                       ("1x1", "affine", cb, cout)):
                rch = nvt.pick_chunk_rows(h, h, n, ci, co, conv, mode)[0]
                out.append((n, h, h, ci, 9 if conv == "3x3" else 1, rch))
    return out


@pytest.mark.parametrize("model", sorted(MODELS))
def test_layout_reads_are_aligned_inside_the_slab_and_tiles_in_a_chunk(
        model):
    halves = _fwd_halves(model)
    assert len(halves) >= 40, len(halves)
    for n, h, w, cin, taps, rch in halves:
        lay = nvt.fwd_int8_layout(n, h, w, cin, taps, rch)
        assert lay.cp % 16 == 0 and lay.cp % lay.bk == 0
        assert cin <= lay.cp < cin + 64
        assert lay.chunks == h // rch and lay.bm == nvt.FWD_BM
        assert lay.m_valid == rch * lay.wq * n
        # whole tiles per chunk: tile t of chunk k is rows [t*bm, (t+1)*bm)
        # of chunk k's M, so it lies in that chunk and has its one scale
        assert (lay.tiles - 1) * lay.bm < lay.m_valid <= lay.tiles * lay.bm
        assert len(lay.shifts) == taps
        # every A row m of every tap reads slab position m + shift, cp bytes
        # at a multiple of 16: inside the slab for every m of every tile
        assert all(sh * lay.cp % 16 == 0 for sh in lay.shifts)
        assert min(lay.shifts) >= 0
        assert max(lay.shifts) + lay.tiles * lay.bm <= lay.slab_len, lay
        if taps == 9:   # tap (1, 1) is the position itself, past the guard
            assert lay.wq == w + 1 and lay.guard == n and lay.halo == 1
            assert lay.shifts[4] == lay.guard + lay.wq * n
            assert lay.shifts[0] == 0
            assert (max(lay.shifts) + lay.tiles * lay.bm == lay.slab_len)
        else:
            assert lay.wq == w and lay.guard == 0 and lay.shifts == (0,)
            assert lay.slab_len == lay.tiles * lay.bm
        # the grid's M tiles
        assert lay.chunks * lay.tiles <= 65535


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(
            torch.bfloat16)


def _operands(rng, n, h, w, cin, cout, conv, mode):
    """A half's forward inputs, each image row's activations scaled by its
    own factor so that neighbouring chunks get different scales."""
    rows = torch.from_numpy(
        np.exp(rng.standard_normal(h)).astype(np.float32))[None, :, None,
                                                            None]
    x = (_bf16(rng, n, h, w, cin).float() * rows).to(torch.bfloat16)
    k = 3 if conv == "3x3" else 1
    wt = torch.from_numpy(rng.standard_normal((cout, cin, k, k)).astype(
        np.float32))
    wq, ws = (nvt.quantize_w_3x3 if k == 3 else nvt.quantize_w_1x1)(wt)
    o = dict(
        x=x.abs() if mode == "identity" else x,
        s=(torch.from_numpy(rng.standard_normal(cin).astype(np.float32)
                            * 0.5 + 1.0) if mode != "identity" else None),
        t=(torch.from_numpy(rng.standard_normal(cin).astype(np.float32)
                            * 0.2) if mode != "identity" else None),
        res=(_bf16(rng, n, h, w, cin) * rows).to(torch.bfloat16)
        if mode == "entry" else None)
    o["rowmax"] = nvt.fwd_rowmax(o["x"], o["s"], o["t"], o["res"],
                                 mode=mode)[0]
    return o, wq, ws


def _args(o):
    return o["x"], o["s"], o["t"], o["res"], o["rowmax"]


def _expected_slab(a, inv, lay):
    """The slab built element by element from its definition: int8 [K,
    slab_len, cp], q(a * inv_k) of image row k*rch - halo + ra, column col
    and image i at position guard + (ra*wq + col)*n + i (3x3) or (i*rch +
    ra)*w + col (1x1), channels < Cin; zero elsewhere."""
    n, h, w, cin = a.shape
    an = a.numpy()
    out = np.zeros((lay.chunks, lay.slab_len, lay.cp), dtype=np.int8)
    for k in range(lay.chunks):
        inv_k = np.float32(inv[k].item())
        for ra in range(lay.rch + 2 * lay.halo):
            row = k * lay.rch - lay.halo + ra
            if not 0 <= row < h:
                continue
            for col in range(w):
                q = np.clip(np.rint(an[:, row, col, :] * inv_k), -127, 127)
                if lay.halo:
                    p = lay.guard + (ra * lay.wq + col) * n
                    out[k, p:p + n, :cin] = q.astype(np.int8)
                else:
                    p = np.arange(n) * lay.rch * w + ra * w + col
                    out[k, p, :cin] = q.astype(np.int8)
    return torch.from_numpy(out)


@pytest.mark.parametrize("conv,mode", [("3x3", "affine"),
                                       ("3x3", "identity"),
                                       ("1x1", "entry")])
def test_prepass_plain_writes_each_chunk_at_its_scale(conv, mode):
    n, h, w, cin, rch = 3, 6, 5, 40, 2
    o, _, _ = _operands(np.random.default_rng(3), n, h, w, cin, 24, conv,
                        mode)
    slab = nvt.fwd_pre(*_args(o), conv=conv, mode=mode, rch=rch)  # plain
    taps = 9 if conv == "3x3" else 1
    lay = nvt.fwd_int8_layout(n, h, w, cin, taps, rch)
    assert slab.dtype == torch.int8
    assert slab.shape == (lay.chunks, lay.slab_len, lay.cp) == (3, *(
        (2 * n + 4 * 6 * n + 128 - 2 * 6 * n, 64) if taps == 9 else
        (128, 64)))
    inv = nvt._quant_params(nvt.chunk_amax(o["rowmax"], rch, lay.halo))[0]
    a = nvt.prologue_plain(o["x"], o["s"], o["t"], o["res"], mode)
    assert torch.equal(slab, _expected_slab(a, inv, lay))
    # the pad channels, the guards and the tile tail are zero
    span = (rch + 2 * lay.halo) * lay.wq * n
    body = slab[:, lay.guard:lay.guard + span]
    body = (body.reshape(lay.chunks, rch + 2, lay.wq, n, lay.cp)
            if lay.halo else body.reshape(lay.chunks, n, rch, w, lay.cp))
    assert not slab[..., cin:].any()
    assert not slab[:, :lay.guard].any()
    assert not slab[:, lay.guard + span:].any()
    assert body[..., :cin].any()
    if conv == "3x3":
        assert not body[:, :, w].any()   # the pad column
        # image row 1 closes chunk 0 (slab row 2) and is chunk 1's upper
        # halo row (slab row 0), each at its chunk's scale; chunk 0's upper
        # halo row and chunk 2's lower one lie outside the image
        def q(k):
            return torch.clamp(torch.round(
                a[:, 1].permute(1, 0, 2) * inv[k]), -127, 127).to(
                    torch.int8)
        assert inv[0] != inv[1]
        assert torch.equal(body[0, 2, :w, :, :cin], q(0))
        assert torch.equal(body[1, 0, :w, :, :cin], q(1))
        assert not torch.equal(q(0), q(1))
        assert not body[0, 0].any() and not body[2, -1].any()
    if mode == "entry":
        # quantized from the f32 activation, not from x_res = bf16(a)
        x_res = nvt.fwd_rowmax(o["x"], o["s"], o["t"], o["res"],
                               mode=mode)[1]
        assert torch.equal(slab, nvt.fwd_pre(*_args(o), conv=conv,
                                             mode=mode, rch=rch))
        assert not torch.equal(slab, _expected_slab(x_res.float(), inv,
                                                    lay))


def _emulate(slab, rowmax, wq, ws, lay):
    """The card kernel on the slab: per chunk, per 128-row tile, per tap,
    per K step of bk bytes, the A tile (row m copied from slab position
    m0 + m + shift[tap], no masks) against the weights' K columns, in
    integers; then rows with c >= w and the tail dropped, y = bf16(f32(acc)
    * f32(ws * sc)) with the tile's one scale sc = amax * f32(1/127), and
    each tile's column sums of f32(y) and y^2 in row order, the tiles added
    in order."""
    s = slab.numpy().astype(np.int64)
    cout = wq.shape[0]
    wt = np.zeros((cout, lay.taps, lay.cp), dtype=np.int64)
    wt[:, :, :lay.cin] = wq.numpy().reshape(cout, lay.taps, lay.cin)
    wt = wt.reshape(cout, -1)
    amax = nvt.chunk_amax(rowmax, lay.rch, lay.halo).numpy()
    wsn = ws.numpy().astype(np.float32)
    y = np.zeros((lay.n, lay.h, lay.w, cout), dtype=np.float32)
    sums = np.zeros((2, cout), dtype=np.float32)
    for k in range(lay.chunks):
        fac = wsn * np.float32(np.float32(amax[k]) * np.float32(nvt.INV_127))
        for t in range(lay.tiles):
            m0 = t * lay.bm
            acc = np.zeros((lay.bm, cout), dtype=np.int64)
            for tap, sh in enumerate(lay.shifts):
                for c0 in range(0, lay.cp, lay.bk):
                    a = s[k, m0 + sh:m0 + sh + lay.bm, c0:c0 + lay.bk]
                    assert a.shape == (lay.bm, lay.bk)   # inside the slab
                    kc = tap * lay.cp + c0
                    acc += a @ wt[:, kc:kc + lay.bk].T
            assert np.abs(acc).max() < 2 ** 31   # an s32 accumulator
            m = m0 + np.arange(lay.bm)
            if lay.halo:   # images innermost
                i, site = m % lay.n, m // lay.n
            else:
                i, site = m // (lay.rch * lay.w), m % (lay.rch * lay.w)
            r, c = site // lay.wq, site % lay.wq
            live = (r < lay.rch) & (c < lay.w) & (i < lay.n)
            yt = torch.from_numpy(acc[live].astype(np.float32) * fac).to(
                torch.bfloat16).float().numpy()
            y[i[live], k * lay.rch + r[live], c[live]] = yt
            sums[0] += yt.sum(0, dtype=np.float32)
            sums[1] += (yt * yt).sum(0, dtype=np.float32)
    return torch.from_numpy(y).to(torch.bfloat16), torch.from_numpy(sums)


def _close(got, want, rel=1e-5):
    assert (got.double() - want.double()).abs().max().item() <= \
        rel * want.double().abs().max().item()


# (conv, mode, n, h, w, Cin, Cout, rch): planes of 7 x 6, 6 x 7 and 5 x 5,
# n = 3 (tile tails, tiles across rows and images) and 32, Cin = 40 (the
# channel pad; K steps of 64 bytes) and 128 (K steps of 128 bytes), Cout =
# 24 (below the 64-wide tile) and 136 (two 128-wide tiles, the second
# ragged), one chunk or several, every mode, the 3x3 in identity mode too
EMULATED = [("3x3", "affine", 3, 7, 6, 40, 24, 7),
            ("3x3", "identity", 32, 6, 7, 40, 24, 2),
            ("3x3", "affine", 3, 5, 5, 128, 136, 1),
            ("1x1", "entry", 3, 5, 5, 40, 24, 1),
            ("1x1", "identity", 32, 7, 6, 40, 24, 7),
            ("1x1", "affine", 3, 6, 7, 128, 136, 3)]


@pytest.mark.parametrize("conv,mode,n,h,w,cin,cout,rch", EMULATED)
def test_emulated_kernel_reproduces_plain_bit_for_bit(conv, mode, n, h, w,
                                                      cin, cout, rch):
    o, wq, ws = _operands(np.random.default_rng(cin + cout + h), n, h, w,
                          cin, cout, conv, mode)
    taps = 9 if conv == "3x3" else 1
    lay = nvt.fwd_int8_layout(n, h, w, cin, taps, rch)
    assert lay.bk == (128 if cin == 128 else 64)
    kw = dict(conv=conv, mode=mode, rch=rch)
    want = nvt.fwd_conv_plain(*_args(o), wq, ws, **kw)
    slab = nvt.fwd_pre(*_args(o), **kw)
    y, sums = _emulate(slab, o["rowmax"], wq, ws, lay)
    assert y.shape == want[0].shape == (n, h, w, cout)
    assert torch.equal(y, want[0])
    _close(sums[0], want[1])
    _close(sums[1], want[2])
    assert want[0].float().abs().max().item() > 0
    # the vectorized plain version of the mainloop, and the CPU wrapper
    got = nvt.fwd_gemm(slab, o["rowmax"], wq, ws, lay)
    assert torch.equal(got[0], want[0])
    _close(got[1], want[1])
    _close(got[2], want[2])
    for a, b in zip(nvt.fwd_conv(*_args(o), wq, ws, **kw), want):
        assert torch.equal(a, b)
