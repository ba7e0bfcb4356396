"""The staged int8 weight gradient of the NV training halves
(ops/cuda/bneck_nv_train.py ``wgrad_int8_layout``, ``wgrad_pre``,
``wgrad_int8_plan``, ``wgrad_gemm``; kernels in csrc/bneck_nv_train.cu and
csrc/wgrad_staged_s8.cuh), on the CPU:

- the slab layout puts every tap shift on a multiple of 16 bytes and keeps
  every shifted read of every K step inside the a slab, at every geometry
  the NV gate admits for ResNet-50 and WRN-50-2;
- the prepass's plain version writes each chunk's a (halo rows included)
  and g at the chunk's scale, a boundary row into both chunks at their two
  scales, and zeros at the pad columns, pad images, halo rows outside the
  image, guards and K tail;
- the plan cuts every chunk's K steps into non-empty splits that take each
  step once, and its tiles cover dW;
- an emulation of the card kernel on the slabs (chunk -> split -> K step
  of 128 positions -> each A row read at its tap's shift, no masks, s32
  tiles, the splits' sum scaled, the chunks added in order in f32)
  reproduces ``wgrad_plain`` bit for bit, as the vectorized
  ``wgrad_gemm_plain`` does.

JAX's interpret-mode int8 wgrad is held against ``wgrad`` in
tests/test_torch_bneck_nv_train.py. Inputs are made with numpy from a
seed.
"""

import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv_train as nvt
from test_torch_nv_wgrad_staged import MODELS, _gate_halves


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(
            torch.bfloat16)


def _operands(rng, n, h, w, cin, cout, mode):
    """The wgrad's inputs, each image row's activations scaled by its own
    factor so that neighbouring chunks get different scales."""
    rows = torch.from_numpy(
        np.exp(rng.standard_normal(h)).astype(np.float32))[None, :, None,
                                                            None]
    x = (_bf16(rng, n, h, w, cin).float() * rows).to(torch.bfloat16)
    o = dict(
        dy=(_bf16(rng, n, h, w, cout).float() * rows).to(torch.bfloat16),
        y=_bf16(rng, n, h, w, cout),
        dzsum=torch.from_numpy(rng.standard_normal(cout).astype(
            np.float32) * 0.1),
        dzssq=torch.from_numpy(rng.standard_normal(cout).astype(
            np.float32) * 0.01),
        x=x.abs() if mode == "identity" else x,
        s=(torch.from_numpy(rng.standard_normal(cin).astype(np.float32)
                            * 0.5 + 1.0) if mode != "identity" else None),
        t=(torch.from_numpy(rng.standard_normal(cin).astype(np.float32)
                            * 0.2) if mode != "identity" else None),
        res=_bf16(rng, n, h, w, cin) if mode == "entry" else None)
    o["rowmax_a"] = nvt.fwd_rowmax(o["x"], o["s"], o["t"], o["res"],
                                   mode=mode)[0]
    o["rowmax_g"] = nvt.bwd_rowmax(o["dy"], o["y"], o["dzsum"], o["dzssq"])
    return o


def _args(o):
    return (o["dy"], o["y"], o["dzsum"], o["dzssq"], o["rowmax_g"], o["x"],
            o["s"], o["t"], o["res"], o["rowmax_a"])


@pytest.mark.parametrize("model", sorted(MODELS))
def test_layout_shifts_are_16_byte_reads_inside_the_slab(model):
    halves = _gate_halves(model)
    assert len(halves) >= 40, len(halves)
    for n, h, w, _, _, taps, rch in halves:
        lay = nvt.wgrad_int8_layout(n, h, w, taps, rch)
        assert lay.n16 % 16 == 0 and n <= lay.n16 < n + 16
        assert lay.wq == w + 1 and lay.chunks == h // rch
        assert lay.k == rch * lay.wq * lay.n16
        assert lay.lg == lay.steps * lay.bk >= lay.k > lay.lg - lay.bk
        assert lay.la % 16 == 0 and lay.lg % 16 == 0
        assert len(lay.shifts) == taps
        assert all(sh % 16 == 0 for sh in lay.shifts), lay
        # K step kt reads a at [kt*bk + sh, (kt+1)*bk + sh) for each shift
        assert min(lay.shifts) >= 0
        assert max(lay.shifts) + lay.lg <= lay.la, lay
        if taps == 9:   # tap (1, 1) is the position itself, past the guard
            assert lay.shifts[4] == lay.guard + lay.wq * lay.n16
            assert lay.shifts[0] == 0 and lay.guard == lay.n16
        else:
            assert lay.la == lay.lg and lay.shifts == (0,)


def _expected_slab(v, inv, lay, halo):
    """The slab built element by element from its definition: int8 [K, C,
    row bytes], each inside entry q(v * inv_k) at (guard + (ra*wq + c)*n16
    + i), zero elsewhere."""
    n, h, w, c = v.shape
    vn = v.numpy()
    guard = lay.guard if halo else 0
    width = lay.la if halo else lay.lg
    out = np.zeros((lay.chunks, c, width), dtype=np.int8)
    for k in range(lay.chunks):
        inv_k = np.float32(inv[k].item())
        for ra in range(lay.rch + 2 * halo):
            row = k * lay.rch - halo + ra
            if not 0 <= row < h:
                continue
            for col in range(w):
                off = guard + (ra * lay.wq + col) * lay.n16
                q = np.clip(np.rint(vn[:, row, col, :].T * inv_k), -127, 127)
                out[k, :, off:off + n] = q.astype(np.int8)
    return torch.from_numpy(out)


@pytest.mark.parametrize("conv,mode", [("3x3", "affine"),
                                       ("3x3", "identity"),
                                       ("1x1", "entry")])
def test_prepass_plain_writes_each_chunk_at_its_scale(conv, mode):
    n, h, w, cin, cout, rch = 3, 6, 5, 16, 24, 2
    o = _operands(np.random.default_rng(3), n, h, w, cin, cout, mode)
    a_slab, g_slab = nvt.wgrad_pre(*_args(o), conv=conv, mode=mode,
                                   rch=rch)   # CPU: the plain version
    taps = 9 if conv == "3x3" else 1
    lay = nvt.wgrad_int8_layout(n, h, w, taps, rch)
    assert a_slab.dtype == g_slab.dtype == torch.int8
    assert a_slab.shape == (lay.chunks, cin, lay.la)
    assert g_slab.shape == (lay.chunks, cout, lay.lg)
    inv_a = nvt._quant_params(nvt.chunk_amax(o["rowmax_a"], rch,
                                             lay.halo))[0]
    inv_g = nvt._quant_params(nvt.chunk_amax(o["rowmax_g"], rch, 0))[0]
    a = nvt.prologue_plain(o["x"], o["s"], o["t"], o["res"], mode)
    g = nvt.fold_plain(o["dy"], o["y"], o["dzsum"], o["dzssq"])
    assert torch.equal(a_slab, _expected_slab(a, inv_a, lay, lay.halo))
    assert torch.equal(g_slab, _expected_slab(g, inv_g, lay, 0))
    # pad columns, pad images, guards and the K tail are zero
    body = a_slab[:, :, lay.guard:lay.guard + (rch + 2 * lay.halo)
                  * lay.wq * lay.n16].reshape(lay.chunks, cin, -1, lay.wq,
                                              lay.n16)
    assert not body[:, :, :, w].any() and not body[..., n:].any()
    assert not a_slab[:, :, :lay.guard].any()
    assert not g_slab[:, :, lay.k:].any()
    assert body[..., :n].any()
    if conv == "3x3":
        # image row 1 closes chunk 0 (slab row 2) and is chunk 1's upper
        # halo row (slab row 0), each at its chunk's scale; chunk 0's
        # upper halo row lies outside the image
        def q(k):
            return torch.clamp(torch.round(
                a[:, 1].permute(2, 1, 0) * inv_a[k]), -127, 127).to(
                    torch.int8)
        assert inv_a[0] != inv_a[1]
        assert torch.equal(body[0, :, 2, :w, :n], q(0))
        assert torch.equal(body[1, :, 0, :w, :n], q(1))
        assert not torch.equal(q(0), q(1))
        assert not body[0, :, 0].any()


@pytest.mark.parametrize("model", sorted(MODELS))
def test_plan_takes_every_k_step_once_and_covers_dw(model):
    for n, h, w, cin, cout, taps, rch in _gate_halves(model):
        lay = nvt.wgrad_int8_layout(n, h, w, taps, rch)
        p = nvt.wgrad_int8_plan(n, h, w, cin, cout, taps, rch)
        assert p.chunks == lay.chunks and p.steps == lay.steps
        assert p.bk == lay.bk == nvt.WGRAD_S8_BK
        assert len(p.ranges) == p.splits >= 1
        assert all(k0 < k1 for k0, k1 in p.ranges), p   # none empty
        assert p.ranges == tuple((z * p.per, min(p.steps, (z + 1) * p.per))
                                 for z in range(p.splits))
        taken = np.zeros(p.steps, dtype=int)
        for k0, k1 in p.ranges:
            taken[k0:k1] += 1
        assert (taken == 1).all(), p
        assert p.chunks * p.splits <= 65535   # grid z
        assert (p.m_tiles - 1) * p.bm < taps * cin <= p.m_tiles * p.bm
        assert (p.n_tiles - 1) * p.bn < cout <= p.n_tiles * p.bn
        assert p.bn == (128 if cout >= 128 else 64)


def _emulate(a_slab, g_slab, lay, plan, rowmax_a, rowmax_g):
    """The card kernel on the slabs: per chunk, per split, per K step of
    bk positions, the A tile [m_tiles*bm, bk] (row (tap, ci) copied from
    ci's slab row at its tap's shift, rows past taps*Cin zero) against the
    B tile [n_tiles*bn, bk], in integers; the splits' s32 tiles added,
    rounded to f32 and scaled by (amax_a * amax_g) * f32(1/127^2), the
    chunks added in order in f32."""
    a, g = a_slab.numpy().astype(np.int64), g_slab.numpy().astype(np.int64)
    cin, cout, bk = a.shape[1], g.shape[1], plan.bk
    m_rows = lay.taps * cin
    tap = np.arange(plan.m_tiles * plan.bm) // cin
    live = tap < lay.taps
    ci = np.where(live, np.arange(len(tap)) % cin, 0)
    shift = np.array(lay.shifts)[np.where(live, tap, 0)]
    amax_a = nvt.chunk_amax(rowmax_a, lay.rch, lay.halo).numpy()
    amax_g = nvt.chunk_amax(rowmax_g, lay.rch, 0).numpy()
    out = None
    for chunk in range(lay.chunks):
        s32 = np.zeros((m_rows, cout), dtype=np.int64)
        for kt0, kt1 in plan.ranges:
            tile = np.zeros((len(tap), plan.n_tiles * plan.bn),
                            dtype=np.int64)
            for kt in range(kt0, kt1):
                cols = kt * bk + np.arange(bk)
                at = a[chunk, ci[:, None], shift[:, None] + cols[None, :]]
                at[~live] = 0
                bt = np.zeros((tile.shape[1], bk), dtype=np.int64)
                bt[:cout] = g[chunk][:, cols]
                tile += at @ bt.T
            assert np.abs(tile).max() < 2 ** 31   # an s32 accumulator
            s32 += tile[:m_rows, :cout]
        ts = np.float32(np.float32(amax_a[chunk]) * np.float32(
            amax_g[chunk])) * np.float32(nvt.INV_127_SQ)
        part = s32.astype(np.float32) * np.float32(ts)
        out = part if out is None else out + part
    return torch.from_numpy(out)


# (conv, mode, n, h, w, Cin, Cout, rch, per): Cin = 64 3x3 halves (128-row
# tiles straddling two taps) with Cout < the 64-wide tile; n = 2, 3 and 20
# padded to 16 and 32 images; one chunk or several, in the plan's splits or
# one K step a split; a 1x1 on a 64-row tile with Cout = 136 (two 128-wide
# tiles, the second ragged) and seven one-step chunks; Cout = 64 on a
# 64-wide tile; planes of 7 x 6, 6 x 7, 7 x 7 and 6 x 6 whose K steps cross
# rows and images
EMULATED = [("3x3", "affine", 3, 7, 6, 64, 24, 7, None),
            ("3x3", "identity", 20, 6, 7, 64, 16, 2, 1),
            ("1x1", "entry", 2, 7, 7, 64, 136, 1, None),
            ("1x1", "affine", 20, 6, 6, 24, 64, 3, 1)]


@pytest.mark.parametrize("conv,mode,n,h,w,cin,cout,rch,per", EMULATED)
def test_emulated_kernel_reproduces_plain_bit_for_bit(conv, mode, n, h, w,
                                                      cin, cout, rch, per):
    o = _operands(np.random.default_rng(cin + cout + h), n, h, w, cin, cout,
                  mode)
    taps = 9 if conv == "3x3" else 1
    lay = nvt.wgrad_int8_layout(n, h, w, taps, rch)
    plan = nvt.wgrad_int8_plan(n, h, w, cin, cout, taps, rch)
    if per is not None:
        splits = -(-plan.steps // per)
        plan = plan._replace(per=per, splits=splits, ranges=tuple(
            (z * per, min(plan.steps, (z + 1) * per))
            for z in range(splits)))
        assert plan.splits > 1
    assert plan.steps > 1 or plan.chunks > 1
    if conv == "3x3":   # tiles straddle taps: 64 channels, 128-row tiles
        assert plan.bm == 128 and cin % plan.bm != 0
    slabs = nvt.wgrad_pre(*_args(o), conv=conv, mode=mode, rch=rch)
    want = nvt.wgrad(*_args(o), conv=conv, mode=mode, rch=rch)
    got = _emulate(*slabs, lay, plan, o["rowmax_a"], o["rowmax_g"])
    assert got.shape == want.shape == (taps * cin, cout)
    assert torch.equal(got, want)
    assert torch.equal(nvt.wgrad_gemm(*slabs, o["rowmax_a"], o["rowmax_g"],
                                      lay), want)
    assert want.abs().max().item() > 0
