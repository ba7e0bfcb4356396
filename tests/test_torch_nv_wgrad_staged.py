"""The staged bf16 weight gradient of the NV training halves
(ops/cuda/bneck_nv_train.py ``wgrad_bf16_pre``, ``wgrad_bf16_plan``,
``wgrad_bf16_gemm``; kernels in csrc/bneck_nv_train.cu and
csrc/wgrad_staged.cuh), on the CPU:

- the prepass's plain version rounds the prologue and the fold once to
  bf16, bit for bit as ``prologue_plain`` and ``fold_plain`` do;
- the plan cuts every chunk's K steps into non-empty splits that take each
  step once, and its tiles cover dW, at every geometry the NV gate admits
  for ResNet-50 and WRN-50-2;
- a float64 emulation of the card kernel's partition (chunk -> split -> K
  step of 64 positions -> each 8-channel piece of an A row at its own tap
  shift, zero outside the image and past the chunk) with f32 split tiles
  added in split order, then chunks in order, reproduces
  ``wgrad_bf16_plain`` within f32 rounding: 2e-6 of dW's largest value
  (the plain version rounds each chunk's float64 sum to f32 once, the
  emulation each split's, then adds a few f32 values).

JAX's interpret-mode bf16 wgrad is held against ``wgrad_bf16`` in
tests/test_torch_bneck_nv_train_bf16.py. Inputs are made with numpy from a
seed.
"""

import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv_train as nvt


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(
            torch.bfloat16)


def _operands(rng, n, h, w, cin, cout, mode):
    x = _bf16(rng, n, h, w, cin)
    return dict(
        dy=_bf16(rng, n, h, w, cout), y=_bf16(rng, n, h, w, cout),
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


@pytest.mark.parametrize("mode", nvt.MODES)
def test_prepass_plain_rounds_prologue_and_fold_once(mode):
    o = _operands(np.random.default_rng(1), 2, 5, 6, 16, 24, mode)
    args = (o["dy"], o["y"], o["dzsum"], o["dzssq"], o["x"], o["s"],
            o["t"], o["res"])
    a_b, g_b = nvt.wgrad_bf16_pre(*args, mode=mode)   # CPU: the plain one
    assert a_b.dtype == g_b.dtype == torch.bfloat16
    assert torch.equal(a_b, nvt.prologue_plain(
        o["x"], o["s"], o["t"], o["res"], mode).to(torch.bfloat16))
    assert torch.equal(g_b, nvt.fold_plain(
        o["dy"], o["y"], o["dzsum"], o["dzssq"]).to(torch.bfloat16))
    if mode == "identity":   # a is x itself: no copy
        assert a_b is o["x"]
    assert torch.equal(
        nvt.wgrad_bf16(*args, conv="1x1", mode=mode, rch=5),
        nvt.wgrad_bf16_gemm(a_b, g_b, conv="1x1", rch=5))


# (h, w, Cin, bottleneck width, Cout) of the identity blocks, by stage
MODELS = {
    "resnet-50": [(56, 256, 64, 256), (28, 512, 128, 512),
                  (14, 1024, 256, 1024), (7, 2048, 512, 2048)],
    "wrn-50-2": [(56, 256, 128, 256), (28, 512, 256, 512),
                 (14, 1024, 512, 1024), (7, 2048, 1024, 2048)],
}


def _gate_halves(model):
    """(n, h, w, Cin, Cout, taps, wgrad row chunk) of every half of every
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
                rch = nvt.pick_chunk_rows(h, h, n, ci, co, conv, mode)[2]
                out.append((n, h, h, ci, co, 9 if conv == "3x3" else 1,
                            rch))
    return out


@pytest.mark.parametrize("model", sorted(MODELS))
def test_plan_takes_every_k_step_of_every_chunk_once(model):
    halves = _gate_halves(model)
    assert len(halves) >= 40, len(halves)   # stage 4 only at batch <= 64
    for n, h, w, cin, cout, taps, rch in halves:
        p = nvt.wgrad_bf16_plan(n, h, w, cin, cout, taps, rch)
        assert p.chunks == h // rch and p.steps == -(-n * rch * w // p.bk)
        assert len(p.ranges) == p.splits >= 1
        assert all(k0 < k1 for k0, k1 in p.ranges), p   # none empty
        # the kernel's own cut: split z takes [z*per, min(steps, (z+1)*per))
        assert p.ranges == tuple((z * p.per, min(p.steps, (z + 1) * p.per))
                                 for z in range(p.splits))
        taken = np.zeros(p.steps, dtype=int)
        for k0, k1 in p.ranges:
            taken[k0:k1] += 1
        assert (taken == 1).all(), p
        assert p.chunks * p.splits <= 65535   # grid z


@pytest.mark.parametrize("model", sorted(MODELS))
def test_plan_tiles_cover_dw(model):
    for n, h, w, cin, cout, taps, rch in _gate_halves(model):
        p = nvt.wgrad_bf16_plan(n, h, w, cin, cout, taps, rch)
        assert p.bm in (64, 128) and p.bn in (64, 128)
        # every row (tap, ci) and column of dW in exactly one tile
        assert (p.m_tiles - 1) * p.bm < taps * cin <= p.m_tiles * p.bm
        assert (p.n_tiles - 1) * p.bn < cout <= p.n_tiles * p.bn
        # a 128-wide N tile wherever Cout >= 128: A is read ceil(Cout/128)
        # times
        assert p.bn == (128 if cout >= 128 else 64)


def _emulate(a_b, g_b, taps, rch, plan):
    """The card kernel's partition in float64: per chunk, per split, per K
    step of bk positions, the A tile [bk, m_tiles*bm] built piece by piece
    (8 channels, each at its own tap) and the B tile [bk, n_tiles*bn],
    zero outside the image and past the chunk; each split's tile rounded
    to f32, the splits then the chunks added in order in f32."""
    bk = plan.bk
    a, g = a_b.double().numpy(), g_b.double().numpy()
    n, h, w, cin = a.shape
    cout = g.shape[-1]
    m_rows, total = taps * cin, n * rch * w
    out = None
    for chunk in range(plan.chunks):
        csum = None
        for kt0, kt1 in plan.ranges:
            tile = np.zeros((plan.m_tiles * plan.bm, plan.n_tiles * plan.bn))
            for kt in range(kt0, kt1):
                at = np.zeros((bk, tile.shape[0]))
                bt = np.zeros((bk, tile.shape[1]))
                for kr in range(bk):
                    kk = kt * bk + kr
                    if kk >= total:
                        continue
                    img, rem = divmod(kk, rch * w)
                    r, c = divmod(rem, w)
                    ry = chunk * rch + r
                    bt[kr, :cout] = g[img, ry, c]
                    for m in range(0, m_rows, 8):
                        tap, ci = divmod(m, cin)
                        dy, dx = ((tap // 3 - 1, tap % 3 - 1) if taps == 9
                                  else (0, 0))
                        iy, ix = ry + dy, c + dx
                        if 0 <= iy < h and 0 <= ix < w:
                            at[kr, m:m + 8] = a[img, iy, ix, ci:ci + 8]
                tile += at.T @ bt
            split = tile[:m_rows, :cout].astype(np.float32)
            csum = split if csum is None else csum + split
        out = csum if out is None else out + csum
    return torch.from_numpy(out)


def _forced(plan, per):
    """The plan with ``per`` K steps a split (more splits than it picks at
    these small shapes)."""
    splits = -(-plan.steps // per)
    return plan._replace(per=per, splits=splits, ranges=tuple(
        (z * per, min(plan.steps, (z + 1) * per)) for z in range(splits)))


# (conv, n, h, w, Cin, Cout, rch, per): Cin = 64 3x3 halves (128-row
# tiles straddling two taps) with Cout < the 64-wide tile; one chunk of
# three K steps of 64 positions in the plan's splits or one split a step,
# or seven chunks of one step; a 1x1 on a 64-row tile with Cout = 136 (two
# 128-wide tiles, the second ragged); planes of 7 x 6 and 6 x 7 whose K
# steps cross rows and images
EMULATED = [("3x3", 3, 7, 7, 64, 24, 7, None),
            ("3x3", 3, 6, 7, 64, 16, 6, 1),
            ("3x3", 3, 7, 6, 64, 40, 1, None),
            ("1x1", 2, 7, 6, 64, 136, 7, 1)]


@pytest.mark.parametrize("conv,n,h,w,cin,cout,rch,per", EMULATED)
def test_emulated_partition_reproduces_plain(conv, n, h, w, cin, cout, rch,
                                             per):
    rng = np.random.default_rng(cin + cout + h)
    a_b, g_b = _bf16(rng, n, h, w, cin), _bf16(rng, n, h, w, cout)
    taps = 9 if conv == "3x3" else 1
    plan = nvt.wgrad_bf16_plan(n, h, w, cin, cout, taps, rch)
    if per is not None:
        plan = _forced(plan, per)
        assert plan.splits > 1
    assert plan.steps > 1 or plan.chunks > 1
    if conv == "3x3":   # tiles straddle taps: 64 channels, 128-row tiles
        assert plan.bm == 128 and cin % plan.bm != 0
    assert cout < plan.bn or cout % plan.bn
    got = _emulate(a_b, g_b, taps, rch, plan)
    want = nvt.wgrad_bf16_gemm_plain(a_b, g_b, conv=conv, rch=rch)
    assert got.shape == want.shape == (taps * cin, cout)
    top = want.abs().max().item()
    assert (got - want).abs().max().item() <= 2e-6 * top
    # the emulation is not blind to the shift: the unshifted 3x3 differs
    if conv == "3x3":
        flat = nvt.wgrad_bf16_gemm_plain(a_b, g_b, conv="1x1", rch=rch)
        assert (got[4 * cin:5 * cin] - flat).abs().max().item() <= 2e-6 * top
        assert (got[:cin] - flat).abs().max().item() > 0.1 * top
