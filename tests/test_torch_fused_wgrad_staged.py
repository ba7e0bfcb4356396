"""The staged weight gradient of the fused bf16 block-half
(ops/cuda/fused_block.py ``wgrad_bf16_pre``, ``wgrad_bf16_gemm``; kernels in
csrc/fused_block_bf16.cu and csrc/wgrad_staged.cuh), on the CPU:

- the prepass's plain version rounds the prologue and the fold once to
  bf16, bit for bit as ``prologue_bf16_plain`` and ``fold_cotangent_plain``
  do, and writes them position-major (transposed), in every dropout mode,
  with and without the stats cotangents;
- the plan (``bneck_nv_train.wgrad_bf16_plan`` with one chunk of h rows and
  nine taps) takes every K step once and its tiles cover dW at the three
  WRN-28-10 stage shapes and at C = 48 padded to 64; its N tile is 128
  wide wherever Cout > 64 (timed on the card against 64 at Cout = 160 and
  320, where 128 pads more columns and still ran faster);
- every NV plan (bf16 and int8) at every geometry the NV gate admits for
  ResNet-50 and WRN-50-2 is the plan of the NV halves' own tile rule;
- a float64 emulation of the card's partition (one chunk -> split -> K
  step of 64 positions -> each 8-channel piece of an A row at its own tap
  shift, zero outside the image), with f32 split tiles added in order,
  reproduces ``wgrad_bf16_plain`` within 2e-6 of dW's largest value, at
  geometries the old kernel refused (12 x 12 images, rows of 40 and of 7).

The whole half is held against JAX (interpret mode) by
tests/test_torch_fused_half_bf16.py. Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv_train as nvt
from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
from pytorch_ddp_resnet_tpu_torch.ops.cuda.wgrad_plan import split_plan
from test_torch_nv_wgrad_staged import MODELS, _emulate, _forced, _gate_halves


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _operands(seed, cin, cout, n, mode, stats):
    """(dy, y, dysum, dyssq, x, scale, shift, bits) and thresh of one half's
    backward: bits a [Cin, N] uint8 tensor, a 0-d int32 seed or none."""
    rng = np.random.default_rng(seed)
    x = _t(rng.standard_normal((cin, n)), torch.bfloat16)
    dy = _t(rng.standard_normal((cout, n)) * 1e-3, torch.bfloat16)
    y = _t(rng.standard_normal((cout, n)), torch.bfloat16)
    dysum = _t(rng.standard_normal(cout) * 1e-4)
    dyssq = _t(rng.standard_normal(cout) * 1e-4)
    scale = _t(rng.random(cin) + 0.5)
    shift = _t(rng.standard_normal(cin) * 0.3)
    bits = {"none": None,
            "bits": torch.from_numpy(rng.integers(0, 256, (cin, n),
                                                  dtype=np.uint8)),
            "seed": torch.tensor(-2 ** 31 + 17, dtype=torch.int32)}[mode]
    thresh = None if bits is None else fb.dropout_thresh(0.3)
    cts = (y, dysum, dyssq) if stats else (None, None, None)
    return (dy, *cts, x, scale, shift, bits), thresh


@pytest.mark.parametrize("mode", ["none", "bits", "seed"])
@pytest.mark.parametrize("stats", [True, False])
def test_prepass_plain_rounds_prologue_and_fold_once(mode, stats):
    args, thresh = _operands(3, 16, 24, 2 * 5 * 6, mode, stats)
    dy, y, dysum, dyssq, x, scale, shift, bits = args
    d_b, g_b = fb.wgrad_bf16_pre(*args, thresh=thresh)   # CPU: the plain one
    assert d_b.dtype == g_b.dtype == torch.bfloat16
    assert d_b.is_contiguous() and g_b.is_contiguous()
    assert torch.equal(d_b, fb.prologue_bf16_plain(x, scale, shift, bits,
                                                   thresh).T)
    g = (dy if not stats else
         fb.fold_cotangent_plain(dy, y, dysum, dyssq).to(torch.bfloat16))
    assert torch.equal(g_b, g.T)
    if mode != "none":   # the mask is applied: it zeroes more values
        undropped = fb.prologue_bf16_plain(x, scale, shift, None, None)
        assert (d_b == 0).sum() > (undropped == 0).sum()
    # the two parts compose to the whole function, transposed
    want = fb.wgrad_bf16_plain(*args, thresh=thresh, h=5, w_img=6)
    got = fb.wgrad_bf16_gemm(d_b, g_b, h=5, w_img=6)
    assert got.shape == (9 * 16, 24)
    assert (got.T - want).abs().max().item() <= 1e-6 * want.abs().max().item()


# (C, H, W) of WRN-28-10's stages at batch 128, and C = 48 zero-padded to 64
# at 32 x 32 (the fused gate's C % 16 case)
FUSED_SHAPES = [(160, 32, 32), (320, 16, 16), (640, 8, 8), (64, 32, 32)]


@pytest.mark.parametrize("c,h,w", FUSED_SHAPES)
def test_plan_takes_every_k_step_once_and_covers_dw(c, h, w):
    n = 128
    p = nvt.wgrad_bf16_plan(n, h, w, c, c, 9, h)
    assert p.chunks == 1 and p.bk == nvt.WGRAD_BK
    assert p.steps == -(-n * h * w // p.bk)
    assert len(p.ranges) == p.splits >= 1
    assert p.ranges == tuple((z * p.per, min(p.steps, (z + 1) * p.per))
                             for z in range(p.splits))
    taken = np.zeros(p.steps, dtype=int)
    for k0, k1 in p.ranges:
        assert k0 < k1, p   # none empty
        taken[k0:k1] += 1
    assert (taken == 1).all(), p
    assert p.splits <= 65535   # grid z
    # every row (tap, ci) and column of dW in exactly one tile
    assert p.bm == 128 and p.bn in (64, 128)
    assert (p.m_tiles - 1) * p.bm < 9 * c <= p.m_tiles * p.bm
    assert (p.n_tiles - 1) * p.bn < c <= p.n_tiles * p.bn
    # 128 wide wherever Cout > 64: at 160 and 320 it pads to 256 and 384
    # columns, and still ran faster on the card than 64 wide (192, 320)
    assert p.bn == (64 if c <= 64 else 128)


def _nv_rule_plan(plan, m, cout):
    """``plan`` re-made with the NV halves' N tile forced (64 where Cout <=
    64, else 128): the tile the staged NV kernels were tuned on."""
    return split_plan(m, cout, plan.chunks, plan.steps, plan.bk,
                      bn=64 if cout <= 64 else 128)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_nv_plans_are_unchanged_by_the_tile_rule(model):
    """The fused wgrad's N tile was timed at 64 and 128 (the width choice
    ``split_plan`` takes now); every NV plan, bf16 and int8, is still the
    plan of the NV halves' own rule."""
    halves = _gate_halves(model)
    assert len(halves) >= 40, len(halves)
    for n, h, w, cin, cout, taps, rch in halves:
        for plan_of in (nvt.wgrad_bf16_plan, nvt.wgrad_int8_plan):
            p = plan_of(n, h, w, cin, cout, taps, rch)
            assert p == _nv_rule_plan(p, taps * cin, cout), (plan_of, p)


def _emulate_fused(d_b, g_b, b, h, w, plan):
    """The card's partition of the fused wgrad: the NV bf16 wgrad's
    emulation, with the position-major operands as NHWC images and the
    whole image one chunk."""
    cin, cout = d_b.shape[1], g_b.shape[1]
    return _emulate(d_b.reshape(b, h, w, cin), g_b.reshape(b, h, w, cout),
                    9, h, plan)


# (b, h, w, Cin, Cout, mode, per): 12 x 12 images (rows not a multiple of
# 8); rows of 40 (wider than 32) with forced splits of two K steps; rows of
# 7 whose K steps cross rows and images, Cout = 136 on two 128-wide
# tiles, the second ragged, one step a split; Cin = 64 (128-row tiles
# straddling taps) with WRN's Cout = 160 on two 128-wide tiles
EMULATED = [(2, 12, 12, 16, 24, "bits", None),
            (2, 3, 40, 8, 16, "seed", 2),
            (3, 5, 7, 8, 136, "none", 1),
            (2, 8, 8, 64, 160, "bits", 1)]


@pytest.mark.parametrize("b,h,w,cin,cout,mode,per", EMULATED)
def test_emulated_partition_reproduces_plain(b, h, w, cin, cout, mode, per):
    n = b * h * w
    args, thresh = _operands(cin + cout + h, cin, cout, n, mode, True)
    d_b, g_b = fb.wgrad_bf16_pre_plain(*args, thresh=thresh)
    plan = nvt.wgrad_bf16_plan(b, h, w, cin, cout, 9, h)
    if per is not None:
        plan = _forced(plan, per)
        assert plan.splits > 1
    assert plan.chunks == 1 and plan.steps > 1
    assert cout < plan.bn or cout % plan.bn   # a ragged N tile
    got = _emulate_fused(d_b, g_b, b, h, w, plan)
    want = fb.wgrad_bf16_plain(*args, thresh=thresh, h=h, w_img=w)
    assert got.shape == (9 * cin, cout) and want.shape == (cout, 9 * cin)
    top = want.abs().max().item()
    assert top > 0
    assert (got.T - want).abs().max().item() <= 2e-6 * top
    # the emulation is not blind to the shift: the centre tap is the
    # unshifted product, a corner tap is not
    flat = (d_b.double().T @ g_b.double()).float()
    assert (got[4 * cin:5 * cin] - flat).abs().max().item() <= 2e-6 * top
    assert (got[:cin] - flat).abs().max().item() > 0.01 * top
