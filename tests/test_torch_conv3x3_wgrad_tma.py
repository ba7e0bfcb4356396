"""The TMA + wgmma weight gradient of ``conv3x3_same`` (ops/cuda/conv3x3.py
``conv3x3_wgrad``, ``wgrad_tma_plan``; kernel in csrc/conv3x3_wgrad.cu and
csrc/wgrad_wgmma_bf16.cuh), on the CPU:

- the plan at every shape the op runs (WRN-28-10's stages, ResNet-v1-20's
  with C = 16 padded to 32, the card tests' shapes with Cout = 48 and 136
  and W = 64): BN by the fused forward's rule, tiles covering dW, every K
  step in exactly one split, none empty;
- a numpy model of the kernel's reads (tests/_wgrad_tma_model.py, on
  one plane with tap (dh, dw) moved by dh - 1 rows and dw - 1 columns):
  every TMA box gathered at the producer's coordinates with zeros out of
  bounds and laid into the stage as the card lays it, the shifter
  warpgroup's copy of each 16-byte piece of staged x into the
  128-byte-swizzled A tile, moved by its tap's column, and every k16 of
  both operands read back through the consumers' wgmma descriptors; each
  split's tile contracted in float64 and rounded to f32, the splits added
  in order in f32. It matches
  ``conv3x3_wgrad_plain`` and JAX's ``conv3x3_wgrad_lanes``
  (``interpret=True``) within 1e-4 of dW's largest value at W = 8, 16, 32
  and 64, at Cin = 160 (tiles straddling taps) and with a ragged Cout, and
  a wrong column shift leaves that bound;
- the geometry rule and its refusals, which name the shape; the CPU path
  returns HWIO and launches nothing.

Inputs are made with numpy from a seed.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu.ops.pallas import conv as jconv
from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3 as k
from _tma_layout import swizzle_offset, tma_box_probe_plain
from _wgrad_tma_model import BK, BM, PIECE, dy_box, land, model, shift8, x_box

# (Cin, Cout, H, W, B) the op runs on the card: WRN-28-10's stages,
# ResNet-v1-20's (C = 16 padded to 32), the card tests' (Cout = 48 and
# 136, W = 64)
PLAN_SHAPES = [(160, 160, 32, 32, 128), (320, 320, 16, 16, 128),
               (640, 640, 8, 8, 128), (32, 32, 32, 32, 128),
               (32, 32, 16, 16, 128), (64, 64, 8, 8, 128),
               (160, 160, 32, 32, 2), (320, 320, 16, 16, 4),
               (640, 640, 8, 8, 8), (32, 48, 8, 8, 4), (96, 64, 16, 8, 2),
               (32, 48, 64, 64, 2), (64, 136, 16, 16, 2),
               (32, 32, 32, 32, 8), (32, 32, 16, 16, 8), (64, 64, 8, 8, 8),
               (16 + 16, 16 + 16, 32, 32, 2), (32, 64, 16, 16, 2),
               (64, 32, 8, 8, 4)]


def _max_err(got, want):
    return np.abs(np.asarray(got, np.float64)
                  - np.asarray(want, np.float64)).max()


@pytest.mark.parametrize("cin,cout,h,w,b", PLAN_SHAPES)
def test_plan(cin, cout, h, w, b):
    n = b * h * w
    p = k.wgrad_tma_plan(cin, cout, n, h, w)
    assert p.bn == (160 if cout % 160 == 0 else 128 if cout > 64 else 64)
    assert (p.m_tiles - 1) * BM < 9 * cin <= p.m_tiles * BM
    assert (p.n_tiles - 1) * p.bn < cout <= p.n_tiles * p.bn
    assert p.steps * BK == n and (h * w) % BK == 0
    assert (p.splits - 1) * p.per < p.steps <= p.splits * p.per
    assert p.splits <= 65535 and p.m_tiles <= 65535
    # the part buffer conv3x3_wgrad allocates: one f32 dW a split
    assert p.splits * 9 * cin * cout * 4 < 2 ** 31


def test_plan_splits_fill_the_card():
    """One block an SM (132 slots): stage 1's 12 x 1 tiles take 11 splits,
    one whole wave; stage 3's 180 tiles already outnumber the SMs."""
    s1 = k.wgrad_tma_plan(160, 160, 128 * 1024, 32, 32)
    assert s1.m_tiles * s1.n_tiles * s1.splits == k.WG_SLOTS == 132
    s3 = k.wgrad_tma_plan(640, 640, 128 * 64, 8, 8)
    assert s3.m_tiles * s3.n_tiles == 180


# --- the numpy model of the kernel's reads (tests/_wgrad_tma_model.py) -----

@functools.lru_cache(maxsize=None)
def _operands(cin, cout, h, w, b, seed=5):
    rng = np.random.default_rng(seed)
    n = b * h * w
    # bf16-representable values, so that every version contracts the same
    x = torch.from_numpy(rng.standard_normal((cin, n), dtype=np.float32)).to(
        torch.bfloat16).float().numpy()
    dy = torch.from_numpy(rng.standard_normal((cout, n),
                                              dtype=np.float32)).to(
        torch.bfloat16).float().numpy()
    return x, dy


def _plain(x, dy, h, w):
    return k.conv3x3_wgrad_plain(torch.from_numpy(x), torch.from_numpy(dy),
                                 h=h, w_img=w).numpy()


MODEL_SHAPES = [(32, 48, 8, 8, 2),     # W = 8, ragged Cout (BN = 64)
                (32, 32, 4, 16, 2),    # W = 16
                (64, 32, 2, 32, 2),    # W = 32, M = 576: a half-live tile
                (32, 32, 2, 64, 1),    # W = 64
                (32, 32, 1, 128, 1),   # W = 128: steps at column 64
                (160, 160, 8, 8, 2)]   # tiles straddling taps, BN = 160


@pytest.mark.parametrize("cin,cout,h,w,b", MODEL_SHAPES)
def test_model_of_the_reads_matches_plain_and_jax(cin, cout, h, w, b):
    x, dy = _operands(cin, cout, h, w, b)
    plan = k.wgrad_tma_plan(cin, cout, b * h * w, h, w)
    got = model(x, dy, h, w, plan).reshape(3, 3, cin, cout)
    plain = _plain(x, dy, h, w)
    want = np.asarray(jconv.conv3x3_wgrad_lanes(
        jnp.asarray(x), jnp.asarray(dy), h=h, w_img=w, interpret=True))
    top = np.abs(plain).max()
    assert _max_err(got, plain) <= 1e-4 * top
    assert _max_err(got, want) <= 1e-4 * top
    assert _max_err(plain, want) <= 1e-4 * top


@pytest.mark.parametrize("cin,cout,h,w,b", [(32, 48, 8, 8, 8),
                                            (32, 32, 2, 64, 4)])
def test_model_with_splits_of_several_steps(cin, cout, h, w, b):
    """Splits of three K steps (the last shorter), which the small shapes'
    own plans (one step a split) do not reach: the ring's steps accumulate
    and the ragged last split adds in order."""
    x, dy = _operands(cin, cout, h, w, b)
    plan = k.wgrad_tma_plan(cin, cout, b * h * w, h, w)
    per = 3
    plan = plan._replace(per=per, splits=-(-plan.steps // per))
    assert plan.steps % per and plan.splits > 1
    got = model(x, dy, h, w, plan).reshape(3, 3, cin, cout)
    plain = _plain(x, dy, h, w)
    assert _max_err(got, plain) <= 1e-4 * np.abs(plain).max()


@pytest.mark.parametrize("w", [8, 64])
def test_model_sees_a_wrong_shift(w):
    """The model is sharp: the shifters moving the dw = 2 taps the wrong
    way (as a mutation of shift8's sign would) leaves the 1e-4 bound."""
    cin, cout, h, b = 32, 48, 8 if w == 8 else 2, 2
    x, dy = _operands(cin, cout, h, w, b)
    plan = k.wgrad_tma_plan(cin, cout, b * h * w, h, w)
    plain = _plain(x, dy, h, w)

    def wrong(v, s, side):
        return shift8(v, -s if s > 0 else s, side)

    got = model(x, dy, h, w, plan, shift=wrong).reshape(3, 3, cin, cout)
    assert _max_err(got, plain) > 1e-2 * np.abs(plain).max()


def test_swizzle_offsets():
    """The 128-byte swizzle moves 16-byte chunk c of 128-byte row r to
    chunk c ^ (r % 8); 64 bytes: c ^ ((r // 2) % 4) in chunks of a 64-byte
    row; 16 (none): in place."""
    off = np.arange(2048)
    sw = swizzle_offset(off, 128)
    assert np.array_equal(sw % 16, off % 16)
    assert np.array_equal(sw // 128, off // 128)
    assert np.array_equal((sw // 16) % 8, ((off // 16) % 8) ^ ((off // 128)
                                                               % 8))
    assert np.array_equal(np.sort(swizzle_offset(off, 64)), off)
    assert np.array_equal(swizzle_offset(off, 16), off)
    # 64-byte row 2, chunk 1: chunk 1 ^ 1
    assert swizzle_offset(64 * 2 + 16, 64) == 64 * 2


# --- the geometry rule ---------------------------------------------------------

@pytest.mark.parametrize("h,w,ok", [
    (32, 32, True), (16, 16, True), (8, 8, True), (64, 64, True),
    (2, 128, True), (4, 16, True), (8, 16, True), (2, 32, True),
    (6, 8, False),    # 64 / W = 8 rows do not divide H
    (2, 16, False),   # 4 rows do not divide H
    (24, 24, False), (12, 12, False), (7, 7, False), (40, 40, False),
    (16, 96, False), (16, 4, False)])
def test_geometry_rule(h, w, ok):
    n = 4 * h * w
    if ok:
        k.check_wgrad_geometry("conv3x3_wgrad", 32, n, h, w)
        return
    with pytest.raises(ValueError, match=f"image {h}x{w} is off the TMA"):
        k.check_wgrad_geometry("conv3x3_wgrad", 32, n, h, w)


def test_geometry_rule_names_channels_and_images():
    with pytest.raises(ValueError, match="Cin=48 is not a multiple of 32"):
        k.check_wgrad_geometry("conv3x3_wgrad", 48, 256, 8, 8)
    with pytest.raises(ValueError, match="N=100"):
        k.check_wgrad_geometry("conv3x3_wgrad", 32, 100, 8, 8)
    with pytest.raises(ValueError, match="image 12x12"):
        k.wgrad_tma_plan(32, 32, 4 * 144, 12, 12)


def test_wgrad_returns_hwio_on_the_cpu():
    """The public function returns JAX's HWIO layout; the CPU path is the
    plain version and launches nothing."""
    x, dy = _operands(32, 48, 8, 8, 2)
    k.reset_launches()
    got = k.conv3x3_wgrad(torch.from_numpy(x), torch.from_numpy(dy), h=8,
                          w_img=8)
    assert got.shape == (3, 3, 32, 48) and got.dtype == torch.float32
    assert not k.launches
    # tap (dh, dw) = (0, 0) reads x one row up and one column left
    x4 = x.reshape(32, 2, 8, 8).astype(np.float64)
    dy4 = dy.reshape(48, 2, 8, 8).astype(np.float64)
    want = np.einsum("cbhw,obhw->co", x4[:, :, :-1, :-1], dy4[:, :, 1:, 1:])
    np.testing.assert_allclose(got[0, 0].numpy(), want, rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("dy,w,at,bn", [
    (False, 8, (-8, 1), 64), (False, 16, (0, 0), 64),
    (False, 32, (64 * 2 - 32 - 64, 1), 64), (False, 64, (-8 - 64, 0), 64),
    (False, 128, (-16 - 128, 0), 64),   # row -1 of a wide image: all zeros
    (True, 8, (64, 0), 48),             # channels past C read as zeros
    (True, 64, (2 * 8 * 64 - 32, 0), 32),   # positions past N
    (True, 16, (0, 16), 160)])
def test_probe_plain_is_the_models_layout(dy, w, at, bn):
    """``tma_box_probe_plain``, what the card probe is held to, is the
    shared-memory layout the model of the reads assumes: the model's box
    (zeros out of bounds) landed dense and swizzled by address."""
    h, b, c = 8, 2, 32
    x, _ = _operands(c, c, h, w, b)
    got = tma_box_probe_plain(torch.from_numpy(x).to(torch.bfloat16), h=h,
                              w_img=w, dy=dy, at=at, bn=bn)
    if dy:
        vals = dy_box(x.astype(np.float64), at, (BK, bn))
        swizzle = 128
    else:
        xw = BK if w < BK else BK + 16
        vals = x_box(x.reshape(c, b, h * w).astype(np.float64),
                     (at[0], at[1], 0), (xw, 1, PIECE))
        swizzle = 16
    smem = np.zeros(vals.size)
    land(smem, 0, vals, swizzle)
    want = torch.from_numpy(smem.astype(np.float32)).to(
        torch.bfloat16).view(torch.uint8)
    assert torch.equal(got, want)
