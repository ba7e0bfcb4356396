"""The lane transition's FQT weight gradient on the TMA + s8 wgmma mainloop
(ops/cuda/transition.py ``bwd_quantize``, ``wgrad``, ``wgrad_plain``,
``wgrad_s8_plan``, ``check_wgrad_s8_geometry``; kernels in
csrc/transition.cu ``bwd_quant_kernel`` (its unit stores) and
csrc/transition_wgrad.cu on csrc/wgrad_wgmma_s8.cuh), on the CPU:

- the quantizer's codes as parity planes [4, Cin, N']: per scale group they
  are the rows p * Cin + ci of JAX's ``d_ref`` (the reference kernel's
  lines, jitted as its interpret mode runs them), and a model of the
  kernel's unit stores (each output lane's input pair, both unit loads)
  writes them from the lane-layout codes;
- the plain version on planes (HWIO) is bit-equal to the lane-order
  contraction it replaces (the exact stride-2 ``conv2d_weight`` of the
  lane codes per group, scaled, added in order);
- tests/_wgrad_s8_model.py's model of the producer's boxes and the
  shifter warps builds each tap's ``TAP_TABLE`` view, zeros included, at
  output rows of 8, 12, 16, 32 and 192 pixels and across K steps that
  straddle images; without its masks or with a wrong box start it does
  not;
- the whole kernel's model (boxes, shifters, swizzles, descriptor reads,
  the s32 tile folded group after group in f32) equals ``wgrad_plain``
  bit for bit; a pairwise fold of the same group contributions differs;
- the plan: tiles covering M and N, groups of whole K steps, the waves and
  the model's choice at WRN-28-10's transitions; the geometry rule takes
  every shape of the straight-through wgrad's and refuses, naming them,
  shapes off its own; the CPU path is the plain version.

Inputs are made with numpy from a seed. Tolerances: none; every
comparison is exact (int8 codes, s32 sums, f32 roundings in one order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn.grad import conv2d_weight

from pytorch_ddp_resnet_tpu.ops.pallas import fused_block as jfb
from pytorch_ddp_resnet_tpu.ops.pallas import transition as jt
from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
from pytorch_ddp_resnet_tpu_torch.ops.cuda import transition as tr
from _wgrad_s8_model import (
    BK,
    BM,
    INV_16129,
    a_rows,
    lead,
    model,
    plane_store,
)


def _bf16(rng, *shape, s=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * s).astype(
        np.float32)).to(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _operands(cin, cout, h, w, b, groups, rate=0.3, seed=7):
    """(quantizer inputs, thresh, tile): the cotangents dz, z, dzsum, dzssq
    and the prologue's x, scale, shift and lane-order bits at input geometry
    h x w, batch b; scale groups of ``tile`` output lanes, ``groups`` of
    them (whole images and K steps: the transition's own tile at these small
    batches is the whole batch)."""
    rng = np.random.default_rng(seed)
    n, n_out = b * h * w, b * h * w // 4
    x = _bf16(rng, cin, n)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cin).astype(np.float32))
    shift = torch.from_numpy((rng.standard_normal(cin) * 0.3).astype(
        np.float32))
    thresh = fb.dropout_thresh(rate) if rate > 0 else None
    bits = (torch.from_numpy(rng.integers(0, 256, (cin, n), dtype=np.uint8))
            if rate > 0 else None)
    # scale groups of different magnitudes: the fold's order matters
    mag = np.repeat(10.0 ** rng.uniform(-3, 0, b), h * w // 4)
    dz = _bf16(rng, cout, n_out) * torch.from_numpy(mag.astype(
        np.float32)).to(torch.bfloat16)
    z = _bf16(rng, cout, n_out)
    dzsum = torch.from_numpy((rng.standard_normal(cout) * 1e-3).astype(
        np.float32))
    dzssq = torch.from_numpy((rng.standard_normal(cout) * 1e-4).astype(
        np.float32))
    tile = n_out // groups
    assert tile % BK == 0 and tile % (h * w // 4) == 0
    return (dz, z, dzsum, dzssq, x, scale, shift, bits), thresh, tile


def _quantized(cin, cout, h, w, b, groups, rate=0.3):
    args, thresh, tile = _operands(cin, cout, h, w, b, groups, rate)
    return tr.bwd_quantize_plain(*args, thresh=thresh, tile=tile, h=h,
                                 w_img=w), tile


# --- the quantizer's parity planes -------------------------------------------

@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("cin,cout,h,w,b,groups", [(32, 64, 16, 16, 8, 4),
                                                   (64, 96, 8, 32, 4, 2)])
def test_quantizer_planes_are_jax_d_ref(rate, cin, cout, h, w, b, groups):
    """d_q's planes, group by group, are the rows p * Cin + ci of the
    reference kernel's d_ref: its _prologue per plane, one absmax over the
    tile's four planes, floor 1e-30 (the kernel's lines, jitted); d_amax
    the tile's absmax."""
    args, thresh, tile = _operands(cin, cout, h, w, b, groups, rate)
    g_q, g_amax, d_q, d_amax, _ = tr.bwd_quantize_plain(
        *args, thresh=thresh, tile=tile, h=h, w_img=w)
    assert d_q.shape == (4, cin, b * h * w // 4) and d_q.dtype == torch.int8
    x, scale, shift, bits = args[4:]
    planes = jt.parity_planes(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                              h, w)
    pbits = (tr.parity_pack(bits, h, w).numpy() if bits is not None
             else None)
    sc = jnp.asarray(scale.numpy())[:, None]
    sh = jnp.asarray(shift.numpy())[:, None]

    @jax.jit
    def d_ref(planes, pb):
        # _bwd_kernel's quant_bwd lines: the four planes' prologue, one
        # absmax, the codes written at rows p * cin + ci
        dqs = [jfb._prologue(planes[p], sc, sh,
                             None if pb is None else pb[p * cin:(p + 1) * cin],
                             thresh, jnp.float32) for p in range(4)]
        amax = jnp.max(jnp.stack([jnp.max(jnp.abs(d)) for d in dqs]))
        inv = 127.0 / jnp.maximum(amax, 1e-30)
        return jnp.concatenate([jnp.clip(jnp.round(d * inv), -127.0,
                                         127.0).astype(jnp.int8)
                                for d in dqs]), amax

    got = d_q.reshape(4 * cin, -1).numpy()
    for grp, t0 in enumerate(range(0, d_q.shape[2], tile)):
        ref, amax = d_ref([p[:, t0:t0 + tile] for p in planes],
                          None if pbits is None else
                          jnp.asarray(pbits[:, t0:t0 + tile]))
        np.testing.assert_array_equal(got[:, t0:t0 + tile], np.asarray(ref))
        assert float(d_amax[grp]) == float(amax)


@pytest.mark.parametrize("cin,h,w,b", [(32, 16, 16, 2), (64, 4, 64, 2),
                                       (32, 32, 32, 1), (32, 24, 24, 2),
                                       (32, 8, 8, 4)])
def test_plane_store_model_writes_the_planes(cin, h, w, b):
    """The kernel's unit stores (each of a unit's 8 output lanes from its
    own input pair; also the 16-byte row loads where output rows hold
    whole units) give the plain version's planes, at output rows of 8, 2,
    16, 12 and 4 pixels."""
    rng = np.random.default_rng(cin + w)
    q = rng.integers(-127, 128, (cin, b * h * w)).astype(np.int8)
    want = torch.stack(tr.parity_planes(torch.from_numpy(q), h, w)).numpy()
    for rows in {False, tr.operand_rows(w)}:
        np.testing.assert_array_equal(plane_store(q, h, w, rows), want)


# --- the plain version on planes ---------------------------------------------

def _lane_order_wgrad(g_q, g_amax, d_lanes, d_amax, tile, h, w):
    """The FQT dW as it was computed on the lane-layout codes: per group the
    exact stride-2 conv2d_weight, to f32, times the group's scale, added
    in order; [Cout, 9 * Cin] in (dh, dw, ci) order."""
    cout, cin = g_q.shape[0], d_lanes.shape[0]
    out = None
    for grp in range(g_q.shape[1] // tile):
        lo, hi = grp * tile, (grp + 1) * tile
        d = d_lanes[:, 4 * lo:4 * hi]
        acc = conv2d_weight(tr._nchw(d, h, w), (cout, cin, 3, 3),
                            tr._nchw(g_q[:, lo:hi], h // 2, w // 2),
                            stride=2, padding=1)
        contrib = acc.permute(0, 2, 3, 1).reshape(cout, 9 * cin).to(
            torch.float32) * ((d_amax[grp] * g_amax[grp]) * fb.INV_16129)
        out = contrib if out is None else out + contrib
    return out


@pytest.mark.parametrize("cin,cout,h,w,b,groups", [
    (32, 64, 16, 16, 8, 4), (64, 40, 32, 32, 4, 4),
    (32, 48, 24, 24, 16, 2)])
def test_plain_on_planes_is_the_lane_order_wgrad(cin, cout, h, w, b,
                                                 groups):
    (g_q, g_amax, d_q, d_amax, _), tile = _quantized(cin, cout, h, w, b,
                                                     groups)
    got = tr.wgrad_plain(g_q, g_amax, d_q, d_amax, tile=tile, h=h, w_img=w)
    assert got.shape == (3, 3, cin, cout) and got.dtype == torch.float32
    d_lanes = tr.parity_interleave(tuple(d_q), h, w)
    want = _lane_order_wgrad(g_q, g_amax, d_lanes, d_amax, tile, h, w)
    assert torch.equal(got, want.reshape(cout, 3, 3, cin).permute(1, 2, 3, 0))


# --- the model of the producer's boxes and the shifters ---------------------

# (Cin, H, W, B, whether K steps straddle images) at the input geometry:
# output rows of 8 (two images a K step), 12 (144-position images, off the
# straight-through wgrad's rule), 16 (12 rows: 192-position images), 32
# (two rows an image: two images a step; and 8 rows) and 192 (a row shift
# of 192 bytes: a 208-byte lead)
SHIFT_SHAPES = [(32, 16, 16, 2, True), (32, 24, 24, 8, True),
                (32, 24, 32, 4, True), (64, 4, 64, 4, True),
                (32, 16, 64, 1, False), (32, 4, 384, 1, False)]


@pytest.mark.parametrize("cin,h,w,b,straddle", SHIFT_SHAPES)
def test_shifter_builds_the_tap_views(cin, h, w, b, straddle):
    """The A operand the producer and the shifter warps build, K step
    after K step, is every tap's TAP_TABLE view of the planes, zeros
    included (the border, the bytes of the previous image and before the
    tensor)."""
    oh, ow = h // 2, w // 2
    n_out = b * oh * ow
    assert n_out % BK == 0
    rng = np.random.default_rng(w)
    d = rng.integers(-127, 128, (4, cin, n_out)).astype(np.int8)
    d[d == 0] = 1   # every zero of the views comes from the masks
    want = tr._tap_views(torch.from_numpy(d), h, w).reshape(
        9 * cin, n_out).numpy()
    got = a_rows(d, tr.TAP_TABLE, oh, ow)
    np.testing.assert_array_equal(got, want)
    assert straddle == ((oh * ow) % BK != 0)


@pytest.mark.parametrize("wrong", ["masks", "lead"])
def test_shifter_model_sees_a_wrong_kernel(wrong):
    """The model is sharp: the shifters without their masks (the previous
    image's bytes and the column before the row leak in), or the box
    started 16 bytes late, do not build the views."""
    cin, h, w, b = 32, 16, 16, 2
    rng = np.random.default_rng(1)
    d = rng.integers(1, 128, (4, cin, b * h * w // 4)).astype(np.int8)
    want = tr._tap_views(torch.from_numpy(d), h, w).reshape(
        9 * cin, -1).numpy()
    if wrong == "masks":
        got = a_rows(d, tr.TAP_TABLE, h // 2, w // 2, masks=False)
    else:
        got = a_rows(d, tr.TAP_TABLE, h // 2, w // 2,
                     lead_fn=lambda rs, cs, ow: lead(rs, cs, ow) + 16)
    assert not np.array_equal(got, want)


# --- the whole kernel's model, and the fold's order --------------------------

# (Cin, Cout, H, W, B, groups): two groups of one K step (rows of 8), a
# ragged Cout (40: BN 64), Cin = 160 (M tiles straddle taps), groups of
# three steps (192-position images), rows of 192 pixels
MODEL_SHAPES = [(32, 64, 16, 16, 4, 2), (64, 40, 16, 16, 2, 1),
                (160, 64, 16, 16, 2, 1), (32, 32, 24, 32, 4, 2),
                (32, 48, 4, 384, 2, 2)]


@pytest.mark.parametrize("cin,cout,h,w,b,groups", MODEL_SHAPES)
def test_kernel_model_equals_plain_bit_for_bit(cin, cout, h, w, b, groups):
    (g_q, g_amax, d_q, d_amax, _), tile = _quantized(cin, cout, h, w, b,
                                                     groups)
    n_out = g_q.shape[1]
    plan = tr.wgrad_s8_plan(cin, cout, n_out, h, w, tile)
    got = model(d_q.numpy(), g_q.numpy(), g_amax.numpy(), d_amax.numpy(),
                tile, h // 2, w // 2, plan, tr.TAP_TABLE)
    want = tr.wgrad_plain(g_q, g_amax, d_q, d_amax, tile=tile, h=h, w_img=w)
    np.testing.assert_array_equal(got.reshape(3, 3, cin, cout),
                                  want.numpy())


def test_every_n_tile_width_folds_alike():
    """The plan's three N tiles (128, 64, 32) give the same bits: the fold
    is per element, in group order, whatever the tile."""
    cin, cout, h, w, b = 32, 128, 16, 16, 4
    (g_q, g_amax, d_q, d_amax, _), tile = _quantized(cin, cout, h, w, b, 2)
    plan = tr.wgrad_s8_plan(cin, cout, g_q.shape[1], h, w, tile)
    outs = [model(d_q.numpy(), g_q.numpy(), g_amax.numpy(), d_amax.numpy(),
                  tile, h // 2, w // 2,
                  plan._replace(bn=bn, n_tiles=-(-cout // bn)), tr.TAP_TABLE)
            for bn in tr.S8_BNS]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])


def test_in_order_fold_is_plain_and_pairwise_is_not():
    """The group contributions (exact s32 sums to f32, times each group's
    scale) added in group order in f32 are wgrad_plain bit for bit; the
    same contributions added pairwise (a tree over groups) are not, so the
    kernel's one launch must walk the groups in order."""
    cin, cout, h, w, b, groups = 32, 64, 16, 16, 16, 8
    (g_q, g_amax, d_q, d_amax, _), tile = _quantized(cin, cout, h, w, b,
                                                     groups)
    taps = tr._tap_views(d_q, h, w)
    da, ga = d_amax.numpy(), g_amax.numpy()
    contribs = []
    for grp in range(groups):
        lo, hi = grp * tile, (grp + 1) * tile
        acc = (taps[:, :, lo:hi] @ g_q[:, lo:hi].double().t()).numpy()
        ts = np.float32(da[grp] * ga[grp]) * INV_16129
        assert ts.dtype == np.float32
        contribs.append(acc.astype(np.float32) * ts)
    in_order = contribs[0]
    for c in contribs[1:]:
        in_order = in_order + c
    level = contribs
    while len(level) > 1:
        level = [level[i] + level[i + 1] if i + 1 < len(level) else level[i]
                 for i in range(0, len(level), 2)]
    want = tr.wgrad_plain(g_q, g_amax, d_q, d_amax, tile=tile, h=h,
                          w_img=w).numpy().reshape(9, cin, cout)
    np.testing.assert_array_equal(in_order, want)
    assert not np.array_equal(level[0], want)
    assert float(INV_16129) == float(fb.INV_16129)


# --- the plan and the geometry -----------------------------------------------

# (Cin, Cout, H, W, B): WRN-28-10's transitions at batch 128, then the
# card tests' shapes (Cin 16 -> 32 padded, Cout = 40, rows of 192 pixels)
# and the models'
PLAN_SHAPES = [(160, 320, 32, 32, 128), (320, 640, 16, 16, 128),
               (32, 32, 32, 32, 16), (64, 40, 16, 16, 8),
               (32, 64, 4, 384, 2), (32, 64, 16, 16, 8),
               (160, 64, 16, 16, 2), (32, 48, 24, 24, 8)]


@pytest.mark.parametrize("cin,cout,h,w,b", PLAN_SHAPES)
def test_plan(cin, cout, h, w, b):
    """Tiles cover M = 9 * Cin and N = Cout, a scale group is a whole
    number of K steps, the waves are the model's (one block an SM), and
    the choice is the model's cheapest, cached."""
    n_out = b * h * w // 4
    tile = tr.transition_tile(h // 2, w // 2, n_out, cin, cout)
    p = tr.wgrad_s8_plan(cin, cout, n_out, h, w, tile)
    assert p.bn in tr.S8_BNS
    assert (p.m_tiles - 1) * BM < 9 * cin <= p.m_tiles * BM
    assert (p.n_tiles - 1) * p.bn < cout <= p.n_tiles * p.bn
    assert p.steps * BK == n_out and p.spg * BK == tile
    assert p.steps % p.spg == 0
    assert p.waves == -(-p.m_tiles * p.n_tiles // tr.S8_SMS)
    assert p.m_tiles <= 65535 and p.n_tiles <= 65535
    assert p == tr.wgrad_s8_plan(cin, cout, n_out, h, w, tile)


def test_plan_at_the_wrn_transitions():
    """dW at stage 2 is 1440 x 320 over 256 K steps in 32 groups; at stage
    3 2880 x 640 over 64 in 16. The model, paced by the bytes each block's
    TMA boxes bring in, takes 32-wide tiles at stage 2 (120 blocks on 132
    SMs: wider tiles leave SMs idle) and 128-wide at stage 3 (115 blocks,
    one wave: narrower tiles load the staged rows again and take two)."""
    s2 = tr.wgrad_s8_plan(160, 320, 128 * 256, 32, 32, 1024)
    assert (s2.m_tiles, s2.steps, s2.spg) == (12, 256, 8)
    assert (s2.bn, s2.n_tiles, s2.waves) == (32, 10, 1)
    s3 = tr.wgrad_s8_plan(320, 640, 128 * 64, 16, 16, 512)
    assert (s3.m_tiles, s3.steps, s3.spg) == (23, 64, 4)
    assert (s3.bn, s3.n_tiles, s3.waves) == (128, 5, 1)
    for stage, (cin, cout, h) in ((s2, (160, 320, 32)),
                                  (s3, (320, 640, 16))):
        assert tr.transition_tile(h // 2, h // 2, 128 * h * h // 4, cin,
                                  cout) == stage.spg * BK


@pytest.mark.parametrize("cin,cout,h,w", [(32, 40, 16, 16), (32, 64, 4, 384),
                                          (32, 64, 16, 128), (32, 48, 8, 64)])
def test_takes_the_straight_through_wgrads_shapes(cin, cout, h, w):
    """Every shape check_wgrad_geometry takes, the FQT wgrad takes too."""
    n_out = 2 * (h // 2) * (w // 2)
    tr.check_wgrad_geometry("transition_wgrad_tma", cin, cout, h, w, n_out)
    tr.check_wgrad_s8_geometry("transition_wgrad_s8", cin, cout, h, w, n_out,
                               128 * (n_out // 128))


@pytest.mark.parametrize("cin,cout,h,w,tile,match", [
    (48, 64, 16, 16, 128, "Cin=48 is not a multiple of 32"),
    (32, 44, 16, 16, 128, "Cout=44 is not a multiple of 8"),
    (32, 64, 15, 16, 128, "geometry H=15 W=16"),
    (32, 64, 12, 12, 144, "output image 6x6 is not whole images of a "
                          "multiple of 16"),
    (32, 64, 16, 16, 64, "scale group of 64 positions"),
    (32, 64, 16, 16, 384, "scale group of 384 positions")])
def test_geometry_refusals_name_the_shape(cin, cout, h, w, tile, match):
    n_out = 8 * (h // 2) * (w // 2)
    with pytest.raises(ValueError, match=match):
        tr.check_wgrad_s8_geometry("transition_wgrad_s8", cin, cout, h, w,
                                   n_out, tile)


def test_cpu_path_is_the_plain_version():
    """On the CPU the wrappers run the plain versions and launch
    nothing; the quantizer's d_q is the planes."""
    args, thresh, tile = _operands(32, 48, 16, 16, 4, 2)
    fwd_amax = tr.fwd_amax_plain(*args[4:], thresh=thresh, tile=tile)[:, 0]
    tr.reset_launches()
    g_q, g_amax, d_q, d_amax, _ = tr.bwd_quantize(
        *args, fwd_amax, thresh=thresh, tile=tile, h=16, w_img=16)
    assert torch.equal(d_amax, fwd_amax)
    dw = tr.wgrad(g_q, g_amax, d_q, d_amax, tile=tile, h=16, w_img=16)
    assert not tr.launches
    assert d_q.shape == (4, 32, 4 * 64)
    assert torch.equal(dw, tr.wgrad_plain(g_q, g_amax, d_q, d_amax,
                                          tile=tile, h=16, w_img=16))
