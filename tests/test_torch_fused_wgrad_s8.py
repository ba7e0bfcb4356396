"""The fused int8 half's FQT weight gradient on the TMA + s8 wgmma mainloop
(ops/cuda/fused_block.py ``wgrad``, ``wgrad_plain``,
``fused_wgrad_s8_plan``, ``check_wgrad_s8_geometry``; kernels in
csrc/fused_wgrad_s8.cu on csrc/wgrad_wgmma_s8.cuh), on the CPU:

- tests/_wgrad_s8_model.py's model of the producer's boxes and the shifter
  warps builds the nine stride-1 taps of one plane (row and column shifts
  of -1, 0 and +1), zeros included, at 8x8, 16x16 and 32x32 images and
  rows of 64 and 384 pixels, across K steps that straddle images; without
  its masks, with a wrong box start or a wrong shift it does not;
- the whole kernel's model (boxes, shifters, swizzles, descriptor reads,
  the s32 tile per scale group) equals ``wgrad_plain`` bit for bit on both
  of the kernel's routes: the groups folded in each block, and the groups
  split into runs whose f32 contributions go to slots in the fragment's
  order and are added in group order; a pairwise sum of the same slots
  differs;
- the same model on the port's quantized operands gives JAX's
  ``fused_half_int8`` weight gradient (within 1e-6, as the op's own test);
- the plan: its choice at the three WRN-28-10 stages, its invariants at
  small shapes; the geometry rule takes widths the old 256-position
  staging chunk refused and refuses, naming them, shapes off its own; the
  CPU path is the plain version, in HWIO.

Inputs are made with numpy from a seed. Tolerances: none for the kernel's
model (int8 codes, s32 sums, f32 roundings in one order); 1e-6 of the
largest value against JAX, whose XLA contraction sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu.ops.pallas import fused_block as jfb
from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
from pytorch_ddp_resnet_tpu_torch.ops.cuda.conv3x3 import patches_f64
from _wgrad_s8_model import (
    BK,
    BM,
    FUSED_TAPS,
    INV_16129,
    a_rows,
    fragment_rc,
    lead,
    model,
    slot_sum,
)


def _codes(cin, cout, n, groups, seed=0):
    """Int8 codes d_q [Cin, N] (no zeros: every zero of a tap view comes
    from a mask) and g_q [Cout, N], and per-group absmaxes of magnitudes
    that differ by orders (the fold's order matters)."""
    rng = np.random.default_rng(seed)
    d = rng.integers(-127, 128, (cin, n)).astype(np.int8)
    d[d == 0] = 1
    g = rng.integers(-127, 128, (cout, n)).astype(np.int8)
    ga = (10.0 ** rng.uniform(-3, 1, groups)).astype(np.float32)
    da = rng.uniform(0.5, 4.0, groups).astype(np.float32)
    return d, g, ga, da


def _plain(d, g, ga, da, tile, h, w):
    return fb.wgrad_plain(torch.from_numpy(g), torch.from_numpy(ga),
                          torch.from_numpy(d), torch.from_numpy(da),
                          tile=tile, h=h, w_img=w).numpy()


# --- the shifter at the nine stride-1 taps -------------------------------------

# (Cin, H, W, B): images of 64 positions (a K step straddles two), 256 and
# 1,024; rows of 64 and of 384 pixels (a row shift moves the box by whole
# 16-byte units, +1 to the next)
SHIFT_SHAPES = [(32, 8, 8, 4), (32, 16, 16, 2), (64, 32, 32, 1),
                (32, 4, 64, 2), (32, 2, 384, 1)]


@pytest.mark.parametrize("cin,h,w,b", SHIFT_SHAPES)
def test_shifter_builds_the_fused_taps(cin, h, w, b):
    """The A operand the producer and the shifter warps build, K step after
    K step, is every tap's (dh, dw) view of the plane (JAX's patches, zero
    off the image: the border, the neighbouring images and past the
    tensor)."""
    n = b * h * w
    assert n % BK == 0
    d, *_ = _codes(cin, 8, n, 1, seed=w)
    want = patches_f64(torch.from_numpy(d), h, w).numpy().astype(np.int8)
    got = a_rows(d[None], FUSED_TAPS, h, w)
    np.testing.assert_array_equal(got, want)
    assert all(abs(rs) <= 1 and abs(cs) <= 1 for _, rs, cs in FUSED_TAPS)
    assert {lead(1, 1, w) % 16, lead(-1, -1, w) % 16} == {0}


@pytest.mark.parametrize("wrong", ["masks", "lead", "shift"])
def test_shifter_model_sees_a_wrong_kernel(wrong):
    """The model is sharp: the shifters without their masks (the next
    image's first row and the row's wrap-around leak in at the +1 taps),
    the box started 16 bytes late, or the +1 column tap read at -1, do not
    build the taps."""
    cin, h, w, b = 32, 16, 16, 2
    d, *_ = _codes(cin, 8, b * h * w, 1, seed=3)
    want = patches_f64(torch.from_numpy(d), h, w).numpy().astype(np.int8)
    if wrong == "masks":
        got = a_rows(d[None], FUSED_TAPS, h, w, masks=False)
    elif wrong == "lead":
        got = a_rows(d[None], FUSED_TAPS, h, w,
                     lead_fn=lambda rs, cs, ow: lead(rs, cs, ow) + 16)
    else:
        table = [(p, rs, -1 if cs == 1 else cs) for p, rs, cs in FUSED_TAPS]
        got = a_rows(d[None], table, h, w)
    assert not np.array_equal(got, want)


# --- the whole kernel's model: both routes --------------------------------------

# (Cin, Cout, H, W, B, groups): 8x8 images in two groups (a K step holds
# two images), 16x16 in four, 32x32 in two (Cin = 96: M tiles straddle
# taps; Cout = 40: a ragged N tile), 4x64 in three
MODEL_SHAPES = [(32, 64, 8, 8, 8, 2), (32, 32, 16, 16, 4, 4),
                (96, 40, 32, 32, 2, 2), (32, 48, 4, 64, 3, 3)]


def _route(plan, route, cout):
    """The plan as it is, or forced to fold in the block (one run of all
    groups) or to split them one group a block at its slot width."""
    if route == "fold":
        return plan._replace(bn=128, n_tiles=-(-cout // 128),
                             gpb=plan.groups, runs=1)
    if route == "split":
        bn = fb.WGRAD_SLOT_BNS[-1]
        return plan._replace(bn=bn, n_tiles=-(-cout // bn), gpb=1,
                             runs=plan.groups)
    return plan


@pytest.mark.parametrize("cin,cout,h,w,b,groups", MODEL_SHAPES)
@pytest.mark.parametrize("route", ["plan", "fold", "split"])
def test_kernel_model_equals_plain_bit_for_bit(cin, cout, h, w, b, groups,
                                               route):
    n = b * h * w
    tile = n // groups
    d, g, ga, da = _codes(cin, cout, n, groups, seed=cin + h)
    plan = fb.fused_wgrad_s8_plan(cin, cout, n, h, w, tile)
    plan = _route(plan, route, cout)
    got = model(d[None], g, ga, da, tile, h, w, plan, FUSED_TAPS)
    np.testing.assert_array_equal(got.reshape(3, 3, cin, cout),
                                  _plain(d, g, ga, da, tile, h, w))


def test_slots_in_group_order_are_the_fold_and_pairwise_are_not():
    """The split route's slots (each group's contribution, in fragment
    order) added in group order by slot_sum are the in-order fold, bit for
    bit; the same slots added pairwise (a tree over groups) are not."""
    cin, cout, h, w, b, groups = 32, 64, 8, 8, 16, 8
    n = b * h * w
    tile = n // groups
    d, g, ga, da = _codes(cin, cout, n, groups, seed=5)
    taps = patches_f64(torch.from_numpy(d), h, w).numpy()
    bn, m = 128, 9 * cin
    m_tiles = -(-m // BM)
    rows, cols = fragment_rc(bn)
    slots = np.zeros((groups, m_tiles, BM * bn), np.float32)
    for grp in range(groups):
        lo, hi = grp * tile, (grp + 1) * tile
        acc = taps[:, lo:hi] @ g[:, lo:hi].astype(np.float64).T
        ts = np.float32(da[grp] * ga[grp]) * INV_16129
        c = np.zeros((m_tiles * BM, bn), np.float32)
        c[:m, :cout] = acc.astype(np.float32) * ts
        for y in range(m_tiles):
            slots[grp, y] = c[y * BM + rows, cols]
    want = _plain(d, g, ga, da, tile, h, w).reshape(m, cout)
    np.testing.assert_array_equal(slot_sum(slots, m, cout, bn, 1), want)
    level = list(slots)
    while len(level) > 1:
        level = [level[i] + level[i + 1] if i + 1 < len(level) else level[i]
                 for i in range(0, len(level), 2)]
    assert not np.array_equal(slot_sum(level[0][None], m, cout, bn, 1),
                              want)


def test_fragment_order_covers_the_tile_once():
    for bn in fb.WGRAD_SLOT_BNS:
        rows, cols = fragment_rc(bn)
        assert rows.size == BM * bn
        assert len(set(zip(rows.tolist(), cols.tolist()))) == BM * bn
        assert rows.max() == BM - 1 and cols.max() == bn - 1


def test_model_on_the_ports_operands_is_jaxs_weight_gradient():
    """The kernel's model on the operands the port's quantizer makes (two
    backward groups at 8x8, batch 128, JAX's fused backward route) gives
    the weight gradient of JAX's ``fused_half_int8`` (interpret mode)."""
    c, h, w, b = 64, 8, 8, 128
    n = b * h * w
    rng = np.random.default_rng(11)

    def bf(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)

    x = bf(rng.standard_normal((c, n)))
    wt = (rng.standard_normal((3, 3, c, c)) * (9 * c) ** -0.5).astype(
        np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    shift = (rng.standard_normal(c) * 0.3).astype(np.float32)
    cy = bf(rng.standard_normal((c, n)))

    def jloss(wj):
        y = jfb.fused_half_int8(
            jnp.asarray(x, jnp.bfloat16), wj, jnp.asarray(scale),
            jnp.asarray(shift), None, None, dropout_rate=0.0, h=h, w_img=w,
            want_stats=False, quant_bwd=True, interpret=True)[0]
        return jnp.sum(y.astype(jnp.float32) * cy)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(wt)), np.float32)
    tile = fb.bwd_tile(h, w, n, c, c)
    g_q, g_amax, d_q, d_amax, _ = fb.bwd_quantize_plain(
        torch.from_numpy(cy).to(torch.bfloat16), None, None, None,
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(scale),
        torch.from_numpy(shift), None, thresh=None, tile=tile,
        emit_res=False)
    plan = fb.fused_wgrad_s8_plan(c, c, n, h, w, tile)
    got = model(d_q.numpy()[None], g_q.numpy(), g_amax.numpy(),
                d_amax.numpy(), tile, h, w, plan,
                FUSED_TAPS).reshape(3, 3, c, c)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert np.abs(want).max() > 0


# --- the plan and the geometry -------------------------------------------------

def test_plan_at_the_wrn_stages():
    """dW at C = 160 is 1440 x 160 over 1,024 K steps in 32 groups: 12 tiles
    of 128 x 160 leave 120 SMs idle, so every group is a block of its own
    (384 blocks) and ``.sum`` adds the 32 slots; at C = 320, 46 tiles, two
    groups a block (368 blocks); at C = 640, 225 tiles of 128 x 128 fill two
    waves alone and fold their 8 groups in the block."""
    want = {160: (160, 12, 1, 32, 1, 32), 320: (160, 23, 2, 16, 2, 8),
            640: (128, 45, 5, 8, 8, 1)}
    for c, hw in ((160, 32), (320, 16), (640, 8)):
        n = 128 * hw * hw
        tile = fb.bwd_tile(hw, hw, n, c, c)
        p = fb.fused_wgrad_s8_plan(c, c, n, hw, hw, tile)
        assert (p.bn, p.m_tiles, p.n_tiles, p.groups, p.gpb,
                p.runs) == want[c]
        assert p.steps * BK == n and p.spg * BK == tile


# (Cin, Cout, H, W, B): the card tests' FQT shapes, then ragged widths and
# rows of 64
PLAN_SHAPES = [(32, 32, 8, 8, 128), (64, 64, 16, 16, 16),
               (32, 40, 8, 8, 32), (96, 64, 32, 32, 4), (32, 48, 4, 64, 16)]


@pytest.mark.parametrize("cin,cout,h,w,b", PLAN_SHAPES)
def test_plan(cin, cout, h, w, b):
    """Tiles cover M = 9 * Cin and N = Cout; the runs cover the groups
    (runs of gpb, the last may be shorter); a split takes a slot width and
    a fold a fold width; the waves are the model's; cached."""
    n = b * h * w
    tile = fb.bwd_tile(h, w, n, cin, cout)
    p = fb.fused_wgrad_s8_plan(cin, cout, n, h, w, tile)
    assert (p.m_tiles - 1) * BM < 9 * cin <= p.m_tiles * BM
    assert (p.n_tiles - 1) * p.bn < cout <= p.n_tiles * p.bn
    assert p.groups * tile == n and p.spg * BK == tile
    assert p.runs == -(-p.groups // p.gpb) and (p.runs - 1) * p.gpb < p.groups
    assert p.bn in (fb.WGRAD_SLOT_BNS if p.runs > 1 else fb.WGRAD_FOLD_BNS)
    assert p.blocks == p.m_tiles * p.n_tiles * p.runs
    assert p.waves == -(-p.blocks // 132)
    assert p == fb.fused_wgrad_s8_plan(cin, cout, n, h, w, tile)


def _staging_chunk_rule(n, tile, h, w):
    """The 256-position staging chunk's rule that the mainloop replaced:
    rows of at most 32, whole rows or whole images a chunk."""
    return not (tile % 256 or w > 32 or 256 % w
                or (256 % (h * w) and (h * w) % 256))


@pytest.mark.parametrize("h,w,b", [(8, 64, 16), (4, 128, 8), (24, 24, 8),
                                   (12, 48, 16)])
def test_geometry_takes_what_the_staging_chunk_refused(h, w, b):
    n = b * h * w
    tile = n // 2 if (n // 2) % BK == 0 else n
    assert not _staging_chunk_rule(n, tile, h, w)
    fb.check_wgrad_s8_geometry("fused_half_wgrad", 32, 64, n, h, w, tile)
    fb.fused_wgrad_s8_plan(32, 64, n, h, w, tile)


@pytest.mark.parametrize("cin,cout,h,w,n,tile,match", [
    (48, 64, 8, 8, 1024, 512, "Cin=48 is not a multiple of 32"),
    (32, 44, 8, 8, 1024, 512, "Cout=44 is not a multiple of 8"),
    (32, 64, 6, 6, 2304, 1152, "geometry H=6 W=6 N=2304"),
    (32, 64, 8, 8, 1000, 500, "geometry H=8 W=8 N=1000"),
    (32, 64, 8, 8, 1024, 64, "scale group of 64 positions"),
    (32, 64, 8, 8, 1024, 384, "scale group of 384 positions")])
def test_geometry_refusals_name_the_shape(cin, cout, h, w, n, tile, match):
    with pytest.raises(ValueError, match=match):
        fb.check_wgrad_s8_geometry("fused_half_wgrad", cin, cout, n, h, w,
                                   tile)
    with pytest.raises(ValueError, match=match):
        fb.fused_wgrad_s8_plan(cin, cout, n, h, w, tile)


def test_cpu_path_is_the_plain_version():
    """On the CPU ``wgrad`` runs the plain version, in HWIO, and launches
    nothing."""
    cin, cout, h, w, b = 32, 48, 8, 8, 4
    n = b * h * w
    d, g, ga, da = _codes(cin, cout, n, 2, seed=9)
    args = [torch.from_numpy(a) for a in (g, ga, d, da)]
    fb.reset_launches()
    got = fb.wgrad(*args, tile=n // 2, h=h, w_img=w)
    assert not fb.launches
    assert got.shape == (3, 3, cin, cout) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  _plain(d, g, ga, da, n // 2, h, w))
