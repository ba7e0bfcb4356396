"""The fused int8 block-half's input gradient in fully quantized training
on the slab route (ops/cuda/fused_block.py ``dgrad_int8_pre``,
``dgrad_int8_gemm``, ``dgrad_conv``; kernels in csrc/fused_half.cuh's
slab copy and csrc/dgrad_wgmma_s8.cuh), on the CPU:

- the prepass's plain version puts g_q's codes at each pixel's position
  of the int8 forward's slab (``fused_fwd_int8_plan`` at Cin = the half's
  Cout) and zeros at every pad position;
- the plain prepass and GEMM composed equal ``dgrad_conv_plain``: dx bit
  for bit (the float64 contraction of int8 products is exact in both, so
  the same f32 accumulator is dequantized in the same order and goes
  through the same masks), d(scale) and d(shift) within 1e-5 of their
  largest value (the GEMM sums every lane at once, the reference group by
  group), at 6x6, 5x7, 12x12 and 8x8 images with Cin != Cout, in the three
  bits modes;
- a numpy model of the card GEMM (each 128-row tile's run of lanes, each
  M row's lane and scale group, the dequantization, f32 staged
  channel-major from the run's lead, 8-lane units masked at their global
  lanes, dx written inside the run, each unit's sums in lane order, the
  units in order, the tiles in ``common::tile_sum``'s 32 runs) gives the
  plain GEMM's dx bit for bit and its sums within 1e-5, and no longer does
  with a wrong lane, row, tap or scale group (each row dequantized at its
  tile's first row's group);
- ``fused_half_int8(quant_bwd=True)`` with the dgrad on the slab route
  against JAX's ``fused_half_int8(..., quant_bwd=True, interpret=True)``
  at 6x6 (a width the old card dgrad refused) and 8x8, with bits and a
  seed, with and without the stats cotangents and a residual, at
  tests/test_torch_fused_block.py::test_backward_matches_jax's
  tolerances;
- the geometry rule: the FQT dgrad takes what the int8 forward takes
  (``check_fwd_int8_geometry``, Cin and Cout swapped), any image width;
  the FQT backward still refuses what its int8 wgrad cannot take;
- chip_smoke.py's profile kinds count the new kernels as the fused int8
  half's.

Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu.ops.pallas import fused_block as jfb
from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb

# (batch, h, w, Cin, Cout, scale group) of the half: widths that are not
# multiples of 8 (6x6, 5x7, 12x12) and 8x8, Cin != Cout (a ragged 64-wide
# N tile at 40); Cout 32 and 96 (a tap's 32-byte box; 64 + 32), 64 (one
# 64-byte box); groups of 2 images of 6x6 (72 lanes) and of 12x12 (288)
GEOS = [(8, 6, 6, 40, 32, 72), (8, 5, 7, 32, 96, 280),
        (4, 12, 12, 40, 64, 288), (4, 8, 8, 48, 32, 128)]
MODES = ["none", "bits", "seed"]


def _operands(rng, cin, cout, n, tile, mode):
    """(g_q, g_amax, w_dg, ws_in, x, scale, shift, thresh, bits): g_q the
    codes of a cotangent quantized per group of ``tile`` lanes, each group
    at its own scale."""
    gf = torch.from_numpy((rng.standard_normal((cout, n))
                           * rng.uniform(0.1, 10.0, n // tile).repeat(tile)
                           ).astype(np.float32))
    g_q, g_amax = fb.quantize_groups_plain(gf, tile, fb.BWD_FLOOR)
    wt = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3))
                           * (9 * cin) ** -0.5).astype(np.float32))
    w_dg, ws_in = fb.quantize_pack_weights_dgrad(wt)
    x = torch.from_numpy(rng.standard_normal((cin, n)).astype(
        np.float32)).to(torch.bfloat16)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cin).astype(np.float32))
    shift = torch.from_numpy((rng.standard_normal(cin) * 0.3).astype(
        np.float32))
    thresh, bits = None, None
    if mode == "bits":
        thresh = fb.dropout_thresh(0.3)
        bits = torch.from_numpy(rng.integers(0, 256, (cin, n),
                                             dtype=np.uint8))
    elif mode == "seed":
        thresh = fb.dropout_thresh(0.3)
        bits = torch.tensor(-987654321, dtype=torch.int32)
    return g_q, g_amax, w_dg, ws_in, x, scale, shift, thresh, bits


@pytest.mark.parametrize("b,h,w,cin,cout,tile", GEOS)
def test_pre_plain_writes_the_codes_at_the_pixels_and_zeros_elsewhere(
        b, h, w, cin, cout, tile):
    n = b * h * w
    rng = np.random.default_rng(n + cout)
    g_q = _operands(rng, cin, cout, n, tile, "none")[0]
    plan = fb.fused_fwd_int8_plan(n, h, w, cout, cin)
    lay = plan.lay
    assert (lay.cin, lay.cout, lay.cp) == (cout, cin, cout)
    assert plan.bn == (160 if cin % 160 == 0 else 128 if cin > 64 else 64)
    assert sum(wd for _, wd, _ in plan.boxes) == cout
    for slab in (fb.dgrad_int8_pre_plain(g_q, plan=plan),
                 fb.dgrad_int8_pre(g_q, plan=plan)):
        assert slab.dtype == torch.int8 and slab.is_contiguous()
        assert tuple(slab.shape) == (lay.slab_len, cout)
        live = fb.fused_fwd_live_rows(lay) + lay.guard
        assert torch.equal(slab[live], g_q.t())
        pads = np.setdiff1d(np.arange(lay.slab_len), live.numpy())
        assert len(pads) == lay.slab_len - n and not slab[pads].any()


@pytest.mark.parametrize("b,h,w,cin,cout,tile", GEOS)
@pytest.mark.parametrize("mode", MODES)
def test_pre_and_gemm_plain_equal_dgrad_conv_plain(b, h, w, cin, cout, tile,
                                                   mode):
    n = b * h * w
    rng = np.random.default_rng(n + cout + len(mode))
    g_q, g_amax, w_dg, ws_in, x, scale, shift, thresh, bits = _operands(
        rng, cin, cout, n, tile, mode)
    args = (g_amax, w_dg, ws_in, x, scale, shift, bits)
    want = fb.dgrad_conv_plain(g_q, *args, thresh=thresh, tile=tile, h=h,
                               w_img=w)
    assert want[0].float().abs().max() > 0
    plan = fb.fused_fwd_int8_plan(n, h, w, cout, cin)
    kw = dict(thresh=thresh, tile=tile, plan=plan)
    got = fb.dgrad_int8_gemm_plain(fb.dgrad_int8_pre_plain(g_q, plan=plan),
                                   *args, **kw)
    assert got[0].dtype == torch.bfloat16
    assert torch.equal(got[0], want[0])
    for g, ref in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32
        assert (g - ref).abs().max() <= 1e-5 * ref.abs().max()
    # on the CPU the wrappers are the plain versions, at any width
    again = fb.dgrad_int8_gemm(fb.dgrad_int8_pre(g_q, plan=plan), *args,
                               **kw)
    for a, b_ in zip(again, got):
        assert torch.equal(a, b_)
    for a, b_ in zip(fb.dgrad_conv(g_q, *args, thresh=thresh, tile=tile,
                                   h=h, w_img=w), want):
        assert torch.equal(a, b_)


# --- a model of the card kernel ---------------------------------------------------

CF_OS = 140     # f32 words a staged channel (csrc/dgrad_wgmma_bf16.cuh)
SUM_RUNS = 32   # runs of tiles of the sum (csrc/common.cuh tile_sum)


def _live_before(lay, m):
    """csrc/fwd_wgmma_bf16.cuh ``live_before``: live rows before M row m."""
    wp = lay.w + 1
    i, rem = divmod(m, lay.per_img)
    if i >= lay.b:
        return lay.n
    r, c = divmod(rem, wp)
    return i * lay.h * lay.w + (0 if r == 0 else (r - 1) * lay.w
                                + max(c - 1, 0))


def _model(slab, g_amax, w_dg, ws_in, x, scale, shift, bits, thresh, tile,
           plan, mutate=None):
    """(dx, d(scale), d(shift)) as the card kernel computes them: the s32
    accumulators of every M row (exact, in int64), per tile each live row's
    lane k and scale g_amax[k // tile] * f32(1/127), v = f32(acc) * (ws_in
    * scale) rounded product by product, staged channel-major at lead +
    at[row], the 8-lane units of each channel's run masked at their global
    lanes, dx written inside the run, each unit's sums in lane order, the
    units' in order, the tiles' in runs. ``mutate``: "lane" reads x and the
    bits from the run's first lane instead of its 8-aligned base, "row"
    stages each live row one place late, "tap" mirrors the taps' columns,
    "group" dequantizes every row at its tile's first row's group."""
    f32 = np.float32
    lay = plan.lay
    cin, kc, n = lay.cout, lay.cin, lay.n
    shifts = list(lay.shifts)
    if mutate == "tap":
        shifts = [lay.shifts[3 * (t // 3) + 2 - t % 3] for t in range(9)]
    a = slab.numpy().astype(np.int64)
    wt = w_dg.numpy().astype(np.int64).reshape(cin, 9, kc)
    rows = np.arange(lay.tiles * lay.bm)
    acc = sum(a[rows + sh, :kc] @ wt[:, t].T
              for t, sh in enumerate(shifts))                # [M, Cin]
    assert np.abs(acc).max() < 2 ** 31
    amax = g_amax.numpy().astype(f32)
    wsc = ws_in.numpy().astype(f32)
    xs = x.float().numpy()
    sc, sh = scale.numpy().astype(f32), shift.numpy().astype(f32)
    drop = fb.mask_bits(bits, cin, n)
    drop = None if drop is None else drop.numpy().astype(np.int32)
    keep = f32(fb.inv_keep(thresh)) if drop is not None else f32(1)
    dx = np.zeros((cin, n), np.float32)
    parts = []
    for t_ in range(lay.tiles):
        m0 = t_ * lay.bm
        lane0 = _live_before(lay, m0)
        count = _live_before(lay, m0 + lay.bm) - lane0
        lead = lane0 % 8
        staged = np.zeros((cin, CF_OS), f32)
        for r in range(lay.bm):
            k = _live_before(lay, m0 + r)
            if _live_before(lay, m0 + r + 1) == k:
                continue
            g = (lane0 if mutate == "group" else k) // tile
            rs = amax[g] * f32(fb.INV_127)
            v = acc[m0 + r].astype(f32) * (wsc * rs)
            staged[:, lead + k - lane0 + (mutate == "row")] = v
        vpc = (lead + count + 7) // 8
        j = np.arange(vpc * 8)
        in_run = (j >= lead) & (j < lead + count)
        base = lane0 if mutate == "lane" else lane0 - lead
        lanes = np.minimum(base + j, n - 1)
        xv = xs[:, lanes]
        live = in_run & (xv.astype(np.float64) * sc[:, None]
                         + sh[:, None] > 0)
        v = staged[:, :vpc * 8]
        if drop is not None:
            live &= drop[:, lanes] < thresh
            v = v * keep
        dn = np.where(live, v, f32(0))
        d = torch.from_numpy(dn * sc[:, None]).to(torch.bfloat16).float()
        dx[:, lanes[in_run]] = d.numpy()[:, in_run]
        prod = (dn * xv).reshape(cin, vpc, 8)
        dn8 = dn.reshape(cin, vpc, 8)
        s1 = np.zeros((cin, vpc), f32)
        s2 = np.zeros((cin, vpc), f32)
        for e in range(8):
            s1, s2 = s1 + prod[:, :, e], s2 + dn8[:, :, e]
        t1, t2 = np.zeros(cin, f32), np.zeros(cin, f32)
        for u in range(vpc):
            t1, t2 = t1 + s1[:, u], t2 + s2[:, u]
        parts.append(np.concatenate([t1, t2]))
    per = -(-lay.tiles // SUM_RUNS)
    runs = []
    for q in range(SUM_RUNS):
        s = np.zeros(2 * cin, f32)
        for t_ in range(q * per, min(lay.tiles, (q + 1) * per)):
            s = s + parts[t_]
        runs.append(s)
    tot = runs[0]
    for s in runs[1:]:
        tot = tot + s
    return (torch.from_numpy(dx).to(torch.bfloat16),
            torch.from_numpy(tot[:cin]), torch.from_numpy(tot[cin:]))


@pytest.mark.parametrize("b,h,w,cin,cout,tile", GEOS + [
    (1, 32, 32, 32, 32, 1024)])
@pytest.mark.parametrize("mode", MODES)
def test_card_kernel_model_equals_the_plain_gemm(b, h, w, cin, cout, tile,
                                                 mode):
    n = b * h * w
    rng = np.random.default_rng(n + cin)
    g_q, g_amax, w_dg, ws_in, x, scale, shift, thresh, bits = _operands(
        rng, cin, cout, n, tile, mode)
    plan = fb.fused_fwd_int8_plan(n, h, w, cout, cin)
    slab = fb.dgrad_int8_pre_plain(g_q, plan=plan)
    args = (slab, g_amax, w_dg, ws_in, x, scale, shift, bits)
    want = fb.dgrad_int8_gemm_plain(*args, thresh=thresh, tile=tile,
                                    plan=plan)
    got = _model(*args, thresh, tile, plan)
    assert torch.equal(got[0], want[0])
    for g, ref in zip(got[1:], want[1:]):
        assert (g - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("mutate", ["lane", "row", "tap", "group"])
def test_card_kernel_model_fails_under_a_wrong_lane_row_tap_or_group(mutate):
    """The model's lane, row, tap and scale-group maps each decide its
    result: at 6x6 (tiles whose runs start off a multiple of 8, groups of
    72 lanes, so a group boundary inside most tiles) with a bits tensor,
    each mistake changes dx."""
    b, h, w, cin, cout, tile = 8, 6, 6, 40, 32, 72
    n = b * h * w
    rng = np.random.default_rng(7)
    g_q, g_amax, w_dg, ws_in, x, scale, shift, thresh, bits = _operands(
        rng, cin, cout, n, tile, "bits")
    plan = fb.fused_fwd_int8_plan(n, h, w, cout, cin)
    lay = plan.lay
    starts = [_live_before(lay, t * lay.bm) for t in range(lay.tiles)]
    ends = [_live_before(lay, (t + 1) * lay.bm) for t in range(lay.tiles)]
    assert any(s % 8 for s in starts)
    assert any(s // tile != (e - 1) // tile for s, e in zip(starts, ends))
    slab = fb.dgrad_int8_pre_plain(g_q, plan=plan)
    args = (slab, g_amax, w_dg, ws_in, x, scale, shift, bits)
    want = fb.dgrad_int8_gemm_plain(*args, thresh=thresh, tile=tile,
                                    plan=plan)
    assert torch.equal(_model(*args, thresh, tile, plan)[0], want[0])
    got = _model(*args, thresh, tile, plan, mutate)
    assert not torch.equal(got[0], want[0])


# --- the FQT op against JAX -------------------------------------------------------

def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("h,w,b", [(6, 6, 32), (8, 8, 32)])
@pytest.mark.parametrize("mode", ["bits", "seed"])
@pytest.mark.parametrize("use_res,want_stats", [(False, True), (True, False),
                                                (True, True)])
def test_fqt_backward_on_the_slab_route_matches_jax(h, w, b, mode, use_res,
                                                    want_stats, monkeypatch):
    """Gradients of a loss linear in (y, ysum, yssq) with the port's dgrad
    on the slab route (``dgrad_int8_pre_plain`` then
    ``dgrad_int8_gemm_plain``) against jax.grad of JAX's FQT op: dx and
    d(res) equal, dW within 1e-6 and d(scale), d(shift) within 1e-5 of
    their largest value (tests/test_torch_fused_block.py says why)."""
    c, n = 32, b * h * w
    rng = np.random.default_rng(h + 2 * use_res + len(mode))
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)  # noqa
    x, res, cy = (bf(rng.standard_normal((c, n))) for _ in range(3))
    wt = (rng.standard_normal((3, 3, c, c)) * (9 * c) ** -0.5).astype(
        np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    shift = (rng.standard_normal(c) * 0.3).astype(np.float32)
    cs, cq = (rng.standard_normal((2, c)) * 0.01).astype(np.float32)
    bits = rng.integers(0, 256, (c, n), dtype=np.uint8)
    seed = -123456789
    jbits = jnp.int32(seed) if mode == "seed" else jnp.asarray(bits)
    tbits = (torch.tensor(seed, dtype=torch.int32) if mode == "seed"
             else torch.from_numpy(bits))
    kw = dict(dropout_rate=0.3, h=h, w_img=w, want_stats=want_stats)

    def jloss(*a):
        y, ys, yq = jfb.fused_half_int8(
            *a[:4], jbits, a[4] if use_res else None, quant_bwd=True,
            interpret=True, **kw)
        loss = jnp.sum(y.astype(jnp.float32) * cy)
        if want_stats:
            loss = loss + jnp.sum(ys * cs) + jnp.sum(yq * cq)
        return loss

    jargs = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt),
             jnp.asarray(scale), jnp.asarray(shift),
             jnp.asarray(res, jnp.bfloat16))
    argnums = (0, 1, 2, 3, 4) if use_res else (0, 1, 2, 3)
    jgrads = jax.grad(jloss, argnums=argnums)(*jargs)

    routed = []

    def slab_route(g_q, g_amax, w_dg, ws_in, x, scale, shift, bits, *,
                   thresh, tile, h, w_img):
        plan = fb.fused_fwd_int8_plan(g_q.shape[1], h, w_img, g_q.shape[0],
                                      x.shape[0])
        routed.append(plan)
        return fb.dgrad_int8_gemm_plain(
            fb.dgrad_int8_pre_plain(g_q, plan=plan), g_amax, w_dg, ws_in, x,
            scale, shift, bits, thresh=thresh, tile=tile, plan=plan)

    monkeypatch.setattr(fb, "dgrad_conv", slab_route)
    targs = [_t(x, torch.bfloat16), _t(wt.transpose(3, 2, 0, 1)), _t(scale),
             _t(shift), _t(res, torch.bfloat16)]
    for t in targs:
        t.requires_grad_(True)
    y, ys, yq = fb.fused_half_int8(*targs[:4], tbits,
                                   targs[4] if use_res else None,
                                   quant_bwd=True, **kw)
    loss = (y.float() * _t(cy)).sum()
    if want_stats:
        loss = loss + (ys * _t(cs)).sum() + (yq * _t(cq)).sum()
    loss.backward()
    assert len(routed) == 1
    got = [targs[0].grad, targs[1].grad.permute(2, 3, 1, 0), targs[2].grad,
           targs[3].grad] + ([targs[4].grad] if use_res else [])
    for name, g, j in zip(["dx", "dW", "dscale", "dshift", "dres"], got,
                          jgrads):
        g, j = g.detach().float().numpy(), np.asarray(j, np.float32)
        assert g.shape == j.shape and np.abs(j).max() > 0, name
        if name in ("dx", "dres"):
            np.testing.assert_array_equal(g, j, err_msg=name)
        else:
            tol = 1e-6 if name == "dW" else 1e-5
            assert np.abs(g - j).max() <= tol * np.abs(j).max(), name


# --- the geometry rule --------------------------------------------------------------

@pytest.mark.parametrize("h,w,b", [(6, 6, 64), (5, 7, 8), (12, 12, 8),
                                   (24, 24, 2), (32, 32, 2)])
def test_the_fqt_dgrad_takes_any_width(h, w, b):
    """Image widths that are not multiples of 8 (the old card dgrad's row
    tiles needed rows of 8 pixels) pass the FQT dgrad's rule, with Cin !=
    Cout and scale groups of whole images."""
    n = b * h * w
    tile = next(k * h * w for k in range(1, b + 1) if k * h * w % 8 == 0
                and n % (k * h * w) == 0)
    fb.check_fwd_int8_geometry("fused_half_dgrad", 32, 48, n, h, w, tile)
    fb.fused_fwd_int8_plan(n, h, w, 32, 48)


def test_the_fqt_backward_takes_12x12_and_refuses_what_it_cannot_take():
    """The FQT backward's check (the op's, before its first launch) passes
    12x12 (the old row-tile dgrad refused it); it still refuses a Cout off
    32 (the dgrad's K steps), a Cin off 8 (its output runs) and images that
    are not a multiple of 16 positions (6x6, 5x7: the int8 wgrad's
    rule)."""
    fb._check_int8_backward.cache_clear()
    fb._check_int8_backward(True, 32, 32, 8 * 144, 12, 12)
    fb._check_int8_backward(True, 64, 32, 16 * 144, 12, 12)
    with pytest.raises(ValueError, match="Cin=48, Cout=32"):
        fb._check_int8_backward(True, 32, 48, 16 * 64, 8, 8)
    with pytest.raises(ValueError, match="Cin=32, Cout=36"):
        fb._check_int8_backward(True, 36, 32, 16 * 64, 8, 8)
    with pytest.raises(ValueError, match="geometry H=6 W=6"):
        fb._check_int8_backward(True, 32, 32, 64 * 36, 6, 6)
    with pytest.raises(ValueError):
        fb._check_int8_backward(True, 32, 32, 8 * 35, 5, 7)
    with pytest.raises(ValueError, match="scale group of 36 lanes"):
        fb.check_fwd_int8_geometry("fused_half_dgrad", 32, 32, 2 * 36, 6, 6,
                                   36)


# --- the profile's kinds ---------------------------------------------------------

def test_profile_kinds_count_the_new_kernels_as_the_fused_int8_halfs():
    """chip_smoke.py's kernel kinds by demangled name: the FQT dgrad's slab
    copy and s8 wgmma GEMM and the tiles' sum are the fused int8 half's;
    the kinds that came before them keep their kernels."""
    import chip_smoke

    want = {
        "void dgrad_wgmma_s8::dgrad_s8_kernel<160, 32>(fwd_wgmma_s8::Maps, "
        "dgrad_wgmma_s8::Args, dgrad_wgmma_bf16::Epi)":
        "fused int8 half (port)",
        "void dgrad_wgmma_s8::dgrad_s8_kernel<64, 96>(fwd_wgmma_s8::Maps, "
        "dgrad_wgmma_s8::Args, dgrad_wgmma_bf16::Epi)":
        "fused int8 half (port)",
        "void fused_half::slab_copy_kernel<signed char>(signed char const*, "
        "signed char*, fused_half::SlabPos, fused_half::PadPos, int, int, "
        "int, int, long)": "fused int8 half (port)",
        "void common::tile_sum_kernel<void>(float const*, float*, int, int)":
        "fused int8 half (port)",
        "void fused_half::quant_kernel<fused_half::Cotangent, "
        "fused_half::Prologue>(fused_half::Cotangent, int, "
        "fused_half::GroupWalk, fused_half::QuantOut, fused_half::Prologue, "
        "int, fused_half::GroupWalk, fused_half::QuantOut, float const*)":
        "fused int8 half (port)",
        "void dgrad_wgmma_bf16::fused_dgrad_gemm_kernel<160>("
        "fwd_wgmma_bf16::Args, dgrad_wgmma_bf16::Epi)":
        "fused bf16 half (port)",
        "void common::tile_sum_kernel<FusedDgradSum>(float const*, float*, "
        "int, int)": "fused bf16 half (port)",
        "void (anonymous namespace)::dgrad::dgrad_kernel<true, 32>("
        "fwd_wgmma_s8::Maps, fwd_wgmma_bf16::Args, fwd_wgmma_bf16::Args, "
        "(anonymous namespace)::dgrad::Args)": "transition (port)",
        "void (anonymous namespace)::dgrad::dgrad_pre_kernel<signed char>("
        "signed char const*, signed char*, unsigned short const*, unsigned "
        "short*, fused_half::SlabPos, fused_half::PadPos, int, int, int, "
        "int, int, long, long)": "transition (port)",
    }
    for name, kind in want.items():
        assert chip_smoke.kernel_kind(name) == kind, name
        assert chip_smoke.kernel_kind(
            name, chip_smoke.WRN_KERNEL_KINDS) == kind, name
