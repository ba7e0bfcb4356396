"""The fused bf16 block-half's input gradient on the slab route
(ops/cuda/fused_block.py ``dgrad_bf16_pre``, ``dgrad_bf16_gemm``,
``dgrad_bf16``; kernels in csrc/fused_block_bf16.cu and
csrc/dgrad_wgmma_bf16.cuh), on the CPU:

- the prepass's plain version writes g = bf16(gf) at each pixel's
  position of the forward's slab (the layout at Cin = the half's Cout) and
  zeros at every pad position, and dres = g where asked;
- the plain prepass and GEMM composed equal ``dgrad_bf16_plain`` bit for
  bit (dx, d(scale), d(shift), dres) at 6x6, 5x7, 12x12 and 32x32 images
  with Cin != Cout, in the three bits modes: the float64 contraction of
  bf16 products is exact in both, so the same f32 accumulator goes through
  the same masks;
- a numpy model of the card GEMM's epilogue (each 128-row tile's run of
  lanes and each row's place in it, f32 staged channel-major from the
  run's lead, 8-lane units read at their global lane, dx written inside
  the run only, each unit's sums in lane order, the units in order, the
  tiles in ``common::tile_sum``'s 32 runs) gives the plain version's dx
  bit for bit and its sums within 1e-5 of their largest value (another
  order of f32 additions), and no longer does with a wrong lane, a wrong
  row or a wrong tap;
- ``fused_half`` and ``fused_half_int8(quant_bwd=False)`` with the dgrad
  on the slab route against JAX's with ``interpret=True`` at 6x6 images,
  batch 64 (the fused gate admits them; the old card dgrad refused
  them), the bf16 op's backward on JAX's y: bf16 outputs within 2 bf16
  ulps of their largest value, f32 sums within 1e-5
  (tests/test_torch_fused_half_bf16.py says why);
- the geometry rule: the bf16 backward takes what the forward takes
  (``check_fwd_bf16_geometry``, Cin and Cout swapped), any image width.

Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu.ops.pallas import fused_block as jfb
from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb

# (batch, h, w, Cin, Cout) of the half: widths that are not multiples of 8
# (6x6, 5x7, 12x12) and 32x32, Cin != Cout (a ragged 64-wide N tile)
GEOS = [(4, 6, 6, 32, 48), (8, 5, 7, 32, 48), (2, 12, 12, 32, 48),
        (2, 32, 32, 32, 48)]
MODES = ["none", "bits", "seed"]


def _operands(rng, cin, cout, n, mode, stats):
    """(dy, y, dysum, dyssq, w_dg, x, scale, shift, thresh, bits)."""
    def bf(shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(
            np.float32)).to(torch.bfloat16)

    x = bf((cin, n))
    wt = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3))
                           * (9 * cin) ** -0.5).astype(np.float32))
    w_dg = fb.pack_weights_dgrad(wt.to(torch.bfloat16))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cin).astype(np.float32))
    shift = torch.from_numpy((rng.standard_normal(cin) * 0.3).astype(
        np.float32))
    dy = bf((cout, n), 1e-3)
    y = bf((cout, n)) if stats else None
    dysum, dyssq = ((torch.from_numpy((rng.standard_normal(cout) * 1e-4
                                       ).astype(np.float32))
                     for _ in range(2)) if stats else (None, None))
    thresh, bits = None, None
    if mode == "bits":
        thresh = fb.dropout_thresh(0.3)
        bits = torch.from_numpy(rng.integers(0, 256, (cin, n),
                                             dtype=np.uint8))
    elif mode == "seed":
        thresh = fb.dropout_thresh(0.3)
        bits = torch.tensor(-987654321, dtype=torch.int32)
    return dy, y, dysum, dyssq, w_dg, x, scale, shift, thresh, bits


@pytest.mark.parametrize("b,h,w,cin,cout", GEOS)
@pytest.mark.parametrize("stats", [True, False])
def test_pre_plain_writes_g_at_the_pixels_and_zeros_elsewhere(b, h, w, cin,
                                                              cout, stats):
    n = b * h * w
    rng = np.random.default_rng(n + cout)
    dy, y, dysum, dyssq = _operands(rng, cin, cout, n, "none", stats)[:4]
    lay = fb.fused_fwd_layout(n, h, w, cout, cin)
    assert (lay.cin, lay.cout, lay.cp) == (cout, cin, cout)
    assert lay.bn == (160 if cin % 160 == 0 else 128 if cin > 64 else 64)
    g = fb.fold_cotangent_plain(dy, y, dysum, dyssq).to(torch.bfloat16)
    for emit_res in (True, False):
        slab, dres = fb.dgrad_bf16_pre(dy, y, dysum, dyssq, lay=lay,
                                       emit_res=emit_res)
        assert slab.dtype == torch.bfloat16 and slab.is_contiguous()
        assert tuple(slab.shape) == (lay.slab_len, cout)
        live = fb.fused_fwd_live_rows(lay) + lay.guard
        assert torch.equal(slab[live], g.t())
        pads = np.setdiff1d(np.arange(lay.slab_len), live.numpy())
        assert len(pads) == lay.slab_len - n and not slab[pads].any()
        if emit_res:
            assert torch.equal(dres, g)
        else:
            assert dres is None


@pytest.mark.parametrize("b,h,w,cin,cout", GEOS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("stats", [True, False])
def test_pre_and_gemm_plain_equal_dgrad_bf16_plain(b, h, w, cin, cout, mode,
                                                   stats):
    n = b * h * w
    rng = np.random.default_rng(n + cout + len(mode))
    ops = _operands(rng, cin, cout, n, mode, stats)
    dy, y, dysum, dyssq, w_dg, x, scale, shift, thresh, bits = ops
    kw = dict(thresh=thresh, h=h, w_img=w, emit_res=stats)
    want = fb.dgrad_bf16_plain(dy, y, dysum, dyssq, w_dg, x, scale, shift,
                               bits, **kw)
    assert want[0].float().abs().max() > 0
    lay = fb.fused_fwd_layout(n, h, w, cout, cin)
    slab, dres = fb.dgrad_bf16_pre_plain(dy, y, dysum, dyssq, lay=lay,
                                         emit_res=stats)
    got = fb.dgrad_bf16_gemm_plain(slab, w_dg, x, scale, shift, bits,
                                   thresh=thresh, lay=lay)
    assert got[0].dtype == torch.bfloat16
    for a, b_ in zip((*got, dres), want):
        assert (a is None and b_ is None) or torch.equal(a, b_)
    # on the CPU the wrappers are the plain versions, at any width
    got = fb.dgrad_bf16_gemm(fb.dgrad_bf16_pre(
        dy, y, dysum, dyssq, lay=lay, emit_res=False)[0], w_dg, x, scale,
        shift, bits, thresh=thresh, lay=lay)
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


# --- a model of the card epilogue ---------------------------------------------

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


def _model(slab, w_dg, x, scale, shift, bits, thresh, lay, mutate=None):
    """(dx, d(scale), d(shift)) as the card kernel computes them: the
    accumulators of every M row (float64, exact for bf16 products, then
    f32), per tile staged channel-major at lead + at[row], the 8-lane units
    of each channel's run masked at their global lanes, dx written inside
    the run, each unit's sums in lane order, the units' in order, the
    tiles' in runs. ``mutate``: "lane" reads x and the bits from the run's
    first lane instead of its 8-aligned base, "row" stages each live row
    one place late, "tap" mirrors the taps' columns."""
    f32 = np.float32
    cin, kc, n = lay.cout, lay.cin, lay.n
    shifts = list(lay.shifts)
    if mutate == "tap":
        shifts = [lay.shifts[3 * (t // 3) + 2 - t % 3] for t in range(9)]
    a = slab.to(torch.float64).numpy()
    wt = w_dg.to(torch.float64).numpy().reshape(cin, 9, kc)
    rows = np.arange(lay.tiles * lay.bm)
    acc = sum(a[rows + sh, :kc] @ wt[:, t].T
              for t, sh in enumerate(shifts)).astype(f32)   # [M, Cin]
    xs = x.float().numpy()
    sc, sh = scale.numpy().astype(f32), shift.numpy().astype(f32)
    drop = fb.mask_bits(bits, cin, n)
    drop = None if drop is None else drop.numpy().astype(np.int32)
    keep = f32(fb.inv_keep(thresh)) if drop is not None else f32(1)
    dx = np.zeros((cin, n), np.float32)
    parts = []
    for tile in range(lay.tiles):
        m0 = tile * lay.bm
        lane0 = _live_before(lay, m0)
        count = _live_before(lay, m0 + lay.bm) - lane0
        lead = lane0 % 8
        staged = np.zeros((cin, CF_OS), f32)
        for r in range(lay.bm):
            k = _live_before(lay, m0 + r)
            if _live_before(lay, m0 + r + 1) > k:
                staged[:, lead + k - lane0 + (mutate == "row")] = \
                    acc[m0 + r]
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
        for t in range(q * per, min(lay.tiles, (q + 1) * per)):
            s = s + parts[t]
        runs.append(s)
    tot = runs[0]
    for s in runs[1:]:
        tot = tot + s
    return (torch.from_numpy(dx).to(torch.bfloat16),
            torch.from_numpy(tot[:cin]), torch.from_numpy(tot[cin:]))


@pytest.mark.parametrize("b,h,w,cin,cout", [(4, 6, 6, 48, 32),
                                            (8, 5, 7, 32, 48),
                                            (2, 12, 12, 24, 16),
                                            (1, 32, 32, 16, 16)])
@pytest.mark.parametrize("mode", MODES)
def test_card_epilogue_model_equals_the_plain_gemm(b, h, w, cin, cout,
                                                   mode):
    n = b * h * w
    rng = np.random.default_rng(n + cin)
    ops = _operands(rng, cin, cout, n, mode, True)
    dy, y, dysum, dyssq, w_dg, x, scale, shift, thresh, bits = ops
    lay = fb.fused_fwd_layout(n, h, w, cout, cin)
    slab, _ = fb.dgrad_bf16_pre_plain(dy, y, dysum, dyssq, lay=lay,
                                      emit_res=False)
    want = fb.dgrad_bf16_gemm_plain(slab, w_dg, x, scale, shift, bits,
                                    thresh=thresh, lay=lay)
    got = _model(slab, w_dg, x, scale, shift, bits, thresh, lay)
    assert torch.equal(got[0], want[0])
    for g, ref in zip(got[1:], want[1:]):
        assert (g - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("mutate", ["lane", "row", "tap"])
def test_card_epilogue_model_fails_under_a_wrong_lane_row_or_tap(mutate):
    """The model's lane, row and tap maps each decide its result: at 6x6
    (tiles whose runs start off a multiple of 8) with a bits tensor, each
    mistake changes dx."""
    b, h, w, cin, cout = 4, 6, 6, 48, 32
    n = b * h * w
    rng = np.random.default_rng(7)
    ops = _operands(rng, cin, cout, n, "bits", True)
    dy, y, dysum, dyssq, w_dg, x, scale, shift, thresh, bits = ops
    lay = fb.fused_fwd_layout(n, h, w, cout, cin)
    assert any(_live_before(lay, t * lay.bm) % 8 for t in range(lay.tiles))
    slab, _ = fb.dgrad_bf16_pre_plain(dy, y, dysum, dyssq, lay=lay,
                                      emit_res=False)
    want = fb.dgrad_bf16_gemm_plain(slab, w_dg, x, scale, shift, bits,
                                    thresh=thresh, lay=lay)
    assert torch.equal(_model(slab, w_dg, x, scale, shift, bits, thresh,
                              lay)[0], want[0])
    got = _model(slab, w_dg, x, scale, shift, bits, thresh, lay, mutate)
    assert not torch.equal(got[0], want[0])


# --- the ops against JAX at a width the old card dgrad refused -------------------

def _jax_and_port(quant, mode, use_res, want_stats, monkeypatch):
    """Forward and backward of one half at 6x6, batch 64, C = 32, on both
    sides, for a loss linear in (y, ysum, yssq); the port's dgrad on the
    slab route (``dgrad_bf16_pre_plain`` then ``dgrad_bf16_gemm_plain``).
    The QAT op runs forward and backward end to end (its int8 y equals
    JAX's). The bf16 op's y may differ from JAX's by an ulp at a rounding
    boundary, and the stats fold carries y into g = bf16(gf), so its
    backward (``_bf16_backward``, the function both ops' backward calls)
    runs on JAX's y. Returns the JAX and the port's (outputs, grads) as
    numpy."""
    c, b, h, w = 32, 64, 6, 6
    n = b * h * w
    rng = np.random.default_rng(int(quant) + 2 * use_res + len(mode))

    def bf(shape, s=1.0):
        return np.asarray(jnp.asarray(rng.standard_normal(shape) * s,
                                      jnp.bfloat16), np.float32)

    x, res, cy = bf((c, n)), bf((c, n)), bf((c, n))
    wt = (rng.standard_normal((3, 3, c, c)) * (9 * c) ** -0.5).astype(
        np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    shift = (rng.standard_normal(c) * 0.3).astype(np.float32)
    cs, cq = (rng.standard_normal((2, c)) * 0.01).astype(np.float32)
    bits = rng.integers(0, 256, (c, n), dtype=np.uint8)
    rate = 0.3 if mode != "none" else 0.0
    jbits = (None if mode == "none" else jnp.int32(-123456789)
             if mode == "seed" else jnp.asarray(bits))
    tbits = (None if mode == "none"
             else torch.tensor(-123456789, dtype=torch.int32)
             if mode == "seed" else torch.from_numpy(bits))
    kw = dict(dropout_rate=rate, h=h, w_img=w, want_stats=want_stats)
    extra = {"quant_bwd": False} if quant else {}
    jop = jfb.fused_half_int8 if quant else jfb.fused_half
    top = fb.fused_half_int8 if quant else fb.fused_half

    def jloss(*a):
        y, ys, yq = jop(*a[:4], jbits, a[4] if use_res else None,
                        interpret=True, **kw, **extra)
        loss = jnp.sum(y.astype(jnp.float32) * cy)
        if want_stats:
            loss = loss + jnp.sum(ys * cs) + jnp.sum(yq * cq)
        return loss, (y, ys, yq)

    jargs = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt),
             jnp.asarray(scale), jnp.asarray(shift),
             jnp.asarray(res, jnp.bfloat16))
    argnums = (0, 1, 2, 3, 4) if use_res else (0, 1, 2, 3)
    jgrads, jout = jax.grad(jloss, argnums=argnums, has_aux=True)(*jargs)

    routed = []

    def slab_route(dy, y, dysum, dyssq, w_dg, x, scale, shift, bits, *,
                   thresh, h, w_img, emit_res):
        lay = fb.fused_fwd_layout(dy.shape[1], h, w_img, dy.shape[0],
                                  x.shape[0])
        slab, dres = fb.dgrad_bf16_pre_plain(dy, y, dysum, dyssq, lay=lay,
                                             emit_res=emit_res)
        routed.append(lay)
        return (*fb.dgrad_bf16_gemm_plain(slab, w_dg, x, scale, shift,
                                          bits, thresh=thresh, lay=lay),
                dres)

    monkeypatch.setattr(fb, "dgrad_bf16", slab_route)
    targs = [torch.from_numpy(x).to(torch.bfloat16),
             torch.from_numpy(wt.transpose(3, 2, 0, 1).copy()),
             torch.from_numpy(scale), torch.from_numpy(shift),
             torch.from_numpy(res).to(torch.bfloat16)]
    tres = targs[4] if use_res else None
    if quant:
        for t in targs:
            t.requires_grad_(True)
        y, ys, yq = top(*targs[:4], tbits, tres, **kw, **extra)
        loss = (y.float() * torch.from_numpy(cy)).sum()
        if want_stats:
            loss = loss + (ys * torch.from_numpy(cs)).sum() + (
                yq * torch.from_numpy(cq)).sum()
        loss.backward()
        tgrads = [t.grad for t in targs]
    else:
        y, ys, yq = top(*targs[:4], tbits, tres, **kw)
        jy = torch.from_numpy(np.asarray(jout[0], np.float32)).to(
            torch.bfloat16)
        dx, dw, ds, dt, dres = fb._bf16_backward(
            torch.from_numpy(cy).to(torch.bfloat16),
            torch.from_numpy(cs) if want_stats else None,
            torch.from_numpy(cq) if want_stats else None, *targs[:4],
            tbits, jy if want_stats else None,
            fb.dropout_thresh(rate) if mode != "none" else None, h, w,
            want_stats, use_res)
        tgrads = [dx, dw, ds, dt, dres]
    assert len(routed) == 1
    tgrads = [tgrads[0], tgrads[1].permute(2, 3, 1, 0)] + tgrads[2:4] + (
        [tgrads[4]] if use_res else [])
    return ((jout, jgrads),
            ([t if t is None else t.detach().float().numpy()
              for t in (y, ys, yq)],
             [t.detach().float().numpy() for t in tgrads]))


def _ulp_ok(got, want, name):
    """Within 2 bf16 ulps of the tensor's largest value."""
    top = np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert np.abs(got - want).max() <= 2 * ulp, name


def _sum_ok(got, want, name):
    """Within 1e-5 of the largest value: f32 sums in another order."""
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), name


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("mode", ["bits", "seed"])
@pytest.mark.parametrize("use_res,want_stats", [(False, True), (True, True)])
def test_ops_match_jax_at_6x6(quant, mode, use_res, want_stats,
                              monkeypatch):
    (jout, jgrads), (tout, tgrads) = _jax_and_port(quant, mode, use_res,
                                                   want_stats, monkeypatch)
    jy = np.asarray(jout[0], np.float32)
    if quant:
        np.testing.assert_array_equal(tout[0], jy)
    else:
        _ulp_ok(tout[0], jy, "y")
    _sum_ok(tout[1], np.asarray(jout[1]), "ysum")
    _sum_ok(tout[2], np.asarray(jout[2]), "yssq")
    for name, g, jg in zip(["dx", "dW", "dscale", "dshift", "dres"], tgrads,
                           jgrads):
        jg = np.asarray(jg, np.float32)
        assert g.shape == jg.shape and np.abs(jg).max() > 0, name
        (_ulp_ok if name in ("dx", "dres") else _sum_ok)(g, jg, name)


# --- the geometry rule --------------------------------------------------------------

@pytest.mark.parametrize("h,w,b", [(6, 6, 64), (5, 7, 8), (12, 12, 8),
                                   (24, 24, 2), (32, 32, 2)])
def test_the_bf16_backward_takes_any_width(h, w, b):
    """Image widths that are not multiples of 8 (the old card dgrad's row
    tiles needed rows of 8 pixels) pass the bf16 dgrad's rule and the QAT
    backward's check, with Cin != Cout."""
    n = b * h * w
    fb.check_fwd_bf16_geometry("fused_half_bf16_dgrad", 48, 32, n, h, w)
    fb._check_int8_backward.cache_clear()
    fb._check_int8_backward(False, 32, 48, n, h, w)


def test_the_bf16_backward_refuses_what_its_kernels_cannot_take():
    fb._check_int8_backward.cache_clear()
    with pytest.raises(ValueError, match="Cin=44, Cout=32"):
        fb._check_int8_backward(False, 32, 44, 8 * 36, 6, 6)
    with pytest.raises(ValueError, match="geometry H=5 W=7 N=105"):
        fb._check_int8_backward(False, 32, 32, 3 * 35, 5, 7)
    with pytest.raises(ValueError, match="geometry H=6 W=6"):
        fb._check_int8_backward(False, 32, 32, 100, 6, 6)
    with pytest.raises(ValueError, match="tiles exceed the grid"):
        fb._check_int8_backward(False, 32, 32, 8192 * 1024, 32, 32)
