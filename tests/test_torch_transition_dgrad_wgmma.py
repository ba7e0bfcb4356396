"""The lane transition's input gradient as the card runs it
(ops/cuda/transition.py ``dgrad_pre``, ``dgrad_gemm`` on
``transition_dgrad_layout``; csrc/transition.cu ``dgrad_pre_kernel``,
``dgrad_kernel``), on the CPU: the layout's slab, each parity class's tap
range, row offsets and weight columns, and the row-to-lane map of the
epilogue, walked in float64 (``dgrad_gemm_plain``), against
``dgrad_plain`` and, through the op, JAX's ``transition_half_int8``
backward (``interpret=True``); a numpy model of the card epilogue's units;
the geometry rule.

Tolerances: the walk sums the same products as ``dgrad_plain``'s float64
transposed conv (exact for int8 operands; bf16 products summed in float64
round to the same f32 at these sizes) and applies the same f32 epilogue,
so dx, d(scale) and d(shift) are equal. Against JAX the tolerances of
tests/test_torch_transition.py: the straight-through dx within 2 bf16 ulps
and the f32 gradients within 1e-4 of their largest value; the FQT body
within twice the reference's own distance from the exact float backward.
The epilogue model's dx is equal (the same f32 operations per element),
its sums, taken unit by unit and then over the units, within 1e-5 of the
largest value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu.ops.pallas import transition as jt
from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
from pytorch_ddp_resnet_tpu_torch.ops.cuda import transition as tr

RATE = 0.3
# (batch, h, w, Cin, Cout): the test shape; 24x24 and 12x12 inputs (12x12
# and 6x6 outputs, rows off 8 pixels) at Cout = 40, off the 32-channel
# chunks; the batch is the least at which the JAX picker finds a lane tile
SHAPES = [(2, 16, 16, 32, 64), (8, 24, 24, 32, 40), (32, 12, 12, 32, 40)]


def _bf(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _operands(b, h, w, cin, cout, quant, proj, rate, seed=0):
    """The dgrad's operands from a seed (numpy): g (int8 codes with the
    group absmax, or bf16), the dgrad-packed weights (with ws_in for
    FQT), x, scale, shift, bits ([Cin, N] lane order or None), dres, wpt
    (or None); and the scale group."""
    rng = np.random.default_rng(seed)
    n = b * h * w
    n_out = n // 4
    tile = tr.transition_tile(h // 2, w // 2, n_out, cin, cout)
    x = _bf(rng.standard_normal((cin, n)))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cin).astype(np.float32))
    shift = torch.from_numpy((rng.standard_normal(cin) * 0.3).astype(
        np.float32))
    bits = (torch.from_numpy(rng.integers(0, 256, (cin, n), dtype=np.uint8))
            if rate else None)
    w1 = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3))
                           * (9 * cin) ** -0.5).astype(np.float32))
    dres = _bf(rng.standard_normal((cout, n_out)) * 1e-3)
    wpt = (_bf(rng.standard_normal((cin, cout)) * cin ** -0.5) if proj
           else None)
    gf = torch.from_numpy((rng.standard_normal((cout, n_out)) * 1e-3
                           * np.exp(rng.standard_normal(n_out // tile)
                                    ).repeat(tile)).astype(np.float32))
    if quant:
        g, g_amax = fb.quantize_groups_plain(gf, tile, fb.BWD_FLOOR)
        w_dg, ws_in = tr.quant_pack_w_dgrad(w1)
    else:
        g, g_amax = gf.to(torch.bfloat16), None
        w_dg, ws_in = tr.pack_w_dgrad(w1.to(torch.bfloat16)), None
    return (g, g_amax, w_dg, ws_in, x, scale, shift, bits, dres, wpt), tile


def _walk(g, g_amax, w_dg, ws_in, x, scale, shift, bits, dres, wpt, *,
          thresh, tile, h, w_img):
    """The card's route on the CPU: the layout's slabs, then its walk."""
    lay = tr.transition_dgrad_layout(x.shape[1], h, w_img, x.shape[0],
                                     g.shape[0], tile, g_amax is not None)
    gslab, dslab = tr.dgrad_pre_plain(g, dres if wpt is not None else None,
                                      lay)
    return tr.dgrad_gemm_plain(gslab, dslab, g_amax, w_dg, ws_in, x, scale,
                               shift, bits, dres, wpt, thresh=thresh,
                               lay=lay)


# --- the layout --------------------------------------------------------------

@pytest.mark.parametrize("b,h,w,cin,cout", SHAPES + [
    (128, 32, 32, 160, 320), (128, 16, 16, 320, 640)])
@pytest.mark.parametrize("quant", [True, False])
def test_layout_classes_are_the_stride2_taps(b, h, w, cin, cout, quant):
    """Every class's taps, row offsets and weight columns from the
    stride-2 conv itself: input pixel (y, x) of class p takes tap (dh, dw)
    from output pixel ((y + 1 - dh) / 2, (x + 1 - dw) / 2), and that pixel's
    slab row, past the image the next image's zero row or the next row's
    zero column; the weights' plane-major columns hold the class's taps in
    row-major order. The slab is the fused forward's layout at the output
    geometry."""
    n = b * h * w
    tile = tr.transition_tile(h // 2, w // 2, n // 4, cin, cout)
    lay = tr.transition_dgrad_layout(n, h, w, cin, cout, tile, quant)
    oh, ow = h // 2, w // 2
    fl = fb.fused_fwd_layout(n // 4, oh, ow, cout, cin)
    assert (lay.guard, lay.tiles, lay.slab_len, lay.per_img) == (
        fl.guard, fl.tiles, fl.slab_len, fl.per_img) == (
        ow + 2, -(-b * (oh + 1) * (ow + 1) // 128),
        2 * (ow + 2) + fl.tiles * 128, (oh + 1) * (ow + 1))
    assert lay.cp == (-(-cout // 32) * 32 if quant else cout)
    assert [c[1] for c in lay.classes] == [1, 2, 2, 4]
    assert [c[0] for c in lay.classes] == [0, 1, 3, 5]
    pw_ = ow + 1

    def slab_row(i, r, c):   # output pixel (i, r, c), zero rows past it
        return lay.guard + i * lay.per_img + (r + 1) * pw_ + c + 1

    for p, (first, count, offs) in enumerate(lay.classes):
        ph, pw = divmod(p, 2)
        taps = tr.PLANE_TAPS[p]
        assert count == len(taps) and len(offs) == count
        for j, (dh, dw) in enumerate(taps):
            # the plane-major weights: column block first + j is tap (dh, dw)
            assert [t for ts in tr.PLANE_TAPS for t in ts][first + j] == (
                dh, dw)
            for r, c in ((0, 0), (oh - 1, ow - 1), (oh - 1, 0), (0, ow - 1)):
                y, x = 2 * r + ph, 2 * c + pw
                sr, sc = (y + 1 - dh) // 2, (x + 1 - dw) // 2
                assert (y + 1 - dh) % 2 == 0 and (x + 1 - dw) % 2 == 0
                got = slab_row(0, r, c) + offs[j]
                if sr < oh and sc < ow:
                    assert got == slab_row(0, sr, sc)
                else:  # past the image: a zero row or column of the slab
                    i_, rem = divmod(got - lay.guard, lay.per_img)
                    assert rem // pw_ == 0 or rem % pw_ == 0


@pytest.mark.parametrize("b,h,w,cin,cout", SHAPES)
def test_prepass_plain_is_the_slab(b, h, w, cin, cout):
    """g's slab: each output pixel's channels at its position, zeros at
    every pad position and pad channel (the int8 layout pads Cout to 32);
    dres's slab likewise at Cout channels."""
    (g, _, _, _, _, _, _, _, dres, _), tile = _operands(
        b, h, w, cin, cout, True, True, 0.0)
    lay = tr.transition_dgrad_layout(b * h * w, h, w, cin, cout, tile, True)
    gslab, dslab = tr.dgrad_pre_plain(g, dres, lay)
    assert gslab.shape == (lay.slab_len, lay.cp) and gslab.dtype == g.dtype
    assert dslab.shape == (lay.slab_len, cout)
    rows = tr._out_rows(lay) + lay.guard
    assert torch.equal(gslab[rows, :cout].t(), g)
    assert torch.equal(dslab[rows].t(), dres)
    pads = torch.ones(lay.slab_len, dtype=torch.bool)
    pads[rows] = False
    assert not gslab[pads].any() and not gslab[:, cout:].any()
    assert not dslab[pads].float().any()


# --- the walk against dgrad_plain and JAX ------------------------------------

@pytest.mark.parametrize("b,h,w,cin,cout", SHAPES)
@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("proj,rate", [(True, RATE), (False, 0.0)])
def test_walk_matches_plain(b, h, w, cin, cout, quant, proj, rate):
    """The layout walk (slabs, class tap ranges, row offsets, weight
    columns, row-to-lane map) equals dgrad_plain's transposed conv: both
    bodies, projection or option A, with and without bits."""
    args, tile = _operands(b, h, w, cin, cout, quant, proj, rate)
    thresh = fb.dropout_thresh(rate) if rate else None
    kw = dict(thresh=thresh, tile=tile, h=h, w_img=w)
    got = _walk(*args, **kw)
    want = tr.dgrad_plain(*args, **kw)
    for a, b_ in zip(got, want):
        assert a.dtype == b_.dtype and torch.equal(a, b_)


def _jax_and_port(b, h, w, cin, cout, quant, proj, monkeypatch):
    """(port grads through the walk, JAX grads, the exact float64 grads)
    of the op with cotangents on all four outputs, in numpy."""
    rng = np.random.default_rng(7)
    n = b * h * w
    x = np.asarray(_bf(rng.standard_normal((cin, n))).float())
    w1 = (rng.standard_normal((3, 3, cin, cout)) * (9 * cin) ** -0.5).astype(
        np.float32)
    wp = ((rng.standard_normal((cin, cout)) * cin ** -0.5).astype(np.float32)
          if proj else None)
    scale = rng.uniform(0.5, 1.5, cin).astype(np.float32)
    shift = (rng.standard_normal(cin) * 0.3).astype(np.float32)
    bits = rng.integers(0, 256, (4 * cin, n // 4), dtype=np.uint8)
    cts = [np.asarray(_bf(rng.standard_normal((cout, n // 4)) * 1e-2
                          ).float()),
           (rng.standard_normal(cout) * 1e-3).astype(np.float32),
           (rng.standard_normal(cout) * 1e-4).astype(np.float32),
           np.asarray(_bf(rng.standard_normal((cout, n // 4)) * 1e-2
                          ).float())]

    def jf(x_, w_, wp_, s_, t_):
        return jt.transition_half_int8(x_, w_, wp_, s_, t_, jnp.asarray(bits),
                                       dropout_rate=RATE, h=h, w_img=w,
                                       quant_bwd=quant, interpret=True)

    import jax
    jargs = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(w1),
             None if wp is None else jnp.asarray(wp), jnp.asarray(scale),
             jnp.asarray(shift))
    _, vjp = jax.vjp(jf, *jargs)
    jg = vjp((jnp.asarray(cts[0], jnp.bfloat16), jnp.asarray(cts[1]),
              jnp.asarray(cts[2]), jnp.asarray(cts[3], jnp.bfloat16)))

    monkeypatch.setattr(tr, "dgrad", _walk)
    xt = _bf(x).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(w1.transpose(3, 2, 0, 1))
                          ).requires_grad_()
    wpt = (None if wp is None else torch.from_numpy(np.ascontiguousarray(
        wp.T)).reshape(cout, cin, 1, 1).requires_grad_())
    st = torch.from_numpy(scale).requires_grad_()
    sh = torch.from_numpy(shift).requires_grad_()
    out = tr.transition_half_int8(xt, wt, wpt, st, sh, torch.from_numpy(bits),
                                  dropout_rate=RATE, h=h, w_img=w,
                                  quant_bwd=quant)
    tcts = [_bf(cts[0]), torch.from_numpy(cts[1]), torch.from_numpy(cts[2]),
            _bf(cts[3])]
    ins = [xt, wt] + ([wpt] if wpt is not None else []) + [st, sh]
    tg = list(torch.autograd.grad(out, ins, tcts))
    tg = [tg[0], tg[-2], tg[-1]]   # dx, d(scale), d(shift)
    jg = [jg[0], jg[3], jg[4]]
    exact = None
    if quant:   # the float backward in float64, for the FQT noise floor
        f64 = torch.float64
        xe = torch.from_numpy(x).to(f64).requires_grad_()
        se = torch.from_numpy(scale).to(f64).requires_grad_()
        he = torch.from_numpy(shift).to(f64).requires_grad_()
        d = torch.clamp_min(xe * se[:, None] + he[:, None], 0)
        lb = tr.parity_unpack(torch.from_numpy(bits), h, w).to(torch.int32)
        thresh = fb.dropout_thresh(RATE)
        d = torch.where(lb < thresh, d * (256.0 / thresh), 0 * d)
        we = torch.from_numpy(np.ascontiguousarray(
            w1.transpose(3, 2, 0, 1))).to(f64)
        z = tr._lanes(torch.nn.functional.conv2d(
            tr._nchw(d, h, w), we, stride=2, padding=1))
        ee = tr.parity_planes(xe, h, w)[0]
        res = (torch.from_numpy(wp).to(f64).t() @ ee if wp is not None
               else torch.nn.functional.pad(ee, (0, 0, 0, cout - cin)))
        c = [torch.from_numpy(v).to(f64) for v in cts]
        loss = ((z * c[0]).sum() + (z.sum(1) * c[1]).sum()
                + ((z * z).sum(1) * c[2]).sum() + (res * c[3]).sum())
        exact = [v.numpy() for v in torch.autograd.grad(loss, [xe, se, he])]
    return ([t.detach().float().numpy() for t in tg],
            [np.asarray(a, np.float32) for a in jg], exact)


@pytest.mark.parametrize("b,h,w,cin,cout,proj", [
    (8, 16, 16, 32, 64, True), (8, 16, 16, 32, 64, False),
    (8, 24, 24, 32, 40, True), (32, 12, 12, 32, 40, True)])
@pytest.mark.parametrize("quant", [True, False])
def test_walk_through_the_op_matches_jax(b, h, w, cin, cout, proj, quant,
                                         monkeypatch):
    """The op's backward with its dgrad on the walk against JAX's
    transition_half_int8 backward (dropout on, cotangents on all four
    outputs): dx, d(scale), d(shift)."""
    got, want, exact = _jax_and_port(b, h, w, cin, cout, quant, proj,
                                     monkeypatch)
    for name, g, j, i in zip(("dx", "dscale", "dshift"), got, want,
                             range(3)):
        assert g.shape == j.shape, name
        if quant:
            noise = np.linalg.norm(j.astype(np.float64) - exact[i])
            d = np.linalg.norm(g.astype(np.float64) - j)
            assert d <= 2 * noise + 1e-3 * np.linalg.norm(exact[i]), name
        elif name == "dx":
            top = np.abs(j).max()
            assert np.abs(g - j).max() <= 2 * 2.0 ** (
                np.floor(np.log2(top)) - 7), name
        else:
            assert np.abs(g - j).max() <= 1e-4 * np.abs(j).max(), name


# --- a model of the card's epilogue ------------------------------------------

def _live_before(m, lay):
    """csrc/fwd_wgmma_bf16.cuh ``live_before`` at the output geometry."""
    wp, per = lay.ow + 1, lay.per_img
    i = m // per
    if i >= lay.b:
        return lay.n // 4
    rem = m - i * per
    r, c = rem // wp, rem % wp
    return i * lay.oh * lay.ow + (0 if r == 0 else (r - 1) * lay.ow
                                  + max(c - 1, 0))


def _in_pos(q, ph, lay):
    """csrc/transition.cu ``in_pos``: output lane q's input lane at row
    parity ph, column parity 0."""
    ohw = lay.oh * lay.ow
    img, rem = divmod(q, ohw)
    r, c = divmod(rem, lay.ow)
    return img * lay.h * lay.w + (2 * r + ph) * lay.w + 2 * c


def _epilogue_model(v, x, scale, shift, bits, thresh, sc, lay,
                    mutate=None):
    """The card epilogue of csrc/transition.cu ``dgrad_kernel`` over every
    (M tile, row parity) block, all channels at once: each live M row's
    place in the tile's run (at) and the lead (lane0 % 4), the two classes'
    values staged as pairs at 2 (lead + at) + pw, then units of 4 output
    lanes: one 16-byte vector of 8 input lanes where the unit lies whole in
    the run and the rows hold whole units (ow % 4 == 0; the model checks
    that the vector's lanes are the pairs'), else pair by pair. v[p] [Cin,
    N'] is class p's dequantized value at each output lane. Returns dx
    (f32 before its bf16 rounding), d(scale), d(shift) and each input
    lane's write count."""
    cin, n = x.shape
    dx = torch.zeros((cin, n), dtype=torch.float32)
    writes = torch.zeros(n, dtype=torch.int32)
    xf = x.float()
    keep = fb.inv_keep(thresh) if bits is not None else 1.0
    slots = []
    for t in range(lay.tiles):
        m0 = t * 128
        lane0 = _live_before(m0, lay)
        count = _live_before(m0 + 128, lay) - lane0
        lead = lane0 % 4
        for ph in (0, 1):
            staged = torch.zeros((cin, 2 * (lead + count) + 8))
            for m in range(m0, m0 + 128):
                k = _live_before(m, lay)
                if _live_before(m + 1, lay) > k:
                    at = k - lane0
                    for pw in (0, 1):
                        j = 2 * (lead + at) + (1 - pw if mutate == "swap_pw"
                                               else pw)
                        staged[:, j] = v[2 * ph + pw][:, k]
            s1 = torch.zeros(cin)
            s2 = torch.zeros(cin)
            for u in range((lead + count + 3) // 4):
                k0 = 4 * u
                q0 = lane0 - (0 if mutate == "q0_lead" else lead) + k0
                whole = k0 >= lead and k0 + 4 <= lead + count
                if whole and (lay.ow % 4 == 0 or mutate == "no_row_check"):
                    lanes = [_in_pos(q0, ph, lay) + e for e in range(8)]
                    if mutate != "no_row_check":
                        assert lanes == [_in_pos(q0 + e // 2, ph, lay) + e % 2
                                         for e in range(8)]
                        assert lanes[0] % 8 == 0
                    elems = list(enumerate(lanes))
                else:
                    elems = [(2 * i + pw, _in_pos(q0 + i, ph, lay) + pw)
                             for i in range(4) if lead <= k0 + i < lead + count
                             for pw in (0, 1)]
                u1 = torch.zeros(cin)
                u2 = torch.zeros(cin)
                for e, lane in elems:
                    val = staged[:, 8 * u + e]
                    xe = xf[:, lane]
                    live = fb._fma(xe, scale, shift) > 0
                    if bits is not None:
                        live = live & (bits[:, lane].to(torch.int32) < thresh)
                        val = val * keep
                    dn = torch.where(live, val, torch.zeros_like(val))
                    u1 = u1 + dn * xe
                    u2 = u2 + dn
                    if ph == 0 and e % 2 == 0:
                        out = fb._fma(dn, scale, sc[:, q0 + e // 2])
                    else:
                        out = dn * scale
                    dx[:, lane] = out
                    writes[lane] += 1
                s1 = s1 + u1
                s2 = s2 + u2
            slots.append((s1, s2))
    ds = sum(s[0] for s in slots)
    dt = sum(s[1] for s in slots)
    return dx, ds, dt, writes


def _model_inputs(b, h, w, cin, cout, quant, proj, rate):
    args, tile = _operands(b, h, w, cin, cout, quant, proj, rate, seed=3)
    g, g_amax, w_dg, ws_in, x, scale, shift, bits, dres, wpt = args
    lay = tr.transition_dgrad_layout(b * h * w, h, w, cin, cout, tile, quant)
    gslab, _ = tr.dgrad_pre_plain(g, None, lay)
    rows = tr._out_rows(lay) + lay.guard
    v = []
    for first, count, offs in lay.classes:
        a = sum(gslab[rows + off, :cout].double()
                @ w_dg.double()[:, (first + j) * cout:(first + j + 1) * cout
                                ].t() for j, off in enumerate(offs)).t().float()
        if quant:
            a = fb._per_group(a, tile, ws_in[:, None]
                              * (g_amax * fb.INV_127)[None, :])
        v.append(a)
    sc = tr._shortcut_cotangent(dres, wpt, cin)
    thresh = fb.dropout_thresh(rate) if rate else None
    return args, tile, lay, v, sc, thresh


@pytest.mark.parametrize("b,h,w,cin,cout", SHAPES)
@pytest.mark.parametrize("quant,proj,rate", [(True, True, RATE),
                                             (False, False, 0.0)])
def test_epilogue_model_matches_plain(b, h, w, cin, cout, quant, proj,
                                      rate):
    """The card epilogue's units and lanes write every input lane of
    every channel exactly once with dgrad_plain's dx, and its sums agree;
    at 12x12 inputs (6 output pixels a row) the units straddle rows and
    take the pair path."""
    args, tile, lay, v, sc, thresh = _model_inputs(b, h, w, cin, cout, quant,
                                                   proj, rate)
    g, g_amax, w_dg, ws_in, x, scale, shift, bits, dres, wpt = args
    dx, ds, dt, writes = _epilogue_model(v, x, scale, shift, bits, thresh,
                                         sc, lay)
    want = tr.dgrad_plain(*args, thresh=thresh, tile=tile, h=h, w_img=w)
    assert (writes == 1).all()
    assert torch.equal(dx.to(torch.bfloat16), want[0])
    for got, ref in ((ds, want[1]), (dt, want[2])):
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("mutate,b,h", [("q0_lead", 2, 16), ("swap_pw", 2, 16),
                                        ("no_row_check", 32, 12)])
def test_epilogue_model_catches_mutations(mutate, b, h):
    """The model's checks bite: a unit's first output lane taken without
    the lead, the two column classes swapped in the staged pairs, and
    whole-unit vectors taken where 6-pixel rows split them."""
    args, tile, lay, v, sc, thresh = _model_inputs(b, h, h, 32, 64, True,
                                                   True, RATE)
    g, g_amax, w_dg, ws_in, x, scale, shift, bits, dres, wpt = args
    want = tr.dgrad_plain(*args, thresh=thresh, tile=tile, h=h, w_img=h)
    try:
        dx, _, _, writes = _epilogue_model(v, x, scale, shift, bits, thresh,
                                           sc, lay, mutate)
    except AssertionError:
        return
    assert not ((writes == 1).all()
                and torch.equal(dx.to(torch.bfloat16), want[0]))


# --- the geometry rule and the CPU route -------------------------------------

@pytest.mark.parametrize("cin,cout,h,w", [(32, 40, 16, 16), (32, 64, 24, 24),
                                          (32, 64, 12, 12), (32, 64, 4, 36),
                                          (160, 320, 32, 32)])
def test_dgrad_takes_the_forwards_geometry(cin, cout, h, w):
    """Any even H and W, Cout % 8, scale groups of whole images (the
    forward's rule): the layout builds where the old row-tile kernel
    refused (output rows off 8 pixels, Cout off 32)."""
    b = 128 if cin == 160 else 32
    n = b * h * w
    tile = tr.transition_tile(h // 2, w // 2, n // 4, cin, cout)
    for quant in (True, False):
        lay = tr.transition_dgrad_layout(n, h, w, cin, cout, tile, quant)
        assert lay.tiles * lay.bm >= lay.m_valid


@pytest.mark.parametrize("cin,cout,h,w,tile,match", [
    (32, 64, 15, 16, 64, "geometry H=15 W=16"),
    (32, 44, 16, 16, 64, "Cout=44"),
    (32, 64, 16, 16, 96, "tile 96")])
def test_dgrad_geometry_refusals_name_the_shape(cin, cout, h, w, tile,
                                                match):
    """What the rule still refuses raises, naming the shape: odd H, Cout
    off 8, scale groups off whole images."""
    with pytest.raises(ValueError, match=match):
        tr.transition_dgrad_layout(8 * h * w, h, w, cin, cout, tile, True)


def test_operand_passes_still_refuse_rows_off_8():
    """Output rows off 8 pixels (6 at 12x12 inputs): the dgrad takes them,
    and since each of their lanes reads its own input pair so do the
    backward's operand passes; what still refuses the shape is the wgrads'
    rule (ROADMAP Queue 3 item 6): the FQT wgrad's at output images off 16
    positions, the TMA wgrad's."""
    tr.transition_dgrad_layout(32 * 144, 12, 12, 32, 64, 1152, True)
    tr.check_operand_geometry("transition_bwd", 12, 12, 32 * 144, 1152)
    with pytest.raises(ValueError, match="output image 6x6"):
        tr.check_wgrad_s8_geometry("transition_wgrad_s8", 32, 64, 12, 12,
                                   32 * 36, 1152)
    with pytest.raises(ValueError, match="image 6x6 is off the TMA"):
        tr.check_wgrad_geometry("transition_wgrad_tma", 32, 64, 12, 12,
                                32 * 36)


def test_cpu_dgrad_is_the_plain_version():
    """On the CPU the op's dgrad is dgrad_plain and launches nothing."""
    args, tile = _operands(2, 16, 16, 32, 64, True, True, RATE)
    kw = dict(thresh=fb.dropout_thresh(RATE), tile=tile, h=16, w_img=16)
    tr.reset_launches()
    got = tr.dgrad(*args, **kw)
    for a, b_ in zip(got, tr.dgrad_plain(*args, **kw)):
        assert torch.equal(a, b_)
    assert not tr.launches
