"""The port's fused int8 block-half (ops/cuda/fused_block.py) against the
JAX package's ``fused_half_int8(..., quant_bwd=True, interpret=True)``:
the scale-group pickers, the weight quantizers, the forward, the fully
quantized backward on both of JAX's routes (the fused ``_bwd_call`` at
Cin <= 320, ``_dgrad_call`` + ``_wgrad_call`` above), and the rounding
points the reference takes where these tests run it.

Tolerances: every int8 decision and every bf16 output is exact (the same
f32 operations in the same order, s32 sums exact in both); f32 sums over
positions (the BatchNorm statistics, d(scale), d(shift)) differ only in
their order: 1e-5 of the largest value. The weight gradient sums the same
per-group f32 products in the same group order: 1e-6 of its largest value
(XLA may fuse a product into the running sum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu.ops.pallas import fused_block as jfb
from pytorch_ddp_resnet_tpu.ops.pallas.conv import _pick_tile
from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb

# (h, w, batch, c): the WRN-28-10 stages at batch 128 and 512, the test
# shapes, and geometries the JAX pickers refuse
GRID = [(32, 32, 128, 160), (16, 16, 128, 320), (8, 8, 128, 640),
        (32, 32, 512, 160), (16, 16, 512, 320), (8, 8, 512, 640),
        (8, 8, 128, 32), (8, 8, 128, 64), (4, 4, 16, 352), (8, 8, 2, 32),
        (8, 8, 1, 32), (7, 7, 4, 64), (56, 56, 8, 64), (28, 28, 2, 128),
        (4, 4, 4, 32)]


def _outcome(fn):
    try:
        return fn()
    except ValueError:
        return "raises"


@pytest.mark.parametrize("h,w,b,c", GRID)
def test_scale_groups_match_jax(h, w, b, c):
    n = b * h * w
    assert _outcome(lambda: fb.lane_tile(h, w, n, c, c)) == _outcome(
        lambda: jfb._lane_tile(h, w, n, c, c, True))
    assert _outcome(lambda: fb.bwd_tile(h, w, n, c, c)) == _outcome(
        lambda: _pick_tile(h * w, n, c // 2, max_tile=4096))


def test_wrn_scale_groups():
    """The groups the ISSUE's table names for WRN-28-10 at batch 128."""
    n = {160: 128 * 1024, 320: 128 * 256, 640: 128 * 64}
    hw = {160: 32, 320: 16, 640: 8}
    got = {c: (fb.lane_tile(hw[c], hw[c], n[c], c, c),
               fb.bwd_tile(hw[c], hw[c], n[c], c, c)) for c in n}
    assert got == {160: (4096, 4096), 320: (1024, 2048), 640: (512, 1024)}


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.detach().float().numpy()


def test_weight_quantizers_match_jax():
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((3, 3, 48, 32)) * 0.1).astype(np.float32)
    w_oihw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    for jfn, tfn in ((jfb._quantize_pack_weights, fb.quantize_pack_weights),
                     (jfb._quantize_pack_weights_dgrad,
                      fb.quantize_pack_weights_dgrad)):
        jq, js = jfn(jnp.asarray(w))
        tq, ts = tfn(w_oihw)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _inputs(c, h, w, b, seed=0, res=True):
    """x, w (HWIO), scale, shift, bits, res as numpy (x, res bf16-valued)."""
    rng = np.random.default_rng(seed)
    n = b * h * w
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)  # noqa
    x = bf(rng.standard_normal((c, n)))
    wt = (rng.standard_normal((3, 3, c, c)) * (9 * c) ** -0.5).astype(
        np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    shift = (rng.standard_normal(c) * 0.3).astype(np.float32)
    bits = rng.integers(0, 256, (c, n), dtype=np.uint8)
    r = bf(rng.standard_normal((c, n))) if res else None
    return x, wt, scale, shift, bits, r


def _jax_args(x, wt, scale, shift, bits, res, rate):
    return (jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt), jnp.asarray(scale),
            jnp.asarray(shift), jnp.asarray(bits) if rate > 0 else None,
            None if res is None else jnp.asarray(res, jnp.bfloat16))


def _port_args(x, wt, scale, shift, bits, res, rate, grad=False):
    args = [_t(x, torch.bfloat16), _t(wt.transpose(3, 2, 0, 1)), _t(scale),
            _t(shift)]
    if grad:
        for a in args:
            a.requires_grad_(True)
    args.append(torch.from_numpy(bits) if rate > 0 else None)
    r = None if res is None else _t(res, torch.bfloat16)
    if grad and r is not None:
        r.requires_grad_(True)
    return args + [r]


H, W, B, C = 8, 8, 128, 32  # N = 8192: two scale groups forward and back


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("use_res", [False, True])
@pytest.mark.parametrize("want_stats", [False, True])
def test_forward_matches_jax(rate, use_res, want_stats):
    data = _inputs(C, H, W, B, res=use_res)
    assert fb.lane_tile(H, W, B * H * W, C, C) * 2 == B * H * W
    jy, js, jq = jfb.fused_half_int8(
        *_jax_args(*data, rate), dropout_rate=rate, h=H, w_img=W,
        want_stats=want_stats, quant_bwd=True, interpret=True)
    ty, ts, tq = fb.fused_half_int8(*_port_args(*data, rate),
                                    dropout_rate=rate, h=H, w_img=W,
                                    want_stats=want_stats)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(ty), np.asarray(jy, np.float32))
    if want_stats:
        for t, j in ((ts, js), (tq, jq)):
            j = np.asarray(j)
            assert np.abs(_np(t) - j).max() <= 1e-5 * np.abs(j).max()
    else:
        assert ts is None and tq is None and js is None


def _cotangents(c, n, seed):
    rng = np.random.default_rng(seed)
    cy = np.asarray(jnp.asarray(rng.standard_normal((c, n)), jnp.bfloat16),
                    np.float32)
    return (cy, (rng.standard_normal(c) * 0.01).astype(np.float32),
            (rng.standard_normal(c) * 0.01).astype(np.float32))


# (c, h, w, b): C=64 takes JAX's fused _bwd_call (two backward groups);
# C=352 > 320 takes _dgrad_call + _wgrad_call
ROUTES = [(64, 8, 8, 128), (352, 4, 4, 16)]


@pytest.mark.parametrize("c,h,w,b", ROUTES)
@pytest.mark.parametrize("rate,use_res,want_stats",
                         [(0.3, True, True), (0.3, True, False),
                          (0.0, False, True)])
def test_backward_matches_jax(c, h, w, b, rate, use_res, want_stats):
    """Gradients of a loss linear in (y, ysum, yssq), so the cotangents are
    fixed inputs: dx, dW, d(scale), d(shift) and d(res) against jax.grad."""
    n = b * h * w
    data = _inputs(c, h, w, b, seed=1, res=use_res)
    cy, cs, cq = _cotangents(c, n, 2)

    def jloss(x, wt, scale, shift, res):
        jx = _jax_args(*data, rate)
        y, ys, yq = jfb.fused_half_int8(
            x, wt, scale, shift, jx[4], res, dropout_rate=rate, h=h,
            w_img=w, want_stats=want_stats, quant_bwd=True, interpret=True)
        loss = jnp.sum(y.astype(jnp.float32) * cy)
        if want_stats:
            loss = loss + jnp.sum(ys * cs) + jnp.sum(yq * cq)
        return loss

    jx = _jax_args(*data, rate)
    argnums = (0, 1, 2, 3, 4) if use_res else (0, 1, 2, 3)
    jgrads = jax.grad(jloss, argnums=argnums)(jx[0], jx[1], jx[2], jx[3],
                                              jx[5])
    targs = _port_args(*data, rate, grad=True)
    y, ys, yq = fb.fused_half_int8(*targs, dropout_rate=rate, h=h, w_img=w,
                                   want_stats=want_stats)
    loss = (y.float() * _t(cy)).sum()
    if want_stats:
        loss = loss + (ys * _t(cs)).sum() + (yq * _t(cq)).sum()
    loss.backward()
    x, wt, scale, shift, _, res = targs
    got = [x.grad, wt.grad.permute(2, 3, 1, 0), scale.grad, shift.grad]
    if use_res:
        got.append(res.grad)
    names = ["dx", "dW", "dscale", "dshift", "dres"]
    for name, g, j in zip(names, got, jgrads):
        g, j = _np(g), np.asarray(j, np.float32)
        assert g.shape == j.shape, name
        if name in ("dx", "dres"):
            np.testing.assert_array_equal(g, j, err_msg=name)
        else:
            tol = 1e-6 if name == "dW" else 1e-5
            assert np.abs(g - j).max() <= tol * np.abs(j).max(), name
        assert np.abs(j).max() > 0, name


# --- the reference's rounding points -----------------------------------------

def _identity_weights(c):
    """Centre tap only, channel to itself: y reveals each int8 code."""
    wt = np.zeros((3, 3, c, c), np.float32)
    wt[1, 1] = np.eye(c) * 0.5
    return wt


def _cancelling(c, n, seed):
    """Per channel x constant and shift = -f32(x * scale): an FMA leaves the
    product's rounding error, two roundings leave exactly 0."""
    rng = np.random.default_rng(seed)
    xc = np.asarray(jnp.asarray(rng.uniform(0.5, 2.0, c), jnp.bfloat16),
                    np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    shift = -(xc * scale).astype(np.float32)
    err = xc.astype(np.float64) * scale + shift
    assert (err > 0).any() and (err < 0).any()
    return np.repeat(xc[:, None], n, 1), scale, shift


def test_prologue_is_one_fma():
    """relu(x * scale + shift) is 0 everywhere when rounded twice; the
    reference's single rounding leaves positive residues whose group
    absmax scales them to visible int8 codes, in the forward (y) and in
    the backward's masks (dx, d(shift))."""
    c, h, w, b = 32, 8, 8, 2
    n = b * h * w
    x, scale, shift = _cancelling(c, n, 1)
    wt = _identity_weights(c)
    dy = np.random.default_rng(2).standard_normal((c, n)).astype(np.float32)

    def jfn(x, wt, s, t):
        return jfb.fused_half_int8(x, wt, s, t, None, None, h=h, w_img=w,
                                   want_stats=False, quant_bwd=True,
                                   interpret=True)[0]

    jy, vjp = jax.vjp(jfn, jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt),
                      jnp.asarray(scale), jnp.asarray(shift))
    jdx, jdw, _, jdt = vjp(jnp.asarray(dy, jnp.bfloat16))
    assert np.abs(np.asarray(jy, np.float32)).max() > 0
    assert np.abs(np.asarray(jdt)).max() > 0 and np.abs(jdw).max() > 0
    args = _port_args(x, wt, scale, shift, np.zeros((c, n), np.uint8), None,
                      0.0, grad=True)
    ty, _, _ = fb.fused_half_int8(*args, h=h, w_img=w, want_stats=False)
    (ty.float() * _t(dy, torch.bfloat16).float()).sum().backward()
    np.testing.assert_array_equal(_np(ty), np.asarray(jy, np.float32))
    np.testing.assert_array_equal(_np(args[0].grad),
                                  np.asarray(jdx, np.float32))
    for got, want in ((args[3].grad, jdt),
                      (args[1].grad.permute(2, 3, 1, 0), jdw)):
        want = np.asarray(want)  # f32 sums: their order only
        assert np.abs(_np(got) - want).max() <= 1e-5 * np.abs(want).max()


def _division_sensitive(count, seed=0):
    """Values r in (0, 1) whose int8 code after dropout differs between
    r / f32(179/256) and r * f32(256/179), in a group whose absmax is the
    kept 1.0 (the same either way)."""
    c = np.float32(179 / 256)
    inv_c = np.float32(1.0) / c
    inv_q = np.float32(127.0) / (np.float32(1.0) * inv_c)
    rng = np.random.default_rng(seed)
    found = []
    while len(found) < count:
        r = rng.uniform(0.01, 0.99, 1_000_000).astype(np.float32)
        q_div = np.round((r / c).astype(np.float32) * inv_q)
        q_mul = np.round((r * inv_c).astype(np.float32) * inv_q)
        found.extend(r[q_div != q_mul][:count - len(found)])
    return np.array(found, np.float32)


def test_dropout_keeps_by_reciprocal_multiply():
    """The reference keeps r * f32(256/thresh) (XLA rewrites the kernel's
    r / (thresh/256)): on channels whose int8 code the two forms round
    differently (x = 1, scale = r, shift = 0, every element kept; channel 0
    holds the group's absmax), y shows the multiply's codes."""
    c, h, w, b = 32, 8, 8, 2
    n = b * h * w
    x = np.ones((c, n), np.float32)
    scale = np.concatenate([[1.0], _division_sensitive(c - 1)]).astype(
        np.float32)
    shift = np.zeros(c, np.float32)
    bits = np.zeros((c, n), np.uint8)
    wt = _identity_weights(c)
    jy, _, _ = jfb.fused_half_int8(
        *_jax_args(x, wt, scale, shift, bits, None, 0.3), dropout_rate=0.3,
        h=h, w_img=w, want_stats=False, quant_bwd=True, interpret=True)
    targs = _port_args(x, wt, scale, shift, bits, None, 0.3)
    ty, _, _ = fb.fused_half_int8(*targs, dropout_rate=0.3, h=h, w_img=w,
                                  want_stats=False)
    np.testing.assert_array_equal(_np(ty), np.asarray(jy, np.float32))
    thresh = fb.dropout_thresh(0.3)
    by_div = torch.clamp_min(fb._fma(targs[0], targs[2][:, None],
                                     targs[3][:, None]), 0.0) / torch.tensor(
        thresh / 256.0)
    q_div, _ = fb.quantize_groups_plain(by_div, n, fb.FWD_FLOOR)
    q_mul, _ = fb.fwd_quantize_plain(targs[0], targs[2], targs[3], targs[4],
                                     thresh=thresh, tile=n)
    assert (q_mul != q_div)[1:].all()


def test_stats_fold_is_one_fma():
    """gf = (dy + dysum) + (2y) * dyssq: with y constant per channel and
    dysum = -f32(2y * dyssq), an FMA leaves residues (the cotangent's group
    absmax makes them full int8 codes), two roundings leave 0."""
    c, h, w, b = 32, 8, 8, 2
    n = b * h * w
    rng = np.random.default_rng(1)
    x = np.repeat(np.asarray(jnp.asarray(rng.uniform(0.5, 2, (c, 1)),
                                         jnp.bfloat16), np.float32), n, 1)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    shift = (rng.standard_normal(c) * 0.1 + 0.5).astype(np.float32)
    wt = _identity_weights(c)

    def jfn(x, wt, s, t):
        return jfb.fused_half_int8(x, wt, s, t, None, None, h=h, w_img=w,
                                   want_stats=True, quant_bwd=True,
                                   interpret=True)

    (jy, _, _), vjp = jax.vjp(jfn, jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(wt), jnp.asarray(scale),
                              jnp.asarray(shift))
    y0 = np.asarray(jy, np.float32)[:, 0]
    assert (np.asarray(jy, np.float32) == y0[:, None]).all()
    dyssq = rng.uniform(0.5, 1.5, c).astype(np.float32)
    dysum = -(2 * y0 * dyssq).astype(np.float32)
    zeros = np.zeros((c, n), np.float32)
    jdx = np.asarray(vjp((jnp.asarray(zeros, jnp.bfloat16),
                          jnp.asarray(dysum), jnp.asarray(dyssq)))[0],
                     np.float32)
    assert np.abs(jdx).max() > 0
    args = _port_args(x, wt, scale, shift, np.zeros((c, n), np.uint8), None,
                      0.0, grad=True)
    ty, ts, tq = fb.fused_half_int8(*args, h=h, w_img=w, want_stats=True)
    np.testing.assert_array_equal(_np(ty), np.asarray(jy, np.float32))
    (ts * _t(dysum)).sum().add((tq * _t(dyssq)).sum()).backward()
    np.testing.assert_array_equal(_np(args[0].grad), jdx)
    two_roundings = (_t(zeros) + _t(dysum)[:, None]) + (
        2 * ty.detach().float()) * _t(dyssq)[:, None]
    assert not two_roundings.any()


def test_refuses_what_the_reference_refuses():
    x, wt, scale, shift, bits, _ = _inputs(C, H, W, 2, res=False)
    args = _port_args(x, wt, scale, shift, bits, None, 0.3)
    with pytest.raises(ValueError, match="needs a bits array"):
        fb.fused_half_int8(*args[:4], None, None, dropout_rate=0.3, h=H,
                           w_img=W)
    with pytest.raises(ValueError, match="zeroes the activations"):
        fb.fused_half_int8(*args, dropout_rate=1.0, h=H, w_img=W)
    with pytest.raises(ValueError, match="multiple of H\\*W"):
        fb.fused_half_int8(*args, dropout_rate=0.3, h=H, w_img=W + 1)
