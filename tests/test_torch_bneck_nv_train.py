"""The port's int8 bottleneck training halves (ops/cuda/bneck_nv_train.py)
against the JAX package's ``nv_half_1x1`` / ``nv_half_3x3`` run as its own
tests run them (Pallas interpret mode on the CPU). The JAX halves take the
TPU's NV carrier [h, wp, N, C]; the port takes NHWC; the tests convert
with the JAX package's ``to_nv`` / ``from_nv``. Inputs are made with numpy
from a seed.

Tolerances: y, x_res, dx, dres and dW equal (the int8 products are exact
in both and the plain versions round where the reference rounds); the f32
sums over positions (zsum, zssq, d(s), d(t)) within 1e-5 of their largest
value (their order differs). The probes pin each rounding point with
inputs on which the alternative gives a different result:
- the prologue ``x*s + t`` is one fused multiply-add (forward codes and
  the backward's relu mask), in the 1x1, 3x3 and entry halves;
- the stats fold ``(dy + dzsum) + (2y)*dzssq`` is one fused multiply-add;
- ``dx = bf16(du*s)`` and ``x_res = bf16(a)`` round the f32 value, not
  the exact one, to bf16;
- the wgrad's chunk scale is ``(amax_a * amax_g) * f32(1/127^2)`` (XLA
  reassociates the two 1/127 factors; ``test_wgrad_chunk_scale``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu.ops.pallas import bneck_nv_train as jnt
from pytorch_ddp_resnet_tpu.ops.pallas.nv_common import from_nv, to_nv
from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv_train as tnt

N = 32  # the halves need a pow2 multiple of 32 images


def _bf(a):
    """numpy f32 values rounded to bf16 (as the carriers hold them)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _nv(a):
    return jnp.asarray(to_nv(jnp.asarray(a, jnp.float32)), jnp.bfloat16)


def _t(a, dtype=torch.float32, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    return t.requires_grad_(grad)


def _np(t):
    return t.detach().float().numpy()


def _oihw(w, conv):
    """JAX [Cin, Cout] / HWIO -> the port's OIHW."""
    return (w.T[:, :, None, None] if conv == "1x1"
            else w.transpose(3, 2, 0, 1))


def _case(rng, conv, mode, h=6, w=5, cin=16, cout=24):
    """Operands of one half (numpy): x >= 0 for the identity/entry modes,
    as their inputs are post-relu or raw accumulators of either sign."""
    if conv == "3x3":
        cout = cin
    x = rng.normal(size=(N, h, w, cin))
    x = _bf(np.abs(x) if mode == "identity" else x)
    wt = (rng.normal(size=(cin, cout) if conv == "1x1" else
                     (3, 3, cin, cout)) * 0.2).astype(np.float32)
    s = (rng.normal(size=cin) * 0.5 + 1.0).astype(np.float32)
    t = (rng.normal(size=cin) * 0.2).astype(np.float32)
    res = _bf(rng.normal(size=(N, h, w, cin))) if mode == "entry" else None
    return dict(x=x, w=wt, s=s, t=t, res=res)


def _cotangents(rng, shape_y, cout, shape_x, mode, scale=(0.01, 0.001)):
    return dict(dy=_bf(rng.normal(size=shape_y)),
                dzsum=(rng.normal(size=cout) * scale[0]).astype(np.float32),
                dzssq=(rng.normal(size=cout) * scale[1]).astype(np.float32),
                dxout=_bf(rng.normal(size=shape_x)) if mode == "entry"
                else None)


def _jax_half(op, ct, conv, mode, rch):
    """JAX forward and vjp: (y, zsum, zssq, x_res | None) and (dx, dres |
    None, dW [Cin, Cout] or HWIO, ds | None, dt | None), NHWC numpy."""
    w_img = op["x"].shape[2]
    entry, affine = mode == "entry", mode != "identity"
    fn = jnt.nv_half_1x1 if conv == "1x1" else jnt.nv_half_3x3

    def f(*args):
        it = iter(args)
        x = next(it)
        res = next(it) if entry else None
        w = next(it)
        s, t = (next(it), next(it)) if affine else (None, None)
        kw = dict(mode=mode, w_img=w_img, chunk_rows=rch, interpret=True)
        if conv == "1x1":
            return fn(x, w, s, t, res=res, **kw)
        return fn(x, w, s, t, **kw)

    args = [_nv(op["x"])] + ([_nv(op["res"])] if entry else []) + [
        jnp.asarray(op["w"])] + ([jnp.asarray(op["s"]), jnp.asarray(
            op["t"])] if affine else [])
    out, vjp = jax.vjp(f, *args)
    cts = [_nv(ct["dy"]), jnp.asarray(ct["dzsum"]), jnp.asarray(ct["dzssq"])]
    if entry:
        cts.append(_nv(ct["dxout"]))
    grads = iter(vjp(tuple(cts)))
    fwd = [np.asarray(from_nv(out[0], w_img), np.float32), np.asarray(out[1]),
           np.asarray(out[2]),
           np.asarray(from_nv(out[3], w_img), np.float32) if entry else None]
    dx = np.asarray(from_nv(next(grads), w_img), np.float32)
    dres = np.asarray(from_nv(next(grads), w_img), np.float32) if entry \
        else None
    dw = np.asarray(next(grads))
    ds, dt = ((np.asarray(next(grads)), np.asarray(next(grads))) if affine
              else (None, None))
    return fwd, (dx, dres, dw, ds, dt)


def _port_half(op, ct, conv, mode, rch):
    """The port's differentiable op, then backward through a loss linear
    in every output with the cotangents as weights."""
    entry, affine = mode == "entry", mode != "identity"
    x = _t(op["x"], torch.bfloat16, grad=True)
    res = _t(op["res"], torch.bfloat16, grad=True) if entry else None
    w = _t(_oihw(op["w"], conv), grad=True)
    s = _t(op["s"], grad=True) if affine else None
    t = _t(op["t"], grad=True) if affine else None
    kw = dict(mode=mode, w_img=op["x"].shape[2], chunk_rows=rch)
    out = (tnt.nv_half_1x1(x, w, s, t, res, **kw) if conv == "1x1"
           else tnt.nv_half_3x3(x, w, s, t, **kw))
    loss = ((out[0].float() * _t(ct["dy"])).sum()
            + (out[1] * _t(ct["dzsum"])).sum()
            + (out[2] * _t(ct["dzssq"])).sum())
    if entry:
        loss = loss + (out[3].float() * _t(ct["dxout"])).sum()
    loss.backward()
    assert out[0].dtype == torch.bfloat16
    fwd = [_np(out[0]), _np(out[1]), _np(out[2]),
           _np(out[3]) if entry else None]
    dw = w.grad.numpy()
    dw = dw[:, :, 0, 0].T if conv == "1x1" else dw.transpose(2, 3, 1, 0)
    return fwd, (_np(x.grad), _np(res.grad) if entry else None, dw,
                 s.grad.numpy() if affine else None,
                 t.grad.numpy() if affine else None)


def _close_sum(got, want, name):
    scale = np.abs(want).max()
    assert scale > 0, name
    assert np.abs(got - want).max() <= 1e-5 * scale, name


def _assert_matches(got, want):
    (y, zs, zq, xres), (dx, dres, dw, ds, dt) = got
    (jy, jzs, jzq, jxres), (jdx, jdres, jdw, jds, jdt) = want
    np.testing.assert_array_equal(y, jy, err_msg="y")
    _close_sum(zs, jzs, "zsum")
    _close_sum(zq, jzq, "zssq")
    np.testing.assert_array_equal(dx, jdx, err_msg="dx")
    np.testing.assert_array_equal(dw, jdw, err_msg="dW")
    assert (xres is None) == (jxres is None) and (dres is None) == (
        jdres is None)
    if xres is not None:
        np.testing.assert_array_equal(xres, jxres, err_msg="x_res")
        np.testing.assert_array_equal(dres, jdres, err_msg="dres")
    assert (ds is None) == (jds is None)
    if ds is not None:
        _close_sum(ds, jds, "ds")
        _close_sum(dt, jdt, "dt")


HALVES = [("1x1", "identity"), ("1x1", "affine"), ("1x1", "entry"),
          ("3x3", "identity"), ("3x3", "affine")]


# --- the halves, forward and backward ----------------------------------------

@pytest.mark.parametrize("conv,mode", HALVES)
@pytest.mark.parametrize("rch", [2, None])
def test_half_matches_jax(conv, mode, rch):
    """rch 2: three chunks of a 6-row plane, so 3x3 halo rows cross chunk
    boundaries; None: the pickers' own choice (one chunk here)."""
    rng = np.random.default_rng(len(conv) * 10 + len(mode) + (rch or 0))
    op = _case(rng, conv, mode)
    cout = op["w"].shape[-1]
    ct = _cotangents(rng, op["x"].shape[:3] + (cout,), cout, op["x"].shape,
                     mode)
    want = _jax_half(op, ct, conv, mode, rch)
    got = _port_half(op, ct, conv, mode, rch)
    assert len(np.unique(want[0][0])) > 100  # y is not degenerate
    _assert_matches(got, want)


def test_stages_match_jax_at_distinct_chunkings():
    """A 3x3 half whose forward, dgrad and wgrad take three different row
    chunks (4, 2, 1 on an 8-row plane), through the stage wrappers."""
    rng = np.random.default_rng(9)
    op = _case(rng, "3x3", "affine", h=8, w=4)
    ct = _cotangents(rng, op["x"].shape, 16, op["x"].shape, "affine")
    x, s, t = _t(op["x"], torch.bfloat16), _t(op["s"]), _t(op["t"])
    w = _t(_oihw(op["w"], "3x3"))
    wq, ws = tnt.quantize_w_3x3(w)
    rowmax_a, _ = tnt.fwd_rowmax(x, s, t, None, mode="affine")
    y, _, _ = tnt.fwd_conv(x, s, t, None, rowmax_a, wq, ws, conv="3x3",
                           mode="affine", rch=4)
    jy = _jax_half(op, ct, "3x3", "affine", 4)[0][0]
    np.testing.assert_array_equal(_np(y), jy)
    dy, dzs, dzq = _t(ct["dy"], torch.bfloat16), _t(ct["dzsum"]), _t(
        ct["dzssq"])
    rowmax_g = tnt.bwd_rowmax(dy, y, dzs, dzq)
    wdg, ws_in = tnt.quantize_w_3x3_dgrad(w)
    dx = tnt.dgrad_conv(dy, y, dzs, dzq, rowmax_g, wdg, ws_in, x, s, t, None,
                        None, conv="3x3", mode="affine", rch=2)[0]
    dw = tnt.wgrad(dy, y, dzs, dzq, rowmax_g, x, s, t, None, rowmax_a,
                   conv="3x3", mode="affine", rch=1)
    yj = jnp.asarray(to_nv(jnp.asarray(jy)), jnp.bfloat16)
    jdx = jnt._dgrad_call(
        _nv(ct["dy"]), yj, jnp.asarray(ct["dzsum"]), jnp.asarray(ct["dzssq"]),
        _nv(op["x"]), None, None, *jnt.quantize_w_3x3_dgrad(jnp.asarray(
            op["w"])), jnp.asarray(op["s"]), jnp.asarray(op["t"]),
        conv="3x3", mode="affine", quant=True, w_img=4, chunk_rows=2,
        interpret=True)[0]
    jdw = jnt._wgrad_call(
        _nv(ct["dy"]), yj, jnp.asarray(ct["dzsum"]), jnp.asarray(ct["dzssq"]),
        _nv(op["x"]), None, jnp.asarray(op["s"]), jnp.asarray(op["t"]),
        conv="3x3", mode="affine", quant=True, w_img=4, chunk_rows=1,
        interpret=True)
    np.testing.assert_array_equal(_np(dx), np.asarray(from_nv(jdx, 4),
                                                      np.float32))
    np.testing.assert_array_equal(dw.numpy(), np.asarray(jdw).reshape(
        -1, 16))


# --- weights and the chunk model ---------------------------------------------

def test_weight_quantizers_match_jax():
    rng = np.random.default_rng(0)
    w1 = (rng.normal(size=(24, 40)) * 0.3).astype(np.float32)   # [Cin, Cout]
    w3 = (rng.normal(size=(3, 3, 24, 40)) * 0.3).astype(np.float32)
    pairs = [(tnt.quantize_w_1x1(_t(_oihw(w1, "1x1"))),
              jnt.quantize_w_1x1(jnp.asarray(w1)), lambda q: q.T),
             (tnt.quantize_w_1x1_dgrad(_t(_oihw(w1, "1x1"))),
              jnt.quantize_w_1x1_dgrad(jnp.asarray(w1)), lambda q: q.T),
             (tnt.quantize_w_3x3(_t(_oihw(w3, "3x3"))),
              jnt.quantize_w_3x3(jnp.asarray(w3)),
              lambda q: q.transpose(2, 0, 1).reshape(40, -1)),
             (tnt.quantize_w_3x3_dgrad(_t(_oihw(w3, "3x3"))),
              jnt.quantize_w_3x3_dgrad(jnp.asarray(w3)),
              lambda q: q.transpose(2, 0, 1).reshape(24, -1))]
    for (tq, ts), (jq, js), to_port in pairs:
        assert tq.dtype == torch.int8 and tq.is_contiguous()
        np.testing.assert_array_equal(tq.numpy(), to_port(np.asarray(jq)))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# (h, w, Cin, Cb, Cout) of every identity bottleneck stage of ResNet-50 and
# WRN-50-2 at 224x224
STAGES = [(56, 56, 256, 64, 256), (28, 28, 512, 128, 512),
          (14, 14, 1024, 256, 1024), (7, 7, 2048, 512, 2048),
          (56, 56, 256, 128, 256), (28, 28, 512, 256, 512),
          (14, 14, 1024, 512, 1024), (7, 7, 2048, 1024, 2048)]


def _jax_rch(fn, *args):
    try:
        return fn(*args)
    except ValueError:
        return None


@pytest.mark.parametrize("n", [32, 64, 128, 256])
def test_pickers_and_gate_match_jax(n):
    for h, w, cin, cb, cout in STAGES:
        assert tnt.nv_train_fits(h, w, n, cin, cb, cout) == \
            jnt.nv_train_fits(h, w, n, cin, cb, cout), (h, n)
        wp = jnt.nv_geometry(h, w)
        assert tnt.nv_geometry(h, w) == wp
        for ci, co, conv, entry in ((cin, cb, "1x1", True),
                                    (cin, cb, "1x1", False),
                                    (cb, cb, "3x3", False),
                                    (cb, cout, "1x1", False)):
            for name in ("_rch_fwd", "_rch_dgrad", "_rch_wgrad"):
                args = (h, wp, n, ci, co, conv, entry)
                assert _jax_rch(getattr(tnt, name), *args) == _jax_rch(
                    getattr(jnt, name), *args), (name, args)


def test_resnet50_batch128_picks():
    """The (fwd, dgrad, wgrad) row chunks the ResNet-50 main path runs: the
    three chunkings of a half differ."""
    pick = tnt.pick_chunk_rows
    assert pick(56, 56, 128, 256, 64, "1x1", "entry") == (1, 1, 2)
    assert pick(56, 56, 128, 64, 64, "3x3", "affine") == (4, 2, 2)
    assert pick(28, 28, 128, 512, 128, "1x1", "identity") == (4, 2, 4)
    assert pick(28, 28, 128, 128, 128, "3x3", "affine") == (7, 4, 7)
    assert pick(14, 14, 128, 256, 1024, "1x1", "affine") == (2, 2, 2)
    assert pick(7, 7, 64, 2048, 512, "1x1", "entry") == (1, 1, 1)
    assert not tnt.nv_train_fits(7, 7, 128, 2048, 512, 2048)
    assert not tnt.nv_train_fits(56, 56, 256, 256, 64, 256)


# --- refusals and launches ---------------------------------------------------

def test_refusals():
    """The mode, residual and batch refusals; every (quant, quant_bwd)
    combination runs, forward and backward (the bf16 bodies:
    tests/test_torch_bneck_nv_train_bf16.py)."""
    x = torch.zeros((32, 4, 4, 16), dtype=torch.bfloat16)
    w1 = torch.zeros((16, 16, 1, 1))
    v = torch.ones(16)
    for quant in (True, False):
        for quant_bwd in (True, False):
            kw = dict(w_img=4, quant=quant, quant_bwd=quant_bwd)
            w3 = torch.zeros((16, 16, 3, 3), requires_grad=True)
            for out in (tnt.nv_half_1x1(x, w1, v, v, mode="affine", **kw),
                        tnt.nv_half_3x3(x, w3, v, v, **kw)):
                assert out[0].shape == x.shape
            out[0].float().sum().backward()
            assert w3.grad.shape == w3.shape
    with pytest.raises(ValueError, match="mode"):
        tnt.nv_half_1x1(x, w1, mode="bogus", w_img=4)
    with pytest.raises(ValueError, match="identity/affine"):
        tnt.nv_half_3x3(x, torch.zeros((16, 16, 3, 3)), v, v, mode="entry",
                        w_img=4)
    with pytest.raises(ValueError, match="residual"):
        tnt.nv_half_1x1(x, w1, v, v, mode="entry", w_img=4)
    for n in (48, 16, 96):
        with pytest.raises(ValueError, match="pow2"):
            tnt.nv_half_1x1(torch.zeros((n, 4, 4, 16), dtype=torch.bfloat16),
                            w1, mode="identity", w_img=4)


def test_plain_halves_count_no_launches():
    rng = np.random.default_rng(3)
    op = _case(rng, "1x1", "entry", h=2, w=2)
    ct = _cotangents(rng, (N, 2, 2, 24), 24, op["x"].shape, "entry")
    tnt.reset_launches()
    _port_half(op, ct, "1x1", "entry", None)
    assert sum(tnt.launches.values()) == 0
    assert sum(tnt.launch_shapes.values()) == 0


# --- rounding-point probes ---------------------------------------------------

def _cancelling(rng, c, shape):
    """x constant per channel and t = -f32(x*s): one fused multiply-add
    leaves the product's rounding error, two roundings leave exactly 0."""
    xc = _bf(rng.uniform(0.5, 2.0, c))
    s = rng.uniform(0.5, 1.5, c).astype(np.float32)
    t = -(xc * s).astype(np.float32)
    err = xc.astype(np.float64) * s + t
    assert (err > 0).any() and (err < 0).any()
    return np.broadcast_to(xc, shape).copy(), s, t


@pytest.mark.parametrize("conv,mode", [("1x1", "affine"), ("3x3", "affine"),
                                       ("1x1", "entry")])
def test_prologue_is_one_fma(conv, mode):
    """relu(x*s + t) is 0 everywhere when rounded twice; the reference's one
    rounding leaves positive residues that the chunk absmax scales to full
    int8 codes, in y (and x_res) and in the backward's relu mask (dx)."""
    rng = np.random.default_rng(1)
    c, h, w = 16, 2, 4
    x, s, t = _cancelling(rng, c, (N, h, w, c))
    wt = np.zeros((c, c) if conv == "1x1" else (3, 3, c, c), np.float32)
    (wt if conv == "1x1" else wt[1, 1])[...] = np.eye(c) * 0.5
    op = dict(x=x, w=wt, s=s, t=t,
              res=np.zeros_like(x) if mode == "entry" else None)
    ct = _cotangents(rng, x.shape, c, x.shape, mode)
    want = _jax_half(op, ct, conv, mode, None)
    assert np.abs(want[0][0]).max() > 0 and np.abs(want[1][0]).max() > 0
    if mode == "entry":
        assert np.abs(want[0][3]).max() > 0
    _assert_matches(_port_half(op, ct, conv, mode, None), want)


def test_stats_fold_is_one_fma():
    """g = (dy + dzsum) + (2y)*dzssq: with y constant per channel, dy = 0
    and dzsum = -f32(2y*dzssq), one rounding leaves residues (the chunk
    absmax makes them full codes), two roundings leave 0."""
    rng = np.random.default_rng(2)
    c, h, w = 16, 2, 4
    x = np.broadcast_to(_bf(rng.uniform(0.5, 2.0, c)), (N, h, w, c)).copy()
    wt = (rng.normal(size=(c, c)) * 0.3).astype(np.float32)
    op = dict(x=x, w=wt, s=None, t=None, res=None)
    y = _jax_half(op, _cotangents(rng, x.shape, c, x.shape, "identity"),
                  "1x1", "identity", None)[0][0]
    y0 = y[0, 0, 0]
    assert (y == y0).all()
    dzssq = rng.uniform(0.5, 1.5, c).astype(np.float32)
    ct = dict(dy=np.zeros_like(y), dzssq=dzssq,
              dzsum=-(2 * y0 * dzssq).astype(np.float32), dxout=None)
    want = _jax_half(op, ct, "1x1", "identity", None)
    assert np.abs(want[1][0]).max() > 0
    two = (np.zeros_like(y) + ct["dzsum"]) + (2 * y) * dzssq
    assert not two.any()
    _assert_matches(_port_half(op, ct, "1x1", "identity", None), want)


def _bf16_once(v):
    """float64 values rounded once to bf16 (8 significant bits, ties to
    even)."""
    m, e = np.frexp(np.asarray(v, np.float64))
    return np.ldexp(np.round(m * 256) / 256, e)


def _double_rounding_scales(rng, k, count):
    """f32 s with bf16(f32(k*s)) != bf16(k*s) for the exact integer k."""
    out = []
    while len(out) < count:
        s = rng.uniform(0.5, 1.5, 1 << 21).astype(np.float32)
        ex = float(k) * s.astype(np.float64)
        hit = s[_bf16_once(ex) != _bf16_once(ex.astype(np.float32))]
        out += list(hit[:count - len(out)])
    return np.array(out, np.float32)


def test_dx_rounds_the_f32_product():
    """dx = bf16(f32(du*s)). Weights 127*I and integer cotangents with
    absmax 127 make every scale 1, so du = 127*k exactly; each channel's s
    puts the f32 product on a bf16 tie that the exact product misses."""
    rng = np.random.default_rng(4)
    c, h, w = 16, 2, 2
    k = rng.integers(1, 127, c)
    s = np.concatenate([_double_rounding_scales(rng, 127 * ki, 1)
                        for ki in k])
    op = dict(x=np.ones((N, h, w, c), np.float32),
              w=(127 * np.eye(c)).astype(np.float32), s=s,
              t=np.zeros(c, np.float32), res=None)
    dy = np.broadcast_to(k.astype(np.float32), (N, h, w, c)).copy()
    dy[0, 0, 0, 0] = 127
    ct = dict(dy=dy, dzsum=np.zeros(c, np.float32),
              dzssq=np.zeros(c, np.float32), dxout=None)
    want = _jax_half(op, ct, "1x1", "affine", None)
    exact = (127 * k).astype(np.float64) * s
    np.testing.assert_array_equal(want[1][0][1, 1, 1],
                                  _bf16_once(exact.astype(np.float32)))
    assert (want[1][0][1, 1, 1] != _bf16_once(exact)).all()
    _assert_matches(_port_half(op, ct, "1x1", "affine", None), want)


def test_x_res_rounds_the_f32_activation():
    """x_res = bf16(f32(a)): with x = 1 + 2^-7, t = 0 and res = 0, a =
    f32(x*s) and each channel's s puts it on a bf16 tie that the exact
    product misses."""
    rng = np.random.default_rng(5)
    c, h, w = 16, 2, 2
    xv = 1 + 2.0 ** -7
    s = _double_rounding_scales(rng, xv, c)
    op = dict(x=np.full((N, h, w, c), xv, np.float32),
              w=(rng.normal(size=(c, 24)) * 0.3).astype(np.float32), s=s,
              t=np.zeros(c, np.float32), res=np.zeros((N, h, w, c),
                                                      np.float32))
    ct = _cotangents(rng, (N, h, w, 24), 24, op["x"].shape, "entry")
    want = _jax_half(op, ct, "1x1", "entry", None)
    exact = xv * s.astype(np.float64)
    np.testing.assert_array_equal(want[0][3][0, 0, 0],
                                  _bf16_once(exact.astype(np.float32)))
    assert (want[0][3][0, 0, 0] != _bf16_once(exact)).all()
    _assert_matches(_port_half(op, ct, "1x1", "entry", None), want)


def test_wgrad_chunk_scale():
    """Each chunk's dW contribution is f32(s32) * ((amax_a * amax_g) *
    f32(1/127^2)): over several chunks the other association, (amax_a *
    f32(1/127)) * (amax_g * f32(1/127)), differs from the reference."""
    rng = np.random.default_rng(6)
    op = _case(rng, "1x1", "affine")
    ct = _cotangents(rng, (N, 6, 5, 24), 24, op["x"].shape, "affine")
    jdw = _jax_half(op, ct, "1x1", "affine", 1)[1][2]
    x, s, t = _t(op["x"], torch.bfloat16), _t(op["s"]), _t(op["t"])
    w = _t(_oihw(op["w"], "1x1"))
    rowmax_a, _ = tnt.fwd_rowmax(x, s, t, None, mode="affine")
    y, _, _ = tnt.fwd_conv(x, s, t, None, rowmax_a, *tnt.quantize_w_1x1(w),
                           conv="1x1", mode="affine", rch=1)
    cts = (_t(ct["dy"], torch.bfloat16), _t(ct["dzsum"]), _t(ct["dzssq"]))
    rowmax_g = tnt.bwd_rowmax(*cts[:1], y, *cts[1:])
    dw = tnt.wgrad(cts[0], y, *cts[1:], rowmax_g, x, s, t, None, rowmax_a,
                   conv="1x1", mode="affine", rch=1)
    np.testing.assert_array_equal(dw.numpy(), jdw)
    amax_a = tnt.chunk_amax(rowmax_a, 1, 0)
    amax_g = tnt.chunk_amax(rowmax_g, 1, 0)
    other = (amax_a * tnt.INV_127) * (amax_g * tnt.INV_127)
    assert not torch.equal(other, (amax_a * amax_g) * tnt.INV_127_SQ)


def test_entry_dgrad_adds_dx_res_in_the_dequant_fma():
    """Entry mode: da = fma(f32(acc), ws_in*scale, dx_res), one rounding.
    With dx_res = -bf16(f32(acc)*fac) the sum cancels to the product's
    rounding error: a second rounding step leaves values that round
    apart from the reference's in bf16 (dres) on many elements."""
    rng = np.random.default_rng(7)
    op = _case(rng, "1x1", "entry", h=2, w=4)
    op["x"] = np.abs(op["x"]) + 1.0   # every relu open: du = da
    op["res"] = np.zeros_like(op["x"])
    ct = _cotangents(rng, (N, 2, 4, 24), 24, op["x"].shape, "entry")
    ct["dxout"] = np.zeros_like(op["x"])
    da = _jax_half(op, ct, "1x1", "entry", None)[1][1]   # dres = bf16(da)
    ct["dxout"] = -da
    want = _jax_half(op, ct, "1x1", "entry", None)
    got = _port_half(op, ct, "1x1", "entry", None)
    assert np.count_nonzero(want[1][1]) > 100
    _assert_matches(got, want)
    # the same du with the dequant rounded before the add
    x, s, t = _t(op["x"], torch.bfloat16), _t(op["s"]), _t(op["t"])
    w = _t(_oihw(op["w"], "1x1"))
    y = _t(want[0][0], torch.bfloat16)
    cts = (_t(ct["dy"], torch.bfloat16), _t(ct["dzsum"]), _t(ct["dzssq"]))
    g = tnt.fold_plain(cts[0], y, *cts[1:])
    rch = tnt.pick_chunk_rows(2, 4, N, 16, 24, "1x1", "entry")[1]
    wq, ws_in = tnt.quantize_w_1x1_dgrad(w)
    acc, scale = tnt._conv_chunks(g, tnt.bwd_rowmax(cts[0], y, *cts[1:]),
                                  rch, 0, wq, 1, 24)
    da = tnt._dequant(acc, ws_in, scale, rch) + _t(ct["dxout"])
    live = tnt._fma(x, s, t) > 0
    two = torch.where(live, da, torch.zeros_like(da)).to(torch.bfloat16)
    assert (_np(two) != want[1][1]).any()
