"""The bf16 bodies of the port's bottleneck training halves
(ops/cuda/bneck_nv_train.py ``fwd_conv_bf16``, ``dgrad_conv_bf16``,
``wgrad_bf16`` and the op's ``quant``/``quant_bwd`` switches) against the
JAX package's ``nv_half_1x1`` / ``nv_half_3x3`` run in Pallas interpret
mode on the CPU, at the shape of the JAX package's own ``_vjp_case`` (h=4,
w=6, N=32, Cin=16, Cout=24 for a 1x1, 16 for a 3x3). Inputs are made with
numpy from a seed; the NV carrier is converted with ``to_nv`` /
``from_nv``.

Tolerances: the plain versions sum the bf16 products in float64 and round
to f32 once, the reference sums them in f32 in XLA's order, so a bf16
output may round the other way: y, x_res, dx and dres within 2 bf16 ulps
of the tensor's largest value; the f32 sums over positions (zsum, zssq,
d(s), d(t)) and dW within 1e-4 of their largest value. The int8 forward
of the QAT mode stays equal to JAX's (as in
tests/test_torch_bneck_nv_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu.ops.pallas import bneck_nv_train as jnt
from pytorch_ddp_resnet_tpu.ops.pallas.nv_common import from_nv, to_nv
from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv_train as tnt

from test_torch_bneck_nv_train import (
    N,
    _bf,
    _case,
    _cotangents,
    _np,
    _nv,
    _oihw,
    _t,
)

H, W = 4, 6   # JAX's _vjp_case plane


def _jax_half(op, ct, conv, mode, rch, quant, quant_bwd):
    """JAX forward and vjp, NHWC numpy: ([y, zsum, zssq, x_res | None],
    [dx, dres | None, dW, ds | None, dt | None])."""
    entry, affine = mode == "entry", mode != "identity"
    fn = jnt.nv_half_1x1 if conv == "1x1" else jnt.nv_half_3x3

    def f(*args):
        it = iter(args)
        x = next(it)
        res = next(it) if entry else None
        w = next(it)
        s, t = (next(it), next(it)) if affine else (None, None)
        kw = dict(mode=mode, w_img=W, chunk_rows=rch, quant=quant,
                  quant_bwd=quant_bwd, interpret=True)
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

    def nhwc(a):
        return np.asarray(from_nv(a, W), np.float32)

    fwd = [nhwc(out[0]), np.asarray(out[1]), np.asarray(out[2]),
           nhwc(out[3]) if entry else None]
    dx = nhwc(next(grads))
    dres = nhwc(next(grads)) if entry else None
    dw = np.asarray(next(grads))
    ds, dt = ((np.asarray(next(grads)), np.asarray(next(grads))) if affine
              else (None, None))
    return fwd, [dx, dres, dw, ds, dt]


def _port_half(op, ct, conv, mode, rch, quant, quant_bwd):
    """The port's op, then backward through a loss linear in every output
    with the cotangents as weights; the same lists as ``_jax_half``."""
    entry, affine = mode == "entry", mode != "identity"
    x = _t(op["x"], torch.bfloat16, grad=True)
    res = _t(op["res"], torch.bfloat16, grad=True) if entry else None
    w = _t(_oihw(op["w"], conv), grad=True)
    s = _t(op["s"], grad=True) if affine else None
    t = _t(op["t"], grad=True) if affine else None
    kw = dict(mode=mode, w_img=W, chunk_rows=rch, quant=quant,
              quant_bwd=quant_bwd)
    out = (tnt.nv_half_1x1(x, w, s, t, res, **kw) if conv == "1x1"
           else tnt.nv_half_3x3(x, w, s, t, **kw))
    loss = ((out[0].float() * _t(ct["dy"])).sum()
            + (out[1] * _t(ct["dzsum"])).sum()
            + (out[2] * _t(ct["dzssq"])).sum())
    if entry:
        loss = loss + (out[3].float() * _t(ct["dxout"])).sum()
    loss.backward()
    assert out[0].dtype == torch.bfloat16
    dw = w.grad.numpy()
    dw = dw[:, :, 0, 0].T if conv == "1x1" else dw.transpose(2, 3, 1, 0)
    return ([_np(out[0]), _np(out[1]), _np(out[2]),
             _np(out[3]) if entry else None],
            [_np(x.grad), _np(res.grad) if entry else None, dw,
             s.grad.numpy() if affine else None,
             t.grad.numpy() if affine else None])


def _bf16_close(got, want, name):
    """Within 2 bf16 ulps of the tensor's largest value."""
    scale = np.abs(want).max()
    assert scale > 0, name
    assert np.abs(got - want).max() <= 2 * 2.0 ** -7 * scale, name


def _sum_close(got, want, name):
    scale = np.abs(want).max()
    assert scale > 0, name
    assert np.abs(got - want).max() <= 1e-4 * scale, name


def _assert_matches(got, want, quant):
    (y, zs, zq, xres), (dx, dres, dw, ds, dt) = got
    (jy, jzs, jzq, jxres), (jdx, jdres, jdw, jds, jdt) = want
    if quant:   # the int8 forward: equal
        np.testing.assert_array_equal(y, jy, err_msg="y")
    else:
        _bf16_close(y, jy, "y")
    _sum_close(zs, jzs, "zsum")
    _sum_close(zq, jzq, "zssq")
    _bf16_close(dx, jdx, "dx")
    _sum_close(dw, jdw, "dW")
    assert (xres is None) == (jxres is None)
    if xres is not None:
        _bf16_close(xres, jxres, "x_res")
        _bf16_close(dres, jdres, "dres")
    assert (ds is None) == (jds is None)
    if ds is not None:
        _sum_close(ds, jds, "ds")
        _sum_close(dt, jdt, "dt")


def _operands(seed, conv, mode):
    rng = np.random.default_rng(seed)
    op = _case(rng, conv, mode, h=H, w=W)
    cout = op["w"].shape[-1]
    ct = _cotangents(rng, (N, H, W, cout), cout, op["x"].shape, mode)
    return op, ct


# (quant, quant_bwd) -> the halves each mode runs here: every half in QAT
# (the models' bf16 backward) and in the all-bf16 mode; the bf16 forward
# with the int8 backward at one 1x1 and the 3x3
CASES = ([(True, False, c, m) for c, m in (
    ("1x1", "identity"), ("1x1", "affine"), ("1x1", "entry"),
    ("3x3", "identity"), ("3x3", "affine"))]
    + [(False, False, c, m) for c, m in (
        ("1x1", "identity"), ("1x1", "entry"), ("3x3", "affine"))]
    + [(False, True, "1x1", "entry"), (False, True, "3x3", "affine")])


@pytest.mark.parametrize("quant,quant_bwd,conv,mode", CASES)
def test_half_matches_jax(quant, quant_bwd, conv, mode):
    """Row chunks of 2: two chunks of the 4-row plane, so the 3x3 halo
    crosses a chunk boundary and the wgrad adds two chunks in order."""
    op, ct = _operands(len(conv) * 10 + len(mode) + 2 * quant + quant_bwd,
                       conv, mode)
    want = _jax_half(op, ct, conv, mode, 2, quant, quant_bwd)
    got = _port_half(op, ct, conv, mode, 2, quant, quant_bwd)
    assert len(np.unique(want[0][0])) > 100  # y is not degenerate
    _assert_matches(got, want, quant)


def test_chunk_invariance_bf16():
    """The port's counterpart of JAX's test_chunk_invariance_bf16: the bf16
    forward's y does not depend on the row chunks (1 or 4 rows), its sums
    only through their order; both agree with JAX's."""
    op, ct = _operands(7, "3x3", "affine")
    x, s, t = _t(op["x"], torch.bfloat16), _t(op["s"]), _t(op["t"])
    w = _t(_oihw(op["w"], "3x3"))
    outs = [tnt.nv_half_3x3(x, w, s, t, w_img=W, quant=False,
                            quant_bwd=False, chunk_rows=r) for r in (1, 4)]
    assert torch.equal(outs[0][0], outs[1][0])
    np.testing.assert_allclose(_np(outs[0][1]), _np(outs[1][1]), rtol=1e-6,
                               atol=1e-3)
    want = _jax_half(op, ct, "3x3", "affine", 1, False, False)[0]
    for i in range(3):
        close = _bf16_close if i == 0 else _sum_close
        close(_np(outs[0][i]), want[i], ("y", "zsum", "zssq")[i])


def test_bf16_weight_packers_match_jax():
    """``pack_w_bf16`` / ``pack_w_bf16_dgrad`` hold JAX's ``quant_fwd_w`` /
    ``quant_dgrad_w`` at quant=False (``bneck_nv_train.py:969-986``: the
    HWIO weight cast to bf16, reshaped to taps, transposed for the dgrad)
    in the kernels' layouts, bit for bit."""
    rng = np.random.default_rng(0)
    w1 = rng.normal(size=(24, 40)).astype(np.float32)   # [Cin, Cout]
    w3 = rng.normal(size=(3, 3, 24, 40)).astype(np.float32)
    j1 = np.asarray(jnp.asarray(w1).astype(jnp.bfloat16), np.float32)
    j3 = np.asarray(jnp.asarray(w3).reshape(9, 24, 40).astype(jnp.bfloat16),
                    np.float32)                           # [9, Cin, Cout]
    j3_dg = j3.transpose(0, 2, 1)                         # [9, Cout, Cin]
    for got, want in (
            (tnt.pack_w_bf16(_t(_oihw(w1, "1x1"))), j1.T),
            (tnt.pack_w_bf16_dgrad(_t(_oihw(w1, "1x1"))), j1),
            (tnt.pack_w_bf16(_t(_oihw(w3, "3x3"))),
             j3.transpose(2, 0, 1).reshape(40, -1)),
            (tnt.pack_w_bf16_dgrad(_t(_oihw(w3, "3x3"))),
             j3_dg.transpose(2, 0, 1).reshape(24, -1))):
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        np.testing.assert_array_equal(_np(got), want)


def test_entry_dgrad_adds_dx_res_after_the_product():
    """bf16 entry mode: da = f32(bf16(g) . bf16(w)) + dx_res, a plain f32
    add (JAX ``bneck_nv_train.py:504``; the int8 body's dequant FMA has no
    counterpart here). With dx_res = -bf16(da) the sum cancels to da's
    bf16 rounding residue, which dres carries; rounding da to bf16 before
    the add (or adding in bf16) would leave exactly 0."""
    op, ct = _operands(8, "1x1", "entry")
    op["x"] = np.abs(op["x"]) + 1.0   # every relu open: du = da
    op["res"] = np.zeros_like(op["x"])
    ct["dxout"] = np.zeros_like(op["x"])
    da = _jax_half(op, ct, "1x1", "entry", None, True, False)[1][1]
    ct["dxout"] = -_bf(da)
    want = _jax_half(op, ct, "1x1", "entry", None, True, False)
    got = _port_half(op, ct, "1x1", "entry", None, True, False)
    assert np.count_nonzero(want[1][1]) > 1000
    assert np.abs(want[1][1]).max() < 2.0 ** -7 * np.abs(da).max()
    _assert_matches(got, want, True)


def test_qat_forward_is_the_int8_forward_and_writes_no_cotangent_maxima():
    """QAT on the CPU runs the int8 forward stages and the bf16 backward
    ones: the plain versions called are the int8 forward's, the bf16
    dgrad's and wgrad's, no row absmax of the cotangent."""
    op, ct = _operands(9, "3x3", "affine")
    calls = {}
    names = ("fwd_rowmax_plain", "fwd_conv_plain", "fwd_conv_bf16_plain",
             "bwd_rowmax_plain", "dgrad_conv_plain", "dgrad_conv_bf16_plain",
             "wgrad_plain", "wgrad_bf16_plain")
    with pytest.MonkeyPatch.context() as mp:
        for name in names:
            orig = getattr(tnt, name)

            def spy(*a, _orig=orig, _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _orig(*a, **k)

            mp.setattr(tnt, name, spy)
        _port_half(op, ct, "3x3", "affine", None, True, False)
        assert calls == {"fwd_rowmax_plain": 1, "fwd_conv_plain": 1,
                         "dgrad_conv_bf16_plain": 1, "wgrad_bf16_plain": 1}
        calls.clear()
        _port_half(op, ct, "3x3", "affine", None, False, True)
        assert calls == {"fwd_conv_bf16_plain": 1, "fwd_rowmax_plain": 1,
                         "bwd_rowmax_plain": 1, "dgrad_conv_plain": 1,
                         "wgrad_plain": 1}


@pytest.mark.parametrize("quant,quant_bwd", [(True, False), (False, False),
                                             (False, True)])
def test_half_stages_match_the_op(quant, quant_bwd):
    """``half_stages`` (what the card check runs) runs the op's bodies: its
    outputs on the CPU equal the op's and its plain path's."""
    op, ct = _operands(10, "1x1", "entry")
    rch = (2, 1, 2)
    ops = dict(x=_t(op["x"], torch.bfloat16), w=_t(_oihw(op["w"], "1x1")),
               s=_t(op["s"]), t=_t(op["t"]),
               res=_t(op["res"], torch.bfloat16),
               dy=_t(ct["dy"], torch.bfloat16), dzsum=_t(ct["dzsum"]),
               dzssq=_t(ct["dzssq"]), dxout=_t(ct["dxout"], torch.bfloat16))
    kw = dict(conv="1x1", mode="entry", rch=rch, quant=quant,
              quant_bwd=quant_bwd)
    got = tnt.half_stages(**ops, **kw)
    plain = tnt.half_stages(**ops, **kw, plain=True)
    assert set(got) == set(plain)
    assert ("rowmax_g" in got) == quant_bwd and ("rowmax_a" in got) == (
        quant or quant_bwd)
    for k, v in got.items():
        assert torch.equal(v, plain[k]), k
    x = ops["x"].clone().requires_grad_()
    w = ops["w"].clone().requires_grad_()
    s = ops["s"].clone().requires_grad_()
    t = ops["t"].clone().requires_grad_()
    res = ops["res"].clone().requires_grad_()
    y, zsum, zssq, x_res = tnt._NVHalf.apply(x, res, w, s, t, "1x1", "entry",
                                             rch, quant, quant_bwd)
    torch.autograd.backward([y, zsum, zssq, x_res],
                            [ops["dy"], ops["dzsum"], ops["dzssq"],
                             ops["dxout"]])
    for name, v in (("y", y), ("zsum", zsum), ("zssq", zssq),
                    ("x_res", x_res), ("dx", x.grad), ("dres", res.grad),
                    ("ds", s.grad), ("dt", t.grad)):
        assert torch.equal(v, got[name]), name
    assert torch.equal(w.grad[:, :, 0, 0].t(), got["dw"])
