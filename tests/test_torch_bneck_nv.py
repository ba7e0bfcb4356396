"""The port's int8 bottleneck kernels' plain versions (ops/cuda/bneck_nv.py)
and scale folding (ops/cuda/nv_common.py) against the JAX package's
``bneck_block_nv`` / ``bneck_transition_nv`` run as its own tests run them
(Pallas interpret mode on the CPU). The JAX kernels take the TPU's NV
layout [h, wp, N, C]; the port takes int8 NHWC; the tests convert with
the JAX package's ``to_nv`` / ``from_nv``.

Tolerance: none. The int8 products are exact in both, and the plain
versions round where the reference rounds, so int8 outputs are equal and
bf16 outputs are equal. The probes pin each rounding point with inputs
on which the alternative gives a different result:
- conv2's padding is zero after requant, not requant of zero;
- the entry quantization multiplies by f32(1/scale) (no division);
- ``acc*p + q`` (both requants and conv3), ``x*r + y`` and
  ``accP*pp + y`` are single FMAs in the reference (XLA contracts them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu.ops.pallas import bneck_nv as jnv
from pytorch_ddp_resnet_tpu.ops.pallas.nv_common import (
    fold_block_scales as jax_fold_block_scales,
)
from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv as tnv
from pytorch_ddp_resnet_tpu_torch.ops.cuda import nv_common as tnc

N = 32  # the JAX kernels need a pow2 multiple of 32 images


def _rand_ops(rng, cin, wdt, cout, proj):
    """Int8 weights in the JAX layouts and folded vectors whose requants
    land across the whole int8 range."""
    ops = dict(w1=rng.integers(-127, 128, (cin, wdt)).astype(np.int8),
               w2=rng.integers(-127, 128, (9, wdt, wdt)).astype(np.int8),
               w3=rng.integers(-127, 128, (wdt, cout)).astype(np.int8))
    if proj:
        ops["wp"] = rng.integers(-127, 128, (cin, cout)).astype(np.int8)

    def sc(k, fan):  # about 40 int8 levels per standard deviation of acc
        return (rng.uniform(0.5, 1.5, k) * 40 / (fan ** 0.5 * 127 ** 2 / 3)
                ).astype(np.float32)

    def off(k):
        return rng.uniform(-2.0, 2.0, k).astype(np.float32)

    ops["vec"] = [sc(wdt, cin), off(wdt), sc(wdt, 9 * wdt), off(wdt),
                  sc(cout, wdt), off(cout)]
    ops["res"] = sc(cout, cin) if proj else 0.37
    return ops


def _jax(x, ops, *, stride=None, out_int8=True):
    """The JAX kernel on NHWC int8 x; returns NHWC as float32."""
    vec = [jnp.asarray(v) for v in ops["vec"]]
    w = [jnp.asarray(ops[k]) for k in ("w1", "w2", "w3")]
    x_nv = jnv.to_nv(jnp.asarray(x))
    if stride is None:
        out = jnv.bneck_block_nv(x_nv, *w, *vec, ops["res"], w=x.shape[2],
                                 out_int8=out_int8, interpret=True)
        ow = x.shape[2]
    else:
        out = jnv.bneck_transition_nv(
            x_nv, *w, jnp.asarray(ops["wp"]), *vec, jnp.asarray(ops["res"]),
            w=x.shape[2], stride=stride, out_int8=out_int8, interpret=True)
        ow = (x.shape[2] - 1) // stride + 1
    return np.asarray(jnv.from_nv(out, ow), np.float32)


def _port_weights(ops):
    """The JAX kernel layouts -> the port's (contraction innermost)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    wdt = ops["w2"].shape[1]
    out = [t(ops["w1"].T), t(ops["w2"].transpose(2, 0, 1).reshape(
        wdt, 9 * wdt)), t(ops["w3"].T)]
    if "wp" in ops:
        out.append(t(ops["wp"].T))
    return out


def _port(x, ops, *, stride=None, out_int8=True):
    vec = [torch.from_numpy(v) for v in ops["vec"]]
    xt = torch.from_numpy(x)
    if stride is None:
        out = tnv.bneck_block_nv(xt, *_port_weights(ops), *vec, ops["res"],
                                 out_int8=out_int8)
    else:
        out = tnv.bneck_transition_nv(xt, *_port_weights(ops), *vec,
                                      torch.from_numpy(ops["res"]),
                                      stride=stride, out_int8=out_int8)
    assert out.dtype == (torch.int8 if out_int8 else torch.bfloat16)
    assert out.is_contiguous()
    return out.float().numpy()


def _rand_x(rng, h, w, c, n=N):
    return rng.integers(-127, 128, (n, h, w, c)).astype(np.int8)


# --- folding --------------------------------------------------------------------

def test_fold_scales_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    vecs = [rng.uniform(0.1, 2.0, 48).astype(np.float32) for _ in range(9)]
    vecs[2::3] = [rng.normal(0, 1, 48).astype(np.float32) for _ in range(3)]
    wps = rng.uniform(1e-3, 1e-2, 48).astype(np.float32)
    for s_out in (0.0731, 1.0):
        args = (0.0213, 0.0457, 0.0119, s_out)
        want = jax_fold_block_scales(*args, *vecs)
        got = tnc.fold_block_scales(*args, *[torch.from_numpy(v)
                                              for v in vecs])
        for g, w_ in zip(got[:6], want[:6]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
        assert got[6] == want[6]
        want = jnv.fold_transition_scales(*args, *vecs, wps)
        got = tnc.fold_transition_scales(
            *args, *[torch.from_numpy(v) for v in vecs],
            torch.from_numpy(wps))
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


# --- the kernels' plain versions against the JAX kernels ----------------------

@pytest.mark.parametrize("h,w,cin,wdt", [(6, 5, 32, 16), (7, 7, 64, 32)])
@pytest.mark.parametrize("out_int8", [True, False])
def test_block_plain_equals_jax(h, w, cin, wdt, out_int8):
    rng = np.random.default_rng(h * w + cin)
    ops = _rand_ops(rng, cin, wdt, cin, proj=False)
    x = _rand_x(rng, h, w, cin)
    want = _jax(x, ops, out_int8=out_int8)
    got = _port(x, ops, out_int8=out_int8)
    assert len(np.unique(want)) > 50  # the outputs are not saturated
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,cin,wdt,cout,stride", [
    (6, 6, 32, 16, 64, 2),    # JAX pads the output carrier: wp 8 > 4
    (8, 8, 32, 32, 64, 2),
    (6, 5, 32, 16, 64, 1),    # stride-1 stage entry (channel change)
])
@pytest.mark.parametrize("out_int8", [True, False])
def test_transition_plain_equals_jax(h, w, cin, wdt, cout, stride,
                                     out_int8):
    rng = np.random.default_rng(h * w + cout + stride)
    ops = _rand_ops(rng, cin, wdt, cout, proj=True)
    x = _rand_x(rng, h, w, cin)
    want = _jax(x, ops, stride=stride, out_int8=out_int8)
    got = _port(x, ops, stride=stride, out_int8=out_int8)
    assert got.shape == (N, (h - 1) // stride + 1, (w - 1) // stride + 1,
                         cout)
    assert len(np.unique(want)) > 50
    np.testing.assert_array_equal(got, want)


def test_transition_feeds_identity_block_as_jax():
    """A stride-2 transition -> identity pair on the int8 carrier (cf. the
    JAX package's test_transition_feeds_identity_block)."""
    rng = np.random.default_rng(4)
    h, w, cin, wdt, cout = 6, 6, 32, 16, 64
    t_ops = _rand_ops(rng, cin, wdt, cout, proj=True)
    i_ops = _rand_ops(rng, cout, wdt, cout, proj=False)
    x = _rand_x(rng, h, w, cin)
    mid = _port(x, t_ops, stride=2).astype(np.int8)
    np.testing.assert_array_equal(mid, _jax(x, t_ops, stride=2))
    # the JAX pair on its own carrier, padded wp included
    vec = [jnp.asarray(v) for v in t_ops["vec"]]
    mid_nv = jnv.bneck_transition_nv(
        jnv.to_nv(jnp.asarray(x)), *[jnp.asarray(t_ops[k]) for k in
                                     ("w1", "w2", "w3", "wp")],
        *vec, jnp.asarray(t_ops["res"]), w=w, stride=2, interpret=True)
    out_nv = jnv.bneck_block_nv(
        mid_nv, *[jnp.asarray(i_ops[k]) for k in ("w1", "w2", "w3")],
        *[jnp.asarray(v) for v in i_ops["vec"]], i_ops["res"], w=3,
        out_int8=False, interpret=True)
    want = np.asarray(jnv.from_nv(out_nv, 3), np.float32)
    np.testing.assert_array_equal(_port(mid, i_ops, out_int8=False), want)


def test_plain_wrappers_count_no_launches():
    rng = np.random.default_rng(5)
    ops = _rand_ops(rng, 32, 32, 32, proj=False)
    tnv.reset_launches()
    _port(_rand_x(rng, 4, 4, 32, n=2), ops)
    assert sum(tnv.launches.values()) == 0


def test_wrappers_check_shapes():
    x = torch.zeros((2, 4, 4, 32), dtype=torch.int8)
    w1, w2, w3 = (torch.zeros(s, dtype=torch.int8)
                  for s in ((16, 32), (16, 144), (64, 16)))
    v = torch.ones(16)
    with pytest.raises(ValueError, match="Cout == Cin"):
        tnv.bneck_block_nv(x, w1, w2, w3, v, v, v, v, torch.ones(64),
                           torch.ones(64), 1.0)
    with pytest.raises(ValueError, match="projection"):
        tnv.bneck_transition_nv(x, w1, w2, w3, torch.zeros(
            (64, 16), dtype=torch.int8), v, v, v, v, torch.ones(64),
            torch.ones(64), torch.ones(64))


# --- rounding-point probes ----------------------------------------------------------

def _fma_sensitive(rng, count, p_fixed=None):
    """(acc, p, q) with acc an integer in [1, 127] such that rint(relu(
    acc*p + q)) differs between one rounding (FMA) and two."""
    found = []
    while len(found) < count:
        acc = rng.integers(1, 128, 200_000).astype(np.float32)
        p = (np.full(acc.size, p_fixed, np.float32) if p_fixed is not None
             else rng.uniform(0.3, 1.0, acc.size).astype(np.float32))
        q = rng.uniform(-5, 5, acc.size).astype(np.float32)
        once = (acc.astype(np.float64) * p + q).astype(np.float32)
        twice = (acc * p).astype(np.float32) + q
        hit = np.nonzero(np.round(np.maximum(once, 0))
                         != np.round(np.maximum(twice, 0)))[0]
        found += [(acc[i], p[i], q[i]) for i in hit[:count - len(found)]]
    acc, p, q = (np.array(v, np.float32) for v in zip(*found))
    return acc, p, q


def _identity_ops(c, *, proj):
    """Weights that pass values straight through: 1x1s are identities and
    conv2 is its centre tap; every (p, q) is (1, 0) until a probe sets
    one. Returns the JAX-layout ops dict."""
    eye = np.eye(c, dtype=np.int8)
    w2 = np.zeros((9, c, c), np.int8)
    w2[4] = eye
    ones, zeros = np.ones(c, np.float32), np.zeros(c, np.float32)
    ops = dict(w1=eye, w2=w2, w3=eye.copy(),
               vec=[ones, zeros, ones.copy(), zeros.copy(), ones.copy(),
                    zeros.copy()], res=0.0)
    if proj:
        ops["wp"] = eye.copy()
        ops["res"] = np.zeros(c, np.float32)
    return ops


def _probe(ops, x, *, stride=None):
    want = _jax(x, ops, stride=stride)
    got = _port(x, ops, stride=stride)
    np.testing.assert_array_equal(got, want)
    return want


@pytest.mark.parametrize("where", ["conv1", "conv2", "conv3"])
def test_requant_epilogues_are_one_fma(where):
    c, h, w = 32, 2, 2
    acc, p, q = _fma_sensitive(np.random.default_rng(1), c)
    ops = _identity_ops(c, proj=False)
    ops["vec"][{"conv1": 0, "conv2": 2, "conv3": 4}[where]] = p
    ops["vec"][{"conv1": 1, "conv2": 3, "conv3": 5}[where]] = q
    x = np.broadcast_to(acc.astype(np.int8), (N, h, w, c)).copy()
    out = _probe(ops, x)[0, 0, 0]
    once = np.round(np.maximum((acc.astype(np.float64) * p + q).astype(
        np.float32), 0))
    np.testing.assert_array_equal(out, once)


def test_residual_is_one_fma():
    c, h, w = 32, 2, 2
    r = np.float32(0.7137)
    acc, _, q = _fma_sensitive(np.random.default_rng(2), c, p_fixed=r)
    ops = _identity_ops(c, proj=False)
    ops["w3"] = np.zeros((c, c), np.int8)  # y = q3 exactly
    ops["vec"][5] = q
    ops["res"] = float(r)
    x = np.broadcast_to(acc.astype(np.int8), (N, h, w, c)).copy()
    out = _probe(ops, x)[0, 0, 0]
    np.testing.assert_array_equal(out, np.round(np.maximum(
        (acc.astype(np.float64) * r + q).astype(np.float32), 0)))


@pytest.mark.parametrize("stride", [1, 2])
def test_projection_is_one_fma(stride):
    c, h, w = 32, 2, 2
    acc, pp, q = _fma_sensitive(np.random.default_rng(3), c)
    ops = _identity_ops(c, proj=True)
    ops["w3"] = np.zeros((c, c), np.int8)
    ops["vec"][5] = q
    ops["res"] = pp
    x = np.broadcast_to(acc.astype(np.int8), (N, h, w, c)).copy()
    out = _probe(ops, x, stride=stride)[0, 0, 0]
    np.testing.assert_array_equal(out, np.round(np.maximum(
        (acc.astype(np.float64) * pp + q).astype(np.float32), 0)))


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2_padding_is_zero_after_requant(stride):
    """With x = 0 and q1 > 0, a1 = round(q1) inside the image; conv2 must
    see zeros outside it, where requant(0) would be round(q1) too. All
    nine taps sum, so border outputs differ from interior ones."""
    c, h, w = 32, 4, 4
    ops = _identity_ops(c, proj=stride == 2)
    ops["w2"] = np.broadcast_to(np.eye(c, dtype=np.int8), (9, c, c)).copy()
    ops["vec"][1] = np.full(c, 3.0, np.float32)  # a1 = 3 in the image
    x = np.zeros((N, h, w, c), np.int8)
    out = _probe(ops, x, stride=None if stride == 1 else stride)[0, ..., 0]
    # taps inside the image: each contributes 3
    inside = np.zeros((h + 2, w + 2))
    inside[1:-1, 1:-1] = 3
    want = np.array([[inside[oy * stride:oy * stride + 3,
                             ox * stride:ox * stride + 3].sum()
                      for ox in range((w - 1) // stride + 1)]
                     for oy in range((h - 1) // stride + 1)])
    np.testing.assert_array_equal(out, np.minimum(want, 127))
    assert out.min() < 27  # the border taps really were zero


def test_entry_quantization_multiplies_by_the_reciprocal():
    scale = 0.0123
    # values within a few f32 ulps of a .5 tie of x / scale
    ties = ((np.arange(-127, 127) + 0.5) * scale).astype(np.float32)
    x = (ties[:, None] * (1 + np.arange(-4, 5) * 2.0 ** -23)).astype(
        np.float32).ravel()
    by_mul = np.round(x * np.float32(1.0 / scale))
    by_div = np.round(x / np.float32(scale))
    x = x[by_mul != by_div][:64]
    assert x.size == 64  # values on which the two differ
    x = x.reshape(1, 2, 1, 32)
    want = np.asarray(jnv.from_nv(jnv.quantize_to_nv(jnp.asarray(x), scale),
                                  1))
    got = tnc.quantize_to_nv(torch.from_numpy(x), scale)
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().ravel(),
                                  np.clip(by_mul[by_mul != by_div][:64],
                                          -127, 127))
