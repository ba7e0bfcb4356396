"""The port's int8 1x1 conv with the requantization epilogue
(ops/cuda/conv1x1.py ``conv1x1_lanes_requant``, ``pick_tile_dense``,
``pack_weights_1x1``) against the JAX package's ``conv1x1_lanes_requant``
with ``interpret=True``, as tests/test_conv1x1.py runs it, on the same
inputs.

Tolerance: none. The s32 product is exact in both, and the epilogue takes
the same f32 operations in the same order with the same rounding points
(XLA contracts ``acc * scale + shift`` and the dual ``y * sb + tb`` into
fused multiply-adds; a probe pins both, for the 3x3 int8 serving conv too,
whose epilogue is the same), so int8 and bf16 outputs are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu.ops.pallas import conv as jconv
from pytorch_ddp_resnet_tpu.ops.pallas import conv1x1 as jc
from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv1x1 as c1
from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3 as k


def _case(cin, cout, n, seed):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (cin, n)).astype(np.int8)
    w_hwio = rng.integers(-127, 128, (1, 1, cin, cout)).astype(np.int8)
    scale = (rng.uniform(0.5, 2.0, (cout,)) * 1e-3).astype(np.float32)
    shift = (rng.normal(size=(cout,)) * 0.01).astype(np.float32)
    res = rng.normal(size=(cout, n)).astype(np.float32)
    sb = rng.uniform(0.5, 2.0, (cout,)).astype(np.float32)
    tb = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    return xq, w_hwio, scale, shift, res, sb, tb


# (relu, inv_out_scale, residual, dual): the epilogue's modes
MODES = {"bf16": (True, None, False, False),
         "bf16-norelu": (False, None, False, False),
         "int8": (True, 50.0, False, False),
         "int8-norelu": (False, 50.0, False, False),
         "bf16+res": (True, None, True, False),
         "bf16+res+dual": (False, None, True, True),
         "bf16+dual": (True, None, False, True)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("cin,cout,n,seed", [(64, 32, 512, 0),
                                             (256, 64, 1024, 1),
                                             (48, 40, 384, 2)])
def test_epilogue_modes_match_jax(mode, cin, cout, n, seed):
    relu, inv, use_res, use_dual = MODES[mode]
    xq, w_hwio, scale, shift, res, sb, tb = _case(cin, cout, n, seed)
    jres = jnp.asarray(res, jnp.bfloat16) if use_res else None
    jdual = (jnp.asarray(sb), jnp.asarray(tb)) if use_dual else None
    want = jc.conv1x1_lanes_requant(
        jnp.asarray(xq), jc.pack_weights_1x1(jnp.asarray(w_hwio)),
        jnp.asarray(scale), jnp.asarray(shift), jres, jdual, relu=relu,
        inv_out_scale=inv, interpret=True)
    wq = c1.pack_weights_1x1(torch.from_numpy(
        w_hwio.transpose(3, 2, 0, 1).copy()))
    got = c1.conv1x1_lanes_requant(
        torch.from_numpy(xq), wq, torch.from_numpy(scale),
        torch.from_numpy(shift),
        torch.from_numpy(res).to(torch.bfloat16) if use_res else None,
        ((torch.from_numpy(sb), torch.from_numpy(tb)) if use_dual
         else None), relu=relu, inv_out_scale=inv)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want) == 1 + use_dual
    for g, w in zip(got, want):
        assert g.dtype == (torch.int8 if w.dtype == jnp.int8
                           else torch.bfloat16)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    assert not c1.launches  # CPU: the plain version only


@pytest.mark.parametrize("n,c", [(512, 64), (802816, 256), (12544, 2048),
                                 (1568, 2048), (6272, 512), (128, 4096),
                                 (100, 64)])
def test_pick_tile_dense_matches_jax(n, c):
    """The JAX test's values and more, its refusals included."""
    try:
        want = jc.pick_tile_dense(n, c)
    except ValueError as e:
        with pytest.raises(ValueError, match="128-lane") as err:
            c1.pick_tile_dense(n, c)
        assert str(err.value) == str(e)
        return
    assert c1.pick_tile_dense(n, c) == want


def test_refusals_match_jax():
    """Dual with an int8 output, mismatched weights, a 3x3 kernel to the
    1x1 packer, and an N off the 128-lane tile: both packages raise."""
    xq, w_hwio, scale, shift, _, sb, tb = _case(64, 32, 512, 0)
    wq_j = jc.pack_weights_1x1(jnp.asarray(w_hwio))
    wq_t = torch.from_numpy(np.asarray(wq_j))
    xt, st, ht = (torch.from_numpy(a) for a in (xq, scale, shift))
    dual_t = (torch.from_numpy(sb), torch.from_numpy(tb))
    dual_j = (jnp.asarray(sb), jnp.asarray(tb))
    cases = [
        ("dual", (xq, wq_j, dual_j, 2.0), (xt, wq_t, dual_t, 2.0)),
        ("vs Cin", (xq[:32], wq_j, None, None), (xt[:32], wq_t, None, None)),
        ("128-lane", (xq[:, :200], wq_j, None, None),
         (xt[:, :200], wq_t, None, None)),
    ]
    for match, (jx, jw, jd, jinv), (tx, tw, td, tinv) in cases:
        with pytest.raises(ValueError, match=match):
            jc.conv1x1_lanes_requant(jnp.asarray(jx), jw, jnp.asarray(scale),
                                     jnp.asarray(shift), None, jd, relu=True,
                                     inv_out_scale=jinv, interpret=True)
        with pytest.raises(ValueError, match=match):
            c1.conv1x1_lanes_requant(tx, tw, st, ht, None, td, relu=True,
                                     inv_out_scale=tinv)
    with pytest.raises(ValueError, match="1x1"):
        jc.pack_weights_1x1(jnp.zeros((3, 3, 8, 8), jnp.int8))
    with pytest.raises(ValueError, match="1x1"):
        c1.pack_weights_1x1(torch.zeros((8, 8, 3, 3), dtype=torch.int8))


def test_pack_weights_1x1_matches_jax():
    w_hwio = np.random.default_rng(4).integers(
        -127, 128, (1, 1, 24, 40)).astype(np.int8)
    want = np.asarray(jc.pack_weights_1x1(jnp.asarray(w_hwio)))
    got = c1.pack_weights_1x1(torch.from_numpy(
        w_hwio.transpose(3, 2, 0, 1).copy()))
    assert got.shape == (40, 24) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kernel", ["conv1x1", "conv3x3"])
@pytest.mark.parametrize("stage", ["scale", "dual"])
def test_epilogue_rounding_points_match_jax(kernel, stage):
    """A probe of the epilogue shared with the 3x3 int8 serving conv: an
    accumulator of 101 everywhere and per-channel factors chosen so that
    ``101 * f + t`` lies a product's rounding error away from x.5. Rounded
    once (an FMA, as XLA computes the reference) and rounded twice the
    int8 results differ, and the port must round as the reference."""
    rng = np.random.default_rng(5)
    cin, cout, h, w, b = 32, 64, 8, 8, 4
    n = b * h * w
    f = rng.uniform(0.3, 0.9, cout).astype(np.float32)
    p = (np.float32(101) * f).astype(np.float32)
    t = (2.5 - p.astype(np.float64)).astype(np.float32)  # exact in f32
    xq = np.zeros((cin, n), np.int8)
    xq[0] = 101
    ones, zeros = np.ones(cout, np.float32), np.zeros(cout, np.float32)
    scale, shift, dual = ((f, t, None) if stage == "scale"
                          else (ones, zeros, (f, t)))
    inv = 1.0 if stage == "scale" else None
    if kernel == "conv1x1":
        wq = np.zeros((cout, cin), np.int8)
        wq[:, 0] = 1
        jfn = jc.conv1x1_lanes_requant
        tfn, kw = c1.conv1x1_lanes_requant, {}
    else:
        wq = np.zeros((cout, 9 * cin), np.int8)
        wq[:, 4 * cin] = 1  # the centre tap of channel 0
        jfn, tfn = jconv.conv3x3_lanes_requant, k.conv3x3_int8_requant
        kw = dict(h=h, w_img=w)
    want = jfn(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale),
               jnp.asarray(shift), None,
               None if dual is None else tuple(map(jnp.asarray, dual)),
               relu=False, inv_out_scale=inv, interpret=True, **kw)
    got = tfn(torch.from_numpy(xq), torch.from_numpy(wq),
              torch.from_numpy(scale), torch.from_numpy(shift), None,
              None if dual is None else tuple(map(torch.from_numpy, dual)),
              relu=False, inv_out_scale=inv, **kw)
    want, got = np.asarray(want[-1] if dual else want), (
        got[-1] if dual else got).numpy()
    twice = np.clip(np.round(np.maximum(
        (np.float32(101) * f).astype(np.float32) + t, 0)), -127, 127)
    assert (want != twice[:, None]).any()  # the probe discriminates
    np.testing.assert_array_equal(got, want)
