"""The port's lane stem (ops/cuda/stem.py) against the JAX package's
``stem_conv_lane(..., interpret=True)``: the tile picker, the forward and
the weight and bias gradients.

Tolerances: the forward's f32 sums of the 27 exact bf16 products differ
from the reference's only in their order, which can move a bf16 output by
one ulp (at most 1 in 1,000 outputs here; none beyond one ulp); the
gradients are f32 sums over positions in another order: 1e-5 of the
largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu.ops.pallas import stem as jstem
from pytorch_ddp_resnet_tpu_torch.ops.cuda import stem as tstem
from pytorch_ddp_resnet_tpu_torch.ops.cuda.conv3x3 import pack_weights

CIN, COUT, H, W, B = 3, 32, 8, 8, 8
N = B * H * W


@pytest.mark.parametrize("h,w,b,cout", [
    (32, 32, 128, 160), (32, 32, 512, 160), (8, 8, 8, 32), (8, 8, 1, 32),
    (8, 8, 2, 16), (7, 7, 4, 32), (224, 224, 2, 64), (4, 4, 4, 32)])
def test_stem_tile_matches_jax(h, w, b, cout):
    def outcome(fn):
        try:
            return fn(h, w, b * h * w, cout)
        except ValueError:
            return "raises"

    assert outcome(tstem.stem_lane_tile) == outcome(jstem.stem_lane_tile)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = np.asarray(jnp.asarray(rng.standard_normal((CIN, N)), jnp.bfloat16),
                   np.float32)
    w = (rng.standard_normal((3, 3, CIN, COUT)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(COUT) * 0.1).astype(np.float32)
    dy = np.asarray(jnp.asarray(rng.standard_normal((COUT, N)),
                                jnp.bfloat16), np.float32)
    return x, w, b, dy


def _port(x, w, b):
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    return xt, wt, bt


def test_forward_and_gradients_match_jax():
    x, w, b, dy = _inputs()
    jy, vjp = jax.vjp(
        lambda xx, ww, bb: jstem.stem_conv_lane(xx, ww, bb, h=H, w_img=W,
                                                interpret=True),
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b))
    _, jdw, jdb = vjp(jnp.asarray(dy, jnp.bfloat16))
    xt, wt, bt = _port(x, w, b)
    ty = tstem.stem_conv_lane(xt, wt, bt, h=H, w_img=W)
    assert ty.dtype == torch.bfloat16 and ty.shape == (COUT, N)
    jy = np.asarray(jy, np.float32)
    got = ty.detach().float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(jy), 2.0 ** -126))) - 7)
    assert (np.abs(got - jy) <= ulp).all()
    assert (got != jy).mean() <= 1e-3
    (ty.float() * torch.from_numpy(dy)).sum().backward()
    assert xt.grad is None  # the data batch gets no gradient
    for g, j in ((wt.grad.permute(2, 3, 1, 0), jdw), (bt.grad, jdb)):
        g, j = g.numpy(), np.asarray(j)
        assert g.shape == j.shape
        assert np.abs(g - j).max() <= 1e-5 * np.abs(j).max()


def test_plain_forward_sums_in_the_kernel_order():
    """The plain version adds the 27 products tap-major, channel-minor in
    f32 (the kernel's order): against the exact sum rounded once it may
    differ, but only by the f32 rounding of a sum of 27 exact products."""
    x, w, b, _ = _inputs(1)
    xt, wt, bt = _port(x, w, b)
    wp = pack_weights(wt.detach().to(torch.bfloat16))
    y = tstem.stem_fwd_plain(xt, wp, bt.detach(), h=H, w_img=W)
    exact = torch.nn.functional.conv2d(
        xt.double().reshape(CIN, B, H, W).transpose(0, 1),
        wt.detach().to(torch.bfloat16).double(), padding=1)
    exact = exact.transpose(0, 1).reshape(COUT, N)
    want = exact.float().to(torch.bfloat16) + bt.detach().to(torch.bfloat16)[
        :, None]
    d = (y.float() - want.float()).abs()
    assert (d <= want.float().abs() * 2.0 ** -7).all()
    assert (d > 0).float().mean() <= 1e-2


def test_refuses_wide_inputs():
    x = torch.zeros((9, N), dtype=torch.bfloat16)
    w = torch.zeros((COUT, 9, 3, 3))
    with pytest.raises(ValueError, match="Cin <= 8"):
        tstem.stem_conv_lane(x, w, torch.zeros(COUT), h=H, w_img=W)
