"""The port's lane-through stage transition (ops/cuda/transition.py
``transition_half_int8``; models/blocks.py ``lane_through_eligible`` /
``apply_lane_through``; the lane-through branch of models/layers.py
``Sequential``) against the JAX package's ``transition_half_int8`` with
``interpret=True`` and its block and ``Sequential``.

Tolerances: the parity helpers, the tile picker, the weight packers and
every int8 decision are exact (the same f32 operations in the same order;
z is the same dequantized s32 sum). The projection's bf16 products are
summed in f32 by the reference and in float64 here, so res and the bf16 dx
of the straight-through body may differ by 2 bf16 ulps of the tensor's
largest value; f32 sums over positions (zsum, zssq, d(scale), d(shift),
dW, dWp) agree to 1e-5 of their largest value, 1e-4 where the reference
sums bf16 products in f32 (the straight-through dW). The FQT backward is
held, as in tests/test_torch_int8_train.py, within twice the reference's
own distance from the exact float backward. Blocks and steps fold
BatchNorm from f32 sums taken in another order, so they are held at the
int8 grain and by the distance of the reference's step from the exact
f32 step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu.algos import steps as jsteps
from pytorch_ddp_resnet_tpu.models.blocks import (
    ResidualBlock as JaxBlock,
)
from pytorch_ddp_resnet_tpu.models.layers import Sequential as JaxSequential
from pytorch_ddp_resnet_tpu.models.resnet import ResNet as JaxResNet
from pytorch_ddp_resnet_tpu.ops.pallas import fused_block as jfb
from pytorch_ddp_resnet_tpu.ops.pallas import transition as jt
from pytorch_ddp_resnet_tpu.utils import optim as joptim
from pytorch_ddp_resnet_tpu_torch.algos.steps import (
    init_train_state,
    make_train_step,
)
from pytorch_ddp_resnet_tpu_torch.convert import (
    load_jax_train_state,
    state_dict_from_jax,
)
from pytorch_ddp_resnet_tpu_torch.models import blocks as tblocks
from pytorch_ddp_resnet_tpu_torch.models import layers as tlayers
from pytorch_ddp_resnet_tpu_torch.models.blocks import ResidualBlock
from pytorch_ddp_resnet_tpu_torch.models.layers import Sequential
from pytorch_ddp_resnet_tpu_torch.models.resnet import ResNet
from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
from pytorch_ddp_resnet_tpu_torch.ops.cuda import transition as tr
from pytorch_ddp_resnet_tpu_torch.utils import optim as toptim

from _torch_port_helpers import JaxKey, _randomize_bn

B, H, W, CIN, COUT = 8, 16, 16, 32, 64
N = B * H * W
RATE = 0.3


def _bf(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _inputs(seed=0, cin=CIN, cout=COUT, n=N):
    """x (bf16-valued), w1 HWIO, wp [Cin, Cout], scale, shift, packed bits,
    as numpy."""
    rng = np.random.default_rng(seed)
    x = _bf(rng.standard_normal((cin, n)))
    w1 = (rng.standard_normal((3, 3, cin, cout)) * (9 * cin) ** -0.5).astype(
        np.float32)
    wp = (rng.standard_normal((cin, cout)) * cin ** -0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cin).astype(np.float32)
    shift = (rng.standard_normal(cin) * 0.3).astype(np.float32)
    bits = rng.integers(0, 256, (4 * cin, n // 4), dtype=np.uint8)
    return x, w1, wp, scale, shift, bits


def _oihw(w1):
    return torch.from_numpy(np.ascontiguousarray(w1.transpose(3, 2, 0, 1)))


# --- the parity layout, the scale groups, the weights -------------------------------

def test_parity_helpers_match_jax():
    """Planes, interleave, pack and unpack, bit for bit, on floats and on
    the uint8 bits."""
    x = _inputs()[0]
    u8 = np.random.default_rng(1).integers(0, 256, (CIN, N), dtype=np.uint8)
    for a in (x, u8):
        jp = jt.parity_planes(jnp.asarray(a), H, W)
        tp = tr.parity_planes(torch.from_numpy(a), H, W)
        for j, t in zip(jp, tp):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        np.testing.assert_array_equal(
            tr.parity_interleave(tp, H, W).numpy(),
            np.asarray(jt.parity_interleave(jp, H, W)))
        packed = tr.parity_pack(torch.from_numpy(a), H, W)
        np.testing.assert_array_equal(
            packed.numpy(), np.asarray(jt.parity_pack(jnp.asarray(a), H, W)))
        np.testing.assert_array_equal(
            tr.parity_unpack(packed, H, W).numpy(),
            np.asarray(jt.parity_unpack(jnp.asarray(packed.numpy()), H, W)))
        np.testing.assert_array_equal(tr.parity_unpack(packed, H, W).numpy(),
                                      a)
    assert tr.PLANE_TAPS == tuple(tuple(v) for _, v in sorted(
        jt._PLANE_TAPS.items()))


def _outcome(fn):
    try:
        return fn()
    except ValueError:
        return "raises"


# (oh, ow, batch, cin, cout): the WRN-28-10 transitions at batch 128, 256
# and 512, the test shapes, and geometries the picker refuses
TILE_GRID = [(16, 16, 128, 160, 320), (8, 8, 128, 320, 640),
             (16, 16, 256, 160, 320), (8, 8, 512, 320, 640),
             (8, 8, 8, 32, 64), (4, 4, 8, 32, 64), (4, 4, 32, 640, 640),
             (4, 4, 2, 32, 64), (3, 3, 8, 32, 64), (7, 7, 4, 64, 128),
             (28, 28, 8, 64, 128), (2, 2, 16, 1024, 2048), (8, 8, 1, 16, 32)]


@pytest.mark.parametrize("oh,ow,b,cin,cout", TILE_GRID)
def test_transition_tile_matches_jax(oh, ow, b, cin, cout):
    n = b * oh * ow
    assert _outcome(lambda: tr.transition_tile(oh, ow, n, cin, cout)) == \
        _outcome(lambda: jt.transition_tile(oh, ow, n, cin, cout))


def test_weight_packers_match_jax():
    """The forward's per-output-channel int8 weights (the fused half's
    quantizer), the dgrad's per-input-channel ones and the plane-major
    dgrad packing."""
    w1 = _inputs()[1]
    jq, jws = jt._quant_pack_w_fwd(jnp.asarray(w1))
    tq, tws = fb.quantize_pack_weights(_oihw(w1))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tws.numpy(), np.asarray(jws))
    jq, jws = jt._quant_pack_w_dgrad(jnp.asarray(w1))
    tq, tws = tr.quant_pack_w_dgrad(_oihw(w1))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tws.numpy(), np.asarray(jws))
    np.testing.assert_array_equal(
        tr.pack_w_dgrad(_oihw(w1)).numpy(),
        np.asarray(jt.pack_weights_transition_dgrad(jnp.asarray(w1))))
    np.testing.assert_array_equal(
        tr._unpack_w_dgrad(tr.pack_w_dgrad(_oihw(w1))).numpy(),
        _oihw(w1).numpy())


@pytest.mark.parametrize("floor", [fb.FWD_FLOOR, fb.BWD_FLOOR])
@pytest.mark.parametrize("b,h,cin,cout,groups", [
    (8, 16, 32, 64, 4), (32, 8, 640, 640, None)])
def test_shared_quantizer_is_the_joint_parity_quantizer(floor, b, h, cin,
                                                        cout, groups):
    """The fused half's per-group quantizer at ``4 * tile`` input lanes
    gives exactly the reference's joint per-tile quantization over its four
    parity planes (its ``_prologue`` per plane, one absmax over the planes
    of a tile of output lanes): codes and group absmaxes, with both floors.
    ``groups`` None: the picker's own tile (two groups at 640 channels)."""
    n = b * h * h
    x, _, _, scale, shift, bits = _inputs(3, cin, cout, n)
    oh = h // 2
    tile = (b * oh * oh // groups if groups
            else tr.transition_tile(oh, oh, n // 4, cin, cout))
    assert n // 4 // tile >= 2
    thresh = fb.dropout_thresh(RATE)
    planes = jt.parity_planes(jnp.asarray(x, jnp.bfloat16), h, h)

    @jax.jit
    def joint(planes, bits):
        # the reference kernel's lines, jitted as its interpret mode is
        dqs = [jfb._prologue(planes[p], jnp.asarray(scale)[:, None],
                             jnp.asarray(shift)[:, None],
                             bits[p * cin:(p + 1) * cin], thresh,
                             jnp.float32) for p in range(4)]
        amax = jnp.max(jnp.stack([jnp.max(jnp.abs(d)) for d in dqs]))
        inv = 127.0 / jnp.maximum(amax, floor)
        return jnp.concatenate([jnp.clip(jnp.round(d * inv), -127.0,
                                         127.0).astype(jnp.int8)
                                for d in dqs]), amax

    want_q, want_a = [], []
    for t0 in range(0, n // 4, tile):
        q, amax = joint([pl[:, t0:t0 + tile] for pl in planes],
                        jnp.asarray(bits[:, t0:t0 + tile]))
        want_q.append(np.asarray(q))
        want_a.append(float(amax))
    d = fb.prologue_plain(_t(x, torch.bfloat16), _t(scale), _t(shift),
                          tr.parity_unpack(torch.from_numpy(bits), h, h),
                          thresh)
    q, amax = fb.quantize_groups_plain(d, 4 * tile, floor)
    packed = tr.parity_pack(q, h, h)
    for g, (wq, wa) in enumerate(zip(want_q, want_a)):
        got = packed[:, g * tile:(g + 1) * tile].numpy()
        np.testing.assert_array_equal(got, wq)
        assert float(amax[g]) == wa
    if floor == fb.FWD_FLOOR:  # the fused half's forward quantizer
        q2, a2 = fb.fwd_quantize_plain(
            _t(x, torch.bfloat16), _t(scale), _t(shift),
            tr.parity_unpack(torch.from_numpy(bits), h, h), thresh=thresh,
            tile=4 * tile)
        assert torch.equal(q2, q) and torch.equal(a2, amax)


# --- the op ---------------------------------------------------------------------

def _run_jax(x, w1, wp, scale, shift, bits, rate, quant_bwd, cts=None, h=H,
             w=W):
    """(outputs, grads or None) of JAX's op at h x w inputs; grads in JAX's
    layouts."""
    jb = jnp.asarray(bits) if rate > 0 else None

    def f(x_, w_, wp_, s_, t_):
        return jt.transition_half_int8(x_, w_, wp_, s_, t_, jb,
                                       dropout_rate=rate, h=h, w_img=w,
                                       quant_bwd=quant_bwd, interpret=True)

    args = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(w1),
            None if wp is None else jnp.asarray(wp), jnp.asarray(scale),
            jnp.asarray(shift))
    out, vjp = jax.vjp(f, *args)
    if cts is None:
        return out, None
    jcts = (jnp.asarray(cts[0], jnp.bfloat16), jnp.asarray(cts[1]),
            jnp.asarray(cts[2]), jnp.asarray(cts[3], jnp.bfloat16))
    return out, vjp(jcts)


def _run_port(x, w1, wp, scale, shift, bits, rate, quant_bwd, cts=None,
              h=H, w=W):
    """(outputs, grads in JAX's layouts or None) of the port's op at h x w
    inputs."""
    cin, cout = w1.shape[2:]
    xt = _t(x, torch.bfloat16).requires_grad_()
    wt = _oihw(w1).requires_grad_()
    wpt = (None if wp is None else torch.from_numpy(np.ascontiguousarray(
        wp.T)).reshape(cout, cin, 1, 1).requires_grad_())
    st, sh = _t(scale).requires_grad_(), _t(shift).requires_grad_()
    tb = torch.from_numpy(bits) if rate > 0 else None
    out = tr.transition_half_int8(xt, wt, wpt, st, sh, tb, dropout_rate=rate,
                                  h=h, w_img=w, quant_bwd=quant_bwd)
    if cts is None:
        return out, None
    ins = [xt, wt] + ([wpt] if wpt is not None else []) + [st, sh]
    tcts = [_t(cts[0], torch.bfloat16), _t(cts[1]), _t(cts[2]),
            _t(cts[3], torch.bfloat16)]
    g = list(torch.autograd.grad(out, ins, tcts))
    g[1] = g[1].permute(2, 3, 1, 0)
    if wpt is not None:
        g[2] = g[2].reshape(cout, cin).t()
    else:
        g.insert(2, None)
    return out, g


def _ulp_ok(got, want, what):
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= 2 * 2.0 ** (np.floor(np.log2(top))
                                                   - 7), what


def _sum_ok(got, want, tol, what):
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), what


def _check_forward(rate, use_proj, cin=CIN, cout=COUT):
    x, w1, wp, scale, shift, bits = _inputs(cin=cin, cout=cout)
    wp = wp if use_proj else None
    jout, _ = _run_jax(x, w1, wp, scale, shift, bits, rate, True)
    tout, _ = _run_port(x, w1, wp, scale, shift, bits, rate, True)
    z, zsum, zssq, res = (_np(t) for t in tout)
    jz, jsum, jssq, jres = (np.asarray(a, np.float32) for a in jout)
    assert tout[0].dtype == tout[3].dtype == torch.bfloat16
    np.testing.assert_array_equal(z, jz)
    _sum_ok(zsum, jsum, 1e-5, "zsum")
    _sum_ok(zssq, jssq, 1e-5, "zssq")
    if use_proj:
        _ulp_ok(res, jres, "res")
    else:
        np.testing.assert_array_equal(res, jres)


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("use_proj", [True, False])
def test_forward_matches_jax(rate, use_proj):
    """z equal (the same s32 sums dequantized alike), res and the sums of
    z within their tolerances; option A's res equal."""
    _check_forward(rate, use_proj)


def _cotangents(seed=5, cout=COUT, n=N):
    rng = np.random.default_rng(seed)
    return (_bf(rng.standard_normal((cout, n // 4)) * 1e-2),
            (rng.standard_normal(cout) * 1e-3).astype(np.float32),
            (rng.standard_normal(cout) * 1e-4).astype(np.float32),
            _bf(rng.standard_normal((cout, n // 4)) * 1e-2))


def _exact_grads(x, w1, wp, scale, shift, bits, rate, cts, h=H, w=W):
    """The float backward at the same point, in float64: the unquantized
    prologue and conv, the cotangents on all four outputs."""
    f64 = torch.float64
    xt = torch.from_numpy(x).to(f64).requires_grad_()
    wt = _oihw(w1).to(f64).requires_grad_()
    wpt = (None if wp is None else
           torch.from_numpy(wp).to(f64).requires_grad_())
    st = torch.from_numpy(scale).to(f64).requires_grad_()
    sh = torch.from_numpy(shift).to(f64).requires_grad_()
    d = torch.clamp_min(xt * st[:, None] + sh[:, None], 0)
    thresh = fb.dropout_thresh(rate)
    if thresh < 256:
        lb = tr.parity_unpack(torch.from_numpy(bits), h, w).to(torch.int32)
        d = torch.where(lb < thresh, d * (256.0 / thresh), 0 * d)
    z = tr._lanes(torch.nn.functional.conv2d(
        tr._nchw(d, h, w), wt, stride=2, padding=1))
    ee = tr.parity_planes(xt, h, w)[0]
    res = (wpt.t() @ ee if wpt is not None
           else torch.nn.functional.pad(ee, (0, 0, 0, w1.shape[3]
                                             - w1.shape[2])))
    loss = ((z * torch.from_numpy(cts[0]).to(f64)).sum()
            + (z.sum(1) * torch.from_numpy(cts[1]).to(f64)).sum()
            + ((z * z).sum(1) * torch.from_numpy(cts[2]).to(f64)).sum()
            + (res * torch.from_numpy(cts[3]).to(f64)).sum())
    ins = [xt, wt] + ([wpt] if wpt is not None else []) + [st, sh]
    g = list(torch.autograd.grad(loss, ins))
    g[1] = g[1].permute(2, 3, 1, 0)
    if wpt is None:
        g.insert(2, None)
    return [None if v is None else v.numpy() for v in g]


NAMES = ("dx", "dw1", "dwp", "dscale", "dshift")


def _check_backward(rate, use_proj, quant_bwd, cin=CIN, cout=COUT, b=B, h=H,
                    w=W):
    n = b * h * w
    x, w1, wp, scale, shift, bits = _inputs(cin=cin, cout=cout, n=n)
    wp = wp if use_proj else None
    cts = _cotangents(cout=cout, n=n)
    geo = dict(h=h, w=w)
    _, jg = _run_jax(x, w1, wp, scale, shift, bits, rate, quant_bwd, cts,
                     **geo)
    _, tg = _run_port(x, w1, wp, scale, shift, bits, rate, quant_bwd, cts,
                      **geo)
    jg = [None if a is None else np.asarray(a, np.float32) for a in jg]
    tg = [None if t is None else _np(t) for t in tg]
    exact = (_exact_grads(x, w1, wp, scale, shift, bits, rate, cts, **geo)
             if quant_bwd else None)
    for name, got, want, i in zip(NAMES, tg, jg, range(5)):
        if want is None:
            assert got is None, name
            continue
        assert got.shape == want.shape, name
        if quant_bwd:
            noise = np.linalg.norm(want.astype(np.float64) - exact[i])
            d = np.linalg.norm(got.astype(np.float64) - want)
            assert d <= 2 * noise + 1e-3 * np.linalg.norm(exact[i]), name
            if name == "dw1":
                np.testing.assert_array_equal(got, want)
        elif name == "dx":
            _ulp_ok(got, want, name)
        else:
            _sum_ok(got, want, 1e-4, name)


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("use_proj", [True, False])
@pytest.mark.parametrize("quant_bwd", [True, False])
def test_backward_matches_jax(rate, use_proj, quant_bwd):
    """Cotangents on all four outputs. Straight-through: dx within 2 bf16
    ulps, the f32 gradients within 1e-4 of each tensor's largest value.
    FQT: within twice the reference's own distance from the exact float
    backward (plus 1e-3 of its norm), and in fact equal but for dx's
    projection sum."""
    _check_backward(rate, use_proj, quant_bwd)


@pytest.mark.parametrize("b,h,w", [(24, 24, 24), (24, 8, 8)])
@pytest.mark.parametrize("quant_bwd", [True, False])
def test_backward_at_rows_off_8_matches_jax(b, h, w, quant_bwd):
    """Output rows off 8 pixels (12 at 24x24 inputs, 4 at 8x8), which the
    backward's operand passes take since each output lane reads its own
    input pair: the op's backward in both bodies (projection, dropout,
    three scale groups) holds to JAX as at 16x16."""
    cin, cout = CIN, COUT
    assert tr.transition_tile(h // 2, w // 2, b * h * w // 4, cin,
                              cout) * 3 == b * h * w // 4
    _check_backward(RATE, True, quant_bwd, cin, cout, b=b, h=h, w=w)


@pytest.mark.parametrize("cin,cout", [(16, 32), (8, 64)])
@pytest.mark.parametrize("use_proj,quant_bwd", [(True, True), (False, False)])
def test_narrow_input_widths_match_jax(cin, cout, use_proj, quant_bwd):
    """A Cin the gate admits off the kernels' 32-channel chunks (WRN-28-1's
    16 -> 32; Cin % 8) runs zero-padded to 32 at the unpadded Cin's scale
    groups: the forward and the gradients hold to JAX as at Cin = 32."""
    _check_forward(RATE, use_proj, cin, cout)
    _check_backward(RATE, use_proj, quant_bwd, cin, cout)


def test_refuses_what_jax_refuses():
    x, w1, wp, scale, shift, bits = _inputs()
    args = (_t(x, torch.bfloat16), _oihw(w1), None, _t(scale), _t(shift))
    for bad, match in (
            (dict(bits=None, dropout_rate=RATE), "needs a bits"),
            (dict(bits=torch.from_numpy(bits), dropout_rate=1.0),
             "zeroes the activations"),
            (dict(bits=torch.tensor(3, dtype=torch.int32),
                  dropout_rate=RATE), "no in-kernel seed")):
        with pytest.raises(ValueError, match=match):
            tr.transition_half_int8(*args, h=H, w_img=W, **bad)
        with pytest.raises(ValueError, match=match):
            jt.transition_half_int8(
                jnp.asarray(x), jnp.asarray(w1), None, jnp.asarray(scale),
                jnp.asarray(shift),
                None if bad["bits"] is None else jnp.asarray(
                    bad["bits"].numpy()), dropout_rate=bad["dropout_rate"],
                h=H, w_img=W, interpret=True)
    with pytest.raises(ValueError, match="even H, W"):
        tr.transition_half_int8(args[0][:, :B * 7 * W], *args[1:], h=7,
                                w_img=W)
    with pytest.raises(ValueError, match="cannot shrink"):
        tr.transition_half_int8(_t(x, torch.bfloat16),
                                _oihw(w1)[:16].contiguous(), None,
                                _t(scale), _t(shift), h=H, w_img=W)


# --- the block and Sequential -------------------------------------------------------

GATE_BLOCKS = [  # (channels, downsample, use_proj, dropout, flags)
    (32, True, True, 0.3, {}), (32, True, False, 0.0, {}),
    (160, True, True, 0.3, {}), (320, True, True, 0.3, {}),
    (32, False, True, 0.3, {}), (16, True, True, 0.3, {}),
    (8, True, True, 0.0, {}), (20, True, True, 0.0, {}),
    (32, True, True, 1.0, {}), (32, True, True, 0.3, {"preact": False}),
    (32, True, True, 0.3, {"lane_transition": False}),
    (32, True, True, 0.3, {"int8_train": False, "int8_train_bwd": False}),
    (32, True, True, 0.3, {"int8_train_bwd": False}),
    (48, True, True, 0.0, {"out_channels_override": 32,
                           "stride_override": 2}),
    (32, True, True, 0.0, {"stride_override": 1})]
GATE_SHAPES = [(128, 32, 32), (128, 16, 16), (8, 16, 16), (8, 8, 8),
               (2, 8, 8), (4, 7, 7), (4, 6, 6), (16, 4, 4), (1, 16, 16)]


@pytest.mark.parametrize("c,down,proj,rate,flags", GATE_BLOCKS)
def test_lane_through_gate_matches_jax(c, down, proj, rate, flags):
    kw = dict(channels=c, downsample=down, preact=True, use_proj=proj,
              dropout_prob=rate, int8_train=True, int8_train_bwd=True,
              lane_transition=True)
    kw.update(flags)
    jb, tb = JaxBlock(**kw), ResidualBlock(**kw)
    for b, h, w in GATE_SHAPES:
        for cin in {c, c + 8}:
            shape = (b, h, w, cin)
            for train in (True, False):
                assert tb.lane_through_eligible(shape, train) == \
                    jb.lane_through_eligible(shape, train), (shape, train)


def _block_pair(use_proj=True, quant_bwd=True, rate=RATE, seed=0):
    kw = dict(channels=CIN, downsample=True, preact=True, use_proj=use_proj,
              dropout_prob=rate, int8_train=True, int8_train_bwd=quant_bwd,
              lane_transition=True)
    jb = JaxBlock(**kw, compute_dtype=jnp.bfloat16)
    params, state, _ = jb.init(jax.random.key(seed), (H, W, CIN))
    _randomize_bn(params, state, np.random.default_rng(seed + 5))
    tb = ResidualBlock(**kw).train()
    tb.load_state_dict(state_dict_from_jax(params, state))
    return jb, tb, params, state


@pytest.mark.parametrize("use_proj,quant_bwd", [(True, True), (False, True),
                                                (True, False)])
def test_apply_lane_through_matches_jax(use_proj, quant_bwd):
    """One transition block, lane in and lane out, with JAX's draws: y at
    the int8 grain, the BatchNorm buffers (mean, var, count) as JAX's, and
    the weights' gradients by their relative distance."""
    jb, tb, params, state = _block_pair(use_proj, quant_bwd)
    x = _inputs(7)[0]
    shape = (B, H, W, CIN)
    assert tb.lane_through_eligible(shape, True)
    key = jax.random.key(3)
    ct = np.random.default_rng(8).standard_normal(
        (COUT, N // 4)).astype(np.float32)

    def jloss(p):
        y, oshape, st = jb.apply_lane_through(
            p, state, jnp.asarray(x, jnp.bfloat16), shape, train=True,
            rng=key)
        return jnp.sum(y.astype(jnp.float32) * ct), (y, oshape, st)

    (_, (jy, joshape, jst)), jg = jax.value_and_grad(jloss, has_aux=True)(
        params)
    ty, toshape = tb.apply_lane_through(_t(x, torch.bfloat16), shape,
                                        key=JaxKey(key))
    (ty.float() * torch.from_numpy(ct)).sum().backward()
    assert toshape == tuple(joshape) == (B, H // 2, W // 2, COUT)
    jy = np.asarray(jy, np.float32)
    diff = np.abs(_np(ty) - jy)
    assert (diff > 0).mean() <= 2e-2
    assert diff.max() <= 0.05 * np.abs(jy).max()
    new_state = state_dict_from_jax({}, jst)
    buffers = dict(tb.named_buffers())
    assert {k for k in new_state} == set(buffers)
    for name, want in new_state.items():
        if name.endswith("count"):
            assert int(buffers[name]) == int(want) == 1, name
        else:
            np.testing.assert_allclose(buffers[name].numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
    grads = state_dict_from_jax(jg, {})
    glob = np.sqrt(sum(np.square(g.numpy().astype(np.float64)).sum()
                       for g in grads.values()))
    named = dict(tb.named_parameters())
    assert set(named) == set(grads)
    for name, g in grads.items():
        want = g.numpy().astype(np.float64)
        d = np.linalg.norm(named[name].grad.numpy() - want)
        assert d <= max(0.1 * np.linalg.norm(want), 2e-2 * glob), name


def _mini_trunk(jax_side, int8):
    """stem -> identity block -> transition -> identity block, as the
    reference's test_sequential_lane_through_integration builds it."""
    kw = dict(preact=True, use_proj=True, dropout_prob=RATE,
              int8_train=int8, int8_train_bwd=int8)
    if jax_side:
        from pytorch_ddp_resnet_tpu.models.layers import Conv as JaxConv

        cd = dict(compute_dtype=jnp.bfloat16)
        return JaxSequential((
            ("00_conv", JaxConv(3, CIN, 3, 1, 1, use_bias=True,
                                lane_stem=int8, **cd)),
            ("01_stack", JaxSequential((
                ("block0", JaxBlock(CIN, False, **kw, **cd)),))),
            ("02_stack", JaxSequential((
                ("block0", JaxBlock(CIN, True, lane_transition=int8, **kw,
                                    **cd)),
                ("block1", JaxBlock(COUT, False, **kw, **cd)))))))
    return Sequential((
        ("00_conv", tlayers.Conv(3, CIN, 3, 1, 1, use_bias=True,
                                 lane_stem=int8)),
        ("01_stack", Sequential((
            ("block0", ResidualBlock(CIN, False, **kw)),))),
        ("02_stack", Sequential((
            ("block0", ResidualBlock(CIN, True, lane_transition=int8, **kw)),
            ("block1", ResidualBlock(COUT, False, **kw)))))))


def test_sequential_carries_the_run_across_the_transition(monkeypatch):
    """The mini trunk: the lane run opens at the stem and crosses the
    stage boundary (the transition takes the lane-through branch; no block
    converts between NHWC and lanes; the run closes once, at the end), and
    the output matches JAX's same trunk at the int8 grain."""
    jseq = _mini_trunk(True, True)
    params, state, _ = jseq.init(jax.random.key(0), (H, W, 3))
    _randomize_bn(params, state, np.random.default_rng(9))
    tseq = _mini_trunk(False, True).train()
    tseq.load_state_dict(state_dict_from_jax(params, state))
    x = np.random.default_rng(10).standard_normal((B, H, W, 3)).astype(
        np.float32)
    key = jax.random.key(4)
    jy, _ = jseq.apply(params, state, jnp.asarray(x), train=True, rng=key)
    calls = {}

    def count(mod, name):
        orig = getattr(mod, name)

        def spy(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return orig(*a, **k)

        monkeypatch.setattr(mod, name, spy)

    count(tblocks, "to_lane")
    count(tblocks, "from_lane")
    count(tlayers, "_delane")
    count(tr, "transition_half_int8")
    ty = tseq(torch.from_numpy(x), key=JaxKey(key))
    assert calls == {"_delane": 1, "transition_half_int8": 1}
    assert ty.shape == (B, H // 2, W // 2, COUT)
    jy = np.asarray(jy, np.float32)
    diff = np.abs(_np(ty) - jy)
    assert np.isfinite(_np(ty)).all()
    assert (diff > 0).mean() <= 5e-2
    assert diff.max() <= 0.1 * np.abs(jy).max()


# --- the whole step ------------------------------------------------------------

SPEC = "c3,32,3,1,1 r1 r1 n a ap4,1,0 fc64,10"
SGD_ARGS = {"lr": 0.1, "momentum": 0.9, "dampening": 0.0, "nesterov": True,
            "weight_decay": 5e-4}
LR = 0.05
MODES = {"fqt": dict(int8_train=True, int8_train_bwd=True,
                     lane_transition=True),
         "qat": dict(int8_train=True, lane_transition=True)}


def _batch():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 8, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, (1, 8)).astype(np.int32)
    return x, y


def _jax_train_step(**flags):
    """JAX's make_train_step from its init at ``flags``: (ts0, {loss,
    <state_dict name>, momentum/<name>})."""
    x, y = _batch()
    cd = jnp.bfloat16 if flags else jnp.float32
    model = JaxResNet(SPEC, preact=True, use_proj=True, dropout_prob=RATE,
                      compute_dtype=cd, **flags)
    opt = joptim.get_optimizer("SGD", SGD_ARGS)
    ts0 = jsteps.init_train_state(model, opt, jax.random.key(0), (8, 8, 3))
    ts1, metrics = jax.jit(jsteps.make_train_step(model, opt))(
        ts0, jnp.asarray(x), jnp.asarray(y), jnp.float32(LR),
        jax.random.key(2))
    out = {"loss": float(metrics["loss"])}
    for name, t in state_dict_from_jax(ts1["params"],
                                       ts1["model_state"]).items():
        out[name] = t.numpy()
    for name, t in state_dict_from_jax(ts1["opt_state"]["buf"], {}).items():
        out[f"momentum/{name}"] = t.numpy()
    return jax.device_get(ts0), out


@pytest.fixture(scope="module")
def exact_step():
    return _jax_train_step()[1]


@pytest.mark.parametrize("mode", list(MODES))
def test_train_step_matches_jax(mode, exact_step, monkeypatch):
    """One step of the small preact net (its second stage opens with a
    32 -> 64 stride-2 transition) from the JAX init with the JAX draws,
    the transition on the lane-through half: every parameter, momentum
    buffer and BN statistic within twice the JAX step's own distance from
    the exact f32 step (plus 1e-3 of the tensor's norm); the stem bias, whose
    true gradient is 0, at 1e-3 of the largest momentum norm."""
    ts0, want = _jax_train_step(**MODES[mode])
    exact = exact_step
    x, y = _batch()
    model = ResNet(SPEC, True, True, RATE, device="cpu", **MODES[mode])
    opt = toptim.get_optimizer("SGD", SGD_ARGS)
    ts = init_train_state(model, opt)
    load_jax_train_state(ts, ts0)
    calls = {}
    for name in ("fwd_conv_plain", "dgrad_plain", "wgrad_plain",
                 "wgrad_bf16_plain", "wgrad_proj_plain"):
        orig = getattr(tr, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a, **k)

        monkeypatch.setattr(tr, name, spy)
    ts, metrics = make_train_step(model, opt)(
        ts, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)), LR,
        JaxKey(jax.random.key(2)))
    wg = "wgrad_plain" if mode == "fqt" else "wgrad_bf16_plain"
    assert calls == {"fwd_conv_plain": 1, "dgrad_plain": 1, wg: 1,
                     "wgrad_proj_plain": 1}
    got = {"loss": float(metrics["loss"])}
    for name, t in model.state_dict().items():
        got[name] = t.numpy()
    for name, p in ts["params"].items():
        got[f"momentum/{name}"] = (
            ts["opt_state"].state[p]["momentum_buffer"].numpy())
    assert set(got) == set(want)
    assert abs(got["loss"] - want["loss"]) <= max(
        abs(want["loss"] - exact["loss"]), 1e-3)
    mnorm = max(np.linalg.norm(v) for k, v in want.items()
                if k.startswith("momentum/"))
    for name, ref in want.items():
        if name == "loss":
            continue
        if name.endswith("count"):
            assert int(got[name]) == int(ref) == 1, name
            continue
        d = np.linalg.norm(got[name].astype(np.float64) - ref)
        if name.endswith("00_conv.bias"):
            assert d <= 1e-3 * mnorm, name
            continue
        noise = np.linalg.norm(ref.astype(np.float64) - exact[name])
        assert d <= 2 * noise + 1e-3 * np.linalg.norm(exact[name]), name


def test_full_width_transitions():
    """WRN-28-10 at batch 128 under the -hard-int8 recipe's flags: both
    stage transitions take the lane-through path (and the JAX gate agrees
    block for block); the other 10 blocks stay on the lane halves."""
    spec = "c3,160,3,1,1 r4 r4 r4 n a ap8,1,0 fc640,10"
    flags = dict(int8_train=True, int8_train_bwd=True, lane_transition=True)
    model = ResNet(spec, True, True, RATE, device="cpu", **flags)
    jmodel = JaxResNet(spec, preact=True, use_proj=True, dropout_prob=RATE,
                       **flags)
    through = []
    for i, (stage, hw, c) in enumerate((("01_stack", 32, 160),
                                        ("02_stack", 16, 320),
                                        ("03_stack", 8, 640))):
        for k in range(4):
            block = model.get_submodule(f"{stage}.block{k}")
            jblock = jmodel.spine.layers[i + 1][1].layers[k][1]
            cin = c // 2 if block.transforms_shortcut else c
            size = hw * 2 if block.transforms_shortcut else hw
            shape = (128, size, size, cin)
            got = block.lane_through_eligible(shape, True)
            assert got == jblock.lane_through_eligible(shape, True)
            assert block.lane_eligible(shape, True) == (not got and i + k > 0
                                                        or (i, k) == (0, 0))
            through.append(got)
            if got:
                tile = tr.transition_tile(hw, hw, 128 * hw * hw, cin, c)
                assert tile == {16: 1024, 8: 512}[hw]
                tr.transition_dgrad_layout(128 * size * size, size, size,
                                           cin, c, tile, True)
                tr.check_operand_geometry("gate", size, size,
                                          128 * size * size, tile)
    assert sum(through) == 2
