"""The lane transition's straight-through weight gradient and dWp on the
TMA + wgmma mainloop (ops/cuda/transition.py ``bwd_fold``, ``wgrad_bf16``,
``wgrad_proj``, ``TAP_TABLE``, ``check_wgrad_geometry``,
``wgrad_tma_plan``; kernels in csrc/transition.cu ``bwd_fold_kernel``,
``bwd_quant_kernel`` and csrc/transition_wgrad.cu on
csrc/wgrad_wgmma_bf16.cuh), on the CPU:

- the tap table, each tap's (plane, row shift, column shift), equals
  JAX's ``_tap_info``;
- the fold's parity planes of the prologue and both operand passes'
  even-even plane of x round-trip to the lane tensors through
  ``parity_planes`` (the port's and JAX's);
- the plain versions on planes equal the lane-order contractions they
  replace (the stride-2 ``conv2d_weight`` of the lane prologue, and
  ``dres @ x[::2, ::2]^T``) to f32 rounding;
- the plan and the geometry check are pure functions: tiles covering dW,
  the splits partitioning the K steps; the wgrad takes shapes the old
  row-tile dgrad refused (Cout = 40, output rows of 192 pixels), as the
  rebuilt dgrad now does, and refuses, naming them, shapes off its rule;
- tests/_wgrad_tma_model.py's numpy model of the kernel's reads, run with
  this table on the fold's planes, matches the plain versions within
  1e-4 of dW's largest value (narrow and wide rows, tiles straddling
  taps, splits of several steps; dWp as one unshifted tap), and a wrong
  column shift or plane leaves that bound;
- the whole op against JAX (``interpret=True``) at widths the other test
  file does not run, as ``test_backward_matches_jax`` holds it.

Inputs are made with numpy from a seed. Tolerances: the plain versions sum
in float64 and round once to f32; the model rounds each split's tile to
f32 and adds the splits in f32, as the card does.
"""

import functools

import numpy as np
import pytest
import torch
from torch.nn.grad import conv2d_weight

from pytorch_ddp_resnet_tpu.ops.pallas import transition as jt
from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
from pytorch_ddp_resnet_tpu_torch.ops.cuda import transition as tr
from _wgrad_tma_model import BK, BM, model, shift8

from test_torch_transition import _check_backward


def _bf16(rng, *shape, s=1.0):
    """bf16-representable normals, as a bf16 tensor."""
    return torch.from_numpy((rng.standard_normal(shape) * s).astype(
        np.float32)).to(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _operands(cin, cout, h, w, b, rate=0.3, seed=3):
    """(fold inputs, thresh): the cotangents dz, z, dzsum, dzssq and the
    prologue's x, scale, shift and lane-order bits at input geometry h x w,
    batch b."""
    rng = np.random.default_rng(seed)
    n, n_out = b * h * w, b * h * w // 4
    x = _bf16(rng, cin, n)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cin).astype(np.float32))
    shift = torch.from_numpy((rng.standard_normal(cin) * 0.3).astype(
        np.float32))
    thresh = fb.dropout_thresh(rate) if rate > 0 else None
    bits = (torch.from_numpy(rng.integers(0, 256, (cin, n), dtype=np.uint8))
            if rate > 0 else None)
    dz, z = _bf16(rng, cout, n_out, s=1e-2), _bf16(rng, cout, n_out)
    dzsum = torch.from_numpy((rng.standard_normal(cout) * 1e-3).astype(
        np.float32))
    dzssq = torch.from_numpy((rng.standard_normal(cout) * 1e-4).astype(
        np.float32))
    return (dz, z, dzsum, dzssq, x, scale, shift, bits), thresh


def _fold(cin, cout, h, w, b, rate=0.3):
    args, thresh = _operands(cin, cout, h, w, b, rate)
    return tr.bwd_fold_plain(*args, thresh=thresh, h=h, w_img=w)


def _lane_wgrad_f64(g, d, h, w_img):
    """sum over positions of g [Cout, N'] x the stride-2 patches of the
    lane-order d [Cin, N], float64, as [Cout, 9*Cin] in (dh, dw, ci)
    order."""
    cout, cin = g.shape[0], d.shape[0]
    dw = conv2d_weight(tr._nchw(d, h, w_img), (cout, cin, 3, 3),
                       tr._nchw(g, h // 2, w_img // 2), stride=2, padding=1)
    return dw.permute(0, 2, 3, 1).reshape(cout, 9 * cin)


def _max_err(got, want):
    return (torch.as_tensor(got).double()
            - torch.as_tensor(want).double()).abs().max().item()


# --- the table and the operand layouts ---------------------------------------

def test_tap_table_matches_jax():
    assert len(tr.TAP_TABLE) == 9
    for dh in range(3):
        for dw in range(3):
            assert tr.TAP_TABLE[3 * dh + dw] == jt._tap_info(dh, dw), (dh, dw)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_fold_writes_the_parity_planes(rate):
    """bwd_fold_plain: g the rounded fold; d the lane prologue's four
    parity planes, plane-major, which interleave back to it; x_ee x's
    even-even plane. bwd_quantize_plain's x_ee is the same plane, its g_q
    and absmaxes are the FQT quantizer's, and its d_q is the quantizer's
    codes of the lane prologue as their four parity planes, the layout of
    the fold's d."""
    h, w, b = 16, 16, 2
    args, thresh = _operands(32, 64, h, w, b, rate)
    g, d, x_ee = tr.bwd_fold_plain(*args, thresh=thresh, h=h, w_img=w)
    x = args[4]
    lane_d = fb.prologue_bf16_plain(x, *args[5:], thresh)
    assert d.shape == (4, 32, b * h * w // 4) and d.is_contiguous()
    assert d.dtype == x.dtype == x_ee.dtype
    assert torch.equal(g, fb.fold_cotangent_plain(*args[:4]).to(g.dtype))
    assert torch.equal(tr.parity_interleave(tuple(d), h, w), lane_d)
    assert torch.equal(d, torch.stack(tr.parity_planes(lane_d, h, w)))
    jplanes = jt.parity_planes(lane_d.float().numpy(), h, w)
    for p in range(4):
        np.testing.assert_array_equal(d[p].float().numpy(),
                                      np.asarray(jplanes[p]))
    assert torch.equal(x_ee, tr.parity_planes(x, h, w)[0])
    np.testing.assert_array_equal(
        x_ee.float().numpy(), np.asarray(jt.parity_planes(
            x.float().numpy(), h, w)[0]))
    tile = tr.transition_tile(h // 2, w // 2, b * h * w // 4, 32, 64)
    q = tr.bwd_quantize_plain(*args, thresh=thresh, tile=tile, h=h, w_img=w)
    assert torch.equal(q[4], x_ee) and q[4].is_contiguous()
    g_q, g_amax = fb.quantize_groups_plain(
        fb.fold_cotangent_plain(*args[:4]), tile, fb.BWD_FLOOR)
    d_q, d_amax = fb.quantize_groups_plain(
        fb.prologue_plain(x, *args[5:], thresh), 4 * tile, fb.BWD_FLOOR)
    planes = torch.stack(tr.parity_planes(d_q, h, w))
    for a, b_ in zip(q[:4], (g_q, g_amax, planes, d_amax)):
        assert torch.equal(a, b_)
    assert q[2].shape == d.shape and q[2].is_contiguous()
    assert torch.equal(tr.parity_interleave(tuple(q[2]), h, w), d_q)


@pytest.mark.parametrize("cin,cout,h,w,b", [(32, 64, 16, 16, 2),
                                            (64, 40, 8, 8, 4),
                                            (32, 48, 4, 12, 2)])
def test_plain_on_planes_equals_lane_order(cin, cout, h, w, b):
    """The plain versions on the planes (HWIO dW; dWp^T [Cin, Cout])
    against the lane-order contractions they replace: the stride-2
    ``conv2d_weight`` of the lane prologue, and dres @ x[::2, ::2]^T; both
    float64, rounded once to f32."""
    args, thresh = _operands(cin, cout, h, w, b)
    g, d, x_ee = tr.bwd_fold_plain(*args, thresh=thresh, h=h, w_img=w)
    lane_d = tr.parity_interleave(tuple(d), h, w)
    got = tr.wgrad_bf16_plain(g, d, h=h, w_img=w)
    want = _lane_wgrad_f64(g, lane_d, h, w).to(torch.float32).reshape(
        cout, 3, 3, cin).permute(1, 2, 3, 0)
    assert got.shape == (3, 3, cin, cout) and got.dtype == torch.float32
    assert _max_err(got, want) <= 1e-6 * want.abs().max().item()
    dres = args[0]
    got = tr.wgrad_proj_plain(dres, x_ee, h=h, w_img=w)
    want = (dres.double() @ tr._even(args[4], h, w).double().t()).float().t()
    assert got.shape == (cin, cout)
    assert _max_err(got, want) <= 1e-6 * want.abs().max().item()


# --- the plan and the geometry -----------------------------------------------

# (taps, Cin, Cout, H, W, B): WRN-28-10's transitions at batch 128 (dW and
# dWp), then the card tests' and the model's shapes
PLAN_SHAPES = [(9, 160, 320, 32, 32, 128), (1, 160, 320, 32, 32, 128),
               (9, 320, 640, 16, 16, 128), (1, 320, 640, 16, 16, 128),
               (9, 32, 64, 32, 32, 128), (9, 64, 40, 16, 16, 4),
               (9, 160, 160, 16, 16, 2), (9, 32, 32, 2, 128, 1),
               (1, 32, 48, 16, 16, 2), (9, 32, 48, 4, 384, 1)]


@pytest.mark.parametrize("taps,cin,cout,h,w,b", PLAN_SHAPES)
def test_plan(taps, cin, cout, h, w, b):
    n_out = b * h * w // 4
    p = tr.wgrad_tma_plan(taps, cin, cout, n_out, h, w)
    assert p.bn == (160 if cout % 160 == 0 else 128 if cout > 64 else 64)
    assert (p.m_tiles - 1) * BM < taps * cin <= p.m_tiles * BM
    assert (p.n_tiles - 1) * p.bn < cout <= p.n_tiles * p.bn
    assert p.steps * BK == n_out
    assert (p.splits - 1) * p.per < p.steps <= p.splits * p.per
    assert p.splits <= 65535 and p.m_tiles <= 65535
    assert p.splits * taps * cin * cout * 4 < 2 ** 31
    assert p == tr.wgrad_tma_plan(taps, cin, cout, n_out, h, w)


def test_plan_at_the_wrn_transitions():
    """dW at stage 2 is 1440 x 320 over 512 K steps; at stage 3 2880 x
    640 over 128; one block an SM of 132."""
    s2 = tr.wgrad_tma_plan(9, 160, 320, 128 * 16 * 16, 32, 32)
    assert (s2.m_tiles, s2.n_tiles, s2.steps) == (12, 2, 512)
    s3 = tr.wgrad_tma_plan(9, 320, 640, 128 * 8 * 8, 16, 16)
    assert (s3.m_tiles, s3.n_tiles, s3.steps) == (23, 4, 128)
    for p in (s2, s3):
        assert p.m_tiles * p.n_tiles * p.splits >= 92


@pytest.mark.parametrize("cin,cout,h,w", [(32, 40, 16, 16),
                                          (32, 64, 2, 384),
                                          (32, 40, 24, 24)])
def test_wgrad_takes_what_the_dgrad_refuses(cin, cout, h, w):
    """Cout = 40 (the old row-tile dgrad contracted Cout in 32-channel
    chunks) and output rows of 192 pixels (no 64- or 128-position row
    tile of whole rows): the old dgrad refused them; since its wgmma
    rebuild the dgrad takes them (the forward's geometry), as the wgrads
    do. Output rows off 8 pixels (12 at 24x24), which the backward's
    operand passes refused while a thread wrote 8 output lanes of one row,
    they take since each lane reads its own input pair, as the FQT wgrad's
    rule does; the TMA wgrad (straight-through) refuses them."""
    n = 8 * h * w
    tr.transition_dgrad_layout(n, h, w, cin, cout, n // 4, True)
    tr.check_operand_geometry("transition_bwd", h, w, n, n // 4)
    if (w // 2) % 8:
        tr.check_wgrad_s8_geometry("transition_wgrad_s8", cin, cout, h, w,
                                   n // 4, n // 4)
        with pytest.raises(ValueError, match="off the TMA"):
            tr.check_wgrad_geometry("transition_wgrad_tma", cin, cout, h, w,
                                    n // 4)
        return
    tr.check_wgrad_geometry("transition_wgrad_tma", cin, cout, h, w, n // 4)
    tr.wgrad_tma_plan(9, cin, cout, n // 4, h, w)


@pytest.mark.parametrize("cin,cout,h,w,match", [
    (32, 64, 24, 24, "image 12x12 is off the TMA"),
    (32, 64, 12, 12, "image 6x6 is off the TMA"),
    (32, 64, 16, 96, "image 8x48 is off the TMA"),
    (32, 64, 4, 32, "image 2x16 is off the TMA"),
    (48, 64, 16, 16, "Cin=48 is not a multiple of 32"),
    (32, 44, 16, 16, "Cout=44 is not a multiple of 8"),
    (32, 64, 15, 16, "geometry H=15 W=16")])
def test_wgrad_geometry_refusals_name_the_shape(cin, cout, h, w, match):
    n_out = 2 * (h // 2) * (w // 2)
    with pytest.raises(ValueError, match=match):
        tr.check_wgrad_geometry("transition_wgrad_tma", cin, cout, h, w,
                                n_out)


def test_fold_geometry_refusal_names_the_shape():
    """The operand passes take whole images of even H and W, each output
    lane reading its own input pair: rows of 6 output pixels (12x12
    inputs) pass the rule as rows of 8 do; an odd width, a partial image
    and units off 8 output lanes raise, naming the shape; the plain
    version (CPU) takes rows of 6."""
    tr.check_operand_geometry("transition_bwd.fold", 12, 12, 2 * 144, 8)
    tr.check_operand_geometry("transition_bwd.fold", 16, 16, 2 * 256, 8)
    with pytest.raises(ValueError, match="geometry H=12 W=13"):
        tr.check_operand_geometry("transition_bwd.fold", 12, 13, 2 * 156, 8)
    with pytest.raises(ValueError, match="geometry H=12 W=12 N=300"):
        tr.check_operand_geometry("transition_bwd.fold", 12, 12, 300, 8)
    with pytest.raises(ValueError, match="scale group of 12 output lanes"):
        tr.check_operand_geometry("transition_bwd", 12, 12, 2 * 144, 12)
    args, thresh = _operands(32, 32, 12, 12, 2)
    g, d, x_ee = tr.bwd_fold_plain(*args, thresh=thresh, h=12, w_img=12)
    assert d.shape == (4, 32, 72) and x_ee.shape == (32, 72)


def test_cpu_path_is_the_plain_version():
    """On the CPU the wrappers run the plain versions and launch
    nothing."""
    args, thresh = _operands(32, 48, 16, 16, 2)
    tr.reset_launches()
    g, d, x_ee = tr.bwd_fold(*args, thresh=thresh, h=16, w_img=16)
    dw = tr.wgrad_bf16(g, d, h=16, w_img=16)
    dwp = tr.wgrad_proj(args[0], x_ee, h=16, w_img=16)
    assert not tr.launches
    assert torch.equal(dw, tr.wgrad_bf16_plain(g, d, h=16, w_img=16))
    assert torch.equal(dwp, tr.wgrad_proj_plain(args[0], x_ee, h=16,
                                                w_img=16))


# --- the numpy model of the kernel's reads, on the transition's table --------

# (Cin, Cout, H, W, B) at the input geometry: output rows of 8 (ragged Cout,
# BN = 64), 16, 64 (wide: 80-position boxes), tiles straddling taps (Cin =
# 160, BN = 160), two images a step
MODEL_SHAPES = [(32, 48, 16, 16, 2), (32, 32, 8, 32, 2),
                (32, 32, 2, 128, 2), (160, 160, 16, 16, 2),
                (64, 64, 16, 16, 1)]


@pytest.mark.parametrize("cin,cout,h,w,b", MODEL_SHAPES)
def test_model_of_the_reads_matches_plain(cin, cout, h, w, b):
    g, d, x_ee = _fold(cin, cout, h, w, b)
    oh, ow, n_out = h // 2, w // 2, b * h * w // 4
    plan = tr.wgrad_tma_plan(9, cin, cout, n_out, h, w)
    got = model(d.float().numpy(), g.float().numpy(), oh, ow, plan,
                tr.TAP_TABLE).reshape(3, 3, cin, cout)
    want = tr.wgrad_bf16_plain(g, d, h=h, w_img=w)
    assert _max_err(got, want) <= 1e-4 * want.abs().max().item()
    dres = _operands(cin, cout, h, w, b)[0][0]
    plan = tr.wgrad_tma_plan(1, cin, cout, n_out, h, w)
    got = model(x_ee.float().numpy(), dres.float().numpy(), oh, ow, plan,
                ((0, 0, 0),))
    want = tr.wgrad_proj_plain(dres, x_ee, h=h, w_img=w)
    assert _max_err(got, want) <= 1e-4 * want.abs().max().item()


def test_model_with_splits_of_several_steps():
    """Splits of three K steps (the last shorter), which the small shapes'
    own plans do not reach: the ring's steps accumulate and the ragged last
    split adds in order."""
    cin, cout, h, w, b = 32, 48, 16, 16, 8
    g, d, _ = _fold(cin, cout, h, w, b)
    plan = tr.wgrad_tma_plan(9, cin, cout, b * h * w // 4, h, w)
    plan = plan._replace(per=3, splits=-(-plan.steps // 3))
    assert plan.steps % 3 and plan.splits > 1
    got = model(d.float().numpy(), g.float().numpy(), h // 2, w // 2, plan,
                tr.TAP_TABLE).reshape(3, 3, cin, cout)
    want = tr.wgrad_bf16_plain(g, d, h=h, w_img=w)
    assert _max_err(got, want) <= 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("wrong", ["shift", "plane"])
def test_model_sees_a_wrong_table(wrong):
    """The model is sharp: the shifters moving the dw = 0 taps the wrong way
    (as a mutation of shift8's sign would), or the dh = 0 taps reading the
    even rows' planes, leave the 1e-4 bound."""
    cin, cout, h, w, b = 32, 48, 16, 16, 2
    g, d, _ = _fold(cin, cout, h, w, b)
    plan = tr.wgrad_tma_plan(9, cin, cout, b * h * w // 4, h, w)
    table, shift = tr.TAP_TABLE, None
    if wrong == "shift":
        def shift(v, s, side):
            return shift8(v, -s, side)
    else:
        table = tuple((p % 2 if rs else p, rs, cs) for p, rs, cs in table)
    got = model(d.float().numpy(), g.float().numpy(), h // 2, w // 2, plan,
                table, shift=shift).reshape(3, 3, cin, cout)
    want = tr.wgrad_bf16_plain(g, d, h=h, w_img=w)
    assert _max_err(got, want) > 1e-2 * want.abs().max().item()


# --- the whole op against JAX ------------------------------------------------

@pytest.mark.parametrize("cin,cout,use_proj", [(64, 96, True),
                                               (32, 32, False)])
def test_backward_matches_jax_at_other_widths(cin, cout, use_proj):
    """The straight-through backward (dW from the planes, HWIO -> OIHW;
    dWp from the even-even plane, transposed) against JAX's VJP with
    ``interpret=True``: dx within 2 bf16 ulps, the f32 gradients within
    1e-4 of each tensor's largest value."""
    _check_backward(0.3, use_proj, False, cin, cout)
