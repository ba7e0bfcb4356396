"""Card-only tests of the port's CUDA kernels (ops/cuda/conv3x3.py,
ops/cuda/conv1x1.py, ops/cuda/augment.py, ops/cuda/fused_block.py,
ops/cuda/stem.py, ops/cuda/bneck_nv.py, ops/cuda/bneck_nv_train.py and
ops/cuda/transition.py): each kernel against its plain PyTorch version on
the same CUDA tensors.

Marked ``cuda``; without a card every test skips (decided in the fixture,
never at import). Run them on the machine with the card (no JAX there, so
without the repo's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: the s32 accumulator is exact in both versions, and the
epilogues use the same f32 operations in the same order, so int8 outputs
agree exactly except where a value lands on a rounding tie after a
different float contraction (allowed: 1 level on <= 0.1% of elements);
the bf16 conv sums in f32 in another order than the float64 plain
version, so outputs may differ by 1 bf16 ulp (2^-8 relative) on a small
share of elements. The augment kernel rounds exactly where its plain
version does (one FMA, one multiply, one bf16 rounding): bit-equal. The
fused int8 half and the stem: int8 codes, group absmaxes, bf16 outputs,
the weight gradient (exact s32 per group, group sums in the same order)
and the stem forward are equal; sums over positions (BatchNorm sums,
d(scale), d(shift), the stem's weight and bias gradients) are f32 sums in
another order: 1e-5 of the largest value. The NV bottleneck kernels: exact
s32 sums and the reference's rounding points in both versions, so int8
and bf16 outputs are equal. The NV training halves: row absmaxes, bf16
outputs and the weight gradient (exact s32 per chunk, chunks added in
order) are equal; the BatchNorm sums, d(s) and d(t) are f32 sums in
another order: 1e-5 of the largest value. Their bf16 bodies: y, dx and
dres (bf16(du), du carrying the product) within 2 bf16 ulps of the
tensor's largest value, x_res equal, the sums and dW (over the tensor
cores' accumulators) within 1e-4; the staged bf16 wgrad's dW (its splits
and chunks added in a fixed order) bit-equal from call to call. The staged
int8 wgrad: its prepass's slabs equal to the plain version's byte for byte,
dW (exact s32 per chunk) equal to ``wgrad_plain`` and bit-equal from call
to call. The int8 dgrad likewise: its prepass's slab byte for byte, dx
and dres equal to ``dgrad_conv_plain``'s and bit-equal from call to call,
d(s) and d(t) within 1e-5. The fused
bf16 half: bf16
outputs (y, dx) within 2 bf16 ulps of the tensor's largest value (f32
against float64 accumulation), dres equal, the BatchNorm sums within 1e-5
of the sums of the kernel's own y, and the sums over the tensor cores'
accumulators (BatchNorm sums, d(scale), d(shift), dW) within 1e-4 of the
plain version's largest value (``_mma_sums`` says why); the seed expansion
and the int8 kernels in seed mode are bit-equal. The transition half: int8
codes, group absmaxes, the forward's slabs (byte for byte), z, the
cotangent fold (g, the prologue's parity planes, x's even-even plane) and
the FQT weight gradient are equal; res and dx (bf16 products summed in f32
on the card) within 2 bf16 ulps; the sums as the fused half's; the
straight-through dW and dWp (the TMA wgrad) within 1e-4 and bit-equal from
call to call. The 3x3 weight gradient: f32 sums over the tensor cores'
accumulators, 1e-4; ``conv3x3_same``'s y, dx and bf16 dW within 2 bf16 ulps
of the CPU op's. The int8 1x1 conv: equal.
"""

import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu_torch.ops.cuda import augment as aug
from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv as nv
from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv_train as nvt
from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3 as k
from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
from pytorch_ddp_resnet_tpu_torch.ops.cuda import stem as st
from pytorch_ddp_resnet_tpu_torch.ops.cuda import transition as tr
from pytorch_ddp_resnet_tpu_torch.utils.rng import Key
from _tma_layout import tma_box_probe_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


SHAPES = [(32, 32, 8, 8, 2), (64, 96, 8, 8, 4), (32, 64, 6, 6, 3),
          (160, 160, 32, 32, 2),
          (320, 320, 16, 16, 4), (640, 640, 8, 8, 8)]


def _inputs(cin, cout, h, w, b, seed=0):
    rng = np.random.default_rng(seed)
    n = b * h * w
    xq = torch.from_numpy(rng.integers(-127, 128, (cin, n), dtype=np.int8))
    wq = torch.from_numpy(
        rng.integers(-127, 128, (cout, 9 * cin), dtype=np.int8))
    xf = torch.from_numpy(rng.standard_normal((cin, n), dtype=np.float32))
    wf = torch.from_numpy(
        rng.standard_normal((cout, 9 * cin), dtype=np.float32) * 0.05)
    vec = lambda s: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(cout) * s).astype(np.float32))
    res = torch.from_numpy(rng.standard_normal((cout, n), dtype=np.float32))
    return xq, wq, xf, wf, vec, res


@pytest.mark.parametrize("cin,cout,h,w,b", SHAPES)
def test_bf16_kernel_matches_plain(dev, cin, cout, h, w, b):
    _, _, xf, wf, _, _ = _inputs(cin, cout, h, w, b)
    x = xf.to(dev, torch.bfloat16)
    wp = wf.to(dev, torch.bfloat16)
    got = k.conv3x3_bf16(x, wp, h=h, w_img=w).float()
    ref = k.conv3x3_bf16_plain(x, wp, h=h, w_img=w).float()
    torch.cuda.synchronize()
    ulp = ref.abs().clamp_min(1e-30) * 2.0 ** -7
    bad = (got - ref).abs() > ulp
    assert bad.float().mean().item() < 1e-3


@pytest.mark.parametrize("cin,cout,h,w,b", SHAPES)
@pytest.mark.parametrize("mode", ["int8", "bf16", "bf16+res", "dual"])
def test_requant_kernel_matches_plain(dev, cin, cout, h, w, b, mode):
    xq, wq, _, _, vec, res = _inputs(cin, cout, h, w, b, seed=1)
    xq, wq = xq.to(dev), wq.to(dev)
    scale = (vec(1.0).abs() * 1e-5).to(dev)
    shift = vec(0.5).to(dev)
    kw = dict(h=h, w_img=w, relu=mode != "bf16")
    args = [xq, wq, scale, shift]
    if mode in ("bf16+res", "dual"):
        args.append(res.to(dev, torch.bfloat16))
    if mode == "dual":
        args.append((vec(30.0).to(dev), vec(3.0).to(dev)))
    if mode == "int8":
        kw["inv_out_scale"] = 1.0 / 0.05
    names = ("conv3x3_int8_requant.pre", "conv3x3_int8_requant")
    before = [k.launches[name] for name in names]
    got = k.conv3x3_int8_requant(*args, **kw)
    ref = k.conv3x3_int8_requant_plain(*args, **kw)
    torch.cuda.synchronize()
    assert [k.launches[name] for name in names] == [v + 1 for v in before]
    _requant_outputs_agree(got, ref)


def _requant_outputs_agree(got, ref):
    """int8 outputs within one level on at most 1e-3 of elements (the
    plain version's float64 double roundings), bf16 outputs equal."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        d = (g.float() - r.float()).abs()
        if g.dtype == torch.int8:
            assert d.max().item() <= 1
            assert (d > 0).float().mean().item() <= 1e-3
        else:
            assert torch.equal(g, r), d.max().item()


# (Cin, Cout, H, W, batch): the WRN-28-10 stages at small batches, and
# widths whose channel rows start off 16 bytes (N = 108, 105) with a Cout
# that is not a multiple of 8 or of the N tile
PARTS_SHAPES = [(160, 160, 32, 32, 2), (320, 320, 16, 16, 4),
                (640, 640, 8, 8, 8), (32, 64, 6, 6, 3), (64, 36, 5, 7, 3)]


@pytest.mark.parametrize("cin,cout,h,w,b", PARTS_SHAPES)
@pytest.mark.parametrize("mode", ["int8", "bf16", "bf16+res", "dual"])
def test_conv3x3_int8_wgmma_parts_match_plain(dev, cin, cout, h, w, b, mode):
    """The prepass's slab equals its plain version byte for byte; the
    GEMM's outputs equal ``conv3x3_int8_requant_gemm_plain``'s on that slab
    (int8 within one level on <= 1e-3 of elements, bf16 equal); two calls
    of the op are bit-equal."""
    xq, wq, _, _, vec, res = _inputs(cin, cout, h, w, b, seed=2)
    xq, wq = xq.to(dev), wq.to(dev)
    n = b * h * w
    plan = k.requant_plan(n, h, w, cin, cout)
    args = [wq, (vec(1.0).abs() * 1e-5).to(dev), vec(0.5).to(dev)]
    kw = dict(relu=mode != "bf16")
    if mode in ("bf16+res", "dual"):
        args.append(res.to(dev, torch.bfloat16))
    if mode == "dual":
        args.append((vec(30.0).to(dev), vec(3.0).to(dev)))
    if mode == "int8":
        kw["inv_out_scale"] = 1.0 / 0.05
    slab = k.conv3x3_int8_requant_pre(xq, plan=plan)
    assert torch.equal(slab, k.conv3x3_int8_requant_pre_plain(xq,
                                                              plan=plan))
    got = k.conv3x3_int8_requant_gemm(slab, *args, plan=plan, **kw)
    _requant_outputs_agree(got, k.conv3x3_int8_requant_gemm_plain(
        slab, *args, plan=plan, **kw))
    first = k.conv3x3_int8_requant(xq, *args, h=h, w_img=w, **kw)
    second = k.conv3x3_int8_requant(xq, *args, h=h, w_img=w, **kw)
    torch.cuda.synchronize()
    first = first if isinstance(first, tuple) else (first,)
    second = second if isinstance(second, tuple) else (second,)
    for a, c in zip(first, second):
        assert torch.equal(a, c)
    got = got if isinstance(got, tuple) else (got,)
    for a, c in zip(first, got):
        assert torch.equal(a, c)


def test_cuda_tensor_never_falls_back(dev):
    x = torch.zeros((16, 128), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((16, 9 * 16), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiple of 32"):
        k.conv3x3_bf16(x, w, h=8, w_img=8)


# (Cin, Cout, H, W, batch): the WRN-28-10 stages, and the widths only the
# WMMA gather kernel took before the slab route (6x6, 5x7, 12x12), whose
# channel rows start off 16 bytes (N = 108, 105), with a Cout that is not
# a multiple of 8 or of the N tile
BF16_PARTS_SHAPES = [(160, 160, 32, 32, 2), (320, 320, 16, 16, 4),
                     (640, 640, 8, 8, 8), (32, 48, 6, 6, 3),
                     (64, 36, 5, 7, 3), (32, 10, 12, 12, 4)]


@pytest.mark.parametrize("cin,cout,h,w,b", BF16_PARTS_SHAPES)
@pytest.mark.parametrize("packing", ["fwd", "dgrad"])
def test_conv3x3_bf16_wgmma_parts_match_plain(dev, cin, cout, h, w, b,
                                              packing):
    """The prepass's slab equals its plain version byte for byte; the
    GEMM's output is within 2 bf16 ulps of ``conv3x3_bf16_gemm_plain``'s
    on that slab and of the plain op's; the op is one launch of each part
    and two calls are bit-equal. ``dgrad``: the weights packed for the
    input gradient (``pack_weights_dgrad``), as conv3x3_same's backward
    runs them."""
    rng = np.random.default_rng(3)
    n = b * h * w
    x = torch.from_numpy(rng.standard_normal((cin, n), dtype=np.float32))
    wt = torch.from_numpy(rng.standard_normal((cout, cin, 3, 3),
                                              dtype=np.float32) * 0.05)
    if packing == "dgrad":   # w' [cin', 9 * cout'] for dy [cout', N]
        wt = wt.transpose(0, 1).contiguous()
        wp = k.pack_weights_dgrad(wt)
    else:
        wp = k.pack_weights(wt)
    x, wp = x.to(dev, torch.bfloat16), wp.to(dev, torch.bfloat16)
    lay = k.conv3x3_bf16_plan(n, h, w, cin, wp.shape[0])
    slab = k.conv3x3_bf16_pre(x, lay=lay)
    assert torch.equal(slab, k.conv3x3_bf16_pre_plain(x, lay=lay))
    got = k.conv3x3_bf16_gemm(slab, wp, lay=lay)
    _bf16_close(got, k.conv3x3_bf16_gemm_plain(slab, wp, lay=lay))
    k.reset_launches()
    first = k.conv3x3_bf16(x, wp, h=h, w_img=w)
    assert dict(k.launches) == {"conv3x3_bf16.pre": 1, "conv3x3_bf16": 1}
    second = k.conv3x3_bf16(x, wp, h=h, w_img=w)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, got)
    _bf16_close(first, k.conv3x3_bf16_plain(x, wp, h=h, w_img=w))


def _augment_inputs(dev, b, n=600, hw=32, c=3, pad=4, crop=32, seed=0):
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.integers(0, 256, (n, hw, hw, c),
                                         dtype=np.uint8)).to(dev)
    corner = hw + 2 * pad - crop + 1
    draws = [rng.integers(0, n, b), rng.integers(0, corner, b),
             rng.integers(0, corner, b), rng.integers(0, 2, b)]
    idx, top, left, flip = (torch.from_numpy(d.astype(np.int32)).to(dev)
                            for d in draws)
    mean = torch.from_numpy(rng.uniform(0.3, 0.7, (hw, hw, c)).astype(
        np.float32)).to(dev)
    std = rng.uniform(0.2, 0.3, (hw, hw, c)).astype(np.float32)
    inv_std = torch.from_numpy(np.float32(1.0) / std).to(dev)
    return data, idx, top, left, flip, mean, inv_std


@pytest.mark.parametrize("b", [128, 512])
@pytest.mark.parametrize("mirror", [False, True])
@pytest.mark.parametrize("whiten", [False, True])
def test_augment_kernel_matches_plain(dev, b, mirror, whiten):
    data, idx, top, left, flip, mean, inv_std = _augment_inputs(dev, b)
    if not whiten:
        mean, inv_std = torch.zeros_like(mean), torch.ones_like(inv_std)
    kw = dict(pad=4, crop=32, mirror=mirror)
    before = aug.launches["augment_batch"]
    got = aug.augment_batch(data, idx, top, left, flip, mean, inv_std, **kw)
    ref = aug.augment_batch_plain(data, idx, top, left, flip, mean, inv_std,
                                  **kw)
    torch.cuda.synchronize()
    assert aug.launches["augment_batch"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, 32, 32, 3)
    assert torch.equal(got, ref)


def test_fused_augment_draws_on_the_card(dev):
    data, *_ = _augment_inputs(dev, 8)
    std = np.full((32, 32, 3), 0.25, np.float32)
    fused = aug.make_pallas_augment_fn(data, np.zeros_like(std), std, 0.5, 4,
                                       28, True, device=dev)
    idx = torch.arange(64, device=dev, dtype=torch.int32)
    got = fused(idx, Key(3))
    assert torch.equal(got, fused(idx, Key(3), fn=aug.augment_batch_plain))
    assert not torch.equal(got, fused(idx, Key(4)))


def test_augment_cuda_tensor_never_falls_back(dev):
    data, idx, top, left, flip, mean, inv_std = _augment_inputs(dev, 8)
    with pytest.raises(ValueError, match="int32"):
        aug.augment_batch(data, idx.long(), top, left, flip, mean, inv_std,
                          pad=4, crop=32, mirror=True)


def _same(got, want, sums=False):
    assert got.dtype == want.dtype and got.shape == want.shape
    if sums:
        d = (got - want).abs().max().item()
        assert d <= 1e-5 * want.abs().max().item(), d
    else:
        assert torch.equal(got, want)


# (c, h, w, b): the WRN-28-10 stages at batch 128, and small shapes
FQT_SHAPES = [(32, 8, 8, 128), (64, 16, 16, 16), (160, 32, 32, 128),
              (320, 16, 16, 128), (640, 8, 8, 128)]


@pytest.mark.parametrize("c,h,w,b", FQT_SHAPES)
@pytest.mark.parametrize("rate,use_res,stats", [(0.3, False, True),
                                                (0.3, True, False),
                                                (0.0, True, True)])
def test_fused_half_kernels_match_plain(dev, c, h, w, b, rate, use_res,
                                        stats):
    g = torch.Generator(device=dev).manual_seed(c + b)
    n = b * h * w
    x = torch.randn(c, n, device=dev, generator=g).to(torch.bfloat16)
    wt = torch.randn(c, c, 3, 3, device=dev, generator=g) * (9 * c) ** -0.5
    scale = torch.rand(c, device=dev, generator=g) + 0.5
    shift = torch.randn(c, device=dev, generator=g) * 0.3
    thresh = fb.dropout_thresh(rate) if rate else None
    bits = (torch.randint(0, 256, (c, n), device=dev, generator=g,
                          dtype=torch.uint8) if rate else None)
    res = (torch.randn(c, n, device=dev, generator=g).to(torch.bfloat16)
           if use_res else None)
    tile, btile = fb.lane_tile(h, w, n, c, c), fb.bwd_tile(h, w, n, c, c)
    wq, ws = fb.quantize_pack_weights(wt)
    plan = fb.fused_fwd_int8_plan(n, h, w, c, c)
    got = fb.fwd_int8_pre(x, scale, shift, bits, thresh=thresh, tile=tile,
                          plan=plan)
    for a, b_ in zip(got, fb.fwd_int8_pre_plain(x, scale, shift, bits,
                                                thresh=thresh, tile=tile,
                                                plan=plan)):
        _same(a, b_)
    y = fb.fwd_int8(x, wq, ws, scale, shift, bits, res, thresh=thresh,
                    tile=tile, h=h, w_img=w, want_stats=stats)
    y_p = fb.fwd_conv_plain(*fb.fwd_quantize_plain(x, scale, shift, bits,
                                                   thresh=thresh, tile=tile),
                            wq, ws, res, tile=tile, h=h, w_img=w,
                            want_stats=stats)
    _same(y[0], y_p[0])
    if stats:
        _same(y[1], y_p[1], sums=True)
        _same(y[2], y_p[2], sums=True)
    dy = (torch.randn(c, n, device=dev, generator=g) * 1e-3).to(
        torch.bfloat16)
    cts = ((y_p[0], torch.randn(c, device=dev, generator=g) * 1e-4,
            torch.randn(c, device=dev, generator=g) * 1e-4) if stats
           else (None, None, None))
    kw = dict(thresh=thresh, tile=btile, emit_res=stats and use_res)
    got = fb.bwd_quantize(dy, *cts, x, scale, shift, bits, **kw)
    want = fb.bwd_quantize_plain(dy, *cts, x, scale, shift, bits, **kw)
    for a, b_ in zip(got, want):
        if b_ is None:
            assert a is None
        else:
            _same(a, b_)
    g_q, g_amax, d_q, d_amax, _ = want
    wdg, wsin = fb.quantize_pack_weights_dgrad(wt)
    args = (g_q, g_amax, wdg, wsin, x, scale, shift, bits)
    got = fb.dgrad_conv(*args, thresh=thresh, tile=btile, h=h, w_img=w)
    want = fb.dgrad_conv_plain(*args, thresh=thresh, tile=btile, h=h,
                               w_img=w)
    _same(got[0], want[0])
    _same(got[1], want[1], sums=True)
    _same(got[2], want[2], sums=True)
    _same(fb.wgrad(g_q, g_amax, d_q, d_amax, tile=btile, h=h, w_img=w),
          fb.wgrad_plain(g_q, g_amax, d_q, d_amax, tile=btile, h=h, w_img=w))
    torch.cuda.synchronize()


def test_fused_half_op_launches_its_kernels(dev):
    c, h, w, n = 32, 8, 8, 8192
    # the wgrad splits this shape's two scale groups: a slot each, then .sum
    assert fb.fused_wgrad_s8_plan(c, c, n, h, w,
                                  fb.bwd_tile(h, w, n, c, c)).runs == 2
    x = torch.randn(c, n, device=dev).to(torch.bfloat16).requires_grad_()
    wt = (torch.randn(c, c, 3, 3, device=dev) * 0.05).requires_grad_()
    scale = (torch.rand(c, device=dev) + 0.5).requires_grad_()
    shift = torch.zeros(c, device=dev, requires_grad=True)
    bits = torch.randint(0, 256, (c, n), device=dev, dtype=torch.uint8)
    fb.reset_launches()
    y, ys, yq = fb.fused_half_int8(x, wt, scale, shift, bits,
                                   dropout_rate=0.3, h=h, w_img=w)
    (y.float().sum() + ys.sum() + yq.sum()).backward()
    torch.cuda.synchronize()
    assert dict(fb.launches) == {
        name: 1 for name in (
            "fused_half_fwd.amax", "fused_half_fwd.pre", "fused_half_fwd",
            "fused_half_fwd.sum", "fused_half_bwd.amax",
            "fused_half_bwd.quant", "fused_half_dgrad.pre",
            "fused_half_dgrad", "fused_half_dgrad.sum", "fused_half_wgrad",
            "fused_half_wgrad.sum")}
    for t in (x, wt, scale, shift):
        assert torch.isfinite(t.grad).all()


STEM_SHAPES = [(3, 32, 8, 8, 8), (3, 160, 32, 32, 128), (1, 16, 16, 16, 4)]


@pytest.mark.parametrize("cin,cout,h,w,b", STEM_SHAPES)
def test_stem_kernels_match_plain(dev, cin, cout, h, w, b):
    g = torch.Generator(device=dev).manual_seed(cout)
    n = b * h * w
    x = torch.randn(cin, n, device=dev, generator=g).to(torch.bfloat16)
    wp = k.pack_weights((torch.randn(cout, cin, 3, 3, device=dev,
                                     generator=g) * 0.3).to(torch.bfloat16))
    bias = torch.randn(cout, device=dev, generator=g) * 0.1
    _same(st.stem_fwd(x, wp, bias, h=h, w_img=w),
          st.stem_fwd_plain(x, wp, bias, h=h, w_img=w))
    dy = torch.randn(cout, n, device=dev, generator=g).to(torch.bfloat16)
    for a, b_ in zip(st.stem_wgrad(dy, x, h=h, w_img=w),
                     st.stem_wgrad_plain(dy, x, h=h, w_img=w)):
        _same(a, b_, sums=True)
    torch.cuda.synchronize()


@pytest.mark.parametrize("cin,cout,h,w,b", STEM_SHAPES + [
    (8, 64, 16, 16, 8), (5, 256, 8, 8, 4), (3, 20, 8, 8, 8)])
def test_stem_wgrad_tc_matches_plain(dev, cin, cout, h, w, b):
    """The stem's weight gradient on the tensor cores (its K runs from
    stem_wgrad_plan, each step's MMA sums rounded to nearest into f32, the
    blocks' slots added in a fixed order): dW and db within 1e-5 of the
    largest value of the plain version (f32 sums in another order), the
    same bits in two calls, one launch and one sum a call; Cin up to 8,
    Cout up to 256 and off the 16-row tiles."""
    g = torch.Generator(device=dev).manual_seed(cout + cin)
    n = b * h * w
    x = torch.randn(cin, n, device=dev, generator=g).to(torch.bfloat16)
    dy = torch.randn(cout, n, device=dev, generator=g).to(torch.bfloat16)
    st.reset_launches()
    got = st.stem_wgrad(dy, x, h=h, w_img=w)
    again = st.stem_wgrad(dy, x, h=h, w_img=w)
    torch.cuda.synchronize()
    assert dict(st.launches) == {"stem_wgrad": 2, "stem_wgrad.sum": 2}
    want = st.stem_wgrad_plain(dy, x, h=h, w_img=w)
    for a, a2, b_ in zip(got, again, want):
        assert torch.equal(a, a2)
        _same(a, b_, sums=True)


@pytest.mark.parametrize("c,h,w,b", FQT_SHAPES + [(32, 4, 64, 16)])
def test_fused_wgrad_s8_matches_plain(dev, c, h, w, b):
    """The fused half's int8 weight gradient on the TMA + s8 wgmma kernel,
    on the quantizer's codes: dW (HWIO) bit-equal to the plain version and
    over two calls; a launch a call and, where fused_wgrad_s8_plan splits
    the scale groups, a sum over their slots; rows of 64 pixels (which the
    staging chunk of the kernel it replaced refused) included."""
    g = torch.Generator(device=dev).manual_seed(c + h + b)
    n = b * h * w
    x = torch.randn(c, n, device=dev, generator=g).to(torch.bfloat16)
    scale = torch.rand(c, device=dev, generator=g) + 0.5
    shift = torch.randn(c, device=dev, generator=g) * 0.3
    bits = torch.randint(0, 256, (c, n), device=dev, generator=g,
                         dtype=torch.uint8)
    dy = (torch.randn(c, n, device=dev, generator=g) * 1e-3).to(
        torch.bfloat16)
    tile = fb.bwd_tile(h, w, n, c, c)
    g_q, g_amax, d_q, d_amax, _ = fb.bwd_quantize_plain(
        dy, None, None, None, x, scale, shift, bits,
        thresh=fb.dropout_thresh(0.3), tile=tile, emit_res=False)
    plan = fb.fused_wgrad_s8_plan(c, c, n, h, w, tile)
    fb.reset_launches()
    kw = dict(tile=tile, h=h, w_img=w)
    dw = fb.wgrad(g_q, g_amax, d_q, d_amax, **kw)
    again = fb.wgrad(g_q, g_amax, d_q, d_amax, **kw)
    torch.cuda.synchronize()
    want = {"fused_half_wgrad": 2}
    if plan.runs > 1:
        want["fused_half_wgrad.sum"] = 2
    assert dict(fb.launches) == want
    assert dw.shape == (3, 3, c, c) and dw.dtype == torch.float32
    assert torch.equal(dw, again)
    _same(dw, fb.wgrad_plain(g_q, g_amax, d_q, d_amax, **kw))


def test_fused_wgrad_s8_refuses_what_it_cannot_take(dev):
    """A CUDA tensor launches the int8 wgrad or raises, naming the shape:
    Cout off 8, a scale group off the 128-position K step, absmaxes of the
    wrong length, f32 codes; nothing launches, nothing falls back."""
    i8 = torch.int8
    fb.reset_launches()
    g = torch.zeros((64, 1024), dtype=i8, device=dev)
    d = torch.zeros((32, 1024), dtype=i8, device=dev)
    a2 = torch.ones(2, device=dev)
    with pytest.raises(ValueError, match="Cout=44 is not a multiple of 8"):
        fb.wgrad(g[:44], a2, d, a2, tile=512, h=8, w_img=8)
    with pytest.raises(ValueError, match="scale group of 64 positions"):
        fb.wgrad(g, torch.ones(16, device=dev), d, torch.ones(16, device=dev),
                 tile=64, h=8, w_img=8)
    with pytest.raises(ValueError, match="vs 2 scale groups"):
        fb.wgrad(g, torch.ones(1, device=dev), d, a2, tile=512, h=8, w_img=8)
    with pytest.raises(ValueError, match="expected torch.int8"):
        fb.wgrad(g.float(), a2, d, a2, tile=512, h=8, w_img=8)
    torch.cuda.synchronize()
    assert not fb.launches


def test_fused_and_stem_never_fall_back(dev):
    x = torch.zeros((48, 8192), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((48, 9 * 48), dtype=torch.int8, device=dev)
    one = torch.ones(48, device=dev)
    fb.reset_launches()
    with pytest.raises(ValueError, match="multiple of 32"):
        fb.fwd_int8(x, w, one, one, one, None, None, thresh=None, tile=4096,
                    h=8, w_img=8, want_stats=True)
    assert not fb.launches
    x = torch.zeros((3, 8192), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        st.stem_fwd(x, torch.zeros((16, 27), device=dev),
                    torch.zeros(16, device=dev), h=8, w_img=8)


# --- the bf16 fused half and the dropout hash ----------------------------------

def _bf16_close(got, want):
    """bf16 outputs: within 2 bf16 ulps of the tensor's largest value (the
    kernel sums the conv in f32, the plain version in float64)."""
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape
    top = want.float().abs().max().item()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert (got.float() - want.float()).abs().max().item() <= 2 * ulp


def _mma_sums(got, want):
    """f32 sums over the bf16 tensor cores' f32 accumulators (BatchNorm
    sums, d(scale), d(shift), dW): within 1e-4 of the largest value. The
    tensor cores' f32 accumulation does not round to nearest: at K = 5,760
    (C = 640) it left y's squares 1.6e-5 of their largest sum below the
    float64 plain version's, every channel low."""
    assert got.dtype == want.dtype and got.shape == want.shape
    d = (got - want).abs().max().item()
    assert d <= 1e-4 * want.abs().max().item(), d


SEEDS = [0, -1, 2 ** 31 - 1, -2 ** 31, 123456789, -987654321]


@pytest.mark.parametrize("c,n", [(160, 128 * 1024), (33, 1000), (8, 8)])
def test_seed_bits_expand_is_bit_equal(dev, c, n):
    for s in SEEDS:
        seed = torch.tensor(s, dtype=torch.int32, device=dev)
        assert torch.equal(fb.seed_bits_expand(seed, c, n),
                           fb.seed_bits(seed, c, n, 0, n))
    torch.cuda.synchronize()


def _drop(mode, dev, g, c, n):
    """(thresh, bits) of a bits mode on the card."""
    if mode == "none":
        return None, None
    if mode == "seed":
        return fb.dropout_thresh(0.3), torch.tensor(
            -2 ** 31 + 17, dtype=torch.int32, device=dev)
    return fb.dropout_thresh(0.3), torch.randint(
        0, 256, (c, n), device=dev, generator=g, dtype=torch.uint8)


@pytest.mark.parametrize("c,h,w,b", FQT_SHAPES)
@pytest.mark.parametrize("mode", ["none", "bits", "seed"])
@pytest.mark.parametrize("use_res,stats", [(False, True), (True, False),
                                           (True, True)])
def test_fused_half_bf16_kernels_match_plain(dev, c, h, w, b, mode, use_res,
                                             stats):
    g = torch.Generator(device=dev).manual_seed(c + b + 1)
    n = b * h * w
    x = torch.randn(c, n, device=dev, generator=g).to(torch.bfloat16)
    wt = torch.randn(c, c, 3, 3, device=dev, generator=g) * (9 * c) ** -0.5
    wp = k.pack_weights(wt.to(torch.bfloat16))
    wdg = fb.pack_weights_dgrad(wt.to(torch.bfloat16))
    scale = torch.rand(c, device=dev, generator=g) + 0.5
    shift = torch.randn(c, device=dev, generator=g) * 0.3
    thresh, bits = _drop(mode, dev, g, c, n)
    res = (torch.randn(c, n, device=dev, generator=g).to(torch.bfloat16)
           if use_res else None)
    kw = dict(thresh=thresh, h=h, w_img=w)
    got = fb.fwd_bf16(x, wp, scale, shift, bits, res, want_stats=stats, **kw)
    want = fb.fwd_bf16_plain(x, wp, scale, shift, bits, res,
                             want_stats=stats, **kw)
    _bf16_close(got[0], want[0])
    if stats:
        yd = got[0].double()
        for s_, own, ref in ((got[1], yd.sum(1), want[1]),
                             (got[2], (yd * yd).sum(1), want[2])):
            _mma_sums(s_, ref)
            d = (s_.double() - own).abs().max().item()
            assert d <= 1e-5 * own.abs().max().item(), d
    dy = (torch.randn(c, n, device=dev, generator=g) * 1e-3).to(
        torch.bfloat16)
    cts = ((want[0], torch.randn(c, device=dev, generator=g) * 1e-4,
            torch.randn(c, device=dev, generator=g) * 1e-4) if stats
           else (None, None, None))
    args = (dy, *cts, wdg, x, scale, shift, bits)
    fb.reset_launches()
    got = fb.dgrad_bf16(*args, emit_res=stats and use_res, **kw)
    assert dict(fb.launches) == {
        "fused_half_bf16_dgrad.pre": 1, "fused_half_bf16_dgrad": 1,
        "fused_half_bf16_dgrad.sum": 1}
    want = fb.dgrad_bf16_plain(*args, emit_res=stats and use_res, **kw)
    _bf16_close(got[0], want[0])
    _mma_sums(got[1], want[1])
    _mma_sums(got[2], want[2])
    if stats and use_res:
        _same(got[3], want[3])
    else:
        assert got[3] is None and want[3] is None
    args = (dy, *cts, x, scale, shift, bits)
    _mma_sums(fb.wgrad_bf16(*args, **kw), fb.wgrad_bf16_plain(*args, **kw))
    torch.cuda.synchronize()


@pytest.mark.parametrize("c,h,w,b", FQT_SHAPES)
def test_int8_kernels_in_seed_mode_match_plain(dev, c, h, w, b):
    """The int8 core's quantizers (the forward's writes the slab) and dgrad
    rebuild the mask from a seed: equal to their plain versions, and to
    themselves fed the expanded bits."""
    g = torch.Generator(device=dev).manual_seed(c + b + 2)
    n = b * h * w
    x = torch.randn(c, n, device=dev, generator=g).to(torch.bfloat16)
    wt = torch.randn(c, c, 3, 3, device=dev, generator=g) * (9 * c) ** -0.5
    scale = torch.rand(c, device=dev, generator=g) + 0.5
    shift = torch.randn(c, device=dev, generator=g) * 0.3
    thresh, seed = _drop("seed", dev, g, c, n)
    expanded = fb.seed_bits(seed, c, n, 0, n)
    tile, btile = fb.lane_tile(h, w, n, c, c), fb.bwd_tile(h, w, n, c, c)
    plan = fb.fused_fwd_int8_plan(n, h, w, c, c)
    outs = []
    for bits in (seed, expanded):
        d_q, amax = fb.fwd_int8_pre(x, scale, shift, bits, thresh=thresh,
                                    tile=tile, plan=plan)
        dy = (torch.randn(c, n, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(
                              7)) * 1e-3).to(torch.bfloat16)
        ops = fb.bwd_quantize(dy, None, None, None, x, scale, shift, bits,
                              thresh=thresh, tile=btile, emit_res=False)
        wdg, wsin = fb.quantize_pack_weights_dgrad(wt)
        dg = fb.dgrad_conv(ops[0], ops[1], wdg, wsin, x, scale, shift, bits,
                           thresh=thresh, tile=btile, h=h, w_img=w)
        outs.append([d_q, amax, *ops[:4], *dg])
        want = fb.fwd_int8_pre_plain(x, scale, shift, bits, thresh=thresh,
                                     tile=tile, plan=plan)
        _same(d_q, want[0])
        _same(amax, want[1])
        want = fb.dgrad_conv_plain(ops[0], ops[1], wdg, wsin, x, scale,
                                   shift, bits, thresh=thresh, tile=btile,
                                   h=h, w_img=w)
        _same(dg[0], want[0])
        _same(dg[1], want[1], sums=True)
    for a, b_ in zip(*outs):
        assert torch.equal(a, b_)
    torch.cuda.synchronize()


def test_fused_half_bf16_op_launches_its_kernels(dev):
    c, h, w, n = 32, 8, 8, 8192
    for op, kw in ((fb.fused_half, {}),
                   (fb.fused_half_int8, {"quant_bwd": False})):
        x = torch.randn(c, n, device=dev).to(torch.bfloat16).requires_grad_()
        wt = (torch.randn(c, c, 3, 3, device=dev) * 0.05).requires_grad_()
        scale = (torch.rand(c, device=dev) + 0.5).requires_grad_()
        shift = torch.zeros(c, device=dev, requires_grad=True)
        seed = torch.tensor(5, dtype=torch.int32, device=dev)
        fb.reset_launches()
        y, ys, yq = op(x, wt, scale, shift, seed, dropout_rate=0.3, h=h,
                       w_img=w, **kw)
        (y.float().sum() + ys.sum() + yq.sum()).backward()
        torch.cuda.synchronize()
        bwd = ("fused_half_bf16_dgrad.pre", "fused_half_bf16_dgrad",
               "fused_half_bf16_dgrad.sum", "fused_half_bf16_wgrad.pre",
               "fused_half_bf16_wgrad", "fused_half_bf16_wgrad.sum")
        fwd = (("fused_half_bf16_fwd.pre", "fused_half_bf16_fwd",
                "fused_half_bf16_fwd.sum") if not kw
               else ("fused_half_fwd.amax", "fused_half_fwd.pre",
                     "fused_half_fwd", "fused_half_fwd.sum"))
        assert dict(fb.launches) == {name: 1 for name in fwd + bwd}
        # the bf16 forward's and the wgrad's prepasses rebuild the mask
        # (their mainloops read the slab and d_b), the dgrad's GEMM in its
        # epilogue (its prepass writes g, which no mask touches)
        seeded = {name for name in fwd + bwd if not name.endswith(".sum")
                  and name not in ("fused_half_fwd", "fused_half_bf16_fwd",
                                   "fused_half_bf16_wgrad",
                                   "fused_half_bf16_dgrad.pre")}
        assert dict(fb.seed_launches) == {name: 1 for name in seeded}
        for t in (x, wt, scale, shift):
            assert torch.isfinite(t.grad).all()


# (Cin, Cout, h, w, batch) of the half for the wgmma bf16 dgrad: the
# WRN-28-10 stages at batch 128, then widths the old row-tile kernel
# refused (6x6, 5x7, 12x12) with Cin != Cout: the GEMM's N is the half's
# Cin, so 48 is a ragged 64-wide N tile and 136 a ragged second 128-wide one
FUSED_DGRAD_SHAPES = [(160, 160, 32, 32, 128), (320, 320, 16, 16, 128),
                      (640, 640, 8, 8, 128), (48, 32, 6, 6, 64),
                      (32, 48, 5, 7, 8), (64, 96, 12, 12, 16),
                      (136, 64, 12, 12, 8)]


@pytest.mark.parametrize("cin,cout,h,w,b", FUSED_DGRAD_SHAPES)
@pytest.mark.parametrize("mode", ["none", "bits", "seed"])
@pytest.mark.parametrize("stats", [True, False])
def test_fused_dgrad_bf16_wgmma_matches_plain(dev, cin, cout, h, w, b, mode,
                                              stats):
    """The bf16 dgrad's prepass and wgmma GEMM: the slab equal to its plain
    version's byte for byte; dx within 2 bf16 ulps of
    ``dgrad_bf16_plain``'s largest value, d(scale) and d(shift) by
    ``_mma_sums``, dres equal; two calls bit-equal; each call one prepass,
    one GEMM (seeded in seed mode: the mask is rebuilt in its epilogue) and
    one ordered sum."""
    g = torch.Generator(device=dev).manual_seed(cin + 3 * cout + w)
    n = b * h * w

    def rn(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=g) * s

    x = rn(cin, n).to(torch.bfloat16)
    wt = rn(cout, cin, 3, 3, s=(9 * cin) ** -0.5)
    wdg = fb.pack_weights_dgrad(wt.to(torch.bfloat16))
    scale, shift = rn(cin).abs() + 0.5, rn(cin, s=0.3)
    thresh, bits = _drop(mode, dev, g, cin, n)
    dy = rn(cout, n, s=1e-3).to(torch.bfloat16)
    cts = ((rn(cout, n).to(torch.bfloat16), rn(cout, s=1e-4),
            rn(cout, s=1e-4)) if stats else (None,) * 3)
    args = (dy, *cts, wdg, x, scale, shift, bits)
    kw = dict(thresh=thresh, h=h, w_img=w, emit_res=stats)
    lay = fb.fused_fwd_layout(n, h, w, cout, cin)
    slab, dres = fb.dgrad_bf16_pre(dy, *cts, lay=lay, emit_res=stats)
    fb.reset_launches()
    got = fb.dgrad_bf16(*args, **kw)
    again = fb.dgrad_bf16(*args, **kw)
    torch.cuda.synchronize()
    pslab, pdres = fb.dgrad_bf16_pre_plain(dy, *cts, lay=lay,
                                           emit_res=stats)
    assert torch.equal(slab, pslab)
    assert (dres is None and pdres is None) or torch.equal(dres, pdres)
    want = fb.dgrad_bf16_plain(*args, **kw)
    _bf16_close(got[0], want[0])
    _mma_sums(got[1], want[1])
    _mma_sums(got[2], want[2])
    if stats:
        _same(got[3], want[3])
    else:
        assert got[3] is None and want[3] is None
    for a, b_ in zip(got, again):
        assert (a is None and b_ is None) or torch.equal(a, b_)
    names = ("fused_half_bf16_dgrad.pre", "fused_half_bf16_dgrad",
             "fused_half_bf16_dgrad.sum")
    assert dict(fb.launches) == {name: 2 for name in names}
    assert dict(fb.seed_launches) == ({names[1]: 2} if mode == "seed"
                                      else {})


def test_fused_dgrad_bf16_refuses_what_it_cannot_take(dev):
    """The wgmma bf16 dgrad raises on what its kernels do not take
    (channels or positions not a multiple of 8, a slab of another layout,
    another dtype), launching nothing."""
    c, h, w, n = 32, 6, 6, 8 * 36
    dy = torch.zeros((c, n), dtype=torch.bfloat16, device=dev)
    wdg = torch.zeros((c, 9 * c), dtype=torch.bfloat16, device=dev)
    one = torch.ones(c, device=dev)
    kw = dict(thresh=None, h=h, w_img=w, emit_res=False)
    fb.reset_launches()
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        fb.dgrad_bf16(dy, None, None, None, wdg, dy.float(), one, one, None,
                      **kw)
    with pytest.raises(ValueError, match="Cin=12"):
        fb.dgrad_bf16(dy[:12].contiguous(), None, None, None,
                      wdg[:, :9 * 12].contiguous(), dy, one, one, None, **kw)
    with pytest.raises(ValueError, match="geometry H=6 W=6 N=252"):
        fb.dgrad_bf16(dy[:, :252].contiguous(), None, None, None, wdg,
                      dy[:, :252].contiguous(), one, one, None, **kw)
    lay = fb.fused_fwd_layout(n, h, w, c, c)
    with pytest.raises(ValueError, match="is not of the layout"):
        fb.dgrad_bf16_gemm(torch.zeros((lay.slab_len - 1, c),
                                       dtype=torch.bfloat16, device=dev),
                           wdg, dy, one, one, None, thresh=None, lay=lay)
    assert not fb.launches


# (Cin, Cout, h, w, batch, scale group) of the half for the wgmma int8
# (FQT) dgrad: the WRN-28-10 stages at batch 128 (their own scale groups:
# Cout % 128 = 32, 64, 0), then widths the old row-tile kernel refused
# (6x6, 5x7, 12x12) at Cout = 32 and 96 (96 % 128: a 64- and a 32-byte
# box a tap) with Cin = 40 (a ragged 64-wide N tile) and 96; groups of 2
# images of 6x6 (72 lanes) and of 12x12 (288) put a group boundary inside
# most 128-row tiles
FUSED_DGRAD_INT8_SHAPES = [(160, 160, 32, 32, 128, None),
                           (320, 320, 16, 16, 128, None),
                           (640, 640, 8, 8, 128, None),
                           (40, 32, 6, 6, 64, 72), (96, 96, 5, 7, 8, 280),
                           (40, 96, 12, 12, 8, 288), (96, 32, 12, 12, 16, 144)]


@pytest.mark.parametrize("cin,cout,h,w,b,tile", FUSED_DGRAD_INT8_SHAPES)
@pytest.mark.parametrize("mode", ["none", "bits", "seed"])
def test_fused_dgrad_int8_wgmma_matches_plain(dev, cin, cout, h, w, b, tile,
                                              mode):
    """The int8 (FQT) dgrad's prepass and s8 wgmma GEMM: the slab equal to
    its plain version's byte for byte; dx equal to ``dgrad_conv_plain``'s
    bit for bit, d(scale) and d(shift) within 1e-5; two calls bit-equal,
    and the GEMM on the slab alone the same; each call one prepass, one
    GEMM (seeded in seed mode: the mask is rebuilt in its epilogue) and one
    ordered sum."""
    g = torch.Generator(device=dev).manual_seed(cin + 5 * cout + w)
    n = b * h * w
    tile = tile or fb.bwd_tile(h, w, n, cin, cout)

    def rn(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=g) * s

    x = rn(cin, n).to(torch.bfloat16)
    wdg, wsin = fb.quantize_pack_weights_dgrad(
        rn(cout, cin, 3, 3, s=(9 * cin) ** -0.5))
    scale, shift = rn(cin).abs() + 0.5, rn(cin, s=0.3)
    thresh, bits = _drop(mode, dev, g, cin, n)
    g_q, g_amax = fb.quantize_groups_plain(rn(cout, n, s=1e-3), tile,
                                           fb.BWD_FLOOR)
    args = (g_q, g_amax, wdg, wsin, x, scale, shift, bits)
    kw = dict(thresh=thresh, tile=tile, h=h, w_img=w)
    plan = fb.fused_fwd_int8_plan(n, h, w, cout, cin)
    slab = fb.dgrad_int8_pre(g_q, plan=plan)
    fb.reset_launches()
    got = fb.dgrad_conv(*args, **kw)
    again = fb.dgrad_conv(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(slab, fb.dgrad_int8_pre_plain(g_q, plan=plan))
    want = fb.dgrad_conv_plain(*args, **kw)
    _same(got[0], want[0])
    _same(got[1], want[1], sums=True)
    _same(got[2], want[2], sums=True)
    for a, b_ in zip(got, again):
        assert torch.equal(a, b_)
    names = ("fused_half_dgrad.pre", "fused_half_dgrad",
             "fused_half_dgrad.sum")
    assert dict(fb.launches) == {name: 2 for name in names}
    assert dict(fb.seed_launches) == ({names[1]: 2} if mode == "seed"
                                      else {})
    alone = fb.dgrad_int8_gemm(slab, *args[1:], thresh=thresh, tile=tile,
                               plan=plan)
    for a, b_ in zip(alone, got):
        assert torch.equal(a, b_)


def test_fused_dgrad_int8_refuses_what_it_cannot_take(dev):
    """The wgmma int8 dgrad raises on what its kernels do not take (Cout
    not a multiple of 32, Cin not a multiple of 8, scale groups that are
    not whole images of a multiple of 8 lanes, a slab of another layout,
    another dtype), launching nothing."""
    cin, cout, h, w, b = 32, 32, 6, 6, 8
    n = b * h * w
    g_q = torch.zeros((cout, n), dtype=torch.int8, device=dev)
    wdg = torch.zeros((cin, 9 * cout), dtype=torch.int8, device=dev)
    x = torch.zeros((cin, n), dtype=torch.bfloat16, device=dev)
    one = torch.ones(cin, device=dev)
    amax = torch.ones(n // 72, device=dev)
    kw = dict(thresh=None, tile=72, h=h, w_img=w)
    fb.reset_launches()
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        fb.dgrad_conv(g_q, amax, wdg, one, x.float(), one, one, None, **kw)
    with pytest.raises(ValueError, match="Cin=48, Cout=32"):
        fb.dgrad_conv(torch.zeros((48, n), dtype=torch.int8, device=dev),
                      amax, torch.zeros((cin, 9 * 48), dtype=torch.int8,
                                        device=dev), one, x, one, one, None,
                      **kw)
    with pytest.raises(ValueError, match="Cin=32, Cout=36"):
        fb.dgrad_conv(g_q, amax, torch.zeros((36, 9 * cout),
                                             dtype=torch.int8, device=dev),
                      torch.ones(36, device=dev),
                      torch.zeros((36, n), dtype=torch.bfloat16, device=dev),
                      torch.ones(36, device=dev), torch.ones(36, device=dev),
                      None, **kw)
    with pytest.raises(ValueError, match="scale group of 36 lanes"):
        fb.dgrad_conv(g_q, torch.ones(n // 36, device=dev), wdg, one, x,
                      one, one, None, **dict(kw, tile=36))
    plan = fb.fused_fwd_int8_plan(n, h, w, cout, cin)
    with pytest.raises(ValueError, match="is not of the layout"):
        fb.dgrad_int8_gemm(torch.zeros((plan.lay.slab_len - 1, cout),
                                       dtype=torch.int8, device=dev),
                           amax, wdg, one, x, one, one, None, thresh=None,
                           tile=72, plan=plan)
    assert not fb.launches


def test_fused_half_int8_fqt_runs_12x12(dev):
    """12x12 images at batch 8 (a width the old FQT dgrad's rows of 8
    refused: ROADMAP Queue 3 item 6): ``fused_half_int8`` in FQT runs
    forward and backward on its kernels, the dgrad's three among them, and
    equals the plain chain: y equal and its sums within 1e-5; dx and dW
    equal, d(scale) and d(shift) within 1e-5 of the plain quantizer, dgrad
    and wgrad on the same cotangents."""
    c, b, h, w = 32, 8, 12, 12
    n = b * h * w
    g = torch.Generator(device=dev).manual_seed(1212)

    def rn(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=g) * s

    x = rn(c, n).to(torch.bfloat16)
    wt = rn(c, c, 3, 3, s=0.05)
    scale, shift = rn(c).abs() + 0.5, rn(c, s=0.3)
    cy, cs, cq = rn(c, n, s=1e-2).to(torch.bfloat16), rn(c, s=1e-3), rn(
        c, s=1e-3)
    leaves = [t.clone().requires_grad_() for t in (x, wt, scale, shift)]
    fb.reset_launches()
    y, ys, yq = fb.fused_half_int8(*leaves, h=h, w_img=w, quant_bwd=True)
    ((y.float() * cy.float()).sum() + (ys * cs).sum()
     + (yq * cq).sum()).backward()
    torch.cuda.synchronize()
    for name in ("fused_half_fwd", "fused_half_bwd.quant",
                 "fused_half_dgrad.pre", "fused_half_dgrad",
                 "fused_half_dgrad.sum", "fused_half_wgrad"):
        assert fb.launches[name] == 1, name
    tile, btile = fb.lane_tile(h, w, n, c, c), fb.bwd_tile(h, w, n, c, c)
    wq, ws = fb.quantize_pack_weights(wt)
    want = fb.fwd_conv_plain(*fb.fwd_quantize_plain(
        x, scale, shift, None, thresh=None, tile=tile), wq, ws, None,
        tile=tile, h=h, w_img=w, want_stats=True)
    _same(y.detach(), want[0])
    _same(ys.detach(), want[1], sums=True)
    _same(yq.detach(), want[2], sums=True)
    g_q, g_amax, d_q, d_amax, _ = fb.bwd_quantize_plain(
        cy, y.detach(), cs, cq, x, scale, shift, None, thresh=None,
        tile=btile, emit_res=False)
    wdg, wsin = fb.quantize_pack_weights_dgrad(wt)
    dx, ds, dt = fb.dgrad_conv_plain(g_q, g_amax, wdg, wsin, x, scale, shift,
                                     None, thresh=None, tile=btile, h=h,
                                     w_img=w)
    dw = fb.wgrad_plain(g_q, g_amax, d_q, d_amax, tile=btile, h=h, w_img=w)
    _same(leaves[0].grad, dx)
    _same(leaves[2].grad, ds, sums=True)
    _same(leaves[3].grad, dt, sums=True)
    _same(leaves[1].grad, dw.permute(3, 2, 0, 1))


# (Cin, Cout, h, w, batch, bits mode) of the staged fused wgrad: geometries
# the old kernel refused (12 x 12 images, rows of 40 and of 7, Cin = 24),
# then WRN-28-10's first stage at a smaller batch
FUSED_WGRAD_SHAPES = [(64, 64, 12, 12, 8, "bits"), (64, 64, 12, 12, 8, "seed"),
                      (32, 48, 5, 40, 4, "none"), (24, 16, 7, 7, 8, "bits"),
                      (160, 160, 32, 32, 16, "seed")]


@pytest.mark.parametrize("cin,cout,h,w,b,mode", FUSED_WGRAD_SHAPES)
def test_fused_wgrad_bf16_staged_matches_plain(dev, cin, cout, h, w, b,
                                               mode):
    """The fused bf16 wgrad on the staged mainloop, with and without the
    stats cotangents: the prepass's d_b and g_b equal its plain version's
    byte for byte; dW within 1e-4 of the plain version's largest value
    (``_mma_sums``) and the same bit for bit in two calls (the splits are
    added in a fixed order); each call launches the prepass (seeded in seed
    mode), the mainloop and the sum once."""
    g = torch.Generator(device=dev).manual_seed(cin + cout + w)
    n = b * h * w

    def rn(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=g) * s

    x = rn(cin, n).to(torch.bfloat16)
    dy, y = rn(cout, n, s=1e-3).to(torch.bfloat16), rn(cout, n).to(
        torch.bfloat16)
    scale, shift = rn(cin).abs() + 0.5, rn(cin, s=0.3)
    thresh, bits = _drop(mode, dev, g, cin, n)
    names = ("fused_half_bf16_wgrad.pre", "fused_half_bf16_wgrad",
             "fused_half_bf16_wgrad.sum")
    for cts in ((y, rn(cout, s=1e-4), rn(cout, s=1e-4)), (None,) * 3):
        args = (dy, *cts, x, scale, shift, bits)
        kw = dict(thresh=thresh, h=h, w_img=w)
        fb.reset_launches()
        d_b, g_b = fb.wgrad_bf16_pre(*args, thresh=thresh)
        want = fb.wgrad_bf16_pre_plain(*args, thresh=thresh)
        first = fb.wgrad_bf16(*args, **kw)
        second = fb.wgrad_bf16(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(d_b, want[0]) and torch.equal(g_b, want[1])
        assert torch.equal(first, second)
        assert dict(fb.launches) == dict(zip(names, (3, 2, 2)))
        assert dict(fb.seed_launches) == ({names[0]: 3} if mode == "seed"
                                          else {})
        _mma_sums(first, fb.wgrad_bf16_plain(*args, **kw))


def test_fused_wgrad_bf16_refuses_what_it_cannot_take(dev):
    """The staged fused wgrad raises on what its kernels do not take
    (channels or positions not a multiple of 8, operands that are not whole
    images, another dtype), launching nothing."""
    x = torch.zeros((32, 8 * 36), dtype=torch.bfloat16, device=dev)
    one = torch.ones(32, device=dev)
    fb.reset_launches()
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        fb.wgrad_bf16_pre(x.float(), None, None, None, x, one, one, None,
                          thresh=None)
    with pytest.raises(ValueError, match="multiple of 8"):
        fb.wgrad_bf16_pre(x[:12].contiguous(), None, None, None, x, one,
                          one, None, thresh=None)
    with pytest.raises(ValueError, match="multiple of 8"):
        fb.wgrad_bf16_pre(x[:, :36 * 7].contiguous(), None, None, None,
                          x[:, :36 * 7].contiguous(), one, one, None,
                          thresh=None)
    d_b = x.t().contiguous()
    with pytest.raises(ValueError, match="whole 5x5 images"):
        fb.wgrad_bf16_gemm(d_b, d_b, h=5, w_img=5)
    with pytest.raises(ValueError, match="multiple of 8"):
        fb.wgrad_bf16_gemm(d_b, d_b[:, :12].contiguous(), h=6, w_img=6)
    assert not fb.launches


def test_fused_half_bf16_never_falls_back(dev):
    x = torch.zeros((32, 8192), dtype=torch.float32, device=dev)
    w = torch.zeros((32, 9 * 32), dtype=torch.bfloat16, device=dev)
    one = torch.ones(32, device=dev)
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        fb.fwd_bf16(x, w, one, one, None, None, thresh=None, h=8, w_img=8,
                    want_stats=True)
    fb.reset_launches()
    with pytest.raises(ValueError, match="multiple of 8"):
        fb.fwd_bf16(x.to(torch.bfloat16).repeat(2, 1)[:44].contiguous(),
                    torch.zeros((44, 9 * 44), dtype=torch.bfloat16,
                                device=dev), torch.ones(44, device=dev),
                    torch.ones(44, device=dev), None, None, thresh=None,
                    h=8, w_img=8, want_stats=True)
    assert not fb.launches


# (Cin, Cout, h, w, batch) of the staged bf16 forward: the FQT shapes (the
# WRN-28-10 stages at batch 128), then widths the old row-tile kernel
# refused (6x6, 12x12) and Cout in {64, 96} with Cin != Cout (a 64-wide
# and a ragged 128-wide N tile)
FUSED_FWD_SHAPES = [(c, c, h, w, b) for c, h, w, b in FQT_SHAPES] + [
    (32, 64, 6, 6, 64), (128, 96, 12, 12, 16), (96, 64, 6, 6, 32)]


@pytest.mark.parametrize("cin,cout,h,w,b", FUSED_FWD_SHAPES)
@pytest.mark.parametrize("mode", ["none", "bits", "seed"])
@pytest.mark.parametrize("use_res,stats", [(False, True), (True, False),
                                           (True, True)])
def test_fused_fwd_bf16_staged_matches_plain(dev, cin, cout, h, w, b, mode,
                                             use_res, stats):
    """The bf16 forward's prepass and wgmma GEMM: the slab equal to its
    plain version's byte for byte; y within 2 bf16 ulps of
    ``fwd_bf16_plain``'s largest value, the sums within 1e-4 of the
    plain's (``_mma_sums``) and within 1e-5 of the sums of the kernel's
    own y; two calls bit-equal; each call one prepass (seeded in seed
    mode), one GEMM and with stats one ordered sum."""
    g = torch.Generator(device=dev).manual_seed(cin + cout + w)
    n = b * h * w
    x = torch.randn(cin, n, device=dev, generator=g).to(torch.bfloat16)
    wt = torch.randn(cout, cin, 3, 3, device=dev, generator=g) * (
        9 * cin) ** -0.5
    wp = k.pack_weights(wt.to(torch.bfloat16))
    scale = torch.rand(cin, device=dev, generator=g) + 0.5
    shift = torch.randn(cin, device=dev, generator=g) * 0.3
    thresh, bits = _drop(mode, dev, g, cin, n)
    res = (torch.randn(cout, n, device=dev, generator=g).to(torch.bfloat16)
           if use_res else None)
    kw = dict(thresh=thresh, h=h, w_img=w, want_stats=stats)
    lay = fb.fused_fwd_layout(n, h, w, cin, cout)
    slab = fb.fused_fwd_pre(x, scale, shift, bits, thresh=thresh, lay=lay)
    fb.reset_launches()
    got = fb.fwd_bf16(x, wp, scale, shift, bits, res, **kw)
    again = fb.fwd_bf16(x, wp, scale, shift, bits, res, **kw)
    want = fb.fwd_bf16_plain(x, wp, scale, shift, bits, res, **kw)
    torch.cuda.synchronize()
    assert torch.equal(slab, fb.fused_fwd_pre_plain(x, scale, shift, bits,
                                                    thresh=thresh, lay=lay))
    _bf16_close(got[0], want[0])
    for a, b_ in zip(got, again):
        assert (a is None and b_ is None) or torch.equal(a, b_)
    if stats:
        yd = got[0].double()
        for s_, own, ref in ((got[1], yd.sum(1), want[1]),
                             (got[2], (yd * yd).sum(1), want[2])):
            _mma_sums(s_, ref)
            d = (s_.double() - own).abs().max().item()
            assert d <= 1e-5 * own.abs().max().item(), d
    else:
        assert got[1] is None and got[2] is None
    names = ("fused_half_bf16_fwd.pre", "fused_half_bf16_fwd") + (
        ("fused_half_bf16_fwd.sum",) if stats else ())
    assert dict(fb.launches) == {name: 2 for name in names}
    assert dict(fb.seed_launches) == ({names[0]: 2} if mode == "seed"
                                      else {})


def _half_6x6(dev, seed):
    """x, w (OIHW), scale, shift of a C = 32 half on 6x6 images at batch
    64 (a geometry the fused gate admits), and the loss's cotangents of
    (y, ysum, yssq)."""
    c, b, h, w = 32, 64, 6, 6
    n = b * h * w
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(c, n, device=dev, generator=g).to(torch.bfloat16)
    wt = torch.randn(c, c, 3, 3, device=dev, generator=g) * 0.05
    scale = torch.rand(c, device=dev, generator=g) + 0.5
    shift = torch.randn(c, device=dev, generator=g) * 0.3
    cy = (torch.randn(c, n, device=dev, generator=g) * 1e-2).to(
        torch.bfloat16)
    cs = torch.randn(c, device=dev, generator=g) * 1e-3
    cq = torch.randn(c, device=dev, generator=g) * 1e-3
    return (x, wt, scale, shift), (cy, cs, cq), (h, w)


def test_fused_half_runs_6x6_forward_and_backward(dev):
    """6x6 images at batch 64 (widths the old bf16 dgrad's rows of 8
    refused): ``fused_half`` runs forward and backward on its kernels, the
    dgrad's three among them, and equals the plain versions: y within 2
    bf16 ulps of ``fwd_bf16_plain``, the sums by ``_mma_sums``; dx within 2
    ulps and d(scale), d(shift), dW by ``_mma_sums`` of the plain backward
    on the kernel's own y."""
    ins, (cy, cs, cq), (h, w) = _half_6x6(dev, 66)
    x, wt, scale, shift = ins
    leaves = [t.clone().requires_grad_() for t in ins]
    fb.reset_launches()
    y, ys, yq = fb.fused_half(*leaves, h=h, w_img=w)
    ((y.float() * cy.float()).sum() + (ys * cs).sum()
     + (yq * cq).sum()).backward()
    torch.cuda.synchronize()
    for name in ("fused_half_bf16_fwd", "fused_half_bf16_dgrad.pre",
                 "fused_half_bf16_dgrad", "fused_half_bf16_dgrad.sum",
                 "fused_half_bf16_wgrad"):
        assert fb.launches[name] == 1, name
    kw = dict(thresh=None, h=h, w_img=w)
    want = fb.fwd_bf16_plain(x, k.pack_weights(wt.to(torch.bfloat16)), scale,
                             shift, None, None, want_stats=True, **kw)
    _bf16_close(y.detach(), want[0])
    _mma_sums(ys.detach(), want[1])
    _mma_sums(yq.detach(), want[2])
    ct = (cy, y.detach(), cs, cq)
    dx, ds, dt, _ = fb.dgrad_bf16_plain(
        *ct, fb.pack_weights_dgrad(wt.to(torch.bfloat16)), x, scale, shift,
        None, emit_res=False, **kw)
    dw = fb.wgrad_bf16_plain(*ct, x, scale, shift, None, **kw)
    _bf16_close(leaves[0].grad, dx)
    _mma_sums(leaves[2].grad, ds)
    _mma_sums(leaves[3].grad, dt)
    _mma_sums(leaves[1].grad, dw.reshape(32, 3, 3, 32).permute(0, 3, 1, 2))


# (Cin, Cout, h, w, batch) of the staged int8 forward: the FQT shapes (the
# WRN-28-10 stages at batch 128), then 6x6 images at Cin 96 (64- and
# 32-byte K steps) and Cout 40 (a ragged 64-wide N tile), and 12x12 at
# Cout 136 (a ragged 128-wide one)
FUSED_FWD_INT8_SHAPES = [(c, c, h, w, b) for c, h, w, b in FQT_SHAPES] + [
    (96, 40, 6, 6, 32), (64, 136, 12, 12, 8)]


@pytest.mark.parametrize("cin,cout,h,w,b", FUSED_FWD_INT8_SHAPES)
@pytest.mark.parametrize("mode", ["none", "bits", "seed"])
@pytest.mark.parametrize("use_res,stats", [(False, True), (True, False),
                                           (True, True)])
def test_fused_fwd_int8_staged_matches_plain(dev, cin, cout, h, w, b, mode,
                                             use_res, stats):
    """The int8 forward's amax pass, prepass and TMA-fed s8 wgmma GEMM: the
    slab and the groups' absmax equal to the plain prepass's byte for
    byte, y equal to ``fwd_conv_plain`` of ``fwd_quantize_plain``, the sums
    within 1e-5 of its largest value; two calls bit-equal; each call one
    amax pass and one prepass (both seeded in seed mode), one GEMM and
    with stats one ordered sum."""
    g = torch.Generator(device=dev).manual_seed(cin + cout + w + 1)
    n = b * h * w
    x = torch.randn(cin, n, device=dev, generator=g).to(torch.bfloat16)
    wt = torch.randn(cout, cin, 3, 3, device=dev, generator=g) * (
        9 * cin) ** -0.5
    wq, ws = fb.quantize_pack_weights(wt)
    scale = torch.rand(cin, device=dev, generator=g) + 0.5
    shift = torch.randn(cin, device=dev, generator=g) * 0.3
    thresh, bits = _drop(mode, dev, g, cin, n)
    res = (torch.randn(cout, n, device=dev, generator=g).to(torch.bfloat16)
           if use_res else None)
    tile = fb.lane_tile(h, w, n, cin, cout)
    plan = fb.fused_fwd_int8_plan(n, h, w, cin, cout)
    kw = dict(thresh=thresh, tile=tile, h=h, w_img=w, want_stats=stats)
    slab, amax = fb.fwd_int8_pre(x, scale, shift, bits, thresh=thresh,
                                 tile=tile, plan=plan)
    fb.reset_launches()
    got = fb.fwd_int8(x, wq, ws, scale, shift, bits, res, **kw)
    again = fb.fwd_int8(x, wq, ws, scale, shift, bits, res, **kw)
    d_q, pamax = fb.fwd_quantize_plain(x, scale, shift, bits, thresh=thresh,
                                       tile=tile)
    want = fb.fwd_conv_plain(d_q, pamax, wq, ws, res, tile=tile, h=h,
                             w_img=w, want_stats=stats)
    torch.cuda.synchronize()
    pslab, pamax2 = fb.fwd_int8_pre_plain(x, scale, shift, bits,
                                          thresh=thresh, tile=tile,
                                          plan=plan)
    _same(slab, pslab)
    _same(amax, pamax2)
    assert want[0].float().abs().max().item() > 0
    _same(got[0], want[0])
    if stats:
        _same(got[1], want[1], sums=True)
        _same(got[2], want[2], sums=True)
    else:
        assert got[1] is None and got[2] is None
    for a, b_ in zip(got, again):
        assert (a is None and b_ is None) or torch.equal(a, b_)
    names = ("fused_half_fwd.amax", "fused_half_fwd.pre",
             "fused_half_fwd") + (("fused_half_fwd.sum",) if stats else ())
    assert dict(fb.launches) == {name: 2 for name in names}
    assert dict(fb.seed_launches) == ({names[0]: 2, names[1]: 2}
                                      if mode == "seed" else {})


def test_fused_fwd_int8_takes_widths_the_backward_refuses_before_any_launch(
        dev):
    """6x6 images at batch 64 (a geometry the fused gate admits): the int8
    forward runs there and equals its plain version; ``fused_half_int8``
    in FQT raises, naming the geometry, before its first launch (its int8
    wgrad takes whole images of a multiple of 16 positions); in QAT its
    bf16 backward runs there, the dgrad's three kernels among its
    launches, with finite gradients."""
    c, b, h, w = 32, 64, 6, 6
    n = b * h * w
    g = torch.Generator(device=dev).manual_seed(67)
    x = torch.randn(c, n, device=dev, generator=g).to(torch.bfloat16)
    wt = torch.randn(c, c, 3, 3, device=dev, generator=g) * 0.05
    scale = torch.rand(c, device=dev, generator=g) + 0.5
    shift = torch.randn(c, device=dev, generator=g) * 0.3
    wq, ws = fb.quantize_pack_weights(wt)
    tile = fb.lane_tile(h, w, n, c, c)
    kw = dict(thresh=None, tile=tile, h=h, w_img=w, want_stats=True)
    got = fb.fwd_int8(x, wq, ws, scale, shift, None, None, **kw)
    want = fb.fwd_conv_plain(*fb.fwd_quantize_plain(
        x, scale, shift, None, thresh=None, tile=tile), wq, ws, None,
        tile=tile, h=h, w_img=w, want_stats=True)
    torch.cuda.synchronize()
    _same(got[0], want[0])
    _same(got[1], want[1], sums=True)
    _same(got[2], want[2], sums=True)
    fb.reset_launches()
    with pytest.raises(ValueError, match="geometry H=6 W=6"):
        fb.fused_half_int8(x.clone().requires_grad_(), wt, scale, shift,
                           h=h, w_img=w, quant_bwd=True)
    assert not fb.launches
    leaves = [t.clone().requires_grad_() for t in (x, wt, scale, shift)]
    y, ys, yq = fb.fused_half_int8(*leaves, h=h, w_img=w, quant_bwd=False)
    (y.float().sum() + ys.sum() + yq.sum()).backward()
    torch.cuda.synchronize()
    _same(y.detach(), want[0])
    for name in ("fused_half_fwd", "fused_half_bf16_dgrad.pre",
                 "fused_half_bf16_dgrad", "fused_half_bf16_dgrad.sum",
                 "fused_half_bf16_wgrad"):
        assert fb.launches[name] == 1, name
    for t in leaves:
        assert torch.isfinite(t.grad).all()


# (h, w, cin, width, cout, stride, batch): small shapes (a 7-wide plane,
# 32-channel widths, a batch that is not a power of two, 2x4x4x32), then
# ResNet-50 stage shapes at batch 128 (its four identity blocks and two
# transitions) and WRN-50-2's stage-4 identity block
NV_SHAPES = [(6, 5, 32, 32, 32, 1, 3), (7, 7, 64, 32, 64, 1, 8),
             (6, 6, 32, 32, 96, 2, 4), (5, 7, 64, 32, 128, 2, 2),
             (8, 8, 32, 64, 64, 1, 2), (4, 4, 32, 32, 32, 1, 2),
             (56, 56, 256, 64, 256, 1, 128), (28, 28, 512, 128, 512, 1, 128),
             (14, 14, 1024, 256, 1024, 1, 128),
             (7, 7, 2048, 512, 2048, 1, 128),
             (7, 7, 2048, 1024, 2048, 1, 128),
             (56, 56, 64, 64, 256, 1, 128), (14, 14, 1024, 512, 2048, 2, 128)]


@pytest.mark.parametrize("h,w,cin,wdt,cout,stride,b", NV_SHAPES)
@pytest.mark.parametrize("out_int8", [True, False])
def test_nv_kernels_match_plain(dev, h, w, cin, wdt, cout, stride, b,
                                out_int8):
    g = torch.Generator(device=dev).manual_seed(h * cin + cout)
    proj = cout != cin or stride != 1

    def i8(*shape):
        return torch.randint(-127, 128, shape, device=dev, generator=g,
                             dtype=torch.int8)

    def sc(c, fan):
        return ((torch.rand(c, device=dev, generator=g) + 0.5) * 40
                / (fan ** 0.5 * 127 ** 2 / 3))

    def off(c):
        return torch.rand(c, device=dev, generator=g) * 4 - 2

    x = i8(b, h, w, cin)
    ws = [i8(wdt, cin), i8(wdt, 9 * wdt), i8(cout, wdt)]
    vecs = [sc(wdt, cin), off(wdt), sc(wdt, 9 * wdt), off(wdt),
            sc(cout, wdt), off(cout)]
    name = "bneck_transition_nv" if proj else "bneck_block_nv"
    nv.reset_launches()
    if proj:
        args = (x, *ws, i8(cout, cin), *vecs, sc(cout, cin))
        kw = dict(stride=stride, out_int8=out_int8)
        got = nv.bneck_transition_nv(*args, **kw)
        want = nv.bneck_transition_nv_plain(*args, **kw)
    else:
        args = (x, *ws, *vecs, 0.37)
        got = nv.bneck_block_nv(*args, out_int8=out_int8)
        want = nv.bneck_block_nv_plain(*args, out_int8=out_int8)
    torch.cuda.synchronize()
    assert dict(nv.launches) == {f"{name}.conv1": 1, f"{name}.conv2": 1,
                                 name: 1}
    assert want.unique().numel() > 20
    _same(got, want)
    # bit-equal, and from call to call
    assert torch.equal(got, want)
    again = (nv.bneck_transition_nv(*args, **kw) if proj
             else nv.bneck_block_nv(*args, out_int8=out_int8))
    assert torch.equal(again, got)


@pytest.mark.parametrize("b,h,w,cin,wdt", [(3, 6, 5, 32, 32),
                                           (2, 4, 7, 96, 96),
                                           (128, 14, 14, 1024, 256)])
def test_nv_identity_conv1_writes_every_pad(dev, b, h, w, cin, wdt):
    """The identity block's slab, filled with nonzero bytes before conv1
    (the wrapper's test hook), comes out equal to its plain build: every
    pad byte zero, every position a1."""
    g = torch.Generator(device=dev).manual_seed(b + cin)
    x = torch.randint(-127, 128, (b, h, w, cin), device=dev, generator=g,
                      dtype=torch.int8)
    ws = [torch.randint(-127, 128, s, device=dev, generator=g,
                        dtype=torch.int8)
          for s in ((wdt, cin), (wdt, 9 * wdt), (cin, wdt))]
    vecs = []
    for c, fan in ((wdt, cin), (wdt, 9 * wdt), (cin, wdt)):
        vecs += [(torch.rand(c, device=dev, generator=g) + 0.5) * 40
                 / (fan ** 0.5 * 127 ** 2 / 3),
                 torch.rand(c, device=dev, generator=g) * 4 - 2]
    slabs = []

    def fill(slab):
        slab.fill_(90)
        slabs.append(slab)

    nv._slab_hook = fill
    try:
        got = nv.bneck_block_nv(x, *ws, *vecs, 0.37)
    finally:
        nv._slab_hook = None
    torch.cuda.synchronize()
    assert len(slabs) == 1
    lay = nv.identity_plan(b, h, w, cin, wdt, cin).lay
    want = nv.identity_slab_plain(x, ws[0], vecs[0], vecs[1], lay)
    assert want.shape == slabs[0].shape
    assert torch.equal(slabs[0], want)
    assert torch.equal(got, nv.bneck_block_nv_plain(x, *ws, *vecs, 0.37))


@pytest.mark.parametrize("b,h,w,cin,wdt,cout,stride", [
    (3, 6, 5, 32, 32, 64, 1), (2, 5, 7, 64, 32, 128, 2),
    (3, 6, 6, 32, 96, 64, 2), (2, 7, 4, 96, 64, 32, 2),
    (128, 28, 28, 512, 256, 1024, 2)])
def test_nv_transition_conv1_writes_every_pad(dev, b, h, w, cin, wdt, cout,
                                              stride):
    """The transition's slab (stride 1) or four parity planes (stride 2,
    odd h and w included), filled with nonzero bytes before conv1 (the
    wrapper's test hook), come out equal to their plain build: every pad
    byte zero, every position a1."""
    g = torch.Generator(device=dev).manual_seed(b + cin + stride)

    def i8(*shape):
        return torch.randint(-127, 128, shape, device=dev, generator=g,
                             dtype=torch.int8)

    x = i8(b, h, w, cin)
    ws = [i8(wdt, cin), i8(wdt, 9 * wdt), i8(cout, wdt), i8(cout, cin)]
    vecs = []
    for c, fan in ((wdt, cin), (wdt, 9 * wdt), (cout, wdt)):
        vecs += [(torch.rand(c, device=dev, generator=g) + 0.5) * 40
                 / (fan ** 0.5 * 127 ** 2 / 3),
                 torch.rand(c, device=dev, generator=g) * 4 - 2]
    pp = (torch.rand(cout, device=dev, generator=g) + 0.5) * 40 / (
        cin ** 0.5 * 127 ** 2 / 3)
    slabs = []

    def fill(slab):
        slab.fill_(90)
        slabs.append(slab)

    nv._slab_hook = fill
    try:
        got = nv.bneck_transition_nv(x, *ws, *vecs, pp, stride=stride)
    finally:
        nv._slab_hook = None
    torch.cuda.synchronize()
    assert len(slabs) == 1
    plan = nv.transition_plan(b, h, w, cin, wdt, cout, stride)
    want = nv.transition_slab_plain(x, ws[0], vecs[0], vecs[1], plan)
    assert want.shape == slabs[0].shape == (plan.slab_rows, wdt)
    assert torch.equal(slabs[0], want)
    assert torch.equal(got, nv.bneck_transition_nv_plain(
        x, *ws, *vecs, pp, stride=stride))


def test_nv_cuda_tensor_never_falls_back(dev):
    x = torch.zeros((2, 4, 4, 48), dtype=torch.int8, device=dev)
    ws = [torch.zeros(s, dtype=torch.int8, device=dev)
          for s in ((48, 48), (48, 9 * 48), (48, 48))]
    v = torch.ones(48, device=dev)
    with pytest.raises(ValueError, match="multiples of 32"):
        nv.bneck_block_nv(x, *ws, v, v, v, v, v, v, 1.0)
    x32 = torch.zeros((2, 4, 4, 32), dtype=torch.int8, device=dev)
    w32 = [torch.zeros(s, dtype=torch.int8, device=dev)
           for s in ((32, 32), (32, 9 * 32), (32, 32))]
    with pytest.raises(ValueError, match="contiguous"):
        nv.bneck_block_nv(x32.transpose(1, 2), *w32, *[v[:32]] * 6, 1.0)
    nv.reset_launches()
    with pytest.raises(ValueError, match="vectors"):
        nv.bneck_block_nv(x32, *w32, v[:16], *[v[:32]] * 5, 1.0)
    assert not nv.launches   # raised before the first launch
    # the transition, at both strides: bad channels, a non-contiguous x,
    # wrong vectors (the folded ones or pp), all before the first launch
    v64 = torch.ones(64, device=dev)
    for stride in (1, 2):
        wt = [torch.zeros(s, dtype=torch.int8, device=dev)
              for s in ((48, 48), (48, 9 * 48), (64, 48), (64, 48))]
        with pytest.raises(ValueError, match="multiples of 32"):
            nv.bneck_transition_nv(x, *wt, *[v] * 4, v64, v64, v64,
                                   stride=stride)
        wt = [torch.zeros(s, dtype=torch.int8, device=dev)
              for s in ((32, 32), (32, 9 * 32), (64, 32), (64, 32))]
        x6 = torch.zeros((2, 6, 6, 32), dtype=torch.int8, device=dev)
        with pytest.raises(ValueError, match="contiguous"):
            nv.bneck_transition_nv(x6.transpose(1, 2), *wt, *[v[:32]] * 4,
                                   v64, v64, v64, stride=stride)
        with pytest.raises(ValueError, match="vectors"):
            nv.bneck_transition_nv(x6, *wt, v[:16], *[v[:32]] * 3, v64,
                                   v64, v64, stride=stride)
        with pytest.raises(ValueError, match="vectors"):
            nv.bneck_transition_nv(x6, *wt, *[v[:32]] * 4, v64, v64,
                                   v[:32], stride=stride)
    assert not nv.launches


def test_bneck_nhwc_int8_products_match_plain(dev):
    """The NHWC path's exact int8 1x1 products (torch._int_mm on the card)
    against the float64 products of ``plain=True``: equal logits."""
    from pytorch_ddp_resnet_tpu_torch.models.quantize import (
        Int8Inference,
        calibrate,
    )
    from pytorch_ddp_resnet_tpu_torch.models.resnet import ResNet

    model = ResNet("c3,64,3,1,1 b2 n a ap8,1,0 fc64,10", True, True, 0.0,
                   generator=torch.Generator().manual_seed(0), device=dev)
    x = torch.randn(32, 8, 8, 3, device=dev)
    inf = Int8Inference(model, fused_bneck=False)
    scales = calibrate(inf, [x])
    assert len(scales) == 6
    got = inf.serve_fn(scales)(x)
    want = Int8Inference(model, fused_bneck=False, plain=True).serve_fn(
        scales)(x)
    assert torch.equal(got, want)


# --- the NV bottleneck training halves ------------------------------------------

NVT_HALVES = [("1x1", "identity"), ("1x1", "affine"), ("1x1", "entry"),
              ("3x3", "identity"), ("3x3", "affine")]
# (n, h, w, cin, cout, (fwd, dgrad, wgrad) row chunks): several chunks and
# 3x3 halos across chunk boundaries, channels that are multiples of 8 but
# not of 32, and ResNet-50's stage-3 widths at batch 128
NVT_SHAPES = [(32, 8, 8, 64, 32, (2, 4, 1)), (64, 7, 7, 32, 64, (7, 1, 1)),
              (32, 6, 5, 40, 24, (3, 2, 6)),
              (128, 14, 14, 1024, 256, (2, 1, 2))]
NVT_SUMS = ("zsum", "zssq", "ds", "dt")
# the bf16 bodies also at the staged wgrad's edges: w = 7 with one chunk
# (every K step of 32 positions crosses images), Cin = 64 3x3 halves whose
# 128-row tiles straddle two taps, a 64-row tile (1x1, Cin = 64), Cout = 64
# and 256 (64- and 128-wide tiles), and stage 1's 28 chunks of two rows
NVT_BF16_SHAPES = NVT_SHAPES + [(32, 7, 7, 64, 64, (7, 7, 7)),
                                (64, 14, 14, 64, 256, (2, 2, 2)),
                                (32, 56, 56, 256, 64, (2, 2, 2))]


def _nvt_inputs(dev, conv, mode, n, h, w, cin, cout, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    if conv == "3x3":
        cin = cout = min(cin, 256)

    def rn(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=g) * s

    x = rn(n, h, w, cin).to(torch.bfloat16)
    if mode == "identity":
        x = x.abs()
    k = 3 if conv == "3x3" else 1
    return dict(
        x=x, w=rn(cout, cin, k, k, s=(k * k * cin) ** -0.5),
        s=rn(cin, s=0.5) + 1.0 if mode != "identity" else None,
        t=rn(cin, s=0.2) if mode != "identity" else None,
        res=rn(n, h, w, cin).to(torch.bfloat16) if mode == "entry" else None,
        dy=rn(n, h, w, cout).to(torch.bfloat16), dzsum=rn(cout, s=0.01),
        dzssq=rn(cout, s=0.001),
        dxout=(rn(n, h, w, cin).to(torch.bfloat16) if mode == "entry"
               else None))


@pytest.mark.parametrize("conv,mode", NVT_HALVES)
@pytest.mark.parametrize("n,h,w,cin,cout,rch", NVT_SHAPES)
def test_nv_train_kernels_match_plain(dev, conv, mode, n, h, w, cin, cout,
                                      rch):
    ops = _nvt_inputs(dev, conv, mode, n, h, w, cin, cout, cin + h)
    nvt.reset_launches()
    got = nvt.half_stages(**ops, conv=conv, mode=mode, rch=rch)
    torch.cuda.synchronize()
    assert {k.split(".")[0] for k in nvt.launches} == {
        "nv_half_fwd", "nv_half_bwd", "nv_half_dgrad", "nv_half_wgrad"}
    want = nvt.half_stages(**ops, conv=conv, mode=mode, rch=rch, plain=True)
    assert want["y"].unique().numel() > 100
    for name, ref in want.items():
        if ref is None:
            assert got[name] is None, name
            continue
        _same(got[name], ref, sums=name in NVT_SUMS)


def test_nv_half_op_launches_its_kernels(dev):
    """The differentiable entry half on the card: one launch of each
    kernel, and the same outputs and gradients as the op on the CPU."""
    ops = _nvt_inputs(dev, "1x1", "entry", 32, 8, 8, 64, 32, 1)

    def run(device):
        leaves = {k: ops[k].detach().to(device).requires_grad_()
                  for k in ("x", "w", "s", "t", "res")}
        out = nvt.nv_half_1x1(leaves["x"], leaves["w"], leaves["s"],
                              leaves["t"], leaves["res"], mode="entry",
                              w_img=8)
        loss = ((out[0].float() * ops["dy"].float().to(device)).sum()
                + (out[1] * ops["dzsum"].to(device)).sum()
                + (out[2] * ops["dzssq"].to(device)).sum()
                + (out[3].float() * ops["dxout"].float().to(device)).sum())
        loss.backward()
        return [o.detach().cpu() for o in out] + [
            leaves[k].grad.cpu() for k in ("x", "w", "s", "t", "res")]

    nvt.reset_launches()
    got = run(dev)
    torch.cuda.synchronize()
    assert dict(nvt.launches) == {name: 1 for name in (
        "nv_half_fwd.amax", "nv_half_fwd.pre", "nv_half_fwd",
        "nv_half_fwd.sum", "nv_half_bwd.amax", "nv_half_dgrad.pre",
        "nv_half_dgrad", "nv_half_dgrad.sum",
        "nv_half_wgrad.pre", "nv_half_wgrad", "nv_half_wgrad.sum")}
    want = run("cpu")
    for i, (a, b) in enumerate(zip(got, want)):
        _same(a, b, sums=i in (1, 2, 6, 7))   # zsum, zssq, d(s), d(t)


def test_nv_train_never_falls_back(dev):
    x = torch.zeros((32, 4, 4, 64), device=dev)
    w = torch.zeros((32, 64, 1, 1), device=dev)
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        nvt.nv_half_1x1(x, w, mode="identity", w_img=4)
    x12 = torch.zeros((32, 4, 4, 12), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        nvt.nv_half_1x1(x12, torch.zeros((32, 12, 1, 1), device=dev),
                        mode="identity", w_img=4)
    # the staged int8 wgrad names what it does not take, before any launch
    xb = x.to(torch.bfloat16)
    dy = torch.zeros((32, 4, 4, 32), dtype=torch.bfloat16, device=dev)
    z32, rmax = torch.zeros(32, device=dev), torch.ones(4, device=dev)
    nvt.reset_launches()
    with pytest.raises(ValueError, match="multiple of 8"):
        nvt.wgrad(dy, dy, z32, z32, rmax, x12, None, None, None, rmax,
                  conv="1x1", mode="identity", rch=4)
    with pytest.raises(ValueError, match="does not divide"):
        nvt.wgrad(dy, dy, z32, z32, rmax, xb, None, None, None, rmax,
                  conv="3x3", mode="identity", rch=3)
    with pytest.raises(ValueError, match="row maxima"):
        nvt.wgrad(dy, dy, z32, z32, rmax[:2], xb, None, None, None, rmax,
                  conv="1x1", mode="identity", rch=4)
    lay = nvt.wgrad_int8_layout(32, 4, 4, 9, 2)
    slab = torch.zeros((lay.chunks, 64, lay.lg), dtype=torch.int8,
                       device=dev)
    with pytest.raises(ValueError, match="not of the layout"):
        nvt.wgrad_gemm(slab, slab, rmax, rmax, lay)
    # so does the staged int8 forward
    wq = torch.zeros((32, 64), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        nvt.fwd_conv(x12, None, None, None, rmax, wq[:, :12].contiguous(),
                     z32, conv="1x1", mode="identity", rch=4)
    with pytest.raises(ValueError, match="does not divide"):
        nvt.fwd_conv(xb, None, None, None, rmax, wq, z32, conv="1x1",
                     mode="identity", rch=3)
    with pytest.raises(ValueError, match="row maxima"):
        nvt.fwd_conv(xb, None, None, None, rmax[:2], wq, z32, conv="1x1",
                     mode="identity", rch=4)
    flay = nvt.fwd_int8_layout(32, 4, 4, 64, 9, 2)
    with pytest.raises(ValueError, match="not of the layout"):
        nvt.fwd_gemm(torch.zeros((flay.chunks, 64, 64), dtype=torch.int8,
                                 device=dev), rmax,
                     torch.zeros((32, 9 * 64), dtype=torch.int8, device=dev),
                     z32, flay)
    assert not nvt.launches


def _nvt_bf16_stages(ops, conv, mode, rch, plain, y_bwd=None):
    """The bf16 forward, dgrad and wgrad of one half; the backward on
    ``y_bwd`` (else its own forward's y), so that the kernels and the plain
    versions can take the same y."""
    def pick(name):
        return getattr(nvt, f"{name}_plain" if plain else name)

    x, s, t, res = ops["x"], ops["s"], ops["t"], ops["res"]
    kw = dict(conv=conv, mode=mode)
    y, zsum, zssq, x_res = pick("fwd_conv_bf16")(
        x, s, t, res, nvt.pack_w_bf16(ops["w"]), rch=rch[0], **kw)
    cts = (ops["dy"], y if y_bwd is None else y_bwd, ops["dzsum"],
           ops["dzssq"])
    dx, ds, dt, dres = pick("dgrad_conv_bf16")(
        *cts, nvt.pack_w_bf16_dgrad(ops["w"]), x, s, t, res, ops["dxout"],
        rch=rch[1], **kw)
    dw = pick("wgrad_bf16")(*cts, x, s, t, res, rch=rch[2], **kw)
    return dict(y=y, zsum=zsum, zssq=zssq, x_res=x_res, dx=dx, ds=ds, dt=dt,
                dres=dres, dw=dw)


def _nvt_bf16_agree(got, want):
    for name, ref in want.items():
        if ref is None:
            assert got[name] is None, name
        elif name == "x_res":
            assert torch.equal(got[name], ref)
        elif ref.dtype == torch.bfloat16:
            _bf16_close(got[name], ref)
        else:
            _mma_sums(got[name], ref)


@pytest.mark.parametrize("conv,mode", NVT_HALVES)
@pytest.mark.parametrize("n,h,w,cin,cout,rch", NVT_BF16_SHAPES)
def test_nv_train_bf16_kernels_match_plain(dev, conv, mode, n, h, w, cin,
                                           cout, rch):
    ops = _nvt_inputs(dev, conv, mode, n, h, w, cin, cout, cin + h)
    nvt.reset_launches()
    got = _nvt_bf16_stages(ops, conv, mode, rch, plain=False)
    torch.cuda.synchronize()
    assert {k.split(".")[0] for k in nvt.launches} == {
        "nv_half_fwd_bf16", "nv_half_dgrad_bf16", "nv_half_wgrad_bf16"}
    assert [nvt.launches[f"nv_half_wgrad_bf16{k}"]
            for k in (".pre", "", ".sum")] == [1, 1, 1]
    assert [nvt.launches[f"nv_half_dgrad_bf16{k}"]
            for k in (".pre", "", ".sum")] == [1, 1, int(mode != "identity")]
    want = _nvt_bf16_stages(ops, conv, mode, rch, plain=True,
                            y_bwd=got["y"])
    assert want["y"].unique().numel() > 100
    _nvt_bf16_agree(got, want)


@pytest.mark.parametrize("quant,quant_bwd", [(True, False), (False, False),
                                             (False, True)])
@pytest.mark.parametrize("conv,mode", [("1x1", "entry"), ("3x3", "affine")])
def test_nv_half_op_runs_every_body_on_the_card(dev, quant, quant_bwd, conv,
                                                mode):
    """The op in each (quant, quant_bwd) mode launches the kernels of its
    bodies only, and its outputs and gradients agree with the same op's
    on CPU copies (plain versions): int8 outputs equal, bf16 ones within
    2 ulps, sums and gradients through the tensor cores within 1e-4 (the
    int8 backward of the bf16 forward sees the card's y, which may round
    apart from the CPU's: within 1e-4 too)."""
    ops = _nvt_inputs(dev, conv, mode, 64, 8, 8, 64, 64 if conv == "3x3"
                      else 32, 2)
    entry = mode == "entry"

    def run(device):
        leaves = {k: ops[k].detach().to(device).requires_grad_()
                  for k in ("x", "w", "s", "t", "res") if ops[k] is not None}
        kw = dict(mode=mode, w_img=8, quant=quant, quant_bwd=quant_bwd)
        out = (nvt.nv_half_1x1(leaves["x"], leaves["w"], leaves["s"],
                               leaves["t"], leaves["res"], **kw)
               if conv == "1x1" else
               nvt.nv_half_3x3(leaves["x"], leaves["w"], leaves["s"],
                               leaves["t"], **kw))
        loss = ((out[0].float() * ops["dy"].float().to(device)).sum()
                + (out[1] * ops["dzsum"].to(device)).sum()
                + (out[2] * ops["dzssq"].to(device)).sum())
        if entry:
            loss = loss + (out[3].float()
                           * ops["dxout"].float().to(device)).sum()
        loss.backward()
        return [o.detach().cpu() for o in out] + [
            leaves[k].grad.cpu() for k in sorted(leaves)]

    nvt.reset_launches()
    got = run(dev)
    torch.cuda.synchronize()
    fwd = ({"nv_half_fwd.amax", "nv_half_fwd.pre", "nv_half_fwd",
            "nv_half_fwd.sum"} if quant
           else {"nv_half_fwd_bf16", "nv_half_fwd_bf16.sum"})
    bwd = ({"nv_half_fwd.amax", "nv_half_bwd.amax", "nv_half_dgrad.pre",
            "nv_half_dgrad", "nv_half_dgrad.sum", "nv_half_wgrad.pre",
            "nv_half_wgrad", "nv_half_wgrad.sum"}
           if quant_bwd else {"nv_half_dgrad_bf16.pre", "nv_half_dgrad_bf16",
                              "nv_half_dgrad_bf16.sum",
                              "nv_half_wgrad_bf16.pre", "nv_half_wgrad_bf16",
                              "nv_half_wgrad_bf16.sum"})
    assert set(nvt.launches) == fwd | bwd
    want = run("cpu")
    for i, (a, b) in enumerate(zip(got, want)):
        if (i == 0 and quant) or (i == 3 and entry):   # int8 y, x_res
            assert torch.equal(a, b), i
        elif a.dtype == torch.bfloat16:
            _bf16_close(a, b)
        else:
            _mma_sums(a, b)


def test_nv_train_bf16_never_falls_back(dev):
    """The bf16 kernels raise on what they do not take (no plain version
    on a CUDA tensor): f32 operands, channels that are not multiples of 8,
    a 3x3 entry half."""
    x = torch.zeros((32, 4, 4, 64), device=dev)
    w = torch.zeros((32, 64, 1, 1), device=dev)
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        nvt.nv_half_1x1(x, w, mode="identity", w_img=4, quant=False,
                        quant_bwd=False)
    x12 = torch.zeros((32, 4, 4, 12), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        nvt.fwd_conv_bf16(x12, None, None, None, nvt.pack_w_bf16(
            torch.zeros((16, 12, 1, 1), device=dev)), conv="1x1",
            mode="identity", rch=4)
    xb = x.to(torch.bfloat16)
    v = torch.ones(64, device=dev)
    with pytest.raises(ValueError, match="entry mode is a 1x1 half"):
        nvt.fwd_conv_bf16(xb, v, v, xb, nvt.pack_w_bf16(
            torch.zeros((64, 64, 3, 3), device=dev)), conv="3x3",
            mode="entry", rch=4)
    dy = torch.zeros((32, 4, 4, 32), dtype=torch.bfloat16, device=dev)
    z = torch.zeros(32, device=dev)
    nvt.reset_launches()
    with pytest.raises(ValueError, match="weights"):
        nvt.dgrad_conv_bf16(dy, dy, z, z, nvt.pack_w_bf16(w), xb, None,
                            None, None, None, conv="1x1", mode="identity",
                            rch=4)
    # the slab route names what it does not take, before any launch
    wdg = nvt.pack_w_bf16_dgrad(w)
    with pytest.raises(ValueError, match="does not divide"):
        nvt.dgrad_conv_bf16(dy, dy, z, z, wdg, xb, None, None, None, None,
                            conv="1x1", mode="identity", rch=3)
    with pytest.raises(ValueError, match="the layout's"):
        nvt.dgrad_conv_bf16(dy, dy, z, z, wdg, xb[:, :2].contiguous(), None,
                            None, None, None, conv="1x1", mode="identity",
                            rch=4)
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        nvt.dgrad_conv_bf16(dy, dy, z, z, wdg, x, None, None, None, None,
                            conv="1x1", mode="identity", rch=4)
    lay = nvt.dgrad_bf16_layout(32, 4, 4, 32, 1)
    with pytest.raises(ValueError, match="not of the layout"):
        nvt.dgrad_bf16_gemm(torch.zeros((1, 64, lay.cp), dtype=torch.bfloat16,
                                        device=dev), wdg, xb, None, None,
                            None, None, lay, mode="identity")
    assert not nvt.launches
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        nvt.wgrad_bf16(dy.float(), dy, z, z, xb, None, None, None,
                       conv="1x1", mode="identity", rch=4)
    # the staged wgrad names what it does not take, before any launch
    nvt.reset_launches()
    with pytest.raises(ValueError, match="multiple of 8"):
        nvt.wgrad_bf16(dy, dy, z, z, x12, None, None, None, conv="1x1",
                       mode="identity", rch=4)
    with pytest.raises(ValueError, match="does not divide"):
        nvt.wgrad_bf16(dy, dy, z, z, xb, None, None, None, conv="1x1",
                       mode="identity", rch=3)
    with pytest.raises(ValueError, match="one plane"):
        nvt.wgrad_bf16_gemm(xb, dy[:, :2].contiguous(), conv="1x1", rch=4)
    with pytest.raises(ValueError, match="multiple of 8"):
        nvt.wgrad_bf16_gemm(x12, dy, conv="3x3", rch=4)
    assert not nvt.launches


@pytest.mark.parametrize("conv,mode,n,h,w,cin,cout,rch", [
    ("3x3", "affine", 128, 28, 28, 128, 128, 7),
    ("1x1", "entry", 128, 56, 56, 256, 64, 2)])
def test_nv_wgrad_bf16_is_deterministic(dev, conv, mode, n, h, w, cin, cout,
                                        rch):
    """The staged bf16 wgrad adds its split tiles, then its chunks, in a
    fixed order with no atomics: two calls on the same inputs give the same
    dW bit for bit (here over 4 x 15 and 28 x 10 (chunk, split) tiles), and
    each launches the prepass, the mainloop and the sum once."""
    ops = _nvt_inputs(dev, conv, mode, n, h, w, cin, cout, 7)
    y = torch.randn(n, h, w, cout, device=dev).to(torch.bfloat16)
    args = (ops["dy"], y, ops["dzsum"], ops["dzssq"], ops["x"], ops["s"],
            ops["t"], ops["res"])
    plan = nvt.wgrad_bf16_plan(n, h, w, ops["x"].shape[-1], cout,
                               9 if conv == "3x3" else 1, rch)
    assert plan.chunks > 1 and plan.splits > 1, plan
    nvt.reset_launches()
    first = nvt.wgrad_bf16(*args, conv=conv, mode=mode, rch=rch)
    second = nvt.wgrad_bf16(*args, conv=conv, mode=mode, rch=rch)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert dict(nvt.launches) == {"nv_half_wgrad_bf16.pre": 2,
                                  "nv_half_wgrad_bf16": 2,
                                  "nv_half_wgrad_bf16.sum": 2}
    _mma_sums(first, nvt.wgrad_bf16_plain(*args, conv=conv, mode=mode,
                                          rch=rch))


# the staged int8 wgrad at its edges: w = 7 with one chunk (K steps of 128
# positions crossing rows and images), n = 20 (padded to 32 images) with
# several chunks, Cin = 64 (3x3 halves' 128-row tiles straddle two taps; a
# 1x1 on a 64-row tile), Cout = 64, 24 (< the tile) and 256 (128-wide
# tiles), and stage 3's widths at batch 128
NVT_S8_SHAPES = [(32, 7, 7, 64, 64, 7), (20, 6, 6, 64, 24, 2),
                 (20, 7, 7, 64, 256, 1), (128, 14, 14, 256, 256, 7)]


def _nvt_wgrad_args(dev, conv, mode, n, h, w, cin, cout, seed):
    """The int8 wgrad's operands, y drawn, the row maxima by the plain
    versions (so the only launches are the wgrad's)."""
    ops = _nvt_inputs(dev, conv, mode, n, h, w, cin, cout, seed)
    y = torch.randn(ops["dy"].shape, device=dev).to(torch.bfloat16)
    x, s, t, res = ops["x"], ops["s"], ops["t"], ops["res"]
    rowmax_a = nvt.fwd_rowmax_plain(x, s, t, res, mode=mode)[0]
    rowmax_g = nvt.bwd_rowmax_plain(ops["dy"], y, ops["dzsum"],
                                    ops["dzssq"])
    return (ops["dy"], y, ops["dzsum"], ops["dzssq"], rowmax_g, x, s, t, res,
            rowmax_a)


@pytest.mark.parametrize("conv,mode", NVT_HALVES)
@pytest.mark.parametrize("n,h,w,cin,cout,rch", NVT_S8_SHAPES)
def test_nv_wgrad_int8_staged_matches_plain(dev, conv, mode, n, h, w, cin,
                                            cout, rch):
    """The prepass's slabs equal the plain version's byte for byte, and dW
    equals ``wgrad_plain`` (exact s32 per chunk, the chunks in order): one
    launch each of the prepass, the mainloop and the sum."""
    args = _nvt_wgrad_args(dev, conv, mode, n, h, w, cin, cout, cin + h)
    kw = dict(conv=conv, mode=mode, rch=rch)
    nvt.reset_launches()
    dw = nvt.wgrad(*args, **kw)
    torch.cuda.synchronize()
    assert dict(nvt.launches) == {"nv_half_wgrad.pre": 1,
                                  "nv_half_wgrad": 1, "nv_half_wgrad.sum": 1}
    assert torch.equal(dw, nvt.wgrad_plain(*args, **kw))
    assert dw.abs().max().item() > 0
    for got, want in zip(nvt.wgrad_pre(*args, **kw),
                         nvt.wgrad_pre_plain(*args, **kw)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("conv,mode,n,h,w,cin,cout,rch", [
    ("3x3", "affine", 128, 28, 28, 128, 128, 7),
    ("1x1", "entry", 128, 56, 56, 256, 64, 2)])
def test_nv_wgrad_int8_is_deterministic(dev, conv, mode, n, h, w, cin, cout,
                                        rch):
    """The staged int8 wgrad adds each chunk's s32 split tiles exactly and
    the chunks in a fixed order, with no atomics: two calls on the same
    inputs give the same dW bit for bit, equal to the plain version, over
    several (chunk, split) tiles."""
    args = _nvt_wgrad_args(dev, conv, mode, n, h, w, cin, cout, 7)
    plan = nvt.wgrad_int8_plan(n, h, w, args[5].shape[-1], cout,
                               9 if conv == "3x3" else 1, rch)
    assert plan.chunks > 1 and plan.splits > 1, plan
    nvt.reset_launches()
    first = nvt.wgrad(*args, conv=conv, mode=mode, rch=rch)
    second = nvt.wgrad(*args, conv=conv, mode=mode, rch=rch)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert dict(nvt.launches) == {"nv_half_wgrad.pre": 2,
                                  "nv_half_wgrad": 2, "nv_half_wgrad.sum": 2}
    assert torch.equal(first, nvt.wgrad_plain(*args, conv=conv, mode=mode,
                                              rch=rch))


# the staged int8 forward at NVT_SHAPES (forward row chunks) and its edges:
# stage 1 at n = 32 (56 x 56, Cin 256 -> 64 1x1 halves, the 3x3 with 4-row
# chunks, Cin 64 -> 256), w = 7 with one chunk, Cin = 64 -> Cout = 256 at
# 14 x 14
NVT_FWD_CASES = [(conv, mode, n, h, w, cin, cout, rch[0])
                 for n, h, w, cin, cout, rch in NVT_SHAPES
                 for conv, mode in NVT_HALVES] + [
    ("1x1", "identity", 32, 56, 56, 256, 64, 1),
    ("1x1", "entry", 32, 56, 56, 256, 64, 2),
    ("3x3", "affine", 32, 56, 56, 64, 64, 4),
    ("1x1", "affine", 32, 56, 56, 64, 256, 2),
    ("3x3", "identity", 32, 7, 7, 64, 64, 7),
    ("1x1", "entry", 32, 7, 7, 64, 64, 7),
    ("1x1", "affine", 64, 14, 14, 64, 256, 2)]


def _nvt_fwd_args(dev, conv, mode, n, h, w, cin, cout, seed):
    """The int8 forward's operands (x, s, t, res, rowmax) and weights (wq,
    ws), the row maxima by the plain version (so the only launches are the
    forward's)."""
    ops = _nvt_inputs(dev, conv, mode, n, h, w, cin, cout, seed)
    x, s, t, res = ops["x"], ops["s"], ops["t"], ops["res"]
    wq, ws = (nvt.quantize_w_3x3 if conv == "3x3"
              else nvt.quantize_w_1x1)(ops["w"])
    rowmax = nvt.fwd_rowmax_plain(x, s, t, res, mode=mode)[0]
    return (x, s, t, res, rowmax), wq, ws


@pytest.mark.parametrize("conv,mode,n,h,w,cin,cout,rch", NVT_FWD_CASES)
def test_nv_fwd_int8_staged_matches_plain(dev, conv, mode, n, h, w, cin,
                                          cout, rch):
    """The prepass's slabs equal the plain version's byte for byte, y
    equals ``fwd_conv_plain``'s and its sums agree within 1e-5: one launch
    each of the prepass, the mainloop and the sum."""
    args, wq, ws = _nvt_fwd_args(dev, conv, mode, n, h, w, cin, cout,
                                 cin + h)
    kw = dict(conv=conv, mode=mode, rch=rch)
    nvt.reset_launches()
    got = nvt.fwd_conv(*args, wq, ws, **kw)
    torch.cuda.synchronize()
    assert dict(nvt.launches) == {"nv_half_fwd.pre": 1, "nv_half_fwd": 1,
                                  "nv_half_fwd.sum": 1}
    want = nvt.fwd_conv_plain(*args, wq, ws, **kw)
    assert want[0].unique().numel() > 100
    for i, (a, b) in enumerate(zip(got, want)):
        _same(a, b, sums=i > 0)
    assert torch.equal(nvt.fwd_pre(*args, **kw), nvt.fwd_pre_plain(*args,
                                                                   **kw))


@pytest.mark.parametrize("conv,mode,n,h,w,cin,cout,rch", [
    ("3x3", "affine", 128, 56, 56, 64, 64, 4),
    ("1x1", "entry", 128, 28, 28, 512, 128, 2)])
def test_nv_fwd_int8_is_deterministic(dev, conv, mode, n, h, w, cin, cout,
                                      rch):
    """The staged int8 forward's y is exact s32 products dequantized, and
    its sums are added in a fixed order with no atomics: two calls on the
    same inputs give the same y and sums bit for bit, y equal to the plain
    version's."""
    args, wq, ws = _nvt_fwd_args(dev, conv, mode, n, h, w, cin, cout, 7)
    kw = dict(conv=conv, mode=mode, rch=rch)
    nvt.reset_launches()
    first = nvt.fwd_conv(*args, wq, ws, **kw)
    second = nvt.fwd_conv(*args, wq, ws, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert dict(nvt.launches) == {"nv_half_fwd.pre": 2, "nv_half_fwd": 2,
                                  "nv_half_fwd.sum": 2}
    assert torch.equal(first[0], nvt.fwd_conv_plain(*args, wq, ws, **kw)[0])


# the int8 input gradient at NVT_SHAPES (dgrad row chunks) and its edges:
# stage 1 at n = 32 (56 x 56: Cin 256 <- Cout 64 1x1 halves on 128-wide N
# tiles and 64-byte K boxes, the 3x3 at 64 channels with 2-row chunks, Cin
# 64 <- Cout 256), w = 7 with one chunk, Cin = 1024 <- Cout = 256 at 14 x
# 14 (eight N tiles)
NVT_DGRAD_CASES = [(conv, mode, n, h, w, cin, cout, rch[1])
                   for n, h, w, cin, cout, rch in NVT_SHAPES
                   for conv, mode in NVT_HALVES] + [
    ("1x1", "identity", 32, 56, 56, 256, 64, 2),
    ("1x1", "entry", 32, 56, 56, 256, 64, 1),
    ("3x3", "affine", 32, 56, 56, 64, 64, 2),
    ("1x1", "affine", 32, 56, 56, 64, 256, 2),
    ("3x3", "identity", 32, 7, 7, 64, 64, 7),
    ("1x1", "entry", 32, 7, 7, 64, 64, 7),
    ("1x1", "affine", 64, 14, 14, 256, 1024, 2)]


def _nvt_dgrad_args(dev, conv, mode, n, h, w, cin, cout, seed):
    """The int8 input gradient's arguments (dy, y, dzsum, dzssq, rowmax_g,
    wq_dg, ws_in, x, s, t, res, dxout), y drawn, the row maxima by the
    plain version (so the only launches are the dgrad's)."""
    ops = _nvt_inputs(dev, conv, mode, n, h, w, cin, cout, seed)
    y = torch.randn(ops["dy"].shape, device=dev).to(torch.bfloat16)
    wq_dg, ws_in = (nvt.quantize_w_3x3_dgrad if conv == "3x3"
                    else nvt.quantize_w_1x1_dgrad)(ops["w"])
    rowmax_g = nvt.bwd_rowmax_plain(ops["dy"], y, ops["dzsum"],
                                    ops["dzssq"])
    return (ops["dy"], y, ops["dzsum"], ops["dzssq"], rowmax_g, wq_dg, ws_in,
            ops["x"], ops["s"], ops["t"], ops["res"], ops["dxout"])


def _nvt_dgrad_same(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None, i
        else:
            _same(a, b, sums=i in (1, 2))   # d(s), d(t)


@pytest.mark.parametrize("conv,mode,n,h,w,cin,cout,rch", NVT_DGRAD_CASES)
def test_nv_dgrad_int8_wgmma_matches_plain(dev, conv, mode, n, h, w, cin,
                                           cout, rch):
    """The prepass's slabs equal the plain version's byte for byte; dx and
    dres equal ``dgrad_conv_plain``'s, d(s) and d(t) within 1e-5; two calls
    bit-equal: one launch each of the prepass, the wgmma GEMM and (but in
    identity mode) the tiles' sum."""
    args = _nvt_dgrad_args(dev, conv, mode, n, h, w, cin, cout, cin + h)
    kw = dict(conv=conv, mode=mode, rch=rch)
    nvt.reset_launches()
    got = nvt.dgrad_conv(*args, **kw)
    torch.cuda.synchronize()
    want_launches = {"nv_half_dgrad.pre": 1, "nv_half_dgrad": 1}
    if mode != "identity":
        want_launches["nv_half_dgrad.sum"] = 1
    assert dict(nvt.launches) == want_launches
    want = nvt.dgrad_conv_plain(*args, **kw)
    assert want[0].unique().numel() > 100
    _nvt_dgrad_same(got, want)
    again = nvt.dgrad_conv(*args, **kw)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)
    pre = dict(conv=conv, rch=rch)
    assert torch.equal(nvt.dgrad_pre(*args[:5], **pre),
                       nvt.dgrad_pre_plain(*args[:5], **pre))


@pytest.mark.parametrize("conv,mode,n,h,w,cin,cout,rch", [
    ("3x3", "affine", 128, 28, 28, 128, 128, 4),
    ("1x1", "entry", 128, 56, 56, 256, 64, 1)])
def test_nv_dgrad_int8_is_deterministic(dev, conv, mode, n, h, w, cin, cout,
                                        rch):
    """At ResNet-50's stage shapes (batch 128, many chunks and tiles) the
    int8 input gradient's dx is exact s32 products dequantized, and its
    sums are added in a fixed order with no atomics: two calls on the same
    inputs give the same outputs bit for bit, dx and dres equal to the
    plain version's."""
    args = _nvt_dgrad_args(dev, conv, mode, n, h, w, cin, cout, 7)
    kw = dict(conv=conv, mode=mode, rch=rch)
    first = nvt.dgrad_conv(*args, **kw)
    second = nvt.dgrad_conv(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert (a is None and b is None) or torch.equal(a, b)
    _nvt_dgrad_same(first, nvt.dgrad_conv_plain(*args, **kw))


def test_nv_dgrad_int8_never_falls_back(dev):
    """The int8 input gradient names what its kernels do not take, before
    any launch."""
    args = list(_nvt_dgrad_args(dev, "1x1", "affine", 32, 4, 4, 64, 32, 3))
    kw = dict(conv="1x1", mode="affine", rch=2)
    nvt.reset_launches()
    with pytest.raises(ValueError, match="does not divide"):
        nvt.dgrad_conv(*args, conv="1x1", mode="affine", rch=3)
    bad = list(args)
    bad[4] = args[4][:2].contiguous()
    with pytest.raises(ValueError, match="row maxima"):
        nvt.dgrad_conv(*bad, **kw)
    bad = list(args)
    bad[5] = args[5][:, :16].contiguous()
    with pytest.raises(ValueError, match="weights"):
        nvt.dgrad_conv(*bad, **kw)
    bad = list(args)
    bad[7] = args[7].float()
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        nvt.dgrad_conv(*bad, **kw)
    lay = nvt.fwd_int8_layout(32, 4, 4, 32, 1, 2)
    with pytest.raises(ValueError, match="not of the layout"):
        nvt.dgrad_gemm(torch.zeros((lay.chunks, 64, lay.cp),
                                   dtype=torch.int8, device=dev), args[4],
                       *args[5:], lay, mode="affine")
    assert not nvt.launches


def _nvt_dgrad_bf16_args(dev, conv, mode, n, h, w, cin, cout, seed):
    """The bf16 input gradient's arguments (dy, y, dzsum, dzssq, wb_dg, x,
    s, t, res, dxout), y drawn."""
    ops = _nvt_inputs(dev, conv, mode, n, h, w, cin, cout, seed)
    y = torch.randn(ops["dy"].shape, device=dev).to(torch.bfloat16)
    return (ops["dy"], y, ops["dzsum"], ops["dzssq"],
            nvt.pack_w_bf16_dgrad(ops["w"]), ops["x"], ops["s"], ops["t"],
            ops["res"], ops["dxout"])


def _nvt_dgrad_bf16_close(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None, i
        elif i in (1, 2):   # d(s), d(t): over the tensor cores' accumulators
            _mma_sums(a, b)
        else:
            _bf16_close(a, b)


@pytest.mark.parametrize("conv,mode,n,h,w,cin,cout,rch", NVT_DGRAD_CASES)
def test_nv_dgrad_bf16_wgmma_matches_plain(dev, conv, mode, n, h, w, cin,
                                           cout, rch):
    """The bf16 input gradient's slab equals its plain version's bit for
    bit; dx and dres within 2 bf16 ulps of ``dgrad_conv_bf16_plain``'s,
    d(s) and d(t) within 1e-4; two calls bit-equal: one launch each of the
    prepass, the wgmma GEMM and (but in identity mode) the tiles' sum."""
    args = _nvt_dgrad_bf16_args(dev, conv, mode, n, h, w, cin, cout,
                                cin + h)
    kw = dict(conv=conv, mode=mode, rch=rch)
    nvt.reset_launches()
    got = nvt.dgrad_conv_bf16(*args, **kw)
    torch.cuda.synchronize()
    want_launches = {"nv_half_dgrad_bf16.pre": 1, "nv_half_dgrad_bf16": 1}
    if mode != "identity":
        want_launches["nv_half_dgrad_bf16.sum"] = 1
    assert dict(nvt.launches) == want_launches
    want = nvt.dgrad_conv_bf16_plain(*args, **kw)
    assert want[0].unique().numel() > 100
    _nvt_dgrad_bf16_close(got, want)
    again = nvt.dgrad_conv_bf16(*args, **kw)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)
    assert torch.equal(nvt.dgrad_bf16_pre(*args[:4], conv=conv),
                       nvt.dgrad_bf16_pre_plain(*args[:4], conv=conv))


def test_weight_scales_on_the_card_equal_the_cpu(dev):
    """The int8 weight quantizers divide by 127 truly on the card too (the
    CPU tests hold the CPU's scales equal to JAX's); a Python-float divisor
    would be a multiply by f32(1/127) there and move some scales by an
    ulp."""
    g = torch.Generator().manual_seed(0)
    w1 = torch.randn(512, 1024, 1, 1, generator=g) * 0.05
    w3 = torch.randn(256, 256, 3, 3, generator=g) * 0.05
    for fn, w in ((nvt.quantize_w_1x1, w1), (nvt.quantize_w_1x1_dgrad, w1),
                  (nvt.quantize_w_3x3, w3), (nvt.quantize_w_3x3_dgrad, w3),
                  (fb.quantize_pack_weights, w3),
                  (fb.quantize_pack_weights_dgrad, w3)):
        for a, b in zip(fn(w.to(dev)), fn(w)):
            assert torch.equal(a.cpu(), b), fn.__name__


def test_fused_half_takes_the_widths_the_gate_admits(dev):
    """C = 48 without dropout (the gate's C % 16 case): the half runs
    zero-padded to 64 channels on the kernels, and its output and
    gradients equal the same op's on CPU copies (plain versions; on the
    CPU the padded half equals the unpadded one exactly:
    tests/test_torch_fused_half_bf16.py)."""
    c, h, w, n = 48, 8, 8, 1024
    g = torch.Generator(device=dev).manual_seed(48)
    card = [torch.randn(c, n, device=dev, generator=g).to(torch.bfloat16),
            torch.randn(c, c, 3, 3, device=dev, generator=g) * 0.05,
            torch.rand(c, device=dev, generator=g) + 0.5,
            torch.randn(c, device=dev, generator=g) * 0.3,
            torch.randn(c, n, device=dev, generator=g).to(torch.bfloat16)]
    cpu = [t.cpu() for t in card]
    outs = []
    for ts, dvc in ((card, dev), (cpu, torch.device("cpu"))):
        ts = [t.clone().requires_grad_() for t in ts]
        x, wt, scale, shift, res = ts
        fb.reset_launches()
        y, ys, yq = fb.fused_half(x, wt, scale, shift, None, res, h=h,
                                  w_img=w)
        dy = torch.linspace(-1e-2, 1e-2, c * n, device=dvc).reshape(c, n)
        ((y.float() * dy).sum() + ys.sum() * 1e-3
         + yq.sum() * 1e-4).backward(inputs=ts)
        outs.append([t.detach().cpu() for t in (y, ys, yq)]
                    + [t.grad.cpu() for t in ts])
        if dvc == dev:
            torch.cuda.synchronize()
            assert fb.launches["fused_half_bf16_fwd"] == 1
            assert fb.launches["fused_half_bf16_dgrad"] == 1
    got, want = outs
    _bf16_close(got[0], want[0])
    _mma_sums(got[1], want[1])
    _mma_sums(got[2], want[2])
    for a, b in zip(got[3:], want[3:]):
        assert a.shape == b.shape
        assert (a.float() - b.float()).abs().max() <= 1e-2 * b.float().abs(
        ).max()


# --- the lane-through stage transition ---------------------------------------------

# (batch, h, w, cin, cout): the test shape, then WRN-28-10's two transitions
# at small batches
TR_SHAPES = [(8, 16, 16, 32, 64), (4, 32, 32, 160, 320),
             (8, 16, 16, 320, 640)]


def _tr_inputs(dev, b, h, w, cin, cout, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    n = b * h * w

    def rn(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=g) * s

    bits = torch.randint(0, 256, (4 * cin, n // 4), device=dev, generator=g,
                         dtype=torch.uint8)
    return dict(x=rn(cin, n).to(torch.bfloat16),
                w1=rn(cout, cin, 3, 3, s=(9 * cin) ** -0.5),
                wp=rn(cout, cin, s=cin ** -0.5).to(torch.bfloat16),
                scale=rn(cin).abs() + 0.5, shift=rn(cin, s=0.3),
                bits=tr.parity_unpack(bits, h, w),
                dz=rn(cout, n // 4, s=1e-3).to(torch.bfloat16),
                dzsum=rn(cout, s=1e-4), dzssq=rn(cout, s=1e-4),
                dres=rn(cout, n // 4, s=1e-3).to(torch.bfloat16))


@pytest.mark.parametrize("b,h,w,cin,cout", TR_SHAPES)
@pytest.mark.parametrize("use_proj,rate", [(True, 0.3), (True, 0.0),
                                           (False, 0.3)])
def test_transition_kernels_match_plain(dev, b, h, w, cin, cout, use_proj,
                                        rate):
    """Forward, both backward bodies and dWp against their plain versions
    on the same CUDA tensors: int8 codes, group absmaxes, z and the FQT dW
    equal; res and dx within 2 bf16 ulps; f32 sums within 1e-5 (1e-4 over
    bf16 tensor-core accumulators)."""
    t = _tr_inputs(dev, b, h, w, cin, cout, b + cin)
    x, scale, shift = t["x"], t["scale"], t["shift"]
    bits = t["bits"] if rate > 0 else None
    thresh = fb.dropout_thresh(rate) if rate > 0 else None
    wp = t["wp"] if use_proj else None
    wpt = wp.t().contiguous() if use_proj else None
    n = x.shape[1]
    tile = tr.transition_tile(h // 2, w // 2, n // 4, cin, cout)
    kw = dict(h=h, w_img=w)
    wq, ws = fb.quantize_pack_weights(t["w1"])
    pd_q, pamax = fb.fwd_quantize_plain(x, scale, shift, bits, thresh=thresh,
                                        tile=4 * tile)
    got = tr.fwd_conv(x, scale, shift, bits, wq, ws, wp, thresh=thresh,
                      tile=tile, **kw)
    want = tr.fwd_conv_plain(pd_q, pamax, wq, ws, x, wp, tile=tile, **kw)
    _same(got[0], want[0])
    _same(got[1], want[1], sums=True)
    _same(got[2], want[2], sums=True)
    (_bf16_close if use_proj else _same)(got[3], want[3])
    _same(got[4], pamax)
    ct = (t["dz"], want[0], t["dzsum"], t["dzssq"])
    scb = (x, scale, shift, bits)
    # the activation quantized at the forward's group absmax
    ops = tr.bwd_quantize(*ct, *scb, got[4], thresh=thresh, tile=tile, **kw)
    ops_p = tr.bwd_quantize_plain(*ct, *scb, thresh=thresh, tile=tile, **kw)
    for a, b_ in zip(ops, ops_p):
        _same(a, b_)
    g_q, g_amax, dq2, d_amax, x_ee = ops_p
    wdq, wsin = tr.quant_pack_w_dgrad(t["w1"])
    dargs = (g_q, g_amax, wdq, wsin, *scb, t["dres"], wpt)
    got = tr.dgrad(*dargs, thresh=thresh, tile=tile, **kw)
    want = tr.dgrad_plain(*dargs, thresh=thresh, tile=tile, **kw)
    _bf16_close(got[0], want[0])
    _same(got[1], want[1], sums=True)
    _same(got[2], want[2], sums=True)
    _same(tr.wgrad(g_q, g_amax, dq2, d_amax, tile=tile, **kw),
          tr.wgrad_plain(g_q, g_amax, dq2, d_amax, tile=tile, **kw))
    fold = tr.bwd_fold(*ct, *scb, thresh=thresh, **kw)
    for a, b_ in zip(fold, tr.bwd_fold_plain(*ct, *scb, thresh=thresh,
                                             **kw)):
        _same(a, b_)
    gb, db, _ = fold
    dargs = (gb, None, tr.pack_w_dgrad(t["w1"].to(torch.bfloat16)), None,
             *scb, t["dres"], wpt)
    got = tr.dgrad(*dargs, thresh=thresh, tile=tile, **kw)
    want = tr.dgrad_plain(*dargs, thresh=thresh, tile=tile, **kw)
    _bf16_close(got[0], want[0])
    _mma_sums(got[1], want[1])
    _mma_sums(got[2], want[2])
    _mma_sums(tr.wgrad_bf16(gb, db, **kw), tr.wgrad_bf16_plain(gb, db, **kw))
    _mma_sums(tr.wgrad_proj(t["dres"], x_ee, **kw),
              tr.wgrad_proj_plain(t["dres"], x_ee, **kw))
    torch.cuda.synchronize()


@pytest.mark.parametrize("quant_bwd", [True, False])
def test_transition_op_launches_its_kernels(dev, quant_bwd):
    """The differentiable op on the card: one launch of each kernel, and
    outputs and gradients as the same op on the CPU (plain versions)."""
    b, h, w, cin, cout = TR_SHAPES[0]
    t = _tr_inputs(dev, b, h, w, cin, cout, 3)
    bits = tr.parity_pack(t["bits"], h, w)
    res = []
    for dvc in (dev, torch.device("cpu")):
        ins = [v.to(dvc).clone().requires_grad_() for v in (
            t["x"], t["w1"], t["wp"].float().reshape(cout, cin, 1, 1),
            t["scale"], t["shift"])]
        tr.reset_launches()
        fb.reset_launches()
        out = tr.transition_half_int8(*ins, bits.to(dvc), dropout_rate=0.3,
                                      h=h, w_img=w, quant_bwd=quant_bwd)
        cts = [t[k].to(dvc) for k in ("dz", "dzsum", "dzssq", "dres")]
        grads = torch.autograd.grad(out, ins, cts)
        res.append([v.detach().cpu() for v in out]
                   + [v.cpu() for v in grads])
        if dvc == dev:
            torch.cuda.synchronize()
            # the FQT operands in one launch
            bwd = (("transition_bwd.quant",) if quant_bwd
                   else ("transition_bwd.fold",))
            # the FQT dW on the TMA + s8 wgmma wgrad (one launch, no
            # sum), the straight-through one on the TMA wgrad; dWp on the
            # TMA wgrad
            wg = (("transition_wgrad_s8",) if quant_bwd
                  else ("transition_wgrad_tma", "transition_wgrad_tma.sum"))
            # the dgrad: g and dres into their slabs, the wgmma GEMM of
            # the four parity classes, its tiles' sums
            assert dict(tr.launches) == {name: 1 for name in (
                "transition_fwd.amax", "transition_fwd.pre",
                "transition_fwd", "transition_fwd.sum",
                "transition_dgrad.pre", "transition_dgrad",
                "transition_dgrad.sum", "transition_wgrad_tma.proj",
                "transition_wgrad_tma.proj_sum") + bwd + wg}
            assert not fb.launches
        else:
            assert not tr.launches and not fb.launches
    got, want = res
    _same(got[0], want[0])
    for a, b_ in zip(got[1:], want[1:]):
        assert a.shape == b_.shape and a.dtype == b_.dtype
        assert (a.float() - b_.float()).abs().max() <= 1e-2 * b_.float(
        ).abs().max()


@pytest.mark.parametrize("cin,cout,use_proj", [(16, 32, True),
                                               (8, 64, False)])
def test_transition_op_pads_narrow_inputs(dev, cin, cout, use_proj):
    """A Cin off the 32-channel chunks (the gate admits Cin % 8) runs
    zero-padded on the card: outputs and gradients as the same op on the
    CPU (the plain versions, held to JAX at these widths by
    tests/test_torch_transition.py)."""
    b, h, w = 8, 16, 16
    t = _tr_inputs(dev, b, h, w, cin, cout, 5)
    bits = tr.parity_pack(t["bits"], h, w)
    res = []
    for dvc in (dev, torch.device("cpu")):
        ins = [v.to(dvc).clone().requires_grad_() for v in (
            t["x"], t["w1"], t["wp"].float().reshape(cout, cin, 1, 1),
            t["scale"], t["shift"])]
        if not use_proj:
            ins[2] = None
        out = tr.transition_half_int8(*ins, bits.to(dvc), dropout_rate=0.3,
                                      h=h, w_img=w, quant_bwd=use_proj)
        cts = [t[k].to(dvc) for k in ("dz", "dzsum", "dzssq", "dres")]
        leaves = [v for v in ins if v is not None]
        grads = torch.autograd.grad(out, leaves, cts)
        res.append([v.detach().cpu() for v in out]
                   + [v.cpu() for v in grads])
    got, want = res
    _same(got[0], want[0])
    for a, b_ in zip(got[1:], want[1:]):
        assert a.shape == b_.shape and a.dtype == b_.dtype
        assert (a.float() - b_.float()).abs().max() <= 1e-2 * b_.float(
        ).abs().max()


# (batch, h, w, Cin, Cout, zero channels) of the straight-through wgrad on
# the TMA + wgmma mainloop: WRN-28-10's two transitions at batch 128; Cin =
# 16 zero-padded to 32, as the op pads WRN-28-1's 16 -> 32; widths outside
# the WRN-28-10 shapes: Cout = 40 (a ragged 64-wide N tile, which the
# dgrad refuses) and output rows of 192 pixels (80-position boxes, three
# K steps a row)
TR_WGRAD_SHAPES = [(128, 32, 32, 160, 320, 0), (128, 16, 16, 320, 640, 0),
                   (16, 32, 32, 32, 32, 16), (8, 16, 16, 64, 40, 0),
                   (2, 4, 384, 32, 64, 0)]


@pytest.mark.parametrize("b,h,w,cin,cout,zeros", TR_WGRAD_SHAPES)
def test_transition_wgrad_tma_matches_plain(dev, b, h, w, cin, cout, zeros):
    """The straight-through operands and weight gradients on the card:
    the fold's g, parity planes and even-even plane equal to the plain
    version's; dW (HWIO) and dWp^T within 1e-4 of the float64 plain
    versions' largest value (sums over the tensor cores' accumulators),
    bit-equal over two calls (the splits added in order); one launch of
    the kernel and one of its ordered sum a call."""
    t = _tr_inputs(dev, b, h, w, cin, cout, b + cin + w)
    if zeros:
        for k in ("x", "scale", "shift"):
            t[k][cin - zeros:] = 0
    bits = t["bits"]
    thresh = fb.dropout_thresh(0.3)
    kw = dict(h=h, w_img=w)
    z = t["dz"].flip(1).contiguous()
    ct = (t["dz"], z, t["dzsum"], t["dzssq"], t["x"], t["scale"],
          t["shift"], bits)
    tr.reset_launches()
    g, d, x_ee = tr.bwd_fold(*ct, thresh=thresh, **kw)
    for a, b_ in zip((g, d, x_ee), tr.bwd_fold_plain(*ct, thresh=thresh,
                                                     **kw)):
        _same(a, b_)
    dw = tr.wgrad_bf16(g, d, **kw)
    dwp = tr.wgrad_proj(t["dres"], x_ee, **kw)
    assert torch.equal(dw, tr.wgrad_bf16(g, d, **kw))
    assert torch.equal(dwp, tr.wgrad_proj(t["dres"], x_ee, **kw))
    torch.cuda.synchronize()
    assert dict(tr.launches) == {
        "transition_bwd.fold": 1, "transition_wgrad_tma": 2,
        "transition_wgrad_tma.sum": 2, "transition_wgrad_tma.proj": 2,
        "transition_wgrad_tma.proj_sum": 2}
    assert dw.shape == (3, 3, cin, cout) and dwp.shape == (cin, cout)
    _mma_sums(dw, tr.wgrad_bf16_plain(g, d, **kw))
    _mma_sums(dwp, tr.wgrad_proj_plain(t["dres"], x_ee, **kw))
    if zeros:
        assert not dw[:, :, cin - zeros:].any()
        assert not dwp[cin - zeros:].any()


def test_transition_wgrad_tma_refuses_what_it_cannot_take(dev):
    """A CUDA tensor launches the TMA wgrad or raises, naming the shape:
    output rows off the TMA reads' rule (12x12 outputs), Cout off 8, f32
    operands, d not in four planes; the fold raises at an odd width (it
    takes 24x24 inputs since each output lane reads its own pair: see
    test_transition_operand_passes_match_plain); nothing launches, and
    nothing falls back to a plain version or another kernel."""
    bf = torch.bfloat16
    tr.reset_launches()
    g = torch.zeros((64, 2 * 144), dtype=bf, device=dev)
    d = torch.zeros((4, 32, 2 * 144), dtype=bf, device=dev)
    with pytest.raises(ValueError, match="image 12x12 is off the TMA"):
        tr.wgrad_bf16(g, d, h=24, w_img=24)
    with pytest.raises(ValueError, match="image 12x12 is off the TMA"):
        tr.wgrad_proj(g, d[0], h=24, w_img=24)
    g = torch.zeros((44, 2 * 64), dtype=bf, device=dev)
    d = torch.zeros((4, 32, 2 * 64), dtype=bf, device=dev)
    with pytest.raises(ValueError, match="Cout=44 is not a multiple of 8"):
        tr.wgrad_bf16(g, d, h=16, w_img=16)
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        tr.wgrad_bf16(g[:40].float(), d, h=16, w_img=16)
    with pytest.raises(ValueError, match="not 4 parity planes"):
        tr.wgrad_bf16(g[:40], d[0], h=16, w_img=16)
    x = torch.zeros((32, 2 * 144 * 4), dtype=bf, device=dev)
    dz = torch.zeros((64, 2 * 144), dtype=bf, device=dev)
    one = torch.ones(32, device=dev)
    v = torch.zeros(64, device=dev)
    with pytest.raises(ValueError, match="geometry H=24 W=23"):
        tr.bwd_fold(dz, dz, v, v, x, one, one, None, thresh=None, h=24,
                    w_img=23)
    torch.cuda.synchronize()
    assert not tr.launches


@pytest.mark.parametrize("b,h,w,cin,cout,zeros", TR_WGRAD_SHAPES)
def test_transition_wgrad_s8_matches_plain(dev, b, h, w, cin, cout, zeros):
    """The FQT operands and weight gradient on the card: the quantizer's
    g_q, absmaxes, d_q's parity planes and x_ee equal to the plain
    version's; dW (HWIO) on the TMA + s8 wgmma kernel bit-equal to the
    plain version (each group's exact s32 sum scaled and added in group
    order) and over two calls; one launch a call, no partial buffer and no
    sum."""
    t = _tr_inputs(dev, b, h, w, cin, cout, b + cin + w + 1)
    if zeros:
        for k in ("x", "scale", "shift"):
            t[k][cin - zeros:] = 0
    thresh = fb.dropout_thresh(0.3)
    kw = dict(h=h, w_img=w)
    n_out = b * h * w // 4
    tile = tr.transition_tile(h // 2, w // 2, n_out, cin - zeros, cout)
    z = t["dz"].flip(1).contiguous()
    ct = (t["dz"], z, t["dzsum"], t["dzssq"], t["x"], t["scale"],
          t["shift"], t["bits"])
    # the forward's group absmax (its plain version: no launch)
    amax = tr.fwd_amax_plain(*ct[4:], thresh=thresh, tile=tile)[:, 0]
    tr.reset_launches()
    ops = tr.bwd_quantize(*ct, amax, thresh=thresh, tile=tile, **kw)
    for a, b_ in zip(ops, tr.bwd_quantize_plain(*ct, thresh=thresh,
                                                tile=tile, **kw)):
        _same(a, b_)
    g_q, g_amax, d_q, d_amax, _ = ops
    assert d_q.shape == (4, cin, n_out)
    dw = tr.wgrad(g_q, g_amax, d_q, d_amax, tile=tile, **kw)
    assert torch.equal(dw, tr.wgrad(g_q, g_amax, d_q, d_amax, tile=tile,
                                    **kw))
    torch.cuda.synchronize()
    assert dict(tr.launches) == {"transition_bwd.quant": 1,
                                 "transition_wgrad_s8": 2}
    assert dw.shape == (3, 3, cin, cout) and dw.dtype == torch.float32
    _same(dw, tr.wgrad_plain(g_q, g_amax, d_q, d_amax, tile=tile, **kw))
    if zeros:
        assert not dw[:, :, cin - zeros:].any()


def test_transition_wgrad_s8_refuses_what_it_cannot_take(dev):
    """A CUDA tensor launches the FQT wgrad or raises, naming the shape:
    d not in four planes, Cout off 8, a scale group off the 128-position K
    step, absmaxes of the wrong length, f32 codes; nothing launches, and
    nothing falls back to a plain version or another kernel."""
    i8 = torch.int8
    tr.reset_launches()
    g = torch.zeros((64, 2 * 64), dtype=i8, device=dev)
    d = torch.zeros((4, 32, 2 * 64), dtype=i8, device=dev)
    a1 = torch.ones(1, device=dev)
    with pytest.raises(ValueError, match="not 4 parity planes"):
        tr.wgrad(g, a1, d[0], a1, tile=128, h=16, w_img=16)
    with pytest.raises(ValueError, match="Cout=44 is not a multiple of 8"):
        tr.wgrad(g[:44], a1, d, a1, tile=128, h=16, w_img=16)
    with pytest.raises(ValueError, match="scale group of 64 positions"):
        tr.wgrad(g, torch.ones(2, device=dev), d, torch.ones(2, device=dev),
                 tile=64, h=16, w_img=16)
    with pytest.raises(ValueError, match="vs 1 scale groups"):
        tr.wgrad(g, torch.ones(2, device=dev), d, a1, tile=128, h=16,
                 w_img=16)
    with pytest.raises(ValueError, match="expected torch.int8"):
        tr.wgrad(g.float(), a1, d, a1, tile=128, h=16, w_img=16)
    torch.cuda.synchronize()
    assert not tr.launches


# (batch, h, w, Cin, Cout): WRN-28-10's two transitions at batch 128, then
# widths the row-tile kernel refused (output rows of 6 and 10 pixels; the
# first in two scale groups)
TR_FWD_SHAPES = [(128, 32, 32, 160, 320), (128, 16, 16, 320, 640),
                 (64, 12, 12, 160, 320), (32, 20, 20, 64, 128)]


@pytest.mark.parametrize("b,h,w,cin,cout", TR_FWD_SHAPES)
@pytest.mark.parametrize("use_proj,rate", [(True, 0.3), (True, 0.0),
                                           (False, 0.3), (False, 0.0)])
def test_transition_fwd_staged_matches_plain(dev, b, h, w, cin, cout,
                                             use_proj, rate):
    """The staged forward's layers against their plain versions on the
    same CUDA tensors: the group absmaxes equal, the slabs byte for byte,
    z equal, res within 2 bf16 ulps (option A's equal), the sums within
    1e-5; z, res and the sums bit-equal over two calls."""
    t = _tr_inputs(dev, b, h, w, cin, cout, b + h + cin)
    x, scale, shift = t["x"], t["scale"], t["shift"]
    bits = t["bits"] if rate > 0 else None
    thresh = fb.dropout_thresh(rate) if rate > 0 else None
    wp = t["wp"] if use_proj else None
    n = x.shape[1]
    tile = tr.transition_tile(h // 2, w // 2, n // 4, cin, cout)
    lay = tr.transition_fwd_layout(n, h, w, cin, cout, tile)
    wq, ws = fb.quantize_pack_weights(t["w1"])
    tr.reset_launches()
    part = tr.fwd_amax(x, scale, shift, bits, thresh=thresh, tile=tile)
    ppart = tr.fwd_amax_plain(x, scale, shift, bits, thresh=thresh,
                              tile=tile)
    _same(part.amax(dim=1), ppart[:, 0])
    slab, ee, amax = tr.fwd_pre(x, scale, shift, bits, part, thresh=thresh,
                                lay=lay)
    pslab, pee, pamax = tr.fwd_pre_plain(x, scale, shift, bits, ppart,
                                         thresh=thresh, lay=lay)
    _same(slab, pslab)
    _same(ee, pee)
    _same(amax, pamax)
    got = tr.fwd_gemm(slab, ee, amax, wq, ws, wp, lay)
    want = tr.fwd_gemm_plain(pslab, pee, pamax, wq, ws, wp, lay)
    _same(got[0], want[0])
    _same(got[1], want[1], sums=True)
    _same(got[2], want[2], sums=True)
    (_bf16_close if use_proj else _same)(got[3], want[3])
    assert want[0].float().abs().max().item() > 0
    # and against the reference that does not depend on the slabs' layout:
    # the quantizer, then the direct stride-2 conv
    d_q, qamax = fb.fwd_quantize_plain(x, scale, shift, bits, thresh=thresh,
                                       tile=4 * tile)
    ref = tr.fwd_conv_plain(d_q, qamax, wq, ws, x, wp, tile=tile, h=h,
                            w_img=w)
    _same(amax, qamax)
    _same(got[0], ref[0])
    _same(got[1], ref[1], sums=True)
    _same(got[2], ref[2], sums=True)
    (_bf16_close if use_proj else _same)(got[3], ref[3])
    del d_q
    first = tr.fwd_conv(x, scale, shift, bits, wq, ws, wp, thresh=thresh,
                        tile=tile, h=h, w_img=w)
    second = tr.fwd_conv(x, scale, shift, bits, wq, ws, wp, thresh=thresh,
                         tile=tile, h=h, w_img=w)
    torch.cuda.synchronize()
    for a, b_, c in zip(first, second, got):
        assert torch.equal(a, b_) and torch.equal(a, c)
    assert dict(tr.launches) == {"transition_fwd.amax": 3,
                                 "transition_fwd.pre": 3,
                                 "transition_fwd": 3,
                                 "transition_fwd.sum": 3}


def test_transition_never_falls_back(dev):
    """A CUDA tensor launches the kernels or raises: f32 activations raise;
    an output width off the 32-channel chunks (Cout = 48; a narrow Cin is
    padded) runs the forward and the whole backward on the card (the dgrad
    takes the forward's geometry since its wgmma rebuild); rows narrower
    than 8 output pixels, which the operand passes take since each output
    lane reads its own pair, run the backward where its wgrad admits them
    (FQT at 8x8 inputs: output images of 16 positions) and raise naming
    the wgrad where it does not (FQT at 12x12: 36 positions; the
    straight-through TMA wgrad at both)."""
    t = _tr_inputs(dev, 8, 16, 16, 32, 64, 4)
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        tr.transition_half_int8(t["x"].float(), t["w1"], None, t["scale"],
                                t["shift"], h=16, w_img=16)
    w48 = t["w1"][:48].contiguous().requires_grad_()
    for quant_bwd in (True, False):
        out = tr.transition_half_int8(t["x"], w48, None, t["scale"],
                                      t["shift"], h=16, w_img=16,
                                      quant_bwd=quant_bwd)
        tr.reset_launches()
        gw = torch.autograd.grad(out[0].float().sum(), w48)[0]
        assert gw.shape == w48.shape and torch.isfinite(gw).all()
        assert tr.launches["transition_dgrad"] == 1
    for hw, quant_bwd, refuser in ((8, True, None),
                                   (12, True, "transition_wgrad_s8"),
                                   (8, False, "transition_wgrad_tma"),
                                   (12, False, "transition_wgrad_tma")):
        x = torch.zeros((32, 32 * hw * hw), dtype=torch.bfloat16,
                        device=dev, requires_grad=True)
        out = tr.transition_half_int8(x, t["w1"], None, t["scale"],
                                      t["shift"], h=hw, w_img=hw,
                                      quant_bwd=quant_bwd)
        if refuser is None:
            gx = torch.autograd.grad(out[0].float().sum(), x)[0]
            assert gx.shape == x.shape and torch.isfinite(gx.float()).all()
            continue
        with pytest.raises(ValueError, match=refuser):
            torch.autograd.grad(out[0].float().sum(), x)


# (batch, h, w, Cin, Cout) of the backward's operand passes: WRN-28-10's two
# transitions at batch 128 (output rows of 16 and 8 pixels: both unit
# loads); 24x24, 12x12 and 8x8 inputs (rows of 12, 6 and 4 pixels: each
# lane its own pair) at three scale groups
TR_OPERAND_SHAPES = [(128, 32, 32, 160, 320), (128, 16, 16, 320, 640),
                     (24, 24, 24, 32, 64), (96, 12, 12, 32, 64),
                     (24, 8, 8, 32, 64)]


@pytest.mark.parametrize("b,h,w,cin,cout", TR_OPERAND_SHAPES)
def test_transition_operand_passes_match_plain(dev, b, h, w, cin, cout):
    """The FQT operands (one launch: the cotangent's clusters, the
    activation at the forward's group absmax) and the straight-through
    fold against their plain versions on the same CUDA tensors, with and
    without the bits: every output equal, d_amax the forward's (the
    kernel forward's ``fwd_pre``) and equal to the plain version's own;
    the fold with each unit load the shape admits (16-byte rows where
    output rows hold whole units, a pair a lane always); two calls
    bit-equal; one launch a call."""
    t = _tr_inputs(dev, b, h, w, cin, cout, b + h + cin)
    n_out = b * h * w // 4
    tile = tr.transition_tile(h // 2, w // 2, n_out, cin, cout)
    assert n_out // tile >= 3 or b == 128
    lay = tr.transition_fwd_layout(b * h * w, h, w, cin, cout, tile)
    kw = dict(h=h, w_img=w)
    z = t["dz"].flip(1).contiguous()
    routes = sorted({False, tr.operand_rows(w)})
    for rate in (0.3, 0.0):
        bits = t["bits"] if rate else None
        thresh = fb.dropout_thresh(rate) if rate else None
        scb = (t["x"], t["scale"], t["shift"], bits)
        ct = (t["dz"], z, t["dzsum"], t["dzssq"], *scb)
        part = tr.fwd_amax(*scb, thresh=thresh, tile=tile)
        amax = tr.fwd_pre(*scb, part, thresh=thresh, lay=lay)[2]
        want = tr.bwd_quantize_plain(*ct, thresh=thresh, tile=tile, **kw)
        _same(amax, want[3])
        tr.reset_launches()
        got = tr.bwd_quantize(*ct, amax, thresh=thresh, tile=tile, **kw)
        again = tr.bwd_quantize(*ct, amax, thresh=thresh, tile=tile, **kw)
        torch.cuda.synchronize()
        assert dict(tr.launches) == {"transition_bwd.quant": 2}
        assert got[3] is amax
        for a, a2, b_ in zip(got, again, want):
            _same(a, b_)
            assert torch.equal(a, a2)
        for rows in routes:
            tr.reset_launches()
            tr._fold_rows = rows
            try:
                got = tr.bwd_fold(*ct, thresh=thresh, **kw)
                again = tr.bwd_fold(*ct, thresh=thresh, **kw)
            finally:
                tr._fold_rows = None
            torch.cuda.synchronize()
            assert dict(tr.launches) == {"transition_bwd.fold": 2}
            for a, a2, b_ in zip(got, again,
                                 tr.bwd_fold_plain(*ct, thresh=thresh, **kw)):
                _same(a, b_)
                assert torch.equal(a, a2)


@pytest.mark.parametrize("hw", [24, 8])
def test_transition_fqt_op_computes_at_rows_off_8(dev, hw):
    """The whole FQT op at 24x24 and 8x8 inputs (output rows of 12 and 4
    pixels; output images of 144 and 16 positions, which the FQT wgrad
    admits) on the card, with option A's shortcut (dWp runs on the TMA
    wgrad, whose rule refuses these outputs): its kernels launch, and its
    outputs and gradients are as the same op's on the CPU (the plain
    versions, held to JAX at these shapes by
    tests/test_torch_transition.py)."""
    b, cin, cout = 24, 32, 64
    t = _tr_inputs(dev, b, hw, hw, cin, cout, hw)
    bits = tr.parity_pack(t["bits"], hw, hw)
    res = []
    for dvc in (dev, torch.device("cpu")):
        ins = [v.to(dvc).clone().requires_grad_() for v in (
            t["x"], t["w1"], t["scale"], t["shift"])]
        tr.reset_launches()
        out = tr.transition_half_int8(ins[0], ins[1], None, *ins[2:],
                                      bits.to(dvc), dropout_rate=0.3,
                                      h=hw, w_img=hw, quant_bwd=True)
        cts = [t[k].to(dvc) for k in ("dz", "dzsum", "dzssq", "dres")]
        grads = torch.autograd.grad(out, ins, cts)
        res.append([v.detach().cpu() for v in out]
                   + [v.cpu() for v in grads])
        if dvc == dev:
            torch.cuda.synchronize()
            for name in ("transition_bwd.quant", "transition_dgrad",
                         "transition_wgrad_s8"):
                assert tr.launches[name] == 1, name
    got, want = res
    _same(got[0], want[0])
    for a, b_ in zip(got[1:], want[1:]):
        assert a.shape == b_.shape and a.dtype == b_.dtype
        assert (a.float() - b_.float()).abs().max() <= 1e-2 * b_.float(
        ).abs().max()


# (batch, h, w, Cin, Cout) of the dgrad's wgmma route: WRN-28-10's two
# transitions at batch 128; 24x24 and 12x12 inputs (output rows of 12 and
# 6 pixels) at Cout = 40, at three scale groups each
TR_DGRAD_SHAPES = [(128, 32, 32, 160, 320), (128, 16, 16, 320, 640),
                   (48, 24, 24, 32, 40), (96, 12, 12, 32, 40)]


@pytest.mark.parametrize("b,h,w,cin,cout", TR_DGRAD_SHAPES)
@pytest.mark.parametrize("quant", [True, False])
def test_transition_dgrad_wgmma_matches_plain(dev, b, h, w, cin, cout,
                                              quant):
    """The dgrad's prepass, GEMM and sum (each parity class a tap range on
    the s8 or bf16 wgmma mainloop, two classes a block) against the plain
    versions on the same CUDA tensors, both bodies, the projection and
    option A, with and without the bits: the slabs byte for byte; dx
    within 2 bf16 ulps; d(scale), d(shift) within 1e-4 (f32 sums taken
    per unit, per tile, then over the tiles); two calls bit-equal. Some M
    tile spans two scale groups."""
    t = _tr_inputs(dev, b, h, w, cin, cout, 11)
    n = b * h * w
    n_out = n // 4
    tile = tr.transition_tile(h // 2, w // 2, n_out, cin, cout)
    lay = tr.transition_dgrad_layout(n, h, w, cin, cout, tile, quant)
    assert n_out // tile >= 3 and any(
        len({min(m, lay.m_valid - 1) // lay.per_img * lay.oh * lay.ow // tile
             for m in range(m0, m0 + 128)}) > 1
        for m0 in range(0, lay.m_valid, 128))
    gf = t["dz"].float()
    if quant:
        g, g_amax = fb.quantize_groups_plain(gf, tile, fb.BWD_FLOOR)
        w_dg, ws_in = tr.quant_pack_w_dgrad(t["w1"])
    else:
        g, g_amax = gf.to(torch.bfloat16), None
        w_dg, ws_in = tr.pack_w_dgrad(t["w1"].to(torch.bfloat16)), None
    wpt = t["wp"].t().contiguous()
    thresh = fb.dropout_thresh(0.3)
    for proj, bits in ((True, t["bits"]), (True, None), (False, t["bits"])):
        wpt_ = wpt if proj else None
        th = thresh if bits is not None else None
        dres = t["dres"]
        slabs = tr.dgrad_pre(g, dres if proj else None, lay)
        want = tr.dgrad_pre_plain(g, dres if proj else None, lay)
        for a, b_ in zip(slabs, want):
            assert (a is None) == (b_ is None)
            if a is not None:
                assert torch.equal(a, b_)
        args = (g_amax, w_dg, ws_in, t["x"], t["scale"], t["shift"], bits,
                dres, wpt_)
        got = tr.dgrad_gemm(*slabs, *args, thresh=th, lay=lay)
        again = tr.dgrad_gemm(*slabs, *args, thresh=th, lay=lay)
        for a, b_ in zip(got, again):
            assert torch.equal(a, b_)
        want = tr.dgrad_plain(g, *args, thresh=th, tile=tile, h=h, w_img=w)
        _bf16_close(got[0], want[0])
        _mma_sums(got[1], want[1])
        _mma_sums(got[2], want[2])
    torch.cuda.synchronize()


def test_fused_gate_geometry_the_kernels_refuse_raises(dev):
    """The fused gate admits 6x6 images at batch 64 (a 2,304-lane tile);
    the FQT half's int8 wgrad takes whole images of a multiple of 16
    positions (its dgrad takes any width) and raises, naming the geometry
    (ROADMAP Queue 3 item 6), instead of computing something else."""
    from pytorch_ddp_resnet_tpu_torch.models.blocks import ResidualBlock

    c, b, h, w = 32, 64, 6, 6
    block = ResidualBlock(c, False, True, True, 0.0, int8_train=True)
    assert block.lane_eligible((b, h, w, c), True)
    x = torch.zeros((c, b * h * w), dtype=torch.bfloat16, device=dev)
    wt = torch.zeros(c, c, 3, 3, device=dev)
    one = torch.ones(c, device=dev)
    with pytest.raises(ValueError, match="geometry"):
        fb.fused_half_int8(x, wt, one, one, h=h, w_img=w)


# --- the conv of use_pallas_conv and the int8 1x1 conv ----------------------------

WGRAD_SHAPES = [(160, 160, 32, 32, 2), (320, 320, 16, 16, 4),
                (640, 640, 8, 8, 8), (32, 48, 8, 8, 4), (96, 64, 16, 8, 2),
                (32, 48, 64, 64, 2), (64, 136, 16, 16, 2), (32, 32, 32, 32, 8),
                (32, 32, 16, 16, 8), (64, 64, 8, 8, 8), (32, 48, 8, 128, 2),
                (64, 160, 2, 192, 2)]


@pytest.mark.parametrize("cin,cout,h,w,b", WGRAD_SHAPES)
def test_conv3x3_wgrad_kernel_matches_plain(dev, cin, cout, h, w, b):
    """dW in f32 against the float64 plain version: within 1e-4 of its
    largest value (sums over the tensor cores' f32 accumulators), HWIO, the
    same bits in two calls (the splits added in order), one launch of the
    kernel and one of its sum a call. The shapes: WRN-28-10's and
    ResNet-v1-20's widths at their image sizes, a ragged Cout at BN = 64
    (48) and 128 (136), W = 64, and W = 128 and 192 (several 64-column
    steps a row; the x box of row -1 on an image's first row lies wholly
    outside the image)."""
    rng = np.random.default_rng(7)
    n = b * h * w
    x = torch.from_numpy(rng.standard_normal((cin, n), dtype=np.float32))
    dy = torch.from_numpy(rng.standard_normal((cout, n), dtype=np.float32))
    x, dy = x.to(dev, torch.bfloat16), dy.to(dev, torch.bfloat16)
    before = k.launches["conv3x3_wgrad"], k.launches["conv3x3_wgrad.sum"]
    got = k.conv3x3_wgrad(x, dy, h=h, w_img=w)
    again = k.conv3x3_wgrad(x, dy, h=h, w_img=w)
    want = k.conv3x3_wgrad_plain(x, dy, h=h, w_img=w)
    torch.cuda.synchronize()
    assert (k.launches["conv3x3_wgrad"], k.launches["conv3x3_wgrad.sum"]) == (
        before[0] + 2, before[1] + 2)
    assert got.shape == (3, 3, cin, cout)
    _mma_sums(got, want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("cin,cout,h,w,b", [(16, 16, 32, 32, 2),
                                            (32, 48, 16, 16, 2),
                                            (48, 32, 8, 8, 4),
                                            (160, 160, 32, 32, 2)])
def test_conv3x3_same_on_the_card(dev, cin, cout, h, w, b):
    """The op at a zero-padded width (16), at Cin != Cout both ways, and at
    a WRN width: y, dx and dW (rounded to bf16) on the card against the
    same op on the CPU (plain versions), one forward, one dgrad and one
    wgrad launch (with its ordered sum) per call."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((b, h, w, cin),
                                             dtype=np.float32))
    wt = torch.from_numpy(rng.standard_normal((cout, cin, 3, 3),
                                              dtype=np.float32) * 0.1)
    dy = torch.from_numpy(rng.standard_normal((b, h, w, cout),
                                              dtype=np.float32))
    outs = {}
    for d in ("cpu", dev):
        xt = x.to(d, torch.bfloat16).requires_grad_()
        wd = wt.to(d, torch.bfloat16).requires_grad_()
        k.reset_launches()
        y = k.conv3x3_same(xt, wd)
        y.backward(dy.to(d, torch.bfloat16))
        outs[str(d)] = (y.detach(), xt.grad, wd.grad)
        if d == dev:
            torch.cuda.synchronize()
            assert dict(k.launches) == {"conv3x3_bf16.pre": 2,
                                        "conv3x3_bf16": 2,
                                        "conv3x3_wgrad": 1,
                                        "conv3x3_wgrad.sum": 1}
            assert k.same_calls == {"forward": 1, "backward": 1}
    for got, want in zip(outs[str(dev)], outs["cpu"]):
        _bf16_close(got.cpu(), want)


@pytest.mark.parametrize("w", [8, 16, 32, 64])
def test_tma_swizzle_probe(dev, w):
    """The two layouts ``conv3x3_wgrad``'s mainloop reads, through the
    kernel's own tensor maps (``tma_box_probe``), against
    ``tma_box_probe_plain``: dy's boxes, 64 positions of a channel a
    128-byte row, land in the 128-byte swizzle by address (the formula of
    the wgmma descriptors); x's staged boxes, 64 positions (80 from 8
    before where W >= 64), land dense and unswizzled. Also where a box
    reaches past the image, the batch or the channels (zeros), and every
    load completes its barrier with the box's bytes. Then the lane
    transition's maps: x as four parity planes [4, C, N], a box of each
    plane at its taps' row shifts (row -1 of an image reads zeros), and
    its even-even plane as one plane."""
    h, b, c = 8, 2, 32
    rng = np.random.default_rng(11)
    t = torch.from_numpy(rng.standard_normal((c, b * h * w),
                                             dtype=np.float32)).to(
        dev, torch.bfloat16)
    hw, xw = h * w, 64 if w < 64 else 80
    cases = [(False, (-w - (xw - 64), 1), 64),  # row -1 of image 1
             (False, (hw - 64 + w - (xw - 64), 0), 64),  # row H of image 0
             (True, (0, 0), 32), (True, (0, 16), 48),  # channels past C
             (True, (b * hw - 32, 0), 32)]  # positions past N
    for dy, at, bn in cases:
        got, done = k.tma_box_probe(t, h=h, w_img=w, dy=dy, at=at, bn=bn)
        torch.cuda.synchronize()
        assert done, (dy, at, bn)
        want = tma_box_probe_plain(t, h=h, w_img=w, dy=dy, at=at, bn=bn)
        assert torch.equal(got.cpu(), want), (dy, at, bn)
    planes = torch.from_numpy(rng.standard_normal(
        (4, c, b * h * w), dtype=np.float32)).to(dev, torch.bfloat16)
    for p, rs, _ in tr.TAP_TABLE:
        for img in range(b):
            at = (rs * w - (xw - 64), img)   # the step at the image's start
            got, done = k.tma_box_probe(planes, h=h, w_img=w, dy=False,
                                        at=at, plane=p)
            torch.cuda.synchronize()
            assert done, (p, rs, img)
            want = tma_box_probe_plain(planes, h=h, w_img=w, dy=False, at=at,
                                       plane=p)
            assert torch.equal(got.cpu(), want), (p, rs, img)
    got, done = k.tma_box_probe(planes[3][None], h=h, w_img=w, dy=False,
                                at=(-(xw - 64), 1))
    torch.cuda.synchronize()
    assert done and torch.equal(got.cpu(), tma_box_probe_plain(
        planes[3], h=h, w_img=w, dy=False, at=(-(xw - 64), 1)))


def test_conv3x3_same_never_falls_back(dev):
    """f32 on the card raises; geometries off the TMA reads' rule (rows of
    12 and 24 positions) raise, naming the image; 64x64 computes on the
    kernel."""
    with pytest.raises(ValueError, match="float32"):
        k.conv3x3_same(torch.zeros(2, 8, 8, 32, device=dev),
                       torch.zeros(32, 32, 3, 3, device=dev))
    for h, w, b in ((12, 12, 16), (24, 24, 4)):
        x = torch.zeros((32, b * h * w), dtype=torch.bfloat16, device=dev)
        with pytest.raises(ValueError, match=f"image {h}x{w} is off the TMA"):
            k.conv3x3_wgrad(x, x, h=h, w_img=w)
    x = torch.ones((32, 2 * 64 * 64), dtype=torch.bfloat16, device=dev)
    before = k.launches["conv3x3_wgrad"]
    dw = k.conv3x3_wgrad(x, x, h=64, w_img=64)
    torch.cuda.synchronize()
    assert k.launches["conv3x3_wgrad"] == before + 1
    # all-ones operands: each tap counts the positions its shift keeps
    keep = torch.tensor([63.0, 64.0, 63.0], device=dev)
    want = 2 * (keep[:, None] * keep[None, :])
    assert torch.equal(dw, want[:, :, None, None].expand(3, 3, 32, 32))


C1_SHAPES = [(256, 64, 56 * 56 * 2), (64, 256, 56 * 56 * 2),
             (2048, 512, 7 * 7 * 128), (48, 40, 384)]


@pytest.mark.parametrize("cin,cout,n", C1_SHAPES)
@pytest.mark.parametrize("mode", ["int8", "bf16", "bf16+res+dual"])
def test_conv1x1_kernel_matches_plain(dev, cin, cout, n, mode):
    """Equal to the plain version in every epilogue mode (exact s32, the
    same rounding points), a Cin off the 32-channel chunk zero-padded."""
    rng = np.random.default_rng(9)
    xq = torch.from_numpy(rng.integers(-127, 128, (cin, n), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (cout, cin),
                                       dtype=np.int8))
    sigma = (127.0 ** 2 / 3) * cin ** 0.5
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(
        np.float32)) / sigma
    shift = torch.from_numpy(rng.uniform(-0.5, 0.5, cout).astype(np.float32))
    args = [t.to(dev) for t in (xq, wq, scale, shift)]
    kw = dict(relu=mode != "bf16+res+dual")
    if mode == "int8":
        kw["inv_out_scale"] = 127 / 4
    if mode == "bf16+res+dual":
        args.append(torch.from_numpy(rng.standard_normal(
            (cout, n), dtype=np.float32)).to(dev, torch.bfloat16))
        args.append(tuple(torch.from_numpy(rng.uniform(lo, hi, cout).astype(
            np.float32)).to(dev) for lo, hi in ((10, 40), (-5, 5))))
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv1x1 as c1

    before = c1.launches["conv1x1_lanes_requant"]
    got = c1.conv1x1_lanes_requant(*args, **kw)
    want = c1.conv1x1_lanes_requant_plain(*args, **kw)
    torch.cuda.synchronize()
    assert c1.launches["conv1x1_lanes_requant"] == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w), (g.float() - w.float()).abs().max().item()
