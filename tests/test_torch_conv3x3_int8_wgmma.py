"""The int8 serving 3x3 conv's slab route (ops/cuda/conv3x3.py
``conv3x3_int8_requant_pre``, ``conv3x3_int8_requant_gemm``,
``requant_plan``, ``check_requant_geometry``; kernels in
csrc/requant_wgmma_s8.cuh), on the CPU:

- the prepass's plain version writes x_q's codes at each pixel's position
  of the fused int8 forward's slab and zeros at every pad position;
- the plain prepass and GEMM composed equal ``conv3x3_int8_requant_plain``
  exactly (every output, int8 and bf16) at 6x6 (batch 3, N = 108: no
  channel row starts on a 16-byte boundary), 5x7, 8x8 and 32x32 images,
  Cin != Cout, a ragged N tile, in every epilogue mode (int8, bf16,
  + residual, + residual + dual): the s32 contraction is exact in both and
  the epilogue is the same function on it;
- a numpy model of the card GEMM's epilogue (each 128-row tile's run of
  lanes and each M row's place in it, each channel staged from its own
  16-byte lead, the run written as a head, whole aligned 16-byte vectors
  and a tail) equals the plain GEMM exactly with every store aligned, and
  no longer does under an off-by-one in the row map, the lead, the head or
  the tail;
- the geometry rule: Cin a multiple of 32, whole images, 32-bit indices;
  any Cout, width and N; every shape the int8 gate (``_conv_eligible``)
  admits passes it.

Inputs are made with numpy from a seed.
"""

import os
import re
import types

import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu_torch.models.quantize import _conv_eligible
from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3 as k

CSRC = os.path.join(os.path.dirname(k.__file__), "csrc")

# (batch, h, w, Cin, Cout): N = 108 at 6x6 (rows off 16 bytes), 5x7, 8x8,
# 32x32; Cin != Cout, each with a ragged last N tile (Cout 48 and 40 on
# tiles of 64, 96 and 200 on tiles of 128)
GEOS = [(3, 6, 6, 32, 48), (3, 5, 7, 64, 96), (2, 8, 8, 96, 40),
        (1, 32, 32, 32, 200)]
MODES = ["int8", "bf16", "bf16+res", "bf16+res+dual"]


def _operands(rng, cin, cout, n, mode):
    xq = torch.from_numpy(rng.integers(-127, 128, (cin, n), dtype=np.int8))
    wq = torch.from_numpy(
        rng.integers(-127, 128, (cout, 9 * cin), dtype=np.int8))
    sigma = 127.0 ** 2 / 3 * (9 * cin) ** 0.5  # std of the s32 sums
    scale = torch.from_numpy(
        (rng.uniform(0.5, 1.5, cout) / sigma).astype(np.float32))
    shift = torch.from_numpy(rng.uniform(-0.5, 0.5, cout).astype(np.float32))
    res = dual = None
    kw = dict(relu=mode != "bf16+res")
    if "res" in mode:
        res = torch.from_numpy(
            rng.standard_normal((cout, n)).astype(np.float32)).to(
            torch.bfloat16)
    if "dual" in mode:
        dual = (torch.from_numpy(
            (rng.uniform(0.5, 1.5, cout) * 127 / 4).astype(np.float32)),
            torch.from_numpy(rng.uniform(-5, 5, cout).astype(np.float32)))
    if mode == "int8":
        kw["inv_out_scale"] = 127 / 4
    return xq, wq, scale, shift, res, dual, kw


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("b,h,w,cin,cout", GEOS)
def test_pre_plain_writes_the_codes_at_the_pixels_and_zeros_elsewhere(
        b, h, w, cin, cout):
    n = b * h * w
    rng = np.random.default_rng(n + cin)
    xq = _operands(rng, cin, cout, n, "int8")[0]
    plan = k.requant_plan(n, h, w, cin, cout)
    lay = plan.lay
    slab = k.conv3x3_int8_requant_pre_plain(xq, plan=plan)
    assert slab.dtype == torch.int8
    assert tuple(slab.shape) == (lay.slab_len, cin)
    i, r, c = np.meshgrid(np.arange(b), np.arange(h), np.arange(w),
                          indexing="ij")
    pos = (lay.guard + i * (h + 1) * (w + 1) + (r + 1) * (w + 1) + c
           + 1).reshape(-1)
    assert torch.equal(slab[torch.from_numpy(pos)], xq.t())
    pads = np.ones(lay.slab_len, bool)
    pads[pos] = False
    assert not slab[torch.from_numpy(pads)].any()
    # the wrapper on a CPU tensor is the plain version and launches nothing
    before = dict(k.launches)
    assert torch.equal(k.conv3x3_int8_requant_pre(xq, plan=plan), slab)
    assert dict(k.launches) == before


@pytest.mark.parametrize("b,h,w,cin,cout", GEOS)
@pytest.mark.parametrize("mode", MODES)
def test_pre_and_gemm_plain_equal_the_plain_op(b, h, w, cin, cout, mode):
    n = b * h * w
    rng = np.random.default_rng(7 * n + cout)
    xq, wq, scale, shift, res, dual, kw = _operands(rng, cin, cout, n, mode)
    plan = k.requant_plan(n, h, w, cin, cout)
    assert cout % plan.bn  # a ragged last N tile
    want = _tuple(k.conv3x3_int8_requant_plain(
        xq, wq, scale, shift, res, dual, h=h, w_img=w, **kw))
    slab = k.conv3x3_int8_requant_pre_plain(xq, plan=plan)
    got = _tuple(k.conv3x3_int8_requant_gemm_plain(
        slab, wq, scale, shift, res, dual, plan=plan, **kw))
    before = dict(k.launches)
    via_ops = _tuple(k.conv3x3_int8_requant_gemm(
        k.conv3x3_int8_requant_pre(xq, plan=plan), wq, scale, shift, res,
        dual, plan=plan, **kw))
    assert dict(k.launches) == before
    assert len(got) == len(want) == len(via_ops) == (2 if dual else 1)
    for g, o, ref in zip(got, via_ops, want):
        assert g.dtype == ref.dtype and g.shape == ref.shape
        assert torch.equal(g, ref) and torch.equal(o, ref)
        assert ref.unique().numel() > 20  # the mode exercises its range


# --- a numpy model of the card GEMM's epilogue ---------------------------------

def _source_int(fname: str, name: str) -> int:
    with open(os.path.join(CSRC, fname)) as f:
        text = f.read()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


CM_OS = 136      # bf16 lanes a staged channel (csrc/fwd_staged_s8.cuh)
NARROW_OS = 144  # int8 lanes a staged channel (csrc/requant_wgmma_s8.cuh)


def test_mirrored_constants_match_the_sources():
    assert _source_int("requant_wgmma_s8.cuh", "NARROW_OS") == NARROW_OS
    assert _source_int("fwd_wgmma_s8.cuh", "BM") == k.REQUANT_BM
    with open(os.path.join(CSRC, "fwd_staged_s8.cuh")) as f:
        assert re.search(r"constexpr int CM_OS = BM \+ 8;", f.read())
    assert CM_OS == k.REQUANT_BM + 8


def _live_before(lay, m):
    """csrc/fwd_wgmma_bf16.cuh ``live_before``: live rows before M row m."""
    wp = lay.w + 1
    i, rem = divmod(m, lay.per_img)
    if i >= lay.b:
        return lay.n
    r, c = divmod(rem, wp)
    return i * lay.h * lay.w + (0 if r == 0 else (r - 1) * lay.w
                                + max(c - 1, 0))


def _write_runs(staged, os_, lead_of, lane0, count, n0, n, dst, v, mutate):
    """csrc/requant_wgmma_s8.cuh ``write_runs`` for every channel of the
    tile: whole vectors of v lanes as one store each, the run's head and
    tail element by element. Returns False if a vector store is not
    aligned to 16 bytes."""
    aligned = True
    vpc = (v - 1 + count + v - 1) // v
    for c in range(staged.shape[0]):
        lead = lead_of(n0 + c, v)
        base = (n0 + c) * n + lane0 - lead
        end = lead + count - (mutate == "tail")
        first = lead + (mutate == "head")
        for j0 in range(0, vpc * v, v):
            if j0 >= lead + count:
                continue
            assert j0 + v <= os_  # inside the staged channel
            flat = dst.reshape(-1)
            if j0 >= lead and j0 + v <= lead + count and mutate != "tail":
                aligned &= (base + j0) % v == 0
                flat[base + j0:base + j0 + v] = staged[c, j0:j0 + v]
            else:
                for e in range(v):
                    if first <= j0 + e < end:
                        flat[base + j0 + e] = staged[c, j0 + e]
    return aligned


def _model(slab, w_q, scale, shift, res, dual, plan, relu, inv,
           mutate=None):
    """The card GEMM's outputs: the exact s32 accumulator of every M row;
    per (M tile, N tile) the run [lane0, lane0 + count), at[row] for each
    live row, the residual staged from each channel's bf16 lead, the
    element function (``requant_epilogue``, the plain version's one copy)
    on each (channel, row), each output staged at its channel's lead +
    at[row] and written by ``_write_runs``. ``mutate``: "row" stages each
    live row one place late, "lead" takes the lead from the run's first
    lane alone (not the channel's offset), "head" and "tail" drop the
    run's first or last lane. Returns (outputs, every vector aligned)."""
    lay = plan.lay
    cin, cout, n, bn = lay.cin, lay.cout, lay.n, plan.bn
    a = slab.to(torch.float64)
    wt = w_q.to(torch.float64).reshape(cout, 9, cin)
    rows = torch.arange(lay.tiles * lay.bm)
    acc = sum(a[rows + sh, :cin] @ wt[:, t].t()
              for t, sh in enumerate(lay.shifts)).to(torch.int32)  # [M, Co]
    out_int8 = inv is not None
    sentinel = -128  # no output code: quant_s8 clips to [-127, 127]
    out = (torch.full((cout, n), sentinel, dtype=torch.int8) if out_int8
           else torch.full((cout, n), float("nan"), dtype=torch.bfloat16))
    out2 = (torch.full((cout, n), sentinel, dtype=torch.int8)
            if dual is not None else None)
    aligned = True
    for m0 in range(0, lay.tiles * lay.bm, lay.bm):
        lane0 = _live_before(lay, m0)
        count = _live_before(lay, m0 + lay.bm) - lane0
        at = []
        for r in range(lay.bm):
            kk = _live_before(lay, m0 + r)
            live = _live_before(lay, m0 + r + 1) > kk
            at.append(kk - lane0 + (mutate == "row") if live else -1)
        live_rows = [r for r in range(lay.bm) if at[r] >= 0]

        def lead_of(co, v):
            return (lane0 if mutate == "lead" else co * n + lane0) % v

        for n0 in range(0, cout, bn):
            cols = min(bn, cout - n0)
            if not live_rows:
                continue
            ch = slice(n0, n0 + cols)
            lead8 = [lead_of(co, 8) for co in range(n0, n0 + cols)]
            lead16 = [lead_of(co, 16) for co in range(n0, n0 + cols)]
            rr = res
            if res is not None:
                wide = torch.zeros((cols, CM_OS), dtype=torch.bfloat16)
                flat = res.reshape(-1)
                for c in range(cols):
                    src = (n0 + c) * n + lane0 - lead8[c]
                    wide[c, lead8[c]:lead8[c] + count] = \
                        flat[src + lead8[c]:src + lead8[c] + count]
                rr = torch.stack([wide[c, [lead8[c] + at[r]
                                           for r in live_rows]]
                                  for c in range(cols)])
            du = None if dual is None else (dual[0][ch], dual[1][ch])
            y = _tuple(k.requant_epilogue(
                acc[[m0 + r for r in live_rows]][:, ch].t(), scale[ch],
                shift[ch], rr, du, relu=relu, inv_out_scale=inv))
            first = y[0]
            narrow = torch.zeros((cols, NARROW_OS), dtype=torch.int8)
            wide_o = torch.zeros((cols, CM_OS), dtype=torch.bfloat16)
            for c in range(cols):
                idx8 = [lead8[c] + at[r] for r in live_rows]
                idx16 = [lead16[c] + at[r] for r in live_rows]
                if out_int8:
                    narrow[c, idx16] = first[c]
                else:
                    wide_o[c, idx8] = first[c]
            if out_int8:
                aligned &= _write_runs(narrow, NARROW_OS, lead_of, lane0,
                                       count, n0, n, out, 16, mutate)
            else:
                aligned &= _write_runs(wide_o, CM_OS, lead_of, lane0,
                                       count, n0, n, out, 8, mutate)
            if dual is not None:
                narrow2 = torch.zeros((cols, NARROW_OS), dtype=torch.int8)
                for c in range(cols):
                    narrow2[c, [lead16[c] + at[r] for r in live_rows]] = \
                        y[1][c]
                aligned &= _write_runs(narrow2, NARROW_OS, lead_of, lane0,
                                       count, n0, n, out2, 16, mutate)
    return (out if out2 is None else (out, out2)), aligned


@pytest.mark.parametrize("b,h,w,cin,cout", [(3, 6, 6, 32, 48),
                                            (3, 5, 7, 32, 72),
                                            (2, 8, 8, 32, 40)])
@pytest.mark.parametrize("mode", MODES)
def test_card_epilogue_model_equals_the_plain_gemm(b, h, w, cin, cout,
                                                   mode):
    n = b * h * w
    rng = np.random.default_rng(n + cout)
    xq, wq, scale, shift, res, dual, kw = _operands(rng, cin, cout, n, mode)
    plan = k.requant_plan(n, h, w, cin, cout)
    slab = k.conv3x3_int8_requant_pre_plain(xq, plan=plan)
    want = _tuple(k.conv3x3_int8_requant_gemm_plain(
        slab, wq, scale, shift, res, dual, plan=plan, **kw))
    got, aligned = _model(slab, wq, scale, shift, res, dual, plan,
                          kw["relu"], kw.get("inv_out_scale"))
    assert aligned
    for g, ref in zip(_tuple(got), want):
        assert torch.equal(g, ref)


@pytest.mark.parametrize("mutate", ["row", "lead", "head", "tail"])
@pytest.mark.parametrize("mode", ["int8", "bf16+res+dual"])
def test_card_epilogue_model_fails_under_an_off_by_one(mutate, mode):
    """At 6x6, batch 3 (N = 108: every channel's run starts at another
    16-byte offset, and tiles' runs start off a multiple of 8), each
    off-by-one changes an output or misaligns a vector store."""
    b, h, w, cin, cout = 3, 6, 6, 32, 48
    n = b * h * w
    rng = np.random.default_rng(11)
    xq, wq, scale, shift, res, dual, kw = _operands(rng, cin, cout, n, mode)
    plan = k.requant_plan(n, h, w, cin, cout)
    lay = plan.lay
    assert n % 16 and any(_live_before(lay, m) % 8
                          for m in range(0, lay.tiles * lay.bm, lay.bm))
    slab = k.conv3x3_int8_requant_pre_plain(xq, plan=plan)
    want = _tuple(k.conv3x3_int8_requant_gemm_plain(
        slab, wq, scale, shift, res, dual, plan=plan, **kw))
    args = (slab, wq, scale, shift, res, dual, plan, kw["relu"],
            kw.get("inv_out_scale"))
    right, aligned = _model(*args)
    assert aligned and all(torch.equal(g, r)
                           for g, r in zip(_tuple(right), want))
    got, aligned = _model(*args, mutate=mutate)
    same = all(torch.equal(g, r) for g, r in zip(_tuple(got), want))
    assert not (same and aligned)


# --- the geometry rule ----------------------------------------------------------

@pytest.mark.parametrize("cin,cout,n,h,w,match", [
    (16, 32, 128, 8, 8, "multiple of 32"),
    (48, 32, 128, 8, 8, "multiple of 32"),
    (32, 0, 128, 8, 8, "Cout=0"),
    (32, 32, 100, 8, 8, "whole images"),
    (32, 32, 0, 8, 8, "whole images"),
    (32, 32, 1024 * 2 ** 21, 32, 32, "32-bit"),
])
def test_the_geometry_rule_refuses_with_a_named_error(cin, cout, n, h, w,
                                                      match):
    with pytest.raises(ValueError, match=match):
        k.check_requant_geometry("conv3x3_int8_requant", cin, cout, n, h, w)


def test_the_geometry_rule_takes_any_cout_width_and_n():
    for cin, cout, n, h, w in [(32, 36, 105, 5, 7), (64, 1, 108, 6, 6),
                               (96, 200, 147, 7, 7), (640, 640, 8192, 8, 8),
                               (160, 160, 131072, 32, 32)]:
        k.check_requant_geometry("conv3x3_int8_requant", cin, cout, n, h, w)


def test_every_shape_the_int8_gate_admits_passes_the_rule():
    admitted = 0
    for hw in (1, 2, 3, 4, 5, 6, 7, 8, 12, 14, 16, 28, 32, 56):
        for batch in (1, 2, 3, 8, 64, 128, 256, 1024):
            n = batch * hw * hw
            for cin in (32, 64, 96, 160, 320, 640, 2048):
                for cout in (32, 64, 160, 640):
                    conv = types.SimpleNamespace(
                        kernel_size=3, stride=1, padding=1, use_bias=False,
                        in_channels=cin, out_channels=cout)
                    if _conv_eligible(conv, hw * hw, n):
                        admitted += 1
                        k.check_requant_geometry("gate", cin, cout, n, hw,
                                                 hw)
    assert admitted > 100
