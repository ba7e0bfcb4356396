"""The staged forward of the fused int8 block-half
(ops/cuda/fused_block.py ``fused_fwd_int8_plan``, ``fwd_int8_pre``,
``fwd_int8_gemm``, ``fwd_int8``; kernels in csrc/fused_block.cu and
csrc/fwd_wgmma_s8.cuh), on the CPU:

- the plan at WRN-28-10's three stages and at 6x6 and 7x5 images, Cin 32 /
  96 / 160 / 320 and Cout 40 / 136 / 160: each tap's boxes cover its Cin
  bytes once, in widths of 128, 64 and 32 bytes, each in the swizzle of its
  width, at offsets that are multiples of 16; the K steps are the taps'
  boxes in order, the weight coordinates are tap * Cin + offset, and
  every A box of every M tile lies inside the slab;
- the prepass's plain version: each pixel's codes equal
  ``fwd_quantize_plain``'s at its slab position, zeros everywhere else,
  with no dropout, bits and a seed;
- a model of the 128-, 64- and 32-byte swizzles (``_tma_layout``): the
  byte TMA lays at (row, k) of a box is the byte the kernel's descriptor
  (its fields as ``smem_desc`` sets them) reads for that row and k, for
  either warpgroup's rows and every k32 slice, and the bases are aligned
  to the swizzle's period;
- an s32 emulation of the card GEMM (M tile -> tap -> box -> k32 slice,
  B rows past Cout zero; then each row's lane, scale group and scale,
  y = bf16(f32(acc) * (ws * rowscale)), the residual, the channel-major
  run and the sums in the kernel's order) reproduces ``fwd_conv_plain``'s
  y bit for bit and its sums within 1e-5 of their largest value, with
  and without res and stats, on tiles that span two scale groups;
- the checks: the forward takes any whole images (6x6, 7x5), and
  ``fused_half_int8`` raises before its forward wherever its backward
  refuses;
- the slab route against JAX's ``fused_half_int8`` with ``interpret=True``
  at 6x6 and 12x12 images: y equal, the sums within 1e-5.

Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tma_layout import swizzle_offset
from pytorch_ddp_resnet_tpu.ops.pallas import fused_block as jfb
from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb

# (batch, h, w, Cin, Cout): WRN-28-10's three stages at batch 128, then
# 6x6 and 7x5 images at the box mixes of Cin 32, 96, 160, 320 and a
# ragged Cout (40 at BN = 64, 136 at BN = 128)
PLANS = [(128, 32, 32, 160, 160), (128, 16, 16, 320, 320),
         (128, 8, 8, 640, 640), (32, 6, 6, 96, 40), (8, 7, 5, 32, 136),
         (4, 6, 6, 160, 160), (2, 7, 5, 320, 40)]


@pytest.mark.parametrize("b,h,w,cin,cout", PLANS)
def test_plan_boxes_steps_and_coordinates(b, h, w, cin, cout):
    n = b * h * w
    plan = fb.fused_fwd_int8_plan(n, h, w, cin, cout)
    lay = plan.lay
    assert lay.cp == cin and (lay.n, lay.cin, lay.cout) == (n, cin, cout)
    # each tap's Cin bytes once, in widths of 128, 64, 32 (widest first),
    # each box in its own width's swizzle, at 16-byte offsets
    covered = []
    for off, width, swizzle in plan.boxes:
        assert width in (128, 64, 32) and swizzle == width
        assert off % 16 == 0
        covered += range(off, off + width)
    assert covered == list(range(cin))
    widths = [wd for _, wd, _ in plan.boxes]
    assert widths == sorted(widths, reverse=True)
    assert widths.count(64) <= 1 and widths.count(32) <= 1
    assert widths.count(128) == cin // 128
    # the K steps: tap after tap, each tap's boxes in order; the weight
    # column is tap * Cin + offset, the A row shift the tap's
    assert len(plan.steps) == 9 * len(plan.boxes)
    for i, (tap, a_col, shift, b_col, width) in enumerate(plan.steps):
        off, wd, _ = plan.boxes[i % len(plan.boxes)]
        assert tap == i // len(plan.boxes)
        assert (a_col, width, shift) == (off, wd, lay.shifts[tap])
        assert b_col == tap * cin + off and b_col % 16 == 0
    # no step spans two taps: its weight columns lie in one tap's Cin
    for tap, _, _, b_col, width in plan.steps:
        assert tap * cin <= b_col and b_col + width <= (tap + 1) * cin
    # every A box (128 rows from row y * 128 + shift) inside the slab
    for _, _, shift, _, _ in plan.steps:
        assert shift >= 0
        assert (lay.tiles - 1) * lay.bm + shift + lay.bm <= lay.slab_len
    assert plan.bn == (160 if cout % 160 == 0 else 128 if cout > 64 else 64)
    assert plan.grid == (-(-cout // plan.bn), lay.tiles)
    if (b, h, w, cin) == (128, 32, 32, 160):
        assert [wd for _, wd, _ in plan.boxes] == [128, 32]
        assert plan.grid == (1, 1089)
    if cin == 320:
        assert [wd for _, wd, _ in plan.boxes] == [128, 128, 64]
    if cin == 640:
        assert [wd for _, wd, _ in plan.boxes] == [128] * 5
    if cin == 96:
        assert [wd for _, wd, _ in plan.boxes] == [64, 32]


def test_mirrored_constants_match_the_sources():
    """The Python side's copies of the kernels' constants: the widest K
    step, the GEMM's M tile and the `.sum`'s runs of tiles."""
    import os
    import re

    csrc = os.path.join(os.path.dirname(fb.__file__), "csrc")

    def const(fname, name):
        with open(os.path.join(csrc, fname)) as f:
            return int(re.search(rf"constexpr int {name} = (\d+);",
                                 f.read()).group(1))

    assert const("fwd_wgmma_s8.cuh", "BK") == fb.FWD_INT8_BOX
    assert const("fwd_wgmma_s8.cuh", "BM") == fb.FUSED_FWD_BM
    # the `.sum`'s kernel, common::tile_sum, is shared with the stem's
    assert const("common.cuh", "SUM_RUNS") == fb.FWD_SUM_RUNS


def _operands(rng, cin, cout, n, mode):
    """x (bf16), w (OIHW f32), scale, shift, (thresh, bits) and res."""
    x = torch.from_numpy(rng.standard_normal((cin, n)).astype(
        np.float32)).to(torch.bfloat16)
    wt = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3))
                           * (9 * cin) ** -0.5).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cin).astype(np.float32))
    shift = torch.from_numpy((rng.standard_normal(cin) * 0.3).astype(
        np.float32))
    res = torch.from_numpy(rng.standard_normal((cout, n)).astype(
        np.float32)).to(torch.bfloat16)
    thresh, bits = None, None
    if mode == "bits":
        thresh = fb.dropout_thresh(0.3)
        bits = torch.from_numpy(rng.integers(0, 256, (cin, n),
                                             dtype=np.uint8))
    elif mode == "seed":
        thresh = fb.dropout_thresh(0.3)
        bits = torch.tensor(-123456789, dtype=torch.int32)
    return x, wt, scale, shift, thresh, bits, res


@pytest.mark.parametrize("b,h,w,cin,tile", [(4, 6, 6, 32, 72),
                                            (8, 7, 5, 64, 280),
                                            (4, 8, 8, 96, 128)])
@pytest.mark.parametrize("mode", ["none", "bits", "seed"])
def test_pre_plain_writes_the_codes_at_the_pixels_and_zeros_elsewhere(
        b, h, w, cin, tile, mode):
    n = b * h * w
    rng = np.random.default_rng(cin + h + w)
    x, _, scale, shift, thresh, bits, _ = _operands(rng, cin, 32, n, mode)
    plan = fb.fused_fwd_int8_plan(n, h, w, cin, 32)
    lay = plan.lay
    slab, amax = fb.fwd_int8_pre(x, scale, shift, bits, thresh=thresh,
                                 tile=tile, plan=plan)
    assert slab.dtype == torch.int8 and slab.is_contiguous()
    assert tuple(slab.shape) == (lay.slab_len, cin)
    d_q, want_amax = fb.fwd_quantize_plain(x, scale, shift, bits,
                                           thresh=thresh, tile=tile)
    assert torch.equal(amax, want_amax) and amax.numel() == n // tile
    live = fb.fused_fwd_live_rows(lay) + lay.guard
    assert torch.equal(slab[live], d_q.t())
    pad = torch.ones(lay.slab_len, dtype=torch.bool)
    pad[live] = False
    assert int(pad.sum()) == lay.slab_len - n
    assert not slab[pad].any()
    assert d_q.abs().max() == 127 and (slab[live] != 0).any()


def _desc_fields(width: int):
    """The descriptor fields csrc/fwd_wgmma_s8.cuh ``smem_desc`` sets for
    a K step of ``width`` bytes (sel = log2(128 / width)): (leading byte
    offset, stride byte offset, swizzle of its layout type, in bytes)."""
    sel = {128: 0, 64: 1, 32: 2}[width]
    layout = sel + 1                     # bits 62-63
    sbo = (64 >> sel) * 16               # bits 32-45, in 16s
    lbo = 1 * 16                         # bits 16-29 (unused when swizzled)
    return lbo, sbo, {1: 128, 2: 64, 3: 32}[layout]


def _desc_read(base: int, row: int, k: int, width: int) -> int:
    """The shared-memory byte the descriptor at ``base`` (K-major,
    swizzled, 8-row groups SBO apart, rows of the swizzle's width) reads
    for (row, k) of its tile, k < 32 within the k32 slice: the
    unswizzled address, then the swizzle of the layout type."""
    _, sbo, swizzle = _desc_fields(width)
    return swizzle_offset(base + (row // 8) * sbo + (row % 8) * swizzle + k,
                          swizzle)


@pytest.mark.parametrize("width", [128, 64, 32])
@pytest.mark.parametrize("rows", [128, 160, 64])
def test_swizzle_model_descriptor_reads_what_tma_lays(width, rows):
    """TMA lays byte (r, k) of a box of ``rows`` x ``width`` bytes in the
    ``width``-byte swizzle at swizzle_offset(base + r * width + k): the
    descriptor of each warpgroup's 64 rows (A: base + wg * 64 * width; B:
    the box's base) and each k32 slice (start address + 32 bytes a slice)
    reads exactly that byte; every base is aligned to the swizzle's period
    (8 rows of its width)."""
    lbo, sbo, swizzle = _desc_fields(width)
    assert swizzle == width and sbo == 8 * width and lbo == 16
    stage = 1024 * 36   # a ring slot at BN = 160: A 16 KB then B 20 KB
    for base in (0, stage, stage + 128 * 128):
        assert base % (8 * width) == 0
        lay = {swizzle_offset(base + r * width + k, width): (r, k)
               for r in range(rows) for k in range(width)}
        assert len(lay) == rows * width  # a permutation of the box
        groups = [(0, rows)] if rows != 128 else [(0, 64), (64, 64)]
        for r0, cnt in groups:
            start = base + r0 * width
            assert start % (8 * width) == 0
            for kk in range(width // 32):
                for r in range(cnt):
                    for k in range(32):
                        at = _desc_read(start + 32 * kk, r, k, width)
                        assert lay[at] == (r0 + r, 32 * kk + k)


def _live_before(lay, m):
    """The card epilogue's count of live rows before M row m
    (csrc/fwd_wgmma_bf16.cuh ``live_before``)."""
    wp = lay.w + 1
    i, rem = divmod(m, lay.per_img)
    if i >= lay.b:
        return lay.n
    r, c = divmod(rem, wp)
    return i * lay.h * lay.w + (0 if r == 0 else (r - 1) * lay.w
                                + max(c - 1, 0))


def _sums_cm(col: torch.Tensor, lead: int, count: int):
    """fwd_staged_s8.cuh ``sums_cm`` on one staged tile [cols, CM_OS]
    (f32 values of the stored bf16): four parts of 34 elements, each
    summed in order (zeros outside the run), then lanes q and q ^ 1, then
    q and q ^ 2 (a fixed butterfly). Returns (s1, s2) per column."""
    cm_os = col.shape[1]
    j = torch.arange(cm_os)
    v = torch.where((j >= lead) & (j < lead + count), col,
                    torch.zeros((), dtype=torch.float32))
    w = cm_os // 4
    parts = []
    for q in range(4):
        s1 = torch.zeros(col.shape[0], dtype=torch.float32)
        s2 = torch.zeros(col.shape[0], dtype=torch.float32)
        for e in range(q * w, (q + 1) * w):
            s1 = s1 + v[:, e]
            s2 = s2 + v[:, e] * v[:, e]
        parts.append((s1, s2))
    pair = [(parts[q][0] + parts[q ^ 1][0], parts[q][1] + parts[q ^ 1][1])
            for q in range(4)]
    return (pair[0][0] + pair[2][0], pair[0][1] + pair[2][1])


def _emulate_gemm(slab, amax, w_q, ws, res, plan, tile, want_stats):
    """The card GEMM in s32 (int64 here, exact): per M tile and N tile the
    K steps of the plan in order, each the A box (128 slab rows at the
    tap's shift, the box's bytes) against the B box (bn weight rows, zeros
    past Cout), k32 slice by slice; then per M row its lane, scale group
    and scale f32(amax_g * 1/127), y = bf16(f32(acc) * f32(ws * scale)),
    the residual bf16(f32(res) + f32(y)) in the tile's run of lanes, the
    staged tile's sums in ``sums_cm``'s order and the tiles' sums in
    ``.sum``'s (runs of tiles, then the runs)."""
    lay = plan.lay
    a = slab.to(torch.int64)
    wq = w_q.to(torch.int64)
    cout, bn = lay.cout, plan.bn
    wpad = torch.zeros(plan.grid[0] * bn, wq.shape[1], dtype=torch.int64)
    wpad[:cout] = wq
    inv127 = torch.tensor(fb.INV_127, dtype=torch.float32)
    cm_os = lay.bm + 8
    y = torch.zeros(cout, lay.n, dtype=torch.bfloat16)
    parts = []
    for ty in range(lay.tiles):
        m0 = ty * lay.bm
        lane0 = _live_before(lay, m0)
        count = _live_before(lay, m0 + lay.bm) - lane0
        lead = lane0 % 8
        at = torch.full((lay.bm,), -1, dtype=torch.long)
        rowscale = torch.zeros(lay.bm, dtype=torch.float32)
        for r in range(lay.bm):
            k = _live_before(lay, m0 + r)
            if _live_before(lay, m0 + r + 1) > k:
                at[r] = k - lane0
                rowscale[r] = amax[k // tile] * inv127
        live = at >= 0
        tile_parts = torch.zeros(2, cout, dtype=torch.float32)
        for tx in range(plan.grid[0]):
            n0 = tx * bn
            acc = torch.zeros(lay.bm, bn, dtype=torch.int64)
            for _, a_col, shift, b_col, width in plan.steps:
                abox = a[m0 + shift:m0 + shift + lay.bm, a_col:a_col + width]
                bbox = wpad[n0:n0 + bn, b_col:b_col + width]
                for kk in range(width // 32):
                    ks = slice(32 * kk, 32 * kk + 32)
                    acc += abox[:, ks] @ bbox[:, ks].t()
            assert acc.abs().max() < 2 ** 31  # s32 holds it
            cols = min(bn, cout - n0)
            wsc = torch.zeros(bn, dtype=torch.float32)
            wsc[:cols] = ws[n0:n0 + cols]
            fac = wsc[None, :] * rowscale[:, None]          # f32, rounded
            v = (acc.to(torch.float32) * fac).to(torch.bfloat16)
            out = torch.zeros(bn, cm_os, dtype=torch.bfloat16)
            out[:, lead + at[live]] = v[live].t()
            run = slice(lane0, lane0 + count)
            staged = out[:cols, lead:lead + count]
            if res is not None:
                staged = (res[n0:n0 + cols, run].float()
                          + staged.float()).to(torch.bfloat16)
                out[:cols, lead:lead + count] = staged
            y[n0:n0 + cols, run] = staged
            s1, s2 = _sums_cm(out.float(), lead, count)
            tile_parts[0, n0:n0 + cols] = s1[:cols]
            tile_parts[1, n0:n0 + cols] = s2[:cols]
        parts.append(tile_parts)
    if not want_stats:
        return y, None, None
    # ``.sum``: FWD_SUM_RUNS runs of consecutive tiles, each added in order
    # from zero, then the runs in order
    per = -(-len(parts) // fb.FWD_SUM_RUNS)
    runs = []
    for q in range(fb.FWD_SUM_RUNS):
        run = torch.zeros(2, cout, dtype=torch.float32)
        for part in parts[q * per:(q + 1) * per]:
            run = run + part
        runs.append(run)
    tot = runs[0]
    for run in runs[1:]:
        tot = tot + run
    return y, tot[0], tot[1]


# (batch, h, w, Cin, Cout, scale-group lanes): groups of 1, 2 and 4
# images whose 128-row M tiles span two groups (81, 49 or 56 padded rows an
# image), a 7-wide image, Cin 96 (64 + 32-byte steps) and 160 (128 + 32),
# a ragged Cout at BN = 64 and 128
EMU = [(4, 8, 8, 32, 40, 64), (4, 8, 8, 160, 160, 128),
       (16, 6, 7, 96, 136, 168), (4, 6, 6, 64, 64, 72)]


@pytest.mark.parametrize("b,h,w,cin,cout,tile", EMU)
@pytest.mark.parametrize("mode,use_res,stats", [("bits", True, True),
                                                ("seed", False, True),
                                                ("none", True, False),
                                                ("none", False, False)])
def test_card_walk_emulation_equals_fwd_conv_plain(b, h, w, cin, cout,
                                                   tile, mode, use_res,
                                                   stats):
    n = b * h * w
    rng = np.random.default_rng(n + cout + cin)
    x, wt, scale, shift, thresh, bits, res = _operands(rng, cin, cout, n,
                                                       mode)
    res = res if use_res else None
    wq, ws = fb.quantize_pack_weights(wt)
    plan = fb.fused_fwd_int8_plan(n, h, w, cin, cout)
    d_q, amax = fb.fwd_quantize_plain(x, scale, shift, bits, thresh=thresh,
                                      tile=tile)
    want = fb.fwd_conv_plain(d_q, amax, wq, ws, res, tile=tile, h=h,
                             w_img=w, want_stats=stats)
    # some M tile holds rows of two scale groups
    groups = {(_live_before(plan.lay, m0), _live_before(plan.lay, m0 + 127))
              for m0 in range(0, plan.lay.m_valid, 128)}
    assert any(lo // tile != (hi - 1) // tile for lo, hi in groups
               if hi > lo)
    slab, amax_s = fb.fwd_int8_pre_plain(x, scale, shift, bits,
                                         thresh=thresh, tile=tile, plan=plan)
    for got in (_emulate_gemm(slab, amax_s, wq, ws, res, plan, tile, stats),
                fb.fwd_int8_gemm(slab, amax_s, wq, ws, res, tile=tile,
                                 plan=plan, want_stats=stats),
                fb.fwd_int8(x, wq, ws, scale, shift, bits, res,
                            thresh=thresh, tile=tile, h=h, w_img=w,
                            want_stats=stats)):
        assert got[0].dtype == torch.bfloat16
        assert torch.equal(got[0], want[0])
        assert want[0].float().abs().max() > 0
        if not stats:
            assert got[1] is None and got[2] is None
            continue
        for g, ref in zip(got[1:], want[1:]):
            assert (g - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_the_checks_take_any_width_and_the_op_keeps_its_backwards_rules():
    """The forward's check takes whole images of any width and refuses
    channels, positions and scale groups its kernels cannot take; the
    op's check of its backward raises, naming the geometry, where the
    int8 wgrad (FQT) needs whole images of a multiple of 16 positions
    (6x6: the FQT dgrad takes any width), and passes where the bf16
    backward (QAT) takes any width."""
    for h, w, n, tile in ((6, 6, 32 * 36, 1152), (5, 7, 8 * 35, 280),
                          (8, 8, 4 * 64, 128)):
        fb.check_fwd_int8_geometry("fwd", 96, 40, n, h, w, tile)
    with pytest.raises(ValueError, match="Cin=48"):
        fb.check_fwd_int8_geometry("fwd", 48, 64, 8 * 36, 6, 6, 72)
    with pytest.raises(ValueError, match="Cout=20"):
        fb.check_fwd_int8_geometry("fwd", 32, 20, 8 * 36, 6, 6, 72)
    with pytest.raises(ValueError, match="geometry"):
        fb.check_fwd_int8_geometry("fwd", 32, 32, 3 * 35, 5, 7, 105)
    with pytest.raises(ValueError, match="scale group"):
        fb.check_fwd_int8_geometry("fwd", 32, 32, 2 * 36, 6, 6, 36)
    with pytest.raises(ValueError, match="scale group"):
        fb.check_fwd_int8_geometry("fwd", 32, 32, 4 * 64, 8, 8, 96)
    with pytest.raises(ValueError, match="Cin=40"):
        fb.fwd_int8_boxes(40)
    # the op's backward checks: 6x6 at batch 64 (the gate admits it)
    with pytest.raises(ValueError, match="geometry H=6 W=6"):
        fb._check_int8_backward(True, 32, 32, 64 * 36, 6, 6)
    fb._check_int8_backward(False, 32, 32, 64 * 36, 6, 6)
    for quant_bwd in (True, False):
        fb._check_int8_backward(quant_bwd, 32, 32, 8 * 64, 8, 8)


# (h, w, batch): widths that are not multiples of 8, at the smallest batch
# whose images make a 128-multiple lane tile for the reference
JAX_GEOS = [(6, 6, 32), (12, 12, 8)]


@pytest.mark.parametrize("h,w,b", JAX_GEOS)
@pytest.mark.parametrize("mode", ["none", "bits", "seed"])
@pytest.mark.parametrize("use_res,stats", [(False, True), (True, True),
                                           (True, False)])
def test_slab_route_matches_jax_at_any_width(h, w, b, mode, use_res, stats):
    c = 32
    n = b * h * w
    rng = np.random.default_rng(h + b + 1)
    x, wt, scale, shift, thresh, bits, res = _operands(rng, c, c, n, mode)
    res = res if use_res else None
    rate = 0.3 if mode != "none" else 0.0
    jbits = (None if bits is None else jnp.int32(int(bits)) if mode == "seed"
             else jnp.asarray(bits.numpy()))
    jy, jys, jyq = jfb.fused_half_int8(
        jnp.asarray(x.float().numpy(), jnp.bfloat16),
        jnp.asarray(wt.permute(2, 3, 1, 0).numpy()),
        jnp.asarray(scale.numpy()), jnp.asarray(shift.numpy()), jbits,
        None if res is None else jnp.asarray(res.float().numpy(),
                                             jnp.bfloat16),
        dropout_rate=rate, h=h, w_img=w, want_stats=stats, quant_bwd=True,
        interpret=True)
    tile = fb.lane_tile(h, w, n, c, c)
    plan = fb.fused_fwd_int8_plan(n, h, w, c, c)
    wq, ws = fb.quantize_pack_weights(wt)
    slab, amax = fb.fwd_int8_pre_plain(x, scale, shift, bits, thresh=thresh,
                                       tile=tile, plan=plan)
    got = _emulate_gemm(slab, amax, wq, ws, res, plan, tile, stats)
    np.testing.assert_array_equal(got[0].float().numpy(),
                                  np.asarray(jy, np.float32))
    if not stats:
        assert got[1] is None and jys is None
        return
    for g, j in ((got[1], jys), (got[2], jyq)):
        j = np.asarray(j)
        assert np.abs(g.numpy() - j).max() <= 1e-5 * np.abs(j).max()
