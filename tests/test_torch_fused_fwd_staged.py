"""The staged forward of the fused bf16 block-half
(ops/cuda/fused_block.py ``fused_fwd_layout``, ``fused_fwd_pre``,
``fused_fwd_gemm``, ``fwd_bf16``; kernels in csrc/fused_block_bf16.cu and
csrc/fwd_wgmma_bf16.cuh), on the CPU:

- the layout's rows, tap shifts and live-row runs: every live pixel at M
  row i * (h + 1) * (w + 1) + (r + 1) * (w + 1) + c + 1, every tap of
  every M row of every tile a read inside the slab that finds the pixel
  the 3x3 conv reads (or a zero), each tile's live rows one run of
  lanes, at WRN-28-10's three stages, at 6x6, 12x12 and 5x7 images and at
  batch 3 (widths the old row-tile kernel refused);
- the prepass's plain version writes d at each pixel's position and zeros
  at every pad position, which are the positions the card prepass's pad
  enumeration lists;
- the plain prepass and GEMM composed equal ``fwd_bf16_plain`` bit for
  bit in y, the sums within 1e-5 of their largest value;
- an emulation of the card GEMM (128-row tile -> 128-byte K step ->
  16-byte piece, each piece at its own tap, the weights' K bytes past 9 *
  Cin read as zeros, each tile's live rows one run of lanes written
  channel-major) reproduces ``fused_fwd_gemm_plain``'s y bit for bit;
- ``fwd_bf16_plain`` and the slab route against JAX's ``fused_half``
  with ``interpret=True`` at image widths that are not multiples of 8: y
  within 2 bf16 ulps of its largest value (the reference sums in f32, the
  plain version in float64, so an element at a rounding boundary may round
  the other way); each channel's sums within 1e-5 of their largest value
  plus what those elements' differences add to that channel's sum of y
  (sum |dy|) or of y^2 (sum |dy| (|y| + |y_ref|)).

Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu.ops.pallas import fused_block as jfb
from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
from pytorch_ddp_resnet_tpu_torch.ops.cuda.conv3x3 import pack_weights

# (batch, h, w, Cin, Cout): WRN-28-10's three stages at batch 128, then
# widths that are not multiples of 8 (6x6, 12x12, 5x7) and batch 3
LAYOUTS = [(128, 32, 32, 160, 160), (128, 16, 16, 320, 320),
           (128, 8, 8, 640, 640), (64, 6, 6, 32, 32), (8, 12, 12, 64, 96),
           (3, 5, 7, 16, 24), (3, 6, 6, 24, 64)]


def _source(lay, pos):
    """The pixel (image, row, col) slab position ``pos`` holds, or None (a
    zero position), from the layout's definition."""
    m = pos - lay.guard
    if not 0 <= m < lay.m_valid:
        return None
    i, rem = divmod(m, lay.per_img)
    r, c = divmod(rem, lay.w + 1)
    return None if r == 0 or c == 0 else (i, r - 1, c - 1)


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


def _pad_positions(lay):
    """The card prepass's pad enumeration (csrc/fused_block_bf16.cu
    ``PadPos``): the k-th slab position that holds no pixel."""
    wp, per_pad = lay.w + 1, lay.w + 1 + lay.h
    img_pads = lay.b * per_pad
    out = []
    for k in range(lay.slab_len - lay.n):
        if k < lay.guard:
            out.append(k)
            continue
        k -= lay.guard
        if k < img_pads:
            i, j = divmod(k, per_pad)
            out.append(lay.guard + i * lay.per_img
                       + (j if j <= lay.w else (j - lay.w) * wp))
        else:
            out.append(lay.guard + lay.m_valid + k - img_pads)
    return out


@pytest.mark.parametrize("b,h,w,cin,cout", LAYOUTS)
def test_layout_rows_taps_and_runs(b, h, w, cin, cout):
    n = b * h * w
    lay = fb.fused_fwd_layout(n, h, w, cin, cout)
    assert (lay.b, lay.per_img, lay.guard) == (b, (h + 1) * (w + 1), w + 2)
    assert lay.m_valid == b * lay.per_img and lay.bm == 128
    assert (lay.tiles - 1) * lay.bm < lay.m_valid <= lay.tiles * lay.bm
    assert lay.slab_len == 2 * lay.guard + lay.tiles * lay.bm
    assert lay.cp == cin and cin * 2 % 16 == 0
    assert lay.bn == (160 if cout % 160 == 0 else 128 if cout > 64 else 64)
    assert lay.shifts == tuple(lay.guard + (dh - 1) * (w + 1) + dw - 1
                               for dh in range(3) for dw in range(3))
    if (b, h, w, cin) == (128, 32, 32, 160):   # 1,089 rows for 1,024 lanes
        assert lay.per_img == 1089 and lay.tiles == 1089
        assert lay.bn == 160 and -(-cout // lay.bn) == 1
    # every tap of every M row of every tile reads inside the slab
    assert min(lay.shifts) >= 0
    assert max(lay.shifts) + lay.tiles * lay.bm <= lay.slab_len
    # the live rows are the lanes in order, at the layout's formula
    rows = fb.fused_fwd_live_rows(lay).numpy()
    i, rem = np.divmod(np.arange(n), h * w)
    r, c = np.divmod(rem, w)
    assert (rows == i * lay.per_img + (r + 1) * (w + 1) + c + 1).all()
    # each tap of each live row of the first and last image reads the
    # pixel the conv reads, or a zero position
    lanes = sorted({*range(h * w), *range(n - h * w, n)})
    for t, sh in enumerate(lay.shifts):
        dh, dw = divmod(t, 3)
        for lane in lanes:
            img, rc = divmod(lane, h * w)
            rr, cc = divmod(rc, w)
            ih, iw = rr + dh - 1, cc + dw - 1
            want = (img, ih, iw) if 0 <= ih < h and 0 <= iw < w else None
            assert _source(lay, rows[lane] + sh) == want
    # each tile's live rows are one run of lanes, which the card
    # epilogue's live_before finds
    for tile in range(lay.tiles):
        m0 = tile * lay.bm
        inside = rows[(rows >= m0) & (rows < m0 + lay.bm)]
        lane0 = int(np.searchsorted(rows, m0))
        assert _live_before(lay, m0) == lane0
        assert _live_before(lay, m0 + lay.bm) - lane0 == len(inside)
        assert (np.searchsorted(rows, inside) == lane0
                + np.arange(len(inside))).all()


def _operands(rng, cin, cout, n, mode):
    """x (bf16), w_packed (bf16), scale, shift, (thresh, bits) and res."""
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


@pytest.mark.parametrize("b,h,w,cin,cout", [(3, 5, 7, 16, 24),
                                            (4, 6, 6, 32, 32),
                                            (2, 12, 12, 8, 16)])
@pytest.mark.parametrize("mode", ["none", "bits", "seed"])
def test_pre_plain_writes_d_at_the_pixels_and_zeros_elsewhere(
        b, h, w, cin, cout, mode):
    n = b * h * w
    rng = np.random.default_rng(cin + h)
    x, _, scale, shift, thresh, bits, _ = _operands(rng, cin, cout, n, mode)
    lay = fb.fused_fwd_layout(n, h, w, cin, cout)
    slab = fb.fused_fwd_pre(x, scale, shift, bits, thresh=thresh, lay=lay)
    assert slab.dtype == torch.bfloat16 and slab.is_contiguous()
    assert tuple(slab.shape) == (lay.slab_len, lay.cp)
    d = fb.prologue_bf16_plain(x, scale, shift, bits, thresh)
    live = fb.fused_fwd_live_rows(lay) + lay.guard
    assert torch.equal(slab[live], d.t())
    pads = _pad_positions(lay)
    assert len(pads) == len(set(pads)) == lay.slab_len - n
    assert sorted(set(pads) | set(live.tolist())) == list(
        range(lay.slab_len))
    assert not slab[pads].any()
    # the card prepass's pixel map (``SlabPos``) is the layout's
    assert (live.numpy() == np.array(
        [lay.guard + (p // (h * w)) * lay.per_img
         + (p % (h * w) // w + 1) * (w + 1) + p % w + 1
         for p in range(n)])).all()


def _emulate_gemm(slab, w_packed, res, lay, want_stats):
    """The card GEMM's walk in float64: per 128-byte K step and 16-byte
    piece p (8 channels), the piece's own (tap, channel) found by walking
    the K bytes as the kernel does, the A rows of every M row at that
    tap's offset (tap / 3 * (w + 1) + tap % 3 - (w + 1) - 1, past the
    guard; taps past the last read tap 8 against zero weights), B the
    weights' 8 columns or zeros past 9 * Cin; then per tile the run of
    lanes and each row's place in it, y = round(acc) written
    channel-major, res added, and each tile's f32 sums added in order."""
    cin, cout = lay.cin, lay.cout
    wp = lay.w + 1
    m_all = lay.tiles * lay.bm
    a = slab.to(torch.float64)
    wf = w_packed.to(torch.float64)
    ldb = 9 * cin
    steps = -(-2 * ldb // 128)
    acc = torch.zeros(m_all, cout, dtype=torch.float64)
    rows = torch.arange(m_all) + lay.guard
    for p in range(8):
        s_tap, s_c = 0, 8 * p
        while s_c >= cin:
            s_c -= cin
            s_tap += 1
        for kt in range(steps):
            tap = min(s_tap, 8)
            off = tap // 3 * wp + tap % 3 - wp - 1
            k = 64 * kt + 8 * p
            if k < ldb:
                acc += a[rows + off, s_c:s_c + 8] @ wf[:, k:k + 8].t()
            s_c += 64
            while s_c >= cin:
                s_c -= cin
                s_tap += 1
    y = torch.zeros(cout, lay.n, dtype=torch.bfloat16)
    parts = []
    for tile in range(lay.tiles):
        m0 = tile * lay.bm
        lane0 = _live_before(lay, m0)
        count = _live_before(lay, m0 + lay.bm) - lane0
        at = [(_live_before(lay, m) - lane0
               if _live_before(lay, m + 1) > _live_before(lay, m) else -1)
              for m in range(m0, m0 + lay.bm)]
        keep = [m for m, k in enumerate(at) if k >= 0]
        out = acc[m0 + torch.tensor(keep, dtype=torch.long)].t().to(
            torch.float32).to(torch.bfloat16) if keep else torch.zeros(
                cout, 0, dtype=torch.bfloat16)
        assert [at[m] for m in keep] == list(range(count))
        if res is not None:
            out = res[:, lane0:lane0 + count] + out
        y[:, lane0:lane0 + count] = out
        of = out.to(torch.float32)
        parts.append(torch.stack([of.sum(1), (of * of).sum(1)]))
    if not want_stats:
        return y, None, None
    tot = parts[0]
    for part in parts[1:]:
        tot = tot + part
    return y, tot[0], tot[1]


@pytest.mark.parametrize("b,h,w,cin,cout", [(3, 5, 7, 16, 24),
                                            (8, 5, 7, 24, 40),
                                            (4, 6, 6, 32, 32),
                                            (2, 12, 12, 64, 96),
                                            (2, 8, 8, 160, 160)])
@pytest.mark.parametrize("mode,use_res,stats", [("bits", True, True),
                                                ("seed", False, True),
                                                ("none", True, False)])
def test_plain_parts_and_the_card_walk_equal_fwd_bf16_plain(
        b, h, w, cin, cout, mode, use_res, stats):
    n = b * h * w
    rng = np.random.default_rng(n + cout)
    x, wt, scale, shift, thresh, bits, res = _operands(rng, cin, cout, n,
                                                       mode)
    res = res if use_res else None
    wp = pack_weights(wt.to(torch.bfloat16))
    lay = fb.fused_fwd_layout(n, h, w, cin, cout)
    want = fb.fwd_bf16_plain(x, wp, scale, shift, bits, res, thresh=thresh,
                             h=h, w_img=w, want_stats=stats)
    slab = fb.fused_fwd_pre_plain(x, scale, shift, bits, thresh=thresh,
                                  lay=lay)
    for got in (fb.fused_fwd_gemm(slab, wp, res, lay=lay, want_stats=stats),
                _emulate_gemm(slab, wp, res, lay, stats)):
        assert got[0].dtype == torch.bfloat16
        assert torch.equal(got[0], want[0])
        if not stats:
            assert got[1] is None and got[2] is None
            continue
        for g, ref in zip(got[1:], want[1:]):
            assert (g - ref).abs().max() <= 1e-5 * ref.abs().max()
    # on the CPU the wrapper is the plain version, at any width
    got = fb.fwd_bf16(x, wp, scale, shift, bits, res, thresh=thresh, h=h,
                      w_img=w, want_stats=stats)
    assert torch.equal(got[0], want[0])


def test_the_checks_take_any_width_and_keep_the_dgrads_rule():
    """The forward's check takes widths that are not multiples of 8 and
    refuses channels, positions or grids it cannot take; the bf16 dgrad
    (the forward's GEMM on the transposed conv) takes those widths too, so
    the QAT backward's check passes them; so does the int8 (FQT) dgrad's
    (the int8 forward's rule, Cin and Cout swapped), and the FQT backward
    keeps its int8 wgrad's rule: whole images of a multiple of 16
    positions (12x12 passes it, 6x6 and 5x7 do not)."""
    for h, w, n in ((6, 6, 64 * 36), (5, 7, 8 * 35), (12, 12, 8 * 144)):
        fb.check_fwd_bf16_geometry("fwd", 32, 64, n, h, w)
        fb._check_int8_backward.cache_clear()
        fb._check_int8_backward(False, 32, 64, n, h, w)
        fb.check_fwd_int8_geometry("dgrad", 64, 32, n, h, w, n)
        if (h * w) % 16:
            with pytest.raises(ValueError, match="geometry"):
                fb.check_wgrad_s8_geometry("wgrad", 32, 64, n, h, w, n)
        else:
            fb.check_wgrad_s8_geometry("wgrad", 32, 64, n, h, w, n)
    with pytest.raises(ValueError, match="multiple of 8"):
        fb.check_fwd_bf16_geometry("fwd", 12, 64, 8 * 36, 6, 6)
    with pytest.raises(ValueError, match="multiple of 8"):
        fb.check_fwd_bf16_geometry("fwd", 32, 20, 8 * 36, 6, 6)
    with pytest.raises(ValueError, match="geometry"):
        fb.check_fwd_bf16_geometry("fwd", 32, 32, 3 * 35, 5, 7)
    with pytest.raises(ValueError, match="geometry"):
        fb.check_fwd_bf16_geometry("fwd", 32, 32, 100, 6, 6)
    # 8,192 images of 32x32: 69,696 M tiles of the slab, past the grid
    with pytest.raises(ValueError, match="69696 tiles exceed the grid"):
        fb.check_fwd_bf16_geometry("fwd", 32, 32, 8192 * 1024, 32, 32)


# (h, w, batch): widths that are not multiples of 8, at the smallest batch
# whose images make a 128-multiple lane tile for the reference
JAX_GEOS = [(6, 6, 32), (12, 12, 8)]


@pytest.mark.parametrize("h,w,b", JAX_GEOS)
@pytest.mark.parametrize("mode", ["none", "bits", "seed"])
@pytest.mark.parametrize("use_res,stats", [(False, True), (True, True),
                                           (True, False)])
def test_fwd_bf16_plain_matches_jax_at_any_width(h, w, b, mode, use_res,
                                                 stats):
    c = 32
    n = b * h * w
    rng = np.random.default_rng(h + b)
    x, wt, scale, shift, thresh, bits, res = _operands(rng, c, c, n, mode)
    res = res if use_res else None
    rate = 0.3 if mode != "none" else 0.0
    jbits = (None if bits is None else jnp.int32(int(bits)) if mode == "seed"
             else jnp.asarray(bits.numpy()))
    jy, jys, jyq = jfb.fused_half(
        jnp.asarray(x.float().numpy(), jnp.bfloat16),
        jnp.asarray(wt.permute(2, 3, 1, 0).numpy()),
        jnp.asarray(scale.numpy()), jnp.asarray(shift.numpy()), jbits,
        None if res is None else jnp.asarray(res.float().numpy(),
                                             jnp.bfloat16),
        dropout_rate=rate, h=h, w_img=w, want_stats=stats, interpret=True)
    jy = np.asarray(jy, np.float32)
    top = np.abs(jy).max()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    wp = pack_weights(wt.to(torch.bfloat16))
    lay = fb.fused_fwd_layout(n, h, w, c, c)
    slab = fb.fused_fwd_pre_plain(x, scale, shift, bits, thresh=thresh,
                                  lay=lay)
    for got in (fb.fwd_bf16_plain(x, wp, scale, shift, bits, res,
                                  thresh=thresh, h=h, w_img=w,
                                  want_stats=stats),
                fb.fused_fwd_gemm_plain(slab, wp, res, lay=lay,
                                        want_stats=stats)):
        assert np.abs(got[0].float().numpy() - jy).max() <= 2 * ulp
        if not stats:
            assert got[1] is None and jys is None
            continue
        gy = got[0].float().numpy()
        dy = np.abs(gy - jy)
        for g, j, moved in ((got[1], jys, dy.sum(1)),
                            (got[2], jyq, (dy * (np.abs(gy)
                                                 + np.abs(jy))).sum(1))):
            j = np.asarray(j)
            assert (np.abs(g.numpy() - j)
                    <= 1e-5 * np.abs(j).max() + moved).all()
