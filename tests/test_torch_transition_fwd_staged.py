"""The staged forward of the lane-through stage transition
(ops/cuda/transition.py ``transition_fwd_layout``, ``fwd_amax``, ``fwd_pre``,
``fwd_gemm``; kernels in csrc/transition.cu and csrc/fwd_staged_s8.cuh), on
the CPU:

- the layout puts every A row of every tap on a 16-byte boundary, keeps
  every shifted read of every M tile inside its plane of the slab, gives
  every live M row its image's scale group, and makes each tap read the
  input pixel the stride-2 conv reads (or a zero where that lies outside
  the image), at WRN-28-10's two transitions and at widths whose output
  rows are not multiples of 8 (the old row-tile kernel refused them);
- the prepass's plain version writes the parity planes, each pixel at its
  group's scale, and the raw even-even plane, with zeros at the pad rows,
  pad columns, pad channels, guards and the tail;
- an emulation of the card kernel on the slabs (128-row tile -> K step ->
  16-byte piece, each piece at its own tap, so a step may span two taps,
  each A row read at its tap's shift with no masks, s32 accumulators,
  each row dequantized at its group's scale, a tile spanning groups and
  images, each tile's live rows one run of lanes written channel-major,
  its sums in run order) reproduces
  ``fwd_conv_plain``'s z and res bit for bit and its sums within 1e-5, as
  the vectorized ``fwd_gemm_plain`` does;
- the slab route (``fwd_amax_plain`` -> ``fwd_pre_plain`` ->
  ``fwd_gemm_plain``) against JAX's ``_fwd_call`` in interpret mode: z
  equal, the sums within 1e-5 of their largest value, res within 2 bf16
  ulps of its largest value (the reference sums the projection's bf16
  products in f32, the plain version in float64), option A's res equal.

Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu.ops.pallas import transition as jt
from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
from pytorch_ddp_resnet_tpu_torch.ops.cuda import transition as tr

# (batch, h, w, Cin, Cout) at the input geometry, the scale group the JAX
# picker gives: WRN-28-10's two transitions at batch 128, then widths the
# row-tile kernel refused (output rows of 6 and 10 pixels) and the small
# shapes of the tests
LAYOUTS = [(128, 32, 32, 160, 320), (128, 16, 16, 320, 640),
           (32, 12, 12, 160, 320), (32, 20, 20, 64, 128),
           (64, 12, 12, 160, 320), (8, 16, 16, 32, 64)]


def _tap_source(lay, plane_pos):
    """The input pixel (image, row, col) a plane position holds, or None
    (a zero position), from the layout's definition."""
    plane, pos = divmod(plane_pos, lay.plane_len)
    m = pos - lay.guard
    if not 0 <= m < lay.m_valid:
        return None
    i, rem = divmod(m, lay.per_img)
    r, c = divmod(rem, lay.ow + 1)
    if r == 0 or c == 0:
        return None
    return (i, 2 * (r - 1) + plane // 2, 2 * (c - 1) + plane % 2)


@pytest.mark.parametrize("b,h,w,cin,cout", LAYOUTS)
def test_layout_reads_are_aligned_inside_the_slab_and_tiles_in_a_group(
        b, h, w, cin, cout):
    n = b * h * w
    tile = tr.transition_tile(h // 2, w // 2, n // 4, cin, cout)
    lay = tr.transition_fwd_layout(n, h, w, cin, cout, tile)
    oh, ow = h // 2, w // 2
    assert lay.cp % 32 == 0 and cin <= lay.cp < cin + 32
    assert lay.bk in (64, 128) and lay.krow % lay.bk == 0
    assert 9 * lay.cp <= lay.krow < 9 * lay.cp + lay.bk
    assert lay.cpb % 32 == 0 and cin <= lay.cpb < cin + 32
    assert lay.imgs * oh * ow == tile and lay.groups * tile == n // 4
    assert lay.per_img == (oh + 1) * (ow + 1)
    assert lay.m_valid == b * lay.per_img
    # the batch's rows in whole tiles, no tail beyond the last tile
    assert (lay.tiles - 1) * lay.bm < lay.m_valid <= lay.tiles * lay.bm
    assert lay.tiles <= 65535
    # every A row m of every tap reads position m + shift, cp bytes at a
    # multiple of 16, inside its plane of the slab for every m of every
    # tile
    assert all(sh * lay.cp % 16 == 0 for sh in lay.shifts)
    for t, sh in enumerate(lay.shifts):
        dh, dw = divmod(t, 3)
        plane = 2 * (dh != 1) + (dw != 1)
        assert plane * lay.plane_len <= sh
        assert sh + lay.tiles * lay.bm <= (plane + 1) * lay.plane_len
    assert lay.shifts[0] == 3 * lay.plane_len   # (0, 0): plane 3, up-left
    assert max(lay.shifts) + lay.tiles * lay.bm == 4 * lay.plane_len
    assert lay.shifts[4] == lay.guard and lay.ee_shift == lay.guard
    assert lay.ee_shift + lay.tiles * lay.bm == lay.plane_len
    # the live rows are the lanes in order, each in its image's group (the
    # group of the kernel's per-row scale: lane // tile)
    rows = tr._live_rows(lay).numpy()
    assert len(rows) == n // 4 and (np.diff(rows) > 0).all()
    assert (rows // lay.per_img // lay.imgs
            == np.arange(n // 4) // tile).all()
    # each tap of each live row of the first and last group reads the
    # pixel the conv reads
    for g in sorted({0, lay.groups - 1}):
        for t, sh in enumerate(lay.shifts):
            dh, dw = divmod(t, 3)
            for lane in range(g * tile, (g + 1) * tile):
                i, rem = divmod(lane, oh * ow)
                r, c = divmod(rem, ow)
                ih, iw = 2 * r + dh - 1, 2 * c + dw - 1
                want = (i, ih, iw) if 0 <= ih < h and 0 <= iw < w else None
                assert _tap_source(lay, rows[lane] + sh) == want
    if ow % 8:   # the row-tile kernels refused it; this forward takes it,
        # and so does the dgrad since its wgmma rebuild, and the backward's
        # operand passes since each output lane reads its own input pair
        tr.transition_dgrad_layout(n, h, w, cin, cout, tile, True)
        tr.check_operand_geometry("transition_bwd", h, w, n, tile)
    tr.check_fwd_geometry("new", cin, cout, h, w, n, tile)


def _operands(rng, b, h, w, cin, cout, rate, proj, group_scale=True):
    """x (bf16), scale, shift, bits ([Cin, N] lane order) and the weights;
    each image scaled by its own factor so that the groups' scales
    differ."""
    n = b * h * w
    img = np.exp(rng.standard_normal(b)).astype(np.float32)
    x = rng.standard_normal((cin, b, h * w)).astype(np.float32)
    if group_scale:
        x = x * img[None, :, None]
    x = torch.from_numpy(x.reshape(cin, n)).to(torch.bfloat16)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cin).astype(np.float32))
    shift = torch.from_numpy((rng.standard_normal(cin) * 0.3).astype(
        np.float32))
    bits = (torch.from_numpy(rng.integers(0, 256, (cin, n), dtype=np.uint8))
            if rate > 0 else None)
    w1 = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3))
                           * (9 * cin) ** -0.5).astype(np.float32))
    wq, ws = fb.quantize_pack_weights(w1)
    wp = (torch.from_numpy((rng.standard_normal((cout, cin))
                            * cin ** -0.5).astype(np.float32)).to(
                                torch.bfloat16) if proj else None)
    thresh = fb.dropout_thresh(rate) if rate > 0 else None
    return x, scale, shift, bits, thresh, wq, ws, wp


def test_prepass_plain_writes_each_group_at_its_scale():
    """3 groups of 2 images at 8x10 inputs (4x5 outputs), Cin = 40 (24 pad
    channels in the int8 slab, 8 in the bf16 one), with bits."""
    b, h, w, cin, tile = 6, 8, 10, 40, 40
    x, scale, shift, bits, thresh, *_ = _operands(
        np.random.default_rng(3), b, h, w, cin, 16, 0.3, False)
    n = b * h * w
    lay = tr.transition_fwd_layout(n, h, w, cin, 16, tile)
    assert (lay.groups, lay.imgs, lay.cp, lay.cpb) == (3, 2, 64, 64)
    part = tr.fwd_amax(x, scale, shift, bits, thresh=thresh, tile=tile)
    slab, ee, amax = tr.fwd_pre(x, scale, shift, bits, part, thresh=thresh,
                                lay=lay)
    assert slab.dtype == torch.int8 and ee.dtype == torch.bfloat16
    assert slab.shape == (4 * lay.plane_len, 64)
    assert ee.shape == (lay.plane_len, 64)
    d = fb.prologue_plain(x, scale, shift, bits, thresh)
    want_q, want_a = fb.quantize_groups_plain(d, 4 * tile, fb.FWD_FLOOR)
    assert torch.equal(amax, want_a)
    assert len(set(want_a.tolist())) == 3   # three different scales
    dq = want_q.numpy().reshape(cin, b, h, w)
    xn = x.view(torch.int16).numpy().reshape(cin, b, h, w)
    want_slab = np.zeros(slab.shape, np.int8)
    want_ee = np.zeros(ee.shape, np.int16)
    for pp in range(4 * lay.plane_len):
        src = _tap_source(lay, pp)
        if src is not None:
            want_slab[pp, :cin] = dq[:, src[0], src[1], src[2]]
            if pp < lay.plane_len:   # plane 0: the even-even pixels
                want_ee[pp, :cin] = xn[:, src[0], src[1], src[2]]
    assert torch.equal(slab, torch.from_numpy(want_slab))
    assert torch.equal(ee.view(torch.int16), torch.from_numpy(want_ee))
    # the zeros: pad channels, guards, the tail, pad rows and columns
    planes = slab.reshape(4, lay.plane_len, 64)
    assert not planes[..., cin:].any() and not ee[..., cin:].any()
    assert not planes[:, :lay.guard].any()
    assert not planes[:, lay.guard + lay.m_valid:].any()
    body = planes[:, lay.guard:lay.guard + lay.m_valid].reshape(
        4, b, lay.oh + 1, lay.ow + 1, 64)
    assert not body[:, :, 0].any() and not body[:, :, :, 0].any()
    assert body[..., :cin].any()


def _live_before(lay, m):
    """The live rows before M row m (the kernel's ``live_before``)."""
    i, rem = divmod(m, lay.per_img)
    if i >= lay.n // (lay.h * lay.w):
        return lay.n // 4
    r, c = divmod(rem, lay.ow + 1)
    return i * lay.oh * lay.ow + (0 if r == 0 else (r - 1) * lay.ow
                                  + max(c - 1, 0))


def _emulate(slab, ee, amax, wq, ws, wp, lay):
    """The card kernel on the slabs: per 128-row tile, per K step of bk
    bytes, per 16-byte piece of it (K byte k: tap k // cp, byte k % cp;
    past the ninth tap, past the weights' 9*cp bytes, zero weights against
    any A row), the A piece (row m copied from slab position m0 + m +
    shift[tap], no masks) against the weights' K columns, in integers; the
    tile's live rows are the run of lanes [live_before(m0),
    live_before(m0 + 128)), a tile spanning groups and images; z =
    bf16(f32(acc) * f32(ws * sc)) with each row's group's scale sc = amax
    * f32(1/127); each tile's sums of f32(z) and z^2 in run order, the
    tiles in order; res from the bf16 slab's rows at ee_shift (exact sums
    in float64, then f32, then bf16), or option A's copy."""
    s = slab.numpy().astype(np.int64)
    e = ee.float().numpy().astype(np.float64)
    cout = wq.shape[0]
    wt = np.zeros((cout, lay.krow), dtype=np.int64)
    wt[:, :9 * lay.cp].reshape(cout, 9, lay.cp)[:, :, :lay.cin] = \
        wq.numpy().reshape(cout, 9, lay.cin)
    assert lay.krow % lay.bk == 0
    wpn = None
    if wp is not None:
        wpn = np.zeros((cout, lay.cpb))
        wpn[:, :lay.cin] = wp.float().numpy()
    wsn = ws.numpy().astype(np.float32)
    sc = (amax.numpy().astype(np.float32) * np.float32(fb.INV_127)).astype(
        np.float32)
    n_out = lay.n // 4
    z = np.zeros((cout, n_out), dtype=np.float32)
    res = np.zeros((cout, n_out), dtype=np.float32)
    sums = np.zeros((2, cout), dtype=np.float32)
    bf = torch.bfloat16
    groups_met = 0
    for t in range(lay.tiles):
        m0 = t * lay.bm
        acc = np.zeros((lay.bm, cout), dtype=np.int64)
        for k in range(0, lay.krow, 16):
            tap, c = divmod(k, lay.cp)
            if tap > 8:
                assert not wt[:, k:k + 16].any()
                tap = 8
            sh = lay.shifts[tap]
            a = s[m0 + sh:m0 + sh + lay.bm, c:c + 16]
            assert a.shape == (lay.bm, 16)   # inside the slab
            acc += a @ wt[:, k:k + 16].T
        assert np.abs(acc).max() < 2 ** 31   # an s32 accumulator
        lane0 = _live_before(lay, m0)
        count = _live_before(lay, m0 + lay.bm) - lane0
        live = [m0 + k for k in range(lay.bm)
                if _live_before(lay, m0 + k + 1)
                > _live_before(lay, m0 + k)]
        assert len(live) == count
        rows = np.array(live, dtype=np.int64) - m0
        lanes = lane0 + np.arange(count)
        grp = lanes // lay.tile
        groups_met = max(groups_met, len(set(grp.tolist())))
        fac = (wsn[None, :] * sc[grp][:, None]).astype(np.float32)
        zt = torch.from_numpy(acc[rows].astype(np.float32) * fac).to(
            bf).float().numpy()
        z[:, lanes] = zt.T
        sums[0] += np.sum(zt, axis=0, dtype=np.float32)
        sums[1] += np.sum(zt * zt, axis=0, dtype=np.float32)
        a = e[lay.ee_shift + m0:lay.ee_shift + m0 + lay.bm]
        assert a.shape == (lay.bm, lay.cpb)
        if wpn is not None:
            pacc = np.zeros((lay.bm, cout))
            for c0 in range(0, lay.cpb, 32):
                pacc += a[:, c0:c0 + 32] @ wpn[:, c0:c0 + 32].T
            res[:, lanes] = torch.from_numpy(
                pacc[rows].astype(np.float32)).to(bf).float().numpy().T
        else:
            k = min(cout, lay.cpb)
            res[:k, lanes] = a[rows, :k].T
    return (torch.from_numpy(z).to(bf), torch.from_numpy(sums),
            torch.from_numpy(res).to(bf), groups_met)


def _close(got, want, rel=1e-5):
    assert (got.double() - want.double()).abs().max().item() <= \
        rel * want.double().abs().max().item()


# (batch, h, w, Cin, Cout, tile, projection, dropout): groups of 2 images
# at odd output widths (4x5 and 5x3: tiles across images and rows, the
# run's lead off the 8-lane vectors), one group of 32 images at 6x6, Cin =
# 40 (pad channels; K steps of 64 bytes) and 128 (K steps of 128 bytes),
# Cout = 24 (below the 64-wide tile) and 136 (two 128-wide tiles, the
# second ragged), option A with Cout > and = Cin, and Cin = 24 (a 32-byte
# pitch: a K step of 64 bytes spans three taps)
EMULATED = [(6, 8, 10, 40, 24, 40, True, 0.3),
            (16, 10, 6, 40, 136, 120, False, 0.0),
            (32, 12, 12, 128, 136, 1152, True, 0.0),
            (4, 8, 8, 128, 128, 32, False, 0.3),
            (16, 8, 8, 64, 64, 64, True, 0.3),
            (4, 8, 8, 24, 40, 32, True, 0.3)]


@pytest.mark.parametrize("b,h,w,cin,cout,tile,proj,rate", EMULATED)
def test_emulated_kernel_reproduces_plain_bit_for_bit(b, h, w, cin, cout,
                                                      tile, proj, rate):
    x, scale, shift, bits, thresh, wq, ws, wp = _operands(
        np.random.default_rng(cin + cout + h), b, h, w, cin, cout, rate,
        proj)
    n = b * h * w
    lay = tr.transition_fwd_layout(n, h, w, cin, cout, tile)
    assert lay.bk == (128 if cin == 128 else 64)
    d_q, amax = fb.fwd_quantize_plain(x, scale, shift, bits, thresh=thresh,
                                      tile=4 * tile)
    want = tr.fwd_conv_plain(d_q, amax, wq, ws, x, wp, tile=tile, h=h,
                             w_img=w)
    part = tr.fwd_amax(x, scale, shift, bits, thresh=thresh, tile=tile)
    slab, ee, amax2 = tr.fwd_pre(x, scale, shift, bits, part,
                                 thresh=thresh, lay=lay)
    assert torch.equal(amax2, amax)
    z, sums, res, groups_met = _emulate(slab, ee, amax2, wq, ws, wp, lay)
    # where there are groups, a tile spans two, each row at its own scale
    assert groups_met >= min(lay.groups, 2)
    assert z.shape == want[0].shape == (cout, n // 4)
    assert torch.equal(z, want[0])
    _close(sums[0], want[1])
    _close(sums[1], want[2])
    assert torch.equal(res, want[3])
    assert want[0].float().abs().max().item() > 0
    # the vectorized plain version of the mainloop, and the CPU wrapper
    got = tr.fwd_gemm(slab, ee, amax2, wq, ws, wp, lay)
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_) and a.is_contiguous()
    for a, b_ in zip(tr.fwd_conv(x, scale, shift, bits, wq, ws, wp,
                                 thresh=thresh, tile=tile, h=h, w_img=w),
                     want):
        assert torch.equal(a, b_)


def _bf(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _ulp_ok(got, want):
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= 2 * 2.0 ** (np.floor(np.log2(top))
                                                   - 7)


def _sum_ok(got, want):
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# (batch, h, Cin, Cout): the test shape (one group), then WRN-28-10's first
# transition at batch 8 (two groups of four images)
@pytest.mark.parametrize("b,h,cin,cout,use_proj,rate", [
    (8, 16, 32, 64, True, 0.3), (8, 16, 32, 64, True, 0.0),
    (8, 16, 32, 64, False, 0.3), (8, 16, 32, 64, False, 0.0),
    (8, 32, 160, 320, True, 0.3)])
def test_slab_route_matches_jax(b, h, cin, cout, use_proj, rate):
    rng = np.random.default_rng(cin + int(rate * 10) + use_proj)
    n = b * h * h
    x = _bf(rng.standard_normal((cin, n)))
    w1 = (rng.standard_normal((3, 3, cin, cout)) * (9 * cin) ** -0.5).astype(
        np.float32)
    wp = _bf(rng.standard_normal((cout, cin)) * cin ** -0.5)
    scale = rng.uniform(0.5, 1.5, cin).astype(np.float32)
    shift = (rng.standard_normal(cin) * 0.3).astype(np.float32)
    bits = rng.integers(0, 256, (4 * cin, n // 4), dtype=np.uint8)
    thresh = fb.dropout_thresh(rate) if rate > 0 else None
    oh = h // 2
    jq, jws = jt._quant_pack_w_fwd(jnp.asarray(w1))
    jz, jsum, jssq, jres = (np.asarray(a, np.float32) for a in jt._fwd_call(
        jt.parity_planes(jnp.asarray(x, jnp.bfloat16), h, h), jq, jws,
        jnp.asarray(wp, jnp.bfloat16) if use_proj else None,
        jnp.asarray(scale), jnp.asarray(shift),
        jnp.asarray(bits) if rate > 0 else None, thresh=thresh or 256,
        oh=oh, ow=oh, use_proj=use_proj, interpret=True))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    st, sh = torch.from_numpy(scale), torch.from_numpy(shift)
    bt = (tr.parity_unpack(torch.from_numpy(bits), h, h) if rate > 0
          else None)
    wq, ws = fb.quantize_pack_weights(torch.from_numpy(
        np.ascontiguousarray(w1.transpose(3, 2, 0, 1))))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jq))
    wpt = torch.from_numpy(wp).to(torch.bfloat16) if use_proj else None
    tile = tr.transition_tile(oh, oh, n // 4, cin, cout)
    lay = tr.transition_fwd_layout(n, h, h, cin, cout, tile)
    assert lay.groups == n // 4 // tile
    part = tr.fwd_amax_plain(xt, st, sh, bt, thresh=thresh, tile=tile)
    slab, ee, amax = tr.fwd_pre_plain(xt, st, sh, bt, part, thresh=thresh,
                                      lay=lay)
    z, zsum, zssq, res = (t.float().numpy() for t in tr.fwd_gemm_plain(
        slab, ee, amax, wq, ws, wpt, lay))
    np.testing.assert_array_equal(z, jz)
    _sum_ok(zsum, jsum)
    _sum_ok(zssq, jssq)
    if use_proj:
        _ulp_ok(res, jres)
    else:
        np.testing.assert_array_equal(res, jres)
