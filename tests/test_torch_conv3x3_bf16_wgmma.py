"""The bf16 3x3 conv's slab route (ops/cuda/conv3x3.py
``conv3x3_bf16_pre``, ``conv3x3_bf16_gemm``, ``conv3x3_bf16_plan``,
``check_conv3x3_bf16_geometry``; kernels in csrc/conv3x3_wgmma_bf16.cuh),
on the CPU:

- the prepass's plain version writes x at each pixel's position of the
  fused bf16 forward's slab and zeros at every pad position: the slab of
  ``fused_block._to_slab``;
- the plain prepass and GEMM composed equal ``conv3x3_bf16_plain`` bit for
  bit (both round the float64 contraction to f32, then to bf16) at 6x6
  (batch 3, N = 108: no channel row starts on a 16-byte boundary), 5x7,
  12x12 and 32x32 images, Cin != Cout and ragged N tiles; and equal the JAX
  package's ``conv3x3_lanes`` (interpret mode) within 1 bf16 ulp, as
  tests/test_torch_conv3x3.py holds the plain op;
- a numpy model of the card GEMM's epilogue (each 128-row tile's run of
  lanes and each M row's place in it, each channel staged from its own
  16-byte lead, the run written as a head, whole aligned 16-byte vectors
  and a tail) equals the plain GEMM exactly with every store aligned, and
  no longer does under an off-by-one in the row map, the lead, the head or
  the tail;
- the geometry rule: Cin a multiple of 32, whole images, 32-bit indices;
  any Cout, width and N, so every shape the bf16 conv took before its slab
  route, every operand ``conv3x3_same`` gives it and every conv the int8
  serving gate calibrates pass it;
- the constants mirrored from the CUDA sources, and chip_smoke.py's
  profile kinds for the two kernels.

Inputs are made with numpy from a seed.
"""

import os
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu.ops.pallas import conv as jconv
from pytorch_ddp_resnet_tpu_torch.models.quantize import _conv_eligible
from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3 as k
from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb

CSRC = os.path.join(os.path.dirname(k.__file__), "csrc")
BF16 = torch.bfloat16

# (batch, h, w, Cin, Cout): N = 108 at 6x6 (rows off 16 bytes), 5x7,
# 12x12, 32x32; Cin != Cout, ragged last N tiles (Cout 48 and 10 on tiles
# of 64, 200 on tiles of 128)
GEOS = [(3, 6, 6, 32, 48), (3, 5, 7, 64, 96), (2, 12, 12, 32, 10),
        (1, 32, 32, 32, 200)]


def _operands(rng, cin, cout, n):
    x = torch.from_numpy(rng.standard_normal((cin, n)).astype(
        np.float32)).to(BF16)
    w = torch.from_numpy((rng.standard_normal((cout, 9 * cin))
                          / (9 * cin) ** 0.5).astype(np.float32)).to(BF16)
    return x, w


def _bf16_ulp(ref: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(ref), np.float32(2.0 ** -126))
    return np.float32(2.0) ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("b,h,w,cin,cout", GEOS)
def test_pre_plain_writes_x_at_the_pixels_and_zeros_elsewhere(b, h, w, cin,
                                                              cout):
    n = b * h * w
    rng = np.random.default_rng(n + cin)
    x, _ = _operands(rng, cin, cout, n)
    lay = k.conv3x3_bf16_plan(n, h, w, cin, cout)
    assert lay == fb.fused_fwd_layout(n, h, w, cin, cout)
    slab = k.conv3x3_bf16_pre_plain(x, lay=lay)
    assert slab.dtype == BF16 and tuple(slab.shape) == (lay.slab_len, cin)
    assert torch.equal(slab, fb._to_slab(x, lay))
    i, r, c = np.meshgrid(np.arange(b), np.arange(h), np.arange(w),
                          indexing="ij")
    pos = (lay.guard + i * (h + 1) * (w + 1) + (r + 1) * (w + 1) + c
           + 1).reshape(-1)
    assert torch.equal(slab[torch.from_numpy(pos)], x.t())
    pads = np.ones(lay.slab_len, bool)
    pads[pos] = False
    assert not slab[torch.from_numpy(pads)].any()
    # the wrapper on a CPU tensor is the plain version and launches nothing
    before = dict(k.launches)
    assert torch.equal(k.conv3x3_bf16_pre(x, lay=lay), slab)
    assert dict(k.launches) == before


@pytest.mark.parametrize("b,h,w,cin,cout", GEOS)
def test_pre_and_gemm_plain_equal_the_plain_op(b, h, w, cin, cout):
    n = b * h * w
    rng = np.random.default_rng(7 * n + cout)
    x, wp = _operands(rng, cin, cout, n)
    lay = k.conv3x3_bf16_plan(n, h, w, cin, cout)
    assert cout % lay.bn  # a ragged last N tile
    want = k.conv3x3_bf16_plain(x, wp, h=h, w_img=w)
    got = k.conv3x3_bf16_gemm_plain(k.conv3x3_bf16_pre_plain(x, lay=lay),
                                    wp, lay=lay)
    before = dict(k.launches)
    via_ops = k.conv3x3_bf16_gemm(k.conv3x3_bf16_pre(x, lay=lay), wp,
                                  lay=lay)
    assert dict(k.launches) == before
    assert got.dtype == BF16 and tuple(got.shape) == (cout, n)
    assert torch.equal(got, want) and torch.equal(via_ops, want)
    assert torch.equal(k.conv3x3_bf16(x, wp, h=h, w_img=w), want)


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 8, 8, 32, 32),
                                            (2, 8, 8, 64, 48),
                                            (1, 16, 16, 32, 16)])
def test_slab_route_matches_jax_conv3x3_lanes(b, h, w, cin, cout):
    """At shapes the JAX kernel's lane-tile picker admits."""
    n = b * h * w
    rng = np.random.default_rng(5 * n + cin)
    xf = rng.standard_normal((cin, n)).astype(np.float32)
    wf = (rng.standard_normal((cout, 9 * cin)) * 0.1).astype(np.float32)
    ref = np.asarray(jconv.conv3x3_lanes(
        jnp.asarray(xf, jnp.bfloat16), jnp.asarray(wf, jnp.bfloat16), h=h,
        w_img=w, interpret=True), np.float32)
    lay = k.conv3x3_bf16_plan(n, h, w, cin, cout)
    x = torch.from_numpy(xf).to(BF16)
    got = k.conv3x3_bf16_gemm_plain(k.conv3x3_bf16_pre_plain(x, lay=lay),
                                    torch.from_numpy(wf).to(BF16), lay=lay)
    diff = np.abs(got.float().numpy() - ref)
    assert (diff <= _bf16_ulp(ref)).all(), diff.max()


# --- a numpy model of the card GEMM's epilogue ---------------------------------

def _source_int(fname: str, name: str) -> int:
    with open(os.path.join(CSRC, fname)) as f:
        text = f.read()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


CM_OS = 136  # bf16 lanes a staged channel (csrc/fwd_staged_s8.cuh)
V = 8        # bf16 lanes a 16-byte vector
PRE_C = 32   # channels a slab-copy tile (csrc/fused_half.cuh)


def test_mirrored_constants_match_the_sources():
    assert _source_int("fwd_wgmma_bf16.cuh", "BM") == fb.FUSED_FWD_BM
    assert _source_int("fwd_staged_s8.cuh", "BM") == fb.FUSED_FWD_BM
    with open(os.path.join(CSRC, "fwd_staged_s8.cuh")) as f:
        assert re.search(r"constexpr int CM_OS = BM \+ 8;", f.read())
    assert CM_OS == fb.FUSED_FWD_BM + 8 >= fb.FUSED_FWD_BM + V - 1
    assert _source_int("fused_half.cuh", "PRE_C") == PRE_C
    with open(os.path.join(CSRC, "conv3x3_wgmma_bf16.cuh")) as f:
        text = f.read()
    # the GEMM stages from each channel's 8-lane lead (below) and writes
    # its runs with the int8 conv's write_runs; the prepass is the one slab
    # copy
    assert "(unsigned)(n0 + 2 * (lane % 4)) * nm + lane0" in text
    assert "write_runs(out, CM_OS," in text
    assert "fused_half::slab_copy(" in text
    # the tile widths the layout picks are the launcher's
    assert "bn != 160 && bn != 128 && bn != 64" in text
    for cout in (10, 16, 48, 64, 96, 160, 200, 320, 640):
        assert fb.fused_fwd_layout(64, 8, 8, 32, cout).bn in (160, 128, 64)


@pytest.mark.parametrize("n", [108, 105, 128, 8192, 131072, 6 * 6 * 7])
def test_the_kernels_two_leads_a_thread_are_each_channels_lead(n):
    """The GEMM stages column 8 j + 2 (lane % 4) + e of an N tile from
    n0 at lead[e] = ((n0 + 2 (lane % 4)) * (n % 8) + lane0 + e * (n % 8))
    % 8 (csrc/conv3x3_wgmma_bf16.cuh): the channel's own lead, (co * n +
    lane0) % 8, which write_runs takes, for every column and tile."""
    nm = n % 8
    for lane0 in (0, 1, 7, 13, n - 3):
        for n0 in (0, 64, 128, 160, 480):
            for quad in range(4):
                lead0 = ((n0 + 2 * quad) * nm + lane0) % 2 ** 32
                lead = [lead0 % 8, (lead0 + nm) % 8]
                for j in range(20):
                    for e in range(2):
                        co = n0 + 8 * j + 2 * quad + e
                        assert lead[e] == (co * n + lane0) % 8


def _live_before(lay, m):
    """csrc/fwd_wgmma_bf16.cuh ``live_before``: live rows before M row m."""
    wp = lay.w + 1
    i, rem = divmod(m, lay.per_img)
    if i >= lay.b:
        return lay.n
    r, c = divmod(rem, wp)
    return i * lay.h * lay.w + (0 if r == 0 else (r - 1) * lay.w
                                + max(c - 1, 0))


def _model(slab, wp, lay, mutate=None):
    """The card GEMM's output: y = bf16(f32(acc)) of every M row (the
    plain version's rounding); per (M tile, N tile) the run [lane0, lane0
    + count), at[row] for each live row, each y staged at its channel's
    lead + at[row] in a [cols, CM_OS] tile, and each channel's run written
    as csrc/requant_wgmma_s8.cuh ``write_runs`` does (whole 8-lane vectors
    as one store, the head and tail element by element). ``mutate``: "row"
    stages each live row one place late, "lead" takes the lead from the
    run's first lane alone (not the channel's offset), "head" and "tail"
    drop the run's first or last lane. Returns (y, every vector store
    aligned to 16 bytes)."""
    cin, cout, n, bn = lay.cin, lay.cout, lay.n, lay.bn
    a = slab.to(torch.float64)
    wt = wp.to(torch.float64).reshape(cout, 9, cin)
    rows = torch.arange(lay.tiles * lay.bm)
    acc = sum(a[rows + sh, :cin] @ wt[:, t].t()
              for t, sh in enumerate(lay.shifts))          # [M, Cout]
    y = acc.to(torch.float32).to(BF16)
    out = torch.full((cout, n), float("nan"), dtype=BF16)
    flat = out.reshape(-1)
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
        if not live_rows:
            continue

        def lead_of(co):
            return (lane0 if mutate == "lead" else co * n + lane0) % V

        for n0 in range(0, cout, bn):
            cols = min(bn, cout - n0)
            staged = torch.zeros((cols, CM_OS), dtype=BF16)
            for c in range(cols):
                idx = [lead_of(n0 + c) + at[r] for r in live_rows]
                staged[c, idx] = y[[m0 + r for r in live_rows], n0 + c]
            vpc = (V - 1 + count + V - 1) // V
            for c in range(cols):
                lead = lead_of(n0 + c)
                base = (n0 + c) * n + lane0 - lead
                first = lead + (mutate == "head")
                end = lead + count - (mutate == "tail")
                for j0 in range(0, vpc * V, V):
                    if j0 >= lead + count:
                        continue
                    assert j0 + V <= CM_OS  # inside the staged channel
                    if j0 >= lead and j0 + V <= lead + count and \
                            mutate != "tail":
                        aligned &= (base + j0) % V == 0
                        flat[base + j0:base + j0 + V] = staged[c, j0:j0 + V]
                    else:
                        for e in range(V):
                            if first <= j0 + e < end:
                                flat[base + j0 + e] = staged[c, j0 + e]
    return out, aligned


@pytest.mark.parametrize("b,h,w,cin,cout", [(3, 6, 6, 32, 48),
                                            (3, 5, 7, 32, 72),
                                            (2, 12, 12, 32, 10),
                                            (2, 8, 8, 32, 136)])
def test_card_epilogue_model_equals_the_plain_gemm(b, h, w, cin, cout):
    n = b * h * w
    rng = np.random.default_rng(n + cout)
    x, wp = _operands(rng, cin, cout, n)
    lay = k.conv3x3_bf16_plan(n, h, w, cin, cout)
    slab = k.conv3x3_bf16_pre_plain(x, lay=lay)
    got, aligned = _model(slab, wp, lay)
    assert aligned
    assert torch.equal(got, k.conv3x3_bf16_gemm_plain(slab, wp, lay=lay))


@pytest.mark.parametrize("mutate", ["row", "lead", "head", "tail"])
def test_card_epilogue_model_fails_under_an_off_by_one(mutate):
    """At 6x6, batch 3 (N = 108: every channel's run starts at another
    16-byte offset, and tiles' runs start off a multiple of 8), each
    off-by-one changes an output or misaligns a vector store."""
    b, h, w, cin, cout = 3, 6, 6, 32, 48
    n = b * h * w
    rng = np.random.default_rng(11)
    x, wp = _operands(rng, cin, cout, n)
    lay = k.conv3x3_bf16_plan(n, h, w, cin, cout)
    assert n % 8 and any(_live_before(lay, m) % 8
                         for m in range(0, lay.tiles * lay.bm, lay.bm))
    slab = k.conv3x3_bf16_pre_plain(x, lay=lay)
    want = k.conv3x3_bf16_gemm_plain(slab, wp, lay=lay)
    right, aligned = _model(slab, wp, lay)
    assert aligned and torch.equal(right, want)
    got, aligned = _model(slab, wp, lay, mutate=mutate)
    assert not (torch.equal(got, want) and aligned)


# --- the geometry rule ----------------------------------------------------------

@pytest.mark.parametrize("cin,cout,n,h,w,match", [
    (16, 32, 128, 8, 8, "Cin=16 is not a multiple of 32"),
    (48, 32, 128, 8, 8, "Cin=48 is not a multiple of 32"),
    (32, 0, 128, 8, 8, "Cout=0"),
    (32, 32, 100, 8, 8, "whole images"),
    (32, 32, 0, 8, 8, "whole images"),
    (32, 32, 1024 * 2 ** 21, 32, 32, "32-bit"),
])
def test_the_geometry_rule_refuses_with_a_named_error(cin, cout, n, h, w,
                                                      match):
    with pytest.raises(ValueError, match=f"conv3x3_bf16: .*{match}"):
        k.check_conv3x3_bf16_geometry("conv3x3_bf16", cin, cout, n, h, w)


@pytest.mark.parametrize("cout", [10, 16, 48, 160, 640])
@pytest.mark.parametrize("h,w,b", [(6, 6, 3), (5, 7, 3), (12, 12, 16),
                                   (7, 7, 128), (1, 1, 8), (32, 32, 128),
                                   (8, 8, 128), (24, 24, 4), (3, 100, 2)])
def test_the_geometry_rule_takes_any_cout_and_width(cout, h, w, b):
    for cin in (32, 64, 160, 640):
        k.check_conv3x3_bf16_geometry("conv3x3_bf16", cin, cout, b * h * w,
                                      h, w)


def test_every_operand_of_conv3x3_same_and_every_calibrated_conv_passes():
    """conv3x3_same zero-pads both widths to multiples of 32 (its forward
    and its dgrad, with Cin and Cout swapped); serving calibrates every
    conv the int8 gate admits."""
    for cin in (3, 16, 32, 48, 160, 320, 640):
        for cout in (10, 16, 64, 160):
            cp, op = -(-cin // 32) * 32, -(-cout // 32) * 32
            for h, w, b in ((32, 32, 128), (6, 6, 3), (5, 7, 2)):
                n = b * h * w
                k.check_conv3x3_bf16_geometry("fwd", cp, op, n, h, w)
                k.check_conv3x3_bf16_geometry("dgrad", op, cp, n, h, w)
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
                        k.check_conv3x3_bf16_geometry("calib", cin, cout, n,
                                                      hw, hw)
    assert admitted > 100


def test_the_cpu_wrappers_check_their_operands_against_the_layout():
    lay = k.conv3x3_bf16_plan(128, 8, 8, 32, 16)
    x = torch.zeros((32, 64), dtype=BF16)
    with pytest.raises(ValueError, match="conv3x3_bf16.pre: x"):
        k.conv3x3_bf16_pre(x, lay=lay)
    slab = torch.zeros((lay.slab_len, 32), dtype=BF16)
    with pytest.raises(ValueError, match="conv3x3_bf16: weights"):
        k.conv3x3_bf16_gemm(slab, torch.zeros((16, 9 * 64), dtype=BF16),
                            lay=lay)
    with pytest.raises(ValueError, match="conv3x3_bf16: slab"):
        k.conv3x3_bf16_gemm(slab[1:], torch.zeros((16, 9 * 32), dtype=BF16),
                            lay=lay)


# --- the profile's kinds ---------------------------------------------------------

def test_profile_kinds_count_the_new_kernels_as_conv3x3_sames():
    """chip_smoke.py's kernel kinds by demangled name: the bf16 conv's slab
    copy and wgmma GEMM are conv3x3_same's forward and dgrad; the int8
    instantiation of the same slab copy and the fused bf16 forward stay
    where they were."""
    import chip_smoke

    same = "conv3x3_same fwd + dgrad (port)"
    want = {
        "void conv3x3_wgmma_bf16::conv3x3_bf16_kernel<160>("
        "fwd_wgmma_bf16::Args, int)": same,
        "void conv3x3_wgmma_bf16::conv3x3_bf16_kernel<64>("
        "fwd_wgmma_bf16::Args, int)": same,
        "void fused_half::slab_copy_kernel<__nv_bfloat16>(__nv_bfloat16 "
        "const*, __nv_bfloat16*, fused_half::SlabPos, fused_half::PadPos, "
        "int, int, int, int, long)": same,
        "void fused_half::slab_copy_kernel<signed char>(signed char const*, "
        "signed char*, fused_half::SlabPos, fused_half::PadPos, int, int, "
        "int, int, long)": "fused int8 half (port)",
        "void fwd_wgmma_bf16::fused_fwd_gemm_kernel<160>("
        "fwd_wgmma_bf16::Args)": "fused bf16 half (port)",
    }
    for name, kind in want.items():
        assert chip_smoke.kernel_kind(name) == kind, name
        assert chip_smoke.kernel_kind(
            name, chip_smoke.WRN_KERNEL_KINDS) == kind, name
