"""The lane transition's backward operand passes as the card runs them
(ops/cuda/transition.py ``bwd_quantize``, ``bwd_fold``; csrc/transition.cu
``bwd_quant_kernel``, ``bwd_fold_kernel``; csrc/fused_half.cuh
``cluster_quant_body``), on the CPU:

- the forward's raw group absmax of the prologue (``fwd_amax_plain``,
  ``fwd_pre_plain``'s ``amax``, the op forward's ``fwd_conv``) equals the
  FQT backward's activation absmax (``bwd_quantize_plain``'s ``d_amax``)
  bit for bit, which is why the card's quantizer takes the forward's and
  computes none;
- a numpy model of the kernels' index math (the activation's units: unit
  -> channel, row parity, output lanes, each lane's input pair; the stores
  into the four parity planes and x_ee; both unit loads, 16-byte rows and
  a pair a lane) places every code and every x_ee value exactly once, at
  every geometry the lane-through gate admits up to 32x32 inputs, and
  agrees with ``parity_planes`` and ``_even``;
- a model of the cotangent's clusters: each scale group's units split over
  the cluster's blocks and threads once, in both passes.

Everything here is exact (indices and maxima): no tolerance.
"""

import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
from pytorch_ddp_resnet_tpu_torch.ops.cuda import transition as tr
from pytorch_ddp_resnet_tpu_torch.ops.cuda.conv3x3 import pad_rows, pick_tile

from _wgrad_s8_model import unit_pair_lanes

RATE = 0.3
CLUSTER = 8      # csrc/fused_half.cuh kClusterCtas
THREADS = 256    # a block of bwd_quant_kernel


def _prologue_inputs(b, h, w, cin, cout, rate, seed=0):
    """x (bf16), scale, shift, bits ([Cin, N] lane order or None), thresh,
    and the backward's cotangents dz, z, dzsum, dzssq, from a seed; each
    image scaled by its own factor so that the groups' absmaxes differ."""
    rng = np.random.default_rng(seed)
    n = b * h * w
    img = np.exp(rng.standard_normal(b)).astype(np.float32)
    x = (rng.standard_normal((cin, b, h * w)).astype(np.float32)
         * img[None, :, None])
    x = torch.from_numpy(x.reshape(cin, n)).to(torch.bfloat16)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cin).astype(np.float32))
    shift = torch.from_numpy((rng.standard_normal(cin) * 0.3).astype(
        np.float32))
    bits = (torch.from_numpy(rng.integers(0, 256, (cin, n), dtype=np.uint8))
            if rate else None)
    thresh = fb.dropout_thresh(rate) if rate else None
    dz = torch.from_numpy((rng.standard_normal((cout, n // 4)) * 1e-2)
                          .astype(np.float32)).to(torch.bfloat16)
    z = torch.from_numpy(rng.standard_normal((cout, n // 4)).astype(
        np.float32)).to(torch.bfloat16)
    dzsum = torch.from_numpy((rng.standard_normal(cout) * 1e-3).astype(
        np.float32))
    dzssq = torch.from_numpy((rng.standard_normal(cout) * 1e-4).astype(
        np.float32))
    return x, scale, shift, bits, thresh, (dz, z, dzsum, dzssq)


# (batch, h, w, Cin, Cout): WRN-28-10's two transitions at batch 2; 24x24,
# 12x12 and 8x8 inputs (output rows of 12, 6 and 4 pixels) at three scale
# groups; Cin = 16, which the op pads to 32
AMAX_CASES = [(2, 32, 32, 160, 320), (2, 16, 16, 320, 640),
              (24, 24, 24, 32, 64), (96, 12, 12, 32, 64), (24, 8, 8, 32, 64),
              (24, 24, 24, 16, 32)]


@pytest.mark.parametrize("b,h,w,cin,cout", AMAX_CASES)
@pytest.mark.parametrize("rate", [0.0, RATE])
def test_forward_absmax_is_the_backward_absmax(b, h, w, cin, cout, rate):
    """The FQT backward's activation absmax is the forward's: the same f32
    prologue of the same x, scale, shift and bits over the same groups of
    4 * tile input lanes, and a maximum is exact in any order. Both are the
    raw maximum (each side floors it only where it divides). With Cin
    padded to 32 as the op pads it, the zero channels change nothing."""
    x, scale, shift, bits, thresh, cts = _prologue_inputs(b, h, w, cin, cout,
                                                          rate, seed=b + cin)
    n_out = b * h * w // 4
    tile = tr.transition_tile(h // 2, w // 2, n_out, cin, cout)
    unpadded = tr.fwd_amax_plain(x, scale, shift, bits, thresh=thresh,
                                 tile=tile)[:, 0]
    pin = -cin % 32
    if pin:
        x, scale, shift = (pad_rows(t, pin) for t in (x, scale, shift))
        bits = None if bits is None else pad_rows(bits, pin)
    part = tr.fwd_amax_plain(x, scale, shift, bits, thresh=thresh, tile=tile)
    lay = tr.transition_fwd_layout(b * h * w, h, w, cin + pin, cout, tile)
    pre_amax = tr.fwd_pre_plain(x, scale, shift, bits, part, thresh=thresh,
                                lay=lay)[2]
    w1 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (cout, cin + pin, 3, 3)).astype(np.float32) * 0.05)
    wq, ws = fb.quantize_pack_weights(w1)
    fwd_out = tr.fwd_conv(x, scale, shift, bits, wq, ws, None, thresh=thresh,
                          tile=tile, h=h, w_img=w)
    bwd = tr.bwd_quantize_plain(*cts, x, scale, shift, bits, thresh=thresh,
                                tile=tile, h=h, w_img=w)
    d_amax = bwd[3]
    assert d_amax.shape == (n_out // tile,) and d_amax.dtype == torch.float32
    assert n_out // tile >= (1 if b == 2 else 3)
    for name, got in (("fwd_amax_plain", part[:, 0]), ("fwd_pre_plain",
                                                       pre_amax),
                      ("fwd_conv", fwd_out[4]), ("unpadded", unpadded)):
        assert torch.equal(got, d_amax), name
    # the wrapper on the CPU: the plain version, whose absmax it returns
    got = tr.bwd_quantize(*cts, x, scale, shift, bits, fwd_out[4],
                          thresh=thresh, tile=tile, h=h, w_img=w)
    for a, b_ in zip(got, bwd):
        assert torch.equal(a, b_)


# --- a model of the kernels' index math -----------------------------------------

def _gate_geometries(limit=32, cin=32, cout=64):
    """(b, h, w): every even h x w up to ``limit`` that the lane-through
    gate admits (models/blocks.py ``lane_through_eligible``: the
    transition's tile picker and conv2's), at the least power-of-two batch
    up to 128 that it admits."""
    out = []
    for h in range(2, limit + 1, 2):
        for w in range(2, limit + 1, 2):
            oh, ow = h // 2, w // 2
            for b in (1, 2, 4, 8, 16, 32, 64, 128):
                try:
                    tr.transition_tile(oh, ow, b * oh * ow, cin, cout)
                    pick_tile(oh * ow, b * oh * ow, cout)
                except ValueError:
                    continue
                out.append((b, h, w))
                break
    return out


GEOMETRIES = _gate_geometries()


def _units(n_out):
    """csrc/transition.cu ``UnitGeo.at`` on one channel: (ph, q0) of each
    unit, neighbouring units along a plane row."""
    per = n_out // 8
    u = np.arange(2 * per)
    ph = u // per
    return ph, (u - ph * per) * 8


def _emulate(b, h, w, rows):
    """The kernels' stores on one channel whose x is its input lane ids:
    (planes [4, N'], x_ee [N'], each output's write count)."""
    n_out = b * h * w // 4
    ph, q0 = _units(n_out)
    at = unit_pair_lanes(h, w, ph, q0, rows)
    assert (at % 2 == 0).all()   # a pair is one aligned 4-byte load
    planes = np.full((4, n_out), -1, dtype=np.int64)
    ee = np.full(n_out, -1, dtype=np.int64)
    writes = np.zeros((5, n_out), dtype=np.int64)
    lanes = q0[:, None] + np.arange(8)[None, :]
    for pw in (0, 1):
        p = 2 * ph[:, None] + pw + 0 * lanes
        planes[p, lanes] = at + pw
        np.add.at(writes, (p, lanes), 1)
    even = ph == 0
    ee[lanes[even]] = at[even]
    np.add.at(writes[4], lanes[even], 1)
    return planes, ee, writes


@pytest.mark.parametrize("b,h,w", GEOMETRIES)
def test_units_place_every_code_once(b, h, w):
    """Every geometry the lane-through gate admits up to 32x32: the per-lane
    unit load (both passes'; and, where output rows hold whole units, the
    fold's 16-byte one) writes each of the four parity planes' lanes and
    each x_ee lane once,
    from the pixel ``parity_planes`` and ``_even`` put there; each unit
    lies in one scale group."""
    n = b * h * w
    n_out = n // 4
    assert n_out % 8 == 0
    ids = torch.arange(n, dtype=torch.float64)[None]
    want = torch.stack(tr.parity_planes(ids, h, w))[:, 0].long().numpy()
    want_ee = tr._even(ids, h, w)[0].long().numpy()
    tile = tr.transition_tile(h // 2, w // 2, n_out, 32, 64)
    _, q0 = _units(n_out)
    assert (q0 // tile == (q0 + 7) // tile).all()
    tr.check_operand_geometry("transition_bwd", h, w, n, tile)
    for rows in {False, tr.operand_rows(w)}:
        planes, ee, writes = _emulate(b, h, w, rows)
        assert (writes == 1).all(), (rows, writes.min(), writes.max())
        np.testing.assert_array_equal(planes, want)
        np.testing.assert_array_equal(ee, want_ee)


def test_gate_geometries_cover_rows_off_8():
    """The model's grid holds the output rows off 8 pixels: 24x24, 12x12
    and 8x8 inputs (output rows of 12, 6 and 4 pixels), and WRN-28-10's
    16x16 and 32x32, where the 16-byte loads run too."""
    seen = {(h, w) for _, h, w in GEOMETRIES}
    assert {(24, 24), (12, 12), (8, 8), (16, 16), (32, 32)} <= seen
    assert tr.operand_rows(32) and tr.operand_rows(16)
    assert not any(tr.operand_rows(s) for s in (24, 12, 8))


def _cluster_walk(cout, tile):
    """fused_half.cuh ``cluster_quant_body`` on one group: (row, lane
    offset) of every unit the blocks' threads take (rank s, thread t:
    units s * 256 + t, + 8 * 256, ... below the group's units), through
    ``GroupWalk.at``."""
    units = cout * (tile // 8)
    out = [u for s in range(CLUSTER) for t in range(THREADS)
           for u in range(s * THREADS + t, units, CLUSTER * THREADS)]
    return [(u // (tile // 8), (u % (tile // 8)) * 8) for u in out]


@pytest.mark.parametrize("cout,tile", [(320, 1024), (640, 512), (64, 128),
                                       (64, 1152), (40, 384), (8, 128)])
def test_cluster_covers_each_group_once(cout, tile):
    """A scale group's units (Cout rows x tile / 8 chunks of 8 lanes) fall
    to the cluster's 8 blocks once each, in both of its passes (the same
    walk): at WRN-28-10's groups (320 x 1024, 640 x 512: 20 units a
    thread), and at groups smaller than the cluster's threads."""
    walk = _cluster_walk(cout, tile)
    assert len(walk) == len(set(walk)) == cout * tile // 8
    assert {off for _, off in walk} == set(range(0, tile, 8))
    assert {r for r, _ in walk} == set(range(cout))


def test_smoke_counts_one_fqt_operand_launch_a_transition():
    """chip_smoke.py's lane FQT step: one ``transition_bwd.quant`` launch a
    transition half (two a step) and no amax pass; its profile counts the
    rebuilt kernels, by demangled name, as the transition's."""
    import chip_smoke

    step = chip_smoke.LANE_FQT_PER_STEP
    assert step["transition_bwd.quant"] == 2
    assert "transition_bwd.amax" not in step
    assert chip_smoke.LANE_QAT_PER_STEP["transition_bwd.fold"] == 2
    for name in (
            "void (anonymous namespace)::bwd_quant_kernel("
            "fused_half::Cotangent, int, fused_half::GroupWalk, int, signed "
            "char*, float*, fused_half::Prologue, (anonymous "
            "namespace)::UnitGeo, float const*, signed char*, "
            "__nv_bfloat16*)",
            "void (anonymous namespace)::bwd_fold_kernel<false>("
            "fused_half::Cotangent, int, int, fused_half::Bf16Prologue, "
            "(anonymous namespace)::UnitGeo, __nv_bfloat16*, "
            "__nv_bfloat16*, __nv_bfloat16*)"):
        for kinds in (chip_smoke.KERNEL_KINDS, chip_smoke.WRN_KERNEL_KINDS):
            assert chip_smoke.kernel_kind(name, kinds) == "transition (port)"
