"""The stem's weight gradient as the card computes it (ops/cuda/stem.py
``stem_wgrad``, ``stem_wgrad_plan``; csrc/stem.cu ``stem_wgrad_tc_kernel``
and ``stem_wgrad_sum_kernel``), on the CPU:

- a numpy model of the kernel: each block's contiguous run of K steps of 64
  positions (``stem_wgrad_plan``), the [NP, 64] tap tile built from x
  (the 9 * Cin tap rows, zero off the image, then the row of ones that
  gives db, then zero rows to a multiple of 16), each step's products
  summed and rounded once to f32 (the MMAs start from zero every step)
  and added into the block's f32 sums, the blocks' slots added in the sum
  kernel's fixed order (runs of consecutive slots, then the runs);
- the model's tap tile is the plain version's taps; its dW and db agree
  with ``stem_wgrad_plain`` and with the gradient of JAX's
  ``stem_conv_lane(..., interpret=True)`` at Cin 1, 3 and 8;
- the plan covers the K steps with runs, none empty, and the geometry
  rule refuses, naming them, shapes off the kernel's.

Inputs are made with numpy from a seed. Tolerance: 1e-5 of the largest
value (f32 sums over positions in another order than the reference's, as
the card check holds the kernel to its plain version).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu.ops.pallas import stem as jstem
from pytorch_ddp_resnet_tpu_torch.ops.cuda import stem as st

KC = st.WG_KC
SUM_RUNS = 32   # csrc/stem.cu: the sum kernel's runs of slots


def tap_tile(x, h, w, p0, cin):
    """The kernel's [NP, KC] tap tile of the K step at position p0, f32:
    row tap * Cin + c is x[c] at the tap's shift (zero off the image), row
    9 * Cin all ones, the rest zero."""
    k = 9 * cin + 1
    npad = -(-k // 16) * 16
    out = np.zeros((npad, KC), np.float32)
    p = p0 + np.arange(KC)
    hh, ww = (p % (h * w)) // w, p % w
    for tap in range(9):
        dh, dw = tap // 3 - 1, tap % 3 - 1
        ok = (hh + dh >= 0) & (hh + dh < h) & (ww + dw >= 0) & (ww + dw < w)
        src = np.where(ok, p + dh * w + dw, 0)
        out[tap * cin:(tap + 1) * cin] = np.where(ok, x[:, src], 0.0)
    out[k - 1] = 1.0
    return out


def run_sum(slots):
    """stem_wgrad_sum_kernel: SUM_RUNS runs of consecutive slots, each
    summed in order in f32 from zero, then the runs in order."""
    per = -(-slots.shape[0] // SUM_RUNS)
    runs = []
    for q in range(SUM_RUNS):
        s = np.zeros(slots.shape[1:], np.float32)
        for t in range(q * per, min(slots.shape[0], (q + 1) * per)):
            s = s + slots[t]
        runs.append(s)
    out = runs[0]
    for r in runs[1:]:
        out = out + r
    return out


def kernel_model(dy, x, h, w):
    """(dW [Cout, 9*Cin], db [Cout]) f32 as the kernel computes them on
    ``stem_wgrad_plan``'s runs: dy [Cout, N], x [Cin, N] float32 holding
    bf16 values."""
    cout, n = dy.shape
    cin = x.shape[0]
    k = 9 * cin + 1
    plan = st.stem_wgrad_plan(n, cout, h, w)
    slots = np.zeros((plan.blocks, cout, k), np.float32)
    for b in range(plan.blocks):
        acc = np.zeros((cout, k), np.float32)
        for i in range(b * plan.per, min(plan.steps, (b + 1) * plan.per)):
            taps = tap_tile(x, h, w, i * KC, cin)[:k].astype(np.float64)
            step = dy[:, i * KC:(i + 1) * KC].astype(np.float64) @ taps.T
            acc = acc + step.astype(np.float32)
        slots[b] = acc
    out = run_sum(slots)
    return out[:, :-1], out[:, -1]


def _bf16(rng, *shape):
    return np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16),
                      np.float32)


def _close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("cin,h,w,b", [(1, 8, 8, 4), (3, 16, 16, 2),
                                       (8, 8, 8, 2), (3, 4, 64, 2)])
def test_tap_tile_is_the_plain_versions_taps(cin, h, w, b):
    rng = np.random.default_rng(cin + h)
    n = b * h * w
    x = _bf16(rng, cin, n)
    taps = st._taps(torch.from_numpy(x), h, w).reshape(9 * cin, n).numpy()
    for i in range(n // KC):
        tile = tap_tile(x, h, w, i * KC, cin)
        np.testing.assert_array_equal(tile[:9 * cin],
                                      taps[:, i * KC:(i + 1) * KC])
        assert (tile[9 * cin] == 1).all() and not tile[9 * cin + 1:].any()
        assert tile.shape[0] % 16 == 0


# (cin, cout, h, w, b): Cin 1, 3 (the model zoo's) and 8 (the most the
# kernel takes); a batch of one image; WRN-28-10's 32x32 at a small batch
STEM_SHAPES = [(1, 16, 8, 8, 8), (3, 32, 8, 8, 8), (8, 32, 16, 16, 2),
               (3, 160, 32, 32, 2), (3, 16, 16, 16, 1)]


@pytest.mark.parametrize("cin,cout,h,w,b", STEM_SHAPES)
def test_kernel_model_agrees_with_plain_and_jax(cin, cout, h, w, b):
    rng = np.random.default_rng(cout + cin)
    n = b * h * w
    x, dy = _bf16(rng, cin, n), _bf16(rng, cout, n)
    dw, db = kernel_model(dy, x, h, w)
    pw, pb = st.stem_wgrad_plain(torch.from_numpy(dy).to(torch.bfloat16),
                                 torch.from_numpy(x).to(torch.bfloat16),
                                 h=h, w_img=w)
    _close(dw, pw.numpy())
    _close(db, pb.numpy())
    wt = (rng.standard_normal((3, 3, cin, cout)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    _, vjp = jax.vjp(
        lambda xx, ww, bb: jstem.stem_conv_lane(xx, ww, bb, h=h, w_img=w,
                                                interpret=True),
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt), jnp.asarray(bias))
    _, jdw, jdb = vjp(jnp.asarray(dy, jnp.bfloat16))
    _close(dw.reshape(cout, 3, 3, cin).transpose(1, 2, 3, 0),
           np.asarray(jdw))
    _close(db, np.asarray(jdb))


def test_runs_are_summed_in_a_fixed_order():
    """The sum kernel's order is not the slots' sequential order, but it is
    fixed: the same slots give the same bits, and with at most SUM_RUNS
    slots it is the sequential order."""
    rng = np.random.default_rng(0)
    few = (rng.standard_normal((20, 7)) * 10.0 ** rng.uniform(
        -3, 3, (20, 1))).astype(np.float32)
    seq = few[0]
    for s in few[1:]:
        seq = seq + s
    np.testing.assert_array_equal(run_sum(few), seq)
    many = np.tile(few, (13, 1))
    np.testing.assert_array_equal(run_sum(many), run_sum(many.copy()))


def test_plan_at_the_wrn_stem():
    """WRN-28-10 at batch 128: 2,048 K steps of 64 positions in 256 runs
    of 8, two blocks on each of 132 SMs (and four short of it)."""
    p = st.stem_wgrad_plan(128 * 32 * 32, 160, 32, 32)
    assert (p.steps, p.per, p.blocks) == (2048, 8, 256)


@pytest.mark.parametrize("n,cout,h,w", [(512, 32, 8, 8), (64, 16, 8, 8),
                                        (1024, 256, 16, 16),
                                        (128 * 1024 * 4, 64, 32, 32),
                                        (3 * 64 * 7, 16, 8, 8)])
def test_plan(n, cout, h, w):
    p = st.stem_wgrad_plan(n, cout, h, w)
    assert p.steps * KC == n
    assert (p.blocks - 1) * p.per < p.steps <= p.blocks * p.per
    assert p.blocks <= st.SMS * st.WG_BLOCKS_PER_SM
    assert p == st.stem_wgrad_plan(n, cout, h, w)


@pytest.mark.parametrize("n,cout,h,w,match", [
    (96, 16, 4, 4, "not a multiple of the 64-position K step"),
    (200, 16, 4, 4, "N=200 of 4x4 images"),
    (512, 257, 8, 8, "Cout=257 is not in 1..256")])
def test_geometry_refusals_name_the_shape(n, cout, h, w, match):
    with pytest.raises(ValueError, match=match):
        st.stem_wgrad_plan(n, cout, h, w)


def test_cpu_path_is_the_plain_version():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_bf16(rng, 3, 512)).to(torch.bfloat16)
    dy = torch.from_numpy(_bf16(rng, 32, 512)).to(torch.bfloat16)
    st.reset_launches()
    got = st.stem_wgrad(dy, x, h=8, w_img=8)
    assert not st.launches
    for a, b in zip(got, st.stem_wgrad_plain(dy, x, h=8, w_img=8)):
        assert torch.equal(a, b)
