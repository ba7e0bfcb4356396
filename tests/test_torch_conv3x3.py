"""The port's 3x3 conv module (pytorch_ddp_resnet_tpu_torch/ops/cuda/
conv3x3.py) against the JAX package's Pallas kernels (ops/pallas/conv.py)
run in interpret mode on the CPU, on the same numpy inputs.

On the CPU the port's wrappers run their plain versions, which these
tests hold against JAX. Tolerances:
- the s32 accumulator is exact in both packages: equal;
- int8 outputs: at most 1 level apart (a y*inv landing within one f32
  rounding of a .5 tie can round either way when the two packages order
  or contract the epilogue's f32 ops differently), on <= 1% of elements;
- bf16 outputs: at most 1 bf16 ulp apart (f32 vs float64 accumulation
  can straddle a bf16 rounding boundary).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu.ops.pallas import conv as jconv
from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3 as tconv

H, W, B = 8, 8, 2


def _bf16_ulp(ref: np.ndarray) -> np.ndarray:
    # spacing of bf16 at |ref| (8 significant bits)
    mag = np.maximum(np.abs(ref), np.float32(2.0 ** -126))
    return np.float32(2.0) ** (np.floor(np.log2(mag)) - 7)


def _rand(cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    n = B * H * W
    return dict(
        xq=rng.integers(-127, 128, (cin, n), dtype=np.int8),
        wq=rng.integers(-127, 128, (cout, 9 * cin), dtype=np.int8),
        xf=rng.standard_normal((cin, n), dtype=np.float32),
        wf=(rng.standard_normal((cout, 9 * cin)) * 0.1).astype(np.float32),
        scale=(np.abs(rng.standard_normal(cout)) * 2e-5).astype(np.float32),
        shift=rng.standard_normal(cout).astype(np.float32),
        res=rng.standard_normal((cout, n), dtype=np.float32),
        sb=(rng.standard_normal(cout) * 20).astype(np.float32),
        tb=(rng.standard_normal(cout) * 2).astype(np.float32),
    )


def test_pack_weights_matches_jax():
    rng = np.random.default_rng(0)
    w_hwio = rng.standard_normal((3, 3, 32, 48)).astype(np.float32)
    ref = np.asarray(jconv.pack_weights(jnp.asarray(w_hwio)))
    got = tconv.pack_weights(torch.from_numpy(w_hwio.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("hw,n,c", [(64, 512, 32), (1024, 131072, 160),
                                    (256, 32768, 320), (64, 8192, 640),
                                    (49, 6272, 128), (64, 64, 32)])
def test_pick_tile_is_the_jax_gate(hw, n, c):
    def run(f):
        try:
            return f(hw, n, c)
        except ValueError:
            return "raises"

    assert run(tconv.pick_tile) == run(jconv._pick_tile)


def test_bf16_plain_matches_jax_conv3x3_lanes():
    d = _rand(32, 32)
    x = jnp.asarray(d["xf"], jnp.bfloat16)
    w = jnp.asarray(d["wf"], jnp.bfloat16)
    ref = np.asarray(jconv.conv3x3_lanes(x, w, h=H, w_img=W,
                                         interpret=True), np.float32)
    tx = torch.from_numpy(d["xf"]).to(torch.bfloat16)
    tw = torch.from_numpy(d["wf"]).to(torch.bfloat16)
    before = dict(tconv.launches)
    got = tconv.conv3x3_bf16(tx, tw, h=H, w_img=W)
    assert got.dtype == torch.bfloat16
    assert dict(tconv.launches) == before  # the CPU runs no kernel
    diff = np.abs(got.float().numpy() - ref)
    assert (diff <= _bf16_ulp(ref)).all(), diff.max()


@pytest.mark.parametrize("cin,cout", [(32, 32), (64, 32)])
def test_s32_accumulator_is_exact(cin, cout):
    d = _rand(cin, cout, seed=1)
    ref = np.asarray(jconv.conv3x3_lanes(
        jnp.asarray(d["xq"]), jnp.asarray(d["wq"]), h=H, w_img=W,
        interpret=True))
    got = tconv.conv3x3_s32_plain(torch.from_numpy(d["xq"]),
                                  torch.from_numpy(d["wq"]), h=H, w_img=W)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


MODES = [  # (relu, int8 out, residual, dual)
    (True, True, False, False), (False, True, True, False),
    (False, False, False, False), (True, False, True, False),
    (False, False, True, True), (True, False, True, True),
]


@pytest.mark.parametrize("relu,quant,use_res,dual", MODES)
def test_requant_plain_matches_jax(relu, quant, use_res, dual):
    d = _rand(32, 32, seed=2)
    inv = 1.0 / 0.04 if quant else None
    j_args = [jnp.asarray(d["xq"]), jnp.asarray(d["wq"]),
              jnp.asarray(d["scale"]), jnp.asarray(d["shift"])]
    t_args = [torch.from_numpy(d[k]) for k in ("xq", "wq", "scale", "shift")]
    j_res = jnp.asarray(d["res"]) if use_res else None
    t_res = torch.from_numpy(d["res"]) if use_res else None
    j_dual = (jnp.asarray(d["sb"]), jnp.asarray(d["tb"])) if dual else None
    t_dual = ((torch.from_numpy(d["sb"]), torch.from_numpy(d["tb"]))
              if dual else None)
    ref = jconv.conv3x3_lanes_requant(
        *j_args, j_res, j_dual, h=H, w_img=W, relu=relu, inv_out_scale=inv,
        interpret=True)
    got = tconv.conv3x3_int8_requant(
        *t_args, t_res, t_dual, h=H, w_img=W, relu=relu, inv_out_scale=inv)
    refs = ref if dual else (ref,)
    gots = got if dual else (got,)
    kinds = [torch.int8 if quant else torch.bfloat16] + (
        [torch.int8] if dual else [])
    assert len(refs) == len(gots) == len(kinds)
    for r, g, kind in zip(refs, gots, kinds):
        assert g.dtype == kind
        r = np.asarray(r.astype(jnp.float32))
        g = g.to(torch.float32).numpy()
        diff = np.abs(g - r)
        if kind == torch.int8:
            assert diff.max() <= 1
            assert (diff > 0).mean() <= 0.01
        else:
            assert (diff <= _bf16_ulp(r)).all(), diff.max()
        # the mode really exercises its range: not all clipped or zero
        assert np.unique(g).size > 3


def test_dual_requires_bf16_carrier():
    d = _rand(32, 32)
    t = [torch.from_numpy(d[k]) for k in ("xq", "wq", "scale", "shift")]
    with pytest.raises(ValueError, match="dual"):
        tconv.conv3x3_int8_requant(*t, None, (t[2], t[3]), h=H, w_img=W,
                                   inv_out_scale=2.0)
