"""The port's bottleneck int8 serving (models/quantize.py ``fused_bneck``,
the NV kernels' plain versions, ``Predictor.quantize_int8``) against the
JAX package's ``Int8Inference`` on the same weights and images. The JAX
side runs its Pallas kernels in interpret mode; the port's wrappers run
their plain versions on the CPU.

The post-act net (16x16, batch 32: the JAX NV batch rule) has a stride-1
transition (32 -> 64 channels), identity blocks on both sides of the
crossover N >= 32*Cin and a stride-2 transition, so calibration and
serving cross the NV entry, the int8 carrier handoff at every block
boundary, the float-mode observers of both kinds of block and the bf16
exit.

Tolerances, as tests/test_torch_quantize.py argues them: calibration
scales 1e-2 relative (observed tensors follow bf16 convs summed in other
orders); serving logits with JAX's scales injected within 1% of the logit
range (an int8 code may flip where a value lies within an f32 rounding of
a .5 tie, because the bf16 layers around the trunk round in other
places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu.models import quantize as jq
from pytorch_ddp_resnet_tpu_torch.models import quantize as tq
from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv, conv3x3

from _torch_port_helpers import images, jax_model, port_model

SPEC = "c3,32,3,1,1 b2,64,32,1 b2,128,32,2 n a ap8,1,0 fc128,10"
HW, BATCH = 16, 32
BLOCKS = ["01_stack/block0", "01_stack/block1", "02_stack/block0",
          "02_stack/block1"]
KEYS = sorted(f"{b}/conv{i}" for b in BLOCKS for i in (1, 2, 3))


def _blocks(model):
    return {f"{s}/{b}": blk for s, stack in model.named_children()
            if hasattr(stack, "named_children") and s.endswith("stack")
            for b, blk in stack.named_children()}


def _jax_blocks(model):
    return {f"{s}/{b}": blk for s, layer in model.spine.layers
            if hasattr(layer, "layers") for b, blk in layer.layers}


@pytest.fixture(scope="module")
def net():
    jm, params, state = jax_model(SPEC, False, True, hw=HW)
    tm = port_model(SPEC, False, True, params, state)
    x = images(BATCH, hw=HW)
    out = dict(jm=jm, params=params, state=state, tm=tm, x=x,
               xt=torch.from_numpy(x))
    for mode in ("nv", False):
        inf = jq.Int8Inference(jm, params, state, fused_bneck=mode)
        scales = jq.calibrate(inf, [jnp.asarray(x)])
        out[mode] = dict(scales=scales, logits=np.asarray(
            jax.jit(inf.serve_fn(scales))(jnp.asarray(x))))
    return out


def test_gates_match_jax(net):
    tb, jb = _blocks(net["tm"]), _jax_blocks(net["jm"])
    assert sorted(tb) == sorted(jb) == BLOCKS
    shapes = [(BATCH, 16, 16, 32), (BATCH, 16, 16, 64), (BATCH, 16, 16, 64),
              (BATCH, 8, 8, 128), (16, 16, 16, 64), (48, 16, 16, 64),
              (BATCH, 14, 14, 64), (BATCH, 16, 15, 64), (64, 8, 8, 128)]
    for name in BLOCKS:
        for shape in shapes:
            for gate in ("_bneck_eligible", "_nv_id_eligible",
                         "_nv_trans_eligible"):
                assert (getattr(tq, gate)(tb[name], shape)
                        == getattr(jq, gate)(jb[name], shape)), \
                    (name, shape, gate)
    # the test net routes as the ResNet-50 trunk does
    assert tq._nv_trans_eligible(tb["01_stack/block0"], (BATCH, 16, 16, 32))
    assert tq._bneck_eligible(tb["01_stack/block1"], (BATCH, 16, 16, 64))
    assert tq._nv_trans_eligible(tb["02_stack/block0"], (BATCH, 16, 16, 64))
    assert not tq._bneck_eligible(tb["02_stack/block1"], (BATCH, 8, 8, 128))
    assert tq._nv_id_eligible(tb["02_stack/block1"], (BATCH, 8, 8, 128))
    for conv in ("conv1", "conv2", "conv3"):
        assert (tq._conv1x1_ok(getattr(tb["01_stack/block1"], conv))
                == jq._conv1x1_ok(jb["01_stack/block1"]._sublayers()[
                    ("conv1", "conv2", "conv3").index(conv)][1]))


@pytest.mark.parametrize("mode", ["nv", False])
def test_bneck_calibration_matches_jax(net, mode):
    scales = tq.calibrate(tq.Int8Inference(net["tm"], fused_bneck=mode),
                          [net["xt"]])
    want = net[mode]["scales"]
    # a missing key would drop its block out of the NV run silently
    assert sorted(scales) == sorted(want)
    if mode == "nv":
        assert sorted(scales) == KEYS
    else:  # only the identity block above the crossover
        assert sorted(scales) == [f"01_stack/block1/conv{i}"
                                  for i in (1, 2, 3)]
    for k, v in want.items():
        np.testing.assert_allclose(scales[k], v, rtol=1e-2, err_msg=k)


@pytest.mark.parametrize("mode", ["nv", False])
def test_bneck_serving_with_jax_scales_matches_jax(net, mode):
    ref = net[mode]["logits"]
    bneck_nv.reset_launches()
    got = tq.Int8Inference(net["tm"], fused_bneck=mode).serve_fn(
        net[mode]["scales"])(net["xt"]).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=0.01 * np.abs(ref).max())
    assert sum(bneck_nv.launches.values()) == 0  # plain versions on the CPU


def test_nv_and_nhwc_substrates_stay_close(net):
    """Where both run, the NV trunk and the NHWC products track the float
    model and each other (cf. the JAX test_nv_bneck_serving_close_to_
    float, whose bounds this uses)."""
    with torch.no_grad():
        ref = net["tm"](net["xt"]).numpy()
    scale = np.abs(ref).max()
    out = {}
    for mode in ("nv", False):
        inf = tq.Int8Inference(net["tm"], fused_bneck=mode)
        out[mode] = inf.serve_fn(tq.calibrate(inf, [net["xt"]]))(
            net["xt"]).numpy()
        assert np.abs(out[mode] - ref).max() < 0.1 * scale + 0.05
    assert np.abs(out["nv"] - out[False]).max() < 0.1 * scale + 0.05
    assert tq.Int8Inference(net["tm"], fused_bneck=True).fused_bneck == "nv"
    with pytest.raises(ValueError, match="fused_bneck"):
        tq.Int8Inference(net["tm"], fused_bneck="flat")


@pytest.mark.parametrize("mode", ["nv", False])
def test_bneck_plain_switch_is_the_cpu_path(net, mode):
    scales = net[mode]["scales"]
    bneck_nv.reset_launches()
    conv3x3.reset_launches()
    a = tq.Int8Inference(net["tm"], fused_bneck=mode).serve_fn(scales)(
        net["xt"])
    b = tq.Int8Inference(net["tm"], fused_bneck=mode, plain=True).serve_fn(
        scales)(net["xt"])
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert sum(bneck_nv.launches.values()) == 0
    assert sum(conv3x3.launches.values()) == 0


def test_nv_walk_calls_each_block_kernel_once(net, monkeypatch):
    """Int8 mode routes the four blocks through the NV wrappers, with an
    int8 carrier between them and a bf16 exit after the last."""
    calls = []
    inf = tq.Int8Inference(net["tm"], fused_bneck="nv")
    for attr in ("_block_nv", "_trans_nv"):
        orig = getattr(inf, attr)

        def wrap(*args, _orig=orig, _attr=attr, **kw):
            calls.append((_attr, args[0].dtype, kw["out_int8"]))
            return _orig(*args, **kw)

        monkeypatch.setattr(inf, attr, wrap)
    inf.serve_fn(net["nv"]["scales"])(net["xt"])
    assert calls == [("_trans_nv", torch.int8, True),
                     ("_block_nv", torch.int8, True),
                     ("_trans_nv", torch.int8, True),
                     ("_block_nv", torch.int8, False)]


def test_preact_bottleneck_serves_through_nhwc_products():
    """A preact bottleneck net (the resnet-v2-164 family) serves its
    identity blocks on the NHWC int8 products under either fused_bneck
    (the NV gates take post-act blocks only)."""
    spec = "c3,64,3,1,1 b2 n a ap8,1,0 fc64,10"
    jm, params, state = jax_model(spec, True, True, hw=8)
    tm = port_model(spec, True, True, params, state)
    x = images(32)
    for mode in ("nv", False):
        jinf = jq.Int8Inference(jm, params, state, fused_bneck=mode)
        jscales = jq.calibrate(jinf, [jnp.asarray(x)])
        ref = np.asarray(jax.jit(jinf.serve_fn(jscales))(jnp.asarray(x)))
        inf = tq.Int8Inference(tm, fused_bneck=mode)
        scales = tq.calibrate(inf, [torch.from_numpy(x)])
        assert sorted(scales) == sorted(jscales) == [
            f"01_stack/block{b}/conv{i}" for b in (0, 1) for i in (1, 2, 3)]
        got = inf.serve_fn(jscales)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=0.01 * np.abs(ref).max())


def test_predictor_quantize_int8_serves_the_nv_trunk(net):
    """``Predictor.quantize_int8`` with the JAX default ``fused_bneck="nv"``
    on raw uint8 images (no preprocessing), calibrated and served by each
    package on its own: 12 quantized convs, logits within 1% of the logit
    range."""
    from pytorch_ddp_resnet_tpu.algos.predict import Predictor as JPredictor
    from pytorch_ddp_resnet_tpu_torch.algos.predict import Predictor

    raw = np.random.default_rng(3).integers(0, 256, (40, HW, HW, 3),
                                            dtype=np.uint8)
    jp = JPredictor(net["jm"], net["params"], net["state"], None,
                    batch_size=BATCH)
    tp = Predictor(net["tm"], None, batch_size=BATCH, device="cpu")
    assert jp.quantize_int8(raw) == tp.quantize_int8(raw) == 12
    ref = jp.logits(raw)
    got = tp.logits(raw)  # 40 = 32 + a padded 8
    assert got.shape == ref.shape == (40, 10)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=0.01 * np.abs(ref).max())
