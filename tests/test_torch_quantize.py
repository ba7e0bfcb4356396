"""The port's int8 serving slice (models/quantize.py) against the JAX
package's Int8Inference on the same weights and images. The JAX side runs
as its own tests run it: its Pallas kernels switch to interpret mode off
the TPU; the port's wrappers run their plain versions on the CPU.

The net has an identity block and a transition block, so calibration and
serving cross the lane entry, the transition's conv2 with the shortcut in
its epilogue, the dual epilogue and the lane exit.

Tolerances:
- calibration scales (absmax/127 of each quantized conv's input): 1e-2
  relative. The observed tensors follow bf16 convs whose f32 sums are
  ordered differently in the two packages, so an absmax may move by a
  bf16 ulp (2^-8 relative), and by that much again after the next layer.
  (Measured on these nets: 1e-7.)
- serving logits with JAX's scales injected: within 1% of the logit range
  (measured: 0.15-0.24%).
  The int8 codes agree except where a value lies within an f32 rounding of
  a .5 tie (the two packages differ in f32 op contraction and in the bf16
  layers around the trunk); one flipped code moves a conv input by one
  quantization step, and the head averages over the whole image.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu.models import quantize as jq
from pytorch_ddp_resnet_tpu_torch.models import quantize as tq
from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3

from _torch_port_helpers import images, jax_model, port_model

SPEC = "c3,32,3,1,1 r1 r1 n a ap4,1,0 fc64,10"
KEYS = ["01_stack/block0/conv1", "01_stack/block0/conv2",
        "02_stack/block0/conv2"]


def test_weight_quantization_matches_jax():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((3, 3, 32, 48)) * 0.3).astype(np.float32)
    jw, js = jq.quantize_conv_weights(jnp.asarray(w))
    tw, ts = tq.quantize_conv_weights(
        torch.from_numpy(w.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tw.numpy(),
                                  np.asarray(jw).transpose(3, 2, 0, 1))


@pytest.fixture(scope="module", params=[(True, True), (False, True),
                                        (False, False)],
                ids=["preact-proj", "postact-proj", "postact-optionA"])
def pair(request):
    preact, proj = request.param
    jm, params, state = jax_model(SPEC, preact, proj)
    tm = port_model(SPEC, preact, proj, params, state)
    x = images(8)
    j_inf = jq.Int8Inference(jm, params, state)
    j_scales = jq.calibrate(j_inf, [jnp.asarray(x)])
    j_logits = np.asarray(jax.jit(j_inf.serve_fn(j_scales))(jnp.asarray(x)))
    return dict(tm=tm, x=torch.from_numpy(x), j_scales=j_scales,
                j_logits=j_logits, preact=preact)


def test_calibration_scales_match_jax(pair):
    inf = tq.Int8Inference(pair["tm"])
    scales = tq.calibrate(inf, [pair["x"]])
    assert sorted(scales) == sorted(pair["j_scales"]) == KEYS
    for k in KEYS:
        np.testing.assert_allclose(scales[k], pair["j_scales"][k],
                                   rtol=1e-2)


def test_serving_with_jax_scales_matches_jax(pair):
    inf = tq.Int8Inference(pair["tm"])
    got = inf.serve_fn(pair["j_scales"])(pair["x"]).numpy()
    ref = pair["j_logits"]
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=0.01 * np.abs(ref).max())


def test_plain_switch_is_the_cpu_path(pair):
    """``plain=True`` (the card-side check) computes what the CPU wrappers
    compute, launch for launch, without counting launches."""
    conv3x3.reset_launches()
    a = tq.Int8Inference(pair["tm"]).serve_fn(pair["j_scales"])(pair["x"])
    b = tq.Int8Inference(pair["tm"], plain=True).serve_fn(
        pair["j_scales"])(pair["x"])
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert sum(conv3x3.launches.values()) == 0


def test_ineligible_width_quantizes_nothing():
    # 16 channels: 16 % 32 != 0, as the v1 CIFAR nets
    spec = "c3,16,3,1,1 n a r1 ap8,1,0 fc16,10"
    jm, params, state = jax_model(spec, False, False)
    tm = port_model(spec, False, False, params, state)
    x = images(4)
    assert tq.calibrate(tq.Int8Inference(tm), [torch.from_numpy(x)]) == {}
    assert jq.calibrate(jq.Int8Inference(jm, params, state),
                        [jnp.asarray(x)]) == {}
