"""The port's float model (spec parser, layers, blocks, ResNet, weight
conversion, BatchNorm folding) against the JAX package on the same weights
and inputs.

Tolerances: at compute dtype float32 both packages evaluate the same f32
formulas with different summation orders, so logits agree to ~1e-5
relative (asserted: 1e-4 of the logit range); at bf16, a 1-ulp rounding
difference in one layer propagates (asserted: the 2e-2 that
tests/test_quantize.py allows between two bf16 conv implementations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ddp_resnet_tpu.models.resnet import ResNet as JaxResNet
from pytorch_ddp_resnet_tpu_torch.convert import state_dict_from_jax
from pytorch_ddp_resnet_tpu_torch.models.fold import fold_batchnorm
from pytorch_ddp_resnet_tpu_torch.models.resnet import ResNet, parse_spec

from _torch_port_helpers import images, jax_model, port_model

GOLDEN = [
    ("resnet20", "c3,16,3,1,1 n a r3 r3 r3 ap8,1,0 fc64,10", False, False,
     32, 269738),
    ("wrn-28-10", "c3,160,3,1,1 r4 r4 r4 n a ap8,1,0 fc640,10", True, True,
     32, 36688330),
    ("extended", "c3,16,3,1,1 r2,32,2 r1,32,1 n a ap16,1,0 fc32,10", True,
     True, 32, None),
]


@pytest.mark.parametrize("name,spec,preact,proj,hw,count", GOLDEN)
def test_param_counts_match_jax(name, spec, preact, proj, hw, count):
    jm = JaxResNet(spec, preact=preact, use_proj=proj, dropout_prob=0.3)
    shapes = jax.eval_shape(lambda k: jm.init(k, (hw, hw, 3)),
                            jax.random.PRNGKey(0))
    jcount = sum(int(np.prod(a.shape))
                 for a in jax.tree_util.tree_leaves(shapes[0]))
    tm = ResNet(spec, preact, proj, 0.3, device="cpu")
    assert tm.param_count() == jcount
    if count is not None:
        assert jcount == count
    # layer names are the JAX pytree keys
    assert [n for n, _ in tm.named_children()] == [
        n for n, _ in jm.spine.layers]


def test_spec_quirks():
    names = [n for n, _ in parse_spec("c3,8,3,1,1 n a r1 r1 ap8,1,0 fc16,10",
                                      True, True, 0.0)]
    assert names == ["00_conv", "01_bn", "02_relu", "03_stack", "04_stack",
                     "05_avgpool", "06_fc"]
    # [a-z]+ prefix: 'fc16,10' is 'f16,10'; adjacency doubles channels
    tm = ResNet("c3,8,3,1,1 r1 r1 ap4,1,0 fc16,10", True, True, 0.0,
                device="cpu")
    assert tm.get_submodule("02_stack.block0").out_channels == 16
    assert tm.get_submodule("02_stack.block0").stride == 2
    # bottleneck stacks build, with int8 fully quantized training and QAT
    # too
    tm = ResNet("c3,64,3,1,1 b2", False, True, 0.0, device="cpu")
    assert tm.get_submodule("01_stack.block1").bottleneck_channels == 16
    for bwd in (True, False):
        tm = ResNet("c3,64,3,1,1 b2", False, True, 0.0, int8_train=True,
                    int8_train_bwd=bwd, device="cpu")
        assert tm.get_submodule("01_stack.block1").int8_train_bwd == bwd
    with pytest.raises(ValueError):
        parse_spec("c3,8,3,1,1 q1", True, True, 0.0)


NETS = [  # (spec, preact, use_proj): identity + transition blocks
    ("c3,32,3,1,1 r1 r1 n a ap4,1,0 fc64,10", True, True),
    ("c3,16,3,1,1 n a r1 r1 ap4,1,0 fc32,10", False, True),
    ("c3,16,3,1,1 n a r1 r1 ap4,1,0 fc32,10", False, False),
    ("c3,16,3,1,1 r1 r1 n a mp3,2,1 ap2,1,0 fc32,10", True, False),
]


def _logits_pair(spec, preact, proj, dtype, n=4):
    jm, params, state = jax_model(spec, preact, proj, dtype)
    x = images(n)
    ref, _ = jax.jit(lambda p, s, xx: jm.apply(p, s, xx, train=False))(
        params, state, jnp.asarray(x))
    tm = port_model(spec, preact, proj, params, state, dtype)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    return np.asarray(ref), got.numpy(), tm, x


@pytest.mark.parametrize("spec,preact,proj", NETS)
def test_float32_logits_match_jax(spec, preact, proj):
    ref, got, _, _ = _logits_pair(spec, preact, proj, "float32")
    assert got.dtype == np.float32 and got.shape == ref.shape
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("spec,preact,proj", NETS[:2])
def test_bf16_logits_match_jax(spec, preact, proj):
    ref, got, _, _ = _logits_pair(spec, preact, proj, "bfloat16")
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)


@pytest.mark.parametrize("spec,preact,proj", NETS[1:3])
def test_fold_batchnorm_leaves_postact_logits(spec, preact, proj):
    ref, got, tm, x = _logits_pair(spec, preact, proj, "float32")
    folded, n = fold_batchnorm(tm)
    assert n == 5  # stem BN + two convs in each of two blocks
    with torch.no_grad():
        got_f = folded(torch.from_numpy(x)).numpy()
    # folding is exact algebra; only f32 rounding of W*inv differs
    np.testing.assert_allclose(got_f, got, rtol=0,
                               atol=1e-4 * np.abs(got).max())
    # the original model is untouched
    with torch.no_grad():
        np.testing.assert_array_equal(tm(torch.from_numpy(x)).numpy(), got)


def test_fold_skips_preact_blocks():
    _, _, tm, _ = _logits_pair(*NETS[0], "float32", n=1)
    _, n = fold_batchnorm(tm)
    assert n == 0


def test_state_dict_keys_are_jax_key_paths():
    spec, preact, proj = NETS[0]
    _, params, state = jax_model(spec, preact, proj)
    sd = state_dict_from_jax(params, state)
    tm = ResNet(spec, preact, proj, 0.0, device="cpu")
    assert set(sd) == set(tm.state_dict())
    w = np.asarray(params["01_stack"]["block0"]["conv1"]["w"])
    np.testing.assert_array_equal(
        sd["01_stack.block0.conv1.weight"].numpy(), w.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["06_fc.weight"].numpy(),
                                  np.asarray(params["06_fc"]["w"]).T)
    assert sd["03_bn.count"].dtype == torch.int32


def test_modules_are_eval_only():
    """Modules start in eval mode (the serving default) and only ``train()``
    switches on batch statistics."""
    tm = ResNet(*NETS[0], 0.0, device="cpu")
    assert not any(m.training for m in tm.modules())
    x = torch.from_numpy(images(2))
    with torch.no_grad():
        y_eval = tm(x)
        y_train = tm.train()(x)
    assert not torch.equal(y_eval, y_train)
    assert all(int(b) == 1 for n, b in tm.named_buffers()
               if n.endswith("count"))
