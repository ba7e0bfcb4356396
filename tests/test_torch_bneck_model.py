"""The port's bottleneck float model (``BottleneckResidualBlock``, the
``b`` spec tokens, BatchNorm folding) against the JAX package on the same
weights and inputs.

Tolerances, as tests/test_torch_model.py argues them: float32 logits to
1e-4 of the logit range (the same f32 formulas summed in other orders);
bf16 logits to 2e-2 (a 1-ulp rounding difference in one layer
propagates); the train-mode forward, with the JAX dropout bits injected,
to 1e-4 of the logit range and the BatchNorm buffers to 1e-5 of their
scale (batch statistics are f32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pytorch_ddp_resnet_tpu.models.fold import (
    fold_batchnorm as jax_fold_batchnorm,
)
from pytorch_ddp_resnet_tpu.models.resnet import ResNet as JaxResNet
from pytorch_ddp_resnet_tpu_torch.convert import state_dict_from_jax
from pytorch_ddp_resnet_tpu_torch.models.blocks import (
    BottleneckResidualBlock,
)
from pytorch_ddp_resnet_tpu_torch.models.fold import fold_batchnorm
from pytorch_ddp_resnet_tpu_torch.models.resnet import ResNet

from _torch_port_helpers import JaxKey, images, jax_model, port_model

MODELS_DIR = "models_dir"
# (config, golden parameter count: JAX tests/test_spec_parser.py)
GOLDEN = [("resnet-50_ilsvrc2012", 224, 25549416),
          ("wrn-50-2-bottleneck_ilsvrc2012", 224, 68875624),
          ("resnet-v2-164_cifar10", 32, 1704458)]


@pytest.mark.parametrize("name,hw,count", GOLDEN)
def test_shipped_bottleneck_configs_match_jax_param_counts(name, hw, count):
    with open(f"{MODELS_DIR}/{name}/config.yaml") as f:
        cfg = yaml.safe_load(f)
    spec, preact, proj = (cfg["architecture_spec"], cfg["preact"],
                          cfg["use_proj"])
    jm = JaxResNet(spec, preact=preact, use_proj=proj, dropout_prob=0.0)
    shapes = jax.eval_shape(lambda k: jm.init(k, (hw, hw, 3)),
                            jax.random.PRNGKey(0))
    jcount = sum(int(np.prod(a.shape))
                 for a in jax.tree_util.tree_leaves(shapes[0]))
    tm = ResNet(spec, preact, proj, 0.0, device="cpu")
    assert tm.param_count() == jcount == count
    # every block's geometry is the JAX block's
    for (sname, jstack), (tname, tstack) in zip(jm.spine.layers,
                                                tm.named_children()):
        assert sname == tname
        if not hasattr(jstack, "layers"):
            continue
        for (jb_name, jb), (tb_name, tb) in zip(jstack.layers,
                                                tstack.named_children()):
            assert jb_name == tb_name
            assert isinstance(tb, BottleneckResidualBlock)
            for attr in ("in_channels", "bottleneck_channels",
                         "out_channels", "stride", "transforms_shortcut"):
                assert getattr(tb, attr) == getattr(jb, attr), (tb_name, attr)


NETS = [  # (spec, preact, use_proj)
    # post-act extended tokens: a stride-1 and a stride-2 transition
    ("c3,32,3,1,1 b2,64,32,1 b2,128,32,2 n a ap4,1,0 fc128,10", False, True),
    # legacy bD: the second stack downsamples by adjacency
    ("c3,16,3,1,1 b1 b1 n a ap4,1,0 fc32,10", True, True),
    ("c3,16,3,1,1 b1 b1 n a ap4,1,0 fc32,10", True, False),
    ("c3,16,3,1,1 n a b1 b1 ap4,1,0 fc32,10", False, False),
]


def _logits_pair(spec, preact, proj, dtype, n=4):
    jm, params, state = jax_model(spec, preact, proj, dtype)
    x = images(n)
    ref, _ = jax.jit(lambda p, s, xx: jm.apply(p, s, xx, train=False))(
        params, state, jnp.asarray(x))
    tm = port_model(spec, preact, proj, params, state, dtype)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    return np.asarray(ref), got.numpy(), tm, x, (jm, params, state)


@pytest.mark.parametrize("spec,preact,proj", NETS)
def test_bottleneck_float32_logits_match_jax(spec, preact, proj):
    ref, got, *_ = _logits_pair(spec, preact, proj, "float32")
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("spec,preact,proj", NETS[:2])
def test_bottleneck_bf16_logits_match_jax(spec, preact, proj):
    ref, got, *_ = _logits_pair(spec, preact, proj, "bfloat16")
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)


@pytest.mark.parametrize("spec,preact,proj", [NETS[0], NETS[3]])
def test_bottleneck_fold_leaves_postact_logits(spec, preact, proj):
    _, got, tm, x, (jm, params, state) = _logits_pair(spec, preact, proj,
                                                      "float32")
    folded, n = fold_batchnorm(tm)
    assert n == jax_fold_batchnorm(jm, params, state)[2]
    # three pairs in each post-act block, plus the stem's BN when it
    # directly follows the stem conv
    n_blocks = 4 if spec == NETS[0][0] else 2
    assert n == 3 * n_blocks + (1 if " n a b" in spec else 0)
    with torch.no_grad():
        got_f = folded(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_f, got, rtol=0,
                               atol=1e-4 * np.abs(got).max())


def test_bottleneck_fold_skips_preact_blocks():
    *_, tm, _, _ = _logits_pair(*NETS[1], "float32", n=1)
    assert fold_batchnorm(tm)[1] == 0


@pytest.mark.parametrize("spec,preact,proj", NETS[:3])
def test_bottleneck_state_dict_keys_are_jax_key_paths(spec, preact, proj):
    _, params, state = jax_model(spec, preact, proj)
    sd = state_dict_from_jax(params, state)
    tm = ResNet(spec, preact, proj, 0.0, device="cpu")
    assert set(sd) == set(tm.state_dict())
    assert any(".proj." in k for k in sd) == proj
    w = np.asarray(params["01_stack"]["block0"]["conv2"]["w"])
    np.testing.assert_array_equal(
        sd["01_stack.block0.conv2.weight"].numpy(), w.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("spec,preact,proj", [NETS[0], NETS[1]])
def test_bottleneck_train_forward_with_jax_draws_matches_jax(spec, preact,
                                                             proj):
    jm = JaxResNet(spec, preact=preact, use_proj=proj, dropout_prob=0.3,
                   compute_dtype=jnp.float32)
    params, state = jm.init(jax.random.PRNGKey(0), (8, 8, 3))
    x = images(4)
    key = jax.random.key(9)
    ref, new_state = jm.apply(params, state, jnp.asarray(x), train=True,
                              rng=key)
    tm = ResNet(spec, preact, proj, 0.3, compute_dtype=torch.float32,
                device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, state))
    got = tm.train()(torch.from_numpy(x), key=JaxKey(key))
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    # without the injected draws the dropout masks differ
    tm2 = ResNet(spec, preact, proj, 0.3, compute_dtype=torch.float32,
                 device="cpu")
    tm2.load_state_dict(state_dict_from_jax(params, state))
    other = tm2.train()(torch.from_numpy(x), key=JaxKey(jax.random.key(10)))
    assert np.abs(other.detach().numpy() - ref).max() > 1e-3
    want = state_dict_from_jax({}, jax.device_get(new_state))
    have = tm.state_dict()
    for name, t in want.items():
        if name.endswith("count"):
            assert int(have[name]) == int(t) == 1, name
        else:
            np.testing.assert_allclose(
                have[name].numpy(), t.numpy(), rtol=0,
                atol=1e-5 * max(1.0, float(t.abs().max())), err_msg=name)


def test_bottleneck_refusals():
    # fully quantized training and QAT build (the NV halves)
    for bwd in (True, False):
        tm = ResNet("c3,64,3,1,1 b2", False, True, 0.0, int8_train=True,
                    int8_train_bwd=bwd, device="cpu")
        block = tm.get_submodule("01_stack.block1")
        assert block.lane_eligible((32, 8, 8, 64), True)
        assert block.int8_train_bwd == bwd
    # option A cannot shrink channels, as in JAX
    with pytest.raises(ValueError, match="cannot SHRINK"):
        ResNet("c3,64,3,1,1 b1,32,8,1", False, False, 0.0, device="cpu")
    with pytest.raises(ValueError, match="carries 3 ints"):
        ResNet("c3,64,3,1,1 b1,32,8", False, True, 0.0, device="cpu")
