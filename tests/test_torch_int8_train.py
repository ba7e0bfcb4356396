"""The port's int8 fully quantized training (``int8_train`` with
``int8_train_bwd``) against the JAX package: the eligibility gates, an
identity and a transition block, one whole train step through
``make_train_step``, and ``setup`` on the ``-int8`` recipe.

The JAX side runs its Pallas kernels in interpret mode and is given the
same weights and, through ``JaxKey``, the same dropout bits. The two sides
fold BatchNorm from f32 sums taken in another order (and XLA and torch
round ``rsqrt`` apart by an ulp), so a few int8 decisions can land the
other way: outputs agree to the int8 grain, and gradients and updates are
held by their distance to the reference.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pytorch_ddp_resnet_tpu.algos import steps as jsteps
from pytorch_ddp_resnet_tpu.models.blocks import (
    ResidualBlock as JaxBlock,
)
from pytorch_ddp_resnet_tpu.models.layers import Conv as JaxConv
from pytorch_ddp_resnet_tpu.models.resnet import ResNet as JaxResNet
from pytorch_ddp_resnet_tpu.utils import optim as joptim
from pytorch_ddp_resnet_tpu_torch.algos.steps import (
    init_train_state,
    make_train_step,
)
from pytorch_ddp_resnet_tpu_torch.algos.train import setup
from pytorch_ddp_resnet_tpu_torch.convert import (
    load_jax_train_state,
    state_dict_from_jax,
)
from pytorch_ddp_resnet_tpu_torch.models.blocks import ResidualBlock
from pytorch_ddp_resnet_tpu_torch.models.layers import Conv
from pytorch_ddp_resnet_tpu_torch.models.resnet import ResNet
from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
from pytorch_ddp_resnet_tpu_torch.ops.cuda import stem as tstem
from pytorch_ddp_resnet_tpu_torch.utils import optim as toptim
from pytorch_ddp_resnet_tpu_torch.utils.config import get_config
from pytorch_ddp_resnet_tpu_torch.utils.rng import Key

from _torch_port_helpers import JaxKey, _randomize_bn

FQT = dict(int8_train=True, int8_train_bwd=True)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "models_dir",
                      "wrn-28-10-dropout_synthspectral-hard-int8",
                      "config.yaml")


# --- gates -----------------------------------------------------------------------

BLOCKS = [  # (channels, downsample, preact, use_proj, dropout)
    (32, False, True, True, 0.3), (32, True, True, True, 0.3),
    (32, True, True, False, 0.0), (48, False, True, True, 0.0),
    (160, False, True, True, 0.3), (160, True, True, True, 0.3),
    (640, False, True, True, 0.3), (32, False, False, True, 0.3),
    (32, False, True, True, 1.0)]
SHAPES = [(128, 32, 32), (128, 16, 16), (128, 8, 8), (512, 8, 8), (8, 8, 8),
          (2, 8, 8), (1, 8, 8), (4, 7, 7), (16, 4, 4), (8, 56, 56)]


@pytest.mark.parametrize("c,down,preact,proj,rate", BLOCKS)
def test_block_gates_match_jax(c, down, preact, proj, rate):
    kw = dict(channels=c, downsample=down, preact=preact, use_proj=proj,
              dropout_prob=rate)
    jb = JaxBlock(**kw, **FQT)
    tb = ResidualBlock(**kw, **FQT)
    for b, h, w in SHAPES:
        shape = (b, h, w, c)
        for train in (False, True):
            assert tb.lane_eligible(shape, train) == jb.lane_eligible(
                shape, train), (shape, train)
            assert tb.lane_entry_eligible(shape, train) == \
                jb.lane_entry_eligible(shape, train), (shape, train)


def test_stem_gate_matches_jax():
    for cin, cout, k, s, p, bias in [(3, 160, 3, 1, 1, True),
                                     (3, 24, 3, 1, 1, True),
                                     (9, 32, 3, 1, 1, True),
                                     (3, 32, 3, 2, 1, True),
                                     (3, 32, 3, 1, 1, False)]:
        jc = JaxConv(cin, cout, k, stride=s, padding=p, use_bias=bias,
                     lane_stem=True)
        tc = Conv(cin, cout, k, stride=s, padding=p, use_bias=bias,
                  lane_stem=True)
        for b, h, w in SHAPES:
            for train in (False, True):
                shape = (b, h, w, cin)
                assert tc.lane_entry_eligible(shape, train) == \
                    jc.lane_entry_eligible(shape, train), (cin, shape)


# --- blocks -----------------------------------------------------------------------

def _rel_l2_ok(got, want, glob):
    num = np.linalg.norm((np.asarray(got, np.float64) - want).ravel())
    return num <= max(0.1 * np.linalg.norm(want.ravel()), 2e-2 * glob)


def _float_path_share(kw, params, state, x, key):
    """Share of outputs in which the port's float block (no int8 flags)
    differs from JAX's on the same input, weights and draws."""
    kw = {k: v for k, v in kw.items() if k not in FQT}
    jy, _ = JaxBlock(**kw).apply(params, state, jnp.asarray(x, jnp.bfloat16),
                                 train=True, rng=key)
    tb = ResidualBlock(**{**kw, "compute_dtype": torch.bfloat16}).train()
    tb.load_state_dict(state_dict_from_jax(params, state))
    with torch.no_grad():
        ty = tb(torch.from_numpy(x).to(torch.bfloat16), key=JaxKey(key))
    return float((ty.float().numpy() != np.asarray(jy, np.float32)).mean())


@pytest.mark.parametrize("down,hw", [(False, 8), (True, 16)])
def test_block_matches_jax(down, hw):
    """An identity block (C=32, 8x8) and a transition block (32 -> 64,
    16x16 -> 8x8), batch 128: two scale groups in every half."""
    c, b = 32, 128
    kw = dict(channels=c, downsample=down, preact=True, use_proj=True,
              dropout_prob=0.3, compute_dtype=jnp.bfloat16, **FQT)
    jb = JaxBlock(**kw)
    params, state, out_shape = jb.init(jax.random.key(0), (hw, hw, c))
    _randomize_bn(params, state, np.random.default_rng(5))
    rng = np.random.default_rng(6)
    x = np.asarray(jnp.asarray(rng.standard_normal((b, hw, hw, c)),
                               jnp.bfloat16), np.float32)
    ct = rng.standard_normal((b,) + tuple(out_shape)).astype(np.float32)
    assert (jb.lane_entry_eligible if down else jb.lane_eligible)(
        x.shape, True)
    key = jax.random.key(1)

    def jloss(p):
        y, st = jb.apply(p, state, jnp.asarray(x, jnp.bfloat16), train=True,
                         rng=key)
        return jnp.sum(y.astype(jnp.float32) * ct), (y, st)

    (_, (jy, jst)), jg = jax.value_and_grad(jloss, has_aux=True)(params)

    tb = ResidualBlock(**{**kw, "compute_dtype": torch.bfloat16}).train()
    tb.load_state_dict(state_dict_from_jax(params, state))
    ty = tb(torch.from_numpy(x).to(torch.bfloat16), key=JaxKey(key))
    (ty.float() * torch.from_numpy(ct)).sum().backward()

    jy = np.asarray(jy, np.float32)
    diff = np.abs(ty.detach().float().numpy() - jy)
    # the bf16 layer path alone (the transition's conv1 and projection on
    # XLA vs torch) already moves some outputs by a bf16 rounding: the int8
    # path may add 1% of the outputs to that share, each by the int8 grain
    assert (diff > 0).mean() <= 1e-2 + _float_path_share(kw, params, state,
                                                          x, key)
    assert diff.max() <= 0.05 * np.abs(jy).max()
    new_state = state_dict_from_jax({}, jst)
    for name, t in tb.state_dict().items():
        if name in new_state:
            want = new_state[name].numpy()
            if name.endswith("count"):
                assert int(t) == int(want) == 1, name
            else:
                np.testing.assert_allclose(t.numpy(), want, rtol=1e-5,
                                           atol=1e-5, err_msg=name)
    grads = state_dict_from_jax(jg, {})
    glob = np.sqrt(sum(np.square(g.numpy().astype(np.float64)).sum()
                       for g in grads.values()))
    named = dict(tb.named_parameters())
    assert set(named) == set(grads)
    for name, g in grads.items():
        assert _rel_l2_ok(named[name].grad.numpy(), g.numpy(), glob), name


# --- the whole step ----------------------------------------------------------------

SPEC = "c3,32,3,1,1 r1 r1 n a ap4,1,0 fc64,10"
SGD_ARGS = {"lr": 0.1, "momentum": 0.9, "dampening": 0.0, "nesterov": True,
            "weight_decay": 5e-4}
LR = 0.05


def _batch():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 8, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, (1, 8)).astype(np.int32)
    return x, y


def _jax_train_step(**flags):
    """JAX's make_train_step from its init at ``flags``: (ts0, {loss,
    <state_dict name>, momentum/<name>})."""
    x, y = _batch()
    cd = jnp.bfloat16 if flags else jnp.float32
    model = JaxResNet(SPEC, preact=True, use_proj=True, dropout_prob=0.3,
                      compute_dtype=cd, **flags)
    opt = joptim.get_optimizer("SGD", SGD_ARGS)
    ts0 = jsteps.init_train_state(model, opt, jax.random.key(0), (8, 8, 3))
    ts1, metrics = jax.jit(jsteps.make_train_step(model, opt))(
        ts0, jnp.asarray(x), jnp.asarray(y), jnp.float32(LR),
        jax.random.key(2))
    out = {"loss": float(metrics["loss"])}
    for name, t in state_dict_from_jax(ts1["params"],
                                       ts1["model_state"]).items():
        out[name] = t.numpy()
    for name, t in state_dict_from_jax(ts1["opt_state"]["buf"], {}).items():
        out[f"momentum/{name}"] = t.numpy()
    return jax.device_get(ts0), out


@pytest.fixture(scope="module")
def jax_steps():
    ts0, fqt = _jax_train_step(**FQT)
    _, exact = _jax_train_step()
    return ts0, fqt, exact


def _spy(monkeypatch, calls):
    for mod, names in ((fb, ("fwd_conv_plain", "wgrad_plain")),
                       (tstem, ("stem_fwd_plain", "stem_wgrad_plain"))):
        for name in names:
            orig = getattr(mod, name)

            def spy(*a, _orig=orig, _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _orig(*a, **k)

            monkeypatch.setattr(mod, name, spy)


def test_train_step_matches_jax(jax_steps, monkeypatch):
    """One FQT step from the JAX init, with the JAX draws. For every
    parameter, momentum buffer and BN statistic, the port lies within twice
    the JAX FQT step's own distance from the exact f32 step (plus 1e-3 of
    the tensor's norm): the port's int8 decisions may differ from JAX's
    only by the grain, never by a biased path. The stem bias, whose true
    gradient is 0 behind a batch-statistics BatchNorm, is held at 1e-3 of
    the largest momentum norm instead."""
    ts0, want, exact = jax_steps
    x, y = _batch()
    model = ResNet(SPEC, True, True, 0.3, device="cpu", **FQT)
    opt = toptim.get_optimizer("SGD", SGD_ARGS)
    ts = init_train_state(model, opt)
    load_jax_train_state(ts, ts0)
    calls = {}
    _spy(monkeypatch, calls)
    ts, metrics = make_train_step(model, opt)(
        ts, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)), LR,
        JaxKey(jax.random.key(2)))
    # the stem and the three int8 convs (two halves of the identity block,
    # conv2 of the transition block), forward and backward, once each
    assert calls == {"stem_fwd_plain": 1, "stem_wgrad_plain": 1,
                     "fwd_conv_plain": 3, "wgrad_plain": 3}
    got = {"loss": float(metrics["loss"])}
    for name, t in model.state_dict().items():
        got[name] = t.numpy()
    for name, p in ts["params"].items():
        got[f"momentum/{name}"] = (
            ts["opt_state"].state[p]["momentum_buffer"].numpy())
    assert set(got) == set(want)
    assert abs(got["loss"] - want["loss"]) <= max(
        abs(want["loss"] - exact["loss"]), 1e-3)
    mnorm = max(np.linalg.norm(v) for k, v in want.items()
                if k.startswith("momentum/"))
    for name, ref in want.items():
        if name == "loss":
            continue
        if name.endswith("count"):
            assert int(got[name]) == int(ref) == 1, name
            continue
        d = np.linalg.norm(got[name].astype(np.float64) - ref)
        if name.endswith("00_conv.bias"):
            assert d <= 1e-3 * mnorm, name
            continue
        noise = np.linalg.norm(ref.astype(np.float64) - exact[name])
        assert d <= 2 * noise + 1e-3 * np.linalg.norm(exact[name]), name


# --- refusals and setup --------------------------------------------------------------

def test_qat_and_other_kernel_flags_raise():
    """The flag still to port raises on an FQT net; QAT on a bottleneck net
    (tests/test_torch_bneck_train.py) and on the basic trunk
    (tests/test_torch_qat_train.py), lane transitions
    (tests/test_torch_transition.py) and the Pallas conv
    (tests/test_torch_conv3x3_same.py) build."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        ResNet(SPEC, True, True, 0.3, device="cpu", **FQT, remat=True)
    bneck = ResNet("c3,64,3,1,1 b2 n a ap8,1,0 fc64,10", False, True, 0.0,
                   device="cpu", int8_train=True)
    assert not bneck.get_submodule("01_stack.block1").int8_train_bwd


def _int8_config(tmp_path, **overrides):
    with open(RECIPE) as f:
        cfg = yaml.safe_load(f)
    cfg.update(use_pallas_augment=True,
               dataset_args={"class_sep": 0.3, "n_train": 40, "n_test": 16})
    cfg.update(overrides)
    run = tmp_path / "models_dir" / "run"
    run.mkdir(parents=True)
    with open(run / "config.yaml", "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return get_config(str(tmp_path / "models_dir"), "run",
                      data_dir=str(tmp_path / "data"), verbose=False)


def test_setup_builds_the_int8_recipe(tmp_path):
    """The recipe at full width: the stem emits the lane layout and all 22
    stride-1 3x3 convs of the trunk take the fused halves at batch 128."""
    config = _int8_config(tmp_path)
    assert config["use_int8_train_bwd"] and config["batch_size"] == 128
    model = setup(config, device="cpu", verbose=False)["model"]
    assert model.int8_train and model.int8_train_bwd
    assert model.param_count() == 36688330
    stem = model.get_submodule("00_conv")
    assert stem.lane_entry_eligible((128, 32, 32, 3), True)
    halves = 0
    for stage, hw, c in (("01_stack", 32, 160), ("02_stack", 16, 320),
                         ("03_stack", 8, 640)):
        for i in range(4):
            block = model.get_submodule(f"{stage}.block{i}")
            if block.transforms_shortcut:
                assert block.lane_entry_eligible((128, 2 * hw, 2 * hw,
                                                  c // 2), True)
                halves += 1
            else:
                assert block.lane_eligible((128, hw, hw, c), True)
                halves += 2
    assert halves == 22


def test_setup_trains_int8_steps_on_cpu(tmp_path):
    """A small net of the recipe through setup, the pipeline and the fused
    augment: two FQT steps move every parameter and count every BN."""
    config = _int8_config(tmp_path, batch_size=8, architecture_spec=(
        "c3,32,3,1,1 r1 r1 n a ap16,1,0 fc64,10"))
    ls = setup(config, device="cpu", verbose=False)
    step = ls["pipeline"].bind_train_step(
        make_train_step(ls["model"], ls["optimizer"],
                        augment_fn=ls["augment_fn"]),
        pass_indices=ls["augment_pass_indices"])
    ts = ls["train_state"]
    before = {k: v.detach().clone() for k, v in ts["params"].items()}
    launches_before = dict(fb.launches)
    for gs, (_, (idx,)) in enumerate(ls["pipeline"].train_feed(0, budget=2)):
        ts, m = step(ts, idx, 0.1, Key(0).fold_in(gs))
        assert np.isfinite(float(m["loss"]))
    for k, v in ts["params"].items():
        assert not torch.equal(v, before[k]), k
    counts = {int(b) for n, b in ts["model_state"].items()
              if n.endswith("count")}
    assert counts == {2}
    assert dict(fb.launches) == launches_before  # CPU: plain versions only
