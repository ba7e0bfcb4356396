"""The port's int8 training of post-act bottleneck nets (``int8_train``,
fully quantized with ``int8_train_bwd``, QAT without; models/blocks.py
NVLane path) against the JAX package: the NV gate block for block, one
whole train step through ``make_train_step`` on the mini spec of the JAX
package's tests/test_nv_train_model.py, the float fallbacks, and ``setup``
on a small bottleneck config.

The JAX side runs its NV halves in interpret mode from the same init
(carried over by ``convert.load_jax_train_state``). The two sides fold
BatchNorm from f32 sums taken in another order and their float layers
(stem, transitions) round bf16 convs apart, so a few int8 decisions can
land the other way: every tensor of the step is held within twice the JAX
step's own distance (FQT or QAT, as the port's) from the exact f32 step
(plus 1e-3 of the tensor's norm), the criterion of
tests/test_torch_int8_train.py.
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
    BottleneckResidualBlock as JaxBneck,
)
from pytorch_ddp_resnet_tpu.models.blocks import NVLane as JaxNVLane
from pytorch_ddp_resnet_tpu.models.resnet import ResNet as JaxResNet
from pytorch_ddp_resnet_tpu.ops.pallas.nv_common import to_nv
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
from pytorch_ddp_resnet_tpu_torch.models.blocks import (
    BottleneckResidualBlock,
    NVLane,
)
from pytorch_ddp_resnet_tpu_torch.models.resnet import ResNet
from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv_train as nvt
from pytorch_ddp_resnet_tpu_torch.utils import optim as toptim
from pytorch_ddp_resnet_tpu_torch.utils.config import get_config
from pytorch_ddp_resnet_tpu_torch.utils.rng import Key

from _torch_port_helpers import JaxKey

FQT = dict(int8_train=True, int8_train_bwd=True)
QAT = dict(int8_train=True, int8_train_bwd=False)
# stage 1: a stride-1 transition (16 -> 32 channels, float path) and an
# identity block (NV); stage 2: a stride-2 transition and an identity
# block at 4x4 (NV)
SPEC = "c3,16,3,1,1 n a b2,32,16,1 b2,64,16,2 ap4,1,0 fc64,10"
SGD_ARGS = {"lr": 0.1, "momentum": 0.9, "dampening": 0.0, "nesterov": True,
            "weight_decay": 5e-4}
LR = 0.05
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R50 = os.path.join(REPO, "models_dir", "resnet-50_ilsvrc2012", "config.yaml")


def _batch(n=32):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, n, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, (1, n)).astype(np.int32)
    return x, y


# --- the gate ----------------------------------------------------------------

BLOCKS = [  # (channels, downsample, preact, dropout, width, out, stride)
    (64, False, False, 0.0, None, None, None),
    (64, False, True, 0.0, None, None, None),
    (64, True, False, 0.0, None, None, None),
    (64, False, False, 0.1, None, None, None),
    (256, False, False, 0.0, 64, 256, 1),
    (16, False, False, 0.0, 16, 32, 1),
    (2048, False, False, 0.0, 512, 2048, 1),
    (40, False, False, 0.0, 12, 40, 1),
]
SHAPES = [(32, 8, 8), (64, 8, 8), (48, 8, 8), (16, 8, 8), (128, 56, 56),
          (256, 56, 56), (128, 7, 7), (64, 7, 7), (32, 4, 4)]


def _check_gate(c, down, preact, rate, width, out, stride, flags):
    kw = dict(channels=c, downsample=down, preact=preact, use_proj=True,
              dropout_prob=rate, width_override=width,
              out_channels_override=out, stride_override=stride)
    jb = JaxBneck(**kw, **flags)
    tb = BottleneckResidualBlock(**kw, **flags)
    for b, h, w in SHAPES:
        for train in (False, True):
            shape = (b, h, w, c)
            assert tb.lane_eligible(shape, train) == jb.lane_eligible(
                shape, train), (shape, train)


@pytest.mark.parametrize("c,down,preact,rate,width,out,stride", BLOCKS)
def test_gate_matches_jax(c, down, preact, rate, width, out, stride):
    _check_gate(c, down, preact, rate, width, out, stride, FQT)


# --- one train step ----------------------------------------------------------

def _jax_side(**flags):
    """JAX's init, its train step at ``flags`` and its train-mode logits
    from the init: (ts0, {loss, logits, <state_dict name>,
    momentum/<name>})."""
    x, y = _batch()
    cd = jnp.bfloat16 if flags else jnp.float32
    model = JaxResNet(SPEC, preact=False, use_proj=True, dropout_prob=0.0,
                      compute_dtype=cd, **flags)
    opt = joptim.get_optimizer("SGD", SGD_ARGS)
    ts0 = jsteps.init_train_state(model, opt, jax.random.key(0), (8, 8, 3))
    ts1, metrics = jax.jit(jsteps.make_train_step(model, opt))(
        ts0, jnp.asarray(x), jnp.asarray(y), jnp.float32(LR),
        jax.random.key(2))
    logits, _ = jax.jit(lambda p, s, xx: model.apply(p, s, xx, train=True))(
        ts0["params"], ts0["model_state"], jnp.asarray(x[0]))
    out = {"loss": float(metrics["loss"]), "logits": np.asarray(logits)}
    for name, t in state_dict_from_jax(ts1["params"],
                                       ts1["model_state"]).items():
        out[name] = t.numpy()
    for name, t in state_dict_from_jax(ts1["opt_state"]["buf"], {}).items():
        out[f"momentum/{name}"] = t.numpy()
    return model, jax.device_get(ts0), out


@pytest.fixture(scope="module")
def jax_steps():
    jmodel, ts0, fqt = _jax_side(**FQT)
    _, _, exact = _jax_side()
    return jmodel, ts0, fqt, exact


def _spy(monkeypatch, calls):
    for name in ("fwd_conv_plain", "dgrad_conv_plain", "wgrad_plain",
                 "dgrad_conv_bf16_plain", "wgrad_bf16_plain"):
        orig = getattr(nvt, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a, **k)

        monkeypatch.setattr(nvt, name, spy)


def test_train_step_matches_jax(jax_steps, monkeypatch):
    """One FQT step from the JAX init. The same blocks take the NV path in
    both packages (the two identity blocks: six halves forward and
    backward); loss, train-mode logits, every parameter, momentum buffer
    and BatchNorm statistic lie within twice the JAX FQT step's distance
    from the exact f32 step (plus 1e-3 of the tensor's norm)."""
    _check_step(jax_steps, FQT, {"fwd_conv_plain": 6, "dgrad_conv_plain": 6,
                                 "wgrad_plain": 6}, monkeypatch)


def _check_step(jax_side, flags, want_calls, monkeypatch):
    """One step at ``flags`` from the JAX init against JAX's at the same
    flags (``jax_side``: model, init, step, exact f32 step), the halves'
    plain versions called as ``want_calls`` say."""
    jmodel, ts0, want, exact = jax_side
    x, y = _batch()
    model = ResNet(SPEC, False, True, 0.0, device="cpu", **flags)
    for stage in ("03_stack", "04_stack"):
        for i, hw in ((0, 8), (1, 8 if stage == "03_stack" else 4)):
            block = model.get_submodule(f"{stage}.block{i}")
            jblock = dict(dict(jmodel.spine.layers)[stage].layers)[
                f"block{i}"]
            shape = (32, hw, hw, block.in_channels)
            assert block.lane_eligible(shape, True) == jblock.lane_eligible(
                shape, True) == (i == 1)
    opt = toptim.get_optimizer("SGD", SGD_ARGS)
    ts = init_train_state(model, opt)
    load_jax_train_state(ts, ts0)

    probe = ResNet(SPEC, False, True, 0.0, device="cpu", **flags).train()
    probe.load_state_dict(model.state_dict())
    with torch.no_grad():
        logits = probe(torch.from_numpy(x[0])).numpy()

    calls = {}
    _spy(monkeypatch, calls)
    ts, metrics = make_train_step(model, opt)(
        ts, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)), LR,
        JaxKey(jax.random.key(2)))
    assert calls == want_calls
    got = {"loss": float(metrics["loss"]), "logits": logits}
    for name, t in model.state_dict().items():
        got[name] = t.numpy()
    for name, p in ts["params"].items():
        got[f"momentum/{name}"] = (
            ts["opt_state"].state[p]["momentum_buffer"].numpy())
    assert set(got) == set(want)
    assert abs(got["loss"] - want["loss"]) <= max(
        2 * abs(want["loss"] - exact["loss"]), 1e-3)
    for name, ref in want.items():
        if name == "loss":
            continue
        if name.endswith("count"):
            assert int(got[name]) == int(ref) == 1, name
            continue
        d = np.linalg.norm(got[name].astype(np.float64) - ref)
        noise = np.linalg.norm(ref.astype(np.float64) - exact[name])
        assert d <= 2 * noise + 1e-3 * np.linalg.norm(exact[name]), name


# --- the float path where the gate says no -----------------------------------

def _pair(spec, preact, n):
    """The same weights in an FQT-flagged model and a float one."""
    q = ResNet(spec, preact, True, 0.0, device="cpu",
               generator=torch.Generator().manual_seed(3), **FQT)
    f = ResNet(spec, preact, True, 0.0, device="cpu")
    f.load_state_dict(q.state_dict())
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (n, 8, 8, 3)).astype(np.float32))
    return q, f, x


def test_eval_stays_on_the_float_path():
    q, f, x = _pair(SPEC, False, 32)
    nvt.reset_launches()
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        _spy(mp, calls)
        with torch.no_grad():
            assert torch.equal(q(x), f(x))
    assert calls == {}


@pytest.mark.parametrize("spec,preact,n", [
    (SPEC, False, 48),     # the batch fails the gate (not a power of two)
    # preact blocks stay on the layer path (a 5x5 stem: a preact int8 net's
    # 3x3 stem would take the FQT stem kernel, in JAX too)
    (SPEC.replace("c3,16,3,1,1", "c3,16,5,1,2"), True, 32),
])
def test_ineligible_nets_train_as_the_float_model(spec, preact, n):
    """A train step's forward and backward equal the float model's."""
    q, f, x = _pair(spec, preact, n)
    outs = []
    for model in (q, f):
        model.train()
        y = model(x)
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum(
        ).backward()
        outs.append((y.detach(), {k: p.grad for k, p in
                                  model.named_parameters()},
                     {k: v.clone() for k, v in model.state_dict().items()}))
    (yq, gq, sq), (yf, gf, sf) = outs
    assert torch.equal(yq, yf)
    assert all(torch.equal(gq[k], gf[k]) for k in gf)
    assert all(torch.equal(sq[k], sf[k]) for k in sf)


def test_qat_raises(jax_steps, monkeypatch, tmp_path):
    """QAT (``int8_train`` alone), which raised before the NV halves' bf16
    bodies were ported, now trains: the gate agrees with JAX's block for
    block; one step from the JAX init (the six halves on the int8 forward
    and the bf16 dgrad and wgrad) lies within twice the JAX QAT step's
    distance from the exact f32 step; and ``setup`` with
    ``use_int8_train`` alone trains a bottleneck net."""
    for block in BLOCKS:
        _check_gate(*block, QAT)
    jmodel, ts0, qat = _jax_side(**QAT)
    _check_step((jmodel, ts0, qat, jax_steps[3]), QAT,
                {"fwd_conv_plain": 6, "dgrad_conv_bf16_plain": 6,
                 "wgrad_bf16_plain": 6}, monkeypatch)
    _check_setup(tmp_path, {"use_int8_train": True},
                 {"fwd_conv_plain": 12, "dgrad_conv_bf16_plain": 12,
                  "wgrad_bf16_plain": 12})


# --- the run's pending epilogue ----------------------------------------------

def test_materialize_is_one_fma():
    """relu(acc3*s3 + t3 + x) in bf16: under jit the reference contracts
    acc3*s3 + t3 into one FMA. acc3 constant per channel and t3 =
    -f32(acc3*s3), x = 0: one rounding leaves residues, two leave 0."""
    rng = np.random.default_rng(8)
    c, shape = 16, (32, 2, 3, 16)
    a = np.asarray(jnp.asarray(rng.uniform(0.5, 2.0, c), jnp.bfloat16),
                   np.float32)
    s3 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    t3 = -(a * s3).astype(np.float32)
    acc3 = np.broadcast_to(a, shape).copy()
    x = np.zeros(shape, np.float32)

    def jfn(acc, xx):
        nv = JaxNVLane(to_nv(xx.astype(jnp.bfloat16)),
                       to_nv(acc.astype(jnp.bfloat16)), jnp.asarray(s3),
                       jnp.asarray(t3))
        return nv.materialize(3)

    want = np.asarray(jax.jit(jfn)(jnp.asarray(acc3), jnp.asarray(x)),
                      np.float32)
    got = NVLane(torch.from_numpy(x).to(torch.bfloat16),
                 torch.from_numpy(acc3).to(torch.bfloat16),
                 torch.from_numpy(s3), torch.from_numpy(t3)).materialize()
    assert got.dtype == torch.bfloat16
    assert np.abs(want).max() > 0
    np.testing.assert_array_equal(got.float().numpy(), want)
    two = (acc3 * s3).astype(np.float32) + t3
    assert not two.any()


# --- setup -------------------------------------------------------------------

def test_setup_trains_a_bottleneck_net_with_the_flag(tmp_path):
    """The ResNet-50 recipe cut to the mini spec on Synthetic 8x8 data at
    batch 32 with use_int8_train_bwd, through setup and the pipeline: two
    steps run the NV halves, move every parameter and count every BN."""
    _check_setup(tmp_path, {"use_int8_train_bwd": True},
                 {"fwd_conv_plain": 12, "dgrad_conv_plain": 12,
                  "wgrad_plain": 12})


def _check_setup(tmp_path, flags, want_calls):
    with open(R50) as f:
        cfg = yaml.safe_load(f)
    cfg.update(
        dataset_cls_name="Synthetic", architecture_spec=SPEC,
        dataset_args={"shape": [8, 8, 3], "num_classes": 10, "n_train": 64,
                      "n_test": 32},
        data_aug_train={"ToTensorTransform": {}, "FlipTransform": {"p": 0.5},
                        "StandardizeWhiteningTransform": {}},
        data_aug_test={"ToTensorTransform": {},
                       "StandardizeWhiteningTransform": {}},
        batch_size=32, world_size=1, **flags)
    run = tmp_path / "models_dir" / "run"
    run.mkdir(parents=True)
    with open(run / "config.yaml", "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    config = get_config(str(tmp_path / "models_dir"), "run",
                        data_dir=str(tmp_path / "data"), verbose=False)
    ls = setup(config, device="cpu", verbose=False)
    model = ls["model"]
    assert model.int8_train
    assert model.int8_train_bwd == flags.get("use_int8_train_bwd", False)
    assert model.get_submodule("03_stack.block1").lane_eligible(
        (32, 8, 8, 32), True)
    step = ls["pipeline"].bind_train_step(
        make_train_step(model, ls["optimizer"],
                        augment_fn=ls["augment_fn"]),
        pass_indices=ls["augment_pass_indices"])
    ts = ls["train_state"]
    before = {k: v.detach().clone() for k, v in ts["params"].items()}
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        _spy(mp, calls)
        for gs, (_, batch) in enumerate(ls["pipeline"].train_feed(
                0, budget=2)):
            ts, m = step(ts, *batch, 0.1, Key(0).fold_in(gs))
            assert np.isfinite(float(m["loss"]))
    assert calls == want_calls
    for k, v in ts["params"].items():
        assert not torch.equal(v, before[k]), k
    counts = {int(b) for n, b in ts["model_state"].items()
              if n.endswith("count")}
    assert counts == {2}
