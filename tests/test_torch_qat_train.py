"""The port's fused bf16 block-halves (``fused_block``), int8 QAT
(``int8_train`` without ``int8_train_bwd``) and in-kernel dropout
(``inkernel_dropout``) against the JAX package: the gates block for block,
the choice between a seed and materialized bits, one whole train step
through ``make_train_step`` in each mode, and ``setup`` on the recipes.

The JAX side runs its Pallas kernels in interpret mode and is given the
same weights and, through ``JaxKey``, the same draws (its dropout seeds
included). As in tests/test_torch_int8_train.py, the two sides fold
BatchNorm from f32 sums taken in another order, so the updates are held by
their distance to the exact f32 step: within twice the JAX step's own
distance from it, plus 1e-3 of the tensor's norm.
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
from pytorch_ddp_resnet_tpu_torch.models.resnet import ResNet
from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
from pytorch_ddp_resnet_tpu_torch.ops.cuda import stem as tstem
from pytorch_ddp_resnet_tpu_torch.utils import optim as toptim
from pytorch_ddp_resnet_tpu_torch.utils.config import get_config
from pytorch_ddp_resnet_tpu_torch.utils.rng import Key

from _torch_port_helpers import JaxKey

MODES = {"fused": dict(fused_block=True),
         "qat": dict(int8_train=True),
         "qat_seed": dict(int8_train=True, inkernel_dropout=True)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = {name: os.path.join(REPO, "models_dir", name, "config.yaml")
           for name in ("wrn-28-10-dropout_synthspectral-hard",
                        "wrn-28-10-dropout_synthspectral-hard-int8")}


# --- gates ---------------------------------------------------------------------

BLOCKS = [  # (channels, downsample, preact, use_proj, dropout)
    (32, False, True, True, 0.3), (32, True, True, True, 0.3),
    (48, False, True, True, 0.0), (16, False, True, True, 0.0),
    (16, False, True, True, 0.3), (160, False, True, True, 0.3),
    (320, False, True, True, 0.3), (640, False, True, True, 0.3),
    (160, True, True, True, 0.3), (32, False, False, True, 0.3),
    (32, False, True, True, 1.0)]
SHAPES = [(128, 32, 32), (128, 16, 16), (128, 8, 8), (8, 8, 8), (2, 8, 8),
          (4, 7, 7), (16, 4, 4), (8, 56, 56), (8, 4, 8)]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("c,down,preact,proj,rate", BLOCKS)
def test_block_gates_match_jax(mode, c, down, preact, proj, rate):
    kw = dict(channels=c, downsample=down, preact=preact, use_proj=proj,
              dropout_prob=rate, **MODES[mode])
    jb, tb = JaxBlock(**kw), ResidualBlock(**kw)
    for b, h, w in SHAPES:
        shape = (b, h, w, c)
        for train in (False, True):
            assert tb.lane_eligible(shape, train) == jb.lane_eligible(
                shape, train), (shape, train)
            assert tb.lane_entry_eligible(shape, train) == \
                jb.lane_entry_eligible(shape, train), (shape, train)


class _Draws:
    """A key that records which draw a half asked for."""

    def __init__(self):
        self.calls = []

    def dropout_seed(self, device):
        self.calls.append("seed")
        return torch.tensor(0, dtype=torch.int32)

    def bits(self, shape, device):
        self.calls.append("bits")
        return None


@pytest.mark.parametrize("c,n", [(160, 128 * 1024), (320, 128 * 256),
                                 (640, 128 * 64), (32, 512),
                                 (320, 2 ** 23)])
def test_seed_or_bits_as_jax_chooses(c, n, monkeypatch):
    """A seed where C <= 320 and C * N < 2^31, else materialized bits (JAX
    ``_dropout_bits``, whose draws are stubbed so that nothing of the size
    of the bits is allocated); without the flag always bits."""
    def jax_bits(key, shape=(), dtype=None):
        return jnp.uint32(0) if shape == () else "bits"

    monkeypatch.setattr(jax.random, "bits", jax_bits)
    for flag in (True, False):
        kw = dict(channels=c, downsample=False, preact=True, use_proj=True,
                  dropout_prob=0.3, int8_train=True, inkernel_dropout=flag)
        jgot = JaxBlock(**kw)._dropout_bits(jax.random.key(0), c, n)
        want = "bits" if isinstance(jgot, str) else "seed"
        key = _Draws()
        ResidualBlock(**kw)._dropout_bits(key, c, n, "cpu")
        assert key.calls == [want], (flag, want)
        assert want == ("seed" if flag and c <= 320 and c * n < 2 ** 31
                        else "bits")


def test_full_width_halves():
    """WRN-28-10 at batch 128: the fused bf16 gate admits the 4 identity
    blocks of stage 1 (8 halves); QAT takes all 22 stride-1 3x3 convs, 15
    of them on seed-mode dropout (stages 1 and 2) under
    ``inkernel_dropout``; block for block as JAX."""
    spec = "c3,160,3,1,1 r4 r4 r4 n a ap8,1,0 fc640,10"
    for mode, want, want_seed in (("fused", 8, 0), ("qat_seed", 22, 15)):
        model = ResNet(spec, True, True, 0.3, device="cpu", **MODES[mode])
        jmodel = JaxResNet(spec, preact=True, use_proj=True,
                           dropout_prob=0.3, **MODES[mode])
        stem = model.get_submodule("00_conv")
        assert stem.lane_entry_eligible((128, 32, 32, 3), True)
        halves = seeded = 0
        for i, (stage, hw, c) in enumerate((("01_stack", 32, 160),
                                            ("02_stack", 16, 320),
                                            ("03_stack", 8, 640))):
            jstage = jmodel.spine.layers[i + 1][1]
            for k in range(4):
                block = model.get_submodule(f"{stage}.block{k}")
                jblock = jstage.layers[k][1]
                cin = c // 2 if block.transforms_shortcut else c
                size = hw * 2 if block.transforms_shortcut else hw
                shape = (128, size, size, cin)
                got = (2 * block.lane_eligible(shape, True)
                       + block.lane_entry_eligible(shape, True))
                assert got == (2 * jblock.lane_eligible(shape, True)
                               + jblock.lane_entry_eligible(shape, True))
                halves += got
                key = _Draws()
                for _ in range(got):
                    block._dropout_bits(key, c, 128 * hw * hw, "cpu")
                seeded += key.calls.count("seed")
        assert (halves, seeded) == (want, want_seed), mode


# --- the whole step ------------------------------------------------------------

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
def exact_step():
    return _jax_train_step()[1]


# per mode: the plain versions one step runs (stem; the 2 halves of the
# identity block, and with the int8 core the transition's conv2 too) and
# the halves that get a seed
CALLS = {"fused": ({"stem_fwd_plain": 1, "stem_wgrad_plain": 1,
                    "fwd_bf16_plain": 2, "dgrad_bf16_plain": 2,
                    "wgrad_bf16_plain": 2}, 0),
         "qat": ({"stem_fwd_plain": 1, "stem_wgrad_plain": 1,
                  "fwd_conv_plain": 3, "dgrad_bf16_plain": 3,
                  "wgrad_bf16_plain": 3}, 0),
         "qat_seed": ({"stem_fwd_plain": 1, "stem_wgrad_plain": 1,
                       "fwd_conv_plain": 3, "dgrad_bf16_plain": 3,
                       "wgrad_bf16_plain": 3}, 3)}


def _spy(monkeypatch, calls):
    for mod, names in ((fb, ("fwd_conv_plain", "wgrad_plain",
                             "fwd_bf16_plain", "dgrad_bf16_plain",
                             "wgrad_bf16_plain")),
                       (tstem, ("stem_fwd_plain", "stem_wgrad_plain"))):
        for name in names:
            orig = getattr(mod, name)

            def spy(*a, _orig=orig, _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _orig(*a, **k)

            monkeypatch.setattr(mod, name, spy)
    for name in ("fused_half", "fused_half_int8"):
        orig = getattr(fb, name)

        def half(*a, _orig=orig, **k):
            if fb.is_seed(a[4] if len(a) > 4 else k.get("bits")):
                calls["seeded"] = calls.get("seeded", 0) + 1
            return _orig(*a, **k)

        monkeypatch.setattr(fb, name, half)


@pytest.mark.parametrize("mode", list(MODES))
def test_train_step_matches_jax(mode, exact_step, monkeypatch):
    """One step from the JAX init, with the JAX draws. For every parameter,
    momentum buffer and BN statistic, the port lies within twice the JAX
    step's own distance from the exact f32 step (plus 1e-3 of the tensor's
    norm). The stem bias, whose true gradient is 0 behind a
    batch-statistics BatchNorm, is held at 1e-3 of the largest momentum
    norm instead."""
    ts0, want = _jax_train_step(**MODES[mode])
    exact = exact_step
    x, y = _batch()
    model = ResNet(SPEC, True, True, 0.3, device="cpu", **MODES[mode])
    opt = toptim.get_optimizer("SGD", SGD_ARGS)
    ts = init_train_state(model, opt)
    load_jax_train_state(ts, ts0)
    calls = {}
    _spy(monkeypatch, calls)
    ts, metrics = make_train_step(model, opt)(
        ts, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)), LR,
        JaxKey(jax.random.key(2)))
    want_calls, seeded = CALLS[mode]
    assert calls == dict(want_calls, **({"seeded": seeded} if seeded
                                        else {}))
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


# --- setup -----------------------------------------------------------------------

def _config(tmp_path, recipe, **overrides):
    with open(RECIPES[recipe]) as f:
        cfg = yaml.safe_load(f)
    cfg.update(use_pallas_augment=True, batch_size=8,
               dataset_args={"class_sep": 0.3, "n_train": 40, "n_test": 16},
               architecture_spec="c3,32,3,1,1 r1 r1 n a ap16,1,0 fc64,10")
    cfg.update(overrides)
    run = tmp_path / "models_dir" / "run"
    run.mkdir(parents=True)
    with open(run / "config.yaml", "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return get_config(str(tmp_path / "models_dir"), "run",
                      data_dir=str(tmp_path / "data"), verbose=False)


@pytest.mark.parametrize("recipe,flags", [
    ("wrn-28-10-dropout_synthspectral-hard", {"use_fused_block": True}),
    ("wrn-28-10-dropout_synthspectral-hard",
     {"use_fused_block": True, "use_inkernel_dropout": True}),
    ("wrn-28-10-dropout_synthspectral-hard-int8",
     {"use_int8_train": True, "use_int8_train_bwd": False,
      "use_inkernel_dropout": True})])
def test_setup_trains_the_new_modes(tmp_path, recipe, flags):
    """A small net of each recipe through setup, the pipeline and the
    fused augment: two steps move every parameter and count every BN."""
    ls = setup(_config(tmp_path, recipe, **flags), device="cpu",
               verbose=False)
    model = ls["model"]
    assert model.fused_block == flags.get("use_fused_block", False)
    assert model.int8_train == flags.get("use_int8_train", False)
    assert not model.int8_train_bwd
    assert model.inkernel_dropout == flags.get("use_inkernel_dropout", False)
    step = ls["pipeline"].bind_train_step(
        make_train_step(model, ls["optimizer"],
                        augment_fn=ls["augment_fn"]),
        pass_indices=ls["augment_pass_indices"])
    ts = ls["train_state"]
    before = {k: v.detach().clone() for k, v in ts["params"].items()}
    for gs, (_, (idx,)) in enumerate(ls["pipeline"].train_feed(0, budget=2)):
        ts, m = step(ts, idx, 0.1, Key(0).fold_in(gs))
        assert np.isfinite(float(m["loss"]))
    for k, v in ts["params"].items():
        assert not torch.equal(v, before[k]), k
    counts = {int(b) for n, b in ts["model_state"].items()
              if n.endswith("count")}
    assert counts == {2}
    assert not fb.launches  # CPU: plain versions only
