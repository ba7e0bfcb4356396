"""The port's training path against the JAX package: BatchNorm and dropout
in train mode, metrics, optimizers and schedulers, and ``setup`` (the
whole train step is in tests/test_torch_train_step.py).

Tolerances:
- BatchNorm: 1e-6 in f32 (the same formulas; the batch sums are taken in
  another order). Dropout with the same bits: exact.
- Optimizers and schedulers: 1e-6 (torch's own classes against the JAX
  rules, which reproduce them); Adam-family 1e-4, as tests/test_optim.py.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pytorch_ddp_resnet_tpu.models import layers as jlayers
from pytorch_ddp_resnet_tpu.ops import metrics as jmetrics
from pytorch_ddp_resnet_tpu.utils import optim as joptim
from pytorch_ddp_resnet_tpu_torch.algos.steps import make_train_step
from pytorch_ddp_resnet_tpu_torch.algos.train import setup
from pytorch_ddp_resnet_tpu_torch.models import layers as tlayers
from pytorch_ddp_resnet_tpu_torch.models.resnet import ResNet
from pytorch_ddp_resnet_tpu_torch.ops import metrics as tmetrics
from pytorch_ddp_resnet_tpu_torch.ops.cuda import augment as taug
from pytorch_ddp_resnet_tpu_torch.utils import optim as toptim
from pytorch_ddp_resnet_tpu_torch.utils.config import get_config
from pytorch_ddp_resnet_tpu_torch.utils.rng import Key

from _torch_port_helpers import DTYPES, JaxKey

CPU = torch.device("cpu")


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() if want.size else 0.0
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * scale + 1e-30, (what, err, scale)


# --- layers in train mode -------------------------------------------------

def test_batchnorm_train_matches_jax():
    rng = np.random.default_rng(0)
    c = 5
    x = (rng.standard_normal((4, 6, 6, c)) * 2 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.2, c).astype(np.float32)
    mean = rng.normal(0, 0.2, c).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    jbn = jlayers.BatchNorm(c, compute_dtype=jnp.float32)
    y, s = jbn.apply({"scale": scale, "bias": bias},
                     {"mean": mean, "var": var, "count": jnp.int32(3)},
                     jnp.asarray(x), train=True)
    tbn = tlayers.BatchNorm(c, compute_dtype=torch.float32).train()
    tbn.load_state_dict({"scale": torch.from_numpy(scale),
                         "bias": torch.from_numpy(bias),
                         "mean": torch.from_numpy(mean),
                         "var": torch.from_numpy(var),
                         "count": torch.tensor(3, dtype=torch.int32)})
    with torch.no_grad():
        got = tbn(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(y), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tbn.mean.numpy(), s["mean"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tbn.var.numpy(), s["var"], rtol=0, atol=1e-6)
    assert tbn.count.dtype == torch.int32 and int(tbn.count) == 4
    assert int(s["count"]) == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.3, 0.5])
def test_dropout_with_jax_bits_is_exact(dtype, rate):
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(1).standard_normal((2, 5, 5, 8)).astype(
        np.float32)
    key = jax.random.key(4)
    want, _ = jlayers.Dropout(rate).apply({}, {}, jnp.asarray(x, jdt),
                                          train=True, rng=key)
    got = tlayers.Dropout(rate).train()(torch.from_numpy(x).to(tdt),
                                        key=JaxKey(key))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    # the same bits passed in explicitly
    bits = JaxKey(key).bits(x.shape, CPU)
    again = tlayers.Dropout(rate).train()(torch.from_numpy(x).to(tdt),
                                          bits=bits)
    assert torch.equal(again, got)


def test_train_mode_needs_a_key_and_updates_counts():
    model = ResNet("c3,16,3,1,1 r1 n a ap8,1,0 fc16,10", True, True, 0.3,
                   device="cpu").train()
    x = torch.zeros(2, 8, 8, 3)
    with pytest.raises(ValueError, match="requires a key"):
        model(x)
    model(x, key=Key(0))
    counts = {n: int(b) for n, b in model.named_buffers()
              if n.endswith("count")}
    assert counts and set(counts.values()) == {1}


def test_kernel_path_flags_raise():
    """The flag still to port raises; QAT builds on a bottleneck net too
    (tests/test_torch_bneck_train.py), as do the fused bf16, QAT and
    in-kernel dropout paths of the basic block
    (tests/test_torch_qat_train.py), lane transitions
    (tests/test_torch_transition.py) and the Pallas conv
    (tests/test_torch_conv3x3_same.py)."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        ResNet("c3,16,3,1,1 r1 n a ap8,1,0 fc16,10", True, True, 0.3,
               device="cpu", remat=True)
    model = ResNet("c3,64,3,1,1 b2 n a ap8,1,0 fc64,10", False, True, 0.0,
                   device="cpu", int8_train=True)
    block = model.get_submodule("01_stack.block1")
    assert block.int8_train and not block.int8_train_bwd


def test_metrics_match_jax():
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((16, 10)) * 3).astype(np.float32)
    labels = rng.integers(0, 10, 16).astype(np.int32)
    weights = (rng.uniform(size=16) > 0.3).astype(np.float32)
    for w in (None, weights):
        want = jmetrics.compute_losses_and_metrics(
            jnp.asarray(logits), jnp.asarray(labels),
            None if w is None else jnp.asarray(w))
        got = tmetrics.compute_losses_and_metrics(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-6)
        for k in ("top1_err", "top5_err"):
            assert float(got[k]) == pytest.approx(float(want[k]), abs=1e-6)


# --- optimizers and schedulers ----------------------------------------------

OPTIMIZERS = [
    ("SGD", {"lr": 0.1, "momentum": 0.9, "dampening": 0.0, "nesterov": True,
             "weight_decay": 5e-4}, 1e-6),
    ("SGD", {"lr": 0.1, "momentum": 0.9, "dampening": 0.5,
             "weight_decay": 1e-4}, 1e-6),
    ("Adam", {"lr": 0.01}, 1e-4),
    ("AdamW", {"lr": 0.01}, 1e-4),
    ("RMSprop", {"lr": 0.01, "momentum": 0.5}, 1e-4),
    ("Adagrad", {"lr": 0.1, "weight_decay": 1e-3}, 1e-4),
]


@pytest.mark.parametrize("name,args,tol", OPTIMIZERS)
def test_optimizer_steps_match_jax(name, args, tol):
    """Five steps at changing rates from the same parameters and
    gradients."""
    rng = np.random.default_rng(3)
    p0 = {"w": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    lrs = [0.1, 0.1, 0.05, 0.05, 0.02]
    jopt = joptim.get_optimizer(name, args)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jopt.init(jp)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in p0.items()}
    topt = toptim.get_optimizer(name, args)
    opt = topt.init(tparams.values())
    for g, lr in zip(grads, lrs):
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp, jnp.float32(lr))
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt.update(opt, lr)
    for k in p0:
        _close(tparams[k].detach().numpy(), jp[k], tol, k)


SCHEDULERS = [
    ("MultiStepLR", {"milestones": [60, 120, 160], "gamma": 0.2}, 200),
    ("StepLR", {"step_size": 4, "gamma": 0.5}, 20),
    ("ExponentialLR", {"gamma": 0.9}, 20),
    ("CosineAnnealingLR", {"T_max": 10, "eta_min": 0.001}, 10),
    ("LinearLR", {"start_factor": 0.25, "end_factor": 1.0,
                  "total_iters": 5}, 10),
    ("ConstantLR", {"factor": 0.5, "total_iters": 4}, 10),
]


@pytest.mark.parametrize("name,args,steps", SCHEDULERS)
def test_scheduler_lr_sequence_matches_jax(name, args, steps):
    js = joptim.get_scheduler(name, dict(args), base_lr=0.1)
    ts = toptim.get_scheduler(name, dict(args), base_lr=0.1)
    for _ in range(steps):
        assert ts.get_lr() == pytest.approx(js.get_lr(), rel=1e-6, abs=1e-12)
        js.step()
        ts.step()
    assert ts.last_epoch == js.last_epoch == steps


def test_unported_names_raise():
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        toptim.get_scheduler("OneCycleLR", {"max_lr": 1.0,
                                            "total_steps": 10}, 0.1)
    assert toptim.get_scheduler("None", None, 0.1) is None
    with pytest.raises(ValueError):
        toptim.get_optimizer("NoSuchOpt", {})
    with pytest.raises(ValueError, match="Nesterov"):
        toptim.get_optimizer("SGD", {"lr": 0.1, "momentum": 0.9,
                                     "dampening": 0.5, "nesterov": True})


# --- setup ------------------------------------------------------------------

RECIPE = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                      "models_dir", "wrn-28-10-dropout_synthspectral-hard",
                      "config.yaml")
INT8_RECIPE = RECIPE.replace("-hard", "-hard-int8")


def _config(tmp_path, **overrides):
    with open(RECIPE) as f:
        cfg = yaml.safe_load(f)
    cfg.update(architecture_spec="c3,16,3,1,1 r1 r1 n a ap16,1,0 fc32,10",
               batch_size=8, use_pallas_augment=True,
               dataset_args={"class_sep": 0.3, "n_train": 40, "n_test": 16})
    cfg.update(overrides)
    run = tmp_path / "models_dir" / "run"
    run.mkdir(parents=True)
    with open(run / "config.yaml", "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)  # transform order matters
    return get_config(str(tmp_path / "models_dir"), "run",
                      data_dir=str(tmp_path / "data"), verbose=False)


def test_setup_trains_two_steps_on_cpu(tmp_path):
    config = _config(tmp_path)
    ls = setup(config, device="cpu", verbose=False)
    assert ls["augment_pass_indices"]
    assert isinstance(ls["augment_fn"], taug.FusedAugment)
    assert sorted(ls) == sorted([
        "mesh", "model", "optimizer", "scheduler", "checkpoint_strategy",
        "pipeline", "augment_fn", "preprocess_fn", "train_state",
        "global_step", "num_microbatches", "augment_pass_indices",
        "device"])
    assert os.path.exists(os.path.join(
        config["checkpoint_dir"], "standardizewhiteningtransform_1.ckpt"))
    step = ls["pipeline"].bind_train_step(
        make_train_step(ls["model"], ls["optimizer"], ls["num_microbatches"],
                        augment_fn=ls["augment_fn"]),
        pass_indices=ls["augment_pass_indices"])
    before = {k: v.detach().clone()
              for k, v in ls["train_state"]["params"].items()}
    for gs, (_, (idx,)) in enumerate(ls["pipeline"].train_feed(0,
                                                               budget=2)):
        ts, m = step(ls["train_state"], idx, ls["scheduler"].get_lr(),
                     Key(config.get("seed", 0)).fold_in(gs))
        assert math.isfinite(float(m["loss"]))
    for k, v in ts["params"].items():
        assert not torch.equal(v, before[k]), k
    counts = [int(b) for n, b in ts["model_state"].items()
              if n.endswith("count")]
    assert counts and set(counts) == {2}
    assert ls["scheduler"].get_lr() == 0.1  # MultiStepLR, epoch unit


@pytest.mark.parametrize("flag,where", [("use_pallas_conv", None),
                                        ("remat", "Queue 1 item 11"),
                                        ("use_lane_transition", None)])
def test_setup_raises_for_unported_flags(tmp_path, flag, where):
    """The flags still to port raise; the ported ones (``where`` None)
    build their recipe: ``use_lane_transition`` the -hard-int8 recipe,
    whose two stage transitions report ``lane_through_eligible``;
    ``use_pallas_conv`` the -hard recipe, whose 22 stride-1 3x3 block
    convs take the kernel (not the stem, the stride-2 convs or the
    projections)."""
    if where is not None:
        with pytest.raises(NotImplementedError, match=where):
            setup(_config(tmp_path, **{flag: True}), device="cpu",
                  verbose=False)
        return
    with open(INT8_RECIPE if flag == "use_lane_transition" else RECIPE) as f:
        cfg = yaml.safe_load(f)
    cfg.update(dataset_args={**cfg["dataset_args"], "n_train": 40,
                             "n_test": 16}, **{flag: True})
    ls = setup(_config(tmp_path, **cfg), device="cpu", verbose=False)
    model = ls["model"]
    if flag == "use_pallas_conv":
        assert model.pallas_conv and not model.get_submodule("00_conv").pallas
        taken = [n for n, m in model.named_modules()
                 if getattr(m, "pallas", False) and m.kernel_size == 3
                 and m.stride == 1]
        assert len(taken) == 22, taken
        return
    assert model.lane_transition and model.int8_train_bwd
    shapes = {"02_stack": (128, 32, 32, 160), "03_stack": (128, 16, 16, 320)}
    for stage in ("01_stack", "02_stack", "03_stack"):
        block = model.get_submodule(f"{stage}.block0")
        assert block.lane_transition
        assert block.lane_through_eligible(
            shapes.get(stage, (128, 32, 32, 160)), True) == (
                stage in shapes), stage


def test_setup_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        setup(_config(tmp_path), verbose=False)


def test_chip_smoke_run_keeps_the_transform_order(tmp_path):
    """chip_smoke.py's run directories keep the recipe's key order (a
    sorted dump once put the whitening before ToTensorTransform)."""
    import chip_smoke

    config = chip_smoke.write_run(str(tmp_path), "run", RECIPE,
                                  use_pallas_augment=True)
    with open(RECIPE) as f:
        recipe = yaml.safe_load(f)
    for split in ("data_aug_train", "data_aug_test"):
        assert list(config[split]) == list(recipe[split])
    assert config["use_pallas_augment"]
