"""The port's serving entry point (algos/predict.py) on a run directory
written by the JAX package: its ``setup`` fits and checkpoints the
standardize transform, and a classifier checkpoint (with non-trivial
BatchNorm statistics) is saved the way its training loop saves one. The
port's ``load_predictor`` serves that directory; its logits are held
against the JAX package's ``load_predictor`` on the same images.

Tolerances (compute dtype float32): float serving 1e-4 of the logit
range (same f32 formulas, different summation orders); int8 serving 1%
of the logit range, as tests/test_torch_quantize.py argues (each package
calibrates on its own, and the scales agree to ~1e-7 relative).
"""

import shutil

import jax
import numpy as np
import pytest
import torch
import yaml

from pytorch_ddp_resnet_tpu.algos.predict import (
    load_predictor as jax_load_predictor,
)
from pytorch_ddp_resnet_tpu.algos.train import setup
from pytorch_ddp_resnet_tpu.data.datasets import load_synthetic
from pytorch_ddp_resnet_tpu.utils.checkpoint import (
    PytreeCheckpointable,
    save_checkpoint,
    save_checkpoints,
)
from pytorch_ddp_resnet_tpu.utils.config import get_config as jax_get_config
from pytorch_ddp_resnet_tpu_torch.algos.predict import (
    Predictor,
    load_predictor,
    train_kinds,
)
from pytorch_ddp_resnet_tpu_torch.data.datasets import get_dataset
from pytorch_ddp_resnet_tpu_torch.data.pipeline import build_transforms
from pytorch_ddp_resnet_tpu_torch.utils.checkpoint import (
    latest_step,
    load_checkpoint,
    resume_step,
)
from pytorch_ddp_resnet_tpu_torch.utils.config import get_config

from _torch_port_helpers import _randomize_bn

SHAPE = [8, 8, 3]
CONFIG = {
    "dataset_cls_name": "Synthetic",
    "dataset_args": {"shape": SHAPE, "n_train": 64, "n_test": 40},
    "data_aug_train": {"ToTensorTransform": {},
                       "StandardizeWhiteningTransform": {},
                       "FlipTransform": {"p": 0.5}},
    "data_aug_test": {"ToTensorTransform": {},
                      "StandardizeWhiteningTransform": {}},
    "architecture_spec": "c3,32,3,1,1 r1 r1 n a ap4,1,0 fc64,10",
    "preact": True,
    "use_proj": True,
    "dropout_prob": 0.3,
    "compute_dtype": "float32",
    "max_steps": 1,
    "batch_size": 16,
    "optimizer_cls_name": "SGD",
    "optimizer_args": {"lr": 0.1, "momentum": 0.9},
    "scheduler_cls_name": "None",
    "checkpoint_strategy_cls_name": "FrequencyCheckpointStrategy",
    "checkpoint_strategy_args": {"unit": "epoch", "frequency": 1},
}


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run directory as the JAX package leaves it after training."""
    root = tmp_path_factory.mktemp("models_dir")
    (root / "run").mkdir()
    (root / "run" / "config.yaml").write_text(
        yaml.safe_dump(CONFIG, sort_keys=False))
    data_dir = str(root / "data")
    config = jax_get_config(str(root), "run", data_dir=data_dir,
                            verbose=False)
    ls = setup(config, verbose=False)  # fits + saves the standardize ckpt
    ts = jax.device_get(ls["train_state"])
    params, state = ts["params"], ts["model_state"]
    _randomize_bn(params, state, np.random.default_rng(7))
    save_checkpoints(config["checkpoint_dir"], {
        "checkpoint_strategy": ls["checkpoint_strategy"],
        "classifier": PytreeCheckpointable(
            {"params": params, "model_state": state}),
        "optimizer": PytreeCheckpointable(ts["opt_state"]),
        "scheduler": ls["scheduler"],
    }, steps=3)
    images = load_synthetic(None, train=False, n_test=40,
                            shape=tuple(SHAPE)).x
    return dict(root=str(root), data_dir=data_dir, jax_config=config,
                images=images)


def _port_config(run_dir):
    return get_config(run_dir["root"], "run", data_dir=run_dir["data_dir"],
                      verbose=False)


def test_reads_the_jax_checkpoint(run_dir):
    state, step = load_checkpoint(_port_config(run_dir)["checkpoint_dir"],
                                  "classifier")
    assert step == 3
    assert set(state) == {"params", "model_state"}
    assert state["params"]["00_conv"]["w"].shape == (3, 3, 3, 32)


def test_float_serving_matches_jax(run_dir):
    ref = jax_load_predictor(run_dir["jax_config"], batch_size=16).logits(
        run_dir["images"])
    pred = load_predictor(_port_config(run_dir), batch_size=16,
                          device="cpu")
    got = pred.logits(run_dir["images"])  # 40 = 2*16 + a padded 8
    assert got.shape == ref.shape == (40, 10)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    np.testing.assert_array_equal(pred.predict(run_dir["images"]),
                                  np.argmax(got, -1))


def test_int8_serving_matches_jax(run_dir):
    ref_pred = jax_load_predictor(run_dir["jax_config"], batch_size=16,
                                  quantize="int8", calib_samples=32)
    pred = load_predictor(_port_config(run_dir), batch_size=16,
                          quantize="int8", calib_samples=32, device="cpu")
    assert pred.n_quantized == ref_pred.n_quantized == 3
    ref = ref_pred.logits(run_dir["images"])
    got = pred.logits(run_dir["images"])
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=0.01 * np.abs(ref).max())


def test_in_memory_fit_matches_the_jax_fit(run_dir, tmp_path):
    config = _port_config(run_dir)
    train = get_dataset("Synthetic", None, train=True,
                        **CONFIG["dataset_args"])
    loaded = build_transforms(train, CONFIG["data_aug_test"],
                              config["checkpoint_dir"], is_train=True,
                              save=False)
    fitted = build_transforms(train, CONFIG["data_aug_test"], str(tmp_path),
                              is_train=True, save=False)
    assert not any(tmp_path.iterdir())  # serving writes nothing
    name = "StandardizeWhiteningTransform"
    for attr in ("mean", "stddev"):
        np.testing.assert_allclose(getattr(fitted[name], attr).numpy(),
                                   getattr(loaded[name], attr).numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_int8_rejects_an_ineligible_model(run_dir, tmp_path):
    cfg = dict(CONFIG, architecture_spec="c3,16,3,1,1 r1 n a ap8,1,0 "
                                         "fc16,10")
    (tmp_path / "run").mkdir()
    (tmp_path / "run" / "config.yaml").write_text(yaml.safe_dump(cfg))
    config = get_config(str(tmp_path), "run", data_dir=run_dir["data_dir"],
                        verbose=False)
    with pytest.raises(ValueError, match="no eligible convs"):
        load_predictor(config, batch_size=16, quantize="int8", device="cpu")


def test_entry_points_default_to_the_card(run_dir):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_predictor(_port_config(run_dir))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(torch.nn.Identity(), None)


def test_serving_skips_a_torn_save(run_dir, tmp_path):
    """A save torn at step 5: only ``classifier_5.ckpt`` landed (other
    BatchNorm statistics), no optimizer file and no manifest. JAX resumes
    from the complete save of step 3, so serving must too: logits within
    1e-4 of the range of JAX's."""
    root = tmp_path / "models_dir"
    shutil.copytree(run_dir["root"], root)
    jcfg = jax_get_config(str(root), "run", data_dir=run_dir["data_dir"],
                          verbose=False)
    ts = jax.device_get(setup(jcfg, verbose=False)["train_state"])
    _randomize_bn(ts["params"], ts["model_state"], np.random.default_rng(9))
    save_checkpoint(jcfg["checkpoint_dir"], "classifier", PytreeCheckpointable(
        {"params": ts["params"], "model_state": ts["model_state"]}), steps=5)
    ref = jax_load_predictor(jcfg, batch_size=16).logits(run_dir["images"])
    config = get_config(str(root), "run", data_dir=run_dir["data_dir"],
                        verbose=False)
    got = load_predictor(config, batch_size=16, device="cpu").logits(
        run_dir["images"])
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    ckpt = config["checkpoint_dir"]
    assert latest_step(ckpt, "classifier") == 5
    assert resume_step(ckpt, train_kinds(config)) == 3
