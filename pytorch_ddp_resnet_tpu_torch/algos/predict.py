"""Inference / serving surface (counterpart of pytorch_ddp_resnet_tpu/
algos/predict.py).

``load_predictor(config)`` -> ``Predictor`` with:
- ``logits(images_u8_nhwc)`` / ``predict(images)`` (top-1 labels) for any
  number of images, served in fixed-size batches (the last one padded by
  repeating its final image);
- ``fold_bn=True`` (default): eval-time BatchNorm folding for post-act
  models (models/fold.py);
- ``quantize='int8'``: w8a8 post-training quantized serving on the hand-
  written CUDA kernels (models/quantize.py), calibrated on training
  images.

Everything runs on the card unless ``device='cpu'`` is passed. AOT export
(the JAX package's ``export_bytes`` / ``export_predictor`` /
``load_exported``) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from pytorch_ddp_resnet_tpu_torch.convert import state_dict_from_jax
from pytorch_ddp_resnet_tpu_torch.data.datasets import get_dataset
from pytorch_ddp_resnet_tpu_torch.data.pipeline import build_transforms
from pytorch_ddp_resnet_tpu_torch.data.transforms import make_batch_augment_fn
from pytorch_ddp_resnet_tpu_torch.models.fold import fold_batchnorm
from pytorch_ddp_resnet_tpu_torch.models.quantize import (
    Int8Inference,
    calibrate,
)
from pytorch_ddp_resnet_tpu_torch.models.resnet import ResNet
from pytorch_ddp_resnet_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    resume_step,
)
from pytorch_ddp_resnet_tpu_torch.utils.types import (
    DTYPES,
    Device,
    resolve_device,
)

_REQUIRED_KEYS = ("dataset_cls_name", "architecture_spec", "preact",
                  "use_proj", "dropout_prob", "batch_size")


class Predictor:
    def __init__(self, model, preprocess_fn: Optional[Callable],
                 batch_size: int = 256, fold_bn: bool = True,
                 device: Device = "cuda"):
        self.device = resolve_device(device)
        # the pre-fold model: quantize_int8 folds the BN eval affines into
        # its dequant scales itself, so it starts from this one
        self._model = model.to(self.device)
        self._batch = batch_size
        self._preprocess = preprocess_fn
        self.n_quantized = 0
        self.act_scales = None
        if fold_bn:
            served, self.n_folded = fold_batchnorm(self._model)
        else:
            served, self.n_folded = self._model, 0
        self._fwd = served

    def _prep(self, chunk: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
        return self._preprocess(x) if self._preprocess else x

    def quantize_int8(self, calib_images: np.ndarray,
                      fused_bneck="nv") -> int:
        """Switch the serving forward to the w8a8 post-training-quantized
        path (models/quantize.py). ``calib_images``: raw uint8 NHWC images,
        calibrated at the serving batch geometry so scale placement and
        int8 eligibility match serving exactly. ``fused_bneck``: "nv" (the
        JAX default) runs post-act bottleneck trunks, identity and
        transition blocks, on the NV kernels (ops/cuda/bneck_nv.py); False
        serves identity bottlenecks on the NHWC int8 products.

        Returns the number of quantized convs; raises ValueError when the
        model has none (channel counts not divisible by 32)."""
        inf = Int8Inference(self._model, fused_bneck=fused_bneck)
        batches = [self._prep(c) for c in self._padded_chunks(calib_images)]
        scales = calibrate(inf, batches)
        if not scales:
            raise ValueError(
                "int8 quantization: no eligible convs in this model "
                "(needs basic residual blocks with identity shortcuts and "
                "channel counts divisible by 32).")
        self._fwd = inf.serve_fn(scales)
        self.act_scales = scales
        self.n_quantized = len(scales)
        return len(scales)

    def _padded_chunks(self, images: np.ndarray):
        """Serving-batch-sized chunks, the last one padded by repeating its
        final image."""
        for start in range(0, len(images), self._batch):
            chunk = images[start:start + self._batch]
            pad = self._batch - len(chunk)
            if pad:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], pad, axis=0)])
            yield chunk

    def logits(self, images: np.ndarray) -> np.ndarray:
        """images: (N, H, W, C) uint8 (raw), any N; returns (N, classes)."""
        n = len(images)
        with torch.no_grad():
            out = [self._fwd(self._prep(c)).to(torch.float32).cpu().numpy()
                   for c in self._padded_chunks(images)]
        return np.concatenate(out)[:n]

    def predict(self, images: np.ndarray) -> np.ndarray:
        """Top-1 class labels."""
        return np.argmax(self.logits(images), axis=-1)


def train_kinds(config):
    """The checkpoint kinds the JAX ``setup`` loads together (its
    ``maybe_load_checkpoints`` call): the scheduler only when there is
    one."""
    kinds = ["checkpoint_strategy", "classifier", "optimizer"]
    if config.get("scheduler_cls_name") not in (None, "None"):
        kinds.append("scheduler")
    return kinds


def load_predictor(config, batch_size: Optional[int] = None,
                   verbose: bool = False, fold_bn: bool = True,
                   quantize: Optional[str] = None, calib_samples: int = 512,
                   device: Device = "cuda") -> Predictor:
    """Build a Predictor from a run directory: config, model, the classifier
    of the step the JAX package's ``setup`` resumes from (the newest
    complete save of its checkpoint kinds; else a fresh init from
    ``seed``), the test-time transforms and, for ``quantize='int8'``,
    ``calib_samples`` calibration images from the training set."""
    dev = resolve_device(device)
    missing = [k for k in _REQUIRED_KEYS if config.get(k) is None]
    if missing:
        raise ValueError(f"config.yaml is missing required keys: {missing}")
    if quantize not in (None, "int8"):
        raise ValueError(f"Unknown quantize mode {quantize!r}.")
    dataset_args = config.get("dataset_args") or {}
    name, data_dir = config.get("dataset_cls_name"), config.get("data_dir")
    dataset_train = get_dataset(name, data_dir, train=True, **dataset_args)
    # the test pipeline's fittables come from the train run's checkpoint,
    # else are fitted in memory; serving writes nothing into the run
    transforms = build_transforms(
        dataset_train, config.get("data_aug_test"),
        config.get("checkpoint_dir"), is_train=True, device=dev, save=False,
        verbose=verbose)
    model = ResNet(
        architecture_spec=config.get("architecture_spec"),
        preact=config.get("preact"),
        use_proj=config.get("use_proj"),
        dropout_prob=config.get("dropout_prob"),
        compute_dtype=DTYPES[config.get("compute_dtype", "bfloat16")],
        generator=torch.Generator().manual_seed(config.get("seed", 0)),
        device=dev)
    ckpt_dir = config.get("checkpoint_dir")
    step = resume_step(ckpt_dir, train_kinds(config))
    state, step = (load_checkpoint(ckpt_dir, "classifier", step)
                   if step is not None else (None, 0))
    if state is not None:
        model.load_state_dict(state_dict_from_jax(state["params"],
                                                  state["model_state"]))
        if verbose:
            print(f"Loaded classifier checkpoint at step {step}.")
    elif verbose:
        print("Warning: no checkpoint found; predicting with fresh init.")
    pred = Predictor(model, make_batch_augment_fn(list(transforms.values())),
                     batch_size=batch_size or config.get("batch_size", 256),
                     fold_bn=fold_bn, device=dev)
    if quantize == "int8":
        calib = dataset_train.x[:max(calib_samples, 1)]
        n = pred.quantize_int8(calib)
        if verbose:
            print(f"int8-quantized {n} convs ({len(calib)} calibration "
                  f"images).")
    return pred
