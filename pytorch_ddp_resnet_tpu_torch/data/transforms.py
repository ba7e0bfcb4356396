"""Batched data transforms on NHWC tensors (counterpart of
pytorch_ddp_resnet_tpu/data/transforms.py, test-time transforms only).

- ``ToTensorTransform``: uint8 [0, 255] -> float32 [0, 1].
- ``StandardizeWhiteningTransform``: per-pixel ``(x - mean) / stddev``
  with train-set statistics (population stddev), fitted in memory or
  loaded from the JAX package's fitted-transform checkpoint.

Divisions are tensor by tensor, so the card divides exactly as the CPU
does (a Python-scalar divisor becomes a reciprocal multiply on the card).
The stochastic training transforms wait for the training slice.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

Shape = Tuple[int, ...]

NOT_PORTED = ("ZeroMeanWhiteningTransform", "ZCAWhiteningTransform",
              "FlipTransform", "PaddingTransform", "RandomCropTransform",
              "RandomScaleTransform", "CenterCropTransform", "ColorTransform")
TRANSFORMS_TODO = ("not ported yet (ROADMAP.md Queue 1, transforms and "
                   "resident data)")


class Transform:
    """A batched deterministic transform on ``(B, H, W, C)`` tensors;
    ``data_shape`` is the per-sample input shape (H, W, C)."""

    fittable = False

    def __init__(self, data_shape: Shape):
        self.data_shape = tuple(data_shape)

    @property
    def output_shape(self) -> Shape:
        return self.data_shape

    def apply_batch(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class ToTensorTransform(Transform):
    def apply_batch(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.float32) / torch.tensor(255.0, device=x.device)


class StandardizeWhiteningTransform(Transform):
    fittable = True

    def __init__(self, data_shape: Shape):
        super().__init__(data_shape)
        self.mean = torch.zeros(self.data_shape)
        self.stddev = torch.ones(self.data_shape)
        self.fitted = False

    def fit(self, x: torch.Tensor) -> None:
        """x: the train set through the upstream transforms, (N, H, W, C)."""
        x = x.to(torch.float32)
        mean = x.mean(dim=0)
        var = torch.square(x - mean).mean(dim=0)  # population variance
        self.mean, self.stddev = mean, torch.sqrt(var)
        self.fitted = True

    def apply_batch(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fitted:
            raise RuntimeError(
                f"{type(self).__name__} must be fitted before use.")
        return (x - self.mean.to(x.device)) / self.stddev.to(x.device)

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        mean = np.asarray(d["mean"], np.float32)
        if mean.shape != self.data_shape:
            raise ValueError(f"fitted statistics of shape {mean.shape} for "
                             f"input shape {self.data_shape}")
        self.mean = torch.from_numpy(mean)
        self.stddev = torch.from_numpy(np.asarray(d["stddev"], np.float32))
        self.fitted = bool(d["fitted"])


TRANSFORM_REGISTRY = {
    "ToTensorTransform": ToTensorTransform,
    "StandardizeWhiteningTransform": StandardizeWhiteningTransform,
}


def get_transform_cls(transform_cls_name: str):
    if transform_cls_name in NOT_PORTED:
        raise NotImplementedError(f"{transform_cls_name}: {TRANSFORMS_TODO}")
    if transform_cls_name not in TRANSFORM_REGISTRY:
        raise ValueError(
            f"Unknown transform {transform_cls_name!r}; available: "
            f"{sorted(TRANSFORM_REGISTRY) + sorted(NOT_PORTED)}")
    return TRANSFORM_REGISTRY[transform_cls_name]


def make_batch_augment_fn(transforms: Sequence[Transform]):
    """Compose deterministic transforms into one ``x -> x`` function (the
    test-time pipeline, ``data_aug_test``)."""
    ts = list(transforms)
    for t in ts:
        if t.fittable and not t.fitted:
            raise RuntimeError(
                f"{type(t).__name__} must be fitted before use.")

    def augment(x: torch.Tensor) -> torch.Tensor:
        for t in ts:
            x = t.apply_batch(x)
        return x

    return augment
