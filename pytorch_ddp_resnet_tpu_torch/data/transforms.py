"""Batched data transforms on NHWC tensors (counterpart of
pytorch_ddp_resnet_tpu/data/transforms.py).

- ``ToTensorTransform``: uint8 [0, 255] -> float32 [0, 1].
- ``ZeroMeanWhiteningTransform`` / ``StandardizeWhiteningTransform``:
  per-pixel ``x - mean`` / ``(x - mean) / stddev`` with train-set
  statistics (population stddev), fitted in f32 or loaded from the
  fitted-transform checkpoint (keys ``mean``, ``stddev``, ``fitted``).
- ``FlipTransform(p)``: per-sample Bernoulli(p) horizontal flip.
- ``PaddingTransform(pad_size, zero|mirror)``: zero or reflect padding of
  H and W (reflect: the edge is not repeated).
- ``RandomCropTransform(crop_size)``: per-sample uniform top-left corner
  in [0, dim - crop].

Stochastic transforms draw from a ``Key`` (utils/rng.py) as the JAX ones
draw from their rng (the crop splits its key into top and left), or take
their draws explicitly: ``flip`` (B,) bool, ``tops`` / ``lefts`` (B,) int.
``make_batch_augment_fn`` hands transform i the key ``key.fold_in(i)``.

Divisions are tensor by tensor, so the card divides exactly as the CPU
does (a Python-scalar divisor becomes a reciprocal multiply on the card).
ZCA whitening, random scaling, center crop and color jitter are not
ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Shape = Tuple[int, ...]

NOT_PORTED = ("ZCAWhiteningTransform", "RandomScaleTransform",
              "CenterCropTransform", "ColorTransform")
TRANSFORMS_TODO = ("not ported yet (ROADMAP.md Queue 1, transforms and "
                   "resident data)")


class Transform:
    """A batched transform on ``(B, H, W, C)`` tensors; ``data_shape`` is
    the per-sample input shape (H, W, C)."""

    fittable = False
    stochastic = False

    def __init__(self, data_shape: Shape):
        self.data_shape = tuple(data_shape)

    @property
    def output_shape(self) -> Shape:
        return self.data_shape

    def apply_batch(self, x: torch.Tensor, key=None) -> torch.Tensor:
        raise NotImplementedError


class ToTensorTransform(Transform):
    def apply_batch(self, x: torch.Tensor, key=None) -> torch.Tensor:
        return x.to(torch.float32) / torch.tensor(255.0, device=x.device)


class _Whitening(Transform):
    """Fitted per-pixel statistics, kept as f32 tensors."""

    fittable = True
    _keys: Tuple[str, ...] = ()

    def __init__(self, data_shape: Shape):
        super().__init__(data_shape)
        self.mean = torch.zeros(self.data_shape)
        self.stddev = torch.ones(self.data_shape)
        self.fitted = False

    def _require_fitted(self) -> None:
        if not self.fitted:
            raise RuntimeError(
                f"{type(self).__name__} must be fitted before use.")

    def state_dict(self) -> Dict[str, np.ndarray]:
        d = {k: getattr(self, k).cpu().numpy() for k in self._keys}
        d["fitted"] = np.asarray(self.fitted)
        return d

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        for k in self._keys:
            v = np.asarray(d[k], np.float32)
            if v.shape != self.data_shape:
                raise ValueError(f"fitted {k} of shape {v.shape} for input "
                                 f"shape {self.data_shape}")
            setattr(self, k, torch.from_numpy(v))
        self.fitted = bool(d["fitted"])


class ZeroMeanWhiteningTransform(_Whitening):
    _keys = ("mean",)

    def fit(self, x: torch.Tensor) -> None:
        """x: the train set through the upstream transforms, (N, H, W, C)."""
        self.mean = x.to(torch.float32).mean(dim=0)
        self.fitted = True

    def apply_batch(self, x: torch.Tensor, key=None) -> torch.Tensor:
        self._require_fitted()
        return x - self.mean.to(x.device)


class StandardizeWhiteningTransform(_Whitening):
    _keys = ("mean", "stddev")

    def fit(self, x: torch.Tensor) -> None:
        """x: the train set through the upstream transforms, (N, H, W, C)."""
        x = x.to(torch.float32)
        mean = x.mean(dim=0)
        var = torch.square(x - mean).mean(dim=0)  # population variance
        self.mean, self.stddev = mean, torch.sqrt(var)
        self.fitted = True

    def apply_batch(self, x: torch.Tensor, key=None) -> torch.Tensor:
        self._require_fitted()
        return (x - self.mean.to(x.device)) / self.stddev.to(x.device)


class FlipTransform(Transform):
    stochastic = True

    def __init__(self, data_shape: Shape, p: float):
        super().__init__(data_shape)
        self.p = float(p)

    def apply_batch(self, x: torch.Tensor, key=None,
                    flip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if flip is None:
            flip = key.bernoulli(self.p, (x.shape[0],), x.device)
        flip = flip.to(device=x.device, dtype=torch.bool)
        return torch.where(flip[:, None, None, None], x.flip(2), x)


class PaddingTransform(Transform):
    def __init__(self, data_shape: Shape, pad_size: int, pad_type: str):
        if pad_type not in ("zero", "mirror"):
            raise ValueError("pad_type must be 'zero' or 'mirror'.")
        super().__init__(data_shape)
        self.pad_size = int(pad_size)
        self.pad_type = pad_type

    @property
    def output_shape(self) -> Shape:
        h, w, c = self.data_shape
        p = self.pad_size
        return (h + 2 * p, w + 2 * p, c)

    def apply_batch(self, x: torch.Tensor, key=None) -> torch.Tensor:
        p = self.pad_size
        mode = "reflect" if self.pad_type == "mirror" else "constant"
        y = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode=mode)
        return y.permute(0, 2, 3, 1)


class RandomCropTransform(Transform):
    stochastic = True

    def __init__(self, data_shape: Shape, crop_size: int):
        super().__init__(data_shape)
        self.crop_size = int(crop_size)

    @property
    def output_shape(self) -> Shape:
        return (self.crop_size, self.crop_size, self.data_shape[-1])

    def apply_batch(self, x: torch.Tensor, key=None,
                    tops: Optional[torch.Tensor] = None,
                    lefts: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        cs = self.crop_size
        if tops is None or lefts is None:
            k_top, k_left = key.split(2)  # as the JAX crop splits its rng
            tops = k_top.randint((b,), 0, h - cs + 1, x.device)
            lefts = k_left.randint((b,), 0, w - cs + 1, x.device)
        return crop_batch(x, tops, lefts, cs)


def crop_batch(x: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
               crop: int) -> torch.Tensor:
    """Per-sample crop windows of NHWC x by an index gather."""
    ar = torch.arange(crop, device=x.device)
    rows = tops.to(x.device).long()[:, None] + ar          # (B, crop)
    cols = lefts.to(x.device).long()[:, None] + ar
    bidx = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[bidx, rows[:, :, None], cols[:, None, :]]


TRANSFORM_REGISTRY = {
    "ToTensorTransform": ToTensorTransform,
    "ZeroMeanWhiteningTransform": ZeroMeanWhiteningTransform,
    "StandardizeWhiteningTransform": StandardizeWhiteningTransform,
    "FlipTransform": FlipTransform,
    "PaddingTransform": PaddingTransform,
    "RandomCropTransform": RandomCropTransform,
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
    """Compose transforms into one ``(x, key=None) -> x`` function; transform
    i draws from ``key.fold_in(i)``. Without a key only deterministic
    pipelines run (the test-time ``data_aug_test``)."""
    ts = list(transforms)
    for t in ts:
        if t.fittable and not t.fitted:
            raise RuntimeError(
                f"{type(t).__name__} must be fitted before use.")

    def augment(x: torch.Tensor, key=None) -> torch.Tensor:
        for i, t in enumerate(ts):
            if t.stochastic and key is None:
                raise ValueError(f"{type(t).__name__} needs a key.")
            x = t.apply_batch(x, key.fold_in(i) if t.stochastic else None)
        return x

    return augment
