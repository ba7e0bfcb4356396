"""Array datasets (own copy of the array-dataset part of
pytorch_ddp_resnet_tpu/data/datasets.py).

- ``CIFAR10`` / ``CIFAR100``: the standard python-pickle archives
  (``cifar-10-batches-py`` / ``cifar-100-python``) read from ``data_dir``;
  nothing is downloaded.
- ``Synthetic``: deterministic fake CIFAR-shaped data with a linearly
  recoverable class signal.
- ``SyntheticSpectral``: class-conditional Gaussian random fields, cached
  to ``data_dir`` after first generation (same file as the JAX package's,
  so both read the same cache).

The other JAX loaders (MNIST family, SVHN, STL10, the image-folder sets)
are not ported yet.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class ArrayDataset:
    """An in-memory image-classification dataset: x uint8 NHWC, y int32."""

    x: np.ndarray
    y: np.ndarray
    num_classes: int
    name: str = "dataset"

    def __post_init__(self):
        if not (self.x.ndim == 4 and self.x.dtype == np.uint8):
            raise ValueError(f"x must be uint8 NHWC, got {self.x.dtype} "
                             f"{self.x.shape}")
        if not (self.y.ndim == 1 and len(self.x) == len(self.y)):
            raise ValueError(f"y {self.y.shape} does not label x "
                             f"{self.x.shape}")

    def __len__(self) -> int:
        return len(self.x)

    @property
    def data_shape(self) -> Tuple[int, int, int]:
        return tuple(self.x.shape[1:])


def _load_cifar_batch(path: str):
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # -> NHWC
    y = d.get(b"labels", d.get(b"fine_labels"))
    return np.ascontiguousarray(x), np.asarray(y, np.int32)


def _require_dir(base: str, name: str) -> None:
    if not os.path.isdir(base):
        raise FileNotFoundError(
            f"{name} not found at {base} (the archive must be extracted "
            f"there; nothing is downloaded).")


def load_cifar10(data_dir: str, train: bool) -> ArrayDataset:
    base = os.path.join(data_dir, "cifar-10-batches-py")
    _require_dir(base, "CIFAR-10")
    if train:
        parts = [_load_cifar_batch(os.path.join(base, f"data_batch_{i}"))
                 for i in range(1, 6)]
        x = np.concatenate([p[0] for p in parts])
        y = np.concatenate([p[1] for p in parts])
    else:
        x, y = _load_cifar_batch(os.path.join(base, "test_batch"))
    return ArrayDataset(x, y, num_classes=10, name="CIFAR10")


def load_cifar100(data_dir: str, train: bool) -> ArrayDataset:
    base = os.path.join(data_dir, "cifar-100-python")
    _require_dir(base, "CIFAR-100")
    x, y = _load_cifar_batch(os.path.join(base, "train" if train else "test"))
    return ArrayDataset(x, y, num_classes=100, name="CIFAR100")


def load_synthetic(
    data_dir: str,
    train: bool,
    n_train: int = 512,
    n_test: int = 256,
    shape: Tuple[int, int, int] = (32, 32, 3),
    num_classes: int = 10,
    seed: int = 0,
) -> ArrayDataset:
    """Deterministic fake data whose class signal is linearly recoverable."""
    n = n_train if train else n_test
    rng = np.random.default_rng(seed + (0 if train else 1))
    y = rng.integers(0, num_classes, size=(n,)).astype(np.int32)
    x = rng.integers(0, 256, size=(n,) + tuple(shape)).astype(np.float32)
    # plant a per-class mean shift
    x = np.clip(x * 0.5 + y[:, None, None, None] * (128.0 / num_classes),
                0, 255)
    return ArrayDataset(x.astype(np.uint8), y, num_classes=num_classes,
                        name="Synthetic")


def load_synthetic_spectral(
    data_dir: str,
    train: bool,
    n_train: int = 50000,
    n_test: int = 10000,
    shape: Tuple[int, int, int] = (32, 32, 3),
    num_classes: int = 10,
    seed: int = 0,
    class_sep: float = 1.0,
) -> ArrayDataset:
    """Class-conditional Gaussian random fields: class k owns a random
    spectral energy mask M_k; a sample is ``irfft2(M_k * rfft2(noise))``,
    contrast-normalized per sample. ``class_sep`` scales each mask's
    distance from a shared common mask (the difficulty knob)."""
    h, w, c = shape
    n = n_train if train else n_test
    sep_key = "" if class_sep == 1.0 else f"_sep{class_sep:g}"
    cache = None
    if data_dir:
        os.makedirs(data_dir, exist_ok=True)
        cache = os.path.join(
            data_dir,
            f"synthetic_spectral_{'train' if train else 'test'}_{n}_"
            f"{h}x{w}x{c}_{num_classes}c_seed{seed}{sep_key}.npz")
        if os.path.exists(cache):
            with np.load(cache) as d:
                return ArrayDataset(d["x"], d["y"], num_classes=num_classes,
                                    name="SyntheticSpectral")
    mask_rng = np.random.default_rng(seed)
    masks = mask_rng.gamma(
        2.0, 1.0, size=(num_classes, h, w // 2 + 1)).astype(np.float32)
    if class_sep != 1.0:
        common = mask_rng.gamma(
            2.0, 1.0, size=(1, h, w // 2 + 1)).astype(np.float32)
        masks = common + np.float32(class_sep) * (masks - common)
    masks[:, 0, 0] = 0.0  # no DC component: keeps textures zero-mean

    srng = np.random.default_rng([seed, 0 if train else 1, 11])
    y = srng.integers(0, num_classes, size=(n,)).astype(np.int32)
    out = np.empty((n, h, w, c), np.uint8)
    chunk = 4096
    for start in range(0, n, chunk):
        yy = y[start:start + chunk]
        z = srng.standard_normal(size=(len(yy), c, h, w), dtype=np.float32)
        spec = np.fft.rfft2(z) * masks[yy][:, None]
        img = np.fft.irfft2(spec, s=(h, w)).astype(np.float32)
        img /= img.std(axis=(1, 2, 3), keepdims=True) + 1e-8
        img = np.clip(img * 36.0 + 128.0, 0, 255)
        out[start:start + chunk] = img.transpose(0, 2, 3, 1).astype(np.uint8)
    if cache and not os.path.exists(cache):
        tmp = f"{cache}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:  # handle: savez won't append .npz
            np.savez(f, x=out, y=y)
        os.replace(tmp, cache)
    return ArrayDataset(out, y, num_classes=num_classes,
                        name="SyntheticSpectral")


_LOADERS = {
    "CIFAR10": load_cifar10,
    "CIFAR100": load_cifar100,
    "Synthetic": load_synthetic,
    "SyntheticSpectral": load_synthetic_spectral,
}


def get_dataset(dataset_cls_name: str, data_dir: str, train: bool, **kwargs):
    """Name-keyed dataset factory (the YAML ``dataset_cls_name``)."""
    if dataset_cls_name not in _LOADERS:
        raise NotImplementedError(
            f"dataset {dataset_cls_name!r} is not ported yet (ROADMAP.md "
            f"Queue 1); available: {sorted(_LOADERS)}")
    return _LOADERS[dataset_cls_name](data_dir, train, **kwargs)
