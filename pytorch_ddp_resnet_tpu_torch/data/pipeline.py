"""Transform building and the resident input pipeline (counterpart of
pytorch_ddp_resnet_tpu/data/pipeline.py, one device).

- ``build_transforms``: the ordered YAML transform pipeline of one split.
  Train split: a fittable is restored from ``{name.lower()}_1.ckpt`` when
  present, else fitted in f32 on the train set passed through the
  transforms before it (in chunks of ``fit_chunk`` images, as the JAX
  ``_fit_input``) and saved there at step 1, with the JAX key names
  (``save=False``, as serving asks, writes nothing). Test split: fittables
  are the train pipeline's instances.
- ``EpochSampler``: the per-epoch seeded global shuffle, padded by wrapping
  to whole batches (numpy, bit-identical to the JAX one).
- ``ResidentPipeline``: the uint8 train set lives on the device; each step
  feeds an (M, mb) int32 index array and the gather happens in the step.
  (The test set and its eval feeds wait for ROADMAP.md Queue 1 item 4.)
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from pytorch_ddp_resnet_tpu_torch.data.datasets import ArrayDataset
from pytorch_ddp_resnet_tpu_torch.data.transforms import (
    Transform,
    get_transform_cls,
)
from pytorch_ddp_resnet_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from pytorch_ddp_resnet_tpu_torch.utils.rng import Key


def _apply_prefix(transforms: Sequence[Transform],
                  x: torch.Tensor) -> torch.Tensor:
    """The upstream pipeline over a dataset array; a stochastic transform
    ahead of a fittable draws from a fixed key, so the fitted statistics
    stay deterministic (as the JAX ``_apply_prefix``)."""
    for i, t in enumerate(transforms):
        x = t.apply_batch(x, Key(0).fold_in(i) if t.stochastic else None)
    return x


def _fit_input(dataset: ArrayDataset, prefix: List[Transform], chunk: int,
               device: torch.device) -> torch.Tensor:
    """The train set through the upstream pipeline, chunked to bound
    memory."""
    n = len(dataset)
    return torch.cat([
        _apply_prefix(prefix, torch.from_numpy(
            dataset.x[start:start + chunk]).to(device))
        for start in range(0, n, chunk)])


def build_transforms(dataset: ArrayDataset,
                     data_aug: Optional[Dict[str, Dict[str, Any]]],
                     checkpoint_dir: str, is_train: bool,
                     reusable_transforms: Optional[
                         "OrderedDict[str, Transform]"] = None,
                     fit_chunk: int = 65536,
                     device: torch.device = torch.device("cpu"),
                     save: bool = True,
                     verbose: bool = False) -> "OrderedDict[str, Transform]":
    transforms: "OrderedDict[str, Transform]" = OrderedDict()
    data_shape = dataset.data_shape
    reusable = reusable_transforms or OrderedDict()
    for name, kwargs in (data_aug or {}).items():
        t = get_transform_cls(name)(data_shape, **(kwargs or {}))
        if t.fittable:
            if is_train:
                state, _ = load_checkpoint(checkpoint_dir, name.lower(), 1)
                if state is not None:
                    t.load_state_dict(state)
                    if verbose:
                        print(f"Loaded {name.lower()} from {checkpoint_dir}.")
                else:
                    if verbose:
                        print(f"Fitting {name} on the train set.")
                    t.fit(_fit_input(dataset, list(transforms.values()),
                                     fit_chunk, device))
                    if save:
                        save_checkpoint(checkpoint_dir, name.lower(),
                                        t.state_dict(), steps=1)
            else:
                if name not in reusable:
                    raise ValueError(
                        "Fittable test transform not in reusable_transforms.")
                t = reusable[name]
                if tuple(t.data_shape) != tuple(data_shape):
                    raise ValueError(
                        "Input shape mismatch on reusable transform.")
        transforms[name] = t
        data_shape = t.output_shape
    return transforms


class EpochSampler:
    """Per-epoch seeded global shuffle + padding to whole global batches
    (own copy of the JAX package's numpy sampler)."""

    def __init__(self, n: int, global_batch: int, num_microbatches: int = 1,
                 seed: int = 0):
        if global_batch % num_microbatches != 0:
            raise ValueError("batch_size must divide by num_microbatches.")
        if n < 1:
            raise ValueError("Empty dataset.")
        self.n = n
        self.global_batch = global_batch
        self.num_microbatches = num_microbatches
        self.seed = seed
        self.batches_per_epoch = -(-n // global_batch)  # ceil

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """(batches, M, mb) int32 index array for one epoch."""
        rng = np.random.default_rng([self.seed, int(epoch)])
        perm = rng.permutation(self.n)
        total = self.batches_per_epoch * self.global_batch
        if total > self.n:
            perm = np.resize(perm, total)  # wrap, like DistributedSampler
        mb = self.global_batch // self.num_microbatches
        return perm.reshape(
            self.batches_per_epoch, self.num_microbatches, mb
        ).astype(np.int32)


class ResidentPipeline:
    """A device-resident train set and index-driven train batches."""

    def __init__(self, dataset_train: ArrayDataset, device: torch.device,
                 batch_size: int, num_microbatches: int = 1,
                 shuffle_seed: int = 0):
        self.device = device
        self.train_x = torch.from_numpy(dataset_train.x).to(device)
        self.train_y = torch.from_numpy(
            dataset_train.y.astype(np.int64)).to(device)
        self.sampler_train = EpochSampler(
            len(dataset_train), batch_size, num_microbatches,
            seed=shuffle_seed)

    def bind_train_step(self, base_step, pass_indices: bool = False):
        """base_step(ts, x, y, lr, key) -> step(ts, idx, lr, key). With
        ``pass_indices`` the index array itself is ``x`` (the fused augment
        kernel gathers its own rows)."""
        data_x, data_y = self.train_x, self.train_y

        def resident_step(ts, idx, lr, key):
            x = idx if pass_indices else data_x[idx.long()]
            return base_step(ts, x, data_y[idx.long()], lr, key)

        return resident_step

    def train_feed(self, epoch: int, chunk: int = 1,
                   budget: Optional[int] = None):
        """Yields ``(n_steps, feed_tuple)``; with ``chunk > 1`` the feed
        carries a leading dim of up to ``chunk`` steps. ``budget`` caps the
        steps yielded."""
        all_idx = self.sampler_train.epoch_indices(epoch)
        if budget is not None:
            all_idx = all_idx[:budget]
        idx = torch.from_numpy(all_idx).to(self.device)
        if chunk <= 1:
            for i in range(len(idx)):
                yield 1, (idx[i],)
            return
        for start in range(0, len(idx), chunk):
            blk = idx[start:start + chunk]
            yield len(blk), (blk,)
