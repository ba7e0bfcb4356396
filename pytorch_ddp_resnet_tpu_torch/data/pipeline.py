"""Test-time transform building (counterpart of the test split of
pytorch_ddp_resnet_tpu/data/pipeline.py ``build_transforms``).

The JAX package fits each fittable transform on the train set once and
checkpoints it as ``{name.lower()}_1.ckpt``; its test pipeline reuses the
fitted train instance. Here a fittable is loaded from that checkpoint
when present, else fitted in memory on the train set passed through the
transforms before it (the same input for every shipped recipe, whose
fittables follow ``ToTensorTransform`` only). Nothing is written.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from pytorch_ddp_resnet_tpu_torch.data.datasets import ArrayDataset
from pytorch_ddp_resnet_tpu_torch.data.transforms import (
    Transform,
    get_transform_cls,
)
from pytorch_ddp_resnet_tpu_torch.utils.checkpoint import load_checkpoint


def build_test_transforms(dataset_train: ArrayDataset,
                          data_aug: Optional[Dict[str, Dict[str, Any]]],
                          checkpoint_dir: str,
                          device: torch.device,
                          verbose: bool = False) -> List[Transform]:
    transforms: List[Transform] = []
    data_shape = dataset_train.data_shape
    for name, kwargs in (data_aug or {}).items():
        t = get_transform_cls(name)(data_shape, **(kwargs or {}))
        if t.fittable:
            state, _ = load_checkpoint(checkpoint_dir, name.lower(), 1)
            if state is not None:
                t.load_state_dict(state)
            else:
                if verbose:
                    print(f"No {name.lower()} checkpoint in {checkpoint_dir}:"
                          f" fitting {name} on the train set in memory.")
                x = torch.from_numpy(dataset_train.x).to(device)
                for prev in transforms:
                    x = prev.apply_batch(x)
                t.fit(x)
        transforms.append(t)
        data_shape = t.output_shape
    return transforms
