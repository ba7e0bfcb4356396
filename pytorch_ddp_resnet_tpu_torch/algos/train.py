"""Learning-system setup on one device (counterpart of
pytorch_ddp_resnet_tpu/algos/train.py ``setup``).

``setup(config)`` builds, from a run config: the model, the train set,
the train and test transforms (fitting a fittable and saving it in the
run's checkpoint directory), the resident pipeline, the augmentation (the
fused kernel of ops/cuda/augment.py when ``use_pallas_augment`` is set and
the recipe matches, else the transform chain), the optimizer and
scheduler, and the train state. It returns the JAX ``setup``'s dict of
handles. A step then runs as

    ls = setup(config)
    step = ls["pipeline"].bind_train_step(
        make_train_step(ls["model"], ls["optimizer"],
                        ls["num_microbatches"], augment_fn=ls["augment_fn"]),
        pass_indices=ls["augment_pass_indices"])
    for n, (idx,) in ls["pipeline"].train_feed(epoch):
        ts, metrics = step(ls["train_state"], idx, lr,
                           Key(seed).fold_in(global_step))

Everything runs on the card unless ``device='cpu'`` is passed. Resuming
from a checkpoint, the training loop, evaluation and the CLI wait for
ROADMAP.md Queue 1 item 4; a run directory that holds a classifier
checkpoint raises rather than starting over.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from pytorch_ddp_resnet_tpu_torch.algos.steps import init_train_state
from pytorch_ddp_resnet_tpu_torch.data.datasets import get_dataset
from pytorch_ddp_resnet_tpu_torch.data.pipeline import (
    ResidentPipeline,
    build_transforms,
)
from pytorch_ddp_resnet_tpu_torch.data.transforms import make_batch_augment_fn
from pytorch_ddp_resnet_tpu_torch.models.resnet import ResNet
from pytorch_ddp_resnet_tpu_torch.ops.cuda.augment import try_from_transforms
from pytorch_ddp_resnet_tpu_torch.utils.checkpoint import latest_step
from pytorch_ddp_resnet_tpu_torch.utils.optim import (
    base_lr_of,
    get_optimizer,
    get_scheduler,
)
from pytorch_ddp_resnet_tpu_torch.utils.types import (
    DTYPES,
    Device,
    resolve_device,
)

_REQUIRED_KEYS = (
    "dataset_cls_name", "data_aug_train", "data_aug_test",
    "architecture_spec", "preact", "use_proj", "dropout_prob",
    "batch_size", "optimizer_cls_name", "optimizer_args",
    "checkpoint_strategy_cls_name",
)


def setup(config, device: Device = "cuda",
          verbose: bool = True) -> Dict[str, Any]:
    """Build the learning system from a run config. Keys of the result:
    mesh (None: one device), model, optimizer, scheduler,
    checkpoint_strategy (None until Queue 1 item 4), pipeline, augment_fn,
    preprocess_fn, train_state, global_step, num_microbatches,
    augment_pass_indices, and device."""
    dev = resolve_device(device)
    missing = [k for k in _REQUIRED_KEYS if config.get(k) is None
               and k not in ("data_aug_train", "data_aug_test")]
    if missing:
        raise ValueError(
            f"config.yaml is missing required keys: {missing} "
            f"(see models_dir/*/config.yaml for the schema).")
    checkpoint_dir = config.get("checkpoint_dir")
    if latest_step(checkpoint_dir, "classifier") is not None:
        raise NotImplementedError(
            f"{checkpoint_dir} holds a classifier checkpoint: resuming is "
            f"not ported yet (ROADMAP.md Queue 1 item 4)")
    if dev.type == "cuda":
        # the reference computes f32 convolutions and matmuls in full f32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    # first, so that a kernel-path flag the port lacks raises before any
    # data is built
    model = ResNet(
        architecture_spec=config.get("architecture_spec"),
        preact=config.get("preact"),
        use_proj=config.get("use_proj"),
        dropout_prob=config.get("dropout_prob"),
        compute_dtype=DTYPES[config.get("compute_dtype", "bfloat16")],
        generator=torch.Generator().manual_seed(config.get("seed", 0)),
        device=dev,
        remat=config.get("remat", False),
        pallas_conv=config.get("use_pallas_conv", False),
        fused_block=config.get("use_fused_block", False),
        int8_train=(config.get("use_int8_train", False)
                    or config.get("use_int8_train_bwd", False)),
        int8_train_bwd=config.get("use_int8_train_bwd", False),
        inkernel_dropout=config.get("use_inkernel_dropout", False),
        lane_transition=config.get("use_lane_transition", False))

    dataset_train = get_dataset(config.get("dataset_cls_name"),
                                config.get("data_dir"), train=True,
                                **(config.get("dataset_args") or {}))
    num_microbatches = config.get("num_microbatches", 1)
    transforms_train = build_transforms(
        dataset_train, config.get("data_aug_train"), checkpoint_dir,
        is_train=True, device=dev, verbose=verbose)
    transforms_test = build_transforms(
        dataset_train, config.get("data_aug_test"), checkpoint_dir,
        is_train=False, reusable_transforms=transforms_train, device=dev)
    augment_fn = make_batch_augment_fn(list(transforms_train.values()))
    preprocess_fn = make_batch_augment_fn(list(transforms_test.values()))
    pipeline = ResidentPipeline(
        dataset_train, dev, batch_size=config.get("batch_size"),
        num_microbatches=num_microbatches,
        shuffle_seed=config.get("shuffle_seed", 0))
    augment_pass_indices = False
    if config.get("use_pallas_augment", False):
        fused = try_from_transforms(transforms_train, pipeline.train_x, dev)
        if fused is not None:
            augment_fn = fused
            augment_pass_indices = True
        elif verbose:
            print("use_pallas_augment: pipeline doesn't match the fused "
                  "kernel pattern; using the transform chain.")

    optimizer = get_optimizer(config.get("optimizer_cls_name"),
                              config.get("optimizer_args"))
    scheduler = get_scheduler(
        config.get("scheduler_cls_name"), config.get("scheduler_args"),
        base_lr=base_lr_of(config.get("optimizer_args")))
    return {
        "mesh": None,
        "model": model,
        "optimizer": optimizer,
        "scheduler": scheduler,
        "checkpoint_strategy": None,
        "pipeline": pipeline,
        "augment_fn": augment_fn,
        "preprocess_fn": preprocess_fn,
        "train_state": init_train_state(model, optimizer),
        "global_step": 0,
        "num_microbatches": num_microbatches,
        "augment_pass_indices": augment_pass_indices,
        "device": dev,
    }
