"""Inference-time BatchNorm folding (counterpart of pytorch_ddp_resnet_tpu/
models/fold.py).

In a post-activation (v1) network every BatchNorm directly follows a conv,
so its eval affine folds into the conv:

    BN(conv(x)) = (W * inv) x + [(b - mean) * inv + beta],
    inv = 1 / sqrt(var + eps) * gamma

The conv weight becomes ``W * inv`` (its bias zero) and the BatchNorm a
pure bias-add: ``scale=1, mean=0, var=1-eps`` and the folded constant in
``bias``. In a post-act block that is conv1/norm1, conv2/norm2 and, in a
bottleneck block, conv3/norm3. Pre-activation (v2) blocks put the BN
before the conv with a ReLU between and are skipped.
"""

from __future__ import annotations

import copy
from typing import Tuple

import torch
from torch import nn

from pytorch_ddp_resnet_tpu_torch.models.blocks import (
    BottleneckResidualBlock,
    ResidualBlock,
)
from pytorch_ddp_resnet_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    Sequential,
)


_BLOCK_PAIRS = (("conv1", "norm1"), ("conv2", "norm2"), ("conv3", "norm3"))


@torch.no_grad()
def _fold_pair(conv: Conv, bn: BatchNorm) -> None:
    inv = (1.0 / torch.sqrt(bn.var + bn.eps) * bn.scale).to(torch.float32)
    conv.weight.copy_(conv.weight.to(torch.float32)
                      * inv[:, None, None, None])
    shift = -bn.mean * inv + bn.bias
    if conv.bias is not None:
        shift = shift + conv.bias.to(torch.float32) * inv
        conv.bias.zero_()
    bn.scale.fill_(1.0)
    bn.bias.copy_(shift)
    bn.mean.zero_()
    bn.var.fill_(1.0 - bn.eps)


def fold_batchnorm(model: nn.Module) -> Tuple[nn.Module, int]:
    """Fold every eval-foldable conv->BN pair of a spec-built ResNet.
    Returns (folded copy of the model, number of folded pairs); the given
    model is untouched."""
    folded = copy.deepcopy(model)
    n = 0
    entries = list(folded.named_children())
    for i, (_, layer) in enumerate(entries):
        if isinstance(layer, Sequential):  # a residual stack
            for block in layer.children():
                if (not isinstance(block, (ResidualBlock,
                                           BottleneckResidualBlock))
                        or block.preact):
                    continue
                for cname, nname in _BLOCK_PAIRS:
                    if hasattr(block, cname):
                        _fold_pair(getattr(block, cname),
                                   getattr(block, nname))
                        n += 1
        elif isinstance(layer, BatchNorm) and i > 0:
            prev = entries[i - 1][1]
            if isinstance(prev, Conv):
                _fold_pair(prev, layer)
                n += 1
    return folded, n
