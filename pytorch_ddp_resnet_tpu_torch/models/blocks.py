"""Residual blocks, float forward in eval and train mode (counterpart of
pytorch_ddp_resnet_tpu/models/blocks.py ``ResidualBlock._forward``).

- ``preact=True``: ResNet-v2 ordering (norm -> relu -> dropout -> conv,
  identity add, no post-activation); ``preact=False``: v1 ordering
  (dropout -> conv -> norm -> relu, post-activation after the add).
- A shortcut-transforming block (stride != 1 or a channel change) uses a
  1x1 projection after a stride-s subsample (``use_proj``), or option A:
  the subsample plus zero-padded channels.
- The residual add is ``shortcut.to(main.dtype) + main``, as in JAX.

- In train mode sublayer i of the JAX ``_sublayers`` order (conv1, conv2,
  norm1, norm2, drop1, drop2, proj) draws from ``key.fold_in(i)``.

Bottleneck blocks (spec token ``b``) and the JAX package's kernel-path
flags of ``ResidualBlock`` (fused, int8 and lane paths, remat) are not
ported yet: ``check_unported_flags`` raises for each.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from pytorch_ddp_resnet_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    Dropout,
    Layer,
)

BOTTLENECK_TODO = ("bottleneck blocks are not ported yet (ROADMAP.md Queue "
                   "2, bottleneck int8 serving on bneck_nv)")

# config flag -> where ROADMAP.md schedules its port
_UNPORTED_FLAGS = {
    "int8_train": "slice 3, int8 FQT training",
    "int8_train_bwd": "slice 3, int8 FQT training",
    "fused_block": "Queue 2 item 7, a later slice",
    "inkernel_dropout": "Queue 2 item 7, a later slice",
    "lane_transition": "Queue 2 item 8, a later slice",
    "pallas_conv": "Queue 2 item 9, a later slice",
    "remat": "Queue 1 item 11, a later slice",
}


def check_unported_flags(**flags) -> None:
    """Raise for any set kernel-path flag of the JAX ``ResidualBlock``: the
    port runs the float layer path only and never ignores a flag."""
    for name, value in flags.items():
        if value:
            raise NotImplementedError(
                f"{name}=True is not ported yet (ROADMAP.md "
                f"{_UNPORTED_FLAGS[name]})")


def subsample(x: torch.Tensor, stride: int) -> torch.Tensor:
    """AvgPool2d(kernel=1, stride=s) on NHWC: every s-th pixel (ceil
    semantics for odd extents); the identity at stride 1."""
    if stride == 1:
        return x
    return x[:, ::stride, ::stride, :]


def zero_pad_channels(x: torch.Tensor, extra: int) -> torch.Tensor:
    """Option-A shortcut: zeros appended on the NHWC channel dim."""
    return F.pad(x, (0, extra))


class ResidualBlock(Layer):
    """Basic two-conv residual block. Children in the JAX sublayer order:
    conv1, conv2, norm1, norm2, drop1, drop2 (+ proj)."""

    def __init__(self, channels: int, downsample: bool, preact: bool,
                 use_proj: bool, dropout_prob: float,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 out_channels_override: Optional[int] = None,
                 stride_override: Optional[int] = None):
        super().__init__()
        self.channels = channels
        self.downsample = downsample
        self.preact = preact
        self.use_proj = use_proj
        self.dropout_prob = dropout_prob
        self.compute_dtype = compute_dtype
        self.out_channels_override = out_channels_override
        self.stride_override = stride_override
        cin, cout, cd = self.in_channels, self.out_channels, compute_dtype
        if self.transforms_shortcut and not use_proj and cout < cin:
            raise ValueError(
                f"Residual block maps {cin} -> {cout} channels with "
                f"use_proj=False: the option-A zero-pad shortcut cannot "
                f"SHRINK channels. Use use_proj=True.")
        self.conv1 = Conv(cin, cout, 3, stride=self.stride, padding=1,
                          use_bias=False, compute_dtype=cd)
        self.conv2 = Conv(cout, cout, 3, stride=1, padding=1, use_bias=False,
                          compute_dtype=cd)
        self.norm1 = BatchNorm(cin if preact else cout, compute_dtype=cd)
        self.norm2 = BatchNorm(cout, compute_dtype=cd)
        self.drop1 = Dropout(dropout_prob)
        self.drop2 = Dropout(dropout_prob)
        self.proj = (Conv(cin, cout, 1, use_bias=False, compute_dtype=cd)
                     if self.transforms_shortcut and use_proj else None)

    @property
    def in_channels(self) -> int:
        return self.channels

    @property
    def out_channels(self) -> int:
        if self.out_channels_override is not None:
            return self.out_channels_override
        return self.channels * 2 if self.downsample else self.channels

    @property
    def stride(self) -> int:
        if self.stride_override is not None:
            return self.stride_override
        return 2 if self.downsample else 1

    @property
    def transforms_shortcut(self) -> bool:
        return self.stride != 1 or self.out_channels != self.in_channels

    def shortcut(self, x: torch.Tensor) -> torch.Tensor:
        """The shortcut branch on the raw block input."""
        if not self.transforms_shortcut:
            return x
        i = subsample(x, self.stride)
        if self.proj is not None:
            return self.proj(i)
        return zero_pad_channels(i, self.out_channels - self.in_channels)

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        def sub(i):  # the JAX sublayer index: drop1 is 4, drop2 is 5
            return None if key is None else key.fold_in(i)

        i = x
        if self.preact:
            x = self.conv1(self.drop1(torch.clamp_min(self.norm1(x), 0),
                                      sub(4)))
            x = self.conv2(self.drop2(torch.clamp_min(self.norm2(x), 0),
                                      sub(5)))
        else:
            x = torch.clamp_min(self.norm1(self.conv1(self.drop1(x, sub(4)))),
                                0)
            x = self.norm2(self.conv2(self.drop2(x, sub(5))))
        h = self.shortcut(i).to(x.dtype) + x
        if not self.preact:
            h = torch.clamp_min(h, 0)
        return h
