"""Residual blocks, eval forward (counterpart of pytorch_ddp_resnet_tpu/
models/blocks.py ``ResidualBlock``).

- ``preact=True``: ResNet-v2 ordering (norm -> relu -> dropout -> conv,
  identity add, no post-activation); ``preact=False``: v1 ordering
  (dropout -> conv -> norm -> relu, post-activation after the add).
- A shortcut-transforming block (stride != 1 or a channel change) uses a
  1x1 projection after a stride-s subsample (``use_proj``), or option A:
  the subsample plus zero-padded channels.
- The residual add is ``shortcut.to(main.dtype) + main``, as in JAX.

Bottleneck blocks (spec token ``b``) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from pytorch_ddp_resnet_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    Dropout,
    EvalOnly,
)

BOTTLENECK_TODO = ("bottleneck blocks are not ported yet (ROADMAP.md Queue "
                   "2, bottleneck int8 serving on bneck_nv)")


def subsample(x: torch.Tensor, stride: int) -> torch.Tensor:
    """AvgPool2d(kernel=1, stride=s) on NHWC: every s-th pixel (ceil
    semantics for odd extents); the identity at stride 1."""
    if stride == 1:
        return x
    return x[:, ::stride, ::stride, :]


def zero_pad_channels(x: torch.Tensor, extra: int) -> torch.Tensor:
    """Option-A shortcut: zeros appended on the NHWC channel dim."""
    return F.pad(x, (0, extra))


class ResidualBlock(EvalOnly):
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        i = x
        if self.preact:
            x = self.conv1(self.drop1(torch.clamp_min(self.norm1(x), 0)))
            x = self.conv2(self.drop2(torch.clamp_min(self.norm2(x), 0)))
        else:
            x = torch.clamp_min(self.norm1(self.conv1(self.drop1(x))), 0)
            x = self.norm2(self.conv2(self.drop2(x)))
        h = self.shortcut(i).to(x.dtype) + x
        if not self.preact:
            h = torch.clamp_min(h, 0)
        return h
