"""Spec-string-driven residual networks (counterpart of
pytorch_ddp_resnet_tpu/models/resnet.py).

Space-separated components:
  cI,O,K,S,P   convolution          mpK,S,P   max pool
  apK,S,P      average pool         rD        stack of D basic blocks
  rD,O,S       D basic blocks, first one to O channels at stride S
  n            batch norm           a         ReLU
  fI,O         flatten + linear     bD        stack of D bottleneck blocks
  bD,O,W,S     D bottleneck blocks, first one to O channels at stride S,
               inner width W

Rules kept from the JAX package: the letter prefix is matched by
``[a-z]+`` (``fc64,10`` parses as ``f64,10``); a legacy ``rD`` or ``bD``
stack whose previous token is a stack of the same kind downsamples 2x and
doubles the channels in its first block; top-level convs get
kaiming-normal init, block convs torch's default.

``ResNet`` is a ``Sequential`` whose children carry the JAX pytree names
('00_conv', '01_stack' -> 'block0', ...), so its ``state_dict`` keys are
the JAX key paths joined with '.'. Activations are NHWC at its surface.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import torch
from torch import nn

from pytorch_ddp_resnet_tpu_torch.models.blocks import (
    BottleneckResidualBlock,
    ResidualBlock,
    check_unported_flags,
)
from pytorch_ddp_resnet_tpu_torch.models.layers import (
    AvgPool,
    BatchNorm,
    Conv,
    Dense,
    MaxPool,
    ReLU,
    Sequential,
)
from pytorch_ddp_resnet_tpu_torch.utils.types import Device, resolve_device

_COMPONENT_RE = re.compile(r"([a-z]+)((?:[0-9]+)(?:,[0-9]+)*)?$")


def extract_int_list(token: str, allowed_counts) -> Tuple[int, ...]:
    m = _COMPONENT_RE.match(token)
    if m is None or m.group(2) is None:
        raise ValueError(f"Cannot parse spec component {token!r}.")
    ints = tuple(int(v) for v in m.group(2).split(","))
    if len(ints) not in allowed_counts:
        raise ValueError(
            f"Spec component {token!r} carries {len(ints)} ints, expected one "
            f"of {sorted(allowed_counts)}.")
    return ints


def extract_ints(token: str, num: int):
    ints = extract_int_list(token, {num})
    return ints[0] if num == 1 else ints


def parse_spec(architecture_spec: str, preact: bool, use_proj: bool,
               dropout_prob: float,
               compute_dtype: torch.dtype = torch.bfloat16,
               int8_train: bool = False, int8_train_bwd: bool = False,
               fused_block: bool = False, inkernel_dropout: bool = False,
               lane_transition: bool = False, pallas_conv: bool = False,
               ) -> List[Tuple[str, nn.Module]]:
    """Token list -> [(name, layer)], threading the channel count."""
    tokens = architecture_spec.split()
    entries: List[Tuple[str, nn.Module]] = []
    channels: Optional[int] = None
    cd = compute_dtype

    def block_stack(kind: str, n: int, tok: str) -> Sequential:
        nonlocal channels
        cls = ResidualBlock if kind == "r" else BottleneckResidualBlock
        ints = extract_int_list(tok, {1, 3} if kind == "r" else {1, 4})
        cin = channels
        if len(ints) == 1:
            # legacy semantics: the adjacency downsampling rule
            depth = ints[0]
            downsample = n > 0 and tokens[n - 1].startswith(kind)
            cout = 2 * channels if downsample else channels
            first, rest = {}, {}
        else:
            # extended stage plan: explicit out-channels / width / stride
            if kind == "r":
                depth, cout, stride = ints
                rest = {}
            else:
                depth, cout, width, stride = ints
                rest = {"width_override": width}
            downsample = False
            rest.update(out_channels_override=cout, stride_override=1)
            first = {**rest, "stride_override": stride}
        blocks = []
        for ell in range(depth):
            blocks.append((f"block{ell}", cls(
                channels=cin if ell == 0 else cout,
                downsample=downsample if ell == 0 else False,
                preact=preact, use_proj=use_proj, dropout_prob=dropout_prob,
                compute_dtype=cd, int8_train=int8_train,
                int8_train_bwd=int8_train_bwd, fused_block=fused_block,
                inkernel_dropout=inkernel_dropout,
                lane_transition=lane_transition, pallas_conv=pallas_conv,
                **(first if ell == 0 else rest))))
        channels = cout
        return Sequential(blocks)

    for n, tok in enumerate(tokens):
        if tok.startswith("c"):
            i, o, k, s, p = extract_ints(tok, 5)
            # the fused trunk runs in the lane layout: an eligible stem
            # emits it directly (ops/cuda/stem.py)
            layer = Conv(i, o, k, stride=s, padding=p, use_bias=True,
                         kernel_init="kaiming_normal", compute_dtype=cd,
                         lane_stem=(preact and (int8_train or fused_block)
                                    and k == 3 and s == 1 and p == 1))
            channels = o
            name = f"{n:02d}_conv"
        elif tok.startswith("mp"):
            layer = MaxPool(*extract_ints(tok, 3))
            name = f"{n:02d}_maxpool"
        elif tok.startswith("ap"):
            layer = AvgPool(*extract_ints(tok, 3))
            name = f"{n:02d}_avgpool"
        elif tok.startswith(("r", "b")):
            layer = block_stack(tok[0], n, tok)
            name = f"{n:02d}_stack"
        elif tok.startswith("n"):
            layer = BatchNorm(channels, compute_dtype=cd)
            name = f"{n:02d}_bn"
        elif tok.startswith("a"):
            layer = ReLU()
            name = f"{n:02d}_relu"
        elif tok.startswith("f"):
            layer = Dense(*extract_ints(tok, 2), compute_dtype=cd)
            name = f"{n:02d}_fc"
        else:
            raise ValueError(f"Unknown component {tok!r} in architecture "
                             f"spec.")
        entries.append((name, layer))
    return entries


class ResNet(Sequential):
    """A residual network built from an architecture spec string, in eval
    mode until ``train()``. Weights are drawn from ``generator`` (a CPU
    ``torch.Generator``; ``None`` draws from torch's default one) and then
    moved to ``device`` (default the card: raises when there is none).

    ``forward(x, key)``: x NHWC, f32 logits. In train mode with dropout a
    ``Key`` is required (the JAX ``apply`` requires an rng); BatchNorm
    buffers update in place. The keyword flags are the JAX constructor's
    kernel-path switches (models/blocks.py), each taken by the blocks the
    JAX gates admit: ``fused_block`` trains the preact basic-block trunk on
    the fused bf16 halves; ``int8_train`` trains it on the fused int8
    halves, and the post-act bottleneck trunk's identity blocks on the NV
    training halves, both with the bf16 straight-through backward (QAT)
    or, with ``int8_train_bwd``, the fully quantized one;
    ``inkernel_dropout`` gives the fused halves a seed in place of
    materialized dropout bits; ``lane_transition`` runs the int8 trunk's
    stride-2 transitions lane in, lane out on the transition half.
    ``pallas_conv`` runs the blocks' stride-1 3x3 convs on the layer path
    through ``conv3x3_same`` (not the stem's, as in JAX). ``remat`` raises
    NotImplementedError."""

    def __init__(self, architecture_spec: str, preact: bool, use_proj: bool,
                 dropout_prob: float,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None,
                 device: Device = "cuda", *, remat: bool = False,
                 pallas_conv: bool = False, fused_block: bool = False,
                 int8_train: bool = False, int8_train_bwd: bool = False,
                 inkernel_dropout: bool = False,
                 lane_transition: bool = False):
        check_unported_flags(remat=remat)
        dev = resolve_device(device)
        super().__init__(parse_spec(architecture_spec, preact, use_proj,
                                    dropout_prob, compute_dtype,
                                    int8_train=int8_train,
                                    int8_train_bwd=int8_train_bwd,
                                    fused_block=fused_block,
                                    inkernel_dropout=inkernel_dropout,
                                    lane_transition=lane_transition,
                                    pallas_conv=pallas_conv))
        self.architecture_spec = architecture_spec
        self.preact = preact
        self.use_proj = use_proj
        self.dropout_prob = dropout_prob
        self.compute_dtype = compute_dtype
        self.int8_train = int8_train
        self.int8_train_bwd = int8_train_bwd
        self.fused_block = fused_block
        self.inkernel_dropout = inkernel_dropout
        self.lane_transition = lane_transition
        self.pallas_conv = pallas_conv
        self.reset_parameters(generator)
        self.to(dev)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Draw every layer's weights in module order."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        if self.training and self.dropout_prob > 0.0 and key is None:
            raise ValueError("Training with dropout requires a key.")
        return super().forward(x, key)

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())
