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

The fused lane path (the JAX config flags ``use_fused_block``,
``use_int8_train`` and ``use_int8_train_bwd``): in train mode a preact
block whose shapes pass the JAX gates runs in the channel-major lane layout
[C, B*H*W], one fused half per conv (ops/cuda/fused_block.py):

- ``fused_block`` alone: ``fused_half``, the bf16 conv core, on identity
  blocks above the JAX crossover ``h*w >= 2c`` (stage 1 of WRN-28-10);
- ``int8_train``: ``fused_half_int8``, the int8 conv core, with its
  backward fully quantized under ``int8_train_bwd`` (FQT) and the bf16
  straight-through backward without it (QAT); no crossover, and the
  stage-transition blocks take it for their conv2.

The halves are wired as in JAX:

- an identity block (``lane_eligible``/``apply_lane``): norm1 from the sums
  of its input, conv1's half emitting norm2's sums, conv2's half adding
  the residual;
- a stage-transition block (``lane_entry_eligible``/``apply_to_lane``,
  int8 only): norm1/drop1/conv1/proj on the layer path, conv2's half at
  the output geometry with the shortcut as its residual, emitting the lane
  layout.

- with ``lane_transition`` (int8 only), a stride-2 transition block that
  an open lane run reaches (``lane_through_eligible``/
  ``apply_lane_through``): norm1 from the sums of its lane input, the
  transition half (ops/cuda/transition.py: prologue, int8 stride-2 conv1,
  the projection or option-A shortcut, norm2's sums), then conv2's half
  with that shortcut as its residual; lane in and lane out, so the run
  stays open across the stage boundary.

BatchNorm's batch statistics fold into the halves' (scale, shift) and its
buffers update in place exactly as the layer does (``_fold_bn_batch_and_
ema``). The dropout bits of a half are drawn over the lane shape (C, N),
or, under ``inkernel_dropout`` where C <= 320 and C*N < 2^31, replaced by
one int32 seed from which the kernels rebuild the mask in registers; the
transition half's are always drawn, over the parity-packed shape
(4*Cin, N/4). ``models/layers.py`` ``Sequential`` threads the lane layout
from block to block.

``pallas_conv`` (both block types, as in JAX): the block's stride-1 3x3
convs on the layer path run ``conv3x3_same`` (``Conv(pallas=True)``); the
lane and fused paths above take precedence where their gates admit the
block. Remat is not ported yet: ``check_unported_flags`` raises for it.

``BottleneckResidualBlock`` (spec token ``b``, JAX ``blocks.py:816-940``):
1x1 -> 3x3 (at the block's stride) -> 1x1 in either ordering, the float
forward in eval and train mode. Its int8 serving path lives in
models/quantize.py (the NV kernels). Its int8 training (JAX ``NVLane``,
``blocks.py:944-1039``): in train mode a post-act identity block whose
geometry passes the JAX gate runs its three convs on
``nv_half_1x1``/``nv_half_3x3`` (ops/cuda/bneck_nv_train.py) with the
int8 forward and, under ``int8_train_bwd``, the fully quantized backward
(FQT), else the bf16 straight-through one (QAT), BatchNorm folded from
each half's sums. ``Sequential`` carries an ``NVLane`` from
block to block (as in JAX, only ``Sequential`` takes the NV path; the
block's own ``forward`` is the float one): each block leaves its conv3
epilogue (BN3 affine, residual add, relu) pending, and the next block's
conv1 applies it in its entry prologue, or ``materialize`` applies it
where the run closes. Every other bottleneck block (preact, a transition,
a batch the gate refuses) trains on the float layer path, as in JAX;
``fused_block``,
``inkernel_dropout`` and ``lane_transition`` are basic-trunk features it
accepts and ignores, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from pytorch_ddp_resnet_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    Dropout,
    Layer,
    from_lane,
    to_lane,
)
from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv_train as nvt
from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
from pytorch_ddp_resnet_tpu_torch.ops.cuda import transition as tr
from pytorch_ddp_resnet_tpu_torch.ops.cuda.conv3x3 import pick_tile
from pytorch_ddp_resnet_tpu_torch.ops.cuda.nv_common import fma_f32

# config flag -> where ROADMAP.md schedules its port
_UNPORTED_FLAGS = {
    "remat": "Queue 1 item 11, a later slice",
}


def check_unported_flags(**flags) -> None:
    """Raise for any set kernel-path flag of the JAX ``ResidualBlock`` that
    the port lacks (``_UNPORTED_FLAGS``): it never ignores a flag."""
    for name, value in flags.items():
        if value and name in _UNPORTED_FLAGS:
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


# the JAX sublayer order: sublayer i draws from key.fold_in(i)
_SUB = {"conv1": 0, "conv2": 1, "norm1": 2, "norm2": 3, "drop1": 4,
        "drop2": 5, "proj": 6}


def _fold_bn_batch_and_ema(bn: BatchNorm, mean, var, n: int):
    """Fold batch statistics into the (scale, shift) of a fused half
    (differentiable) and update the BatchNorm's buffers in place as the
    JAX helper of the same name does: biased variance to normalize, an EMA
    of the mean and of the unbiased variance, count + 1."""
    scale, shift = fb.fold_bn(bn.scale, bn.bias, mean, var, bn.eps)
    with torch.no_grad():
        m = bn.momentum
        bn.mean.copy_((1 - m) * bn.mean + m * mean)
        bn.var.copy_((1 - m) * bn.var + m * var * (n / max(n - 1, 1)))
        bn.count.add_(1)
    return scale, shift


class NVLane(NamedTuple):
    """An open NV run (Sequential's lane payload for int8 bottleneck
    training; JAX ``NVLane``). ``x``: the current block input, the
    materialized residual carrier, NHWC bf16. ``acc3``/``s3``/``t3``: the
    previous block's raw conv3 output and folded BN3 affine, whose epilogue
    is still pending (None at a run's start)."""

    x: torch.Tensor
    acc3: Optional[torch.Tensor] = None
    s3: Optional[torch.Tensor] = None
    t3: Optional[torch.Tensor] = None

    def materialize(self) -> torch.Tensor:
        """Close the run: relu(acc3*s3 + t3 + x) in bf16, NHWC. ``acc3*s3 +
        t3`` is one fused multiply-add, as the reference computes it under
        jit."""
        if self.acc3 is None:
            return self.x
        y = fma_f32(self.acc3, self.s3, self.t3)
        return torch.clamp_min(y + self.x.to(torch.float32),
                               0.0).to(self.x.dtype)


class _BlockBase(Layer):
    """Geometry and shortcut shared by both block types (the JAX dataclass
    fields of the same names)."""

    channels: int
    downsample: bool
    use_proj: bool
    out_channels_override: Optional[int]
    stride_override: Optional[int]

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

    def _check_shortcut(self, kind: str, hint: str) -> None:
        if (self.transforms_shortcut and not self.use_proj
                and self.out_channels < self.in_channels):
            raise ValueError(
                f"{kind} block maps {self.in_channels} -> "
                f"{self.out_channels} channels with use_proj=False: the "
                f"option-A zero-pad shortcut cannot SHRINK channels. "
                f"{hint}")

    def shortcut(self, x: torch.Tensor) -> torch.Tensor:
        """The shortcut branch on the raw block input."""
        if not self.transforms_shortcut:
            return x
        i = subsample(x, self.stride)
        if self.proj is not None:
            return self.proj(i)
        return zero_pad_channels(i, self.out_channels - self.in_channels)


class ResidualBlock(_BlockBase):
    """Basic two-conv residual block. Children in the JAX sublayer order:
    conv1, conv2, norm1, norm2, drop1, drop2 (+ proj)."""

    def __init__(self, channels: int, downsample: bool, preact: bool,
                 use_proj: bool, dropout_prob: float,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 out_channels_override: Optional[int] = None,
                 stride_override: Optional[int] = None,
                 int8_train: bool = False, int8_train_bwd: bool = False,
                 fused_block: bool = False, inkernel_dropout: bool = False,
                 lane_transition: bool = False, pallas_conv: bool = False):
        super().__init__()
        self.pallas_conv = pallas_conv
        self.int8_train = int8_train
        self.int8_train_bwd = int8_train_bwd
        self.fused_block = fused_block
        self.inkernel_dropout = inkernel_dropout
        self.lane_transition = lane_transition
        self.channels = channels
        self.downsample = downsample
        self.preact = preact
        self.use_proj = use_proj
        self.dropout_prob = dropout_prob
        self.compute_dtype = compute_dtype
        self.out_channels_override = out_channels_override
        self.stride_override = stride_override
        cin, cout, cd = self.in_channels, self.out_channels, compute_dtype
        self._check_shortcut("Residual", "Use use_proj=True.")
        self.conv1 = Conv(cin, cout, 3, stride=self.stride, padding=1,
                          use_bias=False, compute_dtype=cd,
                          pallas=pallas_conv)
        self.conv2 = Conv(cout, cout, 3, stride=1, padding=1, use_bias=False,
                          compute_dtype=cd, pallas=pallas_conv)
        self.norm1 = BatchNorm(cin if preact else cout, compute_dtype=cd)
        self.norm2 = BatchNorm(cout, compute_dtype=cd)
        self.drop1 = Dropout(dropout_prob)
        self.drop2 = Dropout(dropout_prob)
        self.proj = (Conv(cin, cout, 1, use_bias=False, compute_dtype=cd)
                     if self.transforms_shortcut and use_proj else None)

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        shape = tuple(x.shape)
        if self.lane_eligible(shape, self.training):
            y_cs = self._forward_lane(to_lane(x, self.compute_dtype), shape,
                                      key)
            return from_lane(y_cs, shape)
        if self.lane_entry_eligible(shape, self.training):
            return from_lane(*self._transition_lane(x, key))

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

    # --- the fused lane path -----------------------------------------------

    def _fused_eligible(self, x_shape, train: bool) -> bool:
        """Copy of the JAX gate: a train-mode preact identity block whose
        shapes the JAX kernel tiles (channels % 32 with dropout bits or the
        int8 core, else % 16; whole images per 128-multiple lane tile);
        the bf16 core only above the crossover h*w >= 2c."""
        if not ((self.fused_block or self.int8_train) and self.preact
                and train and not self.transforms_shortcut):
            return False
        thresh = fb.dropout_thresh(self.dropout_prob)
        if thresh <= 0:
            return False
        b, h, w, c = x_shape
        if c % (32 if (thresh < 256 or self.int8_train) else 16) != 0:
            return False
        if not self.int8_train and h * w < 2 * c:
            return False
        try:
            pick_tile(h * w, b * h * w, c)
        except ValueError:
            return False
        return True

    def lane_eligible(self, x_shape, train: bool) -> bool:
        """Sequential's lane protocol: True when this block runs in the
        lane layout for ``x_shape``."""
        return len(x_shape) == 4 and self._fused_eligible(x_shape, train)

    def apply_lane(self, x_cs: torch.Tensor, x_shape, key=None):
        """The block on an activation already in the lane layout."""
        return self._forward_lane(x_cs, x_shape, key)

    def lane_entry_eligible(self, x_shape, train: bool) -> bool:
        """Copy of the JAX gate: a train-mode preact stage-transition block
        whose conv2 the int8 half takes at the output geometry; it consumes
        NHWC and emits the lane layout."""
        if not (self.int8_train and self.preact and train
                and self.transforms_shortcut):
            return False
        if fb.dropout_thresh(self.dropout_prob) <= 0 or len(x_shape) != 4:
            return False
        b, h, w, _ = x_shape
        s, cout = self.stride, self.out_channels
        oh, ow = (h - 1) // s + 1, (w - 1) // s + 1
        if cout % 32 != 0:
            return False
        try:
            pick_tile(oh * ow, b * oh * ow, cout)
        except ValueError:
            return False
        return True

    def apply_to_lane(self, x: torch.Tensor, key=None):
        """Transition block, NHWC in, lane out: (y_cs, out_shape)."""
        return self._transition_lane(x, key)

    def _transition_lane(self, x: torch.Tensor, key):
        def sub(name):
            return None if key is None else key.fold_in(_SUB[name])

        z = self.conv1(self.drop1(torch.clamp_min(self.norm1(x), 0),
                                  sub("drop1")))
        b, oh, ow, cout = z.shape
        n = b * oh * ow
        # norm2's batch statistics from conv1's output
        zf = z.to(torch.float32)
        mean = zf.mean(dim=(0, 1, 2))
        var = torch.square(zf).mean(dim=(0, 1, 2)) - torch.square(mean)
        s2, t2 = _fold_bn_batch_and_ema(self.norm2, mean, var, n)
        cd = self.compute_dtype
        y_cs, _, _ = self._run_half(
            to_lane(z, cd), self.conv2.weight, s2, t2, self._drop_key(
                sub("drop2")), to_lane(self.shortcut(x), cd), False, oh, ow,
            cout)
        return y_cs, (b, oh, ow, cout)

    def lane_through_eligible(self, x_shape, train: bool) -> bool:
        """Copy of the JAX gate: a train-mode preact stride-2 transition
        block under ``lane_transition`` and ``int8_train``, a dropout rate
        below 1, even H and W, Cout and 4*Cin multiples of 32, option A
        only where it widens, and both the transition's and conv2's tile
        pickers passing (one device: the whole batch is local)."""
        if not (self.lane_transition and self.int8_train and self.preact
                and train and self.transforms_shortcut
                and self.stride == 2):
            return False
        if fb.dropout_thresh(self.dropout_prob) <= 0 or len(x_shape) != 4:
            return False
        b, h, w, cin = x_shape
        if h % 2 or w % 2 or cin != self.in_channels:
            return False
        cout = self.out_channels
        if cout % 32 != 0 or (4 * cin) % 32 != 0:
            return False
        if not self.use_proj and cout < cin:
            return False
        oh, ow = h // 2, w // 2
        try:
            tr.transition_tile(oh, ow, b * oh * ow, cin, cout)
            pick_tile(oh * ow, b * oh * ow, cout)  # conv2's tiling
        except ValueError:
            return False
        return True

    def apply_lane_through(self, x_cs: torch.Tensor, x_shape, key=None):
        """Transition block, lane in and lane out: (y_cs, out_shape). norm1
        from the f32 sums of the lane input, the transition half (conv1,
        the shortcut and norm2's sums), norm2 folded from those sums, and
        conv2's int8 half with the shortcut as its residual."""
        b, h, w, cin = x_shape
        oh, ow, cout = h // 2, w // 2, self.out_channels
        n_in, n_out = b * h * w, b * oh * ow

        def fold_and_ema(bn, ssum, sssq, n):
            mean = ssum / n
            var = sssq / n - torch.square(mean)
            return _fold_bn_batch_and_ema(bn, mean, var, n)

        def drop_key(name):
            return self._drop_key(None if key is None
                                  else key.fold_in(_SUB[name]))

        xf = x_cs.to(torch.float32)
        s1, t1 = fold_and_ema(self.norm1, xf.sum(dim=1),
                              torch.square(xf).sum(dim=1), n_in)
        key1 = drop_key("drop1")
        # the reference's draw shape: the parity-packed layout
        bits = (key1.bits((4 * cin, n_in // 4), x_cs.device)
                if key1 is not None else None)
        z_cs, zsum, zssq, res_cs = tr.transition_half_int8(
            x_cs, self.conv1.weight,
            self.proj.weight if self.proj is not None else None, s1, t1,
            bits, dropout_rate=self.dropout_prob, h=h, w_img=w,
            quant_bwd=self.int8_train_bwd)
        s2, t2 = fold_and_ema(self.norm2, zsum, zssq, n_out)
        y_cs, _, _ = self._run_half(z_cs, self.conv2.weight, s2, t2,
                                    drop_key("drop2"), res_cs, False, oh, ow,
                                    cout)
        return y_cs, (b, oh, ow, cout)

    def _drop_key(self, key):
        """The half's dropout key, or None when the rate keeps every
        element."""
        if fb.dropout_thresh(self.dropout_prob) >= 256:
            return None
        if key is None:
            raise ValueError("Training with dropout requires a key.")
        return key

    def _forward_lane(self, x_cs: torch.Tensor, x_shape, key):
        """The preact chain, both halves fused: norm1 from the sums of the
        input, conv1's half emitting norm2's sums, conv2's half adding the
        residual. Returns y [C, N]."""
        b, h, w, c = x_shape
        n = b * h * w

        def fold_and_ema(bn, ssum, sssq):
            mean = ssum / n
            var = sssq / n - torch.square(mean)
            return _fold_bn_batch_and_ema(bn, mean, var, n)

        def drop_key(name):
            return self._drop_key(None if key is None
                                  else key.fold_in(_SUB[name]))

        x_cs = x_cs.to(self.compute_dtype)
        xf = x_cs.to(torch.float32)
        s1, t1 = fold_and_ema(self.norm1, xf.sum(dim=1),
                              torch.square(xf).sum(dim=1))
        z_cs, zsum, zssq = self._run_half(
            x_cs, self.conv1.weight, s1, t1, drop_key("drop1"), None, True,
            h, w, c)
        s2, t2 = fold_and_ema(self.norm2, zsum, zssq)
        y_cs, _, _ = self._run_half(
            z_cs, self.conv2.weight, s2, t2, drop_key("drop2"), x_cs, False,
            h, w, c)
        return y_cs

    def _dropout_bits(self, key, c: int, n: int, device) -> torch.Tensor:
        """A half's dropout bits: uint8 [c, n] over the lane shape, or, with
        ``inkernel_dropout`` where c <= 320 and c * n < 2^31 (the JAX
        rule), a 0-d int32 seed that the kernels expand in registers."""
        if (self.inkernel_dropout and c <= 320
                and c * n < fb.SEED_INDEX_LIMIT):
            return key.dropout_seed(device)
        return key.bits((c, n), device)

    def _run_half(self, x_in, w_conv, s, t, key, res, want_stats: bool,
                  h: int, w: int, c: int):
        """One fused half: the int8 core under ``int8_train`` (FQT or QAT
        backward), else the bf16 core."""
        bits = (self._dropout_bits(key, c, x_in.shape[1], x_in.device)
                if key is not None else None)
        kw = dict(dropout_rate=self.dropout_prob, h=h, w_img=w,
                  want_stats=want_stats)
        if self.int8_train:
            return fb.fused_half_int8(x_in, w_conv, s, t, bits, res,
                                      quant_bwd=self.int8_train_bwd, **kw)
        return fb.fused_half(x_in, w_conv, s, t, bits, res, **kw)


# the JAX sublayer order of the bottleneck block
_BSUB = {"conv1": 0, "conv2": 1, "conv3": 2, "norm1": 3, "norm2": 4,
         "norm3": 5, "drop1": 6, "drop2": 7, "drop3": 8, "proj": 9}


class BottleneckResidualBlock(_BlockBase):
    """Bottleneck residual block (JAX ``BottleneckResidualBlock``). Children
    in the JAX sublayer order: conv1 (1x1), conv2 (3x3 at the block's
    stride, padding 1), conv3 (1x1), norm1-3, drop1-3 (+ proj). The inner
    width is ``width_override``, else ``channels // 4``, or ``// 2`` when
    downsampling."""

    def __init__(self, channels: int, downsample: bool, preact: bool,
                 use_proj: bool, dropout_prob: float,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 out_channels_override: Optional[int] = None,
                 width_override: Optional[int] = None,
                 stride_override: Optional[int] = None,
                 int8_train: bool = False, int8_train_bwd: bool = False,
                 fused_block: bool = False, inkernel_dropout: bool = False,
                 lane_transition: bool = False, pallas_conv: bool = False):
        super().__init__()
        self.pallas_conv = pallas_conv
        # basic-trunk features, as in JAX
        del fused_block, inkernel_dropout, lane_transition
        self.int8_train = int8_train
        self.int8_train_bwd = int8_train_bwd
        self.channels = channels
        self.downsample = downsample
        self.preact = preact
        self.use_proj = use_proj
        self.dropout_prob = dropout_prob
        self.compute_dtype = compute_dtype
        self.out_channels_override = out_channels_override
        self.width_override = width_override
        self.stride_override = stride_override
        self._check_shortcut("Bottleneck", "Use use_proj=True for "
                             "channel-reducing stack tokens.")
        cin, cb, cout, cd = (self.in_channels, self.bottleneck_channels,
                             self.out_channels, compute_dtype)
        self.conv1 = Conv(cin, cb, 1, use_bias=False, compute_dtype=cd)
        self.conv2 = Conv(cb, cb, 3, stride=self.stride, padding=1,
                          use_bias=False, compute_dtype=cd,
                          pallas=pallas_conv)
        self.conv3 = Conv(cb, cout, 1, use_bias=False, compute_dtype=cd)
        self.norm1 = BatchNorm(cin if preact else cb, compute_dtype=cd)
        self.norm2 = BatchNorm(cb, compute_dtype=cd)
        self.norm3 = BatchNorm(cb if preact else cout, compute_dtype=cd)
        self.drop1 = Dropout(dropout_prob)
        self.drop2 = Dropout(dropout_prob)
        self.drop3 = Dropout(dropout_prob)
        self.proj = (Conv(cin, cout, 1, use_bias=False, compute_dtype=cd)
                     if self.transforms_shortcut and use_proj else None)

    @property
    def bottleneck_channels(self) -> int:
        if self.width_override is not None:
            return self.width_override
        return self.channels // 2 if self.downsample else self.channels // 4

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        def sub(name):  # drop1-3 draw from key.fold_in(6, 7, 8)
            return None if key is None else key.fold_in(_BSUB[name])

        def relu(t):
            return torch.clamp_min(t, 0)

        i = x
        if self.preact:
            x = self.conv1(self.drop1(relu(self.norm1(x)), sub("drop1")))
            x = self.conv2(self.drop2(relu(self.norm2(x)), sub("drop2")))
            x = self.conv3(self.drop3(relu(self.norm3(x)), sub("drop3")))
        else:
            x = relu(self.norm1(self.conv1(self.drop1(x, sub("drop1")))))
            x = relu(self.norm2(self.conv2(self.drop2(x, sub("drop2")))))
            x = self.norm3(self.conv3(self.drop3(x, sub("drop3"))))
        h = self.shortcut(i).to(x.dtype) + x
        return h if self.preact else relu(h)

    # --- the NV int8 training path (Sequential's lane protocol) -------------

    def lane_eligible(self, x_shape, train: bool) -> bool:
        """Copy of the JAX gate: a train-mode post-act identity block at
        stride 1 under ``int8_train``, no dropout, bf16, a batch that is a
        power of two and a multiple of 32, channels and width multiples of
        8, and a geometry every half's row-chunk picker admits."""
        if not (self.int8_train and train and not self.preact):
            return False
        if self.transforms_shortcut or self.stride != 1:
            return False
        if self.dropout_prob != 0.0 or self.compute_dtype != torch.bfloat16:
            return False
        if len(x_shape) != 4:
            return False
        b, h, w, c = x_shape
        if c != self.in_channels:
            return False
        if b < 32 or b % 32 or b & (b - 1):
            return False
        if c % 8 or self.bottleneck_channels % 8:
            return False
        return nvt.nv_train_fits(h, w, b, c, self.bottleneck_channels,
                                 self.out_channels)

    def lane_from_nhwc(self, x: torch.Tensor) -> NVLane:
        """Open an NV run from a materialized NHWC activation."""
        return NVLane(x.to(self.compute_dtype).contiguous())

    def apply_lane(self, nv: NVLane, x_shape, key=None) -> NVLane:
        """One identity block on the NV run: three halves on the int8
        forward (and the FQT or QAT backward, as ``int8_train_bwd`` says)
        and the BatchNorm vector math; its own conv3 epilogue is left
        pending in the returned NVLane (no dropout on this path: gated)."""
        del key
        b, h, w, _ = x_shape
        cnt = b * h * w
        kw = dict(w_img=w, quant=True, quant_bwd=self.int8_train_bwd)

        def bn_fold(bn, zsum, zssq):
            mean = zsum / cnt
            var = zssq / cnt - torch.square(mean)
            return _fold_bn_batch_and_ema(bn, mean, var, cnt)

        if nv.acc3 is None:
            y1, z1s, z1q = nvt.nv_half_1x1(nv.x, self.conv1.weight,
                                           mode="identity", **kw)
            x_mat = nv.x
        else:
            y1, z1s, z1q, x_mat = nvt.nv_half_1x1(
                nv.acc3, self.conv1.weight, nv.s3, nv.t3, res=nv.x,
                mode="entry", **kw)
        s1, t1 = bn_fold(self.norm1, z1s, z1q)
        y2, z2s, z2q = nvt.nv_half_3x3(y1, self.conv2.weight, s1, t1,
                                       mode="affine", **kw)
        s2, t2 = bn_fold(self.norm2, z2s, z2q)
        y3, z3s, z3q = nvt.nv_half_1x1(y2, self.conv3.weight, s2, t2,
                                       mode="affine", **kw)
        s3, t3 = bn_fold(self.norm3, z3s, z3q)
        return NVLane(x_mat, y3, s3, t3)
