"""Layer modules in NHWC layout (counterpart of
pytorch_ddp_resnet_tpu/models/layers.py).

Activations are NHWC tensors at every module's surface, as in the JAX
package. A conv permutes its input to an NCHW *view* (channels-last
strides, no copy) for ``F.conv2d`` and permutes the result back.

Rounding follows the JAX layers: convs and the dense head take inputs and
weights in ``compute_dtype`` and accumulate in f32 (the library kernels
do so for bf16), the conv result is rounded to ``compute_dtype`` and a
bias is added in ``compute_dtype``; BatchNorm evaluates
``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32 and rounds to
``compute_dtype``; the dense head returns f32 logits.

Modules start in eval mode (the serving default); ``train()`` switches on
the training behaviour of the JAX layers' ``train=True``:

- BatchNorm normalizes with the batch statistics, taken in f32 as
  ``mean = E[x]`` and ``var = E[x^2] - mean^2`` (not torch's two-pass
  variance), with the biased variance and eps 1e-5, and updates its
  buffers in place: an EMA with momentum 0.1 of the mean and of the
  unbiased variance (factor n/(n-1)), and ``count += 1``;
- Dropout keeps an element iff its uint8 random bit is below
  ``thresh = round((1 - rate) * 256)`` and scales the kept values by
  ``1 / (thresh / 256)`` in the input's dtype.

Every ``forward`` takes an optional ``key`` (utils/rng.py ``Key``); a
``Sequential`` hands its i-th child ``key.fold_in(i)``, as the JAX
``Sequential`` folds its rng, so each dropout layer draws its own bits.

The lane protocol of the fused training paths (JAX ``Sequential.
_apply_loop``): in train mode a run of layers that take the channel-major
lane layout [C, B*H*W] passes it from one to the next without an NHWC
round trip. A layer joins a run through ``lane_eligible``/``apply_lane``
(a fused residual block), starts one from NHWC through
``lane_entry_eligible``/``apply_to_lane`` (the lane stem, a transition
block), carries it across a stage boundary through
``lane_through_eligible``/``apply_lane_through`` (a transition block under
``lane_transition``, lane in and lane out), and a nested ``Sequential``
whose first block takes the lane layout continues the run; any other
layer closes it back to NHWC. A layer
with ``lane_from_nhwc`` opens its run itself, and a payload with
``materialize`` closes itself (the int8 bottleneck trunk's ``NVLane``,
models/blocks.py); the lane layout is the other payload.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_ddp_resnet_tpu_torch.ops import initializers as init_lib
from pytorch_ddp_resnet_tpu_torch.ops.cuda.conv3x3 import (
    conv3x3_same,
    lanes_to_nhwc,
    nhwc_to_lanes,
)
from pytorch_ddp_resnet_tpu_torch.ops.cuda.stem import (
    CIN_MAX,
    stem_conv_lane,
    stem_lane_tile,
)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def to_lane(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """NHWC -> the lane layout [C, B*H*W] (image-major), in ``dtype``,
    contiguous (the kernels take dense rows)."""
    return nhwc_to_lanes(x.to(dtype))


def from_lane(x_cs: torch.Tensor, shape) -> torch.Tensor:
    """The lane layout back to NHWC of ``shape`` (b, h, w, c)."""
    return lanes_to_nhwc(x_cs, *shape[:3])


def _delane(payload, shape) -> torch.Tensor:
    """Close an open run back to NHWC (JAX ``_delane``)."""
    if hasattr(payload, "materialize"):
        return payload.materialize()
    return from_lane(payload, shape)


class Layer(nn.Module):
    """Base of the port's layers: eval mode from construction on."""

    def __init__(self):
        super().__init__()
        self.train(False)


class Conv(Layer):
    """2-D convolution, NHWC in and out, weight ``[Cout, Cin, K, K]``.
    ``pallas`` (the ``use_pallas_conv`` flag): a 3x3 stride-1 padding-1
    conv runs ``conv3x3_same`` (ops/cuda/conv3x3.py: the hand kernels for
    the forward and both gradients), in train and eval mode, as the JAX
    ``Conv`` runs its Pallas kernel; every other conv stays on
    ``F.conv2d``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, use_bias: bool = True,
                 kernel_init: str = "torch_default",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 pallas: bool = False, lane_stem: bool = False):
        super().__init__()
        self.pallas = pallas
        # set by the spec parser for the stem of a fused-trunk preact net:
        # in train mode the conv then emits the lane layout (ops/cuda/stem.py)
        self.lane_stem = lane_stem
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.use_bias = use_bias
        self.kernel_init = kernel_init
        self.compute_dtype = compute_dtype
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k))
        self.bias = (nn.Parameter(torch.empty(out_channels)) if use_bias
                     else None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        k = self.kernel_size
        fan_in = k * k * self.in_channels
        with torch.no_grad():
            if self.kernel_init == "kaiming_normal":
                w = init_lib.kaiming_normal(self.weight.shape, fan_in,
                                            generator)
            else:
                w = init_lib.torch_default_uniform(self.weight.shape, fan_in,
                                                   generator)
            self.weight.copy_(w)
            if self.bias is not None:
                self.bias.copy_(init_lib.torch_default_uniform(
                    self.bias.shape, fan_in, generator))

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        cd = self.compute_dtype
        if (self.pallas and self.kernel_size == 3 and self.stride == 1
                and self.padding == 1):
            y = conv3x3_same(x.to(cd), self.weight.to(cd))
        else:
            y = nchw_to_nhwc(F.conv2d(nhwc_to_nchw(x.to(cd)),
                                      self.weight.to(cd),
                                      stride=self.stride,
                                      padding=self.padding))
        if self.bias is not None:
            y = y + self.bias.to(cd)
        return y

    def lane_entry_eligible(self, x_shape, train: bool) -> bool:
        """Copy of the JAX gate: the lane stem in train mode, a 3x3 stride-1
        padding-1 conv with bias from at most 8 channels, whose geometry
        the JAX picker tiles."""
        if not (self.lane_stem and train and len(x_shape) == 4
                and self.kernel_size == 3 and self.stride == 1
                and self.padding == 1 and self.use_bias
                and self.in_channels <= CIN_MAX
                and self.out_channels % 16 == 0):
            return False
        b, h, w, _ = x_shape
        try:
            stem_lane_tile(h, w, b * h * w, self.out_channels)
        except ValueError:
            return False
        return True

    def apply_to_lane(self, x: torch.Tensor, key=None):
        """NHWC in, lane layout out: (y_cs, out_shape)."""
        b, h, w, _ = x.shape
        y_cs = stem_conv_lane(to_lane(x, self.compute_dtype), self.weight,
                              self.bias, h=h, w_img=w)
        return y_cs, (b, h, w, self.out_channels)


class BatchNorm(Layer):
    """BatchNorm over NHWC channels. Parameters ``scale`` and ``bias``;
    buffers ``mean``, ``var`` and ``count`` (the JAX state, one to one),
    updated in place in train mode."""

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.eps = eps
        self.compute_dtype = compute_dtype
        f = num_features
        self.scale = nn.Parameter(torch.ones(f))
        self.bias = nn.Parameter(torch.zeros(f))
        self.register_buffer("mean", torch.zeros(f))
        self.register_buffer("var", torch.ones(f))
        self.register_buffer("count", torch.zeros((), dtype=torch.int32))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)
            self.count.zero_()

    def eval_affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(inv, shift) with BN(x) = x * inv + shift."""
        inv = torch.rsqrt(self.var + self.eps) * self.scale
        return inv, self.bias - self.mean * inv

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        xf = x.to(torch.float32)
        if not self.training:
            inv = torch.rsqrt(self.var + self.eps) * self.scale
            return ((xf - self.mean) * inv + self.bias).to(self.compute_dtype)
        n = x.shape[0] * x.shape[1] * x.shape[2]
        mean = xf.mean(dim=(0, 1, 2))
        var = torch.square(xf).mean(dim=(0, 1, 2)) - torch.square(mean)
        inv = torch.rsqrt(var + self.eps) * self.scale
        y = ((xf - mean) * inv + self.bias).to(self.compute_dtype)
        with torch.no_grad():
            m = self.momentum
            unbiased = var * (n / max(n - 1, 1))
            self.mean.copy_((1 - m) * self.mean + m * mean)
            self.var.copy_((1 - m) * self.var + m * unbiased)
            self.count.add_(1)
        return y


class ReLU(Layer):
    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        return torch.clamp_min(x, 0)


class MaxPool(Layer):
    """MaxPool2d(K, S, P); padding contributes -inf."""

    def __init__(self, kernel_size: int, stride: int, padding: int = 0):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        y = F.max_pool2d(nhwc_to_nchw(x), self.kernel_size, self.stride,
                         self.padding)
        return nchw_to_nhwc(y)


class AvgPool(Layer):
    """AvgPool2d(K, S, P), padding counted (count_include_pad), summed in
    f32 and returned in the input dtype."""

    def __init__(self, kernel_size: int, stride: int, padding: int = 0):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        y = F.avg_pool2d(nhwc_to_nchw(x.to(torch.float32)), self.kernel_size,
                         self.stride, self.padding, count_include_pad=True)
        return nchw_to_nhwc(y).to(x.dtype)


class Dropout(Layer):
    """Inverted dropout on 8 random bits per element; the identity in eval.
    The bits come from ``key`` or are passed in as ``bits`` (uint8, the
    shape of x)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, key=None,
                bits: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        thresh = int(round((1.0 - self.rate) * 256.0))  # keep iff bits <
        if thresh <= 0:
            return torch.zeros_like(x)
        if thresh >= 256:
            return x
        if bits is None:
            if key is None:
                raise ValueError("Training with dropout requires a key.")
            bits = key.bits(x.shape, x.device)
        # thresh/256 has at most 8 significant bits, so it is exact in x's
        # dtype; a tensor divisor (not a Python float, which the card turns
        # into a reciprocal multiply) divides as the JAX x / keep_q does
        keep_q = torch.tensor(thresh / 256.0, dtype=x.dtype, device=x.device)
        return torch.where(bits < thresh, x / keep_q, torch.zeros_like(x))


class Dense(Layer):
    """Flatten (H, W, C order) + Linear; weight ``[out, in]``; f32
    logits."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        fan_in = self.in_features
        with torch.no_grad():
            self.weight.copy_(init_lib.torch_default_uniform(
                self.weight.shape, fan_in, generator))
            self.bias.copy_(init_lib.torch_default_uniform(
                self.bias.shape, fan_in, generator))

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        cd = self.compute_dtype
        xb = x.reshape(x.shape[0], -1).to(cd)
        y = F.linear(xb, self.weight.to(cd))
        return y.to(torch.float32) + self.bias.to(torch.float32)


class Sequential(Layer):
    """Ordered composite of named layers (the model spine and each residual
    stack). Names are the JAX pytree keys ('00_conv', 'block0', ...)."""

    def __init__(self, layers: Iterable[Tuple[str, nn.Module]]):
        super().__init__()
        for name, layer in layers:
            self.add_module(name, layer)

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        x, lane = self._apply_loop(x, None, key)
        return _delane(*lane) if lane is not None else x

    def _lane_accepts(self, x_shape, train: bool) -> bool:
        """True when this (nested) Sequential can start from the lane
        layout: its first layer is a lane-run block for ``x_shape``."""
        first = next(iter(self.children()), None)
        if first is None:
            return False
        if hasattr(first, "apply_lane") and first.lane_eligible(x_shape,
                                                                 train):
            return True
        # a stage whose first block is a lane-through transition also takes
        # the open run
        return (hasattr(first, "apply_lane_through")
                and first.lane_through_eligible(x_shape, train))

    def _apply_loop(self, x, lane, key):
        """Run the children; ``lane`` is an open run (x_cs, NHWC shape) or
        None. Returns (x, lane), the run still open when the last child
        left it open."""
        train = self.training
        for i, layer in enumerate(self.children()):
            k = None if key is None else key.fold_in(i)
            shape = lane[1] if lane is not None else tuple(x.shape)
            if (hasattr(layer, "apply_lane")
                    and layer.lane_eligible(shape, train)):
                if lane is None:
                    lane = ((layer.lane_from_nhwc(x)
                             if hasattr(layer, "lane_from_nhwc")
                             else to_lane(x, layer.compute_dtype)), shape)
                lane = (layer.apply_lane(lane[0], shape, key=k), shape)
            elif (hasattr(layer, "apply_lane_through") and lane is not None
                  and layer.lane_through_eligible(shape, train)):
                # a transition block on the open run: lane in, lane out
                lane = layer.apply_lane_through(lane[0], shape, key=k)
            elif (hasattr(layer, "apply_to_lane")
                  and layer.lane_entry_eligible(shape, train)):
                if lane is not None:
                    x, lane = _delane(*lane), None
                lane = layer.apply_to_lane(x, key=k)
            elif (isinstance(layer, Sequential) and lane is not None
                  and layer._lane_accepts(shape, train)):
                x, lane = layer._apply_loop(None, lane, k)
            else:
                if lane is not None:
                    x, lane = _delane(*lane), None
                x = layer(x, key=k)
        return x, lane
