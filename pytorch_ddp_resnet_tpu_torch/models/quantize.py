"""Post-training int8 quantization for serving, w8a8 with per-channel
weights (counterpart of pytorch_ddp_resnet_tpu/models/quantize.py).

Scheme:
- **Weights**: per-output-channel symmetric int8, scale = absmax/127.
- **Activations**: per-tensor symmetric int8, scale = absmax/127 of each
  quantized conv's input over a few calibration batches run through the
  float path; the observers sit in the same walk as the int8 path, so
  calibration and serving agree on where a conv's input is measured.
- **Compute, basic blocks**: eligible 3x3 stride-1 SAME convs run s8 x s8
  -> s32 on the ``conv3x3_int8_requant`` kernel with the BN affines, ReLU,
  residual and the next conv's quantization fused into its epilogue; the
  calibration pass runs them on ``conv3x3_bf16`` (ops/cuda/conv3x3.py).
  Consecutive eligible blocks carry activations as [C, B*H*W] between
  kernels, converting from NHWC once per run.
- **Compute, bottleneck blocks** (``fused_bneck``):
  - ``"nv"``: post-act identity and projection-transition blocks run on
    the NV kernels (ops/cuda/bneck_nv.py), each a whole block with its
    folded requant vectors (ops/cuda/nv_common.py). A run of them keeps
    an int8 NHWC carrier from block to block: one entry quantization
    (``quantize_to_nv``), int8 between blocks, a bf16 exit when the next
    item is not an NV block. Calibration records the three conv inputs
    of identity blocks in ``_bneck_nhwc``'s float mode and of transitions
    in ``_bneck_trans_float``.
  - ``False`` (and, under either setting, every other identity bottleneck
    above the JAX crossover N >= 32*Cin, preact ones included):
    ``_bneck_nhwc`` runs both 1x1s as exact s8 x s8 -> s32 library
    products (``torch._int_mm`` on the card, float64 on the CPU; JAX
    leaves this dot to XLA) and the 3x3 in bf16.
- Everything else (input conv, stride-2 conv1 of basic transitions, 1x1
  projections of non-NV blocks, the head) runs the model's own float
  modules.

Eligibility is the JAX package's, including its TPU tile rule
(``pick_tile``) and the NV gates' pow2 / multiple-of-32 batch rule, so
both packages quantize the same convs: identity-shortcut basic blocks
quantize both 3x3s, shortcut-transforming ones their conv2 (with the
transformed shortcut in the epilogue). For WRN-28-10 that is 22 of the
24 trunk convs; for ResNet-50 at batch 128 every trunk conv but the four
projections' (which ride the transition kernels, as in JAX).

Arithmetic follows the JAX package: scales are Python floats rounded to
f32 where they meet a tensor, products keep the reference's order
(``s1 * w1s * i2``), activations are quantized by a true division
``a / scale`` and the epilogue by a multiply with ``1.0 / s2``, rounding
is half to even.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

import torch.nn.functional as F

from pytorch_ddp_resnet_tpu_torch.models.blocks import (
    BottleneckResidualBlock,
    ResidualBlock,
    subsample,
)
from pytorch_ddp_resnet_tpu_torch.models.layers import (
    Sequential,
    nchw_to_nhwc,
    nhwc_to_nchw,
)
from pytorch_ddp_resnet_tpu_torch.ops.cuda.bneck_nv import (
    bneck_block_nv,
    bneck_block_nv_plain,
    bneck_transition_nv,
    bneck_transition_nv_plain,
    pack_bneck_weights,
)
from pytorch_ddp_resnet_tpu_torch.ops.cuda.conv3x3 import (
    conv3x3_bf16,
    conv3x3_bf16_plain,
    conv3x3_int8_requant,
    conv3x3_int8_requant_plain,
    pack_weights,
    pick_tile,
)
from pytorch_ddp_resnet_tpu_torch.ops.cuda.nv_common import (
    fold_block_scales,
    fold_transition_scales,
    quantize_to_nv,
)

f32 = torch.float32


def _div(t: torch.Tensor, s: float) -> torch.Tensor:
    """``t / s`` with ``s`` rounded to t's dtype, as a true division on
    every device (a Python-scalar divisor becomes a reciprocal multiply on
    the card)."""
    return t / torch.tensor(s, dtype=t.dtype, device=t.device)


def quantize_conv_weights(w_oihw: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: (w_q [OIHW int8], scale [Cout]
    f32) with w ~= w_q * scale."""
    wf = w_oihw.to(f32)
    absmax = wf.abs().amax(dim=(1, 2, 3))
    scale = _div(torch.clamp_min(absmax, 1e-12), 127.0)
    w_q = torch.clamp(torch.round(wf / scale[:, None, None, None]),
                      -127, 127).to(torch.int8)
    return w_q, scale


def _quantize_act(a_f32: torch.Tensor, scale: float) -> torch.Tensor:
    """Per-tensor symmetric int8 activation quantization."""
    return torch.clamp(torch.round(_div(a_f32, scale)), -127,
                       127).to(torch.int8)


def _conv_eligible(conv, hw: int, n: int) -> bool:
    if not (conv.kernel_size == 3 and conv.stride == 1 and conv.padding == 1
            and not conv.use_bias
            and conv.in_channels % 32 == 0 and conv.out_channels % 32 == 0):
        return False
    try:
        pick_tile(hw, n, max(conv.in_channels, conv.out_channels))
    except ValueError:
        return False
    return True


def _block_eligible(block, shape) -> bool:
    """Identity-shortcut basic block with both 3x3s eligible at this
    NHWC activation shape."""
    b, h, w, c = shape
    if not isinstance(block, ResidualBlock) or block.transforms_shortcut:
        return False
    return (_conv_eligible(block.conv1, h * w, b * h * w)
            and _conv_eligible(block.conv2, h * w, b * h * w))


def _conv1x1_ok(conv) -> bool:
    """A 1x1 the NHWC int8 product implements: stride 1, no bias."""
    return conv.kernel_size == 1 and conv.stride == 1 and not conv.use_bias


def _bneck_eligible(block, shape) -> bool:
    """Copy of the JAX gate of the NHWC int8-product path: an identity
    bottleneck with structural 1x1s, a stride-1 conv2 and the JAX
    package's measured crossover N >= 32*Cin."""
    if (not isinstance(block, BottleneckResidualBlock)
            or block.transforms_shortcut):
        return False
    b, h, w, _ = shape
    return (_conv1x1_ok(block.conv1) and _conv1x1_ok(block.conv3)
            and block.conv2.stride == 1
            and b * h * w >= 32 * block.in_channels)


def _nv_batch_ok(b: int) -> bool:
    """The JAX NV kernels' batch rule (their W-coordinate masks use bit
    ops): a power of two, a multiple of 32. The port's kernels need
    neither; the gates keep it so both packages route the same blocks."""
    return b % 32 == 0 and b & (b - 1) == 0


def _nv_id_eligible(block, shape) -> bool:
    """Copy of the JAX gate of the NV identity blocks: post-act identity
    bottleneck, 3x3 stride-1 conv2 with padding 1, 32-aligned channels,
    the NV batch rule. No N >= 32*Cin crossover: the 7x7 stage rides
    along."""
    if (not isinstance(block, BottleneckResidualBlock) or block.preact
            or block.transforms_shortcut):
        return False
    if len(shape) != 4 or shape[3] != block.in_channels:
        return False
    c2 = block.conv2
    return (c2.kernel_size == 3 and c2.padding == 1 and c2.stride == 1
            and block.in_channels % 32 == 0
            and block.bottleneck_channels % 32 == 0
            and _nv_batch_ok(shape[0]))


def _nv_trans_eligible(block, shape) -> bool:
    """Copy of the JAX gate of the NV transition blocks: post-act
    projection bottleneck at stride 1 or 2 (stride 2 on an even plane),
    all three channel counts 32-aligned, the NV batch rule."""
    if (not isinstance(block, BottleneckResidualBlock) or block.preact
            or not block.transforms_shortcut or not block.use_proj):
        return False
    if len(shape) != 4 or shape[3] != block.in_channels:
        return False
    b, h, w, _ = shape
    st = block.stride
    if st not in (1, 2) or (st == 2 and (h % 2 or w % 2)):
        return False
    return (block.in_channels % 32 == 0
            and block.bottleneck_channels % 32 == 0
            and block.out_channels % 32 == 0 and _nv_batch_ok(b))


def _int8_matmul(q: torch.Tensor, w: torch.Tensor,
                 plain: bool) -> torch.Tensor:
    """Exact s8 x s8 -> s32 product over the last dim of q with w [K, N]:
    ``torch._int_mm`` on the card where its shape rules hold (more than
    16 rows, K and N multiples of 8), else (and for ``plain``) float64,
    where every such sum is exact."""
    q2 = q.reshape(-1, q.shape[-1])
    k, n = w.shape
    if (q.is_cuda and not plain and q2.shape[0] > 16 and k % 8 == 0
            and n % 8 == 0):
        acc = torch._int_mm(q2.contiguous(), w)
    else:
        acc = (q2.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)
    return acc.reshape(*q.shape[:-1], n)


def _conv_nhwc(a: torch.Tensor, weight: torch.Tensor, cd, stride: int = 1,
               padding: int = 0) -> torch.Tensor:
    """A bias-free conv in ``cd`` on NHWC, returned in f32."""
    z = F.conv2d(nhwc_to_nchw(a.to(cd)), weight.to(cd), stride=stride,
                 padding=padding)
    return nchw_to_nhwc(z).to(f32)


def _transition_out_shape(block, shape):
    b, h, w, _ = shape
    st = block.stride
    return (b, (h - 1) // st + 1, (w - 1) // st + 1, block.out_channels)


def _transition_eligible(block, shape) -> bool:
    """Shortcut-transforming basic block whose conv2 (3x3/s1 at the
    output geometry) is eligible."""
    if not isinstance(block, ResidualBlock) or not block.transforms_shortcut:
        return False
    if shape[3] != block.in_channels:
        return False
    b, oh, ow, _ = _transition_out_shape(block, shape)
    return _conv_eligible(block.conv2, oh * ow, b * oh * ow)


def _to_lanes(x_nhwc: torch.Tensor, n_c: int) -> torch.Tensor:
    """[B, H, W, C] -> contiguous [C, B*H*W] (the kernels take only
    contiguous tensors; for a contiguous NHWC input the reshape alone
    would be a strided view)."""
    return x_nhwc.permute(3, 0, 1, 2).reshape(n_c, -1).contiguous()


def _delane(lane) -> torch.Tensor:
    x_cs, (b, h, w, c) = lane
    return x_cs.reshape(c, b, h, w).permute(1, 2, 3, 0).contiguous()


class Int8Inference:
    """Quantized eval forward of a spec-built ResNet. Two modes share one
    walk over the model:

    - ``calibrate_fn()`` -> ``f(x) -> (logits, {conv_key: absmax})``, the
      float path with observers at the quantized convs' inputs;
    - ``serve_fn(act_scales)`` -> ``f(x) -> logits``, the int8 path.

    Conv keys are the JAX package's ('01_stack/block0/conv1', ...).
    ``fused_bneck``: False (the JAX default here) serves identity
    bottlenecks on the NHWC int8 products; "nv" (or True) runs post-act
    bottleneck trunks on the NV kernels. ``plain=True`` runs the kernels'
    plain PyTorch versions on any device (to check the kernels on the card
    against the same arithmetic).
    """

    def __init__(self, model, fused_bneck=False, plain: bool = False):
        fused_bneck = "nv" if fused_bneck is True else fused_bneck
        if fused_bneck not in (False, "nv"):
            raise ValueError(f"fused_bneck={fused_bneck!r} not in "
                             f"(False, True, 'nv')")
        self.model = model
        self.fused_bneck = fused_bneck
        self.plain = plain
        self._conv_bf16 = conv3x3_bf16_plain if plain else conv3x3_bf16
        self._requant = (conv3x3_int8_requant_plain if plain
                         else conv3x3_int8_requant)
        self._block_nv = bneck_block_nv_plain if plain else bneck_block_nv
        self._trans_nv = (bneck_transition_nv_plain if plain
                          else bneck_transition_nv)
        # key -> (packed int8 weights, per-channel scale): [Cout, 9*Cin]
        # for the lane kernels, [Cin, Cout] for the NHWC products, the NV
        # kernels' layouts under '<key>:nv'
        self._wq: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        # (block key, scales) -> an NV block's folded requant vectors
        self._folded: Dict[tuple, tuple] = {}

    def _packed_qweights(self, key: str, conv) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
        if key not in self._wq:
            w_q, scale = quantize_conv_weights(conv.weight)
            self._wq[key] = (pack_weights(w_q), scale)
        return self._wq[key]

    # --- the shared walk ---------------------------------------------------

    @torch.no_grad()
    def _forward(self, x: torch.Tensor,
                 act_scales: Optional[Dict[str, float]], stats=None):
        """One eval forward: ``act_scales=None`` -> float mode (recording
        observers into ``stats`` when given); a dict -> int8 mode."""
        cd = self.model.compute_dtype
        # flatten the spine (stacks expand to their blocks) so the int8
        # path can look one item ahead: a dual conv2 epilogue emits the
        # NEXT eligible block's quantized input alongside the carrier
        items = []
        for name, layer in self.model.named_children():
            if isinstance(layer, Sequential):
                items += [(f"{name}/{bname}", block)
                          for bname, block in layer.named_children()]
            else:
                items.append((name, layer))

        def eligible(idx, shape) -> bool:
            key, obj = items[idx]
            if len(shape) != 4 or not _block_eligible(obj, shape):
                return False
            return act_scales is None or f"{key}/conv1" in act_scales

        def trans_ok(idx, shape) -> bool:
            key, obj = items[idx]
            if len(shape) != 4 or not _transition_eligible(obj, shape):
                return False
            return act_scales is None or f"{key}/conv2" in act_scales

        def next_dual(idx, shape, block):
            if (act_scales is not None and idx + 1 < len(items)
                    and eligible(idx + 1, shape)
                    and items[idx + 1][1].preact == block.preact):
                return items[idx + 1]
            return None

        def bneck_ok(idx, shape) -> bool:
            key, obj = items[idx]
            if len(shape) != 4:
                return False
            if _bneck_eligible(obj, shape):
                return act_scales is None or f"{key}/conv1" in act_scales
            # float-mode observers of NV identity blocks the crossover
            # rejects (the 7x7 stage)
            return (act_scales is None and self.fused_bneck == "nv"
                    and _nv_id_eligible(obj, shape))

        def nv_ok(idx, shape) -> bool:
            """Int8-mode gate of the NV trunk (identity and transition
            blocks; their float-mode observers ride bneck_ok and
            nv_trans_float_ok)."""
            key, obj = items[idx]
            if (self.fused_bneck != "nv" or act_scales is None
                    or len(shape) != 4):
                return False
            if not (_nv_id_eligible(obj, shape)
                    or _nv_trans_eligible(obj, shape)):
                return False
            return all(f"{key}/conv{i}" in act_scales for i in (1, 2, 3))

        def nv_trans_float_ok(idx, shape) -> bool:
            return (act_scales is None and self.fused_bneck == "nv"
                    and len(shape) == 4
                    and _nv_trans_eligible(items[idx][1], shape))

        lane = None       # (x_cs [C, B*H*W], (b, h, w, c)) inside a run
        pending_q = None  # s8 conv1 input from the previous dual epilogue
        nvst = None       # (int8 NHWC carrier, its shape) inside an NV run
        for idx, (key, obj) in enumerate(items):
            if nvst is not None:
                shape = nvst[1]
            elif lane is not None:
                shape = lane[1]
            else:
                shape = tuple(x.shape)
            if nv_ok(idx, shape):
                # NV trunk: int8 carriers through identity and transition
                # blocks; float only at the run's entry and exit
                pending_q = None
                if lane is not None:
                    x, lane = _delane(lane), None
                s_in = act_scales[f"{key}/conv1"]
                q = quantize_to_nv(x, s_in) if nvst is None else nvst[0]
                out_shape = (_transition_out_shape(obj, shape)
                             if obj.transforms_shortcut else shape)
                s_out = None
                if idx + 1 < len(items) and nv_ok(idx + 1, out_shape):
                    s_out = act_scales[f"{items[idx + 1][0]}/conv1"]
                out = self._bneck_nv(obj, q, key, act_scales, s_in, s_out)
                if s_out is None:
                    x, nvst = out.to(cd), None
                else:
                    nvst = (out, out_shape)
            elif nv_trans_float_ok(idx, shape):
                # calibration observers of NV transitions
                pending_q = None
                if lane is not None:
                    x, lane = _delane(lane), None
                x = self._bneck_trans_float(obj, x, key, stats)
            elif eligible(idx, shape):
                if lane is None:
                    lane = (_to_lanes(x.to(cd), shape[3]), shape)
                x_cs, pending_q = self._block_lane(
                    obj, lane[0], shape, key, act_scales, stats,
                    q_in=pending_q, nxt=next_dual(idx, shape, obj))
                lane = (x_cs, shape)
            elif trans_ok(idx, shape):
                # stage transition: conv1/shortcut NHWC float, conv2 int8
                # in lane layout; the run continues at the new geometry
                if lane is not None:
                    x, lane = _delane(lane), None
                out_shape = _transition_out_shape(obj, shape)
                x_cs, pending_q = self._transition_lane(
                    obj, x, key, act_scales, stats,
                    nxt=next_dual(idx, out_shape, obj))
                lane = (x_cs, out_shape)
            elif bneck_ok(idx, shape):
                # identity bottleneck: NHWC, exact int8 1x1 products
                pending_q = None
                if lane is not None:
                    x, lane = _delane(lane), None
                x = self._bneck_nhwc(obj, x, key, act_scales, stats)
            else:
                pending_q = None
                if lane is not None:
                    x, lane = _delane(lane), None
                x = obj(x)
        if lane is not None:
            x = _delane(lane)
        return x

    def _bneck_nhwc(self, block, x, key, act_scales, stats):
        """Identity-shortcut bottleneck in NHWC: the 1x1s as exact int8
        products (float in calibration), the 3x3 in bf16, the BN affines
        and relus in f32. Float mode records all three conv inputs (the NV
        kernels quantize conv2 too)."""
        i1, t1 = block.norm1.eval_affine()
        i2, t2 = block.norm2.eval_affine()
        i3, t3 = block.norm3.eval_affine()
        cd = block.compute_dtype
        xf = x.to(f32)

        def relu(t):
            return torch.clamp_min(t, 0.0)

        def conv3(a, inv, sh):
            if stats is not None:
                stats[f"{key}/conv2"] = a.abs().amax()
            return relu(_conv_nhwc(a, block.conv2.weight, cd, padding=1)
                        * inv + sh)

        if act_scales is None:  # float / calibration mode
            def conv1x1(a, cname):
                if stats is not None:
                    stats[f"{key}/{cname}"] = a.abs().amax()
                w = getattr(block, cname).weight
                wt = w.reshape(w.shape[0], w.shape[1]).T.to(cd)
                return (a.to(cd) @ wt).to(f32)
        else:
            s = {c: act_scales[f"{key}/{c}"] for c in ("conv1", "conv3")}

            def conv1x1(a, cname):
                ckey = f"{key}/{cname}"
                if ckey not in self._wq:
                    w_q, w_s = quantize_conv_weights(
                        getattr(block, cname).weight)
                    self._wq[ckey] = (w_q.reshape(w_q.shape[:2]).T, w_s)
                w_q, w_s = self._wq[ckey]
                acc = _int8_matmul(_quantize_act(a, s[cname]), w_q,
                                   self.plain)
                return acc.to(f32) * (torch.tensor(
                    s[cname], dtype=f32, device=w_s.device) * w_s)

        if block.preact:
            a1 = relu(xf * i1 + t1)
            a2 = relu(conv1x1(a1, "conv1") * i2 + t2)
            a3 = conv3(a2, i3, t3)
            return (xf + conv1x1(a3, "conv3")).to(cd)
        a1 = relu(conv1x1(xf, "conv1") * i1 + t1)
        a2 = conv3(a1, i2, t2)
        z3 = conv1x1(a2, "conv3") * i3 + t3
        return relu(xf + z3).to(cd)

    def _bneck_nv(self, block, q, key, act_scales, s_in, s_out):
        """One post-act bottleneck block (identity or transition) on the
        NV kernels. q: the int8 NHWC carrier. ``s_out``: the next block's
        conv1 scale (int8 carrier out) or None (bf16 out)."""
        s2 = act_scales[f"{key}/conv2"]
        s3 = act_scales[f"{key}/conv3"]
        so = 1.0 if s_out is None else s_out
        names = ("conv1", "conv2", "conv3") + (
            ("proj",) if block.transforms_shortcut else ())
        wq = {}
        for cname in names:
            ckey = f"{key}/{cname}:nv"
            if ckey not in self._wq:
                w_q, w_s = quantize_conv_weights(getattr(block, cname).weight)
                self._wq[ckey] = (pack_bneck_weights(w_q), w_s)
            wq[cname] = self._wq[ckey]
        fkey = (key, s_in, s2, s3, so)
        if fkey not in self._folded:
            aff = [v for n in ("norm1", "norm2", "norm3")
                   for v in getattr(block, n).eval_affine()]
            args = (s_in, s2, s3, so,
                    wq["conv1"][1], *aff[0:2], wq["conv2"][1], *aff[2:4],
                    wq["conv3"][1], *aff[4:6])
            self._folded[fkey] = (
                fold_transition_scales(*args, wq["proj"][1])
                if block.transforms_shortcut else fold_block_scales(*args))
        folded = self._folded[fkey]
        weights = [wq[n][0] for n in names]
        if block.transforms_shortcut:
            return self._trans_nv(q, *weights, *folded, stride=block.stride,
                                  out_int8=s_out is not None)
        return self._block_nv(q, *weights, *folded,
                              out_int8=s_out is not None)

    def _bneck_trans_float(self, block, x, key, stats):
        """Float post-act transition bottleneck with observers at its three
        conv inputs (the JAX block's eval semantics; conv2's padding is the
        symmetric 1, not SAME)."""
        i1, t1 = block.norm1.eval_affine()
        i2, t2 = block.norm2.eval_affine()
        i3, t3 = block.norm3.eval_affine()
        cd = block.compute_dtype
        xf = x.to(f32)

        def obs(name, a):
            if stats is not None:
                stats[f"{key}/{name}"] = a.abs().amax()

        obs("conv1", xf)
        a1 = torch.clamp_min(_conv_nhwc(xf, block.conv1.weight, cd) * i1
                             + t1, 0.0)
        obs("conv2", a1)
        a2 = torch.clamp_min(_conv_nhwc(a1, block.conv2.weight, cd,
                                        stride=block.stride, padding=1)
                             * i2 + t2, 0.0)
        obs("conv3", a2)
        z3 = _conv_nhwc(a2, block.conv3.weight, cd) * i3 + t3
        sc = _conv_nhwc(subsample(xf, block.stride), block.proj.weight, cd)
        return torch.clamp_min(sc + z3, 0.0).to(cd)

    def _block_lane(self, block, x_cs, shape, key, act_scales, stats,
                    q_in=None, nxt=None):
        """One eligible basic block in lane layout. Returns
        (new_carrier, next_block_q_or_None)."""
        _, h, w, _ = shape
        i1, t1 = block.norm1.eval_affine()
        i2, t2 = block.norm2.eval_affine()
        if act_scales is not None:
            return self._block_lane_int8(
                block, x_cs, h, w, key, act_scales, i1, t1, i2, t2,
                q_in=q_in, nxt=nxt)

        # float path (calibration): f32 elementwise, observers at exactly
        # the conv inputs the int8 path quantizes
        cd = block.compute_dtype
        xf = x_cs.to(f32)

        def conv(a_f32, cname, bn_inv):
            """a_f32 [Cin, N] -> conv output [Cout, N] f32, with the
            *following* BN's inv folded in when given."""
            if stats is not None:
                stats[f"{key}/{cname}"] = a_f32.abs().amax()
            wp = pack_weights(getattr(block, cname).weight.to(cd))
            yf = self._conv_bf16(a_f32.to(cd), wp, h=h, w_img=w).to(f32)
            return yf * bn_inv[:, None] if bn_inv is not None else yf

        if block.preact:
            # norm1 -> relu -> conv1 -> norm2 -> relu -> conv2, identity add
            a1 = torch.clamp_min(xf * i1[:, None] + t1[:, None], 0.0)
            z = conv(a1, "conv1", i2) + t2[:, None]
            y = conv(torch.clamp_min(z, 0.0), "conv2", None)
            return (xf + y).to(cd), None
        # post-act v1: conv1 -> norm1 -> relu -> conv2 -> norm2, add, relu
        z = conv(xf, "conv1", i1) + t1[:, None]
        y = conv(torch.clamp_min(z, 0.0), "conv2", i2) + t2[:, None]
        return torch.clamp_min(xf + y, 0.0).to(cd), None

    def _transition_lane(self, block, x, key, act_scales, stats, nxt=None):
        """Shortcut-transforming basic block with conv2 on the int8 kernel:
        conv1 (strided / channel-changing) and the shortcut run as float
        modules in NHWC; conv2 takes the transformed shortcut in its
        epilogue. Returns (carrier [Cout, B*OH*OW], next_q_or_None)."""
        cd = block.compute_dtype
        _, oh, ow, cout = _transition_out_shape(block, tuple(x.shape))
        i1, t1 = block.norm1.eval_affine()
        i2, t2 = block.norm2.eval_affine()
        if block.preact:
            a1 = torch.clamp_min(x.to(f32) * i1 + t1, 0.0)
            z1 = block.conv1(a1.to(cd))
        else:
            z1 = block.conv1(x.to(cd))
        # the shortcut transforms the RAW block input
        i_cs = _to_lanes(block.shortcut(x).to(torch.bfloat16), cout)
        z_cs = _to_lanes(z1, cout).to(f32)
        # conv2's input: relu(norm2(z1)) preact, relu(norm1(z1)) post-act
        inv, sh = (i2, t2) if block.preact else (i1, t1)
        a2 = torch.clamp_min(z_cs * inv[:, None] + sh[:, None], 0.0)
        ckey = f"{key}/conv2"

        if act_scales is None:  # float / calibration mode
            if stats is not None:
                stats[ckey] = a2.abs().amax()
            wp = pack_weights(block.conv2.weight.to(cd))
            y = self._conv_bf16(a2.to(cd), wp, h=oh, w_img=ow).to(f32)
            res = i_cs.to(f32)
            if block.preact:
                out = res + y
            else:  # norm2 on conv2's output, add shortcut, post-relu
                out = torch.clamp_min(res + y * i2[:, None] + t2[:, None],
                                      0.0)
            return out.to(cd), None

        s2 = act_scales[ckey]
        w2q, w2s = self._packed_qweights(ckey, block.conv2)
        q2 = _quantize_act(a2, s2)
        dual = (self._next_entry_affine(nxt, act_scales)
                if nxt is not None else None)
        if block.preact:
            out = self._requant(q2, w2q, s2 * w2s, torch.zeros_like(w2s),
                                i_cs, dual, h=oh, w_img=ow, relu=False)
        else:
            out = self._requant(q2, w2q, s2 * w2s * i2, t2, i_cs, dual,
                                h=oh, w_img=ow, relu=True)
        return out if dual is not None else (out, None)

    def _next_entry_affine(self, nxt, act_scales):
        """The next block's norm1 eval affine and conv1 input scale folded
        into the dual epilogue's (sb, tb): next_q = s8(clip(round(
        max(carrier*sb + tb, 0)))). Post-act blocks feed conv1 the raw
        (already relu'd) carrier: identity affine over the scale."""
        nkey, nblk = nxt
        s1n = act_scales[f"{nkey}/conv1"]
        if nblk.preact:
            i1n, t1n = nblk.norm1.eval_affine()
            return _div(i1n, s1n), _div(t1n, s1n)
        ones = torch.ones((nblk.out_channels,), dtype=f32,
                          device=nblk.conv1.weight.device)
        return _div(ones, s1n), ones * 0.0

    def _block_lane_int8(self, block, x_cs, h, w, key, act_scales,
                         i1, t1, i2, t2, q_in=None, nxt=None):
        """Int8 basic block, lane layout, fused requant epilogues: conv1's
        epilogue applies the dequant scale, the BN between the convs, relu
        and conv2's input quantization; conv2's adds the residual and, in
        dual mode, emits the next block's quantized input. Only the first
        block of a run quantizes its input outside a kernel.

        Returns (carrier_bf16, next_block_q_or_None)."""
        s1 = act_scales[f"{key}/conv1"]
        s2 = act_scales[f"{key}/conv2"]
        w1q, w1s = self._packed_qweights(f"{key}/conv1", block.conv1)
        w2q, w2s = self._packed_qweights(f"{key}/conv2", block.conv2)
        x = x_cs.to(torch.bfloat16)  # residual carrier
        dual = (self._next_entry_affine(nxt, act_scales)
                if nxt is not None else None)
        if block.preact:
            if q_in is None:
                # run entry: a1 = relu(norm1(x)), quantized for conv1
                a1 = torch.clamp_min(
                    x.to(f32) * i1[:, None] + t1[:, None], 0.0)
                q_in = _quantize_act(a1, s1)
            q2 = self._requant(q_in, w1q, s1 * w1s * i2, t2, None, h=h,
                               w_img=w, relu=True, inv_out_scale=1.0 / s2)
            out = self._requant(q2, w2q, s2 * w2s, torch.zeros_like(w2s), x,
                                dual, h=h, w_img=w, relu=False)
            return out if dual is not None else (out, None)
        # post-act v1: x is post-relu (>= 0); conv1's input is x itself
        if q_in is None:
            q_in = _quantize_act(x.to(f32), s1)
        q2 = self._requant(q_in, w1q, s1 * w1s * i1, t1, None, h=h, w_img=w,
                           relu=True, inv_out_scale=1.0 / s2)
        out = self._requant(q2, w2q, s2 * w2s * i2, t2, x, dual, h=h,
                            w_img=w, relu=True)
        return out if dual is not None else (out, None)

    # --- public entry points ---------------------------------------------

    def calibrate_fn(self):
        """Float forward with observers: ``f(x_nhwc) -> (logits,
        {conv_key: absmax tensor})``."""

        def f(x):
            stats: Dict[str, Any] = {}
            return self._forward(x, None, stats), stats

        return f

    def serve_fn(self, act_scales: Dict[str, Any]):
        """Int8 forward ``f(x_nhwc) -> logits``; ``act_scales`` maps conv
        keys to per-tensor input scales (kept as Python floats)."""
        scales = {k: float(v) for k, v in act_scales.items()}
        return lambda x: self._forward(x, scales)


def calibrate(inference: Int8Inference, batches) -> Dict[str, float]:
    """Run calibration batches (preprocessed NHWC tensors) through the
    float path; return per-conv activation scales (absmax/127)."""
    f = inference.calibrate_fn()
    maxes: Dict[str, float] = {}
    n = 0
    for xb in batches:
        _, stats = f(xb)
        for k, v in stats.items():
            maxes[k] = max(maxes.get(k, 0.0), float(v))
        n += 1
    if n == 0:
        raise ValueError("calibrate() needs at least one batch.")
    return {k: max(v, 1e-12) / 127.0 for k, v in maxes.items()}
