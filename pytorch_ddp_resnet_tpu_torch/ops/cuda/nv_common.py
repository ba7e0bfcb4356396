"""What int8 bottleneck serving needs of the JAX package's
``ops/pallas/nv_common.py`` and ``ops/pallas/bneck_nv.py``, as the port's
own copy: the folding of scales and BatchNorm affines into the NV
kernels' requant vectors, the requant epilogue, and the entry
quantization.

The JAX kernels carry activations in the TPU's "NV" layout [h, wp, N, C];
the port's carrier is plain int8 NHWC [N, h, w, C], contiguous, with no
border columns (``quantize_to_nv`` keeps the JAX name of the entry and
returns that carrier). The JAX layout helpers (``to_nv``, ``from_nv``,
``wcol_mask``, ``shift_rows``, ``check_nv``) serve the TPU's tiling and
have no counterpart; tests that compare with JAX convert layouts
themselves.

Arithmetic follows the JAX functions operation for operation, in f32:
Python scalars meet tensors as f32 values (``_f32``), a division by a
scale is a true f32 division, and ``quantize_to_nv`` multiplies by
``f32(1 / scale)``, as the JAX entry does (the basic-block path's
``_quantize_act`` divides instead; the two differ in f32).
"""

from __future__ import annotations

from typing import Tuple

import torch

from pytorch_ddp_resnet_tpu_torch.ops.cuda.conv3x3 import fma_f32, quant_s8

f32 = torch.float32
f64 = torch.float64


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """A Python float as an f32 scalar tensor on ``like``'s device."""
    return torch.tensor(v, dtype=f32, device=like.device)


def _vec(v) -> torch.Tensor:
    return torch.as_tensor(v).to(f32)


def fold_block_scales(s_in: float, s2: float, s3: float, s_out,
                      w1s, i1, t1, w2s, i2, t2, w3s, i3, t3):
    """Per-tensor activation scales, per-channel weight scales and the BN
    eval affines of an identity post-act bottleneck block folded into the
    kernel's (p1, q1, p2, q2, p3, q3, r):

        a1 = requant(acc1 * p1 + q1),  p1 = s_in*w1s*i1 / s2, q1 = t1 / s2
        a2 = requant(acc2 * p2 + q2),  p2 = s2*w2s*i2 / s3,   q2 = t2 / s3
        out = relu(x*r + acc3*p3 + q3) / s_out scale:
                                       p3 = s3*w3s*i3 / s_out,
                                       q3 = t3 / s_out, r = s_in / s_out

    (``s_out`` = 1.0 for the bf16 exit). ``r`` is a Python float."""
    s_out = float(s_out)
    w1s, i1, t1, w2s, i2, t2, w3s, i3, t3 = (
        _vec(v) for v in (w1s, i1, t1, w2s, i2, t2, w3s, i3, t3))
    p1 = w1s * i1 * _f32(s_in / s2, w1s)
    q1 = t1 / _f32(s2, t1)
    p2 = w2s * i2 * _f32(s2 / s3, w2s)
    q2 = t2 / _f32(s3, t2)
    p3 = w3s * i3 * _f32(s3 / s_out, w3s)
    q3 = t3 / _f32(s_out, t3)
    return p1, q1, p2, q2, p3, q3, float(s_in) / s_out


def fold_transition_scales(s_in: float, s2: float, s3: float, s_out,
                           w1s, i1, t1, w2s, i2, t2, w3s, i3, t3, wps):
    """``fold_block_scales`` for a transition block: the residual term
    becomes the projection's per-channel dequant ``pp = s_in*wps / s_out``
    (the post-act projection has no BatchNorm)."""
    p1, q1, p2, q2, p3, q3, _ = fold_block_scales(
        s_in, s2, s3, s_out, w1s, i1, t1, w2s, i2, t2, w3s, i3, t3)
    wps = _vec(wps)
    pp = wps * _f32(float(s_in) / float(s_out), wps)
    return p1, q1, p2, q2, p3, q3, pp


def requant(acc: torch.Tensor, p: torch.Tensor,
            q: torch.Tensor) -> torch.Tensor:
    """The serving kernels' epilogue: s32 -> f32 (round to nearest), one
    FMA with the folded (p, q), relu, int8. ``acc``: exact integers in
    any dtype; p, q broadcast over its last dimension."""
    y = fma_f32(acc.to(f32), p, q)
    return quant_s8(torch.clamp_min(y, 0.0))


def quantize_to_nv(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Entry quantization of an NV run: int8 NHWC ``clip(round(x *
    f32(1 / scale)))``, contiguous."""
    xf = x.to(f32)
    return quant_s8(xf * _f32(1.0 / scale, xf)).contiguous()


def out_geometry(h: int, w: int, stride: int) -> Tuple[int, int]:
    """Output plane of conv2 (3x3, padding 1) at ``stride``."""
    return (h - 1) // stride + 1, (w - 1) // stride + 1
