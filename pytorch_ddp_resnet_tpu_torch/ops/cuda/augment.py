"""Fused gather + augmentation of a training batch (counterpart of
pytorch_ddp_resnet_tpu/ops/pallas/augment.py).

- ``augment_batch``: one launch of ``csrc/augment.cu`` turns a batch's
  indices, crop corners and flip bits into the model's bf16 NHWC input,
  straight from the uint8 NHWC train set resident on the card. Replaces
  ``pallas_augment`` (whose output, in the CHW-planar layout, equals this
  one after ``chw_planar_to_nhwc``).
- ``augment_batch_plain``: the same function in PyTorch ops, in f32 and
  the same order. A CPU tensor runs it; a CUDA tensor launches the kernel
  or raises. ``launches`` counts kernel launches only.
- ``make_pallas_augment_fn`` / ``try_from_transforms``: the
  ``(idx, key) -> batch`` function (``FusedAugment``) for the standard
  CIFAR recipe, and the pattern match that selects it for a configured
  pipeline (None where the JAX one returns None).

Arithmetic, as the reference: ``fma(x, f32(1/255), -mean) * inv_std`` in
f32, with ``inv_std`` the f32 reciprocal of the fitted stddev taken on
the host, then the flip, the pad (zero or reflect) and the crop, rounded
to bf16. The multiply and the subtract round once, as one fused
multiply-add: that is what the JAX kernel computes where the tests run it
(XLA on the CPU contracts ``x * (1/255) - mean``; two separate roundings
differ from it in about 1 of 3,000 bf16 outputs).
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_ddp_resnet_tpu_torch.data.transforms import crop_batch
from pytorch_ddp_resnet_tpu_torch.ops.cuda.checks import (
    check_rc,
    on_cpu,
    require_cuda,
)

launches: collections.Counter = collections.Counter()

INV_255 = float(np.float32(1.0 / 255.0))  # the reference's f32 constant

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    launches.clear()


def _check(data, idx, top, left, flip, mean, inv_std, pad: int, crop: int,
           mirror: bool) -> None:
    if data.dim() != 4:
        raise ValueError(
            f"data must be [N, H, W, C], got {tuple(data.shape)}")
    _, h, w, c = data.shape
    b = idx.shape[0]
    for name, t in (("idx", idx), ("top", top), ("left", left),
                    ("flip", flip)):
        if tuple(t.shape) != (b,):
            raise ValueError(f"{name} {tuple(t.shape)} vs batch {b}")
    for name, t in (("mean", mean), ("inv_std", inv_std)):
        if tuple(t.shape) != (h, w, c):
            raise ValueError(
                f"{name} {tuple(t.shape)} vs image {(h, w, c)}")
    if crop > min(h, w) + 2 * pad:
        raise ValueError(f"crop {crop} exceeds the padded image")
    if mirror and pad >= min(h, w):
        raise ValueError(f"reflect padding {pad} needs pad < {min(h, w)}")


def augment_batch_plain(data, idx, top, left, flip, mean, inv_std, *,
                        pad: int, crop: int, mirror: bool) -> torch.Tensor:
    """Plain version of ``augment_batch``."""
    _check(data, idx, top, left, flip, mean, inv_std, pad, crop, mirror)
    # x * f32(1/255) - mean with one rounding, as an FMA: the product of a
    # uint8 and an f32 is exact in float64 and so (for |mean| above 2^-29)
    # is the difference, so the only rounding is the cast to f32
    x = data[idx.long()].to(torch.float64) * torch.tensor(
        INV_255, dtype=torch.float64)
    x = (x - mean.to(torch.float64)).to(torch.float32) * inv_std
    x = torch.where(flip.bool()[:, None, None, None], x.flip(2), x)
    x = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad),
              mode="reflect" if mirror else "constant").permute(0, 2, 3, 1)
    return crop_batch(x, top, left, crop).to(torch.bfloat16)


_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from pytorch_ddp_resnet_tpu_torch.ops.cuda import build

        lib = build.load("augment")
        lib.augment_batch_launch.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
            ctypes.c_float, _P]
        lib.augment_batch_launch.restype = _I
        _lib = lib
    return _lib


def augment_batch(data, idx, top, left, flip, mean, inv_std, *, pad: int,
                  crop: int, mirror: bool) -> torch.Tensor:
    """data [N, H, W, C] uint8; idx, top, left, flip [B] int32 (flip 0/1,
    corners in [0, H + 2*pad - crop]); mean, inv_std [H, W, C] f32.
    Returns [B, crop, crop, C] bf16."""
    if on_cpu(data):
        return augment_batch_plain(data, idx, top, left, flip, mean, inv_std,
                                   pad=pad, crop=crop, mirror=mirror)
    name = "augment_batch"
    _check(data, idx, top, left, flip, mean, inv_std, pad, crop, mirror)
    i32, f32 = torch.int32, torch.float32
    require_cuda(name, [data, idx, top, left, flip, mean, inv_std],
                 [torch.uint8, i32, i32, i32, i32, f32, f32])
    n, h, w, c = data.shape
    b = idx.shape[0]
    out = torch.empty((b, crop, crop, c), dtype=torch.bfloat16,
                      device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    rc = _library().augment_batch_launch(
        data.data_ptr(), idx.data_ptr(), top.data_ptr(), left.data_ptr(),
        flip.data_ptr(), mean.data_ptr(), inv_std.data_ptr(), out.data_ptr(),
        n, b, h, w, c, pad, crop, int(mirror), INV_255, stream)
    check_rc(name, rc)
    launches[name] += 1
    return out


class FusedAugment:
    """``(idx, key) -> (B, crop, crop, C) bf16``: the fused resident gather
    and augmentation, on the data, statistics and geometry it holds. The
    draws follow the JAX function: ``key.split(3)`` into top, left and
    flip."""

    def __init__(self, data: torch.Tensor, mean: torch.Tensor,
                 inv_std: torch.Tensor, flip_p: float, pad: int, crop: int,
                 mirror: bool):
        self.data, self.mean, self.inv_std = data, mean, inv_std
        self.flip_p, self.pad, self.crop, self.mirror = (flip_p, pad, crop,
                                                         mirror)

    def draws(self, bsz: int, key):
        """(top, left, flip), int32 [bsz] each, on the data's device."""
        _, h, w, _ = self.data.shape
        dev = self.data.device
        k_top, k_left, k_flip = key.split(3)
        top = k_top.randint((bsz,), 0, h + 2 * self.pad - self.crop + 1, dev)
        left = k_left.randint((bsz,), 0, w + 2 * self.pad - self.crop + 1,
                              dev)
        flip = k_flip.bernoulli(self.flip_p, (bsz,), dev).to(torch.int32)
        return top, left, flip

    def __call__(self, idx: torch.Tensor, key, fn=None) -> torch.Tensor:
        """``fn`` = ``augment_batch_plain`` runs the plain version on the
        same draws."""
        top, left, flip = self.draws(idx.shape[0], key)
        return (fn or augment_batch)(
            self.data, idx.to(torch.int32), top, left, flip, self.mean,
            self.inv_std, pad=self.pad, crop=self.crop, mirror=self.mirror)


def make_pallas_augment_fn(dataset_nhwc_u8, mean_nhwc: Optional[np.ndarray],
                           std_nhwc: Optional[np.ndarray], flip_p: float,
                           pad: int, crop: int, mirror: bool,
                           device: torch.device) -> FusedAugment:
    """The fused augment of a train set (a tensor on ``device`` is used as
    it is) with fitted whitening statistics in NHWC (None: the
    identity)."""
    data = torch.as_tensor(dataset_nhwc_u8, device=device)
    _, h, w, c = data.shape
    mean = (np.zeros((h, w, c), np.float32) if mean_nhwc is None
            else np.asarray(mean_nhwc, np.float32))
    inv_std = (np.ones((h, w, c), np.float32) if std_nhwc is None
               else np.float32(1.0) / np.asarray(std_nhwc, np.float32))
    return FusedAugment(
        data, torch.from_numpy(np.ascontiguousarray(mean)).to(device),
        torch.from_numpy(np.ascontiguousarray(inv_std)).to(device),
        flip_p, pad, crop, mirror)


def try_from_transforms(transforms, dataset_nhwc_u8, device: torch.device):
    """Match an ordered transform pipeline onto the fused kernel:

        ToTensorTransform
        [ZeroMeanWhiteningTransform | StandardizeWhiteningTransform]
        [FlipTransform(p)]
        [PaddingTransform(pad, zero|mirror)]
        [RandomCropTransform(crop)]

    Returns the fused ``(idx, key) -> batch`` function, or None when the
    pipeline does not match (the caller keeps the transform chain)."""
    from pytorch_ddp_resnet_tpu_torch.data import transforms as T

    seq = list(transforms.values())
    _, h, w, _ = dataset_nhwc_u8.shape
    if not seq or not isinstance(seq[0], T.ToTensorTransform):
        return None
    i = 1
    mean = std = None
    if i < len(seq) and isinstance(seq[i], T.ZeroMeanWhiteningTransform):
        mean = seq[i].mean.cpu().numpy()
        i += 1
    elif i < len(seq) and isinstance(seq[i],
                                     T.StandardizeWhiteningTransform):
        mean, std = seq[i].mean.cpu().numpy(), seq[i].stddev.cpu().numpy()
        i += 1
    flip_p = 0.0
    if i < len(seq) and isinstance(seq[i], T.FlipTransform):
        flip_p = seq[i].p
        i += 1
    pad, mirror = 0, False
    if i < len(seq) and isinstance(seq[i], T.PaddingTransform):
        pad, mirror = seq[i].pad_size, seq[i].pad_type == "mirror"
        i += 1
    crop = h + 2 * pad
    if i < len(seq) and isinstance(seq[i], T.RandomCropTransform):
        crop = seq[i].crop_size
        i += 1
    if i != len(seq) or h != w or crop > h + 2 * pad:
        return None
    return make_pallas_augment_fn(dataset_nhwc_u8, mean, std, flip_p=flip_p,
                                  pad=pad, crop=crop, mirror=mirror,
                                  device=device)
