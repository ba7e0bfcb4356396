"""Stride-1 SAME 3x3 convolutions in the channel-major layout [C, B*H*W].

Counterpart of ``pytorch_ddp_resnet_tpu/ops/pallas/conv.py``: the same
public layout (x ``[Cin, N]`` with ``N = B*H*W`` image-major, packed
weights ``[Cout, 9*Cin]``, taps row-major in (dh, dw) then input channel),
so the tests compare like with like.

- ``conv3x3_bf16``: bf16 in, f32 accumulate, bf16 out (the float
  calibration pass of int8 serving). Replaces ``conv3x3_lanes``.
- ``conv3x3_int8_requant``: s8 x s8 -> s32 with the requantization
  epilogue fused in. Replaces ``conv3x3_lanes_requant``.

Each wrapper dispatches on the device of its input: a CPU tensor goes to
the plain PyTorch version beside it; a CUDA tensor launches the kernel in
``csrc/conv3x3.cu`` (built at first use, ops/cuda/build.py) or raises.
``launches`` counts kernel launches per kernel name and
``launch_shapes`` per (name, Cin, Cout, N, epilogue mode); plain calls
count nothing.

The plain versions compute in float64, where every int8 product sum is
exact (|acc| <= 9*Cin*127^2 ~ 9.3e7 > 2^24 breaks float32) and no TF32
applies on the card.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from pytorch_ddp_resnet_tpu_torch.ops.cuda.checks import (
    check_rc,
    on_cpu,
    require_cuda,
)

launches: collections.Counter = collections.Counter()
launch_shapes: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    launches.clear()
    launch_shapes.clear()


def pick_tile(hw: int, n: int, c: int = 160, max_tile: int = 2048) -> int:
    """Copy of the JAX package's lane-tile picker (ops/pallas/conv.py
    ``_pick_tile``). The port's kernels do not tile this way; the function
    serves only as the int8 eligibility gate (models/quantize.py), so the
    port quantizes exactly the convs the JAX package quantizes."""
    target = max(128, min(max_tile, (160 * 2048) // max(c, 1)))
    t = hw
    while t < target and (t * 2) <= n and n % (t * 2) == 0:
        t *= 2
    while t % 128 != 0:
        if t * 2 > n or n % (t * 2) != 0:
            raise ValueError(
                f"cannot reach a 128-multiple lane tile from HW={hw}, N={n}")
        t *= 2
    if t > 2 * target:
        raise ValueError(
            f"image-aligned lane tile {t} exceeds the VMEM budget for "
            f"c={c} (target {target})")
    return t


def pack_weights(w_oihw: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin, 3, 3] -> [Cout, 9*Cin], taps row-major in (dh, dw)."""
    cout, cin, kh, kw = w_oihw.shape
    if (kh, kw) != (3, 3):
        raise ValueError("pack_weights expects a 3x3 kernel.")
    return w_oihw.permute(0, 2, 3, 1).reshape(cout, 9 * cin).contiguous()


def _shapes(x_cs, w_packed, h: int, w_img: int) -> Tuple[int, int, int]:
    cin, n = x_cs.shape
    cout = w_packed.shape[0]
    if w_packed.shape[1] != 9 * cin:
        raise ValueError(f"weights {tuple(w_packed.shape)} vs Cin {cin}")
    if n % (h * w_img) != 0:
        raise ValueError(f"N={n} not a multiple of H*W={h * w_img}")
    return cin, cout, n


# --- plain versions ----------------------------------------------------------

def _conv_f64(x_cs, w_packed, h: int, w_img: int) -> torch.Tensor:
    """Exact-as-float64 3x3 SAME conv in the [C, N] layout."""
    cin, n = x_cs.shape
    cout = w_packed.shape[0]
    b = n // (h * w_img)
    x = x_cs.to(torch.float64).reshape(cin, b, h, w_img).permute(1, 0, 2, 3)
    w = w_packed.to(torch.float64).reshape(cout, 3, 3, cin).permute(
        0, 3, 1, 2)
    y = F.conv2d(x, w, padding=1)
    return y.permute(1, 0, 2, 3).reshape(cout, n)


def conv3x3_bf16_plain(x_cs, w_packed, *, h: int, w_img: int):
    """Plain version of ``conv3x3_bf16``: output in x's dtype."""
    _shapes(x_cs, w_packed, h, w_img)
    return _conv_f64(x_cs, w_packed, h, w_img).to(torch.float32).to(
        x_cs.dtype)


def conv3x3_s32_plain(x_q, w_q, *, h: int, w_img: int) -> torch.Tensor:
    """The int8 conv's exact s32 accumulator."""
    _shapes(x_q, w_q, h, w_img)
    return _conv_f64(x_q, w_q, h, w_img).to(torch.int32)


def quant_s8(v: torch.Tensor) -> torch.Tensor:
    """clip(round(v), -127, 127) as int8; torch.round is half to even, as
    jnp.round."""
    return torch.clamp(torch.round(v), -127.0, 127.0).to(torch.int8)


def conv3x3_int8_requant_plain(x_q, w_q, scale, shift, res=None, dual=None,
                               *, h: int, w_img: int, relu: bool = False,
                               inv_out_scale: Optional[float] = None):
    """Plain version of ``conv3x3_int8_requant``."""
    if dual is not None and inv_out_scale is not None:
        raise ValueError("dual output requires the bf16-carrier mode")
    acc = conv3x3_s32_plain(x_q, w_q, h=h, w_img=w_img)
    y = acc.to(torch.float32) * scale.to(torch.float32)[:, None] \
        + shift.to(torch.float32)[:, None]
    if res is not None:
        y = y + res.to(torch.bfloat16).to(torch.float32)
    if relu:
        y = torch.clamp_min(y, 0.0)
    out = (quant_s8(y * float(inv_out_scale))
           if inv_out_scale is not None else y.to(torch.bfloat16))
    if dual is None:
        return out
    sb, tb = dual
    g = torch.clamp_min(y * sb.to(torch.float32)[:, None]
                        + tb.to(torch.float32)[:, None], 0.0)
    return out, quant_s8(g)


# --- kernels -------------------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from pytorch_ddp_resnet_tpu_torch.ops.cuda import build

        lib = build.load("conv3x3")
        lib.conv3x3_bf16_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I,
                                            _P]
        lib.conv3x3_bf16_launch.restype = _I
        lib.conv3x3_int8_requant_launch.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
            ctypes.c_float, _P]
        lib.conv3x3_int8_requant_launch.restype = _I
        _lib = lib
    return _lib


def conv3x3_bf16(x_cs, w_packed, *, h: int, w_img: int) -> torch.Tensor:
    """Stride-1 SAME 3x3 conv, x [Cin, N] x w [Cout, 9*Cin] -> [Cout, N].
    On the card: bf16 only, Cin a multiple of 32."""
    cin, cout, n = _shapes(x_cs, w_packed, h, w_img)
    if on_cpu(x_cs):
        return conv3x3_bf16_plain(x_cs, w_packed, h=h, w_img=w_img)
    name = "conv3x3_bf16"
    require_cuda(name, [x_cs, w_packed], [torch.bfloat16] * 2)
    if cin % 32:
        raise ValueError(f"{name}: Cin={cin} is not a multiple of 32")
    out = torch.empty((cout, n), dtype=torch.bfloat16, device=x_cs.device)
    stream = torch.cuda.current_stream(x_cs.device).cuda_stream
    rc = _library().conv3x3_bf16_launch(
        x_cs.data_ptr(), w_packed.data_ptr(), out.data_ptr(), cin, cout, n,
        h, w_img, stream)
    check_rc(name, rc)
    launches[name] += 1
    launch_shapes[(name, cin, cout, n, "bf16")] += 1
    return out


def _requant_mode(res, dual, inv_out_scale) -> str:
    """Epilogue mode label: int8 out, bf16 out, +res, dual."""
    mode = "int8" if inv_out_scale is not None else "bf16"
    if res is not None:
        mode += "+res"
    if dual is not None:
        mode += "+dual"
    return mode


def conv3x3_int8_requant(x_q, w_q, scale, shift, res=None, dual=None, *,
                         h: int, w_img: int, relu: bool = False,
                         inv_out_scale: Optional[float] = None):
    """Int8 stride-1 SAME 3x3 conv with the requantization epilogue:

        y = acc * scale[Cout] + shift[Cout] (+ res)
        if relu: y = max(y, 0)
        out = s8(clip(round(y * inv_out_scale)))  or  bf16(y)
        out2 = s8(clip(round(max(y*sb + tb, 0))))       (dual=(sb, tb))

    x_q [Cin, N] int8, w_q [Cout, 9*Cin] int8, scale/shift [Cout] f32,
    res [Cout, N] (cast to bf16), inv_out_scale a Python float or None.
    Returns out, or (out, out2) in dual mode (bf16-carrier mode only)."""
    cin, cout, n = _shapes(x_q, w_q, h, w_img)
    if dual is not None and inv_out_scale is not None:
        raise ValueError("dual output requires the bf16-carrier mode")
    if on_cpu(x_q):
        return conv3x3_int8_requant_plain(
            x_q, w_q, scale, shift, res, dual, h=h, w_img=w_img, relu=relu,
            inv_out_scale=inv_out_scale)
    name = "conv3x3_int8_requant"
    if cin % 32:
        raise ValueError(f"{name}: Cin={cin} is not a multiple of 32")
    f32 = torch.float32
    scale = scale.to(f32).contiguous()
    shift = shift.to(f32).contiguous()
    tensors = [x_q, w_q, scale, shift]
    dtypes = [torch.int8, torch.int8, f32, f32]
    if res is not None:
        res = res.to(torch.bfloat16).contiguous()
        if tuple(res.shape) != (cout, n):
            raise ValueError(f"{name}: res {tuple(res.shape)} vs "
                             f"{(cout, n)}")
        tensors.append(res)
        dtypes.append(torch.bfloat16)
    sb = tb = None
    if dual is not None:
        sb, tb = (v.to(f32).contiguous() for v in dual)
        tensors += [sb, tb]
        dtypes += [f32, f32]
    require_cuda(name, tensors, dtypes)
    out_int8 = inv_out_scale is not None
    out = torch.empty((cout, n), device=x_q.device,
                      dtype=torch.int8 if out_int8 else torch.bfloat16)
    out2 = (torch.empty((cout, n), dtype=torch.int8, device=x_q.device)
            if dual is not None else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    rc = _library().conv3x3_int8_requant_launch(
        x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        ptr(res), ptr(sb), ptr(tb), out.data_ptr(), ptr(out2), cin, cout, n,
        h, w_img, int(relu), int(out_int8),
        float(inv_out_scale) if out_int8 else 0.0, stream)
    check_rc(name, rc)
    launches[name] += 1
    launch_shapes[(name, cin, cout, n,
                   _requant_mode(res, dual, inv_out_scale))] += 1
    return out if out2 is None else (out, out2)
