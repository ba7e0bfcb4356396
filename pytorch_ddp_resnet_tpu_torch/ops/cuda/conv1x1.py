"""Int8 1x1 convolution with the requantization epilogue in the
channel-major layout [C, B*H*W] (counterpart of
``pytorch_ddp_resnet_tpu/ops/pallas/conv1x1.py``).

A 1x1 conv in this layout is one matrix product, out[Cout, N] = W[Cout,
Cin] @ x[Cin, N], s8 x s8 -> s32, followed by the epilogue of the 3x3
int8 serving conv (``conv3x3.conv3x3_int8_requant``): scale and shift,
the optional bf16 residual, the optional relu, then int8 at
``inv_out_scale`` or bf16, and in dual mode a second int8 output for the
next block. No model path of either package calls it; the JAX package
benchmarks it as a tested op, and so does the port.

``conv1x1_lanes_requant`` dispatches on the device of its input: a CPU
tensor goes to the plain PyTorch version beside it; a CUDA tensor launches
the kernel in ``csrc/conv1x1.cu`` (built at first use, ops/cuda/build.py)
or raises. ``launches`` counts kernel launches; plain calls count
nothing.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from pytorch_ddp_resnet_tpu_torch.ops.cuda.checks import (
    check_rc,
    on_cpu,
    require_cuda,
)
from pytorch_ddp_resnet_tpu_torch.ops.cuda.conv3x3 import (
    pad_rows,
    requant_epilogue,
)

launches: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    launches.clear()


def pick_tile_dense(n: int, c: int, max_tile: int = 2048) -> int:
    """Copy of the JAX package's lane-tile picker for tap-free kernels
    (ops/pallas/conv1x1.py ``pick_tile_dense``): a multiple of 128 that
    divides N, shrinking with the channel count. The card kernel tiles 128
    positions whatever the picker says; the wrapper calls it for its
    refusal, so both packages take the same shapes."""
    if n % 128 != 0:
        raise ValueError(f"N={n} is not a multiple of the 128-lane tile")
    target = max(128, min(max_tile, (512 * 2048) // max(c, 1)))
    t = 128
    while t * 2 <= target and n % (t * 2) == 0:
        t *= 2
    return t


def pack_weights_1x1(w_oihw: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin, 1, 1] -> [Cout, Cin], the kernel's matrix layout."""
    cout, cin, kh, kw = w_oihw.shape
    if (kh, kw) != (1, 1):
        raise ValueError("pack_weights_1x1 expects a 1x1 kernel.")
    return w_oihw.reshape(cout, cin).contiguous()


def _check(x_q, w_q, dual, inv_out_scale):
    """The reference's argument checks: (cin, cout, n)."""
    cin, n = x_q.shape
    cout, wcin = w_q.shape
    if wcin != cin:
        raise ValueError(f"weights {tuple(w_q.shape)} vs Cin {cin}")
    if dual is not None and inv_out_scale is not None:
        raise ValueError("dual output requires the bf16-carrier mode")
    pick_tile_dense(n, max(cin, cout))
    return cin, cout, n


def conv1x1_lanes_requant_plain(x_q, w_q, scale, shift, res=None, dual=None,
                                *, relu: bool = False,
                                inv_out_scale: Optional[float] = None):
    """Plain version of ``conv1x1_lanes_requant``: the exact s32 product
    (float64, where every such sum is exact), then the epilogue in f32 in
    the reference's order, each operation rounded on its own."""
    _check(x_q, w_q, dual, inv_out_scale)
    acc = (w_q.to(torch.float64) @ x_q.to(torch.float64)).to(torch.int32)
    return requant_epilogue(acc, scale, shift, res, dual, relu=relu,
                            inv_out_scale=inv_out_scale)


_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from pytorch_ddp_resnet_tpu_torch.ops.cuda import build

        lib = build.load("conv1x1")
        lib.conv1x1_requant_launch.argtypes = [_P] * 9 + [_I] * 5 + [
            ctypes.c_float, _P]
        lib.conv1x1_requant_launch.restype = _I
        _lib = lib
    return _lib


def conv1x1_lanes_requant(x_q, w_q, scale, shift, res=None, dual=None, *,
                          relu: bool = False,
                          inv_out_scale: Optional[float] = None):
    """Int8 1x1 conv with the requantization epilogue:

        y = (W @ x) * scale[Cout] + shift[Cout] (+ res)
        if relu: y = max(y, 0)
        out = s8(clip(round(y * inv_out_scale)))  or  bf16(y)
        out2 = s8(clip(round(max(y*sb + tb, 0))))       (dual=(sb, tb))

    x_q [Cin, N] int8 (N a multiple of 128), w_q [Cout, Cin] int8
    (``pack_weights_1x1``), scale/shift [Cout] f32, res [Cout, N] (cast to
    bf16), inv_out_scale a Python float or None. Returns out, or (out,
    out2) in dual mode (bf16-carrier mode only). On the card a Cin that is
    not a multiple of 32 runs zero-padded to the next one (exact)."""
    cin, cout, n = _check(x_q, w_q, dual, inv_out_scale)
    if on_cpu(x_q):
        return conv1x1_lanes_requant_plain(
            x_q, w_q, scale, shift, res, dual, relu=relu,
            inv_out_scale=inv_out_scale)
    name = "conv1x1_lanes_requant"
    pad = -cin % 32
    x_q, w_q = pad_rows(x_q, pad), F.pad(w_q, (0, pad))
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
    rc = _library().conv1x1_requant_launch(
        x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        ptr(res), ptr(sb), ptr(tb), out.data_ptr(), ptr(out2), cin + pad,
        cout, n, int(relu), int(out_int8),
        float(inv_out_scale) if out_int8 else 0.0, stream)
    check_rc(name, rc)
    launches[name] += 1
    return out if out2 is None else (out, out2)
