"""Stride-1 SAME 3x3 convolutions in the channel-major layout [C, B*H*W].

Counterpart of ``pytorch_ddp_resnet_tpu/ops/pallas/conv.py``: the same
public layout (x ``[Cin, N]`` with ``N = B*H*W`` image-major, packed
weights ``[Cout, 9*Cin]``, taps row-major in (dh, dw) then input channel),
so the tests compare like with like.

- ``conv3x3_bf16``: bf16 in, f32 accumulate, bf16 out (the float
  calibration pass of int8 serving, and ``conv3x3_same``'s forward and
  input gradient). Replaces ``conv3x3_lanes``. Two launches on the card
  (``csrc/conv3x3_wgmma_bf16.cuh``): ``conv3x3_bf16_pre`` copies x into
  the fused bf16 forward's padded position-major slab
  (``conv3x3_bf16_plan``), then ``conv3x3_bf16_gemm`` runs that forward's
  wgmma mainloop with a plain bf16 epilogue; any image width, N and Cout
  (``check_conv3x3_bf16_geometry``).
- ``conv3x3_int8_requant``: s8 x s8 -> s32 with the requantization
  epilogue fused in. Replaces ``conv3x3_lanes_requant``. Two launches on
  the card (``csrc/requant_wgmma_s8.cuh``): ``conv3x3_int8_requant_pre``
  lays x_q's codes into the fused int8 forward's padded position-major slab
  (``requant_plan``), then ``conv3x3_int8_requant_gemm`` runs that
  forward's TMA-fed s8 wgmma mainloop with a requantizing epilogue; any
  image width and N (``check_requant_geometry``).
- ``conv3x3_wgrad``: the weight gradient of the bf16 conv, dW [3, 3,
  Cin, Cout] (HWIO) = patches(x) @ dy^T in f32 (kernel in
  ``csrc/conv3x3_wgrad.cu`` on ``csrc/wgrad_wgmma_bf16.cuh``: TMA reads x
  and dy in place into a wgmma mainloop). Replaces
  ``conv3x3_wgrad_lanes``.
- ``conv3x3_same``: the differentiable stride-1 SAME 3x3 conv of the
  ``use_pallas_conv`` flag, NHWC x OIHW -> NHWC: forward and input
  gradient on ``conv3x3_bf16``, weight gradient on ``conv3x3_wgrad``.
  Counterpart of the JAX ``conv3x3_same`` (custom VJP).

Each wrapper dispatches on the device of its input: a CPU tensor goes to
the plain PyTorch version beside it; a CUDA tensor launches the kernels in
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
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from pytorch_ddp_resnet_tpu_torch.ops.cuda.checks import (
    check_rc,
    on_cpu,
    require_cuda,
)
from pytorch_ddp_resnet_tpu_torch.ops.cuda.wgrad_plan import split_plan

launches: collections.Counter = collections.Counter()
launch_shapes: collections.Counter = collections.Counter()
same_calls: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    launches.clear()
    launch_shapes.clear()
    same_calls.clear()


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


def pack_weights_dgrad(w: torch.Tensor) -> torch.Tensor:
    """An OIHW 3x3 kernel packed for the input gradient (rot180, in/out
    swapped: w'[ci, (dh, dw, co)] = w[co, ci, 2-dh, 2-dw]): [Cin, 9*Cout].
    The input gradient is then the forward conv of dy with it (JAX
    ``pack_weights_dgrad``)."""
    return pack_weights(w.flip(2, 3).transpose(0, 1))


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


def conv3x3_bf16_plan(n: int, h: int, w_img: int, cin: int, cout: int):
    """The bf16 conv's slab layout and GEMM walk: the fused bf16 forward's
    (``fused_block.fused_fwd_layout``: every tap one slab row offset, 128
    M rows a tile, BN = 160 where Cout % 160 == 0, else 128, or 64 up to
    Cout = 64). Cached there."""
    from pytorch_ddp_resnet_tpu_torch.ops.cuda.fused_block import (
        fused_fwd_layout,
    )

    return fused_fwd_layout(n, h, w_img, cin, cout)


def conv3x3_bf16_pre_plain(x_cs, *, lay) -> torch.Tensor:
    """Plain version of ``conv3x3_bf16_pre``: the slab [slab_len, Cin] of
    layout ``lay`` in x's dtype, x's values at each pixel's position, zeros
    at every pad position."""
    from pytorch_ddp_resnet_tpu_torch.ops.cuda.fused_block import _to_slab

    return _to_slab(x_cs, lay)


def conv3x3_bf16_gemm_plain(slab, w_packed, *, lay) -> torch.Tensor:
    """Plain version of ``conv3x3_bf16_gemm``: each tap's shifted slab rows
    at the live rows contracted with its packed weights in float64, rounded
    to f32, then to the slab's dtype."""
    from pytorch_ddp_resnet_tpu_torch.ops.cuda.fused_block import (
        _slab_conv_f64,
    )

    return _slab_conv_f64(slab, w_packed, lay).to(torch.float32).to(
        slab.dtype)


def conv3x3_s32_plain(x_q, w_q, *, h: int, w_img: int) -> torch.Tensor:
    """The int8 conv's exact s32 accumulator."""
    _shapes(x_q, w_q, h, w_img)
    return _conv_f64(x_q, w_q, h, w_img).to(torch.int32)


def quant_s8(v: torch.Tensor) -> torch.Tensor:
    """clip(round(v), -127, 127) as int8; torch.round is half to even, as
    jnp.round."""
    return torch.clamp(torch.round(v), -127.0, 127.0).to(torch.int8)


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32(a*b + c) rounded once, as the reference's ``a * b + c`` is
    contracted into one FMA: the f32 operands' product is exact in
    float64."""
    f32, f64 = torch.float32, torch.float64
    return (a.to(f32).to(f64) * torch.as_tensor(b).to(f32).to(f64)
            + torch.as_tensor(c).to(f32).to(f64)).to(f32)


def requant_epilogue(acc, scale, shift, res=None, dual=None, *,
                     relu: bool = False,
                     inv_out_scale: Optional[float] = None):
    """The int8 convs' epilogue on an s32 accumulator [Cout, N] in f32, at
    the reference's rounding points (its kernels as XLA computes them):
    ``acc * scale + shift`` and the dual ``y * sb + tb`` are each one
    fused multiply-add, the residual add and the output scaling round on
    their own."""
    f32 = torch.float32
    y = fma_f32(acc.to(f32), scale[:, None], shift[:, None])
    if res is not None:
        y = y + res.to(torch.bfloat16).to(f32)
    if relu:
        y = torch.clamp_min(y, 0.0)
    out = (quant_s8(y * float(inv_out_scale))
           if inv_out_scale is not None else y.to(torch.bfloat16))
    if dual is None:
        return out
    sb, tb = dual
    return out, quant_s8(torch.clamp_min(
        fma_f32(y, sb[:, None], tb[:, None]), 0.0))


def conv3x3_int8_requant_plain(x_q, w_q, scale, shift, res=None, dual=None,
                               *, h: int, w_img: int, relu: bool = False,
                               inv_out_scale: Optional[float] = None):
    """Plain version of ``conv3x3_int8_requant``."""
    if dual is not None and inv_out_scale is not None:
        raise ValueError("dual output requires the bf16-carrier mode")
    acc = conv3x3_s32_plain(x_q, w_q, h=h, w_img=w_img)
    return requant_epilogue(acc, scale, shift, res, dual, relu=relu,
                            inv_out_scale=inv_out_scale)


REQUANT_BM = 128  # M rows a tile (csrc/fwd_wgmma_s8.cuh BM)


def check_requant_geometry(name: str, cin: int, cout: int, n: int, h: int,
                           w_img: int) -> None:
    """The int8 conv's own shape needs on the card: Cin a positive multiple
    of 32 (32-byte K steps), whole images, and the slab's rows and the
    grid's blocks within 32-bit indices; any Cout, any image width, any N
    (each channel's run of lanes is written from its own 16-byte
    alignment)."""
    if cin < 32 or cin % 32:
        raise ValueError(f"{name}: Cin={cin} is not a multiple of 32")
    if cout < 1:
        raise ValueError(f"{name}: Cout={cout}")
    if h < 1 or w_img < 1 or n < 1 or n % (h * w_img):
        raise ValueError(f"{name}: geometry H={h} W={w_img} N={n} is not "
                         "whole images")
    per_img = (h + 1) * (w_img + 1)
    tiles = -(-(n // (h * w_img)) * per_img // REQUANT_BM)
    if (tiles * REQUANT_BM + 2 * (w_img + 2) >= 2 ** 31
            or tiles * -(-cout // 64) >= 2 ** 31):
        raise ValueError(f"{name}: N={n} at H={h} W={w_img}, Cout={cout}: "
                         f"{tiles} M tiles exceed 32-bit indices")


def check_conv3x3_bf16_geometry(name: str, cin: int, cout: int, n: int,
                                h: int, w_img: int) -> None:
    """The bf16 conv's own shape needs on the card: the int8 conv's
    (``check_requant_geometry``; its Cin % 32 here for the slab copy's
    32-channel tiles), as both run a prepass into the padded slab and a
    GEMM on a one-dimensional grid of 128-row M tiles by N tiles of at
    least 64. Every shape the bf16 conv took before it ran on the slab
    passes."""
    check_requant_geometry(name, cin, cout, n, h, w_img)


def requant_plan(n: int, h: int, w_img: int, cin: int, cout: int):
    """The int8 conv's slab layout and GEMM walk: the fused int8 forward's
    (``fused_block.fused_fwd_int8_plan``: one byte a channel, every tap one
    slab row offset, TMA boxes of 128, 64 and 32 bytes a tap, BN = 160
    where Cout % 160 == 0, else 128 or 64). Cached there."""
    from pytorch_ddp_resnet_tpu_torch.ops.cuda.fused_block import (
        fused_fwd_int8_plan,
    )

    return fused_fwd_int8_plan(n, h, w_img, cin, cout)


def conv3x3_int8_requant_pre_plain(x_q, *, plan) -> torch.Tensor:
    """Plain version of ``conv3x3_int8_requant_pre``: the slab
    [slab_len, Cin] int8 of ``plan``'s layout, x_q's codes at each pixel's
    position, zeros at every pad position."""
    from pytorch_ddp_resnet_tpu_torch.ops.cuda.fused_block import _to_slab

    return _to_slab(x_q, plan.lay)


def conv3x3_int8_requant_gemm_plain(slab, w_q, scale, shift, res=None,
                                    dual=None, *, plan, relu: bool = False,
                                    inv_out_scale: Optional[float] = None):
    """Plain version of ``conv3x3_int8_requant_gemm``: the exact s32
    contraction of each tap's shifted slab rows with its packed weights at
    the live rows, then ``requant_epilogue``."""
    from pytorch_ddp_resnet_tpu_torch.ops.cuda.fused_block import (
        _slab_conv_f64,
    )

    if dual is not None and inv_out_scale is not None:
        raise ValueError("dual output requires the bf16-carrier mode")
    acc = _slab_conv_f64(slab, w_q, plan.lay).to(torch.int32)
    return requant_epilogue(acc, scale, shift, res, dual, relu=relu,
                            inv_out_scale=inv_out_scale)


def patches_f64(q: torch.Tensor, h: int, w_img: int) -> torch.Tensor:
    """[C, T] whole images -> the 3x3 SAME patch matrix [9*C, T] in
    float64, rows in (dh, dw, c) order."""
    c, t = q.shape
    b = t // (h * w_img)
    img = q.to(torch.float64).reshape(c, b, h, w_img).transpose(0, 1)
    cols = F.unfold(img, 3, padding=1)              # [b, c*9, h*w]
    cols = cols.reshape(b, c, 9, h * w_img).permute(2, 1, 0, 3)
    return cols.reshape(9 * c, t)


def _wgrad_shapes(x_cs, dy_cs, h: int, w_img: int) -> Tuple[int, int, int]:
    cin, n = x_cs.shape
    cout = dy_cs.shape[0]
    if n % (h * w_img) != 0 or dy_cs.shape[1] != n:
        raise ValueError(f"bad shapes x={tuple(x_cs.shape)} "
                         f"dy={tuple(dy_cs.shape)}")
    return cin, cout, n


def conv3x3_wgrad_plain(x_cs, dy_cs, *, h: int, w_img: int) -> torch.Tensor:
    """Plain version of ``conv3x3_wgrad``: the float64 sum over every
    position, returned as f32 [3, 3, Cin, Cout] (HWIO)."""
    cin, cout, _ = _wgrad_shapes(x_cs, dy_cs, h, w_img)
    dw = patches_f64(x_cs, h, w_img) @ dy_cs.to(torch.float64).T
    return dw.to(torch.float32).reshape(3, 3, cin, cout)


# --- kernels -------------------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from pytorch_ddp_resnet_tpu_torch.ops.cuda import build

        lib = build.load("conv3x3")
        lib.conv3x3_bf16_pre_launch.argtypes = [
            _P, _P, _I, _I, _I, _I, ctypes.c_long, _P]
        lib.conv3x3_bf16_pre_launch.restype = _I
        lib.conv3x3_bf16_gemm_launch.argtypes = [
            _P, _P, _P] + [_I] * 5 + [ctypes.c_long, _I, _I, _P]
        lib.conv3x3_bf16_gemm_launch.restype = _I
        lib.conv3x3_int8_requant_pre_launch.argtypes = [
            _P, _P, _I, _I, _I, _I, ctypes.c_long, _P]
        lib.conv3x3_int8_requant_pre_launch.restype = _I
        lib.conv3x3_int8_requant_gemm_launch.argtypes = [
            _P] * 9 + [_I] * 5 + [ctypes.c_long] + [_I] * 4 + [
            ctypes.c_float, _P]
        lib.conv3x3_int8_requant_gemm_launch.restype = _I
        _lib = lib
    return _lib


BF16 = "conv3x3_bf16"


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _bf16_pre_launch(x_cs, lay) -> torch.Tensor:
    """``conv3x3_bf16_pre``'s launch on an operand already checked."""
    name = f"{BF16}.pre"
    slab = torch.empty((lay.slab_len, lay.cin), dtype=torch.bfloat16,
                       device=x_cs.device)
    check_rc(name, _library().conv3x3_bf16_pre_launch(
        x_cs.data_ptr(), slab.data_ptr(), lay.cin, lay.n, lay.h, lay.w,
        lay.slab_len, _stream(x_cs)))
    launches[name] += 1
    launch_shapes[(name, lay.cin, lay.cout, lay.n, "")] += 1
    return slab


def _bf16_gemm_launch(slab, w_packed, lay) -> torch.Tensor:
    """``conv3x3_bf16_gemm``'s launch on operands already checked."""
    out = torch.empty((lay.cout, lay.n), dtype=torch.bfloat16,
                      device=slab.device)
    check_rc(BF16, _library().conv3x3_bf16_gemm_launch(
        slab.data_ptr(), w_packed.data_ptr(), out.data_ptr(), lay.cin,
        lay.cout, lay.n, lay.h, lay.w, lay.slab_len, lay.tiles, lay.bn,
        _stream(slab)))
    launches[BF16] += 1
    launch_shapes[(BF16, lay.cin, lay.cout, lay.n, "bf16")] += 1
    return out


def conv3x3_bf16_pre(x_cs, *, lay) -> torch.Tensor:
    """The bf16 conv's prepass: x [Cin, N] copied, unchanged, into the slab
    [slab_len, Cin] of layout ``lay`` (``conv3x3_bf16_plan``), each pixel
    at its position, zeros at every pad position. One launch."""
    if tuple(x_cs.shape) != (lay.cin, lay.n):
        raise ValueError(f"{BF16}.pre: x {tuple(x_cs.shape)} vs the layout "
                         f"{lay}")
    if on_cpu(x_cs):
        return conv3x3_bf16_pre_plain(x_cs, lay=lay)
    check_conv3x3_bf16_geometry(f"{BF16}.pre", lay.cin, lay.cout, lay.n,
                                lay.h, lay.w)
    require_cuda(f"{BF16}.pre", [x_cs], [torch.bfloat16])
    return _bf16_pre_launch(x_cs, lay)


def conv3x3_bf16_gemm(slab, w_packed, *, lay) -> torch.Tensor:
    """The bf16 conv's GEMM from the slab of layout ``lay``: the f32
    contraction over (tap, channel) on wgmma, y = bf16(acc) written
    channel-major [Cout, N]. One launch."""
    if tuple(slab.shape) != (lay.slab_len, lay.cin):
        raise ValueError(f"{BF16}: slab {tuple(slab.shape)} is not of the "
                         f"layout {lay}")
    if tuple(w_packed.shape) != (lay.cout, 9 * lay.cin):
        raise ValueError(f"{BF16}: weights {tuple(w_packed.shape)} vs Cin "
                         f"{lay.cin}, Cout {lay.cout}")
    if on_cpu(slab):
        return conv3x3_bf16_gemm_plain(slab, w_packed, lay=lay)
    check_conv3x3_bf16_geometry(BF16, lay.cin, lay.cout, lay.n, lay.h,
                                lay.w)
    require_cuda(BF16, [slab, w_packed], [torch.bfloat16] * 2)
    return _bf16_gemm_launch(slab, w_packed, lay)


def conv3x3_bf16(x_cs, w_packed, *, h: int, w_img: int) -> torch.Tensor:
    """Stride-1 SAME 3x3 conv, x [Cin, N] x w [Cout, 9*Cin] -> [Cout, N].
    On the card: bf16 only, the geometry of
    ``check_conv3x3_bf16_geometry``; the prepass, then the GEMM (two
    launches)."""
    cin, cout, n = _shapes(x_cs, w_packed, h, w_img)
    if on_cpu(x_cs):
        return conv3x3_bf16_plain(x_cs, w_packed, h=h, w_img=w_img)
    require_cuda(BF16, [x_cs, w_packed], [torch.bfloat16] * 2)
    check_conv3x3_bf16_geometry(BF16, cin, cout, n, h, w_img)
    lay = conv3x3_bf16_plan(n, h, w_img, cin, cout)
    return _bf16_gemm_launch(_bf16_pre_launch(x_cs, lay), w_packed, lay)


def _requant_mode(res, dual, inv_out_scale) -> str:
    """Epilogue mode label: int8 out, bf16 out, +res, dual."""
    mode = "int8" if inv_out_scale is not None else "bf16"
    if res is not None:
        mode += "+res"
    if dual is not None:
        mode += "+dual"
    return mode


REQUANT = "conv3x3_int8_requant"


def _requant_operands(name, w_q, scale, shift, res, dual, lay):
    """The GEMM's operands checked against the layout, as the kernel reads
    them: (tensors, dtypes, scale, shift, res, sb, tb)."""
    if tuple(w_q.shape) != (lay.cout, 9 * lay.cin):
        raise ValueError(f"{name}: weights {tuple(w_q.shape)} vs Cin "
                         f"{lay.cin}, Cout {lay.cout}")
    f32 = torch.float32
    scale = scale.to(f32).contiguous()
    shift = shift.to(f32).contiguous()
    tensors = [w_q, scale, shift]
    dtypes = [torch.int8, f32, f32]
    if tuple(scale.shape) != (lay.cout,) or tuple(shift.shape) != (
            lay.cout,):
        raise ValueError(f"{name}: scale {tuple(scale.shape)}, shift "
                         f"{tuple(shift.shape)} vs Cout {lay.cout}")
    if res is not None:
        res = res.to(torch.bfloat16).contiguous()
        if tuple(res.shape) != (lay.cout, lay.n):
            raise ValueError(f"{name}: res {tuple(res.shape)} vs "
                             f"{(lay.cout, lay.n)}")
        tensors.append(res)
        dtypes.append(torch.bfloat16)
    sb = tb = None
    if dual is not None:
        sb, tb = (v.to(f32).contiguous() for v in dual)
        if tuple(sb.shape) != (lay.cout,) or tuple(tb.shape) != (lay.cout,):
            raise ValueError(f"{name}: dual {tuple(sb.shape)}, "
                             f"{tuple(tb.shape)} vs Cout {lay.cout}")
        tensors += [sb, tb]
        dtypes += [f32, f32]
    return tensors, dtypes, scale, shift, res, sb, tb


def _pre_launch(x_q, lay) -> torch.Tensor:
    """``conv3x3_int8_requant_pre``'s launch on an operand already
    checked."""
    name = f"{REQUANT}.pre"
    slab = torch.empty((lay.slab_len, lay.cin), dtype=torch.int8,
                       device=x_q.device)
    check_rc(name, _library().conv3x3_int8_requant_pre_launch(
        x_q.data_ptr(), slab.data_ptr(), lay.cin, lay.n, lay.h, lay.w,
        lay.slab_len, _stream(x_q)))
    launches[name] += 1
    launch_shapes[(name, lay.cin, lay.cout, lay.n, "")] += 1
    return slab


def _gemm_launch(slab, w_q, scale, shift, res, sb, tb, plan, relu,
                 inv_out_scale):
    """``conv3x3_int8_requant_gemm``'s launch on operands already
    checked."""
    lay = plan.lay
    out_int8 = inv_out_scale is not None
    dev = slab.device
    out = torch.empty((lay.cout, lay.n), device=dev,
                      dtype=torch.int8 if out_int8 else torch.bfloat16)
    out2 = (torch.empty((lay.cout, lay.n), dtype=torch.int8, device=dev)
            if sb is not None else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    check_rc(REQUANT, _library().conv3x3_int8_requant_gemm_launch(
        slab.data_ptr(), w_q.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        ptr(res), ptr(sb), ptr(tb), out.data_ptr(), ptr(out2), lay.cin,
        lay.cout, lay.n, lay.h, lay.w, lay.slab_len, lay.tiles, plan.bn,
        int(relu), int(out_int8),
        float(inv_out_scale) if out_int8 else 0.0, _stream(slab)))
    launches[REQUANT] += 1
    mode = _requant_mode(res, None if sb is None else (sb, tb),
                         inv_out_scale)
    launch_shapes[(REQUANT, lay.cin, lay.cout, lay.n, mode)] += 1
    return out if out2 is None else (out, out2)


def conv3x3_int8_requant_pre(x_q, *, plan) -> torch.Tensor:
    """The int8 conv's prepass: x_q [Cin, N] int8 copied, unchanged, into
    the slab [slab_len, Cin] of ``plan``'s layout (``requant_plan``), each
    pixel at its position, zeros at every pad position. One launch."""
    lay = plan.lay
    if tuple(x_q.shape) != (lay.cin, lay.n):
        raise ValueError(f"{REQUANT}.pre: x_q {tuple(x_q.shape)} vs the "
                         f"layout {lay}")
    if on_cpu(x_q):
        return conv3x3_int8_requant_pre_plain(x_q, plan=plan)
    check_requant_geometry(f"{REQUANT}.pre", lay.cin, lay.cout, lay.n,
                           lay.h, lay.w)
    require_cuda(f"{REQUANT}.pre", [x_q], [torch.int8])
    return _pre_launch(x_q, lay)


def conv3x3_int8_requant_gemm(slab, w_q, scale, shift, res=None, dual=None,
                              *, plan, relu: bool = False,
                              inv_out_scale: Optional[float] = None):
    """The int8 conv's GEMM from the slab of ``plan``'s layout: the exact
    s32 contraction over (tap, channel) on s8 wgmma, then the
    requantization epilogue (``requant_epilogue``) in registers, out (and
    out2) written channel-major. One launch."""
    lay = plan.lay
    if dual is not None and inv_out_scale is not None:
        raise ValueError("dual output requires the bf16-carrier mode")
    if tuple(slab.shape) != (lay.slab_len, lay.cin):
        raise ValueError(f"{REQUANT}: slab {tuple(slab.shape)} is not of "
                         f"the layout {lay}")
    if on_cpu(slab):
        return conv3x3_int8_requant_gemm_plain(
            slab, w_q, scale, shift, res, dual, plan=plan, relu=relu,
            inv_out_scale=inv_out_scale)
    check_requant_geometry(REQUANT, lay.cin, lay.cout, lay.n, lay.h, lay.w)
    tensors, dtypes, scale, shift, res, sb, tb = _requant_operands(
        REQUANT, w_q, scale, shift, res, dual, lay)
    require_cuda(REQUANT, [slab] + tensors, [torch.int8] + dtypes)
    return _gemm_launch(slab, w_q, scale, shift, res, sb, tb, plan, relu,
                        inv_out_scale)


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
    Returns out, or (out, out2) in dual mode (bf16-carrier mode only).
    On the card: the prepass, then the GEMM (two launches)."""
    cin, cout, n = _shapes(x_q, w_q, h, w_img)
    if dual is not None and inv_out_scale is not None:
        raise ValueError("dual output requires the bf16-carrier mode")
    if on_cpu(x_q):
        return conv3x3_int8_requant_plain(
            x_q, w_q, scale, shift, res, dual, h=h, w_img=w_img, relu=relu,
            inv_out_scale=inv_out_scale)
    check_requant_geometry(REQUANT, cin, cout, n, h, w_img)
    plan = requant_plan(n, h, w_img, cin, cout)
    tensors, dtypes, scale, shift, res, sb, tb = _requant_operands(
        REQUANT, w_q, scale, shift, res, dual, plan.lay)
    require_cuda(REQUANT, [x_q] + tensors, [torch.int8] + dtypes)
    slab = _pre_launch(x_q, plan.lay)
    return _gemm_launch(slab, w_q, scale, shift, res, sb, tb, plan, relu,
                        inv_out_scale)


# --- the weight gradient ------------------------------------------------------

WG_BK = 64      # positions a K step (csrc/wgrad_wgmma_bf16.cuh BK)
WG_PIECE = 32   # input channels a staged box of x (PIECE)
WG_SLOTS = 132  # blocks in flight: one an SM of an H100

_lib_wgrad: Optional[ctypes.CDLL] = None


def _library_wgrad() -> ctypes.CDLL:
    global _lib_wgrad
    if _lib_wgrad is None:
        from pytorch_ddp_resnet_tpu_torch.ops.cuda import build

        lib = build.load("conv3x3_wgrad")
        lib.conv3x3_wgrad_launch.argtypes = [_P, _P, _P] + [_I] * 8 + [_P]
        lib.conv3x3_wgrad_launch.restype = _I
        lib.partial_sum_launch.argtypes = [_P, _P, _I, _I, _P]
        lib.partial_sum_launch.restype = _I
        lib.conv3x3_wgrad_probe_launch.argtypes = [_P, _P] + [_I] * 10 + [_P]
        lib.conv3x3_wgrad_probe_launch.restype = _I
        _lib_wgrad = lib
    return _lib_wgrad


def check_wgrad_geometry(name: str, cin: int, n: int, h: int,
                         w_img: int) -> None:
    """``conv3x3_wgrad``'s own shape needs (csrc/wgrad_wgmma_bf16.cuh): the
    input channels in 32-channel boxes, and each 64-position K step inside
    one image as whole rows (W = 8, 16 or 32 with H a multiple of 64 / W)
    or as 64 columns of one row (W a multiple of 64), which also gives TMA
    its 16-byte strides (2W, 2HW, 2N bytes)."""
    if cin % WG_PIECE:
        raise ValueError(f"{name}: Cin={cin} is not a multiple of 32")
    hw = h * w_img
    rows = w_img in (8, 16, 32) and h % (WG_BK // w_img) == 0
    if n % hw or not (rows or (w_img > 0 and w_img % WG_BK == 0)):
        raise ValueError(
            f"{name}: N={n} / image {h}x{w_img} is off the TMA reads' "
            f"geometry (W of 8, 16 or 32 with H a multiple of 64 / W, or W "
            f"a multiple of 64)")


class WgradTmaPlan(NamedTuple):
    """How ``conv3x3_wgrad``'s kernel cuts dW [9*Cin, Cout] and the
    positions: ``m_tiles`` x ``n_tiles`` tiles of 128 x ``bn``; ``steps``
    K steps of 64 positions cut into ``splits`` runs of ``per`` (the last
    may be shorter, none empty)."""
    bn: int
    m_tiles: int
    n_tiles: int
    steps: int
    per: int
    splits: int


@functools.lru_cache(maxsize=None)
def wgrad_tma_plan(cin: int, cout: int, n: int, h: int, w_img: int,
                   taps: int = 9) -> WgradTmaPlan:
    """``conv3x3_wgrad``'s tiles and splits (and the lane transition's,
    ``transition.wgrad_tma_plan``, whose dWp has one tap): dW [taps * Cin,
    Cout] in tiles of 128 x BN, BN = 160 where Cout % 160 == 0, else 128,
    or 64 up to Cout = 64 (the fused forward's rule,
    csrc/fwd_wgmma_bf16.cuh); the splits of the K steps by the staged
    wgrads' cost model of waves of blocks (``wgrad_plan.split_plan``), at
    one block an SM. Cached: every call of the wgrad asks."""
    check_wgrad_geometry("wgrad_tma_plan", cin, n, h, w_img)
    bn = 160 if cout % 160 == 0 else (128 if cout > 64 else 64)
    sp = split_plan(taps * cin, cout, 1, n // WG_BK, WG_BK, bn=bn,
                    slots=WG_SLOTS)
    return WgradTmaPlan(bn, sp.m_tiles, sp.n_tiles, sp.steps, sp.per,
                        sp.splits)


def conv3x3_wgrad(x_cs, dy_cs, *, h: int, w_img: int) -> torch.Tensor:
    """Weight gradient of the stride-1 SAME 3x3 conv: x [Cin, N], dy [Cout,
    N] (N = B*H*W, whole images) -> dW [3, 3, Cin, Cout] f32 (HWIO, as
    JAX's ``conv3x3_wgrad_lanes`` returns it). On the card: bf16 operands,
    Cout a multiple of 8, the geometry of ``check_wgrad_geometry``; one
    launch of the TMA + wgmma kernel over ``wgrad_tma_plan``'s splits and
    one ordered sum of the splits (``conv3x3_wgrad.sum``)."""
    cin, cout, n = _wgrad_shapes(x_cs, dy_cs, h, w_img)
    if on_cpu(x_cs):
        return conv3x3_wgrad_plain(x_cs, dy_cs, h=h, w_img=w_img)
    name = "conv3x3_wgrad"
    require_cuda(name, [x_cs, dy_cs], [torch.bfloat16] * 2)
    check_wgrad_geometry(name, cin, n, h, w_img)
    if cout % 8:
        raise ValueError(f"{name}: Cout={cout} is not a multiple of 8")
    plan = wgrad_tma_plan(cin, cout, n, h, w_img)
    dev = x_cs.device
    m = 9 * cin * cout
    part = torch.empty((plan.splits, m), dtype=torch.float32, device=dev)
    out = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _library_wgrad()
    check_rc(name, lib.conv3x3_wgrad_launch(
        x_cs.data_ptr(), dy_cs.data_ptr(), part.data_ptr(), cin, cout, n, h,
        w_img, plan.bn, plan.per, plan.splits, stream))
    launches[name] += 1
    launch_shapes[(name, cin, cout, n, "bf16")] += 1
    check_rc(f"{name}.sum", lib.partial_sum_launch(
        part.data_ptr(), out.data_ptr(), plan.splits, m, stream))
    launches[f"{name}.sum"] += 1
    return out


def tma_box_probe(t, *, h: int, w_img: int, dy: bool, at: Tuple[int, int],
                  bn: int = 64, plane: int = 0) -> Tuple[torch.Tensor, bool]:
    """One TMA load of t [C, N] bf16 (h x w_img images; for x's map also
    [planes, C, N], as the lane transition's wgrad reads its parity
    planes) through the map ``conv3x3_wgrad``'s kernel (csrc/
    wgrad_wgmma_bf16.cuh) reads x with (``dy`` False: positions from
    ``at[0]`` of image ``at[1]`` of plane ``plane``, channels 0-31; 64
    positions, 80 where W >= 64, unswizzled) or dy with (``dy`` True: 64
    positions from ``at[0]`` of ``bn`` channels from ``at[1]``, in the
    128-byte swizzle), into 1024-byte-aligned, zeroed shared memory: the
    box's bytes as they landed (uint8 on t's card), and whether they
    completed the barrier's transaction (the wait is bounded). No part of
    the gradient: the card tests hold the layouts to the ones the mainloop
    assumes."""
    name = "conv3x3_wgrad.probe"
    require_cuda(name, [t], [torch.bfloat16])
    planes, c, n = (1, *t.shape) if t.dim() == 2 else t.shape
    if dy and planes != 1:
        raise ValueError(f"{name}: dy's map takes [C, N]")
    if at[0] % 8:
        raise ValueError(f"{name}: position {at[0]} is not a multiple of 8 "
                         f"(TMA's 16 bytes)")
    xpos = WG_BK if w_img < WG_BK else WG_BK + 16
    nbytes = 2 * (WG_BK * bn if dy else xpos * WG_PIECE)
    out = torch.empty(nbytes + 1, dtype=torch.uint8, device=t.device)
    stream = torch.cuda.current_stream(t.device).cuda_stream
    check_rc(name, _library_wgrad().conv3x3_wgrad_probe_launch(
        t.data_ptr(), out.data_ptr(), planes, c, n, h, w_img, int(dy), bn,
        at[0], at[1], plane, stream))
    launches[name] += 1
    return out[:nbytes], bool(out[nbytes].item())


# --- the differentiable conv of ``use_pallas_conv`` ----------------------------

def nhwc_to_lanes(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [C, B*H*W], contiguous."""
    b, h, w, c = x.shape
    return x.permute(3, 0, 1, 2).reshape(c, b * h * w).contiguous()


def lanes_to_nhwc(y_cs: torch.Tensor, b: int, h: int, w: int):
    """[C, B*H*W] -> a [B, H, W, C] view."""
    return y_cs.reshape(y_cs.shape[0], b, h, w).permute(1, 2, 3, 0)


def pad_rows(t: torch.Tensor, extra: int) -> torch.Tensor:
    """``t`` with ``extra`` zero rows appended on dim 0."""
    return F.pad(t, (0, 0) * (t.dim() - 1) + (0, extra)) if extra else t


class _Conv3x3Same(torch.autograd.Function):
    """NHWC x, OIHW w (both in one dtype) -> NHWC y. Widths run zero-padded
    to multiples of 32 (the kernels contract in 32-channel chunks): zero
    channels add nothing and are sliced off again, so the result is
    exact."""

    @staticmethod
    def forward(ctx, x, w):
        b, h, w_img, cin = x.shape
        cout = w.shape[0]
        w_p = F.pad(w, (0, 0, 0, 0, 0, -cin % 32, 0, -cout % 32))
        x_cs = pad_rows(nhwc_to_lanes(x), -cin % 32)
        y = conv3x3_bf16(x_cs, pack_weights(w_p), h=h, w_img=w_img)
        # the lane-layout x is saved: the wgrad consumes it (JAX does so)
        ctx.save_for_backward(x_cs, w_p)
        ctx.dims = (b, h, w_img, cin, cout)
        same_calls["forward"] += 1
        return lanes_to_nhwc(y[:cout], b, h, w_img)

    @staticmethod
    def backward(ctx, dy):
        x_cs, w_p = ctx.saved_tensors
        b, h, w_img, cin, cout = ctx.dims
        dy_cs = pad_rows(nhwc_to_lanes(dy.to(x_cs.dtype)), -cout % 32)
        dx = conv3x3_bf16(dy_cs, pack_weights_dgrad(w_p), h=h, w_img=w_img)
        # HWIO -> OIHW, rounded to the weight's dtype as the reference's
        # VJP rounds it
        dw = conv3x3_wgrad(x_cs, dy_cs, h=h, w_img=w_img).permute(3, 2, 0, 1)
        same_calls["backward"] += 1
        return (lanes_to_nhwc(dx[:cin], b, h, w_img),
                dw[:cout, :cin].to(w_p.dtype))


def conv3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable stride-1 SAME 3x3 conv, x [B, H, W, Cin] (NHWC) and w
    [Cout, Cin, 3, 3] (OIHW) in one dtype -> y [B, H, W, Cout]: the
    forward and the input gradient on ``conv3x3_bf16`` (the input gradient
    with ``pack_weights_dgrad``), the weight gradient on ``conv3x3_wgrad``
    rounded to w's dtype. Takes the shapes the JAX kernel takes (its lane
    tile picker raises the same ``ValueError`` for the others); on the
    card only bfloat16."""
    b, h, w_img, cin = x.shape
    cout = w.shape[0]
    if tuple(w.shape) != (cout, cin, 3, 3):
        raise ValueError(f"conv3x3_same: weights {tuple(w.shape)} vs Cin "
                         f"{cin}")
    if x.dtype != w.dtype:
        raise ValueError(f"conv3x3_same: x is {x.dtype}, w is {w.dtype}")
    if not on_cpu(x) and x.dtype != torch.bfloat16:
        raise ValueError(f"conv3x3_same: the card kernels take bfloat16, "
                         f"not {x.dtype} (compute_dtype)")
    pick_tile(h * w_img, b * h * w_img, max(cin, cout))
    return _Conv3x3Same.apply(x, w)
