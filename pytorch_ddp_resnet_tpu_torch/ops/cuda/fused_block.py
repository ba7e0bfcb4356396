"""Fused preact block-half with an int8 conv core, forward and fully
quantized backward, in the channel-major layout [C, B*H*W] (counterpart of
``pytorch_ddp_resnet_tpu/ops/pallas/fused_block.py`` ``fused_half_int8``
with ``quant_bwd=True``).

One half computes, for x [Cin, N] (N = B*H*W image-major), the folded
BatchNorm affine (scale, shift) [Cin] f32, uint8 dropout bits [Cin, N] and
an optional residual [Cout, N]:

    d  = dropout(relu(x * scale + shift))             f32
    dq = s8(clip(rint(d * 127 / amax(group))))        per scale group
    y  = bf16(f32(conv3x3(dq, wq)) * ws * amax/127) (+ res, in bf16)
    ysum, yssq = per-channel f32 sums of y            (the next BN's stats)

A *scale group* is a run of whole images: ``lane_tile`` lanes in the
forward, ``bwd_tile`` lanes in the backward, copies of the JAX pickers.
The tile decides the numbers, so every kernel honours it whatever its own
blocking. The backward folds the stats cotangents into
``gf = dy + dysum + 2*y*dyssq``, quantizes it once per group (floor 1e-30)
and feeds the same int8 cotangent to the dgrad (against per-input-channel
int8 weights, with the relu/dropout masks recomputed from x) and to the
wgrad (against the recomputed activation, quantized per group). JAX fuses
the two into one TPU kernel where Cin <= 320 only to save TPU memory
reads; the function is the same on both of its routes.

Rounding points, as the reference computes them where the tests run it
(the JAX kernel in interpret mode, lowered by XLA on the CPU; pinned by
tests/test_torch_fused_block.py): ``x * scale + shift`` is one fused
multiply-add; the dropout keeps ``r * f32(256/thresh)`` (XLA rewrites the
kernel's division by the constant ``thresh/256`` as this multiply); the
stats fold ``(dy + dysum) + (2y) * dyssq`` is one fused multiply-add; the
quantizers, dequantizers and the bf16 residual add round each operation.

Layers of this module, each a CPU-or-card wrapper beside its plain version
(a CPU tensor runs the plain PyTorch version; a CUDA tensor launches the
kernel of ``csrc/fused_block.cu`` or raises):

- ``fwd_quantize``  (launches ``fused_half_fwd.amax``, ``.quant``)
- ``fwd_conv``      (launches ``fused_half_fwd``, ``.sum`` with stats)
- ``bwd_quantize``  (launches ``fused_half_bwd.amax``, ``.quant``)
- ``dgrad_conv``    (launches ``fused_half_dgrad``, ``.sum``)
- ``wgrad``         (launches ``fused_half_wgrad``, ``.sum``)

and ``fused_half_int8``, the differentiable op over them. ``launches``
counts each kernel launch by name; plain calls count nothing.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_ddp_resnet_tpu_torch.ops.cuda.checks import (
    check_rc,
    on_cpu,
    require_cuda,
)
from pytorch_ddp_resnet_tpu_torch.ops.cuda.conv3x3 import (
    _conv_f64,
    pack_weights,
    pick_tile,
)

launches: collections.Counter = collections.Counter()

# the reference's f32 constants (Python floats in JAX are weak-typed f32)
INV_127 = float(np.float32(1.0 / 127.0))
INV_16129 = float(np.float32(1.0 / (127.0 * 127.0)))
FWD_FLOOR = 1e-12   # absmax floor of the forward's activation groups
BWD_FLOOR = 1e-30   # ... and of the backward's cotangent/activation groups
KCHUNK = 256        # positions per wgrad staging chunk (csrc/fused_block.cu)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_F32 = torch.float32


def reset_launches() -> None:
    launches.clear()


def dropout_thresh(rate: float) -> int:
    """The uint8 keep threshold of the Dropout layer (keep iff bits <
    thresh), quantized to 1/256."""
    return int(round((1.0 - rate) * 256.0))


@functools.lru_cache(maxsize=None)
def inv_keep(thresh: int) -> float:
    """f32(256/thresh): the dropout's scale of a kept value (f32(1) over
    the exact f32 thresh/256, rounded once)."""
    return float(np.float32(1.0) / np.float32(thresh / 256.0))


def fold_bn(gamma, beta, mean, var, eps: float = 1e-5):
    """BatchNorm folded into per-channel f32 (scale, shift):
    x * scale + shift == (x - mean) * rsqrt(var + eps) * gamma + beta."""
    scale = torch.rsqrt(var.to(_F32) + eps) * gamma.to(_F32)
    shift = beta.to(_F32) - mean.to(_F32) * scale
    return scale, shift


# --- scale groups (copies of the JAX tile pickers) ----------------------------

def lane_tile(h: int, w_img: int, n: int, cin: int, cout: int) -> int:
    """Forward scale group in quant mode (JAX ``_lane_tile(..., quant=True)``):
    4096-lane groups up to 160 channels, the 2048 budget above."""
    c = max(cin, cout)
    big = c <= 160
    return pick_tile(h * w_img, n, c // 2 if big else c,
                     max_tile=4096 if big else 2048)


def bwd_tile(h: int, w_img: int, n: int, cin: int, cout: int) -> int:
    """Backward scale group (JAX ``_pick_tile(hw, n, max(cin, cout) // 2,
    max_tile=4096)``, the rule of its dgrad, wgrad and fused backward)."""
    return pick_tile(h * w_img, n, max(cin, cout) // 2, max_tile=4096)


# --- weights --------------------------------------------------------------------

def _f32_127(like: torch.Tensor) -> torch.Tensor:
    """127 as a tensor divisor: a true f32 division on the card too (a
    Python float divisor becomes a multiply by its reciprocal there)."""
    return torch.tensor(127.0, dtype=_F32, device=like.device)


def quantize_pack_weights(w: torch.Tensor):
    """Per-output-channel symmetric int8 of an OIHW 3x3 kernel, packed for
    the conv: (w_q [Cout, 9*Cin] int8, ws [Cout] f32)."""
    wf = w.to(_F32)
    absmax = wf.abs().amax(dim=(1, 2, 3))
    ws = torch.clamp_min(absmax, 1e-12) / _f32_127(absmax)
    w_q = torch.clamp(torch.round(wf / ws[:, None, None, None]), -127, 127)
    return pack_weights(w_q.to(torch.int8)), ws


def quantize_pack_weights_dgrad(w: torch.Tensor):
    """Per-input-channel symmetric int8, packed for the input gradient
    (rot180, in/out swapped: w'[ci, (dh, dw, co)] = w[co, ci, 2-dh, 2-dw]):
    (w_q [Cin, 9*Cout] int8, ws [Cin] f32)."""
    wf = w.to(_F32)
    absmax = wf.abs().amax(dim=(0, 2, 3))
    ws = torch.clamp_min(absmax, 1e-12) / _f32_127(absmax)
    w_q = torch.clamp(torch.round(wf / ws[None, :, None, None]), -127, 127)
    w_rot = w_q.to(torch.int8).flip(2, 3).transpose(0, 1)  # [Cin, Cout, 3, 3]
    return pack_weights(w_rot), ws


# --- plain versions --------------------------------------------------------------

def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32(a * b + c) rounded once, as a fused multiply-add: a is bf16 (or
    twice a bf16) and b f32, so the product is exact in float64, and so is
    the sum unless the exponents lie far apart."""
    return (a.to(torch.float64) * b.to(torch.float64)
            + c.to(torch.float64)).to(_F32)


def _vec(v: torch.Tensor) -> torch.Tensor:
    return v.to(_F32).reshape(-1, 1)


def prologue_plain(x, scale, shift, bits, thresh: Optional[int]):
    """d = dropout(relu(x * scale + shift)) in f32."""
    r = torch.clamp_min(_fma(x, _vec(scale), _vec(shift)), 0.0)
    if bits is None:
        return r
    return torch.where(bits.to(torch.int32) < thresh, r * inv_keep(thresh),
                       torch.zeros_like(r))


def fold_cotangent_plain(dy, y, dysum, dyssq):
    """gf = (dy + dysum) + (2y) * dyssq in f32 (the stats cotangents folded
    in; one fused multiply-add), or f32(dy) without them."""
    if y is None:
        return dy.to(_F32)
    return _fma(2.0 * y.to(_F32), _vec(dyssq), dy.to(_F32) + _vec(dysum))


def quantize_groups_plain(v: torch.Tensor, tile: int, floor: float):
    """Per group of ``tile`` lanes: q = s8(clip(rint(v * (127 / max(amax,
    floor))))). Returns (q [C, N] int8, amax [G] f32)."""
    c, n = v.shape
    vg = v.reshape(c, n // tile, tile)
    amax = vg.abs().amax(dim=(0, 2))
    inv = torch.tensor(127.0, dtype=_F32, device=v.device) / torch.clamp_min(
        amax, floor)
    q = torch.clamp(torch.round(vg * inv[None, :, None]), -127.0, 127.0)
    return q.to(torch.int8).reshape(c, n), amax


def _group_sums(v: torch.Tensor, tile: int) -> torch.Tensor:
    """Per-channel f32 sum of [C, N], summed per group and then across the
    groups in order (the reference's per-tile sums carried over its grid)."""
    c, n = v.shape
    parts = v.reshape(c, n // tile, tile).sum(dim=2)
    out = parts[:, 0].clone()
    for g in range(1, parts.shape[1]):
        out = out + parts[:, g]
    return out


def _per_group(v: torch.Tensor, tile: int, fac: torch.Tensor):
    """v [C, N] times fac [C, G], group by group, in f32."""
    c, n = v.shape
    return (v.reshape(c, n // tile, tile) * fac[:, :, None]).reshape(c, n)


def fwd_quantize_plain(x, scale, shift, bits, *, thresh, tile):
    return quantize_groups_plain(
        prologue_plain(x, scale, shift, bits, thresh), tile, FWD_FLOOR)


def fwd_conv_plain(d_q, amax, w_q, ws, res, *, tile, h, w_img, want_stats,
                   out_dtype=torch.bfloat16):
    acc = _conv_f64(d_q, w_q, h, w_img).to(_F32)
    fac = ws.to(_F32)[:, None] * (amax * INV_127)[None, :]
    y = _per_group(acc, tile, fac).to(out_dtype)
    if res is not None:
        y = res.to(out_dtype) + y
    if not want_stats:
        return y, None, None
    yf = y.to(_F32)
    return y, _group_sums(yf, tile), _group_sums(yf * yf, tile)


def bwd_quantize_plain(dy, y, dysum, dyssq, x, scale, shift, bits, *,
                       thresh, tile, emit_res):
    gf = fold_cotangent_plain(dy, y, dysum, dyssq)
    g_q, g_amax = quantize_groups_plain(gf, tile, BWD_FLOOR)
    d_q, d_amax = quantize_groups_plain(
        prologue_plain(x, scale, shift, bits, thresh), tile, BWD_FLOOR)
    dres = gf.to(dy.dtype) if emit_res else None
    return g_q, g_amax, d_q, d_amax, dres


def dgrad_conv_plain(g_q, g_amax, w_dg, ws_in, x, scale, shift, bits, *,
                     thresh, tile, h, w_img):
    acc = _conv_f64(g_q, w_dg, h, w_img).to(_F32)
    a = _per_group(acc, tile, ws_in.to(_F32)[:, None]
                   * (g_amax * INV_127)[None, :])
    xf = x.to(_F32)
    live = _fma(x, _vec(scale), _vec(shift)) > 0
    if bits is not None:
        live = live & (bits.to(torch.int32) < thresh)
        a = a * inv_keep(thresh)
    dn = torch.where(live, a, torch.zeros_like(a))
    dx = (dn * _vec(scale)).to(x.dtype)
    return dx, _group_sums(dn * xf, tile), _group_sums(dn, tile)


def _patches_f64(q: torch.Tensor, h: int, w_img: int) -> torch.Tensor:
    """[C, T] whole images -> the 3x3 SAME patch matrix [9*C, T] in
    float64, rows in (dh, dw, c) order."""
    c, t = q.shape
    b = t // (h * w_img)
    img = q.to(torch.float64).reshape(c, b, h, w_img).transpose(0, 1)
    cols = F.unfold(img, 3, padding=1)              # [b, c*9, h*w]
    cols = cols.reshape(b, c, 9, h * w_img).permute(2, 1, 0, 3)
    return cols.reshape(9 * c, t)


def wgrad_plain(g_q, g_amax, d_q, d_amax, *, tile, h, w_img):
    """dW [Cout, 9*Cin] f32: per group the exact s32 contraction (in
    float64), times (d_amax * g_amax) / 127^2, summed over the groups in
    order."""
    cout, n = g_q.shape
    out = None
    for g in range(n // tile):
        lanes = slice(g * tile, (g + 1) * tile)
        acc = g_q[:, lanes].to(torch.float64) @ _patches_f64(
            d_q[:, lanes], h, w_img).T
        ts = (d_amax[g] * g_amax[g]) * INV_16129
        contrib = acc.to(_F32) * ts
        out = contrib if out is None else out + contrib
    return out


# --- kernels -------------------------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from pytorch_ddp_resnet_tpu_torch.ops.cuda import build

        lib = build.load("fused_block")
        sigs = {
            "fwd_amax_launch": [_P] * 5 + [_I] * 5 + [_F, _P],
            "fwd_quant_launch": [_P] * 7 + [_I] * 5 + [_F, _P],
            "fwd_conv_launch": [_P] * 7 + [_I] * 6 + [_P],
            "bwd_amax_launch": [_P] * 9 + [_I] * 6 + [_F, _P],
            "bwd_quant_launch": [_P] * 14 + [_I] * 6 + [_F, _P],
            "dgrad_conv_launch": [_P] * 10 + [_I] * 7 + [_F, _P],
            "wgrad_launch": [_P] * 5 + [_I] * 6 + [_P],
            "partial_sum_launch": [_P, _P, _I, _I, _P],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = _I
        _lib = lib
    return _lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _slices(groups: int) -> int:
    """Blocks per scale group of the amax passes: enough blocks in all to
    fill the card several times."""
    return max(1, -(-528 // groups))


def _check_geometry(name: str, c: int, n: int, tile: int, h: int,
                    w_img: int) -> None:
    """The kernels' own shape needs (the JAX gates admit more)."""
    if c % 32:
        raise ValueError(f"{name}: C={c} is not a multiple of 32")
    if w_img % 8 or tile % (h * w_img) or n % tile or tile % 8:
        raise ValueError(f"{name}: geometry H={h} W={w_img} N={n} tile="
                         f"{tile} is not supported by the kernel")


def _launch(name: str, fn, *args) -> None:
    check_rc(name, fn(*args))
    launches[name] += 1


def _partial_sum(name: str, part: torch.Tensor) -> torch.Tensor:
    """out[i] = sum over j of part[j, i], in order, in f32."""
    j, m = part.shape
    out = torch.empty(m, dtype=_F32, device=part.device)
    _launch(name, _library().partial_sum_launch, part.data_ptr(),
            out.data_ptr(), j, m, _stream(part))
    return out


def fwd_quantize(x, scale, shift, bits, *, thresh, tile):
    """The prologue d = dropout(relu(x * scale + shift)) quantized per
    forward scale group: (d_q [Cin, N] int8, amax [G] f32)."""
    if on_cpu(x):
        return fwd_quantize_plain(x, scale, shift, bits, thresh=thresh,
                                  tile=tile)
    name = "fused_half_fwd"
    cin, n = x.shape
    scale, shift = scale.to(_F32).contiguous(), shift.to(_F32).contiguous()
    tensors, dtypes = [x, scale, shift], [torch.bfloat16, _F32, _F32]
    if bits is not None:
        tensors.append(bits)
        dtypes.append(torch.uint8)
    require_cuda(name, tensors, dtypes)
    if n % tile or tile % 8:
        raise ValueError(f"{name}: tile {tile} vs N={n}")
    groups = n // tile
    s = _slices(groups)
    part = torch.empty(groups * s, dtype=_F32, device=x.device)
    keep = inv_keep(thresh) if bits is not None else 1.0
    st = _stream(x)
    _launch(f"{name}.amax", _library().fwd_amax_launch, x.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), _ptr(bits), part.data_ptr(),
            cin, n, tile, s, thresh or 256, keep, st)
    d_q = torch.empty((cin, n), dtype=torch.int8, device=x.device)
    amax = torch.empty(groups, dtype=_F32, device=x.device)
    _launch(f"{name}.quant", _library().fwd_quant_launch, x.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), _ptr(bits), part.data_ptr(),
            d_q.data_ptr(), amax.data_ptr(), cin, n, tile, s, thresh or 256,
            keep, st)
    return d_q, amax


def fwd_conv(d_q, amax, w_q, ws, res, *, tile, h, w_img, want_stats):
    """y = bf16(f32(conv(d_q, w_q)) * ws * amax/127) (+ res in bf16), and
    with ``want_stats`` the per-channel f32 sums of y and y^2."""
    if on_cpu(d_q):
        return fwd_conv_plain(d_q, amax, w_q, ws, res, tile=tile, h=h,
                              w_img=w_img, want_stats=want_stats)
    name = "fused_half_fwd"
    cin, n = d_q.shape
    cout = w_q.shape[0]
    if tuple(w_q.shape) != (cout, 9 * cin):
        raise ValueError(f"{name}: weights {tuple(w_q.shape)} vs Cin {cin}")
    _check_geometry(name, cin, n, tile, h, w_img)
    ws = ws.to(_F32).contiguous()
    tensors = [d_q, w_q, amax, ws]
    dtypes = [torch.int8, torch.int8, _F32, _F32]
    if res is not None:
        if tuple(res.shape) != (cout, n):
            raise ValueError(f"{name}: res {tuple(res.shape)}")
        tensors.append(res)
        dtypes.append(torch.bfloat16)
    require_cuda(name, tensors, dtypes)
    y = torch.empty((cout, n), dtype=torch.bfloat16, device=d_q.device)
    nblk = _conv_blocks(n, h, w_img)
    part = (torch.empty((nblk, 2 * cout), dtype=_F32, device=d_q.device)
            if want_stats else None)
    _launch(name, _library().fwd_conv_launch, d_q.data_ptr(),
            w_q.data_ptr(), amax.data_ptr(), ws.data_ptr(), _ptr(res),
            y.data_ptr(), _ptr(part), cin, cout, n, h, w_img, tile,
            _stream(d_q))
    if not want_stats:
        return y, None, None
    sums = _partial_sum(f"{name}.sum", part)
    return y, sums[:cout], sums[cout:]


def _conv_blocks(n: int, h: int, w_img: int) -> int:
    """Position tiles of the conv kernel's grid (whole rows of one image:
    256 or fewer positions; csrc/conv3x3_rows.cuh ``row_tile``)."""
    best = 0
    for r in range(1, h + 1):
        bn = r * w_img
        if h % r == 0 and bn in (64, 128, 256) and bn > best:
            best = bn
    if best == 0:
        raise ValueError(f"no row tile for H={h} W={w_img}")
    return n // best


def bwd_quantize(dy, y, dysum, dyssq, x, scale, shift, bits, *, thresh,
                 tile, emit_res):
    """The backward's shared operands, per backward scale group (floor
    1e-30): the folded cotangent gf quantized (g_q, g_amax), the recomputed
    activation quantized (d_q, d_amax), and bf16(gf) as the residual's
    cotangent when ``emit_res``."""
    if on_cpu(dy):
        return bwd_quantize_plain(dy, y, dysum, dyssq, x, scale, shift, bits,
                                  thresh=thresh, tile=tile,
                                  emit_res=emit_res)
    name = "fused_half_bwd"
    cout, n = dy.shape
    cin = x.shape[0]
    scale, shift = scale.to(_F32).contiguous(), shift.to(_F32).contiguous()
    tensors = [dy, x, scale, shift]
    dtypes = [torch.bfloat16, torch.bfloat16, _F32, _F32]
    if y is not None:
        dysum = dysum.to(_F32).contiguous()
        dyssq = dyssq.to(_F32).contiguous()
        tensors += [y, dysum, dyssq]
        dtypes += [torch.bfloat16, _F32, _F32]
    if bits is not None:
        tensors.append(bits)
        dtypes.append(torch.uint8)
    require_cuda(name, tensors, dtypes)
    if n % tile or tile % 8:
        raise ValueError(f"{name}: tile {tile} vs N={n}")
    groups = n // tile
    s = _slices(groups)
    dev = dy.device
    part = torch.empty(2 * groups * s, dtype=_F32, device=dev)
    keep = inv_keep(thresh) if bits is not None else 1.0
    lib, st = _library(), _stream(dy)
    common = (cout, cin, n, tile, s, thresh or 256, keep, st)
    _launch(f"{name}.amax", lib.bwd_amax_launch, dy.data_ptr(), _ptr(y),
            _ptr(dysum), _ptr(dyssq), x.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), _ptr(bits), part.data_ptr(), *common)
    g_q = torch.empty((cout, n), dtype=torch.int8, device=dev)
    d_q = torch.empty((cin, n), dtype=torch.int8, device=dev)
    g_amax = torch.empty(groups, dtype=_F32, device=dev)
    d_amax = torch.empty(groups, dtype=_F32, device=dev)
    dres = (torch.empty((cout, n), dtype=torch.bfloat16, device=dev)
            if emit_res else None)
    _launch(f"{name}.quant", lib.bwd_quant_launch, dy.data_ptr(), _ptr(y),
            _ptr(dysum), _ptr(dyssq), x.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), _ptr(bits), part.data_ptr(), g_q.data_ptr(),
            d_q.data_ptr(), g_amax.data_ptr(), d_amax.data_ptr(), _ptr(dres),
            *common)
    return g_q, g_amax, d_q, d_amax, dres


def dgrad_conv(g_q, g_amax, w_dg, ws_in, x, scale, shift, bits, *, thresh,
               tile, h, w_img):
    """The input gradient through the masks: (dx [Cin, N] bf16, d(scale),
    d(shift) [Cin] f32)."""
    if on_cpu(g_q):
        return dgrad_conv_plain(g_q, g_amax, w_dg, ws_in, x, scale, shift,
                                bits, thresh=thresh, tile=tile, h=h,
                                w_img=w_img)
    name = "fused_half_dgrad"
    cout, n = g_q.shape
    cin = w_dg.shape[0]
    if tuple(w_dg.shape) != (cin, 9 * cout):
        raise ValueError(f"{name}: weights {tuple(w_dg.shape)}")
    _check_geometry(name, cout, n, tile, h, w_img)
    scale, shift = scale.to(_F32).contiguous(), shift.to(_F32).contiguous()
    ws_in = ws_in.to(_F32).contiguous()
    tensors = [g_q, w_dg, g_amax, ws_in, x, scale, shift]
    dtypes = [torch.int8, torch.int8, _F32, _F32, torch.bfloat16, _F32, _F32]
    if bits is not None:
        tensors.append(bits)
        dtypes.append(torch.uint8)
    require_cuda(name, tensors, dtypes)
    dx = torch.empty((cin, n), dtype=torch.bfloat16, device=g_q.device)
    part = torch.empty((_conv_blocks(n, h, w_img), 2 * cin), dtype=_F32,
                       device=g_q.device)
    keep = inv_keep(thresh) if bits is not None else 1.0
    _launch(name, _library().dgrad_conv_launch, g_q.data_ptr(),
            w_dg.data_ptr(), g_amax.data_ptr(), ws_in.data_ptr(),
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), _ptr(bits),
            dx.data_ptr(), part.data_ptr(), cout, cin, n, h, w_img, tile,
            thresh or 256, keep, _stream(g_q))
    sums = _partial_sum(f"{name}.sum", part)
    return dx, sums[:cin], sums[cin:]


def wgrad(g_q, g_amax, d_q, d_amax, *, tile, h, w_img):
    """dW [Cout, 9*Cin] f32, columns in (dh, dw, ci) order."""
    if on_cpu(g_q):
        return wgrad_plain(g_q, g_amax, d_q, d_amax, tile=tile, h=h,
                           w_img=w_img)
    name = "fused_half_wgrad"
    cout, n = g_q.shape
    cin = d_q.shape[0]
    _check_geometry(name, cin, n, tile, h, w_img)
    if (tile % KCHUNK or w_img > 32 or KCHUNK % w_img
            or (KCHUNK % (h * w_img) and (h * w_img) % KCHUNK)):
        raise ValueError(f"{name}: tile {tile} / image {h}x{w_img} vs the "
                         f"{KCHUNK}-position staging chunk")
    require_cuda(name, [g_q, g_amax, d_q, d_amax],
                 [torch.int8, _F32, torch.int8, _F32])
    groups = n // tile
    part = torch.empty((groups, cout * 9 * cin), dtype=_F32,
                       device=g_q.device)
    _launch(name, _library().wgrad_launch, g_q.data_ptr(),
            g_amax.data_ptr(), d_q.data_ptr(), d_amax.data_ptr(),
            part.data_ptr(), cout, cin, n, h, w_img, tile, _stream(g_q))
    return _partial_sum(f"{name}.sum", part).reshape(cout, 9 * cin)


# --- the differentiable op -------------------------------------------------------

class _FusedHalfInt8(torch.autograd.Function):
    """Forward and fully quantized backward of one half. The bits carry no
    gradient; without stats outputs the residual's cotangent is dy."""

    @staticmethod
    def forward(ctx, x_cs, w, scale, shift, bits, res, thresh, h, w_img,
                want_stats):
        cin, n = x_cs.shape
        cout = w.shape[0]
        tile = lane_tile(h, w_img, n, cin, cout)
        w_q, ws = quantize_pack_weights(w.detach())
        d_q, amax = fwd_quantize(x_cs, scale, shift, bits, thresh=thresh,
                                 tile=tile)
        y, ysum, yssq = fwd_conv(d_q, amax, w_q, ws, res, tile=tile, h=h,
                                 w_img=w_img, want_stats=want_stats)
        ctx.save_for_backward(x_cs, w, scale, shift, bits,
                              y if want_stats else None)
        ctx.cfg = (thresh, h, w_img, want_stats, res is not None)
        return (y, ysum, yssq) if want_stats else y

    @staticmethod
    def backward(ctx, dy, dysum=None, dyssq=None):
        x_cs, w, scale, shift, bits, y = ctx.saved_tensors
        thresh, h, w_img, want_stats, use_res = ctx.cfg
        cin, n = x_cs.shape
        cout = w.shape[0]
        tile = bwd_tile(h, w_img, n, cin, cout)
        dy = dy.contiguous()
        emit_res = use_res and want_stats
        w_dg, ws_in = quantize_pack_weights_dgrad(w.detach())
        g_q, g_amax, d_q, d_amax, dres = bwd_quantize(
            dy, y, dysum, dyssq, x_cs, scale, shift, bits, thresh=thresh,
            tile=tile, emit_res=emit_res)
        dx, ds, dt = dgrad_conv(g_q, g_amax, w_dg, ws_in, x_cs, scale,
                                shift, bits, thresh=thresh, tile=tile, h=h,
                                w_img=w_img)
        dw = wgrad(g_q, g_amax, d_q, d_amax, tile=tile, h=h, w_img=w_img)
        dw = dw.reshape(cout, 3, 3, cin).permute(0, 3, 1, 2).to(w.dtype)
        if use_res and not emit_res:
            dres = dy
        return (dx, dw, ds.to(scale.dtype), dt.to(shift.dtype), None,
                dres if use_res else None, None, None, None, None)


def fused_half_int8(x_cs: torch.Tensor, w: torch.Tensor,
                    scale: torch.Tensor, shift: torch.Tensor,
                    bits: Optional[torch.Tensor] = None,
                    res: Optional[torch.Tensor] = None, *,
                    dropout_rate: float = 0.0, h: int, w_img: int,
                    want_stats: bool = True
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                               Optional[torch.Tensor]]:
    """Differentiable fused preact block-half with an int8 conv core and a
    fully quantized backward.

    x_cs [Cin, N] (N = B*H*W, image-major), w [Cout, Cin, 3, 3] (OIHW),
    scale/shift [Cin] f32 (``fold_bn``), bits [Cin, N] uint8 (required iff
    the dropout rate rounds to a keep threshold below 256), res [Cout, N]
    added after the bf16 rounding. Returns (y [Cout, N], ysum, yssq), or
    (y, None, None) when ``want_stats`` is False (a block's last conv)."""
    thresh = dropout_thresh(dropout_rate)
    if thresh >= 256:
        bits = None
    elif thresh <= 0:
        raise ValueError("dropout_rate >= 1 zeroes the activations; the "
                         "fused kernel does not support it.")
    elif bits is None:
        raise ValueError(f"dropout_rate={dropout_rate} needs a bits array.")
    cin, n = x_cs.shape
    if n % (h * w_img):
        raise ValueError(f"N={n} is not a multiple of H*W={h * w_img}")
    out = _FusedHalfInt8.apply(x_cs, w, scale, shift, bits, res,
                               thresh if bits is not None else None, h,
                               w_img, want_stats)
    return out if want_stats else (out, None, None)
