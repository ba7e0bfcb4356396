"""Training halves of the post-act bottleneck trunk, forward and backward,
int8 and bf16 bodies (counterpart of
``pytorch_ddp_resnet_tpu/ops/pallas/bneck_nv_train.py``).

One half is one conv of an identity bottleneck block with the previous
BatchNorm folded into its prologue:

    a   = x                         "identity" (a run's first conv1)
        = relu(x*s + t)             "affine"   (conv2, conv3)
        = relu(x*s + t + res)       "entry"    (a mid-run conv1; a is also
                                                 emitted as x_res, bf16)
    y   = bf16(f32(conv(q(a), wq)) * (ws * scale))   int8 (``quant``)
        = bf16(conv(bf16(a), bf16(w)))               bf16, f32 accumulation
    zsum, zssq = per-channel f32 sums of y and y^2   (the next BN's stats)

and its backward folds the stats cotangents into ``g = dy + dzsum +
2*y*dzssq``, then (``quant_bwd``, FQT) quantizes g against per-input-channel
int8 weights (dgrad, then the prologue's backward: dx, d(s), d(t), and in
entry mode dres) and quantizes both a and g for the weight gradient, or
(straight-through, QAT) contracts bf16(g) with bf16(w) and bf16(a) with
bf16(g) at the unquantized point. ``quant`` and ``quant_bwd`` are set
apart, as in JAX; the models run (True, True) (FQT) and (True, False)
(QAT).

Tensors are NHWC: x [N, h, w, Cin] bf16, y [N, h, w, Cout] bf16, with no
border columns (the JAX kernels take the TPU's [h, wp, N, C] carrier;
tests convert). Weights are the port's OIHW; the quantizers and packers
return the kernels' layouts with the contraction innermost.

**Scale groups** (int8 bodies). Chunk k of a stage is image rows [k*rch,
(k+1)*rch) of every image, with that stage's own rch (the JAX row-chunk
pickers, copied here with their TPU budget because they decide the
numbers). A 3x3 stage's activation group (forward, wgrad) and cotangent
group (dgrad) also cover the halo rows k*rch-1 and (k+1)*rch inside the
image; the wgrad's cotangent group has none. Each group is quantized with
its own absmax: ``q = clip(rint(v * f32(127 / max(amax, 1e-30))),
+-127)``, ``scale = amax * f32(1/127)``. An absmax is exact in any order,
so one pass writes the per-image-row maxima of |a| (forward, kept for the
wgrad) and of |g| (backward, shared by dgrad and wgrad), and every kernel
reduces them over its own groups. The bf16 bodies use the chunks only for
the order of their sums: the wgrad adds each chunk's f32 contraction into
dW in chunk order.

Rounding points, as the reference computes them where the tests run it
(interpret mode, lowered by XLA on the CPU; pinned by
tests/test_torch_bneck_nv_train.py and
tests/test_torch_bneck_nv_train_bf16.py): ``x*s + t`` is one fused
multiply-add, ``+ res`` rounds on its own; the fold ``(dy + dzsum) +
(2y)*dzssq`` is one fused multiply-add; int8: ``ws * scale`` rounds to
f32 before it multiplies f32(acc), and in the entry dgrad that product and
``+ dx_res`` are one fused multiply-add; the wgrad adds each chunk's
``f32(s32) * ((amax_a * amax_g) * f32(1/127^2))`` into dW in chunk order
(XLA reassociates the two 1/127 factors); bf16: the operands round to bf16
once, the products sum in f32, and the entry dgrad's ``da + dx_res`` is a
plain f32 add; every bf16 output is the f32 value rounded once more.

Layers of this module, each a CPU-or-card wrapper beside its plain
version (a CPU tensor runs the plain PyTorch version; a CUDA tensor
launches the kernels of ``csrc/bneck_nv_train.cu`` or raises):

- ``fwd_rowmax``       (launches ``nv_half_fwd.amax``)
- ``fwd_conv``         ``fwd_pre`` (``nv_half_fwd.pre``: each chunk's
                        activation quantized once into an int8 slab,
                        position-major, in the layout of
                        ``fwd_int8_layout``), then ``fwd_gemm``
                        (``nv_half_fwd``, ``nv_half_fwd.sum``)
- ``fwd_conv_bf16``    (``nv_half_fwd_bf16``, ``nv_half_fwd_bf16.sum``)
- ``bwd_rowmax``       (``nv_half_bwd.amax``)
- ``dgrad_conv``       ``dgrad_pre`` (``nv_half_dgrad.pre``: each chunk's
                        cotangent quantized once into an int8 slab in the
                        layout of ``fwd_int8_layout`` at Cin = the half's
                        Cout), then ``dgrad_gemm`` (``nv_half_dgrad``, and
                        ``nv_half_dgrad.sum`` unless the mode is identity)
- ``dgrad_conv_bf16``  ``dgrad_bf16_pre`` (``nv_half_dgrad_bf16.pre``: the
                        cotangent rounded to bf16 once into a bf16 slab of
                        ``dgrad_bf16_layout``, the int8 layout at one chunk
                        of h rows), then ``dgrad_bf16_gemm``
                        (``nv_half_dgrad_bf16``, and
                        ``nv_half_dgrad_bf16.sum`` unless the mode is
                        identity)
- ``wgrad``            ``wgrad_pre`` (``nv_half_wgrad.pre``: each chunk's
                        operands quantized once into int8 slabs, K
                        contiguous, in the layout of ``wgrad_int8_layout``),
                        then ``wgrad_gemm`` (``nv_half_wgrad``,
                        ``nv_half_wgrad.sum``) on the tiles and splits of
                        ``wgrad_int8_plan``
- ``wgrad_bf16``       ``wgrad_bf16_pre`` (``nv_half_wgrad_bf16.pre``: the
                        operands rounded once into NHWC bf16 scratch), then
                        ``wgrad_bf16_gemm`` (``nv_half_wgrad_bf16``,
                        ``nv_half_wgrad_bf16.sum``) on the tiles and splits
                        of ``wgrad_bf16_plan``

and ``nv_half_1x1`` / ``nv_half_3x3``, the differentiable ops over them.
``launches`` counts each kernel launch by name and ``launch_shapes`` each
op call by (stage, conv, mode, N, h, w, Cin, Cout), the stage ``fwd``,
``dgrad``, ``wgrad`` or, for a bf16 body, ``fwd_bf16``, ``dgrad_bf16``,
``wgrad_bf16``; plain calls count nothing. The plain versions compute
every product sum in float64 (exact for the int8 products) and round it
to f32 where the reference's accumulator holds it.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_ddp_resnet_tpu_torch.ops.cuda.checks import (
    check_rc,
    on_cpu,
    require_cuda,
)
from pytorch_ddp_resnet_tpu_torch.ops.cuda.wgrad_plan import (
    WgradPlan,
    split_plan,
)

launches: collections.Counter = collections.Counter()
launch_shapes: collections.Counter = collections.Counter()

MODES = ("identity", "affine", "entry")
INV_127 = float(np.float32(1.0 / 127.0))  # the reference's f32(1/127)
INV_127_SQ = float(np.float32(INV_127) * np.float32(INV_127))
FLOOR = 1e-30                              # absmax floor of every group

f32 = torch.float32
f64 = torch.float64
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    launches.clear()
    launch_shapes.clear()


# --- the chunk model (copies of the JAX pickers) -----------------------------

def nv_geometry(h: int, w: int) -> int:
    """wp of the JAX NV carrier for an [h, w] plane: the smallest power of
    two >= w + 2, at least 8. The port has no border columns; the pickers
    take wp because it sizes the JAX kernels' row chunks."""
    if h < 1 or w < 1:
        raise ValueError(f"degenerate plane {h}x{w}")
    wp = 8
    while wp < w + 2:
        wp *= 2
    return wp


def _pick_rch(h: int, row_bytes: int, fixed: int,
              budget: int = 100 * 1024 * 1024) -> int:
    """Largest row chunk R dividing h with R * row_bytes + fixed within the
    budget (the TPU kernels' VMEM budget; it decides the scale groups)."""
    best = None
    for r in range(1, h + 1):
        if h % r == 0 and r * row_bytes + fixed <= budget:
            best = r
    if best is None:
        raise ValueError(
            f"NV train geometry does not fit the VMEM budget even at "
            f"1-row chunks: est {(row_bytes + fixed) / 2**20:.1f} MB vs "
            f"{budget / 2**20:.0f} MB — shrink the batch or image plane")
    return best


def _lanes(c: int) -> int:
    return -(-c // 128) * 128


def _w_fixed(taps, cin, cout):
    return taps * cin * _lanes(cout) * 2


def _sliver_fixed(wp, n, c):
    return wp * n * _lanes(c) * (2 * 4 + 2 * 5)


def _rows_fwd1x1(wp, n, cin, cout, entry):
    ci, co = _lanes(cin), _lanes(cout)
    return wp * n * (4 * ci + 4 * ci + ci + 4 * co + 4 * co
                     + (12 * ci if entry else 0))


def _rows_fwd3x3(wp, n, cin, cout):
    ci, co = _lanes(cin), _lanes(cout)
    return wp * n * (4 * ci + 4 * ci + ci + 4 * co + 4 * co)


def _rows_dgrad1x1(wp, n, cin, cout, entry):
    ci, co = _lanes(cin), _lanes(cout)
    return wp * n * (4 * co * 2 + 4 * co + co + 4 * ci + 4 * ci + 4 * ci
                     + 4 * ci + (8 * ci if entry else 0))


def _rows_dgrad3x3(wp, n, cin, cout):
    ci, co = _lanes(cin), _lanes(cout)
    return wp * n * (4 * co * 2 + 4 * co + co + 4 * ci + 4 * ci + 4 * ci
                     + 4 * ci)


def _rows_wgrad1x1(wp, n, cin, cout, entry):
    ci, co = _lanes(cin), _lanes(cout)
    return wp * n * (4 * co * 2 + 4 * co + co + 4 * ci + 4 * ci + ci
                     + (4 * ci if entry else 0))


def _rows_wgrad3x3(wp, n, cin, cout):
    ci, co = _lanes(cin), _lanes(cout)
    return wp * n * (4 * co * 2 + 4 * co + co + 4 * ci + 4 * ci + ci)


def _rch_fwd(h, wp, n, cin, cout, conv, entry):
    if conv == "1x1":
        return _pick_rch(h, _rows_fwd1x1(wp, n, cin, cout, entry),
                         _w_fixed(1, cin, cout))
    return _pick_rch(h, _rows_fwd3x3(wp, n, cin, cout),
                     _w_fixed(9, cin, cout) + _sliver_fixed(wp, n, cin))


def _rch_dgrad(h, wp, n, cin, cout, conv, entry):
    if conv == "1x1":
        return _pick_rch(h, _rows_dgrad1x1(wp, n, cin, cout, entry),
                         _w_fixed(1, cout, cin))
    return _pick_rch(h, _rows_dgrad3x3(wp, n, cin, cout),
                     _w_fixed(9, cout, cin) + 2 * _sliver_fixed(wp, n, cout))


def _rch_wgrad(h, wp, n, cin, cout, conv, entry):
    if conv == "1x1":
        return _pick_rch(h, _rows_wgrad1x1(wp, n, cin, cout, entry),
                         cin * _lanes(cout) * 4 * 2)
    return _pick_rch(h, _rows_wgrad3x3(wp, n, cin, cout),
                     9 * cin * _lanes(cout) * 4 * 2
                     + _sliver_fixed(wp, n, cin))


@functools.lru_cache(maxsize=None)
def nv_train_fits(h: int, w_img: int, n: int, cin: int, cb: int,
                  cout: int) -> bool:
    """True when every half of an identity bottleneck block at this
    geometry gets a row chunk from all three pickers (the JAX gate)."""
    wp = nv_geometry(h, w_img)
    try:
        for ci, co, conv, entry in ((cin, cb, "1x1", True),
                                    (cb, cb, "3x3", False),
                                    (cb, cout, "1x1", False)):
            _rch_fwd(h, wp, n, ci, co, conv, entry)
            _rch_dgrad(h, wp, n, ci, co, conv, entry)
            _rch_wgrad(h, wp, n, ci, co, conv, entry)
    except ValueError:
        return False
    return True


def pick_chunk_rows(h: int, w_img: int, n: int, cin: int, cout: int,
                    conv: str, mode: str):
    """The (fwd, dgrad, wgrad) row chunks of one half."""
    wp, entry = nv_geometry(h, w_img), mode == "entry"
    return tuple(f(h, wp, n, cin, cout, conv, entry)
                 for f in (_rch_fwd, _rch_dgrad, _rch_wgrad))


# --- weights -----------------------------------------------------------------

def _quant_w(wf: torch.Tensor, dims, shape):
    # a tensor divisor: a true f32 division on the card too (a Python float
    # divisor becomes a multiply by its reciprocal there)
    ws = torch.clamp_min(wf.abs().amax(dim=dims), 1e-12) / torch.tensor(
        127.0, dtype=f32, device=wf.device)
    q = torch.clamp(torch.round(wf / ws.reshape(shape)), -127, 127)
    return q.to(torch.int8), ws


def quantize_w_1x1(w: torch.Tensor):
    """OIHW [Cout, Cin, 1, 1] -> (wq [Cout, Cin] int8, ws [Cout] f32),
    per output channel (JAX ``quantize_w_1x1``)."""
    wf = w.to(f32)[:, :, 0, 0]
    q, ws = _quant_w(wf, 1, (-1, 1))
    return q.contiguous(), ws


def quantize_w_1x1_dgrad(w: torch.Tensor):
    """OIHW [Cout, Cin, 1, 1] -> (wq [Cin, Cout] int8, ws [Cin] f32), per
    input channel: the transposed contraction runs over Cout."""
    wf = w.to(f32)[:, :, 0, 0]
    q, ws = _quant_w(wf, 0, (1, -1))
    return q.t().contiguous(), ws


def quantize_w_3x3(w: torch.Tensor):
    """OIHW [Cout, Cin, 3, 3] -> (wq [Cout, 9*Cin] int8, taps row-major in
    (dy, dx) then input channel; ws [Cout] f32)."""
    wf = w.to(f32)
    q, ws = _quant_w(wf, (1, 2, 3), (-1, 1, 1, 1))
    return q.permute(0, 2, 3, 1).reshape(w.shape[0], -1).contiguous(), ws


def quantize_w_3x3_dgrad(w: torch.Tensor):
    """OIHW [Cout, Cin, 3, 3] -> (wq [Cin, 9*Cout] int8, wq[ci, (dy, dx,
    co)] = q(w[co, ci, dy, dx]) in FORWARD tap coordinates (the dgrad's
    gather shifts by them); ws [Cin] f32), per input channel."""
    wf = w.to(f32)
    q, ws = _quant_w(wf, (0, 2, 3), (1, -1, 1, 1))
    return q.permute(1, 2, 3, 0).reshape(w.shape[1], -1).contiguous(), ws


def pack_w_bf16(w: torch.Tensor) -> torch.Tensor:
    """OIHW [Cout, Cin, k, k] -> bf16 [Cout, k*k*Cin], taps row-major in
    (dy, dx) then input channel: the bf16 forward's weights (JAX
    ``quant_fwd_w`` with ``quant=False``)."""
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1).to(
        torch.bfloat16).contiguous()


def pack_w_bf16_dgrad(w: torch.Tensor) -> torch.Tensor:
    """OIHW [Cout, Cin, k, k] -> bf16 [Cin, k*k*Cout], wb[ci, (dy, dx, co)]
    = bf16(w[co, ci, dy, dx]) in forward tap coordinates: the bf16 dgrad's
    weights (JAX ``quant_dgrad_w`` with ``quant_bwd=False``)."""
    return w.permute(1, 2, 3, 0).reshape(w.shape[1], -1).to(
        torch.bfloat16).contiguous()


# --- plain versions ----------------------------------------------------------

def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32(a*b + c) rounded once: a is bf16 (or twice a bf16) or an
    integer below 2^24 and b f32, so the product is exact in float64, and
    so is the sum unless the exponents lie far apart."""
    return (a.to(f64) * b.to(f64) + c.to(f64)).to(f32)


def prologue_plain(x, s, t, res, mode: str) -> torch.Tensor:
    """a in f32: x, relu(x*s + t) or relu(x*s + t + res)."""
    if mode == "identity":
        return x.to(f32)
    u = _fma(x, s.to(f32), t.to(f32))
    if mode == "entry":
        u = u + res.to(f32)
    return torch.clamp_min(u, 0.0)


def fold_plain(dy, y, dzsum, dzssq) -> torch.Tensor:
    """g = (dy + dzsum) + (2y) * dzssq in f32 (one fused multiply-add)."""
    return _fma(2.0 * y.to(f32), dzssq.to(f32), dy.to(f32) + dzsum.to(f32))


def _row_absmax(v: torch.Tensor) -> torch.Tensor:
    return v.abs().amax(dim=(0, 2, 3))


def chunk_amax(rowmax: torch.Tensor, rch: int, halo: int) -> torch.Tensor:
    """Per chunk: the max of the row maxima over rows [k*rch - halo,
    (k+1)*rch + halo) inside the plane."""
    h = rowmax.shape[0]
    out = [rowmax[max(k - halo, 0):min(k + rch + halo, h)].amax()
           for k in range(0, h, rch)]
    return torch.stack(out)


def _quant_params(amax: torch.Tensor):
    """(inv, scale) of each group: f32(127 / max(amax, 1e-30)), amax *
    f32(1/127)."""
    inv = torch.tensor(127.0, dtype=f32, device=amax.device) / torch.clamp_min(
        amax, FLOOR)
    return inv, amax * INV_127


def _q(v: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """clip(rint(v * inv)) as float64 (exact small integers)."""
    return torch.clamp(torch.round(v * inv), -127.0, 127.0).to(f64)


def _slabs(v: torch.Tensor, rch: int, halo: int) -> torch.Tensor:
    """[N, h, w, C] -> [K, N, rch + 2*halo, w, C]: chunk k's rows with its
    halo, zero outside the plane."""
    n, h, w, c = v.shape
    rows = torch.arange(0, h, rch)[:, None] + torch.arange(
        -halo, rch + halo)[None, :]
    inside = (rows >= 0) & (rows < h)
    g = v[:, rows.clamp(0, h - 1).reshape(-1)].reshape(
        n, rows.shape[0], rows.shape[1], w, c).transpose(0, 1)
    return g * inside[:, None, :, None, None].to(device=v.device,
                                                 dtype=v.dtype)


def _dequant(acc, ws, scale, rch, add=None):
    """f32(acc) * f32(ws[c] * scale[k]) on the rows of chunk k (+ add, in
    the same rounding)."""
    fac = ws.to(f32)[None, :] * scale[:, None]        # [K, C]
    fac = fac.repeat_interleave(rch, 0)[None, :, None, :]
    if add is None:
        return acc.to(f32) * fac
    return _fma(acc.to(f32), fac, add)


def _conv_chunks(v, rowmax, rch, halo, wq, taps, cin):
    """The exact s32 sums of every output position: v [N, h, w, Cin] f32
    quantized per chunk (with halo) and contracted with wq [Cout,
    taps*Cin] (taps row-major in (dy, dx)), in float64; and the chunks'
    scales."""
    n, h, w, _ = v.shape
    inv, scale = _quant_params(chunk_amax(rowmax, rch, halo))
    cout = wq.shape[0]
    if taps == 1:
        q = _q(v, inv.repeat_interleave(rch).reshape(1, h, 1, 1))
        return q @ wq.to(f64).t(), scale
    slab = _q(_slabs(v, rch, 1), inv.reshape(-1, 1, 1, 1, 1))
    kk = slab.shape[0]
    k4 = wq.to(f64).reshape(cout, 3, 3, cin).permute(0, 3, 1, 2)
    acc = F.conv2d(slab.reshape(kk * n, rch + 2, w, cin).permute(0, 3, 1, 2),
                   k4, padding=(0, 1))
    acc = acc.reshape(kk, n, cout, rch, w).permute(1, 0, 3, 4, 2)
    return acc.reshape(n, h, w, cout), scale


def _ordered_sum(v: torch.Tensor, rch: int) -> torch.Tensor:
    """Per-channel f32 sum of [N, h, w, C]: per chunk, then across chunks
    in order."""
    n, h, w, c = v.shape
    parts = v.reshape(n, h // rch, rch, w, c).sum(dim=(0, 2, 3))
    out = parts[0].clone()
    for k in range(1, parts.shape[0]):
        out = out + parts[k]
    return out


def _wgrad_chunks(a_slabs, g_slabs, rch, halo):
    """[K, taps*Cin, Cout] float64: per chunk, the contraction over its
    positions of a's slab [K, N, rch + 2*halo, w, Cin] (zero outside the
    plane) at each tap's shift with g's [K, N, rch, w, Cout]."""
    if not halo:
        return torch.einsum("knrwc,knrwd->kcd", a_slabs, g_slabs)
    w = a_slabs.shape[3]
    ap = F.pad(a_slabs, (0, 0, 1, 1))
    return torch.cat([torch.einsum(
        "knrwc,knrwd->kcd", ap[:, :, dy:dy + rch, dx:dx + w], g_slabs)
        for dy in range(3) for dx in range(3)], dim=1)


def _bf64(v: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to bf16, as float64."""
    return v.to(torch.bfloat16).to(f64)


def _conv_bf16(v, wb, taps, cin):
    """f32 of the float64 SAME conv of bf16(v) [N, h, w, Cin] with wb
    [Cout, taps*Cin] bf16 (taps row-major in (dy, dx)): each product is
    exact, so this is the reference's f32 accumulation up to its order."""
    vb, cout = _bf64(v), wb.shape[0]
    if taps == 1:
        return (vb @ wb.to(f64).t()).to(f32)
    k4 = wb.to(f64).reshape(cout, 3, 3, cin).permute(0, 3, 1, 2)
    out = F.conv2d(vb.permute(0, 3, 1, 2), k4, padding=1)
    return out.permute(0, 2, 3, 1).to(f32).contiguous()


def fwd_rowmax_plain(x, s, t, res, *, mode):
    """(the row maxima of |a| [h] f32, x_res = bf16(a) in entry mode)."""
    a = prologue_plain(x, s, t, res, mode)
    return _row_absmax(a), (a.to(torch.bfloat16) if mode == "entry"
                            else None)


def fwd_conv_plain(x, s, t, res, rowmax, wq, ws, *, conv, mode, rch):
    """(y [N, h, w, Cout] bf16, zsum, zssq [Cout] f32)."""
    a = prologue_plain(x, s, t, res, mode)
    taps = 9 if conv == "3x3" else 1
    acc, scale = _conv_chunks(a, rowmax, rch, taps // 9, wq, taps,
                              x.shape[-1])
    y = _dequant(acc, ws, scale, rch).to(torch.bfloat16)
    yb = y.to(f32)
    return y, _ordered_sum(yb, rch), _ordered_sum(yb * yb, rch)


def fwd_conv_bf16_plain(x, s, t, res, wb, *, conv, mode, rch):
    """The bf16 forward: (y [N, h, w, Cout] bf16, zsum, zssq [Cout] f32,
    x_res = bf16(a) in entry mode, else None)."""
    a = prologue_plain(x, s, t, res, mode)
    y = _conv_bf16(a, wb, _taps(conv), x.shape[-1]).to(torch.bfloat16)
    yb = y.to(f32)
    return (y, _ordered_sum(yb, rch), _ordered_sum(yb * yb, rch),
            a.to(torch.bfloat16) if mode == "entry" else None)


def bwd_rowmax_plain(dy, y, dzsum, dzssq):
    """The row maxima of |g| [h] f32."""
    return _row_absmax(fold_plain(dy, y, dzsum, dzssq))


def dgrad_conv_plain(dy, y, dzsum, dzssq, rowmax_g, wq_dg, ws_in, x, s, t,
                     res, dxout, *, conv, mode, rch):
    """(dx [N, h, w, Cin] bf16, ds, dt [Cin] f32 or None, dres bf16 or
    None)."""
    g = fold_plain(dy, y, dzsum, dzssq)
    cin, cout = x.shape[-1], dy.shape[-1]
    if conv == "3x3":
        # da(r, c) = sum g(r - dy + 1, c - dx + 1) . w[dy, dx]^T: a SAME
        # correlation with the taps mirrored
        wq_dg = wq_dg.reshape(cin, 3, 3, cout).flip(1, 2).reshape(cin, -1)
    taps = 9 if conv == "3x3" else 1
    acc, scale = _conv_chunks(g, rowmax_g, rch, taps // 9, wq_dg, taps, cout)
    if mode == "entry":   # f32(acc) * fac + dx_res: one fused multiply-add
        da = _dequant(acc, ws_in, scale, rch, add=dxout.to(f32))
    else:
        da = _dequant(acc, ws_in, scale, rch)
    return _prologue_bwd(da, x, s, t, res, mode, rch)


def _prologue_bwd(da, x, s, t, res, mode, rch):
    """From da = the f32 gradient of a (dx_res added in entry mode): (dx
    bf16, ds, dt f32 or None, dres bf16 or None)."""
    if mode == "identity":
        return da.to(torch.bfloat16), None, None, None
    xf = x.to(f32)
    u = _fma(x, s.to(f32), t.to(f32))
    if mode == "entry":
        u = u + res.to(f32)
    du = torch.where(u > 0, da, torch.zeros_like(da))
    dx = (du * s.to(f32)).to(torch.bfloat16)
    dres = du.to(torch.bfloat16) if mode == "entry" else None
    return dx, _ordered_sum(du * xf, rch), _ordered_sum(du, rch), dres


def dgrad_conv_bf16_plain(dy, y, dzsum, dzssq, wb_dg, x, s, t, res, dxout,
                          *, conv, mode, rch):
    """The bf16 input gradient: bf16(g) against wb_dg [Cin, taps*Cout] bf16
    (forward tap coordinates), then the prologue's backward, dx_res added
    to the f32 product in entry mode: (dx, ds, dt, dres) as
    ``dgrad_conv_plain``."""
    g = fold_plain(dy, y, dzsum, dzssq)
    cin, cout = x.shape[-1], dy.shape[-1]
    if conv == "3x3":   # the taps mirrored, as in dgrad_conv_plain
        wb_dg = wb_dg.reshape(cin, 3, 3, cout).flip(1, 2).reshape(cin, -1)
    da = _conv_bf16(g, wb_dg, _taps(conv), cout)
    if mode == "entry":
        da = da + dxout.to(f32)
    return _prologue_bwd(da, x, s, t, res, mode, rch)


def wgrad_bf16_pre_plain(dy, y, dzsum, dzssq, x, s, t, res, *, mode):
    """The bf16 weight gradient's operands, each rounded once: (a_b [N, h,
    w, Cin] bf16 = bf16(a), x itself in identity mode; g_b [N, h, w, Cout]
    bf16 = bf16(g))."""
    a_b = (x if mode == "identity"
           else prologue_plain(x, s, t, res, mode).to(torch.bfloat16))
    return a_b, fold_plain(dy, y, dzsum, dzssq).to(torch.bfloat16)


def wgrad_bf16_gemm_plain(a_b, g_b, *, conv, rch):
    """dW [taps*Cin, Cout] f32 from the rounded operands: per chunk the
    contraction of a_b (at each tap's shift) with g_b, in float64 rounded
    to f32, added in chunk order."""
    halo = 1 if conv == "3x3" else 0
    acc = _wgrad_chunks(_slabs(a_b.to(f64), rch, halo),
                        _slabs(g_b.to(f64), rch, 0), rch, halo)
    out = acc[0].to(f32)
    for k in range(1, acc.shape[0]):
        out = out + acc[k].to(f32)
    return out


def wgrad_bf16_plain(dy, y, dzsum, dzssq, x, s, t, res, *, conv, mode,
                     rch):
    """The bf16 weight gradient, dW [taps*Cin, Cout] f32 in the rows of
    ``wgrad_plain``: per chunk the contraction of bf16(a) with bf16(g) (in
    float64, rounded to f32), added in chunk order."""
    a_b, g_b = wgrad_bf16_pre_plain(dy, y, dzsum, dzssq, x, s, t, res,
                                    mode=mode)
    return wgrad_bf16_gemm_plain(a_b, g_b, conv=conv, rch=rch)


def _scaled_chunk_sum(acc, rowmax_a, rowmax_g, rch, halo):
    """dW = sum over chunks k in order of f32(acc[k]) * ts_k in f32, acc
    [K, taps*Cin, Cout] the exact s32 sums (float64) and ts_k = (amax_a *
    amax_g) * f32(1/127^2): XLA reassociates (amax_a * c) * (amax_g * c)
    into that."""
    ts = (chunk_amax(rowmax_a, rch, halo) * chunk_amax(rowmax_g, rch, 0)
          ) * INV_127_SQ
    out = acc[0].to(f32) * ts[0]
    for k in range(1, acc.shape[0]):
        out = out + acc[k].to(f32) * ts[k]
    return out


def wgrad_plain(dy, y, dzsum, dzssq, rowmax_g, x, s, t, res, rowmax_a, *,
                conv, mode, rch):
    """dW [taps*Cin, Cout] f32 (rows in (dy, dx, ci) order: JAX's
    [3, 3, Cin, Cout] flattened): per chunk the exact s32 contraction (in
    float64) times (amax_a * amax_g) * f32(1/127^2), added in chunk
    order."""
    a = prologue_plain(x, s, t, res, mode)
    g = fold_plain(dy, y, dzsum, dzssq)
    halo = 1 if conv == "3x3" else 0
    inv_a, _ = _quant_params(chunk_amax(rowmax_a, rch, halo))
    inv_g, _ = _quant_params(chunk_amax(rowmax_g, rch, 0))
    gq = _q(_slabs(g, rch, 0), inv_g.reshape(-1, 1, 1, 1, 1))
    aq = _q(_slabs(a, rch, halo), inv_a.reshape(-1, 1, 1, 1, 1))
    acc = _wgrad_chunks(aq, gq, rch, halo)
    return _scaled_chunk_sum(acc, rowmax_a, rowmax_g, rch, halo)


WGRAD_S8_BK = 128  # positions per K step (csrc/wgrad_staged_s8.cuh K_STEP)


class WgradInt8Layout(NamedTuple):
    """Where the int8 wgrad's prepass writes each chunk's quantized
    operands and where its mainloop reads them (one int8 a position, K
    contiguous). Images are padded to ``n16`` (a multiple of 16) and each
    row of w columns to ``wq = w + 1``: position (r, c, i) of a chunk sits
    at k = (r*wq + c)*n16 + i, and the pad images and the column c = w are
    zero. The g slab [chunks, Cout, lg] holds the chunk's ``rch`` rows, ``k``
    positions, then zeros to ``steps`` whole K steps of ``bk``. The a slab
    [chunks, Cin, la] holds ``guard`` zero bytes, the rch + 2*halo rows
    from image row k*rch - halo (3x3: the halo rows at the chunk's scale,
    zero outside the image), then ``guard`` + lg - k zero bytes. Tap t
    reads a at k + shifts[t], ``guard + (dy*wq + dx - 1)*n16`` for the 3x3
    (the zero column is the left neighbour of column 0 and the right one of
    column w-1), 0 for the 1x1: every shift a multiple of 16 bytes, every
    read inside the slab, no masks."""
    n: int
    h: int
    w: int
    taps: int
    rch: int
    n16: int
    wq: int
    halo: int
    guard: int
    chunks: int
    bk: int
    k: int
    steps: int
    lg: int
    la: int
    shifts: tuple


@functools.lru_cache(maxsize=None)
def wgrad_int8_layout(n: int, h: int, w: int, taps: int,
                      rch: int) -> WgradInt8Layout:
    """The int8 wgrad's slab layout for an [n, h, w] plane, ``taps`` 1 or 9
    and row chunk ``rch`` (see ``WgradInt8Layout``). Cached: every call of
    the wgrad asks."""
    if taps not in (1, 9):
        raise ValueError(f"taps={taps}: the halves are 1x1 or 3x3")
    _check_rch("wgrad_int8_layout", h, rch)
    n16 = -(-n // 16) * 16
    wq = w + 1
    halo = 1 if taps == 9 else 0
    guard = halo * n16
    k = rch * wq * n16
    bk = WGRAD_S8_BK
    steps = -(-k // bk)
    lg = steps * bk
    la = 2 * guard + (rch + 2 * halo) * wq * n16 + lg - k
    shifts = (tuple(guard + (dy * wq + dx - 1) * n16 for dy in range(3)
                    for dx in range(3)) if taps == 9 else (0,))
    return WgradInt8Layout(n, h, w, taps, rch, n16, wq, halo, guard,
                           h // rch, bk, k, steps, lg, la, shifts)


def _slab_rows(v, inv, lay, halo):
    """v [N, h, w, C] f32 quantized per chunk at ``inv`` [K] into the
    layout's slab rows: int8 [K, C, row bytes], the a slab's with ``halo``
    rows and guards, g's without."""
    n, _, w, c = v.shape
    q = _q(_slabs(v, lay.rch, halo), inv.reshape(-1, 1, 1, 1, 1))
    q = F.pad(q, (0, 0, 0, lay.wq - w, 0, 0, 0, lay.n16 - n))
    rows = q.permute(0, 4, 2, 3, 1).reshape(lay.chunks, c, -1)
    guard = lay.guard if halo else 0
    return F.pad(rows, (guard, guard + lay.lg - lay.k)).to(torch.int8)


def wgrad_pre_plain(dy, y, dzsum, dzssq, rowmax_g, x, s, t, res, rowmax_a,
                    *, conv, mode, rch):
    """The int8 wgrad's slabs (a_slab [h/rch, Cin, la], g_slab [h/rch,
    Cout, lg] int8, ``wgrad_int8_layout``): each chunk's a (with its halo
    rows for the 3x3) and g quantized at the chunk's scale, as
    ``wgrad_plain`` quantizes them."""
    n, h, w, _ = x.shape
    lay = wgrad_int8_layout(n, h, w, _taps(conv), rch)
    inv_a, _ = _quant_params(chunk_amax(rowmax_a, rch, lay.halo))
    inv_g, _ = _quant_params(chunk_amax(rowmax_g, rch, 0))
    return (_slab_rows(prologue_plain(x, s, t, res, mode), inv_a, lay,
                       lay.halo),
            _slab_rows(fold_plain(dy, y, dzsum, dzssq), inv_g, lay, 0))


def wgrad_gemm_plain(a_slab, g_slab, rowmax_a, rowmax_g, lay):
    """dW [taps*Cin, Cout] f32 from the slabs of layout ``lay``: per chunk
    the exact contraction (float64) of each tap's shifted a rows with the g
    rows over the chunk's lg positions, times its scale, added in chunk
    order."""
    gq = g_slab.to(f64)
    acc = torch.cat([torch.einsum(
        "kcp,kdp->kcd", a_slab[:, :, sh:sh + lay.lg].to(f64), gq)
        for sh in lay.shifts], dim=1)
    return _scaled_chunk_sum(acc, rowmax_a, rowmax_g, lay.rch, lay.halo)


FWD_BM = 128  # output positions a tile (csrc/fwd_staged_s8.cuh BM)


class FwdInt8Layout(NamedTuple):
    """Where the int8 forward's prepass writes each chunk's quantized
    activation and where its mainloop reads it (and, at Cin = the half's
    Cout, where the int8 input gradient's prepass writes the cotangent:
    the layout is symmetric, so its mainloop reads tap t's mirror at
    ``shifts[taps - 1 - t]``): position-major, ``cp`` bytes a position
    (Cin padded with zeros to a multiple of 64, so that the K step ``bk``
    divides it). Output position (r, c, i) of a chunk
    (r < rch, c < wq, i < n) is M row m = (r*wq + c)*n + i for the 3x3
    (images innermost, so that every tap is one position offset) and
    m = (i*rch + r)*w + c for the 1x1 (runs of rch*w positions contiguous
    in x and y); each row of w columns has ``wq`` (3x3: w + 1, the last
    column zero; 1x1: w), and ``m_valid`` = rch*wq*n rows fill ``tiles``
    whole tiles of ``bm`` rows, so a tile lies in one chunk. The slab
    [chunks, slab_len, cp] of chunk k holds ``guard`` zero positions, the
    rch + 2*halo rows from image row k*rch - halo (3x3: the halo rows at
    the chunk's scale, zero outside the image), ``guard`` more, then
    tiles*bm - m_valid tail positions. Tap t reads position m + shifts[t],
    ``guard + (dy*wq + dx - 1)*n`` for the 3x3 (the zero column is the
    left neighbour of column 0 and the right one of column w-1), 0 for the
    1x1: every A row of every tap a 16-byte aligned read inside the slab,
    no masks. Rows with c >= w and the tail are computed and thrown
    away."""
    n: int
    h: int
    w: int
    cin: int
    taps: int
    rch: int
    cp: int
    bk: int
    wq: int
    halo: int
    guard: int
    chunks: int
    bm: int
    m_valid: int
    tiles: int
    slab_len: int
    shifts: tuple

    @property
    def codes(self) -> int:
        """Bytes of the codes a prepass must write: each chunk's image rows
        (a halo row inside the image once in each chunk that reads it), w
        columns, the real channels; not the pad column, pad channels,
        guards or tail."""
        return (self.h + 2 * self.halo * (self.chunks - 1)) * self.n \
            * self.w * self.cin


@functools.lru_cache(maxsize=None)
def fwd_int8_layout(n: int, h: int, w: int, cin: int, taps: int,
                    rch: int, pad: bool = True) -> FwdInt8Layout:
    """The int8 forward's slab layout for an [n, h, w, cin] activation,
    ``taps`` 1 or 9 and row chunk ``rch`` (see ``FwdInt8Layout``): K steps
    of 128 bytes where the padded channels allow, else 64. ``pad=False``
    keeps cp = cin (a mainloop whose boxes of 128, 64 and 32 bytes take any
    cin % 32, as the serving identity block's slab, ``bneck_nv``; its K
    step then 32 where 64 does not divide cin). Cached: every call of the
    forward asks."""
    if taps not in (1, 9):
        raise ValueError(f"taps={taps}: the halves are 1x1 or 3x3")
    _check_rch("fwd_int8_layout", h, rch)
    cp = -(-cin // 64) * 64 if pad else cin
    bk = 128 if cp % 128 == 0 else 64 if cp % 64 == 0 else 32
    halo = 1 if taps == 9 else 0
    wq = w + halo
    guard = halo * n
    m_valid = rch * wq * n
    tiles = -(-m_valid // FWD_BM)
    slab_len = (2 * guard + (rch + 2 * halo) * wq * n
                + tiles * FWD_BM - m_valid)
    shifts = (tuple(guard + (dy * wq + dx - 1) * n for dy in range(3)
                    for dx in range(3)) if taps == 9 else (0,))
    return FwdInt8Layout(n, h, w, cin, taps, rch, cp, bk, wq, halo, guard,
                         h // rch, FWD_BM, m_valid, tiles, slab_len, shifts)


def _place(q, lay):
    """Each chunk's rows [K, N, rows, w, C] (rows with the halo, zero
    outside the image) laid out as the slabs of layout ``lay`` [K,
    slab_len, cp]: the pad column, pad channels, guards and tile tail
    zero."""
    q = F.pad(q, (0, lay.cp - lay.cin, 0, lay.wq - lay.w))
    if lay.halo:   # images innermost
        q = q.permute(0, 2, 3, 1, 4)
    body = q.reshape(lay.chunks, -1, lay.cp)
    tail = lay.tiles * lay.bm - lay.m_valid
    return F.pad(body, (0, 0, lay.guard, lay.guard + tail))


def _fwd_slab(v, rowmax, lay):
    """v [N, h, w, C] f32 quantized per chunk at its scale (halo rows
    included for the 3x3) into the slabs of layout ``lay``: int8 [h/rch,
    slab_len, cp]."""
    inv, _ = _quant_params(chunk_amax(rowmax, lay.rch, lay.halo))
    q = _q(_slabs(v, lay.rch, lay.halo),
           inv.reshape(-1, 1, 1, 1, 1))            # [K, N, rows, w, C]
    return _place(q, lay).to(torch.int8)


def fwd_pre_plain(x, s, t, res, rowmax, *, conv, mode, rch):
    """The int8 forward's slabs (int8 [h/rch, slab_len, cp],
    ``fwd_int8_layout``): each chunk's a (with its halo rows for the 3x3)
    quantized at the chunk's scale, as ``fwd_conv_plain`` quantizes it."""
    n, h, w, cin = x.shape
    return _fwd_slab(prologue_plain(x, s, t, res, mode), rowmax,
                     fwd_int8_layout(n, h, w, cin, _taps(conv), rch))


def _pack_w_fwd(wq, lay):
    """wq [Cout, taps*Cin] -> [Cout, taps*cp]: each tap's channels padded
    with zeros to the slab's cp."""
    cout = wq.shape[0]
    if lay.cp == lay.cin:
        return wq
    return F.pad(wq.reshape(cout, lay.taps, lay.cin),
                 (0, lay.cp - lay.cin)).reshape(cout, -1).contiguous()


def fwd_tile(cout: int, lay: FwdInt8Layout):
    """(bn, bk) of the int8 forward's mainloop: a 128-wide N tile where
    Cout >= 128 (A read ceil(Cout/128) times), else 64; the layout's K
    step."""
    return (128 if cout >= 128 else 64), lay.bk


def _slab_conv(slab, wq, lay, shifts):
    """[N, h, w, Nout] float64: per chunk the exact contraction of the
    slabs of layout ``lay``, tap t's rows read at ``shifts[t]``, with the
    weights wq [Nout, taps*Cin] (tap t's columns), the pad column and the
    tail dropped."""
    nout, m_pad = wq.shape[0], lay.tiles * lay.bm
    wt = _pack_w_fwd(wq, lay).to(f64).reshape(nout, lay.taps, lay.cp)
    acc = sum(slab[:, sh:sh + m_pad].to(f64) @ wt[:, t].t()
              for t, sh in enumerate(shifts))   # [K, m_pad, Nout]
    acc = acc[:, :lay.m_valid]
    if lay.halo:   # (r, c, i) -> (i, r, c), the pad column dropped
        acc = acc.reshape(lay.chunks, lay.rch, lay.wq, lay.n,
                          nout)[:, :, :lay.w].permute(0, 3, 1, 2, 4)
    return acc.reshape(lay.chunks, lay.n, lay.rch, lay.w, nout).transpose(
        0, 1).reshape(lay.n, lay.h, lay.w, nout)


def fwd_gemm_plain(slab, rowmax, wq, ws, lay):
    """(y [N, h, w, Cout] bf16, zsum, zssq [Cout] f32) from the slabs of
    layout ``lay``: per chunk the exact contraction (float64) of each tap's
    shifted slab rows with its weights, the pad column and the tail
    dropped, y = bf16(f32(acc) * f32(ws * scale)), the sums per chunk then
    across chunks in order."""
    acc = _slab_conv(slab, wq, lay, lay.shifts)
    scale = chunk_amax(rowmax, lay.rch, lay.halo) * INV_127
    y = _dequant(acc, ws, scale, lay.rch).to(torch.bfloat16)
    yb = y.to(f32)
    return y, _ordered_sum(yb, lay.rch), _ordered_sum(yb * yb, lay.rch)


def dgrad_pre_plain(dy, y, dzsum, dzssq, rowmax_g, *, conv, rch):
    """The int8 input gradient's slabs (int8 [h/rch, slab_len, cp],
    ``fwd_int8_layout`` at Cin = the half's Cout): each chunk's g (with its
    halo rows for the 3x3) quantized at the chunk's scale, as
    ``dgrad_conv_plain`` quantizes it."""
    n, h, w, cout = dy.shape
    return _fwd_slab(fold_plain(dy, y, dzsum, dzssq), rowmax_g,
                     fwd_int8_layout(n, h, w, cout, _taps(conv), rch))


def dgrad_gemm_plain(slab, rowmax_g, wq_dg, ws_in, x, s, t, res, dxout, lay,
                     *, mode):
    """(dx, ds, dt, dres) as ``dgrad_conv_plain``'s, from the cotangent's
    slabs of layout ``lay``: per chunk the exact contraction (float64) of
    the slab rows at each forward tap's mirrored shift (tap t reads
    ``shifts[taps - 1 - t]``: g at (r - dy + 1, c - dx + 1)) with wq_dg
    [Cin, taps*Cout] (forward tap coordinates), da = f32(acc) * f32(ws_in
    * scale) (entry mode: one fused multiply-add with dx_res), then the
    prologue's backward."""
    acc = _slab_conv(slab, wq_dg, lay, lay.shifts[::-1])
    scale = chunk_amax(rowmax_g, lay.rch, lay.halo) * INV_127
    da = _dequant(acc, ws_in, scale, lay.rch,
                  add=dxout.to(f32) if mode == "entry" else None)
    return _prologue_bwd(da, x, s, t, res, mode, lay.rch)


def dgrad_bf16_layout(n: int, h: int, w: int, cout: int,
                      taps: int) -> FwdInt8Layout:
    """Where the bf16 input gradient's prepass writes bf16(g) and where its
    GEMM reads it: ``fwd_int8_layout`` at Cin = the half's Cout and one
    chunk of h rows (the bf16 body has no scale groups), its ``cp``
    channels a position of bf16 elements: the 3x3's images innermost with
    a zero column after each row and guards of n positions, no halo row
    twice; the 1x1 plain NHWC and the tile tail."""
    return fwd_int8_layout(n, h, w, cout, taps, h)


def dgrad_bf16_pre_plain(dy, y, dzsum, dzssq, *, conv):
    """The bf16 input gradient's slab (bf16 [1, slab_len, cp],
    ``dgrad_bf16_layout``): g = (dy + dzsum) + (2y) * dzssq rounded to
    bf16 once, as ``dgrad_conv_bf16_plain`` rounds it; zeros at the pad
    column, pad channels, guards, the rows outside the image and the tile
    tail."""
    n, h, w, cout = dy.shape
    lay = dgrad_bf16_layout(n, h, w, cout, _taps(conv))
    g = fold_plain(dy, y, dzsum, dzssq).to(torch.bfloat16)
    return _place(_slabs(g, h, lay.halo), lay).contiguous()


def dgrad_bf16_gemm_plain(slab, wb_dg, x, s, t, res, dxout, lay, *, mode):
    """(dx, ds, dt, dres) as ``dgrad_conv_bf16_plain``'s, from the bf16
    slab of layout ``lay`` (``dgrad_bf16_layout``): the contraction
    (float64, each bf16 product exact) of the slab rows at each forward
    tap's mirrored shift (tap t reads ``shifts[taps - 1 - t]``: g at (r -
    dy + 1, c - dx + 1)) with wb_dg [Cin, taps*Cout] (forward tap
    coordinates), rounded to f32, dx_res added in entry mode, then the
    prologue's backward (the sums in one chunk)."""
    da = _slab_conv(slab, wb_dg, lay, lay.shifts[::-1]).to(f32)
    if mode == "entry":
        da = da + dxout.to(f32)
    return _prologue_bwd(da, x, s, t, res, mode, lay.rch)


# --- kernels -----------------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None
_BM = 128  # output rows per block of the GEMM kernels (csrc/bneck_nv_train.cu)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from pytorch_ddp_resnet_tpu_torch.ops.cuda import build

        lib = build.load("bneck_nv_train")
        sigs = {
            "nvt_rowmax_act_launch": [_P] * 4 + [_I] + [_P] * 2 + [_I] * 5
            + [_P],
            "nvt_rowmax_cot_launch": [_P] * 5 + [_I] * 5 + [_P],
            "nvt_fwd_pre_launch": [_P] * 4 + [_I] + [_P] * 2 + [_I] * 10
            + [_P],
            "nvt_fwd_s8_launch": [_P] * 7 + [_I] * 12 + [_P],
            "nvt_dgrad_pre_launch": [_P] * 6 + [_I] * 10 + [_P],
            "nvt_dgrad_s8_launch": [_P] * 9 + [_I] + [_P] * 4 + [_I] * 11
            + [_P],
            "nvt_dgrad_sum_launch": [_P, _P, _I, _I, _P],
            "nvt_wgrad_pre_launch": [_P] * 4 + [_I] + [_P] * 8 + [_I] * 12
            + [_P],
            "nvt_wgrad_s8_launch": [_P] * 4 + [_I] * 12 + [_P],
            "nvt_wgrad_sum_launch": [_P] * 4 + [_I] * 6 + [_P],
            "nvt_sum_launch": [_P, _P, _I, _I, _P],
            "nvt_fwd_bf16_launch": [_P] * 4 + [_I] + [_P] * 4 + [_I] * 6
            + [_P],
            "nvt_dgrad_pre_bf16_launch": [_P] * 5 + [_I] * 9 + [_P],
            "nvt_dgrad_bf16_launch": [_P] * 7 + [_I] + [_P] * 3 + [_I] * 11
            + [_P],
            "nvt_dgrad_bf16_sum_launch": [_P, _P, _I, _I, _P],
            "nvt_wgrad_pre_bf16_launch": [_P] * 4 + [_I] + [_P] * 6
            + [_I] * 5 + [_P],
            "nvt_wgrad_staged_bf16_launch": [_P] * 3 + [_I] * 12 + [_P],
            "nvt_wgrad_staged_bf16_sum_launch": [_P] * 2 + [_I] * 6 + [_P],
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


def _launch(name: str, fn, *args) -> None:
    check_rc(name, fn(*args))
    launches[name] += 1


def _vecs(*vs):
    """f32, contiguous and 16-byte aligned (a slice of a sums buffer may
    not be)."""
    out = []
    for v in vs:
        if v is not None:
            v = v.to(f32).contiguous()
            if v.data_ptr() % 16:
                v = v.clone()
        out.append(v)
    return out


def _require(name, x, mode, s, t, res, extra=(), extra_dtypes=()):
    """The kernels' needs of a half's prologue operands: bf16 NHWC x (and
    res), f32 s/t, channels a multiple of 8, all contiguous and aligned."""
    n, h, w, c = x.shape
    if c % 8:
        raise ValueError(f"{name}: C={c} is not a multiple of 8")
    tensors, dtypes = [x], [torch.bfloat16]
    if mode != "identity":
        tensors += [s, t]
        dtypes += [f32, f32]
    if mode == "entry":
        tensors.append(res)
        dtypes.append(torch.bfloat16)
    require_cuda(name, tensors + list(extra), dtypes + list(extra_dtypes))


def _taps(conv: str) -> int:
    return 9 if conv == "3x3" else 1


def _check_rch(name: str, h: int, rch: int) -> None:
    if rch < 1 or h % rch:
        raise ValueError(f"{name}: row chunk {rch} does not divide h={h}")


def _slab_bytes(name, lay, elem, n, h, w):
    """Raises where one slab of layout ``lay`` would pass 2 GB (the
    kernels' 32-bit unit counts)."""
    if lay.slab_len * lay.cp * elem >= 2 ** 31:
        raise ValueError(f"{name}: a chunk's slab of {lay.slab_len} x "
                         f"{lay.cp} x {elem} bytes at N={n}, h={h}, w={w}, "
                         f"rch={lay.rch} exceeds 2 GB")


def _sums(name: str, part: torch.Tensor) -> torch.Tensor:
    """out[i] = sum over j of part[j, i] in f32, in a fixed tree."""
    j, m = part.shape
    out = torch.empty(m, dtype=f32, device=part.device)
    _launch(name, _library().nvt_sum_launch, part.data_ptr(), out.data_ptr(),
            j, m, _stream(part))
    return out


WGRAD_BK = 64  # positions per K step (csrc/wgrad_staged.cuh K_STEP)


@functools.lru_cache(maxsize=None)
def wgrad_bf16_plan(n: int, h: int, w: int, cin: int, cout: int, taps: int,
                    rch: int) -> WgradPlan:
    """The bf16 wgrad's tiles and splits: 64-row tiles where taps*Cin <=
    64 (a 1x1 with Cin = 64), 64-wide where Cout <= 64, else 128 (also
    at WRN's Cout = 160 and 320, where the 128-wide tile pads more
    columns: it ran 4% and 10% faster there on an H100,
    tools/bench_fused_wgrad_bf16.py --tiles); the splits that minimize
    the model's time (whole waves of blocks times their K steps, plus the
    split tiles' traffic), the fewest among equals, none empty. Also the
    fused half's wgrad (ops/cuda/fused_block.py: one chunk of h rows, nine
    taps). Cached: every call of the wgrad asks."""
    steps = -(-n * rch * w // WGRAD_BK)
    return split_plan(taps * cin, cout, h // rch, steps, WGRAD_BK)


@functools.lru_cache(maxsize=None)
def wgrad_int8_plan(n: int, h: int, w: int, cin: int, cout: int, taps: int,
                    rch: int) -> WgradPlan:
    """The int8 wgrad's tiles and splits, by ``wgrad_bf16_plan``'s rules
    and cost model, over the K steps of ``wgrad_int8_layout`` (each 128
    positions: the bf16 step's bytes). Cached: every call of the wgrad
    asks."""
    lay = wgrad_int8_layout(n, h, w, taps, rch)
    return split_plan(taps * cin, cout, lay.chunks, lay.steps, lay.bk)


def fwd_rowmax(x, s, t, res, *, mode):
    """The row maxima of |a| ([h] f32, exact) and, in entry mode, x_res =
    bf16(a)."""
    if on_cpu(x):
        return fwd_rowmax_plain(x, s, t, res, mode=mode)
    name = "nv_half_fwd.amax"
    s, t = _vecs(s, t)
    _require(name, x, mode, s, t, res)
    n, h, w, c = x.shape
    rowmax = torch.zeros(h, dtype=f32, device=x.device)
    x_res = torch.empty_like(x) if mode == "entry" else None
    _launch(name, _library().nvt_rowmax_act_launch, x.data_ptr(), _ptr(res),
            _ptr(s), _ptr(t), MODES.index(mode), _ptr(x_res),
            rowmax.data_ptr(), n, h, w, c, max(1, -(-528 // h)), _stream(x))
    return rowmax, x_res


def fwd_pre(x, s, t, res, rowmax, *, conv, mode, rch):
    """The int8 forward's slabs (int8 [h/rch, slab_len, cp],
    ``fwd_int8_layout``): each chunk's activation quantized once at the
    chunk's scale, halo rows included. One launch."""
    if on_cpu(x):
        return fwd_pre_plain(x, s, t, res, rowmax, conv=conv, mode=mode,
                             rch=rch)
    name = "nv_half_fwd.pre"
    n, h, w, cin = x.shape
    _check_rch(name, h, rch)
    s, t = _vecs(s, t)
    _require(name, x, mode, s, t, res, [rowmax], [f32])
    if rowmax.shape != (h,):
        raise ValueError(f"{name}: row maxima {tuple(rowmax.shape)} vs h={h}")
    lay = fwd_int8_layout(n, h, w, cin, _taps(conv), rch)
    _slab_bytes(name, lay, 1, n, h, w)
    slab = torch.empty((lay.chunks, lay.slab_len, lay.cp), dtype=torch.int8,
                       device=x.device)
    _launch(name, _library().nvt_fwd_pre_launch, x.data_ptr(), _ptr(res),
            _ptr(s), _ptr(t), MODES.index(mode), rowmax.data_ptr(),
            slab.data_ptr(), n, h, w, cin, rch, lay.halo, lay.cp, lay.wq,
            lay.guard, lay.slab_len, _stream(x))
    return slab


def fwd_gemm(slab, rowmax, wq, ws, lay):
    """(y [N, h, w, Cout] bf16, zsum, zssq [Cout] f32) from the slabs of
    layout ``lay``: the exact s32 contraction over (tap, channel) on
    128-row tiles of one chunk each, y = bf16(f32(acc) * f32(ws * scale))
    with the tile's one scale, and each tile's sums of y and y^2 added in a
    fixed order (bit for bit the same every run)."""
    if on_cpu(slab):
        return fwd_gemm_plain(slab, rowmax, wq, ws, lay)
    name = "nv_half_fwd"
    cout = wq.shape[0]
    if tuple(slab.shape) != (lay.chunks, lay.slab_len, lay.cp):
        raise ValueError(f"{name}: slab {tuple(slab.shape)} is not of the "
                         f"layout ({lay.chunks}, {lay.slab_len}, {lay.cp})")
    if tuple(wq.shape) != (cout, lay.taps * lay.cin) or cout % 8:
        raise ValueError(f"{name}: weights {tuple(wq.shape)} vs Cin "
                         f"{lay.cin}")
    if rowmax.shape != (lay.h,):
        raise ValueError(f"{name}: row maxima {tuple(rowmax.shape)} vs "
                         f"h={lay.h}")
    if lay.chunks * lay.tiles > 65535:
        raise ValueError(f"{name}: {lay.chunks} chunks x {lay.tiles} tiles "
                         f"at N={lay.n}, h={lay.h}, w={lay.w} exceed the "
                         f"grid")
    (ws,) = _vecs(ws)
    require_cuda(name, [slab, rowmax, wq, ws],
                 [torch.int8, f32, torch.int8, f32])
    wp = _pack_w_fwd(wq, lay)
    y = torch.empty((lay.n, lay.h, lay.w, cout), dtype=torch.bfloat16,
                    device=slab.device)
    part = torch.empty((lay.chunks * lay.tiles, 2 * cout), dtype=f32,
                       device=slab.device)
    shifts = (ctypes.c_int * lay.taps)(*lay.shifts)
    _launch(name, _library().nvt_fwd_s8_launch, slab.data_ptr(),
            wp.data_ptr(), ws.data_ptr(), rowmax.data_ptr(), y.data_ptr(),
            part.data_ptr(), ctypes.addressof(shifts), lay.n, lay.h, lay.w,
            cout, lay.taps, lay.rch, lay.cp, lay.wq, lay.tiles, lay.slab_len,
            *fwd_tile(cout, lay), _stream(slab))
    sums = _sums(f"{name}.sum", part)
    return y, sums[:cout], sums[cout:]


def fwd_conv(x, s, t, res, rowmax, wq, ws, *, conv, mode, rch):
    """The forward half on its activation's row maxima: (y [N, h, w, Cout]
    bf16, zsum, zssq [Cout] f32) (``fwd_pre``, then ``fwd_gemm``)."""
    if on_cpu(x):
        return fwd_conv_plain(x, s, t, res, rowmax, wq, ws, conv=conv,
                              mode=mode, rch=rch)
    n, h, w, cin = x.shape
    cout, taps = wq.shape[0], _taps(conv)
    if tuple(wq.shape) != (cout, taps * cin) or cout % 8:
        raise ValueError(f"nv_half_fwd: weights {tuple(wq.shape)} vs Cin "
                         f"{cin}")
    slab = fwd_pre(x, s, t, res, rowmax, conv=conv, mode=mode, rch=rch)
    return fwd_gemm(slab, rowmax, wq, ws,
                    fwd_int8_layout(n, h, w, cin, taps, rch))


def fwd_conv_bf16(x, s, t, res, wb, *, conv, mode, rch):
    """The bf16 forward half: (y [N, h, w, Cout] bf16, zsum, zssq [Cout]
    f32, x_res bf16 in entry mode, else None). ``rch`` orders the plain
    version's sums; the kernel has no chunks."""
    if on_cpu(x):
        return fwd_conv_bf16_plain(x, s, t, res, wb, conv=conv, mode=mode,
                                   rch=rch)
    name = "nv_half_fwd_bf16"
    n, h, w, cin = x.shape
    cout, taps = wb.shape[0], _taps(conv)
    if tuple(wb.shape) != (cout, taps * cin) or cout % 8:
        raise ValueError(f"{name}: weights {tuple(wb.shape)} vs Cin {cin}")
    if mode == "entry" and taps != 1:
        raise ValueError(f"{name}: entry mode is a 1x1 half")
    _check_rch(name, h, rch)
    s, t = _vecs(s, t)
    _require(name, x, mode, s, t, res, [wb], [torch.bfloat16])
    y = torch.empty((n, h, w, cout), dtype=torch.bfloat16, device=x.device)
    x_res = torch.empty_like(x) if mode == "entry" else None
    part = torch.empty((-(-n * h * w // _BM), 2 * cout), dtype=f32,
                       device=x.device)
    _launch(name, _library().nvt_fwd_bf16_launch, x.data_ptr(), _ptr(res),
            _ptr(s), _ptr(t), MODES.index(mode), wb.data_ptr(), y.data_ptr(),
            part.data_ptr(), _ptr(x_res), n, h, w, cin, cout, taps,
            _stream(x))
    sums = _sums(f"{name}.sum", part)
    return y, sums[:cout], sums[cout:], x_res


def _require_cot(name, dy, y, dzsum, dzssq):
    if dy.shape != y.shape or dy.shape[-1] % 8:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} vs y "
                         f"{tuple(y.shape)}")
    require_cuda(name, [dy, y, dzsum, dzssq],
                 [torch.bfloat16, torch.bfloat16, f32, f32])


def bwd_rowmax(dy, y, dzsum, dzssq):
    """The row maxima of |g| ([h] f32), g = (dy + dzsum) + (2y) * dzssq."""
    if on_cpu(dy):
        return bwd_rowmax_plain(dy, y, dzsum, dzssq)
    name = "nv_half_bwd.amax"
    dzsum, dzssq = _vecs(dzsum, dzssq)
    _require_cot(name, dy, y, dzsum, dzssq)
    n, h, w, c = dy.shape
    rowmax = torch.zeros(h, dtype=f32, device=dy.device)
    _launch(name, _library().nvt_rowmax_cot_launch, dy.data_ptr(),
            y.data_ptr(), dzsum.data_ptr(), dzssq.data_ptr(),
            rowmax.data_ptr(), n, h, w, c, max(1, -(-528 // h)), _stream(dy))
    return rowmax


def dgrad_pre(dy, y, dzsum, dzssq, rowmax_g, *, conv, rch):
    """The int8 input gradient's slabs (int8 [h/rch, slab_len, cp],
    ``fwd_int8_layout`` at Cin = the half's Cout): each chunk's cotangent g
    = (dy + dzsum) + (2y) * dzssq quantized once at the chunk's scale, halo
    rows included. One launch."""
    if on_cpu(dy):
        return dgrad_pre_plain(dy, y, dzsum, dzssq, rowmax_g, conv=conv,
                               rch=rch)
    name = "nv_half_dgrad.pre"
    n, h, w, cout = dy.shape
    _check_rch(name, h, rch)
    dzsum, dzssq = _vecs(dzsum, dzssq)
    _require_cot(name, dy, y, dzsum, dzssq)
    require_cuda(name, [rowmax_g], [f32])
    if rowmax_g.shape != (h,):
        raise ValueError(f"{name}: row maxima {tuple(rowmax_g.shape)} vs "
                         f"h={h}")
    lay = fwd_int8_layout(n, h, w, cout, _taps(conv), rch)
    _slab_bytes(name, lay, 1, n, h, w)
    slab = torch.empty((lay.chunks, lay.slab_len, lay.cp), dtype=torch.int8,
                       device=dy.device)
    _launch(name, _library().nvt_dgrad_pre_launch, dy.data_ptr(),
            y.data_ptr(), dzsum.data_ptr(), dzssq.data_ptr(),
            rowmax_g.data_ptr(), slab.data_ptr(), n, h, w, cout, rch,
            lay.halo, lay.cp, lay.wq, lay.guard, lay.slab_len, _stream(dy))
    return slab


def dgrad_tile(cin: int) -> int:
    """The input gradients' N tile (int8 and bf16 bodies): 128 where Cin >=
    128 (the slab read ceil(Cin/128) times), else 64."""
    return 128 if cin >= 128 else 64


def _dgrad_checked(rowmax_g, wq_dg, ws_in, x, s, t, res, dxout, lay, mode):
    """The int8 GEMM's operands but the slab, checked before any launch of
    the input gradient: (s, t, ws_in) f32, contiguous and aligned."""
    name = "nv_half_dgrad"
    n, h, w, cin = x.shape
    if (n, h, w) != (lay.n, lay.h, lay.w):
        raise ValueError(f"{name}: x {tuple(x.shape)} vs the layout's "
                         f"({lay.n}, {lay.h}, {lay.w})")
    if tuple(wq_dg.shape) != (cin, lay.taps * lay.cin):
        raise ValueError(f"{name}: weights {tuple(wq_dg.shape)} vs Cout "
                         f"{lay.cin}")
    if rowmax_g.shape != (lay.h,):
        raise ValueError(f"{name}: row maxima {tuple(rowmax_g.shape)} vs "
                         f"h={lay.h}")
    if lay.chunks * lay.tiles > 65535:
        raise ValueError(f"{name}: {lay.chunks} chunks x {lay.tiles} tiles "
                         f"at N={n}, h={h}, w={w} exceed the grid")
    s, t, ws_in = _vecs(s, t, ws_in)
    extra, dts = [rowmax_g, wq_dg, ws_in], [f32, torch.int8, f32]
    if mode == "entry":
        extra.append(dxout)
        dts.append(torch.bfloat16)
    _require(name, x, mode, s, t, res, extra, dts)
    return s, t, ws_in


def _dgrad_launch(slab, rowmax_g, wq_dg, ws_in, x, s, t, res, dxout, lay,
                  mode):
    """The int8 GEMM and its sum on checked operands."""
    name = "nv_half_dgrad"
    n, h, w, cin = x.shape
    wp = _pack_w_fwd(wq_dg, lay)
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if mode == "entry" else None
    part = (torch.empty((lay.chunks * lay.tiles, 2 * cin), dtype=f32,
                        device=x.device) if mode != "identity" else None)
    shifts = (ctypes.c_int * lay.taps)(*lay.shifts[::-1])
    _launch(name, _library().nvt_dgrad_s8_launch, slab.data_ptr(),
            wp.data_ptr(), ws_in.data_ptr(), rowmax_g.data_ptr(),
            x.data_ptr(), _ptr(res), _ptr(dxout), _ptr(s), _ptr(t),
            MODES.index(mode), dx.data_ptr(), _ptr(dres), _ptr(part),
            ctypes.addressof(shifts), n, h, w, cin, lay.cp, lay.taps,
            lay.rch, lay.wq, lay.tiles, lay.slab_len, dgrad_tile(cin),
            _stream(x))
    if mode == "identity":
        return dx, None, None, None
    sums = torch.empty(2 * cin, dtype=f32, device=x.device)
    _launch(f"{name}.sum", _library().nvt_dgrad_sum_launch, part.data_ptr(),
            sums.data_ptr(), part.shape[0], 2 * cin, _stream(x))
    return dx, sums[:cin], sums[cin:], dres


def dgrad_gemm(slab, rowmax_g, wq_dg, ws_in, x, s, t, res, dxout, lay, *,
               mode):
    """(dx [N, h, w, Cin] bf16, ds, dt [Cin] f32 (None in identity mode),
    dres bf16 (entry mode)) from the cotangent's slabs of layout ``lay``:
    the exact s32 contraction over (mirrored tap, channel) on 128-row tiles
    of one chunk each, da = f32(acc) * f32(ws_in * scale) with the tile's
    one scale (entry mode: one fused multiply-add with dx_res), then the
    prologue's backward; each tile's sums of du * x and du added in a fixed
    order (bit for bit the same every run)."""
    if on_cpu(slab):
        return dgrad_gemm_plain(slab, rowmax_g, wq_dg, ws_in, x, s, t, res,
                                dxout, lay, mode=mode)
    if tuple(slab.shape) != (lay.chunks, lay.slab_len, lay.cp):
        raise ValueError(f"nv_half_dgrad: slab {tuple(slab.shape)} is not "
                         f"of the layout ({lay.chunks}, {lay.slab_len}, "
                         f"{lay.cp})")
    require_cuda("nv_half_dgrad", [slab], [torch.int8])
    s, t, ws_in = _dgrad_checked(rowmax_g, wq_dg, ws_in, x, s, t, res, dxout,
                                 lay, mode)
    return _dgrad_launch(slab, rowmax_g, wq_dg, ws_in, x, s, t, res, dxout,
                         lay, mode)


def dgrad_conv(dy, y, dzsum, dzssq, rowmax_g, wq_dg, ws_in, x, s, t, res,
               dxout, *, conv, mode, rch):
    """The input gradient through the prologue: (dx [N, h, w, Cin] bf16,
    ds, dt [Cin] f32 (None in identity mode), dres bf16 (entry mode))
    (``dgrad_pre``, then ``dgrad_gemm``; every operand checked before the
    first launch)."""
    if on_cpu(dy):
        return dgrad_conv_plain(dy, y, dzsum, dzssq, rowmax_g, wq_dg, ws_in,
                                x, s, t, res, dxout, conv=conv, mode=mode,
                                rch=rch)
    n, h, w, cout = dy.shape
    lay = fwd_int8_layout(n, h, w, cout, _taps(conv), rch)
    s, t, ws_in = _dgrad_checked(rowmax_g, wq_dg, ws_in, x, s, t, res, dxout,
                                 lay, mode)
    slab = dgrad_pre(dy, y, dzsum, dzssq, rowmax_g, conv=conv, rch=rch)
    return _dgrad_launch(slab, rowmax_g, wq_dg, ws_in, x, s, t, res, dxout,
                         lay, mode)


def dgrad_bf16_pre(dy, y, dzsum, dzssq, *, conv):
    """The bf16 input gradient's slab (bf16 [1, slab_len, cp],
    ``dgrad_bf16_layout``): the cotangent g = (dy + dzsum) + (2y) * dzssq
    rounded to bf16 once. One launch."""
    if on_cpu(dy):
        return dgrad_bf16_pre_plain(dy, y, dzsum, dzssq, conv=conv)
    name = "nv_half_dgrad_bf16.pre"
    n, h, w, cout = dy.shape
    dzsum, dzssq = _vecs(dzsum, dzssq)
    _require_cot(name, dy, y, dzsum, dzssq)
    lay = dgrad_bf16_layout(n, h, w, cout, _taps(conv))
    _slab_bytes(name, lay, 2, n, h, w)
    slab = torch.empty((1, lay.slab_len, lay.cp), dtype=torch.bfloat16,
                       device=dy.device)
    _launch(name, _library().nvt_dgrad_pre_bf16_launch, dy.data_ptr(),
            y.data_ptr(), dzsum.data_ptr(), dzssq.data_ptr(),
            slab.data_ptr(), n, h, w, cout, lay.halo, lay.cp, lay.wq,
            lay.guard, lay.slab_len, _stream(dy))
    return slab


def _dgrad_bf16_checked(wb_dg, x, s, t, res, dxout, lay, mode):
    """The bf16 GEMM's operands but the slab, checked before any launch of
    the input gradient: (s, t) f32, contiguous and aligned."""
    name = "nv_half_dgrad_bf16"
    n, h, w, cin = x.shape
    if (n, h, w) != (lay.n, lay.h, lay.w):
        raise ValueError(f"{name}: x {tuple(x.shape)} vs the layout's "
                         f"({lay.n}, {lay.h}, {lay.w})")
    if tuple(wb_dg.shape) != (cin, lay.taps * lay.cin):
        raise ValueError(f"{name}: weights {tuple(wb_dg.shape)} vs Cout "
                         f"{lay.cin}")
    if lay.tiles > 65535:
        raise ValueError(f"{name}: {lay.tiles} tiles at N={n}, h={h}, "
                         f"w={w} exceed the grid")
    _slab_bytes(name, lay, 2, n, h, w)
    s, t = _vecs(s, t)
    extra, dts = [wb_dg], [torch.bfloat16]
    if mode == "entry":
        extra.append(dxout)
        dts.append(torch.bfloat16)
    _require(name, x, mode, s, t, res, extra, dts)
    return s, t


def _dgrad_bf16_launch(slab, wb_dg, x, s, t, res, dxout, lay, mode):
    """The bf16 GEMM and its sum on checked operands."""
    name = "nv_half_dgrad_bf16"
    n, h, w, cin = x.shape
    wp = _pack_w_fwd(wb_dg, lay)
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if mode == "entry" else None
    part = (torch.empty((lay.tiles, 2 * cin), dtype=f32, device=x.device)
            if mode != "identity" else None)
    _launch(name, _library().nvt_dgrad_bf16_launch, slab.data_ptr(),
            wp.data_ptr(), x.data_ptr(), _ptr(res), _ptr(dxout), _ptr(s),
            _ptr(t), MODES.index(mode), dx.data_ptr(), _ptr(dres),
            _ptr(part), n, h, w, cin, lay.cp, lay.taps, lay.wq, lay.guard,
            lay.tiles, lay.slab_len, dgrad_tile(cin), _stream(x))
    if mode == "identity":
        return dx, None, None, None
    sums = torch.empty(2 * cin, dtype=f32, device=x.device)
    _launch(f"{name}.sum", _library().nvt_dgrad_bf16_sum_launch,
            part.data_ptr(), sums.data_ptr(), lay.tiles, 2 * cin,
            _stream(x))
    return dx, sums[:cin], sums[cin:], dres


def dgrad_bf16_gemm(slab, wb_dg, x, s, t, res, dxout, lay, *, mode):
    """(dx [N, h, w, Cin] bf16, ds, dt [Cin] f32 (None in identity mode),
    dres bf16 (entry mode)) from the bf16 slab of layout ``lay``
    (``dgrad_bf16_layout``): the f32 contraction over (mirrored tap,
    channel) on 128-row tiles, da = acc (entry mode: + dx_res), then the
    prologue's backward; each tile's sums of du * x and du added in a
    fixed order (the same bits every run)."""
    if on_cpu(slab):
        return dgrad_bf16_gemm_plain(slab, wb_dg, x, s, t, res, dxout, lay,
                                     mode=mode)
    if tuple(slab.shape) != (1, lay.slab_len, lay.cp) or lay.chunks != 1:
        raise ValueError(f"nv_half_dgrad_bf16: slab {tuple(slab.shape)} is "
                         f"not of the layout (1, {lay.slab_len}, {lay.cp})")
    require_cuda("nv_half_dgrad_bf16", [slab], [torch.bfloat16])
    s, t = _dgrad_bf16_checked(wb_dg, x, s, t, res, dxout, lay, mode)
    return _dgrad_bf16_launch(slab, wb_dg, x, s, t, res, dxout, lay, mode)


def dgrad_conv_bf16(dy, y, dzsum, dzssq, wb_dg, x, s, t, res, dxout, *,
                    conv, mode, rch):
    """The bf16 input gradient through the prologue: (dx, ds, dt, dres) as
    ``dgrad_conv``'s, from wb_dg [Cin, taps*Cout] bf16 (``dgrad_bf16_pre``,
    then ``dgrad_bf16_gemm``; every operand checked before the first
    launch). ``rch`` orders the plain version's sums; the kernels have one
    chunk."""
    if on_cpu(dy):
        return dgrad_conv_bf16_plain(dy, y, dzsum, dzssq, wb_dg, x, s, t,
                                     res, dxout, conv=conv, mode=mode,
                                     rch=rch)
    n, h, w, cout = dy.shape
    _check_rch("nv_half_dgrad_bf16", h, rch)
    dzsum, dzssq = _vecs(dzsum, dzssq)
    _require_cot("nv_half_dgrad_bf16", dy, y, dzsum, dzssq)
    lay = dgrad_bf16_layout(n, h, w, cout, _taps(conv))
    s, t = _dgrad_bf16_checked(wb_dg, x, s, t, res, dxout, lay, mode)
    slab = dgrad_bf16_pre(dy, y, dzsum, dzssq, conv=conv)
    return _dgrad_bf16_launch(slab, wb_dg, x, s, t, res, dxout, lay, mode)


def wgrad_bf16_pre(dy, y, dzsum, dzssq, x, s, t, res, *, mode):
    """The bf16 wgrad's operands, each rounded once, NHWC: (a_b = bf16(a),
    x itself in identity mode; g_b = bf16(g)). One launch writes both."""
    if on_cpu(dy):
        return wgrad_bf16_pre_plain(dy, y, dzsum, dzssq, x, s, t, res,
                                    mode=mode)
    name = "nv_half_wgrad_bf16.pre"
    dzsum, dzssq, s, t = _vecs(dzsum, dzssq, s, t)
    _require_cot(name, dy, y, dzsum, dzssq)
    _require(name, x, mode, s, t, res)
    n, h, w, cin = x.shape
    if dy.shape[:3] != x.shape[:3]:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} vs x "
                         f"{tuple(x.shape)}")
    a_b = x if mode == "identity" else torch.empty_like(x)
    g_b = torch.empty_like(dy)
    _launch(name, _library().nvt_wgrad_pre_bf16_launch, x.data_ptr(),
            _ptr(res), _ptr(s), _ptr(t), MODES.index(mode), dy.data_ptr(),
            y.data_ptr(), dzsum.data_ptr(), dzssq.data_ptr(),
            None if mode == "identity" else a_b.data_ptr(), g_b.data_ptr(),
            n, h, w, cin, dy.shape[-1], _stream(x))
    return a_b, g_b


def wgrad_bf16_gemm(a_b, g_b, *, conv, rch):
    """dW [taps*Cin, Cout] f32 from the rounded operands a_b [N, h, w, Cin]
    and g_b [N, h, w, Cout] bf16: each chunk's f32 contraction, split over
    blocks by ``wgrad_bf16_plan``, the splits then the chunks added in
    order (bit for bit the same every run)."""
    if on_cpu(a_b):
        return wgrad_bf16_gemm_plain(a_b, g_b, conv=conv, rch=rch)
    name = "nv_half_wgrad_bf16"
    n, h, w, cin = a_b.shape
    cout, taps = g_b.shape[-1], _taps(conv)
    if g_b.shape[:3] != a_b.shape[:3]:
        raise ValueError(f"{name}: a {tuple(a_b.shape)} and g "
                         f"{tuple(g_b.shape)} are not on one plane")
    if cin % 8 or cout % 8:
        raise ValueError(f"{name}: Cin={cin}, Cout={cout}: each must be a "
                         f"multiple of 8")
    _check_rch(name, h, rch)
    require_cuda(name, [a_b, g_b], [torch.bfloat16] * 2)
    plan = wgrad_bf16_plan(n, h, w, cin, cout, taps, rch)
    if plan.chunks * plan.splits > 65535:
        raise ValueError(f"{name}: {plan.chunks} chunks x {plan.splits} "
                         f"splits at N={n}, h={h}, w={w} exceed the grid")
    part = torch.empty((plan.chunks * plan.splits, taps * cin * cout),
                       dtype=f32, device=a_b.device)
    dw = torch.empty((taps * cin, cout), dtype=f32, device=a_b.device)
    lib, stream = _library(), _stream(a_b)
    _launch(name, lib.nvt_wgrad_staged_bf16_launch, a_b.data_ptr(),
            g_b.data_ptr(), part.data_ptr(), n, h, w, cin, cout, taps, rch,
            plan.bm, plan.bn, plan.bk, plan.per, plan.splits, stream)
    _launch(f"{name}.sum", lib.nvt_wgrad_staged_bf16_sum_launch,
            part.data_ptr(), dw.data_ptr(), h, cin, cout, taps, rch,
            plan.splits, stream)
    return dw


def wgrad_bf16(dy, y, dzsum, dzssq, x, s, t, res, *, conv, mode, rch):
    """The bf16 weight gradient, dW [taps*Cin, Cout] f32 in ``wgrad``'s
    rows: each chunk's f32 contraction of bf16(a) with bf16(g), added in
    chunk order (``wgrad_bf16_pre``, then ``wgrad_bf16_gemm``)."""
    if on_cpu(dy):
        return wgrad_bf16_plain(dy, y, dzsum, dzssq, x, s, t, res,
                                conv=conv, mode=mode, rch=rch)
    _check_rch("nv_half_wgrad_bf16", x.shape[1], rch)
    a_b, g_b = wgrad_bf16_pre(dy, y, dzsum, dzssq, x, s, t, res, mode=mode)
    return wgrad_bf16_gemm(a_b, g_b, conv=conv, rch=rch)


def wgrad_pre(dy, y, dzsum, dzssq, rowmax_g, x, s, t, res, rowmax_a, *,
              conv, mode, rch):
    """The int8 wgrad's slabs (a_slab [h/rch, Cin, la], g_slab [h/rch,
    Cout, lg] int8, ``wgrad_int8_layout``): each chunk's a and g quantized
    once at the chunk's scale, K contiguous. One launch writes both."""
    if on_cpu(dy):
        return wgrad_pre_plain(dy, y, dzsum, dzssq, rowmax_g, x, s, t, res,
                               rowmax_a, conv=conv, mode=mode, rch=rch)
    name = "nv_half_wgrad.pre"
    n, h, w, cin = x.shape
    cout = dy.shape[-1]
    _check_rch(name, h, rch)
    dzsum, dzssq, s, t = _vecs(dzsum, dzssq, s, t)
    _require_cot(name, dy, y, dzsum, dzssq)
    _require(name, x, mode, s, t, res, [rowmax_a, rowmax_g], [f32, f32])
    if dy.shape[:3] != x.shape[:3]:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} vs x "
                         f"{tuple(x.shape)}")
    if rowmax_a.shape != (h,) or rowmax_g.shape != (h,):
        raise ValueError(f"{name}: row maxima {tuple(rowmax_a.shape)}, "
                         f"{tuple(rowmax_g.shape)} vs h={h}")
    lay = wgrad_int8_layout(n, h, w, _taps(conv), rch)
    a_slab = torch.empty((lay.chunks, cin, lay.la), dtype=torch.int8,
                         device=x.device)
    g_slab = torch.empty((lay.chunks, cout, lay.lg), dtype=torch.int8,
                         device=x.device)
    _launch(name, _library().nvt_wgrad_pre_launch, x.data_ptr(), _ptr(res),
            _ptr(s), _ptr(t), MODES.index(mode), rowmax_a.data_ptr(),
            dy.data_ptr(), y.data_ptr(), dzsum.data_ptr(), dzssq.data_ptr(),
            rowmax_g.data_ptr(), a_slab.data_ptr(), g_slab.data_ptr(), n, h,
            w, cin, cout, rch, lay.halo, lay.n16, lay.wq, lay.guard, lay.la,
            lay.lg, _stream(x))
    return a_slab, g_slab


def wgrad_gemm(a_slab, g_slab, rowmax_a, rowmax_g, lay):
    """dW [taps*Cin, Cout] f32 from the slabs of layout ``lay``: each
    chunk's exact s32 contraction, split over blocks by
    ``wgrad_int8_plan``, the splits added then scaled, the chunks added in
    order (bit for bit the same every run)."""
    if on_cpu(a_slab):
        return wgrad_gemm_plain(a_slab, g_slab, rowmax_a, rowmax_g, lay)
    name = "nv_half_wgrad"
    chunks, cin, la = a_slab.shape
    cout, taps = g_slab.shape[1], lay.taps
    if (chunks, la) != (lay.chunks, lay.la) or tuple(g_slab.shape) != (
            lay.chunks, cout, lay.lg):
        raise ValueError(f"{name}: slabs {tuple(a_slab.shape)}, "
                         f"{tuple(g_slab.shape)} are not of the layout "
                         f"{lay.chunks} x C x ({lay.la}, {lay.lg})")
    if cin % 8 or cout % 8:
        raise ValueError(f"{name}: Cin={cin}, Cout={cout}: each must be a "
                         f"multiple of 8")
    if max(a_slab.numel(), g_slab.numel()) >= 2 ** 31:
        raise ValueError(f"{name}: slabs {tuple(a_slab.shape)}, "
                         f"{tuple(g_slab.shape)} exceed 2 GB")
    require_cuda(name, [a_slab, g_slab, rowmax_a, rowmax_g],
                 [torch.int8, torch.int8, f32, f32])
    plan = wgrad_int8_plan(lay.n, lay.h, lay.w, cin, cout, taps, lay.rch)
    part = torch.empty((chunks * plan.splits, taps * cin * cout),
                       dtype=torch.int32, device=a_slab.device)
    dw = torch.empty((taps * cin, cout), dtype=f32, device=a_slab.device)
    shifts = (ctypes.c_int * taps)(*lay.shifts)
    lib, stream = _library(), _stream(a_slab)
    _launch(name, lib.nvt_wgrad_s8_launch, a_slab.data_ptr(),
            g_slab.data_ptr(), part.data_ptr(), ctypes.addressof(shifts), cin,
            cout, taps, la, lay.lg, chunks, plan.bm, plan.bn, plan.bk,
            plan.steps, plan.per, plan.splits, stream)
    _launch(f"{name}.sum", lib.nvt_wgrad_sum_launch, part.data_ptr(),
            rowmax_a.data_ptr(), rowmax_g.data_ptr(), dw.data_ptr(), lay.h,
            cin, cout, taps, lay.rch, plan.splits, stream)
    return dw


def wgrad(dy, y, dzsum, dzssq, rowmax_g, x, s, t, res, rowmax_a, *, conv,
          mode, rch):
    """dW [taps*Cin, Cout] f32, rows in (dy, dx, ci) order: each chunk's
    exact s32 contraction times its scale, added in chunk order
    (``wgrad_pre``, then ``wgrad_gemm``)."""
    if on_cpu(dy):
        return wgrad_plain(dy, y, dzsum, dzssq, rowmax_g, x, s, t, res,
                           rowmax_a, conv=conv, mode=mode, rch=rch)
    slabs = wgrad_pre(dy, y, dzsum, dzssq, rowmax_g, x, s, t, res, rowmax_a,
                      conv=conv, mode=mode, rch=rch)
    n, h, w, _ = x.shape
    return wgrad_gemm(*slabs, rowmax_a, rowmax_g,
                      wgrad_int8_layout(n, h, w, _taps(conv), rch))


def _stage(name: str, plain: bool):
    return globals()[f"{name}_plain" if plain else name]


def half_stages(x, w, s, t, res, dy, dzsum, dzssq, dxout, *, conv, mode,
                rch, quant=True, quant_bwd=True, plain=False):
    """One half's forward and backward stages on given cotangents, through
    the wrappers (kernels on the card) or, with ``plain``, their plain
    versions: every intermediate and output by name (``rowmax_a`` and
    ``rowmax_g`` where an int8 body runs). ``rch``: the (fwd, dgrad, wgrad)
    row chunks; ``quant``/``quant_bwd`` pick the bodies as in the op."""
    kw = dict(conv=conv, mode=mode)
    out = {}
    if quant:
        wq, ws = _quant_w_fwd(conv)(w)
        rowmax_a, x_res = _stage("fwd_rowmax", plain)(x, s, t, res,
                                                       mode=mode)
        y, zsum, zssq = _stage("fwd_conv", plain)(
            x, s, t, res, rowmax_a, wq, ws, rch=rch[0], **kw)
        out["rowmax_a"] = rowmax_a
    else:
        y, zsum, zssq, x_res = _stage("fwd_conv_bf16", plain)(
            x, s, t, res, pack_w_bf16(w), rch=rch[0], **kw)
    cts = (dy, y, dzsum, dzssq)
    if quant_bwd:
        if not quant:   # the int8 wgrad's activation groups
            out["rowmax_a"] = _stage("fwd_rowmax", plain)(x, s, t, res,
                                                          mode=mode)[0]
        wq_dg, ws_in = _quant_w_dgrad(conv)(w)
        rowmax_g = _stage("bwd_rowmax", plain)(*cts)
        dx, ds, dt, dres = _stage("dgrad_conv", plain)(
            *cts, rowmax_g, wq_dg, ws_in, x, s, t, res, dxout, rch=rch[1],
            **kw)
        dw = _stage("wgrad", plain)(*cts, rowmax_g, x, s, t, res,
                                    out["rowmax_a"], rch=rch[2], **kw)
        out["rowmax_g"] = rowmax_g
    else:
        dx, ds, dt, dres = _stage("dgrad_conv_bf16", plain)(
            *cts, pack_w_bf16_dgrad(w), x, s, t, res, dxout, rch=rch[1],
            **kw)
        dw = _stage("wgrad_bf16", plain)(*cts, x, s, t, res, rch=rch[2],
                                         **kw)
    out.update(x_res=x_res, y=y, zsum=zsum, zssq=zssq, dx=dx, ds=ds, dt=dt,
               dres=dres, dw=dw)
    return out


def _quant_w_fwd(conv):
    return quantize_w_3x3 if conv == "3x3" else quantize_w_1x1


def _quant_w_dgrad(conv):
    return quantize_w_3x3_dgrad if conv == "3x3" else quantize_w_1x1_dgrad


# --- the differentiable op ---------------------------------------------------

class _NVHalf(torch.autograd.Function):
    """Forward and backward of one half: the int8 or bf16 forward
    (``quant``), the fully quantized or bf16 straight-through backward
    (``quant_bwd``). ``rch`` is the (fwd, dgrad, wgrad) row chunks."""

    @staticmethod
    def forward(ctx, x, res, w, s, t, conv, mode, rch, quant, quant_bwd):
        kw = dict(conv=conv, mode=mode, rch=rch[0])
        if quant:
            wq, ws = _quant_w_fwd(conv)(w.detach())
            rowmax_a, x_res = fwd_rowmax(x, s, t, res, mode=mode)
            y, zsum, zssq = fwd_conv(x, s, t, res, rowmax_a, wq, ws, **kw)
        else:
            rowmax_a = None
            y, zsum, zssq, x_res = fwd_conv_bf16(
                x, s, t, res, pack_w_bf16(w.detach()), **kw)
        ctx.save_for_backward(x, res, w, s, t, y, rowmax_a)
        ctx.cfg = (conv, mode, rch, quant_bwd)
        _record("fwd" if quant else "fwd_bf16", conv, mode, x, y)
        return (y, zsum, zssq, x_res) if mode == "entry" else (y, zsum, zssq)

    @staticmethod
    def backward(ctx, dy, dzsum, dzssq, dxout=None):
        x, res, w, s, t, y, rowmax_a = ctx.saved_tensors
        conv, mode, rch, quant_bwd = ctx.cfg
        cout = y.shape[-1]

        def zeros(g, like, shape):
            return torch.zeros(shape, dtype=like, device=y.device) \
                if g is None else g

        dy = zeros(dy, torch.bfloat16, y.shape).contiguous()
        dzsum = zeros(dzsum, f32, (cout,))
        dzssq = zeros(dzssq, f32, (cout,))
        if mode == "entry":
            dxout = zeros(dxout, torch.bfloat16, x.shape).contiguous()
        cts = (dy, y, dzsum, dzssq)
        kw = dict(conv=conv, mode=mode)
        if quant_bwd:
            if rowmax_a is None:   # a bf16 forward wrote no row maxima
                rowmax_a = fwd_rowmax(x, s, t, res, mode=mode)[0]
            wq_dg, ws_in = _quant_w_dgrad(conv)(w.detach())
            rowmax_g = bwd_rowmax(*cts)
            dx, ds, dt, dres = dgrad_conv(*cts, rowmax_g, wq_dg, ws_in, x, s,
                                          t, res, dxout, rch=rch[1], **kw)
            dw = wgrad(*cts, rowmax_g, x, s, t, res, rowmax_a, rch=rch[2],
                       **kw)
        else:
            dx, ds, dt, dres = dgrad_conv_bf16(
                *cts, pack_w_bf16_dgrad(w.detach()), x, s, t, res, dxout,
                rch=rch[1], **kw)
            dw = wgrad_bf16(*cts, x, s, t, res, rch=rch[2], **kw)
        body = "" if quant_bwd else "_bf16"
        _record("dgrad" + body, conv, mode, x, y)
        _record("wgrad" + body, conv, mode, x, y)
        cin = x.shape[-1]
        if conv == "3x3":   # [(dy, dx, ci), co] -> OIHW
            dw = dw.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
        else:
            dw = dw.t()[:, :, None, None]
        return (dx, dres, dw.to(w.dtype), ds, dt, None, None, None, None,
                None)


def _record(stage: str, conv: str, mode: str, x, y) -> None:
    if not on_cpu(x):
        n, h, w, cin = x.shape
        launch_shapes[(stage, conv, mode, n, h, w, cin, y.shape[-1])] += 1


def _checks(x, w_img):
    n, h, w, _ = x.shape
    if w_img != w:
        raise ValueError(f"w_img={w_img} but x is NHWC with w={w}")
    if n % 32 or n & (n - 1):
        raise ValueError(f"N={n} must be a pow2 multiple of 32 (the JAX "
                         f"kernels' int8 sublane tile)")
    return n, h, w


def _half(conv, x, w, s, t, res, mode, w_img, quant, quant_bwd, chunk_rows):
    n, h, w_ = _checks(x, w_img)
    cin, cout = w.shape[1], w.shape[0]
    if x.shape[-1] != cin:
        raise ValueError(f"x has {x.shape[-1]} channels, w takes {cin}")
    rch = ((chunk_rows,) * 3 if chunk_rows else
           pick_chunk_rows(h, w_, n, cin, cout, conv, mode))
    if mode != "identity":
        s, t = s.to(f32), t.to(f32)
    return _NVHalf.apply(x.contiguous(), res, w, s, t, conv, mode, rch,
                         bool(quant), bool(quant_bwd))


def nv_half_1x1(x, w, s=None, t=None, res=None, *, mode: str = "affine",
                w_img: int, quant: bool = True, quant_bwd: bool = True,
                chunk_rows: Optional[int] = None):
    """Differentiable 1x1-conv half (JAX ``nv_half_1x1``). x [N, h, w,
    Cin] bf16: the previous half's raw output, or a materialized
    activation in identity/entry modes; w [Cout, Cin, 1, 1] (OIHW); s, t
    [Cin] f32 (affine/entry); res [N, h, w, Cin] bf16 (entry). Returns (y
    [N, h, w, Cout] bf16, zsum, zssq [Cout] f32), plus x_res = bf16(relu(
    x*s + t + res)) in entry mode. ``quant``: the int8 forward, else bf16;
    ``quant_bwd``: the fully quantized backward, else the bf16
    straight-through one. ``chunk_rows`` forces one row chunk on all three
    stages (else the JAX pickers choose)."""
    if mode not in MODES:
        raise ValueError(f"mode={mode!r} not in {MODES}")
    if mode == "entry" and res is None:
        raise ValueError("entry mode needs a residual carrier")
    return _half("1x1", x, w, s, t, res if mode == "entry" else None, mode,
                 w_img, quant, quant_bwd, chunk_rows)


def nv_half_3x3(x, w, s=None, t=None, *, mode: str = "affine", w_img: int,
                quant: bool = True, quant_bwd: bool = True,
                chunk_rows: Optional[int] = None):
    """Differentiable stride-1 SAME 3x3-conv half (JAX ``nv_half_3x3``; no
    entry mode). w [Cout, Cin, 3, 3] (OIHW)."""
    if mode not in ("identity", "affine"):
        raise ValueError(f"3x3 half supports identity/affine, got {mode!r}")
    return _half("3x3", x, w, s, t, None, mode, w_img, quant, quant_bwd,
                 chunk_rows)
