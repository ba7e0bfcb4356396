"""Fused preact block-half in the channel-major layout [C, B*H*W], with a
bf16 or an int8 conv core (counterpart of
``pytorch_ddp_resnet_tpu/ops/pallas/fused_block.py``: ``fused_half``, and
``fused_half_int8`` with either backward).

One half computes, for x [Cin, N] (N = B*H*W image-major), the folded
BatchNorm affine (scale, shift) [Cin] f32, dropout bits and an optional
residual [Cout, N]:

    d  = dropout(relu(x * scale + shift))
    y  = conv3x3(d, w) (+ res, in bf16)
    ysum, yssq = per-channel f32 sums of y            (the next BN's stats)

Dropout bits are a [Cin, N] uint8 tensor, or a 0-d int32 seed from which
every kernel rebuilds the same mask in registers (``seed_bits``, the
reference's ``_seed_bits``): a murmur3 hash of each element's global index
row * N + lane, so the mask does not depend on any kernel's tiling.

**bf16 core** (``fused_half``, JAX ``quant=False``): d is rounded to bf16
after the affine and the dropout is taken in bf16; the conv accumulates in
f32 and y = bf16(acc). The backward folds the stats cotangents into
``gf = dy + dysum + 2*y*dyssq``, takes g = bf16(gf) (also the residual's
cotangent), runs the transposed conv against the rot180/swapped bf16
weights, masks it with ``x * scale + shift > 0`` (f32, unrounded) and the
kept bits, and contracts g with the recomputed bf16 d for dW in f32.
The int8 core with ``quant_bwd=False`` (QAT) uses this backward too, at
the unquantized point: the original weights cast to bf16 and the y of its
own int8 forward.

**int8 core** (``fused_half_int8``): the prologue in f32, then

    dq = s8(clip(rint(d * 127 / amax(group))))        per scale group
    y  = bf16(f32(conv3x3(dq, wq)) * ws * amax/127) (+ res, in bf16)

A *scale group* is a run of whole images: ``lane_tile`` lanes in the
forward, ``bwd_tile`` lanes in the backward, copies of the JAX pickers.
The tile decides the numbers, so every kernel honours it whatever its own
blocking. With ``quant_bwd=True`` (fully quantized training) the backward
quantizes gf once per group (floor 1e-30) and feeds the same int8
cotangent to the dgrad (against per-input-channel int8 weights, with the
relu/dropout masks recomputed from x) and to the wgrad (against the
recomputed activation, quantized per group). JAX fuses the two into one
TPU kernel where Cin <= 320 only to save TPU memory reads; the function is
the same on both of its routes.

Rounding points, as the reference computes them where the tests run it
(the JAX kernel in interpret mode, lowered by XLA on the CPU; pinned by
tests/test_torch_fused_block.py and tests/test_torch_fused_half_bf16.py):
``x * scale + shift`` is one fused multiply-add (then rounded to bf16 in
the bf16 core); the dropout keeps ``r * f32(256/thresh)`` (XLA rewrites
the kernel's division by the constant ``thresh/256`` as this multiply; in
bf16 the two round alike for every value); the stats fold ``(dy + dysum)
+ (2y) * dyssq`` is one fused multiply-add; the quantizers, dequantizers
and the bf16 residual add round each operation.

Layers of this module, each a CPU-or-card wrapper beside its plain version
(a CPU tensor runs the plain PyTorch version; a CUDA tensor launches the
kernel of ``csrc/fused_block.cu`` or ``csrc/fused_block_bf16.cu`` or
raises):

- ``fwd_int8``      (``fwd_int8_pre``, then ``fwd_int8_gemm``)
- ``fwd_int8_pre``  (launches ``fused_half_fwd.amax``, ``.pre``: the
  prologue quantized once per group, the codes written position-major
  into the padded slab of ``fused_fwd_layout``)
- ``fwd_int8_gemm`` (launches ``fused_half_fwd``, ``.sum`` with stats:
  the TMA-fed s8 wgmma GEMM of ``csrc/fwd_wgmma_s8.cuh`` on the K steps
  of ``fused_fwd_int8_plan``, dequantized per row, y written
  channel-major with the residual, the tiles' sums added in order)
- ``bwd_quantize``  (launches ``fused_half_bwd.amax``, ``.quant``)
- ``dgrad_conv``    (``dgrad_int8_pre``, then ``dgrad_int8_gemm``)
- ``dgrad_int8_pre`` (launches ``fused_half_dgrad.pre``: g_q's codes copied
  once into the padded slab of ``fused_fwd_int8_plan`` at Cin = the half's
  Cout)
- ``dgrad_int8_gemm`` (launches ``fused_half_dgrad``, ``.sum``: the
  forward's TMA-fed s8 wgmma mainloop on the slab and the dgrad-packed
  weights, a dequantizing, masking epilogue in ``csrc/dgrad_wgmma_s8.cuh``
  writing dx channel-major and each tile's sums, the tiles' sums added in
  order)
- ``wgrad``         (launches ``fused_half_wgrad``, and ``.sum`` where
  ``fused_wgrad_s8_plan`` splits the scale groups: the TMA + s8 wgmma
  mainloop of ``csrc/wgrad_wgmma_s8.cuh`` at the nine stride-1 taps,
  ``csrc/fused_wgrad_s8.cu``; dW HWIO)
- ``fwd_bf16``      (``fused_fwd_pre``, then ``fused_fwd_gemm``)
- ``fused_fwd_pre`` (launches ``fused_half_bf16_fwd.pre``: d computed once,
  written position-major into the padded slab of ``fused_fwd_layout``)
- ``fused_fwd_gemm`` (launches ``fused_half_bf16_fwd``, ``.sum`` with
  stats: the wgmma mainloop of ``csrc/fwd_wgmma_bf16.cuh``, y written
  channel-major with the residual, the tiles' sums added in order)
- ``dgrad_bf16``    (``dgrad_bf16_pre``, then ``dgrad_bf16_gemm``)
- ``dgrad_bf16_pre`` (launches ``fused_half_bf16_dgrad.pre``: g =
  bf16(gf) computed once, written position-major into the padded slab of
  ``fused_fwd_layout`` at Cin = the half's Cout, and dres = g where asked)
- ``dgrad_bf16_gemm`` (launches ``fused_half_bf16_dgrad``, ``.sum``: the
  forward's wgmma mainloop on the slab and the dgrad-packed weights, a
  masking epilogue in ``csrc/dgrad_wgmma_bf16.cuh`` writing dx
  channel-major and each tile's sums, the tiles' sums added in order)
- ``wgrad_bf16``    (``wgrad_bf16_pre``, then ``wgrad_bf16_gemm``)
- ``wgrad_bf16_pre`` (launches ``fused_half_bf16_wgrad.pre``: d and g
  rounded once, position-major)
- ``wgrad_bf16_gemm`` (launches ``fused_half_bf16_wgrad``, ``.sum``: the
  staged mainloop of ``csrc/wgrad_staged.cuh`` and its ordered sum)
- ``seed_bits_expand`` (launches ``seed_bits_expand``: the hash written out,
  for the card check only)

and ``fused_half`` and ``fused_half_int8``, the differentiable ops over
them. ``launches`` counts each kernel launch by name, ``seed_launches``
the launches that rebuilt their mask from a seed; plain calls count
nothing.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_ddp_resnet_tpu_torch.ops.cuda.bneck_nv_train import (
    wgrad_bf16_plan,
)
from pytorch_ddp_resnet_tpu_torch.ops.cuda.checks import (
    check_rc,
    on_cpu,
    require_cuda,
)
from pytorch_ddp_resnet_tpu_torch.ops.cuda.conv3x3 import (
    _conv_f64,
    pack_weights,
    pack_weights_dgrad,
    pad_rows,
    patches_f64,
    pick_tile,
)
from pytorch_ddp_resnet_tpu_torch.ops.cuda.wgrad_plan import (
    PART_BYTES_US,
    S8_BK,
    S8_BM,
    s8_model,
)

launches: collections.Counter = collections.Counter()
seed_launches: collections.Counter = collections.Counter()

# the reference's f32 constants (Python floats in JAX are weak-typed f32)
INV_127 = float(np.float32(1.0 / 127.0))
INV_16129 = float(np.float32(1.0 / (127.0 * 127.0)))
FWD_FLOOR = 1e-12   # absmax floor of the forward's activation groups
BWD_FLOOR = 1e-30   # ... and of the backward's cotangent/activation groups
# the int8 wgrad's N tiles (csrc/fused_wgrad_s8.cu): folding the scale
# groups in each block, and split over them into slots
WGRAD_FOLD_BNS = (128, 64, 32)
WGRAD_SLOT_BNS = (160, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_F32 = torch.float32


def reset_launches() -> None:
    launches.clear()
    seed_launches.clear()


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


# --- in-kernel dropout bits ------------------------------------------------------

SEED_INDEX_LIMIT = 2 ** 31  # the reference hashes row * N + lane in int32
_M32 = 0xFFFFFFFF


def is_seed(bits) -> bool:
    """True for a 0-d int32 tensor (seed mode), False for None or a
    [Cin, N] tensor (materialized bits); raises for anything else scalar,
    as the reference's ``_is_seed`` does."""
    if bits is None:
        return False
    if isinstance(bits, (int, float)):
        raise ValueError(
            "bits must be a 0-d int32 tensor (seed mode) or a [Cin, N] "
            f"uint8 tensor (materialized mode); got python "
            f"{type(bits).__name__}: wrap seeds as torch.tensor(seed, "
            "dtype=torch.int32).")
    if bits.dim() != 0:
        return False
    if bits.dtype != torch.int32:
        raise ValueError("a 0-d bits seed must be int32; got "
                         f"{bits.dtype}.")
    return True


def _mul32(a: torch.Tensor, k: int) -> torch.Tensor:
    """(a * k) mod 2^32 for int64 a in [0, 2^32): in two 16-bit halves of
    k, so no product leaves int64."""
    return ((a * (k & 0xFFFF)) + (((a * (k >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix(h: torch.Tensor, mixed: Optional[torch.Tensor] = None):
    h = h ^ (h >> 16)
    if mixed is not None:
        h = h ^ mixed
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def seed_bits(seed: torch.Tensor, cin: int, n_total: int, lane0: int,
              tile: int) -> torch.Tensor:
    """The plain version of the reference's ``_seed_bits``, bit for bit:
    uint8 [cin, tile] bits of lanes lane0 .. lane0 + tile - 1 of a
    [cin, n_total] tensor. uint32 arithmetic is int64 masked to 32 bits
    (torch has no uint32 multiply on the CPU); it wraps as the reference's
    int32 arithmetic with logical shifts."""
    s = seed.to(torch.int64).reshape(()) & _M32
    mixed = _fmix(s)
    dev = seed.device
    row = torch.arange(cin, dtype=torch.int64, device=dev)[:, None]
    lane = torch.arange(lane0, lane0 + tile, dtype=torch.int64,
                        device=dev)[None, :]
    h = (row * n_total + lane) & _M32
    h = (_mul32(h, 0x9E3779B1) + s) & _M32
    return (_fmix(h, mixed) >> 24).to(torch.uint8)


def mask_bits(bits, cin: int, n: int) -> Optional[torch.Tensor]:
    """The [cin, n] uint8 bits a half reads: ``bits`` itself, or the ones
    a seed expands to."""
    return seed_bits(bits, cin, n, 0, n) if is_seed(bits) else bits



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
    """d = dropout(relu(x * scale + shift)) in f32; bits a [Cin, N] uint8
    tensor, a seed, or None."""
    r = torch.clamp_min(_fma(x, _vec(scale), _vec(shift)), 0.0)
    bits = mask_bits(bits, *x.shape)
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
    dn = _masked(a, x, scale, shift, bits, thresh)
    dx = (dn * _vec(scale)).to(x.dtype)
    return dx, _group_sums(dn * x.to(_F32), tile), _group_sums(dn, tile)


def _masked(a, x, scale, shift, bits, thresh):
    """The dgrad through the prologue's masks, recomputed from x in f32
    (``x * scale + shift > 0`` unrounded, one fma) and the kept bits: dn =
    live ? a * f32(256/thresh) : 0."""
    live = _fma(x, _vec(scale), _vec(shift)) > 0
    bits = mask_bits(bits, *x.shape)
    if bits is not None:
        live = live & (bits.to(torch.int32) < thresh)
        a = a * inv_keep(thresh)
    return torch.where(live, a, torch.zeros_like(a))


def wgrad_plain(g_q, g_amax, d_q, d_amax, *, tile, h, w_img):
    """dW [3, 3, Cin, Cout] f32 (HWIO): per group the exact s32
    contraction (in float64), times (d_amax * g_amax) / 127^2, summed over
    the groups in order."""
    cout, n = g_q.shape
    out = None
    for g in range(n // tile):
        lanes = slice(g * tile, (g + 1) * tile)
        acc = g_q[:, lanes].to(torch.float64) @ patches_f64(
            d_q[:, lanes], h, w_img).T
        ts = (d_amax[g] * g_amax[g]) * INV_16129
        contrib = acc.to(_F32) * ts
        out = contrib if out is None else out + contrib
    return out.t().reshape(3, 3, d_q.shape[0], cout)


def prologue_bf16_plain(x, scale, shift, bits, thresh: Optional[int]):
    """d = dropout(relu(round(x * scale + shift))) in x's dtype: the affine
    is one fma rounded to x's dtype, and a kept value is round(r *
    f32(256/thresh))."""
    r = torch.clamp_min(_fma(x, _vec(scale), _vec(shift)).to(x.dtype), 0)
    bits = mask_bits(bits, *x.shape)
    if bits is None:
        return r
    kept = (r.to(_F32) * inv_keep(thresh)).to(x.dtype)
    return torch.where(bits.to(torch.int32) < thresh, kept,
                       torch.zeros_like(r))


def fwd_bf16_plain(x, w_packed, scale, shift, bits, res, *, thresh, h,
                   w_img, want_stats):
    """y = round(conv3x3(d)) (+ res, rounded) in x's dtype, and with
    ``want_stats`` the per-channel f32 sums of y and y^2."""
    d = prologue_bf16_plain(x, scale, shift, bits, thresh)
    y = _conv_f64(d, w_packed, h, w_img).to(_F32).to(x.dtype)
    if res is not None:
        y = res.to(x.dtype) + y
    if not want_stats:
        return y, None, None
    yf = y.to(_F32)
    return y, yf.sum(dim=1), (yf * yf).sum(dim=1)


class FusedFwdLayout(NamedTuple):
    """Where the bf16 forward's prepass writes d and where its GEMM reads
    it (``fused_fwd_layout``).

    The slab [slab_len, cp] bf16 is position-major, image-major, one
    plane: ``guard`` = w + 2 zero positions, then each image's per_img =
    (h + 1) * (w + 1) positions, a zero row above it and a zero column at
    the start of each row, so that live pixel (i, r, c) sits at M row m =
    i * per_img + (r + 1) * (w + 1) + c + 1, slab position guard + m; then
    zeros to whole tiles of ``bm`` M rows and a second guard. M row m of
    tap (dh, dw) reads slab position m + shifts[3 * dh + dw], shift =
    guard + (dh - 1) * (w + 1) + (dw - 1): one offset for every row,
    image and width, no masks. The live rows of a tile, in order, are one
    run of output lanes. Channels are padded to ``cp`` (a multiple of 8;
    Cin itself, which the forward's check makes a multiple of 8). The
    GEMM walks K = (tap, channel) in 128-byte steps, each 16-byte piece at
    its own tap, on ``tiles`` M tiles and N tiles of ``bn`` (160 where
    Cout % 160 == 0, else 128, or 64 up to Cout = 64)."""
    n: int
    h: int
    w: int
    cin: int
    cout: int
    b: int
    per_img: int
    guard: int
    bm: int
    m_valid: int
    tiles: int
    slab_len: int
    cp: int
    bn: int
    shifts: tuple


FUSED_FWD_BM = 128   # M rows a tile of csrc/fwd_wgmma_bf16.cuh


def check_fwd_bf16_geometry(name: str, cin: int, cout: int, n: int, h: int,
                            w_img: int) -> None:
    """The bf16 forward's own shape needs: Cin and Cout multiples of 8
    (16-byte pieces of a position or a weight row), whole images, N a
    multiple of 8 (16-byte runs of lanes, as the bf16 wgrad's prepass
    reads them too) and at most 65,535 M tiles of the slab (the grid's y);
    any image width. The bf16 dgrad, the forward's GEMM on the transposed
    conv, has the same needs with Cin and Cout swapped, and so has the
    bf16 backward as a whole (the wgrad's are a subset)."""
    if cin % 8 or cout % 8:
        raise ValueError(f"{name}: Cin={cin}, Cout={cout}: each must be a "
                         "multiple of 8")
    if h < 1 or w_img < 1 or n % (h * w_img) or n % 8:
        raise ValueError(f"{name}: geometry H={h} W={w_img} N={n} is not "
                         "supported by the kernel (whole images, N a "
                         "multiple of 8)")
    tiles = -(-(n // (h * w_img)) * (h + 1) * (w_img + 1) // FUSED_FWD_BM)
    if tiles > 65535:
        raise ValueError(f"{name}: {tiles} tiles exceed the grid")


@functools.lru_cache(maxsize=None)
def fused_fwd_layout(n: int, h: int, w_img: int, cin: int,
                     cout: int) -> FusedFwdLayout:
    """The bf16 forward's slab layout for x [Cin, n] of h x w_img images
    (see ``FusedFwdLayout``); any whole images (the kernels' own needs are
    ``check_fwd_bf16_geometry``'s). Cached: every call of the forward
    asks."""
    if h < 1 or w_img < 1 or n % (h * w_img) or cin < 1 or cout < 1:
        raise ValueError(f"fused_fwd_layout: H={h} W={w_img} N={n} Cin="
                         f"{cin} Cout={cout}")
    b = n // (h * w_img)
    per_img = (h + 1) * (w_img + 1)
    guard = w_img + 2
    m_valid = b * per_img
    tiles = -(-m_valid // FUSED_FWD_BM)
    bn = 160 if cout % 160 == 0 else (128 if cout > 64 else 64)
    shifts = tuple(guard + (dh - 1) * (w_img + 1) + dw - 1
                   for dh in range(3) for dw in range(3))
    return FusedFwdLayout(n, h, w_img, cin, cout, b, per_img, guard,
                          FUSED_FWD_BM, m_valid, tiles,
                          guard + tiles * FUSED_FWD_BM + guard,
                          -(-cin // 8) * 8, bn, shifts)


def fused_fwd_live_rows(lay: FusedFwdLayout) -> torch.Tensor:
    """The M rows of the live pixels, in lane order (image, row, column)."""
    i, r, c = torch.meshgrid(torch.arange(lay.b), torch.arange(lay.h),
                             torch.arange(lay.w), indexing="ij")
    return (i * lay.per_img + (r + 1) * (lay.w + 1) + c + 1).reshape(-1)


def _to_slab(d: torch.Tensor, lay: FusedFwdLayout) -> torch.Tensor:
    """d [Cin, N] written into the slab [slab_len, cp] of layout ``lay``,
    each pixel at its position, zeros at every pad position and pad
    channel, in d's dtype."""
    t = d.reshape(lay.cin, lay.b, lay.h, lay.w).permute(1, 2, 3, 0)
    t = F.pad(t, (0, lay.cp - lay.cin, 1, 0, 1, 0)).reshape(lay.m_valid,
                                                            lay.cp)
    return F.pad(t, (0, 0, lay.guard,
                     lay.slab_len - lay.guard - lay.m_valid)).contiguous()


def _from_slab(slab: torch.Tensor, lay: FusedFwdLayout) -> torch.Tensor:
    """The inverse of ``_to_slab``: [Cin, N] from the live positions."""
    rows = fused_fwd_live_rows(lay) + lay.guard
    return slab[rows.to(slab.device), :lay.cin].t().contiguous()


def fused_fwd_pre_plain(x, scale, shift, bits, *, thresh, lay):
    """The slab [slab_len, cp] of layout ``lay`` in x's dtype: the
    prologue's d (``prologue_bf16_plain``) at each pixel's position, zeros
    at every pad position and pad channel."""
    return _to_slab(prologue_bf16_plain(x, scale, shift, bits, thresh), lay)


def _slab_conv_f64(slab, w_packed, lay: FusedFwdLayout) -> torch.Tensor:
    """acc [Cout, N] float64: each tap's shifted slab rows at the live rows
    contracted with its packed weights ([Cout, 9 * Cin], K in (dh, dw, ci)
    order)."""
    rows = fused_fwd_live_rows(lay)
    wt = w_packed.to(torch.float64).reshape(lay.cout, 9, lay.cin)
    acc = sum(slab[rows + sh, :lay.cin].to(torch.float64) @ wt[:, t].t()
              for t, sh in enumerate(lay.shifts))        # [N, Cout]
    return acc.t().contiguous()


def fused_fwd_gemm_plain(slab, w_packed, res, *, lay, want_stats):
    """(y, ysum, yssq) from the slab of layout ``lay``: the contraction
    (float64) of each tap's shifted slab rows with its packed weights at
    the live rows, y = round(acc) (+ res, rounded) in the slab's dtype,
    and with ``want_stats`` the per-channel f32 sums of y and y^2."""
    y = _slab_conv_f64(slab, w_packed, lay).to(_F32).to(slab.dtype)
    if res is not None:
        y = res.to(slab.dtype) + y
    if not want_stats:
        return y, None, None
    yf = y.to(_F32)
    return y, yf.sum(dim=1), (yf * yf).sum(dim=1)


class FusedFwdInt8Plan(NamedTuple):
    """How the int8 forward's GEMM walks the slab (``fused_fwd_int8_plan``).

    ``lay`` is the bf16 forward's ``FusedFwdLayout`` with one byte a
    channel (cp = Cin). A K step is one TMA box of one tap, so no step
    spans two taps: ``boxes`` cut a tap's Cin bytes into (offset, width,
    swizzle) boxes, 128-byte ones, then one of 64 and one of 32 for the
    rest, each landing in the swizzle of its own width. ``steps`` are the
    K steps of every tile in order, (tap, A column, A row shift, B column,
    width): M tile y's step reads the A box of 128 slab rows from row y *
    128 + shift at that byte column, and the B box of ``bn`` weight rows
    from row x * bn at column tap * Cin + offset. ``grid`` is (N tiles, M
    tiles)."""
    lay: FusedFwdLayout
    boxes: tuple
    steps: tuple
    bn: int
    grid: tuple


# csrc/fwd_wgmma_s8.cuh's widest K step (bytes), and the runs of tiles of
# the forward's `.sum` (csrc/common.cuh tile_sum)
FWD_INT8_BOX = 128
FWD_SUM_RUNS = 32


def fwd_int8_boxes(cin: int) -> tuple:
    """One tap's Cin bytes as (offset, width, swizzle) boxes: 128-byte
    ones, then one of 64 and one of 32 for the rest (Cin % 32 == 0)."""
    if cin < 32 or cin % 32:
        raise ValueError(f"fwd_int8_boxes: Cin={cin} is not a positive "
                         "multiple of 32")
    whole = cin - cin % FWD_INT8_BOX
    out = [(o, FWD_INT8_BOX) for o in range(0, whole, FWD_INT8_BOX)]
    for width in (64, 32):
        if cin % FWD_INT8_BOX & width:
            out.append((whole, width))
            whole += width
    return tuple((o, wd, wd) for o, wd in out)


def check_fwd_int8_geometry(name: str, cin: int, cout: int, n: int, h: int,
                            w_img: int, tile: int) -> None:
    """The int8 forward's own shape needs: Cin a multiple of 32 (32-byte
    K steps), Cout a multiple of 8 (16-byte weight rows and output runs),
    whole images, N a multiple of 8 (16-byte runs of lanes), and scale
    groups of whole images, a multiple of 8 lanes, tiling N (the amax
    pass's 8-lane units); any image width. The int8 dgrad, the forward's
    GEMM on the transposed conv, has the same needs with Cin and Cout
    swapped."""
    if cin % 32 or cout % 8:
        raise ValueError(f"{name}: Cin={cin}, Cout={cout}: Cin must be a "
                         "multiple of 32 and Cout of 8")
    if h < 1 or w_img < 1 or n % (h * w_img) or n % 8:
        raise ValueError(f"{name}: geometry H={h} W={w_img} N={n} is not "
                         "supported by the kernel (whole images, N a "
                         "multiple of 8)")
    if tile < 8 or tile % 8 or tile % (h * w_img) or n % tile:
        raise ValueError(f"{name}: scale group of {tile} lanes at H={h} "
                         f"W={w_img} N={n}: whole images, a multiple of 8 "
                         "lanes, tiling N")


@functools.lru_cache(maxsize=None)
def fused_fwd_int8_plan(n: int, h: int, w_img: int, cin: int,
                        cout: int) -> FusedFwdInt8Plan:
    """The int8 forward's walk (see ``FusedFwdInt8Plan``) for x [Cin, n]
    of h x w_img images and Cout outputs. Cached: every call of the
    forward asks."""
    lay = fused_fwd_layout(n, h, w_img, cin, cout)
    boxes = fwd_int8_boxes(cin)
    steps = tuple((t, o, lay.shifts[t], t * cin + o, wd)
                  for t in range(9) for o, wd, _ in boxes)
    return FusedFwdInt8Plan(lay, boxes, steps, lay.bn,
                            (-(-cout // lay.bn), lay.tiles))


def fwd_int8_pre_plain(x, scale, shift, bits, *, thresh, tile, plan):
    """(slab [slab_len, Cin] int8 of ``plan``'s layout, amax [G] f32): the
    codes of ``fwd_quantize_plain`` at each pixel's slab position, zeros
    at every pad position."""
    d_q, amax = fwd_quantize_plain(x, scale, shift, bits, thresh=thresh,
                                   tile=tile)
    return _to_slab(d_q, plan.lay), amax


def fwd_int8_gemm_plain(slab, amax, w_q, ws, res, *, tile, plan,
                        want_stats):
    """``fwd_conv_plain`` of the codes the slab of ``plan``'s layout holds
    at its live positions."""
    lay = plan.lay
    return fwd_conv_plain(_from_slab(slab, lay), amax, w_q, ws, res,
                          tile=tile, h=lay.h, w_img=lay.w,
                          want_stats=want_stats)


def dgrad_int8_pre_plain(g_q, *, plan):
    """The int8 dgrad's operand: the slab [slab_len, Cout] int8 of
    ``plan``'s layout (``fused_fwd_int8_plan`` of the transposed conv:
    ``lay.cin`` = the half's Cout, ``lay.cout`` = its Cin) holding g_q's
    codes [Cout, N] at each pixel's position, zeros at every pad
    position."""
    return _to_slab(g_q, plan.lay)


def dgrad_int8_gemm_plain(slab, g_amax, w_dg, ws_in, x, scale, shift, bits,
                          *, thresh, tile, plan):
    """(dx [Cin, N] in x's dtype, d(scale), d(shift) [Cin] f32) from the
    slab of ``plan``'s layout: the exact contraction (float64) of each
    tap's shifted slab rows with the dgrad-packed weights w_dg [Cin,
    9 * Cout] at the live rows, rounded to f32, dequantized as
    ``dgrad_conv_plain`` (acc * (ws_in[ci] * (g_amax_g * 1/127)), g the
    lane's group of ``tile`` lanes), through the masks."""
    acc = _slab_conv_f64(slab, w_dg, plan.lay).to(_F32)
    a = _per_group(acc, tile, ws_in.to(_F32)[:, None]
                   * (g_amax * INV_127)[None, :])
    return _dgrad_epilogue(a, x, scale, shift, bits, thresh)


def _dgrad_epilogue(acc, x, scale, shift, bits, thresh):
    """(dx in x's dtype, d(scale), d(shift) f32, each sum over every lane at
    once) from the transposed conv's f32 acc [Cin, N] through the masks
    (``_masked``)."""
    dn = _masked(acc, x, scale, shift, bits, thresh)
    dx = (dn * _vec(scale)).to(x.dtype)
    return dx, (dn * x.to(_F32)).sum(dim=1), dn.sum(dim=1)


def dgrad_bf16_plain(dy, y, dysum, dyssq, w_dg, x, scale, shift, bits, *,
                     thresh, h, w_img, emit_res):
    """(dx [Cin, N] in x's dtype, d(scale), d(shift) [Cin] f32, dres): the
    transposed conv of g = round(gf) through the masks; dres = g when
    ``emit_res``."""
    g = fold_cotangent_plain(dy, y, dysum, dyssq).to(dy.dtype)
    acc = _conv_f64(g, w_dg, h, w_img).to(_F32)
    return (*_dgrad_epilogue(acc, x, scale, shift, bits, thresh),
            g if emit_res else None)


def dgrad_bf16_pre_plain(dy, y, dysum, dyssq, *, lay, emit_res):
    """The dgrad's operand: (the slab [slab_len, Cout] of layout ``lay``,
    the forward's layout of the transposed conv (``lay.cin`` = Cout,
    ``lay.cout`` = Cin), holding g = round(gf) at each pixel's position and
    zeros at every pad position; dres = g [Cout, N] when ``emit_res``, else
    None)."""
    g = fold_cotangent_plain(dy, y, dysum, dyssq).to(dy.dtype)
    return _to_slab(g, lay), (g if emit_res else None)


def dgrad_bf16_gemm_plain(slab, w_dg, x, scale, shift, bits, *, thresh,
                          lay):
    """(dx [Cin, N] in x's dtype, d(scale), d(shift) [Cin] f32) from the
    slab of ``lay``: the contraction (float64) of each tap's shifted slab
    rows with the dgrad-packed weights at the live rows, rounded to f32,
    through the masks."""
    acc = _slab_conv_f64(slab, w_dg, lay).to(_F32)
    return _dgrad_epilogue(acc, x, scale, shift, bits, thresh)


def wgrad_bf16_plain(dy, y, dysum, dyssq, x, scale, shift, bits, *, thresh,
                     h, w_img):
    """dW [Cout, 9*Cin] f32, columns in (dh, dw, ci) order: g = round(gf)
    (dy itself without stats cotangents) against the recomputed d, over
    all positions."""
    g = (dy if y is None
         else fold_cotangent_plain(dy, y, dysum, dyssq).to(dy.dtype))
    d = prologue_bf16_plain(x, scale, shift, bits, thresh)
    return (g.to(torch.float64) @ patches_f64(d, h, w_img).T).to(_F32)


def wgrad_bf16_pre_plain(dy, y, dysum, dyssq, x, scale, shift, bits, *,
                         thresh):
    """The weight gradient's operands, each rounded once, position-major
    (N = B*H*W image-major: NHWC), both contiguous: (d_b [N, Cin] = the
    prologue's d, g_b [N, Cout] = round(gf), dy itself without stats
    cotangents)."""
    g = (dy if y is None
         else fold_cotangent_plain(dy, y, dysum, dyssq).to(dy.dtype))
    d = prologue_bf16_plain(x, scale, shift, bits, thresh)
    return d.t().contiguous(), g.t().contiguous()


def wgrad_bf16_gemm_plain(d_b, g_b, *, h, w_img):
    """dW [9*Cin, Cout] f32, rows in (dh, dw, ci) order, from the rounded
    position-major operands: the float64 contraction over every position,
    rounded to f32."""
    return (patches_f64(d_b.t(), h, w_img) @ g_b.to(torch.float64)).to(_F32)


# --- kernels -------------------------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from pytorch_ddp_resnet_tpu_torch.ops.cuda import build

        lib = build.load("fused_block")
        sigs = {
            "fwd_amax_launch": [_P] * 6 + [_I] * 5 + [_F, _P],
            "fwd_pre_launch": [_P] * 8 + [_I] * 7
            + [ctypes.c_long, _I, _F, _P],
            "fwd_gemm_launch": [_P] * 7 + [_I] * 6
            + [ctypes.c_long] + [_I] * 2 + [_P],
            "bwd_amax_launch": [_P] * 10 + [_I] * 6 + [_F, _P],
            "bwd_quant_launch": [_P] * 15 + [_I] * 6 + [_F, _P],
            "dgrad_pre_launch": [_P] * 2 + [_I] * 4 + [ctypes.c_long, _P],
            "dgrad_gemm_launch": [_P] * 11 + [_I] * 6 + [ctypes.c_long]
            + [_I] * 3 + [_F, _P],
            "tile_sum_launch": [_P, _P, _I, _I, _P],
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


def _launch(name: str, fn, *args, seed: bool = False) -> None:
    check_rc(name, fn(*args))
    launches[name] += 1
    if seed:
        seed_launches[name] += 1


def _drop_args(bits, tensors: list, dtypes: list):
    """(bits pointer, seed pointer, seed mode) of a half's dropout bits,
    the tensor added to the ones the launch checks: a [Cin, N] uint8
    tensor, a 0-d int32 seed on the device (read by the kernel through
    its pointer, so the host never waits for it), or None."""
    if bits is None:
        return None, None, False
    tensors.append(bits)
    if is_seed(bits):
        dtypes.append(torch.int32)
        return None, bits.data_ptr(), True
    dtypes.append(torch.uint8)
    return bits.data_ptr(), None, False


def fwd_int8_pre(x, scale, shift, bits, *, thresh, tile, plan):
    """The int8 forward's slab of ``plan``'s layout and the groups' absmax
    (``fwd_int8_pre_plain``): the amax pass, then the prepass that
    computes the prologue once per element, quantizes it at its group's
    scale and writes the codes position-major, zeros at every pad
    position. Two launches; in seed mode both rebuild the mask."""
    if on_cpu(x):
        return fwd_int8_pre_plain(x, scale, shift, bits, thresh=thresh,
                                  tile=tile, plan=plan)
    name = "fused_half_fwd"
    lay = plan.lay
    if tuple(x.shape) != (lay.cin, lay.n):
        raise ValueError(f"{name}.pre: x {tuple(x.shape)} vs the layout "
                         f"{lay}")
    check_fwd_int8_geometry(name, lay.cin, lay.cout, lay.n, lay.h, lay.w,
                            tile)
    scale, shift = scale.to(_F32).contiguous(), shift.to(_F32).contiguous()
    tensors, dtypes = [x, scale, shift], [torch.bfloat16, _F32, _F32]
    drop = _drop_args(bits, tensors, dtypes)
    require_cuda(name, tensors, dtypes)
    return _fwd_int8_pre_launch(x, scale, shift, bits, drop, thresh, tile,
                                lay)


def _fwd_int8_pre_launch(x, scale, shift, bits, drop, thresh, tile, lay):
    """``fwd_int8_pre``'s two launches on operands already checked;
    ``drop`` is ``_drop_args`` of the bits."""
    name = "fused_half_fwd"
    bits_p, seed_p, seeded = drop
    groups = lay.n // tile
    s = _slices(groups)
    dev = x.device
    part = torch.empty(groups * s, dtype=_F32, device=dev)
    keep = inv_keep(thresh) if bits is not None else 1.0
    lib, st = _library(), _stream(x)
    _launch(f"{name}.amax", lib.fwd_amax_launch, x.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), bits_p, seed_p,
            part.data_ptr(), lay.cin, lay.n, tile, s, thresh or 256, keep,
            st, seed=seeded)
    slab = torch.empty((lay.slab_len, lay.cin), dtype=torch.int8,
                       device=dev)
    amax = torch.empty(groups, dtype=_F32, device=dev)
    _launch(f"{name}.pre", lib.fwd_pre_launch, x.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), bits_p, seed_p,
            part.data_ptr(), slab.data_ptr(), amax.data_ptr(), lay.cin,
            lay.n, tile, s, lay.h, lay.w, lay.guard, lay.slab_len,
            thresh or 256, keep, st, seed=seeded)
    return slab, amax


def _check_fwd_int8_operands(name, w_q, ws, res, lay):
    """The GEMM's weights, scales and residual against the layout."""
    if tuple(w_q.shape) != (lay.cout, 9 * lay.cin):
        raise ValueError(f"{name}: weights {tuple(w_q.shape)} vs Cin "
                         f"{lay.cin}, Cout {lay.cout}")
    if tuple(ws.shape) != (lay.cout,):
        raise ValueError(f"{name}: weight scales {tuple(ws.shape)}")
    if res is not None and tuple(res.shape) != (lay.cout, lay.n):
        raise ValueError(f"{name}: res {tuple(res.shape)}")
    if lay.tiles > 65535:
        raise ValueError(f"{name}: {lay.tiles} tiles exceed the grid")


def fwd_int8_gemm(slab, amax, w_q, ws, res, *, tile, plan, want_stats):
    """(y, ysum, yssq) from the slab of ``plan``'s layout
    (``fwd_int8_gemm_plain``): the exact s32 contraction over (tap,
    channel) on s8 wgmma, y = bf16(f32(acc) * (ws[co] * (amax_g * 1/127)))
    (+ res: bf16(f32(res) + f32(y))) written channel-major, each tile's
    sums of the stored y and y^2 added in a fixed order (``FWD_SUM_RUNS``
    runs of consecutive tiles, each in order, then the runs in order: bit
    for bit the same every run)."""
    if on_cpu(slab):
        return fwd_int8_gemm_plain(slab, amax, w_q, ws, res, tile=tile,
                                   plan=plan, want_stats=want_stats)
    name = "fused_half_fwd"
    lay = plan.lay
    if tuple(slab.shape) != (lay.slab_len, lay.cin):
        raise ValueError(f"{name}: slab {tuple(slab.shape)} is not of the "
                         f"layout {lay}")
    check_fwd_int8_geometry(name, lay.cin, lay.cout, lay.n, lay.h, lay.w,
                            tile)
    _check_fwd_int8_operands(name, w_q, ws, res, lay)
    ws = ws.to(_F32).contiguous()
    tensors = [slab, w_q, amax, ws]
    dtypes = [torch.int8, torch.int8, _F32, _F32]
    if res is not None:
        tensors.append(res)
        dtypes.append(torch.bfloat16)
    require_cuda(name, tensors, dtypes)
    if amax.numel() != lay.n // tile:
        raise ValueError(f"{name}: {amax.numel()} group scales vs "
                         f"{lay.n // tile} groups")
    return _fwd_int8_gemm_launch(slab, amax, w_q, ws, res, tile, plan,
                                 want_stats)


def _fwd_int8_gemm_launch(slab, amax, w_q, ws, res, tile, plan, want_stats):
    """``fwd_int8_gemm``'s launches on operands already checked."""
    name = "fused_half_fwd"
    lay = plan.lay
    dev = slab.device
    lib, st = _library(), _stream(slab)
    y = torch.empty((lay.cout, lay.n), dtype=torch.bfloat16, device=dev)
    part = (torch.empty((lay.tiles, 2 * lay.cout), dtype=_F32, device=dev)
            if want_stats else None)
    _launch(name, lib.fwd_gemm_launch, slab.data_ptr(), w_q.data_ptr(),
            amax.data_ptr(), ws.data_ptr(), _ptr(res), y.data_ptr(),
            _ptr(part), lay.cin, lay.cout, lay.n, lay.h, lay.w, tile,
            lay.slab_len, lay.tiles, plan.bn, st)
    if not want_stats:
        return y, None, None
    sums = torch.empty(2 * lay.cout, dtype=_F32, device=dev)
    _launch(f"{name}.sum", lib.tile_sum_launch, part.data_ptr(),
            sums.data_ptr(), lay.tiles, 2 * lay.cout, st)
    return y, sums[:lay.cout], sums[lay.cout:]


def fwd_int8(x, w_q, ws, scale, shift, bits, res, *, thresh, tile, h,
             w_img, want_stats):
    """The int8 half's forward: the prologue d = dropout(relu(x * scale +
    shift)) quantized per forward scale group of ``tile`` lanes, y =
    bf16(f32(conv(d_q, w_q)) * ws * amax/127) (+ res in bf16), and with
    ``want_stats`` the per-channel f32 sums of y and y^2. On the CPU
    ``fwd_conv_plain`` of ``fwd_quantize_plain``; on the card the launches
    of ``fwd_int8_pre`` into a slab freed at return, then those of
    ``fwd_int8_gemm``; every operand is checked once, before the first
    launch."""
    if on_cpu(x):
        d_q, amax = fwd_quantize_plain(x, scale, shift, bits, thresh=thresh,
                                       tile=tile)
        return fwd_conv_plain(d_q, amax, w_q, ws, res, tile=tile, h=h,
                              w_img=w_img, want_stats=want_stats)
    name = "fused_half_fwd"
    cin, n = x.shape
    cout = w_q.shape[0]
    check_fwd_int8_geometry(name, cin, cout, n, h, w_img, tile)
    plan = fused_fwd_int8_plan(n, h, w_img, cin, cout)
    _check_fwd_int8_operands(name, w_q, ws, res, plan.lay)
    scale, shift = scale.to(_F32).contiguous(), shift.to(_F32).contiguous()
    ws = ws.to(_F32).contiguous()
    tensors = [x, scale, shift, w_q, ws]
    dtypes = [torch.bfloat16, _F32, _F32, torch.int8, _F32]
    if res is not None:
        tensors.append(res)
        dtypes.append(torch.bfloat16)
    drop = _drop_args(bits, tensors, dtypes)
    require_cuda(name, tensors, dtypes)
    slab, amax = _fwd_int8_pre_launch(x, scale, shift, bits, drop, thresh,
                                      tile, plan.lay)
    return _fwd_int8_gemm_launch(slab, amax, w_q, ws, res, tile, plan,
                                 want_stats)


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
    bits_p, seed_p, seeded = _drop_args(bits, tensors, dtypes)
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
            shift.data_ptr(), bits_p, seed_p, part.data_ptr(), *common,
            seed=seeded)
    g_q = torch.empty((cout, n), dtype=torch.int8, device=dev)
    d_q = torch.empty((cin, n), dtype=torch.int8, device=dev)
    g_amax = torch.empty(groups, dtype=_F32, device=dev)
    d_amax = torch.empty(groups, dtype=_F32, device=dev)
    dres = (torch.empty((cout, n), dtype=torch.bfloat16, device=dev)
            if emit_res else None)
    _launch(f"{name}.quant", lib.bwd_quant_launch, dy.data_ptr(), _ptr(y),
            _ptr(dysum), _ptr(dyssq), x.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), bits_p, seed_p, part.data_ptr(),
            g_q.data_ptr(), d_q.data_ptr(), g_amax.data_ptr(),
            d_amax.data_ptr(), _ptr(dres), *common, seed=seeded)
    return g_q, g_amax, d_q, d_amax, dres


def _check_dgrad_int8_operands(name, g_amax, w_dg, ws_in, x, tile, lay):
    """The int8 dgrad's operands against the layout of the transposed conv
    (``lay.cin`` = the half's Cout, ``lay.cout`` = its Cin)."""
    _check_dgrad_operands(name, w_dg, x, lay)
    if tuple(ws_in.shape) != (lay.cout,):
        raise ValueError(f"{name}: weight scales {tuple(ws_in.shape)} vs "
                         f"Cin {lay.cout}")
    if g_amax.numel() != lay.n // tile:
        raise ValueError(f"{name}: {g_amax.numel()} group scales vs "
                         f"{lay.n // tile} groups")
    if lay.tiles > 65535:
        raise ValueError(f"{name}: {lay.tiles} tiles exceed the grid")


def _dgrad_int8_tensors(g_amax, w_dg, ws_in, x, scale, shift, bits):
    """The int8 dgrad GEMM's f32 operands made contiguous, its tensors and
    their dtypes for ``require_cuda``, and ``_drop_args`` of the bits:
    (ws_in, scale, shift, tensors, dtypes, drop)."""
    ws_in = ws_in.to(_F32).contiguous()
    scale, shift = scale.to(_F32).contiguous(), shift.to(_F32).contiguous()
    tensors = [w_dg, g_amax, ws_in, x, scale, shift]
    dtypes = [torch.int8, _F32, _F32, torch.bfloat16, _F32, _F32]
    drop = _drop_args(bits, tensors, dtypes)
    return ws_in, scale, shift, tensors, dtypes, drop


def dgrad_int8_pre(g_q, *, plan):
    """The int8 dgrad's slab of ``plan``'s layout (``dgrad_int8_pre_plain``):
    g_q's codes copied once, unchanged, position-major at each pixel's slab
    position, zeros at every pad position. One launch."""
    if on_cpu(g_q):
        return dgrad_int8_pre_plain(g_q, plan=plan)
    name = "fused_half_dgrad.pre"
    lay = plan.lay
    if tuple(g_q.shape) != (lay.cin, lay.n):
        raise ValueError(f"{name}: g_q {tuple(g_q.shape)} vs the layout "
                         f"{lay}")
    if lay.cin % 32:
        raise ValueError(f"{name}: Cout={lay.cin} is not a multiple of 32")
    require_cuda(name, [g_q], [torch.int8])
    return _dgrad_int8_pre_launch(g_q, lay)


def _dgrad_int8_pre_launch(g_q, lay):
    """``dgrad_int8_pre``'s launch on an operand already checked."""
    slab = torch.empty((lay.slab_len, lay.cin), dtype=torch.int8,
                       device=g_q.device)
    _launch("fused_half_dgrad.pre", _library().dgrad_pre_launch,
            g_q.data_ptr(), slab.data_ptr(), lay.cin, lay.n, lay.h, lay.w,
            lay.slab_len, _stream(g_q))
    return slab


def dgrad_int8_gemm(slab, g_amax, w_dg, ws_in, x, scale, shift, bits, *,
                    thresh, tile, plan):
    """(dx [Cin, N] bf16, d(scale), d(shift) [Cin] f32) from the slab of
    ``plan``'s layout (``dgrad_int8_gemm_plain``): the exact s32
    contraction over (tap, Cout channel) on s8 wgmma, each lane's value
    f32(acc) * (ws_in[ci] * (g_amax_g * 1/127)), through the masks
    recomputed from x (and the bits, or the mask rebuilt from the seed), dx
    written channel-major, each tile's sums of dn * x and dn added in a
    fixed order (dx bit-equal to the plain version, the sums the same bits
    every run). Two launches; in seed mode the GEMM rebuilds the mask."""
    if on_cpu(slab):
        return dgrad_int8_gemm_plain(slab, g_amax, w_dg, ws_in, x, scale,
                                     shift, bits, thresh=thresh, tile=tile,
                                     plan=plan)
    name = "fused_half_dgrad"
    lay = plan.lay
    if tuple(slab.shape) != (lay.slab_len, lay.cin):
        raise ValueError(f"{name}: slab {tuple(slab.shape)} is not of the "
                         f"layout {lay}")
    check_fwd_int8_geometry(name, lay.cin, lay.cout, lay.n, lay.h, lay.w,
                            tile)
    _check_dgrad_int8_operands(name, g_amax, w_dg, ws_in, x, tile, lay)
    ws_in, scale, shift, tensors, dtypes, drop = _dgrad_int8_tensors(
        g_amax, w_dg, ws_in, x, scale, shift, bits)
    require_cuda(name, [slab] + tensors, [torch.int8] + dtypes)
    return _dgrad_int8_gemm_launch(slab, g_amax, w_dg, ws_in, x, scale,
                                   shift, drop, thresh, tile, plan)


def _dgrad_int8_gemm_launch(slab, g_amax, w_dg, ws_in, x, scale, shift,
                            drop, thresh, tile, plan):
    """``dgrad_int8_gemm``'s two launches on operands already checked;
    ``drop`` is ``_drop_args`` of the bits."""
    name = "fused_half_dgrad"
    bits_p, seed_p, seeded = drop
    lay = plan.lay
    cin, dev = lay.cout, slab.device
    lib, st = _library(), _stream(slab)
    dx = torch.empty((cin, lay.n), dtype=torch.bfloat16, device=dev)
    part = torch.empty((lay.tiles, 2 * cin), dtype=_F32, device=dev)
    masked = bits_p is not None or seed_p is not None
    _launch(name, lib.dgrad_gemm_launch, slab.data_ptr(), w_dg.data_ptr(),
            g_amax.data_ptr(), ws_in.data_ptr(), x.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), bits_p, seed_p,
            dx.data_ptr(), part.data_ptr(), lay.cin, cin, lay.n, lay.h,
            lay.w, tile, lay.slab_len, lay.tiles, plan.bn, thresh or 256,
            inv_keep(thresh) if masked else 1.0, st, seed=seeded)
    sums = torch.empty(2 * cin, dtype=_F32, device=dev)
    _launch(f"{name}.sum", lib.tile_sum_launch, part.data_ptr(),
            sums.data_ptr(), lay.tiles, 2 * cin, st)
    return dx, sums[:cin], sums[cin:]


def dgrad_conv(g_q, g_amax, w_dg, ws_in, x, scale, shift, bits, *, thresh,
               tile, h, w_img):
    """The input gradient through the masks: (dx [Cin, N] bf16, d(scale),
    d(shift) [Cin] f32) from the codes g_q [Cout, N] of ``bwd_quantize``
    and the dgrad-packed weights (``quantize_pack_weights_dgrad``). On the
    CPU ``dgrad_conv_plain``; on the card ``dgrad_int8_pre`` into a slab
    freed at return, then ``dgrad_int8_gemm``; every operand is checked
    once, before the first launch, and any image width runs
    (``check_fwd_int8_geometry`` with Cin and Cout swapped)."""
    if on_cpu(g_q):
        return dgrad_conv_plain(g_q, g_amax, w_dg, ws_in, x, scale, shift,
                                bits, thresh=thresh, tile=tile, h=h,
                                w_img=w_img)
    name = "fused_half_dgrad"
    cout, n = g_q.shape
    cin = w_dg.shape[0]
    check_fwd_int8_geometry(name, cout, cin, n, h, w_img, tile)
    plan = fused_fwd_int8_plan(n, h, w_img, cout, cin)
    _check_dgrad_int8_operands(name, g_amax, w_dg, ws_in, x, tile, plan.lay)
    ws_in, scale, shift, tensors, dtypes, drop = _dgrad_int8_tensors(
        g_amax, w_dg, ws_in, x, scale, shift, bits)
    require_cuda(name, [g_q] + tensors, [torch.int8] + dtypes)
    slab = _dgrad_int8_pre_launch(g_q, plan.lay)
    return _dgrad_int8_gemm_launch(slab, g_amax, w_dg, ws_in, x, scale,
                                   shift, drop, thresh, tile, plan)


class FusedWgradS8Plan(NamedTuple):
    """How the int8 wgrad's kernel cuts dW [9*Cin, Cout]: ``m_tiles`` x
    ``n_tiles`` tiles of 128 x ``bn``, ``runs`` blocks a tile, each taking
    ``gpb`` of the ``groups`` scale groups (``spg`` of the ``steps`` K
    steps of 128 positions a group); ``runs`` 1: each block folds its
    tile's groups in order, else each group's contribution goes to a slot
    and ``.sum`` adds the slots in group order. ``blocks``, ``waves`` of
    132 SMs and ``us``, the model's time with the slots' traffic."""
    bn: int
    m_tiles: int
    n_tiles: int
    steps: int
    spg: int
    groups: int
    gpb: int
    runs: int
    blocks: int
    waves: int
    us: float


def check_wgrad_s8_geometry(name: str, cin: int, cout: int, n: int, h: int,
                            w_img: int, tile: int) -> None:
    """The int8 wgrad's own shape needs (csrc/wgrad_wgmma_s8.cuh): Cin in
    32-channel pieces, Cout a multiple of 8, whole images of a multiple of
    16 positions (a 16-byte unit of a K step lies in one image), scale
    groups of ``tile`` positions a whole number of 128-position K steps.
    Any image width: the taps are shifts of a channel's row of positions."""
    if cin % 32:
        raise ValueError(f"{name}: Cin={cin} is not a multiple of 32")
    if cout % 8:
        raise ValueError(f"{name}: Cout={cout} is not a multiple of 8")
    if (h * w_img) % 16 or n % (h * w_img):
        raise ValueError(f"{name}: geometry H={h} W={w_img} N={n} is not "
                         "whole images of a multiple of 16 positions")
    if tile % S8_BK or n % tile:
        raise ValueError(f"{name}: scale group of {tile} positions vs N={n} "
                         f"and the {S8_BK}-position K step")


@functools.lru_cache(maxsize=None)
def fused_wgrad_s8_plan(cin: int, cout: int, n: int, h: int, w_img: int,
                        tile: int) -> FusedWgradS8Plan:
    """The int8 wgrad's tiles and split, from ``wgrad_plan.s8_model`` (the
    lane transition's model of the mainloop's blocks, paced by the bytes
    their TMA boxes bring in) plus, when split, the slots written and read
    again at PART_BYTES_US: every fold-in-block width, and every split of
    the groups into runs of the slot widths; the cheapest, the fewest runs
    and the widest tile among equals. Cached: every call asks."""
    check_wgrad_s8_geometry("fused_half_wgrad", cin, cout, n, h, w_img, tile)
    m = 9 * cin
    m_tiles, steps, groups = -(-m // S8_BM), n // S8_BK, n // tile

    def plan(bn, gpb):
        runs = -(-groups // gpb)
        blocks, waves, us = s8_model(m, cout, n, bn, runs, gpb / groups)
        if runs > 1:
            n_tiles = -(-cout // bn)
            us += 8 * groups * m_tiles * S8_BM * n_tiles * bn / PART_BYTES_US
        return FusedWgradS8Plan(bn, m_tiles, -(-cout // bn), steps,
                                tile // S8_BK, groups, gpb, runs, blocks,
                                waves, us)

    plans = [plan(bn, groups) for bn in WGRAD_FOLD_BNS] + [
        plan(bn, gpb) for bn in WGRAD_SLOT_BNS
        for gpb in range(1, groups) if -(-groups // gpb) > 1]
    return min(plans, key=lambda p: (p.us, p.runs, -p.bn))


def wgrad(g_q, g_amax, d_q, d_amax, *, tile, h, w_img):
    """dW [3, 3, Cin, Cout] f32 (HWIO) from the codes g_q [Cout, N] and d_q
    [Cin, N] of ``bwd_quantize``, per scale group of ``tile`` lanes, the
    groups added in order. On the card one launch of the TMA + s8 wgmma
    kernel (``fused_half_wgrad``) on ``fused_wgrad_s8_plan``'s tiles, and
    where the plan splits the groups, ``.sum`` over their slots in group
    order; bit-equal to the plain version."""
    if on_cpu(g_q):
        return wgrad_plain(g_q, g_amax, d_q, d_amax, tile=tile, h=h,
                           w_img=w_img)
    name = "fused_half_wgrad"
    cout, n = g_q.shape
    cin = d_q.shape[0]
    if d_q.shape[1] != n:
        raise ValueError(f"{name}: operands {tuple(d_q.shape)} and "
                         f"{tuple(g_q.shape)}")
    plan = fused_wgrad_s8_plan(cin, cout, n, h, w_img, tile)
    if (tuple(g_amax.shape) != (plan.groups,)
            or tuple(d_amax.shape) != (plan.groups,)):
        raise ValueError(f"{name}: absmaxes {tuple(g_amax.shape)}, "
                         f"{tuple(d_amax.shape)} vs {plan.groups} scale "
                         "groups")
    require_cuda(name, [g_q, g_amax, d_q, d_amax],
                 [torch.int8, _F32, torch.int8, _F32])
    dev, lib, st = g_q.device, _library_wgrad(), _stream(g_q)
    dw = torch.empty((9 * cin, cout), dtype=_F32, device=dev)
    split = plan.runs > 1
    out = (torch.empty((plan.groups, plan.m_tiles * plan.n_tiles,
                        S8_BM * plan.bn), dtype=_F32, device=dev)
           if split else dw)
    _launch(name, lib.fused_wgrad_s8_launch, d_q.data_ptr(), g_q.data_ptr(),
            g_amax.data_ptr(), d_amax.data_ptr(), out.data_ptr(), cin, cout,
            n, h, w_img, tile, plan.bn, plan.gpb if split else 0, st)
    if split:
        _launch(f"{name}.sum", lib.fused_wgrad_s8_sum_launch, out.data_ptr(),
                dw.data_ptr(), plan.groups, cin, cout, plan.bn, st)
    return dw.reshape(3, 3, cin, cout)


_lib_wgrad: Optional[ctypes.CDLL] = None


def _library_wgrad() -> ctypes.CDLL:
    """csrc/fused_wgrad_s8.cu: the int8 wgrad and its slots' sum."""
    global _lib_wgrad
    if _lib_wgrad is None:
        from pytorch_ddp_resnet_tpu_torch.ops.cuda import build

        lib = build.load("fused_wgrad_s8")
        lib.fused_wgrad_s8_launch.argtypes = [_P] * 5 + [_I] * 8 + [_P]
        lib.fused_wgrad_s8_sum_launch.argtypes = [_P, _P] + [_I] * 4 + [_P]
        for fn in (lib.fused_wgrad_s8_launch, lib.fused_wgrad_s8_sum_launch):
            fn.restype = _I
        _lib_wgrad = lib
    return _lib_wgrad


# --- bf16 kernels -----------------------------------------------------------------

_lib_bf16: Optional[ctypes.CDLL] = None


def _library_bf16() -> ctypes.CDLL:
    global _lib_bf16
    if _lib_bf16 is None:
        from pytorch_ddp_resnet_tpu_torch.ops.cuda import build

        lib = build.load("fused_block_bf16")
        sigs = {
            "fused_fwd_pre_launch": [_P] * 6 + [_I] * 5
            + [ctypes.c_long, _I, _F, _P],
            "fused_fwd_gemm_launch": [_P] * 5 + [_I] * 8 + [_P],
            "dgrad_pre_launch": [_P] * 6 + [_I] * 5 + [ctypes.c_long, _P],
            "dgrad_gemm_launch": [_P] * 9 + [_I] * 9 + [_F, _P],
            "dgrad_sum_launch": [_P, _P, _I, _I, _P],
            "wgrad_pre_launch": [_P] * 11 + [_I] * 4 + [_F, _P],
            "wgrad_gemm_launch": [_P] * 3 + [_I] * 10 + [_P],
            "wgrad_sum_launch": [_P, _P, _I, _I, _I, _P],
            "seed_bits_expand_launch": [_P, _P, _I, _I, _P],
            "partial_sum_launch": [_P, _P, _I, _I, _P],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = _I
        _lib_bf16 = lib
    return _lib_bf16


def _bf16_operands(name, x, scale, shift, bits, extra, extra_dtypes):
    """The checked common operands of a bf16 launch: (scale, shift, bits
    pointer, seed pointer, seed mode)."""
    scale, shift = scale.to(_F32).contiguous(), shift.to(_F32).contiguous()
    tensors = [x, scale, shift] + extra
    dtypes = [torch.bfloat16, _F32, _F32] + extra_dtypes
    bits_p, seed_p, seeded = _drop_args(bits, tensors, dtypes)
    require_cuda(name, tensors, dtypes)
    return scale, shift, bits_p, seed_p, seeded


def fused_fwd_pre(x, scale, shift, bits, *, thresh, lay):
    """The bf16 forward's slab of layout ``lay`` (``fused_fwd_pre_plain``):
    d computed once per element, written position-major at each pixel's
    slab position, zeros at every pad position. One launch; in seed mode
    it rebuilds the mask."""
    if on_cpu(x):
        return fused_fwd_pre_plain(x, scale, shift, bits, thresh=thresh,
                                   lay=lay)
    name = "fused_half_bf16_fwd.pre"
    if tuple(x.shape) != (lay.cin, lay.n) or lay.cp != lay.cin:
        raise ValueError(f"{name}: x {tuple(x.shape)} vs the layout {lay}")
    scale, shift, bits_p, seed_p, seeded = _bf16_operands(
        name, x, scale, shift, bits, [], [])
    slab = torch.empty((lay.slab_len, lay.cp), dtype=torch.bfloat16,
                       device=x.device)
    _launch(name, _library_bf16().fused_fwd_pre_launch, x.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), bits_p, seed_p,
            slab.data_ptr(), lay.cin, lay.n, lay.h, lay.w, lay.guard,
            lay.slab_len, thresh or 256,
            inv_keep(thresh) if bits is not None else 1.0, _stream(x),
            seed=seeded)
    return slab


def fused_fwd_gemm(slab, w_packed, res, *, lay, want_stats):
    """(y, ysum, yssq) from the slab of layout ``lay``
    (``fused_fwd_gemm_plain``): the f32 contraction over (tap, channel) on
    wgmma, y = bf16(acc) (+ res: bf16(f32(res) + f32(y))) written
    channel-major, each tile's sums of the stored y and y^2 added in a
    fixed order (bit for bit the same every run)."""
    if on_cpu(slab):
        return fused_fwd_gemm_plain(slab, w_packed, res, lay=lay,
                                    want_stats=want_stats)
    name = "fused_half_bf16_fwd"
    if tuple(slab.shape) != (lay.slab_len, lay.cp) or lay.cp != lay.cin:
        raise ValueError(f"{name}: slab {tuple(slab.shape)} is not of the "
                         f"layout {lay}")
    if tuple(w_packed.shape) != (lay.cout, 9 * lay.cin):
        raise ValueError(f"{name}: weights {tuple(w_packed.shape)} vs Cin "
                         f"{lay.cin}, Cout {lay.cout}")
    if lay.tiles > 65535:
        raise ValueError(f"{name}: {lay.tiles} tiles exceed the grid")
    tensors, dtypes = [slab, w_packed], [torch.bfloat16] * 2
    if res is not None:
        if tuple(res.shape) != (lay.cout, lay.n):
            raise ValueError(f"{name}: res {tuple(res.shape)}")
        tensors.append(res)
        dtypes.append(torch.bfloat16)
    require_cuda(name, tensors, dtypes)
    dev = slab.device
    y = torch.empty((lay.cout, lay.n), dtype=torch.bfloat16, device=dev)
    part = (torch.empty((lay.tiles, 2 * lay.cout), dtype=_F32, device=dev)
            if want_stats else None)
    lib = _library_bf16()
    _launch(name, lib.fused_fwd_gemm_launch, slab.data_ptr(),
            w_packed.data_ptr(), _ptr(res), y.data_ptr(), _ptr(part),
            lay.cin, lay.cout, lay.n, lay.h, lay.w, lay.guard, lay.tiles,
            lay.bn, _stream(slab))
    if not want_stats:
        return y, None, None
    sums = torch.empty(2 * lay.cout, dtype=_F32, device=dev)
    _launch(f"{name}.sum", lib.partial_sum_launch, part.data_ptr(),
            sums.data_ptr(), lay.tiles, 2 * lay.cout, _stream(slab))
    return y, sums[:lay.cout], sums[lay.cout:]


def fwd_bf16(x, w_packed, scale, shift, bits, res, *, thresh, h, w_img,
             want_stats):
    """The bf16 half's forward: y = bf16(conv3x3(d)) (+ res in bf16), d =
    dropout(relu(bf16(x * scale + shift))) in bf16, and with
    ``want_stats`` the per-channel f32 sums of y and y^2. On the card
    ``fused_fwd_pre`` into a slab freed at return, then
    ``fused_fwd_gemm``; every operand is checked before the first
    launch."""
    if on_cpu(x):
        return fwd_bf16_plain(x, w_packed, scale, shift, bits, res,
                              thresh=thresh, h=h, w_img=w_img,
                              want_stats=want_stats)
    name = "fused_half_bf16_fwd"
    cin, n = x.shape
    cout = w_packed.shape[0]
    if tuple(w_packed.shape) != (cout, 9 * cin):
        raise ValueError(f"{name}: weights {tuple(w_packed.shape)} vs Cin "
                         f"{cin}")
    check_fwd_bf16_geometry(name, cin, cout, n, h, w_img)
    extra, extra_dt = [w_packed], [torch.bfloat16]
    if res is not None:
        if tuple(res.shape) != (cout, n):
            raise ValueError(f"{name}: res {tuple(res.shape)}")
        extra.append(res)
        extra_dt.append(torch.bfloat16)
    _bf16_operands(name, x, scale, shift, bits, extra, extra_dt)
    lay = fused_fwd_layout(n, h, w_img, cin, cout)
    slab = fused_fwd_pre(x, scale, shift, bits, thresh=thresh, lay=lay)
    return fused_fwd_gemm(slab, w_packed, res, lay=lay,
                          want_stats=want_stats)


def _cot_operands(dy, y, dysum, dyssq):
    """The cotangent's tensors a backward launch checks, and its f32 stats
    cotangents (contiguous): (extra, extra dtypes, dysum, dyssq)."""
    extra, extra_dt = [dy], [torch.bfloat16]
    if y is not None:
        dysum = dysum.to(_F32).contiguous()
        dyssq = dyssq.to(_F32).contiguous()
        extra += [y, dysum, dyssq]
        extra_dt += [torch.bfloat16, _F32, _F32]
    return extra, extra_dt, dysum, dyssq


def dgrad_bf16_pre(dy, y, dysum, dyssq, *, lay, emit_res):
    """The dgrad's slab of layout ``lay`` (``fused_fwd_layout`` at Cin =
    the half's Cout) and dres (``dgrad_bf16_pre_plain``): g = bf16(gf)
    computed once per element, written position-major at each pixel's slab
    position, zeros at every pad position, and channel-major into dres
    from the same read where ``emit_res``. One launch."""
    if on_cpu(dy):
        return dgrad_bf16_pre_plain(dy, y, dysum, dyssq, lay=lay,
                                    emit_res=emit_res)
    name = "fused_half_bf16_dgrad.pre"
    if tuple(dy.shape) != (lay.cin, lay.n) or lay.cp != lay.cin:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} vs the layout "
                         f"{lay}")
    check_fwd_bf16_geometry(name, lay.cin, lay.cout, lay.n, lay.h, lay.w)
    extra, extra_dt, dysum, dyssq = _cot_operands(dy, y, dysum, dyssq)
    require_cuda(name, extra, extra_dt)
    return _dgrad_pre_launch(dy, y, dysum, dyssq, lay, emit_res)


def _dgrad_pre_launch(dy, y, dysum, dyssq, lay, emit_res):
    """``dgrad_bf16_pre``'s launch on operands already checked."""
    dev = dy.device
    slab = torch.empty((lay.slab_len, lay.cp), dtype=torch.bfloat16,
                       device=dev)
    dres = (torch.empty((lay.cin, lay.n), dtype=torch.bfloat16, device=dev)
            if emit_res else None)
    _launch("fused_half_bf16_dgrad.pre", _library_bf16().dgrad_pre_launch,
            dy.data_ptr(), _ptr(y), _ptr(dysum), _ptr(dyssq),
            slab.data_ptr(), _ptr(dres), lay.cin, lay.n, lay.h, lay.w,
            lay.guard, lay.slab_len, _stream(dy))
    return slab, dres


def _check_dgrad_operands(name, w_dg, x, lay):
    """The dgrad GEMM's weights and input against the layout."""
    if tuple(w_dg.shape) != (lay.cout, 9 * lay.cin):
        raise ValueError(f"{name}: weights {tuple(w_dg.shape)} vs Cin "
                         f"{lay.cout}, Cout {lay.cin}")
    if tuple(x.shape) != (lay.cout, lay.n):
        raise ValueError(f"{name}: x {tuple(x.shape)} vs the layout {lay}")


def dgrad_bf16_gemm(slab, w_dg, x, scale, shift, bits, *, thresh, lay):
    """(dx [Cin, N] bf16, d(scale), d(shift) [Cin] f32) from the slab of
    ``lay`` (``dgrad_bf16_gemm_plain``): the f32 contraction over (tap,
    Cout channel) on wgmma, through the masks recomputed from x (and the
    bits, or the mask rebuilt from the seed), dx written channel-major,
    each tile's sums of dn * x and dn added in a fixed order (bit for bit
    the same every run). Two launches; in seed mode the GEMM rebuilds the
    mask."""
    if on_cpu(slab):
        return dgrad_bf16_gemm_plain(slab, w_dg, x, scale, shift, bits,
                                     thresh=thresh, lay=lay)
    name = "fused_half_bf16_dgrad"
    if tuple(slab.shape) != (lay.slab_len, lay.cp) or lay.cp != lay.cin:
        raise ValueError(f"{name}: slab {tuple(slab.shape)} is not of the "
                         f"layout {lay}")
    _check_dgrad_operands(name, w_dg, x, lay)
    check_fwd_bf16_geometry(name, lay.cin, lay.cout, lay.n, lay.h, lay.w)
    scale, shift, bits_p, seed_p, seeded = _bf16_operands(
        name, x, scale, shift, bits, [slab, w_dg], [torch.bfloat16] * 2)
    return _dgrad_gemm_launch(slab, w_dg, x, scale, shift,
                              (bits_p, seed_p, seeded), thresh, lay)


def _dgrad_gemm_launch(slab, w_dg, x, scale, shift, drop, thresh, lay):
    """``dgrad_bf16_gemm``'s two launches on operands already checked;
    ``drop`` is ``_drop_args`` of the bits."""
    name = "fused_half_bf16_dgrad"
    bits_p, seed_p, seeded = drop
    cin, dev = lay.cout, slab.device
    lib, st = _library_bf16(), _stream(slab)
    dx = torch.empty((cin, lay.n), dtype=torch.bfloat16, device=dev)
    part = torch.empty((lay.tiles, 2 * cin), dtype=_F32, device=dev)
    masked = bits_p is not None or seed_p is not None
    _launch(name, lib.dgrad_gemm_launch, slab.data_ptr(), w_dg.data_ptr(),
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), bits_p,
            seed_p, dx.data_ptr(), part.data_ptr(), lay.cin, cin, lay.n,
            lay.h, lay.w, lay.guard, lay.tiles, lay.bn, thresh or 256,
            inv_keep(thresh) if masked else 1.0, st, seed=seeded)
    sums = torch.empty(2 * cin, dtype=_F32, device=dev)
    _launch(f"{name}.sum", lib.dgrad_sum_launch, part.data_ptr(),
            sums.data_ptr(), lay.tiles, 2 * cin, st)
    return dx, sums[:cin], sums[cin:]


def dgrad_bf16(dy, y, dysum, dyssq, w_dg, x, scale, shift, bits, *, thresh,
               h, w_img, emit_res):
    """The bf16 half's input gradient: (dx [Cin, N] bf16, d(scale),
    d(shift) [Cin] f32, dres = bf16(gf) [Cout, N] or None). On the card
    ``dgrad_bf16_pre`` into a slab freed at return, then
    ``dgrad_bf16_gemm``; every operand is checked once, before the first
    launch, and any image width runs (``check_fwd_bf16_geometry`` with
    Cin and Cout swapped)."""
    if on_cpu(dy):
        return dgrad_bf16_plain(dy, y, dysum, dyssq, w_dg, x, scale, shift,
                                bits, thresh=thresh, h=h, w_img=w_img,
                                emit_res=emit_res)
    name = "fused_half_bf16_dgrad"
    cout, n = dy.shape
    cin = x.shape[0]
    check_fwd_bf16_geometry(name, cout, cin, n, h, w_img)
    lay = fused_fwd_layout(n, h, w_img, cout, cin)
    _check_dgrad_operands(name, w_dg, x, lay)
    extra, extra_dt, dysum, dyssq = _cot_operands(dy, y, dysum, dyssq)
    extra.append(w_dg)
    extra_dt.append(torch.bfloat16)
    scale, shift, bits_p, seed_p, seeded = _bf16_operands(
        name, x, scale, shift, bits, extra, extra_dt)
    slab, dres = _dgrad_pre_launch(dy, y, dysum, dyssq, lay, emit_res)
    dx, ds, dt = _dgrad_gemm_launch(slab, w_dg, x, scale, shift,
                                    (bits_p, seed_p, seeded), thresh, lay)
    return dx, ds, dt, dres


def wgrad_bf16_pre(dy, y, dysum, dyssq, x, scale, shift, bits, *, thresh):
    """The weight gradient's operands, each element computed once:
    (d_b [N, Cin], g_b [N, Cout]) bf16, position-major (NHWC), d the
    prologue's and g = bf16(gf), as the forward and the dgrad round them.
    One launch writes both; in seed mode it rebuilds the mask."""
    if on_cpu(dy):
        return wgrad_bf16_pre_plain(dy, y, dysum, dyssq, x, scale, shift,
                                    bits, thresh=thresh)
    name = "fused_half_bf16_wgrad.pre"
    cout, n = dy.shape
    cin = x.shape[0]
    if x.shape[1] != n:
        raise ValueError(f"{name}: x {tuple(x.shape)} vs dy "
                         f"{tuple(dy.shape)}")
    if cin % 8 or cout % 8 or n % 8:
        raise ValueError(f"{name}: Cin={cin}, Cout={cout}, N={n}: each "
                         "must be a multiple of 8")
    extra, extra_dt, dysum, dyssq = _cot_operands(dy, y, dysum, dyssq)
    scale, shift, bits_p, seed_p, seeded = _bf16_operands(
        name, x, scale, shift, bits, extra, extra_dt)
    d_b = torch.empty((n, cin), dtype=torch.bfloat16, device=dy.device)
    g_b = torch.empty((n, cout), dtype=torch.bfloat16, device=dy.device)
    _launch(name, _library_bf16().wgrad_pre_launch, x.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), bits_p, seed_p,
            dy.data_ptr(), _ptr(y), _ptr(dysum), _ptr(dyssq),
            d_b.data_ptr(), g_b.data_ptr(), cin, cout, n, thresh or 256,
            inv_keep(thresh) if bits is not None else 1.0, _stream(dy),
            seed=seeded)
    return d_b, g_b


def wgrad_bf16_gemm(d_b, g_b, *, h, w_img):
    """dW [9*Cin, Cout] f32, rows in (dh, dw, ci) order, from the rounded
    position-major operands d_b [N, Cin] and g_b [N, Cout] bf16: the f32
    contraction over whole images (one chunk), split over blocks by
    ``bneck_nv_train.wgrad_bf16_plan``, the splits added in order (bit for
    bit the same every run)."""
    if on_cpu(d_b):
        return wgrad_bf16_gemm_plain(d_b, g_b, h=h, w_img=w_img)
    name = "fused_half_bf16_wgrad"
    n, cin = d_b.shape
    cout = g_b.shape[1]
    if g_b.shape[0] != n or n % (h * w_img):
        raise ValueError(f"{name}: d {tuple(d_b.shape)}, g "
                         f"{tuple(g_b.shape)} are not whole {h}x{w_img} "
                         "images")
    if cin % 8 or cout % 8:
        raise ValueError(f"{name}: Cin={cin}, Cout={cout}: each must be a "
                         "multiple of 8")
    require_cuda(name, [d_b, g_b], [torch.bfloat16] * 2)
    b = n // (h * w_img)
    plan = wgrad_bf16_plan(b, h, w_img, cin, cout, 9, h)
    if plan.splits > 65535:
        raise ValueError(f"{name}: {plan.splits} splits at N={n} exceed "
                         "the grid")
    part = torch.empty((plan.splits, 9 * cin * cout), dtype=_F32,
                       device=d_b.device)
    dw = torch.empty((9 * cin, cout), dtype=_F32, device=d_b.device)
    lib, stream = _library_bf16(), _stream(d_b)
    _launch(name, lib.wgrad_gemm_launch, d_b.data_ptr(), g_b.data_ptr(),
            part.data_ptr(), b, h, w_img, cin, cout, plan.bm, plan.bn,
            plan.bk, plan.per, plan.splits, stream)
    _launch(f"{name}.sum", lib.wgrad_sum_launch, part.data_ptr(),
            dw.data_ptr(), cin, cout, plan.splits, stream)
    return dw


def wgrad_bf16(dy, y, dysum, dyssq, x, scale, shift, bits, *, thresh, h,
               w_img):
    """The bf16 half's weight gradient: dW [Cout, 9*Cin] f32, columns in
    (dh, dw, ci) order, summed over every position (on the card
    ``wgrad_bf16_pre``, then ``wgrad_bf16_gemm``, whose [9*Cin, Cout]
    result this returns transposed)."""
    if on_cpu(dy):
        return wgrad_bf16_plain(dy, y, dysum, dyssq, x, scale, shift, bits,
                                thresh=thresh, h=h, w_img=w_img)
    d_b, g_b = wgrad_bf16_pre(dy, y, dysum, dyssq, x, scale, shift, bits,
                              thresh=thresh)
    return wgrad_bf16_gemm(d_b, g_b, h=h, w_img=w_img).t()


def seed_bits_expand(seed: torch.Tensor, cin: int, n: int) -> torch.Tensor:
    """The [cin, n] uint8 bits of a seed, written out by the card's hash
    (csrc/seed_bits.cuh); the plain version is ``seed_bits``. Only the card
    check uses it: the halves rebuild their masks in registers."""
    if on_cpu(seed):
        return seed_bits(seed, cin, n, 0, n)
    name = "seed_bits_expand"
    if not is_seed(seed):
        raise ValueError(f"{name}: expected a 0-d int32 seed")
    require_cuda(name, [seed], [torch.int32])
    out = torch.empty((cin, n), dtype=torch.uint8, device=seed.device)
    _launch(name, _library_bf16().seed_bits_expand_launch, seed.data_ptr(),
            out.data_ptr(), cin, n, _stream(seed))
    return out


# --- the differentiable ops -------------------------------------------------------

def _bf16_backward(dy, dysum, dyssq, x_cs, w, scale, shift, bits, y,
                   thresh, h, w_img, want_stats, use_res):
    """The bf16 backward of a half (the reference's ``_make_op`` backward
    without ``quant_bwd``), at the weights ``w`` cast to bf16: (dx, dw
    OIHW in w's dtype, d(scale), d(shift), dres)."""
    cout, cin = w.shape[:2]
    dy = dy.contiguous()
    emit_res = use_res and want_stats
    w_dg = pack_weights_dgrad(w.detach().to(x_cs.dtype))
    dx, ds, dt, dres = dgrad_bf16(dy, y, dysum, dyssq, w_dg, x_cs, scale,
                                  shift, bits, thresh=thresh, h=h,
                                  w_img=w_img, emit_res=emit_res)
    dw = wgrad_bf16(dy, y, dysum, dyssq, x_cs, scale, shift, bits,
                    thresh=thresh, h=h, w_img=w_img)
    dw = dw.reshape(cout, 3, 3, cin).permute(0, 3, 1, 2).to(w.dtype)
    if use_res and not emit_res:
        dres = dy
    return dx, dw, ds.to(scale.dtype), dt.to(shift.dtype), dres


class _FusedHalf(torch.autograd.Function):
    """Forward and backward of one bf16 half. The bits carry no gradient;
    without stats outputs the residual's cotangent is dy."""

    @staticmethod
    def forward(ctx, x_cs, w, scale, shift, bits, res, thresh, h, w_img,
                want_stats):
        # the forward's own check is the backward's rule too
        # (check_fwd_bf16_geometry): a shape the backward refuses raises
        # before the first launch
        wp = pack_weights(w.detach().to(x_cs.dtype))
        y, ysum, yssq = fwd_bf16(x_cs, wp, scale, shift, bits, res,
                                 thresh=thresh, h=h, w_img=w_img,
                                 want_stats=want_stats)
        ctx.save_for_backward(x_cs, w, scale, shift, bits,
                              y if want_stats else None)
        ctx.cfg = (thresh, h, w_img, want_stats, res is not None)
        return (y, ysum, yssq) if want_stats else y

    @staticmethod
    def backward(ctx, dy, dysum=None, dyssq=None):
        x_cs, w, scale, shift, bits, y = ctx.saved_tensors
        thresh, h, w_img, want_stats, use_res = ctx.cfg
        dx, dw, ds, dt, dres = _bf16_backward(
            dy, dysum, dyssq, x_cs, w, scale, shift, bits, y, thresh, h,
            w_img, want_stats, use_res)
        return (dx, dw, ds, dt, None, dres if use_res else None, None, None,
                None, None)


def _check_bits(dropout_rate: float, bits, x_cs: torch.Tensor, h: int,
                w_img: int):
    """The reference's argument checks: (thresh or None, bits or None)."""
    thresh = dropout_thresh(dropout_rate)
    if thresh >= 256:
        bits = None
    elif thresh <= 0:
        raise ValueError("dropout_rate >= 1 zeroes the activations; the "
                         "fused kernel does not support it.")
    elif bits is None:
        raise ValueError(f"dropout_rate={dropout_rate} needs a bits array.")
    if is_seed(bits) and x_cs.shape[0] * x_cs.shape[1] >= SEED_INDEX_LIMIT:
        raise ValueError("in-kernel dropout bits index in i32: Cin * N "
                         "must be < 2^31 (pass a bits tensor instead).")
    if x_cs.shape[1] % (h * w_img):
        raise ValueError(f"N={x_cs.shape[1]} is not a multiple of "
                         f"H*W={h * w_img}")
    return (thresh if bits is not None else None), bits


def fused_half(x_cs: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               shift: torch.Tensor, bits: Optional[torch.Tensor] = None,
               res: Optional[torch.Tensor] = None, *,
               dropout_rate: float = 0.0, h: int, w_img: int,
               want_stats: bool = True
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                          Optional[torch.Tensor]]:
    """Differentiable fused preact block-half with a bf16 conv core.

    x_cs [Cin, N] (N = B*H*W, image-major), w [Cout, Cin, 3, 3] (OIHW),
    taken as ``w.to(x_cs.dtype)`` in both directions; scale/shift [Cin]
    f32 (``fold_bn``); bits a [Cin, N] uint8 tensor or a 0-d int32 seed
    (Cin * N < 2^31), required iff the dropout rate rounds to a keep
    threshold below 256; res [Cout, N] added after the bf16 rounding.
    Returns (y [Cout, N], ysum, yssq), or (y, None, None) when
    ``want_stats`` is False (a block's last conv). Widths that are not
    multiples of 32 (the gate admits C % 16 without dropout) run zero-padded
    to the next multiple of 32, exactly (zero channels add nothing)."""
    thresh, bits = _check_bits(dropout_rate, bits, x_cs, h, w_img)
    cin, cout = x_cs.shape[0], w.shape[0]
    pin, pout = -cin % 32, -cout % 32
    if pin or pout:
        # zero channels are exact (zero weights, scale and shift contribute
        # nothing, a zero row of x stays masked) and are sliced off again;
        # autograd carries the gradients through the pad and the slices
        x_cs, scale, shift = (pad_rows(t, pin) for t in (x_cs, scale,
                                                          shift))
        if bits is not None and not is_seed(bits):
            bits = pad_rows(bits, pin)
        if res is not None:
            res = pad_rows(res, pout)
        w = F.pad(w, (0, 0, 0, 0, 0, pin, 0, pout))
    out = _FusedHalf.apply(x_cs, w, scale, shift, bits, res, thresh, h,
                           w_img, want_stats)
    if not want_stats:
        return out[:cout], None, None
    return tuple(t[:cout] for t in out)



@functools.lru_cache(maxsize=None)
def _check_int8_backward(quant_bwd: bool, cin: int, cout: int, n: int,
                         h: int, w_img: int) -> None:
    """The shape needs of the backward an int8 half will run: the int8
    quantizer, dgrad and wgrad (FQT) or the bf16 dgrad (QAT). Cached per
    shape; a shape that raises is checked again at each call."""
    if not quant_bwd:
        check_fwd_bf16_geometry("fused_half_bf16_dgrad", cout, cin, n, h,
                                w_img)
        return
    tile = bwd_tile(h, w_img, n, cin, cout)
    check_fwd_int8_geometry("fused_half_dgrad", cout, cin, n, h, w_img, tile)
    check_wgrad_s8_geometry("fused_half_wgrad", cin, cout, n, h, w_img, tile)


class _FusedHalfInt8(torch.autograd.Function):
    """Forward of one int8 half, and its backward: fully quantized with
    ``quant_bwd``, else the bf16 straight-through backward at the
    unquantized point (QAT). The bits carry no gradient; without stats
    outputs the residual's cotangent is dy."""

    @staticmethod
    def forward(ctx, x_cs, w, scale, shift, bits, res, thresh, h, w_img,
                want_stats, quant_bwd):
        cin, n = x_cs.shape
        cout = w.shape[0]
        tile = lane_tile(h, w_img, n, cin, cout)
        if not on_cpu(x_cs):
            # the forward takes any width; raise before its first launch
            # where the backward's kernels refuse the shape
            _check_int8_backward(quant_bwd, cin, cout, n, h, w_img)
        w_q, ws = quantize_pack_weights(w.detach())
        y, ysum, yssq = fwd_int8(x_cs, w_q, ws, scale, shift, bits, res,
                                 thresh=thresh, tile=tile, h=h,
                                 w_img=w_img, want_stats=want_stats)
        ctx.save_for_backward(x_cs, w, scale, shift, bits,
                              y if want_stats else None)
        ctx.cfg = (thresh, h, w_img, want_stats, res is not None, quant_bwd)
        return (y, ysum, yssq) if want_stats else y

    @staticmethod
    def backward(ctx, dy, dysum=None, dyssq=None):
        x_cs, w, scale, shift, bits, y = ctx.saved_tensors
        thresh, h, w_img, want_stats, use_res, quant_bwd = ctx.cfg
        if not quant_bwd:
            dx, dw, ds, dt, dres = _bf16_backward(
                dy, dysum, dyssq, x_cs, w, scale, shift, bits, y, thresh, h,
                w_img, want_stats, use_res)
            return (dx, dw, ds, dt, None, dres if use_res else None, None,
                    None, None, None, None)
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
        dw = dw.permute(3, 2, 0, 1).to(w.dtype)
        if use_res and not emit_res:
            dres = dy
        return (dx, dw, ds.to(scale.dtype), dt.to(shift.dtype), None,
                dres if use_res else None, None, None, None, None, None)


def fused_half_int8(x_cs: torch.Tensor, w: torch.Tensor,
                    scale: torch.Tensor, shift: torch.Tensor,
                    bits: Optional[torch.Tensor] = None,
                    res: Optional[torch.Tensor] = None, *,
                    dropout_rate: float = 0.0, h: int, w_img: int,
                    want_stats: bool = True, quant_bwd: bool = True
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                               Optional[torch.Tensor]]:
    """Differentiable fused preact block-half with an int8 conv core: the
    backward fully quantized with ``quant_bwd`` (FQT), else the bf16
    straight-through backward at the unquantized point (QAT: the original
    weights cast to bf16, the bf16 prologue recomputed).

    x_cs [Cin, N] (N = B*H*W, image-major), w [Cout, Cin, 3, 3] (OIHW),
    scale/shift [Cin] f32 (``fold_bn``), bits a [Cin, N] uint8 tensor or a
    0-d int32 seed (Cin * N < 2^31), required iff the dropout rate rounds
    to a keep threshold below 256, res [Cout, N] added after the bf16
    rounding. Returns (y [Cout, N], ysum, yssq), or (y, None, None) when
    ``want_stats`` is False (a block's last conv)."""
    thresh, bits = _check_bits(dropout_rate, bits, x_cs, h, w_img)
    out = _FusedHalfInt8.apply(x_cs, w, scale, shift, bits, res, thresh, h,
                               w_img, want_stats, quant_bwd)
    return out if want_stats else (out, None, None)
