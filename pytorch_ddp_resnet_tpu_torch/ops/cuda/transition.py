"""Stage-transition half with an int8 stride-2 conv core, lane layout in and
lane layout out (counterpart of
``pytorch_ddp_resnet_tpu/ops/pallas/transition.py`` ``transition_half_int8``).

For x [Cin, N] (N = B*H*W image-major, H and W even), the folded norm1
affine (scale, shift) [Cin] f32 and dropout bits, at the output geometry
(OH, OW) = (H/2, W/2) with N' = N/4:

    d   = dropout(relu(x * scale + shift))            (f32)
    z   = bf16(conv3x3_stride2_pad1(dq, wq) * ws * amax/127)     [Cout, N']
    res = bf16(Wp @ x[::2, ::2])  |  x[::2, ::2] with zero channels added
    zsum, zssq = per-channel f32 sums of z                (norm2's stats)

The padding is symmetric (torch's ``Conv2d(stride=2, padding=1)``): output
(oh, ow) reads input (2oh + dh - 1, 2ow + dw - 1). d is quantized per
*scale group*: the images of one ``transition_tile`` of output lanes, with
one absmax over all their pixels (the reference's joint absmax over its
four parity planes). A group covers the same whole images at the input
geometry with 4x as many lanes: the forward's quantizer (``fwd_amax``,
``fwd_pre``) is the fused half's ``fused_block.fwd_quantize`` run at
``tile = 4 * transition_tile``, its codes laid out in planes.

The backward folds the stats cotangents, ``gf = dz + dzsum + 2z * dzssq``,
and has two bodies, as the reference's ``quant_bwd``:

- FQT: gf and the recomputed d are quantized per group (floor 1e-30); the
  dgrad runs the transposed stride-2 conv of the int8 cotangent against
  per-input-channel int8 weights, the wgrad contracts the two int8
  operands per group exactly and adds the groups' scaled sums in order;
- straight-through: g = bf16(gf), the original weights in bf16 and the
  bf16 prologue recomputed, f32 accumulation.

Both then mask the dgrad with ``x * scale + shift > 0`` and the kept bits,
add the shortcut's cotangent on the even-even pixels (``Wp^T @ dres`` in
bf16 with f32 accumulation, or dres's first Cin rows for option A), and
sum d(scale) and d(shift); ``dWp = dres @ x[::2, ::2]^T`` in f32.

The reference lays the input out as four parity planes, a TPU lane trick.
The forward keeps them as a layout (``transition_fwd_layout``): each scale
group's planes, padded with a zero row above and a zero column left of each
image, position-major in an int8 slab, so that every tap of the stride-2
conv is one position offset of a GEMM's A rows. Both backward bodies'
operand passes write the prologue d as its four planes, channel-major
([4, Cin, N']: the FQT quantizer its int8 codes, the straight-through fold
its bf16 values), and x's even-even plane ([Cin, N']): every tap of the
weight gradient then reads one plane at a shift of at most one row and one
column (``TAP_TABLE``), and dWp one plane unshifted. The dgrad takes
each parity class of input pixel as a stride-1 contraction over the
class's taps at the output geometry: g (and dres) written once into the
fused forward's padded slab (``transition_dgrad_layout``), each class a
range of the plane-major weights' taps, every tap one row offset. The
dropout bits' parity layout [4*Cin, N']
(plane-major rows, the reference's draw) is re-laid once to [Cin, N] by
``parity_unpack``.

Layers of this module, each a CPU-or-card wrapper beside its plain version
(a CPU tensor runs the plain PyTorch version; a CUDA tensor launches the
kernel of ``csrc/transition.cu`` or raises):

- ``fwd_conv``      (``fwd_amax``, ``fwd_pre``, then ``fwd_gemm``)
- ``fwd_amax``      (launches ``transition_fwd.amax``: the prologue's
  partial absmaxes per scale group)
- ``fwd_pre``       (launches ``transition_fwd.pre``: the prologue
  quantized once into the parity-plane slab, the raw even-even plane into
  a bf16 slab)
- ``fwd_gemm``      (launches ``transition_fwd``, ``.sum``: the staged
  mainloop of ``csrc/fwd_staged_s8.cuh`` over the slabs, z, res and the
  ordered sums)
- ``bwd_quantize``  (launches ``transition_bwd.quant``, once; FQT: the
  cotangent's codes, a thread-block cluster per scale group, and the
  activation's codes as parity planes at the forward's group absmax, and
  x's even-even plane)
- ``bwd_fold``      (launches ``transition_bwd.fold``; straight-through:
  the rounded cotangent, the bf16 prologue's parity planes and x's
  even-even plane)
- ``dgrad``         (``dgrad_pre`` then ``dgrad_gemm``)
- ``dgrad_pre``     (launches ``transition_dgrad.pre``: g, and dres where a
  projection runs, into their padded slabs)
- ``dgrad_gemm``    (launches ``transition_dgrad``, ``.sum``: each parity
  class a tap range on the s8 (FQT, TMA-fed) or bf16 wgmma mainloop of
  ``csrc/fwd_wgmma_s8.cuh`` / ``csrc/fwd_wgmma_bf16.cuh``, a masking
  epilogue, the tiles' sums in order)
- ``wgrad``         (launches ``transition_wgrad_s8``; FQT: one launch of
  ``csrc/transition_wgrad.cu`` on the TMA + s8 wgmma mainloop of
  ``csrc/wgrad_wgmma_s8.cuh``, the scale groups folded in order in each
  tile)
- ``wgrad_bf16``    (launches ``transition_wgrad_tma``, ``.sum``:
  ``csrc/transition_wgrad.cu`` on the TMA + wgmma mainloop of
  ``csrc/wgrad_wgmma_bf16.cuh``)
- ``wgrad_proj``    (launches ``transition_wgrad_tma.proj``,
  ``.proj_sum``: the same kernel, one tap)

and ``transition_half_int8``, the differentiable op over them. Weights are
the port's OIHW tensors: conv1 [Cout, Cin, 3, 3], the projection [Cout,
Cin, 1, 1].
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input

from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3
from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
from pytorch_ddp_resnet_tpu_torch.ops.cuda.checks import (
    check_rc,
    on_cpu,
    require_cuda,
)
from pytorch_ddp_resnet_tpu_torch.ops.cuda.fused_block import _ptr, _stream
from pytorch_ddp_resnet_tpu_torch.ops.cuda.conv3x3 import pad_rows, pick_tile
from pytorch_ddp_resnet_tpu_torch.ops.cuda.wgrad_plan import (  # noqa: F401
    S8_BK,
    S8_BM,
    S8_SMS,    # the SMs ``WgradS8Plan.waves`` counts against
    s8_model,
)

launches: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_F32 = torch.float32
_F64 = torch.float64


def reset_launches() -> None:
    launches.clear()


# --- the parity layout (the dropout bits' layout, and the tests') -------------

def parity_planes(x_cs: torch.Tensor, h: int, w_img: int):
    """[C, B*H*W] -> the four planes [C, B*(H/2)*(W/2)], plane p = 2*(h%2)
    + (w%2), each in the lane layout of the output geometry."""
    c, n = x_cs.shape
    v = x_cs.reshape(c, n // (h * w_img), h, w_img)
    return tuple(v[:, :, ph::2, pw::2].reshape(c, n // 4)
                 for ph in (0, 1) for pw in (0, 1))


def parity_interleave(planes, h: int, w_img: int) -> torch.Tensor:
    """Inverse of ``parity_planes``: 4 x [C, N/4] -> [C, B*H*W]."""
    c, q = planes[0].shape
    b = q // ((h // 2) * (w_img // 2))
    out = planes[0].new_empty((c, b, h, w_img))
    for p, pln in enumerate(planes):
        out[:, :, p // 2::2, p % 2::2] = pln.reshape(c, b, h // 2, w_img // 2)
    return out.reshape(c, b * h * w_img)


def parity_pack(x_cs: torch.Tensor, h: int, w_img: int) -> torch.Tensor:
    """The four planes stacked plane-major on rows: [4*C, N/4]."""
    return torch.cat(parity_planes(x_cs, h, w_img), dim=0)


def parity_unpack(xp: torch.Tensor, h: int, w_img: int) -> torch.Tensor:
    """Inverse of ``parity_pack``: [4*C, N/4] -> [C, N], contiguous."""
    c = xp.shape[0] // 4
    return parity_interleave(tuple(xp[p * c:(p + 1) * c] for p in range(4)),
                             h, w_img)


def _tap_plane(dh: int, dw: int) -> int:
    """The parity plane of the input pixels tap (dh, dw) reads: dh = 1
    reads even rows, dh = 0 and 2 odd ones (likewise dw)."""
    return 2 * (dh != 1) + (dw != 1)


# the taps of each plane, row-major: the dgrad's weight blocks, in order
PLANE_TAPS = tuple(tuple((dh, dw) for dh in range(3) for dw in range(3)
                         if _tap_plane(dh, dw) == p) for p in range(4))

# (plane, row shift, column shift) of each tap (dh, dw), row-major: output
# (r, c) of tap (dh, dw) reads plane (r + row shift, c + column shift),
# zero off the image (JAX ``_tap_info``); the weight gradient's table
TAP_TABLE = tuple((_tap_plane(dh, dw), -(dh == 0), -(dw == 0))
                  for dh in range(3) for dw in range(3))


def transition_tile(oh: int, ow: int, n_out: int, cin: int,
                    cout: int) -> int:
    """The scale group at the output geometry (JAX ``transition_tile``):
    ``_pick_tile(oh*ow, n_out, max(4*cin, cout) // 2, max_tile=4096)``."""
    return pick_tile(oh * ow, n_out, max(4 * cin, cout) // 2, max_tile=4096)


# --- weights (OIHW) ------------------------------------------------------------

def pack_w_dgrad(w: torch.Tensor) -> torch.Tensor:
    """conv1 packed for the dgrad, plane-major (JAX
    ``pack_weights_transition_dgrad``): per plane, per tap (dh, dw) of
    ``PLANE_TAPS``, the block w[:, :, dh, dw]^T [Cin, Cout]; [Cin, 9*Cout]."""
    blocks = [w[:, :, dh, dw].t() for taps in PLANE_TAPS for dh, dw in taps]
    return torch.cat(blocks, dim=1).contiguous()


def quant_pack_w_dgrad(w: torch.Tensor):
    """Per-input-channel int8 of conv1, dgrad-packed: (w_q [Cin, 9*Cout]
    int8, ws [Cin] f32) (JAX ``_quant_pack_w_dgrad``)."""
    wf = w.to(_F32)
    absmax = wf.abs().amax(dim=(0, 2, 3))
    ws = torch.clamp_min(absmax, 1e-12) / fb._f32_127(absmax)
    w_q = torch.clamp(torch.round(wf / ws[None, :, None, None]), -127, 127)
    return pack_w_dgrad(w_q.to(torch.int8)), ws


def _unpack_w_dgrad(w_dg: torch.Tensor) -> torch.Tensor:
    """[Cin, 9*Cout] plane-major -> OIHW [Cout, Cin, 3, 3]."""
    cin, k = w_dg.shape
    cout = k // 9
    w = w_dg.new_zeros((cout, cin, 3, 3))
    col = 0
    for taps in PLANE_TAPS:
        for dh, dw in taps:
            w[:, :, dh, dw] = w_dg[:, col:col + cout].t()
            col += cout
    return w


# --- plain versions --------------------------------------------------------------

def _nchw(v: torch.Tensor, h: int, w_img: int) -> torch.Tensor:
    """[C, B*h*w] -> [B, C, h, w] in float64."""
    c, n = v.shape
    return v.to(_F64).reshape(c, n // (h * w_img), h, w_img).transpose(0, 1)


def _lanes(v: torch.Tensor) -> torch.Tensor:
    """[B, C, h, w] -> [C, B*h*w]."""
    return v.transpose(0, 1).reshape(v.shape[1], -1)


def _even(x: torch.Tensor, h: int, w_img: int) -> torch.Tensor:
    """x[:, ::2, ::2] of [C, B*h*w]: [C, B*(h/2)*(w/2)]."""
    return parity_planes(x, h, w_img)[0]


def _s2conv_f64(d: torch.Tensor, w: torch.Tensor, h: int,
                w_img: int) -> torch.Tensor:
    """Stride-2 pad-1 3x3 conv of d [Cin, N] by w OIHW, in float64:
    [Cout, N/4] (exact for int8 operands)."""
    return _lanes(F.conv2d(_nchw(d, h, w_img), w.to(_F64), stride=2,
                           padding=1))


def _unpack_w_fwd(w_q: torch.Tensor) -> torch.Tensor:
    cout, k = w_q.shape
    return w_q.reshape(cout, 3, 3, k // 9).permute(0, 3, 1, 2)


def _shortcut(raw0, wp_c, cout):
    """res from the raw even-even plane raw0 [Cin, N']: bf16(f32(Wp @
    raw0)) with f32 accumulation (float64 here), or raw0 with zero channels
    added, in raw0's dtype."""
    if wp_c is not None:
        acc = wp_c.to(_F64) @ raw0.to(_F64)
        return acc.to(_F32).to(raw0.dtype)
    return F.pad(raw0, (0, 0, 0, cout - raw0.shape[0]))


def fwd_conv_plain(d_q, amax, w_q, ws, x, wp_c, *, tile, h, w_img):
    """(z, zsum, zssq, res): the int8 conv of the quantized prologue d_q
    [Cin, N] (group absmax ``amax``, groups of ``tile`` output lanes), the
    shortcut from the raw x, and the f32 sums of z."""
    acc = _s2conv_f64(d_q, _unpack_w_fwd(w_q), h, w_img).to(_F32)
    fac = ws.to(_F32)[:, None] * (amax * fb.INV_127)[None, :]
    # contiguous: the sums' order does not hang on the conv's output layout
    z = fb._per_group(acc, tile, fac).to(x.dtype).contiguous()
    zf = z.to(_F32)
    res = _shortcut(_even(x, h, w_img), wp_c, w_q.shape[0])
    return z, fb._group_sums(zf, tile), fb._group_sums(zf * zf, tile), res


FWD_BM = 128  # M rows a tile of the forward GEMM (csrc/fwd_staged_s8.cuh BM)
PROJ_BK = 128  # bytes a K step of its projection (csrc/transition.cu)


class TransitionFwdLayout(NamedTuple):
    """Where the forward's prepass writes the quantized prologue and where
    its GEMM reads it (``transition_fwd_layout``).

    The M rows are padded output positions, image-major over the whole
    batch: row m is image i, padded row r' < oh + 1 and padded column c' <
    ow + 1 at m = i*per_img + r'*(ow + 1) + c' (per_img = (oh + 1)*(ow +
    1)); r' = 0 and c' = 0 are pad rows, computed and thrown away, and the
    live rows (r', c' >= 1: output (r' - 1, c' - 1)) in order are the
    output lanes in order. ``m_valid`` = batch*per_img rows fill ``tiles``
    tiles of ``bm``; a tile may span images and scale groups (``imgs``
    images each, ``tile`` = imgs*oh*ow output lanes): each row is
    dequantized at its own group's scale.

    The int8 slab [4*plane_len, cp] holds the four parity planes, plane p
    = 2*ph + pw over plane_len positions of cp bytes (Cin padded with
    zeros to a multiple of 32): ``guard`` = ow + 2 zero positions, then
    position m of plane p holds input (2(r' - 1) + ph, 2(c' - 1) + pw) of
    the row's image, quantized at its group's scale (zero at the pad rows
    and columns), then zeros to the end. Tap (dh, dw) reads plane 2*(dh !=
    1) + (dw != 1) one row up where dh == 0 and one column left where dw
    == 0 (JAX ``_tap_info``): M row m of tap t reads position m +
    shifts[t], every A row of every tap one aligned read inside the slab,
    no masks. The GEMM's K is (tap, channel) in steps of ``bk`` bytes,
    each 16-byte piece at its own tap, so a step may span taps: it walks
    ``krow`` bytes, 9*cp rounded up to bk, the weights' rows being 9*cp
    bytes (the bytes past them read as zeros). The bf16 slab [plane_len,
    cpb] holds the raw even-even plane (x[2(r' - 1), 2(c' - 1)]) at the
    same positions, Cin padded to cpb (a multiple of 32); row m reads
    position m + ee_shift."""
    n: int
    h: int
    w: int
    cin: int
    cout: int
    tile: int
    oh: int
    ow: int
    imgs: int
    groups: int
    per_img: int
    guard: int
    bm: int
    m_valid: int
    tiles: int
    plane_len: int
    cp: int
    bk: int
    krow: int
    cpb: int
    shifts: tuple
    ee_shift: int


def check_fwd_geometry(name: str, cin: int, cout: int, h: int, w_img: int,
                       n: int, tile: int) -> None:
    """The forward kernels' shape needs: any even H and W, scale groups of
    whole images of 8-lane multiples (every lane tile the JAX picker
    gives), Cout a multiple of 8; Cin any (the layout pads it)."""
    if h % 2 or w_img % 2 or n % (h * w_img):
        raise ValueError(f"{name}: geometry H={h} W={w_img} N={n}")
    if tile % ((h // 2) * (w_img // 2)) or (n // 4) % tile or tile % 8:
        raise ValueError(f"{name}: tile {tile} vs N'={n // 4} and images "
                         f"of {(h // 2) * (w_img // 2)} output lanes")
    if cout % 8 or cin < 1:
        raise ValueError(f"{name}: Cin={cin}, Cout={cout}")


@functools.lru_cache(maxsize=None)
def transition_fwd_layout(n: int, h: int, w_img: int, cin: int, cout: int,
                          tile: int) -> TransitionFwdLayout:
    """The forward's slab layout for x [Cin, n] of h x w_img images and
    scale groups of ``tile`` output lanes (see ``TransitionFwdLayout``).
    Cached: every call of the forward asks."""
    check_fwd_geometry("transition_fwd_layout", cin, cout, h, w_img, n,
                       tile)
    oh, ow = h // 2, w_img // 2
    per_img = (oh + 1) * (ow + 1)
    guard = ow + 2
    m_valid = n // (h * w_img) * per_img
    tiles = -(-m_valid // FWD_BM)
    plane_len = guard + tiles * FWD_BM
    cp = -(-cin // 32) * 32
    bk = 128 if cp % 128 == 0 else 64
    shifts = tuple((2 * (dh != 1) + (dw != 1)) * plane_len + guard
                   - (dh == 0) * (ow + 1) - (dw == 0)
                   for dh in range(3) for dw in range(3))
    return TransitionFwdLayout(
        n, h, w_img, cin, cout, tile, oh, ow, tile // (oh * ow),
        n // 4 // tile, per_img, guard, FWD_BM, m_valid, tiles, plane_len,
        cp, bk, -(-9 * cp // bk) * bk, cp, shifts, guard)


def _live_rows(lay: TransitionFwdLayout) -> torch.Tensor:
    """The M rows of the live positions, in lane order."""
    i, r, c = torch.meshgrid(torch.arange(lay.n // (lay.h * lay.w)),
                             torch.arange(lay.oh), torch.arange(lay.ow),
                             indexing="ij")
    return (i * lay.per_img + (r + 1) * (lay.ow + 1) + c + 1).reshape(-1)


def _plane_slab(v: torch.Tensor, lay: TransitionFwdLayout,
                c_pad: int) -> torch.Tensor:
    """v [C, n] -> [4, plane_len, c_pad]: the parity planes at their
    padded positions, zeros elsewhere."""
    c = v.shape[0]
    b = lay.n // (lay.h * lay.w)
    t = v.reshape(c, b, lay.oh, 2, lay.ow, 2)
    t = t.permute(3, 5, 1, 2, 4, 0).reshape(4, b, lay.oh, lay.ow, c)
    t = F.pad(t, (0, c_pad - c, 1, 0, 1, 0)).reshape(4, lay.m_valid, c_pad)
    return F.pad(t, (0, 0, lay.guard,
                     lay.plane_len - lay.guard - lay.m_valid))


def fwd_amax_plain(x, scale, shift, bits, *, thresh, tile):
    """[G, 1] f32: each scale group's absmax of the prologue (groups of
    ``4 * tile`` input lanes)."""
    d = fb.prologue_plain(x, scale, shift, bits, thresh)
    return d.abs().reshape(d.shape[0], -1, 4 * tile).amax(dim=(0, 2))[:, None]


def fwd_pre_plain(x, scale, shift, bits, part, *, thresh, lay):
    """(slab int8 [4*plane_len, cp], ee bf16 [plane_len, cpb], amax
    [groups] f32) of layout ``lay``: the prologue quantized per group at
    127 / max(amax, 1e-12) (``amax`` = the maximum of ``part``'s row, the
    group's partial absmaxes), as ``fwd_quantize_plain``; the raw even-even
    plane of x."""
    d = fb.prologue_plain(x, scale, shift, bits, thresh)
    amax = part.amax(dim=1)
    inv = torch.tensor(127.0, dtype=_F32, device=x.device) / torch.clamp_min(
        amax, fb.FWD_FLOOR)
    q = torch.clamp(torch.round(d.reshape(lay.cin, lay.groups, -1)
                                * inv[None, :, None]), -127.0, 127.0)
    slab = _plane_slab(q.to(torch.int8).reshape(lay.cin, -1), lay, lay.cp)
    ee = _plane_slab(x, lay, lay.cpb)[0]
    return (slab.reshape(4 * lay.plane_len, lay.cp), ee.to(
        x.dtype).contiguous(), amax)


def _pad_w_fwd(w_q, lay):
    """w_q [Cout, 9*Cin] -> [Cout, 9*cp]: each tap's channels padded with
    zeros to the slab's cp (w_q itself where cp == Cin)."""
    if lay.cp == lay.cin:
        return w_q.contiguous()
    cout = w_q.shape[0]
    return F.pad(w_q.reshape(cout, 9, lay.cin),
                 (0, lay.cp - lay.cin)).reshape(cout, -1).contiguous()


def fwd_gemm_plain(slab, ee, amax, w_q, ws, wp_c, lay):
    """(z, zsum, zssq, res) from the slabs of layout ``lay``: the exact
    contraction (float64) of each tap's shifted slab rows with its weights
    at the live rows, z = bf16(f32(acc) * f32(ws * amax/127)) with each
    lane's group's amax, the sums of z per group then across groups in
    order; res from the even-even slab's live rows, as
    ``fwd_conv_plain``."""
    cout = w_q.shape[0]
    wt = _pad_w_fwd(w_q, lay).to(_F64).reshape(cout, 9, lay.cp)
    rows = _live_rows(lay)
    acc = sum(slab[sh + rows].to(_F64) @ wt[:, t].t()
              for t, sh in enumerate(lay.shifts))   # [N', Cout]
    acc = acc.t().contiguous().to(_F32)
    fac = ws.to(_F32)[:, None] * (amax * fb.INV_127)[None, :]
    z = fb._per_group(acc, lay.tile, fac).to(ee.dtype)
    zf = z.to(_F32)
    raw0 = ee[lay.ee_shift + rows, :lay.cin].t().contiguous()
    return (z, fb._group_sums(zf, lay.tile), fb._group_sums(zf * zf, lay.tile),
            _shortcut(raw0, wp_c, cout))


def bwd_quantize_plain(dz, z, dzsum, dzssq, x, scale, shift, bits, *,
                       thresh, tile, h, w_img):
    """FQT operands per group: (g_q [Cout, N'], g_amax, d_q [4, Cin, N'],
    d_amax, x_ee [Cin, N']); the cotangent's groups are ``tile`` lanes,
    the activation's ``4 * tile`` (the same images), both with floor 1e-30;
    d_q holds the activation's codes as its parity planes
    (``parity_planes``), x_ee is x at the even-even pixels (dWp's
    operand)."""
    gf = fb.fold_cotangent_plain(dz, z, dzsum, dzssq)
    g_q, g_amax = fb.quantize_groups_plain(gf, tile, fb.BWD_FLOOR)
    d_q, d_amax = fb.quantize_groups_plain(
        fb.prologue_plain(x, scale, shift, bits, thresh), 4 * tile,
        fb.BWD_FLOOR)
    return (g_q, g_amax, torch.stack(parity_planes(d_q, h, w_img)), d_amax,
            _even(x, h, w_img).contiguous())


def bwd_fold_plain(dz, z, dzsum, dzssq, x, scale, shift, bits, *, thresh,
                   h, w_img):
    """The straight-through operands: g = round(gf) in dz's dtype, the
    prologue d recomputed in x's dtype (``prologue_bf16_plain``) as its
    parity planes [4, Cin, N'] (``parity_planes``), and x at the even-even
    pixels [Cin, N']."""
    d = fb.prologue_bf16_plain(x, scale, shift, bits, thresh)
    return (fb.fold_cotangent_plain(dz, z, dzsum, dzssq).to(dz.dtype),
            torch.stack(parity_planes(d, h, w_img)),
            _even(x, h, w_img).contiguous())


def _dgrad_epilogue(acc, x, scale, shift, bits, thresh, sc, h, w_img):
    """(dx [Cin, N] in x's dtype, d(scale), d(shift) [Cin] f32) from the
    dequantized input gradient acc [Cin, N] f32: through the masks
    (``fb._masked``), dx = dn * scale, and on the even-even pixels
    fma(dn, scale, sc) with the shortcut's cotangent sc [Cin, N'] f32."""
    dn = fb._masked(acc, x, scale, shift, bits, thresh)
    planes = parity_planes(dn * fb._vec(scale), h, w_img)
    ee = fb._fma(parity_planes(dn, h, w_img)[0], fb._vec(scale), sc)
    dx = parity_interleave((ee,) + planes[1:], h, w_img)
    return (dx.to(x.dtype), (dn * x.to(_F32)).sum(dim=1), dn.sum(dim=1))


def _shortcut_cotangent(dres, wpt, cin):
    """sc [Cin, N'] f32: ``wpt`` [Cin, Cout] @ dres (float64 sums), or
    dres's first Cin rows (``wpt`` None, option A)."""
    if wpt is not None:
        return (wpt.to(_F64) @ dres.to(_F64)).to(_F32)
    return dres[:cin].to(_F32)


def dgrad_plain(g, g_amax, w_dg, ws_in, x, scale, shift, bits, dres, wpt, *,
                thresh, tile, h, w_img):
    """(dx [Cin, N] in x's dtype, d(scale), d(shift) [Cin] f32). g is the
    int8 cotangent with its group absmax and ``ws_in`` the per-input-channel
    weight scales (FQT), or the rounded cotangent with both None. On the
    even-even pixels dx adds the shortcut's cotangent: ``wpt`` [Cin, Cout]
    @ dres, or dres's first Cin rows (``wpt`` None)."""
    cin, n = x.shape
    b = n // (h * w_img)
    acc = _lanes(conv2d_input((b, cin, h, w_img), _unpack_w_dgrad(w_dg).to(
        _F64), _nchw(g, h // 2, w_img // 2), stride=2, padding=1)).to(_F32)
    if g_amax is not None:
        acc = fb._per_group(acc, 4 * tile, ws_in.to(_F32)[:, None]
                            * (g_amax * fb.INV_127)[None, :])
    return _dgrad_epilogue(acc, x, scale, shift, bits, thresh,
                           _shortcut_cotangent(dres, wpt, cin), h, w_img)


class TransitionDgradLayout(NamedTuple):
    """Where the dgrad's prepass writes g (and dres) and how its GEMM walks
    them (``transition_dgrad_layout``).

    The slabs are the fused forward's layout (``fused_block.fused_fwd_
    layout``) at the output geometry (oh, ow) = (h/2, w/2): ``guard`` = ow
    + 2 zero positions, then each image's per_img = (oh + 1) * (ow + 1)
    positions, a zero row above it and a zero column at the start of each
    row, output pixel (i, r, c) at M row m = i * per_img + (r + 1) * (ow +
    1) + c + 1 (slab position guard + m), zeros to whole tiles of ``bm`` M
    rows and a second guard. g's slab has ``cp`` channels (Cout, padded
    with zeros to a multiple of 32 for the int8 body, whose K steps are
    32-byte boxes), dres's (where a projection runs) Cout.

    Input pixel (2r + ph, 2c + pw) is of parity class p = 2 ph + pw and
    takes the 1, 2, 2 or 4 taps (dh, dw) of ``PLANE_TAPS[p]``, each from
    the cotangent at output pixel (r + sh, c + sw), sh = (ph == 1 and dh
    == 0), sw = (pw == 1 and dw == 0), zero past the image: M row m of
    output pixel (r, c) reads slab row guard + m + sh * (ow + 1) + sw (the
    next image's zero row or the next row's zero column past the image).
    ``classes[p]`` = (first, count, offs): the class's taps are the
    plane-major weights' taps first .. first + count - 1 (columns (first +
    j) * Cout ..), tap j at slab row offset offs[j] past guard + m. The
    GEMM's block takes an M tile, 80 input channels and a row parity ph:
    classes 2 ph and 2 ph + 1, whose M row m maps to the input
    lanes (``_class_lanes``) of output lane q at row 2r + ph, columns 2c
    and 2c + 1. A tile may span images and scale groups (``tile`` output
    lanes, whole images): each M row takes its own group's scale."""
    n: int
    h: int
    w: int
    cin: int
    cout: int
    tile: int
    oh: int
    ow: int
    b: int
    per_img: int
    guard: int
    bm: int
    m_valid: int
    tiles: int
    slab_len: int
    cp: int
    quant: bool
    classes: tuple


@functools.lru_cache(maxsize=None)
def transition_dgrad_layout(n: int, h: int, w_img: int, cin: int, cout: int,
                            tile: int, quant: bool) -> TransitionDgradLayout:
    """The dgrad's layout for x [Cin, n] of h x w_img images, Cout outputs
    and scale groups of ``tile`` output lanes (see
    ``TransitionDgradLayout``); the forward's geometry rule
    (``check_fwd_geometry``: any even H and W). Cached: every call of the
    backward asks."""
    check_fwd_geometry("transition_dgrad", cin, cout, h, w_img, n, tile)
    oh, ow = h // 2, w_img // 2
    lay = fb.fused_fwd_layout(n // 4, oh, ow, cout, cin)
    if lay.tiles > 65535:
        raise ValueError(f"transition_dgrad: {lay.tiles} tiles exceed the "
                         "grid")
    classes, first = [], 0
    for p, taps in enumerate(PLANE_TAPS):
        ph, pw = divmod(p, 2)
        offs = tuple(int(ph == 1 and dh == 0) * (ow + 1)
                     + int(pw == 1 and dw == 0) for dh, dw in taps)
        classes.append((first, len(taps), offs))
        first += len(taps)
    return TransitionDgradLayout(
        n, h, w_img, cin, cout, tile, oh, ow, lay.b, lay.per_img, lay.guard,
        lay.bm, lay.m_valid, lay.tiles, lay.slab_len,
        -(-cout // 32) * 32 if quant else cout, bool(quant), tuple(classes))


def _out_rows(lay: TransitionDgradLayout) -> torch.Tensor:
    """The M rows of the output pixels, in output-lane order."""
    i, r, c = torch.meshgrid(torch.arange(lay.b), torch.arange(lay.oh),
                             torch.arange(lay.ow), indexing="ij")
    return (i * lay.per_img + (r + 1) * (lay.ow + 1) + c + 1).reshape(-1)


def _class_lanes(lay: TransitionDgradLayout, p: int) -> torch.Tensor:
    """The input lane of each output lane's pixel of class p = 2 ph + pw:
    image i, row 2r + ph, column 2c + pw (the GEMM epilogue's map)."""
    ph, pw = divmod(p, 2)
    q = torch.arange(lay.n // 4)
    i, rem = q // (lay.oh * lay.ow), q % (lay.oh * lay.ow)
    r, c = rem // lay.ow, rem % lay.ow
    return i * lay.h * lay.w + (2 * r + ph) * lay.w + 2 * c + pw


def _out_slab(v: torch.Tensor, lay: TransitionDgradLayout,
              c_pad: int) -> torch.Tensor:
    """v [C, N'] written into a slab [slab_len, c_pad] of ``lay``: each
    output pixel at its position, zeros at every pad position and pad
    channel, in v's dtype."""
    c = v.shape[0]
    t = v.reshape(c, lay.b, lay.oh, lay.ow).permute(1, 2, 3, 0)
    t = F.pad(t, (0, c_pad - c, 1, 0, 1, 0)).reshape(lay.m_valid, c_pad)
    return F.pad(t, (0, 0, lay.guard, lay.slab_len - lay.guard
                     - lay.m_valid)).contiguous()


def dgrad_pre_plain(g, dres, lay):
    """(g's slab [slab_len, cp] in g's dtype, dres's slab [slab_len, Cout]
    or None where ``dres`` is None) of layout ``lay``."""
    return (_out_slab(g, lay, lay.cp),
            None if dres is None else _out_slab(dres, lay, lay.cout))


def dgrad_gemm_plain(gslab, dslab, g_amax, w_dg, ws_in, x, scale, shift,
                     bits, dres, wpt, *, thresh, lay):
    """(dx, d(scale), d(shift)) from the slabs of layout ``lay``, walked as
    the card's GEMM walks them: per parity class, each tap's shifted slab
    rows at the output pixels' M rows against its weight columns (float64
    sums), dequantized at each output lane's group (FQT: f32(acc) *
    f32(ws_in * f32(g_amax / 127))), put at the class's input lanes; the
    shortcut's cotangent from dres's slab (``wpt`` @ its rows) or dres
    (option A); then ``dgrad_plain``'s epilogue."""
    cin, cout = lay.cin, lay.cout
    dev = x.device
    rows = (_out_rows(lay) + lay.guard).to(dev)
    wt = w_dg.to(_F64)
    acc = torch.zeros((cin, lay.n), dtype=_F32, device=dev)
    for p, (first, count, offs) in enumerate(lay.classes):
        a = sum(gslab[rows + off, :cout].to(_F64)
                @ wt[:, (first + j) * cout:(first + j + 1) * cout].t()
                for j, off in enumerate(offs)).t().to(_F32)   # [Cin, N']
        if g_amax is not None:
            a = fb._per_group(a, lay.tile, ws_in.to(_F32)[:, None]
                              * (g_amax * fb.INV_127)[None, :])
        acc[:, _class_lanes(lay, p).to(dev)] = a
    if wpt is not None:
        sc = (wpt.to(_F64) @ dslab[rows, :cout].to(_F64).t()).to(_F32)
    else:
        sc = _shortcut_cotangent(dres, None, cin)
    return _dgrad_epilogue(acc, x, scale, shift, bits, thresh, sc, lay.h,
                           lay.w)


def _tap_views(d: torch.Tensor, h: int, w_img: int) -> torch.Tensor:
    """The nine taps' views of the parity planes d [4, Cin, N'] at the
    output geometry, float64: [9, Cin, N'], tap t its plane moved by its
    row and column shift (``TAP_TABLE``), zero off the image."""
    cin, n_out = d.shape[1:]
    oh, ow = h // 2, w_img // 2
    planes = F.pad(d.to(_F64).reshape(4, cin, n_out // (oh * ow), oh, ow),
                   (1, 1, 1, 1))
    return torch.stack([planes[p, :, :, 1 + rs:1 + rs + oh,
                               1 + cs:1 + cs + ow].reshape(cin, n_out)
                        for p, rs, cs in TAP_TABLE])


def wgrad_plain(g_q, g_amax, d_q, d_amax, *, tile, h, w_img):
    """FQT dW [3, 3, Cin, Cout] f32 (HWIO, the layout the kernel writes):
    the int8 cotangent g_q [Cout, N'] against the activation's codes as
    parity planes d_q [4, Cin, N'] of ``bwd_quantize``, each tap its plane
    at its shift (``TAP_TABLE``); per group of ``tile`` output lanes the
    exact s32 contraction times (d_amax * g_amax) / 127^2, summed over the
    groups in order (the reference's ``_w_init`` / ``_w_acc``)."""
    cout = g_q.shape[0]
    cin = d_q.shape[1]
    taps = _tap_views(d_q, h, w_img)
    g64 = g_q.to(_F64).t()
    out = None
    for grp in range(g_q.shape[1] // tile):
        lo, hi = grp * tile, (grp + 1) * tile
        acc = taps[:, :, lo:hi] @ g64[lo:hi]
        contrib = acc.to(_F32) * ((d_amax[grp] * g_amax[grp])
                                  * fb.INV_16129)
        out = contrib if out is None else out + contrib
    return out.reshape(3, 3, cin, cout)


def wgrad_bf16_plain(g, d, *, h, w_img):
    """Straight-through dW [3, 3, Cin, Cout] f32 (HWIO, the layout the
    kernel writes): the rounded cotangent g [Cout, N'] against the
    prologue's parity planes d [4, Cin, N'] of ``bwd_fold``, each tap its
    plane at its shift (``TAP_TABLE``), summed in float64 over every output
    position (h x w_img: the input geometry)."""
    cout = g.shape[0]
    cin = d.shape[1]
    return (_tap_views(d, h, w_img) @ g.to(_F64).t()).to(_F32).reshape(
        3, 3, cin, cout)


def wgrad_proj_plain(dres, x_ee, *, h, w_img):
    """dWp^T = x_ee @ dres^T [Cin, Cout] f32 (the layout the kernel
    writes), x_ee the even-even plane [Cin, N'] of ``bwd_fold`` or
    ``bwd_quantize``; float64 sums. h and w_img, the input geometry, are
    the kernel's (its K steps), not needed here."""
    del h, w_img
    return (x_ee.to(_F64) @ dres.to(_F64).t()).to(_F32)


# --- kernels -------------------------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None
_lib_wgrad: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from pytorch_ddp_resnet_tpu_torch.ops.cuda import build

        lib = build.load("transition")
        sigs = {
            "fwd_amax_launch": [_P] * 5 + [_I] * 5 + [_F, _P],
            "fwd_pre_launch": [_P] * 8 + [_I] * 13 + [_F, _P],
            "fwd_gemm_launch": [_P] * 10 + [_I] * 16 + [_P],
            "bwd_quant_launch": [_P] * 13 + [_I] * 7 + [_F, _P],
            "bwd_fold_launch": [_P] * 11 + [_I] * 7 + [_F, _P],
            "dgrad_pre_launch": [_P] * 4 + [_I] * 6 + [ctypes.c_long, _P],
            "dgrad_gemm_launch": ([_P] * 15 + [_I] * 9
                                  + [ctypes.c_long, _I, _F, _P]),
            "dgrad_sum_launch": [_P, _P, _I, _I, _P],
            "partial_sum_launch": [_P, _P, _I, _I, _P],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = _I
        _lib = lib
    return _lib


def _library_wgrad() -> ctypes.CDLL:
    """csrc/transition_wgrad.cu: both bodies' wgrad and dWp."""
    global _lib_wgrad
    if _lib_wgrad is None:
        from pytorch_ddp_resnet_tpu_torch.ops.cuda import build

        lib = build.load("transition_wgrad")
        lib.transition_wgrad_launch.argtypes = ([_P] * 3 + [_I, _P]
                                                + [_I] * 9 + [_P])
        lib.transition_wgrad_launch.restype = _I
        lib.transition_wgrad_s8_launch.argtypes = ([_P] * 5 + [_I, _P]
                                                   + [_I] * 8 + [_P])
        lib.transition_wgrad_s8_launch.restype = _I
        lib.partial_sum_launch.argtypes = [_P, _P, _I, _I, _P]
        lib.partial_sum_launch.restype = _I
        _lib_wgrad = lib
    return _lib_wgrad


def _launch(name: str, fn, *args) -> None:
    check_rc(name, fn(*args))
    launches[name] += 1


def _partial_sum(name: str, part: torch.Tensor, lib=None) -> torch.Tensor:
    """out[i] = sum over j of part[j, i], in order, in f32 (with ``lib``'s
    launch, else transition.cu's)."""
    j, m = part.shape
    out = torch.empty(m, dtype=_F32, device=part.device)
    _launch(name, (lib or _library()).partial_sum_launch, part.data_ptr(),
            out.data_ptr(), j, m, _stream(part))
    return out


def _prologue_args(name, x, scale, shift, bits, extra=(), extra_dtypes=()):
    """scale and shift as contiguous f32, after checking x, them, the bits
    and ``extra`` against their dtypes on the card."""
    scale, shift = scale.to(_F32).contiguous(), shift.to(_F32).contiguous()
    tensors = [x, scale, shift, *extra]
    dtypes = [torch.bfloat16, _F32, _F32, *extra_dtypes]
    if bits is not None:
        tensors.append(bits)
        dtypes.append(torch.uint8)
    require_cuda(name, tensors, dtypes)
    return scale, shift


def fwd_amax(x, scale, shift, bits, *, thresh, tile):
    """The prologue's partial absmaxes per scale group of ``4 * tile``
    input lanes: [G, slices] f32 (the group's absmax is a row's maximum;
    the plain version has one column)."""
    if on_cpu(x):
        return fwd_amax_plain(x, scale, shift, bits, thresh=thresh,
                              tile=tile)
    name = "transition_fwd.amax"
    cin, n = x.shape
    if n % (4 * tile) or tile % 8:
        raise ValueError(f"{name}: tile {tile} vs N={n}")
    scale, shift = _prologue_args(name, x, scale, shift, bits)
    groups = n // (4 * tile)
    s = fb._slices(groups)
    part = torch.empty((groups, s), dtype=_F32, device=x.device)
    _launch(name, _library().fwd_amax_launch, x.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), _ptr(bits), part.data_ptr(),
            cin, n, 4 * tile, s, thresh or 256,
            fb.inv_keep(thresh) if bits is not None else 1.0, _stream(x))
    return part


def fwd_pre(x, scale, shift, bits, part, *, thresh, lay):
    """The forward's slabs of layout ``lay`` (``fwd_pre_plain``): the
    prologue recomputed and quantized once per element at its group's
    scale, the parity planes written position-major; the raw even-even
    plane into the bf16 slab; the group absmaxes. One launch."""
    if on_cpu(x):
        return fwd_pre_plain(x, scale, shift, bits, part, thresh=thresh,
                             lay=lay)
    name = "transition_fwd.pre"
    if tuple(x.shape) != (lay.cin, lay.n) or part.shape[0] != lay.groups:
        raise ValueError(f"{name}: x {tuple(x.shape)}, partial maxima "
                         f"{tuple(part.shape)} vs the layout {lay}")
    scale, shift = _prologue_args(name, x, scale, shift, bits, [part],
                                  [_F32])
    dev = x.device
    slab = torch.empty((4 * lay.plane_len, lay.cp), dtype=torch.int8,
                       device=dev)
    ee = torch.empty((lay.plane_len, lay.cpb), dtype=torch.bfloat16,
                     device=dev)
    amax = torch.empty(lay.groups, dtype=_F32, device=dev)
    _launch(name, _library().fwd_pre_launch, x.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), _ptr(bits), part.data_ptr(), amax.data_ptr(),
            slab.data_ptr(), ee.data_ptr(), lay.cin, lay.n, lay.h, lay.w,
            lay.imgs, lay.groups, part.shape[1], lay.guard, lay.m_valid,
            lay.plane_len, lay.cp, lay.cpb, thresh or 256,
            fb.inv_keep(thresh) if bits is not None else 1.0, _stream(x))
    return slab, ee, amax


def fwd_tile(lay: TransitionFwdLayout):
    """(bn, bk) of the forward GEMM: a 128-wide N tile where Cout >= 128
    (A read ceil(Cout/128) times), else 64; the layout's K step."""
    return (128 if lay.cout >= 128 else 64), lay.bk


def fwd_gemm(slab, ee, amax, w_q, ws, wp_c, lay):
    """(z, zsum, zssq, res) from the slabs of layout ``lay``
    (``fwd_gemm_plain``): the exact s32 contraction over (tap, channel) on
    128-row tiles, z = bf16(f32(acc) * f32(ws * amax * f32(1/127))) with
    each row's group's scale; res = bf16 of the f32 sum of Wp [Cout, Cin]
    against the even-even slab (``wp_c``), or its channels with zeros
    added (None); each tile's sums of z and z^2 added in a fixed order (bit
    for bit the same every run)."""
    if on_cpu(slab):
        return fwd_gemm_plain(slab, ee, amax, w_q, ws, wp_c, lay)
    name = "transition_fwd"
    cout = w_q.shape[0]
    if tuple(slab.shape) != (4 * lay.plane_len, lay.cp) or \
            tuple(ee.shape) != (lay.plane_len, lay.cpb):
        raise ValueError(f"{name}: slabs {tuple(slab.shape)}, "
                         f"{tuple(ee.shape)} are not of the layout {lay}")
    if tuple(w_q.shape) != (lay.cout, 9 * lay.cin):
        raise ValueError(f"{name}: weights {tuple(w_q.shape)} vs Cin "
                         f"{lay.cin}, Cout {lay.cout}")
    if lay.tiles > 65535:
        raise ValueError(f"{name}: {lay.tiles} tiles exceed the grid")
    ws = ws.to(_F32).contiguous()
    wt = _pad_w_fwd(w_q, lay)
    tensors = [slab, ee, amax, wt, ws]
    dtypes = [torch.int8, torch.bfloat16, _F32, torch.int8, _F32]
    wpp = None
    # the projection's bf16 rows: cin channels (8-channel multiples: rows
    # of whole 16-byte pieces), the K bytes past them read as zeros
    kp = -(-lay.cin // 8) * 8
    if wp_c is not None:
        if tuple(wp_c.shape) != (cout, lay.cin):
            raise ValueError(f"{name}: projection {tuple(wp_c.shape)}")
        wpp = (wp_c if kp == lay.cin
               else F.pad(wp_c, (0, kp - lay.cin))).contiguous()
        tensors.append(wpp)
        dtypes.append(torch.bfloat16)
    elif cout < lay.cin:
        raise ValueError(f"{name}: option A needs Cout >= Cin")
    require_cuda(name, tensors, dtypes)
    dev = slab.device
    n_out = lay.n // 4
    z = torch.empty((cout, n_out), dtype=torch.bfloat16, device=dev)
    res = torch.empty((cout, n_out), dtype=torch.bfloat16, device=dev)
    part = torch.empty((lay.tiles, 2 * cout), dtype=_F32, device=dev)
    shifts = (ctypes.c_int * 9)(*lay.shifts)
    _launch(name, _library().fwd_gemm_launch, slab.data_ptr(),
            wt.data_ptr(), ws.data_ptr(), amax.data_ptr(),
            ee.data_ptr(), _ptr(wpp), z.data_ptr(), res.data_ptr(),
            part.data_ptr(), ctypes.addressof(shifts), lay.ee_shift, cout,
            lay.cp, lay.cpb, 9 * lay.cp, lay.krow, 2 * kp,
            -(-2 * lay.cpb // PROJ_BK) * PROJ_BK, lay.tiles, lay.imgs,
            lay.n // (lay.h * lay.w), lay.h, lay.w, n_out, *fwd_tile(lay),
            _stream(slab))
    sums = _partial_sum(f"{name}.sum", part)
    return z, sums[:cout], sums[cout:], res


def fwd_conv(x, scale, shift, bits, w_q, ws, wp_c, *, thresh, tile, h,
             w_img):
    """The forward: (z, zsum, zssq, res, amax) of the prologue of x
    quantized per scale group of ``tile`` output lanes, conv1's int8
    weights (``w_q``, ``ws``) and the shortcut (``wp_c`` [Cout, Cin] bf16,
    or None for option A); ``amax`` [G] f32 is each group's raw absmax of
    the prologue, which the FQT backward's activation quantizer takes
    (``bwd_quantize``). On the card ``fwd_amax``, ``fwd_pre``,
    ``fwd_gemm``."""
    if on_cpu(x):
        d_q, amax = fb.fwd_quantize_plain(x, scale, shift, bits,
                                          thresh=thresh, tile=4 * tile)
        return (*fwd_conv_plain(d_q, amax, w_q, ws, x, wp_c, tile=tile, h=h,
                                w_img=w_img), amax)
    cin, n = x.shape
    lay = transition_fwd_layout(n, h, w_img, cin, w_q.shape[0], tile)
    part = fwd_amax(x, scale, shift, bits, thresh=thresh, tile=tile)
    slab, ee, amax = fwd_pre(x, scale, shift, bits, part, thresh=thresh,
                             lay=lay)
    return (*fwd_gemm(slab, ee, amax, w_q, ws, wp_c, lay), amax)


def _cotangent_args(dz, z, dzsum, dzssq):
    dzsum = dzsum.to(_F32).contiguous()
    dzssq = dzssq.to(_F32).contiguous()
    return ([dz, z, dzsum, dzssq],
            [torch.bfloat16, torch.bfloat16, _F32, _F32], dzsum, dzssq)


def check_operand_geometry(name: str, h: int, w_img: int, n: int,
                           tile: int) -> None:
    """The backward's operand passes' shape needs: whole images of even H
    and W (each output lane reads its own input pair) and scale groups of
    ``tile`` output lanes, a multiple of 8 (a unit of the passes), that
    fill N' (the fold takes tile = 8: its units alone)."""
    if h % 2 or w_img % 2 or h < 2 or w_img < 2 or n % (h * w_img):
        raise ValueError(f"{name}: geometry H={h} W={w_img} N={n} is not "
                         "whole images of even H and W")
    if tile < 8 or tile % 8 or (n // 4) % tile:
        raise ValueError(f"{name}: scale group of {tile} output lanes vs "
                         f"N'={n // 4}")


def operand_rows(w_img: int) -> bool:
    """Whether the fold takes a unit's 16 input pixels as 16-byte vectors:
    output rows of a multiple of 8 pixels, so that a unit's 8 output lanes
    lie in one row (else each lane loads its own pair; the FQT quantizer
    always does, which ran faster there on an H100)."""
    return (w_img // 2) % 8 == 0


# The fold's unit load where a test or a bench holds both loads against
# each other (True: 16-byte rows, False: a pair a lane); None, the
# wrapper's own choice (``operand_rows``).
_fold_rows: Optional[bool] = None


def _operand_args(name, dz, z, dzsum, dzssq, x, scale, shift, bits, extra=(),
                  extra_dtypes=()):
    """dzsum, dzssq, scale and shift as contiguous f32, after checking the
    cotangent, x, the bits and ``extra`` against their dtypes on the
    card."""
    tensors, dtypes, dzsum, dzssq = _cotangent_args(dz, z, dzsum, dzssq)
    scale, shift = _prologue_args(name, x, scale, shift, bits,
                                  [*tensors, *extra],
                                  [*dtypes, *extra_dtypes])
    return dzsum, dzssq, scale, shift


def bwd_quantize(dz, z, dzsum, dzssq, x, scale, shift, bits, d_amax, *,
                 thresh, tile, h, w_img):
    """The FQT backward's operands: the folded cotangent quantized per group
    of ``tile`` output lanes, the recomputed activation per group of
    ``4 * tile`` input lanes at the forward's group absmax ``d_amax`` [G]
    f32 (``fwd_conv``'s; floor 1e-30) as its parity planes [4, Cin, N'],
    and x's even-even plane for dWp: (g_q, g_amax, d_q, d_amax, x_ee),
    ``d_amax`` returned as it came. On the card one launch
    (``transition_bwd.quant``): a thread-block cluster per group of the
    cotangent, whose blocks fold it, reduce their partial maxima through
    distributed shared memory, fold it again from L2 and quantize, and
    blocks that quantize the activation, one unit of 8 output lanes a
    thread, each lane loading its own input pair. On the CPU
    ``bwd_quantize_plain``, whose own absmax equals the forward's bit for
    bit."""
    if on_cpu(dz):
        return bwd_quantize_plain(dz, z, dzsum, dzssq, x, scale, shift, bits,
                                  thresh=thresh, tile=tile, h=h, w_img=w_img)
    name = "transition_bwd"
    cout, n_out = dz.shape
    cin, n = x.shape
    if n != 4 * n_out:
        raise ValueError(f"{name}: N={n}, N'={n_out}")
    check_operand_geometry(name, h, w_img, n, tile)
    groups = n_out // tile
    if tuple(d_amax.shape) != (groups,):
        raise ValueError(f"{name}: the forward's absmax "
                         f"{tuple(d_amax.shape)} vs {groups} scale groups")
    dzsum, dzssq, scale, shift = _operand_args(
        name, dz, z, dzsum, dzssq, x, scale, shift, bits, [d_amax], [_F32])
    dev = dz.device
    g_q = torch.empty((cout, n_out), dtype=torch.int8, device=dev)
    d_q = torch.empty((4, cin, n_out), dtype=torch.int8, device=dev)
    g_amax = torch.empty(groups, dtype=_F32, device=dev)
    x_ee = torch.empty((cin, n_out), dtype=torch.bfloat16, device=dev)
    _launch(f"{name}.quant", _library().bwd_quant_launch, dz.data_ptr(),
            z.data_ptr(), dzsum.data_ptr(), dzssq.data_ptr(), x.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), _ptr(bits),
            d_amax.data_ptr(), g_q.data_ptr(), d_q.data_ptr(),
            g_amax.data_ptr(), x_ee.data_ptr(), cout, cin, n_out, tile, h,
            w_img, thresh or 256,
            fb.inv_keep(thresh) if bits is not None else 1.0, _stream(dz))
    return g_q, g_amax, d_q, d_amax, x_ee


def bwd_fold(dz, z, dzsum, dzssq, x, scale, shift, bits, *, thresh, h,
             w_img):
    """The straight-through operands: g = bf16(gf) [Cout, N'], the bf16
    prologue d (dropout(relu(bf16(x * scale + shift)))) as its parity
    planes [4, Cin, N'] and x's even-even plane [Cin, N']. On the card one
    launch (``transition_bwd.fold``), the activation in units of 8 output
    lanes as ``bwd_quantize`` walks it (their 16 input pixels as 16-byte
    vectors where ``operand_rows``; else each lane loads its own pair)."""
    if on_cpu(dz):
        return bwd_fold_plain(dz, z, dzsum, dzssq, x, scale, shift, bits,
                              thresh=thresh, h=h, w_img=w_img)
    name = "transition_bwd.fold"
    cout, n_out = dz.shape
    cin, n = x.shape
    if n != 4 * n_out:
        raise ValueError(f"{name}: N={n}, N'={n_out}")
    check_operand_geometry(name, h, w_img, n, 8)
    rows = operand_rows(w_img) if _fold_rows is None else _fold_rows
    dzsum, dzssq, scale, shift = _operand_args(
        name, dz, z, dzsum, dzssq, x, scale, shift, bits)
    dev = dz.device
    g = torch.empty((cout, n_out), dtype=torch.bfloat16, device=dev)
    d = torch.empty((4, cin, n_out), dtype=torch.bfloat16, device=dev)
    x_ee = torch.empty((cin, n_out), dtype=torch.bfloat16, device=dev)
    _launch(name, _library().bwd_fold_launch, dz.data_ptr(), z.data_ptr(),
            dzsum.data_ptr(), dzssq.data_ptr(), x.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), _ptr(bits), g.data_ptr(),
            d.data_ptr(), x_ee.data_ptr(), cout, cin, n_out, h, w_img,
            int(rows), thresh or 256,
            fb.inv_keep(thresh) if bits is not None else 1.0, _stream(dz))
    return g, d, x_ee


def _pad_w_dgrad(w_dg, lay):
    """w_dg [Cin, 9*Cout] -> [Cin, 9*cp]: each tap's channels padded with
    zeros to g's slab's cp (w_dg itself where cp == Cout)."""
    if lay.cp == lay.cout:
        return w_dg.contiguous()
    return F.pad(w_dg.reshape(lay.cin, 9, lay.cout),
                 (0, lay.cp - lay.cout)).reshape(lay.cin, -1).contiguous()


def dgrad_pre(g, dres, lay):
    """g [Cout, N'] (int8 for the FQT layout, else bf16) and, where a
    projection runs, dres [Cout, N'] bf16 into their slabs of layout
    ``lay`` (``dgrad_pre_plain``): (gslab, dslab or None). One launch."""
    if on_cpu(g):
        return dgrad_pre_plain(g, dres, lay)
    name = "transition_dgrad.pre"
    n_out = lay.n // 4
    el = torch.int8 if lay.quant else torch.bfloat16
    if tuple(g.shape) != (lay.cout, n_out) or (
            dres is not None and tuple(dres.shape) != (lay.cout, n_out)):
        raise ValueError(f"{name}: g {tuple(g.shape)} vs the layout {lay}")
    tensors, dtypes = [g], [el]
    if dres is not None:
        tensors.append(dres)
        dtypes.append(torch.bfloat16)
    require_cuda(name, tensors, dtypes)
    gslab = torch.empty((lay.slab_len, lay.cp), dtype=el, device=g.device)
    dslab = (None if dres is None else torch.empty(
        (lay.slab_len, lay.cout), dtype=torch.bfloat16, device=g.device))
    _launch(name, _library().dgrad_pre_launch, g.data_ptr(), _ptr(dres),
            gslab.data_ptr(), _ptr(dslab), int(lay.quant), lay.cout, lay.cp,
            n_out, lay.oh, lay.ow, lay.slab_len, _stream(g))
    return gslab, dslab


def dgrad_gemm(gslab, dslab, g_amax, w_dg, ws_in, x, scale, shift, bits,
               dres, wpt, *, thresh, lay):
    """(dx [Cin, N] bf16, d(scale), d(shift) [Cin] f32) from the slabs of
    layout ``lay`` (``dgrad_gemm_plain``): on the card each parity class a
    range of taps on the s8 (FQT, TMA-fed) or bf16 wgmma mainloop, two
    classes a block, the projection's shortcut on the bf16 one; dx written
    through the masks and each tile's sums in a fixed order
    (``transition_dgrad``), then the tiles' sums in order
    (``transition_dgrad.sum``): bit for bit the same every run."""
    if on_cpu(gslab):
        return dgrad_gemm_plain(gslab, dslab, g_amax, w_dg, ws_in, x, scale,
                                shift, bits, dres, wpt, thresh=thresh,
                                lay=lay)
    name = "transition_dgrad"
    cin, cout, n_out = lay.cin, lay.cout, lay.n // 4
    el = torch.int8 if lay.quant else torch.bfloat16
    if tuple(gslab.shape) != (lay.slab_len, lay.cp) or (
            (dslab is None) != (wpt is None)) or (
            dslab is not None and tuple(dslab.shape) != (lay.slab_len, cout)):
        raise ValueError(f"{name}: slabs do not match the layout {lay}")
    if tuple(w_dg.shape) != (cin, 9 * cout) or tuple(x.shape) != (cin,
                                                                  lay.n):
        raise ValueError(f"{name}: weights {tuple(w_dg.shape)}, x "
                         f"{tuple(x.shape)} vs the layout {lay}")
    if (g_amax is not None) != lay.quant:
        raise ValueError(f"{name}: the layout's body and g_amax disagree")
    if wpt is None and cout < cin:
        raise ValueError(f"{name}: option A needs Cout >= Cin")
    if tuple(dres.shape) != (cout, n_out):
        raise ValueError(f"{name}: dres {tuple(dres.shape)}")
    w_p = _pad_w_dgrad(w_dg, lay)
    extra, dtypes = [gslab, w_p, dres], [el, el, torch.bfloat16]
    if lay.quant:
        ws_in = ws_in.to(_F32).contiguous()
        extra += [g_amax, ws_in]
        dtypes += [_F32, _F32]
    if wpt is not None:
        extra += [dslab, wpt]
        dtypes += [torch.bfloat16, torch.bfloat16]
    scale, shift = _prologue_args(name, x, scale, shift, bits, extra, dtypes)
    dev = x.device
    dx = torch.empty((cin, lay.n), dtype=torch.bfloat16, device=dev)
    part = torch.empty((2 * lay.tiles, 2 * cin), dtype=_F32, device=dev)
    sc = (None if wpt is None else
          torch.empty((cin, n_out), dtype=_F32, device=dev))
    table = (ctypes.c_int * 24)(*(
        v for first, count, offs in lay.classes
        for v in (first, count, *offs, *(0,) * (4 - count))))
    _launch(name, _library().dgrad_gemm_launch, gslab.data_ptr(),
            _ptr(dslab), w_p.data_ptr(), _ptr(wpt), _ptr(g_amax),
            _ptr(ws_in if lay.quant else None), x.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), _ptr(bits), dres.data_ptr(),
            _ptr(sc), dx.data_ptr(), part.data_ptr(),
            ctypes.addressof(table), int(lay.quant), cin, cout, lay.cp,
            n_out, lay.oh, lay.ow, lay.tile, lay.tiles, lay.slab_len,
            thresh or 256, fb.inv_keep(thresh) if bits is not None else 1.0,
            _stream(x))
    sums = torch.empty(2 * cin, dtype=_F32, device=dev)
    _launch(f"{name}.sum", _library().dgrad_sum_launch, part.data_ptr(),
            sums.data_ptr(), 2 * lay.tiles, 2 * cin, _stream(x))
    return dx, sums[:cin], sums[cin:]


def dgrad(g, g_amax, w_dg, ws_in, x, scale, shift, bits, dres, wpt, *,
          thresh, tile, h, w_img):
    """The input gradient through the masks, plus the shortcut's cotangent
    on the even-even pixels: (dx [Cin, N] bf16, d(scale), d(shift) [Cin]
    f32). FQT: g int8 with ``g_amax`` and ``ws_in``; straight-through: g
    bf16, both None. On the card ``dgrad_pre`` then ``dgrad_gemm`` on
    ``transition_dgrad_layout`` (any geometry of ``check_fwd_geometry``)."""
    if on_cpu(g):
        return dgrad_plain(g, g_amax, w_dg, ws_in, x, scale, shift, bits,
                           dres, wpt, thresh=thresh, tile=tile, h=h,
                           w_img=w_img)
    cout, n_out = g.shape
    cin, n = x.shape
    if n != 4 * n_out:
        raise ValueError(f"transition_dgrad: N={n} vs N'={n_out}")
    lay = transition_dgrad_layout(n, h, w_img, cin, cout, tile,
                                  g_amax is not None)
    gslab, dslab = dgrad_pre(g, dres if wpt is not None else None, lay)
    return dgrad_gemm(gslab, dslab, g_amax, w_dg, ws_in, x, scale, shift,
                      bits, dres, wpt, thresh=thresh, lay=lay)


# the N tiles csrc/wgrad_wgmma_s8.cuh is built for without a split
S8_BNS = (128, 64, 32)


class WgradS8Plan(NamedTuple):
    """How the FQT wgrad's kernel cuts dW [9*Cin, Cout]: ``m_tiles`` x
    ``n_tiles`` tiles of 128 x ``bn``, one block each, ``waves`` waves on
    132 SMs; every block walks all ``steps`` K steps of 128 positions,
    ``spg`` to a scale group; ``us`` the model's time."""
    bn: int
    m_tiles: int
    n_tiles: int
    steps: int
    spg: int
    waves: int
    us: float


def check_wgrad_s8_geometry(name: str, cin: int, cout: int, h: int,
                            w_img: int, n_out: int, tile: int) -> None:
    """The FQT wgrad's own shape needs (csrc/wgrad_wgmma_s8.cuh, at the
    output geometry (h/2, w_img/2) of ``n_out`` positions): Cin in
    32-channel pieces, which the op's zero padding gives; Cout a multiple
    of 8; whole output images of a multiple of 16 positions (a 16-byte unit
    of a K step lies in one image); scale groups of ``tile`` positions, a
    whole number of 128-position K steps. This takes every shape of
    ``check_wgrad_geometry`` and more, and bounds the FQT body as a whole:
    its operand passes and dgrad take any whole images of even H and W."""
    if h % 2 or w_img % 2:
        raise ValueError(f"{name}: geometry H={h} W={w_img} is not even")
    oh, ow = h // 2, w_img // 2
    if cin % 32:
        raise ValueError(f"{name}: Cin={cin} is not a multiple of 32")
    if cout % 8:
        raise ValueError(f"{name}: Cout={cout} is not a multiple of 8")
    if (oh * ow) % 16 or n_out % (oh * ow):
        raise ValueError(f"{name}: N'={n_out} / output image {oh}x{ow} is "
                         "not whole images of a multiple of 16 positions")
    if tile % S8_BK or n_out % tile:
        raise ValueError(f"{name}: scale group of {tile} positions vs "
                         f"N'={n_out} and the {S8_BK}-position K step")


@functools.lru_cache(maxsize=None)
def wgrad_s8_plan(cin: int, cout: int, n_out: int, h: int, w_img: int,
                  tile: int) -> WgradS8Plan:
    """The FQT wgrad's N tile, from a model of its blocks on an H100: the
    blocks run in waves of one an SM, each bringing in its staged d rows
    (144 bytes a 128-byte K step of each of its M rows; every N tile loads
    them again) and its B rows (every M tile loads them again), at the
    smaller of an SM's rate and the card's rate shared by the wave's
    blocks; the widest tile among equals. No split over positions: the
    scale groups are added in order inside each tile. Cached: every call
    asks."""
    check_wgrad_s8_geometry("wgrad_s8_plan", cin, cout, h, w_img, n_out,
                            tile)
    m = 9 * cin
    m_tiles, steps = -(-m // S8_BM), n_out // S8_BK

    def plan(bn):
        _, waves, us = s8_model(m, cout, n_out, bn)
        return WgradS8Plan(bn, m_tiles, -(-cout // bn), steps,
                           tile // S8_BK, waves, us)

    return min((plan(bn) for bn in S8_BNS), key=lambda p: (p.us, -p.bn))


def wgrad(g_q, g_amax, d_q, d_amax, *, tile, h, w_img):
    """FQT dW [3, 3, Cin, Cout] f32 (HWIO): the int8 cotangent g_q [Cout,
    N'] against the activation's parity planes d_q [4, Cin, N'] of
    ``bwd_quantize``, per scale group of ``tile`` output lanes, the groups
    added in order. On the card one launch of the TMA + s8 wgmma kernel
    (``transition_wgrad_s8``) on ``wgrad_s8_plan``'s tiles, bit-equal to
    the plain version; the geometry of ``check_wgrad_s8_geometry``."""
    if on_cpu(g_q):
        return wgrad_plain(g_q, g_amax, d_q, d_amax, tile=tile, h=h,
                           w_img=w_img)
    name = "transition_wgrad_s8"
    if d_q.dim() != 3 or d_q.shape[0] != 4:
        raise ValueError(f"{name}: d {tuple(d_q.shape)} is not 4 parity "
                         "planes")
    cout, n_out = g_q.shape
    cin = d_q.shape[1]
    if d_q.shape[2] != n_out:
        raise ValueError(f"{name}: operands {tuple(d_q.shape)} and "
                         f"{tuple(g_q.shape)}")
    check_wgrad_s8_geometry(name, cin, cout, h, w_img, n_out, tile)
    groups = n_out // tile
    if tuple(g_amax.shape) != (groups,) or tuple(d_amax.shape) != (groups,):
        raise ValueError(f"{name}: absmaxes {tuple(g_amax.shape)}, "
                         f"{tuple(d_amax.shape)} vs {groups} scale groups")
    require_cuda(name, [g_q, g_amax, d_q, d_amax],
                 [torch.int8, _F32, torch.int8, _F32])
    plan = wgrad_s8_plan(cin, cout, n_out, h, w_img, tile)
    dw = torch.empty((9 * cin, cout), dtype=_F32, device=g_q.device)
    tab = (ctypes.c_int * 27)(*(v for t in TAP_TABLE for v in t))
    _launch(name, _library_wgrad().transition_wgrad_s8_launch,
            d_q.data_ptr(), g_q.data_ptr(), g_amax.data_ptr(),
            d_amax.data_ptr(), dw.data_ptr(), 4, ctypes.addressof(tab), 9,
            cin, cout, n_out, h // 2, w_img // 2, tile, plan.bn, _stream(g_q))
    return dw.reshape(3, 3, cin, cout)


def check_wgrad_geometry(name: str, cin: int, cout: int, h: int, w_img: int,
                         n_out: int) -> None:
    """The straight-through wgrad's and dWp's own shape needs
    (csrc/wgrad_wgmma_bf16.cuh, at the output geometry (h/2, w_img/2) of
    ``n_out`` positions): ``conv3x3.check_wgrad_geometry``'s rule (Cin in
    32-channel boxes, which the op's zero padding gives; output rows of W'
    = 8, 16 or 32 with H' a multiple of 64 / W', or W' a multiple of 64),
    and Cout a multiple of 8. The dgrad takes the forward's wider rule
    (``check_fwd_geometry``)."""
    if h % 2 or w_img % 2:
        raise ValueError(f"{name}: geometry H={h} W={w_img} is not even")
    conv3x3.check_wgrad_geometry(name, cin, n_out, h // 2, w_img // 2)
    if cout % 8:
        raise ValueError(f"{name}: Cout={cout} is not a multiple of 8")


def wgrad_tma_plan(taps: int, cin: int, cout: int, n_out: int, h: int,
                   w_img: int) -> conv3x3.WgradTmaPlan:
    """The TMA wgrad's tiles and splits for ``taps`` taps (9, or dWp's 1)
    at the output geometry: ``conv3x3.wgrad_tma_plan``'s rule on M = taps *
    Cin."""
    return conv3x3.wgrad_tma_plan(cin, cout, n_out, h // 2, w_img // 2,
                                  taps=taps)


def _wgrad_tma(name: str, sum_name: str, x: torch.Tensor, g: torch.Tensor,
               table, h: int, w_img: int) -> torch.Tensor:
    """One launch of csrc/transition_wgrad.cu over its plan's splits, then
    their ordered sum (``sum_name``): [taps * Cin, Cout] f32 of x [planes,
    Cin, N'] and g [Cout, N'], tap t reading plane table[t][0] at its
    shifts."""
    planes, cin, n_out = x.shape
    cout = g.shape[0]
    if g.shape[1] != n_out:
        raise ValueError(f"{name}: operands {tuple(x.shape)} and "
                         f"{tuple(g.shape)}")
    check_wgrad_geometry(name, cin, cout, h, w_img, n_out)
    require_cuda(name, [x, g], [torch.bfloat16, torch.bfloat16])
    taps = len(table)
    plan = wgrad_tma_plan(taps, cin, cout, n_out, h, w_img)
    m = taps * cin * cout
    part = torch.empty((plan.splits, m), dtype=_F32, device=g.device)
    tab = (ctypes.c_int * (3 * taps))(*(v for t in table for v in t))
    lib = _library_wgrad()
    _launch(name, lib.transition_wgrad_launch, x.data_ptr(), g.data_ptr(),
            part.data_ptr(), planes, ctypes.addressof(tab), taps, cin, cout,
            n_out, h // 2, w_img // 2, plan.bn, plan.per, plan.splits,
            _stream(g))
    return _partial_sum(sum_name, part, lib).reshape(taps * cin, cout)


def wgrad_bf16(g, d, *, h, w_img):
    """Straight-through dW [3, 3, Cin, Cout] f32 (HWIO): g [Cout, N'] bf16
    against the prologue's parity planes d [4, Cin, N'] of ``bwd_fold``.
    On the card one launch of the TMA + wgmma kernel at the nine taps of
    ``TAP_TABLE`` (``transition_wgrad_tma``) and its ordered sum
    (``.sum``); the geometry of ``check_wgrad_geometry``."""
    if on_cpu(g):
        return wgrad_bf16_plain(g, d, h=h, w_img=w_img)
    name = "transition_wgrad_tma"
    if d.dim() != 3 or d.shape[0] != 4:
        raise ValueError(f"{name}: d {tuple(d.shape)} is not 4 parity "
                         "planes")
    return _wgrad_tma(name, f"{name}.sum", d, g, TAP_TABLE, h,
                      w_img).reshape(
        3, 3, d.shape[1], g.shape[0])


def wgrad_proj(dres, x_ee, *, h, w_img):
    """dWp^T = x_ee @ dres^T [Cin, Cout] f32 (bf16 products, f32 sums), x_ee
    the even-even plane [Cin, N'] of ``bwd_fold`` or ``bwd_quantize``. On
    the card the TMA + wgmma kernel at one unshifted tap
    (``transition_wgrad_tma.proj``) and its ordered sum (``.proj_sum``)."""
    if on_cpu(dres):
        return wgrad_proj_plain(dres, x_ee, h=h, w_img=w_img)
    return _wgrad_tma("transition_wgrad_tma.proj",
                      "transition_wgrad_tma.proj_sum", x_ee[None], dres,
                      ((0, 0, 0),), h, w_img)


# --- the differentiable op --------------------------------------------------------

class _TransitionHalf(torch.autograd.Function):
    """Forward and backward of one transition half. The bits carry no
    gradient; ``bits`` here is already in the [Cin, N] lane order."""

    @staticmethod
    def forward(ctx, x_cs, w1, wp, scale, shift, bits, thresh, h, w_img,
                quant_bwd, tile):
        cin = x_cs.shape[0]
        cout = w1.shape[0]
        # the reference's _quant_pack_w_fwd is the fused half's quantizer
        w_q, ws = fb.quantize_pack_weights(w1.detach())
        wp_c = (None if wp is None else
                wp.detach().reshape(cout, cin).to(x_cs.dtype).contiguous())
        z, zsum, zssq, res, amax = fwd_conv(x_cs, scale, shift, bits, w_q,
                                            ws, wp_c, thresh=thresh,
                                            tile=tile, h=h, w_img=w_img)
        # the FQT backward quantizes the activation at the forward's group
        # absmax
        ctx.save_for_backward(x_cs, w1, wp, scale, shift, bits, z,
                              amax if quant_bwd else None)
        ctx.cfg = (thresh, h, w_img, quant_bwd, tile)
        return z, zsum, zssq, res

    @staticmethod
    def backward(ctx, dz, dzsum, dzssq, dres):
        x_cs, w1, wp, scale, shift, bits, z, amax = ctx.saved_tensors
        thresh, h, w_img, quant_bwd, tile = ctx.cfg
        cout, cin = w1.shape[:2]
        dz, dres = dz.contiguous(), dres.contiguous()
        wpt = (None if wp is None else
               wp.detach().reshape(cout, cin).t().to(x_cs.dtype).contiguous())
        kw = dict(thresh=thresh, h=h, w_img=w_img)
        geo = dict(h=h, w_img=w_img)
        if quant_bwd:
            w_dg, ws_in = quant_pack_w_dgrad(w1.detach())
            g, g_amax, d_q, d_amax, x_ee = bwd_quantize(
                dz, z, dzsum, dzssq, x_cs, scale, shift, bits, amax,
                tile=tile, **kw)
            dx, ds, dt = dgrad(g, g_amax, w_dg, ws_in, x_cs, scale, shift,
                               bits, dres, wpt, tile=tile, **kw)
            # HWIO -> OIHW
            dw = wgrad(g, g_amax, d_q, d_amax, tile=tile, **geo).permute(
                3, 2, 0, 1)
        else:
            g, d, x_ee = bwd_fold(dz, z, dzsum, dzssq, x_cs, scale, shift,
                                  bits, **kw)
            w_dg = pack_w_dgrad(w1.detach().to(x_cs.dtype))
            dx, ds, dt = dgrad(g, None, w_dg, None, x_cs, scale, shift, bits,
                               dres, wpt, tile=tile, **kw)
            # HWIO -> OIHW
            dw = wgrad_bf16(g, d, **geo).permute(3, 2, 0, 1)
        dwp = (None if wp is None else
               wgrad_proj(dres, x_ee, **geo).t().reshape(wp.shape).to(
                   wp.dtype))
        return (dx, dw.to(w1.dtype), dwp, ds.to(scale.dtype),
                dt.to(shift.dtype), None, None, None, None, None, None)


def transition_half_int8(x_cs: torch.Tensor, w1: torch.Tensor,
                         wp: Optional[torch.Tensor], scale: torch.Tensor,
                         shift: torch.Tensor,
                         bits: Optional[torch.Tensor] = None, *,
                         dropout_rate: float = 0.0, h: int, w_img: int,
                         quant_bwd: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Differentiable stage-transition half with an int8 stride-2 conv
    core, lane in and lane out (the reference's ``transition_half_int8``).

    x_cs [Cin, B*h*w] (whole images, image-major), w1 [Cout, Cin, 3, 3],
    wp [Cout, Cin, 1, 1] (or [Cout, Cin]) or None for the option-A
    shortcut (Cout >= Cin), scale/shift [Cin] f32 (``fold_bn``), bits
    [4*Cin, N/4] uint8 over the parity-packed layout (``parity_pack``
    order; no seed mode), required iff the dropout rate rounds to a keep
    threshold below 256. ``quant_bwd``: the fully quantized backward
    (FQT), else the bf16 straight-through one.

    Returns (z_cs [Cout, N/4], zsum [Cout] f32, zssq [Cout] f32, res_cs
    [Cout, N/4]) at the output geometry (h/2, w/2). A Cin that is not a
    multiple of 32 (the gate admits Cin % 8) runs zero-padded to the next
    multiple, at the scale groups of the unpadded Cin: the kernels contract
    in 32-channel chunks."""
    thresh = fb.dropout_thresh(dropout_rate)
    if thresh >= 256:
        bits = None
    elif thresh <= 0:
        raise ValueError("dropout_rate >= 1 zeroes the activations; the "
                         "transition kernel does not support it.")
    elif bits is None:
        raise ValueError(f"dropout_rate={dropout_rate} needs a bits array.")
    if bits is not None and bits.dim() == 0:
        raise ValueError("transition_half_int8 takes materialized bits "
                         "only (no in-kernel seed mode).")
    if h % 2 or w_img % 2:
        raise ValueError(f"stride-2 transition needs even H, W; got "
                         f"{(h, w_img)}")
    if wp is None and w1.shape[0] < x_cs.shape[0]:
        raise ValueError("option-A shortcut cannot shrink channels")
    if x_cs.shape[1] % (h * w_img):
        raise ValueError(f"N={x_cs.shape[1]} is not a multiple of "
                         f"H*W={h * w_img}")
    cin, n = x_cs.shape
    cout = w1.shape[0]
    tile = transition_tile(h // 2, w_img // 2, n // 4, cin, cout)
    if bits is not None:
        bits = parity_unpack(bits, h, w_img)
    pin = -cin % 32
    if pin:
        # zero channels are exact: d = relu(0 * 0 + 0) = 0 leaves every
        # group absmax as it is, zero weights add nothing to z, res or the
        # sums, and the padded rows of dx, d(scale), d(shift) and the
        # weight gradients are sliced off by autograd through the pads
        x_cs, scale, shift = (pad_rows(t, pin) for t in (x_cs, scale,
                                                             shift))
        if bits is not None:
            bits = pad_rows(bits, pin)
        w1 = F.pad(w1, (0, 0, 0, 0, 0, pin))
        if wp is not None:
            wp = F.pad(wp, (0, 0) * (wp.dim() - 2) + (0, pin))
    return _TransitionHalf.apply(x_cs, w1, wp, scale, shift, bits,
                                 thresh if bits is not None else None, h,
                                 w_img, quant_bwd, tile)
