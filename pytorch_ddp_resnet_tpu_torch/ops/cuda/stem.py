"""The stem conv emitting the channel-major layout (counterpart of
pytorch_ddp_resnet_tpu/ops/pallas/stem.py ``stem_conv_lane``).

``stem_conv_lane(x_cs, w, b, h, w_img)``: x [Cin <= 8, N] (N = B*H*W,
image-major) -> [Cout, N], a 3x3 stride-1 SAME conv with bias, rounded as
the layer path rounds it: f32 sums, cast to the compute dtype, then the
bias added in the compute dtype. Its gradient reaches (w, b) only: the
input is the data batch (the reference returns zeros there).

- ``stem_fwd`` (launches ``stem_fwd``) and ``stem_wgrad`` (launches
  ``stem_wgrad``, ``stem_wgrad.sum``: a tensor-core GEMM over positions on
  the K runs of ``stem_wgrad_plan``, then the blocks' slots added in a
  fixed order) run ``csrc/stem.cu`` for a CUDA tensor, or raise; a CPU
  tensor runs the plain version beside each.
- ``stem_lane_tile``: copy of the JAX picker. The reference's tile orders
  its f32 sums only; here it serves as the eligibility gate.

The plain forward sums the 9 * Cin products in the kernel's order
(tap-major, channel-minor; each product of two bf16 values is exact in
f32), so the two agree bit for bit. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from pytorch_ddp_resnet_tpu_torch.ops.cuda.checks import (
    check_rc,
    on_cpu,
    require_cuda,
)
from pytorch_ddp_resnet_tpu_torch.ops.cuda.conv3x3 import (
    pack_weights,
    pick_tile,
)

launches: collections.Counter = collections.Counter()

CIN_MAX = 8
# the weight gradient's kernel (csrc/stem.cu): K steps of WG_KC positions,
# at most WG_COUT_MAX output channels (8 warps of two 16-row tiles); its
# plan aims at WG_BLOCKS_PER_SM blocks on each of an H100's SMS
WG_KC = 64
WG_COUT_MAX = 256
SMS = 132
WG_BLOCKS_PER_SM = 2

_P = ctypes.c_void_p
_I = ctypes.c_int
_F32 = torch.float32


def reset_launches() -> None:
    launches.clear()


def stem_lane_tile(h: int, w_img: int, n: int, cout: int) -> int:
    """The JAX lane-tile pick (raises ValueError for a geometry it cannot
    tile: the layer treats that as not eligible)."""
    return pick_tile(h * w_img, n, cout // 2, max_tile=4096)


class StemWgradPlan(NamedTuple):
    """How the weight gradient's kernel splits K: ``blocks`` blocks, each
    a contiguous run of ``per`` of the ``steps`` K steps of WG_KC positions
    (the last may have fewer); each block's sums take one slot of the
    partial buffer, and the sum adds the slots in order."""
    steps: int
    per: int
    blocks: int


def check_wgrad_geometry(cout: int, n: int, h: int, w_img: int) -> None:
    """The weight gradient's kernel's own shape needs: N whole images and a
    whole number of K steps (the stem's gate, ``stem_lane_tile``, already
    asks for a 128-position tile), Cout <= WG_COUT_MAX."""
    name = "stem_wgrad"
    if n % (h * w_img) or n % WG_KC:
        raise ValueError(f"{name}: N={n} of {h}x{w_img} images is not a "
                         f"multiple of the {WG_KC}-position K step")
    if not 1 <= cout <= WG_COUT_MAX:
        raise ValueError(f"{name}: Cout={cout} is not in 1..{WG_COUT_MAX}")


@functools.lru_cache(maxsize=None)
def stem_wgrad_plan(n: int, cout: int, h: int, w_img: int) -> StemWgradPlan:
    """Runs of K steps so that WG_BLOCKS_PER_SM blocks fall on every SM
    (the kernel streams dy: every SM has to read). Cached: every call
    asks."""
    check_wgrad_geometry(cout, n, h, w_img)
    steps = n // WG_KC
    per = -(-steps // (SMS * WG_BLOCKS_PER_SM))
    return StemWgradPlan(steps, per, -(-steps // per))


def _taps(x_cs: torch.Tensor, h: int, w_img: int) -> torch.Tensor:
    """[Cin, N] -> [9, Cin, N] f32: tap (dh, dw) of every position, zero
    outside the image."""
    cin, n = x_cs.shape
    b = n // (h * w_img)
    img = x_cs.to(_F32).reshape(cin, b, h, w_img)
    pad = F.pad(img, (1, 1, 1, 1))
    return torch.stack([pad[:, :, dh:dh + h, dw:dw + w_img].reshape(cin, n)
                        for dh in range(3) for dw in range(3)])


def stem_fwd_plain(x_cs, w_packed, b, *, h: int, w_img: int):
    """Plain version of ``stem_fwd``: w_packed [Cout, 9*Cin] in the compute
    dtype, b [Cout]."""
    cin, n = x_cs.shape
    cd = x_cs.dtype
    taps = _taps(x_cs, h, w_img)
    wf = w_packed.to(_F32)
    acc = torch.zeros((w_packed.shape[0], n), dtype=_F32,
                      device=x_cs.device)
    for tap in range(9):
        for c in range(cin):
            acc = acc + wf[:, tap * cin + c, None] * taps[tap, c][None, :]
    return acc.to(cd) + b.to(cd)[:, None]


def stem_wgrad_plain(dy, x_cs, *, h: int, w_img: int):
    """Plain version of ``stem_wgrad``: (dW [Cout, 9*Cin], db [Cout]) in
    f32, summed per stem tile and then across the tiles in order, as the
    reference."""
    cout, n = dy.shape
    cin = x_cs.shape[0]
    tile = stem_lane_tile(h, w_img, n, cout)
    patches = _taps(x_cs, h, w_img).reshape(9 * cin, n)
    gf = dy.to(_F32)
    dw = db = None
    for t in range(n // tile):
        lanes = slice(t * tile, (t + 1) * tile)
        pw = gf[:, lanes] @ patches[:, lanes].T
        pb = gf[:, lanes].sum(dim=1)
        dw, db = (pw, pb) if dw is None else (dw + pw, db + pb)
    return dw, db


_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from pytorch_ddp_resnet_tpu_torch.ops.cuda import build

        lib = build.load("stem")
        lib.stem_fwd_launch.argtypes = [_P] * 4 + [_I] * 5 + [_P]
        lib.stem_wgrad_launch.argtypes = [_P] * 3 + [_I] * 6 + [_P]
        lib.stem_wgrad_sum_launch.argtypes = [_P, _P, _I, _I, _P]
        for fn in (lib.stem_fwd_launch, lib.stem_wgrad_launch,
                   lib.stem_wgrad_sum_launch):
            fn.restype = _I
        _lib = lib
    return _lib


def _check(x_cs, h: int, w_img: int) -> None:
    cin, n = x_cs.shape
    if not 1 <= cin <= CIN_MAX:
        raise ValueError(f"stem kernel expects 1 <= Cin <= {CIN_MAX}, got "
                         f"{cin}")
    if n % (h * w_img):
        raise ValueError(f"N={n} is not a multiple of H*W={h * w_img}")


def stem_fwd(x_cs, w_packed, b, *, h: int, w_img: int) -> torch.Tensor:
    """x [Cin, N], w_packed [Cout, 9*Cin] in x's dtype, b [Cout] f32 ->
    y [Cout, N] in x's dtype (bf16 only on the card)."""
    _check(x_cs, h, w_img)
    if on_cpu(x_cs):
        return stem_fwd_plain(x_cs, w_packed, b, h=h, w_img=w_img)
    name = "stem_fwd"
    cin, n = x_cs.shape
    cout = w_packed.shape[0]
    b = b.to(_F32).contiguous()
    require_cuda(name, [x_cs, w_packed, b],
                 [torch.bfloat16, torch.bfloat16, _F32])
    y = torch.empty((cout, n), dtype=torch.bfloat16, device=x_cs.device)
    check_rc(name, _library().stem_fwd_launch(
        x_cs.data_ptr(), w_packed.data_ptr(), b.data_ptr(), y.data_ptr(),
        cin, cout, n, h, w_img,
        torch.cuda.current_stream(x_cs.device).cuda_stream))
    launches[name] += 1
    return y


def stem_wgrad(dy, x_cs, *, h: int, w_img: int):
    """(dW [Cout, 9*Cin], db [Cout]) f32 from dy [Cout, N], x [Cin, N]."""
    _check(x_cs, h, w_img)
    if on_cpu(dy):
        return stem_wgrad_plain(dy, x_cs, h=h, w_img=w_img)
    name = "stem_wgrad"
    cout, n = dy.shape
    cin = x_cs.shape[0]
    plan = stem_wgrad_plan(n, cout, h, w_img)
    require_cuda(name, [dy, x_cs], [torch.bfloat16, torch.bfloat16])
    k = 9 * cin + 1
    part = torch.empty((plan.blocks, cout * k), dtype=_F32, device=dy.device)
    out = torch.empty(cout * k, dtype=_F32, device=dy.device)
    lib = _library()
    stream = torch.cuda.current_stream(dy.device).cuda_stream
    check_rc(name, lib.stem_wgrad_launch(
        dy.data_ptr(), x_cs.data_ptr(), part.data_ptr(), cin, cout, n, h,
        w_img, plan.per, stream))
    launches[name] += 1
    check_rc(f"{name}.sum", lib.stem_wgrad_sum_launch(
        part.data_ptr(), out.data_ptr(), plan.blocks, cout * k, stream))
    launches[f"{name}.sum"] += 1
    out = out.reshape(cout, k)
    return out[:, :-1], out[:, -1]


class _StemConvLane(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_cs, w, b, h, w_img):
        ctx.save_for_backward(x_cs)
        ctx.cfg = (h, w_img, w.dtype, b.dtype, tuple(w.shape))
        w_packed = pack_weights(w.detach().to(x_cs.dtype))
        return stem_fwd(x_cs, w_packed, b.detach(), h=h, w_img=w_img)

    @staticmethod
    def backward(ctx, dy):
        (x_cs,) = ctx.saved_tensors
        h, w_img, w_dtype, b_dtype, (cout, cin, _, _) = ctx.cfg
        dw, db = stem_wgrad(dy.contiguous(), x_cs, h=h, w_img=w_img)
        dw = dw.reshape(cout, 3, 3, cin).permute(0, 3, 1, 2)
        return None, dw.to(w_dtype), db.to(b_dtype), None, None


def stem_conv_lane(x_cs: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                   h: int, w_img: int) -> torch.Tensor:
    """Differentiable lane-layout stem conv: x [Cin, N] in the compute
    dtype, w [Cout, Cin, 3, 3] (OIHW), b [Cout] -> [Cout, N]."""
    return _StemConvLane.apply(x_cs, w, b, h, w_img)
