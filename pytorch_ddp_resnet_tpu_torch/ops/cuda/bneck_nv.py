"""Int8 post-act bottleneck blocks for serving (counterpart of
``pytorch_ddp_resnet_tpu/ops/pallas/bneck_nv.py``).

- ``bneck_block_nv``: an identity block. Replaces ``bneck_block_nv``
  (``_nv_kernel``).
- ``bneck_transition_nv``: a transition block, conv2 at stride 1 or 2 and
  a 1x1 projection on the subsampled input. Replaces
  ``bneck_transition_nv`` (``_nv_transition_kernel``).

Both take the port's int8 NHWC carrier x [N, h, w, Cin] (the JAX kernels
take the TPU's [h, wp, N, C] NV layout) and the folded f32 vectors of
ops/cuda/nv_common.py, and compute

    a1  = requant(x . w1^T, p1, q1)                      every position
    a2  = requant(conv3x3(a1, w2, stride, padding 1), p2, q2)
    y   = acc3 * p3 + q3,  acc3 = a2 . w3^T
    out = relu(x*r + y)                                  identity
        = relu(accP*pp + y),  accP = x[:, ::s, ::s] . wp^T  transition

as int8 (``clip(round(out))``, the next block's carrier) or bf16 (the run's
exit). Weights are int8 with the contraction innermost: w1 [W, Cin], w2
[W, 9*W] (taps row-major in (dy, dx), then input channel), w3 [Cout, W],
wp [Cout, Cin]; ``pack_bneck_weights`` makes them from OIHW.

Each wrapper dispatches on the device of x: a CPU tensor goes to the plain
PyTorch version beside it; a CUDA tensor launches the three kernels of
``csrc/bneck_nv.cu`` (conv1, conv2, and conv3 with the block's output) or
raises. ``launches`` counts ``<name>.conv1``, ``<name>.conv2`` and
``<name>`` (the output launch) where each kernel launches, and
``launch_shapes`` each wrapper call by (name, N, h, w, Cin, W, Cout,
stride, out_int8); plain calls count nothing.

The identity block's three kernels run on the TMA-fed s8 wgmma mainloop
of ``csrc/fwd_wgmma_s8.cuh``: conv1 writes a1 straight into the padded
slab of ``serve_slab_layout`` (every pad byte too, zero), conv2 walks its
nine taps as nine slab row offsets, and the output reads a2 and x in
16-byte vectors (``identity_plan``: the slab, the N tiles, the grids; the
maps of all three launches are encoded before the first). The transition
block still runs the first design's ``mma.sync`` template.

The plain versions compute every int8 product sum exactly in float64 and
round where the reference rounds (nv_common.py).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from pytorch_ddp_resnet_tpu_torch.ops.cuda.bneck_nv_train import (
    FWD_BM,
    FwdInt8Layout,
    _place,
    fwd_int8_layout,
)
from pytorch_ddp_resnet_tpu_torch.ops.cuda.checks import (
    check_rc,
    on_cpu,
    require_cuda,
)
from pytorch_ddp_resnet_tpu_torch.ops.cuda.conv3x3 import quant_s8
from pytorch_ddp_resnet_tpu_torch.ops.cuda.nv_common import (
    fma_f32,
    out_geometry,
    requant,
)

launches: collections.Counter = collections.Counter()
launch_shapes: collections.Counter = collections.Counter()

f32 = torch.float32
f64 = torch.float64
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    launches.clear()
    launch_shapes.clear()


def pack_bneck_weights(w_oihw: torch.Tensor) -> torch.Tensor:
    """OIHW int8 -> [O, K*K*I] with the contraction innermost (taps
    row-major in (dy, dx), then input channel), contiguous."""
    o = w_oihw.shape[0]
    return w_oihw.permute(0, 2, 3, 1).reshape(o, -1).contiguous()


def _check(x, w1q, w2q, w3q, wpq, stride):
    n, h, w, cin = x.shape
    wdt = w1q.shape[0]
    cout = w3q.shape[0]
    if tuple(w1q.shape) != (wdt, cin) or tuple(w2q.shape) != (wdt, 9 * wdt):
        raise ValueError(f"weights w1 {tuple(w1q.shape)}, w2 "
                         f"{tuple(w2q.shape)} do not fit Cin={cin}")
    if tuple(w3q.shape) != (cout, wdt):
        raise ValueError(f"w3 {tuple(w3q.shape)} vs width {wdt}")
    if wpq is None:
        if cout != cin or stride != 1:
            raise ValueError("identity block needs Cout == Cin, stride 1")
    elif tuple(wpq.shape) != (cout, cin):
        raise ValueError(f"projection {tuple(wpq.shape)} != ({cout}, {cin})")
    if stride not in (1, 2):
        raise ValueError(f"stride={stride} not supported")
    return n, h, w, cin, wdt, cout


# --- plain versions ----------------------------------------------------------

def _plain(x, w1q, w2q, w3q, wpq, p1, q1, p2, q2, p3, q3, res, stride,
           out_int8):
    n, h, w, cin, wdt, cout = _check(x, w1q, w2q, w3q, wpq, stride)
    xd = x.to(f64)
    a1 = requant(xd @ w1q.to(f64).T, p1, q1)
    k = w2q.to(f64).reshape(wdt, 3, 3, wdt).permute(0, 3, 1, 2)
    acc2 = F.conv2d(a1.to(f64).permute(0, 3, 1, 2), k, stride=stride,
                    padding=1).permute(0, 2, 3, 1)
    a2 = requant(acc2, p2, q2)
    y = fma_f32((a2.to(f64) @ w3q.to(f64).T).to(f32), p3, q3)
    if wpq is None:
        o = fma_f32(x.to(f32), res, y)
    else:
        accp = xd[:, ::stride, ::stride] @ wpq.to(f64).T
        o = fma_f32(accp.to(f32), res, y)
    o = torch.clamp_min(o, 0.0)
    return quant_s8(o) if out_int8 else o.to(torch.bfloat16)


def bneck_block_nv_plain(x, w1q, w2q, w3q, p1, q1, p2, q2, p3, q3, r, *,
                         out_int8: bool = True):
    """Plain version of ``bneck_block_nv``."""
    return _plain(x, w1q, w2q, w3q, None, p1, q1, p2, q2, p3, q3, float(r),
                  1, out_int8)


def bneck_transition_nv_plain(x, w1q, w2q, w3q, wpq, p1, q1, p2, q2, p3, q3,
                              pp, *, stride: int = 2, out_int8: bool = True):
    """Plain version of ``bneck_transition_nv``."""
    return _plain(x, w1q, w2q, w3q, wpq, p1, q1, p2, q2, p3, q3, pp, stride,
                  out_int8)


# --- the identity block's slab and plan ---------------------------------------

BM = FWD_BM  # M rows a tile (csrc/fwd_wgmma_s8.cuh BM)
_I32 = 2 ** 31


def serve_slab_layout(n: int, h: int, w: int, wdt: int) -> FwdInt8Layout:
    """Where conv1 writes a1 [n, h, w, wdt] and conv2 reads it: the NV
    halves' 3x3 slab (``bneck_nv_train.fwd_int8_layout``) at one chunk of
    h rows, cp = wdt bytes a position (unpadded). Position (y, x) of image
    i lies at row ``guard + ((y + 1)*wq + x)*n + i``: images innermost, a
    zero column after each row (wq = w + 1), a zero halo row above and
    below the image, ``guard`` = n zero rows at each end and zeros
    trailing to whole tiles, so that conv2's M row m = (r*wq + c)*n + i
    (``m_valid`` = h*wq*n rows in ``tiles`` tiles of ``bm``) reads tap
    (dy, dx) at row m + ``shifts[3*dy + dx]``: one offset for every row,
    image and border, every box inside the slab. Rows with column w and
    the tail are computed and thrown away."""
    return fwd_int8_layout(n, h, w, wdt, 9, h, pad=False)


def serve_tile(c: int) -> int:
    """The N tile of a GEMM whose N extent is c: 64 up to 64 channels,
    else 128 (a masked ragged last tile)."""
    return 64 if c <= 64 else 128


class IdentityPlan(NamedTuple):
    """The identity block's three launches: the slab, the N tiles of conv1
    (W), conv2 (W) and the output (Cout), and each launch's blocks (a
    one-dimensional grid, the N tiles of one M tile neighbours): conv1 and
    the output on ceil(n*h*w / 128) M tiles of NHWC rows, conv2 on the
    slab's ``tiles``."""
    lay: FwdInt8Layout
    m: int
    bn1: int
    bn2: int
    bn3: int
    blocks: tuple


@functools.lru_cache(maxsize=None)
def identity_plan(n: int, h: int, w: int, cin: int, wdt: int,
                  cout: int) -> IdentityPlan:
    """The plan of ``bneck_block_nv`` on the card (see ``IdentityPlan``).
    Raises where the slab's rows, the NHWC rows or the grid's blocks would
    pass 32-bit indices. Cached."""
    lay = serve_slab_layout(n, h, w, wdt)
    m = n * h * w
    bn1, bn2, bn3 = serve_tile(wdt), serve_tile(wdt), serve_tile(cout)
    mt = -(-m // BM)
    blocks = (mt * -(-wdt // bn1), lay.tiles * -(-wdt // bn2),
              mt * -(-cout // bn3))
    if lay.slab_len >= _I32 or m >= _I32 or max(blocks) >= _I32:
        raise ValueError(f"bneck_block_nv: N={n} at {h}x{w}, W={wdt}: "
                         f"{lay.slab_len} slab rows or {max(blocks)} "
                         "blocks exceed 32-bit indices")
    return IdentityPlan(lay, m, bn1, bn2, bn3, blocks)


def serve_slab_plain(a1: torch.Tensor, lay: FwdInt8Layout) -> torch.Tensor:
    """a1 [n, h, w, W] int8 laid out as the slab [slab_len, W] of ``lay``
    by the NV slab's placement (``bneck_nv_train._place``): each position
    at its row, zeros at the pad column, the halo rows, the guards and the
    tail."""
    return _place(F.pad(a1, (0, 0, 0, 0, 1, 1))[None], lay)[0]


def identity_slab_plain(x, w1q, p1, q1, lay: FwdInt8Layout):
    """The slab conv1 writes: requant(x . w1^T, p1, q1) placed by
    ``serve_slab_plain``."""
    a1 = requant(x.to(f64) @ w1q.to(f64).T, p1, q1)
    return serve_slab_plain(a1, lay)


# --- kernels -------------------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None
# called on the identity block's freshly allocated slab before conv1 (a
# test fills it with nonzero bytes to show that conv1 writes every pad)
_slab_hook: Optional[Callable[[torch.Tensor], None]] = None
_PLAN_BYTES: Optional[int] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from pytorch_ddp_resnet_tpu_torch.ops.cuda import build

        lib = build.load("bneck_nv")
        lib.bneck_conv1_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I,
                                           _P]
        lib.bneck_conv2_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I,
                                           _I, _I, _P]
        lib.bneck_out_launch.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, ctypes.c_float, _P, _I, _I, _I, _I,
            _I, _I, _I, _I, _P]
        lib.bneck_id_plan.argtypes = [_P] * 7 + [_I] * 9
        lib.bneck_id_conv1_launch.argtypes = [_P, _P, _P, _P] + [_I] * 6 \
            + [_P]
        lib.bneck_id_conv2_launch.argtypes = [_P, _P, _P, _P] + [_I] * 5 \
            + [_P]
        lib.bneck_id_out_launch.argtypes = [
            _P, _P, _P, _P, ctypes.c_float, _P, _I, _I, _I, _I, _I, _P]
        lib.bneck_id_plan_bytes.argtypes = []
        for fn in (lib.bneck_conv1_launch, lib.bneck_conv2_launch,
                   lib.bneck_out_launch, lib.bneck_id_plan,
                   lib.bneck_id_conv1_launch, lib.bneck_id_conv2_launch,
                   lib.bneck_id_out_launch, lib.bneck_id_plan_bytes):
            fn.restype = _I
        _lib = lib
    return _lib


def _check_channels(name, cin, wdt, cout):
    for c in (cin, wdt, cout):
        if c % 32:
            raise ValueError(f"{name}: channels {cin}/{wdt}/{cout} are not "
                             f"all multiples of 32")


def _identity_launches(x, w1q, w2q, w3q, p1, q1, p2, q2, p3, q3, r,
                       out_int8):
    """((conv1, conv2, out), out tensor): the identity block's three
    launches on the card as closures to run in order, after the plan, the
    operand checks and all three launches' maps; each counts itself where
    it launches."""
    global _PLAN_BYTES
    name = "bneck_block_nv"
    n, h, w, cin, wdt, cout = _check(x, w1q, w2q, w3q, None, 1)
    _check_channels(name, cin, wdt, cout)
    vecs = [v.to(f32).contiguous() for v in (p1, q1, p2, q2, p3, q3)]
    if [tuple(v.shape) for v in vecs] != [(wdt,)] * 4 + [(cout,)] * 2:
        raise ValueError(f"{name}: vectors {[tuple(v.shape) for v in vecs]}"
                         f" vs W={wdt}, Cout={cout}")
    require_cuda(name, [x, w1q, w2q, w3q] + vecs,
                 [torch.int8] * 4 + [f32] * 6)
    p1, q1, p2, q2, p3, q3 = vecs
    plan = identity_plan(n, h, w, cin, wdt, cout)
    lay = plan.lay
    dev = x.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _library()
    slab = torch.empty((lay.slab_len, wdt), dtype=torch.int8, device=dev)
    if _slab_hook is not None:
        _slab_hook(slab)
    a2 = torch.empty((n, h, w, wdt), dtype=torch.int8, device=dev)
    out = torch.empty((n, h, w, cout), device=dev,
                      dtype=torch.int8 if out_int8 else torch.bfloat16)
    if _PLAN_BYTES is None:
        _PLAN_BYTES = lib.bneck_id_plan_bytes()
    maps = ctypes.create_string_buffer(_PLAN_BYTES)   # host memory
    check_rc(name, lib.bneck_id_plan(
        maps, x.data_ptr(), w1q.data_ptr(), slab.data_ptr(), w2q.data_ptr(),
        a2.data_ptr(), w3q.data_ptr(), n, h, w, cin, wdt, cout, plan.bn1,
        plan.bn2, plan.bn3))

    def conv1():
        check_rc(name, lib.bneck_id_conv1_launch(
            maps, p1.data_ptr(), q1.data_ptr(), slab.data_ptr(), n, h, w, cin,
            wdt, plan.bn1, stream))
        launches[f"{name}.conv1"] += 1

    def conv2():
        check_rc(name, lib.bneck_id_conv2_launch(
            maps, p2.data_ptr(), q2.data_ptr(), a2.data_ptr(), n, h, w, wdt,
            plan.bn2, stream))
        launches[f"{name}.conv2"] += 1

    def conv3():
        check_rc(name, lib.bneck_id_out_launch(
            maps, p3.data_ptr(), q3.data_ptr(), x.data_ptr(), float(r),
            out.data_ptr(), plan.m, wdt, cout, int(out_int8), plan.bn3,
            stream))
        launches[name] += 1
        launch_shapes[(name, n, h, w, cin, wdt, cout, 1, out_int8)] += 1

    return (conv1, conv2, conv3), out


def _launch_transition(x, w1q, w2q, w3q, wpq, p1, q1, p2, q2, p3, q3, pp,
                       stride, out_int8):
    """The transition block's three launches on the first design."""
    name = "bneck_transition_nv"
    n, h, w, cin, wdt, cout = _check(x, w1q, w2q, w3q, wpq, stride)
    _check_channels(name, cin, wdt, cout)
    vecs = [v.to(f32).contiguous() for v in (p1, q1, p2, q2, p3, q3)]
    pp = pp.to(f32).contiguous()
    require_cuda(name, [x, w1q, w2q, w3q] + vecs + [wpq, pp],
                 [torch.int8] * 4 + [f32] * 6 + [torch.int8, f32])
    p1, q1, p2, q2, p3, q3 = vecs
    oh, ow = out_geometry(h, w, stride)
    dev = x.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _library()
    a1 = torch.empty((n, h, w, wdt), dtype=torch.int8, device=dev)
    check_rc(name, lib.bneck_conv1_launch(
        x.data_ptr(), w1q.data_ptr(), p1.data_ptr(), q1.data_ptr(),
        a1.data_ptr(), n * h * w, cin, wdt, stream))
    launches[f"{name}.conv1"] += 1
    a2 = torch.empty((n, oh, ow, wdt), dtype=torch.int8, device=dev)
    check_rc(name, lib.bneck_conv2_launch(
        a1.data_ptr(), w2q.data_ptr(), p2.data_ptr(), q2.data_ptr(),
        a2.data_ptr(), n, h, w, wdt, stride, stream))
    launches[f"{name}.conv2"] += 1
    out = torch.empty((n, oh, ow, cout), device=dev,
                      dtype=torch.int8 if out_int8 else torch.bfloat16)
    check_rc(name, lib.bneck_out_launch(
        a2.data_ptr(), w3q.data_ptr(), p3.data_ptr(), q3.data_ptr(),
        x.data_ptr(), wpq.data_ptr(), pp.data_ptr(), 0.0, out.data_ptr(),
        n, h, w, cin, wdt, cout, stride, int(out_int8), stream))
    launches[name] += 1
    launch_shapes[(name, n, h, w, cin, wdt, cout, stride, out_int8)] += 1
    return out


def bneck_block_nv(x, w1q, w2q, w3q, p1, q1, p2, q2, p3, q3, r, *,
                   out_int8: bool = True):
    """One identity-shortcut post-act bottleneck block on the int8 carrier
    x [N, h, w, C]; r a Python float. Returns [N, h, w, C] int8
    (``out_int8``) or bf16. On the card every channel count is a
    multiple of 32."""
    if on_cpu(x):
        return bneck_block_nv_plain(x, w1q, w2q, w3q, p1, q1, p2, q2, p3,
                                    q3, r, out_int8=out_int8)
    parts, out = _identity_launches(x, w1q, w2q, w3q, p1, q1, p2, q2, p3,
                                    q3, float(r), out_int8)
    for launch in parts:
        launch()
    return out


def bneck_transition_nv(x, w1q, w2q, w3q, wpq, p1, q1, p2, q2, p3, q3, pp,
                        *, stride: int = 2, out_int8: bool = True):
    """One shortcut-transforming post-act bottleneck block: conv2 at
    ``stride``, the projection wp [Cout, Cin] on x[:, ::s, ::s] with its
    dequant pp [Cout]. Returns [N, oh, ow, Cout], oh = (h-1)//s + 1."""
    if on_cpu(x):
        return bneck_transition_nv_plain(x, w1q, w2q, w3q, wpq, p1, q1, p2,
                                         q2, p3, q3, pp, stride=stride,
                                         out_int8=out_int8)
    return _launch_transition(x, w1q, w2q, w3q, wpq, p1, q1, p2, q2, p3, q3,
                              pp, stride, out_int8)
