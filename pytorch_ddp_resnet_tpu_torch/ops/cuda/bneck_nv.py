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

Both blocks' kernels run on the TMA-fed s8 wgmma mainloop of
``csrc/fwd_wgmma_s8.cuh``: conv1 writes a1 straight into the padded slab
of ``serve_slab_layout`` (every pad byte too, zero), conv2 walks its nine
taps as nine slab row offsets, and the output reads a2 and x in 16-byte
vectors (``identity_plan`` and ``transition_plan``: the slab, the N tiles,
the grids; the maps of all three launches are encoded before the first).
At stride 2 the transition's slab is four parity planes, each the slab of
``serve_slab_layout`` at the output size, so that every tap of conv2 is
one row offset into one plane, and conv1 also copies x[:, ::2, ::2] for
the projection; its output launch runs conv3 and the projection as two
mainloops of one kernel.

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


# --- the blocks' slabs and plans ----------------------------------------------

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


class BlockPlan(NamedTuple):
    """A block's three launches on the card: a1's slab (``planes`` slabs
    of layout ``lay`` one after another: one at stride 1, four parity
    planes at stride 2), conv2's nine slab rows for M row 0 (``shifts``),
    the N tiles of conv1 (W), conv2 (W) and the output (Cout), and each
    launch's blocks (a one-dimensional grid, the N tiles of one M tile
    neighbours): conv1 on ceil(m / 128) M tiles of x's NHWC rows, conv2 on
    the layout's ``tiles``, the output on ceil(m_out / 128)."""
    lay: FwdInt8Layout
    m: int
    bn1: int
    bn2: int
    bn3: int
    blocks: tuple
    planes: int
    shifts: tuple
    m_out: int

    @property
    def slab_rows(self) -> int:
        return self.planes * self.lay.slab_len


def _block_plan(name, n, h, w, cin, wdt, cout, stride, bn3) -> BlockPlan:
    """The plan of a block of input [n, h, w, cin] at ``stride``. At
    stride 2 the slab is four planes of ``serve_slab_layout(n, oh, ow,
    W)``: plane p = 2*py + px holds a1 at input position (2r + py, 2c +
    px) at its position (r, c), zero where that lies past an odd h or w;
    tap (dy, dx) reads plane 2*[dy != 1] + [dx != 1] at row m + p*slab_len
    + guard + ([dy != 0]*wq - [dx == 0])*n. Raises where the slab's rows,
    the NHWC rows or the grid's blocks would pass 32-bit indices."""
    oh, ow = out_geometry(h, w, stride)
    lay = serve_slab_layout(n, oh, ow, wdt)
    if stride == 1:
        planes, shifts = 1, lay.shifts
    else:
        planes = 4
        shifts = tuple(
            (2 * (dy != 1) + (dx != 1)) * lay.slab_len + lay.guard
            + ((dy != 0) * lay.wq - (dx == 0)) * n
            for dy in range(3) for dx in range(3))
    m, m_out = n * h * w, n * oh * ow
    bn1 = bn2 = serve_tile(wdt)
    blocks = (-(-m // BM) * -(-wdt // bn1), lay.tiles * -(-wdt // bn2),
              -(-m_out // BM) * -(-cout // bn3))
    rows = planes * lay.slab_len
    if rows >= _I32 or m >= _I32 or max(blocks) >= _I32:
        raise ValueError(f"{name}: N={n} at {h}x{w}, W={wdt}: {rows} slab "
                         f"rows or {max(blocks)} blocks exceed 32-bit "
                         "indices")
    return BlockPlan(lay, m, bn1, bn2, bn3, blocks, planes, shifts, m_out)


@functools.lru_cache(maxsize=None)
def identity_plan(n: int, h: int, w: int, cin: int, wdt: int,
                  cout: int) -> BlockPlan:
    """The plan of ``bneck_block_nv`` on the card (see ``BlockPlan``): one
    slab, the output's N tile 64 up to 64 channels, else 128. Cached."""
    return _block_plan("bneck_block_nv", n, h, w, cin, wdt, cout, 1,
                       serve_tile(cout))


@functools.lru_cache(maxsize=None)
def transition_plan(n: int, h: int, w: int, cin: int, wdt: int, cout: int,
                    stride: int) -> BlockPlan:
    """The plan of ``bneck_transition_nv`` on the card (see ``BlockPlan``
    and ``_block_plan``): the identity's at stride 1, four parity planes at
    stride 2; the output's N tile 64 (two accumulators in registers).
    Cached."""
    return _block_plan("bneck_transition_nv", n, h, w, cin, wdt, cout,
                       stride, 64)


def serve_slab_plain(a1: torch.Tensor, lay: FwdInt8Layout) -> torch.Tensor:
    """a1 [n, h, w, W] int8 laid out as the slab [slab_len, W] of ``lay``
    by the NV slab's placement (``bneck_nv_train._place``): each position
    at its row, zeros at the pad column, the halo rows, the guards and the
    tail."""
    return _place(F.pad(a1, (0, 0, 0, 0, 1, 1))[None], lay)[0]


def block_slab_plain(a1: torch.Tensor, plan: BlockPlan) -> torch.Tensor:
    """a1 [n, h, w, W] laid out as the plan's slab [slab_rows, W]: the one
    slab, or the four parity planes (a1[:, py::2, px::2], zero past an odd
    h or w, each placed by ``serve_slab_plain``) one after another."""
    if plan.planes == 1:
        return serve_slab_plain(a1, plan.lay)
    oh, ow = plan.lay.h, plan.lay.w
    out = []
    for py in (0, 1):
        for px in (0, 1):
            q = a1[:, py::2, px::2]
            q = F.pad(q, (0, 0, 0, ow - q.shape[2], 0, oh - q.shape[1]))
            out.append(serve_slab_plain(q, plan.lay))
    return torch.cat(out)


def identity_slab_plain(x, w1q, p1, q1, lay: FwdInt8Layout):
    """The slab conv1 writes: requant(x . w1^T, p1, q1) placed by
    ``serve_slab_plain``."""
    a1 = requant(x.to(f64) @ w1q.to(f64).T, p1, q1)
    return serve_slab_plain(a1, lay)


def transition_slab_plain(x, w1q, p1, q1, plan: BlockPlan):
    """The slab (stride 1) or planes (stride 2) conv1 writes:
    requant(x . w1^T, p1, q1) placed by ``block_slab_plain``."""
    a1 = requant(x.to(f64) @ w1q.to(f64).T, p1, q1)
    return block_slab_plain(a1, plan)


# --- kernels -------------------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None
# called on a block's freshly allocated slab before conv1 (a test fills it
# with nonzero bytes to show that conv1 writes every pad)
_slab_hook: Optional[Callable[[torch.Tensor], None]] = None
_PLAN_BYTES: Optional[int] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from pytorch_ddp_resnet_tpu_torch.ops.cuda import build

        lib = build.load("bneck_nv")
        lib.bneck_block_plan_bytes.argtypes = []
        lib.bneck_block_plan.argtypes = [_P] * 9 + [_I] * 10
        lib.bneck_block_conv1_launch.argtypes = [_P] * 6 + [_I] * 7 + [_P]
        lib.bneck_block_conv2_launch.argtypes = [_P] * 4 + [_I] * 6 + [_P]
        lib.bneck_id_out_launch.argtypes = [
            _P, _P, _P, _P, ctypes.c_float, _P, _I, _I, _I, _I, _I, _P]
        lib.bneck_tr_out_launch.argtypes = [_P] * 5 + [_I] * 6 + [_P]
        for fn in (lib.bneck_block_plan_bytes, lib.bneck_block_plan,
                   lib.bneck_block_conv1_launch, lib.bneck_block_conv2_launch,
                   lib.bneck_id_out_launch, lib.bneck_tr_out_launch):
            fn.restype = _I
        _lib = lib
    return _lib


def _check_channels(name, cin, wdt, cout):
    for c in (cin, wdt, cout):
        if c % 32:
            raise ValueError(f"{name}: channels {cin}/{wdt}/{cout} are not "
                             f"all multiples of 32")


def _block_launches(name, x, w1q, w2q, w3q, wpq, vecs, res, stride,
                    out_int8):
    """((conv1, conv2, out), out tensor): a block's three launches on the
    card as closures to run in order, after the plan, the operand checks
    and all the launches' maps; each counts itself where it launches.
    ``wpq`` None: the identity block (``res`` the Python float r), else
    the transition (``res`` the projection's dequant pp)."""
    global _PLAN_BYTES
    n, h, w, cin, wdt, cout = _check(x, w1q, w2q, w3q, wpq, stride)
    _check_channels(name, cin, wdt, cout)
    vecs = [v.to(f32).contiguous() for v in vecs]
    if [tuple(v.shape) for v in vecs] != [(wdt,)] * 4 + [(cout,)] * 2:
        raise ValueError(f"{name}: vectors {[tuple(v.shape) for v in vecs]}"
                         f" vs W={wdt}, Cout={cout}")
    ops, kinds = [x, w1q, w2q, w3q] + vecs, [torch.int8] * 4 + [f32] * 6
    if wpq is not None:
        res = res.to(f32).contiguous()
        if tuple(res.shape) != (cout,):
            raise ValueError(f"{name}: vectors pp {tuple(res.shape)} vs "
                             f"Cout={cout}")
        ops, kinds = ops + [wpq, res], kinds + [torch.int8, f32]
    require_cuda(name, ops, kinds)
    p1, q1, p2, q2, p3, q3 = vecs
    plan = (identity_plan(n, h, w, cin, wdt, cout) if wpq is None
            else transition_plan(n, h, w, cin, wdt, cout, stride))
    oh, ow = plan.lay.h, plan.lay.w
    dev = x.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _library()
    slab = torch.empty((plan.slab_rows, wdt), dtype=torch.int8, device=dev)
    if _slab_hook is not None:
        _slab_hook(slab)
    a2 = torch.empty((n, oh, ow, wdt), dtype=torch.int8, device=dev)
    out = torch.empty((n, oh, ow, cout), device=dev,
                      dtype=torch.int8 if out_int8 else torch.bfloat16)
    if _PLAN_BYTES is None:
        _PLAN_BYTES = lib.bneck_block_plan_bytes()
    maps = ctypes.create_string_buffer(_PLAN_BYTES)   # host memory
    # the projection's input: x at stride 1, else x[:, ::2, ::2] as conv1
    # copies it
    xp = x if stride == 1 else torch.empty(
        (plan.m_out, cin), dtype=torch.int8, device=dev)
    check_rc(name, lib.bneck_block_plan(
        maps, x.data_ptr(), w1q.data_ptr(), slab.data_ptr(), w2q.data_ptr(),
        a2.data_ptr(), w3q.data_ptr(), xp.data_ptr(),
        None if wpq is None else wpq.data_ptr(), n, h, w, cin, wdt, cout,
        stride, plan.bn1, plan.bn2, plan.bn3))
    key = (name, n, h, w, cin, wdt, cout, stride, out_int8)

    def conv1():
        check_rc(name, lib.bneck_block_conv1_launch(
            maps, p1.data_ptr(), q1.data_ptr(), slab.data_ptr(), x.data_ptr(),
            xp.data_ptr(), n, h, w, cin, wdt, stride, plan.bn1, stream))

    def conv2():
        check_rc(name, lib.bneck_block_conv2_launch(
            maps, p2.data_ptr(), q2.data_ptr(), a2.data_ptr(), n, h, w, wdt,
            stride, plan.bn2, stream))

    def conv3():
        if wpq is None:
            rc = lib.bneck_id_out_launch(
                maps, p3.data_ptr(), q3.data_ptr(), x.data_ptr(), float(res),
                out.data_ptr(), plan.m, wdt, cout, int(out_int8), plan.bn3,
                stream)
        else:
            rc = lib.bneck_tr_out_launch(
                maps, p3.data_ptr(), q3.data_ptr(), res.data_ptr(),
                out.data_ptr(), plan.m_out, wdt, cin, cout, int(out_int8),
                plan.bn3, stream)
        check_rc(name, rc)

    def counted(launch, part):
        def run():
            launch()
            launches[name + part] += 1
            if not part:
                launch_shapes[key] += 1
        return run

    return (counted(conv1, ".conv1"), counted(conv2, ".conv2"),
            counted(conv3, "")), out


def _identity_launches(x, w1q, w2q, w3q, p1, q1, p2, q2, p3, q3, r,
                       out_int8):
    """The identity block's three launches (``_block_launches``)."""
    return _block_launches("bneck_block_nv", x, w1q, w2q, w3q, None,
                           (p1, q1, p2, q2, p3, q3), float(r), 1, out_int8)


def _transition_launches(x, w1q, w2q, w3q, wpq, p1, q1, p2, q2, p3, q3, pp,
                         stride, out_int8):
    """The transition block's three launches (``_block_launches``)."""
    return _block_launches("bneck_transition_nv", x, w1q, w2q, w3q, wpq,
                           (p1, q1, p2, q2, p3, q3), pp, stride, out_int8)


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
                                    q3, r, out_int8)
    for launch in parts:
        launch()
    return out


def bneck_transition_nv(x, w1q, w2q, w3q, wpq, p1, q1, p2, q2, p3, q3, pp,
                        *, stride: int = 2, out_int8: bool = True):
    """One shortcut-transforming post-act bottleneck block: conv2 at
    ``stride``, the projection wp [Cout, Cin] on x[:, ::s, ::s] with its
    dequant pp [Cout]. Returns [N, oh, ow, Cout], oh = (h-1)//s + 1. On
    the card every channel count is a multiple of 32."""
    if on_cpu(x):
        return bneck_transition_nv_plain(x, w1q, w2q, w3q, wpq, p1, q1, p2,
                                         q2, p3, q3, pp, stride=stride,
                                         out_int8=out_int8)
    parts, out = _transition_launches(x, w1q, w2q, w3q, wpq, p1, q1, p2, q2,
                                      p3, q3, pp, stride, out_int8)
    for launch in parts:
        launch()
    return out
