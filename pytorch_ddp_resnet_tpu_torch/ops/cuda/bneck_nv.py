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

The plain versions compute every int8 product sum exactly in float64 and
round where the reference rounds (nv_common.py).
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


# --- kernels -------------------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None


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
        for fn in (lib.bneck_conv1_launch, lib.bneck_conv2_launch,
                   lib.bneck_out_launch):
            fn.restype = _I
        _lib = lib
    return _lib


def _launch(name, x, w1q, w2q, w3q, wpq, p1, q1, p2, q2, p3, q3, res,
            stride, out_int8):
    n, h, w, cin, wdt, cout = _check(x, w1q, w2q, w3q, wpq, stride)
    for c in (cin, wdt, cout):
        if c % 32:
            raise ValueError(f"{name}: channels {cin}/{wdt}/{cout} are not "
                             f"all multiples of 32")
    vecs = [v.to(f32).contiguous() for v in (p1, q1, p2, q2, p3, q3)]
    tensors = [x, w1q, w2q, w3q] + vecs
    dtypes = [torch.int8] * 4 + [f32] * 6
    if wpq is not None:
        res = res.to(f32).contiguous()
        tensors += [wpq, res]
        dtypes += [torch.int8, f32]
    require_cuda(name, tensors, dtypes)
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
    proj = wpq is not None
    check_rc(name, lib.bneck_out_launch(
        a2.data_ptr(), w3q.data_ptr(), p3.data_ptr(), q3.data_ptr(),
        x.data_ptr(), wpq.data_ptr() if proj else None,
        res.data_ptr() if proj else None, 0.0 if proj else float(res),
        out.data_ptr(), n, h, w, cin, wdt, cout, stride, int(out_int8),
        stream))
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
    return _launch("bneck_block_nv", x, w1q, w2q, w3q, None, p1, q1, p2, q2,
                   p3, q3, float(r), 1, out_int8)


def bneck_transition_nv(x, w1q, w2q, w3q, wpq, p1, q1, p2, q2, p3, q3, pp,
                        *, stride: int = 2, out_int8: bool = True):
    """One shortcut-transforming post-act bottleneck block: conv2 at
    ``stride``, the projection wp [Cout, Cin] on x[:, ::s, ::s] with its
    dequant pp [Cout]. Returns [N, oh, ow, Cout], oh = (h-1)//s + 1."""
    if on_cpu(x):
        return bneck_transition_nv_plain(x, w1q, w2q, w3q, wpq, p1, q1, p2,
                                         q2, p3, q3, pp, stride=stride,
                                         out_int8=out_int8)
    return _launch("bneck_transition_nv", x, w1q, w2q, w3q, wpq, p1, q1, p2,
                   q2, p3, q3, pp, stride, out_int8)
