"""Time the port's int8 NV bottleneck blocks on the card: the identity
block (``bneck_nv.bneck_block_nv``) at ResNet-50's four identity shapes and
WRN-50-2's stage-4 block, and the transition block
(``bneck_transition_nv``) at ResNet-50's four transitions and WRN-50-2's
last (batch 128), each beside the same block in bf16 on cuDNN and its
bound, then summed over a ResNet-50 int8 serving batch.

    python tools/bench_nv_block_int8.py [--repo DIR] [--parts]

``--repo`` imports the port from another checkout (an unpacked parent
commit, to compare two versions in one call: run parent, change, change,
parent). The transition is what the checkout has: conv1 into the slab or
four parity planes, conv2 and the output (conv3 and the projection as two
mainloops of one kernel) on the TMA-fed s8 wgmma mainloop (``route``
"wgmma"), or, before it, three launches of the ``mma.sync`` template
(``route`` "mma_sync"). ``--parts`` also times each block's three launches
apart (``conv1``, ``conv2``, ``out``), each beside its bound (the larger
of its operations at the int8 peak and its bytes: x read, a1's n*h*w*W
codes and at stride 2 xs written by conv1, not the slab's pads; a1's codes
read and a2 written by conv2; a2 and x or xs read and the output written
by the output; weights once): the wgmma route's through the wrapper's own
launch closures, the first design's transition by the profiler's split of
its kernels' names (``KERNELS["mma_sync"]``) in one call of the block.
Every time is a CUDA-event mean of back-to-back calls (``ms``), the
kernels' summed device time per call (``dev_ms``, torch.profiler; a window
that lost a part's kernels is profiled again, and a time still missing is
null, as is every batch sum that needs it) and the host's time to issue
one call (``host_ms``: wall clock over 20 calls issued back to back, before
the card is waited for). Each block's int8 output is checked equal to its
plain version first.

The serving batch is ResNet-50's at batch 128: 2 / 3 / 5 / 2 identity
blocks at stages 1-4, the last of them emitting bf16 (the run's exit), and
4 transitions (``chip_smoke.py`` phase 9 asserts the same launches). Prints
one JSON line per (shape, output type), then one line with the times
summed over the batch and the card's name and power limit. Needs a CUDA
card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from bench_fused_fwd_int8 import host_ms
from bench_nv_fwd_int8 import INT8
from bench_nv_wgrad_bf16 import BW, REPO, time_ms

BATCH = 128
# (h, w, Cin, W, Cout, blocks a ResNet-50 serving batch: int8 out, bf16
# out); WRN-50-2's stage-4 block is timed, not summed
IDENTITY = [(56, 56, 256, 64, 256, 2, 0), (28, 28, 512, 128, 512, 3, 0),
            (14, 14, 1024, 256, 1024, 5, 0), (7, 7, 2048, 512, 2048, 1, 1),
            (7, 7, 2048, 1024, 2048, 0, 0)]
# (h, w, Cin, W, Cout, stride, blocks a batch)
TRANSITION = [(56, 56, 64, 64, 256, 1, 1), (56, 56, 256, 128, 512, 2, 1),
              (28, 28, 512, 256, 1024, 2, 1), (14, 14, 1024, 512, 2048, 2, 1),
              (14, 14, 1024, 1024, 2048, 2, 0)]


# the kernels each part launches, by block and route (their names in
# torch.profiler); the transition's conv1 is conv1_kernel at stride 1 and
# conv1_planes_kernel at stride 2
KERNELS = {"wgmma": {"conv1": "bneck_wgmma::conv1_kernel",
                     "conv2": "bneck_wgmma::conv2_kernel",
                     "out": "bneck_wgmma::out_kernel"},
           "transition": {"conv1": "bneck_wgmma::conv1",
                          "conv2": "bneck_wgmma::conv2_kernel",
                          "out": "bneck_wgmma::out_proj_kernel"},
           "mma_sync": {"conv1": "bneck_gemm_kernel<0, false, "
                                 "(anonymous namespace)::Requant>",
                        "conv2": "bneck_gemm_kernel<1, false",
                        "out": "BlockOut>"}}


def device_ms(fn, need=(), reps=10, tries=3):
    """The summed device time per call of the kernels ``fn`` launches
    (torch.profiler over ``reps`` calls after one warm-up call). The
    profiler can lose a kernel's events in a window, so a window with no
    device time, or fewer than ``reps`` launches of a kernel whose name
    holds a key of ``need`` (each call launches each once), is profiled
    again, up to ``tries`` windows; None if it still misses one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in evs)
        if us > 0 and all(sum(e.count for e in evs if key in e.key) >= reps
                          for key in need):
            return us / reps / 1e3
        print(f"device_ms: a profiler window missed {need or 'all'}",
              file=sys.stderr)
    return None


def split_ms(fn, keys, reps=10, tries=3):
    """{key: device ms per call} of the kernels ``fn`` launches, summed by
    the key their name holds (torch.profiler over ``reps`` calls after one
    warm-up call); a window that lost a key's kernels is profiled again, up
    to ``tries`` windows; None if it still misses one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = dict.fromkeys(keys, 0.0)
        for e in prof.key_averages():
            if e.device_type.name != "CUDA":
                continue
            for key in keys:
                if key in e.key:
                    out[key] += getattr(e, "self_device_time_total", getattr(
                        e, "self_cuda_time_total", 0.0)) / reps / 1e3
        if all(v > 0 for v in out.values()):
            return out
        print(f"split_ms: a profiler window missed {keys}", file=sys.stderr)
    return None


def _timed(row, key, fn, need=()):
    """row[key_ms], row[key_dev_ms], row[key_host_ms] (``ms``, ``dev_ms``,
    ``host_ms`` for key None); ``need``: the kernels ``fn`` launches
    every call (``device_ms``)."""
    pre = f"{key}_" if key else ""
    row[f"{pre}ms"] = time_ms(fn)
    row[f"{pre}dev_ms"] = device_ms(fn, need)
    row[f"{pre}host_ms"] = host_ms(fn)


def _bound(ops, byts):
    """(ms, "operations" or "bytes"): the larger of ops at the int8 peak
    and bytes at the memory rate."""
    o, b = ops / INT8 * 1e3, byts / BW * 1e3
    return (o, "operations") if o >= b else (b, "bytes")


def part_bounds(m, m_out, cin, wdt, cout, stride, out_int8):
    """{part_bound_ms, part_bound_by}: each of the transition's launches'
    own bound. a1 counts as its m*W codes, x as read once by conv1 and, for
    the output, as the m_out rows it reads (x at stride 1, xs at stride 2,
    which conv1 writes too); weights and the folded vectors once."""
    ob = 1 if out_int8 else 2
    xs = m_out * cin if stride == 2 else 0
    parts = dict(
        conv1=_bound(2 * m * cin * wdt,
                     m * cin + m * wdt + xs + wdt * cin + 8 * wdt),
        conv2=_bound(2 * m_out * 9 * wdt * wdt,
                     m * wdt + m_out * wdt + 9 * wdt * wdt + 8 * wdt),
        out=_bound(2 * m_out * cout * (wdt + cin),
                   m_out * wdt + m_out * cin + m_out * cout * ob + cout * wdt
                   + cout * cin + 12 * cout))
    out = {}
    for part, (ms, by) in parts.items():
        out[f"{part}_bound_ms"], out[f"{part}_bound_by"] = ms, by
    return out


def _operands(g, dev, cin, wdt, cout, proj):
    """Random int8 weights and folded vectors whose requants land across
    the int8 range (chip_smoke.py phase 8's)."""
    import torch

    def i8(*shape):
        return torch.randint(-127, 128, shape, device=dev, generator=g,
                             dtype=torch.int8)

    def vec(c, lo, hi):
        return torch.rand(c, device=dev, generator=g) * (hi - lo) + lo

    def sc(c, fan):
        return vec(c, 0.5, 1.5) * 40 / (fan ** 0.5 * 127 ** 2 / 3)

    ws = [i8(wdt, cin), i8(wdt, 9 * wdt), i8(cout, wdt)] + (
        [i8(cout, cin)] if proj else [])
    vecs = [sc(wdt, cin), vec(wdt, -2, 2), sc(wdt, 9 * wdt), vec(wdt, -2, 2),
            sc(cout, wdt), vec(cout, -2, 2)]
    res = sc(cout, cin) if proj else 0.37
    return ws, vecs, res


def _cudnn_block(g, dev, h, w, cin, wdt, cout, stride, proj):
    """The same block in bf16 on cuDNN, channels-last, the BatchNorm
    affines and relus in f32 (chip_smoke.py phase 8's yardstick)."""
    import torch
    import torch.nn.functional as F

    def cl(t):
        return t.to(memory_format=torch.channels_last)

    x4 = cl(torch.randn(BATCH, cin, h, w, device=dev, generator=g)
            .to(torch.bfloat16))
    w4 = [cl((torch.randn(o, i, k, k, device=dev, generator=g)
              * (i * k * k) ** -0.5).to(torch.bfloat16))
          for o, i, k in [(wdt, cin, 1), (wdt, wdt, 3), (cout, wdt, 1)]
          + ([(cout, cin, 1)] if proj else [])]
    aff = [(torch.rand(c, device=dev, generator=g) + 0.5).view(1, -1, 1, 1)
           for c in (wdt, wdt, wdt, wdt, cout, cout)]

    def conv(a, wt, s=1, p=0):
        return F.conv2d(a.to(torch.bfloat16), wt, stride=s,
                        padding=p).float()

    def block():
        xf = x4.float()
        a1 = torch.relu(conv(xf, w4[0]) * aff[0] + aff[1])
        a2 = torch.relu(conv(a1, w4[1], stride, 1) * aff[2] + aff[3])
        z3 = conv(a2, w4[2]) * aff[4] + aff[5]
        sc_ = xf if not proj else conv(xf[:, :, ::stride, ::stride], w4[3])
        return torch.relu(sc_ + z3).to(torch.bfloat16)

    return block


def _parts(nv, x, ws, vecs, res, out_int8, stride=None):
    """{part: a callable that launches that part alone}, on buffers the
    block's earlier parts have filled (the wrapper's launch closures; the
    transition's where ``stride`` is given)."""
    if stride is None:
        calls, _ = nv._identity_launches(x, *ws, *vecs, res, out_int8)
    else:
        calls, _ = nv._transition_launches(x, *ws, *vecs, res, stride,
                                           out_int8)
    for c in calls:
        c()
    return dict(zip(("conv1", "conv2", "out"), calls))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=None)
    ap.add_argument("--parts", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.repo or REPO))
    import torch

    if not torch.cuda.is_available():
        print("bench_nv_block_int8: no CUDA device", file=sys.stderr)
        return 1
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv as nv

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(29)
    route = "wgmma" if hasattr(nv, "transition_plan") else "mma_sync"
    batch = {}

    def add(row, count):
        """Each time of ``row`` times count into the batch's sums; a time
        not measured (None) leaves its sum None."""
        for key, v in row.items():
            if count and key.endswith("ms"):
                batch[key] = (None if v is None or batch.get(key, 0.0)
                              is None else batch.get(key, 0.0) + v * count)

    for h, w, cin, wdt, cout, n_int8, n_bf16 in IDENTITY:
        ws, vecs, r = _operands(g, dev, cin, wdt, cout, False)
        x = torch.randint(-127, 128, (BATCH, h, w, cin), device=dev,
                          generator=g, dtype=torch.int8)
        block = _cudnn_block(g, dev, h, w, cin, wdt, cout, 1, False)
        cudnn = dict(cudnn_ms=time_ms(block), cudnn_dev_ms=device_ms(block))
        del block
        m = BATCH * h * w
        ops = 2 * m * (cin * wdt + 9 * wdt * wdt + wdt * cout)
        wbytes = wdt * cin + 9 * wdt * wdt + cout * wdt + 4 * (
            4 * wdt + 2 * cout)
        for out_int8 in (True, False):
            def call():
                return nv.bneck_block_nv(x, *ws, *vecs, r,
                                         out_int8=out_int8)

            want = nv.bneck_block_nv_plain(x, *ws, *vecs, r,
                                           out_int8=out_int8)
            assert torch.equal(call(), want), (h, wdt, out_int8)
            del want
            ob = 1 if out_int8 else 2
            row = dict(name="bneck_block_nv", route="wgmma", h=h, cin=cin,
                       wdt=wdt, cout=cout, out_int8=out_int8, **cudnn,
                       bound_ms=max(ops / INT8, (m * cin + m * cout * ob
                                                 + wbytes) / BW) * 1e3)
            _timed(row, None, call, tuple(KERNELS["wgmma"].values()))
            if opts.parts:
                c2_ops = 2 * m * 9 * wdt * wdt / INT8 * 1e3
                c2_bytes = (2 * m * wdt + 9 * wdt * wdt) / BW * 1e3
                row.update(
                    conv1_bound_ms=(m * cin + m * wdt + wdt * cin) / BW
                    * 1e3,
                    conv2_bound_ms=max(c2_ops, c2_bytes),
                    conv2_bound_by=("operations" if c2_ops >= c2_bytes
                                    else "bytes"),
                    out_bound_ms=(m * wdt + m * cout * (1 + ob)
                                  + cout * wdt) / BW * 1e3)
                for part, fn in _parts(nv, x, ws, vecs, r,
                                       out_int8).items():
                    _timed(row, part, fn, (KERNELS["wgmma"][part],))
            print(json.dumps(row), flush=True)
            add(row, n_int8 if out_int8 else n_bf16)
        del x, ws
        torch.cuda.empty_cache()

    keys = KERNELS["transition" if route == "wgmma" else "mma_sync"]
    for h, w, cin, wdt, cout, stride, count in TRANSITION:
        ws, vecs, pp = _operands(g, dev, cin, wdt, cout, True)
        x = torch.randint(-127, 128, (BATCH, h, w, cin), device=dev,
                          generator=g, dtype=torch.int8)
        m = BATCH * h * w
        m_out = BATCH * ((h - 1) // stride + 1) * ((w - 1) // stride + 1)

        def call():
            return nv.bneck_transition_nv(x, *ws, *vecs, pp, stride=stride)

        want = nv.bneck_transition_nv_plain(x, *ws, *vecs, pp, stride=stride)
        assert torch.equal(call(), want), (h, wdt, stride)
        del want
        ops = 2 * (m * cin * wdt + m_out * (9 * wdt * wdt + wdt * cout
                                            + cin * cout))
        byts = m * cin + m_out * cout + wdt * cin + 9 * wdt * wdt + cout * (
            wdt + cin) + 4 * (4 * wdt + 3 * cout)
        row = dict(name="bneck_transition_nv", route=route, h=h, cin=cin,
                   wdt=wdt, cout=cout, stride=stride, out_int8=True,
                   bound_ms=_bound(ops, byts)[0])
        _timed(row, None, call, tuple(keys.values()))
        if opts.parts:
            row.update(part_bounds(m, m_out, cin, wdt, cout, stride, True))
            if route == "wgmma":
                for part, fn in _parts(nv, x, ws, vecs, pp, True,
                                       stride).items():
                    _timed(row, part, fn, (keys[part],))
            else:   # the first design: its kernels' split of one call
                split = split_ms(call, tuple(keys.values()))
                for part, key in keys.items():
                    row[f"{part}_dev_ms"] = split[key] if split else None
        print(json.dumps(row), flush=True)
        add({f"transition_{k}": v for k, v in row.items()}, count)
        del x, ws
        torch.cuda.empty_cache()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"serving_batch_ms": batch, "route": route,
                      "repo": opts.repo or ".", "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
