"""Time the port's int8 NV forward (``bneck_nv_train.fwd_rowmax`` +
``fwd_conv``) on the card at ResNet-50's NV training geometries, beside
cuDNN's bf16 forward of the same conv (channels-last) and the function's
bound.

    python tools/bench_nv_fwd_int8.py [--repo DIR] [--parts]

``--repo`` imports the port from another checkout (an unpacked parent
commit, to compare two versions in one call: run parent, change, change,
parent). ``--parts`` also times the row-max pass, the prepass and the
mainloop + ordered sum apart (checkouts that have them: ``fwd_pre``,
``fwd_gemm``), each beside its byte bound, and each also in device time
(``*_dev_ms``: the kernels' summed device time per call, torch.profiler,
without the wrappers' host time that back-to-back CUDA-event timing of a
small call measures); ``--tiles`` also times the mainloop on every (bn,
bk) tile it takes. Prints one JSON line per
(geometry, half), then one line with the times summed over the 30 halves
of a ResNet-50 FQT (or QAT: the same forwards) step at batch 128 (stage 4
at batch 64 is timed, not summed: the gate shuts it at 128) and the card's
name and power limit. Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from bench_nv_wgrad_bf16 import BW, GEOMETRIES, REPO, halves, time_ms

INT8 = 1979e12   # H100 SXM: dense int8 OP/s


def device_ms(fn, reps=10):
    """The summed device time of the kernels ``fn`` launches, per call
    (torch.profiler over ``reps`` calls after one warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages() if e.device_type.name == "CUDA")
    return us / reps / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=None)
    ap.add_argument("--parts", action="store_true")
    ap.add_argument("--tiles", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.repo or REPO))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bench_nv_fwd_int8: no CUDA device", file=sys.stderr)
        return 1
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv_train as nvt

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    step = {}
    for n, h, w, cin, cb, cout, blocks in GEOMETRIES:
        p = n * h * w
        for conv, mode, ci, co, per_step in halves(cin, cb, cout, blocks):
            k = 3 if conv == "3x3" else 1
            taps = k * k

            def rn(*shape, s=1.0):
                return torch.randn(*shape, device=dev, generator=g) * s

            x = rn(n, h, w, ci).to(torch.bfloat16)
            x = x.abs() if mode == "identity" else x
            s = rn(ci, s=0.5) + 1.0 if mode != "identity" else None
            t = rn(ci, s=0.2) if mode != "identity" else None
            res = (rn(n, h, w, ci).to(torch.bfloat16) if mode == "entry"
                   else None)
            wt = rn(co, ci, k, k, s=(taps * ci) ** -0.5)
            wq, ws = (nvt.quantize_w_3x3 if k == 3
                      else nvt.quantize_w_1x1)(wt)
            rch = nvt.pick_chunk_rows(h, w, n, ci, co, conv, mode)[0]
            kw = dict(conv=conv, mode=mode, rch=rch)

            def fwd():
                rowmax = nvt.fwd_rowmax(x, s, t, res, mode=mode)[0]
                return nvt.fwd_conv(x, s, t, res, rowmax, wq, ws, **kw)

            row = dict(n=n, h=h, conv=conv, mode=mode, cin=ci, cout=co,
                       rch=rch, per_step=per_step, ms=time_ms(fwd),
                       dev_ms=device_ms(fwd))
            cl = dict(memory_format=torch.channels_last)
            x4 = x.permute(0, 3, 1, 2)          # channels-last views
            w4 = wt.to(torch.bfloat16).to(**cl)
            row["cudnn_ms"] = time_ms(lambda: F.conv2d(x4, w4,
                                                       padding=k // 2))
            row["cudnn_dev_ms"] = device_ms(lambda: F.conv2d(
                x4, w4, padding=k // 2))
            entry = mode == "entry"
            act = 2 * p * ci * (2 if entry else 1)   # x (and res) in
            byts = act + 2 * p * co + taps * ci * co + (
                2 * p * ci if entry else 0)          # y out, x_res out
            row["bound_ms"] = max(byts / BW, 2 * p * taps * ci * co / INT8
                                  ) * 1e3
            if opts.parts and hasattr(nvt, "fwd_gemm"):
                rowmax = nvt.fwd_rowmax(x, s, t, res, mode=mode)[0]
                lay = nvt.fwd_int8_layout(n, h, w, ci, taps, rch)
                slab = nvt.fwd_pre(x, s, t, res, rowmax, **kw)
                parts = dict(
                    amax=lambda: nvt.fwd_rowmax(x, s, t, res, mode=mode),
                    pre=lambda: nvt.fwd_pre(x, s, t, res, rowmax, **kw),
                    gemm=lambda: nvt.fwd_gemm(slab, rowmax, wq, ws, lay))
                for part, fn in parts.items():
                    row[f"{part}_ms"] = time_ms(fn)
                    row[f"{part}_dev_ms"] = device_ms(fn)
                if opts.tiles:
                    chosen = nvt.fwd_tile
                    for bn in (64, 128):
                        for bk in (64, 128):
                            if lay.cp % bk == 0:
                                nvt.fwd_tile = lambda c, la: (bn, bk)
                                row[f"gemm_dev_ms_{bn}_{bk}"] = device_ms(
                                    parts["gemm"])
                    nvt.fwd_tile = chosen
                row["amax_bound_ms"] = (act + (2 * p * ci if entry else 0)
                                        ) / BW * 1e3
                row["pre_bound_ms"] = (act + lay.codes) / BW * 1e3
                row["gemm_bound_ms"] = max(
                    (lay.codes + taps * ci * co + 2 * p * co) / BW,
                    2 * p * taps * ci * co / INT8) * 1e3
                row["layout"] = dict(cp=lay.cp, bk=lay.bk, tiles=lay.tiles,
                                     chunks=lay.chunks,
                                     slab_mb=slab.numel() / 1e6)
                del slab
            print(json.dumps(row), flush=True)
            for key, v in row.items():
                if key == "ms" or "_ms" in key:
                    step[key] = step.get(key, 0.0) + v * per_step
            del x, res
            torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"step_ms": step, "repo": opts.repo or ".",
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
