"""Time the port's int8 NV weight gradient (``bneck_nv_train.wgrad``) on
the card at ResNet-50's NV training geometries, beside cuDNN's bf16 weight
gradient of the same conv (channels-last) and the function's bound.

    python tools/bench_nv_wgrad_int8.py [--repo DIR] [--parts]

``--repo`` imports the port from another checkout (an unpacked parent
commit, to compare two versions in one call: run parent, change, change,
parent). ``--parts`` also times the prepass and the mainloop + ordered sum
apart (checkouts that have them: ``wgrad_pre``, ``wgrad_gemm``). Prints
one JSON line per (geometry, half), then one line with the times summed
over the 30 halves of a ResNet-50 FQT step at batch 128 (stage 4 at batch
64 is timed, not summed: the gate shuts it at 128) and the card's name and
power limit. Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# the 30 halves of a step are the same in FQT and QAT
from bench_nv_wgrad_bf16 import BW, GEOMETRIES, REPO, halves, time_ms

INT8 = 1979e12   # H100 SXM: dense int8 OP/s


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=None)
    ap.add_argument("--parts", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.repo or REPO))
    import torch
    from torch.nn.grad import conv2d_weight

    if not torch.cuda.is_available():
        print("bench_nv_wgrad_int8: no CUDA device", file=sys.stderr)
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
            dy = rn(n, h, w, co, s=1e-3).to(torch.bfloat16)
            y = rn(n, h, w, co).to(torch.bfloat16)
            dzsum, dzssq = rn(co, s=1e-4), rn(co, s=1e-5)
            rch = nvt.pick_chunk_rows(h, w, n, ci, co, conv, mode)[2]
            rowmax_a = nvt.fwd_rowmax(x, s, t, res, mode=mode)[0]
            rowmax_g = nvt.bwd_rowmax(dy, y, dzsum, dzssq)
            args = (dy, y, dzsum, dzssq, rowmax_g, x, s, t, res, rowmax_a)
            kw = dict(conv=conv, mode=mode, rch=rch)
            row = dict(n=n, h=h, conv=conv, mode=mode, cin=ci, cout=co,
                       rch=rch, per_step=per_step,
                       ms=time_ms(lambda: nvt.wgrad(*args, **kw)))
            x4 = x.permute(0, 3, 1, 2)          # channels-last views
            dy4 = dy.permute(0, 3, 1, 2)
            row["cudnn_ms"] = time_ms(lambda: conv2d_weight(
                x4, (co, ci, k, k), dy4, padding=k // 2))
            byts = (2 * p * (2 * co + ci) + 4 * taps * ci * co
                    + (2 * p * ci if mode == "entry" else 0))
            row["bound_ms"] = max(byts / BW, 2 * p * taps * ci * co / INT8
                                  ) * 1e3
            if opts.parts and hasattr(nvt, "wgrad_gemm"):
                slabs = nvt.wgrad_pre(*args, **kw)
                lay = nvt.wgrad_int8_layout(n, h, w, taps, rch)
                row["pre_ms"] = time_ms(lambda: nvt.wgrad_pre(*args, **kw))
                row["gemm_ms"] = time_ms(lambda: nvt.wgrad_gemm(
                    *slabs, rowmax_a, rowmax_g, lay))
                row["plan"] = list(nvt.wgrad_int8_plan(
                    n, h, w, ci, co, taps, rch)[:-1])
                del slabs
            print(json.dumps(row), flush=True)
            for key, v in row.items():
                if key == "ms" or key.endswith("_ms"):
                    step[key] = step.get(key, 0.0) + v * per_step
            del x, res, dy, y, args
            torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"fqt_step_ms": step, "repo": opts.repo or ".",
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
