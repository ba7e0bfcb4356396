"""Time the port's bf16 NV weight gradient (``bneck_nv_train.wgrad_bf16``)
on the card at ResNet-50's NV training geometries, beside cuDNN's bf16
weight gradient of the same conv (channels-last) and the function's bound.

    python tools/bench_nv_wgrad_bf16.py [--repo DIR] [--parts]

``--repo`` imports the port from another checkout (an unpacked parent
commit, to compare two versions in one call: run parent, change, change,
parent). ``--parts`` also times the prepass and the mainloop + ordered sum
apart (checkouts that have them). Prints one JSON
line per (geometry, half), then one line with the times summed over the
30 halves of a ResNet-50 QAT step at batch 128 (stage 4 at batch 64 is
timed, not summed: the gate shuts it at 128) and the card's name and
power limit. Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (batch, h, w, Cin, width, Cout, identity blocks): ResNet-50's identity
# bottleneck blocks the NV gate admits
GEOMETRIES = [(128, 56, 56, 256, 64, 256, 2),
              (128, 28, 28, 512, 128, 512, 3),
              (128, 14, 14, 1024, 256, 1024, 5),
              (64, 7, 7, 2048, 512, 2048, 0)]
BW, BF16 = 3.35e12, 989e12   # H100 SXM: bytes/s, dense bf16 FLOP/s


def halves(cin, cb, cout, blocks):
    """(conv, mode, Cin, Cout, halves per QAT step) of one stage."""
    return [("1x1", "identity", cin, cb, min(blocks, 1)),
            ("1x1", "entry", cin, cb, max(blocks - 1, 0)),
            ("3x3", "affine", cb, cb, blocks),
            ("1x1", "affine", cb, cout, blocks)]


def time_ms(fn, reps=10):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=None)
    ap.add_argument("--parts", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo or REPO))
    import torch
    from torch.nn.grad import conv2d_weight

    if not torch.cuda.is_available():
        print("bench_nv_wgrad_bf16: no CUDA device", file=sys.stderr)
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
            cts = (dy, y, dzsum, dzssq, x, s, t, res)
            kw = dict(conv=conv, mode=mode, rch=rch)
            row = dict(n=n, h=h, conv=conv, mode=mode, cin=ci, cout=co,
                       rch=rch, per_step=per_step,
                       ms=time_ms(lambda: nvt.wgrad_bf16(*cts, **kw)))
            x4 = x.permute(0, 3, 1, 2)          # channels-last views
            dy4 = dy.permute(0, 3, 1, 2)
            row["cudnn_ms"] = time_ms(lambda: conv2d_weight(
                x4, (co, ci, k, k), dy4, padding=k // 2))
            byts = (2 * p * (2 * co + ci) + 4 * taps * ci * co
                    + (2 * p * ci if mode == "entry" else 0))
            row["bound_ms"] = max(byts / BW, 2 * p * taps * ci * co / BF16
                                  ) * 1e3
            if args.parts:
                a_b, g_b = nvt.wgrad_bf16_pre(dy, y, dzsum, dzssq, x, s, t,
                                              res, mode=mode)
                row["pre_ms"] = time_ms(lambda: nvt.wgrad_bf16_pre(
                    dy, y, dzsum, dzssq, x, s, t, res, mode=mode))
                row["gemm_ms"] = time_ms(lambda: nvt.wgrad_bf16_gemm(
                    a_b, g_b, conv=conv, rch=rch))
                row["plan"] = list(nvt.wgrad_bf16_plan(
                    n, h, w, ci, co, taps, rch)[:-1])
                del a_b, g_b
            print(json.dumps(row), flush=True)
            for key, v in row.items():
                if key == "ms" or key.endswith("_ms"):
                    step[key] = step.get(key, 0.0) + v * per_step
            del x, res, dy, y
            torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"qat_step_ms": step, "repo": args.repo or ".",
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
