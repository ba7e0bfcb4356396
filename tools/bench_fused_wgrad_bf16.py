"""Time the port's fused bf16 block-half weight gradient
(``fused_block.wgrad_bf16``) on the card at WRN-28-10's three stage shapes
(batch 128), beside cuDNN's bf16 weight gradient of the same 3x3 conv
(channels-last) and the function's bound.

    python tools/bench_fused_wgrad_bf16.py [--repo DIR] [--parts] [--tiles]

``--repo`` imports the port from another checkout (an unpacked parent
commit, to compare two versions in one call: run parent, change, change,
parent). ``--parts`` also times the prepass and the mainloop + ordered sum
apart (checkouts that have them: ``wgrad_bf16_pre``, ``wgrad_bf16_gemm``),
each beside its bound; ``--tiles`` also takes the device time of the
mainloop + sum (``tiles``: ``gemm_dev`` per plan) with 64- and 128-wide N
tiles (each with the plan's splits for that width) and, at C = 640, with
1, 2, 3 and 4 splits of the 128-wide tile. Every time is a
CUDA-event mean of back-to-back calls and, as ``*_dev_ms``, the kernels'
summed device time per call (torch.profiler). Rows: each stage in the bits
modes (a [C, N] uint8 tensor, a seed) with and without the stats
cotangents. Then one line with the times summed over the wgrad calls of a
QAT step (22 halves) and of a fused bf16 step (8 halves at C = 160), and
the card's name and power limit. Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from bench_nv_fwd_int8 import device_ms
from bench_nv_wgrad_bf16 import BF16, BW, REPO, time_ms

BATCH = 128
STAGES = [(160, 32, 32), (320, 16, 16), (640, 8, 8)]   # (C, H, W)
# wgrad calls a step by (C, stats cotangents, bits mode): the QAT step's 22
# halves (conv1 of the 10 identity blocks folds the BatchNorm cotangents;
# in-kernel dropout from a seed at C <= 320), the fused bf16 step's 8
# (stage 1, a bits tensor)
QAT_MIX = {(160, True, "seed"): 4, (160, False, "seed"): 4,
           (320, True, "seed"): 3, (320, False, "seed"): 4,
           (640, True, "bits"): 3, (640, False, "bits"): 4}
FUSED_MIX = {(160, True, "bits"): 4, (160, False, "bits"): 4}


def _forced(plan, splits):
    """``plan`` cut into ``splits`` runs of K steps (fewer where the last
    would be empty)."""
    per = -(-plan.steps // splits)
    splits = -(-plan.steps // per)
    return plan._replace(per=per, splits=splits, ranges=tuple(
        (z * per, min(plan.steps, (z + 1) * per)) for z in range(splits)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=None)
    ap.add_argument("--parts", action="store_true")
    ap.add_argument("--tiles", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.repo or REPO))
    import torch
    from torch.nn.grad import conv2d_weight

    if not torch.cuda.is_available():
        print("bench_fused_wgrad_bf16: no CUDA device", file=sys.stderr)
        return 1
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv_train as nvt
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    staged = hasattr(fb, "wgrad_bf16_gemm")
    step = {"qat": {}, "fused": {}}
    for c, h, w in STAGES:
        n = BATCH * h * w

        def rn(*shape, s=1.0):
            return torch.randn(*shape, device=dev, generator=g) * s

        x = rn(c, n).to(torch.bfloat16)
        dy = rn(c, n, s=1e-3).to(torch.bfloat16)
        y = rn(c, n).to(torch.bfloat16)
        dysum, dyssq = rn(c, s=1e-4), rn(c, s=1e-4)
        scale, shift = rn(c).abs() + 0.5, rn(c, s=0.3)
        thresh = fb.dropout_thresh(0.3)
        drops = {"bits": torch.randint(0, 256, (c, n), device=dev,
                                       generator=g, dtype=torch.uint8),
                 "seed": torch.tensor(-1234567, dtype=torch.int32,
                                      device=dev)}
        cl = dict(memory_format=torch.channels_last)
        x4 = rn(BATCH, c, h, w).to(torch.bfloat16).to(**cl)
        dy4 = rn(BATCH, c, h, w).to(torch.bfloat16).to(**cl)
        cudnn_ms = time_ms(lambda: conv2d_weight(x4, (c, c, 3, 3), dy4,
                                                 padding=1))
        cudnn_dev_ms = device_ms(lambda: conv2d_weight(x4, (c, c, 3, 3), dy4,
                                                       padding=1))
        del x4, dy4
        ops_ms = 2 * 9 * c * c * n / BF16 * 1e3
        for kind, bits in drops.items():
            for stats in (True, False):
                cts = (y, dysum, dyssq) if stats else (None, None, None)
                args = (dy, *cts, x, scale, shift, bits)
                kw = dict(thresh=thresh, h=h, w_img=w)
                row = dict(c=c, h=h, w=w, n=n, mode=kind, stats=stats,
                           ms=time_ms(lambda: fb.wgrad_bf16(*args, **kw)),
                           dev_ms=device_ms(lambda: fb.wgrad_bf16(*args,
                                                                  **kw)),
                           cudnn_ms=cudnn_ms, cudnn_dev_ms=cudnn_dev_ms)
                inb = (4 * c * n + 8 * c + (c * n if kind == "bits" else 0)
                       + (2 * c * n + 8 * c if stats else 0))
                row["bound_ms"] = max((inb + 36 * c * c) / BW * 1e3, ops_ms)
                if opts.parts and staged:
                    d_b, g_b = fb.wgrad_bf16_pre(*args, thresh=thresh)
                    parts = dict(
                        pre=lambda: fb.wgrad_bf16_pre(*args, thresh=thresh),
                        gemm=lambda: fb.wgrad_bf16_gemm(d_b, g_b, h=h,
                                                        w_img=w))
                    for part, fn in parts.items():
                        row[f"{part}_ms"] = time_ms(fn)
                        row[f"{part}_dev_ms"] = device_ms(fn)
                    row["pre_bound_ms"] = (inb + 4 * c * n) / BW * 1e3
                    row["gemm_bound_ms"] = max(
                        (4 * c * n + 36 * c * c) / BW * 1e3, ops_ms)
                    plan = nvt.wgrad_bf16_plan(BATCH, h, w, c, c, 9, h)
                    row["plan"] = list(plan[:-1])
                    if opts.tiles and kind == "bits" and stats:
                        plans = {f"bn{bn}": nvt.split_plan(
                            9 * c, c, 1, plan.steps, plan.bk, bn=bn)
                            for bn in (64, 128)}
                        if c == 640:
                            plans.update({f"bn128_s{k}": _forced(
                                plans["bn128"], k) for k in (1, 2, 3, 4)})
                        row["tiles"] = {}
                        chosen = fb.wgrad_bf16_plan
                        for key, p in plans.items():
                            fb.wgrad_bf16_plan = lambda *a, p=p: p
                            row["tiles"][key] = dict(
                                plan=list(p[:-1]), gemm_dev=device_ms(
                                    parts["gemm"]))
                        fb.wgrad_bf16_plan = chosen
                    del d_b, g_b
                print(json.dumps(row), flush=True)
                for mix, tot in ((QAT_MIX, step["qat"]),
                                 (FUSED_MIX, step["fused"])):
                    count = mix.get((c, stats, kind), 0)
                    for key, v in row.items():
                        if count and (key == "ms" or key.endswith("_ms")):
                            tot[key] = tot.get(key, 0.0) + v * count
        del x, dy, y, drops
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"qat_step_ms": step["qat"],
                      "fused_step_ms": step["fused"],
                      "repo": opts.repo or ".", "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
