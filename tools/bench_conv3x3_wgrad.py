"""Time the port's weight gradient of ``conv3x3_same``
(``conv3x3.conv3x3_wgrad``) on the card at WRN-28-10's three stage shapes
and ResNet-v1-20's first (C = 16, zero-padded to 32 as the op pads it),
batch 128, beside cuDNN's bf16 weight gradient of the same 3x3 conv
(channels-last) and the function's bound.

    python tools/bench_conv3x3_wgrad.py [--repo DIR]

``--repo`` imports the port from another checkout (an unpacked parent
commit, to compare two versions in one call: run parent, change, change,
parent). Every time is a CUDA-event mean of 10 back-to-back calls
and, as ``*_dev_ms``, the kernels' summed device time per call
(torch.profiler); TFLOP/s counts the unpadded conv's 2 * 9 * C^2 * N.
Rows: one per stage. Then one line with the times summed over the 22
wgrad calls of a ``use_pallas_conv`` WRN-28-10 step (8 at C = 160, 7 at
320, 7 at 640), and the card's name and power limit. Needs a CUDA card;
exits 1 without one.
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
STAGES = [(160, 32, 32), (320, 16, 16), (640, 8, 8), (16, 32, 32)]
STEP_MIX = {160: 8, 320: 7, 640: 7}  # wgrad calls a pallas-conv step


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=None)
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.repo or REPO))
    import torch
    from torch.nn.grad import conv2d_weight

    if not torch.cuda.is_available():
        print("bench_conv3x3_wgrad: no CUDA device", file=sys.stderr)
        return 1
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3 as k

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    step = {}
    for c, h, w in STAGES:
        n = BATCH * h * w
        cp = -(-c // 32) * 32

        def rn(*shape):
            return torch.randn(*shape, device=dev, generator=g).to(
                torch.bfloat16)

        x, dy = rn(cp, n), rn(cp, n)
        x[c:], dy[c:] = 0, 0   # the op's zero channels

        def run():
            return k.conv3x3_wgrad(x, dy, h=h, w_img=w)

        cl = dict(memory_format=torch.channels_last)
        x4, dy4 = rn(BATCH, c, h, w).to(**cl), rn(BATCH, c, h, w).to(**cl)

        def cudnn():
            return conv2d_weight(x4, (c, c, 3, 3), dy4, padding=1)

        ops_ms = 2 * 9 * c * c * n / BF16 * 1e3
        bytes_ms = (2 * 2 * c * n + 4 * 9 * c * c) / BW * 1e3
        row = dict(c=c, padded_c=cp, h=h, w=w, n=n, ms=time_ms(run),
                   dev_ms=device_ms(run), cudnn_ms=time_ms(cudnn),
                   cudnn_dev_ms=device_ms(cudnn),
                   bound_ms=max(ops_ms, bytes_ms),
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        row["tflops"] = 2 * 9 * c * c * n / row["ms"] / 1e9
        if row["dev_ms"]:
            row["dev_tflops"] = 2 * 9 * c * c * n / row["dev_ms"] / 1e9
        if hasattr(k, "wgrad_tma_plan"):
            row["plan"] = list(k.wgrad_tma_plan(cp, cp, n, h, w))
        print(json.dumps(row), flush=True)
        for key, v in row.items():
            if c in STEP_MIX and key.endswith("ms") and v is not None:
                step[key] = step.get(key, 0.0) + v * STEP_MIX[c]
        del x, dy, x4, dy4
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"pallas_step_ms": step, "repo": opts.repo or ".",
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
