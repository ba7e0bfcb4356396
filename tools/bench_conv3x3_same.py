"""Time the port's bf16 3x3 conv (``conv3x3.conv3x3_bf16``), the forward
and the input gradient of ``conv3x3_same``, on the card at WRN-28-10's
three stage shapes (C = 160, 320, 640 at 32x32, 16x16, 8x8) and
ResNet-v1-20's first (C = 16 at 32x32, zero-padded to 32 as the op pads
it), batch 128, beside cuDNN's bf16 forward and input gradient of the same
3x3 conv (channels-last) and the function's bound.

    python tools/bench_conv3x3_same.py [--repo DIR] [--parts]

``--repo`` imports the port from another checkout (an unpacked parent
commit, to compare two versions in one call: run parent, change, change,
parent). The conv is what the checkout has: its prepass into the padded
slab then the wgmma GEMM (``route`` "slab"), or, before them, one launch of
the row-tile mma.sync conv (``route`` "rows"). The dgrad is the same conv
on dy with the weights of ``pack_weights_dgrad``. ``--parts`` splits each
call's device time by kernel (``*_split_dev_ms``) and, with the slab
route, times its two wrappers apart (``pre``, ``gemm``), beside each
part's bound (``pre_bound_ms``: x read and the slab written;
``gemm_bound_ms``: its operations, or x, the weights and y once). Every
time is a CUDA-event mean of back-to-back calls (``ms``), the kernels'
summed device time per call (``dev_ms``, torch.profiler), and the host's
time to issue one call (``host_ms``: wall clock over 20 calls issued back
to back, before the card is waited for). Rows: one per (stage, pass).
Then one line with the times summed over a ``use_pallas_conv`` WRN-28-10
step (22 forwards and 22 dgrads: 8 at C = 160, 7 at 320, 7 at 640) and
over a WRN-28-10 calibration batch (the 22 forwards at the same widths),
and the card's name and power limit. Needs a CUDA card; exits 1 without
one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from bench_fused_fwd_int8 import _timed, split_ms
from bench_nv_wgrad_bf16 import BF16, BW, REPO, time_ms

BATCH = 128
STAGES = [(160, 32, 32), (320, 16, 16), (640, 8, 8), (16, 32, 32)]
# conv3x3_same calls of a pallas-conv step by width, each a forward and a
# dgrad; the calibration batch runs the same 22 convs forward
STEP_MIX = {160: 8, 320: 7, 640: 7}
# each route's kernels by part, for the device-time split
KERNELS = {"slab": {"pre": "slab_copy_kernel",
                    "gemm": "conv3x3_bf16_kernel"},
           "rows": {"conv": "conv3x3_rows_kernel"}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=None)
    ap.add_argument("--parts", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.repo or REPO))
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input

    if not torch.cuda.is_available():
        print("bench_conv3x3_same: no CUDA device", file=sys.stderr)
        return 1
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3 as k

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(26)
    route = "slab" if hasattr(k, "conv3x3_bf16_gemm") else "rows"
    sums = {"pallas_step_ms": {}, "calib_batch_ms": {}}
    for c, h, w in STAGES:
        n = BATCH * h * w
        cp = -(-c // 32) * 32

        def rn(*shape, s=1.0):
            return (torch.randn(*shape, device=dev, generator=g) * s).to(
                torch.bfloat16)

        wt = torch.zeros((cp, cp, 3, 3), dtype=torch.bfloat16, device=dev)
        wt[:c, :c] = rn(c, c, 3, 3, s=(9 * c) ** -0.5)
        x, dy = rn(cp, n), rn(cp, n)
        x[c:], dy[c:] = 0, 0   # the op's zero channels
        cl = dict(memory_format=torch.channels_last)
        x4, dy4 = rn(BATCH, c, h, w).to(**cl), rn(BATCH, c, h, w).to(**cl)
        w4 = wt[:c, :c].contiguous().to(**cl)
        cudnn = {"fwd": lambda: F.conv2d(x4, w4, padding=1),
                 "dgrad": lambda: conv2d_input((BATCH, c, h, w), w4, dy4,
                                               padding=1)}
        ops = 2 * 9 * c * c * n
        for name, src, wp in (("fwd", x, k.pack_weights(wt)),
                              ("dgrad", dy, k.pack_weights_dgrad(wt))):
            def call(src=src, wp=wp):
                return k.conv3x3_bf16(src, wp, h=h, w_img=w)

            row = dict(route=route, pass_=name, c=c, padded_c=cp, h=h, w=w,
                       n=n)
            _timed(row, None, call)
            _timed(row, "cudnn", cudnn[name])
            row["bound_ms"] = max(ops / BF16,
                                  2 * (2 * c * n + 9 * c * c) / BW) * 1e3
            if opts.parts:
                row.update({f"{part}_split_dev_ms": v for part, v in
                            split_ms(call, KERNELS[route]).items()})
                if route == "slab":
                    lay = k.conv3x3_bf16_plan(n, h, w, cp, cp)
                    slab = k.conv3x3_bf16_pre(src, lay=lay)
                    _timed(row, "pre",
                           lambda src=src: k.conv3x3_bf16_pre(src, lay=lay))
                    _timed(row, "gemm", lambda wp=wp: k.conv3x3_bf16_gemm(
                        slab, wp, lay=lay))
                    row.update(bn=lay.bn, tiles=lay.tiles,
                               pre_bound_ms=2 * (cp * n + lay.slab_len * cp)
                               / BW * 1e3)
                    del slab
                row["gemm_bound_ms"] = row["bound_ms"]
                gemm = row.get("gemm_split_dev_ms",
                               row.get("conv_split_dev_ms"))
                row["gemm_tflops"] = ops / gemm / 1e9 if gemm else None
            print(json.dumps(row), flush=True)
            for key, passes in (("pallas_step_ms", ("fwd", "dgrad")),
                                ("calib_batch_ms", ("fwd",))):
                count = STEP_MIX.get(c, 0) if name in passes else 0
                for kk, v in row.items():
                    if count and kk.endswith("ms") and v is not None:
                        sums[key][kk] = sums[key].get(kk, 0.0) + v * count
        del x, dy, x4, dy4, wt, w4
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({**sums, "route": route, "repo": opts.repo or ".",
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
