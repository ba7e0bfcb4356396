"""Time the port's fused bf16 block-half forward (``fused_block.fwd_bf16``)
on the card at WRN-28-10's three stage shapes (batch 128), beside cuDNN's
bf16 forward of the same 3x3 conv (channels-last) and the function's
bound.

    python tools/bench_fused_fwd_bf16.py [--repo DIR] [--parts]

``--repo`` imports the port from another checkout (an unpacked parent
commit, to compare two versions in one call: run parent, change, change,
parent). ``--parts`` also times the prepass and the wgmma GEMM + ordered
sum apart (checkouts that have them: ``fused_fwd_pre``,
``fused_fwd_gemm``), each beside its bound (the prepass by its bytes, the
GEMM by its operations, both counted on unpadded operands), with the MACs
the GEMM issues against the useful ones and, as ``sum_dev_ms``, the
ordered sum's share of the GEMM call's device time. Every time is a
CUDA-event mean of back-to-back calls and, as ``*_dev_ms``, the kernels'
summed device time per call (torch.profiler). Rows: each stage in the
bits modes (a [C, N] uint8 tensor, a seed), as a block's first half
(BatchNorm sums, no residual) and its second (a residual, no sums). Then
one line with the times summed over the forwards of a fused bf16 step (8
halves at C = 160, a bits tensor), and the card's name and power limit.
Needs a CUDA card; exits 1 without one.
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
F32 = 67e12   # H100 SXM f32 FLOP/s outside the tensor cores
# forward calls of a fused bf16 step by (C, residual, sums, bits mode): the
# 4 identity blocks of stage 1, each a first half with sums and a second
# with the residual
FUSED_MIX = {(160, False, True, "bits"): 4, (160, True, False, "bits"): 4}


def kernel_dev_ms(fn, pattern, reps=10):
    """The device time per call of the kernels ``fn`` launches whose names
    contain ``pattern`` (torch.profiler over ``reps`` calls)."""
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
             for e in prof.key_averages()
             if e.device_type.name == "CUDA" and pattern in e.key)
    return us / reps / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=None)
    ap.add_argument("--parts", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.repo or REPO))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bench_fused_fwd_bf16: no CUDA device", file=sys.stderr)
        return 1
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
    from pytorch_ddp_resnet_tpu_torch.ops.cuda.conv3x3 import pack_weights

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    staged = hasattr(fb, "fused_fwd_gemm")
    step = {}
    for c, h, w in STAGES:
        n = BATCH * h * w

        def rn(*shape, s=1.0):
            return torch.randn(*shape, device=dev, generator=g) * s

        x = rn(c, n).to(torch.bfloat16)
        wt = rn(c, c, 3, 3, s=(9 * c) ** -0.5)
        wp = pack_weights(wt.to(torch.bfloat16))
        res = rn(c, n).to(torch.bfloat16)
        scale, shift = rn(c).abs() + 0.5, rn(c, s=0.3)
        thresh = fb.dropout_thresh(0.3)
        drops = {"bits": torch.randint(0, 256, (c, n), device=dev,
                                       generator=g, dtype=torch.uint8),
                 "seed": torch.tensor(-1234567, dtype=torch.int32,
                                      device=dev)}
        cl = dict(memory_format=torch.channels_last)
        x4 = rn(BATCH, c, h, w).to(torch.bfloat16).to(**cl)
        w4 = wt.to(torch.bfloat16).to(**cl)
        cudnn_ms = time_ms(lambda: F.conv2d(x4, w4, padding=1))
        cudnn_dev_ms = device_ms(lambda: F.conv2d(x4, w4, padding=1))
        del x4, w4
        ops = 2 * 9 * c * c * n
        for kind, bits in drops.items():
            bits_b = c * n if kind == "bits" else 0
            for use_res, stats in ((False, True), (True, False)):
                r = res if use_res else None
                kw = dict(thresh=thresh, h=h, w_img=w, want_stats=stats)

                def call():
                    return fb.fwd_bf16(x, wp, scale, shift, bits, r, **kw)

                row = dict(c=c, h=h, w=w, n=n, mode=kind, res=use_res,
                           stats=stats, ms=time_ms(call),
                           dev_ms=device_ms(call), cudnn_ms=cudnn_ms,
                           cudnn_dev_ms=cudnn_dev_ms)
                byts = (4 * c * n + 18 * c * c + 8 * c + bits_b
                        + (2 * c * n if use_res else 0)
                        + (8 * c if stats else 0))
                row["bound_ms"] = max(byts / BW, ops / BF16) * 1e3
                if opts.parts and staged:
                    lay = fb.fused_fwd_layout(n, h, w, c, c)
                    slab = fb.fused_fwd_pre(x, scale, shift, bits,
                                            thresh=thresh, lay=lay)
                    parts = dict(
                        pre=lambda: fb.fused_fwd_pre(
                            x, scale, shift, bits, thresh=thresh, lay=lay),
                        gemm=lambda: fb.fused_fwd_gemm(
                            slab, wp, r, lay=lay, want_stats=stats))
                    for part, fn in parts.items():
                        row[f"{part}_ms"] = time_ms(fn)
                        row[f"{part}_dev_ms"] = device_ms(fn)
                    row["pre_bound_ms"] = max(
                        (4 * c * n + bits_b + 8 * c) / BW,
                        3 * c * n / F32) * 1e3
                    row["gemm_bound_ms"] = max(
                        (2 * c * n + 18 * c * c + 2 * c * n
                         + (2 * c * n if use_res else 0)
                         + (8 * c if stats else 0)) / BW, ops / BF16) * 1e3
                    n_cols = -(-c // lay.bn) * lay.bn
                    row.update(bn=lay.bn, tiles=lay.tiles,
                               issued_macs=lay.tiles * lay.bm * n_cols
                               * (-(-18 * c // 128) * 64),
                               useful_macs=ops // 2)
                    row["gemm_tflops"] = ops / row["gemm_dev_ms"] / 1e9
                    if stats:
                        row["sum_dev_ms"] = kernel_dev_ms(parts["gemm"],
                                                          "partial_sum")
                    del slab
                print(json.dumps(row), flush=True)
                count = FUSED_MIX.get((c, use_res, stats, kind), 0)
                for key, v in row.items():
                    if count and (key == "ms" or key.endswith("_ms")):
                        step[key] = step.get(key, 0.0) + v * count
        del x, res, drops
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"fused_step_ms": step, "repo": opts.repo or ".",
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
