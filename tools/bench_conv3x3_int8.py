"""Time the port's int8 serving 3x3 conv (``conv3x3.conv3x3_int8_requant``)
on the card at WRN-28-10's three stage shapes (batch 128) in each epilogue
mode, beside cuDNN's bf16 forward of the same 3x3 conv (channels-last) and
the function's bound, then summed over a WRN-28-10 int8 serving batch.

    python tools/bench_conv3x3_int8.py [--repo DIR] [--parts] [--bf16]

``--repo`` imports the port from another checkout (an unpacked parent
commit, to compare two versions in one call: run parent, change, change,
parent). The op is what the checkout has: its prepass into the padded slab
and the TMA-fed s8 wgmma GEMM with the requantizing epilogue (``route``
"slab"), or, before it, one launch of the row-tile mma.sync conv
(``route`` "rows"). ``--parts`` also times the slab route's two wrappers
apart (``pre``, ``gemm``) and splits the op's device time by kernel
(``pre_split_dev_ms``, ``gemm_split_dev_ms``), beside each part's bound
(``pre_bound_ms``: x_q read and the slab written; ``gemm_bound_ms``: its
operations, or the slab, weights and outputs). ``--bf16`` also times the
bf16 conv (``conv3x3_bf16``, which shares ``csrc/conv3x3.cu``) at each
stage. Every time is a CUDA-event mean of back-to-back calls (``ms``), the
kernels' summed device time per call (``dev_ms``, torch.profiler), and the
host's time to issue one call (``host_ms``: wall clock over 20 calls issued
back to back, before the card is waited for).

The serving batch's mix of (stage, mode) calls is read from
``conv3x3.launch_shapes`` after one batch of 128 images through
``load_predictor(config, quantize="int8")`` on the WRN-28-10 recipe with
Synthetic data (random weights from the config's seed). Prints one JSON
line per (stage, mode), then one line with the times summed over the
batch's launches, the mix, and the card's name and power limit. Needs a
CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

from bench_fused_fwd_int8 import host_ms, split_ms
from bench_nv_fwd_int8 import INT8, device_ms
from bench_nv_wgrad_bf16 import BF16, BW, REPO, time_ms

BATCH = 128
STAGES = [(160, 32, 32), (320, 16, 16), (640, 8, 8)]   # (C, H, W)
MODES = ("int8", "bf16", "bf16+res", "bf16+res+dual")
# the slab route's kernels by part, for the device-time split: the
# prepass is csrc/fused_half.cuh's slab copy (before it moved there,
# requant_wgmma_s8.cuh's own pre_kernel; a tree has one or the other)
KERNELS = {"pre": "slab_copy_kernel", "pre_own": "requant_wgmma_s8::pre_",
           "gemm": "requant_s8_kernel"}


def _timed(row, key, fn):
    """row[key_ms], row[key_dev_ms], row[key_host_ms] (``ms``, ``dev_ms``,
    ``host_ms`` for key None)."""
    pre = f"{key}_" if key else ""
    row[f"{pre}ms"] = time_ms(fn)
    row[f"{pre}dev_ms"] = device_ms(fn)
    row[f"{pre}host_ms"] = host_ms(fn)


def serving_mix(repo: str) -> dict:
    """{(C, mode): launches} of the int8 conv over one serving batch of
    WRN-28-10 at batch 128 (``conv3x3.launch_shapes``)."""
    import torch

    sys.path.insert(0, repo)
    from chip_smoke import WRN_CONFIG, write_run
    from pytorch_ddp_resnet_tpu_torch.algos.predict import load_predictor
    from pytorch_ddp_resnet_tpu_torch.data.datasets import load_synthetic
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3

    with tempfile.TemporaryDirectory() as d:
        config = write_run(d, "wrn-28-10", WRN_CONFIG,
                           dataset_cls_name="Synthetic")
        qp = load_predictor(config, quantize="int8")
        images = load_synthetic(None, train=False).x[:BATCH]
        conv3x3.reset_launches()
        qp.logits(images)
        torch.cuda.synchronize()
    mix = {}
    for (name, cin, _, n, mode), count in conv3x3.launch_shapes.items():
        if name == "conv3x3_int8_requant":
            assert n == BATCH * next(h * w for c, h, w in STAGES
                                     if c == cin), (cin, n)
            mix[(cin, mode)] = mix.get((cin, mode), 0) + count
    assert sum(mix.values()) == 22, mix
    return mix


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=None)
    ap.add_argument("--parts", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    opts = ap.parse_args()
    repo = os.path.abspath(opts.repo or REPO)
    sys.path.insert(0, repo)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bench_conv3x3_int8: no CUDA device", file=sys.stderr)
        return 1
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3 as k

    torch.backends.cudnn.allow_tf32 = False
    mix = serving_mix(repo)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23)
    route = "slab" if hasattr(k, "conv3x3_int8_requant_gemm") else "rows"
    batch = {}
    for c, h, w in STAGES:
        n = BATCH * h * w

        def rn(*shape, s=1.0):
            return torch.randn(*shape, device=dev, generator=g) * s

        def vec(lo, hi):
            return torch.rand(c, device=dev, generator=g) * (hi - lo) + lo

        xq = torch.randint(-127, 128, (c, n), device=dev, generator=g,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (c, 9 * c), device=dev, generator=g,
                           dtype=torch.int8)
        sigma = (127.0 ** 2 / 3) * (9 * c) ** 0.5  # std of the s32 sums
        scale, shift = vec(0.5, 1.5) / sigma, vec(-0.5, 0.5)
        res = rn(c, n).to(torch.bfloat16)
        dual = (vec(0.5, 1.5) * 127 / 4, vec(-5.0, 5.0))
        cl = dict(memory_format=torch.channels_last)
        x4 = rn(BATCH, c, h, w).to(torch.bfloat16).to(**cl)
        w4 = rn(c, c, 3, 3, s=(9 * c) ** -0.5).to(torch.bfloat16).to(**cl)
        cudnn_ms = time_ms(lambda: F.conv2d(x4, w4, padding=1))
        cudnn_dev_ms = device_ms(lambda: F.conv2d(x4, w4, padding=1))
        del x4, w4
        ops = 2 * 9 * c * c * n
        if opts.bf16:
            xb = rn(c, n).to(torch.bfloat16)
            wb = rn(c, 9 * c, s=(9 * c) ** -0.5).to(torch.bfloat16)
            row = dict(name="conv3x3_bf16", route=route, c=c, h=h, w=w,
                       n=n, cudnn_ms=cudnn_ms, cudnn_dev_ms=cudnn_dev_ms,
                       bound_ms=max(ops / BF16, 2 * (2 * c * n + 9 * c * c)
                                    / BW) * 1e3)
            _timed(row, None, lambda: k.conv3x3_bf16(xb, wb, h=h, w_img=w))
            print(json.dumps(row), flush=True)
            del xb, wb
        modes = {
            "int8": ((None, None), dict(relu=True, inv_out_scale=127 / 4)),
            "bf16": ((None, None), dict(relu=True)),
            "bf16+res": ((res, None), dict(relu=False)),
            "bf16+res+dual": ((res, dual), dict(relu=False)),
        }
        for mode in MODES:
            (r, du), kw = modes[mode]

            def call():
                return k.conv3x3_int8_requant(xq, wq, scale, shift, r, du,
                                              h=h, w_img=w, **kw)

            out_b = c * n * (1 if mode == "int8" else 2)
            io_b = (c * n + 9 * c * c + 4 * c * (4 if du else 2) + out_b
                    + (2 * c * n if r is not None else 0)
                    + (c * n if du else 0))
            row = dict(name="conv3x3_int8_requant", route=route, c=c, h=h,
                       w=w, n=n, mode=mode, cudnn_ms=cudnn_ms,
                       cudnn_dev_ms=cudnn_dev_ms,
                       bound_ms=max(io_b / BW, ops / INT8) * 1e3)
            _timed(row, None, call)
            row["tops"] = ops / row["dev_ms"] / 1e9 if row["dev_ms"] else None
            if opts.parts and route == "slab":
                plan = k.requant_plan(n, h, w, c, c)
                slab = k.conv3x3_int8_requant_pre(xq, plan=plan)
                slab_b = plan.lay.slab_len * c
                split = split_ms(call, KERNELS)
                split["pre"] += split.pop("pre_own")
                row.update({f"{part}_split_dev_ms": v
                            for part, v in split.items()})
                _timed(row, "pre",
                       lambda: k.conv3x3_int8_requant_pre(xq, plan=plan))
                _timed(row, "gemm", lambda: k.conv3x3_int8_requant_gemm(
                    slab, wq, scale, shift, r, du, plan=plan, **kw))
                row.update(
                    bn=plan.bn, tiles=plan.lay.tiles,
                    blocks=plan.lay.tiles * -(-c // plan.bn),
                    pre_bound_ms=(c * n + slab_b) / BW * 1e3,
                    gemm_bound_ms=max((io_b - c * n + slab_b) / BW,
                                      ops / INT8) * 1e3)
                gemm = row["gemm_split_dev_ms"]
                row["gemm_tops"] = ops / gemm / 1e9 if gemm else None
                del slab
            print(json.dumps(row), flush=True)
            count = mix.get((c, mode), 0)
            for key, v in row.items():
                if count and key.endswith("ms") and v is not None:
                    batch[key] = batch.get(key, 0.0) + v * count
        del xq, wq, res
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"serving_batch_ms": batch, "route": route,
                      "mix": {f"{c}/{m}": v for (c, m), v in mix.items()},
                      "repo": opts.repo or ".", "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
