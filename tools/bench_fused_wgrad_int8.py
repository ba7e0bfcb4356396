"""Time the port's fused int8 half's weight gradient on the card at
WRN-28-10's three stages (C = 160, 320, 640 at 32x32, 16x16, 8x8, batch
128): ``fused_block.wgrad`` on its quantizer's codes (``bwd_quantize``),
beside cuDNN's bf16 weight gradient of the same 3x3 conv (channels-last,
``conv2d_weight``) and the function's bound (60.4 G int8 operations a call
at 1,979 TOP/s). Then the times summed over an FQT step's 22 halves (8 at
C = 160, 7 at 320, 7 at 640).

    python tools/bench_fused_wgrad_int8.py [--repo DIR] [--parts] [--plans]

``--repo`` imports the port from another checkout (an unpacked parent
commit, to compare two versions in one call: run parent, change, change,
parent). ``--parts`` also gives the mainloop's and the sum's device time
apart (torch.profiler, by kernel name). ``--plans`` (a checkout with
``fused_wgrad_s8_plan``) times every tile width and split the plan weighs
at each stage beside the model's time, and whether the plan took it. Every
time is given by CUDA events (``ms``: 10 back-to-back calls) and in device
time (``dev_ms``: the kernels' summed device time per call); ``tops`` is
the useful 2 * 9 * C * C * N operations over ``dev_ms``. Prints one JSON
line per stage (and per plan), then the step's sums, with the card's name
and power limit. Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from bench_nv_fwd_int8 import device_ms
from bench_nv_wgrad_bf16 import REPO, time_ms
from bench_stem_wgrad import split_ms
from bench_transition_wgrad import INT8, card

BATCH = 128
# (C, H = W, halves a WRN-28-10 FQT step runs at that width)
STAGES = [(160, 32, 8), (320, 16, 7), (640, 8, 7)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=None)
    ap.add_argument("--parts", action="store_true")
    ap.add_argument("--plans", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.repo or REPO))
    import torch
    from torch.nn.grad import conv2d_weight

    if not torch.cuda.is_available():
        print("bench_fused_wgrad_int8: no CUDA device", file=sys.stderr)
        return 1
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    name = card()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    has_plan = hasattr(fb, "fused_wgrad_s8_plan")
    step = dict(ms=0.0, dev_ms=0.0, cudnn_ms=0.0, cudnn_dev_ms=0.0,
                bound_ms=0.0)
    for c, hw, halves in STAGES:
        n = BATCH * hw * hw

        def rn(*shape, s=1.0):
            return torch.randn(*shape, device=dev, generator=g) * s

        x = rn(c, n).to(torch.bfloat16)
        scale, shift = rn(c).abs() + 0.5, rn(c, s=0.3)
        bits = torch.randint(0, 256, (c, n), device=dev, generator=g,
                             dtype=torch.uint8)
        dy = rn(c, n, s=1e-3).to(torch.bfloat16)
        tile = fb.bwd_tile(hw, hw, n, c, c)
        g_q, g_amax, d_q, d_amax, _ = fb.bwd_quantize(
            dy, None, None, None, x, scale, shift, bits,
            thresh=fb.dropout_thresh(0.3), tile=tile, emit_res=False)
        kw = dict(tile=tile, h=hw, w_img=hw)

        def kernel():
            return fb.wgrad(g_q, g_amax, d_q, d_amax, **kw)

        cl = dict(memory_format=torch.channels_last)
        x4 = x.t().contiguous().view(BATCH, hw, hw, c).permute(0, 3, 1, 2)
        dy4 = dy.t().contiguous().view(BATCH, hw, hw, c).permute(0, 3, 1, 2)
        x4, dy4 = x4.to(**cl), dy4.to(**cl)

        def cudnn():
            return conv2d_weight(x4, (c, c, 3, 3), dy4, padding=1)

        ops = 2 * 9 * c * c * n
        want = fb.wgrad_plain(g_q, g_amax, d_q, d_amax, **kw)
        row = dict(card=name, repo=opts.repo or "this", c=c, h=hw, w=hw,
                   batch=BATCH, halves=halves, ms=time_ms(kernel),
                   dev_ms=device_ms(kernel), cudnn_ms=time_ms(cudnn),
                   cudnn_dev_ms=device_ms(cudnn),
                   bound_ms=ops / INT8 * 1e3, bound_by="operations",
                   bit_equal=bool(torch.equal(kernel(), want)))
        row["tops"] = ops / row["dev_ms"] / 1e9
        if has_plan:
            p = fb.fused_wgrad_s8_plan(c, c, n, hw, hw, tile)
            row.update(bn=p.bn, gpb=p.gpb, runs=p.runs, blocks=p.blocks,
                       model_us=p.us)
        if opts.parts:
            row["parts_dev_ms"] = split_ms(kernel, ("sum", "wgrad"))
        print(json.dumps(row), flush=True)
        for k in step:
            step[k] += row[k] * halves
        if opts.plans and has_plan:
            chosen = fb.fused_wgrad_s8_plan
            plan0 = chosen(c, c, n, hw, hw, tile)
            cands = []
            for bn in fb.WGRAD_FOLD_BNS:
                cands.append((bn, plan0.groups))
            for bn in fb.WGRAD_SLOT_BNS:
                for gpb in sorted({1, 2, 4, plan0.groups // 2}):
                    if 0 < gpb < plan0.groups:
                        cands.append((bn, gpb))
            try:
                for bn, gpb in cands:
                    runs = -(-plan0.groups // gpb)
                    p = plan0._replace(bn=bn, n_tiles=-(-c // bn), gpb=gpb,
                                       runs=runs)
                    fb.fused_wgrad_s8_plan = lambda *a, p=p: p
                    ok = bool(torch.equal(kernel(), want))
                    print(json.dumps(dict(
                        card=name, c=c, plan=dict(bn=bn, gpb=gpb, runs=runs),
                        chosen=(bn, gpb) == (plan0.bn, plan0.gpb),
                        dev_ms=device_ms(kernel), bit_equal=ok)), flush=True)
            finally:
                fb.fused_wgrad_s8_plan = chosen
    print(json.dumps(dict(card=name, repo=opts.repo or "this",
                          per="FQT step of 22 halves", **step)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
