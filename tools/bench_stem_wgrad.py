"""Time the port's stem weight gradient on the card at WRN-28-10's stem
(3 -> 160 channels, 32x32, batch 128): ``stem.stem_wgrad`` (dW and db)
beside cuDNN's bf16 weight gradient of the same 3x3 conv (channels-last,
``conv2d_weight``; its bias gradient is not counted) and the function's
bound (dy and x read once, dW and db written: 42 MB at 3.35 TB/s).

    python tools/bench_stem_wgrad.py [--repo DIR] [--parts] [--sweep]

``--repo`` imports the port from another checkout (an unpacked parent
commit, to compare two versions in one call: run parent, change, change,
parent). ``--parts`` also gives the mainloop's and the sum's device time
apart (torch.profiler, by kernel name). ``--sweep`` (a checkout with
``stem_wgrad_plan``) times the plan's blocks per SM at 1, 2 and 4. Every
time is given by CUDA events (``ms``: 20 back-to-back calls) and in device
time (``dev_ms``: the kernels' summed device time per call); ``rel_err``
is the largest difference from the plain version over its largest value.
Prints one JSON line per run, with the card's name and power limit. Needs
a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from bench_nv_fwd_int8 import device_ms
from bench_nv_wgrad_bf16 import BF16, BW, REPO, time_ms
from bench_transition_wgrad import card

CIN, COUT, H, W, BATCH = 3, 160, 32, 32, 128


def split_ms(fn, keys, reps=10):
    """Device time per call of ``fn`` by kernel-name key (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {k: 0.0 for k in keys}
    for e in prof.key_averages():
        if e.device_type.name != "CUDA":
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        for k in keys:
            if k in e.key:
                out[k] += us / reps / 1e3
                break
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=None)
    ap.add_argument("--parts", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.repo or REPO))
    import torch
    from torch.nn.grad import conv2d_weight

    if not torch.cuda.is_available():
        print("bench_stem_wgrad: no CUDA device", file=sys.stderr)
        return 1
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import stem as st

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    name = card()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    n = BATCH * H * W
    x = torch.randn(CIN, n, device=dev, generator=g).to(torch.bfloat16)
    dy = torch.randn(COUT, n, device=dev, generator=g).to(torch.bfloat16)
    cl = dict(memory_format=torch.channels_last)
    x4 = x.t().contiguous().view(BATCH, H, W, CIN).permute(0, 3, 1, 2)
    dy4 = dy.t().contiguous().view(BATCH, H, W, COUT).permute(0, 3, 1, 2)
    x4, dy4 = x4.to(**cl), dy4.to(**cl)

    def cudnn():
        return conv2d_weight(x4, (COUT, CIN, 3, 3), dy4, padding=1)

    def kernel():
        return st.stem_wgrad(dy, x, h=H, w_img=W)

    want = st.stem_wgrad_plain(dy, x, h=H, w_img=W)
    byts = 2 * (CIN + COUT) * n + 4 * (9 * CIN + 1) * COUT
    flops = 2 * (9 * CIN + 1) * COUT * n
    bound_ms = max(byts / BW, flops / BF16) * 1e3
    plans = [None]
    if opts.sweep and hasattr(st, "stem_wgrad_plan"):
        plans = [1, 2, 4]
    base = getattr(st, "WG_BLOCKS_PER_SM", None)
    for per_sm in plans:
        if per_sm is not None:
            st.WG_BLOCKS_PER_SM = per_sm
            st.stem_wgrad_plan.cache_clear()
        got = kernel()
        rel = max(((a - b).abs().max() / b.abs().max()).item()
                  for a, b in zip(got, want))
        row = dict(card=name, repo=opts.repo or "this", cin=CIN, cout=COUT,
                   h=H, w=W, batch=BATCH, ms=time_ms(kernel, 20),
                   dev_ms=device_ms(kernel), cudnn_ms=time_ms(cudnn, 20),
                   cudnn_dev_ms=device_ms(cudnn), bound_ms=bound_ms,
                   bound_by="bytes" if byts / BW >= flops / BF16
                   else "operations", rel_err=rel)
        if hasattr(st, "stem_wgrad_plan"):
            p = st.stem_wgrad_plan(n, COUT, H, W)
            row.update(blocks_per_sm=st.WG_BLOCKS_PER_SM, blocks=p.blocks,
                       steps_per_block=p.per)
        if opts.parts:
            row["parts_dev_ms"] = split_ms(kernel, ("sum", "stem_wgrad"))
        print(json.dumps(row), flush=True)
    if base is not None:
        st.WG_BLOCKS_PER_SM = base
        st.stem_wgrad_plan.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
