"""Time the port's fused int8 block-half forward on the card at WRN-28-10's
three stage shapes (batch 128), beside cuDNN's bf16 forward of the same 3x3
conv (channels-last) and the function's bound.

    python tools/bench_fused_fwd_int8.py [--repo DIR] [--parts] [--others]

``--repo`` imports the port from another checkout (an unpacked parent
commit, to compare two versions in one call: run parent, change, change,
parent). The forward is what the checkout has: ``fwd_int8`` (the amax
pass, the prepass into the padded slab, the TMA-fed s8 wgmma GEMM and its
ordered sum) or, before it, ``fwd_quantize`` then ``fwd_conv`` (the amax
and channel-major quant passes, the row-tile mma.sync conv and its sum).
``--parts`` also times the two wrappers of each route apart (``pre`` and
``gemm``, or ``quant`` and ``conv``) and splits the forward's device time
by kernel (``amax``, ``prepass`` or ``quant``, ``gemm`` or ``conv``,
``sum``), beside each part's bound (``pre_bound_ms``: the function's
bytes, x and the bits read once and the slab written;
``pre_traffic_ms``: the two passes' own traffic, x and the bits read by
each); with the new route, the GEMM also at the other N tile (160 or 128)
that divides Cout. ``--others`` times the other users of the code this
change touched: the FQT backward's quantizer (``bwd_quantize``), the lane
transition's forward (``transition.fwd_conv``) and the fused bf16
forward (``fwd_bf16``). Every time is a CUDA-event mean of back-to-back
calls, as ``*_dev_ms`` the kernels' summed device time per call
(torch.profiler), and as ``*_host_ms`` the host's time to issue one call
(wall clock over 20 calls issued back to back, before the card is waited
for: the wrappers' checks, allocations and launches). Rows: each stage in both bits modes (a [C, N] uint8
tensor, a seed), as a block's first half (BatchNorm sums, no residual) and
its second (a residual, no sums). Then one line with the times summed over
the forwards of a WRN-28-10 FQT step (22 halves: 8 at C = 160, 7 at 320, 7
at 640, bits tensors), and the card's name and power limit. Needs a CUDA
card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from bench_nv_fwd_int8 import INT8, device_ms
from bench_nv_wgrad_bf16 import BW, REPO, time_ms

BATCH = 128
STAGES = [(160, 32, 32), (320, 16, 16), (640, 8, 8)]   # (C, H, W)
# forward calls of a WRN-28-10 FQT step by (C, residual, sums, bits mode)
# (chip_smoke.py phase 7's record of the step's halves)
FQT_MIX = {(160, False, True, "bits"): 4, (160, True, False, "bits"): 4,
           (320, False, True, "bits"): 3, (320, True, False, "bits"): 4,
           (640, False, True, "bits"): 3, (640, True, False, "bits"): 4}
# the kernels of each route by name, for the device-time split
KERNELS = {"new": {"amax": "amax_kernel", "prepass": "fwd_slab_kernel",
                   "gemm": "fwd_s8_kernel", "sum": "tile_sum"},
           "old": {"amax": "amax_kernel", "quant": "quant_kernel",
                   "conv": "conv3x3_rows_kernel", "sum": "partial_sum"}}
# (stage, batch, h, w, cin, cout): WRN-28-10's two stage transitions
TR_SHAPES = [(2, BATCH, 32, 32, 160, 320), (3, BATCH, 16, 16, 320, 640)]


def split_ms(fn, keys, reps=10):
    """Device time per call of ``fn`` by kernel: {name: ms} over the
    kernels whose names contain each pattern of ``keys`` (torch.profiler
    over ``reps`` calls after one warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {name: 0.0 for name in keys}
    for e in prof.key_averages():
        if e.device_type.name != "CUDA":
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        for name, pattern in keys.items():
            if pattern in e.key:
                out[name] += us / reps / 1e3
    return out


def host_ms(fn, reps=20):
    """The host's time per call of ``fn``: the wall clock over ``reps``
    calls issued back to back after one warm-up call, read before the card
    is waited for (the launches stay far below the queue's depth)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def _timed(row, key, fn):
    """row[key_ms], row[key_dev_ms], row[key_host_ms] (``ms``, ``dev_ms``,
    ``host_ms`` for key None)."""
    pre = f"{key}_" if key else ""
    row[f"{pre}ms"] = time_ms(fn)
    row[f"{pre}dev_ms"] = device_ms(fn)
    row[f"{pre}host_ms"] = host_ms(fn)


def others(fb, dev, g):
    """Rows of the other users of the touched code: the FQT backward's
    quantizer at each stage (stats cotangents, a bits tensor), the fused
    bf16 forward at each stage (a bits tensor, sums), the transition
    forward at both transitions (projection, bits)."""
    import torch

    from pytorch_ddp_resnet_tpu_torch.ops.cuda import transition as tr
    from pytorch_ddp_resnet_tpu_torch.ops.cuda.conv3x3 import pack_weights

    def rn(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=g) * s

    thresh = fb.dropout_thresh(0.3)
    for c, h, w in STAGES:
        n = BATCH * h * w
        x = rn(c, n).to(torch.bfloat16)
        y = rn(c, n).to(torch.bfloat16)
        dy = rn(c, n, s=1e-3).to(torch.bfloat16)
        scale, shift = rn(c).abs() + 0.5, rn(c, s=0.3)
        bits = torch.randint(0, 256, (c, n), device=dev, generator=g,
                             dtype=torch.uint8)
        btile = fb.bwd_tile(h, w, n, c, c)
        dysum, dyssq = rn(c, s=1e-4), rn(c, s=1e-4)
        row = dict(name="bwd_quantize", c=c, h=h, mode="bits+stats")
        _timed(row, None, lambda: fb.bwd_quantize(
            dy, y, dysum, dyssq, x, scale, shift, bits, thresh=thresh,
            tile=btile, emit_res=False))
        print(json.dumps(row), flush=True)
        wp = pack_weights(rn(c, c, 3, 3, s=(9 * c) ** -0.5).to(
            torch.bfloat16))
        row = dict(name="fwd_bf16", c=c, h=h, mode="bits+stats")
        _timed(row, None, lambda: fb.fwd_bf16(
            x, wp, scale, shift, bits, None, thresh=thresh, h=h, w_img=w,
            want_stats=True))
        print(json.dumps(row), flush=True)
        del x, y, dy, bits
        torch.cuda.empty_cache()
    for stage, b, h, w, cin, cout in TR_SHAPES:
        oh, ow = h // 2, w // 2
        n, n_out = b * h * w, b * oh * ow
        x = rn(cin, n).to(torch.bfloat16)
        w1 = rn(cout, cin, 3, 3, s=(9 * cin) ** -0.5)
        wp = rn(cout, cin, s=cin ** -0.5).to(torch.bfloat16)
        scale, shift = rn(cin).abs() + 0.5, rn(cin, s=0.3)
        bits = tr.parity_unpack(torch.randint(
            0, 256, (4 * cin, n_out), device=dev, generator=g,
            dtype=torch.uint8), h, w)
        tile = tr.transition_tile(oh, ow, n_out, cin, cout)
        wq, ws = fb.quantize_pack_weights(w1)
        row = dict(name="transition_fwd", stage=stage, cin=cin, cout=cout,
                   mode="proj+bits")
        _timed(row, None, lambda: tr.fwd_conv(
            x, scale, shift, bits, wq, ws, wp, thresh=thresh, tile=tile,
            h=h, w_img=w))
        print(json.dumps(row), flush=True)
        del x, bits
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=None)
    ap.add_argument("--parts", action="store_true")
    ap.add_argument("--others", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.repo or REPO))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bench_fused_fwd_int8: no CUDA device", file=sys.stderr)
        return 1
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20)
    route = "new" if hasattr(fb, "fwd_int8") else "old"
    step = {}
    for c, h, w in STAGES:
        n = BATCH * h * w

        def rn(*shape, s=1.0):
            return torch.randn(*shape, device=dev, generator=g) * s

        x = rn(c, n).to(torch.bfloat16)
        wt = rn(c, c, 3, 3, s=(9 * c) ** -0.5)
        wq, ws = fb.quantize_pack_weights(wt)
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
        tile = fb.lane_tile(h, w, n, c, c)
        ops = 2 * 9 * c * c * n
        for kind, bits in drops.items():
            bits_b = c * n if kind == "bits" else 0
            for use_res, stats in ((False, True), (True, False)):
                r = res if use_res else None
                kw = dict(thresh=thresh, tile=tile, h=h, w_img=w,
                          want_stats=stats)
                qkw = dict(thresh=thresh, tile=tile)
                if route == "new":
                    plan = fb.fused_fwd_int8_plan(n, h, w, c, c)
                    slab_b = plan.lay.slab_len * c

                    def call():
                        return fb.fwd_int8(x, wq, ws, scale, shift, bits, r,
                                           **kw)
                else:
                    slab_b = c * n

                    def call():
                        d_q, amax = fb.fwd_quantize(x, scale, shift, bits,
                                                    **qkw)
                        return fb.fwd_conv(d_q, amax, wq, ws, r, tile=tile,
                                           h=h, w_img=w, want_stats=stats)

                row = dict(route=route, c=c, h=h, w=w, n=n, mode=kind,
                           res=use_res, stats=stats, cudnn_ms=cudnn_ms,
                           cudnn_dev_ms=cudnn_dev_ms)
                _timed(row, None, call)
                # x, the bits tensor, res, the int8 weights and their
                # scales read once, y written once
                res_b = 2 * c * n if use_res else 0
                row["bound_ms"] = max(
                    (4 * c * n + 9 * c * c + 4 * c + bits_b + res_b) / BW,
                    ops / INT8) * 1e3
                if opts.parts:
                    row.update({f"{k}_split_dev_ms": v for k, v in split_ms(
                        call, KERNELS[route]).items()})
                    if route == "new":
                        slab, amax = fb.fwd_int8_pre(x, scale, shift, bits,
                                                     plan=plan, **qkw)
                        parts = dict(
                            pre=lambda: fb.fwd_int8_pre(
                                x, scale, shift, bits, plan=plan, **qkw),
                            gemm=lambda: fb.fwd_int8_gemm(
                                slab, amax, wq, ws, r, tile=tile, plan=plan,
                                want_stats=stats))
                        for bn in (160, 128):
                            if bn != plan.bn and c % bn == 0:
                                parts[f"gemm_bn{bn}"] = (
                                    lambda p_=plan._replace(bn=bn):
                                    fb.fwd_int8_gemm(
                                        slab, amax, wq, ws, r, tile=tile,
                                        plan=p_, want_stats=stats))
                        row.update(bn=plan.bn, tiles=plan.lay.tiles,
                                   boxes=[b[1] for b in plan.boxes])
                    else:
                        slab, amax = fb.fwd_quantize(x, scale, shift, bits,
                                                     **qkw)
                        parts = dict(
                            quant=lambda: fb.fwd_quantize(
                                x, scale, shift, bits, **qkw),
                            conv=lambda: fb.fwd_conv(
                                slab, amax, wq, ws, r, tile=tile, h=h,
                                w_img=w, want_stats=stats))
                    for part, fn in parts.items():
                        _timed(row, part, fn)
                    row["amax_bound_ms"] = (2 * c * n + bits_b) / BW * 1e3
                    row["pre_bound_ms"] = (
                        2 * c * n + bits_b + slab_b) / BW * 1e3
                    row["pre_traffic_ms"] = (
                        4 * c * n + 2 * bits_b + slab_b) / BW * 1e3
                    row["gemm_bound_ms"] = max(
                        (slab_b + 9 * c * c + 2 * c * n + res_b) / BW,
                        ops / INT8) * 1e3
                    gemm = row.get("gemm_split_dev_ms",
                                   row.get("conv_split_dev_ms"))
                    row["gemm_tops"] = ops / gemm / 1e9 if gemm else None
                    del slab, amax
                print(json.dumps(row), flush=True)
                count = FQT_MIX.get((c, use_res, stats, kind), 0)
                for key, v in row.items():
                    if count and key.endswith("ms") and v is not None:
                        step[key] = step.get(key, 0.0) + v * count
        del x, res, drops
        torch.cuda.empty_cache()
    if opts.others:
        others(fb, dev, g)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"fqt_step_ms": step, "route": route,
                      "repo": opts.repo or ".", "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
