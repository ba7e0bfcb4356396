"""Time the port's lane-transition input gradient (``transition.dgrad``) on
the card at WRN-28-10's two stage transitions (160 -> 320 at 32x32, 320 ->
640 at 16x16, batch 128), both bodies as a lane step runs them (FQT: the
int8 cotangent with its group absmax; straight-through: the bf16 one; the
projection and the dropout bits in both), beside cuDNN's bf16 input
gradient of the stride-2 3x3 conv plus the 1x1 stride-2 projection's
(channels-last) and the function's bound.

    python tools/bench_transition_dgrad.py [--repo DIR] [--parts] [--others]

``--repo`` imports the port from another checkout (an unpacked parent
commit, to compare two versions in one call: run parent, change, change,
parent). ``--parts`` splits the dgrad's device time by kernel (the slab
prepass ``pre``, the GEMM ``gemm`` with its masking epilogue, the sum
``sum``; before the rebuild the strided kernel and its sum) and, where
the checkout has them, times ``dgrad_pre`` and ``dgrad_gemm`` apart, each
beside its bound. The four parity classes run inside the one GEMM kernel
(both column classes of a row parity in one block, the two row parities
in neighbouring blocks), so they are not timed apart. ``--others`` times
the other users of the mainloop headers this rebuild changed
(csrc/fwd_wgmma_s8.cuh, csrc/fwd_wgmma_bf16.cuh) at WRN-28-10's three
stages: the fused int8 forward (``fused_block.fwd_int8``, a bits tensor,
sums), the int8 serving conv (``conv3x3.conv3x3_int8_requant``, int8
out), the fused bf16 forward (``fwd_bf16``, a bits tensor, sums) and
dgrad (``dgrad_bf16``, a bits tensor, stats). Every time is a CUDA-event
mean of 10 back-to-back calls (``*ms``), the kernels' summed device time
per call (``*dev_ms``, torch.profiler) and the host's time to issue one
call (``*host_ms``); TOP/s counts the useful 2 * (9 + 1) * Cin * Cout * N'
(the taps and the projection). Prints one JSON line per (stage, body),
then one line with the times summed over a lane step's two transitions for
each body beside cuDNN's and the bound, then the ``--others`` lines; every
summary carries the card's name and power limit. Needs a CUDA card; exits
1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from bench_fused_fwd_int8 import _timed, split_ms
from bench_nv_fwd_int8 import INT8, device_ms
from bench_nv_wgrad_bf16 import BF16, BW, REPO, time_ms

BATCH = 128
# (stage, h, w, Cin, Cout): WRN-28-10's stage transitions
SHAPES = [(2, 32, 32, 160, 320), (3, 16, 16, 320, 640)]
STAGES = [(160, 32, 32), (320, 16, 16), (640, 8, 8)]   # (C, H, W)
# the kernels of each route by name, for the device-time split
KERNELS = {"wgmma": {"pre": "dgrad_pre_kernel", "gemm": "dgrad_kernel",
                     "sum": "TransitionDgradSum"},
           "rows": {"gemm": "dgrad_kernel", "sum": "partial_sum"}}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=None)
    ap.add_argument("--parts", action="store_true")
    ap.add_argument("--others", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.repo or REPO))
    import torch
    from torch.nn.grad import conv2d_input

    if not torch.cuda.is_available():
        print("bench_transition_dgrad: no CUDA device", file=sys.stderr)
        return 1
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import transition as tr

    torch.backends.cudnn.allow_tf32 = False
    name = card()
    route = "wgmma" if hasattr(tr, "dgrad_gemm") else "rows"
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(24)
    step = {}
    for stage, h, w, cin, cout in SHAPES:
        oh, ow = h // 2, w // 2
        n, n_out = BATCH * h * w, BATCH * oh * ow

        def rn(*shape, s=1.0):
            return torch.randn(*shape, device=dev, generator=g) * s

        x = rn(cin, n).to(torch.bfloat16)
        scale, shift = rn(cin).abs() + 0.5, rn(cin, s=0.3)
        bits = tr.parity_unpack(torch.randint(
            0, 256, (4 * cin, n_out), device=dev, generator=g,
            dtype=torch.uint8), h, w)
        thresh = fb.dropout_thresh(0.3)
        w1 = rn(cout, cin, 3, 3, s=(9 * cin) ** -0.5)
        wpt = rn(cin, cout, s=cin ** -0.5).to(torch.bfloat16)
        dres = rn(cout, n_out, s=1e-3).to(torch.bfloat16)
        gf = rn(cout, n_out, s=1e-3)
        tile = tr.transition_tile(oh, ow, n_out, cin, cout)
        g_q, g_amax = fb.quantize_groups_plain(gf, tile, fb.BWD_FLOOR)
        wdq, wsin = tr.quant_pack_w_dgrad(w1)
        wdb = tr.pack_w_dgrad(w1.to(torch.bfloat16))
        macs, pmacs = 9 * cin * cout * n_out, cin * cout * n_out

        cl = dict(memory_format=torch.channels_last)
        x4 = x.t().contiguous().view(BATCH, h, w, cin).permute(0, 3, 1, 2)
        dy4 = gf.to(torch.bfloat16).t().contiguous().view(
            BATCH, oh, ow, cout).permute(0, 3, 1, 2)
        x4, dy4 = x4.to(**cl), dy4.to(**cl)
        w4 = w1.to(torch.bfloat16).to(**cl)
        wp4 = wpt.t().contiguous().view(cout, cin, 1, 1).to(**cl)

        def cudnn():
            return (conv2d_input(x4.shape, w4, dy4, stride=2, padding=1),
                    conv2d_input(x4.shape, wp4, dy4, stride=2))

        cudnn_ms, cudnn_dev_ms = time_ms(cudnn), device_ms(cudnn)
        del x4, dy4
        for body, (gg, ga, wd, ws_in, el, peak) in dict(
                fqt=(g_q, g_amax, wdq, wsin, 1, INT8),
                st=(gf.to(torch.bfloat16), None, wdb, None, 2, BF16)).items():
            args = (gg, ga, wd, ws_in, x, scale, shift, bits, dres, wpt)
            kw = dict(thresh=thresh, tile=tile, h=h, w_img=w)

            def call():
                return tr.dgrad(*args, **kw)

            row = dict(route=route, stage=stage, cin=cin, cout=cout, h=h,
                       w=w, batch=BATCH, body=body, cudnn_ms=cudnn_ms,
                       cudnn_dev_ms=cudnn_dev_ms, card=name)
            _timed(row, None, call)
            # g, the weights, x, the bits, dres and Wp read once; dx out
            gemm_bytes = (el * (cout * n_out + 9 * cin * cout) + 5 * cin * n
                          + 2 * cout * n_out + 2 * cin * cout)
            ops = 2 * macs / peak + 2 * pmacs / BF16
            row["bound_ms"] = max(gemm_bytes / BW, ops) * 1e3
            row["bound_by"] = ("bytes" if gemm_bytes / BW >= ops
                               else "operations")
            for t in ("ms", "dev_ms"):
                if row[t]:
                    row[f"{t[:-2]}tops"] = 2 * (macs + pmacs) / row[t] / 1e9
            if opts.parts:
                row.update({f"{k}_split_dev_ms": v for k, v in split_ms(
                    call, KERNELS[route]).items()})
                if route == "wgmma":
                    lay = tr.transition_dgrad_layout(n, h, w, cin, cout,
                                                     tile, ga is not None)
                    gslab, dslab = tr.dgrad_pre(gg, dres, lay)
                    parts = dict(
                        pre=lambda: tr.dgrad_pre(gg, dres, lay),
                        gemm=lambda: tr.dgrad_gemm(
                            gslab, dslab, ga, wd, ws_in, x, scale, shift,
                            bits, dres, wpt, thresh=thresh, lay=lay))
                    for part, fn in parts.items():
                        _timed(row, part, fn)
                    row.update(tiles=lay.tiles, cp=lay.cp,
                               slab_mb=(gslab.numel() * el
                                        + 2 * dslab.numel()) / 1e6)
                    # g and dres read, their slabs' live rows written
                    row["pre_bound_ms"] = (2 * (el + 2) * cout * n_out
                                           / BW * 1e3)
                    del gslab, dslab
                gemm = row.get("gemm_split_dev_ms")
                row["gemm_tops"] = (2 * (macs + pmacs) / gemm / 1e9
                                    if gemm else None)
            print(json.dumps(row), flush=True)
            acc = step.setdefault(body, {})
            for key, v in row.items():
                if key.endswith("ms") and v is not None:
                    acc[key] = acc.get(key, 0.0) + v
        del x, bits, g_q, gf, dres
        torch.cuda.empty_cache()
    print(json.dumps({"step_ms": step, "per": "lane step (both "
                      "transitions' dgrad: FQT + lane, or QAT + lane for "
                      "st)", "route": route, "repo": opts.repo or ".",
                      "card": name}), flush=True)
    if opts.others:
        others(fb, dev, g, name, opts.repo or ".")
    return 0


def others(fb, dev, g, name, repo):
    """The other users of the changed mainloop headers at each WRN-28-10
    stage, one line each, then their sums."""
    import torch

    from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3 as k
    from pytorch_ddp_resnet_tpu_torch.ops.cuda.conv3x3 import pack_weights

    thresh = fb.dropout_thresh(0.3)
    total = {}
    for c, h, w in STAGES:
        n = BATCH * h * w

        def rn(*shape, s=1.0):
            return torch.randn(*shape, device=dev, generator=g) * s

        x = rn(c, n).to(torch.bfloat16)
        scale, shift = rn(c).abs() + 0.5, rn(c, s=0.3)
        bits = torch.randint(0, 256, (c, n), device=dev, generator=g,
                             dtype=torch.uint8)
        wt = rn(c, c, 3, 3, s=(9 * c) ** -0.5)
        wq, ws = fb.quantize_pack_weights(wt)
        wpk = pack_weights(wt.to(torch.bfloat16))
        wdg = fb.pack_weights_dgrad(wt.to(torch.bfloat16))
        dy = rn(c, n, s=1e-3).to(torch.bfloat16)
        y = rn(c, n).to(torch.bfloat16)
        dysum, dyssq = rn(c, s=1e-4), rn(c, s=1e-4)
        x_q = torch.randint(-127, 128, (c, n), device=dev, generator=g,
                            dtype=torch.int8)
        rq_scale, rq_shift = rn(c).abs() * 1e-3, rn(c, s=0.1)
        ftile = fb.lane_tile(h, w, n, c, c)
        calls = dict(
            fwd_int8=lambda: fb.fwd_int8(
                x, wq, ws, scale, shift, bits, None, thresh=thresh,
                tile=ftile, h=h, w_img=w, want_stats=True),
            requant=lambda: k.conv3x3_int8_requant(
                x_q, wq, rq_scale, rq_shift, h=h, w_img=w,
                inv_out_scale=0.5),
            fwd_bf16=lambda: fb.fwd_bf16(
                x, wpk, scale, shift, bits, None, thresh=thresh, h=h,
                w_img=w, want_stats=True),
            dgrad_bf16=lambda: fb.dgrad_bf16(
                dy, y, dysum, dyssq, wdg, x, scale, shift, bits,
                thresh=thresh, h=h, w_img=w, emit_res=False))
        for key, fn in calls.items():
            row = dict(name=key, c=c, h=h, card=name)
            _timed(row, None, fn)
            print(json.dumps(row), flush=True)
            acc = total.setdefault(key, {})
            for t in ("ms", "dev_ms", "host_ms"):
                if row[t] is not None:
                    acc[t] = acc.get(t, 0.0) + row[t]
        del x, bits, dy, y, x_q
        torch.cuda.empty_cache()
    print(json.dumps({"others_ms": total, "per": "one call at each of the "
                      "three stages", "repo": repo, "card": name}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
