"""Time the port's fused int8 block-half input gradient in fully quantized
training (``fused_block.bwd_quantize``, then ``dgrad_conv``: what one FQT
half's backward runs before its weight gradient) on the card at
WRN-28-10's three stage shapes (batch 128), beside cuDNN's bf16 input
gradient of the same 3x3 conv (channels-last) and the function's bound.

    python tools/bench_fused_dgrad_int8.py [--repo DIR] [--parts] [--others]

``--repo`` imports the port from another checkout (an unpacked parent
commit, to compare two versions in one call: run parent, change, change,
parent). The dgrad is what the checkout has: the amax pass and the
quantizer, then ``dgrad_int8_pre`` (g's codes copied into the padded
slab) and ``dgrad_int8_gemm`` (the s8 wgmma GEMM with its dequantizing,
masking epilogue, the tiles' ordered sum) or, before them, the row-tile
conv and its sum. ``--parts`` splits the function's device time by
kernel (``amax``, ``quant``, then ``pre``, ``gemm`` or ``conv``, and
``sum``), each beside its bound (the amax pass: dy, y where the stats
cotangents are folded, x and a bits tensor read; the quantizer: those
again, g_q and d_q written; the prepass: g_q read, the slab's live rows
written; the GEMM: its operations, or the codes, the weights, x, the
bits, dx and the sums once), and with the new route times the two
wrappers apart (``pre_*``, ``gemm_*``). Every time is a CUDA-event mean of
10 back-to-back calls (``*ms``), the kernels' summed device time per call
(``*dev_ms``, torch.profiler) and the host's time to issue one call
(``*host_ms``); ``dgrad_*`` times ``dgrad_conv`` alone on the quantizer's
codes. Rows: each stage as a block's first half (the stats cotangents, no
dropout) and its second (a bits tensor). Then one line with the times
summed over a FQT step's 22 dgrad calls. ``--others`` times the other
users of the code this rebuild moved (the int8 slab copy, now in
csrc/fused_half.cuh, and csrc/fused_block.cu): the int8 serving conv
(``conv3x3.conv3x3_int8_requant``), the lane transition's FQT dgrad
(``transition.dgrad``) and the fused int8 forward (``fwd_int8``), and the
fused bf16 dgrad (``dgrad_bf16``, csrc/dgrad_wgmma_bf16.cuh), one line each
and their sums. Every summary carries the card's name and power limit.
Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from bench_fused_fwd_int8 import _timed, split_ms
from bench_nv_fwd_int8 import INT8, device_ms
from bench_nv_wgrad_bf16 import BW, REPO, time_ms

BATCH = 128
STAGES = [(160, 32, 32), (320, 16, 16), (640, 8, 8)]   # (C, H, W)
# dgrad calls a FQT step by (C, stats cotangents): conv1 of the 10
# identity blocks folds the BatchNorm cotangents and has no dropout; the 12
# second halves (conv2 of every block) take a bits tensor
FQT_MIX = {(160, True): 4, (160, False): 4, (320, True): 3, (320, False): 4,
           (640, True): 3, (640, False): 4}
# the kernels of each route by name, for the device-time split
KERNELS = {"wgmma": {"amax": "amax_kernel", "quant": "quant_kernel",
                     "pre": "slab_copy_kernel", "gemm": "dgrad_s8_kernel",
                     "sum": "tile_sum_kernel"},
           "rows": {"amax": "amax_kernel", "quant": "quant_kernel",
                    "conv": "conv3x3_rows_kernel", "sum": "partial_sum"}}
# (h, w, Cin, Cout): WRN-28-10's stage transitions
TRANSITIONS = [(32, 32, 160, 320), (16, 16, 320, 640)]


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
        print("bench_fused_dgrad_int8: no CUDA device", file=sys.stderr)
        return 1
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb

    torch.backends.cudnn.allow_tf32 = False
    name = card()
    route = "wgmma" if hasattr(fb, "dgrad_int8_gemm") else "rows"
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(25)
    step = {}
    for c, h, w in STAGES:
        n = BATCH * h * w

        def rn(*shape, s=1.0):
            return torch.randn(*shape, device=dev, generator=g) * s

        x = rn(c, n).to(torch.bfloat16)
        wt = rn(c, c, 3, 3, s=(9 * c) ** -0.5)
        wdg, wsin = fb.quantize_pack_weights_dgrad(wt)
        scale, shift = rn(c).abs() + 0.5, rn(c, s=0.3)
        bits = torch.randint(0, 256, (c, n), device=dev, generator=g,
                             dtype=torch.uint8)
        dy = rn(c, n, s=1e-3).to(torch.bfloat16)
        y = rn(c, n).to(torch.bfloat16)
        dysum, dyssq = rn(c, s=1e-4), rn(c, s=1e-4)
        tile = fb.bwd_tile(h, w, n, c, c)
        cl = dict(memory_format=torch.channels_last)
        w4 = wt.to(torch.bfloat16).to(**cl)
        dy4 = rn(BATCH, c, h, w).to(torch.bfloat16).to(**cl)
        shape4 = (BATCH, c, h, w)

        def cudnn():
            return conv2d_input(shape4, w4, dy4, padding=1)

        cudnn_ms, cudnn_dev_ms = time_ms(cudnn), device_ms(cudnn)
        del dy4
        ops = 2 * 9 * c * c * n
        cn = c * n
        for stats in (True, False):
            cts = (y, dysum, dyssq) if stats else (None,) * 3
            drop = None if stats else bits
            thresh = None if stats else fb.dropout_thresh(0.3)
            qkw = dict(thresh=thresh, tile=tile, emit_res=False)
            dkw = dict(thresh=thresh, tile=tile, h=h, w_img=w)

            def call():
                g_q, g_amax = fb.bwd_quantize(dy, *cts, x, scale, shift,
                                              drop, **qkw)[:2]
                return fb.dgrad_conv(g_q, g_amax, wdg, wsin, x, scale,
                                     shift, drop, **dkw)

            g_q, g_amax = fb.bwd_quantize(dy, *cts, x, scale, shift, drop,
                                          **qkw)[:2]
            row = dict(route=route, c=c, h=h, w=w, n=n, stats=stats,
                       bits="none" if stats else "bits", cudnn_ms=cudnn_ms,
                       cudnn_dev_ms=cudnn_dev_ms, card=name)
            _timed(row, None, call)
            _timed(row, "dgrad", lambda: fb.dgrad_conv(
                g_q, g_amax, wdg, wsin, x, scale, shift, drop, **dkw))
            bits_b = 0 if stats else cn
            ins = 4 * cn + bits_b + (2 * cn + 8 * c if stats else 0)
            # dy (y, the stats cotangents), x, the bits, the weights read
            # once; dx, g_q and d_q (the wgrad's operands) written
            row["bound_ms"] = max((ins + 9 * c * c + 2 * cn + 2 * cn) / BW,
                                  ops / INT8) * 1e3
            row["bound_by"] = ("bytes" if (ins + 9 * c * c + 4 * cn) / BW
                               >= ops / INT8 else "operations")
            if opts.parts:
                row.update({f"{k}_split_dev_ms": v for k, v in split_ms(
                    call, KERNELS[route]).items()})
                if route == "wgmma":
                    plan = fb.fused_fwd_int8_plan(n, h, w, c, c)
                    slab = fb.dgrad_int8_pre(g_q, plan=plan)
                    _timed(row, "pre", lambda: fb.dgrad_int8_pre(
                        g_q, plan=plan))
                    _timed(row, "gemm", lambda: fb.dgrad_int8_gemm(
                        slab, g_amax, wdg, wsin, x, scale, shift, drop,
                        thresh=thresh, tile=tile, plan=plan))
                    row.update(bn=plan.bn, tiles=plan.lay.tiles,
                               slab_mb=slab.numel() / 1e6)
                    del slab
                row["amax_bound_ms"] = ins / BW * 1e3
                row["quant_bound_ms"] = (ins + 2 * cn) / BW * 1e3
                row["pre_bound_ms"] = 2 * cn / BW * 1e3
                row["gemm_bound_ms"] = max(
                    (cn + 9 * c * c + 4 * cn + bits_b + 8 * c) / BW,
                    ops / INT8) * 1e3
                gemm = row.get("gemm_split_dev_ms",
                               row.get("conv_split_dev_ms"))
                row["gemm_tops"] = ops / gemm / 1e9 if gemm else None
            print(json.dumps(row), flush=True)
            count = FQT_MIX[(c, stats)]
            for k, v in row.items():
                if k.endswith("ms") and v is not None:
                    step[k] = step.get(k, 0.0) + v * count
        del x, bits, dy, y, g_q
        torch.cuda.empty_cache()
    print(json.dumps({"fqt_step_ms": step, "per": "FQT step (22 dgrad "
                      "calls)", "route": route, "repo": opts.repo or ".",
                      "card": name}), flush=True)
    if opts.others:
        others(fb, dev, g, name, opts.repo or ".")
    return 0


def others(fb, dev, g, name, repo):
    """The other users of the moved code, one line each, then their sums:
    at each WRN-28-10 stage the int8 serving conv (int8 out), the fused
    int8 forward (a bits tensor, sums) and the fused bf16 dgrad (a bits
    tensor, stats); at both transitions the lane transition's FQT dgrad
    (projection, bits)."""
    import torch

    from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3 as k
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import transition as tr

    def rn(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=g) * s

    thresh = fb.dropout_thresh(0.3)
    total = {}

    def run(key, fn, **geo):
        row = dict(name=key, **geo, card=name)
        _timed(row, None, fn)
        print(json.dumps(row), flush=True)
        acc = total.setdefault(key, {})
        for t in ("ms", "dev_ms", "host_ms"):
            if row[t] is not None:
                acc[t] = acc.get(t, 0.0) + row[t]

    for c, h, w in STAGES:
        n = BATCH * h * w
        x = rn(c, n).to(torch.bfloat16)
        scale, shift = rn(c).abs() + 0.5, rn(c, s=0.3)
        bits = torch.randint(0, 256, (c, n), device=dev, generator=g,
                             dtype=torch.uint8)
        wt = rn(c, c, 3, 3, s=(9 * c) ** -0.5)
        wq, ws = fb.quantize_pack_weights(wt)
        wdg = fb.pack_weights_dgrad(wt.to(torch.bfloat16))
        dy = rn(c, n, s=1e-3).to(torch.bfloat16)
        y = rn(c, n).to(torch.bfloat16)
        dysum, dyssq = rn(c, s=1e-4), rn(c, s=1e-4)
        x_q = torch.randint(-127, 128, (c, n), device=dev, generator=g,
                            dtype=torch.int8)
        rq_scale, rq_shift = rn(c).abs() * 1e-3, rn(c, s=0.1)
        ftile = fb.lane_tile(h, w, n, c, c)
        run("requant", lambda: k.conv3x3_int8_requant(
            x_q, wq, rq_scale, rq_shift, h=h, w_img=w, inv_out_scale=0.5),
            c=c, h=h)
        run("fwd_int8", lambda: fb.fwd_int8(
            x, wq, ws, scale, shift, bits, None, thresh=thresh, tile=ftile,
            h=h, w_img=w, want_stats=True), c=c, h=h)
        run("dgrad_bf16", lambda: fb.dgrad_bf16(
            dy, y, dysum, dyssq, wdg, x, scale, shift, bits, thresh=thresh,
            h=h, w_img=w, emit_res=False), c=c, h=h)
        del x, bits, dy, y, x_q
        torch.cuda.empty_cache()
    for h, w, cin, cout in TRANSITIONS:
        oh, ow = h // 2, w // 2
        n, n_out = BATCH * h * w, BATCH * oh * ow
        x = rn(cin, n).to(torch.bfloat16)
        scale, shift = rn(cin).abs() + 0.5, rn(cin, s=0.3)
        bits = tr.parity_unpack(torch.randint(
            0, 256, (4 * cin, n_out), device=dev, generator=g,
            dtype=torch.uint8), h, w)
        w1 = rn(cout, cin, 3, 3, s=(9 * cin) ** -0.5)
        wpt = rn(cin, cout, s=cin ** -0.5).to(torch.bfloat16)
        dres = rn(cout, n_out, s=1e-3).to(torch.bfloat16)
        tile = tr.transition_tile(oh, ow, n_out, cin, cout)
        g_q, g_amax = fb.quantize_groups_plain(rn(cout, n_out, s=1e-3), tile,
                                               fb.BWD_FLOOR)
        wdq, wsin = tr.quant_pack_w_dgrad(w1)
        run("transition_dgrad", lambda: tr.dgrad(
            g_q, g_amax, wdq, wsin, x, scale, shift, bits, dres, wpt,
            thresh=thresh, tile=tile, h=h, w_img=w), cin=cin, h=h)
        del x, bits, g_q, dres
        torch.cuda.empty_cache()
    print(json.dumps({"others_ms": total, "per": "one call at each of the "
                      "three stages (transition_dgrad: at both "
                      "transitions)", "repo": repo, "card": name}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
