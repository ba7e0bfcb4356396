"""Time the port's lane-transition weight gradients on the card at WRN-28-10's
two stage transitions (160 -> 320 at 32x32, 320 -> 640 at 16x16, batch
128): the straight-through body (``transition.bwd_fold``, timed apart,
then ``wgrad_bf16`` and ``wgrad_proj``) and the FQT body's dW with dWp
(``wgrad`` on its quantizer's operands, and ``wgrad_proj``), beside
cuDNN's bf16 weight gradient of the stride-2 3x3 conv plus the 1x1
stride-2 projection's (channels-last) and the function's bound. Then
``conv3x3_same``'s wgrad (``conv3x3.conv3x3_wgrad``) at WRN-28-10's three
stages, the other user of the bf16 TMA mainloop.

    python tools/bench_transition_wgrad.py [--repo DIR] [--parts]

``--repo`` imports the port from another checkout (an unpacked parent
commit, to compare two versions in one call: run parent, change, change,
parent); each version's quantizer feeds its own ``wgrad`` (the FQT codes
as lanes or as parity planes), and a checkout whose fold writes
lane-order d (no ``TAP_TABLE``) is timed through its own signatures (dWp
from x). ``--parts`` also times each body's dW and dWp apart, each beside
its bound (the FQT dW's TOP/s as ``wgrad_tflops``), and the FQT body's
quantizer (``bwd_quantize``) beside its bound. Every time is given
by CUDA events (``*ms``: 10 back-to-back calls, the wrappers' host time
included where the card waits on it) and in device time (``*dev_ms``:
the kernels' summed device time per call, torch.profiler); TFLOP/s counts
the useful 2 * (9 + 1) * Cin * Cout * N' (dW and dWp; the fold
excluded). Prints one JSON line per
(stage, body), then one line with the times summed over a lane step's two
transitions for each body, beside cuDNN's, then one line per
``conv3x3_same`` stage and their sum; every line carries the card's
name and power limit. Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

from bench_nv_fwd_int8 import device_ms
from bench_nv_wgrad_bf16 import BF16, BW, REPO, time_ms

INT8 = 1979e12   # H100 SXM: dense int8 OP/s
# (stage, batch, h, w, Cin, Cout): WRN-28-10's stage transitions
SHAPES = [(2, 128, 32, 32, 160, 320), (3, 128, 16, 16, 320, 640)]
# (C, H = W) of conv3x3_same's wgrad at WRN-28-10's stages, batch 128
SAME_SHAPES = [(160, 32), (320, 16), (640, 8)]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=None)
    ap.add_argument("--parts", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.repo or REPO))
    import torch
    from torch.nn.grad import conv2d_weight

    if not torch.cuda.is_available():
        print("bench_transition_wgrad: no CUDA device", file=sys.stderr)
        return 1
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import transition as tr

    planes = hasattr(tr, "TAP_TABLE")
    # as chip_smoke.py and the port's training setup run cuDNN
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    name = card()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    step = {}
    for stage, b, h, w, cin, cout in SHAPES:
        oh, ow = h // 2, w // 2
        n, n_out = b * h * w, b * oh * ow
        geo = dict(h=h, w_img=w)

        def rn(*shape, s=1.0):
            return torch.randn(*shape, device=dev, generator=g) * s

        x = rn(cin, n).to(torch.bfloat16)
        scale, shift = rn(cin).abs() + 0.5, rn(cin, s=0.3)
        bits = tr.parity_unpack(torch.randint(
            0, 256, (4 * cin, n_out), device=dev, generator=g,
            dtype=torch.uint8), h, w)
        thresh = fb.dropout_thresh(0.3)
        dz = rn(cout, n_out, s=1e-3).to(torch.bfloat16)
        z = rn(cout, n_out).to(torch.bfloat16)
        dzsum, dzssq = rn(cout, s=1e-4), rn(cout, s=1e-4)
        dres = rn(cout, n_out, s=1e-3).to(torch.bfloat16)
        ct = (dz, z, dzsum, dzssq, x, scale, shift, bits)
        tile = tr.transition_tile(oh, ow, n_out, cin, cout)
        macs, pmacs = 9 * cin * cout * n_out, cin * cout * n_out
        # the forward's group absmax, where the quantizer takes it
        amax = ((tr.fwd_amax_plain(x, scale, shift, bits, thresh=thresh,
                                   tile=tile)[:, 0],) if "d_amax" in
                inspect.signature(tr.bwd_quantize).parameters else ())

        def fold():
            return tr.bwd_fold(*ct, thresh=thresh, **(geo if planes else {}))

        if planes:
            gb, db, xee = fold()
            qt = tr.bwd_quantize(*ct, *amax, thresh=thresh, tile=tile,
                                 **geo)
        else:
            (gb, db), xee = fold(), x
            qt = tr.bwd_quantize(*ct, thresh=thresh, tile=tile)
        g_q, g_amax, d_q, d_amax = qt[:4]
        dwp_in = qt[4] if planes else x

        def dw_bf16():
            return tr.wgrad_bf16(gb, db, **geo)

        def proj(x_in):
            return lambda: tr.wgrad_proj(dres, x_in, **geo)

        cl = dict(memory_format=torch.channels_last)
        x4 = x.t().contiguous().view(b, h, w, cin).permute(0, 3, 1, 2)
        dy4 = dz.t().contiguous().view(b, oh, ow, cout).permute(0, 3, 1, 2)
        x4, dy4 = x4.to(**cl), dy4.to(**cl)

        def cudnn():
            return (conv2d_weight(x4, (cout, cin, 3, 3), dy4, stride=2,
                                  padding=1),
                    conv2d_weight(x4, (cout, cin, 1, 1), dy4, stride=2))

        cudnn_ms, cudnn_dev_ms = time_ms(cudnn), device_ms(cudnn)
        bodies = dict(
            qat=(lambda: (dw_bf16(), proj(xee)()),
                 2 * macs / BF16,
                 # g, d, dres and x_ee in (as the fold writes them); dW
                 # and dWp out
                 4 * cout * n_out + 2 * cin * n + 2 * cin * n_out
                 + 40 * cin * cout),
            fqt=(lambda: (tr.wgrad(g_q, g_amax, d_q, d_amax, tile=tile,
                                   **geo), proj(dwp_in)()),
                 2 * macs / INT8,
                 # g_q and d_q in (their scales aside), dres, x_ee; out
                 cout * n_out + cin * n + 2 * cout * n_out
                 + 2 * cin * n_out + 40 * cin * cout))
        for body, (fn, ops3, byts) in bodies.items():
            ops = ops3 + 2 * pmacs / BF16
            row = dict(stage=stage, cin=cin, cout=cout, h=h, w=w, batch=b,
                       body=body, planes=planes, ms=time_ms(fn),
                       dev_ms=device_ms(fn), cudnn_ms=cudnn_ms,
                       cudnn_dev_ms=cudnn_dev_ms,
                       bound_ms=max(byts / BW, ops) * 1e3,
                       bound_by="bytes" if byts / BW >= ops else
                       "operations", card=name)
            if body == "qat":   # the fold, which this body runs first
                row["fold_ms"] = time_ms(fold)
                row["fold_dev_ms"] = device_ms(fold)
                # dz, z, x and the bits in, g, d and x_ee out
                row["fold_bound_ms"] = (6 * cout * n_out + 5 * cin * n
                                        + cin * n // 2) / BW * 1e3
            if opts.parts and body == "fqt":   # its quantizer
                def quant():
                    return tr.bwd_quantize(*ct, *amax, thresh=thresh,
                                           tile=tile,
                                           **(geo if planes else {}))

                row["quant_ms"] = time_ms(quant)
                row["quant_dev_ms"] = device_ms(quant)
                # dz, z, x and the bits in; g_q, d_q and x_ee out
                row["quant_bound_ms"] = (5 * cout * n_out + 4 * cin * n
                                         + cin * n // 2) / BW * 1e3
            if opts.parts:
                parts = dict(wgrad=dw_bf16, proj=proj(xee)) \
                    if body == "qat" else dict(
                        wgrad=lambda: tr.wgrad(g_q, g_amax, d_q, d_amax,
                                               tile=tile, **geo),
                        proj=proj(dwp_in))
                for key, part in parts.items():
                    row[f"{key}_ms"] = time_ms(part)
                    row[f"{key}_dev_ms"] = device_ms(part)
                el = 2 if body == "qat" else 1   # bf16 or int8 operands
                row["wgrad_bound_ms"] = max(
                    (el * (cout * n_out + cin * n) + 36 * cin * cout) / BW,
                    ops3) * 1e3
                row["proj_bound_ms"] = max(
                    (2 * cout * n_out + 2 * cin * n_out + 4 * cin * cout)
                    / BW, 2 * pmacs / BF16) * 1e3
                useful = {"wgrad": macs, "proj": pmacs}
                for key, work in useful.items():
                    for t in ("ms", "dev_ms"):
                        if row.get(f"{key}_{t}"):
                            row[f"{key}_{t[:-2]}tflops"] = (
                                2 * work / row[f"{key}_{t}"] / 1e9)
            for t in ("ms", "dev_ms"):
                if row[t]:
                    row[f"{t[:-2]}tflops"] = 2 * (macs + pmacs) / row[t] / 1e9
            if hasattr(tr, "wgrad_tma_plan") and body == "qat":
                row["plan"] = list(tr.wgrad_tma_plan(9, cin, cout, n_out, h,
                                                     w))
                row["proj_plan"] = list(tr.wgrad_tma_plan(1, cin, cout,
                                                          n_out, h, w))
            print(json.dumps(row), flush=True)
            acc = step.setdefault(body, {})
            for key, v in row.items():
                if key.endswith("ms") and v is not None:
                    acc[key] = acc.get(key, 0.0) + v
        del x, bits, gb, db, xee, qt, x4, dy4
        torch.cuda.empty_cache()
    print(json.dumps({"step_ms": step, "per": "lane step (both "
                      "transitions; dW + dWp, the fold apart)",
                      "repo": opts.repo or ".", "card": name}), flush=True)
    same_wgrad(name, opts.repo or ".")
    return 0


def same_wgrad(name: str, repo: str) -> None:
    """conv3x3_same's wgrad, x [C, N] and dy [C, N] bf16 at each WRN-28-10
    stage (batch 128): events and device time per call, and their sum."""
    import torch

    from pytorch_ddp_resnet_tpu_torch.ops.cuda import conv3x3 as k

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    total = {}
    for c, hw in SAME_SHAPES:
        n = 128 * hw * hw
        x = torch.randn(c, n, device=dev, generator=g).to(torch.bfloat16)
        dy = torch.randn(c, n, device=dev, generator=g).to(torch.bfloat16)

        def fn():
            return k.conv3x3_wgrad(x, dy, h=hw, w_img=hw)

        row = dict(same_wgrad_c=c, h=hw, ms=time_ms(fn), dev_ms=device_ms(fn),
                   card=name)
        print(json.dumps(row), flush=True)
        for key in ("ms", "dev_ms"):
            if row[key] is not None:
                total[key] = total.get(key, 0.0) + row[key]
        del x, dy
    print(json.dumps({"same_wgrad_ms": total, "per": "one call at each of "
                      "the three stages", "repo": repo, "card": name}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
