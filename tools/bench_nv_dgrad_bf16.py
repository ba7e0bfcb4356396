"""Time the port's bf16 NV input gradient (``bneck_nv_train.dgrad_conv_bf16``,
the QAT body) on the card at ResNet-50's NV training geometries, beside
cuDNN's bf16 input gradient of the same conv (channels-last) and the
function's bound.

    python tools/bench_nv_dgrad_bf16.py [--repo DIR] [--parts]

``--repo`` imports the port from another checkout (an unpacked parent
commit, to compare two versions in one call: run parent, change, change,
parent). Each time is given three ways: CUDA events around back-to-back
calls (``*_ms``), the kernels' summed device time per call (``*_dev_ms``,
torch.profiler) and the host's time to issue one call (``*_host_ms``).
``--parts`` also times the parts apart in checkouts that have them
(``dgrad_bf16_pre``, ``dgrad_bf16_gemm``), each beside its byte or
operation bound: the prepass (``pre``), the GEMM (``gemm``, its device time
without the sum) and the tiles' sum (``sum``); each part's bytes count
what the function needs (the slab as its values, ``FwdInt8Layout.codes``
bf16 elements, not its pads). Prints one JSON line per (geometry, half),
then one line with the times summed over the 30 halves of a ResNet-50 QAT
step at batch 128 (stage 4 at batch 64 is timed, not summed: the gate
shuts it at 128) and the card's name and power limit. Needs a CUDA card;
exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from bench_fused_fwd_int8 import host_ms
from bench_nv_dgrad_int8 import _timed, device_split
from bench_nv_wgrad_bf16 import BF16, BW, GEOMETRIES, REPO, halves, time_ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=None)
    ap.add_argument("--parts", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.repo or REPO))
    import torch
    from torch.nn.grad import conv2d_input

    if not torch.cuda.is_available():
        print("bench_nv_dgrad_bf16: no CUDA device", file=sys.stderr)
        return 1
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv_train as nvt
    from pytorch_ddp_resnet_tpu_torch.ops.cuda.checks import check_rc

    staged = hasattr(nvt, "dgrad_bf16_pre")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    step = {}
    for n, h, w, cin, cb, cout, blocks in GEOMETRIES:
        p = n * h * w
        for conv, mode, ci, co, per_step in halves(cin, cb, cout, blocks):
            k = 3 if conv == "3x3" else 1
            taps = k * k
            entry, affine = mode == "entry", mode != "identity"

            def rn(*shape, s=1.0):
                return torch.randn(*shape, device=dev, generator=g) * s

            x = rn(n, h, w, ci).to(torch.bfloat16)
            x = x.abs() if mode == "identity" else x
            s = rn(ci, s=0.5) + 1.0 if affine else None
            t = rn(ci, s=0.2) if affine else None
            res = rn(n, h, w, ci).to(torch.bfloat16) if entry else None
            dxout = (rn(n, h, w, ci, s=1e-3).to(torch.bfloat16) if entry
                     else None)
            dy = rn(n, h, w, co, s=1e-3).to(torch.bfloat16)
            y = rn(n, h, w, co).to(torch.bfloat16)
            dzsum, dzssq = rn(co, s=1e-4), rn(co, s=1e-5)
            wt = rn(co, ci, k, k, s=(taps * ci) ** -0.5)
            wdg = nvt.pack_w_bf16_dgrad(wt)
            rch = nvt.pick_chunk_rows(h, w, n, ci, co, conv, mode)[1]
            cts = (dy, y, dzsum, dzssq)
            rest = (wdg, x, s, t, res, dxout)

            def dgrad():
                return nvt.dgrad_conv_bf16(*cts, *rest, conv=conv,
                                           mode=mode, rch=rch)

            row = dict(n=n, h=h, conv=conv, mode=mode, cin=ci, cout=co,
                       rch=rch, per_step=per_step)
            _timed(row, None, dgrad)
            x4 = x.permute(0, 3, 1, 2)          # channels-last views
            dy4 = dy.permute(0, 3, 1, 2)
            w4 = wt.to(torch.bfloat16).to(memory_format=torch.channels_last)

            def cudnn():
                return conv2d_input(x4.shape, w4, dy4, padding=k // 2)

            row["cudnn_ms"] = time_ms(cudnn)
            row["cudnn_dev_ms"] = device_split(cudnn)[0]
            cot = 4 * p * co                     # dy and y in
            act = 2 * p * ci * ((1 if affine else 0) + (2 if entry else 0))
            out = 2 * p * ci * (2 if entry else 1)   # dx (and dres) out
            ops = 2 * p * taps * ci * co / BF16
            wb = 2 * taps * ci * co
            row["bound_ms"] = max((cot + wb + act + out) / BW, ops) * 1e3
            if opts.parts and staged:
                lay = nvt.dgrad_bf16_layout(n, h, w, co, taps)
                vals = 2 * lay.codes             # the slab's values
                slab = nvt.dgrad_bf16_pre(*cts, conv=conv)
                _timed(row, "pre", lambda: nvt.dgrad_bf16_pre(*cts,
                                                               conv=conv))

                def gemm():
                    return nvt.dgrad_bf16_gemm(slab, *rest, lay, mode=mode)

                row["gemm_ms"] = time_ms(gemm)
                dev_all, dev_sum = device_split(gemm)
                row["gemm_dev_ms"] = dev_all - dev_sum
                row["gemm_host_ms"] = host_ms(gemm)
                row["pre_bound_ms"] = (cot + vals) / BW * 1e3
                row["gemm_bound_ms"] = max(
                    (vals + wb + act + out) / BW, ops) * 1e3
                row["gemm_tflops"] = (2 * p * taps * ci * co
                                      / row["gemm_dev_ms"] / 1e9)
                if affine:
                    part = torch.zeros((lay.tiles, 2 * ci), device=dev)
                    sums = torch.empty(2 * ci, device=dev)
                    lib = nvt._library()

                    def tile_sum():
                        check_rc("nv_half_dgrad_bf16.sum",
                                 lib.nvt_dgrad_bf16_sum_launch(
                                     part.data_ptr(), sums.data_ptr(),
                                     lay.tiles, 2 * ci,
                                     torch.cuda.current_stream().cuda_stream))

                    _timed(row, "sum", tile_sum)
                    row["sum_bound_ms"] = (part.numel() + sums.numel()) \
                        * 4 / BW * 1e3
                row["layout"] = dict(cp=lay.cp, tiles=lay.tiles,
                                     bn=nvt.dgrad_tile(ci),
                                     slab_mb=slab.numel() * 2 / 1e6)
                del slab
            print(json.dumps(row), flush=True)
            for key, v in row.items():
                if key == "ms" or "_ms" in key:
                    step[key] = step.get(key, 0.0) + v * per_step
            del x, res, dy, y, dxout
            torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"step_ms": step, "repo": opts.repo or ".",
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
