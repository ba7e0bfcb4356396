"""Time the port's transition forward (``transition.fwd_conv``: the
prologue's quantization and the int8 stride-2 conv with its shortcut and
sums) on the card at WRN-28-10's two stage transitions (160 -> 320 at
32x32, 320 -> 640 at 16x16, batch 128), beside cuDNN's bf16 stride-2 3x3
conv plus the 1x1 stride-2 projection (channels-last) and the function's
bound.

    python tools/bench_transition_fwd.py [--repo DIR] [--parts]

``--repo`` imports the port from another checkout (an unpacked parent
commit, to compare two versions in one call: run parent, change, change,
parent); a checkout without the staged forward (no ``fwd_gemm``) is timed
as its fused-half quantizer then its ``fwd_conv``. ``--parts`` also times
the amax pass, the prepass and the mainloop + ordered sum apart
(checkouts that have them), each beside its byte or operation bound. Every
time is given by CUDA events (``*ms``: back-to-back calls, the wrappers'
host time included where the card waits on it) and in device time
(``*dev_ms``: the kernels' summed device time per call, torch.profiler).
Prints one JSON line per (stage, mode), then one line with the times of
the recipe's case (projection, dropout bits) summed over a lane step's two
transitions, beside cuDNN's, with the card's name and power limit. Needs a
CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from bench_nv_fwd_int8 import device_ms
from bench_nv_wgrad_bf16 import BF16, BW, REPO, time_ms

INT8 = 1979e12   # H100 SXM: dense int8 OP/s
# (stage, batch, h, w, Cin, Cout): WRN-28-10's stage transitions
SHAPES = [(2, 128, 32, 32, 160, 320), (3, 128, 16, 16, 320, 640)]
STEP_MODE = "proj+bits"   # the -hard-int8 recipe's case


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=None)
    ap.add_argument("--parts", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.repo or REPO))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bench_transition_fwd: no CUDA device", file=sys.stderr)
        return 1
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import transition as tr

    staged = hasattr(tr, "fwd_gemm")
    # as chip_smoke.py and the port's training setup run cuDNN
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    step = {}
    for stage, b, h, w, cin, cout in SHAPES:
        oh, ow = h // 2, w // 2
        n, n_out = b * h * w, b * oh * ow

        def rn(*shape, s=1.0):
            return torch.randn(*shape, device=dev, generator=g) * s

        x = rn(cin, n).to(torch.bfloat16)
        w1 = rn(cout, cin, 3, 3, s=(9 * cin) ** -0.5)
        wp = rn(cout, cin, s=cin ** -0.5).to(torch.bfloat16)
        scale, shift = rn(cin).abs() + 0.5, rn(cin, s=0.3)
        bits = tr.parity_unpack(torch.randint(
            0, 256, (4 * cin, n_out), device=dev, generator=g,
            dtype=torch.uint8), h, w)
        tile = tr.transition_tile(oh, ow, n_out, cin, cout)
        wq, ws = fb.quantize_pack_weights(w1)
        macs, pmacs = 9 * cin * cout * n_out, cin * cout * n_out
        cl = dict(memory_format=torch.channels_last)
        x4 = x.t().contiguous().view(b, h, w, cin).permute(0, 3, 1, 2)
        w4 = w1.to(torch.bfloat16).to(**cl)
        wp4 = wp.reshape(cout, cin, 1, 1).to(**cl)

        def cudnn():
            return (F.conv2d(x4, w4, stride=2, padding=1),
                    F.conv2d(x4, wp4, stride=2))

        cudnn_ms, cudnn_dev_ms = time_ms(cudnn), device_ms(cudnn)
        for mode in ("proj+bits", "proj", "optA+bits"):
            bits_ = bits if "bits" in mode else None
            wp_ = wp if mode.startswith("proj") else None
            th = fb.dropout_thresh(0.3) if bits_ is not None else None

            if staged:
                def fwd():
                    return tr.fwd_conv(x, scale, shift, bits_, wq, ws, wp_,
                                       thresh=th, tile=tile, h=h, w_img=w)
            else:
                def fwd():
                    d_q, amax = fb.fwd_quantize(x, scale, shift, bits_,
                                                thresh=th, tile=4 * tile)
                    return tr.fwd_conv(d_q, amax, wq, ws, x, wp_, tile=tile,
                                       h=h, w_img=w)

            xb = 2 * cin * n + (cin * n if bits_ is not None else 0)
            byts = (xb + 4 * cout * n_out + 9 * cin * cout
                    + (2 * cin * cout if wp_ is not None else 0))
            ops = 2 * macs / INT8 + (2 * pmacs / BF16 if wp_ is not None
                                     else 0)
            row = dict(stage=stage, cin=cin, cout=cout, h=h, w=w, batch=b,
                       mode=mode, staged=staged, ms=time_ms(fwd),
                       dev_ms=device_ms(fwd),
                       bound_ms=max(byts / BW, ops) * 1e3,
                       bound_by="bytes" if byts / BW >= ops else
                       "operations")
            if mode.startswith("proj"):
                row["cudnn_ms"], row["cudnn_dev_ms"] = cudnn_ms, cudnn_dev_ms
            if opts.parts and staged:
                lay = tr.transition_fwd_layout(n, h, w, cin, cout, tile)
                part = tr.fwd_amax(x, scale, shift, bits_, thresh=th,
                                   tile=tile)
                slab, ee, amax = tr.fwd_pre(x, scale, shift, bits_, part,
                                            thresh=th, lay=lay)
                parts = dict(
                    amax=lambda: tr.fwd_amax(x, scale, shift, bits_,
                                             thresh=th, tile=tile),
                    pre=lambda: tr.fwd_pre(x, scale, shift, bits_, part,
                                           thresh=th, lay=lay),
                    gemm=lambda: tr.fwd_gemm(slab, ee, amax, wq, ws, wp_,
                                             lay))
                for key, fn in parts.items():
                    row[f"{key}_ms"] = time_ms(fn)
                    row[f"{key}_dev_ms"] = device_ms(fn)
                # the bounds count what the function needs between the
                # parts: the int8 codes of d and the bf16 even-even plane,
                # unpadded (the slabs' pads are this design's)
                sb = slab.numel() + 2 * ee.numel()
                need = cin * n + 2 * cin * n // 4
                wb = 9 * cin * cout + (2 * cin * cout if wp_ is not None
                                       else 0)
                row["amax_bound_ms"] = xb / BW * 1e3
                row["pre_bound_ms"] = (xb + need) / BW * 1e3
                row["gemm_bound_ms"] = max(
                    (need + wb + 4 * cout * n_out) / BW, ops) * 1e3
                row["layout"] = dict(cp=lay.cp, bk=lay.bk, krow=lay.krow,
                                     cpb=lay.cpb,
                                     groups=lay.groups, tiles=lay.tiles,
                                     m_rows=lay.tiles * lay.bm,
                                     live_rows=n_out, slab_mb=sb / 1e6,
                                     need_mb=need / 1e6)
                del slab, ee
            print(json.dumps(row), flush=True)
            if mode == STEP_MODE:
                for key, v in row.items():
                    if key.endswith("_ms") or key == "ms":
                        step[key] = step.get(key, 0.0) + v
        del x, bits, x4
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"step_ms": step, "per": f"lane step ({STEP_MODE}, "
                      "both transitions)", "repo": opts.repo or ".",
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
