"""Time the port's fused bf16 block-half input gradient
(``fused_block.dgrad_bf16``) on the card at WRN-28-10's three stage shapes
(batch 128), beside cuDNN's bf16 input gradient of the same 3x3 conv
(channels-last) and the function's bound.

    python tools/bench_fused_dgrad_bf16.py [--repo DIR] [--parts]

``--repo`` imports the port from another checkout (an unpacked parent
commit, to compare two versions in one call: run parent, change, change,
parent). The dgrad is what the checkout has: ``dgrad_bf16_pre`` then
``dgrad_bf16_gemm`` (the prepass into the padded slab, the wgmma GEMM with
its masking epilogue, the tiles' ordered sum) or, before them, the one
row-tile launch and its sum. ``--parts`` splits the call's device time by
kernel (``prepass``, ``gemm`` or ``conv``, ``sum``) and, with the new
route, times the two wrappers apart (``pre``: the prepass; ``gemm``: the
GEMM and the sum), each beside its bound (``pre_bound_ms``: dy, y and the
stats cotangents in, g unpadded and dres out; ``gemm_bound_ms``: the
contraction's operations, or g, the weights, x, the bits, dx and the sums
once). Every time is a CUDA-event mean of back-to-back calls, as
``*_dev_ms`` the kernels' summed device time per call (torch.profiler),
and as ``*_host_ms`` the host's time to issue one call (the wrappers'
checks, allocations and launches; see bench_fused_fwd_int8.py
``host_ms``). Rows: each stage in the bits modes (a [C, N] uint8 tensor,
a seed), as a block's first half (the stats cotangents, no residual) and
its second (a residual: dy alone). Then one line with the times summed
over the dgrad calls of a QAT + in-kernel dropout step (22 halves) and of
a fused bf16 step (8 halves at C = 160, a bits tensor), and the card's
name and power limit. Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from bench_fused_fwd_int8 import _timed, split_ms
from bench_nv_fwd_int8 import device_ms
from bench_nv_wgrad_bf16 import BF16, BW, REPO, time_ms

BATCH = 128
STAGES = [(160, 32, 32), (320, 16, 16), (640, 8, 8)]   # (C, H, W)
F32 = 67e12   # H100 SXM f32 FLOP/s outside the tensor cores
# dgrad calls a step by (C, stats cotangents, bits mode): the QAT step's 22
# halves (conv1 of the 10 identity blocks folds the BatchNorm cotangents;
# in-kernel dropout from a seed at C <= 320), the fused bf16 step's 8
# (stage 1, a bits tensor)
QAT_MIX = {(160, True, "seed"): 4, (160, False, "seed"): 4,
           (320, True, "seed"): 3, (320, False, "seed"): 4,
           (640, True, "bits"): 3, (640, False, "bits"): 4}
FUSED_MIX = {(160, True, "bits"): 4, (160, False, "bits"): 4}
# the kernels of each route by name, for the device-time split
KERNELS = {"new": {"prepass": "fused_dgrad_pre", "gemm": "fused_dgrad_gemm",
                   "sum": "FusedDgrad"},
           "old": {"conv": "conv3x3_rows_kernel", "sum": "partial_sum"}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=None)
    ap.add_argument("--parts", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.repo or REPO))
    import torch
    from torch.nn.grad import conv2d_input

    if not torch.cuda.is_available():
        print("bench_fused_dgrad_bf16: no CUDA device", file=sys.stderr)
        return 1
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(22)
    route = "new" if hasattr(fb, "dgrad_bf16_gemm") else "old"
    steps = {"qat_step_ms": {}, "fused_step_ms": {}}
    for c, h, w in STAGES:
        n = BATCH * h * w

        def rn(*shape, s=1.0):
            return torch.randn(*shape, device=dev, generator=g) * s

        x = rn(c, n).to(torch.bfloat16)
        wt = rn(c, c, 3, 3, s=(9 * c) ** -0.5)
        wdg = fb.pack_weights_dgrad(wt.to(torch.bfloat16))
        scale, shift = rn(c).abs() + 0.5, rn(c, s=0.3)
        thresh = fb.dropout_thresh(0.3)
        dy = rn(c, n, s=1e-3).to(torch.bfloat16)
        y = rn(c, n).to(torch.bfloat16)
        dysum, dyssq = rn(c, s=1e-4), rn(c, s=1e-4)
        drops = {"bits": torch.randint(0, 256, (c, n), device=dev,
                                       generator=g, dtype=torch.uint8),
                 "seed": torch.tensor(-1234567, dtype=torch.int32,
                                      device=dev)}
        cl = dict(memory_format=torch.channels_last)
        w4 = wt.to(torch.bfloat16).to(**cl)
        dy4 = rn(BATCH, c, h, w).to(torch.bfloat16).to(**cl)
        shape4 = (BATCH, c, h, w)

        def cudnn():
            return conv2d_input(shape4, w4, dy4, padding=1)

        cudnn_ms, cudnn_dev_ms = time_ms(cudnn), device_ms(cudnn)
        del dy4
        ops = 2 * 9 * c * c * n
        for kind, bits in drops.items():
            bits_b = c * n if kind == "bits" else 0
            for stats in (True, False):
                cts = (y, dysum, dyssq) if stats else (None,) * 3
                args = (dy, *cts, wdg, x, scale, shift, bits)
                kw = dict(thresh=thresh, h=h, w_img=w, emit_res=False)

                def call():
                    return fb.dgrad_bf16(*args, **kw)

                row = dict(route=route, c=c, h=h, w=w, n=n, mode=kind,
                           stats=stats, cudnn_ms=cudnn_ms,
                           cudnn_dev_ms=cudnn_dev_ms)
                _timed(row, None, call)
                # dy (y and the stats cotangents), the weights, x, the bits,
                # scale and shift read once; dx and the two sums written
                ct_b = 2 * c * n + 8 * c if stats else 0
                row["bound_ms"] = max(
                    (6 * c * n + 18 * c * c + 16 * c + bits_b + ct_b) / BW,
                    ops / BF16) * 1e3
                if opts.parts:
                    row.update({f"{k}_split_dev_ms": v for k, v in split_ms(
                        call, KERNELS[route]).items()})
                    if route == "new":
                        lay = fb.fused_fwd_layout(n, h, w, c, c)
                        slab, _ = fb.dgrad_bf16_pre(dy, *cts, lay=lay,
                                                    emit_res=False)
                        parts = dict(
                            pre=lambda: fb.dgrad_bf16_pre(
                                dy, *cts, lay=lay, emit_res=False),
                            gemm=lambda: fb.dgrad_bf16_gemm(
                                slab, wdg, x, scale, shift, bits,
                                thresh=thresh, lay=lay))
                        for part, fn in parts.items():
                            _timed(row, part, fn)
                        row.update(bn=lay.bn, tiles=lay.tiles)
                        del slab
                    row["pre_bound_ms"] = max(
                        (4 * c * n + ct_b) / BW, 3 * c * n / F32) * 1e3
                    row["gemm_bound_ms"] = max(
                        (6 * c * n + 18 * c * c + 16 * c + bits_b) / BW,
                        ops / BF16) * 1e3
                    gemm = row.get("gemm_split_dev_ms",
                                   row.get("conv_split_dev_ms"))
                    row["gemm_tflops"] = ops / gemm / 1e9 if gemm else None
                print(json.dumps(row), flush=True)
                for key, mix in (("qat_step_ms", QAT_MIX),
                                 ("fused_step_ms", FUSED_MIX)):
                    count = mix.get((c, stats, kind), 0)
                    for k, v in row.items():
                        if count and k.endswith("ms") and v is not None:
                            steps[key][k] = steps[key].get(k, 0.0) + v * count
        del x, dy, y, drops
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({**steps, "route": route, "repo": opts.repo or ".",
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
