"""Time the port's lane-transition backward operand passes on the card at
WRN-28-10's two stage transitions (160 -> 320 at 32x32, 320 -> 640 at
16x16, batch 128), both bodies as a lane step runs them (the dropout bits
on): the FQT operands (``transition.bwd_quantize``: the folded cotangent's
and the activation's int8 codes, x's even-even plane) and the
straight-through fold (``transition.bwd_fold``), beside the bound of each.

    python tools/bench_transition_operands.py [--repo DIR] [--parts]

``--repo`` imports the port from another checkout (an unpacked parent
commit, to compare two versions in one call: run parent, change, change,
parent). ``--parts`` splits each pass's device time by kernel (the FQT
body: the amax pass ``amax`` where the checkout has one, the quantizer
``quant``; the fold ``fold``) and, where the checkout has it, also times
the fold with each output lane loading its own input pair (``lanes``, the
unit load of output rows off 8 pixels, which the FQT pass always takes),
checked equal to the default. Every time is a CUDA-event mean of 10 back-to-back
calls (``ms``), the kernels' device time per call from chip_smoke.py's
``kernel_split_ms`` (torch.profiler; ``dev_ms``, and ``<part>_dev_ms``)
and the host's time to issue one call (``host_ms``). The bound is the
bytes each pass must move (its operands read once, its outputs written
once) at 3.35 TB/s; ``share`` is the bound over the device time. Prints
one JSON line per (stage, body), then one line with the times summed over
a lane step's two transitions for each body (null where a transition's
time was not measured); every line carries the
card's name and power limit. Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys

from bench_fused_fwd_int8 import host_ms
from bench_nv_wgrad_bf16 import BW, REPO, time_ms

BATCH = 128
# (stage, h, w, Cin, Cout): WRN-28-10's stage transitions
SHAPES = [(2, 32, 32, 160, 320), (3, 16, 16, 320, 640)]
# the kernels of each pass by name, for the device-time split
PARTS = {"fqt": {"amax": "amax_kernel", "quant": "bwd_quant_kernel"},
         "st": {"fold": "bwd_fold_kernel"}}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def smoke():
    """This checkout's chip_smoke.py, loaded by path (the port may come
    from --repo)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=None)
    ap.add_argument("--parts", action="store_true")
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.repo or REPO))
    import torch

    if not torch.cuda.is_available():
        print("bench_transition_operands: no CUDA device", file=sys.stderr)
        return 1
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import transition as tr

    split_ms = smoke().kernel_split_ms
    name = card()
    params = inspect.signature(tr.bwd_quantize).parameters
    takes_amax = "d_amax" in params
    routes = hasattr(tr, "_fold_rows")
    parts = {body: dict(kern) for body, kern in PARTS.items()}
    if takes_amax:   # the forward's absmax: no amax pass to time
        del parts["fqt"]["amax"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
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
        tile = tr.transition_tile(oh, ow, n_out, cin, cout)
        ct = (rn(cout, n_out, s=1e-3).to(torch.bfloat16),
              rn(cout, n_out).to(torch.bfloat16), rn(cout, s=1e-4),
              rn(cout, s=1e-4), x, scale, shift, bits)
        kw = dict(thresh=thresh, h=h, w_img=w)
        amax = ()
        if takes_amax:   # the forward's group absmax, from its kernels
            lay = tr.transition_fwd_layout(n, h, w, cin, cout, tile)
            amax = (tr.fwd_pre(x, scale, shift, bits, tr.fwd_amax(
                x, scale, shift, bits, thresh=thresh, tile=tile),
                thresh=thresh, lay=lay)[2],)

        def fqt():
            return tr.bwd_quantize(*ct, *amax, tile=tile, **kw)

        def st(rows=None):
            tr._fold_rows = rows
            try:
                return tr.bwd_fold(*ct, **kw)
            finally:
                tr._fold_rows = None

        # each operand read once, each output written once
        byts = dict(fqt=4 * cout * n_out + 3 * cin * n + cout * n_out
                    + cin * n + cin * n // 2,
                    st=6 * cout * n_out + 5 * cin * n + cin * n // 2)
        for body, call in (("fqt", fqt), ("st", st)):
            row = dict(stage=stage, cin=cin, cout=cout, h=h, w=w,
                       batch=BATCH, tile=tile, body=body, card=name,
                       repo=opts.repo or ".")
            row["ms"] = time_ms(call)
            row["host_ms"] = host_ms(call)
            keys = list(parts[body].values())
            split = split_ms(call, 10, keys, need=keys)
            row["dev_ms"] = sum(split.values()) if split else None
            row["bound_ms"] = byts[body] / BW * 1e3
            row["bound_mb"] = byts[body] / 1e6
            row["share"] = (row["bound_ms"] / row["dev_ms"]
                            if row["dev_ms"] else None)
            if opts.parts:
                if split:
                    row.update({f"{part}_dev_ms": split[key]
                                for part, key in parts[body].items()})
                if routes and body == "st":   # a pair a lane
                    base = call()
                    for a, b_ in zip(call(False), base):
                        assert torch.equal(a, b_), (stage, body, "lanes")
                    row["lanes_ms"] = time_ms(lambda: call(False))
                    vs = split_ms(lambda: call(False), 10, keys, need=keys)
                    row["lanes_dev_ms"] = sum(vs.values()) if vs else None
                    del base
            print(json.dumps(row), flush=True)
            acc = step.setdefault(body, {})
            for key, v in row.items():   # None where a stage has none
                if key.endswith("ms"):
                    prev = acc.get(key, 0.0)
                    acc[key] = None if prev is None or v is None else prev + v
        del x, bits, ct, amax
        torch.cuda.empty_cache()
    for acc in step.values():
        if acc.get("dev_ms"):
            acc["share"] = acc["bound_ms"] / acc["dev_ms"]
    print(json.dumps({"step_ms": step, "per": "lane step (both "
                      "transitions' operand passes: FQT + lane for fqt, QAT "
                      "+ lane for st)", "repo": opts.repo or ".",
                      "card": name}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
