"""Where the lane transition's dgrad GEMM (csrc/transition.cu
``dgrad_kernel``) spends its time on the card: each variant is a copy of
the port under ``chip_smoke_probe/<variant>/`` (listed in .gitignore)
with one part of the kernel cut out, timed by kernel in device time at
WRN-28-10's two transitions (batch 128), both bodies, with the projection
and without (option A), as a lane step runs them.

    python tools/probe_transition_dgrad.py [--variants full,no_mask,...]

Variants:
- ``full``: the kernel as it is;
- ``no_mask``: the epilogue's mask pass over the units cut out (the
  mainloops, the staging of the two classes and the sums remain);
- ``no_mainloops``: the two class mainloops and the projection's cut out
  (the accumulators set from the thread index; the epilogue whole).

The cut variants compute wrong results: they only time. Prints one JSON
line per (variant, stage, body, shortcut) and one per variant with its
times summed over a lane step's two transitions, each with the card's
name and power limit. Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "pytorch_ddp_resnet_tpu_torch/ops/cuda/csrc/transition.cu"
MASK_LOOP = "  for (; c < cols; c += dc, u += du) {"
CLASS0 = ("  class_gemm<QUANT, REM>(mp, gp, a, 2 * ph, rows, ring, m0, n0, "
          "acc0);")
CLASS1 = ("  class_gemm<QUANT, REM>(mp, gp, a, 2 * ph + 1, rows + 4, ring, "
          "m0, n0,\n                         acc1);")
PROJ = ("    wb::mainloop<BN>(pp, wb::TapWalk<NoOff>{0, 1, 1, {}}, ring, m0, "
        "n0, acc);")
# variant -> (anchor, replacement) text edits of csrc/transition.cu
CUTS = {
    "full": (),
    "no_mask": ((MASK_LOOP, "  for (; c < 0 * cols; c += dc, u += du) {"),),
    "no_mainloops": (
        (CLASS0, "  for (int i = 0; i < BN / 2; ++i) acc0[i] = (Acc)(tid + i);"),
        (CLASS1, "  for (int i = 0; i < BN / 2; ++i) acc1[i] = (Acc)(tid + i);"),
        (PROJ, "")),
}
SHAPES = [(2, 32, 32, 160, 320), (3, 16, 16, 320, 640)]  # stage, H, W, Cin, Cout
KERNELS = {"pre": "dgrad_pre_kernel", "gemm": "dgrad_kernel<",
           "sum": "TransitionDgradSum"}


def make_variant(name: str) -> str:
    """A copy of the port with the variant's cuts: its directory."""
    root = os.path.join(REPO, "chip_smoke_probe", name)
    pkg = os.path.join(root, "pytorch_ddp_resnet_tpu_torch")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "pytorch_ddp_resnet_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(root, SRC)
    with open(path) as f:
        text = f.read()
    for anchor, repl in CUTS[name]:
        if anchor not in text:
            raise SystemExit(f"probe_transition_dgrad: {name}: the kernel no "
                             f"longer holds {anchor!r}")
        text = text.replace(anchor, repl)
    with open(path, "w") as f:
        f.write(text)
    return root


def run(name: str, root: str) -> int:
    """Time the variant in ``root`` (a process of its own: each variant
    is its own package)."""
    sys.path.insert(0, root)
    import torch

    from bench_fused_fwd_int8 import split_ms
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import fused_block as fb
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import transition as tr

    if not torch.cuda.is_available():
        print("probe_transition_dgrad: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(24)
    total = {}
    for stage, h, w, cin, cout in SHAPES:
        n, n_out = 128 * h * w, 32 * h * w

        def rn(*shape, s=1.0):
            return torch.randn(*shape, device=dev, generator=g) * s

        x = rn(cin, n).to(torch.bfloat16)
        scale, shift = rn(cin).abs() + 0.5, rn(cin, s=0.3)
        bits = torch.randint(0, 256, (cin, n), device=dev, generator=g,
                             dtype=torch.uint8)
        w1 = rn(cout, cin, 3, 3, s=(9 * cin) ** -0.5)
        wpt = rn(cin, cout, s=cin ** -0.5).to(torch.bfloat16)
        dres = rn(cout, n_out, s=1e-3).to(torch.bfloat16)
        gf = rn(cout, n_out, s=1e-3)
        tile = tr.transition_tile(h // 2, w // 2, n_out, cin, cout)
        g_q, g_amax = fb.quantize_groups_plain(gf, tile, fb.BWD_FLOOR)
        bodies = dict(
            fqt=(g_q, g_amax, *tr.quant_pack_w_dgrad(w1)),
            st=(gf.to(torch.bfloat16), None,
                tr.pack_w_dgrad(w1.to(torch.bfloat16)), None))
        for body, (gg, ga, wd, ws_in) in bodies.items():
            for shortcut, wp_ in (("proj", wpt), ("optA", None)):
                def call():
                    return tr.dgrad(gg, ga, wd, ws_in, x, scale, shift, bits,
                                    dres, wp_, thresh=fb.dropout_thresh(0.3),
                                    tile=tile, h=h, w_img=w)

                split = split_ms(call, KERNELS, reps=20)
                print(json.dumps(dict(variant=name, stage=stage, body=body,
                                      shortcut=shortcut, card=card,
                                      **{f"{k}_dev_ms": v
                                         for k, v in split.items()})),
                      flush=True)
                acc = total.setdefault(f"{body}+{shortcut}", {})
                for k, v in split.items():
                    acc[f"{k}_dev_ms"] = acc.get(f"{k}_dev_ms", 0.0) + v
        del x, bits, g_q, gf, dres
        torch.cuda.empty_cache()
    print(json.dumps({"variant": name, "step_dev_ms": total,
                      "per": "lane step (both transitions)", "card": card}),
          flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="full,no_mask,no_mainloops")
    ap.add_argument("--run", nargs=2, metavar=("NAME", "DIR"),
                    help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.run:
        return run(*opts.run)
    rc = 0
    for name in opts.variants.split(","):
        if name not in CUTS:
            raise SystemExit(f"probe_transition_dgrad: no variant {name!r}")
        root = make_variant(name)
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--run", name, root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
