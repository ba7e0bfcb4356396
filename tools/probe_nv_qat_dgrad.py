"""Probe the port's bf16 NV input gradient on the ResNet-50 QAT train step:
10 steps of ``chip_smoke.py``'s phase-21 recipe (Synthetic 224x224 data,
batch 128, ``use_int8_train`` alone) three times from the same seed:

- ``kernel``: every ``dgrad_conv_bf16`` call of every step (300) held
  against ``dgrad_conv_bf16_plain`` on its live operands: the largest
  difference of dx, dres, d(s) and d(t) over the calls, relative to the
  largest value of the plain version's tensor, and whether every output is
  finite; and the losses;
- ``plain``: the losses with the plain version's dgrad in place of the
  kernels' (float64 products);
- ``kernel_lr_0.01``: the losses with the kernels at a tenth of the
  recipe's learning rate.

    python tools/probe_nv_qat_dgrad.py [--repo DIR]

``--repo`` imports the port (and its ``chip_smoke.py``) from another
checkout, an unpacked parent commit. Prints one JSON line with the card's
name and power limit. Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 10


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=None)
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.repo or REPO))
    import torch

    if not torch.cuda.is_available():
        print("probe_nv_qat_dgrad: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pytorch_ddp_resnet_tpu_torch.algos.steps import make_train_step
    from pytorch_ddp_resnet_tpu_torch.algos.train import setup
    from pytorch_ddp_resnet_tpu_torch.ops.cuda import bneck_nv_train as nvt
    from pytorch_ddp_resnet_tpu_torch.utils.rng import Key

    kernel = nvt.dgrad_conv_bf16
    errs = []

    def checked(*args, **kw):
        out = kernel(*args, **kw)
        ref = nvt.dgrad_conv_bf16_plain(*args, **kw)
        e = {}
        for name, got, want in zip(("dx", "ds", "dt", "dres"), out, ref):
            if want is None:
                continue
            top = want.double().abs().max().item()
            d = (got.double() - want.double()).abs().max().item()
            e[name] = d / top if top else d
            e["finite"] = e.get("finite", True) and bool(
                torch.isfinite(got).all())
        errs.append(e)
        return out

    def plain(*args, **kw):
        return nvt.dgrad_conv_bf16_plain(*args, **kw)

    def losses(dgrad, lr_scale, tag):
        nvt.dgrad_conv_bf16 = dgrad
        try:
            config = cs.write_run(
                tempfile.mkdtemp(), f"resnet-50-qat-{tag}", cs.R50_CONFIG,
                dataset_cls_name="Synthetic",
                dataset_args={"shape": [224, 224, 3], "num_classes": 1000,
                              "n_train": 1024, "n_test": 128},
                data_aug_train={"ToTensorTransform": {},
                                "FlipTransform": {"p": 0.5},
                                "StandardizeWhiteningTransform": {}},
                data_aug_test={"ToTensorTransform": {},
                               "StandardizeWhiteningTransform": {}},
                batch_size=cs.BATCH, use_int8_train=True)
            ls = setup(config, verbose=False)
            step = ls["pipeline"].bind_train_step(
                make_train_step(ls["model"], ls["optimizer"],
                                ls["num_microbatches"],
                                augment_fn=ls["augment_fn"]),
                pass_indices=ls["augment_pass_indices"])
            root = Key(config.get("seed", 0))
            feeds = [b for e in (0, 1) for _, b in
                     ls["pipeline"].train_feed(e)][:STEPS]
            lr = ls["scheduler"].get_lr() * lr_scale
            ts, out = ls["train_state"], []
            for gs in range(STEPS):
                ts, m = step(ts, *feeds[gs], lr, root.fold_in(gs))
                out.append(float(m["loss"]))
            return out
        finally:
            nvt.dgrad_conv_bf16 = kernel

    res = {"kernel": losses(checked, 1.0, "kernel")}
    res["calls_checked"] = len(errs)
    res["worst_rel_err"] = {
        k: max(e[k] for e in errs if k in e)
        for k in ("dx", "ds", "dt", "dres")}
    res["all_finite"] = all(e["finite"] for e in errs)
    res["plain"] = losses(plain, 1.0, "plain")
    res["kernel_lr_0.01"] = losses(kernel, 0.1, "lr")
    res["repo"] = opts.repo or "."
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
