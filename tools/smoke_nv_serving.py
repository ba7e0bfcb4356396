"""Run ``chip_smoke.py``'s phases 8 and 9 alone, with their summary: the NV
serving blocks against their plain versions at every ResNet-50 stage shape
(each block's three launches apart in device time), then full-width
ResNet-50 served through ``load_predictor`` in float and int8 (launches
per batch, logits equal to the plain walk, img/s, the profiled batch).

    python tools/smoke_nv_serving.py [--repo DIR]

``--repo`` runs another checkout's port and ``chip_smoke.py`` (an unpacked
parent commit, for its serving img/s in the same call). Prints the card's
name and power limit, one JSON line per kernel row, the serving phase's
results and the per-batch summary. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=REPO)
    root = os.path.abspath(ap.parse_args().repo)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("smoke_nv_serving: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    rows = cs.nv_kernel_phase(cs.card_peaks(torch.cuda.get_device_name(0)))
    for r in rows:
        print(json.dumps({k: r[k] for k in (
            "name", "h", "cin", "wdt", "cout", "stride", "out_int8", "ms",
            "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")
            + cs.NV_ID_ROW_KEYS if k in r}), flush=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=root)
    try:
        serving = cs.bneck_serving_phase(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({k: v for k, v in serving.items() if k != "shapes"},
                     default=str), flush=True)
    print(json.dumps(cs.nv_summary(rows, serving), default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
