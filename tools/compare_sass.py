"""Build the named kernel libraries in two checkouts of the repo and
compare their SASS (``cuobjdump -sass``) kernel by kernel: which kernels
only one build has, which are the same instruction for instruction, which
differ only in the offsets of their kernel parameters (``c[0x0][...]``:
an argument struct that changed its layout), which only changed their
name (the same code under a new symbol), and which differ (with their
first differing lines). Names in an anonymous namespace carry two
hashes (``_GLOBAL__N__<hash>_<len>_<file>_cu_<hash>``) that differ
between builds; both are masked before comparing, in the kernels' names
and in their code (a kernel whose code names its own shared memory or a
sibling carries them there too).

Run on a machine with the CUDA toolkit, from the root of one checkout:

    python tools/compare_sass.py [--time-builds] PARENT_DIR . conv3x3 transition

``--time-builds`` first builds each library of each checkout alone, one
after another, and prints its seconds (a library already built is
reported as cached). Prints one line per library and ends with a JSON
object of the counts.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

_HASH = re.compile(r"_GLOBAL__N__[0-9a-f]+_(\d+_\w+?_cu)_[0-9a-f]{8}")
_PARAM = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]")
_ENCODING = re.compile(r"/\* 0x[0-9a-f]{16} \*/")


def build(root: str, names):
    """Library paths of ``names`` built from the checkout at ``root`` (a
    process of its own, so that the two checkouts' modules do not mix)."""
    code = ("import sys; sys.path.insert(0, %r); "
            "from pytorch_ddp_resnet_tpu_torch.ops.cuda import build; "
            "print(repr(build.build_all(%r)))") % (os.path.abspath(root),
                                                   list(names))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    return eval(out.strip().splitlines()[-1])


def time_builds(root: str, names) -> dict:
    """Seconds to build each of ``names`` alone from the checkout at
    ``root`` (None where the library was already built)."""
    out = {}
    for name in names:
        code = ("import os, sys; sys.path.insert(0, %r); "
                "from pytorch_ddp_resnet_tpu_torch.ops.cuda import build; "
                "print(os.path.exists(build.library_path(%r))); "
                "build.build_all([%r])") % (os.path.abspath(root), name, name)
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, check=True)
        cached = res.stdout.split()[0] == "True"
        out[name] = None if cached else round(time.perf_counter() - t0, 1)
    return out


def _masked(lines):
    """The lines with every kernel-parameter offset and every encoding
    word masked."""
    return [_ENCODING.sub("", _PARAM.sub("c[0x0][P]", x)).strip()
            for x in lines]


def kernels(path: str, cuobjdump: str) -> dict:
    """Kernel name (hash masked) -> its SASS lines (hash masked)."""
    text = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        line = _HASH.sub(r"_GLOBAL__N__X_\1_H", line)
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            out[name] = []
        elif name is not None and line.strip():
            out[name].append(line.strip())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", help="the first checkout (say, the parent)")
    ap.add_argument("b", help="the second checkout")
    ap.add_argument("names", nargs="+", help="csrc/<name>.cu libraries")
    ap.add_argument("--time-builds", action="store_true")
    args = ap.parse_args()
    cuobjdump = (shutil.which("cuobjdump")
                 or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                 "bin", "cuobjdump"))
    if args.time_builds:
        for root in (args.a, args.b):
            print(json.dumps({"build_s": time_builds(root, args.names),
                              "tree": root}), flush=True)
    libs_a, libs_b = build(args.a, args.names), build(args.b, args.names)
    summary = {}
    for name in args.names:
        ka, kb = kernels(libs_a[name], cuobjdump), kernels(libs_b[name],
                                                         cuobjdump)
        same = sorted(k for k in ka if k in kb and ka[k] == kb[k])
        both = [k for k in ka if k in kb and ka[k] != kb[k]]
        params = sorted(k for k in both
                        if _masked(ka[k]) == _masked(kb[k]))
        differ = sorted(k for k in both if k not in params)
        only_a = sorted(set(ka) - set(kb))
        only_b = sorted(set(kb) - set(ka))
        renamed = [(a, b) for a in only_a for b in only_b if ka[a] == kb[b]]
        only_a = [k for k in only_a if k not in {a for a, _ in renamed}]
        only_b = [k for k in only_b if k not in {b for _, b in renamed}]
        summary[name] = dict(same=len(same), params=len(params),
                             renamed=len(renamed), differ=len(differ),
                             only_a=len(only_a), only_b=len(only_b))
        print(f"{name}: {len(same)} kernels the same, {len(params)} the "
              f"same but for parameter offsets, {len(renamed)} the same "
              f"under a new name, {len(differ)} differ, {len(only_a)} only "
              f"in a, {len(only_b)} only in b", flush=True)
        for k in params:
            first = next(i for i, (x, y) in enumerate(zip(ka[k], kb[k]))
                         if x != y)
            print(f"  parameter offsets: {k[:160]} (first at line {first})")
            print(f"    a: {ka[k][first][:140]}\n    b: {kb[k][first][:140]}")
        for a, b in renamed:
            print(f"  renamed: {a[:120]}\n        -> {b[:120]}")
        for k in only_a:
            print(f"  only in a: {k[:160]}")
        for k in only_b:
            print(f"  only in b: {k[:160]}")
        for k in differ:
            la, lb = ka[k], kb[k]
            first = next((i for i, (x, y) in enumerate(zip(la, lb))
                          if x != y), min(len(la), len(lb)))
            print(f"  differs: {k[:160]} ({len(la)} vs {len(lb)} lines, "
                  f"first at line {first})")
            for x, y in list(zip(la, lb))[first:first + 3]:
                print(f"    a: {x[:140]}\n    b: {y[:140]}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
