"""The port's CUDA sources ship whole: ``setup.py build_py`` into a scratch
directory, then every ``#include "..."`` of every shipped ``csrc/*.cu`` and
``csrc/*.cuh`` names a file that the built ``csrc/`` holds (the kernels
compile at first use, from the installed package's own sources)."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_setup_py_ships_every_header_the_kernels_include(tmp_path):
    subprocess.run([sys.executable, "setup.py", "-q", "build_py",
                    "--build-lib", str(tmp_path)], cwd=REPO, check=True,
                   capture_output=True)
    csrc = tmp_path / "pytorch_ddp_resnet_tpu_torch" / "ops" / "cuda" / "csrc"
    shipped = sorted(p.name for p in csrc.iterdir())
    sources = [f for f in shipped if f.endswith((".cu", ".cuh"))]
    in_repo = sorted(f for f in os.listdir(os.path.join(
        REPO, "pytorch_ddp_resnet_tpu_torch", "ops", "cuda", "csrc"))
        if f.endswith((".cu", ".cuh")))
    assert sources == in_repo
    includes = set()
    for name in sources:
        text = (csrc / name).read_text()
        includes.update(re.findall(r'^\s*#include\s+"([^"]+)"', text, re.M))
    assert includes, "no local header included: the check would be empty"
    missing = sorted(h for h in includes if not (csrc / h).is_file())
    assert not missing, missing
