"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded with
``ctypes``. Nothing includes PyTorch's headers, so a build takes seconds.

Builds happen at first use, into ``_build/`` beside this file (listed in
``.gitignore``), from the sources in the checkout only. A library's file
name carries a hash of its source, of the shared headers ``csrc/*.cuh``
and of the flags, so an edited source or header is rebuilt and a stale
library is never loaded. ``build_all`` starts one
``nvcc`` per source at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional, Tuple

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels are compiled at first use on the machine with the card")


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str) -> Optional[Tuple[subprocess.Popen, str, str, str]]:
    """Start nvcc for one source unless its library is already built:
    (process, name, library path, temporary output path)."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    with open(f"{out}.log", "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, name, out, tmp


def _finish(proc: subprocess.Popen, name: str, out: str, tmp: str) -> None:
    rc = proc.wait()
    if rc != 0:
        with open(f"{out}.log") as f:
            raise RuntimeError(f"nvcc failed on {name}.cu (rc {rc}):\n"
                               f"{f.read()[-4000:]}")
    os.replace(tmp, out)


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the given sources (default: every csrc/*.cu) in parallel.
    Returns name -> library path."""
    if names is None:
        names = sorted(f[:-3] for f in os.listdir(CSRC_DIR)
                       if f.endswith(".cu"))
    names = list(names)
    with _lock:
        started = [b for b in (_start(n) for n in names) if b is not None]
        for build in started:
            _finish(*build)
    return {n: library_path(n) for n in names}


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers, shared memory, spills) for the
    current build of ``name``; empty if it was built by another process
    that left no log."""
    path = f"{library_path(name)}.log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = _libs.setdefault(name, ctypes.CDLL(path))
    return lib
