"""Checkpoint files (counterpart of pytorch_ddp_resnet_tpu/utils/
checkpoint.py: reading, and the single-file write that fitted transforms
use; manifests, retention GC and the async writer wait for ROADMAP.md
Queue 1 item 4).

The JAX package writes one ``{kind}_{steps}.ckpt`` per kind and step in a
flat checkpoint directory: an ``.npz`` of the flattened pytree with
'/'-joined path keys (``params/00_conv/w``, ``model_state/...``). These
functions find the newest step of a kind and read its file back as a
nested dict of numpy arrays, so the port serves a run directory that the
JAX package trained.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

CKPT_SUFFIX = "ckpt"
_NAME_RE = re.compile(r"(\w+)_([0-9]+)\.([a-z]+)$")


def format_name(kind: str, steps: int, suffix: str = CKPT_SUFFIX) -> str:
    return f"{kind}_{steps}.{suffix}"


def parse_name(filename: str) -> Optional[Dict[str, Any]]:
    m = _NAME_RE.match(filename)
    if m is None:
        return None
    return {"kind": m.group(1), "steps": int(m.group(2)),
            "suffix": m.group(3)}


def latest_step(checkpoint_dir: str, kind: str) -> Optional[int]:
    """Newest saved step of ``kind`` (exact kind match), or None."""
    if not os.path.isdir(checkpoint_dir):
        return None
    steps = [p["steps"] for p in map(parse_name, os.listdir(checkpoint_dir))
             if p and p["kind"] == kind and p["suffix"] == CKPT_SUFFIX]
    return max(steps) if steps else None


def unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """'/'-joined path keys -> nested dicts."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def load_checkpoint(checkpoint_dir: str, kind: str,
                    steps: Optional[int] = None):
    """(nested dict of arrays, step) of the given or newest step of
    ``kind``; (None, 0) when there is none."""
    steps = latest_step(checkpoint_dir, kind) if steps is None else steps
    path = (os.path.join(checkpoint_dir, format_name(kind, steps))
            if steps is not None else None)
    if path is None or not os.path.exists(path):
        return None, 0
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    return unflatten(flat), steps


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[str, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield "/".join(prefix + (str(k),)), np.asarray(v)


def save_checkpoint(checkpoint_dir: str, kind: str, state: Dict[str, Any],
                    steps: int) -> str:
    """Write ``{kind}_{steps}.ckpt``: an ``.npz`` of the nested dict with
    '/'-joined keys, the file the JAX package writes and reads, written to a
    temporary name and renamed into place."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, format_name(kind, steps))
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:  # a handle: savez would append .npz
        np.savez(f, **dict(_flatten(state)))
    os.replace(tmp, path)
    return path
