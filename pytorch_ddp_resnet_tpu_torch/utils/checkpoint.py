"""Checkpoint files (counterpart of pytorch_ddp_resnet_tpu/utils/
checkpoint.py: reading, the choice of the step to resume from, and the
single-file write that fitted transforms use; writing manifests, retention
GC and the async writer wait for ROADMAP.md Queue 1 item 4).

The JAX package writes one ``{kind}_{steps}.ckpt`` per kind and step in a
flat checkpoint directory: an ``.npz`` of the flattened pytree with
'/'-joined path keys (``params/00_conv/w``, ``model_state/...``), and,
last, a ``manifest_{steps}.json`` naming the kinds of that save and their
file sizes. These functions find the newest step of a kind, or the step a
multi-kind load takes (``resume_step``, the JAX ``maybe_load_checkpoints``
choice), and read a file back as a nested dict of numpy arrays, so the
port serves a run directory that the JAX package trained.
"""

from __future__ import annotations

import json
import os
import re
import zipfile
from typing import Any, Dict, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np

CKPT_SUFFIX = "ckpt"
MANIFEST_KIND = "manifest"
MANIFEST_SUFFIX = "json"
_NAME_RE = re.compile(r"(\w+)_([0-9]+)\.([a-z]+)$")


def format_name(kind: str, steps: int, suffix: str = CKPT_SUFFIX) -> str:
    return f"{kind}_{steps}.{suffix}"


def parse_name(filename: str) -> Optional[Dict[str, Any]]:
    m = _NAME_RE.match(filename)
    if m is None:
        return None
    return {"kind": m.group(1), "steps": int(m.group(2)),
            "suffix": m.group(3)}


def _steps(checkpoint_dir: str, kind: str,
           suffix: Optional[str] = None) -> Set[int]:
    """Every saved step of ``kind`` (exact kind match; any suffix, as the
    JAX step scan, unless ``suffix`` is given)."""
    if not os.path.isdir(checkpoint_dir):
        return set()
    return {p["steps"] for p in map(parse_name, os.listdir(checkpoint_dir))
            if p and p["kind"] == kind and suffix in (None, p["suffix"])}


def latest_step(checkpoint_dir: str, kind: str) -> Optional[int]:
    """Newest saved step of ``kind`` (exact kind match), or None."""
    steps = _steps(checkpoint_dir, kind, CKPT_SUFFIX)
    return max(steps) if steps else None


def _read_manifests(checkpoint_dir: str
                    ) -> List[Tuple[int, List[str], Dict[str, int]]]:
    """(steps, kinds, sizes) per manifest, newest first; unreadable ones
    skipped (JAX ``_read_manifests``)."""
    out = []
    for step in sorted(_steps(checkpoint_dir, MANIFEST_KIND), reverse=True):
        path = os.path.join(checkpoint_dir,
                            format_name(MANIFEST_KIND, step, MANIFEST_SUFFIX))
        try:
            with open(path) as f:
                data = json.load(f)
            out.append((step, list(data["kinds"]),
                        dict(data.get("sizes", {}))))
        except (OSError, ValueError, KeyError):
            continue
    return out


def _manifest_resume_step(checkpoint_dir: str, kinds: Sequence[str],
                          exclude: Set[int]) -> Optional[int]:
    """Newest manifested step, not in ``exclude``, that covers every kind
    with its files present at the recorded sizes (JAX
    ``_manifest_resume_step``); None when no manifest qualifies."""
    for step, manifest_kinds, sizes in _read_manifests(checkpoint_dir):
        if step in exclude or not set(kinds) <= set(manifest_kinds):
            continue

        def intact(kind):
            path = os.path.join(checkpoint_dir, format_name(kind, step))
            want = sizes.get(kind)
            return os.path.exists(path) and (
                want is None or os.path.getsize(path) == want)

        if all(intact(k) for k in kinds):
            return step
    return None


def _readable(checkpoint_dir: str, kinds: Sequence[str], step: int) -> bool:
    """Every kind's file of ``step`` parses as an npz (what JAX's load of
    the step would raise on)."""
    for kind in kinds:
        try:
            with np.load(os.path.join(checkpoint_dir,
                                      format_name(kind, step)),
                         allow_pickle=False) as data:
                for k in data.files:
                    data[k]
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            return False
    return True


def resume_step(checkpoint_dir: str, kinds: Sequence[str]) -> Optional[int]:
    """The step a load of ``kinds`` takes, as the JAX package's
    ``maybe_load_checkpoints`` picks it: the newest manifested step whose
    files are intact and readable (scanning back past unreadable ones);
    else the newest step at which every kind has a file. None when there
    is nothing to load (no files, or a kind without any: a first save that
    never finished); raises when the kinds share no step."""
    tried: Set[int] = set()
    while True:
        step = _manifest_resume_step(checkpoint_dir, kinds, tried)
        if step is None:
            break
        if _readable(checkpoint_dir, kinds, step):
            return step
        tried.add(step)
    per_kind = {k: _steps(checkpoint_dir, k) for k in kinds}
    if not all(per_kind.values()):
        return None
    common = set.intersection(*per_kind.values())
    if not common:
        raise RuntimeError(
            f"Checkpoint kinds share no common step: "
            f"{ {k: sorted(v)[-3:] for k, v in per_kind.items()} }")
    return max(common)


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
