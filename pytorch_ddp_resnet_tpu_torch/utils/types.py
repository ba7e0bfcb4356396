"""Shared type aliases and the device rule of the port's entry points."""

from __future__ import annotations

from typing import Any, Dict, Union

import torch

StateDict = Dict[str, torch.Tensor]
PyTree = Any                     # nested dict of numpy arrays (JAX side)
Device = Union[str, torch.device]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}  # the config's compute_dtype names


def resolve_device(device: Device) -> torch.device:
    """The entry points run on the card unless the caller asks for the CPU:
    a CUDA device without a card raises, never falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but no CUDA device is "
            f"available; pass device='cpu' to run on the CPU")
    return dev
