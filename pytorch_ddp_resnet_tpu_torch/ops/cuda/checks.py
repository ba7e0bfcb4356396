"""Argument checks shared by the kernel wrappers of ops/cuda/."""

from __future__ import annotations

import torch


def on_cpu(x: torch.Tensor) -> bool:
    """True for a CPU tensor (the wrapper runs the plain version), False
    for a CUDA tensor (the wrapper launches the kernel); raises otherwise."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return False


def require_cuda(name: str, tensors, dtypes) -> None:
    """Every tensor on one device, of its dtype, contiguous and 16-byte
    aligned, as the kernels read them."""
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dt:
            raise ValueError(f"{name}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor data must be 16-byte aligned")


def check_rc(name: str, rc: int) -> None:
    """Raise on the cudaError_t a launch function returned."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
