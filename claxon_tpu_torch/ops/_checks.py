"""Argument checks shared by the kernel wrappers."""

import torch

__all__ = ["on_cpu", "require_cuda_int32"]


def on_cpu(*tensors):
    """True when every tensor lies on the CPU (the plain-form route);
    raises on a mix of devices."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: "
                         f"{sorted(map(str, devs))}")
    return next(iter(devs)).type == "cpu"


def require_cuda_int32(name, **tensors):
    """Check that every tensor is a contiguous int32 tensor on one CUDA
    device; returns that device."""
    devs = set()
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, "
                             f"got {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        devs.add(t.device)
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices: "
                         f"{sorted(map(str, devs))}")
    return devs.pop()
