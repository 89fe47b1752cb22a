"""Checks every CUDA wrapper makes before and after a launch."""

from __future__ import annotations

import torch


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when all are on one CUDA
    device; raises for anything else (the kernels take no other place)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no CUDA kernel for device {dev}")
    return False


def kernel_args(*tensors: torch.Tensor):
    """float32, contiguous, 8-byte aligned (float2 reads) — or raise."""
    out = []
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32, got {t.dtype}")
        t = t.contiguous()
        if t.data_ptr() % 8:
            raise ValueError("the CUDA kernels need 8-byte aligned inputs")
        out.append(t)
    return out


def check_launch(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {rc}")
