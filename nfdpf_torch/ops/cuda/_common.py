"""Checks every CUDA wrapper makes before and after a launch."""

from __future__ import annotations

import ctypes

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


def read_launch_note(entry, *slot: int) -> dict:
    """A kernel's last launch as its library noted it (``csrc/launch_note.cuh``),
    through the C entry point ``entry`` (with ``slot`` where the library notes
    several kernels): the launched kernel's name, its registers a thread and
    static shared memory a block as the runtime loaded it, the launch's
    dynamic shared memory, grid and block, and the launches noted so far."""
    out, name = (ctypes.c_longlong * 10)(), ctypes.create_string_buffer(96)
    rc = entry(*slot, out, name, len(name))
    if rc != 0:
        raise RuntimeError(f"reading a launch note failed: cudaError_t {rc}")
    return {"kernel": name.value.decode(), "registers": out[0], "smem_static_bytes": out[1],
            "smem_dynamic_bytes": out[2], "grid": list(out[3:6]), "block": list(out[6:9]),
            "launches": out[9]}
