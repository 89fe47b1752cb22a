"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source under ``csrc/`` is compiled at first use into a shared library
with a plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a
-O3 -shared -Xcompiler -fPIC``), named by a hash of its text and flags so an
edited source is rebuilt.  The libraries live in ``_build/`` beside this file
(listed in ``.gitignore``).  A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, dict] = {}   # source name → {"seconds", "ptxas", "path"}


def find_nvcc() -> str:
    """nvcc from PATH, else from ``$CUDA_HOME`` or the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels of nfdpf_torch are built from source at first use")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (if not built yet) and return the library path."""
    src = CSRC / f"{name}.cu"
    text = src.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        build_log.setdefault(name, {"seconds": 0.0, "ptxas": "", "path": str(lib)})
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)   # atomic: concurrent builders never load a half file
    build_log[name] = {"seconds": time.perf_counter() - t0,
                       "ptxas": proc.stderr, "path": str(lib)}
    return lib


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build and load ``csrc/<name>.cu`` once per process.

    ``signatures`` maps each C entry point to its ctypes ``argtypes``; every
    entry returns an int (a ``cudaError_t``).
    """
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return _loaded[name]
