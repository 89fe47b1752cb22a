"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source under ``csrc/`` is compiled at first use into a shared library
with a plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a
-O3 -shared -Xcompiler -fPIC``), named by a hash of its text, the headers
under ``csrc/`` and the flags, so an edited source or header is rebuilt.
A source may be built several times with different ``-D`` defines (a
kernel's compile-time width); each build is a library of its own.  The libraries live in ``_build/`` beside this file
(listed in ``.gitignore``), each with the compiler's ``-v`` report beside it.
A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from nfdpf_torch.utils.profiling import span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[tuple, ctypes.CDLL] = {}
build_log: dict[str, dict] = {}   # build label → {"seconds", "ptxas", "path"}


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


def build(name: str, defines: tuple = ()) -> Path:
    """Compile ``csrc/<name>.cu`` with ``-D<define>`` for each of ``defines``
    (if not built yet) and return the library path.  The build is logged
    under ``name`` followed by its defines."""
    src = CSRC / f"{name}.cu"
    # the shared headers count as part of every source
    text = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    label = " ".join((name,) + tuple(defines))
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    report = lib.with_name(f"{lib.name}.ptxas.txt")   # the compiler's -v report, kept beside it
    if lib.exists():
        build_log.setdefault(label, {"seconds": 0.0, "path": str(lib),
                                     "ptxas": report.read_text() if report.exists() else ""})
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    with span("cuda.build"):
        proc = subprocess.run([nvcc, *flags, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    report.write_text(proc.stderr)
    os.replace(tmp, lib)   # atomic: concurrent builders never load a half file
    build_log[label] = {"seconds": time.perf_counter() - t0,
                       "ptxas": proc.stderr, "path": str(lib)}
    return lib


def build_all(specs) -> None:
    """Compile several ``(name, defines)`` builds at once, one nvcc process each."""
    specs = list(specs)
    with ThreadPoolExecutor(max_workers=len(specs)) as pool:
        for future in [pool.submit(build, name, defines) for name, defines in specs]:
            future.result()


def load(name: str, signatures: dict, defines: tuple = ()) -> ctypes.CDLL:
    """Build and load ``csrc/<name>.cu`` (with ``defines``) once per process.

    ``signatures`` maps each C entry point to its ctypes ``argtypes``; every
    entry returns an int (a ``cudaError_t``).
    """
    with _lock:
        key = (name, defines)
        if key not in _loaded:
            lib = ctypes.CDLL(str(build(name, defines)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[key] = lib
        return _loaded[key]
