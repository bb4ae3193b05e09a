"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source under ``lap_tpu_torch/csrc/`` is compiled on first use into a
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds), for ``sm_90a``. Libraries go to ``lap_tpu_torch/_build/``, named by
a hash of the source and of the shared headers (``csrc/*.cuh``), so an edited
source is rebuilt and an unchanged one is reused within a checkout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections.abc import Iterable
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}
# Compiler output of each build (register and shared-memory use from
# ``-Xptxas -v``), keyed by source name, for reports.
BUILD_LOGS: dict[str, str] = {}


def find_nvcc() -> str:
    for candidate in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError("nvcc not found: set CUDA_HOME or NVCC, or put nvcc on PATH")


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library is already built."""
    src = CSRC_DIR / source
    content = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(content + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{src.stem}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}\n{proc.stderr}")
    BUILD_LOGS[source] = proc.stdout + proc.stderr
    os.replace(tmp, lib)
    return lib


def load(source: str, signatures: dict[str, Iterable]) -> ctypes.CDLL:
    """Build (if needed) and load one source; ``signatures`` maps each C
    function to its ctypes argument types. Every function returns a
    ``cudaError_t`` as int."""
    with _LOCK:
        if source not in _LOADED:
            lib = ctypes.CDLL(str(build(source)))
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LOADED[source] = lib
        return _LOADED[source]
