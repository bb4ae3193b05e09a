"""Native host ops: ctypes bindings over ``lap_tpu_torch/csrc/lap_native.cpp``.

The port's counterpart of ``lap_tpu/native/__init__.py``, reading the port's
own copy of the source. These are host ops on the serving path (the
resize-with-pad of camera frames, the unigram tokenizer's Viterbi loop and
the FAST codec's BPE merge loop, ``NativeIntBPE``), not device kernels. The library is compiled with ``g++ -O3 -shared`` at first
use into ``lap_tpu_torch/_build/``, never at import. Every consumer keeps the
JAX package's pure-Python fallback, so serving works without a toolchain,
just slower on the host; whether the library loaded is logged once and
reported by ``status()``.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "csrc" / "lap_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
LIB_PATH = BUILD_DIR / "liblap_native.so"

_lib = None
_load_failed = False


def _build() -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Built under a name of this process, then renamed: processes that start
    # at once never load a half-written library.
    tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp), str(SOURCE), "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, LIB_PATH)
        return True
    except Exception as e:  # noqa: BLE001
        logger.warning("native build failed (%s); using Python fallbacks", e)
        return False


def get_lib():
    """The loaded shared library, or None when unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        if not LIB_PATH.exists() or LIB_PATH.stat().st_mtime < SOURCE.stat().st_mtime:
            if not _build():
                _load_failed = True
                return None
        lib = ctypes.CDLL(str(LIB_PATH))
        lib.resize_with_pad_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.rotate180_u8.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.vocab_create.restype = ctypes.c_void_p
        lib.vocab_create.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.vocab_free.argtypes = [ctypes.c_void_p]
        lib.unigram_encode.restype = ctypes.c_int
        lib.unigram_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.bpe_create.restype = ctypes.c_void_p
        lib.bpe_create.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.bpe_free.argtypes = [ctypes.c_void_p]
        lib.bpe_encode.restype = ctypes.c_int
        lib.bpe_encode.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        _lib = lib
        logger.info("native host ops loaded from %s", LIB_PATH)
    except Exception as e:  # noqa: BLE001
        logger.warning("native lib load failed (%s); using Python fallbacks", e)
        _load_failed = True
    return _lib


def status() -> str:
    """Whether the library loaded: "loaded (...)", "unavailable (Python
    fallbacks)" or "not tried yet"."""
    if _lib is not None:
        return f"loaded ({LIB_PATH.name}, built from lap_tpu_torch/csrc/{SOURCE.name})"
    return "unavailable (Python fallbacks)" if _load_failed else "not tried yet"


def resize_with_pad_u8(images: np.ndarray, out_h: int, out_w: int, *, num_threads: int = 8) -> np.ndarray | None:
    """Batched native resize-with-pad; None if the library is unavailable or
    the input is not uint8 HWC."""
    lib = get_lib()
    if lib is None:
        return None
    images = np.ascontiguousarray(images)
    if images.dtype != np.uint8 or images.ndim not in (3, 4):
        return None
    single = images.ndim == 3
    if single:
        images = images[None]
    n, h, w, c = images.shape
    out = np.empty((n, out_h, out_w, c), np.uint8)
    lib.resize_with_pad_u8(images.ctypes.data, n, h, w, c, out.ctypes.data, out_h, out_w, num_threads)
    return out[0] if single else out


def rotate180_u8(img: np.ndarray) -> np.ndarray | None:
    lib = get_lib()
    if lib is None or img.dtype != np.uint8 or img.ndim != 3:
        return None
    out = np.ascontiguousarray(img).copy()
    h, w, c = out.shape
    lib.rotate180_u8(out.ctypes.data, h, w, c)
    return out


class NativeIntBPE:
    """C++ greedy lowest-rank-first BPE over integer symbol streams (the
    semantics of ``lap_tpu_torch.models.bpe.IntBPE.encode_py``)."""

    def __init__(self, merges: list[tuple[int, int]], alphabet_size: int):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native lib unavailable")
        self._lib = lib
        flat = np.ascontiguousarray(np.asarray(merges, np.int32).reshape(-1))
        self._handle = lib.bpe_create(flat.ctypes.data, len(merges), alphabet_size)

    def encode(self, seq: list[int]) -> list[int]:
        arr = np.ascontiguousarray(np.asarray(seq, np.int32))
        if arr.size < 2:
            return arr.tolist()
        out = np.empty(arr.size, np.int32)
        n = self._lib.bpe_encode(self._handle, arr.ctypes.data, arr.size, out.ctypes.data, out.size)
        return out[:n].tolist()

    def __del__(self):
        if getattr(self, "_handle", None) and getattr(self, "_lib", None):
            self._lib.bpe_free(self._handle)


class NativeUnigramVocab:
    """C++ Viterbi encoder over a sentencepiece-style piece table."""

    def __init__(self, pieces: list[str], scores: np.ndarray, normal_flags: np.ndarray, unk_id: int):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native lib unavailable")
        self._lib = lib
        encoded = [p.encode("utf-8") for p in pieces]
        blob = b"".join(encoded)
        offsets = np.zeros(len(encoded) + 1, np.int64)
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        scores = np.ascontiguousarray(scores, np.float32)
        flags = np.ascontiguousarray(normal_flags, np.uint8)
        self._handle = lib.vocab_create(
            blob, offsets.ctypes.data, scores.ctypes.data, flags.ctypes.data, len(encoded), unk_id,
        )

    def encode(self, text: str) -> list[int]:
        data = text.encode("utf-8")
        out = np.empty(max(len(data), 1) * 2, np.int32)
        n = self._lib.unigram_encode(self._handle, data, len(data), out.ctypes.data, len(out))
        return out[:n].tolist()

    def __del__(self):
        if getattr(self, "_handle", None) and getattr(self, "_lib", None):
            self._lib.vocab_free(self._handle)
