"""Native host ops: ctypes bindings over ``lap_tpu_torch/csrc/lap_native.cpp``.

The port's counterpart of ``lap_tpu/native/__init__.py``, reading the port's
own copy of the source. These are host ops, not device kernels: on the
serving path the resize-with-pad of camera frames, the unigram tokenizer's
Viterbi loop and the FAST codec's BPE merge loop (``NativeIntBPE``); on the
data path the JPEG/PNG codec (``decode_image``, ``jpeg_encode``), which the
JAX package leaves to ``cv2``. The library is compiled with ``g++ -O3
-shared`` at first use into ``lap_tpu_torch/_build/``, never at import.
The serving consumers keep the JAX package's pure-Python fallbacks, so
serving works without a toolchain, just slower on the host; the codec has
none and raises when the library is unavailable. Whether the library loaded
is logged once and reported by ``status()``.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import zlib
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
        lib.codec_last_error.restype = ctypes.c_char_p
        lib.jpeg_header.argtypes = [ctypes.c_char_p, ctypes.c_int64] + [ctypes.POINTER(ctypes.c_int)] * 3
        lib.jpeg_decode_rgb.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.jpeg_encode.restype = ctypes.c_int64
        lib.jpeg_encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.jpeg_encoded_copy.argtypes = [ctypes.c_void_p]
        lib.png_unfilter.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ]
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


# ---------------------------------------------------------------------------
# JPEG/PNG codec (the data pipeline's frames)
# ---------------------------------------------------------------------------
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# Channels a PNG colour type carries at 8 bits (grey, RGB, palette, grey+alpha, RGBA).
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _codec_lib():
    lib = get_lib()
    if lib is None:
        raise RuntimeError(
            f"the native codec is unavailable: {LIB_PATH} did not build or load from {SOURCE} (needs g++)"
        )
    return lib


def _codec_error(lib) -> str:
    return lib.codec_last_error().decode("utf-8", "replace")


def jpeg_decode(data: bytes) -> np.ndarray:
    """Baseline JPEG bytes -> uint8 [H, W, 3] RGB (grayscale replicated), the
    bits ``cv2.imdecode(..., IMREAD_COLOR)[..., ::-1]`` gives. Raises
    ``ValueError`` for a file it does not decode (progressive, arithmetic,
    12-bit: the message names the SOF marker)."""
    lib = _codec_lib()
    data = bytes(data)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_header(data, len(data), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c)) != 0:
        raise ValueError(_codec_error(lib))
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.jpeg_decode_rgb(data, len(data), out.ctypes.data, h.value, w.value) != 0:
        raise ValueError(_codec_error(lib))
    return out


def jpeg_encode(img: np.ndarray, quality: int = 95) -> bytes:
    """uint8 [H, W, 3] RGB (or [H, W] / [H, W, 1] grey) -> baseline JPEG bytes
    (4:2:0 for colour, Annex K tables scaled by ``quality``)."""
    lib = _codec_lib()
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"jpeg_encode takes uint8 HW or HWC images, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    n = lib.jpeg_encode(img.ctypes.data, h, w, c, int(quality))
    if n < 0:
        raise ValueError(_codec_error(lib))
    out = np.empty(n, np.uint8)
    lib.jpeg_encoded_copy(out.ctypes.data)
    return out.tobytes()


def png_decode(data: bytes) -> np.ndarray:
    """8-bit non-interlaced PNG -> uint8 [H, W, 3] RGB, as
    ``cv2.imdecode(..., IMREAD_COLOR)[..., ::-1]``: grey is replicated, a
    palette looked up, alpha dropped. Other bit depths and interlaced files
    raise ``ValueError``."""
    lib = _codec_lib()
    data = bytes(data)
    if not data.startswith(_PNG_MAGIC):
        raise ValueError("not a PNG file")
    pos, ihdr, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        length = int.from_bytes(data[pos : pos + 4], "big")
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = body
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None or len(ihdr) < 13 or not idat:
        raise ValueError("corrupt PNG data: no IHDR or IDAT chunk")
    w, h = int.from_bytes(ihdr[0:4], "big"), int.from_bytes(ihdr[4:8], "big")
    depth, color, interlace = ihdr[8], ihdr[9], ihdr[12]
    if depth != 8 or color not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {color}, interlace {interlace} "
                         "(8-bit, non-interlaced only)")
    if color == 3 and palette is None:
        raise ValueError("corrupt PNG data: palette image without PLTE")
    ch = _PNG_CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    px = np.empty((h, w, ch), np.uint8)
    if lib.png_unfilter(raw, len(raw), h, w * ch, ch, px.ctypes.data) != 0:
        raise ValueError(_codec_error(lib))
    if color == 3:
        if int(px.max(initial=0)) >= len(palette):
            raise ValueError("corrupt PNG data: palette index out of range")
        return palette[px[..., 0]]
    if ch <= 2:
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def decode_image(data) -> np.ndarray:
    """JPEG or PNG bytes -> uint8 [H, W, 3] RGB, the format picked by its
    magic bytes."""
    data = bytes(data)
    if data[:2] == b"\xff\xd8":
        return jpeg_decode(data)
    if data.startswith(_PNG_MAGIC):
        return png_decode(data)
    raise ValueError(f"failed to decode image: neither JPEG nor PNG (starts {data[:8]!r})")
