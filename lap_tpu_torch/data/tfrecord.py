"""Pure-Python TFRecord + tf.train.Example codec (no TensorFlow dependency).

The reference feeds everything through tf.data/TFDS; the TPU-native rebuild
reads the same on-disk format (TFRecord files of serialized Example/
SequenceExample protos) directly with numpy, so the input pipeline is plain
threaded Python. Includes a writer so tests can fabricate datasets.

TFRecord framing: {uint64 length, uint32 masked-crc32c(length),
bytes data[length], uint32 masked-crc32c(data)}.

Copied from ``lap_tpu/data/tfrecord.py``; its imports point at the port's
copies.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

# ---------------------------------------------------------------------------
# CRC32C (software fallback; the masked variant TFRecord uses)
# ---------------------------------------------------------------------------

_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table.append(crc)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------


def read_tfrecords(path: str | Path, *, verify_crc: bool = False):
    """Yield raw record bytes from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if verify_crc:
                (crc,) = struct.unpack("<I", header[8:12])
                if crc != _masked_crc(header[:8]):
                    raise ValueError("corrupt TFRecord length CRC")
            data = f.read(length)
            footer = f.read(4)
            if verify_crc:
                (crc,) = struct.unpack("<I", footer)
                if crc != _masked_crc(data):
                    raise ValueError("corrupt TFRecord data CRC")
            yield data


def write_tfrecords(path: str | Path, records) -> None:
    with open(path, "wb") as f:
        for rec in records:
            header = struct.pack("<Q", len(rec))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(rec)
            f.write(struct.pack("<I", _masked_crc(rec)))


# ---------------------------------------------------------------------------
# Protobuf wire primitives
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _write_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _iter_fields(buf: bytes):
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            val = buf[i : i + ln]
            i += ln
        elif wire == 5:
            val = buf[i : i + 4]
            i += 4
        elif wire == 1:
            val = buf[i : i + 8]
            i += 8
        else:
            raise ValueError(f"wire type {wire}")
        yield field, wire, val


def _field(num: int, wire: int, payload: bytes) -> bytes:
    return _write_varint((num << 3) | wire) + payload


def _len_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2, _write_varint(len(payload)) + payload)


# ---------------------------------------------------------------------------
# tf.train.Example / Feature
# ---------------------------------------------------------------------------
# Example { Features features = 1 }  Features { map<string, Feature> = 1 }
# Feature { oneof: BytesList=1, FloatList=2, Int64List=3 }, each { repeated value = 1 }


def parse_feature(buf: bytes):
    for field, _wire, val in _iter_fields(buf):
        if field == 1:  # bytes_list
            return [v for f, _w, v in _iter_fields(val) if f == 1]
        if field == 2:  # float_list (packed)
            floats = []
            for f, w, v in _iter_fields(val):
                if f == 1:
                    if w == 2:
                        floats.extend(np.frombuffer(v, dtype="<f4").tolist())
                    else:
                        floats.append(struct.unpack("<f", v)[0])
            return np.asarray(floats, dtype=np.float32)
        if field == 3:  # int64_list (packed varints)
            ints = []
            for f, w, v in _iter_fields(val):
                if f == 1:
                    if w == 2:
                        i = 0
                        while i < len(v):
                            x, i = _read_varint(v, i)
                            ints.append(_to_signed(x))
                    else:
                        ints.append(_to_signed(v))
            return np.asarray(ints, dtype=np.int64)
    return None


def _to_signed(x: int) -> int:
    return x - (1 << 64) if x >= (1 << 63) else x


def parse_example(buf: bytes) -> dict:
    """Serialized tf.train.Example -> {name: bytes-list | float[] | int64[]}."""
    out = {}
    for field, _wire, val in _iter_fields(buf):
        if field != 1:
            continue
        for f2, _w2, entry in _iter_fields(val):  # features.feature map entries
            if f2 != 1:
                continue
            name, feature = None, None
            for f3, _w3, v3 in _iter_fields(entry):
                if f3 == 1:
                    name = v3.decode("utf-8")
                elif f3 == 2:
                    feature = parse_feature(v3)
            if name is not None:
                out[name] = feature
    return out


def _encode_feature(value) -> bytes:
    if isinstance(value, (bytes, str)):
        value = [value]
    if isinstance(value, (list, tuple)) and value and isinstance(value[0], (bytes, str)):
        payload = b"".join(
            _len_field(1, v.encode() if isinstance(v, str) else v) for v in value
        )
        return _len_field(1, payload)
    arr = np.asarray(value)
    if arr.dtype.kind in "iub":
        payload = b"".join(_field(1, 0, _write_varint(int(v) & (1 << 64) - 1)) for v in arr.flatten())
        return _len_field(3, payload)
    packed = arr.astype("<f4").tobytes()
    return _len_field(2, _len_field(1, packed))


def build_example(features: dict) -> bytes:
    entries = b""
    for name, value in features.items():
        entry = _len_field(1, name.encode()) + _len_field(2, _encode_feature(value))
        entries += _len_field(1, entry)
    return _len_field(1, entries)
