"""msgpack with numpy support, wire-compatible with the msgpack_numpy
convention used by openpi's websocket protocol (ndarray encoded as a map with
b"nd"/b"type"/b"kind"/b"shape"/b"data" keys).

Copied from ``lap_tpu/serving/msgpack_numpy.py``. ``msgpack`` is imported
where a message is packed or unpacked, so importing the port never needs it
(the GPU host may not have it)."""

from __future__ import annotations

import numpy as np


def _encode(obj):
    if isinstance(obj, np.ndarray):
        if obj.dtype == object:
            raise TypeError("object arrays are not serializable")
        if not obj.flags["C_CONTIGUOUS"]:
            obj = np.ascontiguousarray(obj)
        return {
            b"nd": True,
            b"type": obj.dtype.str,
            b"kind": b"",
            b"shape": list(obj.shape),
            b"data": obj.tobytes(),
        }
    if isinstance(obj, (np.bool_, np.number)):
        return {
            b"nd": False,
            b"type": obj.dtype.str,
            b"kind": b"",
            b"data": obj.tobytes(),
        }
    return obj


def _decode(obj):
    if b"nd" in obj:
        dtype = np.dtype(obj[b"type"])
        if obj[b"nd"]:
            return np.frombuffer(obj[b"data"], dtype=dtype).reshape(obj[b"shape"])
        return np.frombuffer(obj[b"data"], dtype=dtype)[0]
    return obj


def packb(obj) -> bytes:
    import msgpack

    return msgpack.packb(obj, default=_encode, use_bin_type=True)


def unpackb(data: bytes):
    import msgpack

    return msgpack.unpackb(data, object_hook=_decode, raw=False, strict_map_key=False)


def Packer():  # noqa: N802 - the name msgpack_numpy gives it
    import msgpack

    return msgpack.Packer(default=_encode, use_bin_type=True)


def Unpacker():  # noqa: N802
    import msgpack

    return msgpack.Unpacker(object_hook=_decode, raw=False, strict_map_key=False)
