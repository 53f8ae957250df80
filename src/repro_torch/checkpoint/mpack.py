"""A small MessagePack codec for checkpoint sidecars.

The JAX package writes each checkpoint's ``.meta.msgpack`` sidecar with
``msgpack.packb(obj, use_bin_type=True)`` and reads it with
``msgpack.unpackb(raw=False, strict_map_key=False)``. The port reads and
writes the same bytes without the ``msgpack`` package, which the
machines the port runs on need not have. It covers the types a sidecar
holds: maps, arrays (lists and tuples), str, bytes, int, float, bool
and None, each in the smallest encoding ``msgpack.packb`` picks, so its
output is byte-equal to the package's. ``unpackb`` also reads the
encodings a sidecar never holds but another writer may pick (float32,
the wider fixed-size forms); it returns lists for arrays and str for
strings, as ``unpackb(raw=False)`` does.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

__all__ = ["packb", "unpackb"]


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit 64 bits")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if v >= low:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit 64 bits")


def _pack_len(n: int, fix: int, fix_max: int, codes, out: bytearray) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    ``codes`` ((code, struct format, limit), ...) that holds ``n``."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in codes:
        if n < top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} is too large for MessagePack")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARRAY = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 32, _STR, out)
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), None, 0, _BIN, out)
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, _ARRAY, out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, _MAP, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} object")


def packb(obj: Any) -> bytes:
    """``obj`` as MessagePack bytes, as ``msgpack.packb(obj,
    use_bin_type=True)`` writes them."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# (struct format, size) of the fixed-size scalars, by type byte
_SCALARS = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# type byte -> (kind, struct format of the length, its size)
_SIZED = {
    0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
}


def _take(data: bytes, pos: int, n: int) -> Tuple[bytes, int]:
    if pos + n > len(data):
        raise ValueError("MessagePack data ends early")
    return data[pos:pos + n], pos + n


def _unpack(data: bytes, pos: int) -> Tuple[Any, int]:
    raw, pos = _take(data, pos, 1)
    t = raw[0]
    if t < 0x80:
        return t, pos
    if t >= 0xE0:
        return t - 0x100, pos
    if t == 0xC0:
        return None, pos
    if t in (0xC2, 0xC3):
        return t == 0xC3, pos
    if t in _SCALARS:
        fmt, size = _SCALARS[t]
        raw, pos = _take(data, pos, size)
        return struct.unpack(fmt, raw)[0], pos
    if 0xA0 <= t <= 0xBF:
        kind, n = "str", t & 0x1F
    elif 0x90 <= t <= 0x9F:
        kind, n = "array", t & 0x0F
    elif 0x80 <= t <= 0x8F:
        kind, n = "map", t & 0x0F
    elif t in _SIZED:
        kind, fmt, size = _SIZED[t]
        raw, pos = _take(data, pos, size)
        n = struct.unpack(fmt, raw)[0]
    else:
        raise ValueError(f"unsupported MessagePack type byte 0x{t:02x}")
    if kind == "str":
        raw, pos = _take(data, pos, n)
        return raw.decode("utf-8"), pos
    if kind == "bin":
        return _take(data, pos, n)
    if kind == "array":
        items = []
        for _ in range(n):
            item, pos = _unpack(data, pos)
            items.append(item)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(data, pos)
        v, pos = _unpack(data, pos)
        out[k] = v
    return out, pos


def unpackb(data: bytes) -> Any:
    """One MessagePack object from ``data``, as ``msgpack.unpackb(data,
    raw=False, strict_map_key=False)`` reads it; trailing bytes raise."""
    obj, pos = _unpack(bytes(data), 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} bytes of extra data after the object")
    return obj
