"""A msgpack encoder and decoder for the subset a checkpoint uses: maps,
str, bin, arrays, ints, nil and booleans (the port keeps its own, so it
needs no `msgpack` package; what it writes any msgpack reader reads, and
it reads what `msgpack.packb(..., use_bin_type=True)` writes of that
subset).
"""
from __future__ import annotations

import struct

__all__ = ["packb", "unpackb"]


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        if 0 <= obj < 0x80:
            out.append(struct.pack("B", obj))
        elif -32 <= obj < 0:
            out.append(struct.pack("b", obj))
        elif 0 <= obj < 1 << 64:
            out.append(b"\xcf" + struct.pack(">Q", obj))
        elif -(1 << 63) <= obj < 0:
            out.append(b"\xd3" + struct.pack(">q", obj))
        else:
            raise OverflowError(f"msgpack: int {obj} out of range")
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(struct.pack("B", 0xa0 | n))
        elif n < 1 << 8:
            out.append(b"\xd9" + struct.pack("B", n))
        elif n < 1 << 16:
            out.append(b"\xda" + struct.pack(">H", n))
        else:
            out.append(b"\xdb" + struct.pack(">I", n))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = len(obj)
        if n < 1 << 8:
            out.append(b"\xc4" + struct.pack("B", n))
        elif n < 1 << 16:
            out.append(b"\xc5" + struct.pack(">H", n))
        else:
            out.append(b"\xc6" + struct.pack(">I", n))
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(struct.pack("B", 0x90 | n))
        elif n < 1 << 16:
            out.append(b"\xdc" + struct.pack(">H", n))
        else:
            out.append(b"\xdd" + struct.pack(">I", n))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(struct.pack("B", 0x80 | n))
        elif n < 1 << 16:
            out.append(b"\xde" + struct.pack(">H", n))
        else:
            out.append(b"\xdf" + struct.pack(">I", n))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# fixed-width ints: first byte -> (struct format, size)
_INTS = {0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4),
         0xcf: (">Q", 8), 0xd0: (">b", 1), 0xd1: (">h", 2),
         0xd2: (">i", 4), 0xd3: (">q", 8)}
# lengths: first byte -> (kind, struct format, size)
_SIZED = {0xc4: ("bin", ">B", 1), 0xc5: ("bin", ">H", 2),
          0xc6: ("bin", ">I", 4), 0xd9: ("str", ">B", 1),
          0xda: ("str", ">H", 2), 0xdb: ("str", ">I", 4),
          0xdc: ("array", ">H", 2), 0xdd: ("array", ">I", 4),
          0xde: ("map", ">H", 2), 0xdf: ("map", ">I", 4)}


def _unpack(buf: memoryview, pos: int):
    b = buf[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8f:
        return _items("map", b & 0x0f, buf, pos)
    if 0x90 <= b <= 0x9f:
        return _items("array", b & 0x0f, buf, pos)
    if 0xa0 <= b <= 0xbf:
        n = b & 0x1f
        return str(buf[pos:pos + n], "utf-8"), pos + n
    if b == 0xc0:
        return None, pos
    if b in (0xc2, 0xc3):
        return b == 0xc3, pos
    if b in _INTS:
        fmt, size = _INTS[b]
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    if b in _SIZED:
        kind, fmt, size = _SIZED[b]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += size
        if kind == "bin":
            return bytes(buf[pos:pos + n]), pos + n
        if kind == "str":
            return str(buf[pos:pos + n], "utf-8"), pos + n
        return _items(kind, n, buf, pos)
    raise ValueError(f"msgpack: byte 0x{b:02x} at {pos - 1} is outside the "
                     "subset a checkpoint uses")


def _items(kind: str, n: int, buf: memoryview, pos: int):
    if kind == "array":
        out = []
        for _ in range(n):
            x, pos = _unpack(buf, pos)
            out.append(x)
        return out, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        v, pos = _unpack(buf, pos)
        out[k] = v
    return out, pos


def unpackb(data: bytes):
    buf = memoryview(data)
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError(f"msgpack: {len(buf) - pos} trailing bytes")
    return obj
