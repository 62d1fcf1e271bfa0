"""The subset of MessagePack the checkpoint format writes, encoded and
decoded by the port itself.

The reference's checkpoints are ``msgpack.packb(payload,
use_bin_type=True)`` (``repro/checkpoint/checkpointing.py``).  The card's
machine has no ``msgpack`` package, so the port carries this codec for the
types that payload holds: map, array (list or tuple), str, bin (bytes,
bytearray, memoryview), int, float (as float64), bool and nil.  Its output
is byte for byte ``msgpack.packb(obj, use_bin_type=True)``'s, and it reads
what that writes (``raw=False``: str as str, bin as bytes).

``packb_chunks`` returns the encoding as a list of pieces whose bin bodies
are the caller's buffers, not copies, so a checkpoint of many GB is
hashed and written without joining it in memory; ``unpackb(...,
bin_view=True)`` returns bins as memoryview slices of the input.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

# msgpack's largest str, bin, array and map: a 32-bit length
MAX_LEN = 2 ** 32 - 1


def _header(n: int, fix: int, fix_max: int, codes: Tuple[int, ...],
            what: str) -> bytes:
    """The length header of a str/bin/array/map of ``n`` items: a fix
    form (``fix | n``, if ``fix_max`` allows) or one of ``codes`` for 8-,
    16- and 32-bit lengths (0 where the type has no such form)."""
    if n > MAX_LEN:
        unit = "bytes" if what in ("bin", "str") else "items"
        raise ValueError(f"{what} of {n:,} {unit} is over msgpack's limit "
                         f"of {MAX_LEN:,}")
    if n <= fix_max:
        return bytes((fix | n,))
    for code, fmt, top in zip(codes, (">BB", ">BH", ">BI"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= top:
            return struct.pack(fmt, code, n)


def _int(v: int) -> bytes:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        return struct.pack("b" if v < 0 else "B", v)
    for lo, hi, fmt, code in ((0, 0xFF, ">BB", 0xCC),
                              (-0x80, -1, ">Bb", 0xD0),
                              (0, 0xFFFF, ">BH", 0xCD),
                              (-0x8000, -1, ">Bh", 0xD1),
                              (0, 0xFFFFFFFF, ">BI", 0xCE),
                              (-0x80000000, -1, ">Bi", 0xD2),
                              (0, 0xFFFFFFFFFFFFFFFF, ">BQ", 0xCF),
                              (-0x8000000000000000, -1, ">Bq", 0xD3)):
        if lo <= v <= hi:
            return struct.pack(fmt, code, v)
    raise OverflowError("Integer value out of range")


def _pack(obj: Any, out: List) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_header(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), "str"))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = memoryview(obj).cast("B") if isinstance(obj, memoryview) \
            else obj
        out.append(_header(len(data), 0, -1, (0xC4, 0xC5, 0xC6), "bin"))
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 15, (0, 0xDC, 0xDD), "array"))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 15, (0, 0xDE, 0xDF), "map"))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"Cannot serialize {obj!r}")


def packb_chunks(obj: Any) -> List:
    """The encoding of ``obj`` as pieces (bytes, or the caller's own
    buffers for bin bodies) whose concatenation is ``packb(obj)``."""
    out: List = []
    _pack(obj, out)
    return out


def packb(obj: Any) -> bytes:
    return b"".join(packb_chunks(obj))


class _Reader:
    def __init__(self, buf, bin_view: bool):
        self.mv = memoryview(buf).cast("B")
        self.pos = 0
        self.bin_view = bin_view

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.mv):
            raise ValueError("msgpack data ends early")
        out = self.mv[self.pos:end]
        self.pos = end
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def bin(self, n: int):
        data = self.take(n)
        return data if self.bin_view else bytes(data)

    def obj(self) -> Any:
        b = self.num("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        nums = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
                0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in nums:
            return self.num(nums[b])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
        if b not in lens:
            raise ValueError(f"msgpack type byte 0x{b:02x} is not one the "
                             "checkpoint format writes")
        n = self.num(lens[b])
        if b <= 0xC6:
            return self.bin(n)
        if b <= 0xDB:
            return str(self.take(n), "utf-8")
        if b <= 0xDD:
            return [self.obj() for _ in range(n)]
        return self.map(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(buf, bin_view: bool = False) -> Any:
    """Decode one object from ``buf`` (bytes-like), which it must fill.
    ``bin_view=True`` returns bins as memoryview slices of ``buf``."""
    r = _Reader(buf, bin_view)
    obj = r.obj()
    if r.pos != len(r.mv):
        raise ValueError(f"{len(r.mv) - r.pos} extra bytes after the "
                         "msgpack object")
    return obj
