"""Order-preserving byte encodings for index key components.

Parity: the reference's lexicoders used by attribute index keys
(geomesa-index-api index/attribute key encoding; upstream uses a ByteArrays/
Lexicoders scheme) [upstream, unverified]. Property required of every coder:
a < b  <=>  encode(a) < encode(b) bytewise.

A copy of the reference package's `index/lexicoders.py`.
"""

from __future__ import annotations

import struct
from typing import Optional

NULL_BYTE = b"\x00"
# Escaping for embedded NULs in strings: 0x00 -> 0x01 0x01, 0x01 -> 0x01 0x02.
# Keeps bytewise order for all strings not containing 0x00/0x01 prefixes and
# makes the 0x00 field separator unambiguous.
_ESC = b"\x01"


def encode_string(s: str) -> bytes:
    raw = s.encode("utf-8")
    if b"\x00" in raw or b"\x01" in raw:
        raw = raw.replace(_ESC, b"\x01\x02").replace(NULL_BYTE, b"\x01\x01")
    return raw


def decode_string(b: bytes) -> str:
    if _ESC in b:
        b = b.replace(b"\x01\x01", NULL_BYTE).replace(b"\x01\x02", _ESC)
    return b.decode("utf-8")


def encode_int(v: int) -> bytes:
    """Signed 64-bit, order-preserving: flip the sign bit, big-endian."""
    return struct.pack(">Q", (int(v) ^ (1 << 63)) & 0xFFFFFFFFFFFFFFFF)


def decode_int(b: bytes) -> int:
    (u,) = struct.unpack(">Q", b)
    return u - (1 << 63)


def encode_float(v: float) -> bytes:
    """IEEE-754 double, order-preserving.

    Non-negative (sign bit 0): set the sign bit. Negative: invert all bits.
    NaN sorts above everything (encoded via its IEEE pattern); callers treat
    NaN as null before encoding.
    """
    (bits,) = struct.unpack(">Q", struct.pack(">d", float(v)))
    if bits & (1 << 63):
        bits = ~bits & 0xFFFFFFFFFFFFFFFF
    else:
        bits |= 1 << 63
    return struct.pack(">Q", bits)


def decode_float(b: bytes) -> float:
    (bits,) = struct.unpack(">Q", b)
    if bits & (1 << 63):
        bits &= ~(1 << 63) & 0xFFFFFFFFFFFFFFFF
    else:
        bits = ~bits & 0xFFFFFFFFFFFFFFFF
    (v,) = struct.unpack(">d", struct.pack(">Q", bits))
    return v


def encode_value(v, type_name: str) -> Optional[bytes]:
    """Encode a typed attribute value; None/NaN -> None (not indexed)."""
    if v is None:
        return None
    if type_name in ("Integer", "Long", "Short", "Byte"):
        return encode_int(int(v))
    if type_name in ("Float", "Double"):
        f = float(v)
        if f != f:  # NaN
            return None
        return encode_float(f)
    if type_name in ("Date", "Timestamp"):
        return encode_int(int(v))  # epoch millis
    if type_name == "Boolean":
        return b"\x01" if v else b"\x00"
    return encode_string(str(v))


def successor(b: bytes) -> bytes:
    """The smallest byte string strictly greater than every string with
    prefix b: append 0x00 is wrong (b itself < b+0x00 but b+x may sort
    between); the correct exclusive upper bound for prefix scans is b with
    the last non-0xff byte incremented and the tail dropped."""
    arr = bytearray(b)
    for i in range(len(arr) - 1, -1, -1):
        if arr[i] != 0xFF:
            arr[i] += 1
            return bytes(arr[: i + 1])
        # byte is 0xff: drop it and carry
    # all-0xff prefix: no finite exact bound; a long 0xff tail bounds every
    # realistic key (suffixes here are feature ids far shorter than 64 bytes)
    return b + b"\xff" * 64
