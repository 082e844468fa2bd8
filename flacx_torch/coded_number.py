"""UTF-8-style coded numbers (the frame index varint of a FLAC header).

A value of up to 36 bits is written as 1-7 bytes: a prefix byte whose
leading-ones count gives the total length, then 6 payload bits per
continuation byte (``0b10xxxxxx``).
"""

from __future__ import annotations

#: Payload bit capacity for each total byte count 1..7.
_CAPACITY = (7, 11, 16, 21, 26, 31, 36)


def required_bytes(x: int) -> int:
    """Total encoded size in bytes for value ``x``."""
    n = x.bit_length()
    for size, cap in enumerate(_CAPACITY, start=1):
        if n <= cap:
            return size
    raise ValueError(f"cannot encode coded number: {x}")


def encode(x: int) -> bytes:
    """Encode ``x`` (< 2^36) as a coded number.

    >>> encode(0x41).hex(), encode(0x1234).hex()
    ('41', 'e188b4')
    """
    if x < 0:
        raise ValueError("coded numbers are unsigned")
    size = required_bytes(x)
    if size == 1:
        return bytes([x])
    out = bytearray(size)
    for i in range(size - 1, 0, -1):
        out[i] = 0x80 | (x & 0x3F)
        x >>= 6
    out[0] = ((0xFF << (8 - size)) & 0xFF) | x
    return bytes(out)


def following_bytes(b0: int) -> int:
    """Number of continuation bytes implied by the first byte."""
    n = 0
    while n < 7 and (b0 << n) & 0x80:
        n += 1
    return max(0, n - 1)


def decode(bs: bytes) -> int:
    """Decode a complete coded number.

    >>> decode(encode(12345678))
    12345678
    """
    size = following_bytes(bs[0]) + 1
    if size != len(bs):
        raise ValueError("coded number length mismatch")
    if size == 1:
        return bs[0]
    x = bs[0] & (0xFF >> (size + 1))
    for b in bs[1:]:
        if b & 0xC0 != 0x80:
            raise ValueError("bad continuation byte in coded number")
        x = (x << 6) | (b & 0x3F)
    return x
