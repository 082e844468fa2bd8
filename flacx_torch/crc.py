"""CRC-8 / CRC-16 of FLAC (host side, table driven).

Both CRCs start at 0 and are not reflected: CRC-8 (poly 0x107) covers the
frame header, CRC-16 (poly 0x18005) the whole frame.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from flacx_torch.format import CRC8_POLYNOMIAL, CRC16_POLYNOMIAL


@lru_cache(maxsize=None)
def crc_table(width: int, poly_with_top: int) -> np.ndarray:
    """256-entry lookup table of a ``width``-bit MSB-first CRC."""
    poly = poly_with_top & ((1 << width) - 1)
    top = 1 << (width - 1)
    entries = np.arange(256, dtype=np.uint32) << (width - 8)
    for _ in range(8):
        hit = (entries & top) != 0
        entries = ((entries << 1) ^ np.where(hit, poly, 0)) \
            & ((1 << width) - 1)
    return entries.astype(np.uint32)


def crc8(data: bytes, initial: int = 0) -> int:
    """CRC-8 with polynomial x^8+x^2+x+1.

    >>> hex(crc8(b'123456789'))
    '0xf4'
    """
    table = crc_table(8, CRC8_POLYNOMIAL)
    crc = initial
    for b in data:
        crc = int(table[b ^ crc])
    return crc


def crc16(data: bytes, initial: int = 0) -> int:
    """CRC-16 with polynomial x^16+x^15+x^2+1.

    >>> hex(crc16(b'123456789'))
    '0xfee8'
    """
    table = crc_table(16, CRC16_POLYNOMIAL)
    crc = initial
    for b in data:
        crc = int(table[(crc >> 8) ^ b]) ^ ((crc << 8) & 0xFFFF)
    return crc
