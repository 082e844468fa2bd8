"""Host-side MSB-first bit I/O (the oracle codec and STREAMINFO).

The writer keeps one unbounded integer accumulator and flushes whole bytes
lazily; the reader services requests from a refillable integer window
over the buffer.
"""

from __future__ import annotations


def mask(n: int) -> int:
    """Lowest ``n`` bits set.

    >>> bin(mask(0)), bin(mask(3))
    ('0b0', '0b111')
    """
    return (1 << n) - 1


class BitWriter:
    """MSB-first bit accumulator producing ``bytes``.

    >>> w = BitWriter(); w.write_uint(0b101, 3); w.write_unary(2)
    >>> w.pad_to_byte(); w.getvalue()
    b'\\xa4'
    """

    def __init__(self) -> None:
        self._out = bytearray()
        self._acc = 0        # pending bits, MSB-first, value < 2**_nbits
        self._nbits = 0      # number of pending bits (< 8 after a write)

    @property
    def bits_until_alignment(self) -> int:
        return (-self._nbits) % 8

    def write_uint(self, value: int, nbits: int) -> None:
        """Append the low ``nbits`` bits of ``value`` (two's complement for
        negatives), most significant bit first."""
        if nbits == 0:
            return
        self._acc = (self._acc << nbits) | (value & mask(nbits))
        self._nbits += nbits
        if self._nbits >= 8:
            whole, rem = divmod(self._nbits, 8)
            self._out += (self._acc >> rem).to_bytes(whole, "big")
            self._acc &= mask(rem)
            self._nbits = rem

    def write_sint(self, value: int, nbits: int) -> None:
        self.write_uint(value, nbits)

    def write_bool(self, value: bool) -> None:
        self.write_uint(1 if value else 0, 1)

    def write_bytes(self, data: bytes) -> None:
        if self._nbits:
            raise ValueError("byte write requires alignment")
        self._out += data

    def write_unary(self, q: int) -> None:
        """``q`` zero bits followed by a one bit (FLAC unary)."""
        self.write_uint(1, q + 1)

    def pad_to_byte(self) -> None:
        self.write_uint(0, self.bits_until_alignment)

    def getvalue(self) -> bytes:
        if self._nbits:
            raise ValueError("bitstream not byte-aligned")
        return bytes(self._out)


class BitReader:
    """MSB-first bit reader over a ``bytes``/``memoryview`` buffer.

    >>> r = BitReader(bytes([0b11010001]))
    >>> r.read_uint(1), r.read_sint(3), r.read_unary()
    (1, -3, 3)
    """

    def __init__(self, data: bytes) -> None:
        self._data = memoryview(data)
        self._pos = 0        # next unread byte index
        self._acc = 0        # look-ahead bits (MSB-first), < 2**_nbits
        self._nbits = 0

    @property
    def bit_position(self) -> int:
        """Absolute bit offset from the start of the buffer."""
        return 8 * self._pos - self._nbits

    @property
    def bits_until_alignment(self) -> int:
        return self._nbits % 8

    def at_eof(self) -> bool:
        return self._nbits == 0 and self._pos >= len(self._data)

    def _refill(self, need: int) -> None:
        want_bytes = (need - self._nbits + 7) >> 3
        end = self._pos + want_bytes
        chunk = self._data[self._pos:end]
        if len(chunk) < want_bytes:
            raise EOFError("bitstream exhausted")
        self._acc = (self._acc << (8 * want_bytes)) | int.from_bytes(chunk,
                                                                     "big")
        self._nbits += 8 * want_bytes
        self._pos = end

    def read_uint(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        if nbits > self._nbits:
            self._refill(nbits)
        rem = self._nbits - nbits
        value = self._acc >> rem
        self._acc &= mask(rem)
        self._nbits = rem
        return value

    def read_sint(self, nbits: int) -> int:
        x = self.read_uint(nbits)
        return x - ((x >> (nbits - 1)) << nbits)

    def read_bool(self) -> bool:
        return self.read_uint(1) == 1

    def read_bytes(self, n: int) -> bytes:
        if self._nbits % 8:
            raise ValueError("byte read requires alignment")
        out = bytearray()
        while self._nbits and n:
            out.append(self.read_uint(8))
            n -= 1
        chunk = self._data[self._pos:self._pos + n]
        if len(chunk) < n:
            raise EOFError("bitstream exhausted")
        self._pos += n
        return bytes(out) + bytes(chunk)

    def read_unary(self) -> int:
        """Count zero bits until (and consuming) the terminating one bit."""
        q = 0
        while True:
            if self._nbits == 0:
                self._refill(1)
            if self._acc == 0:
                q += self._nbits
                self._nbits = 0
                continue
            lead = self._nbits - self._acc.bit_length()
            q += lead
            self._nbits -= lead + 1
            self._acc &= mask(self._nbits)
            return q
