"""Host-side helpers of the CLI and the oracle encoder.

The port's own copy of the matching functions of the JAX package's
``utils.py`` (parity with the reference's ``flac/utils.py``).
"""

from __future__ import annotations

from itertools import islice
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")


def argparse_range(s: str) -> range:
    """Parse ``"N"`` or ``"M,N"`` into the inclusive range ``[M, N]`` as a
    half-open ``range(M, N + 1)`` (M defaults to 0).

    >>> argparse_range('5')
    range(0, 6)
    >>> argparse_range('2,5')
    range(2, 6)
    """
    parts = [int(p) for p in s.split(",")]
    if not 1 <= len(parts) <= 2:
        raise ValueError(f"expected 'N' or 'M,N', got {s!r}")
    if len(parts) == 2 and parts[0] >= parts[1]:
        raise ValueError(f"range must be strictly increasing, got {s!r}")
    lo, hi = (0, parts[0]) if len(parts) == 1 else (parts[0], parts[1])
    return range(lo, hi + 1)


def batch(it: Iterable[T], n: int) -> Iterator[list[T]]:
    """Chunk an iterable into lists of length ``n`` (last may be shorter).

    >>> [x for x in batch(iter('ABCDEFG'), 3)]
    [['A', 'B', 'C'], ['D', 'E', 'F'], ['G']]
    """
    if n < 1:
        raise ValueError("n must be greater than zero")
    it = iter(it)
    while chunk := list(islice(it, n)):
        yield chunk


def clamp(x: int, lo: int, hi: int) -> int:
    """Clamp ``x`` into ``[lo, hi]``."""
    return lo if x < lo else hi if x > hi else x


def zigzag_encode(x: int) -> int:
    """Map a signed integer to an unsigned 'folded' integer (64-bit word).

    >>> [zigzag_encode(v) for v in (0, -1, 1, -2, 2)]
    [0, 1, 2, 3, 4]
    """
    if not -(1 << 63) < x < (1 << 63):
        raise OverflowError(f"zigzag domain exceeded: {x}")
    return (x << 1) ^ (x >> 63)
