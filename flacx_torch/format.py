"""The parts of the FLAC stream grammar the port uses, as data.

Own copy of the matching definitions in the JAX package's ``format``
module (RFC 9639 values), with the records and header-field encoders of
the oracle encoder; the port imports nothing of that package.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

import numpy as np

MAGIC = b"fLaC"

#: 15-bit frame sync code (0b111111111111100).
FRAME_SYNC_CODE = 0x7FFC

#: CRC generator polynomials (with the leading x^n term).
CRC8_POLYNOMIAL = 0x107        # x^8 + x^2 + x + 1
CRC16_POLYNOMIAL = 0x18005     # x^16 + x^15 + x^2 + 1

#: Fixed (polynomial) predictor taps for orders 0..4.
FIXED_PREDICTOR_COEFFICIENTS: tuple[tuple[int, ...], ...] = (
    (),
    (1,),
    (2, -1),
    (3, -3, 1),
    (4, -6, 4, -1),
)

#: Same table, zero-padded to shape [5, 4] (int32).
FIXED_PREDICTOR_TAPS = np.array(
    [list(c) + [0] * (4 - len(c)) for c in FIXED_PREDICTOR_COEFFICIENTS],
    dtype=np.int32,
)

#: Largest Rice parameter expressible by the 5-bit coding method (31=escape).
MAX_RICE_PARAMETER = 30


class MetadataBlockType(enum.IntEnum):
    Streaminfo = 0
    Padding = 1
    Application = 2
    Seektable = 3
    VorbisComment = 4
    Cuesheet = 5
    Picture = 6


@dataclass(frozen=True)
class MetadataBlockHeader:
    last: bool
    type: MetadataBlockType
    length: int


@dataclass(frozen=True)
class Streaminfo:
    min_block_size: int
    max_block_size: int
    min_frame_size: int
    max_frame_size: int
    sample_rate: int
    channels: int
    sample_size: int
    samples: int
    md5: bytes


class Channels(enum.IntEnum):
    """Channel assignment; the value is the 4-bit wire code."""
    M = 0b0000
    L_R = 0b0001
    L_R_C = 0b0010
    FL_FR_BL_BR = 0b0011
    FL_FR_FC_BL_BR = 0b0100
    FL_FR_FC_LFE_BL_BR = 0b0101
    FL_FR_FC_LFE_BC_SL_SR = 0b0110
    FL_FR_FC_LFE_BL_BR_SL_SR = 0b0111
    L_S = 0b1000   # left + side
    S_R = 0b1001   # side + right
    M_S = 0b1010   # mid + side

    @property
    def count(self) -> int:
        """Number of coded subframes."""
        if self in (Channels.L_S, Channels.S_R, Channels.M_S):
            return 2
        return int(self) + 1

    @property
    def decorrelation_bit(self) -> list[int]:
        """Extra sample-size bit of the side channel, per subframe."""
        if self in (Channels.L_S, Channels.M_S):
            return [0, 1]
        if self is Channels.S_R:
            return [1, 0]
        return [0] * self.count


#: Channel layout for a plain n-channel stream (no decorrelation).
INDEPENDENT_CHANNELS: dict[int, Channels] = {
    n: Channels(n - 1) for n in range(1, 9)}


class BlockingStrategy(enum.IntEnum):
    Fixed = 0
    Variable = 1


@dataclass(frozen=True)
class FrameHeader:
    blocking_strategy: BlockingStrategy
    block_size: int
    sample_rate: Optional[int]
    channels: Channels
    sample_size: Optional[int]
    coded_number: int
    crc: Optional[int] = None


class SubframeKind(enum.Enum):
    Constant = enum.auto()
    Verbatim = enum.auto()
    Fixed = enum.auto()
    LPC = enum.auto()


@dataclass(frozen=True)
class Subframe:
    """A decoded subframe; fields unused by its kind keep their defaults."""
    kind: SubframeKind
    order: int = 0
    wasted_bits: int = 0
    constant: int = 0
    verbatim: tuple[int, ...] = ()
    warmup: tuple[int, ...] = ()
    precision: int = 0       # LPC only
    shift: int = 0           # LPC only
    coefficients: tuple[int, ...] = ()  # LPC only
    residual: tuple[int, ...] = ()      # signed residual (not zigzag)


@dataclass(frozen=True)
class Frame:
    header: FrameHeader
    subframes: tuple[Subframe, ...]
    crc: int = 0


class RiceCodingMethod(enum.IntEnum):
    """Value == parameter field width."""
    Rice4Bit = 4
    Rice5Bit = 5


@dataclass(frozen=True)
class RicePartition:
    parameter: int                  # escape if parameter == (1<<width)-1
    escaped_size: int = 0           # bits per raw sample when escaped
    residual: tuple[int, ...] = ()  # signed residual values


@dataclass(frozen=True)
class Residual:
    coding_method: RiceCodingMethod
    partition_order: int
    partitions: tuple[RicePartition, ...]


#: 4-bit encodings for common block sizes.
BLOCK_SIZE_ENCODING: dict[int, int] = {
    192: 0b0001,
    576: 0b0010, 1152: 0b0011, 2304: 0b0100, 4608: 0b0101,
    256: 0b1000, 512: 0b1001, 1024: 0b1010, 2048: 0b1011,
    4096: 0b1100, 8192: 0b1101, 16384: 0b1110, 32768: 0b1111,
}
BLOCK_SIZE_UNCOMMON8 = 0b0110   # followed by 8-bit (size - 1)
BLOCK_SIZE_UNCOMMON16 = 0b0111  # followed by 16-bit (size - 1)

SAMPLE_RATE_ENCODING: dict[int, int] = {
    88_200: 0b0001, 176_400: 0b0010, 192_000: 0b0011,
    8_000: 0b0100, 16_000: 0b0101, 22_050: 0b0110, 24_000: 0b0111,
    32_000: 0b1000, 44_100: 0b1001, 48_000: 0b1010, 96_000: 0b1011,
}
SAMPLE_RATE_FROM_STREAMINFO = 0b0000
SAMPLE_RATE_UNCOMMON8_KHZ = 0b1100   # + 8 bits, rate in kHz
SAMPLE_RATE_UNCOMMON16_HZ = 0b1101   # + 16 bits, rate in Hz
SAMPLE_RATE_UNCOMMON16_DAHZ = 0b1110  # + 16 bits, rate in tens of Hz
SAMPLE_RATE_DECODING = {v: k for k, v in SAMPLE_RATE_ENCODING.items()}

SAMPLE_SIZE_ENCODING: dict[int, int] = {
    8: 0b001, 12: 0b010, 16: 0b100, 20: 0b101, 24: 0b110, 32: 0b111,
}
SAMPLE_SIZE_FROM_STREAMINFO = 0b000
SAMPLE_SIZE_DECODING = {v: k for k, v in SAMPLE_SIZE_ENCODING.items()}


def encode_block_size_bits(size: int) -> tuple[int, int, int]:
    """Return ``(code4, extra_bits, extra_value)`` for a block size.

    ``extra_bits`` is 0, 8 or 16 trailing bits carrying ``size - 1``.
    """
    code = BLOCK_SIZE_ENCODING.get(size)
    if code is not None:
        return code, 0, 0
    if 1 <= size <= 256:
        return BLOCK_SIZE_UNCOMMON8, 8, size - 1
    if size <= 65536:
        return BLOCK_SIZE_UNCOMMON16, 16, size - 1
    raise ValueError(f"cannot encode block size {size}")


def encode_sample_rate_bits(sample_rate: Optional[int],
                            ) -> tuple[int, int, int]:
    """Return ``(code4, extra_bits, extra_value)`` for the sample-rate
    field; ``None`` means "read from streaminfo"."""
    if sample_rate is None:
        return SAMPLE_RATE_FROM_STREAMINFO, 0, 0
    code = SAMPLE_RATE_ENCODING.get(sample_rate)
    if code is not None:
        return code, 0, 0
    if sample_rate < 65536:
        return SAMPLE_RATE_UNCOMMON16_HZ, 16, sample_rate
    if sample_rate % 1000 == 0 and sample_rate // 1000 < 256:
        return SAMPLE_RATE_UNCOMMON8_KHZ, 8, sample_rate // 1000
    if sample_rate % 10 == 0 and sample_rate // 10 < 65536:
        return SAMPLE_RATE_UNCOMMON16_DAHZ, 16, sample_rate // 10
    raise ValueError(f"cannot encode sample rate {sample_rate}")


def encode_sample_size_bits(size: Optional[int]) -> int:
    """3-bit sample-size field; ``None`` = from streaminfo."""
    if size is None:
        return SAMPLE_SIZE_FROM_STREAMINFO
    code = SAMPLE_SIZE_ENCODING.get(size)
    if code is None:
        raise ValueError(f"cannot encode sample size {size}")
    return code
