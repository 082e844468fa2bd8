"""Oracle stream encoder (pure Python, reference-byte-identical).

The port's own copy of the JAX package's ``oracle/encoder.py`` (that
module imports no JAX, but the port imports nothing of that package).  The
file pipeline encodes the short last frame with it, and blocks under
``encoder.device_min_block_size``; ``encode --no-device`` encodes every
frame with it.

Surface parity: reference flac/encoder.py ``encode(sample_rate, sample_size,
channels, frames, samples, parameters) -> Iterator[bytes]``
(flac/encoder.py:48-55), same defaults and parameter semantics.

Differences from the reference, all deliberate (SURVEY.md §2.3 fixes):
* the frame header carries the *actual* channel layout instead of a
  hardcoded stereo L/R (reference flac/encoder.py:96 corrupts mono files),
* constant blocks produce Constant subframes (silence crashes the
  reference),
* fixed/LPC ties pick fixed instead of asserting.
For inputs that don't trigger those defects the output is byte-identical.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Iterator

import flacx_torch.coded_number as coded_number
from flacx_torch.bitio import BitWriter
from flacx_torch.crc import crc8, crc16
from flacx_torch.format import (INDEPENDENT_CHANNELS, MAGIC,
                                FRAME_SYNC_CODE, BlockingStrategy, Channels,
                                MetadataBlockType, Residual,
                                RiceCodingMethod, Streaminfo, Subframe,
                                SubframeKind, encode_block_size_bits,
                                encode_sample_rate_bits,
                                encode_sample_size_bits)
from flacx_torch.oracle.analyze import SubframePlan, plan_subframe
from flacx_torch.utils import batch, zigzag_encode


@dataclass
class EncoderParameters:
    """Parity: reference flac/encoder.py:33-43 (same fields and checks)."""
    block_size: int = 4608
    rice_partition_order: range = field(default_factory=lambda: range(0, 6))
    lpc_order: range = field(default_factory=lambda: range(0, 13))
    qlp_precision: int = 5
    #: Admit escaped Rice partitions where strictly smaller.  Default OFF:
    #: byte-parity with the reference encoder (which cannot write them,
    #: flac/encoder.py:770-772) is the oracle's contract.
    use_escapes: bool = False

    def __post_init__(self) -> None:
        if self.lpc_order.start != 0:
            raise ValueError("lpc_order must start at 0")
        if self.lpc_order.stop > 33:
            raise ValueError("max LPC order is 32")
        if self.qlp_precision < 5:
            raise ValueError("qlp precision must be >= 5")

    @property
    def max_lpc_order(self) -> int:
        return self.lpc_order.stop - 1


# ---------------------------------------------------------------------------
# Stream assembly

def encode_stream(sample_rate: int, sample_size: int, channels: int,
                  frames: int, samples: Iterable[list[int]],
                  parameters: EncoderParameters) -> Iterator[bytes]:
    """Encode interleaved PCM rows into a FLAC stream, one frame per yield.

    Parity: reference flac/encoder.py:48-165 (incl. the subset guard at
    encoder.py:56-57).
    """
    if sample_rate <= 48_000 and parameters.lpc_order.stop > 13:
        raise ValueError("subset streams at <= 48 kHz require LPC order <= 12")

    yield MAGIC
    yield serialize_metadata_header(last=True,
                                    type_=MetadataBlockType.Streaminfo,
                                    length=34)
    yield serialize_streaminfo(Streaminfo(
        min_block_size=parameters.block_size,
        max_block_size=parameters.block_size,
        min_frame_size=0, max_frame_size=0,
        sample_rate=sample_rate, channels=channels,
        sample_size=sample_size, samples=frames, md5=bytes(16)))

    layout = INDEPENDENT_CHANNELS[channels]
    for index, rows in enumerate(batch(samples, parameters.block_size)):
        planar = [[row[c] for row in rows] for c in range(channels)]
        yield encode_frame(planar, layout, index, sample_size, parameters)


def encode_frame(planar: list[list[int]], layout: Channels, index: int,
                 sample_size: int, parameters: EncoderParameters,
                 blocking: BlockingStrategy = BlockingStrategy.Fixed
                 ) -> bytes:
    """Analyze + serialize one frame from planar per-channel samples."""
    block_size = len(planar[0])
    plans = [
        plan_subframe(ch, block_size, parameters.max_lpc_order,
                      parameters.qlp_precision,
                      parameters.rice_partition_order,
                      use_escapes=parameters.use_escapes)
        for ch in planar
    ]
    return serialize_frame(plans, layout, index, block_size, sample_size,
                           blocking=blocking)


# ---------------------------------------------------------------------------
# Serializers

def serialize_metadata_header(last: bool, type_: MetadataBlockType,
                              length: int) -> bytes:
    w = BitWriter()
    w.write_bool(last)
    w.write_uint(type_, 7)
    w.write_uint(length, 24)
    return w.getvalue()


def serialize_streaminfo(si: Streaminfo) -> bytes:
    """Parity: reference flac/encoder.py:178-189."""
    w = BitWriter()
    w.write_uint(si.min_block_size, 16)
    w.write_uint(si.max_block_size, 16)
    w.write_uint(si.min_frame_size, 24)
    w.write_uint(si.max_frame_size, 24)
    w.write_uint(si.sample_rate, 20)
    w.write_uint(si.channels - 1, 3)
    w.write_uint(si.sample_size - 1, 5)
    w.write_uint(si.samples, 36)
    w.write_bytes(si.md5)
    return w.getvalue()


def serialize_frame_header(layout: Channels, index: int, block_size: int,
                           sample_rate: int | None,
                           sample_size: int | None,
                           blocking: BlockingStrategy =
                           BlockingStrategy.Fixed) -> bytes:
    """Frame header incl. trailing CRC-8.

    Parity: reference flac/encoder.py:194-234.  The reference always writes
    sample rate and size as "from streaminfo" (encoder.py:94-97); callers
    preserve that by passing None.  Under ``BlockingStrategy.Variable``
    (a flacx extension) ``index`` is the frame's first sample number.
    """
    bs_code, bs_extra_bits, bs_extra = encode_block_size_bits(block_size)
    sr_code, sr_extra_bits, sr_extra = encode_sample_rate_bits(sample_rate)
    ss_code = encode_sample_size_bits(sample_size)

    w = BitWriter()
    w.write_uint(FRAME_SYNC_CODE, 15)
    w.write_uint(blocking, 1)
    w.write_uint(bs_code, 4)
    w.write_uint(sr_code, 4)
    w.write_uint(layout, 4)
    w.write_uint(ss_code, 3)
    w.write_uint(0, 1)
    w.write_bytes(coded_number.encode(index))
    if bs_extra_bits:
        w.write_uint(bs_extra, bs_extra_bits)
    if sr_extra_bits:
        w.write_uint(sr_extra, sr_extra_bits)
    header = w.getvalue()
    return header + bytes([crc8(header)])


def serialize_frame(plans: list[SubframePlan], layout: Channels, index: int,
                    block_size: int, sample_size: int,
                    blocking: BlockingStrategy = BlockingStrategy.Fixed
                    ) -> bytes:
    """Serialize analyzed subframes into a complete frame with CRC-16.

    Parity: reference flac/encoder.py:87-165 (header, subframes, zero
    padding to alignment, CRC-16 footer).
    """
    w = BitWriter()
    w.write_bytes(serialize_frame_header(layout, index, block_size,
                                         None, None, blocking=blocking))
    decorr = layout.decorrelation_bit
    for i, plan in enumerate(plans):
        write_subframe(w, plan, sample_size + decorr[i])
    w.pad_to_byte()
    body = w.getvalue()
    return body + int.to_bytes(crc16(body), 2, "big")


def write_subframe(w: BitWriter, plan: SubframePlan, bps: int) -> None:
    """Subframe header + payload.  Parity: flac/encoder.py:553-627."""
    sf = plan.subframe
    w.write_uint(0, 1)
    w.write_uint(_subframe_type_code(sf), 6)
    w.write_uint(0, 1)  # no wasted bits

    match sf.kind:
        case SubframeKind.Constant:
            w.write_sint(sf.constant, bps)
        case SubframeKind.Verbatim:
            for s in sf.verbatim:
                w.write_sint(s, bps)
        case SubframeKind.Fixed:
            for s in sf.warmup:
                w.write_sint(s, bps)
            write_residual(w, plan.residual_plan)
        case SubframeKind.LPC:
            for s in sf.warmup:
                w.write_sint(s, bps)
            w.write_uint(sf.precision - 1, 4)
            w.write_uint(sf.shift, 5)
            for c in sf.coefficients:
                w.write_sint(c, sf.precision)
            write_residual(w, plan.residual_plan)


def _subframe_type_code(sf: Subframe) -> int:
    match sf.kind:
        case SubframeKind.Constant:
            return 0b000000
        case SubframeKind.Verbatim:
            return 0b000001
        case SubframeKind.Fixed:
            return 0b001000 | sf.order
        case SubframeKind.LPC:
            return 0b100000 | (sf.order - 1)
    raise AssertionError(sf.kind)


def write_residual(w: BitWriter, plan: Residual) -> None:
    """Coding method, partition order, partitions.

    Parity: flac/encoder.py:765-807 (the unary quotient + binary remainder
    emitted here in two writes instead of per-bit calls).
    """
    w.write_uint(0 if plan.coding_method is RiceCodingMethod.Rice4Bit else 1,
                 2)
    w.write_uint(plan.partition_order, 4)
    width = plan.coding_method.value
    for part in plan.partitions:
        w.write_uint(part.parameter, width)
        if part.parameter == (1 << width) - 1:
            # escaped partition: 5-bit raw size + raw signed residuals
            w.write_uint(part.escaped_size, 5)
            for r in part.residual:
                w.write_sint(r, part.escaped_size)
        else:
            k = part.parameter
            for r in part.residual:
                u = zigzag_encode(r)
                w.write_unary(u >> k)
                w.write_uint(u, k)
