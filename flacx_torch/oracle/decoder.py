"""Oracle stream decoder (pure Python, strict).

Returns ``(sample_rate, sample_size, channels, samples_count, iterator)``.
Frame CRC-8 and CRC-16 are verified, the wasted-bits unary is decoded per
spec (count + 1) and the RFC 9639 uncommon sample-rate forms use their
kHz/daHz scaling.  The port uses it as the host-side verifier of the
frames its encoder writes.
"""

from __future__ import annotations

from typing import BinaryIO, Iterator

import flacx_torch.coded_number as coded_number
from flacx_torch.bitio import BitReader
from flacx_torch.crc import crc8, crc16
from flacx_torch.format import (FIXED_PREDICTOR_COEFFICIENTS,
                                FRAME_SYNC_CODE, MAGIC, SAMPLE_RATE_DECODING,
                                SAMPLE_SIZE_DECODING, BlockingStrategy,
                                Channels, Frame, FrameHeader,
                                MetadataBlockHeader, MetadataBlockType,
                                Streaminfo, Subframe, SubframeKind)


class FlacFormatError(ValueError):
    pass


def _expect(cond: bool, message: str) -> None:
    if not cond:
        raise FlacFormatError(message)


def zigzag_decode(x: int) -> int:
    """Inverse zigzag fold.

    >>> [zigzag_decode(v) for v in (0, 1, 2, 3, 4)]
    [0, -1, 1, -2, 2]
    """
    return (x >> 1) ^ -(x & 1)


# ---------------------------------------------------------------------------
# Stream level

def decode_stream(f: BinaryIO, verify_crc: bool = True,
                  ) -> tuple[int, int, int, int, Iterator[list[int]]]:
    """Parse a FLAC stream; yields interleaved PCM rows frame by frame."""
    data = f.read()
    r = BitReader(data)
    _expect(r.read_bytes(4) == MAGIC, "not a FLAC stream")

    streaminfo: Streaminfo | None = None
    while True:
        header = read_metadata_header(r)
        if header.type == MetadataBlockType.Streaminfo:
            _expect(streaminfo is None, "duplicate streaminfo")
            streaminfo = read_streaminfo(r)
        else:
            r.read_bytes(header.length)
        if header.last:
            break
    _expect(streaminfo is not None, "missing streaminfo")

    def rows() -> Iterator[list[int]]:
        while not r.at_eof():
            _, planar = read_frame(r, streaminfo.sample_size,
                                   verify_crc=verify_crc)
            for row in zip(*planar):
                yield list(row)

    return (streaminfo.sample_rate, streaminfo.sample_size,
            streaminfo.channels, streaminfo.samples, rows())


def read_metadata_header(r: BitReader) -> MetadataBlockHeader:
    last = r.read_bool()
    type_code = r.read_uint(7)
    try:
        btype = MetadataBlockType(type_code)
    except ValueError:
        raise FlacFormatError(
            f"invalid metadata block type {type_code}") from None
    return MetadataBlockHeader(last=last, type=btype,
                               length=r.read_uint(24))


def read_streaminfo(r: BitReader) -> Streaminfo:
    return Streaminfo(
        min_block_size=r.read_uint(16), max_block_size=r.read_uint(16),
        min_frame_size=r.read_uint(24), max_frame_size=r.read_uint(24),
        sample_rate=r.read_uint(20), channels=r.read_uint(3) + 1,
        sample_size=r.read_uint(5) + 1, samples=r.read_uint(36),
        md5=r.read_bytes(16))


# ---------------------------------------------------------------------------
# Frame level

def read_frame(r: BitReader | bytes, sample_size: int,
               verify_crc: bool = True,
               ) -> tuple[Frame, list[list[int]]]:
    """Parse one frame and reconstruct its PCM (planar, per channel).

    ``r`` is a reader positioned at a frame, or the frame's bytes;
    ``sample_size`` is the stream's bits per sample (frames written with
    the from-streaminfo sample-size code need it).
    """
    if not isinstance(r, BitReader):
        r = BitReader(r)
    frame_start = r.bit_position // 8
    header = read_frame_header(r, verify_crc=verify_crc)
    bps = header.sample_size or sample_size

    subframes = tuple(
        read_subframe(r, header.block_size,
                      bps + header.channels.decorrelation_bit[i])
        for i in range(header.channels.count))

    _expect(r.read_uint(r.bits_until_alignment) == 0, "nonzero frame padding")
    frame_end = r.bit_position // 8
    stored_crc = r.read_uint(16)
    if verify_crc:
        body = r._data[frame_start:frame_end]
        _expect(crc16(bytes(body)) == stored_crc, "frame CRC-16 mismatch")

    frame = Frame(header, subframes, stored_crc)
    return frame, reconstruct_frame(frame)


def read_frame_header(r: BitReader, verify_crc: bool = True) -> FrameHeader:
    start = r.bit_position // 8
    _expect(r.read_uint(15) == FRAME_SYNC_CODE, "bad frame sync")
    blocking = BlockingStrategy(r.read_uint(1))
    bs_code = r.read_uint(4)
    sr_code = r.read_uint(4)
    channels = Channels(r.read_uint(4))
    ss_code = r.read_uint(3)
    _expect(r.read_uint(1) == 0, "reserved frame header bit set")

    b0 = r.read_uint(8)
    extra = coded_number.following_bytes(b0)
    number = coded_number.decode(bytes([b0]) + (r.read_bytes(extra)
                                                if extra else b""))

    _expect(bs_code != 0, "reserved block size code")
    if bs_code == 0b0110:
        block_size = r.read_uint(8) + 1
    elif bs_code == 0b0111:
        block_size = r.read_uint(16) + 1
    elif bs_code == 0b0001:
        block_size = 192
    elif 0b0010 <= bs_code <= 0b0101:
        block_size = 144 << bs_code
    else:
        block_size = 1 << bs_code

    if sr_code == 0b0000:
        sample_rate = None
    elif sr_code in SAMPLE_RATE_DECODING:
        sample_rate = SAMPLE_RATE_DECODING[sr_code]
    elif sr_code == 0b1100:
        sample_rate = r.read_uint(8) * 1000
    elif sr_code == 0b1101:
        sample_rate = r.read_uint(16)
    elif sr_code == 0b1110:
        sample_rate = r.read_uint(16) * 10
    else:
        raise FlacFormatError("invalid sample rate code")

    if ss_code == 0b000:
        sample_size = None
    else:
        _expect(ss_code in SAMPLE_SIZE_DECODING, "reserved sample size code")
        sample_size = SAMPLE_SIZE_DECODING[ss_code]

    end = r.bit_position // 8
    stored_crc = r.read_uint(8)
    if verify_crc:
        _expect(crc8(bytes(r._data[start:end])) == stored_crc,
                "frame header CRC-8 mismatch")

    return FrameHeader(blocking, block_size, sample_rate, channels,
                       sample_size, number, stored_crc)


# ---------------------------------------------------------------------------
# Subframe level

def read_subframe(r: BitReader, block_size: int, bps: int) -> Subframe:
    _expect(r.read_uint(1) == 0, "reserved subframe header bit set")
    type_code = r.read_uint(6)
    wasted = 0
    if r.read_uint(1) == 1:
        wasted = r.read_unary() + 1  # spec: unary-coded (wasted - 1)
    eff_bps = bps - wasted

    if type_code == 0b000000:
        return Subframe(kind=SubframeKind.Constant, wasted_bits=wasted,
                        constant=r.read_sint(eff_bps))
    if type_code == 0b000001:
        return Subframe(kind=SubframeKind.Verbatim, wasted_bits=wasted,
                        verbatim=tuple(r.read_sint(eff_bps)
                                       for _ in range(block_size)))
    if 0b001000 <= type_code <= 0b001100:
        order = type_code & 0b111
        warmup = tuple(r.read_sint(eff_bps) for _ in range(order))
        residual = read_residual(r, block_size, order)
        return Subframe(kind=SubframeKind.Fixed, order=order,
                        wasted_bits=wasted, warmup=warmup, residual=residual)
    if type_code >= 0b100000:
        order = (type_code & 0b11111) + 1
        warmup = tuple(r.read_sint(eff_bps) for _ in range(order))
        precision = r.read_uint(4)
        _expect(precision != 0b1111, "invalid qlp precision")
        precision += 1
        shift = r.read_sint(5)
        coefs = tuple(r.read_sint(precision) for _ in range(order))
        residual = read_residual(r, block_size, order)
        return Subframe(kind=SubframeKind.LPC, order=order,
                        wasted_bits=wasted, warmup=warmup,
                        precision=precision, shift=shift,
                        coefficients=coefs, residual=residual)
    raise FlacFormatError(f"reserved subframe type {type_code:#08b}")


def read_residual(r: BitReader, block_size: int,
                  predictor_order: int) -> tuple[int, ...]:
    method_code = r.read_uint(2)
    _expect(method_code <= 1, "reserved residual coding method")
    width = 4 if method_code == 0 else 5
    escape = (1 << width) - 1
    order = r.read_uint(4)
    nparts = 1 << order
    _expect(block_size % nparts == 0, "partition count does not divide block")
    psize = block_size >> order
    _expect(psize > predictor_order, "partition smaller than predictor order")

    out: list[int] = []
    for p in range(nparts):
        count = psize - (predictor_order if p == 0 else 0)
        param = r.read_uint(width)
        if param == escape:
            raw = r.read_uint(5)
            out.extend(r.read_sint(raw) if raw else 0 for _ in range(count))
        else:
            for _ in range(count):
                q = r.read_unary()
                u = (q << param) | r.read_uint(param)
                out.append(zigzag_decode(u))
    return tuple(out)


# ---------------------------------------------------------------------------
# Reconstruction

def reconstruct_subframe(sf: Subframe, block_size: int) -> list[int]:
    match sf.kind:
        case SubframeKind.Constant:
            out = [sf.constant] * block_size
        case SubframeKind.Verbatim:
            out = list(sf.verbatim)
        case SubframeKind.Fixed | SubframeKind.LPC:
            coefs = (FIXED_PREDICTOR_COEFFICIENTS[sf.order]
                     if sf.kind is SubframeKind.Fixed else sf.coefficients)
            shift = sf.shift if sf.kind is SubframeKind.LPC else 0
            out = list(sf.warmup) + list(sf.residual)
            for i in range(sf.order, len(out)):
                acc = 0
                for j, c in enumerate(coefs):
                    acc += out[i - 1 - j] * c
                out[i] += acc >> shift
        case _:
            raise AssertionError(sf.kind)
    if sf.wasted_bits:
        out = [x << sf.wasted_bits for x in out]
    return out


def reconstruct_frame(frame: Frame) -> list[list[int]]:
    """Undo stereo decorrelation."""
    n = frame.header.block_size
    chans = [reconstruct_subframe(sf, n) for sf in frame.subframes]
    match frame.header.channels:
        case Channels.L_S:
            left, side = chans
            return [left, [l - s for l, s in zip(left, side)]]
        case Channels.S_R:
            side, right = chans
            return [[s + r for s, r in zip(side, right)], right]
        case Channels.M_S:
            mid, side = chans
            right = [m - (s >> 1) for m, s in zip(mid, side)]
            left = [r + s for r, s in zip(right, side)]
            return [left, right]
        case _:
            return chans
