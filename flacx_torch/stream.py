"""Host-side stream assembly: metadata, frame concatenation, finalization.

Unlike the reference — which writes zero MD5 and zero min/max frame sizes
(flac/encoder.py:75-81) — the stream writer computes the audio MD5 and
patches real frame-size statistics into Streaminfo on close.  The port's
own copy of the JAX package's ``stream.py``.
"""

from __future__ import annotations

import hashlib
from typing import BinaryIO, Iterable

import numpy as np

from flacx_torch.format import MAGIC, MetadataBlockType, Streaminfo
from flacx_torch.oracle.encoder import (serialize_metadata_header,
                                        serialize_streaminfo)
from flacx_torch.wavio import pcm_to_le_bytes


class StreamWriter:
    """Writes a FLAC stream and finalizes Streaminfo in place."""

    def __init__(self, f: BinaryIO, sample_rate: int, bps: int,
                 channels: int, total_samples: int | None, block_size: int,
                 compute_md5: bool = True):
        """``total_samples=None`` streams an unknown-length input: the
        writer counts samples as they are fed and patches the true count
        into Streaminfo on :meth:`finalize` (the reference requires the
        count up front, flac/encoder.py:70)."""
        self._f = f
        self._bps = bps
        self._compute_md5 = compute_md5
        self._md5 = hashlib.md5() if compute_md5 else None
        self._min_frame = None
        self._max_frame = 0
        self._count_samples = total_samples is None
        self._seen_samples = 0
        self._streaminfo = Streaminfo(
            min_block_size=block_size, max_block_size=block_size,
            min_frame_size=0, max_frame_size=0, sample_rate=sample_rate,
            channels=channels, sample_size=bps, samples=total_samples or 0,
            md5=bytes(16))
        f.write(MAGIC)
        f.write(serialize_metadata_header(
            True, MetadataBlockType.Streaminfo, 34))
        self._si_offset = f.tell()
        f.write(serialize_streaminfo(self._streaminfo))

    def add_pcm(self, pcm: np.ndarray) -> None:
        """Feed raw interleaved PCM ``[frames, channels]`` into the MD5."""
        self._seen_samples += pcm.shape[0]
        if self._md5 is not None:
            self._md5.update(pcm_to_le_bytes(pcm, self._bps))

    def write_frame(self, frame: bytes) -> None:
        size = len(frame)
        self._min_frame = size if self._min_frame is None \
            else min(self._min_frame, size)
        self._max_frame = max(self._max_frame, size)
        self._f.write(frame)

    def write_frames(self, frames: Iterable[bytes]) -> None:
        for frame in frames:
            self.write_frame(frame)

    def finalize(self) -> None:
        """Patch Streaminfo with MD5 and frame-size statistics.

        (Per RFC 9639 the short final block does NOT lower the minimum
        block size field.)
        """
        si = self._streaminfo
        patched = Streaminfo(
            min_block_size=si.min_block_size, max_block_size=si.max_block_size,
            min_frame_size=self._min_frame or 0,
            max_frame_size=self._max_frame,
            sample_rate=si.sample_rate, channels=si.channels,
            sample_size=si.sample_size,
            samples=self._seen_samples if self._count_samples
            else si.samples,
            md5=self._md5.digest() if self._md5 else bytes(16))
        pos = self._f.tell()
        self._f.seek(self._si_offset)
        self._f.write(serialize_streaminfo(patched))
        self._f.seek(pos)
