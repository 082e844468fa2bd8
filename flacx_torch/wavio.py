"""Bulk WAV I/O.

The reference reads one PCM frame per call (``readframes(1)``,
flac/__main__.py:82-92) and converts each sample with ``int.from_bytes`` —
here whole files move through numpy in one shot (8/16/24/32-bit PCM).
The port's own copy of the JAX package's ``wavio.py``.
"""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np


def _raw_to_int32(raw: bytes, width: int) -> np.ndarray:
    """Little-endian PCM sample bytes → flat int32 (8-bit recentred)."""
    if width == 1:
        return np.frombuffer(raw, np.uint8).astype(np.int32) - 128
    if width == 2:
        return np.frombuffer(raw, "<i2").astype(np.int32)
    if width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.uint32)
        u = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        pcm = u.astype(np.int32)
        return np.where(pcm >= 1 << 23, pcm - (1 << 24), pcm)
    if width == 4:
        return np.frombuffer(raw, "<i4").astype(np.int32)
    raise ValueError(f"unsupported sample width {width}")


def wav_info(path: Path | str) -> tuple[int, int, int, int]:
    """Probe a PCM WAV header: ``(sample_rate, bps, channels, frames)``."""
    with wave.open(str(path), "rb") as w:
        return (w.getframerate(), w.getsampwidth() * 8, w.getnchannels(),
                w.getnframes())


def read_wav(path: Path | str) -> tuple[int, int, int, np.ndarray]:
    """Read a PCM WAV file.

    Returns ``(sample_rate, bits_per_sample, channels, pcm)`` with ``pcm``
    int32 ``[frames, channels]`` (8-bit WAV's unsigned samples are
    recentred to signed).
    """
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        width = w.getsampwidth()
        channels = w.getnchannels()
        frames = w.getnframes()
        raw = w.readframes(frames)
    return sr, width * 8, channels, _raw_to_int32(raw, width).reshape(
        -1, channels)


def read_wav_chunks(path: Path | str, chunk_frames: int):
    """Stream a PCM WAV file in ``chunk_frames``-sized pieces.

    Yields int32 ``[n, channels]`` arrays (the last may be short) while
    holding only one chunk in memory — the constant-memory ingest half of
    the streaming encode path (the reference achieves the same contract
    one sample at a time, flac/__main__.py:82-92).
    """
    with wave.open(str(path), "rb") as w:
        width = w.getsampwidth()
        channels = w.getnchannels()
        while True:
            raw = w.readframes(chunk_frames)
            if not raw:
                return
            yield _raw_to_int32(raw, width).reshape(-1, channels)


def pcm_to_le_bytes(pcm: np.ndarray, bps: int) -> bytes:
    """Interleaved little-endian sample bytes (the MD5/WAV payload form).

    Streaminfo MD5 covers each sample as ceil(bps/8) little-endian
    two's-complement bytes (RFC 9639 §8.2), so non-byte-aligned sizes
    (12, 20) pack like their 16/24-bit containers.
    """
    flat = pcm.reshape(-1)
    nbytes = (bps + 7) // 8
    if nbytes == 1:
        return flat.astype(np.int8).tobytes()
    if nbytes == 2:
        return flat.astype("<i2").tobytes()
    if nbytes == 3:
        u = flat.astype(np.int32).view(np.uint32) & 0xFFFFFF
        out = np.empty((flat.size, 3), np.uint8)
        out[:, 0] = u & 0xFF
        out[:, 1] = (u >> 8) & 0xFF
        out[:, 2] = (u >> 16) & 0xFF
        return out.tobytes()
    if nbytes == 4:
        return flat.astype("<i4").tobytes()
    raise ValueError(f"unsupported bits per sample {bps}")


def write_wav(path: Path | str, sample_rate: int, bps: int,
              pcm: np.ndarray) -> None:
    """Write int32 ``[frames, channels]`` PCM as a WAV file.

    Non-byte-aligned sample sizes (12, 20) are written into their
    ceil(bps/8)-byte container exactly as the MD5 payload packs them
    (RFC 9639 §8.2) — the same bytes ``pcm_to_le_bytes`` produces — so
    a 12-bit FLAC decodes to a 16-bit-container WAV that re-encodes to
    the identical stream.
    """
    payload = pcm_to_le_bytes(pcm, bps)
    if bps <= 8:  # WAV stores 8-bit audio unsigned
        payload = (np.frombuffer(payload, np.int8).astype(np.int16) + 128
                   ).astype(np.uint8).tobytes()
    with wave.open(str(path), "wb") as w:
        w.setnchannels(pcm.shape[1])
        w.setsampwidth((bps + 7) // 8)
        w.setframerate(sample_rate)
        w.writeframes(payload)


def write_wav_chunks(path: Path | str, sample_rate: int, bps: int,
                     channels: int, chunks) -> int:
    """Write a stream of int32 ``[n, channels]`` PCM chunks as a WAV file.

    The egress half of the constant-memory decode path: only one chunk is
    ever materialized as bytes (the ``wave`` module patches the header
    frame count on close, so the total length need not be known up
    front).  Returns the number of audio frames written.  Non-byte
    sample sizes use their ceil(bps/8)-byte container (see
    :func:`write_wav`).
    """
    frames = 0
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth((bps + 7) // 8)
        w.setframerate(sample_rate)
        for pcm in chunks:
            payload = pcm_to_le_bytes(pcm, bps)
            if bps <= 8:  # WAV stores 8-bit audio unsigned
                payload = (np.frombuffer(payload, np.int8)
                           .astype(np.int16) + 128).astype(np.uint8)\
                    .tobytes()
            w.writeframes(payload)
            frames += pcm.shape[0]
    return frames
