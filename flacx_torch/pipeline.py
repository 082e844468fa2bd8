"""The file encode: WAV PCM in, a finished FLAC stream out.

Full blocks stream through :class:`flacx_torch.encoder.BatchEncoder` on the
device, ``batch_frames`` at a time with two batches in flight; the (at
most one) short final block goes through the pure-Python oracle encoder,
as do blocks too small for the batched pipeline and every block under
``oracle=True``.  The stream writer computes the MD5 and patches
STREAMINFO on finalize.  The same keyword arguments and bytes as the JAX
package's ``pipeline`` module, with ``device`` the torch device (the card
by default) and ``oracle=True`` in place of its ``device=False``.
"""

from __future__ import annotations

import io
from typing import BinaryIO

import numpy as np
import torch

from flacx_torch.device import resolve_device
from flacx_torch.encoder import (BatchEncoder, EncoderConfig,
                                 device_min_block_size)
from flacx_torch.format import INDEPENDENT_CHANNELS
from flacx_torch.oracle.encoder import EncoderParameters, encode_frame
from flacx_torch.stream import StreamWriter


def _oracle_frame(pcm_rows: np.ndarray, index: int, bps: int,
                  block_size: int, max_lpc_order: int, qlp_precision: int,
                  partition_orders: tuple[int, ...]) -> bytes:
    """One frame of interleaved ``[n, channels]`` PCM from the oracle
    encoder, with the pipeline's settings."""
    channels = pcm_rows.shape[1]
    params = EncoderParameters(
        block_size=block_size,
        rice_partition_order=range(min(partition_orders),
                                   max(partition_orders) + 1),
        lpc_order=range(0, max_lpc_order + 1),
        qlp_precision=qlp_precision)
    planar = [list(map(int, pcm_rows[:, c])) for c in range(channels)]
    return encode_frame(planar, INDEPENDENT_CHANNELS[channels], index, bps,
                        params)


def encode_chunks_to_file(f: BinaryIO, chunks, *, sample_rate: int,
                          bps: int, channels: int, block_size: int,
                          max_lpc_order: int, qlp_precision: int,
                          partition_orders: tuple[int, ...],
                          total_samples: int | None = None,
                          batch_frames: int = 256, stereo: str = "auto",
                          device: str | torch.device = "cuda",
                          oracle: bool = False, wasted_bits: bool = False,
                          escapes: bool = True,
                          order_search: str = "estimate", sharding=None,
                          collect_stats: bool = False,
                          windows: tuple[str, ...] = ("tukey(0.5)",),
                          conformance: bool = False) -> dict:
    """Constant-memory encode of a PCM chunk stream into ``f`` (seekable).

    ``chunks`` is an iterable of interleaved int32 ``[n, channels]``
    arrays of any sizes; peak memory is O(batch_frames · block_size)
    whatever the stream's length.  Pass ``total_samples=None`` for
    unknown-length streams; the true count is patched into STREAMINFO on
    finalize.  Output bytes equal :func:`encode_to_file`'s.  ``sharding``
    splits each batch over a mesh's devices (:class:`flacx_torch.encoder.
    BatchEncoder`), with the same bytes.  Returns ``samples``, ``frames``,
    ``bytes_in`` and ``bytes_out`` (and ``stats`` with ``collect_stats``
    on the batched path).
    """
    dev = resolve_device(device)
    if block_size < device_min_block_size(max_lpc_order):
        # the batched analysis needs 2·max(order, 4) + 2 samples a block
        oracle = True
    writer = StreamWriter(f, sample_rate, bps, channels, total_samples,
                          block_size)
    run_stats: dict | None = {} if collect_stats else None
    batch_samples = block_size * batch_frames
    state = {"seen": 0, "tail": None}

    # ≤ 16-bit content crosses to the device as int16 (half the bytes)
    stage_dt = np.int16 if bps <= 16 else np.int32

    def full_block_batches():
        """Cut the chunk stream into [F <= batch, C, N] planar batches."""
        buf = np.zeros((0, channels), np.int32)
        for chunk in chunks:
            chunk = np.ascontiguousarray(chunk, np.int32)
            if chunk.ndim != 2 or chunk.shape[1] != channels:
                raise ValueError("chunk must be [n, channels]")
            writer.add_pcm(chunk)
            state["seen"] += chunk.shape[0]
            buf = chunk if not buf.shape[0] else np.concatenate([buf, chunk])
            while buf.shape[0] >= batch_samples:
                cut, buf = buf[:batch_samples], buf[batch_samples:]
                yield (cut.reshape(batch_frames, block_size, channels)
                       .transpose(0, 2, 1).astype(stage_dt))
        n_left = buf.shape[0] // block_size
        state["tail"] = buf[n_left * block_size:]
        if n_left:
            yield (buf[: n_left * block_size]
                   .reshape(n_left, block_size, channels)
                   .transpose(0, 2, 1).astype(stage_dt))

    def oracle_frame(rows: np.ndarray, index: int) -> bytes:
        return _oracle_frame(rows, index, bps, block_size, max_lpc_order,
                             qlp_precision, partition_orders)

    if oracle:
        index = 0
        for batch in full_block_batches():
            for blk in batch:                       # [C, N] → rows [N, C]
                writer.write_frame(oracle_frame(blk.T, index))
                index += 1
    else:
        cfg = EncoderConfig(
            sample_rate=sample_rate, bps=bps, channels=channels,
            block_size=block_size, max_lpc_order=max_lpc_order,
            qlp_precision=qlp_precision, partition_orders=partition_orders,
            stereo=stereo, wasted_bits=wasted_bits, escapes=escapes,
            order_search=order_search, windows=windows,
            conformance=conformance)
        enc = BatchEncoder(cfg, batch_frames=batch_frames, device=dev,
                           sharding=sharding)
        writer.write_frames(enc.encode_frame_stream(
            full_block_batches(), 0, stats=run_stats))

    total = state["seen"]
    n_full = total // block_size
    tail = state["tail"]
    if tail is not None and tail.shape[0]:
        writer.write_frame(oracle_frame(tail, n_full))

    writer.finalize()
    result = {
        "samples": total,
        "frames": n_full + (1 if total % block_size else 0),
        "bytes_in": total * channels * ((bps + 7) // 8),
        "bytes_out": f.tell(),
    }
    if collect_stats and not oracle:
        result["stats"] = run_stats
    return result


def encode_to_file(f: BinaryIO, pcm: np.ndarray, *, sample_rate: int,
                   bps: int, channels: int, block_size: int,
                   max_lpc_order: int, qlp_precision: int,
                   partition_orders: tuple[int, ...], batch_frames: int = 256,
                   stereo: str = "auto", device: str | torch.device = "cuda",
                   oracle: bool = False, wasted_bits: bool = False,
                   escapes: bool = True, order_search: str = "estimate",
                   sharding=None, collect_stats: bool = False,
                   windows: tuple[str, ...] = ("tukey(0.5)",),
                   conformance: bool = False) -> dict:
    """Encode interleaved PCM ``[frames, channels]`` into ``f`` (seekable):
    :func:`encode_chunks_to_file` on one chunk (the same bytes)."""
    return encode_chunks_to_file(
        f, [pcm], sample_rate=sample_rate, bps=bps, channels=channels,
        block_size=block_size, max_lpc_order=max_lpc_order,
        qlp_precision=qlp_precision, partition_orders=partition_orders,
        total_samples=pcm.shape[0], batch_frames=batch_frames,
        stereo=stereo, device=device, oracle=oracle,
        wasted_bits=wasted_bits, escapes=escapes, order_search=order_search,
        sharding=sharding, collect_stats=collect_stats, windows=windows,
        conformance=conformance)


def encode_best(f: BinaryIO, pcm: np.ndarray, *, sample_rate: int, bps: int,
                channels: int,
                block_sizes: tuple[int, ...] = (1152, 2304, 4608),
                max_lpc_order: int = 12, qlp_precision: int = 5,
                partition_orders: tuple[int, ...] = (0, 1, 2, 3, 4, 5),
                batch_frames: int = 256, stereo: str = "auto",
                wasted_bits: bool = False,
                windows: tuple[str, ...] = ("tukey(0.5)", "hann",
                                            "flattop"),
                device: str | torch.device = "cuda") -> dict:
    """Best-compression sweep (``encode --best``): encode the PCM at every
    candidate block size with the exact order search over ``windows`` and
    write the smallest result to ``f``; its stats gain ``block_size``."""
    best = None
    for bs in block_sizes:
        buf = io.BytesIO()
        stats = encode_to_file(
            buf, pcm, sample_rate=sample_rate, bps=bps, channels=channels,
            block_size=bs, max_lpc_order=max_lpc_order,
            qlp_precision=qlp_precision, partition_orders=partition_orders,
            batch_frames=batch_frames, stereo=stereo, device=device,
            wasted_bits=wasted_bits, order_search="exact", windows=windows)
        if best is None or stats["bytes_out"] < best[1]["bytes_out"]:
            best = (buf.getvalue(), stats, bs)
    f.write(best[0])
    best[1]["block_size"] = best[2]
    return best[1]
