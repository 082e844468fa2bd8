"""flacx_torch's batched encoder end to end against flacx on the CPU.

The headline configuration (block 4608, LPC order 12, 16-bit stereo) on
tonal and noise frames: the port's plain path must write the same bytes
as ``flacx.encoder._encode_batch`` wherever the two chose the same
coefficients, and every frame must decode bit-exactly under flacx's
oracle decoder and its batched ``decode_array``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import flacx.ops  # noqa: F401  (x64)
import jax
import jax.numpy as jnp
from flacx.bitio import BitReader
from flacx.decoder import decode_array
from flacx.encoder import EncoderConfig as FxConfig
from flacx.encoder import _encode_batch as fx_encode_batch
from flacx.format import MAGIC, MetadataBlockType, Streaminfo
from flacx.oracle.decoder import read_frame
from flacx.oracle.encoder import (serialize_metadata_header,
                                  serialize_streaminfo)

from flacx_torch.encoder import (BatchEncoder, EncoderConfig,
                                 _encode_batch, config_from_flacx)
from flacx_torch.ops.lpc import apodization_window_np, window_from_numpy
from flacx_torch.oracle.decoder import read_frame as own_read_frame

from conftest import make_pcm

torch.set_num_threads(1)

N = 4608
FX_CFG = FxConfig(block_size=N, max_lpc_order=12)


def planar_frames(seed: int, frames: int, kind: str) -> np.ndarray:
    """``[frames, 2, N]`` int32 16-bit stereo blocks."""
    pcm = make_pcm(np.random.default_rng(seed), frames * N, 2, 16, kind)
    return np.ascontiguousarray(pcm.reshape(frames, N, 2).transpose(0, 2, 1))


@pytest.fixture(scope="module")
def batch():
    """Four tonal and four noise frames, and flacx's encoding of them."""
    pcm = np.concatenate([planar_frames(1, 4, "tonal"),
                          planar_frames(2, 4, "noise")])
    fn = jax.jit(functools.partial(fx_encode_batch, FX_CFG))
    ref = {k: np.asarray(v) for k, v in
           fn(jnp.asarray(pcm), jnp.int64(5)).items()}
    return pcm, ref


def frames_of(out: dict) -> list[bytes]:
    data, lens = np.asarray(out["bytes"]), np.asarray(out["length"])
    return [bytes(data[i, :lens[i]]) for i in range(len(lens))]


def subframe_params(frame_bytes: bytes) -> tuple:
    si = Streaminfo(N, N, 0, 0, 44100, 2, 16, 0, bytes(16))
    frame, _ = read_frame(BitReader(frame_bytes), si)
    return (frame.header.channels,
            tuple((sf.kind, sf.order, sf.shift, sf.coefficients)
                  for sf in frame.subframes))


def flac_stream(frames: list[bytes], n_frames: int) -> bytes:
    si = Streaminfo(N, N, 0, 0, 44100, 2, 16, N * n_frames, bytes(16))
    return (MAGIC + serialize_metadata_header(True,
                                              MetadataBlockType.Streaminfo,
                                              34)
            + serialize_streaminfo(si) + b"".join(frames))


def port_encode(cfg: EncoderConfig, pcm: np.ndarray, first: int) -> dict:
    window = window_from_numpy(
        apodization_window_np(cfg.windows[0], cfg.block_size)
        .astype(np.float32))
    return _encode_batch(cfg, torch.from_numpy(pcm), first, window)


def test_encode_batch_matches_flacx_and_decodes(batch):
    pcm, ref = batch
    cfg = config_from_flacx(dataclasses.asdict(FX_CFG))
    out = port_encode(cfg, pcm, 5)
    got, want = frames_of(out), frames_of(ref)
    equal = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            equal += 1
        else:
            assert subframe_params(g) != subframe_params(w), \
                f"frame {i}: same coefficients, different bytes"
    assert equal >= len(got) - 1
    for key in ("kind", "channel_code", "subframe_bits"):
        np.testing.assert_array_equal(out[key].numpy(), ref[key])

    si = Streaminfo(N, N, 0, 0, 44100, 2, 16, 0, bytes(16))
    for i, g in enumerate(got):
        _, planes = read_frame(BitReader(g), si)
        np.testing.assert_array_equal(np.asarray(planes), pcm[i])
    _, decoded = decode_array(flac_stream(got, len(got)), device=False)
    np.testing.assert_array_equal(
        decoded, pcm.transpose(0, 2, 1).reshape(-1, 2))


def test_batch_encoder_streams_in_small_batches(batch):
    """Batches of 3 (the last one padded), at most two in flight, int16
    input: the same frames as one direct batch."""
    pcm, _ = batch
    cfg = EncoderConfig(block_size=N, max_lpc_order=12)
    direct = frames_of(port_encode(cfg, pcm, 10))
    enc = BatchEncoder(cfg, batch_frames=3, device="cpu")
    stats = {}
    got = enc.encode_frames(pcm.astype(np.int16), 10, stats)
    assert got == direct
    assert stats["frame_bytes"] == sum(map(len, got))
    assert sum(stats["subframe_kinds"].values()) == 2 * len(pcm)
    assert sum(stats["stereo_modes"].values()) == len(pcm)
    with pytest.raises(TypeError):
        enc.encode_batch_device(pcm.astype(np.float32), 0)
    with pytest.raises(ValueError):
        enc.encode_batch_device(pcm[:, :1], 0)
    with pytest.raises(ValueError):
        next(enc.encode_frame_stream([pcm[:4]]))


@pytest.mark.parametrize("changes,later", [
    # encodes since the conformance slice (the reference's choices)
    ({"conformance": True, "order_search": "exact"}, None),
    ({"conformance": True}, None),
    # encodes since the 25- to 32-bit slice (an int64 working type)
    ({"bps": 25}, None),
    ({"bps": 24}, None),
    ({"bps": 24, "windows": ("tukey(0.5)", "hann")}, None),
    ({"partition_orders": tuple(range(10))}, None),
    ({"partition_orders": tuple(range(10)), "order_search": "exact",
      "wasted_bits": True}, None),
    ({"max_lpc_order": 32, "qlp_precision": 15}, None),
    # refused past the int32 MAC bound until lpc_allorder's wide MAC
    pytest.param({"max_lpc_order": 32, "qlp_precision": 15,
                  "order_search": "exact"}, None, id="changes7-int32 MAC"),
    ({"bps": 32}, None),
])
def test_unsupported_configs_raise(changes, later):
    """What the port would refuse raises on every device (nothing is left
    to refuse); what the hi-res, file, conformance and 25- to 32-bit
    slices brought (24-bit, 512 partitions, order 32 at precision 15 in
    either order search, conformance mode, samples of 25 and 32 bits)
    encodes a frame that decodes bit-exactly."""
    cfg = EncoderConfig(block_size=N, **changes)
    if later is not None:
        with pytest.raises(NotImplementedError, match=later):
            BatchEncoder(cfg, device="cpu")
        with pytest.raises(NotImplementedError, match=later):
            port_encode(cfg, np.zeros((1, cfg.channels, N), np.int32), 0)
        return
    pcm = make_pcm(np.random.default_rng(11), N, 2, cfg.bps, "tonal")
    planar = np.ascontiguousarray(pcm.T[None])
    frames = BatchEncoder(cfg, batch_frames=1, device="cpu") \
        .encode_frames(planar, 0)
    _, planes = own_read_frame(frames[0], cfg.bps)
    np.testing.assert_array_equal(np.asarray(planes), planar[0])


def test_rice_shared_memory_refusal_is_the_same_on_every_device():
    """Partition counts past ``rice_stats``' shared memory and frames past
    a block's shared memory are not refused: ``rice_stats`` cuts a row
    into more segments, from the configuration alone, and ``frame_pack``
    packs chunks of a fixed slot count whatever the frame's size; the
    encoder accepts them."""
    from flacx_torch.kernels import frame_pack as k_fp
    from flacx_torch.kernels import rice_stats as k_rs
    ok = EncoderConfig(block_size=N, partition_orders=tuple(range(9)))
    many = EncoderConfig(block_size=N, partition_orders=tuple(range(10)))
    assert k_rs.segment_log2(N, max(ok.porders), ok.kmax) == 1
    assert k_rs.segment_log2(N, max(many.porders), many.kmax) == 2
    assert k_rs.segment_log2(N, 5, ok.kmax) == 0
    hires = dict(block_size=16384, max_lpc_order=32, bps=24,
                 partition_orders=tuple(range(16)))
    stereo = EncoderConfig(**hires)
    six = EncoderConfig(**hires, channels=6)
    assert (stereo.max_frame_bytes, six.max_frame_bytes) == (102656, 295168)
    # past a Hopper block's 232,448 bytes: one route all the same, a
    # chunk's words (4 B a slot at most) in 48 KB of static shared memory
    assert stereo.max_frame_bytes < 232448 < six.max_frame_bytes
    assert 4 * k_fp.CHUNK_SLOTS <= 48 * 1024
    assert k_rs.segment_log2(stereo.block_size, max(stereo.porders),
                             stereo.kmax) == 6
    for cfg in (many, stereo, six):
        BatchEncoder(cfg, device="cpu")


def test_batch_encoder_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchEncoder(EncoderConfig())
