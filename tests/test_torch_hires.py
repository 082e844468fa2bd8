"""flacx_torch's hi-res path against flacx on the CPU.

24-bit samples, LPC order 32 and partition orders 0..15 (one-sample
partitions): the wide (int64) MAC of ``lpc_residual``, the Rice plan at
many partitions, and the whole encode of the hi-res configuration scaled
to block 1024 (``tests/test_device_encoder.py::test_hires_config``) for
stereo, six channels and qlp precision 15.  The port's plain path must
write the same bytes as ``flacx.encoder._encode_batch`` wherever the two
chose the same coefficients, and every frame must decode bit-exactly.
One stereo frame at the configuration's own block, 16384, is byte-equal
to flacx's.
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
from flacx.encoder import EncoderConfig as FxConfig
from flacx.encoder import _encode_batch as fx_encode_batch
from flacx.format import Streaminfo, SubframeKind
from flacx.ops import lpc as fx_lpc
from flacx.ops import rice as fx_rice
from flacx.oracle.decoder import read_frame as fx_read_frame

from flacx_torch import crc
from flacx_torch.encoder import BatchEncoder, _encode_batch, config_from_flacx
from flacx_torch.kernels import rice_stats as k_rs
from flacx_torch.kernels.lpc_residual import (lpc_residual_stats,
                                              lpc_residual_zz, mac_width)
from flacx_torch.ops import rice
from flacx_torch.oracle.decoder import read_frame

from conftest import make_pcm

torch.set_num_threads(1)

N = 1024
HIRES = dict(block_size=N, max_lpc_order=32, bps=24, sample_rate=96000,
             partition_orders=tuple(range(16)))
#: the three flacx configurations, each a fresh XLA:CPU compile
CONFIGS = {
    "stereo": FxConfig(**HIRES),
    "six-channels": FxConfig(**HIRES, channels=6),
    "precision-15": FxConfig(**HIRES, qlp_precision=15),
}


# ---------------------------------------------------------------------------
# the wide MAC


def wide_rows(precision: int) -> tuple:
    """24-bit rows (the 25-bit side channel's range) with order-32 taps at
    ``precision``; rows 0-2 are built so their residual passes 2^30 and
    2^31."""
    rng = np.random.default_rng(precision)
    r, n, t = 10, 700, 32
    x = rng.integers(-(1 << 24), 1 << 24, size=(r, n)).astype(np.int32)
    x[:3] = np.where(np.arange(n) % 2, (1 << 24) - 1, -(1 << 24))
    qmax = (1 << (precision - 1)) - 1
    taps = rng.integers(-qmax - 1, qmax + 1, size=(r, t)).astype(np.int32)
    order = rng.integers(1, t + 1, size=r).astype(np.int32)
    order[:3] = t
    taps[np.arange(t) >= order[:, None]] = 0
    # alternating signs against an alternating signal: every product adds
    taps[:3] = np.where(np.arange(t) % 2, qmax, -qmax - 1)
    shift = rng.integers(0, 16, size=r).astype(np.int32)
    shift[:3] = (0, 1, 3)
    return x, taps, shift, order


@pytest.mark.parametrize("precision", [5, 15])
def test_wide_mac_matches_flacx_on_every_lane(precision):
    """Stats equal flacx's int64 XLA route on every lane, those past 2^30
    and 2^31 included; zz equals the encoder's int32 zigzag of it."""
    x, taps, shift, order = wide_rows(precision)
    eff, sum_taps = 25, 32 << (precision - 1)
    assert mac_width(eff, sum_taps) == "wide"
    assert mac_width(17, 12 << 4) == "int32"
    ref_res, ref_lzz, ref_max = (np.asarray(a) for a in jax.jit(
        functools.partial(fx_lpc.predict_residual_fused, eff_bps=eff,
                          sum_taps_max=sum_taps, use_tile_kernel=False))(
        *(jnp.asarray(a) for a in (x, taps, shift, order))))
    assert ref_res.dtype == np.int64
    big = np.abs(ref_res).max(-1)
    assert (big >= 1 << 31).sum() >= 2
    args = [torch.from_numpy(a) for a in (x, taps, shift, order)]
    lzz, maxabs = lpc_residual_stats(*args, eff, sum_taps)
    np.testing.assert_array_equal(lzz.numpy(), ref_lzz)
    np.testing.assert_array_equal(maxabs.numpy(), ref_max)
    zz = lpc_residual_zz(*args, eff, max(sum_taps, 15))
    ref_zz = np.asarray(fx_rice.zigzag(jnp.asarray(ref_res)
                                       .astype(jnp.int32)))
    assert zz.dtype == torch.int32
    np.testing.assert_array_equal(zz.numpy(), ref_zz)


# ---------------------------------------------------------------------------
# the Rice plan at many partitions


@pytest.mark.parametrize("n,max_po", [(1024, 10), (4608, 9)])
def test_rice_plan_at_many_partitions_matches_flacx(n, max_po):
    """Partition orders 0..10 at block 1024 (one-sample partitions, where
    flacx takes its closed form) and 0..9 at 4608 (9-sample partitions),
    kmax 30: both cut into several ``rice_stats`` segments a row."""
    rng = np.random.default_rng(n)
    porders = tuple(range(max_po + 1))
    zz = np.minimum(rng.exponential(size=(3, 2, n))
                    * 2.0 ** rng.integers(0, 28, size=(3, 2, 1)), 2 ** 30 - 1)
    order = rng.integers(0, 33, size=(3, 2)).astype(np.int32)
    order[0, 0] = 0
    zz = np.where(np.arange(n) < order[..., None], 0, zz).astype(np.int32)
    assert k_rs.segment_log2(n, max_po, 30) > 0
    ref = jax.jit(functools.partial(fx_rice.exact_plan, porders=porders,
                                    preferred=porders, kmax=30))(
        jnp.asarray(zz), jnp.asarray(order))
    zt, ot = torch.from_numpy(zz), torch.from_numpy(order)
    got = rice.exact_plan(zt, ot, porders, porders, 30,
                          kernel_stats=k_rs.rice_stats(zt, ot, porders, 30))
    for field in ("bits", "porder", "width", "k_seg", "esc_seg"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)


# ---------------------------------------------------------------------------
# the whole encode


def planar_frames(seed: int, frames: int, channels: int,
                  kind: str) -> np.ndarray:
    """``[frames, channels, N]`` int32 24-bit blocks."""
    pcm = make_pcm(np.random.default_rng(seed), frames * N, channels, 24,
                   kind)
    return np.ascontiguousarray(
        pcm.reshape(frames, N, channels).transpose(0, 2, 1))


def frames_of(out: dict) -> list[bytes]:
    data, lens = np.asarray(out["bytes"]), np.asarray(out["length"])
    return [bytes(data[i, :lens[i]]) for i in range(len(lens))]


def streaminfo(channels: int) -> Streaminfo:
    return Streaminfo(N, N, 0, 0, 96000, channels, 24, 0, bytes(16))


def subframe_params(frame_bytes: bytes, channels: int) -> tuple:
    frame, _ = fx_read_frame(BitReader(frame_bytes), streaminfo(channels))
    return (frame.header.channels,
            tuple((sf.kind, sf.order, sf.shift, sf.coefficients)
                  for sf in frame.subframes))


@pytest.fixture(scope="module", params=list(CONFIGS))
def encoded(request):
    """Two tonal and two noise frames, flacx's encoding and the port's."""
    fx_cfg = CONFIGS[request.param]
    c = fx_cfg.channels
    pcm = np.concatenate([planar_frames(1, 2, c, "tonal"),
                          planar_frames(2, 2, c, "noise")])
    ref = jax.jit(functools.partial(fx_encode_batch, fx_cfg))(
        jnp.asarray(pcm), jnp.int64(3))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    cfg = config_from_flacx(dataclasses.asdict(fx_cfg))
    out = _encode_batch(cfg, torch.from_numpy(pcm), 3)
    return request.param, cfg, pcm, ref, out


def test_hires_frames_match_flacx(encoded):
    name, cfg, _, ref, out = encoded
    got, want = frames_of(out), frames_of(ref)
    equal = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            equal += 1
        else:
            assert subframe_params(g, cfg.channels) != \
                subframe_params(w, cfg.channels), \
                f"{name} frame {i}: same coefficients, different bytes"
    assert equal >= len(got) - 1, name


def test_hires_kind_mode_and_size_match_flacx(encoded):
    name, _, _, ref, out = encoded
    for key in ("kind", "channel_code", "subframe_bits"):
        np.testing.assert_array_equal(out[key].numpy(), ref[key],
                                      err_msg=f"{name} {key}")


def test_hires_frames_decode_bit_exactly(encoded):
    """Under flacx's oracle decoder and the port's; LPC subframes (whose
    residual took the wide MAC) occur."""
    name, cfg, pcm, _, out = encoded
    kinds = set()
    for i, frame in enumerate(frames_of(out)):
        assert crc.crc16(frame[:-2]) == int.from_bytes(frame[-2:], "big")
        decoded, planes = fx_read_frame(BitReader(frame),
                                        streaminfo(cfg.channels))
        np.testing.assert_array_equal(np.asarray(planes), pcm[i],
                                      err_msg=f"{name} frame {i}")
        _, own = read_frame(frame, 24)
        np.testing.assert_array_equal(np.asarray(own), pcm[i])
        kinds.update(sf.kind for sf in decoded.subframes)
    assert SubframeKind.LPC in kinds, name


def test_batch_encoder_takes_hires_on_the_cpu():
    """``BatchEncoder`` accepts 24-bit int32 input in the hi-res config
    and writes the frames of a direct ``_encode_batch`` call."""
    cfg = config_from_flacx(dataclasses.asdict(CONFIGS["stereo"]))
    pcm = planar_frames(5, 3, 2, "tonal")
    direct = frames_of(_encode_batch(cfg, torch.from_numpy(pcm), 0))
    enc = BatchEncoder(cfg, batch_frames=2, device="cpu")
    assert enc.encode_frames(pcm, 0) == direct


def test_block_16384_frame_equals_flacx():
    """One stereo 24-bit frame at the hi-res configuration's own block,
    16384 (LPC order 32, partition orders 0..15), byte-equal to flacx's."""
    n = 16384
    fx_cfg = FxConfig(**dict(HIRES, block_size=n))
    pcm = make_pcm(np.random.default_rng(16), n, 2, 24, "tonal")
    planar = np.ascontiguousarray(pcm.reshape(1, n, 2).transpose(0, 2, 1))
    ref = jax.jit(functools.partial(fx_encode_batch, fx_cfg))(
        jnp.asarray(planar), jnp.int64(7))
    out = _encode_batch(config_from_flacx(dataclasses.asdict(fx_cfg)),
                        torch.from_numpy(planar), 7)
    assert frames_of(out) == frames_of({k: np.asarray(v)
                                        for k, v in ref.items()})
    np.testing.assert_array_equal(out["kind"].numpy(), [[3, 3]])
