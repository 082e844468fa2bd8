"""flacx_torch's conformance mode against flacx and the oracle on the CPU.

The reference chain bit for bit against ``flacx.conformance`` on the same
seeded inputs (``floor_log2``, ``ordered_autocorr`` as f64 bits,
``levinson_reference``, ``quantize_reference``, ``reference_rice_plan``,
and the plain versions of the ``reference_analysis`` kernels), then
``encode_batch_conformance``'s frames byte for byte against flacx's and
against the oracle encoder's: tonal, noise, impulse and silent frames,
frame indices across batches, a spike that takes the overflow route, a
frame past the packer's buffer, and a whole file against
``flacx.pipeline``'s.  No tolerance anywhere.
"""

import functools
import io
import math

import numpy as np
import pytest
import torch

import flacx.ops  # noqa: F401  (x64)
import jax
import jax.numpy as jnp
from flacx import conformance as fx_conf
from flacx import pipeline as fx_pipeline
from flacx.encoder import BatchEncoder as FxBatchEncoder
from flacx.encoder import EncoderConfig as FxConfig
from flacx.encoder import _jitted_encode as fx_jitted_encode
from flacx.ops.lpc import tukey_window_np

from flacx_torch import conformance, pipeline
from flacx_torch.encoder import BatchEncoder, EncoderConfig, _encode_batch
from flacx_torch.kernels.reference_analysis import (abs_residual_sums,
                                                    reference_lpc)
from flacx_torch.oracle.decoder import read_frame

from conftest import make_pcm

torch.set_num_threads(1)

N, P, PREC = 1152, 12, 5
PORDERS = (0, 1, 2, 3, 4, 5)
KINDS = ("tonal", "noise", "impulse", "silence")


def planar(pcm: np.ndarray, n: int) -> np.ndarray:
    """Interleaved ``[frames·n, C]`` PCM as ``[frames, C, n]``."""
    return np.ascontiguousarray(
        pcm.reshape(-1, n, pcm.shape[1]).transpose(0, 2, 1))


def rows_of(seed: int, r: int, n: int) -> np.ndarray:
    """``[r, n]`` int32 16-bit rows: tones with noise, silence, a constant
    row and full-scale alternation."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = (np.sin(t[None] * rng.uniform(0.005, 0.3, (r, 1)))
         * rng.uniform(0, 30000, (r, 1))
         + rng.standard_normal((r, n)) * rng.uniform(0, 200, (r, 1)))
    x = np.clip(x, -32768, 32767).astype(np.int32)
    x[0] = 0
    x[1] = 1234
    x[2] = np.where(t % 2, 32767, -32768)
    return x


def bits(a) -> np.ndarray:
    return np.asarray(a, np.float64).view(np.int64)


def test_floor_log2_edges():
    """Exact powers, one ulp under each (the round-up branch), and random
    values, against flacx's function."""
    vals = []
    for k in range(-40, 41):
        p2 = math.ldexp(1.0, k)
        vals += [p2, np.nextafter(p2, 0.0), np.nextafter(p2, np.inf)]
    rng = np.random.default_rng(5)
    vals += list(np.exp(rng.uniform(-60, 60, 2000)))
    vals += list(rng.integers(1, 1 << 40, 500) / rng.integers(1, 5000, 500))
    x = np.asarray(vals, np.float64)
    want = np.asarray(fx_conf.floor_log2(jnp.asarray(x)))
    got = conformance.floor_log2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def chain():
    """Windowed rows and flacx's reference chain on them."""
    x = rows_of(1, 8, 256)
    w = x.astype(np.float64) * tukey_window_np(256)
    autoc = np.asarray(fx_conf.ordered_autocorr(jnp.asarray(w), P))
    taps, valid = fx_conf.levinson_reference(jnp.asarray(autoc), P)
    return x, w, autoc, np.asarray(taps), np.asarray(valid)


def test_ordered_autocorr_bits(chain):
    _, w, autoc, _, _ = chain
    got = conformance.ordered_autocorr(torch.from_numpy(w), P)
    np.testing.assert_array_equal(bits(got), bits(autoc))


def test_levinson_reference_bits(chain):
    _, _, autoc, taps, valid = chain
    got_t, got_v = conformance.levinson_reference(torch.from_numpy(autoc), P)
    np.testing.assert_array_equal(got_v.numpy(), valid)
    assert valid[3:].all() and not valid[0].any()
    np.testing.assert_array_equal(bits(got_t)[valid], bits(taps)[valid])


@pytest.mark.parametrize("precision", [5, 15])
def test_quantize_reference(chain, precision):
    """The chain's valid rows, and rows that take the negative shift."""
    _, _, _, taps, valid = chain
    big = np.random.default_rng(3).uniform(-3e3, 3e3, (4, P, P))
    big *= np.tril(np.ones((P, P)))
    for t in (taps[valid.all(-1)], big):
        want_q, want_s = fx_conf.quantize_reference(jnp.asarray(t), precision)
        got_q, got_s = conformance.quantize_reference(torch.from_numpy(t),
                                                      precision)
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("porders,order_max", [((0, 1, 2, 3, 4, 5), 12),
                                               ((0, 2, 3), 32)])
def test_reference_rice_plan(porders, order_max):
    """Every field of the plan, on zigzags from tiny to past 2^24 (means
    that take the 5-bit width), all-zero rows and orders up to 32."""
    rng = np.random.default_rng(7)
    r, n = 12, 256
    scale = 2.0 ** rng.integers(0, 26, (r, 1))
    zz = (rng.exponential(1.0, (r, n)) * scale).astype(np.int64)
    zz[0] = 0
    order = rng.integers(0, order_max + 1, r)
    zz[np.arange(n)[None] < order[:, None]] = 0
    want = jax.jit(functools.partial(
        fx_conf.reference_rice_plan, porders=porders,
        preferred=porders[1:]))(jnp.asarray(zz), jnp.asarray(order,
                                                             jnp.int32))
    got = conformance.reference_rice_plan(
        torch.from_numpy(zz), torch.from_numpy(order.astype(np.int32)),
        porders, porders[1:])
    for name in want._fields:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            err_msg=name)


def test_reference_lpc_plain(chain):
    """The kernel's plain version against flacx's chain, its quantization
    included (invalid rows zeroed)."""
    x, _, autoc, taps, valid = chain
    got = reference_lpc(torch.from_numpy(x),
                        torch.from_numpy(tukey_window_np(256)), P, PREC)
    want_q, want_s = (np.asarray(a) for a in
                      fx_conf.quantize_reference(jnp.asarray(taps), PREC))
    np.testing.assert_array_equal(bits(got[0]), bits(autoc))
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.where(valid[..., None], want_q, 0))
    np.testing.assert_array_equal(got[2].numpy(), np.where(valid, want_s, 0))
    np.testing.assert_array_equal(got[3].numpy(), valid)


@pytest.mark.parametrize("p", [0, 8])
def test_abs_residual_sums_plain(chain, p):
    """Σ|res| of every fixed and LPC order against flacx's residuals."""
    from flacx.format import FIXED_PREDICTOR_TAPS
    from flacx.ops.lpc import lpc_residuals_all, predict_residual
    x, _, _, taps, _ = chain
    q, s = (np.asarray(a) for a in fx_conf.quantize_reference(
        jnp.asarray(taps[:, :p, :p]), 15)) if p else \
        (np.zeros((len(x), 0, 0), np.int32), np.zeros((len(x), 0), np.int32))
    i = np.arange(x.shape[-1])
    fixed = np.stack([np.abs(np.asarray(predict_residual(
        jnp.asarray(x), jnp.broadcast_to(jnp.asarray(FIXED_PREDICTOR_TAPS[o]),
                                         (len(x), 4)),
        jnp.zeros(len(x), jnp.int32))) * (i >= o)).sum(-1)
        for o in range(5)], -1)
    lpc = (np.abs(np.asarray(lpc_residuals_all(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(s)))
        * (i >= np.arange(1, p + 1)[:, None])).sum(-1)) if p else \
        np.zeros((len(x), 0), np.int64)
    got_f, got_l = abs_residual_sums(torch.from_numpy(x), torch.from_numpy(q),
                                     torch.from_numpy(s), 16, p << 14)
    np.testing.assert_array_equal(got_f.numpy(), fixed)
    np.testing.assert_array_equal(got_l.numpy(), lpc)


def oracle_frames(frames: np.ndarray, first: int, n: int, p: int,
                  porders=PORDERS, bps: int = 16,
                  precision: int = PREC) -> list[bytes]:
    """flacx's oracle encoder on ``[F, C, n]`` blocks."""
    return [fx_pipeline._oracle_frame(blk.T, first + i, bps, n, p,
                                      precision, porders)
            for i, blk in enumerate(frames)]


@pytest.fixture(scope="module")
def mixed():
    """Four stereo frames at block 1152, LPC order 12 (tonal, noise,
    impulse, silence), flacx's ``encode_batch_conformance`` of them
    (compiled once, at the shape the file test's pipeline uses) and the
    oracle's frames."""
    pcm = np.concatenate([make_pcm(np.random.default_rng(20 + k), N, 2, 16,
                                   kind) for k, kind in enumerate(KINDS)])
    blocks = planar(pcm, N)
    cfg = FxConfig(sample_rate=44100, bps=16, channels=2, block_size=N,
                   max_lpc_order=P, qlp_precision=PREC,
                   partition_orders=PORDERS, conformance=True)
    out = fx_jitted_encode(cfg, None)(jnp.asarray(blocks.astype(np.int16)),
                                      jnp.int64(3))
    ref = {k: np.asarray(v) for k, v in out.items()}
    return blocks, ref, oracle_frames(blocks, 3, N, P)


def test_encode_batch_equals_flacx_and_oracle(mixed):
    """Frame for frame: byte-equal to flacx wherever flacx packs the frame
    (its overflow flag clear), to the oracle everywhere through
    ``BatchEncoder`` (overflow frames replaced), the same overflow flags."""
    blocks, ref, orc = mixed
    cfg = EncoderConfig(block_size=N, max_lpc_order=P, conformance=True)
    out = _encode_batch(cfg, torch.from_numpy(blocks), 3)
    np.testing.assert_array_equal(out["overflow"].numpy(), ref["overflow"])
    np.testing.assert_array_equal(out["kind"].numpy()[~ref["overflow"]],
                                  ref["kind"][~ref["overflow"]])
    for i in np.nonzero(~ref["overflow"])[0]:
        got = out["bytes"][i, :out["length"][i]].numpy().tobytes()
        assert got == ref["bytes"][i, :ref["length"][i]].tobytes(), i
        assert got == orc[i], i
    assert ref["overflow"][2] and not ref["overflow"][[0, 1, 3]].any()
    frames = BatchEncoder(cfg, batch_frames=4, device="cpu") \
        .encode_frames(blocks, 3)
    assert frames == orc
    for fr, blk in zip(frames, blocks):
        np.testing.assert_array_equal(np.asarray(read_frame(fr, 16)[1]), blk)


def port_file(pcm: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    pipeline.encode_to_file(buf, pcm, sample_rate=44100, bps=16,
                            channels=pcm.shape[1], qlp_precision=PREC,
                            device="cpu", conformance=True, **kw)
    return buf.getvalue()


def flacx_file(pcm: np.ndarray, device: bool, **kw) -> bytes:
    buf = io.BytesIO()
    fx_pipeline.encode_to_file(buf, pcm, sample_rate=44100, bps=16,
                               channels=pcm.shape[1], qlp_precision=PREC,
                               device=device, conformance=device, **kw)
    return buf.getvalue()


def test_file_equals_flacx_pipeline(mixed):
    """A whole file (three full frames and a short tail) against
    ``flacx.pipeline`` in conformance mode, byte for byte."""
    pcm = make_pcm(np.random.default_rng(31), 3 * N + 300, 2, 16, "tonal")
    kw = dict(block_size=N, max_lpc_order=P, partition_orders=PORDERS,
              batch_frames=4)
    assert port_file(pcm, **kw) == flacx_file(pcm, True, **kw)


@pytest.mark.parametrize("channels", [1, 2])
def test_frame_indices_across_batches(channels):
    """Coded frame numbers cross batch boundaries (batches of 3) and the
    two-byte form; the file equals the oracle's."""
    pcm = make_pcm(np.random.default_rng(4), 256 * 10, channels, 16,
                   "tonal")
    kw = dict(block_size=256, max_lpc_order=8, partition_orders=PORDERS)
    assert port_file(pcm, batch_frames=3, **kw) == flacx_file(pcm, False,
                                                              **kw)
    stats = {}
    enc = BatchEncoder(EncoderConfig(block_size=256, max_lpc_order=8,
                                     channels=channels, conformance=True),
                       batch_frames=3, device="cpu")
    frames = enc.encode_frames(planar(pcm, 256), 130, stats)
    assert frames == oracle_frames(planar(pcm, 256), 130, 256, 8)
    assert stats["frame_bytes"] == sum(map(len, frames))


def test_overflow_spike_takes_the_oracle():
    """A spike in low noise: the mean-estimate parameter leaves a Rice
    quotient past 32 bits; the frame is flagged and re-encoded by the
    oracle, and the file equals the oracle's."""
    rng = np.random.default_rng(0)
    pcm = rng.integers(-2, 3, size=(512, 2)).astype(np.int32)
    pcm[40, 0] = 30000
    kw = dict(block_size=256, max_lpc_order=4, partition_orders=(0,))
    cfg = EncoderConfig(block_size=256, max_lpc_order=4,
                        partition_orders=(0,), conformance=True)
    out = _encode_batch(cfg, torch.from_numpy(planar(pcm, 256)), 0)
    assert out["overflow"].tolist() == [True, False]
    assert port_file(pcm, **kw) == flacx_file(pcm, False, **kw)


def test_overflow_batch_stats_equal_flacx():
    """The spike batch of :func:`test_overflow_spike_takes_the_oracle`, a
    frame a batch, through both ``BatchEncoder``s with ``stats``: a batch
    with an overflow frame adds only its frame bytes (the oracle frame's),
    the other its subframe kinds and stereo modes as well; the dicts are
    equal."""
    rng = np.random.default_rng(0)
    pcm = rng.integers(-2, 3, size=(512, 2)).astype(np.int32)
    pcm[40, 0] = 30000
    kw = dict(block_size=256, max_lpc_order=4, partition_orders=(0,),
              conformance=True)
    blocks = planar(pcm, 256)
    got, want = {}, {}
    frames = BatchEncoder(EncoderConfig(**kw), batch_frames=1,
                          device="cpu").encode_frames(blocks, 0, got)
    ref = FxBatchEncoder(FxConfig(**kw), batch_frames=1) \
        .encode_frames(blocks, 0, want)
    assert frames == ref == oracle_frames(blocks, 0, 256, 4, (0,))
    assert got == want
    assert sum(got["subframe_kinds"].values()) == 2  # the second frame's


def test_24_bit_precision_15_equals_flacx_and_oracle(monkeypatch):
    """24-bit stereo at precision 15, where a residual may pass int32
    (``residual_fits_int32`` false: the chosen residual's max is read):
    every frame flacx packs byte-equal to flacx's, every frame through
    ``BatchEncoder`` the oracle's, the same overflow flags."""
    n, p, prec = 1152, 8, 15
    assert not conformance.residual_fits_int32(24, p << (prec - 1))
    pcm = np.concatenate([make_pcm(np.random.default_rng(40 + k), n, 2, 24,
                                   kind) for k, kind in enumerate(KINDS)])
    blocks = planar(pcm, n)
    kw = dict(bps=24, channels=2, block_size=n, max_lpc_order=p,
              qlp_precision=prec, partition_orders=PORDERS,
              conformance=True)
    ref = {k: np.asarray(v) for k, v in fx_jitted_encode(
        FxConfig(**kw), None)(jnp.asarray(blocks), jnp.int64(7)).items()}
    reads = []
    stats = conformance.lpc_residual_stats
    monkeypatch.setattr(conformance, "lpc_residual_stats",
                        lambda *a: reads.append(1) or stats(*a))
    cfg = EncoderConfig(**kw)
    out = _encode_batch(cfg, torch.from_numpy(blocks), 7)
    assert reads
    np.testing.assert_array_equal(out["overflow"].numpy(), ref["overflow"])
    for i in np.nonzero(~ref["overflow"])[0]:
        got = out["bytes"][i, :out["length"][i]].numpy().tobytes()
        assert got == ref["bytes"][i, :ref["length"][i]].tobytes(), i
    frames = BatchEncoder(cfg, batch_frames=4, device="cpu") \
        .encode_frames(blocks, 7)
    assert frames == oracle_frames(blocks, 7, n, p, bps=24, precision=prec)


def test_frame_past_the_buffer_takes_the_oracle():
    """Full-scale white noise at block 4608: the reference's Rice codes
    (about 16.5 bits a sample) pass the verbatim-sized frame buffer; the
    frame is flagged and re-encoded by the oracle."""
    n = 4608
    pcm = np.random.default_rng(2).integers(-32768, 32768, (n, 2)) \
        .astype(np.int32)
    cfg = EncoderConfig(block_size=n, conformance=True)
    out = _encode_batch(cfg, torch.from_numpy(planar(pcm, n)), 0)
    assert out["overflow"].tolist() == [True]
    assert int(out["length"][0]) <= cfg.max_frame_bytes
    frames = BatchEncoder(cfg, batch_frames=1, device="cpu") \
        .encode_frames(planar(pcm, n), 0)
    want = oracle_frames(planar(pcm, n), 0, n, 12)
    assert frames == want and len(want[0]) > cfg.max_frame_bytes


def test_window_is_the_reference_tukey():
    w = conformance.reference_window(N, torch.device("cpu"))
    np.testing.assert_array_equal(bits(w), bits(tukey_window_np(N)))
