"""flacx_torch at 25- to 32-bit samples against flacx on the CPU.

Past 24 bits both packages carry the zigzag residual in int64
(``EncoderConfig.work_dtype``).  Whole files through
``flacx_torch.pipeline`` (each kernel's plain version) equal
``flacx.pipeline``'s byte for byte: stereo at 25, 28 and 31 bits (side
channels of 26, 29 and 32 bits), stereo at 32 bits (independent) and mono
at 32 bits, under the estimate (f32) and the exact (f64) order search,
with wasted bits and escapes.  The inputs hold tones with noise,
full-scale white noise at 32 bits (its residuals pass 2^31: verbatim), a
frame whose best code is an escape of 31 bits, coded residuals whose
zigzag is 2^31 - 2 and 2^31 - 1 beside frames at 2^31 and 2^32 that go
verbatim, and a frame that the JAX package's int32 LPC gate would code
otherwise.  On these inputs the f32 analysis chooses the same
coefficients as flacx on every frame, so the estimate files are
byte-equal too, not only the frames whose coefficients agree.

Then the plain twins of the widened kernels against flacx's functions
(the fixed-order sums' int64 differences, the f32 rounding of samples
past 2^24, the int64 zigzag residual and its statistics at eff_bps 32 and
precision 15, every order's statistics, the Rice statistics of int64
``zz`` and ``exact_plan`` on them around 2^31 and 2^32); the decode of
flacx's streams on both of the port's reconstruct routes; conformance
mode at 28 bits against flacx and the oracle; and the CLI on a 32-bit WAV
(the defaults and ``--best``).  Every case with a new configuration is
one XLA:CPU compile of flacx's pipeline; the CLI's shares two of them.
"""

import functools
import io

import numpy as np
import pytest
import torch

import flacx.ops  # noqa: F401  (x64)
import jax
import jax.numpy as jnp
import flacx.decoder as fx_dec
import flacx.pipeline as fx_pipeline
import flacx.wavio as fx_wavio
from flacx.encoder import EncoderConfig as FxConfig
from flacx.encoder import _jitted_encode as fx_jitted_encode
from flacx.ops import lpc as fx_lpc
from flacx.ops import rice as fx_rice
from flacx.ops.fixedpred import fixed_order_zz_sums as fx_fixed_sums

import flacx_torch.encoder as encoder
from flacx_torch import cli, decoder, pipeline
from flacx_torch.encoder import BatchEncoder, EncoderConfig, _encode_batch
from flacx_torch.kernels import reconstruct as k_rec
from flacx_torch.kernels.analysis import analysis, diff_width
from flacx_torch.kernels.lpc_allorder import lpc_allorder
from flacx_torch.kernels.lpc_residual import (lpc_residual_stats,
                                              lpc_residual_zz)
from flacx_torch.ops import rice
from flacx_torch.ops.fixedpred import fixed_order_zz_sums
from flacx_torch.oracle.decoder import read_frame
from flacx_torch.wavio import read_wav, write_wav

from conftest import make_pcm

torch.set_num_threads(1)

RATE, BATCH, TAIL = 44100, 4, 300
PORDERS = tuple(range(6))
SMALL = dict(block_size=1152, max_lpc_order=8, qlp_precision=12,
             partition_orders=PORDERS)
#: the CLI's defaults (``stereo32`` shares its compile with the CLI test)
DEFAULTS = dict(block_size=4608, max_lpc_order=12, qlp_precision=5,
                partition_orders=PORDERS)
BEST_WINDOWS = ("tukey(0.5)", "hann", "flattop")


def tones(seed: int, frames: int, n: int, channels: int, bps: int,
          ) -> np.ndarray:
    return make_pcm(np.random.default_rng(seed), frames * n, channels, bps)


def gate_frame(n: int) -> np.ndarray:
    """Two tones near 28-bit full scale ending in a burst: the chosen LPC
    residual passes 2^30, so the frame goes verbatim, where an int32 gate
    on it would code both channels with fixed predictors."""
    t = np.arange(n)
    x = ((np.sin(2 * np.pi * 600 * t / RATE) * 0.45
          + np.sin(2 * np.pi * 5000 * t / RATE + 1) * 0.45)
         * (1 << 27)).astype(np.int64)
    x[n - 3::2] = (1 << 27) - 1
    x[n - 2] = -(1 << 27)
    return np.stack([x, x // 3], axis=1).astype(np.int32)


def loud_frames(n: int) -> np.ndarray:
    """Full-scale 32-bit white noise, then a frame whose left channel is
    white noise of 31 bits (best coded as escapes of E = 31) beside a
    tone."""
    rng = np.random.default_rng(9)
    noise = rng.integers(-(1 << 31), 1 << 31, (n, 2))
    esc = rng.integers(-(1 << 30), 1 << 30, (n, 2))
    esc[:, 1] = tones(10, 1, n, 1, 32)[:, 0]
    return np.concatenate([noise, esc]).astype(np.int32)


#: zigzag residuals (fixed order 0) of the four edge frames' peaks
EDGE_ZZ = ((1 << 31) - 2, 1 << 31, (1 << 31) - 1, (1 << 32) - 2)


def edge_frames(n: int) -> np.ndarray:
    """Mono 32-bit frames of small noise with one peak each, whose zigzag
    is :data:`EDGE_ZZ`: 2^31 - 2 and 2^31 - 1 code (escapes), 2^31 and
    2^32 - 2 go verbatim."""
    x = np.random.default_rng(11).integers(-(1 << 20), 1 << 20, (4, n))
    x[:, n // 2] = (2 ** 30 - 1, 2 ** 30, -2 ** 30, 2 ** 31 - 1)
    return x.reshape(-1, 1).astype(np.int32)


def with_tail(*parts) -> np.ndarray:
    pcm = np.concatenate(parts)
    return np.concatenate([pcm, pcm[:TAIL]])


#: name -> (interleaved PCM, encode_to_file keyword arguments)
CASES = {
    "stereo25": (lambda: with_tail(tones(1, 3, 1152, 2, 25)),
                 dict(SMALL, bps=25, channels=2)),
    "stereo28": (lambda: with_tail(tones(2, 3, 1152, 2, 28),
                                   gate_frame(1152)),
                 dict(SMALL, bps=28, channels=2)),
    "stereo31": (lambda: with_tail(tones(3, 3, 1152, 2, 31)),
                 dict(SMALL, bps=31, channels=2)),
    "stereo32": (lambda: with_tail(tones(4, 2, 4608, 2, 32),
                                   loud_frames(4608)),
                 dict(DEFAULTS, bps=32, channels=2)),
    "mono32": (lambda: with_tail(tones(5, 2, 1152, 1, 32),
                                 edge_frames(1152)),
               dict(SMALL, bps=32, channels=1)),
    # 25-bit tones shifted left by 3: every subframe has wasted bits
    "exact28w": (lambda: with_tail(tones(6, 3, 1152, 2, 25) << 3),
                 dict(SMALL, bps=28, channels=2, order_search="exact",
                      wasted_bits=True)),
    # encode --best's block-1152 pass (the CLI test shares its compile)
    "exact32": (lambda: with_tail(tones(7, 3, 1152, 2, 32)),
                dict(DEFAULTS, block_size=1152, bps=32, channels=2,
                     order_search="exact", windows=BEST_WINDOWS)),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """A case's name, PCM, settings and flacx's file."""
    make, kw = CASES[request.param]
    pcm = make()
    f = io.BytesIO()
    fx_pipeline.encode_to_file(f, pcm, sample_rate=RATE,
                               batch_frames=BATCH, **kw)
    return request.param, pcm, kw, f.getvalue()


def encode_spied(monkeypatch, pcm, kw) -> tuple[bytes, dict]:
    """The port's file of ``pcm`` and, per frame, what ``pack_frames`` got
    (kind, zz, escape flags and parameters of the finest partitions) and
    ``lpc_residual_stats``' max |residual|."""
    seen = {"kind": [], "zz": [], "esc": [], "k": [], "maxabs": []}

    def pack(hdr, kind, order, bps, x, taps, shift, prec, zz, plan, *a,
             **k):
        for key, v in (("kind", kind), ("zz", zz), ("esc", plan.esc_seg),
                       ("k", plan.k_seg)):
            seen[key].append(v)
        return pack_frames(hdr, kind, order, bps, x, taps, shift, prec, zz,
                           plan, *a, **k)

    def stats(*args):
        out = lpc_stats(*args)
        seen["maxabs"].append(out[1])
        return out

    pack_frames, lpc_stats = encoder.pack_frames, encoder.lpc_residual_stats
    monkeypatch.setattr(encoder, "pack_frames", pack)
    monkeypatch.setattr(encoder, "lpc_residual_stats", stats)
    f = io.BytesIO()
    pipeline.encode_to_file(f, pcm, sample_rate=RATE, batch_frames=BATCH,
                            device="cpu", **kw)
    return f.getvalue(), {key: torch.cat(v) if v else None
                          for key, v in seen.items()}


def test_file_equals_flacx(case, monkeypatch):
    """Byte for byte, MD5 of 4-byte samples and the oracle's short last
    frame included; the working type is int64; each crafted frame takes
    the route it was made for, as flacx's does."""
    name, pcm, kw, want = case
    got, seen = encode_spied(monkeypatch, pcm, kw)
    assert got == want
    assert seen["zz"].dtype == torch.int64
    n = kw["block_size"]
    kind = seen["kind"]
    if name == "stereo28":
        # the gate frame (frame 3): a chosen LPC residual past 2^30 on the
        # stats route, verbatim subframes; under an int32 gate the same
        # frame would be coded with fixed predictors
        assert int(seen["maxabs"][3].max()) >= 1 << 30
        assert kind[3].tolist() == [1, 1]
        frame = torch.from_numpy(gate_frame(n).T.copy()[None])
        cfg = EncoderConfig(**kw)
        with monkeypatch.context() as m:
            m.setattr(EncoderConfig, "work_dtype",
                      property(lambda self: torch.int32))
            assert _encode_batch(cfg, frame, 0)["kind"].tolist() == [[2, 2]]
    if name == "stereo32":
        # white noise verbatim; the left channel of frame 3 coded with
        # escapes of E = 31 (parameter field = E in escaped partitions)
        assert kind[2].tolist() == [1, 1]
        assert kind[3, 0] >= 2
        assert bool((seen["esc"][3, 0] & (seen["k"][3, 0] == 31)).any())
    if name == "mono32":
        edges = slice(2, 6)
        peak = seen["zz"][edges, 0].amax(-1).tolist()
        coded = (kind[edges, 0] >= 2).tolist()
        assert coded == [True, False, True, False]
        assert [p for p, c in zip(peak, coded) if c] == [EDGE_ZZ[0],
                                                         EDGE_ZZ[2]]
    if name == "exact28w":
        frames = BatchEncoder(EncoderConfig(**kw), batch_frames=BATCH,
                              device="cpu").encode_frames(
            np.ascontiguousarray(pcm[:3 * n].reshape(3, n, 2)
                                 .transpose(0, 2, 1)), 0)
        wasted = [sf.wasted_bits for fr in frames
                  for sf in read_frame(fr, 28)[0].subframes]
        assert min(wasted) >= 3


def reconstruct_route(monkeypatch) -> list:
    """Records the route of each ``reconstruct`` call: ``chunk`` (the
    walker's sample state), ``serial``, or ``fixed`` (an all-fixed batch,
    which takes no state at any width)."""
    routes = []
    original = k_rec.reconstruct

    def spy(*args):
        routes.append("fixed" if args[14:] and args[14] is not None else
                      "serial" if args[9] is None else "chunk")
        return original(*args)
    monkeypatch.setattr(decoder, "reconstruct", spy)
    return routes


@pytest.mark.parametrize("route", ["chunk", "serial"])
def test_decode_matches_pcm_and_flacx(case, monkeypatch, route):
    """flacx's streams through ``decode_array`` and ``decode_stream`` on
    the port's device route (plain versions): bit-exact against the PCM
    and flacx's sequential decoder, on the chunk route (the walker's
    sample state, int64 past 31 bits) at every width where the host has
    the cores, and on the serial route where it has not."""
    name, pcm, kw, data = case
    monkeypatch.setattr(decoder, "CHUNK_STATE_MIN_CORES",
                        1 if route == "chunk" else 10 ** 6)
    routes = reconstruct_route(monkeypatch)
    stats = {}
    _, got = decoder.decode_array(data, batch_frames=BATCH, device="cpu",
                                  stats=stats)
    np.testing.assert_array_equal(got, pcm)
    assert stats.get("device") and not stats.get("host") \
        and not stats.get("sequential"), stats
    assert set(routes) - {"fixed"} == {route}, routes
    _, chunks = decoder.decode_stream(io.BytesIO(data), batch_frames=3,
                                      device="cpu")
    np.testing.assert_array_equal(np.concatenate(list(chunks)), pcm)
    np.testing.assert_array_equal(fx_dec.decode_array(data, device=False)[1],
                                  pcm)


def full_scale_rows(seed: int, r: int, n: int, bps: int) -> np.ndarray:
    """``[r, n]`` int32 rows of ``bps``-bit samples: white noise at full
    scale, the two extremes alternating, a ramp through them, a tone."""
    rng = np.random.default_rng(seed)
    lo, hi = -(1 << (bps - 1)), (1 << (bps - 1)) - 1
    x = rng.integers(lo, hi + 1, (r, n))
    x[0] = np.where(np.arange(n) % 2, hi, lo)
    x[1] = np.linspace(lo, hi, n).astype(np.int64)
    x[2] = (np.sin(np.arange(n) * 0.01) * hi).astype(np.int64)
    return x.astype(np.int32)


@pytest.mark.parametrize("bps", [26, 27, 32])
def test_fixed_sums_and_f32_rounding_match_flacx(bps):
    """The fixed-order sums at eff_bps 26 (the int32 route) and 27, 32
    (int64 differences) against flacx's int64 route; the int32 chain
    would wrap at 32.  Samples past 2^24 round to f32 exactly as flacx's
    convert does, and the autocorrelation stays within rtol 1e-9."""
    n = 1152
    x = full_scale_rows(bps, 6, n, bps)
    w = np.hanning(n).astype(np.float32)
    autoc, fsums = analysis(torch.from_numpy(x), torch.from_numpy(w), 8,
                            eff_bps=bps)
    ref = np.asarray(fx_fixed_sums(jnp.asarray(x.astype(np.int64)), bps))
    np.testing.assert_array_equal(fsums.numpy(), ref)
    assert diff_width(bps) == ("int32" if bps <= 26 else "int64")
    if bps == 32:
        assert not np.array_equal(
            fixed_order_zz_sums(torch.from_numpy(x)).numpy(), ref)
    np.testing.assert_array_equal(
        torch.from_numpy(x).float().numpy().view(np.int32),
        np.asarray(jnp.asarray(x).astype(jnp.float32)).view(np.int32))
    ref_a = np.asarray(jax.jit(functools.partial(
        fx_lpc.autocorrelate, max_lag=8, use_tile_kernel=False))(
            jnp.asarray(x), window=jnp.asarray(w)))
    assert np.all(np.abs(autoc.numpy() - ref_a)
                  <= 1e-9 * (np.abs(ref_a) + np.abs(ref_a[:, :1])))


def extreme_taps(seed: int, r: int, order: int, prec: int) -> np.ndarray:
    """``[r, order]`` taps of precision ``prec``: the extremes with
    alternating signs, the extremes all negative, random."""
    rng = np.random.default_rng(seed)
    top = 1 << (prec - 1)
    t = rng.integers(-top, top, (r, order))
    t[0] = np.where(np.arange(order) % 2, top - 1, -top)
    t[1] = -top
    return t.astype(np.int32)


@pytest.mark.parametrize("order,prec", [(12, 12), (32, 15)])
def test_int64_zz_and_stats_match_flacx(order, prec):
    """At eff_bps 32 the zz mode's int64 output is the exact zigzag of
    flacx's int64 residual (|x|·Σ|taps| up to 2^31·2^19 = 2^50), and the
    stats mode's sums and clamped max are flacx's."""
    n, r = 1152, 6
    x = full_scale_rows(order, r, n, 32)
    taps = extreme_taps(order, r, order, prec)
    shift = np.array([prec - 1, 0, 3, 15, 9, 1], np.int32)
    ords = np.array([order, order, 1, order // 2, order, 2], np.int32)
    taps = np.where(np.arange(order) < ords[:, None], taps, 0) \
        .astype(np.int32)
    bound = order << (prec - 1)
    ref_res, ref_lzz, ref_max = (np.asarray(a) for a in jax.jit(
        functools.partial(fx_lpc.predict_residual_fused, eff_bps=32,
                          sum_taps_max=bound, use_tile_kernel=False))(
        *(jnp.asarray(a) for a in (x, taps, shift, ords))))
    assert ref_res.dtype == np.int64 and np.abs(ref_res).max() > 1 << 40
    args = [torch.from_numpy(a) for a in (x, taps, shift, ords)]
    zz = lpc_residual_zz(*args, 32, bound, torch.int64)
    assert zz.dtype == torch.int64
    np.testing.assert_array_equal(
        zz.numpy(), np.asarray(fx_rice.zigzag(jnp.asarray(ref_res))))
    lzz, maxabs = lpc_residual_stats(*args, 32, bound)
    np.testing.assert_array_equal(lzz.numpy(), ref_lzz)
    np.testing.assert_array_equal(maxabs.numpy(), ref_max)


@pytest.mark.parametrize("bps", [25, 28, 32])
def test_allorder_plain_matches_flacx_int64(bps):
    """``lpc_allorder``'s plain version (int64 past the int32 bound)
    against flacx's int64 XLA route of every order's statistics."""
    n, p, prec = 1152, 12, 15
    x = full_scale_rows(bps, 4, n, bps)
    q = np.stack([extreme_taps(bps + o, 4, p, prec) for o in range(p)],
                 axis=1)
    q = np.where(np.arange(p) <= np.arange(p)[:, None], q, 0) \
        .astype(np.int32)
    s = np.tile(np.array([14, 0, 7, 11] * 3, np.int32), (4, 1))
    lzz, lmax = lpc_allorder(*(torch.from_numpy(a) for a in (x, q, s)),
                             bps, p << (prec - 1))
    res = np.asarray(fx_lpc.lpc_residuals_all(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), jnp.int64))
    res = res * (np.arange(n) >= np.arange(1, p + 1)[:, None])
    np.testing.assert_array_equal(
        lzz.numpy(), np.asarray(fx_rice.zigzag(jnp.asarray(res))).sum(-1))
    np.testing.assert_array_equal(
        lmax.numpy(), np.minimum(np.abs(res).max(-1), (1 << 31) - 1))


def zz_around_2_31(n: int, rows: int) -> np.ndarray:
    """int64 ``[rows, 1, n]`` zigzag residuals, small but for peaks that
    straddle 2^31 - 1, 2^31 and 2^32 in single partitions."""
    rng = np.random.default_rng(n)
    zz = rng.integers(0, 1 << 12, (rows, 1, n))
    peaks = ((1 << 31) - 2, (1 << 31) - 1, 1 << 31, (1 << 32) - 1,
             1 << 32, (1 << 32) + 5, 1 << 40, (1 << 30) + 7)
    for i in range(rows):
        for j in range(i % 3 + 1):
            zz[i, 0, rng.integers(0, n)] = peaks[(i + 3 * j) % len(peaks)]
    zz[0, 0] = rng.integers((1 << 30), (1 << 31) - 1, n)  # escapes of 31
    return zz


@pytest.mark.parametrize("n,porders,escapes", [
    (1152, PORDERS, True), (1152, PORDERS, False), (64, tuple(range(7)),
                                                    True)])
def test_exact_plan_on_int64_kernel_stats_matches_flacx(n, porders,
                                                        escapes):
    """``exact_plan`` on the Rice statistics of int64 ``zz`` (the kernel's
    form: int32 tables, the max saturated at 2^31) equals flacx's int64
    ``exact_plan`` in every field, and the statistics do not change when
    every value is saturated at 2^31 first, as the kernel reads it."""
    rows = 12
    zz = zz_around_2_31(n, rows)
    order = (np.arange(rows) % 5).astype(np.int32)[:, None]
    zz[..., :4] *= np.arange(4) >= order[..., None]
    zt, ot = torch.from_numpy(zz), torch.from_numpy(order)
    stats = rice.rice_stats(zt, ot, porders, 30)
    sat = rice.rice_stats(zt.clamp(max=1 << 31), ot, porders, 30)
    for po in porders:
        for a, b in zip(stats[po], sat[po]):
            assert torch.equal(a, b)
    got = rice.exact_plan(zt, ot, porders, porders, 30, escapes,
                          kernel_stats=stats)
    ref = jax.jit(fx_rice.exact_plan, static_argnums=(2, 3, 4, 5))(
        jnp.asarray(zz), jnp.asarray(order), porders, porders, 30, escapes)
    for field in rice.RicePlan._fields:
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(ref, field)),
            err_msg=field)
    # past 2^31 no code: every order invalid (less its fallback bias)
    assert (got.bits.numpy() >= rice.INVALID - rice.FALLBACK_BIAS).any()
    if escapes:
        assert bool((got.esc_seg & (got.k_seg == 31)).any())


def test_conformance_at_28_bits_equals_flacx_and_oracle():
    """Conformance mode at 28 bits (independent channels, int64 zigzag):
    every frame flacx packs byte-equal to flacx's, and through
    ``BatchEncoder`` every frame the oracle's; the same overflow flags."""
    n, p, prec = 1152, 8, 12
    pcm = np.concatenate([tones(12, 3, n, 2, 28),
                          make_pcm(np.random.default_rng(13), n, 2, 28,
                                   "noise")])
    blocks = np.ascontiguousarray(pcm.reshape(-1, n, 2).transpose(0, 2, 1))
    kw = dict(bps=28, channels=2, block_size=n, max_lpc_order=p,
              qlp_precision=prec, partition_orders=PORDERS)
    cfg = EncoderConfig(conformance=True, **kw)
    ref = {k: np.asarray(v) for k, v in fx_jitted_encode(
        FxConfig(conformance=True, **kw), None)(
            jnp.asarray(blocks), jnp.int64(5)).items()}
    out = _encode_batch(cfg, torch.from_numpy(blocks), 5)
    np.testing.assert_array_equal(out["overflow"].numpy(), ref["overflow"])
    oracle = [fx_pipeline._oracle_frame(blk.T, 5 + i, 28, n, p, prec,
                                        PORDERS)
              for i, blk in enumerate(blocks)]
    for i in np.nonzero(~ref["overflow"])[0]:
        got = out["bytes"][i, :out["length"][i]].numpy().tobytes()
        assert got == ref["bytes"][i, :ref["length"][i]].tobytes(), i
    frames = BatchEncoder(cfg, batch_frames=len(blocks), device="cpu") \
        .encode_frames(blocks, 5)
    assert frames == oracle


def test_cli_32_bit_wav_equals_flacx(tmp_path):
    """``python -m flacx_torch encode --device cpu`` on a 32-bit stereo WAV
    writes the bytes flacx's pipeline writes from it, at the defaults
    (f32 analysis: byte-equal on this input) and with ``--best`` (f64),
    and ``decode --device cpu`` gives the PCM back."""
    pcm = with_tail(tones(14, 3, 4608, 2, 32))
    wav = tmp_path / "in.wav"
    write_wav(wav, RATE, 32, pcm)
    assert read_wav(wav)[:3] == (RATE, 32, 2)
    out, back = tmp_path / "out.flac", tmp_path / "back.wav"
    flags = ("--batch-frames", str(BATCH))
    cli.main(["encode", "--device", "cpu", *flags, str(wav), str(out)])
    want = io.BytesIO()
    fx_pipeline.encode_chunks_to_file(
        want, fx_wavio.read_wav_chunks(wav, BATCH * 4608), sample_rate=RATE,
        bps=32, channels=2, total_samples=len(pcm), batch_frames=BATCH,
        **DEFAULTS)
    assert out.read_bytes() == want.getvalue()
    cli.main(["encode", "--device", "cpu", "--best", *flags, str(wav),
              str(out)])
    want = io.BytesIO()
    fx_pipeline.encode_best(want, pcm, sample_rate=RATE, bps=32, channels=2,
                            batch_frames=BATCH, windows=BEST_WINDOWS)
    assert out.read_bytes() == want.getvalue()
    cli.main(["decode", "--device", "cpu", str(out), str(back)])
    np.testing.assert_array_equal(read_wav(back)[3], pcm)
