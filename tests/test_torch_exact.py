"""flacx_torch's best-compression path against flacx on the CPU.

The exact order search (every order's residual statistics, f64
analysis), several apodization windows, wasted bits and finest partitions
below 40 samples (the general slot layout): the port's plain path must
write the same bytes as ``flacx.encoder._encode_batch`` wherever the two
chose the same coefficients, and every frame must decode bit-exactly.
Each module that holds a kernel is held against flacx on the same inputs.
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
from flacx.format import Streaminfo
from flacx.kernels.lpcres_tile import lpc_allorder_stats as fx_allorder
from flacx.ops import emit as fx_emit
from flacx.ops import headers as fx_headers
from flacx.ops import lpc as fx_lpc
from flacx.ops import rice as fx_rice
from flacx.ops.bitpack import pack_symbols_words as fx_pack
from flacx.ops.bitpack import words_to_bytes as fx_words_to_bytes
from flacx.ops.crcfold import crc16_over_word_rows as fx_crc16_rows
from flacx.oracle.decoder import read_frame

from flacx_torch import crc
from flacx_torch.encoder import (BatchEncoder, _encode_batch,
                                 analysis_windows, config_from_flacx,
                                 shared_trailing_zeros)
from flacx_torch.format import FIXED_PREDICTOR_TAPS, Channels
from flacx_torch.kernels.analysis import analysis
from flacx_torch.kernels.lpc_allorder import lpc_allorder, lpc_allorder_plain
from flacx_torch.kernels.lpc_residual import lpc_residual_zz_plain
from flacx_torch.kernels.rice_stats import rice_stats
from flacx_torch.ops import emit, lpc, rice
from flacx_torch.ops.framepack import pack_frames
from flacx_torch.ops.headers import frame_header_symbols

from conftest import make_pcm

torch.set_num_threads(1)

WINDOWS3 = ("tukey(0.5)", "hann", "flattop")
#: the three flacx configurations, each a fresh XLA:CPU compile
CONFIGS = {
    # `encode --best` at its general-layout block (finest partition 36)
    "best-1152": FxConfig(block_size=1152, order_search="exact",
                          windows=WINDOWS3),
    # estimate search, two windows, 18-sample partitions, wasted bits
    "estimate-windows-wasted": FxConfig(
        block_size=4608, windows=("tukey(0.5)", "hann"),
        partition_orders=tuple(range(9)), wasted_bits=True),
    # exact search without stereo modes, f32 analysis
    "exact-independent-f32": FxConfig(block_size=2304, order_search="exact",
                                      stereo="independent",
                                      analysis_dtype="f32"),
}


def planar_frames(seed: int, n: int, frames: int, kind: str,
                  bps: int = 16) -> np.ndarray:
    """``[frames, 2, n]`` int32 stereo blocks."""
    pcm = make_pcm(np.random.default_rng(seed), frames * n, 2, bps, kind)
    return np.ascontiguousarray(pcm.reshape(frames, n, 2).transpose(0, 2, 1))


def frames_of(out: dict) -> list[bytes]:
    data, lens = np.asarray(out["bytes"]), np.asarray(out["length"])
    return [bytes(data[i, :lens[i]]) for i in range(len(lens))]


def streaminfo(n: int) -> Streaminfo:
    return Streaminfo(n, n, 0, 0, 44100, 2, 16, 0, bytes(16))


def subframe_params(frame_bytes: bytes, n: int) -> tuple:
    frame, _ = read_frame(BitReader(frame_bytes), streaminfo(n))
    return (frame.header.channels,
            tuple((sf.kind, sf.order, sf.shift, sf.coefficients,
                   sf.wasted_bits) for sf in frame.subframes))


@pytest.fixture(scope="module", params=list(CONFIGS))
def encoded(request):
    """Four tonal and four noise frames (two of them 13-bit shifted left
    by 3: wasted bits), flacx's encoding of them and the port's."""
    fx_cfg = CONFIGS[request.param]
    n = fx_cfg.block_size
    pcm = np.concatenate([planar_frames(1, n, 4, "tonal"),
                          planar_frames(2, n, 4, "noise")])
    pcm[2:4] = planar_frames(3, n, 2, "tonal", bps=13) << 3
    ref = jax.jit(functools.partial(fx_encode_batch, fx_cfg))(
        jnp.asarray(pcm), jnp.int64(7))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    cfg = config_from_flacx(dataclasses.asdict(fx_cfg))
    out = _encode_batch(cfg, torch.from_numpy(pcm), 7)
    return request.param, cfg, pcm, ref, out


def test_frames_match_flacx(encoded):
    name, cfg, _, ref, out = encoded
    got, want = frames_of(out), frames_of(ref)
    differ = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            differ += 1
            assert subframe_params(g, cfg.block_size) != \
                subframe_params(w, cfg.block_size), \
                f"{name} frame {i}: same coefficients, different bytes"
    assert differ <= len(got) // 8, name


def test_kind_mode_and_size_match_flacx(encoded):
    name, _, _, ref, out = encoded
    for key in ("kind", "channel_code", "subframe_bits"):
        np.testing.assert_array_equal(out[key].numpy(), ref[key],
                                      err_msg=f"{name} {key}")


def test_frames_decode_bit_exactly(encoded):
    name, cfg, pcm, _, out = encoded
    n = cfg.block_size
    wasted_seen = 0
    for i, frame in enumerate(frames_of(out)):
        assert crc.crc16(frame[:-2]) == int.from_bytes(frame[-2:], "big")
        decoded, planes = read_frame(BitReader(frame), streaminfo(n))
        np.testing.assert_array_equal(np.asarray(planes), pcm[i],
                                      err_msg=f"{name} frame {i}")
        wasted_seen += sum(sf.wasted_bits for sf in decoded.subframes)
    assert (wasted_seen > 0) == cfg.wasted_bits, name


def test_batch_encoder_holds_every_window():
    """``BatchEncoder`` builds one window per name in the analysis type
    and writes the frames of a direct ``_encode_batch`` call."""
    cfg = config_from_flacx(dataclasses.asdict(CONFIGS["best-1152"]))
    pcm = planar_frames(5, 1152, 3, "tonal")
    enc = BatchEncoder(cfg, batch_frames=2, device="cpu")
    assert [w.dtype for w in enc._windows] == [torch.float64] * 3
    direct = frames_of(_encode_batch(cfg, torch.from_numpy(pcm), 4,
                                     analysis_windows(cfg, "cpu")))
    assert enc.encode_frames(pcm.astype(np.int16), 4) == direct
    with pytest.raises(ValueError, match="windows"):
        _encode_batch(cfg, torch.from_numpy(pcm), 0,
                      analysis_windows(cfg, "cpu")[:1])


# ---------------------------------------------------------------------------
# module tests


def test_lpc_allorder_plain_matches_pallas_kernel(rng):
    """The shape of flacx's own all-orders kernel test."""
    b, v, n, p = 32, 4, 1024, 12
    x = rng.integers(-(1 << 15), 1 << 15, size=(b, v, n)).astype(np.int32)
    qcoefs = rng.integers(-16, 16, size=(b, v, p, p)).astype(np.int32)
    qcoefs *= np.arange(p) < np.arange(1, p + 1)[:, None]
    shifts = rng.integers(0, 15, size=(b, v, p)).astype(np.int32)
    ref = fx_allorder(jnp.asarray(x), jnp.asarray(qcoefs),
                      jnp.asarray(shifts), interpret=True)
    got = lpc_allorder(*(torch.from_numpy(a) for a in (x, qcoefs, shifts)),
                       17, p << 4)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.int32


def test_lpc_allorder_plain_matches_flacx_residual_stack():
    """Order 32 at precision 5, full-scale 17-bit rows, a silent row and
    a ragged length."""
    rng = np.random.default_rng(31)
    r, n, p = 6, 777, 32
    x = rng.integers(-(1 << 16), 1 << 16, size=(r, n)).astype(np.int32)
    x[0] = 0
    x[1] = np.where(np.arange(n) % 2, (1 << 16) - 1, -(1 << 16))
    qcoefs = rng.integers(-16, 16, size=(r, p, p)).astype(np.int32)
    qcoefs *= np.arange(p) < np.arange(1, p + 1)[:, None]
    shifts = rng.integers(0, 15, size=(r, p)).astype(np.int32)
    res = np.asarray(fx_lpc.lpc_residuals_all(
        jnp.asarray(x), jnp.asarray(qcoefs), jnp.asarray(shifts), jnp.int64))
    res = res * (np.arange(n) >= np.arange(1, p + 1)[:, None])
    lzz, maxabs = lpc_allorder_plain(
        *(torch.from_numpy(a) for a in (x, qcoefs, shifts)), 17, p << 4)
    np.testing.assert_array_equal(
        lzz.numpy(), np.asarray(fx_rice.zigzag(jnp.asarray(res))).sum(-1))
    np.testing.assert_array_equal(maxabs.numpy(), np.abs(res).max(-1))
    # past the int32 MAC bound the plain version takes the int64 route
    # (no longer a refusal): the same statistics on these rows
    wide = lpc_allorder_plain(*(torch.from_numpy(a) for a in
                                (x, qcoefs, shifts)), 25, 32 << 14)
    for g, w in zip(wide, (lzz, maxabs)):
        assert torch.equal(g, w) and g.dtype == w.dtype


@pytest.mark.parametrize("n,max_lag", [(1152, 12), (4608, 12), (1000, 32)])
def test_f64_autocorrelate_matches_flacx(n, max_lag):
    """Same f64 products, other summation order: rtol 1e-12, or 1e-12 of
    the lag-0 sum (which bounds Σ|products|) near zero."""
    x = np.concatenate([planar_frames(n, n, 2, "tonal"),
                        planar_frames(n + 1, n, 1, "noise")])
    for name in WINDOWS3:
        w64 = lpc.apodization_window_np(name, n)
        autoc, fsums = analysis(torch.from_numpy(x), torch.from_numpy(w64),
                                max_lag)
        ref = np.asarray(jax.jit(functools.partial(
            fx_lpc.autocorrelate, max_lag=max_lag, use_tile_kernel=False))(
                jnp.asarray(x).astype(jnp.float64), window=jnp.asarray(w64)))
        tol = 1e-12 * (np.abs(ref) + np.abs(ref[..., :1]))
        assert np.all(np.abs(autoc.numpy() - ref) <= tol), name
        assert fsums is not None
    _, none = analysis(torch.from_numpy(x), torch.from_numpy(w64), max_lag,
                       fixed_sums=False)
    assert none is None


def fx_merge(ranks, lzzs, lmaxs, qcoefs, qshifts, valids):
    """flacx's window merge, ``encoder.py:449-466``, step for step."""
    inf = jnp.int64(1) << 50
    best = None
    for w in range(len(ranks)):
        wrank_w = jnp.where(valids[w], lzzs[w], inf)
        if best is None:
            best = dict(wrank=wrank_w, lzz=lzzs[w], lmax=lmaxs[w],
                        q=qcoefs[w], s=qshifts[w], valid=valids[w])
            continue
        bet = wrank_w < best["wrank"]
        best = dict(
            wrank=jnp.where(bet, wrank_w, best["wrank"]),
            lzz=jnp.where(bet, lzzs[w], best["lzz"]),
            valid=bet & valids[w] | ~bet & best["valid"],
            s=jnp.where(bet, qshifts[w], best["s"]),
            q=jnp.where(bet[..., None], qcoefs[w], best["q"]),
            lmax=jnp.where(bet, lmaxs[w], best["lmax"]))
    return best


def test_window_merge_matches_flacx():
    rng = np.random.default_rng(17)
    shape = (5, 4, 12)
    ws = 3
    lzzs = [rng.integers(0, 6, size=shape) for _ in range(ws)]   # ties
    lmaxs = [rng.integers(0, 1 << 20, size=shape).astype(np.int32)
             for _ in range(ws)]
    qcoefs = [rng.integers(-16, 16, size=shape + (12,)).astype(np.int32)
              for _ in range(ws)]
    qshifts = [rng.integers(0, 15, size=shape).astype(np.int32)
               for _ in range(ws)]
    valids = [rng.random(shape) < 0.7 for _ in range(ws)]
    ref = fx_merge(*([jnp.asarray(a) for a in arrs] for arrs in
                     (lzzs, lzzs, lmaxs, qcoefs, qshifts, valids)))
    best = None
    for w in range(ws):
        cand = lpc.window_candidates(
            *(torch.from_numpy(a[w]) for a in
              (lzzs, lmaxs, qcoefs, qshifts, valids)))
        best = lpc.merge_windows(best, cand)
    for got, key in zip(best, ("wrank", "lzz", "lmax", "q", "s", "valid")):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    est = lpc.merge_windows(None, cand._replace(maxabs=None))
    assert lpc.merge_windows(est, est).maxabs is None


def test_shared_trailing_zeros_match_flacx():
    """flacx's count (``encoder.py:292-299``: lowest set bit, f64 log2,
    63 for zero) on rows with shared zeros, odd samples, INT32_MIN and
    all-zero rows."""
    rng = np.random.default_rng(23)
    x = rng.integers(-(1 << 20), 1 << 20, size=(3, 4, 64)).astype(np.int32)
    for r, k in enumerate((0, 1, 5, 11, 17, 30)):
        x.reshape(12, 64)[r] <<= k
    x[1, 2] = 0
    x[2, 3] = 0
    x[2, 1, 5] = np.int32(-(1 << 31))
    x[2, 1, :5] = 0
    x[2, 1, 6:] = 0
    xu = jnp.asarray(x).astype(jnp.uint32)
    lowbit = xu & (~xu + jnp.uint32(1))
    tz = jnp.where(lowbit == 0, 63, jnp.round(jnp.log2(jnp.maximum(
        lowbit.astype(jnp.float64), 1.0))).astype(jnp.int32))
    ref = np.asarray(jnp.min(tz, axis=-1))
    got = shared_trailing_zeros(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert {63, 31, 17}.issubset(set(ref.ravel().tolist()))


def test_rice_plan_of_all_virtual_channels_at_36_sample_partitions():
    """The exact plan of ``[B, 4, 1152]`` residuals at partition orders
    0..5 (36-sample partitions), from ``rice_stats``, equals flacx's
    plan."""
    rng = np.random.default_rng(29)
    zz = np.minimum(rng.exponential(size=(4, 4, 1152))
                    * 2.0 ** rng.integers(0, 26, size=(4, 4, 1)), 2 ** 30 - 1)
    order = rng.integers(0, 13, size=(4, 4)).astype(np.int32)
    zz = np.where(np.arange(1152) < order[..., None], 0, zz).astype(np.int32)
    porders = (0, 1, 2, 3, 4, 5)
    ref = jax.jit(functools.partial(fx_rice.exact_plan, porders=porders,
                                    preferred=porders, kmax=23))(
        jnp.asarray(zz), jnp.asarray(order))
    zt, ot = torch.from_numpy(zz), torch.from_numpy(order)
    got = rice.exact_plan(zt, ot, porders, porders, 23,
                          kernel_stats=rice_stats(zt, ot, porders, 23))
    for field in rice.RicePlan._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)


# ---------------------------------------------------------------------------
# frame_pack in the general layout


PREC, T, KMAX = 5, 12, 23
LPC, FIXED, VERB, CONST = (emit.KIND_LPC, emit.KIND_FIXED,
                           emit.KIND_VERBATIM, emit.KIND_CONSTANT)
LAYOUT = [[(LPC, 8), (FIXED, 2)],
          [(VERB, 0), (CONST, 0)],
          [(FIXED, 0), (LPC, 12)],
          [(LPC, 1), (VERB, 0)]]
WASTED = [[2, 0], [1, 3], [0, 0], [0, 4]]
INDICES = [0, 200, 70000, 1 << 33]
CH_CODES = [Channels.L_R, Channels.L_S, Channels.S_R, Channels.M_S]


def subframes(n: int) -> dict:
    """Subframes of every kind, some with wasted bits (their samples and
    width already shifted), one uniform-noise channel that escapes."""
    rng = np.random.default_rng(n)
    b = len(LAYOUT)
    x = planar_frames(n, n, b, "tonal").copy()
    kind, order, shift = (np.zeros((b, 2), np.int32) for _ in range(3))
    taps = np.zeros((b, 2, T), np.int32)
    wasted = np.array(WASTED, np.int32)
    bps = 16 - wasted
    for f, chans in enumerate(LAYOUT):
        for c, (k, o) in enumerate(chans):
            kind[f, c], order[f, c] = k, o
            x[f, c] >>= wasted[f, c]
            if k == CONST:
                x[f, c] = -1234
            elif k == FIXED:
                taps[f, c, :4] = FIXED_PREDICTOR_TAPS[o]
                if o == 0:
                    x[f, c] = rng.integers(-32768, 32768, n)
            elif k == LPC:
                w = lpc.window_from_numpy(lpc.apodization_window_np(
                    "tukey(0.5)", n).astype(np.float32))
                autoc = lpc.autocorrelate(torch.from_numpy(x[f, c][None]),
                                          T, window=w)
                q, s, _ = lpc.quantize_all_orders(
                    -lpc.levinson_all_orders(autoc, T)[0], PREC)
                taps[f, c], shift[f, c] = q[0, o - 1].numpy(), s[0, o - 1]
    zz = lpc_residual_zz_plain(*(torch.from_numpy(a) for a in
                                 (x, taps, shift, order)), 17, 192).numpy()
    return dict(kind=kind, order=order, bps=bps, x=x, taps=taps, shift=shift,
                zz=zz, wasted=wasted)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def fx_chain(j, plan, n, psize_min, max_bytes):
    """flacx's classic emit → pack → CRC chain (``encoder.py:711-742``)."""
    b = j["x"].shape[0]
    hdr = fx_headers.frame_header_symbols(
        jnp.asarray(INDICES, jnp.int64),
        jnp.asarray([int(c) for c in CH_CODES], jnp.int32), n)
    sv, sl = fx_emit.subframe_symbols(j["kind"], j["order"], j["bps"], j["x"],
                                      j["taps"], j["shift"], PREC, j["zz"],
                                      plan, psize_min=psize_min,
                                      wasted=j["wasted"])
    sv, sl = sv.reshape(b, -1), sl.reshape(b, -1)
    body = (jnp.sum(hdr.lengths, -1)
            + jnp.sum(sl, -1, dtype=jnp.int64)).astype(jnp.int32)
    values = jnp.concatenate([hdr.values, sv, jnp.zeros((b, 1), jnp.uint32)],
                             -1)
    lengths = jnp.concatenate([hdr.lengths, sl, ((-body) % 8)[:, None]], -1)
    words, bits = fx_pack(values, lengths, max_bytes, use_tile_kernel=False)
    nbytes = bits // 8
    return fx_words_to_bytes(words), nbytes, fx_crc16_rows(words, nbytes)


@pytest.mark.parametrize("n,porders", [(1152, (0, 1, 2, 3, 4, 5)),
                                       (4608, (0, 2, 5, 8))])
def test_frame_pack_plain_general_layout_matches_flacx_chain(n, porders):
    """Finest partitions of 36 and 18 samples: the general slot layout."""
    case = subframes(n)
    psize_min = n >> max(porders)
    assert not emit.blocked_layout_ok(n, psize_min)
    max_bytes = config_from_flacx(dataclasses.asdict(
        FxConfig(block_size=n))).max_frame_bytes
    zt, ot = torch.from_numpy(case["zz"]), torch.from_numpy(case["order"])
    plan = rice.exact_plan(zt, ot, porders, porders, KMAX)
    ref_plan = fx_rice.exact_plan(jnp.asarray(case["zz"]),
                                  jnp.asarray(case["order"]), porders,
                                  porders, KMAX)
    assert bool(plan.esc_seg.any())
    by, nbytes, crc16 = (np.asarray(a) for a in fx_chain(
        {k: jnp.asarray(v) for k, v in case.items()}, ref_plan, n,
        psize_min, max_bytes))
    ref = by.copy()
    for f in range(len(ref)):
        ref[f, nbytes[f]:nbytes[f] + 2] = [int(crc16[f]) >> 8,
                                           int(crc16[f]) & 0xFF]
    hdr = frame_header_symbols(torch.tensor(INDICES),
                               torch.tensor([int(c) for c in CH_CODES],
                                            dtype=torch.int32), n)
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    out, length = pack_frames(hdr, t["kind"], t["order"], t["bps"], t["x"],
                              t["taps"], t["shift"], PREC, t["zz"], plan,
                              psize_min, max_bytes, wasted=t["wasted"])
    np.testing.assert_array_equal(length.numpy(), nbytes + 2)
    np.testing.assert_array_equal(out.numpy(), ref)
    extra, mult = emit.general_layout_tables(n, psize_min)
    assert len(mult) == n // psize_min and len(extra) + len(mult) == len(
        emit.param_slot_positions(n, psize_min))
