"""flacx_torch emission, packing and CRC against flacx on the CPU.

The ``frame_pack`` kernel's plain version must produce frames byte for
byte identical to flacx's classic chain ``subframe_symbols →
pack_symbols_words → crc16_over_word_rows`` (``flacx/encoder.py:711-742``),
on subframes of every kind, escaped partitions and multi-byte frame
numbers included.
"""

import functools

import numpy as np
import pytest
import torch

import flacx.ops  # noqa: F401  (x64)
import jax
import jax.numpy as jnp
from flacx.ops import emit as fx_emit
from flacx.ops import headers as fx_headers
from flacx.ops import rice as fx_rice
from flacx.ops.bitpack import pack_symbols_words as fx_pack
from flacx.ops.bitpack import words_to_bytes as fx_words_to_bytes
from flacx.ops.crcfold import crc16_over_word_rows as fx_crc16_rows

from flacx_torch import crc, trace
from flacx_torch.format import FIXED_PREDICTOR_TAPS, Channels
from flacx_torch.kernels.frame_pack import frame_pack
from flacx_torch.kernels.lpc_residual import lpc_residual_zz_plain
from flacx_torch.ops import bitpack, crcfold, emit, lpc, rice
from flacx_torch.ops.framepack import pack_frames
from flacx_torch.ops.headers import frame_header_symbols

from conftest import make_pcm

torch.set_num_threads(1)

N, T, PREC, KMAX = 4608, 12, 5, 23
LPC, FIXED, VERB, CONST = emit.KIND_LPC, emit.KIND_FIXED, emit.KIND_VERBATIM, \
    emit.KIND_CONSTANT
#: (kind, order) of each frame's two subframes; the FIXED order-0 channel
#: carries uniform noise, whose partitions code smaller as escapes
LAYOUT = [[(LPC, 8), (FIXED, 2)],
          [(VERB, 0), (CONST, 0)],
          [(FIXED, 0), (LPC, 12)],
          [(LPC, 1), (VERB, 0)]]
INDICES = [0, 200, 70000, 1 << 33]
CH_CODES = [Channels.L_R, Channels.L_S, Channels.S_R, Channels.M_S]
MAX_FRAME_BYTES = 19712


def lpc_taps(row: np.ndarray, order: int) -> tuple[np.ndarray, int]:
    """Quantized order-``order`` predictor of one row (port analysis)."""
    w = lpc.window_from_numpy(
        lpc.apodization_window_np("tukey(0.5)", N).astype(np.float32))
    autoc = lpc.autocorrelate(torch.from_numpy(row[None]), T, window=w)
    taps, _, _ = lpc.levinson_all_orders(autoc, T)
    q, s, _ = lpc.quantize_all_orders(-taps, PREC)
    return q[0, order - 1].numpy(), int(s[0, order - 1])


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(21)
    b = len(LAYOUT)
    pcm = make_pcm(rng, b * N, 2, 16, "tonal")
    x = pcm.T.reshape(2, b, N).transpose(1, 0, 2).astype(np.int32).copy()
    kind = np.zeros((b, 2), np.int32)
    order = np.zeros((b, 2), np.int32)
    taps = np.zeros((b, 2, T), np.int32)
    shift = np.zeros((b, 2), np.int32)
    for f, chans in enumerate(LAYOUT):
        for c, (k, o) in enumerate(chans):
            kind[f, c], order[f, c] = k, o
            if k == CONST:
                x[f, c] = -1234
            elif k == FIXED:
                taps[f, c, :4] = FIXED_PREDICTOR_TAPS[o]
                if o == 0:
                    x[f, c] = rng.integers(-32768, 32768, N)
            elif k == LPC:
                taps[f, c], shift[f, c] = lpc_taps(x[f, c], o)
    bps = np.array([[16, 17]] * b, np.int32)
    zz = lpc_residual_zz_plain(*(torch.from_numpy(a) for a in
                                 (x, taps, shift, order)), 17, 192).numpy()
    return dict(kind=kind, order=order, bps=bps, x=x, taps=taps,
                shift=shift, zz=zz)


def plans(case, porders):
    """The port's and flacx's Rice plans of the case's residuals."""
    zz, order = case["zz"], case["order"]
    got = rice.exact_plan(torch.from_numpy(zz), torch.from_numpy(order),
                          porders, porders, KMAX)
    ref = jax.jit(functools.partial(
        fx_rice.exact_plan, porders=porders, preferred=porders, kmax=KMAX))(
            jnp.asarray(zz), jnp.asarray(order))
    return got, ref


@functools.partial(jax.jit, static_argnums=2)
def fx_subframe_symbols(j, plan, psize_min):
    return fx_emit.subframe_symbols(j["kind"], j["order"], j["bps"], j["x"],
                                    j["taps"], j["shift"], PREC, j["zz"],
                                    plan, psize_min=psize_min)


@functools.partial(jax.jit, static_argnums=2)
def fx_pack_crc(values, lengths, max_bytes):
    words, bits = fx_pack(values, lengths, max_bytes, use_tile_kernel=False)
    return words, bits, fx_crc16_rows(words, bits // 8)


@functools.partial(jax.jit, static_argnums=2)
def fx_chain(j, plan, psize_min):
    """flacx's classic emit → pack → CRC chain (encoder.py:711-742)."""
    b = j["x"].shape[0]
    hdr = fx_headers.frame_header_symbols(
        jnp.asarray(INDICES, jnp.int64),
        jnp.asarray([int(c) for c in CH_CODES], jnp.int32), N)
    sv, sl = fx_emit.subframe_symbols(j["kind"], j["order"], j["bps"], j["x"],
                                      j["taps"], j["shift"], PREC, j["zz"],
                                      plan, psize_min=psize_min)
    sv, sl = sv.reshape(b, -1), sl.reshape(b, -1)
    body = (jnp.sum(hdr.lengths, -1)
            + jnp.sum(sl, -1, dtype=jnp.int64)).astype(jnp.int32)
    values = jnp.concatenate([hdr.values, sv, jnp.zeros((b, 1), jnp.uint32)],
                             -1)
    lengths = jnp.concatenate([hdr.lengths, sl, ((-body) % 8)[:, None]], -1)
    words, bits = fx_pack(values, lengths, MAX_FRAME_BYTES,
                          use_tile_kernel=False)
    nbytes = bits // 8
    return fx_words_to_bytes(words), nbytes, fx_crc16_rows(words, nbytes)


def flacx_frames(case, plan, psize_min: int):
    """Frame bytes and lengths of :func:`fx_chain`, CRC-16 appended."""
    by, nbytes, crc16 = (np.asarray(a) for a in fx_chain(
        {k: jnp.asarray(v) for k, v in case.items()}, plan, psize_min))
    out = by.copy()
    for f in range(len(out)):
        n_ = int(nbytes[f])
        out[f, n_:n_ + 2] = [int(crc16[f]) >> 8, int(crc16[f]) & 0xFF]
    return out, nbytes + 2


def test_frame_header_symbols_match_flacx():
    idx = np.array(INDICES + [127, 128, 2047, 2048, (1 << 36) - 1],
                   np.int64)
    codes = np.arange(len(idx), dtype=np.int32) % 11
    for n in (4608, 4000, 200):
        got = frame_header_symbols(torch.from_numpy(idx),
                                   torch.from_numpy(codes), n)
        ref = jax.jit(fx_headers.frame_header_symbols, static_argnums=2)(
            jnp.asarray(idx), jnp.asarray(codes), n)
        for a, r in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(r))


@pytest.mark.parametrize("porders", [(0, 1, 2, 3, 4, 5), (0, 8)])
def test_subframe_symbols_match_flacx(case, porders):
    """The blocked slot layout (finest partition 144) and the general one
    (finest partition 18)."""
    got_plan, ref_plan = plans(case, porders)
    psize_min = N >> max(porders)
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    sv, sl = emit.subframe_symbols(t["kind"], t["order"], t["bps"], t["x"],
                                   t["taps"], t["shift"], PREC, t["zz"],
                                   got_plan, psize_min)
    rv, rl = fx_subframe_symbols({k: jnp.asarray(v) for k, v in case.items()},
                                 ref_plan, psize_min)
    np.testing.assert_array_equal(sl.numpy(), np.asarray(rl))
    live = sl.numpy() > 0
    np.testing.assert_array_equal(sv.numpy()[live], np.asarray(rv)[live])
    assert emit.blocked_layout_ok(N, psize_min) == (psize_min == 144)


def test_frame_pack_plain_matches_flacx_chain(case):
    porders = (0, 1, 2, 3, 4, 5)
    got_plan, ref_plan = plans(case, porders)
    assert bool(got_plan.esc_seg.any())
    ref_bytes, ref_len = flacx_frames(case, ref_plan, 144)
    hdr = frame_header_symbols(torch.tensor(INDICES),
                               torch.tensor([int(c) for c in CH_CODES],
                                            dtype=torch.int32), N)
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    out, length = pack_frames(hdr, t["kind"], t["order"], t["bps"], t["x"],
                              t["taps"], t["shift"], PREC, t["zz"],
                              got_plan, 144, MAX_FRAME_BYTES)
    assert out.dtype == torch.uint8 and length.dtype == torch.int32
    np.testing.assert_array_equal(length.numpy(), ref_len)
    np.testing.assert_array_equal(out.numpy(), ref_bytes)
    for f in range(len(LAYOUT)):
        frame = bytes(out[f, :length[f]].numpy())
        assert crc.crc16(frame[:-2]) == int.from_bytes(frame[-2:], "big")


def kernel_slot_walk(n: int, psize_min: int) -> tuple:
    """The ``frame_pack`` kernel's walk of one channel's param and sample
    slots (``csrc/frame_pack.cu`` ``walk_at`` / ``walk_step``): per slot,
    whether it is a param slot, and its param or sample index."""
    extra, mult = emit.general_layout_tables(n, psize_min)
    u = np.arange(n + n // psize_min)
    seg, r = u // (psize_min + 1), u % (psize_min + 1)
    is_param = np.concatenate([np.ones(len(extra), bool), r == 0])
    index = np.concatenate([extra, np.where(r == 0, np.asarray(mult)[seg],
                                            seg * psize_min + r - 1)])
    return torch.from_numpy(is_param), torch.from_numpy(index)


@pytest.mark.parametrize("porders", [(0, 1, 2, 3, 4, 5), (0, 6)])
def test_kernel_slot_walk_writes_the_blocked_stream(case, porders):
    """Finest partitions of 144 and 72 samples: the general layout's slot
    order, which the kernel walks at every partition size, gives the
    blocked layout's symbol stream."""
    psize_min = N >> max(porders)
    assert emit.blocked_layout_ok(N, psize_min)
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    plan = rice.exact_plan(t["zz"], t["order"], porders, porders, KMAX)
    pv, pl = emit.partition_param_symbols(t["kind"], plan)
    sv, sl = emit.sample_symbols_from(t["kind"], t["order"], t["bps"],
                                      t["x"], t["zz"], plan.k_sample,
                                      plan.esc_sample)
    blocked_v = torch.cat(emit.interleave_slots(pv, sv, psize_min), -1)
    blocked_l = torch.cat(emit.interleave_slots(pl, sl, psize_min), -1)
    is_param, index = kernel_slot_walk(N, psize_min)
    pidx = torch.where(is_param, index, 0)
    walk_v = torch.where(is_param, pv[..., pidx], sv[..., index])
    walk_l = torch.where(is_param, pl[..., pidx], sl[..., index])
    assert walk_l.shape[-1] == pl.shape[-1] + N
    for f in range(len(LAYOUT)):
        for c in range(2):
            live_b, live_w = blocked_l[f, c] > 0, walk_l[f, c] > 0
            assert torch.equal(blocked_l[f, c][live_b], walk_l[f, c][live_w])
            assert torch.equal(blocked_v[f, c][live_b], walk_v[f, c][live_w])


def test_frame_pack_wrapper_is_plain_on_cpu(case):
    """The wrapper takes its plain version for CPU tensors only."""
    plan, _ = plans(case, (0, 1, 2, 3, 4, 5))
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    hdr = frame_header_symbols(torch.tensor(INDICES),
                               torch.tensor([int(c) for c in CH_CODES],
                                            dtype=torch.int32), N)
    sh_v, sh_l = emit.subframe_header_symbols(
        t["kind"], t["order"], t["bps"], t["x"], t["taps"], t["shift"],
        PREC, plan)
    pv, pl = emit.partition_param_symbols(t["kind"], plan)
    kesc = plan.k_seg.int() | (plan.esc_seg.int() << 7)
    with trace.recording():
        before = trace.snapshot()["counters"]
        out, length = frame_pack(hdr.values, hdr.lengths, sh_v, sh_l, pv,
                                 pl, t["zz"], t["x"], kesc, t["kind"],
                                 t["order"], t["bps"], 144, MAX_FRAME_BYTES)
        assert trace.snapshot()["counters"] == before
    ref, ref_len = pack_frames(hdr, t["kind"], t["order"], t["bps"], t["x"],
                               t["taps"], t["shift"], PREC, t["zz"], plan,
                               144, MAX_FRAME_BYTES)
    assert torch.equal(out, ref) and torch.equal(length, ref_len)


def test_pack_symbols_words_matches_flacx():
    rng = np.random.default_rng(9)
    b, s = 3, 300
    lengths = rng.integers(0, 33, size=(b, s)).astype(np.int32)
    lengths[0, :50] = 0
    values = rng.integers(0, 1 << 32, size=(b, s), dtype=np.uint64)
    values &= (np.uint64(1) << lengths.astype(np.uint64)) - np.uint64(1)
    words, bits = bitpack.pack_symbols_words(
        torch.from_numpy(values.astype(np.int64)), torch.from_numpy(lengths),
        1024)
    ref_w, ref_b, _ = fx_pack_crc(jnp.asarray(values.astype(np.uint32)),
                                  jnp.asarray(lengths), 1024)
    np.testing.assert_array_equal(words.numpy(), np.asarray(ref_w))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(ref_b))
    np.testing.assert_array_equal(bitpack.words_to_bytes(words).numpy(),
                                  np.asarray(fx_words_to_bytes(ref_w)))


def test_crc16_over_word_rows_matches_host_crc():
    rng = np.random.default_rng(4)
    nbytes = np.array([0, 1, 5, 63, 200])
    data = np.zeros((5, 256), np.uint8)
    for r, n_ in enumerate(nbytes):
        data[r, :n_] = rng.integers(0, 256, n_)
    words = torch.from_numpy(
        data.reshape(5, 64, 4).astype(np.int64)
        @ np.array([1 << 24, 1 << 16, 1 << 8, 1], np.int64))
    got = crcfold.crc16_over_word_rows(words, torch.from_numpy(nbytes))
    assert got.tolist() == [crc.crc16(bytes(data[r, :n_]))
                            for r, n_ in enumerate(nbytes)]


def test_host_crc_check_values():
    assert crc.crc8(b"123456789") == 0xF4
    assert crc.crc16(b"123456789") == 0xFEE8


def test_tile_layout_predicates_match_flacx():
    """``segmented_layout`` and ``tile_layout_ok`` (which picks the
    estimate search's residual route) against flacx's layout gate
    (``flacx/encoder.py:318-320``) at every block size and finest
    partition the CLI can ask for, and at the routes' named cases."""
    for n in (192, 576, 1152, 2304, 4096, 4608, 8192, 16384):
        for po in range(16):
            if n % (1 << po):
                continue
            psize = n >> po
            assert emit.segmented_layout(n, psize) == \
                fx_emit.segmented_layout(n, psize), (n, psize)
            assert emit.tile_layout_ok(n, psize) == (
                fx_emit.blocked_layout_ok(n, psize)
                or fx_emit.segmented_layout(n, psize) is not None)
    assert emit.tile_layout_ok(4608, 144) and emit.tile_layout_ok(16384, 1)
    for n, po in ((1152, 5), (4608, 7), (2304, 6)):
        assert not emit.tile_layout_ok(n, n >> po), (n, po)
