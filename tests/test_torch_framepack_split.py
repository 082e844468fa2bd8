"""The ``frame_pack`` kernel's split of a frame into chunks, modelled on the
CPU against flacx.

The kernel cuts a frame's symbol slots into chunks of a fixed slot count.
Each chunk counts its bits and packs its symbols alone, from bit 0; an
exclusive scan of the chunk totals gives each chunk its bit offset.  A
word whose bits come from several chunks is written by the chunk that
holds its first bit, which ORs in the leading bits of the chunks after
it.  Each chunk folds the CRC-16 of the bytes it wrote in runs of whole
words (four bytes a step), shifts each run's CRC by the bytes after the
run (``x^(8 len) mod P``) and XORs them; the chunks' CRCs are joined in
order by ``crc(A|B) = crc(A) * x^(8|B|) + crc(B)``, the GF(2) products
taken from integer products of bits four apart.  The model below does
the same in plain Python on the symbol streams that flacx's
``pack_symbols_words`` and ``crc16_over_word_rows`` take, and must give
their words and CRC at every chunk size, one slot a chunk included.
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
from flacx.ops.crcfold import crc16_over_word_rows as fx_crc16_rows

from flacx_torch.encoder import EncoderConfig
from flacx_torch.format import FIXED_PREDICTOR_TAPS
from flacx_torch.kernels.lpc_residual import lpc_residual_zz_plain
from flacx_torch.ops import emit

from conftest import make_pcm

torch.set_num_threads(1)

POLY = 0x18005
MASK32 = 0xFFFFFFFF


def mod_p(v: int) -> int:
    """``v mod P`` over GF(2)."""
    for t in range(v.bit_length() - 1, 15, -1):
        if (v >> t) & 1:
            v ^= POLY << (t - 16)
    return v


def clmul(a: int, b: int) -> int:
    out = 0
    for t in range(b.bit_length()):
        if (b >> t) & 1:
            out ^= a << t
    return out


#: tab[k][i] = i * x^(16 + 8k) mod P, the kernel's table rows
TAB = [[mod_p(i << (16 + 8 * k)) for i in range(256)] for k in range(4)]


@functools.lru_cache(maxsize=None)
def shift8(k: int) -> int:
    """``x^(8k) mod P``."""
    return 1 if k == 0 else mod_p(shift8(k - 1) << 8)


def mulmod(a: int, b: int) -> int:
    """``a * b mod P`` as the kernel takes it: the four classes of bits
    four apart multiplied as integers (32-bit), the top bits reduced by
    the table rows x^16 and x^24."""
    m = [0x1111 << k for k in range(4)]
    av, bv = [a & mk for mk in m], [b & mk for mk in m]
    p = 0
    for k in range(4):
        z = 0
        for i in range(4):
            z ^= (av[i] * bv[(k - i) % 4]) & MASK32
        p |= z & (0x11111111 << k)
    return (p & 0xFFFF) ^ TAB[0][(p >> 16) & 0xFF] ^ TAB[1][p >> 24]


def crc_run(words: list, nbytes: int) -> int:
    """CRC-16 of the first ``nbytes`` bytes of MSB-first ``words``: a
    whole word a step, the last bytes one at a time."""
    crc = 0
    for i, wd in enumerate(words):
        if 4 * i + 4 <= nbytes:
            crc = (TAB[3][(wd >> 24) ^ (crc >> 8)]
                   ^ TAB[2][((wd >> 16) & 0xFF) ^ (crc & 0xFF)]
                   ^ TAB[1][(wd >> 8) & 0xFF] ^ TAB[0][wd & 0xFF])
        else:
            for j in range(nbytes - 4 * i):
                byte = (wd >> (24 - 8 * j)) & 0xFF
                crc = TAB[0][(crc >> 8) ^ byte] ^ ((crc << 8) & 0xFFFF)
    return crc


def pack_alone(values, lengths) -> list:
    """One chunk's symbols packed MSB-first from bit 0, the last word
    zero-padded."""
    acc, bits = 0, 0
    for v, ln in zip(values, lengths):
        acc = (acc << int(ln)) | (int(v) & ((1 << int(ln)) - 1))
        bits += int(ln)
    acc <<= -bits % 32
    n = (bits + 31) // 32
    return [(acc >> (32 * (n - 1 - i))) & MASK32 for i in range(n)]


def split_pack(values, lengths, chunk: int, threads: int):
    """The kernel's decomposition of one frame's stream: ``(words, total
    bits, CRC-16 of its bytes)``."""
    slots = len(values)
    starts = range(0, slots, chunk)
    counts = [int(lengths[s:s + chunk].sum()) for s in starts]
    offs = np.concatenate([[0], np.cumsum(counts)]).tolist()
    packed = [pack_alone(values[s:s + chunk], lengths[s:s + chunk])
              for s in starts]
    total, nch = offs[-1], len(counts)
    nbytes = (total + 7) // 8
    words, parts = [0] * ((total + 31) // 32), []
    for d in range(nch):
        s, e = offs[d], offs[d + 1]
        w0, w1 = (s + 31) // 32, (e + 31) // 32  # words starting in d
        own = []
        for w in range(w0, w1):
            rel = 32 * w - s
            src, iw, sh = packed[d], rel >> 5, rel & 31
            val = src[iw]
            if sh:
                nxt = src[iw + 1] if iw + 1 < len(src) else 0
                val = ((val << sh) | (nxt >> (32 - sh))) & MASK32
            f = d + 1
            while f < nch and offs[f] < 32 * w + 32:
                if offs[f + 1] > offs[f]:
                    val |= packed[f][0] >> (offs[f] - 32 * w)
                f += 1
            own.append(val)
        words[w0:w1] = own
        nb = min(4 * w1, nbytes) - 4 * w0 if w1 > w0 else 0
        nw = (nb + 3) // 4
        per = -(-nw // threads)
        crc = 0
        for lo in range(0, nw, per or 1):
            hi = min(lo + per, nw)
            run_bytes = min(4 * hi, nb) - 4 * lo
            crc ^= mulmod(crc_run(own[lo:hi], run_bytes),
                          shift8(nb - min(4 * hi, nb)))
        parts.append((crc, shift8(nb)))
    # the frame's last chunk: 32 lanes fold a share of the parts each in
    # order, then a log-depth tree joins the lanes in order
    pc = -(-nch // 32)
    lanes = []
    for lane in range(32):
        crc, pw = 0, 1
        for c, p in parts[lane * pc:(lane + 1) * pc]:
            crc, pw = mulmod(crc, p) ^ c, mulmod(pw, p)
        lanes.append((crc, pw))
    while len(lanes) > 1:
        lanes = [(mulmod(ca, pb) ^ cb, mulmod(pa, pb))
                 for (ca, pa), (cb, pb) in zip(lanes[0::2], lanes[1::2])]
    return words, total, lanes[0][0]


def flacx_streams(n: int, porders: tuple, bps: int):
    """``(values, lengths, words, bits, crc)`` of two frames through flacx:
    the symbol streams its encoder hands ``pack_symbols_words`` (frame
    header, subframes, byte pad), and its packed words and CRC-16."""
    b, psize_min = 2, n >> max(porders)
    rng = np.random.default_rng(17)
    pcm = make_pcm(rng, b * n, 2, bps, "tonal")
    x = pcm.T.reshape(2, b, n).transpose(1, 0, 2).copy()
    kind = np.array([[emit.KIND_FIXED, emit.KIND_LPC],
                     [emit.KIND_VERBATIM, emit.KIND_FIXED]], np.int32)
    order = np.array([[2, 4], [0, 0]], np.int32)
    x[1, 1] = rng.integers(-(1 << (bps - 1)), 1 << (bps - 1), n)  # escapes
    taps = np.zeros((b, 2, 4), np.int32)
    taps[...] = FIXED_PREDICTOR_TAPS[order]
    shift = np.zeros((b, 2), np.int32)
    bps_a = np.full((b, 2), bps, np.int32)
    zz = lpc_residual_zz_plain(*(torch.from_numpy(a) for a in
                                 (x, taps, shift, order)), bps + 1, 15).numpy()
    kmax = EncoderConfig(block_size=n, bps=bps, partition_orders=porders).kmax
    plan = jax.jit(functools.partial(
        fx_rice.exact_plan, porders=porders, preferred=porders, kmax=kmax))(
            jnp.asarray(zz), jnp.asarray(order))
    hdr = fx_headers.frame_header_symbols(
        jnp.asarray([5, 70000], jnp.int64), jnp.asarray([1, 1], jnp.int32), n)
    sv, sl = fx_emit.subframe_symbols(
        *(jnp.asarray(a) for a in (kind, order, bps_a, x, taps, shift)), 5,
        jnp.asarray(zz), plan, psize_min=psize_min)
    sv, sl = sv.reshape(b, -1), sl.reshape(b, -1)
    body = jnp.sum(hdr.lengths, -1) + jnp.sum(sl, -1, dtype=jnp.int64)
    values = jnp.concatenate([hdr.values, sv, jnp.zeros((b, 1), jnp.uint32)],
                             -1)
    lengths = jnp.concatenate(
        [hdr.lengths, sl, ((-body) % 8).astype(jnp.int32)[:, None]], -1)
    cfg = EncoderConfig(block_size=n, bps=bps)
    words, bits = fx_pack(values, lengths, cfg.max_frame_bytes,
                          use_tile_kernel=False)
    crc = fx_crc16_rows(words, bits // 8)
    return tuple(np.asarray(a) for a in (values, lengths, words, bits, crc))


@functools.lru_cache(maxsize=None)
def layout(name: str):
    if name == "headline":
        return flacx_streams(4608, (0, 1, 2, 3, 4, 5), 16)
    return flacx_streams(1024, tuple(range(11)), 24)   # one-sample


@pytest.mark.parametrize("name", ["headline", "one_sample"])
@pytest.mark.parametrize("chunk,threads", [(1, 256), (33, 3), (256, 256),
                                           (2048, 256), (2048, 5)])
def test_split_pack_matches_flacx(name, chunk, threads):
    values, lengths, words, bits, crc = layout(name)
    if name == "one_sample":
        assert values.shape[1] > 2 * 2048   # a slot per sample and param
    for f in range(len(values)):
        got_words, total, got_crc = split_pack(values[f], lengths[f], chunk,
                                               threads)
        assert total == int(bits[f]) and total % 8 == 0
        want = words[f, :len(got_words)].astype(np.int64).tolist()
        assert got_words == want
        assert not words[f, len(got_words):].any()
        assert got_crc == int(crc[f])


def test_chunk_totals_cross_words():
    """At 33 slots a chunk, chunk offsets fall inside words and on word
    boundaries, and some chunks carry no bits."""
    values, lengths, *_ = layout("one_sample")
    counts = np.add.reduceat(lengths[0].astype(np.int64),
                             np.arange(0, lengths.shape[1], 33))
    offs = np.cumsum(counts)
    assert (offs % 32 == 0).any() and (offs % 32 != 0).any()
    assert (counts == 0).any() or (lengths[1] == 0).any()


def test_gf_mulmod_from_integer_products():
    rng = np.random.default_rng(3)
    pairs = [(0xFFFF, 0xFFFF), (0, 0x1234), (1, 0x8005), (0x8000, 0x8000)]
    pairs += [tuple(map(int, p)) for p in rng.integers(0, 1 << 16, (300, 2))]
    for a, b in pairs:
        assert mulmod(a, b) == mod_p(clmul(a, b)), (a, b)
