"""How the decode kernels split their work, modelled in plain torch and
held against flacx on the CPU, integer for integer.

``reconstruct``'s all-fixed route (``csrc/reconstruct.cu``) runs flacx's
parallel integration one block a frame: the block walks the row in tiles
of ``32 FX_RUN`` samples a warp, each thread a run of ``FX_RUN``
consecutive samples.  A level's masked inclusive scan is a serial sum
over each run, a shuffle scan of the run totals across the warp, the
totals of the channel's earlier warps, and the level's carry from the
tiles before; the warm-up prefix takes its differences in binomial form.
The model below does the same and must give
``flacx.ops.reconstruct.reconstruct_fixed_parallel``'s integers in int32
(wrapping) and int64.

``bit_unpack`` (``csrc/bit_unpack.cu``) stages, a block of ``LANES``
lanes at a time, the words from its first lane's checkpoint to five
words past the next block's first checkpoint, up to a capacity from the
rows' mean bytes a lane; a lane keeps three words at its cursor, reads
the next one ahead of each symbol (and one more after a symbol of 33
bits or more) and moves on by the words the symbol used, each word from
the staged span, or from the row where the span does not hold it (zero
past the row).  The model must give
``flacx.ops.bitunpack.parse_residual_chunks``'s values and error flag on
a real stream, a 70-bit unary code and corrupt checkpoints, and a real
stream's walk must read only staged words.
"""

import math

import numpy as np
import pytest
import torch

import flacx.ops  # noqa: F401  (x64)
import jax.numpy as jnp
from flacx.ops import bitunpack as fx_bitunpack
from flacx.ops.reconstruct import reconstruct_fixed_parallel as fx_fixed

from flacx_torch import native
from flacx_torch.ops import MASK32
from flacx_torch.ops.bitunpack import _clz64, _srl, bytes_to_words

from test_torch_decode import encoded, long_unary_stream, rows_of

torch.set_num_threads(1)

#: csrc/reconstruct.cu: samples a thread's run, warps a block at most
FX_RUN, FX_WARPS = 4, 16
#: csrc/bit_unpack.cu: lanes a block, symbols a lane, staged words at most
LANES, S, SPAN_MAX = 64, 64, 8192


# ---------------------------------------------------------------------------
# reconstruct: the all-fixed route's tiled, run-split scan

def split_scan(res: torch.Tensor, order: torch.Tensor, fixed_max: int,
               dtype) -> torch.Tensor:
    """``[F, C, n]`` → the integrated rows, as the kernel computes them
    (every sum an explicit wrapping add in ``dtype``)."""
    f, c, n = res.shape
    wpc = max(1, FX_WARPS // c)
    ts = wpc * 32 * FX_RUN
    tiles = -(-n // ts)
    x = torch.nn.functional.pad(res.to(dtype), (0, tiles * ts - n))
    # the warm-up prefix: position i < order holds the min(i, L-1)-th
    # difference of the warm-up values there, sum_q (-1)^q C(m, q) r[i-q]
    warm = x.clone()
    for i in range(1, min(int(order.max()), n)):
        m = min(i, fixed_max - 1)
        d = warm[..., i].clone()
        for q in range(1, m + 1):
            term = warm[..., i - q] * math.comb(m, q)
            d = d - term if q % 2 else d + term
        x[..., i] = torch.where(order > i, d, x[..., i])
    pos = torch.arange(tiles * ts).reshape(tiles, wpc, 32, FX_RUN)
    x = x.reshape(f, c, tiles, wpc, 32, FX_RUN)
    ordc = order[:, :, None, None, None, None]
    zero = torch.zeros((), dtype=dtype)
    for j in range(fixed_max - 1, -1, -1):
        masked = torch.where(pos >= j, x, zero)
        s = torch.empty_like(masked)
        run = torch.zeros_like(masked[..., 0])
        for k in range(FX_RUN):                 # a thread's serial run
            run = run + masked[..., k]
            s[..., k] = run
        inc = run.clone()                        # the warp's shuffle scan
        o = 1
        while o < 32:
            shifted = torch.zeros_like(inc)
            shifted[..., o:] = inc[..., :-o]
            inc = inc + shifted
            o *= 2
        wtot = inc[..., 31]                      # [F, C, tiles, wpc]
        before = torch.zeros_like(wtot)          # earlier warps + carry
        carry = torch.zeros_like(wtot[..., 0, 0])
        for t in range(tiles):
            acc = carry.clone()
            for w in range(wpc):
                before[:, :, t, w] = acc
                acc = acc + wtot[:, :, t, w]
            carry = acc
        out = (before[..., None] + (inc - run))[..., None] + s
        x = torch.where((pos >= j) & (ordc > j), out, x)
    return x.reshape(f, c, tiles * ts)[..., :n]


def fixed_batch(seed: int, f: int, c: int, n: int, top: int, bits: int):
    """Merged rows of an all-fixed batch: orders 0..top mixed (each at
    least once), warm-up values of 31 bits, residuals of ``bits``."""
    rng = np.random.default_rng(seed)
    order = rng.integers(0, top + 1, (f, c))
    order.flat[:top + 1] = np.arange(top + 1)
    res = rng.integers(-2 ** bits, 2 ** bits, (f, c, n))
    warm = rng.integers(-2 ** 31, 2 ** 31, (f, c, n))
    res = np.where(np.arange(n) < order[..., None], warm, res)
    return res, order.astype(np.int32)


@pytest.mark.parametrize("c,n", [(2, 4608), (2, 4097), (6, 1000),
                                 (1, 2050)])
@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_fixed_split_scan_matches_flacx(c, n, dtype):
    """Tiles of 256 to 2048 samples a channel and n that is not a
    multiple of the tile (nor, at 4097, of the run), orders 0-4 and 0-2
    mixed in one batch, residuals of 30 bits whose integrations wrap
    int32 and pass 2^64."""
    for top in (4, 2):
        res, order = fixed_batch(n + c + top, 3, c, n, top, 30)
        got = split_scan(torch.from_numpy(res), torch.from_numpy(order),
                         top, getattr(torch, dtype))
        ref = fx_fixed(jnp.asarray(res), jnp.asarray(order), top,
                       dtype=getattr(jnp, dtype))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# bit_unpack: the staged span and the register window

def decode(win, start, wd, escape_val, param, esc, inesc):
    """One symbol from 64-bit windows ``win`` (int64 bit patterns), as the
    kernel's ``decode``: (value, bits used, param, esc, inesc)."""
    wf = torch.where(start, wd, 0)
    p_field = torch.where(start, _srl(win, 64 - wf.clamp(min=1)), 0)
    is_esc = start & (p_field == escape_val)
    param = torch.where(start & ~is_esc, p_field, param)
    esc = torch.where(is_esc, _srl(win, 59 - wf) & 31, esc)
    inesc = torch.where(start, is_esc, inesc)
    consumed = wf + torch.where(is_esc, 5, 0)
    vwin = win << consumed
    q = _clz64(vwin)
    code_bits = q + 1 + param
    rem = _srl(vwin, (64 - code_bits).clamp(0, 63)) & ((1 << param) - 1)
    u = (q << param) | rem
    rice = (u >> 1) ^ -(u & 1)
    escv = torch.where(esc > 0, vwin >> (64 - esc).clamp(1, 63), 0)
    val = torch.where(inesc, escv, rice)
    used = consumed + torch.where(inesc, esc, code_bits)
    return val, used, param, esc, inesc


def staged_walk(rows: torch.Tensor, ckpt_pos, ckpt_param, ckpt_esc,
                ckpt_inesc, kind, order, po, width, n: int):
    """``(vals, err, reads)``: the kernel's walk, ``reads`` counting the
    word reads from the staged spans and from the rows."""
    f, w = rows.shape
    c, k = ckpt_pos.shape[1:]
    nw, lanes = w // 4, f * c * k
    words = bytes_to_words(rows)[:, :nw].reshape(-1)     # flat, big-endian
    cp = ckpt_pos.reshape(-1).long()
    # each block's span of flat words, staged as a copy
    mean = LANES * w // (c * k)
    cap = min(SPAN_MAX, (mean + mean // 8) // 4 + 8) & ~3
    blocks = -(-lanes // LANES)
    span = torch.zeros((blocks, cap), dtype=torch.int64)
    s0 = torch.zeros(blocks, dtype=torch.int64)
    slen = torch.zeros(blocks, dtype=torch.int64)
    for b in range(blocks):
        l0, lend = b * LANES, min(b * LANES + LANES, lanes)
        lo = (l0 // (c * k)) * nw + int(cp[l0] >> 5)
        hi = ((lend // (c * k)) * nw + int(cp[lend] >> 5) + 5
              if lend < lanes else f * nw)
        lo = max(0, lo) & ~3
        size = max(0, min(min(hi, f * nw) - lo, cap))
        s0[b], slen[b] = lo, size
        span[b, :size] = words[lo:lo + size]
    reads = {"span": 0, "rows": 0}

    def lanewise(a):
        return a.long()[..., None].expand(f, c, k).reshape(lanes)

    idx = torch.arange(lanes)
    block = idx // LANES
    kk, sub = idx % k, idx // k
    fbase = (sub // c) * nw
    rb = fbase - s0[block]

    def word(i):
        """Row word i of every lane: the span's copy where it lies in the
        lane's block's span, else the row's; zero past the row."""
        o = rb + i
        inside = (o >= 0) & (o < slen[block])
        row = i < nw
        reads["span"] += int((inside & row).sum())
        reads["rows"] += int((~inside & row).sum())
        got = torch.where(inside, span[block, o.clamp(0, cap - 1)],
                          words[(fbase + i).clamp(0, f * nw - 1)])
        return torch.where(row, got, 0)

    kind_l, order_l, wd = lanewise(kind), lanewise(order), lanewise(width)
    psize = n >> lanewise(po)
    pred = kind_l >= 2
    escape_val = (1 << wd) - 1
    pos = cp.clone()
    param = ckpt_param.reshape(-1).long()
    esc = ckpt_esc.reshape(-1).long()
    inesc = ckpt_inesc.reshape(-1).bool()
    err = torch.zeros(lanes, dtype=torch.bool)
    vals = torch.zeros((lanes, S), dtype=torch.int64)
    cw = pos >> 5
    w0, w1, w2 = word(cw), word(cw + 1), word(cw + 2)
    for i in range(S):
        j = kk * S + i
        start = pred & (j < n) & ((j == order_l) | ((j > 0)
                                                    & (j % psize == 0)))
        act = (j < n) & ((pred & (j >= order_l)) | (kind_l == 1))
        n1 = word(cw + 3)                         # read ahead
        sh = pos & 31
        hi = ((w0 << sh) | (w1 >> (32 - sh))) & MASK32
        lo = ((w1 << sh) | (w2 >> (32 - sh))) & MASK32
        val, used, p2, e2, in2 = decode((hi << 32) | lo, start, wd,
                                        escape_val, param, esc, inesc)
        param = torch.where(act, p2, param)
        esc = torch.where(act, e2, esc)
        inesc = torch.where(act, in2, inesc)
        err |= act & (used > 64)
        pos = pos + torch.where(act, used, 0)
        vals[:, i] = torch.where(act, val, 0)
        d = (pos >> 5) - cw
        far = d > 2                                 # reloads (an error)
        two = d == 2                                # a 33-bit symbol or more
        n2 = word(torch.where(two, cw + 4, nw)) if bool(two.any()) else 0
        w0, w1, w2 = (torch.where(d == 0, w0, torch.where(d == 1, w1, w2)),
                      torch.where(d == 0, w1, torch.where(d == 1, w2, n1)),
                      torch.where(d == 0, w2, torch.where(d == 1, n1, n2)))
        cw = cw + d
        if bool(far.any()):
            w0 = torch.where(far, word(cw), w0)
            w1 = torch.where(far, word(cw + 1), w1)
            w2 = torch.where(far, word(cw + 2), w2)
    chain = pos.reshape(f, c, k)[..., :-1] == ckpt_pos[..., 1:].long()
    return (vals.reshape(f, c, k * S)[..., :n], bool(err.any())
            or not bool(chain.all()), reads)


def flacx_unpack(rows: np.ndarray, args: list, n: int, interval: int):
    """flacx's ``parse_residual_chunks`` with a span bucket no chunk of
    these streams passes (a lane's 64 symbols, past the rows' end too)."""
    vals, err = fx_bitunpack.parse_residual_chunks(
        fx_bitunpack.bytes_to_words(jnp.asarray(rows)),
        *map(jnp.asarray, args), n, interval, span_words=256)
    return np.asarray(vals), bool(err)


@pytest.mark.parametrize("name", ["stereo", "long-unary"])
def test_staged_span_walk_matches_flacx(name):
    """A real stream (blocks of 64 lanes crossing subframes and frames,
    escaped partitions) reads every word from its block's span; a 70-bit
    unary code sets the flag, both as flacx."""
    data = (encoded(1, 6 * 1152 + 500, 2, 16, 1152, 8, bursts=True)[0]
            if name == "stereo" else long_unary_stream()[0])
    si, rows, _ = rows_of(data)
    n = si.max_block_size
    scan = native.scan_frames(rows, np.zeros(len(rows), np.int64), n,
                              si.channels, si.sample_size)
    args = [scan.ckpt_pos, scan.ckpt_param, scan.ckpt_esc, scan.ckpt_inesc,
            scan.kind, scan.order, scan.po, scan.width]
    vals, err, reads = staged_walk(torch.from_numpy(rows),
                                   *map(torch.from_numpy, args), n)
    ref, ref_err = flacx_unpack(rows, args, n, scan.ckpt_interval)
    np.testing.assert_array_equal(vals.numpy(), ref)
    assert err == ref_err == (name == "long-unary")
    assert reads["span"] > 0 and reads["rows"] == 0, reads
    if name == "stereo":
        assert scan.ckpt_pos.size > 2 * LANES      # blocks cross frames


@pytest.mark.parametrize("where", ["past-row", "backwards"])
def test_staged_span_corrupt_cursor_matches_flacx(where):
    """A checkpoint past its row's end (words read as zero) and one that
    jumps back into the frame header, before its block's span (words read
    from the row): values and flag as flacx's."""
    data = encoded(1, 6 * 1152 + 500, 2, 16, 1152, 8, bursts=True)[0]
    si, rows, _ = rows_of(data)
    n, c = si.max_block_size, si.channels
    scan = native.scan_frames(rows, np.zeros(len(rows), np.int64), n, c,
                              si.sample_size)
    pos = scan.ckpt_pos.copy()
    k = pos.shape[-1]
    if where == "past-row":
        pos[-1, -1, -1] = rows.shape[1] * 8 - 3
    else:   # back before the span of a block that starts mid-frame
        flat = pos.reshape(-1)
        lane = next(i for i in range(1, pos.size) if i % LANES
                    and (i - i % LANES) // (c * k) == i // (c * k)
                    and flat[i - i % LANES] >= 256)
        flat[lane] = 40
    args = [pos, scan.ckpt_param, scan.ckpt_esc, scan.ckpt_inesc, scan.kind,
            scan.order, scan.po, scan.width]
    vals, err, reads = staged_walk(torch.from_numpy(rows),
                                   *map(torch.from_numpy, args), n)
    ref, ref_err = flacx_unpack(rows, args, n, scan.ckpt_interval)
    np.testing.assert_array_equal(vals.numpy(), ref)
    assert err and ref_err
    if where == "backwards":
        assert reads["rows"] > 0, reads
