"""The work split of conformance mode's two kernels, modelled in numpy and
held against the JAX package.

``reference_lpc`` packs the autocorrelation chains densely on lanes where
the rows fill the card: lane 0 of a row walks lag 0, lane k >= 1 lags
2k - 1 and 2k, in groups of 8 steps over a ring of windowed samples in
which w[n-1] and everything past it is 0, so every chain walks the same
whole tiles; lag 2k - 1's first term of a group comes from the previous
group's last value.  Where the rows are few it walks one lag a lane, a
block a row, lane i of warp w lag 32 w + i.  Levinson
then runs on a row's lanes: one lane forms the rounded products a[j] *
autoc[k+1-j] and subtracts them in order, and lane i updates the pair
(a[i], a[k+1-i]) from the old values.  ``abs_residual_sums`` runs
the LPC MACs as 8-bit limb products (2, 3 or 4 sample limbs; the taps'
signed lo and hi bytes) in int32 accumulators, combined in uint32 under
the int32 MAC bound and in int64 past it, and the fixed orders as
successive differences of runs of 8 samples.  The models below do the
same on the CPU and check that every accumulator and sum stays in the
range the kernels give it, against ``flacx.conformance`` and
``flacx.ops.lpc``.
"""

import numpy as np
import pytest

import flacx.ops  # noqa: F401  (x64)
import jax.numpy as jnp
from flacx import conformance as fx_conf
from flacx.format import FIXED_PREDICTOR_TAPS
from flacx.ops.lpc import lpc_residuals_all, predict_residual, tukey_window_np

from flacx_torch.kernels.analysis import diff_width
from flacx_torch.kernels.lpc_residual import mac_width
from flacx_torch.kernels.reference_analysis import (SEG_MAX, sample_limbs,
                                                    segment_size)

from test_torch_conformance import P, rows_of

INT32 = (-(1 << 31), (1 << 31) - 1)
U = 8


def bits(a) -> np.ndarray:
    return np.asarray(a, np.float64).view(np.int64)


# ---- reference_lpc: packed chains ----------------------------------------

def lane_layout(p: int, one: bool = False) -> tuple[int, int]:
    """``(lanes a row, rows a warp)``: packed, lane 0 takes lag 0, lane
    k >= 1 lags 2k - 1 and 2k, at most 8 rows a warp (a lane windows its
    chunk's quads of up to 4 rows); one lag a lane, a row a warp (or a
    block of two)."""
    lpr = 1 + (p + 1) // 2
    return lpr, 1 if one else min(8, 32 // lpr)


def tile_of(p: int, one: bool = False) -> int:
    """The kernel's tile: about 1024 samples a chain warp, 128 to 512 (a
    quad a lane of the windowing warp at least)."""
    t = 512
    while t > 128 and lane_layout(p, one)[1] * t > 1024:
        t >>= 1
    return t


def ring_stride(p: int, one: bool = False) -> int:
    """Doubles of a row's ring: three tiles and the mirror of slot 0's
    head, at least the row's Levinson arrays, even, banks aligned."""
    lpr, _ = lane_layout(p, one)
    mirror = (2 * U + (p + 1 if one else 2 * lpr) + 3) & ~3
    nl = p + 1
    levinson = 2 * nl + p * p + (p * p + 2 * p + 1) // 2
    s = max(3 * tile_of(p, one) + mirror, levinson + (levinson & 1))
    while s % 16 != 2 * lpr % 16:
        s += 2
    return s


def model_chains(w: np.ndarray, p: int) -> np.ndarray:
    """``autoc [rows, p+1]`` as the packed lanes add it: every lane of a
    row walks whole tiles in groups of ``U`` steps, lag 2k from its window
    c[v] = w[j0 + 2k + v] and lag 2k - 1 from the same window shifted by
    one, its first value the previous group's last; the ring holds w with
    w[n-1] and past it 0."""
    r, n = w.shape
    lpr, _ = lane_layout(p)
    t = tile_of(p)
    steps = -(-(n - 1) // t) * t
    ring = np.zeros((r, steps + t + 2 * lpr + U))
    ring[:, :n - 1] = w[:, :n - 1]
    k = np.arange(lpr)
    acc0 = np.zeros((r, lpr))           # lag 2k - 1 (none for lane 0)
    acc1 = np.zeros((r, lpr))           # lag 2k
    carry = np.where(k > 0, ring[:, np.maximum(2 * k - 1, 0)], 0.0)
    for j0 in range(0, steps, U):
        a = ring[:, j0:j0 + U]
        c = ring[:, j0 + 2 * k[:, None] + np.arange(U)]     # [r, lpr, U]
        for u in range(U):
            b = carry if u == 0 else c[:, :, u - 1]
            acc0 = acc0 + a[:, u, None] * b
            acc1 = acc1 + a[:, u, None] * c[:, :, u]
        carry = c[:, :, U - 1]
    out = np.zeros((r, p + 1))
    out[:, 2 * k[2 * k <= p]] = acc1[:, 2 * k <= p]
    out[:, 2 * k[1:] - 1] = acc0[:, 1:]
    return out


def model_one_lag_chains(w: np.ndarray, p: int) -> np.ndarray:
    """``autoc [rows, p+1]`` as one lag a lane adds it: lane i of warp v
    walks lag 32 v + i over the same ring, whole tiles in groups of ``U``
    steps, its window c[v] = w[j0 + lag + v] (8-byte loads, any
    alignment)."""
    r, n = w.shape
    t = tile_of(p, one=True)
    steps = -(-(n - 1) // t) * t
    ring = np.zeros((r, steps + t + p + 1 + U))
    ring[:, :n - 1] = w[:, :n - 1]
    wpr = (p + 32) // 32
    lag = np.minimum(np.arange(32 * wpr), p)      # lanes past p mirror p
    acc = np.zeros((r, 32 * wpr))
    for j0 in range(0, steps, U):
        a = ring[:, j0:j0 + U]
        c = ring[:, j0 + lag[:, None] + np.arange(U)]       # [r, lanes, U]
        for u in range(U):
            acc = acc + a[:, u, None] * c[:, :, u]
    return acc[:, :p + 1]


# ---- reference_lpc: Levinson on a row's lanes ----------------------------

def model_levinson(autoc: np.ndarray, p: int) -> tuple[np.ndarray,
                                                       np.ndarray]:
    """``(taps [rows, p, p], valid [rows, p])``: the products of each order
    subtracted in order, the symmetric pairs updated at once from their
    old values."""
    r = autoc.shape[0]
    a = np.zeros((r, p + 1))
    a[:, 0] = 1.0
    err = autoc[:, 0].copy()
    ok = np.ones(r, bool)
    taps = np.zeros((r, p, p))
    valid = np.zeros((r, p), bool)
    with np.errstate(all="ignore"):
        for kk in range(p):
            ok = ok & (err != 0.0)
            safe = np.where(err != 0.0, err, 1.0)
            lam = np.zeros(r)
            for j in range(kk + 1):                          # one lane
                lam = lam - a[:, j] * autoc[:, kk + 1 - j]
            lam = lam / safe
            err = err * (1.0 - lam * lam)
            i = np.arange((kk + 1) // 2 + 1)                 # lane i
            ai, am = a[:, i], a[:, kk + 1 - i]
            a[:, i] = ai + lam[:, None] * am
            a[:, kk + 1 - i] = am + lam[:, None] * ai
            taps[:, kk, :kk + 1] = a[:, 1:kk + 2]
            valid[:, kk] = ok
        valid &= np.isfinite(taps).all(-1)
    return taps, valid


@pytest.fixture(scope="module")
def chain():
    """``tests/test_torch_conformance.py``'s chain rows, windowed, and
    flacx's reference chain on them."""
    x = rows_of(1, 8, 256)
    w = x.astype(np.float64) * tukey_window_np(256)
    autoc = np.asarray(fx_conf.ordered_autocorr(jnp.asarray(w), P))
    taps, valid = fx_conf.levinson_reference(jnp.asarray(autoc), P)
    return w, autoc, np.asarray(taps), np.asarray(valid)


@pytest.mark.parametrize("model", [model_chains, model_one_lag_chains])
def test_packed_chains_equal_ordered_autocorr(chain, model):
    w, autoc, _, _ = chain
    np.testing.assert_array_equal(bits(model(w, P)), bits(autoc))


@pytest.mark.parametrize("model", [model_chains, model_one_lag_chains])
@pytest.mark.parametrize("n,p", [(33, 32), (100, 1), (300, 2), (300, 15),
                                 (700, 31), (1025, 8)])
def test_packed_chains_other_orders(n, p, model):
    """Rows that take 2 to 17 lanes packed (1 to 33 one lag a lane, two
    warps at P = 32), tiles of 64 to 512, rows shorter than a tile and
    ending mid-group."""
    x = rows_of(n + p, 5, n)
    w = x.astype(np.float64) * tukey_window_np(n)
    want = np.asarray(fx_conf.ordered_autocorr(jnp.asarray(w), p))
    np.testing.assert_array_equal(bits(model(w, p)), bits(want))


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8, 12, 15, 24, 31, 32])
def test_lane_layout_covers_every_lag(p):
    """Every lag 0..P in exactly one chain; a warp's rows fit 32 lanes;
    the Levinson pairs of the last order fit a row's lanes; the loads'
    lookahead past a group (the mirror of slot 0's head) fits a tile; a
    lane of the windowing warp has whole quads of a tile; and four chain
    warps' rings (each at least its Levinson arrays) fit a block's
    227 KB."""
    lpr, rpw = lane_layout(p)
    lags = [0] + [lag for k in range(1, lpr) for lag in (2 * k - 1, 2 * k)
                  if lag <= p]
    assert sorted(lags) == list(range(p + 1))
    assert rpw * lpr <= 32 and rpw >= 1
    assert p // 2 + 1 <= lpr
    t = tile_of(p)
    mirror = (2 * U + 2 * lpr + 3) & ~3
    assert 2 * U + 2 * lpr - 2 <= mirror <= t and t % 128 == 0
    assert 4 * rpw * ring_stride(p) * 8 <= 232448


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8, 12, 15, 24, 31, 32])
def test_one_lag_layout_covers_every_lag(p):
    """One lag a lane: the lanes of a row's warps cover lags 0..P, one
    warp up to P = 31 and two at P = 32; warp 0's lanes hold the Levinson
    pairs; the lookahead fits the mirror and the mirror a tile; the row's
    one ring (at least its Levinson arrays) fits a block's 227 KB."""
    wpr = (p + 32) // 32
    assert wpr == (1 if p < 32 else 2)
    lags = [lag for lag in range(32 * wpr) if lag <= p]
    assert lags == list(range(p + 1))
    lpr, rpw = lane_layout(p, one=True)
    assert rpw == 1 and p // 2 + 1 <= lpr <= 32
    t = tile_of(p, one=True)
    mirror = (2 * U + p + 1 + 3) & ~3
    assert 2 * U + p - 1 <= mirror <= t == 512
    assert ring_stride(p, one=True) * 8 <= 232448


def test_lane_levinson_equals_flacx(chain):
    _, autoc, taps, valid = chain
    got_t, got_v = model_levinson(autoc, P)
    np.testing.assert_array_equal(got_v, valid)
    np.testing.assert_array_equal(bits(got_t)[valid], bits(taps)[valid])


@pytest.mark.parametrize("seq", [
    [1.0, 1.0, 1.0, 1.0, 1.0, 1.0],      # |lambda| = 1: error 0 after order 1
    [4.0, -2.0, 1.0, 0.5, 0.0, 0.0],
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],      # silent
    [2.0, 1.0, 2.0, 1.0, 0.5, 0.25]])    # error 0 after order 2
def test_lane_levinson_zero_error(seq):
    """Autocorrelations whose error reaches 0 at the start or partway:
    the validity flags and every valid row's taps as flacx's."""
    autoc = np.asarray([seq, seq[:1] + [0.0] * 5], np.float64)
    p = len(seq) - 1
    taps, valid = (np.asarray(a) for a in
                   fx_conf.levinson_reference(jnp.asarray(autoc), p))
    got_t, got_v = model_levinson(autoc, p)
    np.testing.assert_array_equal(got_v, valid)
    np.testing.assert_array_equal(bits(got_t)[valid], bits(taps)[valid])


# ---- abs_residual_sums: limb products -------------------------------------

def split_samples(x: np.ndarray, limbs: int) -> list:
    """The bytes of int32 ``x``: low limbs in [0, 255], the top one signed."""
    v = x.astype(np.int64)
    return ([(v >> (8 * a)) & 0xFF for a in range(limbs - 1)]
            + [v >> (8 * (limbs - 1))])


def split_taps(q: np.ndarray) -> tuple:
    """``(lo, hi)``: the signed low byte and the rest, both in s8 range."""
    v = q.astype(np.int64)
    lo = ((v & 0xFF) ^ 0x80) - 0x80
    return lo, (v - lo) >> 8


def model_lpc_sums(x, q, s, eff_bps, sum_taps_max):
    """Σ|res| of every LPC order from the limb products, as the kernel
    combines them, checking each accumulator's range and each residual's
    width on the route it takes."""
    limbs = sample_limbs(eff_bps)
    wide = mac_width(eff_bps, sum_taps_max) == "wide" or limbs == 4
    if wide:
        limbs = max(limbs, 3)      # the int64 combine runs 3 or 4 limbs
    r, n = x.shape
    p = q.shape[-2]
    xl = split_samples(x, limbs)
    assert xl[-1].min() >= -128 and xl[-1].max() <= 127, "x past eff_bps"
    lo, hi = split_taps(q)
    assert np.abs(np.concatenate([lo, hi])).max() <= 128

    def window(v):   # [r, n] -> [p, r, n]: v[i - 1 - j] (0 before the row)
        out = np.zeros((p, r, n), np.int64)
        for j in range(p):
            out[j, :, j + 1:] = v[:, :n - j - 1]
        return out

    acc = np.zeros((limbs + 1, r, p, n), np.int64)     # by shift of 8 bits
    for a, xa in enumerate(xl):
        w = window(xa)
        for b, qb in enumerate((lo, hi)):
            if not wide and a + b >= 4:
                continue           # shift 32 vanishes mod 2^32
            acc[a + b] += np.einsum("roj,jrn->ron", qb, w)
    assert acc.min() >= INT32[0] and acc.max() <= INT32[1], "past int32"
    pred = np.tensordot(np.array([1 << (8 * k) for k in range(limbs + 1)],
                                 np.int64), acc, axes=1)
    if not wide:   # uint32 wrap, then an int32 arithmetic shift
        pred = ((pred & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    res = x.astype(np.int64)[:, None] - (pred >> s[..., None])
    res = res * (np.arange(n) > np.arange(p)[:, None])
    mag = np.abs(res)
    if not wide:   # a step's four values of a column in 32 bits
        assert mag.max() < 1 << 30 and 4 * mag.max() < 1 << 32
    return mag.sum(-1)


def extremes(seed, r, n, bits):
    """Rows at -2^(b-1) and 2^(b-1) - 1 (alternating, in runs of three,
    constant) and white noise over the full range."""
    rng = np.random.default_rng(seed)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    t = np.arange(n)
    x = rng.integers(lo, hi + 1, (r, n))
    x[0] = np.where(t % 2, hi, lo)
    x[1] = np.where(t // 3 % 2, hi, lo)
    x[2] = lo
    x[3] = hi
    return x.astype(np.int32)


def clip_taps(seed, r, p, prec, hi_rows=True):
    """Taps at the clip bounds of ``prec`` (rows of -2^(prec-1), of
    2^(prec-1) - 1, alternating, random); without ``hi_rows`` every row's
    taps fit one signed byte."""
    rng = np.random.default_rng(seed)
    h = 1 << (prec - 1)
    q = rng.integers(-h, h, (r, p, p))
    q[0] = -h
    q[1] = h - 1
    q[2] = np.where(np.arange(p) % 2, h - 1, -h)
    if not hi_rows:
        q = np.clip(q, -128, 127)
    return (q * (np.arange(p) < np.arange(1, p + 1)[:, None])).astype(
        np.int32)


@pytest.mark.parametrize("eff_bps,p,prec,hi_rows", [
    (8, 12, 5, True),      # two limbs, lo taps
    (16, 12, 5, True),     # the headline: two limbs, lo taps
    (16, 12, 9, True),     # two limbs, hi taps, int32
    (16, 16, 15, True),    # wide: three limbs at 16 bits, hi taps
    (16, 16, 15, False),   # wide, taps cut to one byte
    (17, 12, 9, True),     # three limbs, hi taps, int32 near its bound
    (24, 12, 15, True),    # hi-res samples: three limbs, hi taps, wide
    (24, 4, 4, True),      # three limbs at the int32 bound
    (25, 12, 15, True),    # four limbs, wide
    (32, 12, 15, True),    # four limbs at 32 bits, wide
    (25, 3, 2, False),     # four limbs under the int32 bound: int64
])
def test_limb_sums_equal_flacx_at_extremes(eff_bps, p, prec, hi_rows):
    """Samples at the extremes of ``eff_bps`` bits, taps at the clip bounds
    of the precision, shift 0: the model's Σ|res| equals flacx's
    Σ|``lpc_residuals_all``| (int64), masked at i <= o."""
    r, n = 5, 97
    x = extremes(eff_bps + p, r, n, eff_bps)
    q = clip_taps(prec + p, r, p, prec, hi_rows)
    s = np.zeros((r, p), np.int32)
    stm = p << (prec - 1)
    res = np.asarray(lpc_residuals_all(jnp.asarray(x), jnp.asarray(q),
                                       jnp.asarray(s), jnp.int64))
    want = np.abs(res * (np.arange(n) >= np.arange(1, p + 1)[:, None])) \
        .sum(-1)
    np.testing.assert_array_equal(model_lpc_sums(x, q, s, eff_bps, stm),
                                  want)


def test_limb_sums_with_shifts():
    """Shifts 0..15 on the int32 route: the model equals flacx's."""
    r, n, p, prec = 5, 97, 12, 9
    x = extremes(1, r, n, 16)
    q = clip_taps(2, r, p, prec)
    s = np.random.default_rng(3).integers(0, 16, (r, p)).astype(np.int32)
    res = np.asarray(lpc_residuals_all(jnp.asarray(x), jnp.asarray(q),
                                       jnp.asarray(s), jnp.int64))
    want = np.abs(res * (np.arange(n) >= np.arange(1, p + 1)[:, None])) \
        .sum(-1)
    np.testing.assert_array_equal(
        model_lpc_sums(x, q, s, 16, p << (prec - 1)), want)


def test_accumulators_at_their_worst():
    """Every limb at its extreme and every tap -128 in both limbs over 32
    orders: the two limb products that share an accumulator stay inside
    int32."""
    assert 2 * 32 * 255 * 128 < 1 << 31
    p = 32
    x = np.full((1, 64), -1, np.int32)      # low bytes 255, top byte -1
    q = np.full((1, p, p), -128 - 128 * 256, np.int32)
    q = q * np.tril(np.ones((p, p), np.int32))
    model_lpc_sums(x, q, np.zeros((1, p), np.int32), 25, p << 15)


# ---- abs_residual_sums: fixed orders as differences -----------------------

def model_fixed_sums(x: np.ndarray, eff_bps: int, seg: int) -> np.ndarray:
    """Σ|D^o x| (o = 0..4, zero at i < o) as the kernel forms it: segments
    of ``seg`` samples, runs of 8 with the 4 samples before them (0 before
    the row), successive differences in int32 up to eff_bps 26 (checked
    to fit) and int64 past it, a run's sums in 32 bits on the int32
    route (checked to fit)."""
    r, n = x.shape
    d64 = diff_width(eff_bps) == "int64"
    xp = np.concatenate([np.zeros((r, 4), np.int64), x.astype(np.int64),
                         np.zeros((r, 8), np.int64)], 1)
    out = np.zeros((r, 5), np.int64)
    for s0 in range(0, n, seg):
        for c in range(0, min(seg, n - s0), 8):
            v = xp[:, s0 + c:s0 + c + 12]            # positions c-4 .. c+7
            d = [v]
            for _ in range(4):
                d.append(d[-1][:, 1:] - d[-1][:, :-1])
            i = s0 + c + np.arange(8)
            for o in range(5):
                run = d[o][:, -8:]                   # positions c .. c+7
                if not d64:
                    assert np.abs(run).max() < 1 << 30
                keep = (i >= o) & (i < n)
                mag = np.abs(run * keep).sum(-1)
                if not d64:
                    assert mag.max() < 1 << 32
                out[:, o] += mag
    return out


@pytest.mark.parametrize("eff_bps,n", [(16, 4608), (20, 15), (21, 4608),
                                       (24, 15), (26, 4608), (27, 15),
                                       (32, 4608)])
def test_fixed_differences_equal_flacx(eff_bps, n):
    """Rows at the extremes: the differences equal flacx's fixed
    predictor residuals (``predict_residual`` with the binomial taps,
    int64), summed; int32 differences and 32-bit run sums suffice up to
    eff_bps 26."""
    x = extremes(eff_bps, 4, n, eff_bps)
    i = np.arange(n)
    want = np.stack([np.abs(np.asarray(predict_residual(
        jnp.asarray(x), jnp.broadcast_to(jnp.asarray(FIXED_PREDICTOR_TAPS[o]),
                                         (len(x), 4)),
        jnp.zeros(len(x), jnp.int32), jnp.int64)) * (i >= o)).sum(-1)
        for o in range(5)], -1)
    np.testing.assert_array_equal(
        model_fixed_sums(x, eff_bps, segment_size(n)), want)


@pytest.mark.parametrize("n", [1, 32, 33, 2048, 2049, 4608, 16384])
def test_segments_cover_the_row(n):
    """Equal segments of at most SEG_MAX, whole 32-sample steps, the last
    one holding samples."""
    seg = segment_size(n)
    nseg = -(-n // seg)
    assert seg % 32 == 0 and seg <= SEG_MAX
    assert (nseg - 1) * seg < n <= nseg * seg
    # 256 threads of runs of 8: at most two runs a thread
    assert -(-seg // (8 * 256)) <= 2
