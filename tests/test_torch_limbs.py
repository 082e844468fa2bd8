"""The limb arithmetic of the ``lpc_allorder`` kernel, modelled in numpy.

The kernel runs every order's MAC on the tensor cores over 8-bit limbs:
each sample splits into its bytes (the low ones u8, the top one s8; three
limbs up to eff_bps 24, four past it), each tap into ``lo = (int8)(q &
0xff)`` and ``hi = (q - lo) >> 8`` (both s8), the limb products are summed
in int32 accumulators (one per shift of 8 bits) and recombined in uint32
under the int32 MAC bound or in int64 past it.  The model below does the
same on the CPU, checks that every accumulator stays inside int32, and is
held equal to ``lpc_allorder``'s plain version and, at the extremes, to
flacx's ``lpc_residuals_all``-based statistics.
"""

import numpy as np
import pytest
import torch

import flacx.ops  # noqa: F401  (x64)
import jax
import jax.numpy as jnp
from flacx.ops import lpc as fx_lpc
from flacx.ops.rice import zigzag as fx_zigzag

from flacx_torch.kernels.lpc_allorder import lpc_allorder_plain, sample_limbs
from flacx_torch.kernels.lpc_residual import mac_width

torch.set_num_threads(1)

INT32 = (-(1 << 31), (1 << 31) - 1)


def split_samples(x: np.ndarray, limbs: int) -> list:
    """The bytes of int32 ``x``: low limbs in [0, 255], the top one signed."""
    v = x.astype(np.int64)
    parts = [(v >> (8 * a)) & 0xFF for a in range(limbs - 1)]
    return parts + [v >> (8 * (limbs - 1))]


def split_taps(q: np.ndarray) -> tuple:
    """``(lo, hi)``: the signed low byte and the rest, both in s8 range."""
    v = q.astype(np.int64)
    lo = ((v & 0xFF) ^ 0x80) - 0x80
    return lo, (v - lo) >> 8


def model_allorder(x, qcoefs, shifts, eff_bps, sum_taps_max):
    """``(lzz, maxabs)`` of every order from the limb products, as the
    kernel combines them."""
    wide = mac_width(eff_bps, sum_taps_max) == "wide"
    r, n = x.shape
    p = qcoefs.shape[-2]
    limbs = sample_limbs(eff_bps)
    xl = split_samples(x, limbs)
    top = xl[-1]
    assert top.min() >= -128 and top.max() <= 127, "x past eff_bps"
    # taps past each order and past the row's tap count are zero
    q = qcoefs[..., :p].astype(np.int64) * (np.arange(p)
                                            < np.arange(1, p + 1)[:, None])
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
    weights = np.array([1 << (8 * s) for s in range(limbs + 1)], np.int64)
    pred = np.tensordot(weights, acc, axes=1)           # [r, p, n]
    if not wide:   # uint32 wrap, then an int32 arithmetic shift
        pred = ((pred & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    res = x.astype(np.int64)[:, None] - (pred >> shifts[..., None])
    res = res * (np.arange(n) >= np.arange(1, p + 1)[:, None])
    zz = (res << 1) ^ (res >> 63)
    maxabs = np.abs(res).max(-1)
    if wide:
        maxabs = np.minimum(maxabs, INT32[1])
    return zz.sum(-1), maxabs.astype(np.int32)


def full_scale_rows(seed, r, n, bits):
    rng = np.random.default_rng(seed)
    h = 1 << (bits - 1)
    x = rng.integers(-h, h, (r, n))
    x[0] = -h
    x[1] = h - 1
    x[2] = np.where(np.arange(n) % 2, h - 1, -h)
    return x.astype(np.int32)


def taps(seed, r, p, prec):
    rng = np.random.default_rng(seed)
    h = 1 << (prec - 1)
    q = rng.integers(-h, h, (r, p, p))
    q[1] = -h
    q[2] = np.where(np.arange(p) % 2, h - 1, -h)
    return (q * (np.arange(p) < np.arange(1, p + 1)[:, None])).astype(
        np.int32)


@pytest.mark.parametrize("eff_bps,p,prec", [
    (17, 12, 5),     # encode --best at 16 bits: one tap limb, int32
    (13, 4, 15),     # two tap limbs, eff_bps + 1 + bitlen = 31
    (24, 4, 4),      # three full-scale sample limbs at the int32 bound
    (17, 12, 9),     # taps just past one limb, int32
    (25, 12, 15),    # 24-bit stereo --best: four limbs, wide
    (25, 32, 15),    # every order, wide
    (17, 32, 15),    # three limbs, wide by the taps
    (25, 3, 2),      # four limbs under the int32 bound
])
def test_limb_model_matches_plain(eff_bps, p, prec):
    """Full-scale rows and extreme taps: the model equals
    ``lpc_allorder_plain`` on every order's sum and maximum."""
    r, n = 5, 300
    x = full_scale_rows(eff_bps + p, r, n, eff_bps)
    q = taps(prec + p, r, p, prec)
    shifts = np.random.default_rng(p).integers(0, 16, (r, p))
    shifts[1] = 0
    shifts = shifts.astype(np.int32)
    stm = p << (prec - 1)
    lzz, maxabs = model_allorder(x, q, shifts, eff_bps, stm)
    want = lpc_allorder_plain(*(torch.from_numpy(a) for a in (x, q, shifts)),
                              eff_bps, stm)
    np.testing.assert_array_equal(lzz, want[0].numpy())
    np.testing.assert_array_equal(maxabs, want[1].numpy())


@pytest.mark.parametrize("eff_bps,p,prec,dtype", [
    (25, 12, 15, jnp.int64), (25, 32, 15, jnp.int64),
    (13, 4, 15, jnp.int32), (24, 4, 4, jnp.int32)])
def test_limb_model_matches_flacx_at_extremes(eff_bps, p, prec, dtype):
    """Rows of -2^(b-1) and 2^(b-1) - 1 with taps of -2^(prec-1) and
    2^(prec-1) - 1, shift 0: the model equals flacx's ``lpc_residuals_all``
    (int64 past the int32 bound, int32 at it), masked and reduced."""
    r, n = 4, 257
    x = full_scale_rows(p, r, n, eff_bps)
    q = taps(p + 1, r, p, prec)
    shifts = np.zeros((r, p), np.int32)
    stm = p << (prec - 1)
    assert (mac_width(eff_bps, stm) == "wide") == (dtype == jnp.int64)
    res = np.asarray(jax.jit(fx_lpc.lpc_residuals_all, static_argnums=3)(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(shifts), dtype))
    res = res * (np.arange(n) >= np.arange(1, p + 1)[:, None])
    want_lzz = np.asarray(fx_zigzag(jnp.asarray(res))).astype(np.int64) \
        .sum(-1)
    lzz, maxabs = model_allorder(x, q, shifts, eff_bps, stm)
    np.testing.assert_array_equal(lzz, want_lzz)
    np.testing.assert_array_equal(
        maxabs, np.minimum(np.abs(res.astype(np.int64)).max(-1), INT32[1]))


def test_limbs_recombine_and_bound_the_accumulators():
    """Samples recombine from their bytes and taps from (lo, hi) exactly,
    every limb in u8 or s8 range; and the worst accumulator (two limb
    products of 32 terms at 255 x 128) stays inside int32."""
    rng = np.random.default_rng(0)
    for bits, limbs in ((17, 3), (24, 3), (25, 4), (32, 4)):
        x = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), 4096)
        x[:2] = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
        parts = split_samples(x.astype(np.int32), limbs)
        assert all(0 <= v.min() and v.max() <= 255 for v in parts[:-1])
        assert -128 <= parts[-1].min() and parts[-1].max() <= 127
        np.testing.assert_array_equal(
            sum(v << (8 * a) for a, v in enumerate(parts)), x)
    q = np.concatenate([rng.integers(-(1 << 14), 1 << 14, 4096),
                        [-(1 << 14), (1 << 14) - 1, -129, -128, 127, 128]])
    lo, hi = split_taps(q)
    np.testing.assert_array_equal(lo + (hi << 8), q)
    assert np.abs(np.concatenate([lo, hi])).max() <= 128
    assert (hi[np.abs(q) <= 127] == 0).all() and (hi[-1] == 1)
    assert 2 * 32 * 255 * 128 < 1 << 31
    # the model's own int32 check at that worst case: every limb at its
    # extreme, every tap -128 in both limbs, 32 orders
    p = 32
    x = np.full((1, 64), -1, np.int32)      # low bytes 255, top byte -1
    q = np.full((1, p, p), -128 - 128 * 256, np.int32)
    model_allorder(x, q, np.zeros((1, p), np.int32), 25, p << 15)
