"""The ``analysis`` and ``lpc_residual`` kernels' split of a row into
segments, and ``analysis`` under several windows, against flacx on the
CPU.

Both kernels cut a row into segments of ``segment_size(n)`` samples, one
block each.  A block stages its segment with a halo of the samples before
it (zero before the row start) and computes the segment's part: the
autocorrelation's products whose later sample lies in the segment (the
windowed values zero from sample n - 1 on: the last sample takes part in
no product), the fixed-order sums of its samples, or the residuals of its
samples with the warm-up mask at the row position.  The parts combine in
segment order (the f64 sums) or by sum and max (the integers).  The model
below does the same in plain torch and must give flacx's results: the
autocorrelation within summation-order noise, the integers exactly.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flacx.ops  # noqa: F401  (x64)
import jax
import jax.numpy as jnp
from flacx.ops.fixedpred import fixed_order_zz_sums as fx_fixed_sums
from flacx.ops.lpc import autocorrelate as fx_autocorrelate
from flacx.ops.lpc import predict_residual_fused as fx_residual_fused

from flacx_torch.format import FIXED_PREDICTOR_TAPS
from flacx_torch.kernels import analysis as k_an
from flacx_torch.kernels import lpc_residual as k_lr
from flacx_torch.ops.lpc import apodization_window_np

from conftest import make_pcm

torch.set_num_threads(1)

WINDOWS = ("tukey(0.5)", "hann", "flattop")
RTOL = {np.float32: 1e-9, np.float64: 1e-12}


@pytest.fixture(scope="module")
def fx():
    """flacx's analysis functions, jitted once for the module."""
    return {
        "autoc": jax.jit(fx_autocorrelate, static_argnums=1),
        "fixed": jax.jit(fx_fixed_sums, static_argnums=1),
        "residual": jax.jit(fx_residual_fused, static_argnums=(4, 5)),
    }


def stereo_rows(seed: int, frames: int, n: int, bits: int = 16,
                kind: str = "tonal") -> np.ndarray:
    """``[frames, 4, n]`` int32 L, R, M, S of ``bits``-bit stereo PCM."""
    pcm = make_pcm(np.random.default_rng(seed), frames * n, 2, bits, kind)
    planar = pcm.T.reshape(2, frames, n).transpose(1, 0, 2).astype(np.int32)
    left, right = planar[:, 0], planar[:, 1]
    return np.stack([left, right, (left + right) >> 1, left - right], 1)


@pytest.mark.parametrize("n", [1152, 4608])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_analysis_windows_match_flacx(fx, n, dtype):
    """``[3, n]`` windows: each window's slice is flacx's autocorrelation
    under that window alone, and the fixed sums are flacx's."""
    x = stereo_rows(n, 2, n)
    wins = np.stack([apodization_window_np(w, n) for w in WINDOWS]) \
        .astype(dtype)
    autoc, fsums = k_an.analysis(torch.from_numpy(x), torch.from_numpy(wins),
                                 12)
    assert autoc.shape == (2, 4, 3, 13) and autoc.dtype == torch.float64
    for i in range(len(WINDOWS)):
        # flacx takes the f64 analysis's samples as f64, as its encoder
        # hands them (flacx/encoder.py:407-408)
        ref = fx["autoc"](jnp.asarray(x.astype(dtype)), 12,
                          window=jnp.asarray(wins[i]))
        np.testing.assert_allclose(autoc[:, :, i].numpy(), np.asarray(ref),
                                   rtol=RTOL[dtype])
    np.testing.assert_array_equal(
        fsums.numpy(), np.asarray(fx["fixed"](jnp.asarray(x), 17)))


def segmented_analysis(x: torch.Tensor, w: torch.Tensor, max_lag: int,
                       seg: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split: per segment the products whose later sample
    lies in it, from the windowed values staged with a zero halo and zero
    from sample n - 1 on, summed in f64 and added in segment order; the
    fixed-order sums of the segment's samples from its int32 samples and
    a halo of 4, with the ``i >= o`` guard at the row position."""
    n = x.shape[-1]
    halo = max(max_lag, 4)
    wx = x.to(w.dtype) * w
    wx[..., n - 1:] = 0
    wpad = F.pad(wx, (halo, 0))
    xpad = F.pad(x, (halo, 0))
    autoc = fsums = 0
    for s0 in range(0, n, seg):
        m = min(seg, n - s0)
        ws = wpad[..., s0:s0 + halo + m]
        autoc = autoc + torch.stack(
            [(ws[..., halo:] * ws[..., halo - lag:halo - lag + m])
             .sum(-1, dtype=torch.float64) for lag in range(max_lag + 1)],
            -1)
        d = xpad[..., s0:s0 + halo + m]
        i = torch.arange(s0, s0 + m)
        part = []
        for o in range(5):  # d holds D^o of the staged samples
            v = d[..., halo - o:]
            zz = ((v << 1) ^ (v >> 31)).long()
            part.append(torch.where(i >= o, zz, 0).sum(-1))
            d = d[..., 1:] - d[..., :-1]
        fsums = fsums + torch.stack(part, -1)
    return autoc, fsums


@pytest.mark.parametrize("n,max_lag", [(5000, 12), (1000, 32), (4609, 32),
                                       (4608, 0)])
def test_analysis_segments_match_flacx(fx, n, max_lag):
    """Rows of two segments, the last of one sample or of a few hundred, a
    row shorter than one pass, lag 32 across a segment start; f32 and
    f64."""
    seg = k_an.segment_size(n)
    assert seg % k_an.PASS == 0 and seg <= k_an.SEG_MAX
    x = stereo_rows(n + max_lag, 1, n, kind="noise")
    for dtype in (np.float32, np.float64):
        w = apodization_window_np("tukey(0.5)", n).astype(dtype)
        autoc, fsums = segmented_analysis(torch.from_numpy(x),
                                          torch.from_numpy(w), max_lag, seg)
        ref = fx["autoc"](jnp.asarray(x.astype(dtype)), max_lag,
                          window=jnp.asarray(w))
        np.testing.assert_allclose(autoc.numpy(), np.asarray(ref),
                                   rtol=RTOL[dtype])
        np.testing.assert_array_equal(
            fsums.numpy(), np.asarray(fx["fixed"](jnp.asarray(x), 17)))


def segmented_residual_stats(x: torch.Tensor, taps: torch.Tensor,
                             shift: torch.Tensor, order: torch.Tensor,
                             wide: bool, seg: int,
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split of the residual statistics: per segment the
    residuals of its samples from its samples and a zero-filled halo of
    32, the MAC in int64 (wide) or wrapping int32, the warm-up mask at the
    row position; Σ zigzag added and max |res| taken over the segments."""
    n, t = x.shape[-1], taps.shape[-1]
    xpad = F.pad(x.long(), (32, 0))
    lzz = torch.zeros(x.shape[:-1], dtype=torch.int64)
    mx = torch.zeros(x.shape[:-1], dtype=torch.int64)
    for s0 in range(0, n, seg):
        m = min(seg, n - s0)
        xs = xpad[..., s0:s0 + 32 + m]
        acc = sum(taps[..., k:k + 1].long() * xs[..., 31 - k:31 - k + m]
                  for k in range(t))
        if not wide:  # uint32 wraparound, read as int32
            acc = ((acc + (1 << 31)) % (1 << 32)) - (1 << 31)
        res = xs[..., 32:] - (acc >> shift[..., None].long())
        if not wide:
            res = ((res + (1 << 31)) % (1 << 32)) - (1 << 31)
        res = torch.where(torch.arange(s0, s0 + m) >= order[..., None],
                          res, 0)
        lzz += ((res << 1) ^ (res >> 63)).sum(-1)
        mx = torch.maximum(mx, res.abs().amax(-1))
    return lzz, mx.clamp(max=(1 << 31) - 1).int()


@pytest.mark.parametrize("n,bits,wide", [(5000, 17, False), (1000, 17, False),
                                         (4608, 25, True), (2305, 25, True)])
def test_residual_segments_match_flacx(fx, n, bits, wide):
    """Order 32 across every segment start, a fixed predictor, a row whose
    only tap is its last, a warm-up longer than the distance to the first
    segment boundary, and the wide MAC on 25-bit rows with precision-15
    taps (sums past 2^31)."""
    seg = k_lr.segment_size(n)
    r, t = 8, 32
    rng = np.random.default_rng(n + bits)
    x = stereo_rows(n, 2, n, bits=bits - 1, kind="noise").reshape(r, n)
    tmax = (1 << 14) if wide else 6
    sum_taps_max = t * tmax
    assert (k_lr.mac_width(bits, sum_taps_max) == "wide") == wide
    taps = rng.integers(-tmax, tmax, (r, t)).astype(np.int32)
    order = np.full(r, t, np.int32)
    order[1] = 12
    taps[1, 12:] = 0
    taps[2], order[2] = 0, 4
    taps[2, :4] = FIXED_PREDICTOR_TAPS[4]
    taps[3], taps[3, -1] = 0, -tmax
    order[4] = min(seg + 7, n - 1)        # the warm-up passes a boundary
    shift = rng.integers(0, 16, r).astype(np.int32)
    shift[5] = 0
    args = [torch.from_numpy(a) for a in (x, taps, shift, order)]
    lzz, mx = segmented_residual_stats(*args, wide, seg)
    _, ref_lzz, ref_mx = fx["residual"](*(jnp.asarray(a) for a in
                                          (x, taps, shift, order)),
                                        bits, sum_taps_max)
    np.testing.assert_array_equal(lzz.numpy(), np.asarray(ref_lzz))
    np.testing.assert_array_equal(mx.numpy(), np.asarray(ref_mx))
    if wide:
        assert int(np.asarray(ref_mx).max()) > 1 << 24
