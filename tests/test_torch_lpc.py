"""flacx_torch LPC stages against flacx on the CPU.

The same numpy inputs go through both packages: Levinson-Durbin within
f64 rounding noise, the quantized coefficients and shifts exactly, and the
integer residual statistics, zigzag residual and written residual (the
``lpc_residual`` kernel's plain version) and the wide all-orders
statistics (``lpc_allorder``'s) exactly.
"""

import functools

import numpy as np
import pytest
import torch

import flacx.ops  # noqa: F401  (x64)
import jax
import jax.numpy as jnp
from flacx.ops import lpc as fx_lpc
from flacx.ops.rice import zigzag as fx_zigzag

from flacx_torch.kernels.lpc_allorder import lpc_allorder
from flacx_torch.kernels.lpc_residual import (lpc_residual_res,
                                              lpc_residual_stats,
                                              lpc_residual_zz, mac_width)
from flacx_torch.ops import lpc

from conftest import make_pcm

torch.set_num_threads(1)

N, P, PREC = 4608, 12, 5
SUM_TAPS_MAX = P << (PREC - 1)


def virtual_channels(seed: int, b: int, kind: str) -> np.ndarray:
    """``[B, 4, N]`` int32 L, R, M, S of 16-bit stereo PCM."""
    pcm = make_pcm(np.random.default_rng(seed), b * N, 2, 16, kind)
    planar = pcm.T.reshape(2, b, N).transpose(1, 0, 2).astype(np.int32)
    left, right = planar[:, 0], planar[:, 1]
    return np.stack([left, right, (left + right) >> 1, left - right], 1)


@pytest.fixture(scope="module")
def analysed():
    """Virtual channels of tonal and noise frames with their windowed
    autocorrelation (one silent frame makes the recursion degenerate)."""
    x_v = np.concatenate([virtual_channels(3, 3, "tonal"),
                          virtual_channels(4, 2, "noise")], axis=0)
    x_v[-1] = 0
    w32 = lpc.apodization_window_np("tukey(0.5)", N).astype(np.float32)
    autoc = lpc.autocorrelate(torch.from_numpy(x_v), P,
                              window=lpc.window_from_numpy(w32)).numpy()
    return x_v, autoc


@pytest.fixture(scope="module")
def fx_levinson(analysed):
    _, autoc = analysed
    fn = jax.jit(fx_lpc.levinson_all_orders, static_argnums=1)
    return [np.asarray(a) for a in fn(jnp.asarray(autoc), P)]


def test_levinson_matches_flacx(analysed, fx_levinson):
    _, autoc = analysed
    taps, err, valid = lpc.levinson_all_orders(torch.from_numpy(autoc), P)
    ref_taps, ref_err, ref_valid = fx_levinson
    np.testing.assert_array_equal(valid.numpy(), ref_valid)
    assert not ref_valid[-1].any() and ref_valid[0].all()
    ok = ref_valid[..., None]
    np.testing.assert_allclose(np.where(ok, taps.numpy(), 0),
                               np.where(ok, ref_taps, 0), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(np.where(ref_valid, err.numpy(), 0),
                               np.where(ref_valid, ref_err, 0), rtol=1e-9)


@pytest.mark.parametrize("precision", [5, 12, 15])
def test_quantize_matches_flacx(fx_levinson, precision):
    ref_taps = -np.nan_to_num(fx_levinson[0])
    q, s, ok = lpc.quantize_all_orders(torch.from_numpy(ref_taps), precision)
    fq, fs, fok = jax.jit(fx_lpc.quantize_all_orders, static_argnums=1)(
        jnp.asarray(ref_taps), precision)
    np.testing.assert_array_equal(q.numpy(), np.asarray(fq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(fs))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(fok))
    assert q.dtype == torch.int32 and s.dtype == torch.int32


def test_round_half_even_like_jnp_rint():
    v = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5])
    np.testing.assert_array_equal(torch.round(torch.from_numpy(v)).numpy(),
                                  np.asarray(jnp.rint(jnp.asarray(v))))


@pytest.fixture(scope="module")
def chosen(analysed, fx_levinson):
    """Each row's quantized predictor at a seeded order 1..P, padded."""
    x_v, _ = analysed
    q, s, _ = lpc.quantize_all_orders(
        torch.from_numpy(-np.nan_to_num(fx_levinson[0])), PREC)
    rng = np.random.default_rng(7)
    order = rng.integers(1, P + 1, size=x_v.shape[:2]).astype(np.int32)
    o = torch.from_numpy(order).long() - 1
    taps = q.gather(2, o[..., None, None].expand(*o.shape, 1, P))[:, :, 0]
    shift = s.gather(2, o[..., None])[..., 0]
    return (x_v, taps.numpy().astype(np.int32),
            shift.numpy().astype(np.int32), order)


def test_residual_stats_and_zz_match_flacx(chosen):
    x_v, taps, shift, order = chosen
    res_fn = jax.jit(functools.partial(
        fx_lpc.predict_residual_fused, eff_bps=17, sum_taps_max=SUM_TAPS_MAX,
        use_tile_kernel=False))
    ref_res, ref_lzz, ref_max = (np.asarray(a) for a in res_fn(
        jnp.asarray(x_v), jnp.asarray(taps), jnp.asarray(shift),
        jnp.asarray(order)))
    args = [torch.from_numpy(a) for a in (x_v, taps, shift, order)]
    res, lzz, maxabs = lpc.predict_residual_fused(*args, 17, SUM_TAPS_MAX)
    np.testing.assert_array_equal(res.numpy(), ref_res)
    np.testing.assert_array_equal(lzz.numpy(), ref_lzz)
    np.testing.assert_array_equal(maxabs.numpy(), ref_max)

    # the kernel wrappers on CPU tensors: stats mode, and zz mode as the
    # encoder derives the emitted residual (zigzag, warmup zeroed)
    k_lzz, k_max = lpc_residual_stats(*args, 17, SUM_TAPS_MAX)
    np.testing.assert_array_equal(k_lzz.numpy(), ref_lzz)
    np.testing.assert_array_equal(k_max.numpy(), ref_max)
    in_resid = np.arange(N) >= order[..., None]
    ref_zz = np.asarray(fx_zigzag(jnp.asarray(ref_res))) * in_resid
    zz = lpc_residual_zz(*args, 17, max(SUM_TAPS_MAX, 15))
    assert zz.dtype == torch.int32
    np.testing.assert_array_equal(zz.numpy(), ref_zz)


def test_residual_wrappers_refuse_past_int32_bound(chosen):
    """Past the int32 MAC bound the wrappers take the wide (int64) MAC
    instead of refusing, and equal flacx's int64 XLA route there."""
    from flacx_torch.kernels.lpc_residual import mac_width
    x_v, taps, shift, order = chosen
    args = [torch.from_numpy(a) for a in (x_v, taps, shift, order)]
    assert mac_width(17, SUM_TAPS_MAX) == "int32"
    assert mac_width(25, 32 << 14) == "wide"
    ref_res, ref_lzz, ref_max = (np.asarray(a) for a in jax.jit(
        functools.partial(fx_lpc.predict_residual_fused, eff_bps=25,
                          sum_taps_max=32 << 14, use_tile_kernel=False))(
        *(jnp.asarray(a) for a in (x_v, taps, shift, order))))
    assert ref_res.dtype == np.int64
    lzz, maxabs = lpc_residual_stats(*args, 25, 32 << 14)
    np.testing.assert_array_equal(lzz.numpy(), ref_lzz)
    np.testing.assert_array_equal(maxabs.numpy(), ref_max)
    in_resid = np.arange(N) >= order[..., None]
    np.testing.assert_array_equal(
        lpc_residual_zz(*args, 25, 32 << 14).numpy(),
        np.asarray(fx_zigzag(jnp.asarray(ref_res))) * in_resid)


def test_window_table_matches_flacx():
    for name in ("tukey(0.5)", "hann", "welch", "gauss(0.3)"):
        for n in (64, 4608):
            np.testing.assert_array_equal(
                lpc.apodization_window_np(name, n),
                fx_lpc.apodization_window_np(name, n))
    w = lpc.window_from_numpy(np.ones(8, np.float32))
    assert w.dtype == torch.float32 and w.device.type == "cpu"


@pytest.mark.parametrize("r, n, t", [
    (128, 531, 12),      # ragged tail tile
    (128, 700, 32),      # max order: lookbehind spans tile boundary
    (256, 512, 4),       # fixed-predictor tap count, one tile
])
def test_residual_res_matches_pallas_kernel(r, n, t):
    """``lpc_residual_res`` (its plain version on CPU tensors) against
    flacx's ``lpc_residual_tiles`` in interpret mode, on the inputs of
    ``test_pallas_kernels.py``'s test of that kernel."""
    from flacx.kernels.lpcres_tile import lpc_residual_tiles

    rng = np.random.default_rng(n + t)
    x = rng.integers(-(1 << 16), 1 << 16, size=(r, n)).astype(np.int32)
    taps = rng.integers(-16, 16, size=(r, t)).astype(np.int32)
    order = rng.integers(0, t + 1, size=(r,)).astype(np.int32)
    taps[np.arange(t) >= order[:, None]] = 0
    shift = rng.integers(0, 15, size=(r,)).astype(np.int32)
    want = lpc_residual_tiles(*(jnp.asarray(a) for a in (x, taps, shift,
                                                         order)),
                              interpret=True)
    got = lpc_residual_res(*(torch.from_numpy(a) for a in (x, taps, shift,
                                                           order)),
                           17, t << 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert [g.dtype for g in got] == [torch.int32, torch.int64, torch.int32]


@pytest.mark.parametrize("p", [12, 32])
def test_wide_allorder_matches_flacx_int64_route(p):
    """The exact search past the int32 MAC bound (24-bit stereo: eff_bps
    25, precision-15 taps): ``lpc_allorder``'s plain version equals
    flacx's int64 ``lpc_residuals_all`` → warm-up mask → zigzag sum on
    every order's lane, those whose residual passes 2^31 included (max
    |res| clamps to 2^31 - 1 there)."""
    r, n = 6, 777
    rng = np.random.default_rng(p)
    x = rng.integers(-(1 << 24), 1 << 24, size=(r, n)).astype(np.int32)
    x[0] = 0
    x[1] = np.where(np.arange(n) % 2, (1 << 24) - 1, -(1 << 24))
    qcoefs = rng.integers(-(1 << 14), 1 << 14, size=(r, p, p)) \
        .astype(np.int32)
    qcoefs *= np.arange(p) < np.arange(1, p + 1)[:, None]
    shifts = rng.integers(0, 16, size=(r, p)).astype(np.int32)
    shifts[1] = 0
    assert mac_width(25, p << 14) == "wide"
    res = np.asarray(jax.jit(fx_lpc.lpc_residuals_all, static_argnums=3)(
        jnp.asarray(x), jnp.asarray(qcoefs), jnp.asarray(shifts), jnp.int64))
    res = res * (np.arange(n) >= np.arange(1, p + 1)[:, None])
    want_lzz = np.asarray(fx_zigzag(jnp.asarray(res))).sum(-1)
    lzz, maxabs = lpc_allorder(*(torch.from_numpy(a) for a in
                                 (x, qcoefs, shifts)), 25, p << 14)
    np.testing.assert_array_equal(lzz.numpy(), want_lzz)
    np.testing.assert_array_equal(
        maxabs.numpy(), np.minimum(np.abs(res).max(-1), (1 << 31) - 1))
    assert maxabs.dtype == torch.int32
    assert (np.abs(res).max(-1) >= 1 << 31).sum() > r * p // 4
