"""flacx_torch analysis stage against flacx on the CPU.

The ``analysis`` kernel's plain version (what its wrapper runs on CPU
tensors) must match ``flacx.ops.lpc.autocorrelate`` within summation-order
noise (f64 sums of identical f32 products) and
``flacx.ops.fixedpred.fixed_order_zz_sums`` exactly, including the
17-bit side channel.
"""

import functools

import numpy as np
import pytest
import torch

import flacx.ops  # noqa: F401  (x64)
import jax
import jax.numpy as jnp
from flacx.ops.fixedpred import fixed_order_zz_sums as fx_fixed_sums
from flacx.ops.lpc import apodization_window_np as fx_window
from flacx.ops.lpc import autocorrelate as fx_autocorrelate

from flacx_torch.kernels.analysis import analysis
from flacx_torch.ops.lpc import apodization_window_np, window_from_numpy

from conftest import make_pcm

torch.set_num_threads(1)


def virtual_channels(rng, b: int, n: int, kind: str) -> np.ndarray:
    """``[B, 4, N]`` int32 L, R, M, S of 16-bit stereo PCM."""
    pcm = make_pcm(rng, b * n, 2, 16, kind)
    planar = pcm.T.reshape(2, b, n).transpose(1, 0, 2).astype(np.int32)
    left, right = planar[:, 0], planar[:, 1]
    return np.stack([left, right, (left + right) >> 1, left - right], 1)


@pytest.mark.parametrize("n,max_lag,kind", [
    (4608, 12, "tonal"),
    (4608, 12, "noise"),
    (1000, 32, "tonal"),
])
def test_autocorrelate_and_fixed_sums_match_flacx(n, max_lag, kind):
    rng = np.random.default_rng(n + max_lag)
    x_v = virtual_channels(rng, 3, n, kind)
    w32 = apodization_window_np("tukey(0.5)", n).astype(np.float32)
    np.testing.assert_array_equal(
        w32, fx_window("tukey(0.5)", n).astype(np.float32))

    autoc, fsums = analysis(torch.from_numpy(x_v), window_from_numpy(w32),
                            max_lag)
    ref = jax.jit(functools.partial(fx_autocorrelate, max_lag=max_lag))(
        jnp.asarray(x_v), window=jnp.asarray(w32))
    np.testing.assert_allclose(autoc.numpy(), np.asarray(ref), rtol=1e-9)

    ref_f = jax.jit(fx_fixed_sums, static_argnums=1)(jnp.asarray(x_v), 17)
    np.testing.assert_array_equal(fsums.numpy(), np.asarray(ref_f))
    assert autoc.dtype == torch.float64 and fsums.dtype == torch.int64


def test_fixed_sums_full_width_side_channel():
    """Side channel at its full 17-bit range, alternating extremes (the
    largest fixed-order differences)."""
    b, n = 2, 512
    left = np.full((b, n), 32767, np.int32)
    left[:, 1::2] = -32768
    right = -1 - left
    x_v = np.stack([left, right, (left + right) >> 1, left - right], 1)
    _, fsums = analysis(torch.from_numpy(x_v),
                        torch.ones(n, dtype=torch.float32), 4)
    ref = np.asarray(fx_fixed_sums(jnp.asarray(x_v), 17))
    np.testing.assert_array_equal(fsums.numpy(), ref)
