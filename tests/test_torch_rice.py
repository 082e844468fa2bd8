"""flacx_torch Rice search against flacx on the CPU.

The ``rice_stats`` kernel's plain version must equal the JAX package's
Pallas kernel ``rice_stats_tiles`` (run in interpret mode) bit for bit,
and ``exact_plan`` fed those statistics must choose exactly the plan
flacx's own int32 search chooses.
"""

import functools

import numpy as np
import pytest
import torch

import flacx.ops  # noqa: F401  (x64)
import jax
import jax.numpy as jnp
from flacx.kernels.rice_tile import rice_stats_tiles
from flacx.ops import rice as fx_rice

from flacx_torch.kernels.rice_stats import rice_stats
from flacx_torch.ops import rice

torch.set_num_threads(1)

N, KMAX = 4608, 23
PORDERS = (0, 1, 2, 3, 4, 5)


def zigzag_rows(seed: int, b: int, c: int = 2) -> tuple[np.ndarray,
                                                        np.ndarray]:
    """``zz [B, C, N]`` int32 rows of residual magnitudes from 2^0 to 2^29
    (the widest exceed every Rice code cap), a few all-zero rows, zeros
    at the warmup positions of a seeded order."""
    rng = np.random.default_rng(seed)
    scale = 2.0 ** rng.integers(0, 30, size=(b, c, 1))
    zz = np.minimum(rng.exponential(size=(b, c, N)) * scale, 2 ** 30 - 1)
    zz = zz.astype(np.int32)
    zz[rng.random((b, c)) < 0.05] = 0
    order = rng.integers(0, 13, size=(b, c)).astype(np.int32)
    zz[np.arange(N) < order[..., None]] = 0
    return zz, order


def test_rice_stats_matches_pallas_kernel():
    zz, order = zigzag_rows(11, 128)
    ref = rice_stats_tiles(jnp.asarray(zz), jnp.asarray(order), PORDERS,
                           KMAX, interpret=True).levels
    got = rice_stats(torch.from_numpy(zz), torch.from_numpy(order),
                     PORDERS, KMAX)
    assert sorted(got) == sorted(ref)
    for po in PORDERS:
        for name, a, r in zip(("min4", "arg4", "min5", "arg5", "max"),
                              got[po], ref[po]):
            assert a.dtype == torch.int32, name
            np.testing.assert_array_equal(a.numpy(), np.asarray(r),
                                          err_msg=f"po {po} {name}")
    sent = got[0][2].numpy() == rice.SENT
    assert sent.any() and not sent.all()


@pytest.mark.parametrize("orders,escapes", [
    (PORDERS, True),
    (PORDERS, False),
    ((2, 3), True),
])
def test_exact_plan_matches_flacx(orders, escapes):
    zz, order = zigzag_rows(12, 8)
    porders = tuple(sorted(set(orders) | {0}))
    plan_fn = jax.jit(functools.partial(
        fx_rice.exact_plan, porders=porders, preferred=orders, kmax=KMAX,
        allow_escape=escapes))
    ref = plan_fn(jnp.asarray(zz), jnp.asarray(order))
    zt, ot = torch.from_numpy(zz), torch.from_numpy(order)
    stats = rice_stats(zt, ot, porders, KMAX)
    for got in (rice.exact_plan(zt, ot, porders, orders, KMAX, escapes,
                                kernel_stats=stats),
                rice.exact_plan(zt, ot, porders, orders, KMAX, escapes)):
        for field in rice.RicePlan._fields:
            np.testing.assert_array_equal(
                getattr(got, field).numpy(),
                np.asarray(getattr(ref, field)), err_msg=field)
    assert (np.asarray(ref.esc_seg).any() == escapes)


def test_estimate_bits_and_zigzag_match_flacx():
    rng = np.random.default_rng(5)
    sums = rng.integers(0, 1 << 40, size=64)
    counts = rng.integers(0, 5000, size=64)
    np.testing.assert_array_equal(
        rice.estimate_bits(torch.from_numpy(sums), torch.from_numpy(counts),
                           KMAX).numpy(),
        np.asarray(fx_rice.estimate_bits(jnp.asarray(sums),
                                         jnp.asarray(counts), KMAX)))
    r = rng.integers(-(1 << 29), 1 << 29, size=256).astype(np.int32)
    np.testing.assert_array_equal(
        rice.zigzag(torch.from_numpy(r)).numpy(),
        np.asarray(fx_rice.zigzag(jnp.asarray(r))))


def test_rice_stats_is_int32_only():
    """The statistics are int32 tables of int32 ``zz`` or, past 24-bit
    samples, of int64 ``zz``; ``zz`` of any other type is refused."""
    zz = torch.zeros((2, 1, 1000), dtype=torch.int16)
    order = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(TypeError):
        rice.rice_stats(zz, order, (0, 3), KMAX)
    with pytest.raises(TypeError):
        rice.exact_plan(zz, order, (0, 3), (0, 3), KMAX,
                        kernel_stats=rice.rice_stats(zz.int(), order,
                                                     (0, 3), KMAX))
    for t in rice.rice_stats(zz.long(), order, (0, 3), KMAX)[3]:
        assert t.dtype == torch.int32
