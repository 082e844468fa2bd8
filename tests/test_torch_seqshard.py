"""flacx_torch's sequence sharding against flacx's on the CPU.

``flacx_torch.parallel.seqshard`` on ``seq_mesh`` over ``("cpu",) * 8``
(the ``seqshard`` kernel's plain versions do the shard-local work) and
``flacx.parallel.seqshard`` on its 8 virtual CPU devices (the root
``conftest.py`` sets them) take the same rows, those of
``tests/test_seqshard.py``: 4 rows of 1024 tonal 16-bit samples at
``(n_data, n_seq)`` in {(4, 2), (2, 4), (1, 8)}.  Each mesh runs twice:
with the shards of a mesh row side by side on its one device (one launch
a row, halos read in place), and with every shard on a device of its own
(one launch a shard, each halo copied from its neighbour), the route of a
mesh of distinct cards.  Integer statistics must equal flacx's bit for
bit; the autocorrelation agrees within ``rtol=1e-12, atol=1e-6``, as
flacx's own test states (the same products, f64 sums in another order).
The plain versions' per-shard partials are held against flacx's fixed
and LPC residuals shard by shard, spans with explicit halos against one
span, a 32-bit-range LPC case proves the max |res| unclamped, and the
raises.  flacx's functions are called as ``tests/test_seqshard.py``
calls them (``use_tile_kernel=False``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import flacx.ops  # noqa: F401
from flacx.ops.fixedpred import fixed_order_zz_sums, fixed_residuals
from flacx.ops.lpc import autocorrelate, predict_residual_fused
from flacx.ops.lpc import tukey_window_np
from flacx.parallel import seqshard as fx_seqshard

from flacx_torch.kernels import seqshard as k_seq
from flacx_torch.parallel import seqshard

from conftest import make_pcm

torch.set_num_threads(1)

N, ROWS, LAGS, TAPS = 1024, 4, 8, 8
MESHES = [(4, 2), (2, 4), (1, 8)]
#: how a mesh row's shards meet their devices: side by side on one
#: device, or each on a device of its own
LAYOUTS = ["side_by_side", "one_a_device"]


@pytest.fixture(scope="module")
def data():
    """The rows, windowed rows (f64 and f32), taps, shifts and orders of
    ``tests/test_seqshard.py``'s LPC case."""
    rng = np.random.default_rng(0xF1AC)
    pcm = make_pcm(rng, N * ROWS, 1, 16, "tonal")[:, 0].reshape(ROWS, N)
    w = tukey_window_np(N)
    taps = rng.integers(-16, 16, size=(ROWS, TAPS)).astype(np.int32)
    shift = rng.integers(0, 6, size=(ROWS,)).astype(np.int32)
    order = np.array([TAPS, 3, TAPS, 1], np.int32)
    return {"x": pcm.astype(np.int32), "xw": pcm * w,
            "xw32": (pcm * w).astype(np.float32), "taps": taps,
            "shift": shift, "order": order}


def fx_mesh(n_data, n_seq):
    if len(jax.devices()) < n_data * n_seq:
        pytest.skip("needs 8 JAX devices")
    return fx_seqshard.seq_mesh(n_data, n_seq)


def fx_put(a, mesh):
    return jax.device_put(jnp.asarray(a), NamedSharding(mesh,
                                                        P("frames", "seq")))


def port_mesh(n_data, n_seq, layout, monkeypatch):
    if layout == "one_a_device":
        monkeypatch.setattr(seqshard, "_runs", lambda row: [
            (d, j, j + 1) for j, d in enumerate(row)])
    return seqshard.seq_mesh(n_data, n_seq,
                             devices=("cpu",) * (n_data * n_seq))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n_data,n_seq", MESHES)
@pytest.mark.parametrize("key", ["xw", "xw32"])
def test_sharded_autocorr_matches_flacx(data, key, n_data, n_seq, layout,
                                        monkeypatch):
    xw = data[key]
    want = np.asarray(autocorrelate(jnp.asarray(xw), LAGS,
                                    use_tile_kernel=False))
    mesh = fx_mesh(n_data, n_seq)
    fx_got = np.asarray(jax.jit(lambda v: fx_seqshard.autocorrelate_sharded(
        v, LAGS, mesh))(fx_put(xw, mesh)))
    got = seqshard.autocorrelate_sharded(
        torch.from_numpy(xw), LAGS, port_mesh(n_data, n_seq, layout,
                                              monkeypatch))
    assert got.dtype == torch.float64 and got.shape == (ROWS, LAGS + 1)
    # the same products in the input's type, f64 sums in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), fx_got, rtol=1e-12, atol=1e-6)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n_data,n_seq", MESHES)
def test_sharded_fixed_sums_match_flacx(data, n_data, n_seq, layout,
                                        monkeypatch):
    x = data["x"]
    want = np.asarray(fixed_order_zz_sums(jnp.asarray(x), 16,
                                          use_tile_kernel=False))
    mesh = fx_mesh(n_data, n_seq)
    fx_got = np.asarray(jax.jit(
        lambda v: fx_seqshard.fixed_order_zz_sums_sharded(v, mesh))(
            fx_put(x, mesh)))
    got = seqshard.fixed_order_zz_sums_sharded(
        torch.from_numpy(x), port_mesh(n_data, n_seq, layout, monkeypatch))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), fx_got)


def fx_lpc_sharded(x, taps, shift, order, mesh):
    zz, mx = jax.jit(
        lambda v, tp, sh, od: fx_seqshard.lpc_zz_stats_sharded(
            v, tp, sh, od, mesh))(fx_put(x, mesh), jnp.asarray(taps),
                                  jnp.asarray(shift), jnp.asarray(order))
    return np.asarray(zz), np.asarray(mx).astype(np.int64)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n_data,n_seq", MESHES)
def test_sharded_lpc_stats_match_flacx(data, n_data, n_seq, layout,
                                       monkeypatch):
    x, taps, shift, order = (data[k] for k in ("x", "taps", "shift",
                                               "order"))
    _, want_sum, want_max = predict_residual_fused(
        jnp.asarray(x), jnp.asarray(taps), jnp.asarray(shift),
        jnp.asarray(order), 17, TAPS << 4, use_tile_kernel=False)
    fx_sum, fx_max = fx_lpc_sharded(x, taps, shift, order,
                                    fx_mesh(n_data, n_seq))
    got_sum, got_max = seqshard.lpc_zz_stats_sharded(
        *(torch.from_numpy(a) for a in (x, taps, shift, order)),
        port_mesh(n_data, n_seq, layout, monkeypatch))
    assert got_sum.dtype == got_max.dtype == torch.int64
    np.testing.assert_array_equal(got_sum.numpy(), np.asarray(want_sum))
    np.testing.assert_array_equal(got_max.numpy(),
                                  np.asarray(want_max).astype(np.int64))
    np.testing.assert_array_equal(got_sum.numpy(), fx_sum)
    np.testing.assert_array_equal(got_max.numpy(), fx_max)


def per_shard(values: np.ndarray, n_seq: int, reduce) -> np.ndarray:
    """``[..., n]`` per-sample values reduced over each shard:
    ``[..., n_seq]``."""
    return reduce(values.reshape(*values.shape[:-1], n_seq, -1), axis=-1)


@pytest.mark.parametrize("n_seq", [1, 4, 8])
def test_seq_fixed_plain_partials_are_flacx_residual_sums(data, n_seq):
    """Each shard's partial is the shard's sum of flacx's zigzag fixed
    residuals at positions ``i >= o``."""
    from flacx.ops.rice import zigzag
    x = data["x"]
    res = np.asarray(zigzag(fixed_residuals(jnp.asarray(x)))).astype(
        np.int64)                                      # [rows, 5, n]
    res = res * (np.arange(N) >= np.arange(5)[:, None])
    want = per_shard(res, n_seq, np.sum).transpose(0, 2, 1)
    got = k_seq.seq_fixed_plain(torch.from_numpy(x), n_seq)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_seq", [1, 4, 8])
def test_seq_lpc_plain_partials_are_flacx_residual_stats(data, n_seq):
    """Each shard's partials are the zigzag sum and max |res| of flacx's
    masked residual over the shard."""
    x, taps, shift, order = (data[k] for k in ("x", "taps", "shift",
                                               "order"))
    res, _, _ = predict_residual_fused(
        jnp.asarray(x), jnp.asarray(taps), jnp.asarray(shift),
        jnp.asarray(order), 17, TAPS << 4, use_tile_kernel=False)
    res = np.asarray(res).astype(np.int64)
    zz = (res << 1) ^ (res >> 63)
    got_zz, got_max = k_seq.seq_lpc_plain(
        *(torch.from_numpy(a) for a in (x, taps, shift, order)), n_seq)
    np.testing.assert_array_equal(got_zz.numpy(), per_shard(zz, n_seq,
                                                            np.sum))
    np.testing.assert_array_equal(got_max.numpy(),
                                  per_shard(np.abs(res), n_seq, np.max))


@pytest.mark.parametrize("n_seq", [1, 4, 8])
def test_seq_autocorr_plain_partials_sum_to_flacx(data, n_seq):
    for key in ("xw", "xw32"):
        xw = data[key]
        want = np.asarray(autocorrelate(jnp.asarray(xw), LAGS,
                                        use_tile_kernel=False))
        got = k_seq.seq_autocorr_plain(torch.from_numpy(xw), LAGS, n_seq)
        assert got.shape == (ROWS, n_seq, LAGS + 1)
        np.testing.assert_allclose(got.sum(1).numpy(), want, rtol=1e-12,
                                   atol=1e-6)


@pytest.mark.parametrize("mode", ["autocorr", "fixed", "lpc"])
def test_spans_with_halos_equal_one_span(data, mode):
    """Two spans of 3 and 5 shards, each with the halo its neighbour's
    device would send, give the one span's partials (the halo path of a
    mesh of distinct cards)."""
    cut = 3 * N // 8
    x = torch.from_numpy(data["x"])
    if mode == "autocorr":
        xw = torch.from_numpy(data["xw32"])
        whole = k_seq.seq_autocorr(xw, LAGS, 8)
        parts = [k_seq.seq_autocorr(xw[:, :cut], LAGS, 3,
                                    halo=xw[:, cut:cut + LAGS], n=N),
                 k_seq.seq_autocorr(xw[:, cut:], LAGS, 5, shard0=3, n=N)]
        assert torch.equal(torch.cat(parts, 1), whole)
        return
    if mode == "fixed":
        whole = k_seq.seq_fixed(x, 8)
        parts = [k_seq.seq_fixed(x[:, :cut], 3),
                 k_seq.seq_fixed(x[:, cut:].contiguous(), 5,
                                 halo=x[:, cut - 4:cut], shard0=3)]
        assert torch.equal(torch.cat(parts, 1), whole)
        return
    tso = [torch.from_numpy(data[k]) for k in ("taps", "shift", "order")]
    whole = k_seq.seq_lpc(x, *tso, 8)
    parts = [k_seq.seq_lpc(x[:, :cut], *tso, 3),
             k_seq.seq_lpc(x[:, cut:], *tso, 5, halo=x[:, cut - TAPS:cut],
                           shard0=3)]
    for k in range(2):
        assert torch.equal(torch.cat([p[k] for p in parts], 1), whole[k])


def test_lpc_max_is_unclamped_int64(monkeypatch):
    """32-bit-range samples with large taps: |res| passes 2^31, and the
    sharded max keeps it whole, as flacx's does."""
    rng = np.random.default_rng(7)
    x = rng.integers(-(1 << 31), (1 << 31) - 1, size=(2, N)).astype(np.int32)
    taps = rng.integers(-(1 << 14), 1 << 14, size=(2, 32)).astype(np.int32)
    shift = np.array([3, 9], np.int32)
    order = np.array([32, 5], np.int32)
    fx_sum, fx_max = fx_lpc_sharded(x, taps, shift, order, fx_mesh(2, 4))
    got_sum, got_max = seqshard.lpc_zz_stats_sharded(
        *(torch.from_numpy(a) for a in (x, taps, shift, order)),
        port_mesh(2, 4, "one_a_device", monkeypatch))
    assert (got_max.numpy() >= 1 << 31).all()
    np.testing.assert_array_equal(got_max.numpy(), fx_max)
    np.testing.assert_array_equal(got_sum.numpy(), fx_sum)


@pytest.mark.parametrize("case", ["samples", "rows", "halo"])
def test_sharded_functions_raise_where_flacx_cannot_run(case):
    i32 = torch.int32
    mesh = seqshard.seq_mesh(2, 4, devices=("cpu",) * 8)
    x = {"samples": torch.zeros((4, N + 2), dtype=i32),   # n % n_seq
         "rows": torch.zeros((3, N), dtype=i32),          # rows % n_data
         "halo": torch.zeros((4, 12), dtype=i32)}[case]   # local 3 < 4
    calls = [lambda: seqshard.fixed_order_zz_sums_sharded(x, mesh)]
    if case == "halo":          # shards of 3 < lags 4, taps 4
        calls += [lambda: seqshard.autocorrelate_sharded(x.double(), 4, mesh),
                  lambda: seqshard.lpc_zz_stats_sharded(
                      x, torch.zeros((4, 4), dtype=i32),
                      torch.zeros(4, dtype=i32), torch.zeros(4, dtype=i32),
                      mesh)]
    else:
        calls.append(lambda: seqshard.autocorrelate_sharded(x.double(), 2,
                                                            mesh))
    for call in calls:
        with pytest.raises(ValueError):
            call()


def test_seq_mesh_takes_repeated_devices():
    mesh = seqshard.seq_mesh(2, 4, devices=("cpu",) * 9)
    assert mesh.shape == {"frames": 2, "seq": 4} and mesh.size == 8
    assert mesh.axis_names == ("frames", "seq")
    assert all(d == torch.device("cpu") for r in mesh.devices for d in r)
    assert seqshard._runs(mesh.devices[0]) == [(torch.device("cpu"), 0, 4)]
    with pytest.raises(ValueError):
        seqshard.seq_mesh(2, 4, devices=("cpu",) * 7)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            seqshard.seq_mesh(1, 2)


def test_unsplit_leading_axis_and_axis_names(data):
    """``batch_axis=None`` leaves the leading axis whole (the first mesh
    row computes every row); axis names the mesh lacks raise."""
    mesh = seqshard.seq_mesh(2, 4, devices=("cpu",) * 8)
    x = torch.from_numpy(data["x"][:3])            # 3 rows: not split
    want = seqshard.fixed_order_zz_sums_sharded(
        x, seqshard.seq_mesh(1, 4, devices=("cpu",) * 4))
    assert torch.equal(seqshard.fixed_order_zz_sums_sharded(
        x, mesh, batch_axis=None), want)
    with pytest.raises(ValueError):
        seqshard.fixed_order_zz_sums_sharded(x, mesh, seq_axis="samples")
