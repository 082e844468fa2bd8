"""How the ``seqshard`` kernel splits its work, modelled in plain torch and
held against flacx's sequence sharding on the CPU.

``csrc/seqshard.cu`` gives a (row, shard) a block of up to ``MAXWARPS``
warps, each a contiguous part of the shard of about four tiles (the
part's size from ``local`` alone), walked in tiles of ``32 RUN``
samples.  A tile and its halo (after it for the autocorrelation, before
it for the fixed and LPC sums) are staged from the span in place, from
``halo`` across the span's edge, and zero past it; lane i takes the
tile's samples ``RUN i .. RUN i + RUN - 1`` with its window of values in
registers:

* autocorrelation: f32 products split as ``Σ fl(a b) = Σ a b - Σ e``,
  the first exact products summed in f64 (the kernel's tensor-core GEMM),
  the second each lane's f32 sum of the exact errors ``e = fma(a, b,
  -fl(a b))``, folded into f64 every ``FLUSH`` samples of a lane after
  the warp's lane sums are added in f32 (a butterfly); every value past
  global index ``n - 2`` staged as zero (the ``jg <= n - l - 2`` limit),
  samples past the part weighted zero;
* fixed orders: the difference triangle of the run's first sample from
  the four before it, then ``D^1..D^4`` carried along the run in the
  input's type;
* LPC: the taps up to a bucket (4, 8, 12, 16, 24, 32) holding the row's
  last nonzero tap, the int64 MAC of each sample from the window.

The models below do the same and must give flacx's
``autocorrelate_sharded`` (within ``rtol=1e-12, atol=1e-6``, as flacx's
own test), ``fixed_order_zz_sums_sharded`` and ``lpc_zz_stats_sharded``
(bit for bit), and equal the plain versions' per-shard partials at the
span edges: ``shard0 > 0``, ``n`` past the span, ``halo=None``, shards
that are not a multiple of the lane run, a shard as short as its halo.
The split sum is also held against the exact sum of the rounded f32
products (``math.fsum``) within its stated bound, on a cancelling signal
(alternating signs) where ``Σ|products|`` dwarfs ``|Σ products|``.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import flacx.ops  # noqa: F401  (x64)
from flacx.ops.lpc import tukey_window_np
from flacx.parallel import seqshard as fx_seqshard

from flacx_torch.kernels import seqshard as k_seq

from conftest import make_pcm

torch.set_num_threads(1)

#: csrc/seqshard.cu: samples a lane's run, warps a (row, shard) at most,
#: the widest halo, a lane's samples between f32 error folds
RUN, MAXWARPS, MAXH, FLUSH = 8, 4, 32, 64
TILE = 32 * RUN
BUCKETS = (4, 8, 12, 16, 24, 32)
N, ROWS = 2048, 3


def parts(local: int) -> tuple[int, int]:
    """``(warps, per)``: the kernel's ``parts``."""
    warps = min(MAXWARPS, max(1, -(-local // (4 * TILE))))
    per = -(-(-(-local // warps)) // TILE) * TILE
    return -(-local // per), per


def staged(x: torch.Tensor, halo, h: int, first: int, count: int,
           before: bool) -> torch.Tensor:
    """``[rows, count]`` values of span indices ``first ..``: in place,
    from the halo (``h`` wide) across the span's edge, zero past it."""
    rows, m = x.shape
    out = torch.zeros((rows, count), dtype=x.dtype)
    for u in range(count):
        j = first + u
        if 0 <= j < m:
            out[:, u] = x[:, j]
        elif halo is not None and before and -h <= j < 0:
            out[:, u] = halo[:, h + j]
        elif halo is not None and not before and 0 <= j - m < h:
            out[:, u] = halo[:, j - m]
    return out


def windows(tile: torch.Tensor, width: int) -> torch.Tensor:
    """``[rows, 32, width]``: lane i's values ``RUN i .. RUN i + width - 1``
    of a staged tile."""
    idx = RUN * torch.arange(32)[:, None] + torch.arange(width)
    return tile[:, idx]


def walk(local: int):
    """``(warp, t0, cnt)`` of every tile of a shard, warp by warp."""
    warps, per = parts(local)
    for w in range(warps):
        start, end = min(w * per, local), min(w * per + per, local)
        for t0 in range(start, end, TILE):
            yield w, t0, min(TILE, end - t0)


def lane_sum(err: torch.Tensor) -> torch.Tensor:
    """``[rows, 32, lags]`` f32 → ``[rows, lags]``: the warp's 32 lane sums
    added in f32 by a butterfly (five levels)."""
    while err.shape[1] > 1:
        half = err.shape[1] // 2
        err = err[:, :half] + err[:, half:]
    return err[:, 0]


def autocorr_model(xw: torch.Tensor, max_lag: int, n_seq: int, halo=None,
                   shard0: int = 0, n: int | None = None,
                   flush: int = FLUSH) -> torch.Tensor:
    """The kernel's f32 autocorrelation: ``[rows, n_seq, max_lag + 1]``.
    The exact products' sum (the kernel's tensor-core GEMM) is summed here
    lane by lane in f64, in another order."""
    rows, m = xw.shape
    local = m // n_seq
    n = (shard0 + n_seq) * local if n is None else n
    out = torch.zeros((rows, n_seq, MAXH + 1), dtype=torch.float64)
    lanes = RUN * torch.arange(32)[:, None] + torch.arange(RUN)
    for s in range(n_seq):
        acc = err = folded = None
        last_w, tiles = -1, 0
        for w, t0, cnt in walk(local):
            if w != last_w:
                if acc is not None:
                    folded += lane_sum(err).double()
                    out[:, s] += acc.sum(1) - folded
                acc = torch.zeros((rows, 32, MAXH + 1), dtype=torch.float64)
                err = torch.zeros((rows, 32, MAXH + 1), dtype=torch.float32)
                folded = torch.zeros((rows, MAXH + 1), dtype=torch.float64)
                last_w, tiles = w, 0
            j0 = s * local + t0
            tile = staged(xw, halo, max_lag, j0, TILE + MAXH, False)
            glob = shard0 * local + j0 + torch.arange(TILE + MAXH)
            tile = torch.where(glob <= n - 2, tile, torch.zeros_like(tile))
            win = windows(tile, RUN + MAXH)          # [rows, 32, 40]
            a = torch.where(lanes < cnt, win[..., :RUN],
                            torch.zeros_like(win[..., :RUN]))
            for c in range(RUN + MAXH):
                b = win[..., c]
                for r in range(RUN):
                    lag = c - r
                    if 0 <= lag <= MAXH:
                        exact = a[..., r].double() * b.double()
                        acc[..., lag] = acc[..., lag] + exact
                        # e = fma(a, b, -fl(a b)): exact in f32
                        e = (exact - (a[..., r] * b).double()).float()
                        err[..., lag] = err[..., lag] + e
            tiles += 1
            if tiles * RUN == flush:
                folded += lane_sum(err).double()
                err.zero_()
                tiles = 0
        folded += lane_sum(err).double()
        out[:, s] += acc.sum(1) - folded
    return out[..., :max_lag + 1]


def fixed_model(x: torch.Tensor, n_seq: int, halo=None,
                shard0: int = 0) -> torch.Tensor:
    """The kernel's fixed-order sums: ``[rows, n_seq, 5]`` int64."""
    rows, m = x.shape
    local = m // n_seq
    bits = 8 * x.element_size()
    out = torch.zeros((rows, n_seq, 5), dtype=torch.int64)
    lanes = RUN * torch.arange(32)[:, None] + torch.arange(RUN)
    for s in range(n_seq):
        for _, t0, cnt in walk(local):
            j0 = s * local + t0
            win = windows(staged(x, halo, 4, j0 - 4, TILE + 4, True),
                          RUN + 4)                    # [rows, 32, 12]
            p = win[..., :4]
            e1, e0 = p[..., 2] - p[..., 1], p[..., 1] - p[..., 0]
            d = [p[..., 3], p[..., 3] - p[..., 2]]
            d += [d[1] - e1, d[1] - e1 - (e1 - e0)]
            jg = (shard0 + s) * local + t0 + lanes
            for r in range(RUN):
                v = [win[..., 4 + r]]
                for o in range(1, 5):
                    v.append(v[-1] - d[o - 1])
                d = v[:4]
                for o in range(5):
                    zz = (v[o] << 1) ^ (v[o] >> (bits - 1))
                    keep = (lanes[:, r] < cnt) & (jg[:, r] >= o)
                    out[:, s, o] += (zz.long() * keep).sum(1)
    return out


def lpc_model(x: torch.Tensor, taps: torch.Tensor, shift: torch.Tensor,
              order: torch.Tensor, n_seq: int, halo=None, shard0: int = 0):
    """The kernel's LPC statistics: ``(zz_sum, maxabs)`` ``[rows, n_seq]``."""
    rows, m = x.shape
    t = taps.shape[-1]
    local = m // n_seq
    zsum = torch.zeros((rows, n_seq), dtype=torch.int64)
    amax = torch.zeros((rows, n_seq), dtype=torch.int64)
    lanes = RUN * torch.arange(32)[:, None] + torch.arange(RUN)
    for row in range(rows):
        nz = torch.nonzero(taps[row]).flatten()
        ntaps = int(nz[-1]) + 1 if len(nz) else 0
        tb = next(b for b in BUCKETS if ntaps <= b)
        tp = torch.zeros(tb, dtype=torch.int64)
        tp[:min(t, tb)] = taps[row, :tb].long()
        xr, hr = x[row:row + 1], None if halo is None else halo[row:row + 1]
        for s in range(n_seq):
            for _, t0, cnt in walk(local):
                j0 = s * local + t0
                win = windows(staged(xr, hr, t, j0 - tb, TILE + tb, True),
                              tb + RUN)[0].long()     # [32, tb + RUN]
                jg = (shard0 + s) * local + t0 + lanes
                for r in range(RUN):
                    acc = torch.zeros(32, dtype=torch.int64)
                    for c in range(tb + RUN - 1):
                        k = r - 1 - (c - tb)
                        if 0 <= k < tb:
                            acc += tp[k] * win[:, c]
                    res = win[:, tb + r] - (acc >> int(shift[row]))
                    keep = (lanes[:, r] < cnt) & (jg[:, r] >= order[row])
                    zz = ((res << 1) ^ (res >> 63)) * keep
                    zsum[row, s] += zz.sum()
                    amax[row, s] = max(int(amax[row, s]),
                                       int((res.abs() * keep).max()))
    return zsum, amax


@pytest.fixture(scope="module")
def data():
    """Tonal 16-bit rows, windowed in f64 and f32, taps with trailing zeros
    (so the buckets differ from ``t``), shifts and orders."""
    rng = np.random.default_rng(0x5EC)
    pcm = make_pcm(rng, N * ROWS, 1, 16, "tonal")[:, 0].reshape(ROWS, N)
    w = tukey_window_np(N)
    taps = rng.integers(-16, 16, size=(ROWS, 32)).astype(np.int32)
    taps[0, 5:] = 0                   # bucket 8
    taps[1, 13:] = 0                  # bucket 16
    shift = rng.integers(0, 6, size=ROWS).astype(np.int32)
    order = np.array([5, 13, 32], np.int32)
    return {"x": pcm.astype(np.int32), "xw": pcm * w,
            "xw32": (pcm * w).astype(np.float32), "taps": taps,
            "shift": shift, "order": order}


def fx_call(fn, mesh, *arrays):
    """flacx's sharded function on ``mesh`` (the data split by rows and
    samples, the rest by rows)."""
    def put(a, spec):
        return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))
    args = [put(arrays[0], P("frames", "seq"))]
    args += [put(a, P("frames", *(None,) * (a.ndim - 1)))
             for a in arrays[1:]]
    return jax.jit(lambda *v: fn(*v, mesh))(*args)


def fx_mesh(n_data: int, n_seq: int):
    if len(jax.devices()) < n_data * n_seq:
        pytest.skip("needs 8 JAX devices")
    return fx_seqshard.seq_mesh(n_data, n_seq)


def test_parts_cover_every_shard_once():
    for local in (4, 5, 100, 255, 256, 257, 1000, 2048, 4096, 32768):
        warps, per = parts(local)
        assert 1 <= warps <= MAXWARPS and per % TILE == 0
        covered = [t0 + i for _, t0, cnt in walk(local) for i in range(cnt)]
        assert covered == list(range(local)), local


@pytest.mark.parametrize("n_seq", [1, 8])
def test_autocorr_model_matches_flacx(data, n_seq):
    xw = data["xw32"]
    mesh = fx_mesh(1, n_seq)
    want = np.asarray(fx_call(
        lambda v, mesh: fx_seqshard.autocorrelate_sharded(
            v, 32, mesh), mesh, xw))
    got = autocorr_model(torch.from_numpy(xw), 32, n_seq)
    np.testing.assert_allclose(got.sum(1).numpy(), want, rtol=1e-12,
                               atol=1e-6)
    plain = k_seq.seq_autocorr_plain(torch.from_numpy(xw), 32, n_seq)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-12,
                               atol=1e-6)


@pytest.mark.parametrize("n_seq", [1, 4])
def test_fixed_model_matches_flacx(data, n_seq):
    x = data["x"]
    mesh = fx_mesh(1, n_seq)
    want = np.asarray(fx_call(
        lambda v, mesh: fx_seqshard.fixed_order_zz_sums_sharded(
            v, mesh), mesh, x))
    got = fixed_model(torch.from_numpy(x), n_seq)
    np.testing.assert_array_equal(got.sum(1).numpy(), want)
    assert torch.equal(got, k_seq.seq_fixed_plain(torch.from_numpy(x),
                                                  n_seq))


@pytest.mark.parametrize("n_seq", [1, 4])
def test_lpc_model_matches_flacx(data, n_seq):
    x, taps, shift, order = (data[k] for k in ("x", "taps", "shift",
                                               "order"))
    mesh = fx_mesh(1, n_seq)
    fx_zz, fx_mx = fx_call(
        lambda v, tp, sh, od, mesh: fx_seqshard.lpc_zz_stats_sharded(
            v, tp, sh, od, mesh), mesh, x, taps, shift,
        order)
    args = [torch.from_numpy(a) for a in (x, taps, shift, order)]
    zz, mx = lpc_model(*args, n_seq)
    np.testing.assert_array_equal(zz.sum(1).numpy(), np.asarray(fx_zz))
    np.testing.assert_array_equal(mx.amax(1).numpy(),
                                  np.asarray(fx_mx).astype(np.int64))
    want = k_seq.seq_lpc_plain(*args, n_seq)
    assert torch.equal(zz, want[0]) and torch.equal(mx, want[1])


#: span edges: (local, n_seq of the span, shard0, extra samples of the row
#: past the span, a halo given)
EDGES = [(100, 3, 2, 37, True),     # local not a multiple of the run
         (32, 2, 1, 0, False),      # local equal to the halo, row's end
         (300, 2, 3, 500, True),    # two tiles a shard, n past the span
         (4, 5, 0, 9, True)]        # fixed: a shard of four samples


@pytest.mark.parametrize("local,n_seq,shard0,extra,with_halo", EDGES)
def test_models_equal_plain_at_span_edges(local, n_seq, shard0, extra,
                                          with_halo):
    """Halos in place, across the span's edge and absent; the row's end
    past the span; every model equals the plain version's partials."""
    rng = np.random.default_rng(local + shard0)
    m = local * n_seq
    row = rng.integers(-30000, 30000, size=(2, m + 80)).astype(np.int32)
    x = torch.from_numpy(row[:, 40:40 + m].copy())
    before = torch.from_numpy(row[:, :40].copy())
    after = torch.from_numpy(row[:, 40 + m:].copy())
    lag = min(32, local)
    n = (shard0 + n_seq) * local + extra
    xw = (x.double() * 0.37).float()
    aw = (after.double() * 0.37).float()[:, :lag] if with_halo else None
    want = k_seq.seq_autocorr_plain(xw, lag, n_seq, aw, shard0, n)
    np.testing.assert_allclose(
        autocorr_model(xw, lag, n_seq, aw, shard0, n).numpy(), want.numpy(),
        rtol=1e-12, atol=1e-6)
    hb = before[:, 36:].contiguous() if with_halo else None
    for xi, hi in ((x, hb), (x.long(), None if hb is None else hb.long())):
        assert torch.equal(fixed_model(xi, n_seq, hi, shard0),
                           k_seq.seq_fixed_plain(xi, n_seq, hi, shard0))
    t = min(7, local)
    taps = torch.from_numpy(rng.integers(-200, 200, (2, t)).astype(np.int32))
    taps[1, t - 2:] = 0                              # trailing zeros
    shift = torch.tensor([3, 0], dtype=torch.int32)
    order = torch.tensor([t, 0], dtype=torch.int32)
    hl = before[:, 40 - t:].contiguous() if with_halo else None
    got = lpc_model(x, taps, shift, order, n_seq, hl, shard0)
    want = k_seq.seq_lpc_plain(x, taps, shift, order, n_seq, hl, shard0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("signal", ["alternating", "noise"])
def test_split_sum_within_its_bound(signal):
    """On cancelling rows the split sum stays within (64 + 5) 2^-48 of
    ``Σ|products|`` a fold (plus the f64 sums' rounding) of the exact sum
    of the rounded f32 products, and within the chip's tolerance of the
    plain version: ``rtol 1e-12`` plus ``1e-12`` of the lag-0 sum."""
    rng = np.random.default_rng(7)
    n = 8192                      # 64 samples a lane: one fold a warp
    mag = 1000 * (1 + 0.01 * rng.standard_normal((2, n)))
    sign = ((-1.0) ** np.arange(n) if signal == "alternating"
            else rng.choice([-1.0, 1.0], (2, n)))
    xw = torch.from_numpy((mag * sign).astype(np.float32))
    got = autocorr_model(xw, 32, 1)[:, 0]
    plain = k_seq.seq_autocorr_plain(xw, 32, 1)[:, 0]
    v = xw.numpy().astype(np.float64)
    for r in range(2):
        for lag in range(33):
            a, b = v[r, :n - 1 - lag], v[r, lag:n - 1]
            prods = (a.astype(np.float32) * b.astype(np.float32)).astype(
                np.float64)
            exact = math.fsum(prods.tolist())
            total = float(np.abs(prods).sum())
            bound = (69 * 2.0 ** -48 + n * 2.0 ** -53) * total
            assert abs(float(got[r, lag]) - exact) <= bound, (r, lag)
            if lag and signal == "noise":
                assert abs(exact) < 0.2 * total   # the sums cancel
    err = (got - plain).abs()
    assert bool((err <= 1e-12 * plain.abs()
                 + 1e-12 * plain[:, :1].abs()).all())
