"""The nine CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA card and skip without one (the CUDA
kernels have no CPU mode).  Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Shapes here are the edges the main paths do not reach: rows that end
mid-tile, silence, the widest lags, every predictor order, zigzag rows
past every Rice code cap, the general slot layout at finest partitions of
36, 18 and 16 samples, and the hi-res routes: the wide MAC with sums past
2^31, the Rice tree at partitions of 1, 2, 3 and 9 samples over many
segments, and 5.1 frames past 200 KB; the frame packer's chunk edges
(words shared by two chunks, chunk totals on and off a 32-bit word,
blocks the chunk size does not divide, chunks with no bits, 32-bit
symbols, a batch of one frame); the residual written with its stats (res
mode); ``analysis`` under 1-5 windows at the segment edges, bit for
bit from call to call; ``lpc_residual`` in every tap bucket over one
to eight segments a row; the all-orders MAC's limb split at its
edges (two
tap limbs, the int32 bound met exactly, the M and K tile edges, rows
shorter than a tile, full-scale 25-bit rows) and the Rice search's
(nonpositive counts, sums that wrap uint32); the decode kernels on
frames the encoder writes at blocks 192 to 16384 and 1 to 8 channels,
escapes of 0 and 7 bits and a 70-bit Rice quotient (the error flag),
``bit_unpack`` blocks whose staged span crosses subframes and frames of
unequal length, with checkpoints past the row's end and before the span,
reconstruction from arbitrary inputs at orders 0-32 in every tap bucket
on both routes and working types, the chunk route from int64 state (past
±2^31, a side channel near ±2^32; refused on the int32 type), the
all-fixed route at block 16384 on
1-8 channels with integrations that wrap and on blocks of 1, 3 and 4097
samples at every integration count, a chunk-route batch of the
headline's size (288 blocks), and CRC-16 rows of every length mod 4 up to
295,168 bytes with one corrupted; conformance mode's
``reference_lpc`` (f64 compared as bits) at orders 1-32, precisions 5 and
15, over rows of zeros, constants and full-scale alternation, its
``floor_log2`` on the values just under powers of two, and
``abs_residual_sums`` on both MACs, every tap bucket and one to three
segments a row, and the conformance encode against the plain CPU path.
Integers must match
exactly; the
autocorrelation within rtol 1e-9 (f64 sums of the same f32 products in
another order; 1e-12 for f64 products) or that factor of autoc[0] near
zero.
"""

import numpy as np
import pytest
import torch

from flacx_torch import trace
from flacx_torch.encoder import EncoderConfig
from flacx_torch.format import FIXED_PREDICTOR_TAPS
from flacx_torch.kernels import analysis as k_an
from flacx_torch.kernels import bit_unpack as k_bu
from flacx_torch.kernels import crc16_rows as k_crc
from flacx_torch.kernels import frame_pack as k_fp
from flacx_torch.kernels import lpc_allorder as k_la
from flacx_torch.kernels import lpc_residual as k_lr
from flacx_torch.kernels import reconstruct as k_rec
from flacx_torch.kernels import rice_stats as k_rs
from flacx_torch.ops import emit, rice
from flacx_torch.ops.headers import frame_header_symbols

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def counted():
    """Every test counts the hand kernels' launches (:func:`launches`)."""
    with trace.recording():
        yield


def launches(name: str) -> int:
    """Launches of hand kernel ``name`` counted so far."""
    return trace.snapshot()["counters"].get("launch." + name, 0)


def rows(seed: int, r: int, n: int, bits: int = 17) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = (np.sin(t[None] * rng.uniform(0.001, 0.2, (r, 1)))
         * rng.uniform(0, 2 ** (bits - 2), (r, 1))
         + rng.standard_normal((r, n)) * rng.uniform(0, 300, (r, 1)))
    x = x.astype(np.int32)
    x[0] = 0                                        # silence
    x[1] = np.where(t % 2, 2 ** (bits - 1) - 1, -2 ** (bits - 1))
    return x


@pytest.mark.parametrize("n,max_lag", [(4608, 12), (1000, 32), (1025, 0),
                                       (64, 5)])
def test_analysis_kernel(dev, n, max_lag):
    x = torch.from_numpy(rows(1, 9, n)).to(dev)
    w = torch.rand(n, generator=torch.Generator().manual_seed(n)).to(dev)
    autoc, fsums = k_an.analysis(x, w, max_lag)
    ref_a, ref_f = k_an.analysis_plain(x, w, max_lag)
    torch.cuda.synchronize()
    assert torch.equal(fsums, ref_f)
    tol = 1e-9 * ref_a.abs() + 1e-12 * ref_a[..., :1].abs()
    assert bool(((autoc - ref_a).abs() <= tol).all())


@pytest.mark.parametrize("n,max_lag", [(4608, 12), (4608, 32), (1000, 12),
                                       (1000, 32), (64, 12), (64, 32)])
def test_analysis_kernel_f64(dev, n, max_lag):
    x = torch.from_numpy(rows(5, 9, n)).to(dev)
    w = torch.rand(n, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(n)).to(dev)
    autoc, fsums = k_an.analysis(x, w, max_lag)
    ref_a, ref_f = k_an.analysis_plain(x, w, max_lag)
    later, none = k_an.analysis(x, w, max_lag, fixed_sums=False)
    torch.cuda.synchronize()
    assert torch.equal(fsums, ref_f) and none is None
    tol = 1e-12 * (ref_a.abs() + ref_a[..., :1].abs())
    assert bool(((autoc - ref_a).abs() <= tol).all())
    assert torch.equal(later, autoc)


@pytest.mark.parametrize("max_lag", [0, 12, 32])
@pytest.mark.parametrize("n", [64, 1152, 2304, k_an.SEG_MAX - 1,
                               k_an.SEG_MAX, k_an.SEG_MAX + 1, 16384])
def test_analysis_kernel_windows(dev, n, max_lag):
    """1, 3, 4 and 5 windows ``[W, n]``, each call one launch, f32 and f64,
    on rows of one pass or less, on either side of a segment, and of several
    segments: each window's lags within tolerance of the plain version,
    the fixed sums exact, and two calls equal bit for bit (the segments'
    partials add in a fixed order)."""
    x = torch.from_numpy(rows(9, 6, n)).to(dev)
    gen = torch.Generator().manual_seed(n + max_lag)
    for dtype in (torch.float32, torch.float64):
        for nwin in (1, 3, 4, 5):
            w = torch.rand((nwin, n), dtype=dtype, generator=gen).to(dev)
            before = launches("analysis")
            autoc, fsums = k_an.analysis(x, w, max_lag)
            again = k_an.analysis(x, w, max_lag)
            ref_a, ref_f = k_an.analysis_plain(x, w, max_lag)
            torch.cuda.synchronize()
            assert launches("analysis") - before == 2
            assert autoc.shape == (6, nwin, max_lag + 1)
            assert torch.equal(autoc, again[0])
            assert torch.equal(fsums, again[1])
            assert torch.equal(fsums, ref_f)
            rtol = 1e-9 if dtype == torch.float32 else 1e-12
            tol = rtol * ref_a.abs() + 1e-12 * ref_a[..., :1].abs()
            assert bool(((autoc - ref_a).abs() <= tol).all()), (dtype, nwin)


#: one row count of taps in each of the kernel's MAC buckets (0, 4, 8, 12,
#: 16, 24, 32), some padded by the bucket
BUCKET_TAPS = (0, 3, 8, 11, 16, 20, 32)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("n,r", [(1152, 1024), (4608, 14), (16384, 14)])
def test_lpc_residual_kernel_buckets(dev, n, r, wide):
    """Every mode on rows in every tap bucket: 1024 rows of 1152 (the best
    path's shape), rows of two segments (4608) and of eight (16384), the
    int32 MAC on 17-bit rows and the wide one on 25-bit rows with
    precision-15 taps; a warm-up past the first segment boundary (the
    mask takes the row position).  Each wrapper counts one launch."""
    bits, tmax = (25, 1 << 14) if wide else (17, 6)
    bound = (bits, 32 * tmax)
    assert (k_lr.mac_width(*bound) == "wide") == wide
    x = torch.from_numpy(rows(13, r, n, bits=bits)).to(dev)
    rng = np.random.default_rng(n + r + bits)
    nt = np.resize(BUCKET_TAPS, r)
    taps = rng.integers(-tmax, tmax, (r, 32)).astype(np.int32)
    taps[np.arange(32) >= nt[:, None]] = 0
    taps[nt > 0, nt[nt > 0] - 1] = tmax - 1       # the last tap nonzero
    order = nt.astype(np.int32)
    order[7] = min(n - 1, k_lr.segment_size(n) + 96)
    shift = rng.integers(0, 16, r).astype(np.int32)
    args = [x] + [torch.from_numpy(a).to(dev) for a in (taps, shift, order)]
    for mode in ("stats", "zz") + (() if wide else ("res",)):
        fn = getattr(k_lr, f"lpc_residual_{mode}")
        before = launches(fn.__name__)
        got = fn(*args, *bound)
        ref = getattr(k_lr, f"lpc_residual_{mode}_plain")(*args, *bound)
        torch.cuda.synchronize()
        assert launches(fn.__name__) == before + 1
        got, ref = ((v if isinstance(v, tuple) else (v,)) for v in (got, ref))
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), mode


@pytest.mark.parametrize("p", [1, 12, 16, 17, 32])
def test_lpc_allorder_kernel(dev, p):
    """N = 777 (no tile multiple), a silent and a full-scale alternating
    17-bit row, every order 1..P at precision 5 (P = 16 and 17 on either
    side of one M tile and a 16-deep K)."""
    allorder_case(dev, rows(6, 10, 777), p, 5, 17)


@pytest.mark.parametrize("eff_bps,p,prec", [(13, 4, 15), (24, 4, 4),
                                            (17, 12, 9)])
def test_lpc_allorder_kernel_int32_limbs(dev, eff_bps, p, prec):
    """Under the int32 bound: precision-15 taps (a high tap limb) with
    eff_bps + 1 + bitlen(sum |taps|) = 13 + 1 + 17 = 31, full-scale 24-bit
    rows at 24 + 1 + 6 = 31, and precision 9 (taps just past one limb)."""
    assert eff_bps + 1 + (p << (prec - 1)).bit_length() <= 31
    allorder_case(dev, rows(11, 10, 1000, bits=eff_bps), p, prec, eff_bps)


@pytest.mark.parametrize("n", [1, 7, 8, 15])
def test_lpc_allorder_kernel_short_rows(dev, n):
    """Rows shorter than a tile of 8 samples or two, at P = 12 and 32."""
    for p in (12, 32):
        allorder_case(dev, rows(12, 6, n), p, 5, 17)


@pytest.mark.parametrize("p", [12, 32])
def test_lpc_allorder_kernel_wide_extremes(dev, p):
    """Rows of -2^24 and 2^24 - 1 (eff_bps 25, four sample limbs) with
    every tap -2^14, shift 0: the largest sums the int64 combine meets."""
    n, r = 1000, 4
    x = np.full((r, n), -(1 << 24), np.int32)
    x[1] = (1 << 24) - 1
    x[2] = np.where(np.arange(n) % 2, (1 << 24) - 1, -(1 << 24))
    x[3, ::3] = (1 << 24) - 1
    qcoefs = np.full((r, p, p), -(1 << 14), np.int32)
    qcoefs *= np.arange(p) < np.arange(1, p + 1)[:, None]
    shifts = np.zeros((r, p), np.int32)
    got, ref = allorder_pair(dev, x, qcoefs, shifts, 25, p << 14)
    assert k_lr.mac_width(25, p << 14) == "wide"
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert int(ref[1].max()) == (1 << 31) - 1


def allorder_pair(dev, x, qcoefs, shifts, eff_bps, sum_taps_max):
    args = [torch.from_numpy(a).to(dev) for a in (x, qcoefs, shifts)]
    got = k_la.lpc_allorder(*args, eff_bps, sum_taps_max)
    ref = k_la.lpc_allorder_plain(*args, eff_bps, sum_taps_max)
    torch.cuda.synchronize()
    return got, ref


def allorder_case(dev, x, p, prec, eff_bps):
    """Every order 1..P of ``x`` at ``prec``-bit taps (one row at the tap
    extremes), the kernel against its plain version."""
    r = x.shape[0]
    rng = np.random.default_rng(p + prec + x.shape[-1])
    h = 1 << (prec - 1)
    qcoefs = rng.integers(-h, h, (r, p, p)).astype(np.int32)
    qcoefs[min(2, r - 1)] = np.where(np.arange(p) % 2, h - 1, -h)
    qcoefs *= np.arange(p) < np.arange(1, p + 1)[:, None]
    shifts = rng.integers(0, 16, (r, p)).astype(np.int32)
    got, ref = allorder_pair(dev, x, qcoefs, shifts, eff_bps, p << (prec - 1))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("n,ntaps", [(4608, 12), (777, 32), (40, 4)])
def test_lpc_residual_kernel(dev, n, ntaps):
    r = 12
    x = torch.from_numpy(rows(2, r, n)).to(dev)
    rng = np.random.default_rng(n)
    order = rng.integers(0, ntaps + 1, r).astype(np.int32)
    taps = rng.integers(-16, 16, (r, ntaps)).astype(np.int32)
    taps[np.arange(ntaps) >= order[:, None]] = 0
    taps[2, :4] = FIXED_PREDICTOR_TAPS[4]
    order[2] = max(order[2], 4)
    taps[3], order[3] = 0, ntaps       # the MAC runs to the last nonzero tap
    taps[3, -1] = 7
    shift = rng.integers(0, 16, r).astype(np.int32)
    args = [x] + [torch.from_numpy(a).to(dev) for a in (taps, shift, order)]
    bound = (17, 16 * 32)
    got = k_lr.lpc_residual_stats(*args, *bound)
    ref = k_lr.lpc_residual_stats_plain(*args, *bound)
    zz = k_lr.lpc_residual_zz(*args, *bound)
    ref_zz = k_lr.lpc_residual_zz_plain(*args, *bound)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert torch.equal(zz, ref_zz)


@pytest.mark.parametrize("n,ntaps,tap_max", [(1152, 12, 16), (777, 32, 6),
                                             (40, 4, 16), (3000, 1, 16)])
def test_lpc_residual_kernel_res_mode(dev, n, ntaps, tap_max):
    """The residual written with its stats, under the int32 gate (17-bit
    rows, Σ|taps| ≤ 192): rows ending mid-tile, every order up to 32, the
    fixed predictor, a row whose only tap is its last."""
    r = 12
    x = torch.from_numpy(rows(3, r, n)).to(dev)
    rng = np.random.default_rng(n + ntaps)
    order = rng.integers(0, ntaps + 1, r).astype(np.int32)
    taps = rng.integers(-tap_max, tap_max + 1, (r, ntaps)).astype(np.int32)
    taps[np.arange(ntaps) >= order[:, None]] = 0
    if ntaps >= 4:
        taps[2, :4] = FIXED_PREDICTOR_TAPS[4]
        order[2] = max(order[2], 4)
    taps[3], order[3] = 0, ntaps
    taps[3, -1] = -tap_max
    shift = rng.integers(0, 16, r).astype(np.int32)
    args = [x] + [torch.from_numpy(a).to(dev) for a in (taps, shift, order)]
    bound = (17, 192)
    assert np.abs(taps).sum(-1).max() <= 192
    before = launches("lpc_residual_res")
    got = k_lr.lpc_residual_res(*args, *bound)
    ref = k_lr.lpc_residual_res_plain(*args, *bound)
    torch.cuda.synchronize()
    assert launches("lpc_residual_res") == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert torch.equal(rice.zigzag(got[0]),
                       k_lr.lpc_residual_zz(*args, *bound))


@pytest.mark.parametrize("p,n", [(1, 777), (12, 4608), (12, 1152),
                                 (32, 777)])
def test_lpc_allorder_kernel_wide(dev, p, n):
    """25-bit rows and precision-15 taps (past the int32 MAC bound):
    every order's sums exact where |res| passes 2^31, max |res| clamped."""
    r = 10
    x = torch.from_numpy(rows(7, r, n, bits=25)).to(dev)
    rng = np.random.default_rng(p + n)
    qcoefs = rng.integers(-(1 << 14), 1 << 14, (r, p, p)).astype(np.int32)
    qcoefs[1] = np.where(np.arange(p) % 2, (1 << 14) - 1, -(1 << 14))
    qcoefs *= np.arange(p) < np.arange(1, p + 1)[:, None]
    shifts = rng.integers(0, 16, (r, p)).astype(np.int32)
    shifts[1] = 0
    args = [x] + [torch.from_numpy(a).to(dev) for a in (qcoefs, shifts)]
    bound = (25, p << 14)
    assert k_lr.mac_width(*bound) == "wide"
    got = k_la.lpc_allorder(*args, *bound)
    ref = k_la.lpc_allorder_plain(*args, *bound)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert int(ref[1].max()) == (1 << 31) - 1


@pytest.mark.parametrize("n,ntaps", [(1777, 32), (16384, 32)])
def test_lpc_residual_kernel_wide(dev, n, ntaps):
    """25-bit rows, precision-15 taps: the int64 MAC, whose sums pass
    2^31 on the full-scale rows (maxabs clamps to 2^31 - 1)."""
    r = 12
    x = torch.from_numpy(rows(8, r, n, bits=25)).to(dev)
    rng = np.random.default_rng(n + 1)
    order = rng.integers(0, ntaps + 1, r).astype(np.int32)
    order[1] = ntaps
    taps = rng.integers(-(1 << 14), 1 << 14, (r, ntaps)).astype(np.int32)
    taps[1] = np.where(np.arange(ntaps) % 2, (1 << 14) - 1, -(1 << 14))
    taps[np.arange(ntaps) >= order[:, None]] = 0
    taps[3], order[3] = 0, ntaps       # the MAC runs to the last nonzero tap
    taps[3, -1] = -(1 << 14)
    taps[4, ::2] = 0                   # and over interior zeros
    shift = rng.integers(0, 16, r).astype(np.int32)
    shift[1] = 0
    args = [x] + [torch.from_numpy(a).to(dev) for a in (taps, shift, order)]
    bound = (25, 32 << 14)
    assert k_lr.mac_width(*bound) == "wide"
    got = k_lr.lpc_residual_stats(*args, *bound)
    ref = k_lr.lpc_residual_stats_plain(*args, *bound)
    zz = k_lr.lpc_residual_zz(*args, *bound)
    ref_zz = k_lr.lpc_residual_zz_plain(*args, *bound)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert torch.equal(zz, ref_zz)
    assert int(ref[1].max()) == (1 << 31) - 1


@pytest.mark.parametrize("n,porders,kmax,c", [
    (4096, tuple(range(13)), 30, 2), (8192, tuple(range(13)), 30, 2),
    (12288, tuple(range(13)), 30, 2), (3072, (0, 4, 9, 10), 30, 4),
    (16384, tuple(range(15)), 30, 2), (4096, (0, 12), 3, 2)])
def test_rice_stats_kernel_levels_route(dev, n, porders, kmax, c):
    """Partitions of 1, 2 and 3 samples, sparse levels on four channels,
    the hi-res shape (orders 0..14 at 16384) and kmax 3: rows cut into
    segments, the coarse levels finished by each row's last block."""
    assert k_rs.segment_log2(n, max(porders), kmax) > 0
    rice_stats_case(dev, n, porders, kmax, c)


@pytest.mark.parametrize("n,porders,kmax,c", [
    (4608, (0, 1, 2, 3, 4, 5), 23, 2), (4096, (0, 2, 7), 30, 2),
    (1152, (3,), 0, 2), (1152, (0, 1, 2, 3, 4, 5), 23, 4)])
def test_rice_stats_kernel(dev, n, porders, kmax, c):
    """One segment a row.  The last case is the best path at block 1152:
    the four virtual channels, finest partitions of 36 samples."""
    assert k_rs.segment_log2(n, max(porders), kmax) == 0
    rice_stats_case(dev, n, porders, kmax, c)


@pytest.mark.parametrize("porders,kmax", [(tuple(range(11)), 30),
                                          ((0, 2, 4, 6, 8), 23)])
def test_rice_stats_kernel_block_9216(dev, porders, kmax):
    """Block 9216 (9 x 1024): 9-sample partitions staged over segments,
    and 36-sample ones a warp each."""
    rice_stats_case(dev, 9216, porders, kmax, 2)


@pytest.mark.parametrize("kmax", [30, 14, 1, 0])
def test_rice_stats_kernel_search_edges(dev, kmax):
    """Orders 0..12 at one-sample partitions with every predictor order
    0..12 (partition 0's count is 1 - order, nonpositive from order 1),
    and rows of values near 2^31 - 1 (sums that wrap uint32, small k past
    the code-length cap, and the max 2^31 - 1 itself)."""
    n = 4096
    rng = np.random.default_rng(kmax)
    zz = rng.integers(0, 1 << 20, (2, 13, n)).astype(np.int32)
    order = np.tile(np.arange(13, dtype=np.int32), (2, 1))
    zz = np.where(np.arange(n) < order[..., None], 0, zz).astype(np.int32)
    zz[1, :, 100:400] = (1 << 31) - 1 - rng.integers(0, 5, (13, 300))
    zz[1, 3, 500] = (1 << 31) - 1
    zz[1, 5, :] = (1 << 31) - 2
    rice_stats_equal(dev, zz, order, tuple(range(13)), kmax)


def rice_stats_case(dev, n, porders, kmax, c):
    rng = np.random.default_rng(n)
    scale = 2.0 ** rng.integers(0, 30, size=(6, c, 1))
    zz = np.minimum(rng.exponential(size=(6, c, n)) * scale, 2 ** 30 - 1)
    order = rng.integers(0, 13, size=(6, c)).astype(np.int32)
    zz = np.where(np.arange(n) < order[..., None], 0, zz).astype(np.int32)
    rice_stats_equal(dev, zz, order, porders, kmax)


def rice_stats_equal(dev, zz, order, porders, kmax):
    zt, ot = torch.from_numpy(zz).to(dev), torch.from_numpy(order).to(dev)
    got = k_rs.rice_stats(zt, ot, porders, kmax)
    ref = rice.rice_stats(zt, ot, porders, kmax)
    torch.cuda.synchronize()
    for po in ref:
        assert all(torch.equal(a, b) for a, b in zip(got[po], ref[po])), po


def test_frame_pack_kernel(dev):
    """Every subframe kind, escapes, and multi-byte frame numbers."""
    frame_pack_case(dev, 4608, (0, 1, 2, 3, 4, 5), wasted=False)


@pytest.mark.parametrize("n,porders", [(1152, (0, 1, 2, 3, 4, 5)),
                                       (4608, (0, 2, 5, 8)),
                                       (4096, (0, 3, 8))])
def test_frame_pack_kernel_general_layout(dev, n, porders):
    """Finest partitions of 36, 18 and 16 samples, wasted bits."""
    frame_pack_case(dev, n, porders, wasted=True)


def frame_pack_case(dev, n, porders, wasted):
    b, prec = 6, 5
    psize_min = n >> max(porders)
    assert emit.blocked_layout_ok(n, psize_min) != wasted
    rng = np.random.default_rng(3)
    x = rows(4, b * 2, n, bits=16).reshape(b, 2, n)
    kind = rng.integers(0, 4, (b, 2)).astype(np.int32)
    kind[0] = emit.KIND_FIXED
    x[0, 0] = rng.integers(-32768, 32768, n)        # escapes
    x[kind == emit.KIND_CONSTANT] = 77
    order = np.where(kind >= emit.KIND_FIXED,
                     rng.integers(0, 5, (b, 2)), 0).astype(np.int32)
    order[kind == emit.KIND_LPC] = np.maximum(order[kind == emit.KIND_LPC], 1)
    order[0, 0] = 0
    taps = np.zeros((b, 2, 12), np.int32)
    taps[..., :4] = FIXED_PREDICTOR_TAPS[order]
    shift = np.zeros((b, 2), np.int32)
    w = (rng.integers(0, 4, (b, 2)) * wasted).astype(np.int32)
    w[0, 0] = 0
    x = x >> w[..., None]
    bps = 16 - w
    t = {k: torch.from_numpy(v).to(dev) for k, v in dict(
        x=x, kind=kind, order=order, taps=taps, shift=shift,
        bps=bps, w=w).items()}
    zz = k_lr.lpc_residual_zz_plain(t["x"], t["taps"], t["shift"],
                                    t["order"], 17, 15)
    plan = rice.exact_plan(zz, t["order"], porders, porders, 23)
    hdr = frame_header_symbols(
        torch.tensor([0, 5, 127, 128, 70000, 1 << 33], device=dev),
        torch.tensor([1, 8, 9, 10, 1, 1], dtype=torch.int32, device=dev), n)
    sh_v, sh_l = emit.subframe_header_symbols(
        t["kind"], t["order"], t["bps"], t["x"], t["taps"], t["shift"], prec,
        plan, t["w"])
    pv, pl = emit.partition_param_symbols(t["kind"], plan)
    kesc = (plan.k_seg.int() | (plan.esc_seg.int() << 7)).contiguous()
    args = (hdr.values, hdr.lengths, sh_v, sh_l, pv, pl, zz, t["x"], kesc,
            t["kind"], t["order"], t["bps"], psize_min,
            EncoderConfig(block_size=n).max_frame_bytes)
    before = launches("frame_pack")
    out, length = k_fp.frame_pack(*args)
    ref, ref_len = k_fp.frame_pack_plain(*args)
    torch.cuda.synchronize()
    assert launches("frame_pack") == before + 1
    assert bool(plan.esc_seg.any())
    assert torch.equal(length, ref_len) and torch.equal(out, ref)


@pytest.mark.parametrize("verbatim", [False, True])
def test_frame_pack_kernel_global_route(dev, verbatim):
    """Two 5.1 hi-res frames (6 x 16384 24-bit samples, one-sample
    partitions), packed in device memory; ``verbatim`` makes the first
    frame all verbatim, its largest size."""
    b, c, n, prec = 2, 6, 16384, 5
    porders = tuple(range(15))
    cfg = EncoderConfig(block_size=n, max_lpc_order=32, bps=24, channels=c,
                        partition_orders=porders)
    assert cfg.max_frame_bytes == 295168
    rng = np.random.default_rng(9)
    x = rows(10, b * c, n, bits=24).reshape(b, c, n)
    kind = rng.integers(0, 4, (b, c)).astype(np.int32)
    kind[0, :2] = emit.KIND_FIXED
    if verbatim:
        kind[0] = emit.KIND_VERBATIM
        x[0] = rng.integers(-(1 << 23), 1 << 23, (c, n))
    x[kind == emit.KIND_CONSTANT] = -77
    order = np.where(kind >= emit.KIND_FIXED,
                     rng.integers(0, 5, (b, c)), 0).astype(np.int32)
    order[kind == emit.KIND_LPC] = np.maximum(order[kind == emit.KIND_LPC], 1)
    taps = np.zeros((b, c, 32), np.int32)
    taps[..., :4] = FIXED_PREDICTOR_TAPS[order]
    shift = np.zeros((b, c), np.int32)
    bps = np.full((b, c), 24, np.int32)
    t = {k: torch.from_numpy(v).to(dev) for k, v in dict(
        x=x, kind=kind, order=order, taps=taps, shift=shift,
        bps=bps).items()}
    zz = k_lr.lpc_residual_zz_plain(t["x"], t["taps"], t["shift"],
                                    t["order"], 24, 15)
    plan = rice.exact_plan(zz, t["order"], porders, porders, cfg.kmax)
    hdr = frame_header_symbols(
        torch.tensor([3, 70000], device=dev),
        torch.tensor([5, 5], dtype=torch.int32, device=dev), n)
    sh_v, sh_l = emit.subframe_header_symbols(
        t["kind"], t["order"], t["bps"], t["x"], t["taps"], t["shift"], prec,
        plan)
    pv, pl = emit.partition_param_symbols(t["kind"], plan)
    kesc = (plan.k_seg.int() | (plan.esc_seg.int() << 7)).contiguous()
    args = (hdr.values, hdr.lengths, sh_v, sh_l, pv, pl, zz, t["x"], kesc,
            t["kind"], t["order"], t["bps"], 1, cfg.max_frame_bytes)
    out, length = k_fp.frame_pack(*args)
    ref, ref_len = k_fp.frame_pack_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(length, ref_len) and torch.equal(out, ref)
    assert (int(length[0]) > 200 * 1024) == verbatim


def frame_pack_inputs(dev, b, c, n, porders, bits=16, kind=None, seed=3,
                      hdr_lengths=None):
    """``frame_pack`` arguments of ``b`` frames of ``c`` channels: random
    subframe kinds (or ``kind``), fixed predictors, exact Rice plans; with
    ``hdr_lengths`` one more frame-header symbol (random bits) of these
    lengths, one a frame."""
    rng = np.random.default_rng(seed)
    x = rows(seed + 1, b * c, n, bits=bits).reshape(b, c, n)
    if kind is None:
        kind = rng.integers(0, 4, (b, c))
        kind[0, 0] = emit.KIND_FIXED
        x[0, 0] = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), n)
    kind = np.asarray(kind, np.int32)
    x[kind == emit.KIND_CONSTANT] = 77
    order = np.where(kind >= emit.KIND_FIXED,
                     rng.integers(0, 5, (b, c)), 0).astype(np.int32)
    order[kind == emit.KIND_LPC] = np.maximum(order[kind == emit.KIND_LPC], 1)
    taps = np.zeros((b, c, 12), np.int32)
    taps[..., :4] = FIXED_PREDICTOR_TAPS[order]
    t = {k: torch.from_numpy(v).to(dev) for k, v in dict(
        x=x, kind=kind, order=order, taps=taps,
        shift=np.zeros((b, c), np.int32),
        bps=np.full((b, c), bits, np.int32)).items()}
    zz = k_lr.lpc_residual_zz_plain(t["x"], t["taps"], t["shift"],
                                    t["order"], bits + 1, 15)
    cfg = EncoderConfig(block_size=n, bps=bits, channels=c,
                        partition_orders=porders)
    plan = rice.exact_plan(zz, t["order"], porders, porders, cfg.kmax)
    hdr = frame_header_symbols(
        torch.arange(b, device=dev) * 70001,
        torch.ones(b, dtype=torch.int32, device=dev), n)
    hdr_v, hdr_l = hdr.values, hdr.lengths
    if hdr_lengths is not None:
        more = torch.from_numpy(rng.integers(0, 1 << 32, (b, 1))).to(dev)
        hdr_v = torch.cat([hdr_v, more], 1).contiguous()
        hdr_l = torch.cat([hdr_l, torch.tensor(
            hdr_lengths, dtype=torch.int32, device=dev)[:, None]],
            1).contiguous()
    sh_v, sh_l = emit.subframe_header_symbols(
        t["kind"], t["order"], t["bps"], t["x"], t["taps"], t["shift"], 5,
        plan)
    pv, pl = emit.partition_param_symbols(t["kind"], plan)
    kesc = (plan.k_seg.int() | (plan.esc_seg.int() << 7)).contiguous()
    return [hdr_v, hdr_l, sh_v, sh_l, pv, pl, zz, t["x"], kesc, t["kind"],
            t["order"], t["bps"], n >> max(porders), cfg.max_frame_bytes]


def chunk_bits(args) -> np.ndarray:
    """``[B, chunks]`` bits of each chunk of the kernel's slot walk (the
    general layout's order, :data:`k_fp.CHUNK_SLOTS` slots a chunk)."""
    hdr_l, sh_l, pl, zz, x, kesc, kind, order, bps, psize = (
        args[i] for i in (1, 3, 5, 6, 7, 8, 9, 10, 11, 12))
    b, c, n = x.shape
    _, sl = emit.sample_symbols_from(
        kind, order, bps, x, zz, (kesc & 31).repeat_interleave(psize, -1),
        ((kesc >> 7) & 1).bool().repeat_interleave(psize, -1))
    extra, mult = emit.general_layout_tables(n, psize)
    seg = torch.cat([pl[..., mult][..., None],
                     sl.reshape(b, c, n // psize, psize)], -1)
    slots = torch.cat([hdr_l, torch.cat(
        [sh_l, pl[..., extra], seg.reshape(b, c, -1)], -1).reshape(b, -1)],
        -1).long().cpu().numpy()
    pad = -slots.shape[1] % k_fp.CHUNK_SLOTS
    return np.pad(slots, ((0, 0), (0, pad))).reshape(
        b, -1, k_fp.CHUNK_SLOTS).sum(-1)


def frame_pack_equal(args):
    before = launches("frame_pack")
    out, length = k_fp.frame_pack(*args)
    ref, ref_len = k_fp.frame_pack_plain(*args)
    torch.cuda.synchronize()
    assert launches("frame_pack") == before + 1
    assert torch.equal(length, ref_len) and torch.equal(out, ref)


@pytest.mark.parametrize("n,porders,bits,c", [
    (1152, (0, 1, 2, 3, 4, 5), 16, 6), (4096, (0, 3, 8), 16, 2),
    (9216, tuple(range(9)), 16, 2), (16384, tuple(range(15)), 24, 2)])
def test_frame_pack_kernel_chunk_edges(dev, n, porders, bits, c):
    """Blocks whose slot count the chunk size does not divide; a frame
    header symbol sized so that frame 0's first chunk ends on a 32-bit
    word and frame 1's does not (a word then holds bits of two chunks)."""
    kind = [[2, 3] * (c // 2), [2, 1] * (c // 2)]
    args = frame_pack_inputs(dev, 2, c, n, porders, bits, kind=kind,
                             hdr_lengths=[0, 0])
    first = chunk_bits(args)[:, 0]
    args[1][:, -1] = torch.tensor([-first[0] % 32, (13 - first[1]) % 32],
                                  dtype=torch.int32, device=dev)
    bits_ = chunk_bits(args)
    slots = args[1].shape[-1] + c * (args[3].shape[-1] + args[5].shape[-1]
                                     + n)
    assert bits_.shape[1] > 1 and slots % k_fp.CHUNK_SLOTS
    assert bits_[0, 0] % 32 == 0 and bits_[1, 0] % 32 != 0
    frame_pack_equal(args)


def test_frame_pack_kernel_headers_only(dev):
    """Every subframe constant: only the chunks that hold a header carry
    bits."""
    args = frame_pack_inputs(dev, 3, 2, 16384, tuple(range(15)), 24,
                             kind=np.zeros((3, 2)))
    bits_ = chunk_bits(args)
    assert bits_.shape[1] > 4 and ((bits_ > 0).sum(1) == 2).all()
    frame_pack_equal(args)


def test_frame_pack_kernel_full_width_symbols(dev):
    """32-bit symbols: a 24-bit verbatim channel beside escapes at k = 31
    and Rice codes of exactly 32 bits, 32-bit header symbols, in frames
    of several chunks."""
    n, porders = 4608, (0, 1, 2, 3, 4, 5)
    args = frame_pack_inputs(dev, 2, 2, n, porders, 24, kind=[[2, 1], [1, 1]],
                             hdr_lengths=[32, 32])
    rng = np.random.default_rng(5)
    nseg = args[8].shape[-1]
    ks = np.where(np.arange(nseg) % 2, 31 | 128, 20)  # escapes, Rice k = 20
    args[8][0, 0] = torch.from_numpy(ks.astype(np.int32)).to(dev)
    psize = args[12]
    k_sample = np.repeat(ks & 31, psize)
    zz = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    rice_zz = (11 << 20) | (zz & ((1 << 20) - 1))     # 11 + 1 + 20 bits
    zz = np.where(k_sample == 20, rice_zz, zz).astype(np.uint32)
    zz[:int(args[10][0, 0])] = 0
    args[6][0, 0] = torch.from_numpy(zz.view(np.int32)).to(dev)
    assert chunk_bits(args).shape[1] > 1
    frame_pack_equal(args)


@pytest.mark.parametrize("n,porders,bits", [
    (4608, (0, 1, 2, 3, 4, 5), 16), (16384, tuple(range(15)), 24)])
def test_frame_pack_kernel_one_frame(dev, n, porders, bits):
    frame_pack_equal(frame_pack_inputs(dev, 1, 2, n, porders, bits))


# ---------------------------------------------------------------------------
# The decode kernels: bit_unpack, reconstruct, crc16_rows

def staged(dev, frames: list[bytes], n: int, c: int, bps: int, ss: int):
    """Frame bytes staged as the decoder stages them: padded rows, lengths
    and the walker's output (sample state every ``ss``), on ``dev``."""
    from flacx_torch.native import scan_frames

    lens = np.array([len(fr) for fr in frames])
    w = (int(lens.max()) + 255) // 256 * 256
    rows_np = np.zeros((len(frames), w), np.uint8)
    for i, fr in enumerate(frames):
        rows_np[i, :len(fr)] = np.frombuffer(fr, np.uint8)
    scan = scan_frames(rows_np, np.zeros(len(frames), np.int64), n, c, bps,
                       state_interval=ss)
    t = {k: torch.from_numpy(getattr(scan, k)).to(dev) for k in (
        "channel_code", "kind", "order", "shift", "wasted", "po", "width",
        "taps", "warmup", "const_val", "ckpt_pos", "ckpt_param", "ckpt_esc",
        "ckpt_inesc") + (("ckpt_state",) if ss else ())}
    return (torch.from_numpy(rows_np).to(dev),
            torch.from_numpy(lens.astype(np.int32)).to(dev), t, scan)


def unpack_args(rows_t, t, n):
    return (rows_t, t["ckpt_pos"], t["ckpt_param"], t["ckpt_esc"],
            t["ckpt_inesc"], t["kind"], t["order"], t["po"], t["width"], n)


def hold_unpack(args):
    before = launches("bit_unpack")
    got = k_bu.bit_unpack(*args)
    ref = k_bu.bit_unpack_plain(*args)
    torch.cuda.synchronize()
    assert launches("bit_unpack") == before + 1
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    return got


def hold_reconstruct(*args):
    before = launches("reconstruct")
    got = k_rec.reconstruct(*args)
    ref = k_rec.reconstruct_plain(*args)
    torch.cuda.synchronize()
    assert launches("reconstruct") == before + 1
    assert torch.equal(got[1], ref[1])
    assert torch.equal(got[0], ref[0]), (got[0] != ref[0]).nonzero()[:4]


def state_interval(n: int) -> int:
    return 256 if n >= 2048 else max(64, n // 8)


@pytest.mark.parametrize("n,c,bps,lpc", [
    (192, 1, 16, 8), (1152, 2, 16, 12), (4608, 2, 16, 12),
    (16384, 6, 24, 32), (1152, 8, 20, 4), (4608, 2, 24, 32)])
def test_decode_kernels_on_encoded_frames(dev, n, c, bps, lpc):
    """Frames from the port's encoder on the card (silent, full-scale,
    noisy and tonal rows: constant, verbatim, escaped and LPC subframes)
    through all three kernels on both routes and both working types."""
    from flacx_torch.encoder import BatchEncoder

    f = 4
    x = rows(n + c, f * c, n, bits=bps).reshape(f, c, n)
    rng = np.random.default_rng(n)
    x[2, -1, n // 3:n // 3 + 40] = rng.integers(
        -2 ** (bps - 1), 2 ** (bps - 1), 40)          # an escaped burst
    x[3, 0] = rng.integers(-2 ** (bps - 1), 2 ** (bps - 1), n)  # verbatim
    cfg = EncoderConfig(block_size=n, channels=c, bps=bps, max_lpc_order=lpc,
                        qlp_precision=15 if lpc > 12 else 12,
                        sample_rate=96000, partition_orders=tuple(range(6)))
    frames = BatchEncoder(cfg, batch_frames=f, device=dev).encode_frames(
        x, 0)
    for ss in (0, state_interval(n)):
        rows_t, lens, t, scan = staged(dev, frames, n, c, bps, ss)
        vals, err = hold_unpack(unpack_args(rows_t, t, n))
        assert err.item() == 0
        bucket = k_rec.tap_bucket(int(scan.order.max()))
        for use_i32 in (True, False):
            hold_reconstruct(
                vals, t["taps"], t["shift"], t["order"], t["kind"],
                t["wasted"], t["warmup"], t["const_val"], t["channel_code"],
                t.get("ckpt_state"), ss, bucket, use_i32,
                k_rec.residual_limit(bps, use_i32))
    ok, all_ok = k_crc.crc16_rows(rows_t, lens)
    ref = k_crc.crc16_rows_plain(rows_t, lens)
    assert torch.equal(ok, ref[0]) and all_ok.item() == ref[1].item() == 1
    assert set(np.unique(scan.kind)) >= {0, 1, 3}, np.unique(scan.kind)


def handmade_frame(index: int, long_unary: bool) -> bytes:
    """A mono 16-bit frame of 256 samples, fixed order 1, partition order
    2: an escape of 0 bits (zeros), an escape of 7 bits, Rice k = 3 and
    Rice k = 0, whose first quotient is 70 where ``long_unary``."""
    from flacx_torch.bitio import BitWriter
    from flacx_torch.crc import crc8, crc16

    rng = np.random.default_rng(index)
    w = BitWriter()
    for value, bits in ((0xFFF8, 16), (8, 4), (9, 4), (0, 4), (4, 3), (0, 1),
                        (index, 8)):
        w.write_uint(value, bits)
    w.write_uint(crc8(w.getvalue()), 8)
    for value, bits in ((0, 1), (9, 6), (0, 1)):
        w.write_uint(value, bits)
    w.write_sint(-1234, 16)                        # warm-up
    w.write_uint(0, 2)
    w.write_uint(2, 4)
    w.write_uint(15, 4)
    w.write_uint(0, 5)                              # escape of 0 bits
    w.write_uint(15, 4)
    w.write_uint(7, 5)
    for v in rng.integers(-64, 64, 64):
        w.write_sint(int(v), 7)
    for k, count in ((3, 64), (0, 64)):
        w.write_uint(k, 4)
        for i, u in enumerate(rng.integers(0, 40, count)):
            q = 70 if long_unary and k == 0 and i == 0 else int(u) >> k
            w.write_unary(q)
            w.write_uint(int(u) & ((1 << k) - 1), k)
    w.pad_to_byte()
    body = w.getvalue()
    return body + crc16(body).to_bytes(2, "big")


@pytest.mark.parametrize("long_unary", [False, True])
def test_bit_unpack_kernel_escapes_and_long_unary(dev, long_unary):
    """Escapes of 0 and 7 bits decode as the plain version does; a 70-bit
    quotient sets the error flag on the card as in the plain version."""
    frames = [handmade_frame(0, False), handmade_frame(1, long_unary)]
    rows_t, lens, t, scan = staged(dev, frames, 256, 1, 16, 0)
    # the checkpoint at sample 64 carries partition 0's escape of 0 bits
    assert scan.ckpt_inesc[0, 0, 1] == 1 and scan.ckpt_esc[0, 0, 1] == 0
    vals, err = hold_unpack(unpack_args(rows_t, t, 256))
    assert err.item() == int(long_unary)
    assert not vals[0, 0, :64].any() and vals[0, 0, 64:128].abs().max() <= 64
    ok, all_ok = k_crc.crc16_rows(rows_t, lens)
    assert ok.tolist() == [1, 1] and all_ok.item() == 1


@pytest.mark.parametrize("route", ["serial", "chunk"])
@pytest.mark.parametrize("n,c", [(192, 1), (1152, 2), (4608, 2),
                                 (16384, 6), (1152, 8)])
def test_reconstruct_kernel_random(dev, n, c, route):
    """Arbitrary inputs (no stream needed): orders 0-32 in every tap
    bucket, shifts 0 and 15, every channel code, wasted bits, residuals
    past the int32 guard in one frame, random sample state; int32 and
    int64 working types, and the all-fixed batch (the plain version's
    cumsums, the kernel's tiled block scans: no state)."""
    rng = np.random.default_rng(n * 10 + c)
    f = 5
    ss = state_interval(n) if route == "chunk" else 0
    ks = -(-n // ss) if ss else 0
    for bucket in k_rec.TAP_BUCKETS + ("fixed",):
        kind = rng.integers(0, 4, (f, c)).astype(np.int32)
        if bucket == "fixed":
            kind = np.minimum(kind, 2)
        order = np.where(kind == 2, rng.integers(0, 5, (f, c)), 0)
        top = 4 if bucket == "fixed" else bucket
        lpc = rng.integers(1, top + 1, (f, c))
        lpc.flat[0] = top
        order = np.where(kind == 3, lpc, order).astype(np.int32)
        taps = np.where(np.arange(32) < order[..., None],
                        rng.integers(-2 ** 14, 2 ** 14, (f, c, 32)), 0)
        taps[kind == 2, :4] = FIXED_PREDICTOR_TAPS[order[kind == 2]]
        taps[kind == 2, 4:] = 0
        shift = np.where(kind == 3, rng.choice([0, 15, 9], (f, c)), 0)
        vals = rng.integers(-2 ** 12, 2 ** 12, (f, c, n))
        vals[np.arange(n) < order[..., None]] = 0
        vals[kind == 0] = 0
        vals[-1, -1, n // 2] = 2 ** 40               # past the int32 guard
        code = (rng.choice([1, 8, 9, 10], f) if c == 2
                else np.full(f, c - 1))
        t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in dict(
                 vals=vals, taps=taps.astype(np.int32),
                 shift=shift.astype(np.int32), order=order, kind=kind,
                 wasted=rng.integers(0, 3, (f, c)).astype(np.int32),
                 warmup=rng.integers(-2 ** 15, 2 ** 15, (f, c, 32)),
                 const_val=rng.integers(-2 ** 15, 2 ** 15, (f, c)),
                 code=code.astype(np.int32)).items()}
        state = (torch.from_numpy(rng.integers(
            -2 ** 15, 2 ** 15, (f, c, ks, 32)).astype(np.int32)).to(dev)
            if ss and bucket != "fixed" else None)
        t_bucket = 4 if bucket == "fixed" else bucket
        for use_i32 in (True, False):
            hold_reconstruct(
                t["vals"], t["taps"], t["shift"], t["order"], t["kind"],
                t["wasted"], t["warmup"], t["const_val"], t["code"], state,
                ss, t_bucket, use_i32, k_rec.residual_limit(16, use_i32),
                int(order.max()) if bucket == "fixed" else None)


def fixed_inputs(rng, dev, f: int, c: int, n: int, big: int):
    """An all-fixed batch: constant, verbatim and fixed orders 0-4 (one
    order 4), residuals of up to ``big`` bits, warm-up values of up to 31
    bits, wasted bits, every stereo channel code."""
    kind = rng.integers(0, 3, (f, c)).astype(np.int32)
    order = np.where(kind == 2, rng.integers(0, 5, (f, c)), 0)
    kind.flat[0], order.flat[0] = 2, 4
    order = order.astype(np.int32)
    taps = np.zeros((f, c, 32), np.int64)
    taps[kind == 2, :4] = FIXED_PREDICTOR_TAPS[order[kind == 2]]
    vals = rng.integers(-2 ** big, 2 ** big, (f, c, n))
    vals[np.arange(n) < order[..., None]] = 0
    vals[kind == 0] = 0
    code = (rng.choice([1, 8, 9, 10], f) if c == 2 else np.full(f, c - 1))
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in dict(
        vals=vals, taps=taps.astype(np.int32),
        shift=np.zeros((f, c), np.int32), order=order, kind=kind,
        wasted=rng.integers(0, 3, (f, c)).astype(np.int32),
        warmup=rng.integers(-2 ** 31, 2 ** 31, (f, c, 32)),
        const_val=rng.integers(-2 ** 31, 2 ** 31, (f, c)),
        code=code.astype(np.int32)).items()}
    return t, int(order.max())


@pytest.mark.parametrize("c", [1, 2, 6, 8])
@pytest.mark.parametrize("use_i32", [True, False])
def test_reconstruct_kernel_all_fixed_wraps(dev, c, use_i32):
    """The all-fixed route at block 16384 (every tile and warp total of a
    block, 1-16 warps a channel): residuals of 30 bits, whose fourfold
    integrations wrap int32 and grow past 2^64's low bits, integer for
    integer with the plain version's cumsums in both working types."""
    rng = np.random.default_rng(c * 2 + use_i32)
    n = 16384
    t, fixed_max = fixed_inputs(rng, dev, 3, c, n, 30)
    hold_reconstruct(t["vals"], t["taps"], t["shift"], t["order"], t["kind"],
                     t["wasted"], t["warmup"], t["const_val"], t["code"],
                     None, 0, 4, use_i32, k_rec.residual_limit(24, use_i32),
                     fixed_max)


@pytest.mark.parametrize("n", [1, 3, 4097, 4608])
def test_reconstruct_kernel_all_fixed_edges(dev, n):
    """All-fixed blocks shorter than the warm-up and than a run, a block
    of odd length (runs off the 16-byte grid), and every fixed_max from 0
    to 4 on the same inputs."""
    rng = np.random.default_rng(n)
    t, top = fixed_inputs(rng, dev, 4, 2, n, 20)
    for fixed_max in range(top, 5):
        for use_i32 in (True, False):
            hold_reconstruct(
                t["vals"], t["taps"], t["shift"], t["order"], t["kind"],
                t["wasted"], t["warmup"], t["const_val"], t["code"], None, 0,
                4, use_i32, k_rec.residual_limit(16, use_i32), fixed_max)


@pytest.mark.parametrize("t_bucket,use_i32", [(12, True), (32, False)])
def test_reconstruct_kernel_chunk_many_blocks(dev, t_bucket, use_i32):
    """A chunk-route batch the size of the headline's (256 frames of two
    channels at block 4608, 18 chunks a channel): 288 blocks, several on
    each SM, every block's staged windows and stores; LPC orders up to
    the tap bucket, random sample state."""
    rng = np.random.default_rng(t_bucket)
    f, c, n, ss = 256, 2, 4608, 256
    ks = n // ss
    order = rng.integers(1, t_bucket + 1, (f, c)).astype(np.int32)
    taps = np.where(np.arange(32) < order[..., None],
                    rng.integers(-2 ** 10, 2 ** 10, (f, c, 32)), 0)
    vals = rng.integers(-2 ** 12, 2 ** 12, (f, c, n))
    vals[np.arange(n) < order[..., None]] = 0
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in dict(
        vals=vals, taps=taps.astype(np.int32),
        shift=rng.integers(9, 13, (f, c)).astype(np.int32), order=order,
        kind=np.full((f, c), 3, np.int32),
        wasted=np.zeros((f, c), np.int32),
        warmup=rng.integers(-2 ** 15, 2 ** 15, (f, c, 32)),
        const_val=np.zeros((f, c), np.int64),
        code=rng.choice([1, 8, 9, 10], f).astype(np.int32),
        state=rng.integers(-2 ** 15, 2 ** 15, (f, c, ks, 32)).astype(
            np.int32)).items()}
    hold_reconstruct(t["vals"], t["taps"], t["shift"], t["order"], t["kind"],
                     t["wasted"], t["warmup"], t["const_val"], t["code"],
                     t["state"], ss, t_bucket, use_i32,
                     k_rec.residual_limit(16, use_i32))


#: the tone of the wide-state tests, radians a sample, and its order-2
#: recurrence x[i] = 2 cos(w) x[i-1] - x[i-2] at shift 14
TONE = 1.3
TONE_TAPS = (round(2 * np.cos(TONE) * (1 << 14)), -(1 << 14))


def wide_state_inputs(rng, dev, c: int, n: int, ss: int,
                      bucket: int) -> dict:
    """A chunk-route batch of 6 frames with int64 sample state: orders up
    to the tap bucket (one at it), random taps, residuals, warm-up values,
    constants and windows past ±2^31 (the IIR wraps int64 as the plain
    version does); frames 0-2 a tone near ±2^32 in the side channel of left/side,
    side/right and mid/side (channel 0 where mono): windows of the tone's
    samples, residuals of a few units, its order-2 recurrence."""
    f, ks = 6, -(-n // ss)
    kind = np.full((f, c), 3)
    order = rng.integers(1, bucket + 1, (f, c))
    order.flat[-1] = bucket
    taps = np.where(np.arange(32) < order[..., None],
                    rng.integers(-2 ** 14, 2 ** 14, (f, c, 32)), 0)
    shift = rng.choice([0, 9, 15], (f, c))
    vals = rng.integers(-2 ** 33, 2 ** 33, (f, c, n))
    state = rng.integers(-2 ** 33, 2 ** 33, (f, c, ks, 32))
    code = (np.array([8, 9, 10, 1, 8, 10]) if c == 2
            else np.full(f, c - 1))
    kind[3, 0], order[3, 0] = 0, 0                    # a constant
    kind[4, 0], order[4, 0] = 2, 3                    # fixed order 3
    taps[4, 0] = 0
    taps[4, 0, :3] = FIXED_PREDICTOR_TAPS[3][:3]
    shift[kind != 3] = 0
    i = np.arange(n)
    for fr in range(3):
        ch = 0 if c == 1 or code[fr] == 9 else 1
        order[fr, ch], shift[fr, ch] = 2, 14
        taps[fr, ch] = 0
        taps[fr, ch, :2] = TONE_TAPS
        vals[fr, ch] = rng.integers(-8, 9, n)
        pos = (np.arange(ks)[:, None] * ss - 32 + np.arange(32))
        state[fr, ch] = np.where(pos >= 0, (np.sin(pos * TONE + fr)
                                            * 0.95 * 2 ** 32), 0)
    vals[i < order[..., None]] = 0
    vals[kind == 0] = 0
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in dict(
                vals=vals, taps=taps.astype(np.int32),
                shift=shift.astype(np.int32), order=order.astype(np.int32),
                kind=kind.astype(np.int32),
                wasted=rng.integers(0, 3, (f, c)).astype(np.int32),
                warmup=rng.integers(-2 ** 32, 2 ** 32, (f, c, 32)),
                const_val=rng.integers(-2 ** 32, 2 ** 32, (f, c)),
                code=code.astype(np.int32), state=state).items()}


@pytest.mark.parametrize("t_bucket", k_rec.TAP_BUCKETS)
@pytest.mark.parametrize("n,c", [(576, 2), (4608, 2), (1152, 1)])
def test_reconstruct_kernel_int64_state(dev, n, c, t_bucket):
    """The chunk route from int64 sample state (the walker's past 31
    bits) on the int64 working type in every tap bucket: windows,
    residuals, warm-up values and constants past ±2^31, and a side channel
    near ±2^32 in each stereo mode (the MAC's high parts on every
    sample)."""
    rng = np.random.default_rng(n * 100 + c * 10 + t_bucket)
    ss = state_interval(n)
    t = wide_state_inputs(rng, dev, c, n, ss, t_bucket)
    assert t["state"].dtype == torch.int64
    assert int(t["state"].abs().max()) > 2 ** 32 - 2 ** 30
    hold_reconstruct(t["vals"], t["taps"], t["shift"], t["order"], t["kind"],
                     t["wasted"], t["warmup"], t["const_val"], t["code"],
                     t["state"], ss, t_bucket, False, -1)


def test_reconstruct_kernel_refuses_int64_state_on_int32(dev):
    """The int32 working type never takes int64 state: the wrapper
    raises, and the library's entry point refuses the pairing itself."""
    from flacx_torch.kernels.build import bind

    rng = np.random.default_rng(7)
    f, c, n = 6, 2, 576
    ss = state_interval(n)
    t = wide_state_inputs(rng, dev, c, n, ss, 4)
    args = (t["vals"], t["taps"], t["shift"], t["order"], t["kind"],
            t["wasted"], t["warmup"], t["const_val"], t["code"])
    before = launches("reconstruct")
    with pytest.raises(ValueError, match="int64 state"):
        k_rec.reconstruct(*args, t["state"], ss, 4, True, 29)
    assert launches("reconstruct") == before
    pcm = torch.empty((f, n, c), dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    fn = bind("reconstruct", "flacx_reconstruct", 12, 10)
    ptrs = [x.data_ptr() for x in args[:8] + (t["state"], args[8], pcm, err)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    # wide 0 with state64 1: cudaErrorInvalidValue
    assert fn(*ptrs, f, c, n, 4, 0, 29, ss, -(-n // ss), -1, 1, stream) == 1
    assert fn(*ptrs, f, c, n, 4, 1, -1, ss, -(-n // ss), -1, 1, stream) == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("n,c", [(192, 1), (1152, 2), (4608, 2)])
def test_bit_unpack_kernel_span_crosses_frames(dev, n, c):
    """Blocks of 64 lanes whose staged span crosses subframes and frames
    (3 to 144 lanes a frame), frames of unequal length (row padding inside
    the span), then corrupt checkpoints: a cursor past its row's end and
    one that jumps backwards (reads outside the span), the error flag and
    values as the plain version's."""
    from flacx_torch.encoder import BatchEncoder

    f = 24
    x = rows(n + c, f * c, n, bits=16).reshape(f, c, n)
    x[::3] //= 64                                    # shorter frames
    cfg = EncoderConfig(block_size=n, channels=c, max_lpc_order=8)
    frames = BatchEncoder(cfg, batch_frames=f, device=dev).encode_frames(
        x, 0)
    assert len({len(fr) for fr in frames}) > 1
    rows_t, lens, t, scan = staged(dev, frames, n, c, 16, 0)
    vals, err = hold_unpack(unpack_args(rows_t, t, n))
    assert err.item() == 0
    for lane, pos in (((f - 1, c - 1, -1), rows_t.shape[1] * 8 - 3),
                      ((f // 2, 0, 0), 40)):
        bad = dict(t, ckpt_pos=t["ckpt_pos"].clone())
        bad["ckpt_pos"][lane] = pos
        assert hold_unpack(unpack_args(rows_t, bad, n))[1].item() == 1


@pytest.mark.parametrize("w", [256, 4096, 295168])
def test_crc16_rows_kernel(dev, w):
    """Lengths of every residue mod 4, the whole row, one corrupted row."""
    from flacx_torch.native import crc16_rows as host_crc16

    rng = np.random.default_rng(w)
    f = 9
    rows_np = rng.integers(0, 256, (f, w)).astype(np.uint8)
    lens = np.minimum(rng.integers(3, w + 1, f) // 4 * 4 + np.arange(f) % 4,
                      w)
    lens[0] = w
    crc = host_crc16(rows_np, lens - 2)
    for i in range(f):
        rows_np[i, lens[i] - 2] = crc[i] >> 8
        rows_np[i, lens[i] - 1] = crc[i] & 0xFF
    for bad in (None, 4):
        if bad is not None:
            rows_np[bad, lens[bad] // 2] ^= 0x40
        args = (torch.from_numpy(rows_np).to(dev),
                torch.from_numpy(lens.astype(np.int32)).to(dev))
        before = launches("crc16_rows")
        ok, all_ok = k_crc.crc16_rows(*args)
        ref_ok, ref_all = k_crc.crc16_rows_plain(*args)
        torch.cuda.synchronize()
        assert launches("crc16_rows") == before + 1
        assert torch.equal(ok, ref_ok) and torch.equal(all_ok, ref_all)
        assert ok.tolist() == [int(i != bad) for i in range(f)]


def lpc_rows(seed: int, r: int, n: int) -> np.ndarray:
    """``rows`` with a constant row (the third) as well."""
    x = rows(seed, r, n)
    x[2] = 4321
    return x


def f64_bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.cpu().view(torch.int64), b.cpu().view(torch.int64))


@pytest.mark.parametrize("precision", [5, 15])
@pytest.mark.parametrize("n,p", [(64, 1), (1152, 8), (4608, 12), (1025, 32),
                                 (4608, 32), (2049, 12)])
def test_reference_lpc_kernel(dev, n, p, precision):
    """Against the plain version on the CPU, exactly (f64 as bits): rows of
    zeros (invalid), constant rows, full-scale alternation, tones in
    noise; tiles of 1024 samples and their ragged ends."""
    from flacx_torch.conformance import reference_window
    from flacx_torch.kernels import reference_analysis as k_ra
    x = torch.from_numpy(lpc_rows(11 + p, 10, n))
    w = reference_window(n, torch.device("cpu"))
    before = launches("reference_lpc")
    got = k_ra.reference_lpc(x.to(dev), w.to(dev), p, precision)
    want = k_ra.reference_lpc_plain(x, w, p, precision)
    torch.cuda.synchronize()
    assert launches("reference_lpc") == before + 1
    assert f64_bits_equal(got[0], want[0])
    for g, r in zip(got[1:], want[1:]):
        assert torch.equal(g.cpu(), r)
    assert not want[3][0].any()


def test_floor_log2_kernel(dev):
    """The kernel's floor_log2 on the edge values of the CPU tests (exact
    powers, one ulp either side, random values) and the integer means of
    the Rice plan, against the plain version."""
    import math

    from flacx_torch.conformance import floor_log2
    from flacx_torch.kernels import reference_analysis as k_ra
    vals = []
    for k in range(-40, 41):
        p2 = math.ldexp(1.0, k)
        vals += [p2, np.nextafter(p2, 0.0), np.nextafter(p2, np.inf)]
        vals += [p2 * (1 - j * 2.0 ** -53) for j in range(2, 8)]
    rng = np.random.default_rng(5)
    vals += list(np.exp(rng.uniform(-60, 60, 2000)))
    vals += list(rng.integers(1, 1 << 40, 500) / rng.integers(1, 5000, 500))
    x = torch.tensor(vals, dtype=torch.float64)
    got = k_ra.floor_log2_device(x.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), floor_log2(x))


@pytest.mark.parametrize("n", [1, 7, 1152, 2305, 4608])
@pytest.mark.parametrize("p,precision,eff_bps", [
    (0, 5, 17), (1, 5, 17), (8, 15, 17), (12, 5, 17), (12, 5, 31),
    (32, 15, 17), (32, 5, 24)])
def test_abs_residual_sums_kernel(dev, n, p, precision, eff_bps):
    """Against the plain version, exactly, on both MACs (int32 under the
    static bound, int64 past it), every tap bucket, rows of one to three
    segments, rows shorter than the orders; coefficients at the clip
    bounds of the precision, shifts 0..15."""
    from flacx_torch.kernels import reference_analysis as k_ra
    rng = np.random.default_rng(n * 100 + p)
    x = torch.from_numpy(lpc_rows(n + p, 9, n))
    lim = 1 << (precision - 1)
    q = rng.integers(-lim, lim, (9, p, p)).astype(np.int32)
    q[:, :, :1] = np.where(rng.random((9, p, 1)) < 0.3, -lim, q[:, :, :1])
    q *= np.tril(np.ones((p, p), np.int32))
    qc = torch.from_numpy(q)
    qs = torch.from_numpy(rng.integers(0, 16, (9, p)).astype(np.int32))
    taps_max = max(p, 1) << (precision - 1)
    before = launches("abs_residual_sums")
    got = k_ra.abs_residual_sums(x.to(dev), qc.to(dev), qs.to(dev), eff_bps,
                                 taps_max)
    want = k_ra.abs_residual_sums_plain(x, qc, qs, eff_bps, taps_max)
    torch.cuda.synchronize()
    assert launches("abs_residual_sums") == before + 1
    for g, r in zip(got, want):
        assert torch.equal(g.cpu(), r)


def chain_rows(seed: int, r: int, n: int) -> np.ndarray:
    """``[r, n]`` 16-bit rows for ``reference_lpc``'s packed chains: tones
    in noise; from the second row on, a silent row, a row whose only
    samples are x[0] (where the window is 0) and x[n-1] (outside the
    reference's range), so its error is 0 from the first order, a constant
    row and full-scale alternation."""
    x = rows(seed, r + 2, n, bits=16)[2:]
    edge = np.zeros(n, np.int32)
    edge[0], edge[-1] = 1234, -999
    for i, v in enumerate((0, edge, 4321, np.where(np.arange(n) % 2, 32767,
                                                    -32768)), start=1):
        if i < r:
            x[i] = v
    return x


@pytest.mark.parametrize("n,r", [(33, 1), (1025, 1), (4608, 1), (16384, 1),
                                 (33, 3), (1025, 3), (4608, 3), (16384, 3),
                                 (33, 5), (1025, 5), (4608, 5), (16384, 5),
                                 (33, 1029), (1025, 1029)])
@pytest.mark.parametrize("p", [1, 2, 15, 31, 32])
def test_reference_lpc_packed_chains(dev, r, p, n):
    """Both lane layouts: 1, 3 and 5 rows take one lag a lane (a block a
    row; two warps at P = 32), 1029 rows the dense packing (lanes of a
    row, rows of a warp, warps of a block), its last warp and block left
    part-full, at orders whose rows take 2, 9, 16 and 17 lanes; silent
    rows and rows whose error is 0 from the first order invalid
    throughout.  (A nonzero error cannot reach exactly 0 later from
    integer samples: the autocorrelation's Toeplitz matrix is positive
    definite; the CPU model in test_torch_conformance_split.py feeds
    Levinson such sequences.)  Exact against the plain version, f64 as
    bits, one launch a call."""
    from flacx_torch.conformance import reference_window
    from flacx_torch.kernels import reference_analysis as k_ra
    x = torch.from_numpy(chain_rows(p * 7 + r, r, n))
    w = reference_window(n, torch.device("cpu"))
    before = launches("reference_lpc")
    got = k_ra.reference_lpc(x.to(dev), w.to(dev), p, 15 if p > 2 else 5)
    want = k_ra.reference_lpc_plain(x, w, p, 15 if p > 2 else 5)
    torch.cuda.synchronize()
    assert launches("reference_lpc") == before + 1
    assert f64_bits_equal(got[0], want[0])
    for g, v in zip(got[1:], want[1:]):
        assert torch.equal(g.cpu(), v)
    assert want[3][0].all()
    for i in (1, 2):
        if i < r:
            assert not want[3][i].any()


def full_scale(seed: int, r: int, n: int, bits: int) -> np.ndarray:
    """``[r, n]`` int32 rows of ``bits``-bit samples: white noise, the two
    extremes alternating and in runs of three, then tones in noise."""
    rng = np.random.default_rng(seed)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    t = np.arange(n)
    x = np.round(np.sin(t[None] * rng.uniform(0.001, 0.2, (r, 1)))
                 * rng.uniform(0, hi, (r, 1))
                 + rng.standard_normal((r, n)) * (hi / 64))
    x = np.clip(x, lo, hi)
    x[0] = rng.integers(lo, hi + 1, n)
    if r > 1:
        x[1] = np.where(t % 2, hi, lo)
    if r > 2:
        x[2] = np.where(t // 3 % 2, hi, lo)
    return x.astype(np.int64).astype(np.int32)


def sum_args(seed: int, r: int, n: int, p: int, eff_bps: int,
             precision: int, hi_rows: bool = True):
    """:func:`full_scale` rows and taps at the clip bounds of
    ``precision`` (rows 0 and 1 at -2^(prec-1) and 2^(prec-1) - 1
    throughout), shifts 0..15 (row 0 at 0); with ``hi_rows`` False every
    other row's taps fit one signed byte (no hi limb), the rest keep
    theirs."""
    x = full_scale(seed, r, n, eff_bps)
    rng = np.random.default_rng(seed + 1)
    lim = 1 << (precision - 1)
    q = rng.integers(-lim, lim, (r, p, p))
    q[0] = -lim
    if r > 1:
        q[1] = lim - 1
    if not hi_rows:
        q[::2] = np.clip(q[::2], -128, 127)
    q = (q * np.tril(np.ones((p, p), np.int64))).astype(np.int32)
    s = rng.integers(0, 16, (r, p)).astype(np.int32)
    if p:
        s[0] = 0
    return (torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s),
            max(p, 1) << (precision - 1))


def hold_sums(dev, args, eff_bps):
    from flacx_torch.kernels import reference_analysis as k_ra
    x, q, s, taps_max = args
    before = launches("abs_residual_sums")
    got = k_ra.abs_residual_sums(x.to(dev), q.to(dev), s.to(dev), eff_bps,
                                 taps_max)
    want = k_ra.abs_residual_sums_plain(x, q, s, eff_bps, taps_max)
    torch.cuda.synchronize()
    assert launches("abs_residual_sums") == before + 1
    for g, v in zip(got, want):
        assert torch.equal(g.cpu(), v)


@pytest.mark.parametrize("precision", [5, 8, 9, 15])
@pytest.mark.parametrize("eff_bps", [8, 16, 17, 24, 25, 28, 32])
def test_abs_residual_sums_limb_routes(dev, eff_bps, precision):
    """Every sample-limb count (2 up to 16 bits, 3 up to 24, 4 past), with
    and without hi tap limbs, the int32 and the int64 combine, 32- and
    64-bit sums, int32 and int64 differences: full-scale rows at the
    extremes, taps at the clip bounds, two segments a row."""
    hold_sums(dev, sum_args(eff_bps * 16 + precision, 6, 4097, 12, eff_bps,
                            precision), eff_bps)


def test_abs_residual_sums_mixed_hi_limbs(dev):
    """One batch whose rows' blocks take the hi tap products and skip
    them, row by row."""
    hold_sums(dev, sum_args(3, 8, 4608, 12, 16, 9, hi_rows=False), 16)


@pytest.mark.parametrize("p", [0, 1, 4, 12, 13, 32])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4608, 16384])
def test_abs_residual_sums_shapes(dev, n, p):
    """Rows shorter than a 16-sample block and than the orders, one and
    eight segments a row, no LPC order, a lone order, the packed last tile
    (4, 12), the unpacked one (13) and four full tiles (32)."""
    hold_sums(dev, sum_args(n + p, 5, n, p, 17, 9), 17)


@pytest.mark.parametrize("n,p,kinds", [
    (1152, 12, ("tonal", "noise", "impulse", "silence")),
    (4608, 8, ("tonal", "noise"))])
def test_conformance_encode_on_card(dev, n, p, kinds):
    """``BatchEncoder(conformance=True)`` on the card writes the plain CPU
    path's frames byte for byte, overflow frames (the oracle's) included,
    and launches both kernels once a batch."""
    from conftest import make_pcm

    from flacx_torch.encoder import BatchEncoder
    from flacx_torch.kernels import reference_analysis as k_ra
    pcm = np.concatenate([make_pcm(np.random.default_rng(k), n, 2, 16, kind)
                          for k, kind in enumerate(kinds)])
    blocks = np.ascontiguousarray(pcm.reshape(-1, n, 2).transpose(0, 2, 1))
    cfg = EncoderConfig(block_size=n, max_lpc_order=p, conformance=True)
    before = (launches("reference_lpc"), launches("abs_residual_sums"))
    card = BatchEncoder(cfg, batch_frames=len(blocks)).encode_frames(
        blocks, 9)
    assert (launches("reference_lpc"),
            launches("abs_residual_sums")) == (before[0] + 1, before[1] + 1)
    cpu = BatchEncoder(cfg, batch_frames=len(blocks), device="cpu") \
        .encode_frames(blocks, 9)
    assert card == cpu


# ---------------------------------------------------------------------------
# The 25- to 32-bit routes: int64 differences, int64 zz, int64 Rice input


def wide_rows(seed: int, r: int, n: int, bits: int) -> np.ndarray:
    """``[r, n]`` int32 rows of ``bits``-bit samples: :func:`rows` at that
    width, full-scale white noise, the two extremes in runs of three."""
    x = rows(seed, r, n, bits=bits)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    x[2] = np.random.default_rng(seed).integers(lo, hi + 1, n)
    x[3] = np.where(np.arange(n) // 3 % 2, hi, lo)
    return x


@pytest.mark.parametrize("eff_bps", [26, 27, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1152, 9217])
def test_analysis_kernel_wide_differences(dev, eff_bps, dtype, n):
    """Fixed-order sums on the int32 route at eff_bps 26 and the int64
    route past it, samples up to +-2^31 (past 2^24 the f32 conversion
    rounds to nearest even, as the plain version's), one and several
    segments a row."""
    x = torch.from_numpy(wide_rows(eff_bps, 6, n, eff_bps)).to(dev)
    w = torch.rand((2, n), dtype=dtype,
                   generator=torch.Generator().manual_seed(n)).to(dev)
    autoc, fsums = k_an.analysis(x, w, 12, eff_bps)
    ref_a, ref_f = k_an.analysis_plain(x, w, 12, eff_bps)
    torch.cuda.synchronize()
    assert k_an.diff_width(eff_bps) == ("int32" if eff_bps <= 26
                                        else "int64")
    assert torch.equal(fsums, ref_f)
    rtol = 1e-9 if dtype == torch.float32 else 1e-12
    tol = rtol * ref_a.abs() + 1e-12 * ref_a[..., :1].abs()
    assert bool(((autoc - ref_a).abs() <= tol).all())


@pytest.mark.parametrize("eff_bps,ntaps,prec", [(17, 12, 5), (28, 12, 12),
                                                (32, 12, 5), (32, 32, 15)])
@pytest.mark.parametrize("n", [4608, 16384])
def test_lpc_residual_kernel_zz_int64(dev, eff_bps, ntaps, prec, n):
    """The zz mode's int64 output on both MACs (the int32 MAC at eff_bps
    17, the wide one past it), and the stats at eff_bps 32 and precision
    15, where |x| * sum |taps| reaches 2^31 * 2^19 = 2^50: every value
    equal to the plain version's, the residual never narrowed."""
    r = 8
    x = torch.from_numpy(wide_rows(n, r, n, eff_bps)).to(dev)
    rng = np.random.default_rng(n + ntaps)
    top = 1 << (prec - 1)
    taps = rng.integers(-top, top, (r, ntaps)).astype(np.int32)
    taps[2] = -top
    taps[3] = np.where(np.arange(ntaps) % 2, top - 1, -top)
    order = rng.integers(0, ntaps + 1, r).astype(np.int32)
    order[2:4] = ntaps
    taps[np.arange(ntaps) >= order[:, None]] = 0
    shift = rng.integers(0, 16, r).astype(np.int32)
    shift[2:4] = 0
    args = [x] + [torch.from_numpy(a).to(dev) for a in (taps, shift, order)]
    bound = (eff_bps, ntaps << (prec - 1))
    before = launches("lpc_residual_zz")
    zz = k_lr.lpc_residual_zz(*args, *bound, torch.int64)
    ref = k_lr.lpc_residual_zz_plain(*args, *bound, torch.int64)
    got_s = k_lr.lpc_residual_stats(*args, *bound)
    ref_s = k_lr.lpc_residual_stats_plain(*args, *bound)
    torch.cuda.synchronize()
    assert launches("lpc_residual_zz") == before + 1
    assert zz.dtype == torch.int64 and torch.equal(zz, ref)
    assert all(torch.equal(a, b) for a, b in zip(got_s, ref_s))
    if eff_bps == 32 and prec == 15:
        assert int(ref.max()) > 1 << 40


def int64_zz(seed: int, r: int, c: int, n: int, order: np.ndarray,
             ) -> np.ndarray:
    """int64 ``[r, c, n]`` zigzag residuals (zero at ``i < order``) of
    many scales, with peaks at 2^31 - 2, 2^31 - 1, 2^31, 2^32 - 1, 2^32 and
    2^40 in single partitions, and a row of 31-bit values (escapes of
    E = 31)."""
    rng = np.random.default_rng(seed)
    scale = 2.0 ** rng.integers(0, 30, size=(r, c, 1))
    zz = np.minimum(rng.exponential(size=(r, c, n)) * scale,
                    2 ** 30 - 1).astype(np.int64)
    peaks = np.array([(1 << 31) - 2, (1 << 31) - 1, 1 << 31, (1 << 32) - 1,
                      1 << 32, 1 << 40])
    at = rng.integers(0, n, (r, c, 2))
    np.put_along_axis(zz, at, peaks[rng.integers(0, 6, (r, c, 2))], -1)
    zz[0, 0] = rng.integers(1 << 30, 1 << 31, n)
    return np.where(np.arange(n) < order[..., None], 0, zz)


@pytest.mark.parametrize("n,porders,c", [
    (4608, (0, 1, 2, 3, 4, 5), 2), (1152, (0, 1, 2, 3, 4, 5), 4),
    (9216, tuple(range(11)), 2), (16384, tuple(range(15)), 2),
    (64, tuple(range(7)), 2)])
def test_rice_stats_kernel_int64(dev, n, porders, c):
    """The int64 route (values saturated at 2^31 into the uint32 tree)
    against the plain int64 search: partitions read from device memory
    (144 and 36 samples) and staged (9, 1 and 2 samples, over many
    segments), one-sample partitions at n = 64; the plans from its
    statistics equal the plans the plain search gives, escapes of 31 bits
    included."""
    r = 6
    order = np.random.default_rng(n).integers(0, 13, (r, c)).astype(np.int32)
    if n == 64:
        order[:] = np.minimum(order, 1)
    zz = int64_zz(n, r, c, n, order)
    zt, ot = torch.from_numpy(zz).to(dev), torch.from_numpy(order).to(dev)
    before = launches("rice_stats")
    got = k_rs.rice_stats(zt, ot, porders, 30)
    ref = rice.rice_stats(zt, ot, porders, 30)
    torch.cuda.synchronize()
    assert launches("rice_stats") == before + 1
    for po in ref:
        assert all(torch.equal(a, b) for a, b in zip(got[po], ref[po])), po
    plan = rice.exact_plan(zt, ot, porders, porders, 30, kernel_stats=got)
    ref_plan = rice.exact_plan(zt, ot, porders, porders, 30)
    for a, b in zip(plan, ref_plan):
        assert torch.equal(a, b)
    assert bool((plan.esc_seg & (plan.k_seg == 31)).any())


def frame_pack_int64_args(dev, n, porders):
    """``frame_pack`` arguments of two 32-bit stereo frames with int64
    ``zz``: a fixed channel of small noise whose peak codes at zz = 2^31 -
    2 beside a verbatim channel of full-scale noise (its zz past 2^31,
    never read); white noise of 31 bits (escapes of E = 31) beside a tone
    at order 2."""
    rng = np.random.default_rng(n)
    x = rng.integers(-(1 << 20), 1 << 20, (2, 2, n))
    x[0, 0, n // 2] = (1 << 30) - 1
    x[0, 1] = rng.integers(-(1 << 31), 1 << 31, n)
    x[1, 0] = rng.integers(-(1 << 30), 1 << 30, n)
    x[1, 1] = (np.sin(np.arange(n) * 0.01) * (1 << 29)).astype(np.int64)
    kind = np.array([[emit.KIND_FIXED, emit.KIND_VERBATIM],
                     [emit.KIND_FIXED, emit.KIND_FIXED]], np.int32)
    order = np.array([[0, 0], [0, 2]], np.int32)
    taps = np.zeros((2, 2, 12), np.int32)
    taps[..., :4] = FIXED_PREDICTOR_TAPS[order]
    t = {k: torch.from_numpy(v).to(dev) for k, v in dict(
        x=x.astype(np.int32), kind=kind, order=order, taps=taps,
        shift=np.zeros((2, 2), np.int32),
        bps=np.full((2, 2), 32, np.int32)).items()}
    zz = k_lr.lpc_residual_zz_plain(t["x"], t["taps"], t["shift"],
                                    t["order"], 32, 15, torch.int64)
    plan = rice.exact_plan(zz, t["order"], porders, porders, 30)
    coded = t["kind"] >= emit.KIND_FIXED
    assert bool((plan.bits[coded] < 1 << 40).all())
    assert int(zz[0, 0].max()) == (1 << 31) - 2
    assert int(zz[0, 1].max()) >= 1 << 31
    hdr = frame_header_symbols(torch.arange(2, device=dev) * 9,
                               torch.ones(2, dtype=torch.int32, device=dev),
                               n)
    sh_v, sh_l = emit.subframe_header_symbols(
        t["kind"], t["order"], t["bps"], t["x"], t["taps"], t["shift"], 5,
        plan)
    pv, pl = emit.partition_param_symbols(t["kind"], plan)
    kesc = (plan.k_seg.int() | (plan.esc_seg.int() << 7)).contiguous()
    cfg = EncoderConfig(block_size=n, bps=32, partition_orders=porders)
    return [hdr.values, hdr.lengths, sh_v, sh_l, pv, pl, zz, t["x"], kesc,
            t["kind"], t["order"], t["bps"], n >> max(porders),
            cfg.max_frame_bytes], plan


@pytest.mark.parametrize("n,porders", [(4608, (0, 1, 2, 3, 4, 5)),
                                       (1152, (0, 1, 2, 3, 4, 5)),
                                       (16384, tuple(range(15)))])
def test_frame_pack_kernel_int64_zz(dev, n, porders):
    """int64 ``zz``, of which the kernel reads the low 32 bits: a coded
    residual of zz = 2^31 - 2, escapes of 31 bits, a verbatim channel
    whose zz passes 2^31; the bytes of the plain version, which reads the
    whole values, and of the same frames with ``zz`` narrowed to int32."""
    args, plan = frame_pack_int64_args(dev, n, porders)
    assert bool((plan.esc_seg & (plan.k_seg == 31)).any())
    frame_pack_equal(args)
    narrow = list(args)
    narrow[6] = args[6].to(torch.int32)
    assert torch.equal(k_fp.frame_pack(*narrow)[0], k_fp.frame_pack(*args)[0])


@pytest.mark.parametrize("eff_bps", [25, 28, 32])
@pytest.mark.parametrize("p", [12, 32])
def test_lpc_allorder_kernel_past_24_bits(dev, eff_bps, p):
    """Four sample limbs and the int64 combine at eff_bps 25, 28 and 32:
    full-scale rows, taps of precision 15 (the extremes on one row, every
    tap -2^14 at shift 0 on another)."""
    x = wide_rows(eff_bps + p, 8, 1000, eff_bps)
    assert k_la.sample_limbs(eff_bps) == 4
    assert k_lr.mac_width(eff_bps, p << 14) == "wide"
    allorder_case(dev, x, p, 15, eff_bps)
    qcoefs = np.full((8, p, p), -(1 << 14), np.int32)
    qcoefs *= np.arange(p) < np.arange(1, p + 1)[:, None]
    got, ref = allorder_pair(dev, x, qcoefs, np.zeros((8, p), np.int32),
                             eff_bps, p << 14)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert int(ref[1].max()) == (1 << 31) - 1


@pytest.mark.parametrize("bps,channels,order_search", [
    (28, 2, "estimate"), (32, 2, "estimate"), (32, 1, "exact"),
    (25, 2, "exact")])
def test_encode_past_24_bits_on_card(dev, bps, channels, order_search):
    """``BatchEncoder`` at 25 to 32 bits on the card writes the plain CPU
    path's frames wherever both chose the same coefficients (every frame
    under the exact search), and the frames decode bit-exactly on the
    card's device route."""
    import io

    from conftest import make_pcm

    from flacx_torch import decoder
    from flacx_torch.encoder import BatchEncoder
    from flacx_torch.oracle.decoder import read_frame
    from flacx_torch.stream import StreamWriter
    n = 4608
    pcm = np.concatenate([
        make_pcm(np.random.default_rng(bps), 3 * n, channels, bps),
        np.random.default_rng(1).integers(-(1 << (bps - 1)),
                                          1 << (bps - 1), (n, channels))])
    blocks = np.ascontiguousarray(
        pcm.reshape(-1, n, channels).transpose(0, 2, 1).astype(np.int32))
    cfg = EncoderConfig(block_size=n, bps=bps, channels=channels,
                        order_search=order_search)
    card = BatchEncoder(cfg, batch_frames=4).encode_frames(blocks, 0)
    cpu = BatchEncoder(cfg, batch_frames=4, device="cpu") \
        .encode_frames(blocks, 0)
    for i, (a, b) in enumerate(zip(card, cpu)):
        if a != b:
            assert order_search == "estimate", i
            fa, fb = read_frame(a, bps)[0], read_frame(b, bps)[0]
            assert [sf.coefficients for sf in fa.subframes] != \
                [sf.coefficients for sf in fb.subframes], i
    f = io.BytesIO()
    w = StreamWriter(f, 44100, bps, channels, len(pcm), n)
    w.add_pcm(pcm)
    w.write_frames(card)
    w.finalize()
    stats = {}
    _, got = decoder.decode_array(f.getvalue(), device="cuda", stats=stats)
    assert np.array_equal(got, pcm) and not stats.get("host"), stats


@pytest.mark.parametrize("bps,rate,channels", [
    (16, 44100, 2), (16, 44100, 1), (24, 48000, 2), (24, 96000, 2)])
def test_encode_batch_indexed_rows_independent_on_card(dev, bps, rate,
                                                       channels):
    """A corpus batch's frames do not depend on their batch neighbours or
    on ``B``: frames of three signals mixed into one batch with per-frame
    indices equal each frame encoded in another batch, of another size
    and order (the corpus buckets' settings at block 4608)."""
    from conftest import make_pcm

    from flacx_torch.encoder import BatchEncoder
    n = 4608
    rng = np.random.default_rng(bps + channels)
    blocks = np.concatenate([
        make_pcm(rng, 4 * n, channels, bps, kind).reshape(4, n, channels)
        for kind in ("tonal", "noise", "impulse")]).transpose(0, 2, 1)
    blocks = np.ascontiguousarray(blocks.astype(np.int32))
    idx = np.tile(np.arange(4, dtype=np.int64), 3) + np.repeat(
        np.array([0, 70_000, 1 << 21], np.int64), 4)
    cfg = EncoderConfig(sample_rate=rate, bps=bps, channels=channels,
                        block_size=n)
    enc = BatchEncoder(cfg, batch_frames=12)
    whole = enc._drain(enc.encode_batch_indexed(blocks, idx), 12, None)
    perm = rng.permutation(12)
    for lo, hi in ((0, 5), (5, 12)):
        sel = perm[lo:hi]
        part = enc._drain(enc.encode_batch_indexed(blocks[sel], idx[sel]),
                          hi - lo, None)
        assert part == [whole[i] for i in sel]
    one = enc._drain(enc.encode_batch_device(blocks[7:8], int(idx[7])), 1,
                     None)
    assert one == [whole[7]]


def test_sharded_encode_and_decode_on_card(dev):
    """A mesh of two ``cuda:0`` entries: ``BatchEncoder`` writes the
    unsharded frames, and ``decode_array`` gives the PCM bit for bit on
    the device route at a batch that divides the mesh and one that does
    not."""
    import io

    from conftest import make_pcm

    from flacx_torch import decoder, pipeline
    from flacx_torch.encoder import BatchEncoder
    from flacx_torch.parallel import data_mesh, frame_sharding
    sh = frame_sharding(data_mesh(devices=("cuda:0", "cuda:0")))
    n = 1152
    pcm = make_pcm(np.random.default_rng(9), 9 * n, 2, 16)
    blocks = np.ascontiguousarray(
        pcm.reshape(9, n, 2).transpose(0, 2, 1).astype(np.int16))
    cfg = EncoderConfig(block_size=n)
    want = BatchEncoder(cfg, 4).encode_frames(blocks, 2)
    enc = BatchEncoder(cfg, 4, sharding=sh)
    assert [len(p["length"]) for p in enc.encode_batch_device(blocks, 0)] \
        == [5, 4]
    assert enc.encode_frames(blocks, 2) == want
    kw = dict(sample_rate=44100, bps=16, channels=2, block_size=n,
              max_lpc_order=12, qlp_precision=5,
              partition_orders=(0, 1, 2, 3, 4, 5), batch_frames=4)
    a, b = io.BytesIO(), io.BytesIO()
    pipeline.encode_to_file(a, pcm, sharding=sh, **kw)
    pipeline.encode_to_file(b, pcm, **kw)
    assert a.getvalue() == b.getvalue()
    for batch in (4, 3):
        stats = {}
        _, got = decoder.decode_array(a.getvalue(), batch_frames=batch,
                                      stats=stats, sharding=sh)
        assert np.array_equal(got, pcm)
        assert stats == {"device": -(-9 // batch)}
    with pytest.raises(ValueError, match="conflicts"):
        BatchEncoder(cfg, 4, device="cpu", sharding=sh)
    with pytest.raises(RuntimeError, match="visible"):
        data_mesh(torch.cuda.device_count() + 1)


def autoc_ok(got, want) -> bool:
    """f64 sums of the same products in another order: within rtol 1e-12,
    or 1e-12 of the lag-0 sum near zero."""
    tol = 1e-12 * want.abs() + 1e-12 * want[..., :1].abs()
    return bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("n,n_seq,bits", [(16384, 8, 24), (32768, 2, 24),
                                          (32768, 1, 24), (1000, 5, 17),
                                          (4100, 41, 32)])
def test_seqshard_kernel_modes(dev, n, n_seq, bits):
    """Each mode against its plain version at the hi-res shapes and at
    tiles that end mid-shard, with spans cut at a shard edge and their
    halos passed in: integers exact, the autocorrelation within
    :func:`autoc_ok`."""
    from flacx_torch.kernels import seqshard as k_seq
    x = torch.from_numpy(rows(11, 6, n, bits)).to(dev)
    w = torch.rand(n, generator=torch.Generator().manual_seed(n)).to(dev)
    rng = np.random.default_rng(n)
    t = min(32, n // n_seq)
    taps = torch.from_numpy(rng.integers(-2 ** 14, 2 ** 14, (6, t))
                            .astype(np.int32)).to(dev)
    shift = torch.from_numpy(rng.integers(0, 16, 6).astype(np.int32)).to(dev)
    order = torch.from_numpy(rng.integers(0, t + 1, 6).astype(np.int32)
                             ).to(dev)
    lag = min(32, n // n_seq)
    for xw in ((x.float() * w), x.double() * w.double()):
        got = k_seq.seq_autocorr(xw, lag, n_seq)
        assert autoc_ok(got, k_seq.seq_autocorr_plain(xw, lag, n_seq))
    for xi in (x, x.long()):
        assert torch.equal(k_seq.seq_fixed(xi, n_seq),
                           k_seq.seq_fixed_plain(xi, n_seq))
    for a, b in zip(k_seq.seq_lpc(x, taps, shift, order, n_seq),
                    k_seq.seq_lpc_plain(x, taps, shift, order, n_seq)):
        assert torch.equal(a, b)
    if n_seq < 2:
        return
    cut = (n // n_seq) * (n_seq // 2)
    head, tail = x[:, :cut].contiguous(), x[:, cut:].contiguous()
    k = n_seq // 2
    xw = (x.float() * w)
    parts = [k_seq.seq_autocorr(xw[:, :cut].contiguous(), lag, k,
                                halo=xw[:, cut:cut + lag].contiguous(), n=n),
             k_seq.seq_autocorr(xw[:, cut:].contiguous(), lag, n_seq - k,
                                shard0=k, n=n)]
    assert autoc_ok(torch.cat(parts, 1),
                    k_seq.seq_autocorr_plain(xw, lag, n_seq))
    parts = [k_seq.seq_fixed(head, k),
             k_seq.seq_fixed(tail, n_seq - k, halo=x[:, cut - 4:cut]
                             .contiguous(), shard0=k)]
    assert torch.equal(torch.cat(parts, 1), k_seq.seq_fixed_plain(x, n_seq))
    want = k_seq.seq_lpc_plain(x, taps, shift, order, n_seq)
    parts = [k_seq.seq_lpc(head, taps, shift, order, k),
             k_seq.seq_lpc(tail, taps, shift, order, n_seq - k,
                           halo=x[:, cut - t:cut].contiguous(), shard0=k)]
    for j in range(2):
        assert torch.equal(torch.cat([p[j] for p in parts], 1), want[j])
    torch.cuda.synchronize()


def test_seqshard_sharded_functions_on_card(dev):
    """The sharded functions on meshes of repeated ``cuda:0`` entries equal
    the unsharded kernels: ``analysis``'s fixed sums and the wide
    ``lpc_residual_stats`` exactly (the max below its clamp), its f32
    autocorrelation within :func:`autoc_ok`."""
    from flacx_torch.kernels import lpc_residual as k_lr
    from flacx_torch.parallel import seqshard
    n = 16384
    x = torch.from_numpy(rows(12, 8, n, 24)).to(dev)
    w = torch.rand(n, generator=torch.Generator().manual_seed(3)).to(dev)
    rng = np.random.default_rng(3)
    taps = torch.from_numpy(rng.integers(-16, 16, (8, 32)).astype(np.int32)
                            ).to(dev)
    shift = torch.full((8,), 4, dtype=torch.int32, device=dev)
    order = torch.from_numpy(rng.integers(1, 33, 8).astype(np.int32)).to(dev)
    autoc, fsums = k_an.analysis(x, w, 32)
    lzz, maxabs = k_lr.lpc_residual_stats(x, taps, shift, order, 25,
                                          32 << 4)
    for nd, ns in ((1, 2), (1, 8), (2, 4)):
        mesh = seqshard.seq_mesh(nd, ns, devices=("cuda:0",) * (nd * ns))
        assert torch.equal(seqshard.fixed_order_zz_sums_sharded(x, mesh),
                           fsums)
        zz, mx = seqshard.lpc_zz_stats_sharded(x, taps, shift, order, mesh)
        assert torch.equal(zz, lzz)
        below = maxabs < 2 ** 31 - 1
        assert torch.equal(mx[below], maxabs[below].long())
        assert autoc_ok(seqshard.autocorrelate_sharded(x.float() * w, 32,
                                                       mesh), autoc)


#: (local, shards, shard0, samples of the row past the span, a halo): a
#: shard not a multiple of the lane run, shards as short as the halo (32
#: and 4), the row's end at the span's end or one past it, shards of
#: several tiles a warp
SEQ_EDGES = [(300, 3, 2, 77, True), (32, 4, 0, 0, False),
             (32, 2, 3, 1, True), (4, 6, 1, 5, True), (5000, 2, 1, 0, True),
             (257, 1, 0, 0, False)]


@pytest.mark.parametrize("local,shards,shard0,extra,with_halo", SEQ_EDGES)
def test_seqshard_kernel_run_edges(dev, local, shards, shard0, extra,
                                   with_halo):
    """Each mode at the lane runs' and tiles' edges against its plain
    version: f32 and f64 products, int32 and int64 differences, LPC taps
    with trailing zeros (so the tap bucket is below ``t``) and a row of
    zero taps; halos across the span's edge, or none."""
    from flacx_torch.kernels import seqshard as k_seq
    rng = np.random.default_rng(local * 7 + shard0)
    m = local * shards
    full = torch.from_numpy(rows(local, 5, m + 64, 24)).to(dev)
    x, before, after = (full[:, 32:32 + m].contiguous(),
                        full[:, :32].contiguous(),
                        full[:, 32 + m:].contiguous())
    n = (shard0 + shards) * local + extra
    lag = min(32, local)
    w = torch.rand(m + 64, generator=torch.Generator().manual_seed(m)).to(dev)
    for dtype in (torch.float32, torch.float64):
        xw = (full.to(dtype) * w.to(dtype))
        span = xw[:, 32:32 + m].contiguous()
        halo = xw[:, 32 + m:32 + m + lag].contiguous() if with_halo else None
        got = k_seq.seq_autocorr(span, lag, shards, halo, shard0, n)
        want = k_seq.seq_autocorr_plain(span, lag, shards, halo, shard0, n)
        assert autoc_ok(got, want), dtype
    for xi in (x, x.long()):
        hb = before[:, 28:].to(xi.dtype).contiguous() if with_halo else None
        assert torch.equal(k_seq.seq_fixed(xi, shards, hb, shard0),
                           k_seq.seq_fixed_plain(xi, shards, hb, shard0))
    t = min(32, local)
    taps = torch.from_numpy(rng.integers(-2 ** 14, 2 ** 14, (5, t))
                            .astype(np.int32)).to(dev)
    taps[1, max(1, t - 3):] = 0                      # a lower bucket
    taps[2] = 0                                      # no tap at all
    taps[3, t // 2:] = 0
    shift = torch.tensor([0, 5, 9, 15, 3], dtype=torch.int32, device=dev)
    order = torch.tensor([t, 0, 3, local * shard0 + 1, 1],
                         dtype=torch.int32, device=dev)
    hl = before[:, 32 - t:].contiguous() if with_halo else None
    got = k_seq.seq_lpc(x, taps, shift, order, shards, hl, shard0)
    want = k_seq.seq_lpc_plain(x, taps, shift, order, shards, hl, shard0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()


@pytest.mark.parametrize("w,count", [(1024, 1), (4096, 7), (260, 5),
                                     (300032, 3)])
def test_crc16_rows_kernel_edges(dev, w, count):
    """Lengths under 2, equal to the row width and one past it; a byte
    corrupted in a row's first and in its last body word; a batch of one
    row; a width that is not a multiple of 16 (4-byte copies) and rows of
    several blocks a row (a cluster)."""
    from flacx_torch.native import crc16_rows as host_crc16

    rng = np.random.default_rng(w + count)
    rows_np = rng.integers(0, 256, (count, w)).astype(np.uint8)
    lens = rng.integers(2, w + 1, count)
    lens[0] = w
    if count > 2:
        lens[1], lens[2] = 1, 0
    good = (lens >= 2) & (lens <= w)
    crc = host_crc16(rows_np[good], (lens[good] - 2).astype(np.int32))
    for i, c in zip(np.flatnonzero(good), crc):
        rows_np[i, lens[i] - 2], rows_np[i, lens[i] - 1] = c >> 8, c & 0xFF
    bad = {}
    if count > 4:
        bad = {3: 1, 4: int(lens[4]) - 3}           # first word, last word
        lens[3], lens[4] = max(lens[3], 8), max(lens[4], 8)
    for row, byte in bad.items():
        body = int(lens[row]) - 2
        crc = host_crc16(rows_np[row:row + 1], np.array([body], np.int32))
        rows_np[row, body], rows_np[row, body + 1] = crc[0] >> 8, crc[0] & 255
        rows_np[row, min(byte, body - 1)] ^= 0x10
    args = (torch.from_numpy(rows_np).to(dev),
            torch.from_numpy(lens.astype(np.int32)).to(dev))
    before = launches("crc16_rows")
    ok, all_ok = k_crc.crc16_rows(*args)
    ref_ok, ref_all = k_crc.crc16_rows_plain(*args)
    torch.cuda.synchronize()
    assert launches("crc16_rows") == before + 1
    assert torch.equal(ok, ref_ok) and torch.equal(all_ok, ref_all)
    assert ok.tolist() == [int(bool(good[i]) and i not in bad)
                           for i in range(count)]


def opt_in_inputs(d):
    """The f64 analysis at a 4608-sample segment (past 48 KB of shared
    memory) and a serial-route ``reconstruct`` batch (the IIR kernel, 32
    taps, int64), on card ``d``."""
    rng = np.random.default_rng(48)
    x = torch.from_numpy(rows(48, 4, 4608)).to(d)
    win = torch.rand(4608, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(48)).to(d)
    f, c, n = 3, 2, 4608
    order = rng.integers(1, 33, (f, c)).astype(np.int32)
    taps = np.where(np.arange(32) < order[..., None],
                    rng.integers(-2 ** 14, 2 ** 14, (f, c, 32)), 0)
    vals = rng.integers(-2 ** 12, 2 ** 12, (f, c, n))
    vals[np.arange(n) < order[..., None]] = 0
    rec = [torch.from_numpy(np.ascontiguousarray(v)).to(d) for v in (
        vals, taps.astype(np.int32), np.full((f, c), 9, np.int32), order,
        np.full((f, c), 3, np.int32), np.zeros((f, c), np.int32),
        rng.integers(-2 ** 15, 2 ** 15, (f, c, 32)),
        np.zeros((f, c), np.int64), np.full(f, 1, np.int32))]
    return x, win, rec


def test_shared_memory_opt_in_on_every_card(dev):
    """The opt-in past 48 KB holds per card: the f64 ``analysis`` (at
    least 55,488 bytes of shared memory at a 4608-sample segment) and
    ``reconstruct``'s IIR route launch on ``cuda:0`` and then on every
    other visible card, each equal to its plain version there."""
    assert k_an.segment_size(4608) == 4608
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    for d in cards:
        with torch.cuda.device(d):
            x, win, rec = opt_in_inputs(d)
            autoc, fsums = k_an.analysis(x, win, 32)
            ref_a, ref_f = k_an.analysis_plain(x, win, 32)
            assert torch.equal(fsums, ref_f)
            tol = 1e-12 * (ref_a.abs() + ref_a[..., :1].abs())
            assert bool(((autoc - ref_a).abs() <= tol).all())
            hold_reconstruct(*rec, None, 0, 32, False,
                             k_rec.residual_limit(16, False))
            torch.cuda.synchronize()
    if len(cards) < 2:
        pytest.skip("one visible card: cuda:0 passed; the opt-in on a "
                    "second card needs a machine with two")
