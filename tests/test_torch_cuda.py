"""The four CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA card and skip without one (the CUDA
kernels have no CPU mode).  Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Shapes here are the edges the headline batch does not reach: rows that
end mid-tile, silence, the widest lags, every predictor order, and zigzag
rows past every Rice code cap.  Integers must match exactly; the
autocorrelation within rtol 1e-9 (f64 sums of the same f32 products in
another order) or n·eps64·autoc[0] near zero.
"""

import numpy as np
import pytest
import torch

from flacx_torch.format import FIXED_PREDICTOR_TAPS
from flacx_torch.kernels import analysis as k_an
from flacx_torch.kernels import frame_pack as k_fp
from flacx_torch.kernels import lpc_residual as k_lr
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


@pytest.mark.parametrize("n,porders,kmax", [
    (4608, (0, 1, 2, 3, 4, 5), 23), (4096, (0, 2, 7), 30), (1152, (3,), 0)])
def test_rice_stats_kernel(dev, n, porders, kmax):
    rng = np.random.default_rng(n)
    scale = 2.0 ** rng.integers(0, 30, size=(6, 2, 1))
    zz = np.minimum(rng.exponential(size=(6, 2, n)) * scale, 2 ** 30 - 1)
    order = rng.integers(0, 13, size=(6, 2)).astype(np.int32)
    zz = np.where(np.arange(n) < order[..., None], 0, zz).astype(np.int32)
    zt, ot = torch.from_numpy(zz).to(dev), torch.from_numpy(order).to(dev)
    got = k_rs.rice_stats(zt, ot, porders, kmax)
    ref = rice.rice_stats(zt, ot, porders, kmax)
    torch.cuda.synchronize()
    for po in ref:
        assert all(torch.equal(a, b) for a, b in zip(got[po], ref[po])), po


def test_frame_pack_kernel(dev):
    """Every subframe kind, escapes, and multi-byte frame numbers."""
    b, n, psize_min, prec = 6, 4608, 144, 5
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
    bps = np.full((b, 2), 16, np.int32)
    t = {k: torch.from_numpy(v).to(dev) for k, v in dict(
        x=x, kind=kind, order=order, taps=taps, shift=shift,
        bps=bps).items()}
    zz = k_lr.lpc_residual_zz_plain(t["x"], t["taps"], t["shift"],
                                    t["order"], 17, 15)
    porders = (0, 1, 2, 3, 4, 5)
    plan = rice.exact_plan(zz, t["order"], porders, porders, 23)
    hdr = frame_header_symbols(
        torch.tensor([0, 5, 127, 128, 70000, 1 << 33], device=dev),
        torch.tensor([1, 8, 9, 10, 1, 1], dtype=torch.int32, device=dev), n)
    sh_v, sh_l = emit.subframe_header_symbols(
        t["kind"], t["order"], t["bps"], t["x"], t["taps"], t["shift"], prec,
        plan)
    pv, pl = emit.partition_param_symbols(t["kind"], plan)
    kesc = (plan.k_seg.int() | (plan.esc_seg.int() << 7)).contiguous()
    args = (hdr.values, hdr.lengths, sh_v, sh_l, pv, pl, zz, t["x"], kesc,
            t["kind"], t["order"], t["bps"], psize_min, 19712)
    out, length = k_fp.frame_pack(*args)
    ref, ref_len = k_fp.frame_pack_plain(*args)
    torch.cuda.synchronize()
    assert bool(plan.esc_seg.any())
    assert torch.equal(length, ref_len) and torch.equal(out, ref)
