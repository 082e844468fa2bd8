"""The frozen counts of ``portbench/roofline.py`` pinned at the shapes of
``PERF.md`` §6's kernel table (the headline batch: 1024 frames, four
virtual channels, block 4608, LPC order 12; the hi-res batch: 128 frames,
block 16384, order 32), to the bound it prints for each."""

import pytest
import torch

from portbench import roofline


def ms(name, args, out):
    return roofline.bound_s(name, args, out) * 1e3


def analysis_args(frames, n, lags):
    x = torch.zeros((frames, 4, n), dtype=torch.int32)
    w = torch.zeros(n, dtype=torch.float32)
    out = (torch.zeros((frames, 4, lags), dtype=torch.float64),
           torch.zeros((frames, 4, 5), dtype=torch.int64))
    return (x, w, lags - 1, 17), out


@pytest.mark.parametrize("frames,n,lags,want", [(1024, 4608, 13, 0.0259),
                                                (128, 16384, 33, 0.0241)])
def test_analysis_bound(frames, n, lags, want):
    args, out = analysis_args(frames, n, lags)
    assert round(ms("analysis", args, out), 4) == want


def residual_args(rows):
    x = torch.zeros((1024, rows, 4608), dtype=torch.int32)
    taps = torch.ones((1024, rows, 12), dtype=torch.int32)
    shift = torch.zeros((1024, rows), dtype=torch.int32)
    order = torch.full((1024, rows), 12, dtype=torch.int32)
    return (x, taps, shift, order, 17, 12 << 4)


def test_lpc_residual_stats_bound():
    args = residual_args(4)
    out = (torch.zeros((1024, 4), dtype=torch.int64),
           torch.zeros((1024, 4), dtype=torch.int32))
    assert round(ms("lpc_residual_stats", args, out), 4) == 0.0226


def test_lpc_residual_zz_bound():
    args = residual_args(2) + (torch.int32,)
    out = torch.zeros((1024, 2, 4608), dtype=torch.int32)
    # the zz mode on the two chosen channels: x read, zz written
    assert round(ms("lpc_residual_zz", args, out), 4) == 0.0226


def test_rice_stats_bound():
    zz = torch.zeros((1024, 2, 4608), dtype=torch.int32)
    order = torch.zeros((1024, 2), dtype=torch.int32)
    out = {po: tuple(torch.zeros((1024, 2, 1 << po), dtype=torch.int32)
                     for _ in range(5)) for po in range(6)}
    assert round(ms("rice_stats", (zz, order, tuple(range(6)), 23), out),
                 4) == 0.0120


def test_crc16_rows_bound_counts_the_frame_bytes():
    rows = torch.zeros((256, 13312), dtype=torch.uint8)
    lens = torch.full((256,), 13000, dtype=torch.int32)
    bound = ms("crc16_rows", (rows, lens), None)
    assert bound == pytest.approx((256 * 13000 + 8 * 256 + 4)
                                  / roofline.HBM_BYTES_PER_S * 1e3)


def test_hand_kernel_names():
    assert roofline.is_hand_kernel("void analysis_kernel<12>(Args)",
                                   roofline.ENCODE)
    assert roofline.is_hand_kernel("frame_pack_kernel_place(Args)",
                                   ("frame_pack",))
    assert not roofline.is_hand_kernel("void at::native::elementwise",
                                       roofline.ENCODE)
    assert not roofline.is_hand_kernel("reconstruct_kernel_iir",
                                       roofline.ENCODE)
