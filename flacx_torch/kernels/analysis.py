"""The ``analysis`` kernel: windowed autocorrelation and the five
fixed-order zigzag sums of every row, from one read of the row.

Replaces the TPU kernels ``flacx/kernels/autocorr_tile.py::autocorr_tiled``
and ``flacx/kernels/zzsum_tile.py::fixed_order_sums``; source, bound and
design in ``csrc/analysis.cu``.
"""

from __future__ import annotations

import math

import torch

from flacx_torch.kernels.build import bind, check, launch
from flacx_torch.ops.fixedpred import fixed_order_zz_sums
from flacx_torch.ops.lpc import autocorrelate


def analysis_plain(x: torch.Tensor, window: torch.Tensor, max_lag: int,
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`analysis`."""
    return autocorrelate(x, max_lag, window=window), fixed_order_zz_sums(x)


def analysis(x: torch.Tensor, window: torch.Tensor, max_lag: int,
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Autocorrelation lags ``0..max_lag`` of ``f32(x) * window`` (last
    sample dropped, f32 products, f64 sums) and the fixed-order zigzag
    sums of ``x``.

    Args:
      x: int32 samples ``[..., n]``.
      window: f32 ``[n]``.
    Returns:
      ``(autoc f64 [..., max_lag+1], fsums int64 [..., 5])``.
    """
    if x.device.type == "cpu":
        return analysis_plain(x, window, max_lag)
    n = x.shape[-1]
    lead = x.shape[:-1]
    check(x, "x", torch.int32)
    check(window, "window", torch.float32, (n,), x.device)
    if not 0 <= max_lag <= 32 or n < 2:
        raise ValueError(f"analysis: max_lag {max_lag} / n {n} out of range")
    autoc = torch.empty((*lead, max_lag + 1), dtype=torch.float64,
                        device=x.device)
    fsums = torch.empty((*lead, 5), dtype=torch.int64, device=x.device)
    launch(bind("analysis", "flacx_analysis", 4, 3),
           [x, window, autoc, fsums], [math.prod(lead), n, max_lag],
           "analysis")
    analysis.launches += 1
    return autoc, fsums


analysis.launches = 0
