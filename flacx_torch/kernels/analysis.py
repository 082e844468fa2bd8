"""The ``analysis`` kernel: windowed autocorrelation and the five
fixed-order zigzag sums of every row, from one read of the row.

Replaces the TPU kernels ``flacx/kernels/autocorr_tile.py::autocorr_tiled``
and ``flacx/kernels/zzsum_tile.py::fixed_order_sums``; its f64 mode is the
counterpart of the JAX package's f64 XLA analysis.  Source, bound and
design in ``csrc/analysis.cu``.
"""

from __future__ import annotations

import math

import torch

from flacx_torch.kernels.build import bind, check, launch
from flacx_torch.ops.fixedpred import fixed_order_zz_sums
from flacx_torch.ops.lpc import autocorrelate


def analysis_plain(x: torch.Tensor, window: torch.Tensor, max_lag: int,
                   fixed_sums: bool = True,
                   ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain version of :func:`analysis`."""
    return (autocorrelate(x, max_lag, window=window),
            fixed_order_zz_sums(x) if fixed_sums else None)


def analysis(x: torch.Tensor, window: torch.Tensor, max_lag: int,
             fixed_sums: bool = True,
             ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Autocorrelation lags ``0..max_lag`` of ``x * window`` in the
    window's float type (last sample dropped, products in that type, f64
    sums) and, if ``fixed_sums``, the fixed-order zigzag sums of ``x``.

    Args:
      x: int32 samples ``[..., n]``.
      window: f32 or f64 ``[n]``.
    Returns:
      ``(autoc f64 [..., max_lag+1], fsums int64 [..., 5] or None)``.
    """
    if x.device.type == "cpu":
        return analysis_plain(x, window, max_lag, fixed_sums)
    n = x.shape[-1]
    lead = x.shape[:-1]
    check(x, "x", torch.int32)
    if window.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"window: dtype {window.dtype}, expected f32 or f64")
    check(window, "window", window.dtype, (n,), x.device)
    if not 0 <= max_lag <= 32 or n < 2:
        raise ValueError(f"analysis: max_lag {max_lag} / n {n} out of range")
    autoc = torch.empty((*lead, max_lag + 1), dtype=torch.float64,
                        device=x.device)
    fsums = (torch.empty((*lead, 5), dtype=torch.int64, device=x.device)
             if fixed_sums else None)
    launch(bind("analysis", "flacx_analysis", 4, 5),
           [x, window, autoc, fsums],
           [math.prod(lead), n, max_lag, int(window.dtype == torch.float64),
            int(fixed_sums)], "analysis")
    analysis.launches += 1
    return autoc, fsums


analysis.launches = 0
