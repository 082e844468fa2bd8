"""The ``analysis`` kernel: windowed autocorrelation under one or several
windows and the five fixed-order zigzag sums of every row, from one read
of the row.

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

#: samples of a block's pass (``THREADS * RUN`` of ``csrc/analysis.cu``)
PASS = 1152
#: the widest samples whose fixed-order differences the int32 route holds
DIFF_INT32_MAX_BPS = 26
#: the largest segment of a row one block takes
SEG_MAX = 4 * PASS


def segment_size(n: int) -> int:
    """Samples of one block's segment of a row of ``n``: whole passes, at
    most :data:`SEG_MAX`."""
    return min(SEG_MAX, -(-n // PASS) * PASS)


def diff_width(eff_bps: int) -> str:
    """The type of the fixed-order differences for samples of ``eff_bps``
    bits: ``"int32"`` up to :data:`DIFF_INT32_MAX_BPS` (``|D^4 x| <=
    2^(eff_bps+3) <= 2^29``, so its zigzag fits too), else ``"int64"``."""
    return "int32" if eff_bps <= DIFF_INT32_MAX_BPS else "int64"


def analysis_plain(x: torch.Tensor, window: torch.Tensor, max_lag: int,
                   eff_bps: int = 32, fixed_sums: bool = True,
                   ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain version of :func:`analysis`."""
    if window.dim() == 1:
        autoc = autocorrelate(x, max_lag, window=window)
    else:
        autoc = torch.stack([autocorrelate(x, max_lag, window=w)
                             for w in window], dim=-2)
    if not fixed_sums:
        return autoc, None
    wide = diff_width(eff_bps) == "int64"
    return autoc, fixed_order_zz_sums(x.long() if wide else x)


def analysis(x: torch.Tensor, window: torch.Tensor, max_lag: int,
             eff_bps: int = 32, fixed_sums: bool = True,
             ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Autocorrelation lags ``0..max_lag`` of ``x * window`` in the
    window's float type (last sample dropped, products in that type, f64
    sums) under each window and, if ``fixed_sums``, the fixed-order
    zigzag sums of ``x``.

    Args:
      x: int32 samples ``[..., n]`` of at most ``eff_bps`` bits, which
        picks the differences' type (:func:`diff_width`; the default takes
        any int32).  Samples past 2^24 round to f32 to nearest even, as
        ``Tensor.float()`` rounds them.
      window: f32 or f64, one window ``[n]`` or ``W`` windows ``[W, n]``.
    Returns:
      ``(autoc f64 [..., max_lag+1] or [..., W, max_lag+1], fsums int64
      [..., 5] or None)``.
    """
    if x.device.type == "cpu":
        return analysis_plain(x, window, max_lag, eff_bps, fixed_sums)
    n = x.shape[-1]
    lead = x.shape[:-1]
    check(x, "x", torch.int32)
    if window.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"window: dtype {window.dtype}, expected f32 or f64")
    wins = window.reshape(-1, n) if window.dim() == 1 else window
    check(wins, "window", window.dtype, (wins.shape[0], n), x.device)
    if not 0 <= max_lag <= 32 or n < 2 or not wins.shape[0]:
        raise ValueError(f"analysis: max_lag {max_lag} / n {n} / "
                         f"{wins.shape[0]} windows out of range")
    rows, nwin, lags = math.prod(lead), wins.shape[0], max_lag + 1
    autoc = torch.empty((rows, nwin, lags), dtype=torch.float64,
                        device=x.device)
    fsums = (torch.empty((*lead, 5), dtype=torch.int64, device=x.device)
             if fixed_sums else None)
    seg = segment_size(n)
    scratch = tickets = None
    if seg < n:
        scratch = torch.empty((rows, -(-n // seg), nwin * lags + 5),
                              dtype=torch.float64, device=x.device)
        tickets = torch.zeros(rows, dtype=torch.int32, device=x.device)
    launch(bind("analysis", "flacx_analysis", 6, 8),
           [x, wins, autoc, fsums, scratch, tickets],
           [rows, n, max_lag, nwin, int(window.dtype == torch.float64),
            int(fixed_sums), int(diff_width(eff_bps) == "int64"), seg],
           "analysis")
    shape = (*lead, lags) if window.dim() == 1 else (*lead, nwin, lags)
    return autoc.reshape(shape), fsums
