"""Batched LPC analysis: window → autocorrelation → all-order
Levinson-Durbin → error-feedback quantization → integer residuals.

The Levinson recursion yields every order's coefficients in one sweep and
the quantization's sequential error feedback runs over the tap positions,
vectorised over all (batch, order) lanes.  Analysis floats only choose
the coefficients; residuals are exact integers.
"""

from __future__ import annotations

import re
from functools import lru_cache
from math import cos, floor, pi
from typing import NamedTuple

import numpy as np
import torch

from flacx_torch.ops.rice import zigzag


def tukey_window(n: int, r: float = 0.5) -> list[float]:
    """Tukey window as libFLAC's ``FLAC__window_tukey`` defines it.

    Ends are Hann-tapered over ``floor(r/2*n) - 1`` points.
    """
    nr = floor(r / 2.0 * n) - 1
    w = [1.0] * n
    for i in range(nr + 1):
        left = 0.5 - 0.5 * cos(pi * i / nr)
        right = 0.5 - 0.5 * cos(pi * (i + nr) / nr)
        w[i] = left
        w[n - nr - 1 + i] = right
    return w


@lru_cache(maxsize=None)
def tukey_window_np(n: int, r: float = 0.5) -> np.ndarray:
    """Window constants (f64)."""
    return np.asarray(tukey_window(n, r), dtype=np.float64)


@lru_cache(maxsize=None)
def apodization_window_np(name: str, n: int) -> np.ndarray:
    """Apodization window constants by libFLAC-style name (f64, host).

    Supported: ``tukey(P)`` (default P=0.5), ``hann``, ``rectangle``,
    ``triangle``, ``welch``, ``blackman``, ``nuttall``, ``flattop``,
    ``gauss(STDDEV)`` — the libFLAC formulas over ``N-1``.

    >>> bool(np.all(apodization_window_np("rectangle", 4) == 1.0))
    True
    """
    m = re.fullmatch(r"([a-z_]+)(?:\(([^()]*)\))?", name.strip().lower())
    if not m:
        raise ValueError(f"bad apodization window {name!r}")
    kind, arg = m.group(1), m.group(2)
    i = np.arange(n, dtype=np.float64)
    d = max(n - 1, 1)
    if kind == "tukey":
        return tukey_window_np(n, float(arg) if arg else 0.5)
    if arg is not None and kind != "gauss":
        raise ValueError(f"window {kind!r} takes no parameter")
    if kind == "rectangle":
        return np.ones(n, np.float64)
    if kind == "hann":
        return 0.5 - 0.5 * np.cos(2.0 * np.pi * i / d)
    if kind == "triangle":
        return 1.0 - np.abs(2.0 * i - d) / d
    if kind == "welch":
        t = (2.0 * i - d) / d
        return 1.0 - t * t
    if kind == "blackman":
        x = 2.0 * np.pi * i / d
        return 0.42 - 0.5 * np.cos(x) + 0.08 * np.cos(2.0 * x)
    if kind == "nuttall":
        x = 2.0 * np.pi * i / d
        return (0.3635819 - 0.4891775 * np.cos(x)
                + 0.1365995 * np.cos(2.0 * x) - 0.0106411 * np.cos(3.0 * x))
    if kind == "flattop":
        x = 2.0 * np.pi * i / d
        return (1.0 - 1.93 * np.cos(x) + 1.29 * np.cos(2.0 * x)
                - 0.388 * np.cos(3.0 * x) + 0.0322 * np.cos(4.0 * x))
    if kind == "gauss":
        s = float(arg) if arg else 0.25
        if not 0.0 < s <= 0.5:
            raise ValueError("gauss stddev must be in (0, 0.5]")
        t = (2.0 * i - d) / d
        return np.exp(-0.5 * (t / s) ** 2)
    raise ValueError(f"unknown apodization window {kind!r}")


def window_from_numpy(window: np.ndarray) -> torch.Tensor:
    """Host window constants as a CPU tensor of the same dtype (the
    caller moves it to its device)."""
    return torch.from_numpy(np.ascontiguousarray(window))


def autocorrelate(x: torch.Tensor, max_lag: int,
                  window: torch.Tensor | None = None) -> torch.Tensor:
    """Autocorrelation for lags ``0..max_lag`` over the last axis.

    Drops the last product of each lag (the reference encoder's summation
    range).  int32 input is converted to the window's float type (f32
    without a window) and multiplied by the ``window``; each lag product
    is in that type (f32 or f64) and the sums are f64.  Returns
    ``[..., max_lag+1]`` f64.
    """
    n = x.shape[-1]
    w = x
    if x.dtype == torch.int32:
        w = x.to(torch.float32 if window is None else window.dtype)
    if window is not None:
        w = w * window.to(w.dtype)
    cols = [(w[..., : n - lag - 1] * w[..., lag: n - 1]).sum(
        -1, dtype=torch.float64) for lag in range(max_lag + 1)]
    return torch.stack(cols, dim=-1)


def levinson_all_orders(autoc: torch.Tensor, max_order: int,
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Levinson-Durbin for every order ``1..max_order`` in one sweep.

    Args:
      autoc: ``[..., max_order+1]`` f64 autocorrelation values.
    Returns:
      ``(taps, errors, valid)`` — taps ``[..., max_order, max_order]`` f64
      (row ``o-1`` holds the order-``o`` analysis polynomial a[1:],
      zero-padded), the per-order prediction error power, and a validity
      mask ``[..., max_order]`` (False once the recursion degenerates,
      e.g. on digital silence).
    """
    p = max_order
    lead = autoc.shape[:-1]
    dev = autoc.device
    pos = torch.arange(p + 1, device=dev)
    a = torch.zeros((*lead, p + 1), dtype=torch.float64, device=dev)
    a[..., 0] = 1.0
    err = autoc[..., 0]
    ok = torch.ones(lead, dtype=torch.bool, device=dev)
    a_hist, err_hist, ok_hist = [], [], []
    for k in range(p):
        rev_idx = torch.clamp(k + 1 - pos, 0, p)
        av = autoc[..., rev_idx]
        ok = ok & (err > 0.0)
        lam = -(a * av).sum(-1) / torch.where(err > 0.0, err, 1.0)
        lam = torch.where(ok, lam, 0.0)
        arev = a[..., rev_idx]
        upd_mask = (pos <= k + 1).to(a.dtype)
        a = a + lam[..., None] * arev * upd_mask
        err = err * (1.0 - lam * lam)
        a_hist.append(a)
        err_hist.append(err)
        ok_hist.append(ok)
    taps = torch.stack(a_hist, dim=-2)[..., 1:]
    errors = torch.stack(err_hist, dim=-1)
    valid = torch.stack(ok_hist, dim=-1)
    valid = valid & torch.isfinite(taps).all(-1)
    return taps, errors, valid


def quantize_all_orders(taps: torch.Tensor, precision: int,
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback quantization for every order's tap set at once.

    ``shift = precision - floor(log2(max|c|)) - 2`` clamped to the 5-bit
    field, then sequential round-half-even with running error (libFLAC's
    algorithm).

    Args:
      taps: ``[..., orders, taps]`` f64.
    Returns:
      ``(qcoefs i32, shifts i32, valid bool)`` with shapes
      ``[..., orders, taps]``, ``[..., orders]``, ``[..., orders]``.
    """
    p = taps.shape[-1]
    dev = taps.device
    cmax = taps.abs().amax(-1)
    finite = torch.isfinite(cmax) & (cmax > 0.0)
    safe_cmax = torch.where(finite, cmax, 1.0)
    shift = precision - torch.floor(torch.log2(safe_cmax)).to(torch.int32) - 2
    shift = torch.clamp(shift, -32, 15)
    scale = torch.exp2(shift.to(torch.float64))
    emitted_shift = torch.clamp(shift, min=0)

    qmax = (1 << (precision - 1)) - 1
    qmin = -(1 << (precision - 1))
    err = torch.zeros(taps.shape[:-1], dtype=torch.float64, device=dev)
    qs = []
    for t in range(p):
        err = err + taps[..., t] * scale
        q = torch.clamp(torch.round(err), qmin, qmax)   # half to even
        err = err - q
        qs.append(q.to(torch.int32))
    qcoefs = torch.stack(qs, dim=-1)

    # zero out taps beyond each row's order (row o-1 ⇒ order o)
    order = torch.arange(1, taps.shape[-2] + 1, device=dev)
    tap_mask = torch.arange(p, device=dev) < order[:, None]
    qcoefs = torch.where(tap_mask, qcoefs, 0)
    return qcoefs, emitted_shift.to(torch.int32), finite


def shift_right_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[..., i] -> x[..., i-k], zero-filled."""
    if not k:
        return x
    return torch.cat([torch.zeros_like(x[..., :k]), x[..., :-k]], dim=-1)


def predict_residual(x: torch.Tensor, taps: torch.Tensor,
                     shift: torch.Tensor,
                     acc_dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """Exact integer residual ``x[i] - (Σ_j taps_j·x[i-1-j] >> shift)``.

    Args:
      x: ``[..., n]`` integer samples.
      taps: ``[..., T]`` int taps (zero beyond the true order).
      shift: ``[...]`` int arithmetic right shift.
      acc_dtype: accumulator dtype; int32 is exact whenever
        ``bps_eff + 1 + bitlen(Σ|taps|_max) <= 31``.
    Returns:
      ``[..., n]`` acc_dtype (positions ``i < order`` hold junk).
    """
    xa = x.to(acc_dtype)
    acc = torch.zeros_like(xa)
    for j in range(taps.shape[-1]):
        acc = acc + taps[..., j, None].to(acc_dtype) * shift_right_k(xa, j + 1)
    return xa - (acc >> shift[..., None].to(acc_dtype))


def lpc_residuals_all(x: torch.Tensor, qcoefs: torch.Tensor,
                      shifts: torch.Tensor,
                      acc_dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """Exact residuals for every LPC order.

    Args:
      x: ``[..., n]`` int samples; qcoefs ``[..., P, T]`` (row ``o-1`` is
        the order-``o`` predictor, zero past its order); shifts
        ``[..., P]``.
      acc_dtype: see :func:`predict_residual` (same static bound).
    Returns:
      ``[..., P, n]`` acc_dtype; row ``o-1`` valid at positions ``i >= o``.
    """
    p = qcoefs.shape[-2]
    xa = x.to(acc_dtype)
    shifted = [shift_right_k(xa, j + 1) for j in range(p)]
    rows = []
    for o in range(1, p + 1):
        acc = torch.zeros_like(xa)
        for j in range(o):
            acc = acc + qcoefs[..., o - 1, j, None].to(acc_dtype) * shifted[j]
        rows.append(xa - (acc >> shifts[..., o - 1, None].to(acc_dtype)))
    return torch.stack(rows, dim=-2)


class WindowCandidates(NamedTuple):
    """One window's LPC candidates per (frame, channel, order), or the
    best of several windows.  ``rank`` orders the windows (the zigzag
    sum, :data:`RANK_INVALID` where the predictor is invalid); ``maxabs``
    is None where the order search does not compute it."""
    rank: torch.Tensor          # [..., P] int64
    lzz: torch.Tensor           # [..., P] int64 zigzag sum (or estimate)
    maxabs: torch.Tensor | None  # [..., P] int32 max |residual|
    qcoefs: torch.Tensor        # [..., P, T] int32
    qshifts: torch.Tensor       # [..., P] int32
    valid: torch.Tensor         # [..., P] bool


#: Rank of an invalid predictor: after every valid one.
RANK_INVALID = 1 << 50


def window_candidates(lzz: torch.Tensor, maxabs: torch.Tensor | None,
                      qcoefs: torch.Tensor, qshifts: torch.Tensor,
                      valid: torch.Tensor) -> WindowCandidates:
    """One window's candidates, ranked by ``lzz`` (invalid ones last)."""
    return WindowCandidates(torch.where(valid, lzz, RANK_INVALID), lzz,
                            maxabs, qcoefs, qshifts, valid)


def merge_windows(best: WindowCandidates | None,
                  cand: WindowCandidates) -> WindowCandidates:
    """Keep, per (frame, channel, order), the window of smaller rank;
    the earlier window (``best``) keeps a tie."""
    if best is None:
        return cand
    bet = cand.rank < best.rank

    def pick(new, old):
        if new is None:
            return None
        grown = bet.reshape(bet.shape + (1,) * (new.dim() - bet.dim()))
        return torch.where(grown, new, old)
    return WindowCandidates(*(pick(c, b) for c, b in zip(cand, best)))


def mac_int32_ok(eff_bps: int, sum_taps_max: int) -> bool:
    """Whether the int32 MAC is exact: the static bound
    ``eff_bps + 1 + bitlen(Σ|taps|_max) <= 31``."""
    return eff_bps + 1 + max(1, sum_taps_max).bit_length() <= 31


def fused_int32_ok(eff_bps: int, sum_taps_max: int) -> bool:
    """The JAX package's gate for its fused residual kernels: the int32
    MAC, and zigzag partial sums of 64 samples that fit int32
    (``(1 + Σ|taps|_max) < 2^(25 - eff_bps)``)."""
    return (mac_int32_ok(eff_bps, sum_taps_max)
            and (1 + sum_taps_max) < (1 << max(25 - eff_bps, 0)))


def predict_residual_fused(x: torch.Tensor, taps: torch.Tensor,
                           shift: torch.Tensor, order: torch.Tensor,
                           eff_bps: int, sum_taps_max: int,
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Masked LPC residual and its two selection statistics.

    Returns ``(res, lzz, maxabs)``: :func:`predict_residual` with
    positions ``i < order`` zeroed, ``lzz = Σ zigzag(res)`` (int64) and
    ``maxabs = max |res|`` (int32, clamped before narrowing so an int64
    ``|res| ≥ 2^31`` stays ≥ 2^30 and the caller's eligibility compare
    holds).
    """
    n = x.shape[-1]
    acc_dtype = (torch.int32 if mac_int32_ok(eff_bps, sum_taps_max)
                 else torch.int64)
    res = predict_residual(x, taps, shift, acc_dtype)
    i_pos = torch.arange(n, dtype=torch.int32, device=x.device)
    res = res * (i_pos >= order[..., None])
    lzz = zigzag(res).sum(-1, dtype=torch.int64)
    maxabs = torch.clamp(res.abs().amax(-1), max=(1 << 31) - 1) \
        .to(torch.int32)
    return res, lzz, maxabs
