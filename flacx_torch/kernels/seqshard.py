"""The ``seqshard`` kernel: the shard-local statistics of sample-axis
(sequence) sharding, every shard of a span in one launch.

Replaces the shard-local bodies of the JAX package's sequence sharding
(``flacx/parallel/seqshard.py:47-67``, ``:110-121``, ``:152-167``), which
it runs as XLA under ``shard_map``: the windowed autocorrelation
(:func:`seq_autocorr`), the fixed-order zigzag sums
(:func:`seq_fixed`) and the LPC residual statistics (:func:`seq_lpc`).
Source, bound and design in ``csrc/seqshard.cu``.

A *span* is ``n_seq`` contiguous shards of ``local`` samples of every
row (``x [..., n_seq * local]``); its first shard is shard ``shard0`` of
the whole row.  Each shard takes a halo from its neighbour: inside the
span in place, across its edge from ``halo`` (``[..., H]``, the samples a
``ppermute`` would carry), and zeros where ``halo`` is None (the row's
ends).  Every function returns per-shard partials ``[..., n_seq, ...]``;
their sum over the shards (``psum``) is the caller's.
"""

from __future__ import annotations

import math

import torch

from flacx_torch.kernels.build import bind, check, launch
from flacx_torch.ops.fixedpred import shift_right_one
from flacx_torch.ops.lpc import predict_residual
from flacx_torch.ops.rice import zigzag

#: the widest halo: lags of the autocorrelation, taps of the LPC
MAX_HALO = 32
#: the fixed predictors' lookbehind
FIXED_HALO = 4


def _span(x: torch.Tensor, n_seq: int, width: int, what: str) -> int:
    """``local``, the samples of one shard of ``x``'s span, after checking
    that ``n_seq`` shards of at least ``width`` samples cut it."""
    m = x.shape[-1]
    if n_seq < 1 or m % n_seq:
        raise ValueError(f"{what}: {n_seq} shards do not divide rows of {m}")
    local = m // n_seq
    if local < width:
        raise ValueError(f"{what}: shards of {local} samples are shorter "
                         f"than the halo of {width}")
    return local


def _global_index(n_seq: int, local: int, shard0: int,
                  device: torch.device) -> torch.Tensor:
    """``[n_seq, local]`` global sample index of each shard's samples."""
    s = torch.arange(shard0, shard0 + n_seq, device=device)
    return s[:, None] * local + torch.arange(local, device=device)


def _with_halo(x: torch.Tensor, n_seq: int, width: int,
               halo: torch.Tensor | None, ahead: bool) -> torch.Tensor:
    """``[rows, n_seq, local + width]``: each shard of the span's rows with
    its halo, the next shard's first ``width`` samples after it
    (``ahead``) or the previous shard's last ``width`` before it."""
    rows = x.reshape(-1, n_seq, x.shape[-1] // n_seq)
    edge = (torch.zeros((rows.shape[0], width), dtype=x.dtype,
                        device=x.device) if halo is None
            else halo.reshape(-1, width).to(x.dtype))[:, None]
    if ahead:
        nxt = torch.cat([rows[:, 1:, :width], edge], dim=1)
        return torch.cat([rows, nxt], dim=-1)
    prev = torch.cat([edge, rows[:, :-1, rows.shape[-1] - width:]], dim=1)
    return torch.cat([prev, rows], dim=-1)


def seq_autocorr_plain(xw: torch.Tensor, max_lag: int, n_seq: int,
                       halo: torch.Tensor | None = None, shard0: int = 0,
                       n: int | None = None) -> torch.Tensor:
    """Plain version of :func:`seq_autocorr`."""
    local = _span(xw, n_seq, max_lag, "seq_autocorr")
    n = (shard0 + n_seq) * local if n is None else n
    ext = _with_halo(xw, n_seq, max_lag, halo, ahead=True)
    jg = _global_index(n_seq, local, shard0, xw.device)
    cols = []
    for lag in range(max_lag + 1):
        prod = ext[..., :local] * ext[..., lag: lag + local]
        cols.append(torch.where(jg <= n - lag - 2, prod, 0).sum(
            -1, dtype=torch.float64))
    return torch.stack(cols, dim=-1).reshape(
        *xw.shape[:-1], n_seq, max_lag + 1)


def seq_fixed_plain(x: torch.Tensor, n_seq: int,
                    halo: torch.Tensor | None = None, shard0: int = 0,
                    ) -> torch.Tensor:
    """Plain version of :func:`seq_fixed`."""
    local = _span(x, n_seq, FIXED_HALO, "seq_fixed")
    cur = _with_halo(x, n_seq, FIXED_HALO, halo, ahead=False)
    jg = _global_index(n_seq, local, shard0, x.device)
    cols = []
    for o in range(5):
        if o:
            cur = cur - shift_right_one(cur)
        cols.append((zigzag(cur[..., FIXED_HALO:]) * (jg >= o)).sum(
            -1, dtype=torch.int64))
    return torch.stack(cols, dim=-1).reshape(*x.shape[:-1], n_seq, 5)


def seq_lpc_plain(x: torch.Tensor, taps: torch.Tensor, shift: torch.Tensor,
                  order: torch.Tensor, n_seq: int,
                  halo: torch.Tensor | None = None, shard0: int = 0,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`seq_lpc`."""
    t = taps.shape[-1]
    local = _span(x, n_seq, max(t, 1), "seq_lpc")
    ext = _with_halo(x, n_seq, t, halo, ahead=False)
    lead = x.shape[:-1]
    res = predict_residual(ext, taps.reshape(-1, 1, t),
                           shift.reshape(-1, 1))[..., t:]
    jg = _global_index(n_seq, local, shard0, x.device)
    keep = jg >= order.reshape(-1, 1, 1)
    zz = ((res << 1) ^ (res >> 63)) * keep
    return (zz.sum(-1).reshape(*lead, n_seq),
            (res.abs() * keep).amax(-1).reshape(*lead, n_seq))


def _rows_and_halo(x: torch.Tensor, halo: torch.Tensor | None,
                   width: int, dtype: torch.dtype, what: str) -> int:
    rows = math.prod(x.shape[:-1])
    check(x, "x", dtype)
    if halo is not None:
        check(halo, "halo", dtype, (*x.shape[:-1], width), x.device)
    if rows < 1:
        raise ValueError(f"{what}: no rows")
    return rows


def seq_autocorr(xw: torch.Tensor, max_lag: int, n_seq: int,
                 halo: torch.Tensor | None = None, shard0: int = 0,
                 n: int | None = None) -> torch.Tensor:
    """Each shard's partial autocorrelation for lags ``0..max_lag``.

    ``out[..., s, l]`` is the f64 sum, over the samples ``jg <= n - l - 2``
    of shard ``s``, of the products ``xw[jg] * xw[jg + l]`` in ``xw``'s
    type: summed over the shards, the autocorrelation of
    :func:`flacx_torch.ops.lpc.autocorrelate` up to summation order.

    Args:
      xw: windowed samples, f32 or f64 ``[..., n_seq * local]``.
      max_lag: at most 32, and at most ``local``.
      halo: ``[..., max_lag]``, the first samples after the span (the next
        shard's head), or None at the row's end.
      shard0, n: the span's first shard in the row, and the row's length
        (by default the span ends the row).
    Returns:
      f64 ``[..., n_seq, max_lag + 1]``.
    """
    if xw.device.type == "cpu":
        return seq_autocorr_plain(xw, max_lag, n_seq, halo, shard0, n)
    if xw.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"xw: dtype {xw.dtype}, expected f32 or f64")
    if not 0 <= max_lag <= MAX_HALO:
        raise ValueError(f"seq_autocorr: max_lag {max_lag} out of range")
    local = _span(xw, n_seq, max_lag, "seq_autocorr")
    n = (shard0 + n_seq) * local if n is None else n
    if shard0 < 0 or (shard0 + n_seq) * local > n:
        raise ValueError(f"seq_autocorr: shards {shard0}..{shard0 + n_seq} "
                         f"of {local} pass the row's {n} samples")
    rows = _rows_and_halo(xw, halo, max_lag, xw.dtype, "seq_autocorr")
    out = torch.empty((*xw.shape[:-1], n_seq, max_lag + 1),
                      dtype=torch.float64, device=xw.device)
    launch(bind("seqshard", "flacx_seq_autocorr", 3, 7),
           [xw, halo, out],
           [rows, xw.shape[-1], n_seq, shard0, n, max_lag,
            int(xw.dtype == torch.float64)], "seq_autocorr")
    return out


def seq_fixed(x: torch.Tensor, n_seq: int,
              halo: torch.Tensor | None = None, shard0: int = 0,
              ) -> torch.Tensor:
    """Each shard's partial zigzag sums of the fixed-order residuals
    ``D^o x`` (``o = 0..4``, in ``x``'s type), over its samples ``jg >=
    o``: summed over the shards,
    :func:`flacx_torch.ops.fixedpred.fixed_order_zz_sums` bit for bit.

    Args:
      x: int32 or int64 ``[..., n_seq * local]``, local at least 4.
      halo: ``[..., 4]``, the 4 samples before the span, or None at the
        row's start.
    Returns:
      int64 ``[..., n_seq, 5]``.
    """
    if x.device.type == "cpu":
        return seq_fixed_plain(x, n_seq, halo, shard0)
    if x.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"x: dtype {x.dtype}, expected int32 or int64")
    _span(x, n_seq, FIXED_HALO, "seq_fixed")
    if shard0 < 0:
        raise ValueError(f"seq_fixed: shard0 {shard0}")
    rows = _rows_and_halo(x, halo, FIXED_HALO, x.dtype, "seq_fixed")
    out = torch.empty((*x.shape[:-1], n_seq, 5), dtype=torch.int64,
                      device=x.device)
    launch(bind("seqshard", "flacx_seq_fixed", 3, 5), [x, halo, out],
           [rows, x.shape[-1], n_seq, shard0, int(x.dtype == torch.int64)],
           "seq_fixed")
    return out


def seq_lpc(x: torch.Tensor, taps: torch.Tensor, shift: torch.Tensor,
            order: torch.Tensor, n_seq: int,
            halo: torch.Tensor | None = None, shard0: int = 0,
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each shard's partial LPC residual statistics: ``res = x - (Σ_k
    taps_k·x[jg-1-k] >> shift)`` with an int64 MAC, over the shard's
    samples ``jg >= order``, the int64 sum of ``(res << 1) ^ (res >> 63)``
    and the int64 max ``|res|``, unclamped (a masked sample counts 0).

    Args:
      x: int32 ``[..., n_seq * local]``; taps int32 ``[..., t]`` (1 ≤ t ≤
        32, t ≤ local); shift (0..63) and order int32 ``[...]``.
      halo: int32 ``[..., t]``, the ``t`` samples before the span, or None
        at the row's start.
    Returns:
      ``(zz_sum, maxabs)``, int64 ``[..., n_seq]`` each.
    """
    if x.device.type == "cpu":
        return seq_lpc_plain(x, taps, shift, order, n_seq, halo, shard0)
    t = taps.shape[-1]
    if not 1 <= t <= MAX_HALO:
        raise ValueError(f"seq_lpc: {t} taps, expected 1..{MAX_HALO}")
    _span(x, n_seq, t, "seq_lpc")
    if shard0 < 0:
        raise ValueError(f"seq_lpc: shard0 {shard0}")
    lead = x.shape[:-1]
    rows = _rows_and_halo(x, halo, t, torch.int32, "seq_lpc")
    check(taps, "taps", torch.int32, (*lead, t), x.device)
    check(shift, "shift", torch.int32, lead, x.device)
    check(order, "order", torch.int32, lead, x.device)
    out = torch.empty((*lead, n_seq, 2), dtype=torch.int64, device=x.device)
    launch(bind("seqshard", "flacx_seq_lpc", 6, 5),
           [x, halo, taps, shift, order, out],
           [rows, x.shape[-1], n_seq, shard0, t], "seq_lpc")
    return out[..., 0], out[..., 1]
