"""The ``lpc_residual`` kernel: the integer LPC residual of every row, in
a stats mode (Σ zigzag and max |res|, the residual never written), a zz
mode (the zigzag residual written out) and a res mode (the masked
residual written out with its stats).

Replaces the TPU kernels ``flacx/kernels/lpcres_tile.py::
lpc_residual_stats`` (stats mode), ``::zigzag_residual_tiles`` (zz mode),
their two-limb split MAC included, and ``::lpc_residual_tiles`` (res
mode); source, bound and design in ``csrc/lpc_residual.cu``.  The stats
and zz modes have two MAC widths: int32 under its static bound, and an
int64 ("wide") MAC that is exact for every row; the zz mode writes int32
(the residual narrowed first) or int64 (past 24-bit samples, whole).  The
res mode runs only
under the JAX package's int32 gate (``ops.lpc.fused_int32_ok``), as the
TPU kernel does.
"""

from __future__ import annotations

import math

import torch

from flacx_torch.kernels.build import bind, check, launch
from flacx_torch.ops.lpc import (fused_int32_ok, mac_int32_ok,
                                 predict_residual_fused)
from flacx_torch.ops.rice import zigzag

MAX_TAPS = 32
#: samples of a block's pass (``THREADS * RUN`` of ``csrc/lpc_residual.cu``)
PASS = 1152
#: the largest segment of a row one block takes
SEG_MAX = 2 * PASS


def segment_size(n: int) -> int:
    """Samples of one block's segment of a row of ``n``: whole passes, at
    most :data:`SEG_MAX`."""
    return min(SEG_MAX, -(-n // PASS) * PASS)


def _stats_outputs(x: torch.Tensor, seg: int):
    """``(lzz, maxabs)`` for the kernel: zeros where a row has several
    segments (their blocks add into them), else left to be written."""
    new = torch.zeros if seg < x.shape[-1] else torch.empty
    return (new(x.shape[:-1], dtype=torch.int64, device=x.device),
            new(x.shape[:-1], dtype=torch.int32, device=x.device))


def mac_width(eff_bps: int, sum_taps_max: int) -> str:
    """The MAC the kernel runs for this static width bound: ``"int32"``
    where the single-int32 MAC is exact, else ``"wide"`` (int64)."""
    return "int32" if mac_int32_ok(eff_bps, sum_taps_max) else "wide"


def lpc_residual_stats_plain(x: torch.Tensor, taps: torch.Tensor,
                             shift: torch.Tensor, order: torch.Tensor,
                             eff_bps: int, sum_taps_max: int,
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`lpc_residual_stats`."""
    _, lzz, maxabs = predict_residual_fused(x, taps, shift, order, eff_bps,
                                            sum_taps_max)
    return lzz, maxabs


def lpc_residual_zz_plain(x: torch.Tensor, taps: torch.Tensor,
                          shift: torch.Tensor, order: torch.Tensor,
                          eff_bps: int, sum_taps_max: int,
                          out_dtype: torch.dtype = torch.int32,
                          ) -> torch.Tensor:
    """Plain version of :func:`lpc_residual_zz`."""
    res, _, _ = predict_residual_fused(x, taps, shift, order, eff_bps,
                                       sum_taps_max)
    return zigzag(res.to(out_dtype))


def lpc_residual_res_plain(x: torch.Tensor, taps: torch.Tensor,
                           shift: torch.Tensor, order: torch.Tensor,
                           eff_bps: int, sum_taps_max: int,
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Plain version of :func:`lpc_residual_res`."""
    return predict_residual_fused(x, taps, shift, order, eff_bps,
                                  sum_taps_max)


def _check_inputs(x, taps, shift, order):
    lead = x.shape[:-1]
    check(x, "x", torch.int32)
    check(taps, "taps", torch.int32, (*lead, taps.shape[-1]), x.device)
    check(shift, "shift", torch.int32, lead, x.device)
    check(order, "order", torch.int32, lead, x.device)
    if taps.shape[-1] > MAX_TAPS or x.shape[-1] < 1:
        raise ValueError(f"lpc_residual: {taps.shape[-1]} taps > {MAX_TAPS}")
    return math.prod(lead), x.shape[-1], taps.shape[-1]


def lpc_residual_stats(x: torch.Tensor, taps: torch.Tensor,
                       shift: torch.Tensor, order: torch.Tensor,
                       eff_bps: int, sum_taps_max: int,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(Σ zigzag(res) int64, min(max |res|, 2^31 - 1) int32)`` per row,
    where ``res[i] = x[i] - (Σ_j taps_j·x[i-1-j] >> shift)`` and ``res[i <
    order] = 0``.

    Args:
      x: int32 ``[..., n]``; taps int32 ``[..., T]`` (T ≤ 32, zero past
        the order, precision ≤ 15); shift and order int32 ``[...]``.
      eff_bps, sum_taps_max: the static width bound that picks the MAC
        (:func:`mac_width`).
    """
    if x.device.type == "cpu":
        return lpc_residual_stats_plain(x, taps, shift, order, eff_bps,
                                        sum_taps_max)
    rows, n, t = _check_inputs(x, taps, shift, order)
    wide = mac_width(eff_bps, sum_taps_max) == "wide"
    seg = segment_size(n)
    lzz, maxabs = _stats_outputs(x, seg)
    launch(bind("lpc_residual", "flacx_lpc_residual_stats", 6, 5),
           [x, taps, shift, order, lzz, maxabs], [rows, n, t, int(wide), seg],
           "lpc_residual_stats")
    return lzz, maxabs


def lpc_residual_zz(x: torch.Tensor, taps: torch.Tensor,
                    shift: torch.Tensor, order: torch.Tensor,
                    eff_bps: int, sum_taps_max: int,
                    out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """``zigzag(res)`` ``[..., n]`` in ``out_dtype``, zero at ``i <
    order`` (the other arguments as :func:`lpc_residual_stats`): int32
    narrows the residual to int32 first, as the encoder's int32 working
    type does up to 24-bit samples; int64 keeps every residual whole, the
    encoder's working type past them."""
    if out_dtype not in (torch.int32, torch.int64):
        raise TypeError(f"lpc_residual_zz: out_dtype {out_dtype}, expected "
                        "int32 or int64")
    if x.device.type == "cpu":
        return lpc_residual_zz_plain(x, taps, shift, order, eff_bps,
                                     sum_taps_max, out_dtype)
    rows, n, t = _check_inputs(x, taps, shift, order)
    zz = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    wide = mac_width(eff_bps, sum_taps_max) == "wide"
    launch(bind("lpc_residual", "flacx_lpc_residual_zz", 5, 6),
           [x, taps, shift, order, zz],
           [rows, n, t, int(wide), segment_size(n),
            int(out_dtype == torch.int64)], "lpc_residual_zz")
    return zz


def lpc_residual_res(x: torch.Tensor, taps: torch.Tensor,
                     shift: torch.Tensor, order: torch.Tensor,
                     eff_bps: int, sum_taps_max: int,
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(res int32 [..., n], lzz int64, maxabs int32)``: the residual of
    :func:`lpc_residual_stats`, zero at ``i < order``, with its two
    statistics, from one pass.  Only under the int32 gate
    (``ops.lpc.fused_int32_ok``), which the caller checks."""
    if x.device.type == "cpu":
        return lpc_residual_res_plain(x, taps, shift, order, eff_bps,
                                      sum_taps_max)
    assert fused_int32_ok(eff_bps, sum_taps_max), "past the int32 gate"
    rows, n, t = _check_inputs(x, taps, shift, order)
    res = torch.empty_like(x)
    seg = segment_size(n)
    lzz, maxabs = _stats_outputs(x, seg)
    launch(bind("lpc_residual", "flacx_lpc_residual_res", 7, 4),
           [x, taps, shift, order, res, lzz, maxabs], [rows, n, t, seg],
           "lpc_residual_res")
    return res, lzz, maxabs
