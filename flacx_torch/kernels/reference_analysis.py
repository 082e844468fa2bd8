"""The ``reference_analysis`` kernels of conformance mode: ``reference_lpc``
(the reference encoder's f64 LPC chain of every row) and
``abs_residual_sums`` (Σ|residual| of every fixed and LPC order).

The JAX package runs both as XLA, with no ``pallas_call``:
``reference_lpc`` replaces ``flacx/conformance.py:325-329`` (the Tukey
window product, ``ordered_autocorr``, ``levinson_reference``,
``quantize_reference``), ``abs_residual_sums`` the residuals and sums at
``flacx/conformance.py:307-319`` and ``:330-333``.  Source, bound and
design in ``csrc/reference_analysis.cu``.  The plain versions are the
functions of :mod:`flacx_torch.conformance`.
"""

from __future__ import annotations

import math

import torch

from flacx_torch.kernels.analysis import diff_width
from flacx_torch.kernels.build import bind, check, launch
from flacx_torch.kernels.lpc_residual import mac_width
from flacx_torch.ops.lpc import predict_residual, shift_right_k

MAX_ORDER = 32
#: the largest segment of a row one block of ``abs_residual_sums`` takes
SEG_MAX = 2304


def segment_size(n: int) -> int:
    """Samples of one block's segment of a row of ``n`` in
    ``abs_residual_sums``: the row in equal parts of at most
    :data:`SEG_MAX`, rounded up to 32."""
    parts = -(-n // SEG_MAX)
    return (-(-n // parts) + 31) // 32 * 32


def sample_limbs(eff_bps: int) -> int:
    """8-bit limbs of a sample of ``eff_bps`` bits in ``abs_residual_sums``'
    tensor-core MAC: 2 up to 16, 3 up to 24, else 4."""
    return 2 if eff_bps <= 16 else 3 if eff_bps <= 24 else 4


def reference_lpc_plain(x: torch.Tensor, window: torch.Tensor,
                        max_order: int, precision: int,
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """Plain version of :func:`reference_lpc`."""
    from flacx_torch.conformance import (levinson_reference,
                                         ordered_autocorr,
                                         quantize_reference)
    autoc = ordered_autocorr(x.double() * window, max_order)
    taps, valid = levinson_reference(autoc, max_order)
    qcoefs, shift = quantize_reference(taps, precision)
    return (autoc, torch.where(valid[..., None], qcoefs, 0),
            torch.where(valid, shift, 0), valid)


def abs_residual_sums_plain(x: torch.Tensor, qcoefs: torch.Tensor,
                            qshift: torch.Tensor, eff_bps: int,
                            sum_taps_max: int,
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`abs_residual_sums` (int64 throughout)."""
    n = x.shape[-1]
    p = qcoefs.shape[-1]
    i_pos = torch.arange(n, device=x.device)
    # the order-o fixed residual is the o-th difference (binomial taps)
    fixed, cur = [], x.long()
    for o in range(5):
        if o:
            cur = cur - shift_right_k(cur, 1)
        fixed.append((cur * (i_pos >= o)).abs().sum(-1))
    lpc = [(predict_residual(x, qcoefs[..., o, :o + 1], qshift[..., o])
            * (i_pos > o)).abs().sum(-1) for o in range(p)]
    return (torch.stack(fixed, dim=-1),
            torch.stack(lpc, dim=-1) if p else
            torch.zeros((*x.shape[:-1], 0), dtype=torch.int64,
                        device=x.device))


def reference_lpc(x: torch.Tensor, window: torch.Tensor, max_order: int,
                  precision: int,
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """The reference encoder's LPC analysis of every row, bit for bit.

    ``w = x · window`` (f64), its autocorrelation summed strictly left to
    right over the reference's range (:func:`flacx_torch.conformance.
    ordered_autocorr`), the reference's Levinson-Durbin and its
    error-feedback quantization of every order.

    Args:
      x: int32 ``[..., n]``; window: f64 ``[n]``; ``1 <= max_order <=
        min(32, n - 1)``; precision: the coefficients' bits (5..15).
    Returns:
      ``(autoc f64 [..., P+1], qcoefs int32 [..., P, P], shift int32
      [..., P], valid bool [..., P])``; row ``o-1`` of ``qcoefs`` is the
      order-``o`` predictor, zero past ``o``; ``qcoefs`` and ``shift`` are
      zero where ``valid`` is False.
    """
    if x.device.type == "cpu":
        return reference_lpc_plain(x, window, max_order, precision)
    lead, n = x.shape[:-1], x.shape[-1]
    check(x, "x", torch.int32)
    check(window, "window", torch.float64, (n,), x.device)
    if not 1 <= max_order <= min(MAX_ORDER, n - 1):
        raise ValueError(f"reference_lpc: order {max_order} outside 1.."
                         f"{min(MAX_ORDER, n - 1)}")
    if not 2 <= precision <= 15:
        raise ValueError(f"reference_lpc: precision {precision}")
    p = max_order
    dev = x.device
    autoc = torch.empty((*lead, p + 1), dtype=torch.float64, device=dev)
    qcoefs = torch.empty((*lead, p, p), dtype=torch.int32, device=dev)
    shift = torch.empty((*lead, p), dtype=torch.int32, device=dev)
    valid = torch.empty((*lead, p), dtype=torch.bool, device=dev)
    launch(bind("reference_analysis", "flacx_reference_lpc", 6, 4),
           [x, window, autoc, qcoefs, shift, valid],
           [math.prod(lead), n, p, precision], "reference_lpc")
    return autoc, qcoefs, shift, valid


def abs_residual_sums(x: torch.Tensor, qcoefs: torch.Tensor,
                      qshift: torch.Tensor, eff_bps: int, sum_taps_max: int,
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(Σ|res| of the fixed orders 0..4, int64 [..., 5]; Σ|res| of the
    LPC orders 1..P, int64 [..., P])`` per row, each residual ``x[i] -
    (Σ_j c_j·x[i-1-j] >> shift)`` zero at ``i < order``; the residuals are
    never written.

    Args:
      x: int32 ``[..., n]``; qcoefs: int32 ``[..., P, P]`` (row ``o-1``
        the order-``o`` predictor, zero past ``o``; P <= 32, may be 0);
        qshift: int32 ``[..., P]``.
      eff_bps, sum_taps_max: the static bound on the samples' width
        (``x`` must lie within ``eff_bps`` bits) and on Σ|taps| of the LPC
        orders; they pick the sample limbs, the int32 or the int64 MAC
        (``lpc_residual.mac_width``; int64 with four sample limbs), and
        int32 or int64 fixed-order differences (``analysis.diff_width``).
    """
    if x.device.type == "cpu":
        return abs_residual_sums_plain(x, qcoefs, qshift, eff_bps,
                                       sum_taps_max)
    lead, n = x.shape[:-1], x.shape[-1]
    p = qcoefs.shape[-1]
    check(x, "x", torch.int32)
    check(qcoefs, "qcoefs", torch.int32, (*lead, p, p), x.device)
    check(qshift, "qshift", torch.int32, (*lead, p), x.device)
    if p > MAX_ORDER or n < 1:
        raise ValueError(f"abs_residual_sums: order {p} > {MAX_ORDER}")
    limbs = sample_limbs(eff_bps)
    wide = mac_width(eff_bps, sum_taps_max) == "wide" or limbs == 4
    seg = segment_size(n)
    new = torch.zeros if seg < n else torch.empty
    fsum = new((*lead, 5), dtype=torch.int64, device=x.device)
    lsum = new((*lead, p), dtype=torch.int64, device=x.device)
    launch(bind("reference_analysis", "flacx_abs_residual_sums", 5, 7),
           [x, qcoefs, qshift, fsum, lsum],
           [math.prod(lead), n, p, int(wide), limbs,
            int(diff_width(eff_bps) == "int64"), seg],
           "abs_residual_sums")
    return fsum, lsum


def floor_log2_device(x: torch.Tensor) -> torch.Tensor:
    """``floor_log2`` of every element of f64 CUDA ``x`` (positive,
    finite) as ``reference_lpc`` computes it on the card (int32), for
    holding it against :func:`flacx_torch.conformance.floor_log2`."""
    check(x, "x", torch.float64)
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    launch(bind("reference_analysis", "flacx_floor_log2", 2, 1), [x, out],
           [x.numel()], "floor_log2")
    return out


def dadd_latency_probe(steps: int, device: torch.device) -> torch.Tensor:
    """Launch one thread that runs a chain of ``steps`` dependent f64 adds
    (the dependence ``reference_lpc``'s autocorrelation cannot break);
    timing it gives one add's latency on the card.  Returns the chain's
    result (f64 ``[1]``)."""
    out = torch.ones(1, dtype=torch.float64, device=device)
    launch(bind("reference_analysis", "flacx_dadd_chain", 1, 1), [out],
           [steps], "dadd_chain")
    return out
