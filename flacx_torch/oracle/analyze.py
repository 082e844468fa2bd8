"""Subframe analysis with reference-identical numerics (oracle).

The port's own copy of the JAX package's ``oracle/analyze.py``, reference
defects and fixes included.

Float sections (window, autocorrelation, Levinson-Durbin, quantization)
reproduce the reference's exact CPython arithmetic *order* so the chosen
coefficients — and therefore the emitted bytes — match bit-for-bit
(reference flac/encoder.py:362-534).  Integer sections (residuals, Rice
sizing) are exact by construction.

Defect fixes relative to the reference (SURVEY.md §2.3): digital silence
becomes a Constant subframe instead of a ZeroDivisionError; fixed/LPC size
ties pick fixed instead of ``assert False``; negative quantization shift
keeps the scaled coefficients instead of returning an empty list; the Rice
parameter is clamped to the 5-bit ceiling.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import cos, floor, log2, pi

from flacx_torch.format import (FIXED_PREDICTOR_COEFFICIENTS,
                                MAX_RICE_PARAMETER, Residual,
                                RiceCodingMethod, RicePartition, Subframe,
                                SubframeKind)
from flacx_torch.utils import clamp, zigzag_encode


@dataclass(frozen=True)
class SubframePlan:
    """A fully decided subframe: the record plus its residual coding plan."""
    subframe: Subframe
    residual_plan: Residual | None  # None for constant/verbatim


# ---------------------------------------------------------------------------
# Windowing / LPC analysis (float, reference-exact order of operations)

def tukey_window(n: int, r: float = 0.5) -> list[float]:
    """Tukey window as defined by libFLAC's FLAC__window_tukey.

    Parity: reference flac/encoder.py:423-440 (itself a port of libflac
    window.c).  Ends are Hann-tapered over ``floor(r/2*n) - 1`` points.
    """
    nr = floor(r / 2.0 * n) - 1
    w = [1.0] * n
    for i in range(nr + 1):
        left = 0.5 - 0.5 * cos(pi * i / nr)
        right = 0.5 - 0.5 * cos(pi * (i + nr) / nr)
        w[i] = left
        w[n - nr - 1 + i] = right
    return w


def autocorrelation(xs: list[float], max_lag: int) -> list[float]:
    """Left-to-right autocorrelation sums for lags ``0..max_lag-1``.

    Parity: reference flac/encoder.py:443-450 including its off-by-one (the
    sum stops at ``len - lag - 2``); summation order is strictly
    left-to-right so results match CPython float arithmetic exactly.
    """
    n = len(xs)
    out = []
    for lag in range(max_lag):
        acc = 0.0
        for j in range(n - lag - 1):
            acc += xs[j] * xs[j + lag]
        out.append(acc)
    return out


def levinson_durbin(autoc: list[float]) -> list[float]:
    """LPC coefficients for order ``len(autoc) - 1`` via Levinson-Durbin.

    Parity: reference flac/encoder.py:453-479 — the in-place symmetric
    update is reproduced operation-for-operation (float results must be
    bit-identical for byte-compatible output).
    """
    order = len(autoc) - 1
    a = [0.0] * (order + 1)
    a[0] = 1.0
    err = autoc[0]
    for k in range(order):
        lam = 0.0
        for j in range(k + 1):
            lam -= a[j] * autoc[k + 1 - j]
        lam /= err
        for i in range((k + 1) // 2 + 1):
            tmp = a[k + 1 - i] + lam * a[i]
            a[i] = a[i] + lam * a[k + 1 - i]
            a[k + 1 - i] = tmp
        err *= 1.0 - lam ** 2
    return a[1:]


def quantize_coefficients(coefs: list[float],
                          precision: int) -> tuple[list[int], int]:
    """Error-feedback quantization to ``(precision, shift)`` integers.

    Parity: reference flac/encoder.py:482-534 (libFLAC
    FLAC__lpc_quantize_coefficients) with the negative-shift defect fixed:
    the reference forgets to append the quantized value in that branch
    (flac/encoder.py:527-532), producing an empty coefficient list; here the
    scaled-down coefficients are kept and shift becomes 0.
    """
    if precision < 5:
        raise ValueError("qlp precision must be >= 5")
    cmax = max(abs(c) for c in coefs)
    if cmax <= 0.0:
        # All-zero predictor (cannot happen for non-constant input, which is
        # filtered out earlier); emit zeros with shift 0.
        return [0] * len(coefs), 0

    shift_max = (1 << 4) - 1
    shift = precision - floor(log2(cmax)) - 2
    shift = min(shift, shift_max)

    qmax = (1 << (precision - 1)) - 1
    qmin = -(1 << (precision - 1))

    out: list[int] = []
    err = 0.0
    if shift >= 0:
        scale = 1 << shift
    else:
        scale = 1.0 / (1 << -shift)
        shift = 0
    for c in coefs:
        err += c * scale
        q = clamp(round(err), qmin, qmax)
        err -= q
        out.append(q)
    return out, shift


# ---------------------------------------------------------------------------
# Integer prediction

def predict_residual(samples: list[int], coefs: list[int] | tuple[int, ...],
                     shift: int = 0) -> list[int]:
    """Integer residual ``x[i] - (sum_j c_j x[i-1-j] >> shift)``.

    Parity: reference flac/encoder.py:537-548.  Exact integer arithmetic
    with arithmetic right shift (Python ``>>`` floors, matching the spec).
    """
    order = len(coefs)
    out = []
    for i in range(order, len(samples)):
        acc = 0
        for j, c in enumerate(coefs):
            acc += samples[i - 1 - j] * c
        out.append(samples[i] - (acc >> shift))
    return out


# ---------------------------------------------------------------------------
# Subframe analysis

def analyze_fixed(samples: list[int]) -> Subframe:
    """Best fixed-order subframe by minimum sum-of-abs-residual.

    Parity: reference flac/encoder.py:331-359 (order 0 forced when the
    block has <= 4 samples; first minimum wins ties).
    """
    n = len(samples)
    if n <= 4:
        return Subframe(kind=SubframeKind.Fixed, order=0,
                        residual=tuple(samples))
    best_order, best_err, best_res = 0, None, None
    for order, coefs in enumerate(FIXED_PREDICTOR_COEFFICIENTS):
        res = predict_residual(samples, coefs)
        err = sum(abs(r) for r in res)
        if best_err is None or err < best_err:
            best_order, best_err, best_res = order, err, res
    return Subframe(kind=SubframeKind.Fixed, order=best_order,
                    warmup=tuple(samples[:best_order]),
                    residual=tuple(best_res))


def analyze_lpc(samples: list[int], max_order: int,
                precision: int) -> Subframe | None:
    """Best LPC subframe over orders ``1..max_order`` by sum-abs-residual.

    Parity: reference flac/encoder.py:362-420.  Returns None when LPC is
    not applicable (max_order < 1, degenerate window, or a block too short
    for any order).
    """
    n = len(samples)
    max_order = min(max_order, n - 1)
    # n < 9 would give a degenerate Tukey taper (nr < 1 divides by zero in
    # the reference, flac/encoder.py:437); such tiny blocks use fixed/const.
    if max_order < 1 or n < 9:
        return None

    window = tukey_window(n)
    windowed = [float(x) * w for x, w in zip(samples, window)]
    autoc = autocorrelation(windowed, max_order + 1)
    if autoc[0] == 0.0:
        return None  # digital silence; handled by the constant subframe

    best = None  # (err, subframe)
    for order in range(1, max_order + 1):
        coefs_f = levinson_durbin(autoc[: order + 1])
        qcoefs, shift = quantize_coefficients(coefs_f, precision)
        res = predict_residual(samples, qcoefs, shift)
        err = sum(abs(r) for r in res)
        if best is None or err < best[0]:
            best = (err, Subframe(
                kind=SubframeKind.LPC, order=order,
                warmup=tuple(samples[:order]),
                precision=precision, shift=shift,
                coefficients=tuple(qcoefs), residual=tuple(res)))
    return best[1] if best else None


def analyze_subframe(samples: list[int], max_lpc_order: int,
                     precision: int) -> Subframe:
    """Pick the subframe type for one channel of one block.

    Selection parity with the reference (flac/encoder.py:127-157): fixed vs
    LPC by the sum-of-abs-residual heuristic.  Defect fixes: constant
    subframes are emitted for constant blocks (the reference crashes on
    silence, SURVEY.md §2.3.2), and size ties choose fixed (the reference
    hits ``assert False``, §2.3.4).
    """
    if all(s == samples[0] for s in samples):
        return Subframe(kind=SubframeKind.Constant, constant=samples[0])

    fixed = analyze_fixed(samples)
    lpc = analyze_lpc(samples, max_lpc_order, precision)
    if lpc is None:
        return fixed

    fixed_err = sum(abs(r) for r in fixed.residual)
    lpc_err = sum(abs(r) for r in lpc.residual)
    return lpc if lpc_err < fixed_err else fixed


# ---------------------------------------------------------------------------
# Rice residual planning

def find_rice_parameter(zigzags: list[int]) -> int:
    """``floor(log2(mean magnitude))`` estimate, clamped to [0, 30].

    Parity: reference flac/encoder.py:730-753 (libFLAC's estimate), with
    the defects fixed: an all-zero partition yields parameter 0 instead of
    ``log2(0)`` crashing, and the result is clamped to the 5-bit ceiling
    (the reference's TODO at flac/encoder.py:751-752).
    """
    total = sum(zigzags)
    if total == 0 or total < len(zigzags):
        return 0
    return clamp(floor(log2(total / len(zigzags))), 0, MAX_RICE_PARAMETER)


def rice_bit_size(zigzag: int, parameter: int) -> int:
    """Bits to Rice-code one zigzag value.  Parity: flac/encoder.py:756-760."""
    return (zigzag >> parameter) + 1 + parameter


def plan_residual(residual: tuple[int, ...], block_size: int,
                  predictor_order: int, partition_orders: range,
                  use_escapes: bool = False) -> Residual:
    """Choose partition order and per-partition Rice parameters.

    Parity: reference flac/encoder.py:632-727 — candidate partition orders
    are filtered for divisibility and ``block_size >> order >
    predictor_order``; each partition's parameter comes from the mean
    estimate; the configuration with the smallest estimated size wins
    (first minimum, i.e. the lowest candidate order, on ties).  Falls back
    to partition order 0 when no candidate in the range is legal (the
    reference asserts instead).

    ``use_escapes`` additionally admits ESCAPED partitions (raw E-bit
    two's-complement blocks, E = bitlen(max zigzag) clamped to [1, 31])
    where strictly smaller than the Rice coding.  Default OFF: the
    reference encoder can never produce escapes
    (flac/encoder.py:770-772), and byte-parity with it on valid input is
    the oracle's contract.
    """
    zz = [zigzag_encode(r) for r in residual]

    candidates = [o for o in partition_orders
                  if block_size % (1 << o) == 0
                  and (block_size >> o) > predictor_order]
    if not candidates:
        candidates = [0]

    best = None  # (est_size, order, [(param, part_zz, esc_size), ...])
    for order in candidates:
        nparts = 1 << order
        psize = block_size >> order
        bounds = [0] + [p * psize - predictor_order
                        for p in range(1, nparts)] + [len(zz)]
        est = 0
        parts = []
        for p in range(nparts):
            part = zz[bounds[p]: bounds[p + 1]]
            param = find_rice_parameter(part)
            rice_cost = sum(rice_bit_size(z, param) for z in part)
            esc_size = 0
            if use_escapes and part:
                e = max(1, max(part).bit_length())
                if e <= 31 and 5 + e * len(part) < rice_cost:
                    esc_size = e
                    rice_cost = 5 + e * len(part)
            est += 4 + (5 if param > 14 else 4) + rice_cost
            parts.append((param, part, esc_size))
        if best is None or est < best[0]:
            best = (est, order, parts)

    _, order, parts = best
    method = (RiceCodingMethod.Rice4Bit
              if all(p <= 14 for p, _, e in parts if not e)
              else RiceCodingMethod.Rice5Bit)
    marker = (1 << method.value) - 1
    signed_parts = []
    start = 0
    for param, part, esc_size in parts:
        stop = start + len(part)
        signed_parts.append(RicePartition(
            parameter=marker if esc_size else param,
            residual=tuple(residual[start:stop]),
            escaped_size=esc_size))
        start = stop
    return Residual(coding_method=method, partition_order=order,
                    partitions=tuple(signed_parts))


def plan_subframe(samples: list[int], block_size: int, max_lpc_order: int,
                  precision: int, partition_orders: range,
                  use_escapes: bool = False) -> SubframePlan:
    sf = analyze_subframe(samples, max_lpc_order, precision)
    if sf.kind in (SubframeKind.Constant, SubframeKind.Verbatim):
        return SubframePlan(sf, None)
    plan = plan_residual(sf.residual, block_size, sf.order, partition_orders,
                         use_escapes=use_escapes)
    return SubframePlan(sf, plan)
