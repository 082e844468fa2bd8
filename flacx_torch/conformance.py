"""Reference-conformance encode mode: the reference encoder's parameter
choices, reproduced bit for bit, on the device.

``EncoderConfig(conformance=True)`` makes :class:`flacx_torch.encoder.
BatchEncoder` write the frames the oracle encoder (``flacx_torch.oracle``)
writes, byte for byte: independent channels, no wasted bits, no escapes,
no verbatim (constant blocks become Constant subframes); fixed against
LPC by the smaller sum of |residual|, first minimum on ties (a tie goes
to fixed); the f64 LPC analysis sequenced as the reference's Python loops
(Tukey window, left-to-right autocorrelation over the reference's
drop-last-product range, its Levinson-Durbin op order, error-feedback
quantization with ``floor(log2(.))``); the mean-estimate Rice parameter
and the reference's partition-size estimate.  Counterpart of the JAX
package's ``conformance`` module, function for function.

Every f64 multiply, add and subtract of the chain is its own rounded
operation: nothing here fuses a multiply into an add (no ``addcmul``,
``addmm`` or ``baddbmm``), and the CUDA kernel uses the ``__d*_rn``
intrinsics, which the compiler never contracts into an FMA.

On the card the analysis runs in the ``reference_analysis`` kernels
(``reference_lpc``: window, ordered autocorrelation, Levinson and
quantization of every row; ``abs_residual_sums``: Σ|residual| of every
fixed and LPC order), the chosen residual in ``lpc_residual`` (zz mode),
the Rice plan in plain PyTorch, and emission in ``frame_pack``.

Two ops differ from the JAX package's by design, each where the JAX
package's XLA math is off by an ulp: ``2^k`` is exact here (XLA's
``exp2`` is ``exp(k·ln 2)``, a few ulps off most integers; the oracle
scales by ``1 << shift``), and ``floor(log2(|e|))`` of an integer exponent
is exact (XLA's ``log2`` lands a hair under 3, 6 and 7 at 8, 64 and 128).
They change a result only where a value lies within a few ulps of a
rounding boundary: a quantized coefficient whose running error is that
close to a half, or a ``floor_log2`` argument 3-5 ulps under ``2^±8``,
``2^±64`` or ``2^±128``.
"""

from __future__ import annotations

import functools
import math

import torch

from flacx_torch.format import FIXED_PREDICTOR_TAPS, INDEPENDENT_CHANNELS
from flacx_torch.kernels.lpc_residual import (lpc_residual_stats,
                                              lpc_residual_zz)
from flacx_torch.kernels.reference_analysis import (abs_residual_sums,
                                                    reference_lpc)
from flacx_torch.ops import emit
from flacx_torch.ops.framepack import pack_frames
from flacx_torch.ops.headers import frame_header_symbols, frame_indices
from flacx_torch.ops.lpc import tukey_window_np
from flacx_torch.ops.rice import RicePlan, bit_length, plan_from_segments

INF64 = 1 << 60
BIAS = 1 << 40
LN2 = math.log(2.0)


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exactly ``2^e`` as f64 for integer ``e`` in [-1022, 1023], from the
    exponent bits."""
    return ((e.long() + 1023) << 52).view(torch.float64)


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """``floor(log2(x))`` for positive finite f64 ``x`` (int32), as the JAX
    package computes it: the exponent of ``frexp``, rounded up where the
    correctly-rounded ``log2`` would land on the next integer — ``x`` a
    hair under a power of two, ``-log2(mantissa)`` (from ``log1p``) under
    half an ulp of the exponent."""
    mant, expo = torch.frexp(x)                      # x = mant·2^e
    delta = -torch.log1p(mant - 1.0) / LN2
    fl = bit_length(expo.abs().clamp(min=1)) - 1     # floor(log2(|e|))
    half_ulp = pow2(fl - 53)
    rounds_up = (expo != 0) & (delta < half_ulp)
    return (expo - 1 + rounds_up.to(expo.dtype)).to(torch.int32)


def ordered_autocorr(w: torch.Tensor, max_lag: int) -> torch.Tensor:
    """``out[..., lag] = Σ_{j=0}^{n-lag-2} w_j·w_{j+lag}`` (f64), each sum
    added strictly left to right over ``j``, as the reference's loop
    (its range drops each lag's last product).  A loop over ``j``,
    vectorised over rows and lags; a masked term adds ``+0.0``, which
    leaves the sum as it is (the sum is never ``-0.0``)."""
    n = w.shape[-1]
    nl = max_lag + 1
    lags = torch.arange(nl, device=w.device)
    wp = torch.nn.functional.pad(w, (0, nl))
    # every product w_j·w_{j+lag} once, masked past the reference's range
    j = torch.arange(n - 1, device=w.device)
    prods = w[..., :n - 1, None] * wp[..., j[:, None] + lags]
    prods = torch.where(j[:, None] + lags <= n - 2, prods, 0.0)
    acc = torch.zeros((*w.shape[:-1], nl), dtype=torch.float64,
                      device=w.device)
    for k in range(n - 1):
        acc = acc + prods[..., k, :]
    return acc


def levinson_reference(autoc: torch.Tensor, max_order: int,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's Levinson-Durbin in its exact op order, every order
    from one recursion (each order's run repeats the same ops over the
    shared prefix).  Returns ``(taps [..., P, P] f64, valid [..., P])``:
    row ``o-1`` holds the order-``o`` coefficients ``a[1:]`` (the
    predictor's, used as they come), zero past ``o``; ``valid`` goes False
    once the recursion meets a zero error (the reference raises there) or
    a row is not finite."""
    lead = autoc.shape[:-1]
    p = max_order
    dev = autoc.device
    a = [torch.zeros(lead, dtype=torch.float64, device=dev)
         for _ in range(p + 1)]
    a[0] = torch.ones(lead, dtype=torch.float64, device=dev)
    err = autoc[..., 0]
    ok = torch.ones(lead, dtype=torch.bool, device=dev)
    rows, valids = [], []
    for k in range(p):
        ok = ok & (err != 0.0)
        safe_err = torch.where(err != 0.0, err, 1.0)
        lam = torch.zeros(lead, dtype=torch.float64, device=dev)
        for j in range(k + 1):
            lam = lam - a[j] * autoc[..., k + 1 - j]
        lam = lam / safe_err
        for i in range((k + 1) // 2 + 1):
            tmp = a[k + 1 - i] + lam * a[i]
            a[i] = a[i] + lam * a[k + 1 - i]
            a[k + 1 - i] = tmp
        err = err * (1.0 - lam * lam)
        # a[j > k+1] are still zero: the row is a[1:] as it stands
        rows.append(torch.stack(a[1:], dim=-1))
        valids.append(ok)
    taps = torch.stack(rows, dim=-2)
    valid = torch.stack(valids, dim=-1) & torch.isfinite(taps).all(-1)
    return taps, valid


def quantize_reference(taps: torch.Tensor, precision: int,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback quantization (the reference's, with the oracle's
    negative-shift fix: scale down and emit shift 0).

    Args: taps ``[..., P, P]`` f64 (row ``o-1`` zero past order ``o``).
    Returns ``(qcoefs int32 [..., P, P], shift int32 [..., P])``.
    """
    p = taps.shape[-1]
    dev = taps.device
    cmax = taps.abs().amax(-1)
    pos = cmax > 0.0
    shift = precision - floor_log2(torch.where(pos, cmax, 1.0)) - 2
    shift = torch.clamp(shift, max=15)
    scale = torch.where(shift >= 0, pow2(shift.clamp(min=0)),
                        1.0 / pow2((-shift).clamp(min=0)))
    out_shift = torch.where(pos, shift.clamp(min=0), 0)

    qmax = (1 << (precision - 1)) - 1
    qmin = -(1 << (precision - 1))
    err = torch.zeros(taps.shape[:-1], dtype=torch.float64, device=dev)
    qs = []
    for j in range(p):
        err = err + taps[..., j] * scale
        q = torch.clamp(torch.round(err), qmin, qmax)   # half to even
        err = err - q
        qs.append(q.to(torch.int32))
    qcoefs = torch.stack(qs, dim=-1)
    order = torch.arange(1, p + 1, device=dev)
    tap_mask = torch.arange(p, device=dev) < order[:, None]
    qcoefs = torch.where(tap_mask & pos[..., None], qcoefs, 0)
    return qcoefs, out_shift.to(torch.int32)


def reference_rice_plan(zz: torch.Tensor, order: torch.Tensor,
                        porders: tuple[int, ...],
                        preferred: tuple[int, ...]) -> RicePlan:
    """The reference's Rice planning, batched.

    Per partition: parameter ``floor(log2(total/count))`` (0 for an
    all-zero or sub-unity mean, clamped to [0, 30]); cost the exact bits
    at that parameter; partition order the first minimum, ascending, of
    ``Σ 4 + width_p + cost_p`` (``width_p`` 5 where ``p``'s parameter
    passes 14).  The method's width is 5 bits where any chosen parameter
    passes 14.  No escapes.  ``zz`` ``[..., n]`` zigzag residuals (zero
    at ``i < order``), any integer type; ``order`` ``[...]``.  The shifted
    sums run in plain PyTorch on every device.
    """
    n = zz.shape[-1]
    lead = zz.shape[:-1]
    dev = zz.device
    max_po = max(porders)
    kmax = 30
    order64 = order.long()

    zzr = zz.long().reshape(*lead, 1 << max_po, n >> max_po)
    s = torch.stack([(zzr >> k).sum(-1) for k in range(kmax + 1)], dim=-1)
    s_by_po = {max_po: s}
    for po in range(max_po, 0, -1):
        s_by_po[po - 1] = (s_by_po[po][..., 0::2, :]
                           + s_by_po[po][..., 1::2, :])

    best_est = torch.full(lead, INF64, dtype=torch.int64, device=dev)
    best_po = torch.zeros(lead, dtype=torch.int32, device=dev)
    k_levels = {}
    for po in porders:
        nparts = 1 << po
        psize = n >> po
        sp = s_by_po[po]                                # [..., np, 31]
        is_p0 = torch.arange(nparts, device=dev) == 0
        cnt = psize - order64[..., None] * is_p0
        total = sp[..., 0]
        mean = total.double() / cnt.double()
        param = torch.clamp(floor_log2(torch.clamp(mean, min=1.0)), 0, 30)
        param = torch.where((total == 0) | (total < cnt), 0, param)
        k_levels[po] = param
        cost = (sp.gather(-1, param.long()[..., None])[..., 0]
                + (param.long() + 1) * cnt)
        est = (4 + torch.where(param > 14, 5, 4) + cost).sum(-1)
        bias = 0 if po in preferred else BIAS
        est = torch.where(psize > order64, est + bias, INF64)
        take = est < best_est                  # strict: ascending first-min
        best_po = torch.where(take, po, best_po)
        best_est = torch.minimum(est, best_est)

    # the chosen order's parameters on the finest grid; the method's
    # width, and every other field of the plan, follow from them
    nseg = 1 << max_po
    k_seg = torch.zeros((*lead, nseg), dtype=torch.int8, device=dev)
    for po in porders:
        seg_of = torch.arange(nseg, device=dev) >> (max_po - po)
        k_seg = torch.where((best_po == po)[..., None],
                            k_levels[po].to(torch.int8)[..., seg_of], k_seg)
    width = torch.where(k_seg.amax(-1) > 14, 5, 4).to(torch.int32)
    return plan_from_segments(
        best_est - torch.where(best_est >= BIAS, BIAS, 0), best_po, width,
        k_seg, torch.zeros_like(k_seg, dtype=torch.bool), order, n)


@functools.lru_cache(maxsize=None)
def reference_window(n: int, device: torch.device) -> torch.Tensor:
    """The reference's Tukey(0.5) window (f64 ``[n]``) on ``device``."""
    return torch.from_numpy(tukey_window_np(n)).to(device)


def residual_fits_int32(bps: int, sum_taps_max: int) -> bool:
    """Whether every residual ``x - (Σ taps·x >> shift)`` of ``bps``-bit
    samples under taps of ``Σ|taps| <= sum_taps_max`` has ``|res| <=
    2^29``, so that its zigzag is exact in int32 (``|res| <= 2^(bps-1)·
    (1 + Σ|taps|)``)."""
    return bps + max(1, sum_taps_max).bit_length() <= 30


def encode_batch_conformance(cfg, pcm: torch.Tensor, frame_index) -> dict:
    """Reference-choice encode of pcm ``[B, C, N]`` into packed frames,
    ``frame_index`` a scalar first index or a per-frame ``[B]`` array.

    The output dict of ``encoder._encode_batch`` (``bytes``, ``length``,
    ``kind``, ``channel_code``, ``subframe_bits``, zeros here) plus
    ``overflow`` ``[B]``: frames the packer cannot take, written as
    verbatim stand-ins here, which the host replaces with the oracle's
    frames.  A frame overflows where a reference Rice code passes 32 bits
    (the reference's unary quotients are unbounded), where the frame would
    pass ``max_frame_bytes`` (the reference never writes verbatim), or,
    up to 24-bit samples, where a chosen residual reaches 2^30 (its zigzag
    would not fit the int32 working type; such a frame has a code past 32
    bits anyway).  Past 24 bits the zigzag residual is int64
    (``cfg.work_dtype``), exact on every frame.
    """
    n = cfg.block_size
    b = pcm.shape[0]
    c = cfg.channels
    p = cfg.max_lpc_order
    t = cfg.max_taps
    prec = cfg.qlp_precision
    dev = pcm.device
    indices = frame_indices(frame_index, b, dev)
    x = pcm.to(torch.int32).contiguous()                  # [B, C, N]
    rows = x.reshape(b * c, n)
    i_pos = torch.arange(n, device=dev)
    bps_c = torch.full((b, c), cfg.bps, dtype=torch.int32, device=dev)
    taps_max = max(cfg.sum_taps_max, 15)

    # ---- analysis: every row's reference LPC chain, then Σ|residual| of
    # the fixed orders 0..4 and the LPC orders 1..P
    use_lpc_path = p >= 1 and n >= 9
    pe = min(p, n - 1)
    if use_lpc_path:
        autoc, qcoefs, qshift, valid = reference_lpc(
            rows, reference_window(n, dev), pe, prec)
    else:
        qcoefs = torch.zeros((b * c, 0, 0), dtype=torch.int32, device=dev)
        qshift = torch.zeros((b * c, 0), dtype=torch.int32, device=dev)
    ferr, lerr = abs_residual_sums(rows, qcoefs, qshift, cfg.bps, taps_max)
    ferr = ferr.reshape(b, c, 5)
    f_order = ferr.argmin(-1).to(torch.int32)             # first minimum
    f_err = ferr.amin(-1)

    if use_lpc_path:
        lerr = torch.where(valid, lerr, INF64)
        lerr = torch.where(autoc[:, :1] == 0.0, INF64, lerr)  # silence
        lerr = lerr.reshape(b, c, pe)
        l_order0 = lerr.argmin(-1)                        # first minimum
        l_err = lerr.amin(-1)
        is_lpc = (l_err < INF64) & (l_err < f_err)        # tie → fixed
        lpc_order = (l_order0 + 1).to(torch.int32)
        taps_lpc = qcoefs.reshape(b, c, pe, pe).gather(
            2, l_order0[..., None, None].expand(b, c, 1, pe))[:, :, 0]
        taps_lpc = torch.nn.functional.pad(taps_lpc, (0, t - pe))
        shift_lpc = qshift.reshape(b, c, pe).gather(
            -1, l_order0[..., None])[..., 0]
    else:
        is_lpc = torch.zeros((b, c), dtype=torch.bool, device=dev)
        lpc_order = torch.ones((b, c), dtype=torch.int32, device=dev)
        taps_lpc = torch.zeros((b, c, t), dtype=torch.int32, device=dev)
        shift_lpc = torch.zeros((b, c), dtype=torch.int32, device=dev)

    # ---- selection: constant, else the smaller of fixed and LPC
    const_sel = (x == x[..., :1]).all(-1)
    order = torch.where(is_lpc, lpc_order, f_order).contiguous()
    kind = torch.where(const_sel, emit.KIND_CONSTANT,
                       torch.where(is_lpc, emit.KIND_LPC, emit.KIND_FIXED)
                       ).to(torch.int32)
    taps_fix = torch.nn.functional.pad(
        torch.from_numpy(FIXED_PREDICTOR_TAPS).to(dev)[f_order.long()],
        (0, t - 4))
    taps = torch.where(is_lpc[..., None], taps_lpc, taps_fix) \
        .to(torch.int32).contiguous()
    shift = torch.where(is_lpc, shift_lpc, 0).to(torch.int32).contiguous()

    # ---- the chosen residual's zigzag (zero at i < order) and its plan;
    # exact in int32 on every frame that does not overflow: each code
    # (zz >> k) + 1 + k <= 32 with k <= 30 gives zz < 2^31
    zz = lpc_residual_zz(x, taps, shift, order, cfg.bps, taps_max,
                         cfg.work_dtype)
    coded = kind >= emit.KIND_FIXED
    wraps = torch.zeros(b, dtype=torch.bool, device=dev)
    if zz.dtype == torch.int32 and not residual_fits_int32(cfg.bps,
                                                           taps_max):
        _, maxabs = lpc_residual_stats(x, taps, shift, order, cfg.bps,
                                       taps_max)
        wraps = (coded & (maxabs >= (1 << 30))).any(-1)
    plan = reference_rice_plan(zz, order, cfg.porders,
                               cfg.preferred_porders)

    # ---- the packer's limits: codes of at most 32 bits, frames of at
    # most max_frame_bytes
    k64 = plan.k_sample.long()
    in_resid = coded[..., None] & (i_pos >= order[..., None])
    code_len = torch.where(in_resid, (zz.long() >> k64) + 1 + k64, 0)
    long_code = (code_len > 32).any(-1).any(-1)
    ord64, bps64 = order.long(), bps_c.long()
    sub_bits = torch.where(
        coded, 8 + ord64 * bps64
        + torch.where(is_lpc, 9 + ord64 * prec, 0) + 6
        + (torch.ones_like(ord64) << plan.porder.long()) * plan.width
        + code_len.sum(-1),
        8 + bps64)
    ch_code = torch.full((b,), int(INDEPENDENT_CHANNELS[c]),
                         dtype=torch.int32, device=dev)
    hdr = frame_header_symbols(indices, ch_code, n)
    frame_len = hdr.nbytes + (sub_bits.sum(-1) + 7) // 8 + 2
    overflow = long_code | wraps | (frame_len > cfg.max_frame_bytes)
    kind = torch.where(overflow[:, None], emit.KIND_VERBATIM, kind) \
        .to(torch.int32)

    # ---- emission (the oracle writer's layout) through frame_pack
    psize_min = n >> max(cfg.porders)
    frame_bytes, length = pack_frames(
        hdr, kind, order, bps_c, x, taps, shift, prec, zz, plan, psize_min,
        cfg.max_frame_bytes)
    return {"bytes": frame_bytes, "length": length, "kind": kind,
            "channel_code": ch_code,
            "subframe_bits": torch.zeros((b, c), dtype=torch.int64,
                                         device=dev),
            "overflow": overflow}
