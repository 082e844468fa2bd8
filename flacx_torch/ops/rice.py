"""Exact exhaustive Rice parameter / partition-order search, batched.

The per-partition quantities ``S_k = Σ (zigzag >> k)`` are computed once at
the finest partition level for every k; coarser partition orders are sums
up the tree, and each partition's parameter is the exact argmin of
``S_k + (k+1)·count`` over k (lowest k on ties).

Shapes: ``zz`` is ``[..., n]`` zigzag magnitudes with zeros at warmup
positions ``i < order``, ``order`` is ``[...]``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Sequence

import torch

#: Bias added to fallback partition orders outside the user's requested
#: range so they are only selected when every requested order is invalid.
FALLBACK_BIAS = 1 << 40
INVALID = 1 << 50
#: Invalid marker of the int32 search (every eligible int32 bits value is
#: below it); the Rice-statistics kernel writes the same sentinel.
SENT = 1 << 28

#: Hard cap on a complete Rice code (unary quotient + stop bit + remainder)
#: in bits: every symbol of the packer fits one 32-bit word, so only k with
#: ``(max(zz) >> k) + 1 + k <= CODE_BITS_MAX`` are eligible.
CODE_BITS_MAX = 32


class RicePlan(NamedTuple):
    bits: torch.Tensor        # [...]   exact residual section size in bits
    porder: torch.Tensor      # [...]   chosen partition order (int32)
    width: torch.Tensor       # [...]   parameter field width, 4 or 5
    k_sample: torch.Tensor    # [..., n] int8 Rice parameter of sample i
    #                           (escape SIZE in escaped partitions)
    param_start: torch.Tensor  # [..., n] bool: param symbol precedes i
    esc_sample: torch.Tensor  # [..., n] bool: sample i is ESCAPED
    k_param: torch.Tensor     # [..., P] the same three at the static
    start_param: torch.Tensor  # [..., P] param-slot positions
    esc_param: torch.Tensor   # [..., P]
    k_seg: torch.Tensor       # [..., nseg] int8 per finest-grid segment
    esc_seg: torch.Tensor     # [..., nseg] bool


def zigzag(r: torch.Tensor) -> torch.Tensor:
    """Signed int -> non-negative folded int, dtype-preserving.

    Values must fit with one spare bit (int32 inputs need |r| < 2^30).
    """
    width = torch.iinfo(r.dtype).bits - 1
    return (r << 1) ^ (r >> width)


def bit_length(m: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative integers (0 for 0), as int64."""
    bits = torch.iinfo(m.dtype).bits - 1
    pow2 = torch.ones(bits, dtype=torch.int64, device=m.device) \
        << torch.arange(bits, device=m.device)
    return (m.long()[..., None] >= pow2).sum(-1)


def estimate_bits(zz_sum: torch.Tensor, count: torch.Tensor,
                  kmax: int) -> torch.Tensor:
    """Cheap residual-size estimate used only for candidate *ranking*:
    ``k ≈ floor(log2(mean))``, size ≈ ``(Σu >> k) + (k+1)·m``."""
    count = torch.clamp(count, min=1)
    mean = zz_sum.double() / count
    k = torch.clamp(torch.floor(torch.log2(torch.clamp(mean, min=1.0))),
                    0, kmax).long()
    return (zz_sum >> k) + (k + 1) * count


def _search_levels(zz: torch.Tensor, order: torch.Tensor,
                   porders: Sequence[int], kmax: int, invalid: int,
                   ) -> dict:
    """Per-level ``(min4, arg4, min5, arg5, max)`` of the exact search.

    ``min*`` is the least ``S_k + (k+1)·count`` over eligible k (k ≤ 14
    for the 4-bit method, k ≤ kmax for the 5-bit one), ``invalid`` where
    no k is eligible; ``arg*`` the lowest k attaining it.
    """
    n = zz.shape[-1]
    lead = zz.shape[:-1]
    max_po = max(porders)
    nparts = 1 << max_po
    psize_fine = n >> max_po
    n_k4 = min(kmax, 14) + 1
    dev = zz.device
    zzr = zz.reshape(*lead, nparts, psize_fine).long()
    s_fine = torch.stack([(zzr >> k).sum(-1) for k in range(kmax + 1)],
                         dim=-1)                          # [..., np, K]
    m_fine = zzr.amax(-1)                                 # [..., np]
    ks = torch.arange(kmax + 1, device=dev, dtype=torch.int32)
    levels = {}
    for po in porders:
        span = nparts >> po
        s = s_fine.reshape(*lead, 1 << po, span, kmax + 1).sum(-2)
        m = m_fine.reshape(*lead, 1 << po, span).amax(-1)
        psize = n >> po
        is_p0 = torch.arange(1 << po, device=dev) == 0
        cnt = psize - order.long()[..., None] * is_p0     # [..., np]
        bits = s + (ks.long() + 1) * cnt[..., None]
        # code-length cap in the input's own integer width (int32 wraps
        # exactly as the kernel's arithmetic does)
        mz, kz = m.to(zz.dtype)[..., None], ks.to(zz.dtype)
        ok = (mz >> kz) + kz + 1 <= CODE_BITS_MAX
        bits = torch.where(ok, bits, invalid)
        arg5 = bits.argmin(-1)
        min5 = bits.gather(-1, arg5[..., None])[..., 0]
        arg4 = bits[..., :n_k4].argmin(-1)
        min4 = bits.gather(-1, arg4[..., None])[..., 0]
        dt = zz.dtype
        levels[po] = (min4.to(dt), arg4.to(torch.int32), min5.to(dt),
                      arg5.to(torch.int32), m.to(dt))
    return levels


def rice_stats(zz: torch.Tensor, order: torch.Tensor,
               porders: Sequence[int], kmax: int) -> dict:
    """Plain per-level search statistics of int32 or int64 ``zz``.

    Returns ``{po: (min4, arg4, min5, arg5, max)}``, each ``[..., 2^po]``
    int32, ``min*`` carrying :data:`SENT` where no k is eligible — the
    statistics the Rice kernel computes in one pass over ``zz``.  int64
    ``zz`` is searched in int64; its eligible costs are under 2^20 (each
    value's ``zz >> k`` is at most 31), and ``max`` is saturated at 2^31,
    which no Rice parameter (k ≤ 30) nor escape (31 bits) can code, and
    written as int32 (2^31 as -2^31; :func:`exact_plan` reads it back as
    unsigned).
    """
    if zz.dtype == torch.int32:
        return _search_levels(zz, order, porders, kmax, SENT)
    if zz.dtype != torch.int64:
        raise TypeError(f"rice statistics take int32 or int64, not "
                        f"{zz.dtype}")
    levels = _search_levels(zz, order, porders, kmax, INVALID)
    top = 1 << 31
    return {po: (torch.where(min4 >= INVALID, SENT, min4).to(torch.int32),
                 arg4,
                 torch.where(min5 >= INVALID, SENT, min5).to(torch.int32),
                 arg5, torch.where(m >= top, -top, m).to(torch.int32))
            for po, (min4, arg4, min5, arg5, m) in levels.items()}


def exact_plan(zz: torch.Tensor, order: torch.Tensor,
               porders: Sequence[int], preferred: Sequence[int], kmax: int,
               allow_escape: bool = True,
               kernel_stats: dict | None = None) -> RicePlan:
    """Choose partition order, method width and per-partition parameters.

    Args:
      zz: ``[..., n]`` zigzag magnitudes, zeros at ``i < order``.
      order: ``[...]`` predictor order (partition 0 is short by this much).
      porders: candidate partition orders (ascending, must divide n;
        always contains 0 as a last-resort fallback).
      preferred: subset of ``porders`` the user requested; the others carry
        :data:`FALLBACK_BIAS`.
      kmax: largest Rice parameter searched (≤ 30).
      allow_escape: admit ESCAPED partitions (raw two's-complement blocks)
        wherever they are strictly smaller than every eligible parameter.
      kernel_stats: per-level statistics from :func:`rice_stats` or the
        Rice kernel (int32 or int64 ``zz``); searched here when None.

    Returns a :class:`RicePlan`; ``bits`` includes the 2-bit coding method
    and 4-bit partition-order fields.
    """
    n = zz.shape[-1]
    lead = zz.shape[:-1]
    dev = zz.device
    max_po = max(porders)
    i32 = zz.dtype == torch.int32
    if kernel_stats is None:
        levels = _search_levels(zz, order, porders, kmax,
                                SENT if i32 else INVALID)
    else:
        if zz.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"kernel rice stats take int32 or int64 zz, "
                            f"not {zz.dtype}")
        levels = kernel_stats

    best_bits = torch.full(lead, INVALID, dtype=torch.int64, device=dev)
    best_po = torch.zeros(lead, dtype=torch.int32, device=dev)
    best_width = torch.full(lead, 4, dtype=torch.int32, device=dev)
    k4_levels, k5_levels, e4_levels, e5_levels = {}, {}, {}, {}
    for po in porders:
        nparts = 1 << po
        psize = n >> po
        min4, arg4, min5, arg5, m = levels[po]
        if min4.dtype == torch.int32:
            # rejoin the int64 tail: remap the int32 invalid sentinel, and
            # read the max as unsigned (2^31, int64 zz's saturated max)
            min4 = torch.where(min4 >= SENT, INVALID, min4.long())
            min5 = torch.where(min5 >= SENT, INVALID, min5.long())
            m = m.long() & 0xFFFFFFFF
        is_p0 = torch.arange(nparts, device=dev) == 0
        cnt = psize - order.long()[..., None] * is_p0

        # ESCAPED partition: all-ones parameter, 5-bit raw size E, then
        # count E-bit two's-complement residuals; E = bitlen(max zz) ≥ 1
        esc_e = torch.clamp(bit_length(m), min=1)
        esc_cost = 5 + esc_e * cnt
        esc_cost = torch.where(esc_e <= 31, esc_cost, INVALID)
        if not allow_escape:
            esc_cost = torch.full_like(esc_cost, INVALID)

        esc4 = esc_cost < min4
        esc5 = esc_cost < min5
        min4 = torch.minimum(min4, esc_cost)
        min5 = torch.minimum(min5, esc_cost)
        e_i32 = esc_e.to(torch.int32)
        k4_levels[po] = torch.where(esc4, e_i32, arg4)
        k5_levels[po] = torch.where(esc5, e_i32, arg5)
        e4_levels[po], e5_levels[po] = esc4, esc5

        tot4 = 6 + (4 + min4).sum(-1)
        tot5 = 6 + (5 + min5).sum(-1)
        # a partition with NO eligible coding poisons the whole order
        valid = (psize > order) & ~(min4 >= INVALID).any(-1)
        valid5 = (psize > order) & ~(min5 >= INVALID).any(-1)
        bias = 0 if po in preferred else FALLBACK_BIAS
        tot4 = torch.where(valid, tot4 + bias, INVALID)
        tot5 = torch.where(valid5, tot5 + bias, INVALID)

        take4 = tot4 < best_bits
        best_po = torch.where(take4, po, best_po)
        best_width = torch.where(take4, 4, best_width)
        best_bits = torch.where(take4, tot4, best_bits)
        take5 = tot5 < best_bits
        best_po = torch.where(take5, po, best_po)
        best_width = torch.where(take5, 5, best_width)
        best_bits = torch.where(take5, tot5, best_bits)

    best_bits = best_bits - torch.where(best_bits >= FALLBACK_BIAS,
                                        FALLBACK_BIAS, 0)

    # finest-grid (segment) copies, walking orders coarse → fine and
    # overriding where that order won
    k_seg = torch.zeros((*lead, 1), dtype=torch.int8, device=dev)
    esc_seg = torch.zeros((*lead, 1), dtype=torch.bool, device=dev)
    cur_po = 0
    for po in sorted(porders):
        if po > cur_po:
            f = 1 << (po - cur_po)
            k_seg = k_seg.repeat_interleave(f, dim=-1)
            esc_seg = esc_seg.repeat_interleave(f, dim=-1)
            cur_po = po
        w4 = (best_width == 4)[..., None]
        args = torch.where(w4, k4_levels[po], k5_levels[po]).to(torch.int8)
        escs = torch.where(w4, e4_levels[po], e5_levels[po])
        here = (best_po == po)[..., None]
        k_seg = torch.where(here, args, k_seg)
        esc_seg = torch.where(here, escs, esc_seg)
    if cur_po < max_po:
        f = 1 << (max_po - cur_po)
        k_seg = k_seg.repeat_interleave(f, dim=-1)
        esc_seg = esc_seg.repeat_interleave(f, dim=-1)

    return plan_from_segments(best_bits, best_po, best_width, k_seg,
                              esc_seg, order, n)


@lru_cache(maxsize=None)
def _param_positions(n: int, psize_min: int, device: torch.device,
                     ) -> tuple[torch.Tensor, torch.Tensor] | None:
    """The param-slot positions ``pos_p`` (int32) and the finest segment
    of each (int64) on ``device``, built once; None where every sample
    is a position (one-sample partitions)."""
    ppos = sorted(set(range(min(33, n))) | set(range(0, n, psize_min)))
    if len(ppos) == n and psize_min == 1:
        return None
    pos_p = torch.tensor(ppos, dtype=torch.int32, device=device)
    return pos_p, (pos_p // psize_min).long()


def plan_from_segments(bits: torch.Tensor, porder: torch.Tensor,
                       width: torch.Tensor, k_seg: torch.Tensor,
                       esc_seg: torch.Tensor, order: torch.Tensor,
                       n: int) -> RicePlan:
    """The :class:`RicePlan` of a chosen partition order from its
    finest-grid parameters ``k_seg`` / ``esc_seg`` ``[..., nseg]`` (each
    finest segment's parameter and escape flag under the chosen order):
    every other field derives from them."""
    dev = k_seg.device
    psize_min = n // k_seg.shape[-1]
    k_sample = k_seg.repeat_interleave(psize_min, dim=-1)
    esc_sample = esc_seg.repeat_interleave(psize_min, dim=-1)
    i = torch.arange(n, dtype=torch.int32, device=dev)
    psz_best = torch.bitwise_right_shift(torch.full_like(porder, n),
                                         porder)[..., None]
    order_c = order[..., None]
    param_start = ((i % psz_best == 0) & (i > 0)) | (i == order_c)

    positions = _param_positions(n, psize_min, dev)
    if positions is None:
        k_param, esc_param, start_param = k_seg, esc_seg, param_start
    else:
        pos_p, part_idx = positions
        k_param = k_seg[..., part_idx]
        esc_param = esc_seg[..., part_idx]
        start_param = (((pos_p % psz_best) == 0) & (pos_p > 0)) \
            | (pos_p == order_c)

    return RicePlan(bits=bits, porder=porder, width=width,
                    k_sample=k_sample, param_start=param_start,
                    esc_sample=esc_sample, k_param=k_param,
                    start_param=start_param, esc_param=esc_param,
                    k_seg=k_seg, esc_seg=esc_seg)
