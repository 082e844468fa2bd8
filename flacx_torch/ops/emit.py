"""Subframe → symbol-stream emission.

Every subframe occupies a FIXED slot layout regardless of its kind; unused
slots carry zero length and vanish in the bit packer:

  [header(1) | wasted(1) | warmup(T) | lpc-meta(1) | coefs(T) |
   res-meta(1) | param/sample slots (see :func:`interleave_slots`)]

A Rice-coded residual sample is ONE symbol: value ``(1 << k) | remainder``
with length ``q + 1 + k`` — its leading zeros ARE the unary quotient (the
Rice planner caps every code at 32 bits).

Partition parameter slots live at STATIC positions: a partition can only
start at sample ``order`` (≤ 32) or at a multiple of the finest legal
partition size, so a param slot precedes samples 0..32 and every multiple
of ``psize_min``.  Symbol values are unsigned 32-bit, carried in int64.
"""

from __future__ import annotations

import math

import torch

from flacx_torch.ops.rice import RicePlan

KIND_CONSTANT, KIND_VERBATIM, KIND_FIXED, KIND_LPC = 0, 1, 2, 3


def _bits_mask(bps: torch.Tensor) -> torch.Tensor:
    """``(1 << bps) - 1`` as int64."""
    b64 = bps.long()
    return torch.bitwise_left_shift(torch.ones_like(b64), b64) - 1


def param_slot_positions(n: int, psize_min: int) -> list[int]:
    """Sample indices that may be preceded by a partition-parameter field."""
    pos = set(range(0, min(33, n)))
    pos.update(range(0, n, psize_min))
    return sorted(pos)


def subframe_header_symbols(kind: torch.Tensor, order: torch.Tensor,
                            bps: torch.Tensor, x: torch.Tensor,
                            taps: torch.Tensor, shift: torch.Tensor,
                            precision: int, plan: RicePlan,
                            wasted: torch.Tensor | None = None,
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Header-region symbols: subframe header, wasted-bits unary, warmup
    (the constant value rides in warmup slot 0), LPC meta + coefficients,
    residual meta.  ``wasted`` ``[B, C]`` is each subframe's count of
    stripped low zero bits (None: none); ``bps`` and ``x`` are then the
    shifted width and samples.  Returns ``(values int64, lengths int32)``
    of shape ``[B, C, 4 + 2T]``."""
    b, c, _ = x.shape
    t = taps.shape[-1]
    dev = x.device
    x64 = x[..., :t].long()
    bps_mask = _bits_mask(bps)[..., None]
    is_pred = kind >= KIND_FIXED
    is_lpc = kind == KIND_LPC

    # subframe header (1 bit pad + 6-bit type + wasted flag = 8 bits),
    # then the unary wasted count ((w-1) zeros and a one = w bits)
    if wasted is None:
        wasted = torch.zeros_like(kind)
    has_wasted = wasted > 0
    order64 = order.long()
    type_code = torch.where(
        kind == KIND_CONSTANT, 0,
        torch.where(kind == KIND_VERBATIM, 1,
                    torch.where(kind == KIND_FIXED, 8 + order64,
                                32 + order64 - 1)))
    hdr_v = ((type_code << 1) | has_wasted.long())[..., None]
    hdr_l = torch.full((b, c, 1), 8, dtype=torch.int32, device=dev)
    wst_v = torch.ones((b, c, 1), dtype=torch.int64, device=dev)
    wst_l = torch.where(has_wasted, wasted, 0)[..., None].to(torch.int32)

    # warmup slots (constant value rides in slot 0)
    ti = torch.arange(t, dtype=torch.int32, device=dev)
    warm_active = is_pred[..., None] & (ti < order[..., None])
    const_active = (kind == KIND_CONSTANT)[..., None] & (ti == 0)
    warm_v = x64 & bps_mask
    warm_l = torch.where(warm_active | const_active, bps[..., None], 0) \
        .to(torch.int32)

    # LPC meta ((precision-1)<<5 | shift, 9 bits) and coefficients
    meta_v = (((precision - 1) << 5) | (shift.long() & 0xFFFFFFFF))[..., None]
    meta_l = torch.where(is_lpc, 9, 0)[..., None].to(torch.int32)
    coef_v = taps.long() & ((1 << precision) - 1)
    coef_l = torch.where(is_lpc[..., None] & (ti < order[..., None]),
                         precision, 0).to(torch.int32)

    # residual meta (2-bit method + 4-bit partition order)
    method = (plan.width - 4).long()
    rmeta_v = ((method << 4) | plan.porder.long())[..., None]
    rmeta_l = torch.where(is_pred, 6, 0)[..., None].to(torch.int32)

    values = torch.cat([hdr_v, wst_v, warm_v, meta_v, coef_v, rmeta_v],
                       dim=-1)
    lengths = torch.cat([hdr_l, wst_l, warm_l, meta_l, coef_l, rmeta_l],
                        dim=-1)
    return values, lengths


def partition_param_symbols(kind: torch.Tensor, plan: RicePlan,
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Partition-parameter symbols at the static slot positions.

    Rice partition: width-bit parameter k.  Escaped partition: width-bit
    all-ones marker followed by the 5-bit raw size E (one fused symbol).
    Returns ``(values int64, lengths int32)`` of shape ``[B, C, P]`` with
    ``P = len(param_slot_positions(n, psize_min))``.
    """
    is_pred = kind >= KIND_FIXED
    esc_p = plan.esc_param
    kp = plan.k_param.long()
    ones_marker = _bits_mask(plan.width)[..., None]
    param_v = torch.where(esc_p, (ones_marker << 5) | kp, kp)
    param_l = torch.where(is_pred[..., None] & plan.start_param,
                          plan.width[..., None] + torch.where(esc_p, 5, 0),
                          0).to(torch.int32)
    return param_v, param_l


def sample_symbols_from(kind: torch.Tensor, order: torch.Tensor,
                        bps: torch.Tensor, x: torch.Tensor,
                        zz: torch.Tensor, k_sample: torch.Tensor,
                        esc_sample: torch.Tensor,
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample symbols given each sample's parameter ``k_sample`` and
    escape flag: Rice code, escaped raw residual (``k_sample``-bit two's
    complement) or verbatim sample.  Returns ``(values int64, lengths
    int32)`` of shape ``[B, C, N]``."""
    n = x.shape[-1]
    is_pred = kind >= KIND_FIXED
    i = torch.arange(n, dtype=torch.int32, device=x.device)
    in_resid = is_pred[..., None] & (i >= order[..., None])
    k = k_sample.long()
    z = zz.long()
    low = torch.bitwise_left_shift(torch.ones_like(k), k) - 1
    rice_v = (low + 1) | (z & low)
    rice_l = (zz >> k_sample.to(zz.dtype)).to(torch.int32) + 1 + k_sample
    r_signed = (z >> 1) ^ -(z & 1)
    esc_v = r_signed & low
    pred_v = torch.where(esc_sample, esc_v, rice_v)
    pred_l = torch.where(esc_sample, k_sample.to(torch.int32), rice_l)
    verb_v = x.long() & _bits_mask(bps)[..., None]
    is_verb = (kind == KIND_VERBATIM)[..., None]
    samp_v = torch.where(is_verb, verb_v, pred_v)
    samp_l = torch.where(is_verb, bps[..., None],
                         torch.where(in_resid, pred_l, 0)).to(torch.int32)
    return samp_v, samp_l


def sample_symbols(kind: torch.Tensor, order: torch.Tensor,
                   bps: torch.Tensor, x: torch.Tensor, zz: torch.Tensor,
                   plan: RicePlan) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample symbols (one per sample) of a Rice plan."""
    return sample_symbols_from(kind, order, bps, x, zz, plan.k_sample,
                               plan.esc_sample)


def blocked_layout_ok(n: int, psize_min: int) -> bool:
    """Whether the blocked (8-aligned, params-before-samples) slot layout
    applies."""
    return (psize_min >= 40 and psize_min % 8 == 0
            and n % psize_min == 0 and n > psize_min)


def general_layout_tables(n: int, psize_min: int,
                          ) -> tuple[list[int], list[int]]:
    """Param-slot indices of the general layout: ``extra``, the head
    slots off the segment grid (emitted first), and ``mult``, the slot
    that leads each of the ``n // psize_min`` segments."""
    ppos = param_slot_positions(n, psize_min)
    extra = [j for j, pos in enumerate(ppos) if pos % psize_min]
    mult = [j for j, pos in enumerate(ppos) if pos % psize_min == 0]
    return extra, mult


def segmented_layout(n: int, psize_min: int,
                     ) -> tuple[int, list[int], list[int]] | None:
    """The JAX package's segmented tile-emit layout (finest partitions
    below 40 samples): ``(chunk_segs, extra, mult)``, where ``chunk_segs``
    is the smallest segment count whose ``[1 param, psize_min samples]``
    slots fill whole 512-slot packer tiles and ``extra`` / ``mult`` are
    :func:`general_layout_tables`; None where that tiling does not exist.
    The port's ``frame_pack`` walks the general layout either way; this
    decides only where the JAX package writes the residual with its
    stats (:func:`tile_layout_ok`)."""
    if psize_min < 1 or n % psize_min or n <= psize_min:
        return None
    nseg = n // psize_min
    chunk = 512 // math.gcd(psize_min + 1, 512)
    if chunk % 8 or nseg % chunk or (chunk * psize_min) % 128:
        return None
    extra, mult = general_layout_tables(n, psize_min)
    assert len(mult) == nseg
    return chunk, extra, mult


def tile_layout_ok(n: int, psize_min: int) -> bool:
    """Whether the JAX package's tiled emit applies at this block size and
    finest partition (blocked or segmented layout).  Where it does not,
    its estimate search writes the chosen LPC residual together with the
    statistics (``lpc_residual`` res mode) instead of recomputing it."""
    return (blocked_layout_ok(n, psize_min)
            or segmented_layout(n, psize_min) is not None)


def interleave_slots(pv: torch.Tensor, sv: torch.Tensor,
                     psize_min: int) -> list[torch.Tensor]:
    """Emit param slots ``pv [B, C, P]`` so each precedes its partition's
    samples ``sv [B, C, N]``.

    BLOCKED layout: the 33 head param slots (at most one carries a
    symbol: partition 0's parameter, preceding sample ``order``) form one
    block before the first sample segment, and every later segment leads
    with its single param slot padded to 8.  Legal because samples
    ``0..order-1`` are zero-length (warmup lives in the header region),
    and zero-length slots are position-free.

    General layout (any ``psize_min``): the head params at non-multiple
    positions first, then each segment leads with its own param slot.
    """
    b, c, n = sv.shape
    nseg = n // psize_min
    if blocked_layout_ok(n, psize_min):
        z7 = torch.zeros((b, c, 7), dtype=pv.dtype, device=pv.device)
        rest_p = pv[..., 33:, None]
        rest_z = torch.zeros((b, c, nseg - 1, 7), dtype=pv.dtype,
                             device=pv.device)
        rest_s = sv[..., psize_min:].reshape(b, c, nseg - 1, psize_min)
        rest = torch.cat([rest_p, rest_z, rest_s], dim=-1) \
            .reshape(b, c, (nseg - 1) * (psize_min + 8))
        return [pv[..., :33], z7, sv[..., :psize_min], rest]
    extra, mult = general_layout_tables(n, psize_min)
    seg = torch.cat([pv[..., mult][..., None],
                     sv.reshape(b, c, nseg, psize_min)], dim=-1) \
        .reshape(b, c, nseg * (psize_min + 1))
    return [pv[..., extra], seg] if extra else [seg]


def subframe_symbols(kind: torch.Tensor, order: torch.Tensor,
                     bps: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
                     shift: torch.Tensor, precision: int, zz: torch.Tensor,
                     plan: RicePlan, psize_min: int,
                     wasted: torch.Tensor | None = None,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Emit symbols for a batch of subframes.

    Args:
      kind: ``[B, C]`` in {constant, verbatim, fixed, lpc}.
      order: ``[B, C]`` predictor order.
      bps: ``[B, C]`` effective sample size (incl. the side-channel bit).
      x: ``[B, C, N]`` integer samples of the emitted (virtual) channel.
      taps: ``[B, C, T]`` chosen integer predictor taps.
      shift: ``[B, C]`` LPC shift.
      zz: ``[B, C, N]`` zigzag residual magnitudes (0 at ``i < order``).
      plan: exact Rice plan for these residuals.
      psize_min: finest legal partition size.
      wasted: ``[B, C]`` stripped low zero bits, or None.
    Returns:
      ``(values int64, lengths int32)`` of shape ``[B, C, slots]``.
    """
    hdr_v, hdr_l = subframe_header_symbols(kind, order, bps, x, taps,
                                           shift, precision, plan, wasted)
    param_v, param_l = partition_param_symbols(kind, plan)
    samp_v, samp_l = sample_symbols(kind, order, bps, x, zz, plan)
    values = torch.cat([hdr_v, *interleave_slots(param_v, samp_v,
                                                 psize_min)], dim=-1)
    lengths = torch.cat([hdr_l, *interleave_slots(param_l, samp_l,
                                                  psize_min)], dim=-1)
    return values, lengths
