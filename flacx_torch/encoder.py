"""Batched FLAC encoder on PyTorch and CUDA.

A batch of ``[B, channels, block_size]`` PCM blocks flows through one
pipeline on the device:

  stereo candidates → wasted bits → per window: analysis (autocorrelation
  + fixed-order sums, ``analysis`` kernel) → Levinson-Durbin and
  quantization of every order → [exact search: every order's residual
  statistics, ``lpc_allorder`` kernel] → window merge → order choice
  (estimate search: the chosen order's statistics, ``lpc_residual``
  kernel in stats mode, or in res mode, which also writes the residual,
  where the JAX package's tiled emit does not apply) → stereo mode choice
  (exact search: on every virtual channel's exact Rice plan) → chosen
  zigzag residual (``lpc_residual`` in zz mode) → exact Rice search
  (``rice_stats`` kernel + plan) → emit, pack and CRC-16 (``frame_pack``
  kernel)

yielding complete, CRC'd FLAC frames as byte rows.  On the CPU every
kernel is replaced by its plain PyTorch version.

Both order searches, f32 and f64 analysis, any number of windows and
wasted bits are covered at every sample width up to 32 bits, every
partition order and frame size, and conformance mode (the reference
encoder's choices, :mod:`flacx_torch.conformance`).  Past 24 bits the
zigzag residual is int64 (``EncoderConfig.work_dtype``), as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from flacx_torch import trace
from flacx_torch.conformance import encode_batch_conformance
from flacx_torch.device import on_device
from flacx_torch.format import (FIXED_PREDICTOR_TAPS, INDEPENDENT_CHANNELS,
                                Channels)
from flacx_torch.kernels.analysis import analysis
from flacx_torch.kernels.lpc_allorder import lpc_allorder
from flacx_torch.kernels.lpc_residual import (lpc_residual_res,
                                              lpc_residual_stats,
                                              lpc_residual_zz)
from flacx_torch.kernels.rice_stats import rice_stats
from flacx_torch.ops import emit, rice
from flacx_torch.ops.framepack import pack_frames
from flacx_torch.ops.headers import frame_header_symbols, frame_indices
from flacx_torch.ops.lpc import (apodization_window_np, fused_int32_ok,
                                 levinson_all_orders, merge_windows,
                                 quantize_all_orders, window_candidates,
                                 window_from_numpy)
from flacx_torch.parallel.mesh import home_device

_INF = 1 << 50

#: stereo modes: (channel code, virtual-channel pair)
_STEREO_MODES = (
    (Channels.L_R, (0, 1)),
    (Channels.L_S, (0, 3)),
    (Channels.S_R, (3, 1)),
    (Channels.M_S, (2, 3)),
)


def device_min_block_size(max_lpc_order: int) -> int:
    """Smallest block size the batched pipeline accepts."""
    return 2 * max(max_lpc_order, 4) + 2


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder configuration: the same fields, defaults and validation as
    the JAX package's ``EncoderConfig``."""
    sample_rate: int = 44100
    bps: int = 16
    channels: int = 2
    block_size: int = 4608
    max_lpc_order: int = 12
    qlp_precision: int = 5
    partition_orders: tuple[int, ...] = (0, 1, 2, 3, 4, 5)
    stereo: str = "auto"          # "auto" | "independent"
    #: "estimate" ranks LPC orders by the Levinson prediction error and
    #: computes exact residuals only for the winner; "exact" evaluates
    #: every order's true integer residual.
    order_search: str = "estimate"
    #: LPC analysis float width: "f32", "f64" or "auto" (f32 for the
    #: estimate-mode order search, f64 for exact).
    analysis_dtype: str = "auto"
    #: Emit ESCAPED Rice partitions where strictly smaller than every
    #: eligible Rice parameter.
    escapes: bool = True
    #: Detect and strip shared trailing zero bits per subframe.
    wasted_bits: bool = False
    #: LPC apodization window candidates (libFLAC-style ``-A`` names).
    windows: tuple[str, ...] = ("tukey(0.5)",)
    #: Reproduce the reference encoder's parameter choices exactly.
    conformance: bool = False

    def __post_init__(self):
        if self.conformance:
            object.__setattr__(self, "stereo", "independent")
            object.__setattr__(self, "escapes", False)
            object.__setattr__(self, "wasted_bits", False)
            object.__setattr__(self, "windows", ("tukey(0.5)",))
        if isinstance(self.windows, str):          # accept a lone name
            object.__setattr__(self, "windows", (self.windows,))
        if not self.windows:
            raise ValueError("windows must name at least one window")
        for w in self.windows:
            apodization_window_np(w, 64)           # validate eagerly
        if self.order_search not in ("estimate", "exact"):
            raise ValueError("order_search must be 'estimate' or 'exact'")
        if self.analysis_dtype not in ("auto", "f32", "f64"):
            raise ValueError("analysis_dtype must be 'auto', 'f32' or 'f64'")
        if not 1 <= self.channels <= 8:
            raise ValueError("channels must be in 1..8")
        if not 0 <= self.max_lpc_order <= 32:
            raise ValueError("max LPC order is 32")
        if self.max_lpc_order and self.qlp_precision < 5:
            raise ValueError("qlp precision must be >= 5")
        if self.block_size < device_min_block_size(self.max_lpc_order):
            raise ValueError("block size too small for requested LPC order")
        if self.bps > 31 and self.stereo == "auto":
            # side channel would need 33-bit samples; stay independent
            object.__setattr__(self, "stereo", "independent")

    @property
    def use_stereo_modes(self) -> bool:
        return self.channels == 2 and self.stereo == "auto"

    @property
    def max_taps(self) -> int:
        return max(self.max_lpc_order, 4)

    @property
    def kmax(self) -> int:
        return min(30, self.bps + 7)

    @property
    def porders(self) -> tuple[int, ...]:
        """Legal partition orders: requested ∪ {0}, filtered by the 4-bit
        field and divisibility."""
        legal = [o for o in self.partition_orders
                 if o <= 15 and self.block_size % (1 << o) == 0]
        return tuple(sorted(set(legal) | {0}))

    @property
    def preferred_porders(self) -> tuple[int, ...]:
        return tuple(o for o in self.porders if o in self.partition_orders)

    @property
    def eff_bps(self) -> int:
        """Max per-virtual-channel sample width (side channel is bps+1)."""
        return self.bps + (1 if self.use_stereo_modes else 0)

    @property
    def sum_taps_max(self) -> int:
        """Static bound on Σ|taps| of a quantized LPC predictor."""
        return max(1, self.max_lpc_order << max(self.qlp_precision - 1, 0))

    @property
    def work_dtype(self) -> torch.dtype:
        """The zigzag residual's type: int32 up to 24-bit samples (fixed
        residuals are under 2^(eff_bps+3), and LPC residuals past 2^30
        make their candidate ineligible), int64 past them."""
        return torch.int32 if self.bps <= 24 else torch.int64

    @property
    def max_frame_bytes(self) -> int:
        side = 1 if self.use_stereo_modes else 0
        bits = (16 * 8 + self.channels * (8 + self.block_size *
                                          (self.bps + side)) + 64)
        return ((bits // 8 + 2) + 255) // 256 * 256


def config_from_flacx(d: dict) -> EncoderConfig:
    """An :class:`EncoderConfig` from ``dataclasses.asdict`` of the JAX
    package's config; raises on a field this config does not know."""
    known = {f.name for f in dataclasses.fields(EncoderConfig)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"unknown encoder config fields: {unknown}")
    return EncoderConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in d.items()})


def analysis_dtype(cfg: EncoderConfig) -> torch.dtype:
    """The LPC analysis float type: f64 for ``analysis_dtype="f64"``, and
    for ``"auto"`` under the exact order search; else f32."""
    if cfg.analysis_dtype == "f64" or (cfg.analysis_dtype == "auto"
                                       and cfg.order_search == "exact"):
        return torch.float64
    return torch.float32


def analysis_windows(cfg: EncoderConfig, device: torch.device,
                     ) -> torch.Tensor:
    """The apodization windows ``[W, block_size]``, one row per name in
    ``cfg.windows``, in the analysis float type, on ``device``."""
    np_dtype = np.float64 if analysis_dtype(cfg) == torch.float64 \
        else np.float32
    return torch.stack([
        window_from_numpy(apodization_window_np(name, cfg.block_size)
                          .astype(np_dtype))
        for name in cfg.windows]).to(device)


class _Constants(NamedTuple):
    """What ``_encode_batch`` reads of a configuration on a device, built
    once (a copy to the card each batch would be illegal in a captured
    graph, and costs host time eagerly)."""
    bps_v: torch.Tensor           # [V] int64 each virtual channel's width
    fixed_taps: torch.Tensor      # [5, 4] FIXED_PREDICTOR_TAPS
    pairs: torch.Tensor | None    # [4, 2] each stereo mode's channel pair
    codes: torch.Tensor | None    # [4] int32 each stereo mode's code
    win_pow: tuple[float, ...]    # each window's mean power


@functools.lru_cache(maxsize=None)
def _constants(cfg: EncoderConfig, dev: torch.device) -> _Constants:
    if cfg.use_stereo_modes:
        bps_list = [cfg.bps] * 3 + [cfg.bps + 1]
        pairs = torch.tensor([m[1] for m in _STEREO_MODES], device=dev)
        codes = torch.tensor([int(m[0]) for m in _STEREO_MODES],
                             dtype=torch.int32, device=dev)
    else:
        bps_list = [cfg.bps] * cfg.channels
        pairs = codes = None
    return _Constants(
        torch.tensor(bps_list, dtype=torch.int64, device=dev),
        torch.from_numpy(FIXED_PREDICTOR_TAPS).to(dev), pairs, codes,
        tuple(float(np.mean(apodization_window_np(name, cfg.block_size)
                            ** 2)) for name in cfg.windows))


def shared_trailing_zeros(x: torch.Tensor) -> torch.Tensor:
    """Low zero bits shared by every sample of each row of int32 ``x
    [..., n]``: the least trailing-zero count of its samples, 63 for a row
    of zeros.  Integer ops only: each sample's lowest set bit, the row's
    least one, its bit length."""
    x64 = x.long()
    low = x64 & -x64
    none = torch.iinfo(torch.int64).max
    least = torch.where(low == 0, none, low).amin(-1)
    return torch.where(least == none, 63, rice.bit_length(least) - 1)


def _gather_pair(arr: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """``arr [B, V, ...]`` at each frame's virtual-channel pair ``sel``."""
    idx = sel.reshape(*sel.shape, *([1] * (arr.dim() - 2)))
    return arr.gather(1, idx.expand(-1, -1, *arr.shape[2:]))


def _encode_batch(cfg: EncoderConfig, pcm: torch.Tensor, frame_index,
                  windows: torch.Tensor | None = None) -> dict:
    """pcm int16/int32 ``[B, channels, N]`` → frames ``[B, max_bytes]``.

    ``frame_index`` is either a scalar (the first index of a contiguous
    batch) or a per-frame ``[B]`` int64 array or tensor (a corpus batch
    mixes the frames of many files); one of another length raises.

    ``windows`` holds one ``[N]`` apodization window per name in
    ``cfg.windows`` (``[W, N]``; a lone ``[N]`` for one window), in the
    analysis float type, on ``pcm``'s device; None builds them from
    ``cfg``.
    Returns a dict of device tensors: ``bytes`` (u8), ``length``, ``kind``,
    ``channel_code`` and ``subframe_bits``; under ``cfg.conformance`` the
    reference's choices (:func:`flacx_torch.conformance.
    encode_batch_conformance`, which adds ``overflow``).
    """
    if cfg.conformance:
        return encode_batch_conformance(cfg, pcm, frame_index)
    with trace.span("encode.analysis"):
        n = cfg.block_size
        b = pcm.shape[0]
        p = cfg.max_lpc_order
        t = cfg.max_taps
        prec = cfg.qlp_precision
        kmax = cfg.kmax
        exact = cfg.order_search == "exact"
        dev = pcm.device
        const = _constants(cfg, dev)
        indices = frame_indices(frame_index, b, dev)
        if windows is None:
            windows = analysis_windows(cfg, dev)
        windows = windows.reshape(-1, n)
        adt = analysis_dtype(cfg)
        if len(windows) != len(cfg.windows) or windows.dtype != adt:
            raise ValueError(f"expected {len(cfg.windows)} {adt} windows")

        def ar(*args):
            return torch.arange(*args, dtype=torch.int64, device=dev)

        # ----- virtual channels ----------------------------------------------
        if cfg.use_stereo_modes:
            left = pcm[:, 0].to(torch.int32)
            right = pcm[:, 1].to(torch.int32)
            x_v = torch.stack([left, right, (left + right) >> 1,
                               left - right], dim=1)             # [B, 4, N]
        else:
            x_v = pcm.to(torch.int32).contiguous()
        nv = x_v.shape[1]
        bps_v = const.bps_v.expand(b, nv)                            # [B, V]

        # ----- wasted bits: strip each virtual channel's shared low zeros ----
        if cfg.wasted_bits:
            w_v = torch.minimum(shared_trailing_zeros(x_v), bps_v - 1)
            x_v = x_v >> w_v[..., None].to(torch.int32)
            bps_v = bps_v - w_v
        else:
            w_v = torch.zeros((b, nv), dtype=torch.int64, device=dev)

        # ----- candidate analysis: fixed orders 0..4, LPC orders 1..P per
        # window, the windows merged per (frame, channel, order) -------------
        lorders = ar(1, p + 1)
        lcounts = n - lorders
        sum_taps_max = cfg.sum_taps_max
        psize_min = n >> max(cfg.porders)
        keep_res = (not exact and p > 0
                    and not emit.tile_layout_ok(n, psize_min)
                    and fused_int32_ok(cfg.eff_bps, sum_taps_max))
        best = None
        # every window's autocorrelation in one call (each window's as
        # flacx computes it alone), and the fixed-order sums, which do not
        # depend on the window; without LPC only the sums are used
        autoc_w, fzz_sum = analysis(x_v, windows if p else windows[:1], p,
                                    eff_bps=cfg.eff_bps)
        for wi in range(len(cfg.windows) if p else 0):
            autoc = autoc_w[:, :, wi]
            taps_f, lpc_err, valid_ld = levinson_all_orders(autoc, p)
            # Levinson returns the analysis polynomial a[1:]; the prediction
            # coefficients of x̂[i] = Σ c_j·x[i-1-j] are its negation
            qcoefs_w, qshifts_w, valid_q = quantize_all_orders(-taps_f, prec)
            if exact:
                lzz_w, lmax_w = lpc_allorder(x_v, qcoefs_w, qshifts_w,
                                             cfg.eff_bps, sum_taps_max)
            else:
                # the error power is in the windowed domain: undo the
                # window's average power so fixed (unwindowed) and LPC
                # estimates, and different windows, compare;
                # E|r| ≈ sqrt(2/π)·σ
                sigma = torch.sqrt(torch.clamp(lpc_err, min=0.0)
                                   / (n * const.win_pow[wi]))
                mean_abs = math.sqrt(2.0 / math.pi) * sigma
                lzz_w = (2.0 * mean_abs * lcounts.double()).long()
                lmax_w = None
            best = merge_windows(best, window_candidates(
                lzz_w, lmax_w, qcoefs_w, qshifts_w, valid_ld & valid_q))

        fixed_orders = ar(5)
        fest = (rice.estimate_bits(fzz_sum, n - fixed_orders, kmax)
                + 8 + fixed_orders * bps_v[..., None])
        fixed_bits = fest.amin(-1)
        fixed_order = fest.argmin(-1).to(torch.int32)

    with trace.span("encode.select"):
        if p:
            lest = (rice.estimate_bits(best.lzz, lcounts, kmax) + 8
                    + lorders * bps_v[..., None] + 9 + lorders * prec)
            lest = torch.where(best.valid, lest, _INF)
            lo0 = lest.argmin(-1)                                   # [B, V]
            lpc_order = (lo0 + 1).to(torch.int32)
            taps_lpc_v = best.qcoefs.gather(
                2, lo0[..., None, None].expand(b, nv, 1, p))[:, :, 0]
            shift_lpc_v = best.qshifts.gather(2, lo0[..., None])[..., 0]
            if exact:
                # every order's exact statistics exist: take the chosen one's
                lzz_exact = best.lzz.gather(-1, lo0[..., None])[..., 0]
                lpc_maxabs = best.maxabs.gather(-1, lo0[..., None])[..., 0]
            elif keep_res:
                # the JAX package writes the chosen residual with its stats
                # here and emits it, rather than recompute it (its tiled emit
                # does not apply)
                lpc_res_v, lzz_exact, lpc_maxabs = lpc_residual_res(
                    x_v, taps_lpc_v.contiguous(), shift_lpc_v.contiguous(),
                    lpc_order, cfg.eff_bps, sum_taps_max)
            else:
                # cross-family comparison on EXACT magnitude sums (the
                # Levinson error is optimistic about post-quantization
                # residuals)
                lzz_exact, lpc_maxabs = lpc_residual_stats(
                    x_v, taps_lpc_v.contiguous(), shift_lpc_v.contiguous(),
                    lpc_order, cfg.eff_bps, sum_taps_max)
            lo64 = lpc_order.long()
            lpc_bits = (rice.estimate_bits(lzz_exact, n - lo64, kmax)
                        + 8 + lo64 * bps_v + 9 + lo64 * prec)
            lpc_ok = best.valid.gather(-1, lo0[..., None])[..., 0]
            if cfg.work_dtype == torch.int32:
                # residuals that cannot survive the int32 working dtype make
                # the LPC candidate ineligible (verbatim/fixed win instead)
                lpc_ok = lpc_ok & (lpc_maxabs < (1 << 30))
            lpc_bits = torch.where(lpc_ok, lpc_bits, _INF)
            pred_is_lpc = lpc_bits < fixed_bits
        else:
            lpc_bits = torch.full_like(fixed_bits, _INF)
            lpc_order = torch.ones_like(fixed_order)
            taps_lpc_v = torch.zeros((b, nv, t), dtype=torch.int32, device=dev)
            shift_lpc_v = torch.zeros((b, nv), dtype=torch.int32, device=dev)
            pred_is_lpc = torch.zeros_like(fixed_bits, dtype=torch.bool)
        pred_bits = torch.minimum(fixed_bits, lpc_bits)
        pred_order = torch.where(pred_is_lpc, lpc_order, fixed_order)

        # each virtual channel's chosen taps, merged across the two families
        # and padded to max_taps
        taps_fix4 = const.fixed_taps[fixed_order.long()]         # [B, V, 4]
        taps_fix = torch.nn.functional.pad(taps_fix4, (0, t - 4))
        taps_lpc = torch.nn.functional.pad(taps_lpc_v,
                                           (0, t - taps_lpc_v.shape[-1]))
        taps_v = torch.where(pred_is_lpc[..., None], taps_lpc, taps_fix) \
            .to(torch.int32)
        shift_v = torch.where(pred_is_lpc, shift_lpc_v, 0).to(torch.int32)

        const_ok = (x_v == x_v[..., :1]).all(-1)                    # [B, V]
        const_bits = torch.where(const_ok, 8 + bps_v, _INF)
        verb_bits = 8 + n * bps_v

        def residual_zz(x, taps, shift, order, taps_max):
            """The zigzag residual of the chosen taps (``taps_max`` bounds
            their Σ|taps|)."""
            return lpc_residual_zz(x, taps.contiguous(), shift.contiguous(),
                                   order.contiguous(), cfg.eff_bps, taps_max,
                                   cfg.work_dtype)

        def rice_plan(zz, order):
            """The exact Rice plan of a zigzag residual."""
            order = order.contiguous()
            return rice.exact_plan(zz, order, cfg.porders,
                                   cfg.preferred_porders, kmax,
                                   allow_escape=cfg.escapes,
                                   kernel_stats=rice_stats(
                                       zz, order, cfg.porders, kmax))

        def residual_plan(x, taps, shift, order):
            zz = residual_zz(x, taps, shift, order, max(sum_taps_max, 15))
            return zz, rice_plan(zz, order)

        # exact mode ranks the stereo modes by the exact Rice plan of every
        # virtual channel; the plan of the winning pair is then emitted
        plan_v = None
        if cfg.use_stereo_modes and exact:
            zz_v, plan_v = residual_plan(x_v, taps_v, shift_v, pred_order)
            po64 = pred_order.long()
            pred_bits = (8 + po64 * bps_v
                         + torch.where(pred_is_lpc, 9 + po64 * prec, 0)
                         + plan_v.bits)
        cost_v = torch.minimum(torch.minimum(pred_bits, verb_bits), const_bits)

        # ----- stereo mode / channel selection -------------------------------
        if cfg.use_stereo_modes:
            pairs, codes = const.pairs, const.codes
            mode_cost = cost_v[:, pairs[:, 0]] + cost_v[:, pairs[:, 1]]
            mode = mode_cost.argmin(-1)                                  # [B]
            ch_code = codes[mode]
            sel = pairs[mode]                                         # [B, 2]

            def gather_v(arr):
                return _gather_pair(arr, sel)
        else:
            ch_code = torch.full(
                (b,), int(INDEPENDENT_CHANNELS[cfg.channels]),
                dtype=torch.int32, device=dev)

            def gather_v(arr):
                return arr

        x_sel = gather_v(x_v).contiguous()
        is_lpc = gather_v(pred_is_lpc)
        order = gather_v(pred_order)
        const_sel = gather_v(const_ok)
        bps_c = gather_v(bps_v)
        taps = gather_v(taps_v).contiguous()
        shift = gather_v(shift_v).contiguous()

    with trace.span("encode.plan"):
        # ----- chosen residual and its exact Rice plan -----------------------
        if keep_res:
            # LPC rows from the written residual, fixed rows from the fixed
            # taps (Σ|taps| ≤ 15); both are zero at i < order
            zz_fix = residual_zz(x_sel, gather_v(taps_fix4),
                                 torch.zeros_like(shift), order, 15)
            zz = torch.where(is_lpc[..., None],
                             rice.zigzag(gather_v(lpc_res_v)), zz_fix)
            plan = rice_plan(zz, order)
        elif plan_v is None:
            zz, plan = residual_plan(x_sel, taps, shift, order)
        else:
            zz = gather_v(zz_v)
            plan = rice.RicePlan(*(gather_v(f) for f in plan_v))

        # ----- final kind by exact size --------------------------------------
        order64 = order.long()
        pred_total = (8 + order64 * bps_c
                      + torch.where(is_lpc, 9 + order64 * prec, 0)
                      + plan.bits)
        verb_total = 8 + n * bps_c
        kind = torch.where(
            const_sel, emit.KIND_CONSTANT,
            torch.where(verb_total < pred_total, emit.KIND_VERBATIM,
                        torch.where(is_lpc, emit.KIND_LPC, emit.KIND_FIXED))
        ).to(torch.int32)
        sub_bits = torch.where(const_sel, 8 + bps_c,
                               torch.minimum(verb_total, pred_total))

    with trace.span("encode.emit"):
        # ----- emission ------------------------------------------------------
        hdr = frame_header_symbols(indices, ch_code, n)
        frame_bytes, length = pack_frames(
            hdr, kind, order, bps_c.to(torch.int32), x_sel, taps, shift,
            prec, zz, plan, psize_min, cfg.max_frame_bytes,
            wasted=gather_v(w_v))
    return {"bytes": frame_bytes, "length": length, "kind": kind,
            "channel_code": ch_code, "subframe_bits": sub_bits}


def _fetch(result, valid: int, key: str, width: int | None = None,
           ) -> np.ndarray:
    """The first ``valid`` rows of ``result[key]`` on the host (its first
    ``width`` columns where given), the parts of a sharded result joined
    in frame order."""
    out = []
    with trace.span("encode.fetch"):
        for part in result if isinstance(result, list) else [result]:
            t = part[key][:max(valid, 0)]
            if width is not None:
                t = t[:, :width]
            out.append(t.cpu().numpy())
            trace.count("copy.d2h_bytes", t.nbytes)
            valid -= part[key].shape[0]
        return np.concatenate(out)


def _upload(arr: torch.Tensor, dev: torch.device,
            into: torch.Tensor | None = None) -> torch.Tensor:
    """``arr`` copied to ``dev``, into ``into`` where given (span
    ``encode.upload``; its bytes counted in ``copy.h2d_bytes``)."""
    with trace.span("encode.upload"), on_device(dev):
        x = arr.to(dev) if into is None else into.copy_(arr)
    trace.count("copy.h2d_bytes", x.nbytes)
    return x


def _shape_key(pcm) -> tuple:
    """A batch's shape and dtype, which key its captured graph."""
    arr = torch.as_tensor(pcm)
    return tuple(arr.shape), arr.dtype


class _Graph:
    """``_encode_batch`` captured as one CUDA graph for one batch shape:
    its static PCM input, the batch's first frame index as a device
    scalar, and the outputs that every replay overwrites.  Capture runs
    the stage spans and counts the launches once; a replay runs neither."""

    def __init__(self, cfg: EncoderConfig, shape: tuple, dtype: torch.dtype,
                 dev: torch.device, windows: torch.Tensor):
        self.pcm = torch.empty(shape, dtype=dtype, device=dev)
        self.index = torch.zeros((), dtype=torch.int64, device=dev)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = _encode_batch(cfg, self.pcm, self.index, windows)

    def replay(self, index: int) -> dict:
        """The outputs for a batch whose PCM is in :attr:`pcm` and whose
        first frame is ``index``, copied out of the graph's memory so that
        they outlive the next replay."""
        self.index.fill_(index)
        self.graph.replay()
        return {k: v.clone() for k, v in self.out.items()}


class BatchEncoder:
    """Batched frame encoder with host assembly.

    ``device`` defaults to the card; pass ``device="cpu"`` for the plain
    PyTorch path (no kernels).  There is no fallback between the two.
    ``sharding`` (:func:`flacx_torch.parallel.frame_sharding`) splits each
    batch into contiguous parts, one a device of its mesh: every part is
    launched on its device before any is read back, and the drain joins
    them in frame order.  ``device`` must then name the mesh's device type
    (and, with an index, one of its devices).

    On the card, unsharded and outside conformance mode,
    :meth:`encode_frame_stream` replays ``_encode_batch`` as one CUDA
    graph a batch: the first batch of each shape runs eagerly (it sets up
    the constants, the kernel libraries and their shared-memory opt-in);
    a later batch that another batch of its shape follows in its stream
    captures the graph, kept on the encoder for later streams (so a
    stream of two batches on a new encoder stays eager: one replay would
    not repay the capture).
    :meth:`encode_batch_device` and :meth:`encode_batch_indexed` always
    run eagerly.
    """

    def __init__(self, config: EncoderConfig, batch_frames: int = 32,
                 device: str | torch.device = "cuda", sharding=None):
        self.config = config
        self.batch_frames = batch_frames
        self.sharding = sharding
        self.device = home_device(device, sharding)
        devs = (self.device,) if sharding is None else sharding.mesh.devices
        self._part_windows = {dev: analysis_windows(config, dev)
                              for dev in dict.fromkeys(devs)}
        self._windows = self._part_windows[self.device]
        self._graphed = (self.device.type == "cuda" and sharding is None
                         and not config.conformance)
        #: by batch shape and dtype: None once its first batch ran
        #: eagerly, then its captured graph
        self._graphs: dict[tuple, _Graph | None] = {}

    def encode_batch_device(self, pcm, first_index: int):
        """Run the pipeline on ``[B, channels, N]`` int16 or int32 PCM
        (numpy or tensor); returns the device tensors of
        :func:`_encode_batch`, under ``sharding`` a list of such dicts,
        one a part in frame order.  int16 input crosses to the device as
        int16 and is widened there."""
        return self._run(self._checked(pcm), int(first_index))

    def encode_batch_indexed(self, pcm, frame_indices):
        """:meth:`encode_batch_device` with a per-frame coded number:
        ``frame_indices`` int64 ``[B]`` (numpy or tensor), one a frame of
        ``pcm`` (a corpus batch mixes the frames of many files).  Indices
        of another length raise ``ValueError``."""
        idx = torch.as_tensor(frame_indices)
        if tuple(idx.shape) != (len(pcm),):
            raise ValueError(f"frame indices of shape {tuple(idx.shape)} "
                             f"for a batch of {len(pcm)} frames")
        return self._run(self._checked(pcm), idx)

    def _checked(self, pcm) -> torch.Tensor:
        """``pcm`` as a tensor; raises unless int16 or int32 ``[B,
        channels, block_size]``."""
        arr = torch.as_tensor(pcm)
        if arr.dtype not in (torch.int16, torch.int32):
            raise TypeError(f"PCM must be int16 or int32, got {arr.dtype}")
        if tuple(arr.shape[1:]) != (self.config.channels,
                                    self.config.block_size):
            raise ValueError(f"PCM shape {tuple(arr.shape)} does not match "
                             f"[B, {self.config.channels}, "
                             f"{self.config.block_size}]")
        return arr

    def _run(self, arr: torch.Tensor, index):
        if self.sharding is None:
            x = _upload(arr, self.device)
            with on_device(self.device):
                return _encode_batch(self.config, x, index, self._windows)
        parts = []
        for dev, lo, hi in self.sharding.parts(arr.shape[0]):
            part_index = index + lo if isinstance(index, int) \
                else index[lo:hi]
            x = _upload(arr[lo:hi], dev)
            with on_device(dev):
                parts.append(_encode_batch(self.config, x, part_index,
                                           self._part_windows[dev]))
        return parts

    def _capture_due(self, pcm) -> bool:
        """Whether a batch like ``pcm`` would capture its shape's graph
        were another of its shape to follow: the shape has run eagerly
        and has no graph yet."""
        key = _shape_key(pcm)
        return key in self._graphs and self._graphs[key] is None

    def _replay(self, pcm, first_index: int, follows: bool) -> dict:
        """A batch of :meth:`encode_frame_stream` on the card.  Without a
        graph of its shape it runs eagerly where it is the shape's first
        batch or ``follows`` is false (no batch of its shape comes next),
        else it captures the graph (counter ``encode.graph_captures``).
        With the graph it replays it (span ``encode.replay``: the index
        write, the replay and the outputs' copies; counter
        ``encode.graph_replays``)."""
        arr, first_index = self._checked(pcm), int(first_index)
        key = _shape_key(arr)
        graph = self._graphs.get(key)
        if graph is None:
            if key not in self._graphs or not follows:
                self._graphs[key] = None
                return self._run(arr, first_index)
            with on_device(self.device):
                graph = self._graphs[key] = _Graph(
                    self.config, *key, self.device, self._windows)
            trace.count("encode.graph_captures")
        _upload(arr, self.device, into=graph.pcm)
        with trace.span("encode.replay"), on_device(self.device):
            out = graph.replay(first_index)
        trace.count("encode.graph_replays")
        return out

    def _drain(self, result, valid: int, stats: dict | None,
               pcm: np.ndarray | None = None, index0: int = 0,
               ) -> list[bytes]:
        """Fetch one finished batch (the parts of a sharded one in frame
        order) and cut its rows into frame bytes.  Under conformance,
        ``pcm`` is the batch's ``[B, C, N]`` PCM and ``index0`` its first
        frame's index: each overflow frame (one the packer cannot take) is
        the oracle encoder's instead, the same bytes by the oracle's own
        parity, and a batch that holds one adds only its frame bytes to
        ``stats``, as the JAX package's does."""
        lens = _fetch(result, valid, "length")
        width = int(lens.max()) if valid else 0
        data = _fetch(result, valid, "bytes", width)
        over = (_fetch(result, valid, "overflow") if pcm is not None
                else np.zeros(0, bool))
        histograms = stats is not None and not over.any()
        if histograms:
            kinds = _fetch(result, valid, "kind").ravel()
            codes = _fetch(result, valid, "channel_code")
        # every fetch is above: the rest is host time (encode.cut)
        with trace.span("encode.cut"):
            frames = [data[i, :lens[i]].tobytes() for i in range(valid)]
            if over.any():
                from flacx_torch.pipeline import _oracle_frame
                cfg = self.config
                for i in np.nonzero(over)[0]:
                    frames[i] = _oracle_frame(
                        pcm[i].T, index0 + int(i), cfg.bps, cfg.block_size,
                        cfg.max_lpc_order, cfg.qlp_precision,
                        cfg.partition_orders)
            if histograms:
                kh = stats.setdefault("subframe_kinds", {})
                for name, code in (("constant", 0), ("verbatim", 1),
                                   ("fixed", 2), ("lpc", 3)):
                    kh[name] = kh.get(name, 0) + int((kinds == code).sum())
                mh = stats.setdefault("stereo_modes", {})
                for name, code in (("L/R", 1), ("L/S", 8), ("S/R", 9),
                                   ("M/S", 10)):
                    mh[name] = mh.get(name, 0) + int((codes == code).sum())
            if stats is not None:
                stats["frame_bytes"] = stats.get("frame_bytes", 0) \
                    + sum(map(len, frames))
        return frames

    def encode_frame_stream(self, batches, first_index: int = 0,
                            stats: dict | None = None):
        """Encode a stream of block batches, yielding frame byte strings.

        ``batches`` is an iterable of ``[F <= batch_frames, channels, N]``
        full-block groups (short groups are zero-padded to the batch
        shape; pad frames are encoded and discarded).  At most two batches
        are in flight: batch ``i+1`` is dispatched to the device before
        batch ``i`` is fetched and cut into frames.  Under conformance each
        batch's PCM is kept until its drain, for the overflow frames.  On
        the card, unsharded and outside conformance mode, batches replay a
        captured graph of the pipeline (the class's notes); where a batch
        would capture it, the next batch is taken from ``batches`` before
        it is dispatched, to see whether one follows.

        ``stats``, if given, accumulates subframe-kind and stereo-mode
        histograms plus total frame bytes.
        """
        keep_pcm = self.config.conformance
        index = first_index
        pending = []
        queue = self._padded(batches)
        ahead = next(queue, None)
        while ahead is not None:
            (chunk, valid), ahead = ahead, None
            if not self._graphed:
                result = self.encode_batch_device(chunk, index)
            else:
                follows = False
                if self._capture_due(chunk):
                    ahead = next(queue, None)
                    follows = (ahead is not None and _shape_key(ahead[0])
                               == _shape_key(chunk))
                result = self._replay(chunk, index, follows)
            pending.append((result, valid,
                            np.asarray(chunk) if keep_pcm else None, index))
            index += valid
            if len(pending) == 2:
                result, valid, pcm, index0 = pending.pop(0)
                yield from self._drain(result, valid, stats, pcm, index0)
            if ahead is None:
                ahead = next(queue, None)
        for result, valid, pcm, index0 in pending:
            yield from self._drain(result, valid, stats, pcm, index0)

    def _padded(self, batches):
        """Each group of ``batches`` zero-padded to the batch shape, with
        its count of real frames."""
        bsz = self.batch_frames
        for chunk in batches:
            valid = chunk.shape[0]
            if valid > bsz:
                raise ValueError(f"batch group of {valid} frames exceeds "
                                 f"batch_frames={bsz}")
            if valid < bsz:
                chunk = np.concatenate(
                    [chunk, np.zeros((bsz - valid, *chunk.shape[1:]),
                                     chunk.dtype)], axis=0)
            yield chunk, valid

    def encode_frames(self, pcm: np.ndarray, first_index: int,
                      stats: dict | None = None) -> list[bytes]:
        """Encode ``[F, channels, N]`` full blocks into frame byte strings."""
        bsz = self.batch_frames
        batches = (pcm[s: s + bsz] for s in range(0, pcm.shape[0], bsz))
        return list(self.encode_frame_stream(batches, first_index, stats))
