"""The ``reconstruct`` kernel: int32 PCM ``[F, n, C]`` of a batch of
frames from their decoded residuals — warm-up and constants merged, the
predictor, wasted bits, stereo undecorrelation and the interleave in one
launch.

Replaces the decode path's XLA scans ``flacx/ops/reconstruct.py::
reconstruct_predicted``, ``reconstruct_predicted_chunks`` and
``reconstruct_fixed_parallel``, ``undo_decorrelation``, and the glue of
``flacx/decoder.py:399-427``; flacx has no Pallas kernel there.  Source,
bound and design in ``csrc/reconstruct.cu``.  Its routes: an all-fixed
batch (``fixed_max``) as flacx's parallel integration, one block a frame;
else the IIR, one thread per (frame, channel, chunk of ``state_ss``
samples) where the walker gave sample state, or per (frame, channel) over
all samples, residuals staged through shared memory; int32 or int64
working type (``use_i32``), the state int32 or (on the int64 type only)
int64.
"""

from __future__ import annotations

import torch

from flacx_torch.kernels.build import bind, check, launch
from flacx_torch.ops.reconstruct import (reconstruct_fixed_parallel,
                                         reconstruct_predicted,
                                         reconstruct_predicted_chunks,
                                         undo_decorrelation)

#: tap buckets: the batch's largest order rounded up to one of these
TAP_BUCKETS = (4, 8, 12, 16, 32)
#: the all-fixed route's integrations at most (fixed predictor orders)
FIXED_MAX = 4


def tap_bucket(max_order: int) -> int:
    return next(b for b in TAP_BUCKETS if b >= max(4, max_order))


def residual_limit(bps: int, use_i32: bool) -> int:
    """The int32 route's guard: a residual past ``2^limit`` flags the
    batch (flacx/decoder.py:406-410); -1 (none) on the int64 route."""
    return min(bps + 3, 29) if use_i32 else -1


def reconstruct_plain(vals: torch.Tensor, taps: torch.Tensor,
                      shift: torch.Tensor, order: torch.Tensor,
                      kind: torch.Tensor, wasted: torch.Tensor,
                      warmup: torch.Tensor, const_val: torch.Tensor,
                      channel_code: torch.Tensor,
                      state: torch.Tensor | None, state_ss: int, t: int,
                      use_i32: bool, lim: int, fixed_max: int | None = None,
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`reconstruct`: flacx's routes — the nested
    cumsums where ``fixed_max`` is given, the chunk IIR from the walker's
    state, else the sample-serial IIR."""
    f, c, n = vals.shape
    dtype = torch.int32 if use_i32 else torch.int64
    i = torch.arange(n, device=vals.device)
    warm = torch.nn.functional.pad(warmup[..., :min(32, n)],
                                   (0, max(0, n - 32)))
    res = torch.where(i < order[..., None], warm, vals)
    res = torch.where((kind == 0)[..., None], const_val[..., None], res)
    err = torch.zeros(1, dtype=torch.int32, device=vals.device)
    if lim >= 0:
        err |= (vals.abs() > (1 << lim)).any().to(torch.int32)
    if fixed_max is not None:
        x = reconstruct_fixed_parallel(res, order, fixed_max, dtype=dtype)
    elif state is not None:
        x = reconstruct_predicted_chunks(res, taps[..., :t], shift, order,
                                         state, state_ss, dtype=dtype)
    else:
        x = reconstruct_predicted(res, taps[..., :t], shift, order,
                                  dtype=dtype)
    x = x << wasted[..., None].to(dtype)
    if c == 2:
        left, right = undo_decorrelation(x[:, 0], x[:, 1], channel_code)
        x = torch.stack([left, right], dim=1)
    return x.transpose(1, 2).to(torch.int32).contiguous(), err


def reconstruct(vals: torch.Tensor, taps: torch.Tensor, shift: torch.Tensor,
                order: torch.Tensor, kind: torch.Tensor, wasted: torch.Tensor,
                warmup: torch.Tensor, const_val: torch.Tensor,
                channel_code: torch.Tensor, state: torch.Tensor | None,
                state_ss: int, t: int, use_i32: bool, lim: int,
                fixed_max: int | None = None,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(pcm int32 [F, n, C], err int32 [1])``.

    Args:
      vals: int64 ``[F, C, n]`` residuals (zero at warm-up positions).
      taps: int32 ``[F, C, 32]`` (zero past the order; fixed subframes the
        binomial taps); shift, order, kind, wasted: int32 ``[F, C]``.
      warmup: int64 ``[F, C, 32]``; const_val: int64 ``[F, C]``.
      channel_code: int32 ``[F]``.
      state: int32 or int64 ``[F, C, Ks, 32]`` walker sample state every
        ``state_ss`` samples, or None; int64 state only with the int64
        working type (``use_i32`` False), else ValueError.
      t: the tap bucket (:func:`tap_bucket`), taps zero past it.
      use_i32: the int32 working type (exact under flacx's bound).
      lim: :func:`residual_limit`; ``err`` is set where a residual passes
        ``2^lim``.
      fixed_max: the batch's largest order (0..4) where every subframe
        is constant, verbatim or fixed: flacx's parallel integration (the
        plain version's cumsums), which takes no state.
    """
    if fixed_max is not None and state is not None:
        raise ValueError("reconstruct: the all-fixed route takes no state")
    state64 = state is not None and state.dtype == torch.int64
    if state64 and use_i32:
        raise ValueError("reconstruct: int64 state on the int32 route")
    if vals.device.type == "cpu":
        return reconstruct_plain(vals, taps, shift, order, kind, wasted,
                                 warmup, const_val, channel_code, state,
                                 state_ss, t, use_i32, lim, fixed_max)
    f, c, n = vals.shape
    dev = vals.device
    check(vals, "vals", torch.int64, device=dev)
    check(taps, "taps", torch.int32, (f, c, 32), dev)
    for name, x in (("shift", shift), ("order", order), ("kind", kind),
                    ("wasted", wasted)):
        check(x, name, torch.int32, (f, c), dev)
    check(warmup, "warmup", torch.int64, (f, c, 32), dev)
    check(const_val, "const_val", torch.int64, (f, c), dev)
    check(channel_code, "channel_code", torch.int32, (f,), dev)
    ks = 1
    if state is not None:
        ks = state.shape[2]
        check(state, "state", torch.int64 if state64 else torch.int32,
              (f, c, ks, 32), dev)
        if ks != -(-n // state_ss):
            raise ValueError(f"reconstruct: {ks} state windows for block "
                             f"{n} at interval {state_ss}")
    if t not in TAP_BUCKETS or not 1 <= c <= 8:
        raise ValueError(f"reconstruct: tap bucket {t}, {c} channels")
    if fixed_max is not None and not 0 <= fixed_max <= FIXED_MAX:
        raise ValueError(f"reconstruct: fixed_max {fixed_max}")
    pcm = torch.empty((f, n, c), dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    launch(bind("reconstruct", "flacx_reconstruct", 12, 10),
           [vals, taps, shift, order, kind, wasted, warmup, const_val, state,
            channel_code, pcm, err],
           [f, c, n, t, int(not use_i32), lim, state_ss, ks,
            -1 if fixed_max is None else fixed_max, int(state64)],
           "reconstruct")
    return pcm, err
