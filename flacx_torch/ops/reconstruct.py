"""Batched predictor reconstruction (decode side, plain PyTorch).

The IIR ``x[i] = r[i] + (Σ_j c_j·x[i-1-j] >> shift)`` is sequential in i
but independent across subframes: each step advances every ``[frame,
channel]`` lane at once, carrying the last-T-samples window.  These are
the plain versions of the ``reconstruct`` kernel's routes
(``flacx_torch/kernels/csrc/reconstruct.cu``): a Python loop over the
samples (or over one chunk's samples) at the test sizes the CPU runs.
"""

from __future__ import annotations

import torch

from flacx_torch.format import Channels


def _iir(res_t: torch.Tensor, win: torch.Tensor, taps_wt: torch.Tensor,
         shift: torch.Tensor, order: torch.Tensor, base,
         dtype) -> torch.Tensor:
    """Run the IIR over the leading (sample) axis of ``res_t [S, lanes]``
    from the transposed window ``win [T, lanes]`` (``win[-1]`` the sample
    before the first); ``base + i >= order`` guards the prediction."""
    xs = torch.empty_like(res_t)
    for i in range(res_t.shape[0]):
        acc = (win * taps_wt).sum(0, dtype=dtype)
        pred = acc >> shift
        x = res_t[i] + torch.where(base + i >= order, pred,
                                   torch.zeros((), dtype=dtype))
        win = torch.cat([win[1:], x[None]])
        xs[i] = x
    return xs


def reconstruct_predicted(residual: torch.Tensor, taps: torch.Tensor,
                          shift: torch.Tensor, order: torch.Tensor,
                          dtype=torch.int64) -> torch.Tensor:
    """Rebuild samples from residuals for fixed/LPC subframes.

    Args:
      residual: ``[..., n]`` int — warmup samples occupy positions
        ``i < order`` (verbatim-style), residuals the rest.
      taps: ``[..., T]`` int32 predictor taps (zero beyond order).
      shift: ``[...]`` int32.
      order: ``[...]`` int32.
      dtype: working type.  int64 is always exact; the caller may pick
        int32 where ``eff_bps + bitlen(Σ|taps|) + 2 <= 31`` holds for the
        whole batch.
    Returns:
      ``[..., n]`` reconstructed samples in ``dtype``.
    """
    t = taps.shape[-1]
    lead = residual.shape[:-1]
    taps_wt = torch.movedim(taps.flip(-1).to(dtype), -1, 0)
    res_t = torch.movedim(residual.to(dtype), -1, 0)
    win0 = torch.zeros((t, *lead), dtype=dtype, device=residual.device)
    xs = _iir(res_t, win0, taps_wt, shift.to(dtype), order, 0, dtype)
    return torch.movedim(xs, 0, -1)


def reconstruct_predicted_chunks(residual: torch.Tensor, taps: torch.Tensor,
                                 shift: torch.Tensor, order: torch.Tensor,
                                 state: torch.Tensor, state_interval: int,
                                 dtype=torch.int64) -> torch.Tensor:
    """Chunk-parallel IIR reconstruction from walker sample-state
    checkpoints.

    The C++ walker (``flacx_torch.native.scan_frames`` with
    ``state_interval > 0``) runs the integer IIR inline during its serial
    residual walk and emits the last-32-samples window before every
    ``state_interval`` boundary.  Given those windows every chunk of
    ``state_interval`` samples reconstructs independently: ``SS`` serial
    steps over ``F·C·Ks`` lanes instead of ``n`` over ``F·C``.

    Args:
      residual: ``[F, C, n]`` int (contract of
        :func:`reconstruct_predicted`).
      taps: ``[F, C, T]`` int32; shift, order: ``[F, C]`` int32.
      state: ``[F, C, Ks, 32]`` int32, or int64 (the walker's state past
        31 bits; int64 ``dtype`` only) — ``state[..., m, i]`` is sample
        ``x[m·SS - 32 + i]`` (zero for negative indices).
      state_interval: SS; need not divide ``n``.
    Returns:
      ``[F, C, n]`` reconstructed samples in ``dtype``.
    """
    if state.dtype == torch.int64 and dtype != torch.int64:
        raise ValueError("int64 sample state needs the int64 working type")
    f, c, n = residual.shape
    t = taps.shape[-1]
    ss = state_interval
    ks = state.shape[-2]
    n_pad = ks * ss
    lanes = f * c * ks
    taps_wt = taps.flip(-1).to(dtype)[..., None, :].expand(f, c, ks, t) \
        .reshape(lanes, t).T
    shift_w = shift.to(dtype)[..., None].expand(f, c, ks).reshape(lanes)
    order_w = order[..., None].expand(f, c, ks).reshape(lanes)
    base = (torch.arange(ks, device=residual.device) * ss).repeat(f * c)
    res = torch.nn.functional.pad(residual.to(dtype), (0, n_pad - n))
    res_t = res.reshape(lanes, ss).T
    win0 = state[..., 32 - t:].to(dtype).reshape(lanes, t).T
    xs = _iir(res_t, win0, taps_wt, shift_w, order_w, base, dtype)
    return xs.T.reshape(f, c, n_pad)[..., :n]


def reconstruct_fixed_parallel(residual: torch.Tensor, order: torch.Tensor,
                               max_order: int,
                               dtype=torch.int32) -> torch.Tensor:
    """Fully parallel reconstruction for constant/verbatim/FIXED subframes.

    A fixed order-k predictor is the k-th finite difference (binomial taps,
    shift 0), so its inverse is k nested integrations — ``cumsum``s, not a
    sample-serial scan.  Two phases over ``a`` (the residual with warmup
    samples in positions ``i < order``):

      1. difference triangle on the warmup prefix: after pass j, position
         ``i ∈ [j, order)`` holds Δʲ x[i]; on completion position i holds
         Δⁱ x[i] — the integration constant for level i.
      2. suffix integrations j = max_order-1 … 0: positions ``i ≥ j`` are
         replaced by their running sum (prefix masked out of the sum),
         applied only to lanes with ``order > j``.

    Args:
      residual: ``[..., n]`` int — warmup in positions ``i < order``.
      order: ``[...]`` int32, 0..4 (0 for constant/verbatim lanes).
      max_order: upper bound on ``order`` (pass count).
    Returns:
      ``[..., n]`` reconstructed samples in ``dtype``.
    """
    n = residual.shape[-1]
    a = residual.to(dtype)
    i = torch.arange(n, device=residual.device)
    ord_ = order[..., None]
    for j in range(1, max_order):          # difference triangle (phase 1)
        d = a - torch.roll(a, 1, dims=-1)
        a = torch.where((i >= j) & (i < ord_), d, a)
    for j in range(max_order - 1, -1, -1):  # suffix integrations (phase 2)
        cs = torch.cumsum(torch.where(i >= j, a, 0), dim=-1, dtype=dtype)
        a = torch.where((i >= j) & (ord_ > j), cs, a)
    return a


def undo_decorrelation(ch0: torch.Tensor, ch1: torch.Tensor,
                       mode: torch.Tensor) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Invert stereo decorrelation per frame.

    Args:
      ch0/ch1: ``[B, n]`` decoded subframe samples.
      mode: ``[B]`` int32 channel codes (Channels values).
    Returns:
      ``(left, right)``.
    """
    m = mode[..., None]
    l_s = m == int(Channels.L_S)
    s_r = m == int(Channels.S_R)
    m_s = m == int(Channels.M_S)
    left = torch.where(l_s, ch0, torch.where(s_r, ch0 + ch1, ch0))
    right = torch.where(l_s, ch0 - ch1, ch1)
    ms_right = ch0 - (ch1 >> 1)
    left = torch.where(m_s, ms_right + ch1, left)
    right = torch.where(m_s, ms_right, right)
    return left, right
