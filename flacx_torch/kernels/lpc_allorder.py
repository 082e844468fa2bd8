"""The ``lpc_allorder`` kernel: Σ zigzag and max |res| of the integer LPC
residual at every order 1..P of every row, the residuals never written.

Replaces the TPU kernel ``flacx/kernels/lpcres_tile.py::
lpc_allorder_stats``, and past its int32 gate the JAX package's int64 XLA
route of the same statistics.  The MACs of all orders run as one small
integer product on the tensor cores (``mma.sync`` over 8-bit limbs of the
samples and the taps, each limb product exact in int32); the limbs are
combined in uint32 under the static bound of
:func:`flacx_torch.kernels.lpc_residual.mac_width` and in int64
("wide") past it, exact on every lane.  The sample limbs (3 up to
``eff_bps`` 24, else 4) and the 32-bit chunk sums (:func:`narrow_sums`)
come from the static inputs; the kernel skips a row's high tap limb where
its taps fit one.  Bound: the epilogue of every
(sample, order) on the CUDA cores, or the bytes of the row.  Source,
exactness argument and design in ``csrc/lpc_allorder.cu``.
"""

from __future__ import annotations

import math

import torch

from flacx_torch.kernels.build import bind, check, launch
from flacx_torch.kernels.lpc_residual import mac_width
from flacx_torch.ops.lpc import lpc_residuals_all
from flacx_torch.ops.rice import zigzag

MAX_ORDER = 32


def sample_limbs(eff_bps: int) -> int:
    """8-bit limbs of a sample of ``eff_bps`` bits: 3 up to 24, else 4."""
    return 3 if eff_bps <= 24 else 4


def narrow_sums(eff_bps: int, sum_taps_max: int) -> bool:
    """Whether every zigzag residual is under 2^26 (|res| < 2^(eff_bps +
    bitlen(sum_taps_max))), so the kernel sums a chunk in 32 bits."""
    return eff_bps + max(1, sum_taps_max).bit_length() <= 25


def lpc_allorder_plain(x: torch.Tensor, qcoefs: torch.Tensor,
                       shifts: torch.Tensor, eff_bps: int, sum_taps_max: int,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`lpc_allorder`: the residual of every order
    (int32 MAC, or int64 past its bound), masked and reduced."""
    wide = mac_width(eff_bps, sum_taps_max) == "wide"
    p, n = qcoefs.shape[-2], x.shape[-1]
    res = lpc_residuals_all(x, qcoefs, shifts,
                            torch.int64 if wide else torch.int32)
    dev = x.device
    warm = (torch.arange(n, device=dev)
            < torch.arange(1, p + 1, device=dev)[:, None])
    res = res.masked_fill(warm, 0)                       # [..., P, n]
    maxabs = res.abs().amax(-1)
    if wide:
        maxabs = maxabs.clamp(max=(1 << 31) - 1).to(torch.int32)
    return zigzag(res).sum(-1, dtype=torch.int64), maxabs


def lpc_allorder(x: torch.Tensor, qcoefs: torch.Tensor, shifts: torch.Tensor,
                 eff_bps: int, sum_taps_max: int,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(lzz int64 [..., P], maxabs int32 [..., P])``: for each order
    ``o``, ``Σ zigzag(res_o)`` and ``min(max |res_o|, 2^31 - 1)`` where
    ``res_o[i] = x[i] - (Σ_{j<o} qcoefs[o-1, j]·x[i-1-j] >> shifts[o-1])``
    and ``res_o[i < o] = 0``.

    Args:
      x: int32 ``[..., n]``, within ``eff_bps`` bits.
      qcoefs: int32 ``[..., P, T]`` (row ``o-1`` is the order-``o``
        predictor, zero past its order; P, T ≤ 32; precision ≤ 15).
      shifts: int32 ``[..., P]``.
      eff_bps, sum_taps_max: the static width bound that picks the MAC
        (:func:`flacx_torch.kernels.lpc_residual.mac_width`) and the
        sample limbs (:func:`sample_limbs`).
    """
    if x.device.type == "cpu":
        return lpc_allorder_plain(x, qcoefs, shifts, eff_bps, sum_taps_max)
    lead = x.shape[:-1]
    p, t = qcoefs.shape[-2:]
    check(x, "x", torch.int32)
    check(qcoefs, "qcoefs", torch.int32, (*lead, p, t), x.device)
    check(shifts, "shifts", torch.int32, (*lead, p), x.device)
    if not (1 <= p <= MAX_ORDER and 1 <= t <= MAX_ORDER) or x.shape[-1] < 1:
        raise ValueError(f"lpc_allorder: {p} orders x {t} taps out of range")
    lzz = torch.empty((*lead, p), dtype=torch.int64, device=x.device)
    maxabs = torch.empty((*lead, p), dtype=torch.int32, device=x.device)
    launch(bind("lpc_allorder", "flacx_lpc_allorder", 5, 7),
           [x, qcoefs, shifts, lzz, maxabs],
           [math.prod(lead), x.shape[-1], p, t,
            int(mac_width(eff_bps, sum_taps_max) == "wide"),
            sample_limbs(eff_bps), int(narrow_sums(eff_bps, sum_taps_max))],
           "lpc_allorder")
    return lzz, maxabs
