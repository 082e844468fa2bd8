"""The ``rice_stats`` kernel: the exact Rice-parameter search statistics
of every partition of every requested partition order.

Replaces the TPU kernel ``flacx/kernels/rice_tile.py::rice_stats_tiles``
(its whole-row and chunked forms); source, bound and design in
``csrc/rice_stats.cu``.  Any block size whose finest partition divides it
is taken (the TPU kernel's tile-ratio gap is not copied).  Two routes: a
shared-memory table of the finest level's sums where it fits, and a
levels route that searches every partition straight from ``zz`` past it.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from flacx_torch.kernels.build import bind, check, launch
from flacx_torch.ops.rice import rice_stats as rice_stats_plain

#: Shared memory the smem route may use for its finest-level sums (bytes).
SMEM_LIMIT = 48 * 1024
KMAX_LIMIT = 30


def smem_bytes(max_po: int, kmax: int) -> int:
    """Shared memory of the finest-level sums at ``2^max_po`` partitions."""
    return (kmax + 2) * (1 << max_po) * 4


def route(max_po: int, kmax: int) -> str:
    """``"smem"`` where the finest level's table fits :data:`SMEM_LIMIT`,
    else ``"levels"``."""
    return "smem" if smem_bytes(max_po, kmax) <= SMEM_LIMIT else "levels"


def rice_stats(zz: torch.Tensor, order: torch.Tensor,
               porders: Sequence[int], kmax: int) -> dict:
    """Per-level ``{po: (min4, arg4, min5, arg5, max)}`` of int32 ``zz``
    ``[..., n]`` with ``order [...]``, each ``[..., 2^po]`` int32, bit
    for bit as :func:`flacx_torch.ops.rice.rice_stats`."""
    if zz.device.type == "cpu":
        return rice_stats_plain(zz, order, porders, kmax)
    n = zz.shape[-1]
    lead = zz.shape[:-1]
    check(zz, "zz", torch.int32)
    check(order, "order", torch.int32, lead, zz.device)
    levels = sorted(set(porders))
    max_po = levels[-1]
    if levels[0] < 0 or max_po > 15 or n % (1 << max_po):
        raise ValueError(f"rice_stats: partition orders {levels} do not "
                         f"divide block size {n}")
    if not 0 <= kmax <= KMAX_LIMIT:
        raise ValueError(f"rice_stats: kmax {kmax} out of range")
    tot = sum(1 << po for po in levels)
    out = torch.empty((math.prod(lead), 5, tot), dtype=torch.int32,
                      device=zz.device)
    po_mask = sum(1 << po for po in levels)
    symbol = {"smem": "flacx_rice_stats",
              "levels": "flacx_rice_stats_levels"}[route(max_po, kmax)]
    launch(bind("rice_stats", symbol, 3, 6), [zz, order, out],
           [math.prod(lead), n, max_po, po_mask, kmax, tot], "rice_stats")
    rice_stats.launches += 1
    result = {}
    off = 0
    for po in levels:
        w = 1 << po
        result[po] = tuple(out[:, a, off:off + w].reshape(*lead, w)
                           for a in range(5))
        off += w
    return result


rice_stats.launches = 0
