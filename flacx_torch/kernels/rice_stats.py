"""The ``rice_stats`` kernel: the exact Rice-parameter search statistics
of every partition of every requested partition order.

Replaces the TPU kernel ``flacx/kernels/rice_tile.py::rice_stats_tiles``
(its whole-row and chunked forms).  One bottom-up partition tree serves
every path: a block reads its segment of a row's ``zz`` once, sums the
finest stored level, adds up every coarser level from the one below and
searches them all from those sums; levels coarser than a segment are
finished by the row's last block.  Bound: bytes (``zz`` read once, the
statistics written once).  Source and design in ``csrc/rice_stats.cu``.
Any block size whose finest partition divides it is taken (the TPU
kernel's tile-ratio gap is not copied).  int64 ``zz`` (past 24-bit
samples) is read saturated at 2^31 into the same 32-bit tree: every
partition a Rice parameter or an escape can code holds values below 2^31,
and one that holds a larger value shows max 2^31, which neither can code.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from flacx_torch.kernels.build import bind, check, launch
from flacx_torch.ops.rice import rice_stats as rice_stats_plain

#: Shared memory a block's segment table (and staged zz) may use (bytes).
SMEM_BUDGET = 48 * 1024
#: Finest stored partitions under this many samples are summed from zz
#: staged in shared memory, larger ones a warp each from device memory.
STAGE_BELOW = 32
KMAX_LIMIT = 30


def table_stride(kmax: int) -> int:
    """Words of a table entry: ``kmax + 1`` sums and the max, odd."""
    return (kmax + 2) | 1


def segment_log2(n: int, max_po: int, kmax: int) -> int:
    """log2 of the segments a row of ``n`` is cut into: the fewest whose
    partition tree (from the finest stored level up) and staged ``zz``
    fit :data:`SMEM_BUDGET` (``csrc/rice_stats.cu``'s ``Plan``)."""
    lo = max_po - 1 if n >> max_po == 1 and max_po > 0 else max_po
    staged = n >> lo < STAGE_BELOW
    for s in range(lo + 1):
        table = ((2 << (lo - s)) - 1) * table_stride(kmax)
        zs = -(-(n >> s) // 4) * 4 if staged else 0
        if (table + zs) * 4 <= SMEM_BUDGET:
            return s
    raise AssertionError("a one-partition segment always fits")


def rice_stats(zz: torch.Tensor, order: torch.Tensor,
               porders: Sequence[int], kmax: int) -> dict:
    """Per-level ``{po: (min4, arg4, min5, arg5, max)}`` of int32 or int64
    ``zz`` ``[..., n]`` (≥ 0) with ``order [...]``, each ``[..., 2^po]``
    int32, bit for bit as :func:`flacx_torch.ops.rice.rice_stats`."""
    if zz.device.type == "cpu":
        return rice_stats_plain(zz, order, porders, kmax)
    n = zz.shape[-1]
    lead = zz.shape[:-1]
    if zz.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"zz: dtype {zz.dtype}, expected int32 or int64")
    check(zz, "zz", zz.dtype)
    check(order, "order", torch.int32, lead, zz.device)
    levels = sorted(set(porders))
    max_po = levels[-1]
    if levels[0] < 0 or max_po > 15 or n % (1 << max_po):
        raise ValueError(f"rice_stats: partition orders {levels} do not "
                         f"divide block size {n}")
    if not 0 <= kmax <= KMAX_LIMIT:
        raise ValueError(f"rice_stats: kmax {kmax} out of range")
    rows = math.prod(lead)
    po_mask = sum(1 << po for po in levels)  # also the entries of a row
    out = torch.empty((rows, 5, po_mask), dtype=torch.int32, device=zz.device)
    s = segment_log2(n, max_po, kmax)
    scratch = tickets = None
    if s:
        scratch = torch.empty((rows, (2 << s) - 1, table_stride(kmax)),
                              dtype=torch.int32, device=zz.device)
        tickets = torch.zeros(rows, dtype=torch.int32, device=zz.device)
    launch(bind("rice_stats", "flacx_rice_stats", 5, 7),
           [zz, order, out, scratch, tickets],
           [rows, n, max_po, po_mask, kmax, s,
            int(zz.dtype == torch.int64)], "rice_stats")
    result = {}
    off = 0
    for po in levels:
        w = 1 << po
        result[po] = tuple(out[:, a, off:off + w].reshape(*lead, w)
                           for a in range(5))
        off += w
    return result
