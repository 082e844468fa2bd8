"""The ``crc16_rows`` kernel: every frame row's CRC-16 against the two
bytes stored at its end.

Replaces ``flacx/ops/crcfold.py::crc16_over_rows`` and the check of
``flacx/decoder.py:428-437`` around it (XLA in flacx, no Pallas kernel);
source, bound and design in ``csrc/crc16_rows.cu``: lanes fold contiguous
runs of a row's big-endian words with sliced tables, each run's CRC is
shifted to the body's end by ``x^(32 d)`` and the terms are XORed.
"""

from __future__ import annotations

import functools

import torch

from flacx_torch.format import CRC16_POLYNOMIAL
from flacx_torch.kernels.build import bind, check, launch
from flacx_torch.kernels.frame_pack import crc16_consts
from flacx_torch.ops.crcfold import _gf_mul, crc16_over_rows, \
    inverse_power_table

#: entries of each power table: ``x^(32 d)`` for ``d < LEVEL``, then
#: ``x^(32 LEVEL j)`` for ``j < LEVEL``, then ``x^(32 LEVEL^2 k)`` for ``k
#: < TOP`` (every distance under 2^29 words)
LEVEL, TOP = 1024, 512
#: threads a block (``THREADS`` in the source)
THREADS = 256


def _powers(base: int, count: int) -> list[int]:
    """``base^i mod P`` for ``i < count``."""
    out, v = [], 1
    for _ in range(count):
        out.append(v)
        v = _gf_mul(v, base, 16, CRC16_POLYNOMIAL)
    return out


def word_powers() -> tuple[list[int], list[int], list[int]]:
    """The three tables: ``x^(32 d)`` (``d < LEVEL``), ``x^(32 LEVEL j)``
    (``j < LEVEL``) and ``x^(32 LEVEL^2 k)`` (``k < TOP``), mod P; a
    distance of ``d`` words is ``lo[d % LEVEL] * mid[(d // LEVEL) % LEVEL]
    * hi[d // LEVEL^2]``."""
    x32 = _powers(2, 33)[32]
    lo = _powers(x32, LEVEL + 1)
    mid = _powers(lo[LEVEL], LEVEL + 1)
    hi = _powers(mid[LEVEL], TOP)
    return lo[:LEVEL], mid[:LEVEL], hi


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> torch.Tensor:
    """The kernel's constants (P the polynomial): the table rows ``i *
    x^(16 + 8k) mod P`` (``k < 4``), the three tables of
    :func:`word_powers`, then ``x^(-8 p) mod P`` for ``p < 4``."""
    lo, mid, hi = word_powers()
    inv = inverse_power_table(16, CRC16_POLYNOMIAL, 4).tolist()
    table = crc16_consts(torch.device("cpu"))[:1024].tolist()
    return torch.tensor(table + lo + mid + hi + inv, dtype=torch.int32,
                        device=device)


def crc16_rows_plain(rows: torch.Tensor, lens: torch.Tensor,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`crc16_rows` (a row shorter than its two CRC
    bytes, or longer than the row width, is not ok)."""
    w = rows.shape[1]
    lens = lens.long()
    fits = (lens >= 2) & (lens <= w)
    lens = torch.where(fits, lens, 2)
    pos = torch.arange(w, device=rows.device)
    body = torch.where(pos[None, :] >= (lens - 2)[:, None], 0, rows)
    crc = crc16_over_rows(body, lens - 2)
    idx = torch.stack([lens - 2, lens - 1], dim=1).clamp(0, w - 1)
    stored = torch.gather(rows, 1, idx).long()
    ok = fits & (crc == ((stored[:, 0] << 8) | stored[:, 1]))
    return ok.to(torch.int32), ok.all().to(torch.int32).reshape(1)


def crc16_rows(rows: torch.Tensor, lens: torch.Tensor,
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ok int32 [F], all_ok int32 [1])``: whether the CRC-16 of
    ``rows[f, :lens[f] - 2]`` is the big-endian pair at ``lens[f] - 2``,
    per row and for the batch.

    Args:
      rows: u8 ``[F, W]``, W a multiple of 4.
      lens: int32 ``[F]`` frame lengths, CRC bytes included.
    """
    if rows.device.type == "cpu":
        return crc16_rows_plain(rows, lens)
    f, w = rows.shape
    dev = rows.device
    check(rows, "rows", torch.uint8, device=dev)
    check(lens, "lens", torch.int32, (f,), dev)
    if w % 4:
        raise ValueError(f"crc16_rows: row width {w} is not a multiple of 4")
    ok = torch.empty(f, dtype=torch.int32, device=dev)
    all_ok = torch.ones(1, dtype=torch.int32, device=dev)
    launch(bind("crc16_rows", "flacx_crc16_rows", 5, 2),
           [rows, lens, _consts(dev), ok, all_ok], [f, w], "crc16_rows")
    return ok, all_ok


def empty(device: torch.device, f: int, w: int) -> None:
    """Launch an empty kernel on ``device`` on the grid :func:`crc16_rows`
    launches for ``f`` rows of ``w`` bytes, clusters included
    (``flacx_empty_kernel``): the launch floor that its time is read
    against.  For measurement only."""
    fn = bind("crc16_rows", "flacx_empty", 0, 2)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(f, w, stream)
    if rc:
        raise RuntimeError(f"flacx_torch: empty launch failed with CUDA "
                           f"error {rc}")
