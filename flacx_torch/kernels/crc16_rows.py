"""The ``crc16_rows`` kernel: every frame row's CRC-16 against the two
bytes stored at its end (one block a row).

Replaces ``flacx/ops/crcfold.py::crc16_over_rows`` and the check of
``flacx/decoder.py:428-437`` around it (XLA in flacx, no Pallas kernel);
source, bound and design in ``csrc/crc16_rows.cu``.
"""

from __future__ import annotations

import functools

import torch

from flacx_torch.format import CRC16_POLYNOMIAL
from flacx_torch.kernels.build import bind, check, launch
from flacx_torch.kernels.frame_pack import crc16_consts
from flacx_torch.ops.crcfold import (crc16_over_rows, inverse_power_table,
                                     power_table)

#: threads a block (``THREADS`` in the source): rows are read as 32-bit
#: words, thread t taking words t, t + THREADS, ...
THREADS = 256


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> torch.Tensor:
    """The kernel's constants (P the polynomial): the table rows ``i *
    x^(16 + 8k) mod P`` (``k < 4``), then ``x^(32 d) mod P`` for ``d <=
    THREADS``, then ``x^(-8 p) mod P`` for ``p < 4``."""
    # power_table's entry 4d - 2 is x^(8 (4d - 2) + 16) = x^(32 d)
    xw = [1] + power_table(16, CRC16_POLYNOMIAL, 4 * THREADS)[2::4].tolist()
    inv = inverse_power_table(16, CRC16_POLYNOMIAL, 4).tolist()
    table = crc16_consts(torch.device("cpu"))[:1024].tolist()
    return torch.tensor(table + xw + inv, dtype=torch.int32, device=device)


def crc16_rows_plain(rows: torch.Tensor, lens: torch.Tensor,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`crc16_rows`."""
    lens = lens.long()
    pos = torch.arange(rows.shape[1], device=rows.device)
    body = torch.where(pos[None, :] >= (lens - 2)[:, None], 0, rows)
    crc = crc16_over_rows(body, lens - 2)
    idx = torch.stack([lens - 2, lens - 1], dim=1)
    stored = torch.gather(rows, 1, idx).long()
    ok = crc == ((stored[:, 0] << 8) | stored[:, 1])
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
    crc16_rows.launches += 1
    return ok, all_ok


crc16_rows.launches = 0
