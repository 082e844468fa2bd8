"""The ``frame_pack`` kernel: finished frame bytes (sample symbols
emitted, the frame's symbol stream packed MSB-first, CRC-16 appended)
from the encoder's chosen subframes.

Replaces the TPU chain ``flacx/kernels/emit_tile.py::emit_sample_tiles``
→ ``bitpack_tile.py::merge_tiles_t`` → ``bitpack_tile.py::merge_strings_t``
→ ``crc_tile.py::crc16_packed_t`` of the blocked slot layout, the
segmented emit ``emit_tile.py::emit_sample_tiles_seg`` and the leveled
merge ``bitpack_tile.py::merge_strings_t_leveled`` of the hi-res path, and
the classic path's ``bitpack_tile.py::merge_tiles`` → ``merge_strings``
below 40-sample partitions; source, bound and design in
``csrc/frame_pack.cu``.  The kernel walks the general layout's slots,
which give the blocked layout's stream wherever that applies, in chunks
of :data:`CHUNK_SLOTS` slots a block, whatever the frame's size.  Its
plain version is the classic symbol chain: ``emit`` symbols → merge-tree
packer → CRC-16 fold.
"""

from __future__ import annotations

import functools

import torch

from flacx_torch.format import CRC16_POLYNOMIAL
from flacx_torch.kernels.build import bind, check, launch
from flacx_torch.ops.bitpack import pack_symbols_words, words_to_bytes
from flacx_torch.ops.crcfold import crc16_over_word_rows
from flacx_torch.ops.emit import (general_layout_tables, interleave_slots,
                                  sample_symbols_from)


#: Symbol slots a block of the kernel packs (``CHUNK`` in the source).
CHUNK_SLOTS = 1024
#: Chunks whose words a block places (``GROUP`` in the source).
PLACE_CHUNKS = 4


@functools.lru_cache(maxsize=None)
def _layout_tables(n: int, psize_min: int, device: torch.device,
                   ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The general layout's ``extra`` and ``mult`` tables on ``device``,
    and the first segment from which ``mult[s] = s + len(extra)``."""
    extra, mult = general_layout_tables(n, psize_min)
    head = len(mult)
    while head and mult[head - 1] == head - 1 + len(extra):
        head -= 1
    return (torch.tensor(extra, dtype=torch.int32, device=device),
            torch.tensor(mult, dtype=torch.int32, device=device), head)


@functools.lru_cache(maxsize=None)
def crc16_consts(device: torch.device) -> torch.Tensor:
    """The kernel's CRC-16 constants (P the polynomial): the table rows
    ``i * x^(16 + 8k) mod P`` for ``k < 4``, ``i < 256`` (one and four
    bytes a step), then ``x^(8k) mod P`` for ``k`` up to the bytes a block
    places, ``4 * PLACE_CHUNKS * CHUNK_SLOTS + 4`` (each run's CRC shifted
    by the bytes after it)."""
    def times_x8(r: int) -> int:
        for _ in range(8):
            r = (r << 1) ^ (CRC16_POLYNOMIAL if r & 0x8000 else 0)
        return r

    rows = [[times_x8(times_x8(i)) for i in range(256)]]
    for _ in range(3):
        rows.append([times_x8(v) for v in rows[-1]])
    shifts = [1]
    for _ in range(4 * PLACE_CHUNKS * CHUNK_SLOTS + 4):
        shifts.append(times_x8(shifts[-1]))
    return torch.tensor([v for row in rows for v in row] + shifts,
                        dtype=torch.int32, device=device)


def frame_pack_plain(hdr_v: torch.Tensor, hdr_l: torch.Tensor,
                     sh_v: torch.Tensor, sh_l: torch.Tensor,
                     pv: torch.Tensor, pl: torch.Tensor, zz: torch.Tensor,
                     x: torch.Tensor, kesc: torch.Tensor, kind: torch.Tensor,
                     order: torch.Tensor, bps: torch.Tensor, psize_min: int,
                     max_frame_bytes: int,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`frame_pack`."""
    b, c, n = x.shape
    k_sample = (kesc & 31).repeat_interleave(psize_min, dim=-1)
    esc_sample = ((kesc >> 7) & 1).bool().repeat_interleave(psize_min,
                                                           dim=-1)
    sv, sl = sample_symbols_from(kind, order, bps, x, zz, k_sample,
                                 esc_sample)
    values = torch.cat([sh_v, *interleave_slots(pv, sv, psize_min)],
                       dim=-1).reshape(b, -1)
    lengths = torch.cat([sh_l, *interleave_slots(pl, sl, psize_min)],
                        dim=-1).reshape(b, -1)
    body_bits = hdr_l.sum(-1) + lengths.sum(-1)
    pad = (-body_bits) % 8
    values = torch.cat([hdr_v, values, torch.zeros_like(values[:, :1])],
                       dim=-1)
    lengths = torch.cat([hdr_l, lengths, pad[:, None].to(torch.int32)],
                        dim=-1)
    words, total_bits = pack_symbols_words(values, lengths, max_frame_bytes)
    nbytes = total_bits.long() // 8
    crc = crc16_over_word_rows(words, nbytes)
    frame_bytes = words_to_bytes(words)
    pos = torch.arange(max_frame_bytes, device=x.device)
    frame_bytes = torch.where(pos == nbytes[:, None],
                              (crc[:, None] >> 8).to(torch.uint8),
                              frame_bytes)
    frame_bytes = torch.where(pos == (nbytes + 1)[:, None],
                              (crc[:, None] & 0xFF).to(torch.uint8),
                              frame_bytes)
    return frame_bytes, (nbytes + 2).to(torch.int32)


def frame_pack(hdr_v: torch.Tensor, hdr_l: torch.Tensor, sh_v: torch.Tensor,
               sh_l: torch.Tensor, pv: torch.Tensor, pl: torch.Tensor,
               zz: torch.Tensor, x: torch.Tensor, kesc: torch.Tensor,
               kind: torch.Tensor, order: torch.Tensor, bps: torch.Tensor,
               psize_min: int, max_frame_bytes: int,
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Frame bytes ``u8 [B, max_frame_bytes]`` and lengths ``int32 [B]``
    (CRC-16 included).

    Args:
      hdr_v, hdr_l: frame-header symbols ``[B, H]`` (values int64 holding
        unsigned 32-bit symbols, lengths int32 ≤ 32).
      sh_v, sh_l: subframe-header symbols ``[B, C, SH]``.
      pv, pl: partition-parameter symbols ``[B, C, P]`` at
        ``emit.param_slot_positions(n, psize_min)``.
      zz, x: ``[B, C, N]`` zigzag residuals (0 at ``i < order``; int32,
        or int64 past 24-bit samples) and int32 samples.  Of int64 ``zz``
        the kernel reads the low 32 bits: every value it codes is below
        2^31, since a partition that a Rice parameter (k ≤ 30) or an
        escape (≤ 31 bits) codes holds no larger value
        (``ops.rice.exact_plan``), and a subframe with any other partition
        goes verbatim, from ``x``.
      kesc: int32 ``[B, C, N // psize_min]`` per-segment ``k | escape << 7``.
      kind, order, bps: ``[B, C]`` chosen subframe kind, predictor order
        and sample width.
      psize_min: finest partition size.
    """
    if x.device.type == "cpu":
        return frame_pack_plain(hdr_v, hdr_l, sh_v, sh_l, pv, pl, zz, x,
                                kesc, kind, order, bps, psize_min,
                                max_frame_bytes)
    b, c, n = x.shape
    if n % psize_min:
        raise ValueError(f"frame_pack: finest partition {psize_min} does "
                         f"not divide block {n}")
    dev = x.device
    extra, mult, mult_head = _layout_tables(n, psize_min, dev)
    p = extra.numel() + mult.numel()
    check(hdr_v, "hdr_v", torch.int64, (b, hdr_v.shape[-1]), dev)
    check(hdr_l, "hdr_l", torch.int32, hdr_v.shape, dev)
    check(sh_v, "sh_v", torch.int64, (b, c, sh_v.shape[-1]), dev)
    check(sh_l, "sh_l", torch.int32, sh_v.shape, dev)
    check(pv, "pv", torch.int64, (b, c, p), dev)
    check(pl, "pl", torch.int32, (b, c, p), dev)
    if zz.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"zz: dtype {zz.dtype}, expected int32 or int64")
    check(zz, "zz", zz.dtype, (b, c, n), dev)
    check(x, "x", torch.int32, (b, c, n), dev)
    check(kesc, "kesc", torch.int32, (b, c, n // psize_min), dev)
    if max_frame_bytes % 4:
        raise ValueError("frame_pack: max_frame_bytes must be a multiple "
                         "of 4")
    meta = torch.stack([kind, order, bps], dim=-1).to(torch.int32) \
        .contiguous()
    h, sh = hdr_v.shape[-1], sh_v.shape[-1]
    chunks = -(-(h + c * (sh + p + n)) // CHUNK_SLOTS)
    out = torch.empty((b, max_frame_bytes), dtype=torch.uint8, device=dev)
    length = torch.empty(b, dtype=torch.int32, device=dev)
    # each chunk's packed words, bit count and CRC part; a ticket a frame
    work = torch.empty(b * (chunks * (CHUNK_SLOTS + 2) + 1),
                       dtype=torch.int32, device=dev)
    launch(bind("frame_pack", "flacx_frame_pack", 16, 13),
           [hdr_v, hdr_l, sh_v, sh_l, pv, pl, zz, x, kesc, meta, extra, mult,
            crc16_consts(dev), out, length, work],
           [b, c, h, sh, p, n, psize_min, max_frame_bytes, extra.numel(),
            mult_head, CHUNK_SLOTS, PLACE_CHUNKS,
            int(zz.dtype == torch.int64)], "frame_pack")
    return out, length
