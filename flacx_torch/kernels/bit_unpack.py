"""The ``bit_unpack`` kernel: every residual and verbatim symbol of a
batch of frames, decoded in parallel from the host walker's checkpoints
(one thread per chunk of 64 symbols, each block walking its span of the
rows from a copy in shared memory).

Replaces the decode path's XLA scan ``flacx/ops/bitunpack.py::
parse_residual_chunks`` (with ``bytes_to_words``); flacx has no Pallas
kernel there.  Source, bound and design in ``csrc/bit_unpack.cu``.  The
values come out as int64 whatever the stream's width: a Rice code's
quotient may pass 32 bits in a corrupt stream, which the reconstruction's
int32 guard has to see.
"""

from __future__ import annotations

import torch

from flacx_torch.kernels.build import bind, check, launch
from flacx_torch.ops.bitunpack import bytes_to_words, parse_residual_chunks

#: symbols a chunk: the walker's checkpoint interval
INTERVAL = 64


def bit_unpack_plain(rows: torch.Tensor, ckpt_pos: torch.Tensor,
                     ckpt_param: torch.Tensor, ckpt_esc: torch.Tensor,
                     ckpt_inesc: torch.Tensor, kind: torch.Tensor,
                     order: torch.Tensor, po: torch.Tensor,
                     width: torch.Tensor, n: int,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`bit_unpack`."""
    vals, err = parse_residual_chunks(
        bytes_to_words(rows), ckpt_pos, ckpt_param, ckpt_esc, ckpt_inesc,
        kind, order, po, width, n, INTERVAL)
    return vals, err.to(torch.int32).reshape(1)


def bit_unpack(rows: torch.Tensor, ckpt_pos: torch.Tensor,
               ckpt_param: torch.Tensor, ckpt_esc: torch.Tensor,
               ckpt_inesc: torch.Tensor, kind: torch.Tensor,
               order: torch.Tensor, po: torch.Tensor, width: torch.Tensor,
               n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(vals int64 [F, C, n], err int32 [1])``: the zigzag-decoded
    residuals (verbatim samples of a verbatim subframe; zero at warm-up
    positions and in constant subframes) and the batch's error flag.

    Args:
      rows: u8 ``[F, W]`` frame bytes, each frame from byte 0, W a
        multiple of 4.
      ckpt_pos, ckpt_param, ckpt_esc, ckpt_inesc: int32 ``[F, C, K]``,
        the walker's checkpoints every 64 samples (``K = ceil(n / 64)``).
      kind, order, po, width: int32 ``[F, C]`` subframe structure.
      n: block size.
    """
    if rows.device.type == "cpu":
        return bit_unpack_plain(rows, ckpt_pos, ckpt_param, ckpt_esc,
                                ckpt_inesc, kind, order, po, width, n)
    f, w = rows.shape
    c, k = ckpt_pos.shape[1:]
    dev = rows.device
    check(rows, "rows", torch.uint8, device=dev)
    for name, t in (("ckpt_pos", ckpt_pos), ("ckpt_param", ckpt_param),
                    ("ckpt_esc", ckpt_esc), ("ckpt_inesc", ckpt_inesc)):
        check(t, name, torch.int32, (f, c, k), dev)
    for name, t in (("kind", kind), ("order", order), ("po", po),
                    ("width", width)):
        check(t, name, torch.int32, (f, c), dev)
    if w % 4 or k != -(-n // INTERVAL):
        raise ValueError(f"bit_unpack: row width {w} (a multiple of 4) or "
                         f"{k} checkpoints for block {n}")
    vals = torch.empty((f, c, n), dtype=torch.int64, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    launch(bind("bit_unpack", "flacx_bit_unpack", 11, 6),
           [rows, ckpt_pos, ckpt_param, ckpt_esc, ckpt_inesc, kind, order, po,
            width, vals, err], [f, c, k, n, w, INTERVAL], "bit_unpack")
    return vals, err
