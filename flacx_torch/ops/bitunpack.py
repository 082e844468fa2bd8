"""Chunk-parallel Rice/escape/verbatim symbol decode (plain PyTorch).

The plain version of the ``bit_unpack`` kernel
(``flacx_torch/kernels/csrc/bit_unpack.cu``).  The decode grammar is
bit-serial *within* a symbol chain, so the host walker
(``flacx_torch.native.scan_frames``) checkpoints the bit cursor every
``S`` samples, and every ``[F, C, n/S]`` chunk of a batch decodes its S
symbols independently:

  * each step reads a lane's 64-bit window straight from its frame's
    words (three big-endian 32-bit words at the cursor; words past the
    row read as zero),
  * the count of leading zeros of the window is the unary quotient,
    remainder / escape / verbatim fields are plain shifts,
  * partition parameter fields are consumed in-step where a lane's
    sample index crosses a partition boundary.

Self-validating: a symbol whose fields pass one 64-bit window, or a chunk
whose final cursor does not land exactly on the next chunk's checkpoint,
sets the error flag, and the caller falls back to the host parse.

64-bit windows are carried in int64 as the bit pattern of an unsigned
64-bit value (PyTorch's CPU ``uint64`` lacks shifts); :func:`_srl` is the
logical right shift.
"""

from __future__ import annotations

import torch

from flacx_torch.ops import MASK32


def bytes_to_words(rows: torch.Tensor) -> torch.Tensor:
    """``[F, W]`` u8 rows → ``[F, W/4 + 2]`` big-endian 32-bit words in
    int64.  W must be a multiple of 4; two zero words are appended, as
    the JAX package does."""
    f, w = rows.shape
    r = rows.to(torch.int64).reshape(f, w // 4, 4)
    words = (r[..., 0] << 24) | (r[..., 1] << 16) | (r[..., 2] << 8) \
        | r[..., 3]
    return torch.nn.functional.pad(words, (0, 2))


def _srl(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Logical right shift of 64-bit patterns ``v`` by ``s`` in [0, 63]."""
    s1 = s.clamp(min=1)
    return torch.where(s == 0, v, (v >> s1) & ((1 << (64 - s1)) - 1))


def _clz64(v: torch.Tensor) -> torch.Tensor:
    hi = _srl(v, torch.full_like(v, 32))
    lo = v & MASK32

    def bitlen(x):
        return torch.frexp(x.double()).exponent.to(torch.int64)
    return torch.where(hi != 0, 32 - bitlen(hi), 64 - bitlen(lo))


def parse_residual_chunks(words: torch.Tensor, ckpt_pos: torch.Tensor,
                          ckpt_param: torch.Tensor, ckpt_esc: torch.Tensor,
                          ckpt_inesc: torch.Tensor, kind: torch.Tensor,
                          order: torch.Tensor, po: torch.Tensor,
                          width: torch.Tensor, n: int, s_interval: int,
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode all residual/verbatim symbols of a frame batch in parallel.

    Args:
      words: ``[F, Wp]`` int64 big-endian 32-bit frame words
        (:func:`bytes_to_words`).
      ckpt_*: ``[F, C, K]`` walker checkpoints (cursor bit position,
        current Rice parameter, escape size, in-escape flag).
      kind/order/po/width: ``[F, C]`` subframe structure.
      n: block size; s_interval: checkpoint interval.
    Returns:
      ``(vals [F, C, n] int64, err [] bool)``: zigzag-decoded residuals
      (zero at warm-up positions and in constant subframes) and the
      batch-level error flag.
    """
    f, c, k = ckpt_pos.shape
    s = s_interval
    lanes = f * c * k
    dev = words.device
    wp = words.shape[1]
    flat_words = words.reshape(-1)

    def lanewise(a):  # [F, C] -> [lanes]
        return a.to(torch.int64)[..., None].expand(f, c, k).reshape(lanes)

    kind_l, order_l = lanewise(kind), lanewise(order)
    psize_l = n >> lanewise(po)
    width_l = lanewise(width)
    pred = kind_l >= 2
    escape_val = (1 << width_l) - 1
    base = (torch.arange(k, device=dev) * s).repeat(f * c)      # [lanes]
    row_base = torch.arange(f, device=dev).repeat_interleave(c * k) * wp

    pos = ckpt_pos.reshape(lanes).to(torch.int64)
    param = ckpt_param.reshape(lanes).to(torch.int64)
    esc = ckpt_esc.reshape(lanes).to(torch.int64)
    inesc = ckpt_inesc.reshape(lanes).bool()
    err = torch.zeros(lanes, dtype=torch.bool, device=dev)
    vals = torch.zeros((lanes, s), dtype=torch.int64, device=dev)

    def word(d):
        idx = (pos >> 5) + d
        got = flat_words[row_base + idx.clamp(max=wp - 1)]
        return torch.where(idx < wp, got, 0)

    for i in range(s):
        j = base + i
        in_block = j < n
        start_m = pred & in_block & ((j == order_l)
                                     | ((j > 0) & (j % psize_l == 0)))
        act_m = in_block & ((pred & (j >= order_l)) | (kind_l == 1))
        sh = pos & 31
        w0, w1, w2 = word(0), word(1), word(2)
        hi = ((w0 << sh) | (w1 >> (32 - sh))) & MASK32
        lo = ((w1 << sh) | (w2 >> (32 - sh))) & MASK32
        win = (hi << 32) | lo

        # partition parameter field (and 5-bit escape size) in-window
        wf = torch.where(start_m, width_l, 0)
        p_field = torch.where(start_m, _srl(win, 64 - wf.clamp(min=1)), 0)
        is_esc = start_m & (p_field == escape_val)
        esc_field = _srl(win, 59 - wf) & 31
        param = torch.where(start_m & ~is_esc, p_field, param)
        esc = torch.where(is_esc, esc_field, esc)
        inesc = torch.where(start_m, is_esc, inesc)
        consumed = wf + torch.where(is_esc, 5, 0)
        vwin = win << consumed

        # Rice: the count of leading zeros is the unary quotient
        q = _clz64(vwin)
        code_bits = q + 1 + param
        rem = _srl(vwin, (64 - code_bits).clamp(0, 63)) & ((1 << param) - 1)
        u = (q << param) | rem
        rice_val = (u >> 1) ^ -(u & 1)

        # escape partitions / verbatim: an esc-bit signed field (the
        # arithmetic shift of the signed window sign-extends)
        esc_val = torch.where(esc > 0, vwin >> (64 - esc).clamp(1, 63), 0)

        val = torch.where(inesc, esc_val, rice_val)
        used = consumed + torch.where(inesc, esc, code_bits)
        err = err | (act_m & (used > 64))
        pos = pos + torch.where(act_m, used, 0)
        vals[:, i] = torch.where(act_m, val, 0)

    # self-check: each chunk must land exactly on the next checkpoint
    pos_end = pos.reshape(f, c, k)
    chain_ok = pos_end[..., :-1] == ckpt_pos[..., 1:].to(torch.int64)
    err_any = err.any() | ~chain_ok.all()
    return vals.reshape(f, c, k * s)[..., :n], err_any
