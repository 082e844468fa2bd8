"""Bit packer: variable-length symbol streams → packed 32-bit words.

A **hierarchical bitstring merge tree**: every symbol becomes a one-word
MSB-aligned bitstring; ``log2(S)`` rounds of pairwise concatenation
(word shift by binary decomposition + bit shift + OR) fold each row's
stream into one packed buffer.  Words are carried in int64 masked to 32
bits.

Symbol contract: ``length ≤ 32`` bits per symbol; bits of ``value`` above
``length`` are dropped.
"""

from __future__ import annotations

import torch

from flacx_torch.ops import MASK32


def _shift_words(x: torch.Tensor, t: int) -> torch.Tensor:
    """x[..., w] -> x[..., w - t] along the word axis, zero-filled."""
    if t >= x.shape[-1]:
        return torch.zeros_like(x)
    return torch.cat([torch.zeros_like(x[..., :t]), x[..., :-t]], dim=-1)


def _merge_level(words: torch.Tensor, bits: torch.Tensor,
                 out_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Concatenate adjacent bitstring pairs.

    Args:
      words: ``[B, S, cap]`` MSB-first bitstrings (bits beyond each
        string's length are zero — the invariant that makes OR exact).
      bits: ``[B, S]`` int32 lengths.
      out_cap: word capacity of merged strings; bits beyond are dropped.
    Returns:
      ``(words [B, S//2, out_cap], bits [B, S//2])``.
    """
    a = words[:, 0::2]
    x = words[:, 1::2]
    la = bits[:, 0::2]
    lb = bits[:, 1::2]
    pad = out_cap - words.shape[-1]
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        x = torch.nn.functional.pad(x, (0, pad))

    # word-granularity placement of B at offset la: shift right by la>>5
    # words via binary decomposition (conditional static shifts)
    w0 = (la >> 5)[..., None]
    t = 1
    while t < out_cap:
        x = torch.where((w0 & t) != 0, _shift_words(x, t), x)
        t <<= 1

    # bit granularity: shift right by r = la & 31 with cross-word carry
    r = (la & 31)[..., None].long()
    carry = torch.where(r > 0, (_shift_words(x, 1) << ((32 - r) & 31))
                        & MASK32, 0)
    x = (x >> r) | carry
    return a | x, la + lb


def pack_symbols_words(values: torch.Tensor, lengths: torch.Tensor,
                       max_bytes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack per-row symbol streams into 32-bit words (merge tree).

    Args:
      values: ``[B, S]`` int64 symbol payloads (low ``length`` bits).
      lengths: ``[B, S]`` int32 bit lengths in ``0..32`` (0 = absent).
      max_bytes: output capacity per row (multiple of 4).
    Returns:
      ``(words int64 [B, max_bytes // 4] MSB-first, total_bits int32
      [B])``; words beyond each row's stream are zero.
    """
    b, s = values.shape
    cap_words = max_bytes // 4
    s_pow = 1
    while s_pow < s:
        s_pow <<= 1
    if s_pow != s:
        values = torch.nn.functional.pad(values, (0, s_pow - s))
        lengths = torch.nn.functional.pad(lengths, (0, s_pow - s))
    # level 0: MSB-align each value in one word
    l64 = lengths.long()
    words = torch.where(lengths > 0, (values << ((32 - l64) & 31)) & MASK32,
                        0)[..., None]
    bits = lengths
    cap = 1
    while words.shape[1] > 1:
        cap = min(cap * 2, cap_words + 2)
        words, bits = _merge_level(words, bits, cap)
    return words[:, 0, :cap_words], bits[:, 0]


def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """``[..., W]`` MSB-first words → ``[..., 4W]`` uint8 big-endian bytes."""
    by = torch.stack([(words >> 24) & 0xFF, (words >> 16) & 0xFF,
                      (words >> 8) & 0xFF, words & 0xFF], dim=-1)
    return by.to(torch.uint8).reshape(*words.shape[:-1], words.shape[-1] * 4)
