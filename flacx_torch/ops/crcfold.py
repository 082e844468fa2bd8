"""Table-free CRC-8/CRC-16 via GF(2) polynomial folding (plain PyTorch).

CRC over GF(2) is linear: ``crc(m) = Σ_i clmul(byte_i, x^(8·d_i + w)) mod P``
where ``d_i`` is the byte's distance from the end of the message and ``w``
the CRC width.  The per-distance constants ``x^(8d+w) mod P`` are a small
host table; the carry-less multiply of a byte by a ≤16-bit constant
unrolls into 8 conditional XORs, vectorised over batch × position.
Values are carried in int64.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from flacx_torch.format import CRC8_POLYNOMIAL, CRC16_POLYNOMIAL


def _gf_mod(value: int, width: int, poly_with_top: int) -> int:
    for t in range(value.bit_length() - 1, width - 1, -1):
        if (value >> t) & 1:
            value ^= poly_with_top << (t - width)
    return value


def _gf_mul(a: int, b: int, width: int, poly_with_top: int) -> int:
    """Carry-less multiply mod P (host helper)."""
    res = 0
    while b:
        if b & 1:
            res ^= a
        b >>= 1
        a = _gf_mod(a << 1, width, poly_with_top)
    return res


@lru_cache(maxsize=None)
def power_table(width: int, poly_with_top: int, max_len: int) -> np.ndarray:
    """``tab[d] = x^(8d + width) mod P`` for byte distances ``0..max_len-1``."""
    out = np.zeros(max_len, np.int64)
    r = _gf_mod(1 << width, width, poly_with_top)
    for d in range(max_len):
        out[d] = r
        r = _gf_mod(r << 8, width, poly_with_top)
    return out


@lru_cache(maxsize=None)
def inverse_power_table(width: int, poly_with_top: int,
                        max_len: int) -> np.ndarray:
    """``tab[p] = x^(-8p) mod P`` for zero-pad lengths ``0..max_len-1``.

    ``x`` is a unit mod P (FLAC's CRC polynomials have a constant term);
    ``x^(-8) = x^(ord-8)`` with ``ord`` its multiplicative order.
    """
    acc, order = _gf_mod(1 << 1, width, poly_with_top), 1
    while acc != 1:
        acc = _gf_mod(acc << 1, width, poly_with_top)
        order += 1
    c, e, base = 1, (order - 8) % order, 2
    while e:
        if e & 1:
            c = _gf_mul(c, base, width, poly_with_top)
        base = _gf_mul(base, base, width, poly_with_top)
        e >>= 1
    out = np.zeros(max_len, np.int64)
    v = 1
    for p in range(max_len):
        out[p] = v
        v = _gf_mul(v, c, width, poly_with_top)
    return out


@lru_cache(maxsize=None)
def _power_table_on(width: int, poly_with_top: int, max_len: int,
                    device: torch.device) -> torch.Tensor:
    """:func:`power_table` on ``device``, copied there once."""
    return torch.from_numpy(power_table(width, poly_with_top, max_len)) \
        .to(device)


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR-reduce the last axis via a log-depth pairwise tree."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        h = x.shape[-1] // 2
        x = x[..., :h] ^ x[..., h:]
    return x[..., 0]


def _clmul16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Carry-less multiply of two ≤16-bit values (≤ 31-bit product)."""
    prod = torch.zeros_like(a)
    for t in range(16):
        prod = prod ^ ((a << t) * ((b >> t) & 1))
    return prod


def _barrett(x: torch.Tensor, width: int, poly_with_top: int,
             in_bits: int) -> torch.Tensor:
    for t in range(in_bits - 1, width - 1, -1):
        x = x ^ ((poly_with_top << (t - width)) * ((x >> t) & 1))
    return x


def crc_fold(byte_vals: torch.Tensor, distances: torch.Tensor,
             active: torch.Tensor, width: int,
             poly_with_top: int) -> torch.Tensor:
    """CRC of the byte sequence described positionally.

    Args:
      byte_vals: ``[..., L]`` int64 byte values (0..255).
      distances: ``[..., L]`` distance from the message END in bytes (last
        byte has distance 0); entries with ``active=False`` are ignored.
      active: ``[..., L]`` bool.
    Returns:
      ``[...]`` int64 CRC (width bits).
    """
    max_len = byte_vals.shape[-1] + 1
    tab = _power_table_on(width, poly_with_top, max_len, byte_vals.device)
    k = tab[torch.clamp(distances, 0, max_len - 1).long()]
    b = byte_vals.long()
    prod = torch.zeros_like(k)
    for t in range(8):
        prod = prod ^ ((k << t) * ((b >> t) & 1))
    prod = torch.where(active, prod, 0)
    return _barrett(_xor_reduce(prod), width, poly_with_top, width + 7)


def crc8_fold(byte_vals: torch.Tensor, distances: torch.Tensor,
              active: torch.Tensor) -> torch.Tensor:
    return crc_fold(byte_vals, distances, active, 8, CRC8_POLYNOMIAL)


def crc16_over_word_rows(words: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """CRC-16 of the big-endian byte stream of ``words[b, :]`` rows.

    ``words`` are MSB-first 32-bit words (int64) with every byte past
    ``lengths[b]`` zero.  The fold uses fixed per-position constants
    (distance from the END of the whole row); trailing zero bytes only
    multiply the true CRC by ``x^(8·pad)``, which one per-row
    inverse-power lookup undoes.
    """
    w_count = words.shape[-1]
    total = w_count * 4
    dev = words.device
    tab = power_table(16, CRC16_POLYNOMIAL, total + 1)
    k4 = torch.from_numpy(tab[total - 1::-1].copy().reshape(w_count, 4)) \
        .to(dev)
    d = words.long()
    prod = torch.zeros_like(d)
    for j in range(4):
        kj = k4[:, j]
        for t in range(8):
            prod = prod ^ ((kj << t) * ((d >> (8 * (3 - j) + t)) & 1))
    folded = _barrett(_xor_reduce(prod), 16, CRC16_POLYNOMIAL, 23)
    inv = torch.from_numpy(inverse_power_table(16, CRC16_POLYNOMIAL,
                                               total + 1)).to(dev)
    fix = inv[torch.clamp(total - lengths.long(), 0, total)]
    return _barrett(_clmul16(folded, fix), 16, CRC16_POLYNOMIAL, 31)


def crc16_over_rows(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """CRC-16 of ``data[b, :lengths[b]]`` per row; ``data`` is ``[..., L]``
    u8 with every byte past ``lengths`` zero.

    The fold uses fixed per-position constants (distance from the END of
    the whole row); trailing zeros only multiply the true CRC by
    ``x^(8·pad)``, which one per-row inverse-power lookup undoes.
    """
    total = data.shape[-1]
    dev = data.device
    tab = power_table(16, CRC16_POLYNOMIAL, total + 1)
    k = torch.from_numpy(tab[total - 1::-1].copy()).to(dev)
    b = data.long()
    prod = torch.zeros_like(b)
    for t in range(8):
        prod = prod ^ ((k << t) * ((b >> t) & 1))
    folded = _barrett(_xor_reduce(prod), 16, CRC16_POLYNOMIAL, 23)
    inv = torch.from_numpy(inverse_power_table(16, CRC16_POLYNOMIAL,
                                               total + 1)).to(dev)
    fix = inv[torch.clamp(total - lengths.long(), 0, total)]
    return _barrett(_clmul16(folded, fix), 16, CRC16_POLYNOMIAL, 31)
