"""How the ``crc16_rows`` kernel splits a row's CRC-16, modelled in plain
Python and held against flacx's ``crc16_over_rows`` on the CPU.

``csrc/crc16_rows.cu`` cuts a row's body (``lens - 2`` bytes, read as
big-endian 32-bit words, the bytes past it masked to zero) into pieces
of ``PIECE_WORDS``; a lane folds a contiguous run of ``RUN_WORDS`` words
of a piece with the sliced tables ``tab[k][i] = i x^(16 + 8k) mod P``
(``v = w ^ (crc << 16)``, then four lookups), shifts the run's CRC to
the body's padded end by the constants ``x^(32 d)`` (``d`` the words
after the run: ``lo[d % 1024] * mid[(d // 1024) % 1024] * hi[d //
2^20]``), and XORs every run's term; the zero bytes after the body are
undone with ``x^(-8 pad)``.  Products are ``crc16.cuh``'s
``gf_mulmod16`` (integer products of the operands' bits four apart,
reduced with the tables).  The model uses the kernel's own constants
(``kernels/crc16_rows._consts``) and must give flacx's CRC on rows of 2-9
bytes, lengths that are not a multiple of 4, rows of several pieces and
rows whose length is the row width; at the kernel's sizes and with small
runs and pieces.
"""

import numpy as np
import pytest
import torch

import flacx.ops  # noqa: F401  (x64)
import jax.numpy as jnp
from flacx.ops.crcfold import crc16_over_rows as fx_crc16_over_rows

from flacx_torch.format import CRC16_POLYNOMIAL
from flacx_torch.kernels import crc16_rows as k_crc
from flacx_torch.native import crc16_rows as host_crc16
from flacx_torch.ops.crcfold import _gf_mul

torch.set_num_threads(1)

#: csrc/crc16_rows.cu: words of a lane's run and of a piece, the offsets
#: of the power tables and of x^(-8 p) in the constants
RUN_WORDS, PIECE_WORDS = 16, 512
LO, MID, HI, INV = 1024, 2048, 3072, 3584


@pytest.fixture(scope="module")
def consts() -> list[int]:
    return [v & 0xFFFF for v in k_crc._consts(torch.device("cpu")).tolist()]


def gf_mulmod16(a: int, b: int, c: list[int]) -> int:
    """``crc16.cuh``'s product: carry-less from integer products of bits
    four apart, the top 15 bits reduced with table rows 0 and 1."""
    m32 = 0xFFFFFFFF
    am = [a & (0x1111 << k) for k in range(4)]
    bm = [b & (0x1111 << k) for k in range(4)]
    z = []
    for k in range(4):
        acc = 0
        for i in range(4):
            acc ^= (am[i] * bm[(k - i) % 4]) & m32
        z.append(acc)
    p = 0
    for k in range(4):
        p |= z[k] & (0x11111111 << k)
    return (p & 0xFFFF) ^ c[(p >> 16) & 0xFF] ^ c[256 + (p >> 24)]


def shift_words(a: int, d: int, c: list[int]) -> int:
    a = gf_mulmod16(a, c[LO + (d & 1023)], c)
    if d >= 1024:
        a = gf_mulmod16(a, c[MID + ((d >> 10) & 1023)], c)
    if d >= 1 << 20:
        a = gf_mulmod16(a, c[HI + (d >> 20)], c)
    return a


def fold(words: list[int], c: list[int]) -> int:
    """The sliced-table fold of ``words`` from 0: ``v = w ^ (crc << 16)``,
    then the four byte lookups."""
    crc = 0
    for w in words:
        v = w ^ (crc << 16)
        crc = (c[768 + (v >> 24)] ^ c[512 + ((v >> 16) & 0xFF)]
               ^ c[256 + ((v >> 8) & 0xFF)] ^ c[v & 0xFF])
    return crc


def model_crc(row: bytes, length: int, c: list[int], run: int = RUN_WORDS,
              piece: int = PIECE_WORDS) -> int:
    """The kernel's CRC of ``row[:length - 2]``: runs of ``run`` words in
    pieces of ``piece``, each run's CRC shifted to the padded end, every
    term XORed."""
    body = max(0, min(length - 2, len(row)))
    m = (body + 3) // 4
    padded = row[:body] + bytes(4 * m - body)
    words = [int.from_bytes(padded[4 * i:4 * i + 4], "big") for i in range(m)]
    total = 0
    for p0 in range(0, m, piece):
        for r0 in range(p0, min(p0 + piece, m), run):
            r1 = min(r0 + run, p0 + piece, m)
            total ^= shift_words(fold(words[r0:r1], c), m - r1, c)
    return gf_mulmod16(total, c[INV + 4 * m - body], c)


def rows_with_lengths(seed: int, width: int, lens: list[int]) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (len(lens), width)).astype(np.uint8)


def fx_crcs(rows: np.ndarray, lens: list[int]) -> list[int]:
    """flacx's CRC of ``rows[f, :lens[f] - 2]`` (bytes past it zeroed)."""
    body = np.array(lens) - 2
    data = np.where(np.arange(rows.shape[1]) < body[:, None], rows, 0)
    return np.asarray(fx_crc16_over_rows(
        jnp.asarray(data), jnp.asarray(body))).astype(np.int64).tolist()


CASES = {
    # rows of 2-9 bytes, every length mod 4
    "short": (12, list(range(2, 10)) + [12, 12, 12, 11]),
    # several pieces of the small layout, ends off a word, len = width
    "pieces": (520, [520, 519, 518, 517, 301, 130, 66, 65]),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("run,piece", [(RUN_WORDS, PIECE_WORDS), (2, 8),
                                       (3, 12)])
def test_run_fold_matches_flacx(consts, case, run, piece):
    width, lens = CASES[case]
    rows = rows_with_lengths(width + run, width, lens)
    want = fx_crcs(rows, lens)
    got = [model_crc(rows[f].tobytes(), lens[f], consts, run, piece)
           for f in range(len(lens))]
    assert got == want


def test_rows_of_several_kernel_pieces(consts):
    """Rows of up to six 2 KB pieces at the kernel's layout: the mid
    table (d >= 1024 words) and runs cut by the body's end."""
    lens = [10000, 9999, 8194, 4098, 4097, 4096, 12288]
    rows = rows_with_lengths(5, 12288, lens)
    want = host_crc16(rows, (np.array(lens) - 2).astype(np.int32))
    got = [model_crc(rows[f].tobytes(), lens[f], consts)
           for f in range(len(lens))]
    assert got == [int(v) for v in want]
    assert got[:3] == fx_crcs(rows[:3], lens[:3])


def test_shift_words_covers_every_distance(consts):
    """``x^(32 d)`` from the three tables equals the direct power for
    distances on every level (d past 2^20 words included)."""
    x32 = 1
    for _ in range(32):
        x32 = _gf_mul(x32, 2, 16, CRC16_POLYNOMIAL)

    def power(d):
        out, base = 1, x32
        while d:
            if d & 1:
                out = _gf_mul(out, base, 16, CRC16_POLYNOMIAL)
            base = _gf_mul(base, base, 16, CRC16_POLYNOMIAL)
            d >>= 1
        return out
    rng = np.random.default_rng(2)
    for d in [0, 1, 1023, 1024, 1025, 2 ** 20 - 1, 2 ** 20, 2 ** 20 + 7,
              2 ** 29 - 1] + rng.integers(0, 2 ** 29, 20).tolist():
        a = int(rng.integers(1, 2 ** 16))
        want = _gf_mul(a, power(int(d)), 16, CRC16_POLYNOMIAL)
        assert shift_words(a, int(d), consts) == want, d


def test_model_checks_stored_bytes_as_the_plain_version(consts):
    """A row's verdict from the model's CRC equals ``crc16_rows_plain``'s,
    a corrupted byte in the first and in the last word included."""
    width, lens = 64, [64, 33, 9, 2, 1, 0]
    rows = rows_with_lengths(9, width, lens)
    for f, n in enumerate(lens):
        if n >= 2:
            crc = model_crc(rows[f].tobytes(), n, consts)
            rows[f, n - 2], rows[f, n - 1] = crc >> 8, crc & 0xFF
    rows[0, 0] ^= 1                       # first word
    rows[1, 30] ^= 0x80                   # the body's last word
    ok, all_ok = k_crc.crc16_rows_plain(torch.from_numpy(rows),
                                        torch.tensor(lens, dtype=torch.int32))
    mine = []
    for f, n in enumerate(lens):
        stored = (int(rows[f, n - 2]) << 8 | int(rows[f, n - 1])
                  if 2 <= n <= width else -1)
        mine.append(int(n >= 2 and model_crc(rows[f].tobytes(), n, consts)
                        == stored))
    assert mine == ok.tolist() == [0, 0, 1, 1, 0, 0]
    assert all_ok.tolist() == [0]
