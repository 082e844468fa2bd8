"""Native host runtime bindings (C++, ctypes).

``lib()`` builds ``hostops.cc`` at first use (``flacx_torch/native/
build.py``) and returns the loaded library.  The decoder has no other
route: a failed build or load raises, with the compiler's output.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_lib = None
_lock = threading.Lock()

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            from flacx_torch.native.build import build
            cdll = ctypes.CDLL(str(build()))
            cdll.fxt_crc16_rows.restype = None
            cdll.fxt_crc16_rows.argtypes = [_P, _P, _I64, _I64, _P]
            cdll.fxt_scatter_rows.restype = None
            cdll.fxt_scatter_rows.argtypes = [_P, _P, _P, _I64, _P, _I64]
            cdll.fxt_scan_candidates.restype = _I64
            cdll.fxt_scan_candidates.argtypes = [_P, _I64, _I64, _P, _P, _P,
                                                 _P, _I64]
            cdll.fxt_parse_frames.restype = _I64
            cdll.fxt_parse_frames.argtypes = ([_P, _I64, _I64, _P, _I32, _I32,
                                               _I32] + [_P] * 9)
            cdll.fxt_scan_frames.restype = _I64
            cdll.fxt_scan_frames.argtypes = ([_P, _I64, _I64, _P] + [_I32] * 6
                                             + [_P] * 17)
            _lib = cdll
    return _lib


def _ptr(a: np.ndarray | None) -> int | None:
    return None if a is None else a.ctypes.data


def crc16_rows(data: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """CRC-16 of ``data[i, :lengths[i]]`` per row, uint16."""
    data = np.ascontiguousarray(data, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.int32)
    out = np.empty(data.shape[0], np.uint16)
    lib().fxt_crc16_rows(_ptr(data), _ptr(lengths), data.shape[0],
                         data.shape[1], _ptr(out))
    return out


def scatter_rows(data: np.ndarray, offs: np.ndarray, ends: np.ndarray,
                 width: int) -> np.ndarray:
    """``rows[i, :ends[i]-offs[i]] = data[offs[i]:ends[i]]``, zero-padded
    to ``width``: a batch of frame byte spans in the device's padded row
    layout, in one threaded pass."""
    offs = np.ascontiguousarray(offs, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    data = np.ascontiguousarray(data, np.uint8)
    rows = np.empty((offs.shape[0], width), np.uint8)
    lib().fxt_scatter_rows(_ptr(data), _ptr(offs), _ptr(ends), offs.shape[0],
                           _ptr(rows), width)
    return rows


def scan_candidates(data: np.ndarray, first: int
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]:
    """Frame-boundary candidates from ``first`` on: every sync code whose
    header parses and whose CRC-8 holds.  Returns ``(offsets, numbers,
    strategies, block_sizes)`` int64 (block sizes decoded from each
    header, the uncommon 8/16-bit forms included)."""
    data = np.ascontiguousarray(data, np.uint8)
    empty = (np.asarray([], np.int64),) * 4
    lim = data.size - 6
    if lim <= first:
        return empty
    cap = int(np.count_nonzero(data[first:lim] == 0xFF))
    if cap == 0:
        return empty
    offs = np.empty(cap, np.int64)
    nums = np.empty(cap, np.int64)
    strats = np.empty(cap, np.int32)
    bsizes = np.empty(cap, np.int64)
    cnt = lib().fxt_scan_candidates(_ptr(data), data.size, first, _ptr(offs),
                                    _ptr(nums), _ptr(strats), _ptr(bsizes),
                                    cap)
    return (offs[:cnt], nums[:cnt], strats[:cnt].astype(np.int64),
            bsizes[:cnt])


def wide_state(bps: int, channels: int) -> bool:
    """Whether the walker's sample state is int64: past 31 bits with a
    stereo side channel counted (``bps + 1`` in stereo), where a valid
    stream's samples may not fit int32."""
    return bps + (1 if channels == 2 else 0) > 31


class ScannedFrames:
    """Structure-of-arrays output of the C++ walker (device decode path)."""

    __slots__ = ("channel_code", "kind", "order", "shift", "wasted", "po",
                 "width", "taps", "warmup", "const_val", "ckpt_pos",
                 "ckpt_param", "ckpt_esc", "ckpt_inesc", "ckpt_state",
                 "end_bits", "ckpt_interval", "state_interval", "fbps")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def scan_frames(data: np.ndarray, start_bits: np.ndarray, block_size: int,
                channels: int, bps: int, ckpt_interval: int = 64,
                state_interval: int = 0) -> ScannedFrames:
    """Run the C++ structure walker over a batch of equal-size frames.

    Parses headers, taps and warm-up samples and checkpoints the residual
    bit cursor every ``ckpt_interval`` samples; residual VALUES are decoded
    on the device (``flacx_torch.kernels.bit_unpack``).  With
    ``state_interval > 0`` the walker also runs the integer reconstruction
    IIR inline and emits the last-32-samples window before every
    ``state_interval`` boundary (``ckpt_state [F, C, Ks, 32]``), so the
    device can reconstruct all chunks of a batch in parallel: int32 where
    every sample fits it, int64 past 31 bits (:func:`wide_state`; the
    walker's history has the same type).  Raises ValueError on malformed
    input.
    """
    f = data.shape[0]
    n, c, s, ss = block_size, channels, ckpt_interval, state_interval
    k = (n + s - 1) // s
    ks = (n + ss - 1) // ss if ss > 0 else 0
    data = np.ascontiguousarray(data, np.uint8)
    start = np.ascontiguousarray(start_bits, np.int64)
    wide = wide_state(bps, c)

    def i32(*shape):
        return np.zeros(shape, np.int32)

    out = ScannedFrames(
        channel_code=i32(f), kind=i32(f, c), order=i32(f, c),
        shift=i32(f, c), wasted=i32(f, c), po=i32(f, c), width=i32(f, c),
        taps=i32(f, c, 32), warmup=np.zeros((f, c, 32), np.int64),
        const_val=np.zeros((f, c), np.int64), ckpt_pos=i32(f, c, k),
        ckpt_param=i32(f, c, k), ckpt_esc=i32(f, c, k),
        ckpt_inesc=i32(f, c, k),
        ckpt_state=np.zeros((f, c, ks, 32), np.int64 if wide else np.int32)
        if ss > 0 else None,
        end_bits=np.zeros(f, np.int64), ckpt_interval=s, state_interval=ss,
        fbps=i32(f))
    rc = lib().fxt_scan_frames(
        _ptr(data), f, data.shape[1], _ptr(start), n, c, bps, s, ss,
        int(wide),
        *(_ptr(getattr(out, name)) for name in (
            "channel_code", "kind", "order", "shift", "wasted", "po",
            "width", "taps", "warmup", "const_val", "ckpt_pos", "ckpt_param",
            "ckpt_esc", "ckpt_inesc", "ckpt_state", "end_bits", "fbps")))
    if rc != 0:
        raise ValueError(f"frame scan error in row {int(rc) - 1}")
    return out
