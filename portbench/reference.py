"""The benchmark's plain FLAC reference, in NumPy alone.

It imports nothing of the program and takes nothing the program made but
the outputs it judges.  It holds what decides ``correct``:

- :func:`choose`: the encoder's choices for one frame of PCM, worked out
  again from the PCM by the algorithm the configuration names (stereo
  mode, per subframe the kind, predictor order, quantized coefficients
  and shift), at the analysis precision the configuration states, or at
  a lower one for the control;
- :func:`rice_optimum`: the exact optimum of a residual's partitioned
  Rice code over the search space the configuration states;
- :func:`write_frame`: a FLAC frame writer (RFC 9639) for given choices;
- :func:`check_frame`: reads a frame's fields, writes the frame again
  from those fields and the input PCM, and compares every byte: a frame
  that passes is a FLAC encoding of its input PCM, CRC-8 and CRC-16 and
  all;
- :func:`decode_frame`: a sequential decoder, exact in int64, or in a
  narrower type for the control.

Streams are a ``fLaC`` marker, one STREAMINFO block and the frames
(:func:`stream_bytes`).

It judges every configuration that names no reference of its own
(``portbench.references``); :meth:`Format.from_config` refuses one it
cannot judge.
"""

from __future__ import annotations

import math
import operator
from dataclasses import dataclass

import numpy as np

INF = 1 << 50
#: stereo decorrelation modes: (channel code, virtual-channel pair)
STEREO_MODES = ((1, (0, 1)), (8, (0, 3)), (9, (3, 1)), (10, (2, 3)))
FIXED_TAPS = ((), (1,), (2, -1), (3, -3, 1), (4, -6, 4, -1))
#: block sizes with a 4-bit code of their own (RFC 9639, 9.1.1)
BLOCK_CODES = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5,
               **{256 << i: 8 + i for i in range(8)}}
RATE_CODES = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5,
              22050: 6, 24000: 7, 32000: 8, 44100: 9, 48000: 10,
              96000: 11}
SIZE_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}


@dataclass(frozen=True)
class Format:
    """What a configuration states, as the reference needs it."""
    sample_rate: int
    bps: int
    channels: int
    block_size: int
    max_lpc_order: int
    qlp_precision: int
    partition_orders: tuple
    stereo: str = "auto"
    order_search: str = "estimate"
    analysis: str = "f32"
    escapes: bool = True
    window: str = "tukey(0.5)"

    @classmethod
    def from_config(cls, cfg: dict) -> "Format":
        enc = cfg["encoder"]
        if enc.get("order_search", "estimate") != "estimate" \
                or enc.get("conformance") or enc.get("wasted_bits") \
                or len(enc.get("windows", ["tukey(0.5)"])) != 1:
            raise ValueError("the reference works out the estimate order "
                             "search under one window, without wasted "
                             "bits or conformance mode: name a reference "
                             "of its own (portbench.references)")
        return cls(sample_rate=enc["sample_rate"], bps=enc["bps"],
                   channels=enc["channels"], block_size=enc["block_size"],
                   max_lpc_order=enc["max_lpc_order"],
                   qlp_precision=enc["qlp_precision"],
                   partition_orders=tuple(enc["partition_orders"]),
                   stereo=enc["stereo"], analysis=enc["analysis_dtype"],
                   escapes=enc["escapes"],
                   window=enc.get("windows", ["tukey(0.5)"])[0])

    @property
    def stereo_modes(self) -> bool:
        return self.channels == 2 and self.stereo == "auto" \
            and self.bps <= 31

    @property
    def kmax(self) -> int:
        return min(30, self.bps + 7)

    @property
    def porders(self) -> tuple:
        legal = {o for o in self.partition_orders
                 if o <= 15 and self.block_size % (1 << o) == 0}
        return tuple(sorted(legal | {0}))

    @property
    def pcm_bytes(self) -> int:
        """Bytes of one PCM sample as a WAV file stores it."""
        return (self.bps + 7) // 8


# ---------------------------------------------------------------- CRCs

def _crc_table(poly: int, width: int) -> list:
    top, mask = 1 << (width - 1), (1 << width) - 1
    out = []
    for byte in range(256):
        c = byte << (width - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) if c & top else c << 1
        out.append(c & mask)
    return out


_CRC8 = _crc_table(0x07, 8)
_CRC16 = _crc_table(0x8005, 16)


def crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC8[c ^ b]
    return c


def crc16(data: bytes) -> int:
    c = 0
    table = _CRC16
    for b in data:
        c = ((c << 8) & 0xFFFF) ^ table[(c >> 8) ^ b]
    return c


# --------------------------------------------------------- bit writing

class BitWriter:
    """MSB-first bit string built from NumPy arrays of 0/1."""

    def __init__(self):
        self.parts = []

    def put(self, value: int, nbits: int) -> None:
        if nbits:
            v = int(value) & ((1 << nbits) - 1)
            self.parts.append(np.array(
                [(v >> s) & 1 for s in range(nbits - 1, -1, -1)], np.uint8))

    def put_bytes(self, data: bytes) -> None:
        self.parts.append(np.unpackbits(np.frombuffer(data, np.uint8)))

    def put_array(self, values: np.ndarray, nbits: int) -> None:
        """Each value as ``nbits``-bit two's complement."""
        if nbits and len(values):
            sh = np.arange(nbits - 1, -1, -1, dtype=np.int64)
            bits = (np.asarray(values, np.int64)[:, None] >> sh) & 1
            self.parts.append(bits.astype(np.uint8).ravel())

    def put_rice(self, zz: np.ndarray, k: int) -> None:
        """Rice codes of parameter ``k``: ``zz >> k`` zeros, a one, then
        the low ``k`` bits."""
        if not len(zz):
            return
        q = zz >> k
        lengths = q + 1 + k
        starts = np.cumsum(lengths) - lengths
        out = np.zeros(int(lengths.sum()), np.uint8)
        stop = starts + q
        out[stop] = 1
        for b in range(k):
            out[stop + 1 + b] = (zz >> (k - 1 - b)) & 1
        self.parts.append(out)

    def to_bytes(self) -> bytes:
        bits = np.concatenate(self.parts) if self.parts \
            else np.zeros(0, np.uint8)
        return np.packbits(bits).tobytes()   # zero-padded to a byte


class BitReader:
    """MSB-first reads from bytes; reading past the end raises."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        b0, b1 = p >> 3, (p + n + 7) >> 3
        if b1 > len(self.data):
            raise EOFError("read past the end of the frame")
        v = int.from_bytes(self.data[b0:b1], "big")
        self.pos = p + n
        return (v >> ((b1 << 3) - p - n)) & ((1 << n) - 1)

    def signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if n and v >> (n - 1) else v


# ----------------------------------------------------- small helpers

def zigzag(r: np.ndarray) -> np.ndarray:
    r = np.asarray(r, np.int64)
    return np.where(r >= 0, 2 * r, -2 * r - 1)


def bit_length(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.int64)
    out = np.zeros(m.shape, np.int64)
    for b in range(63):
        out += m >= (np.int64(1) << b)
    return out


def tukey(n: int, r: float = 0.5) -> np.ndarray:
    """libFLAC's Tukey window (f64): ends Hann-tapered over
    ``floor(r/2*n) - 1`` points."""
    nr = math.floor(r / 2.0 * n) - 1
    w = [1.0] * n
    for i in range(nr + 1):
        w[i] = 0.5 - 0.5 * math.cos(math.pi * i / nr)
        w[n - nr - 1 + i] = 0.5 - 0.5 * math.cos(math.pi * (i + nr) / nr)
    return np.asarray(w, np.float64)


_WINDOWS: dict = {}


def window(name: str, n: int) -> np.ndarray:
    key = (name, n)
    if key not in _WINDOWS:
        s = name.strip().lower()
        if not (s.startswith("tukey(") and s.endswith(")")):
            raise ValueError(f"the reference knows the Tukey window only, "
                             f"not {name!r}")
        _WINDOWS[key] = tukey(n, float(s[6:-1]))
    return _WINDOWS[key]


def bf16(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to bfloat16 (to nearest even), kept as f32."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def residual(x: np.ndarray, kind: str, order: int, coefs=(),
             shift: int = 0) -> np.ndarray:
    """The prediction residual of ``x`` at positions ``order..n-1``
    (int64, exact)."""
    x = np.asarray(x, np.int64)
    n = len(x)
    if kind == "fixed":
        return np.diff(x, n=order) if order else x.copy()
    acc = np.zeros(n - order, np.int64)
    for j, c in enumerate(coefs):
        acc += int(c) * x[order - 1 - j: n - 1 - j]
    return x[order:] - (acc >> shift)


def virtual_channels(pcm: np.ndarray, fmt: Format):
    """``[V, n]`` int64 signals and their widths: L, R, mid, side under
    stereo decorrelation, else the channels."""
    x = np.asarray(pcm, np.int64)
    if fmt.stereo_modes:
        left, right = x[0], x[1]
        return (np.stack([left, right, (left + right) >> 1, left - right]),
                [fmt.bps] * 3 + [fmt.bps + 1])
    return x, [fmt.bps] * fmt.channels


def channel_signals(pcm: np.ndarray, fmt: Format, code: int):
    """The subframe signals and widths of a frame of channel code
    ``code``."""
    x = np.asarray(pcm, np.int64)
    if code < 8:
        return list(x), [fmt.bps] * len(x)
    left, right = x[0], x[1]
    side = left - right
    if code == 8:
        return [left, side], [fmt.bps, fmt.bps + 1]
    if code == 9:
        return [side, right], [fmt.bps + 1, fmt.bps]
    if code == 10:
        return [(left + right) >> 1, side], [fmt.bps, fmt.bps + 1]
    raise ValueError(f"channel code {code}")


# -------------------------------------------------------------- Rice

@dataclass
class RicePlan:
    bits: int            # with the 2-bit method and 4-bit order fields
    porder: int
    width: int           # parameter field width, 4 or 5
    params: list         # per partition (escaped, k or raw size)


def rice_optimum(zz: np.ndarray, order: int, fmt: Format) -> RicePlan:
    """The least partitioned Rice code of ``zz`` (int64 ``[n]``, zeros at
    ``i < order``) over what the configuration states: partition orders
    of ``fmt.porders`` whose partitions exceed the order (the requested
    ones first), parameters up to 14 (4-bit field) or ``kmax`` (5-bit),
    every code at most 32 bits, and where ``fmt.escapes``, escaped
    partitions of ``bitlen(max) >= 1`` raw bits.  The lowest order,
    the 4-bit field and the lowest parameter win ties."""
    n = len(zz)
    kmax = fmt.kmax
    ks = np.arange(kmax + 1, dtype=np.int64)
    max_po = max(fmt.porders)
    fine = zz.reshape(1 << max_po, n >> max_po)
    s_fine = np.stack([(fine >> k).sum(1) for k in ks], 1)
    m_fine = fine.max(1)
    preferred = set(fmt.partition_orders)
    best = None
    for pass_ in (True, False):
        for po in fmt.porders:
            if (po in preferred) != pass_:
                continue
            psize = n >> po
            if psize <= order:
                continue
            span = 1 << (max_po - po)
            s = s_fine.reshape(1 << po, span, -1).sum(1)
            m = m_fine.reshape(1 << po, span).max(1)
            cnt = np.full(1 << po, psize, np.int64)
            cnt[0] -= order
            cost = s + (ks + 1)[None] * cnt[:, None]
            ok = (m[:, None] >> ks) + ks + 1 <= 32
            cost = np.where(ok, cost, INF)
            e = np.maximum(bit_length(m), 1)
            esc = np.where(e <= 31, 5 + e * cnt, INF) if fmt.escapes \
                else np.full(len(m), INF)
            for width, kcap in ((4, min(kmax, 14)), (5, kmax)):
                c = cost[:, :kcap + 1]
                kbest, cmin = c.argmin(1), c.min(1)
                use_esc = esc < cmin
                part = np.where(use_esc, esc, cmin)
                if (part >= INF).any():
                    continue
                total = 6 + int((width + part).sum())
                if best is None or total < best.bits:
                    best = RicePlan(total, po, width, [
                        (bool(u), int(ee if u else kk))
                        for u, ee, kk in zip(use_esc, e, kbest)])
        if best is not None:
            return best
    raise ValueError("no partitioned Rice code fits this residual")


def estimate_bits(zz_sum, count, kmax: int):
    """The encoder's ranking estimate: ``k = floor(log2(mean))``, size
    ``(sum >> k) + (k + 1) * count``."""
    zz_sum = np.asarray(zz_sum, np.int64)
    count = np.maximum(np.asarray(count, np.int64), 1)
    mean = zz_sum.astype(np.float64) / count
    k = np.clip(np.floor(np.log2(np.maximum(mean, 1.0))), 0, kmax) \
        .astype(np.int64)
    return (zz_sum >> k) + (k + 1) * count


# ---------------------------------------------------------- analysis

def autocorrelation(x: np.ndarray, win: np.ndarray, max_lag: int,
                    precision: str) -> np.ndarray:
    """Lags ``0..max_lag`` of ``x * win`` over ``n - 1`` products each
    (the last sample dropped): ``"f32"`` windowed samples and products in
    f32, sums in f64; ``"bf16"`` (the control) each in bfloat16, sums in
    f32.  Returns f64 ``[V, max_lag + 1]``."""
    n = x.shape[-1]
    if precision == "f32":
        w = x.astype(np.float32) * win.astype(np.float32)
        cols = [(w[:, :n - lag - 1] * w[:, lag:n - 1]).sum(
            -1, dtype=np.float64) for lag in range(max_lag + 1)]
    elif precision == "bf16":
        w = bf16(bf16(x.astype(np.float32)) * bf16(win.astype(np.float32)))
        cols = [bf16(w[:, :n - lag - 1] * w[:, lag:n - 1]).sum(
            -1, dtype=np.float32).astype(np.float64)
            for lag in range(max_lag + 1)]
    else:
        raise ValueError(f"analysis precision {precision!r}")
    return np.stack(cols, -1)


def levinson(autoc: np.ndarray, p: int):
    """Every order's analysis polynomial ``a[1:]`` ``[V, p, p]``, error
    power ``[V, p]`` and validity ``[V, p]`` (the recursion stops once the
    error is not positive)."""
    v = autoc.shape[0]
    pos = np.arange(p + 1)
    a = np.zeros((v, p + 1))
    a[:, 0] = 1.0
    err = autoc[:, 0].copy()
    ok = np.ones(v, bool)
    hist_a, hist_e, hist_ok = [], [], []
    with np.errstate(all="ignore"):
        for k in range(p):
            rev = np.clip(k + 1 - pos, 0, p)
            ok = ok & (err > 0.0)
            lam = -(a * autoc[:, rev]).sum(-1) / np.where(err > 0.0, err,
                                                            1.0)
            lam = np.where(ok, lam, 0.0)
            a = a + lam[:, None] * a[:, rev] * (pos <= k + 1)
            err = err * (1.0 - lam * lam)
            hist_a.append(a)
            hist_e.append(err)
            hist_ok.append(ok)
    taps = np.stack(hist_a, -2)[..., 1:]
    valid = np.stack(hist_ok, -1) & np.isfinite(taps).all(-1)
    return taps, np.stack(hist_e, -1), valid


def quantize(coefs: np.ndarray, precision: int):
    """libFLAC's quantization of every order's predictor ``[V, p, p]``:
    shift ``precision - floor(log2(max|c|)) - 2`` in -32..15 (written as
    at least 0), round half to even with the error carried forward."""
    p = coefs.shape[-1]
    with np.errstate(all="ignore"):
        cmax = np.abs(coefs).max(-1)
        finite = np.isfinite(cmax) & (cmax > 0.0)
        safe = np.where(finite, cmax, 1.0)
        shift = precision - np.floor(np.log2(safe)).astype(np.int64) - 2
        shift = np.clip(shift, -32, 15)
        scale = np.exp2(shift.astype(np.float64))
        qmax, qmin = (1 << (precision - 1)) - 1, -(1 << (precision - 1))
        err = np.zeros(coefs.shape[:-1])
        qs = []
        for t in range(p):
            err = err + coefs[..., t] * scale
            q = np.clip(np.round(err), qmin, qmax)
            err = err - q
            qs.append(np.nan_to_num(q).astype(np.int64))
    q = np.stack(qs, -1)
    q = np.where(np.arange(p)[None, :] < np.arange(1, p + 1)[:, None], q, 0)
    return q, np.maximum(shift, 0), finite


@dataclass
class Subframe:
    kind: str
    order: int = 0
    coefs: tuple = ()
    shift: int = 0
    plan: RicePlan | None = None

    def key(self) -> tuple:
        """What the analysis chose, for comparison."""
        if self.kind in ("constant", "verbatim"):
            return (self.kind,)
        return (self.kind, self.order, tuple(self.coefs), self.shift)


def choose(pcm: np.ndarray, fmt: Format, precision: str | None = None):
    """The encoder's choices for one frame ``pcm [C, n]`` under the
    estimate order search: ``(channel code, [Subframe per channel])``.

    Per virtual channel: the fixed order of least estimated size from
    exact difference sums; every LPC order from the windowed
    autocorrelation (``precision``, default the configuration's), all-order
    Levinson and quantization, ranked by the Levinson error's size
    estimate; the best order's exact residual statistics against the
    fixed order; verbatim and constant.  The stereo mode of least summed
    estimate; then the chosen predictors' exact Rice plans, and verbatim
    where that is smaller."""
    precision = precision or fmt.analysis
    n, p, prec, kmax = (fmt.block_size, fmt.max_lpc_order,
                        fmt.qlp_precision, fmt.kmax)
    xv, bps_list = virtual_channels(pcm, fmt)
    bps_v = np.asarray(bps_list, np.int64)
    nv = len(xv)

    fixed_est = []
    for o in range(5):
        zsum = zigzag(np.diff(xv, n=o, axis=-1) if o else xv).sum(-1)
        fixed_est.append(estimate_bits(zsum, n - o, kmax) + 8 + o * bps_v)
    fixed_est = np.stack(fixed_est, -1)
    fixed_bits = fixed_est.min(-1)
    fixed_order = fixed_est.argmin(-1)

    lpc_bits = np.full(nv, INF, np.int64)
    lpc_pick = [None] * nv
    if p:
        win = window(fmt.window, n)
        autoc = autocorrelation(xv, win, p, precision)
        taps, err, valid_ld = levinson(autoc, p)
        q, shifts, valid_q = quantize(-taps, prec)
        valid = valid_ld & valid_q
        win_pow = float(np.mean(win ** 2))
        lorders = np.arange(1, p + 1, dtype=np.int64)
        lcounts = n - lorders
        with np.errstate(all="ignore"):
            sigma = np.sqrt(np.maximum(err, 0.0) / (n * win_pow))
            mean_abs = math.sqrt(2.0 / math.pi) * sigma
            lzz = (2.0 * mean_abs * lcounts.astype(np.float64))
            lzz = np.where(np.isfinite(lzz), lzz, 0).astype(np.int64)
        lest = (estimate_bits(lzz, lcounts[None], kmax) + 8
                + lorders[None] * bps_v[:, None] + 9 + lorders[None] * prec)
        lest = np.where(valid, lest, INF)
        lo0 = lest.argmin(-1)
        for v in range(nv):
            o = int(lo0[v]) + 1
            coefs = tuple(int(c) for c in q[v, o - 1, :o])
            sh = int(shifts[v, o - 1])
            r = residual(xv[v], "lpc", o, coefs, sh)
            bits = (int(estimate_bits(zigzag(r).sum(), n - o, kmax)) + 8
                    + o * int(bps_v[v]) + 9 + o * prec)
            ok = bool(valid[v, o - 1])
            if fmt.bps <= 24:
                ok = ok and int(np.abs(r).max(initial=0)) < (1 << 30)
            if ok:
                lpc_bits[v] = bits
            lpc_pick[v] = (o, coefs, sh)
    pred_is_lpc = lpc_bits < fixed_bits
    pred_bits = np.minimum(fixed_bits, lpc_bits)
    const_ok = (xv == xv[:, :1]).all(-1)
    const_bits = np.where(const_ok, 8 + bps_v, INF)
    cost = np.minimum(np.minimum(pred_bits, 8 + n * bps_v), const_bits)

    if fmt.stereo_modes:
        mode = int(np.argmin([cost[a] + cost[b]
                              for _, (a, b) in STEREO_MODES]))
        code, sel = STEREO_MODES[mode][0], STEREO_MODES[mode][1]
    else:
        code, sel = fmt.channels - 1, tuple(range(nv))

    out = []
    for v in sel:
        bps = int(bps_v[v])
        if const_ok[v]:
            out.append(Subframe("constant"))
            continue
        if pred_is_lpc[v]:
            o, coefs, sh = lpc_pick[v]
            sf = Subframe("lpc", o, coefs, sh)
            head = 9 + o * prec
        else:
            o = int(fixed_order[v])
            sf = Subframe("fixed", o)
            head = 0
        r = residual(xv[v], sf.kind, sf.order, sf.coefs, sf.shift)
        zz = np.concatenate([np.zeros(sf.order, np.int64), zigzag(r)])
        sf.plan = rice_optimum(zz, sf.order, fmt)
        pred_total = 8 + sf.order * bps + head + sf.plan.bits
        out.append(Subframe("verbatim") if 8 + n * bps < pred_total
                   else sf)
    return code, out


# ----------------------------------------------------------- writing

def coded_number(v: int) -> bytes:
    """UTF-8-like coded frame number (RFC 9639, 9.1.5)."""
    if v < 0x80:
        return bytes([v])
    for size, cap in ((2, 11), (3, 16), (4, 21), (5, 26), (6, 31), (7, 36)):
        if v < (1 << cap):
            tail = []
            for _ in range(size - 1):
                tail.append(0x80 | (v & 0x3F))
                v >>= 6
            return bytes([((0xFF << (8 - size)) & 0xFF) | v] + tail[::-1])
    raise ValueError("frame number too large")


def header_bytes(fmt: Format, index: int, code: int,
                 bs_code: int | None = None, rate_code: int = 0,
                 size_code: int = 0) -> bytes:
    """A fixed-blocking frame header with its CRC-8; ``rate_code`` and
    ``size_code`` 0 take rate and width from STREAMINFO."""
    n = fmt.block_size
    if bs_code is None:
        bs_code = BLOCK_CODES.get(n, 6 if n <= 256 else 7)
    out = bytearray([0xFF, 0xF8, (bs_code << 4) | rate_code,
                     (code << 4) | (size_code << 1)])
    out += coded_number(index)
    if bs_code == 6:
        out.append(n - 1)
    elif bs_code == 7:
        out += (n - 1).to_bytes(2, "big")
    if rate_code == 12:
        out.append(fmt.sample_rate // 1000)
    elif rate_code == 13:
        out += fmt.sample_rate.to_bytes(2, "big")
    elif rate_code == 14:
        out += (fmt.sample_rate // 10).to_bytes(2, "big")
    out.append(crc8(bytes(out)))
    return bytes(out)


def write_subframe(w: BitWriter, x: np.ndarray, bps: int, sf: Subframe,
                   prec: int, wasted: int = 0) -> None:
    code = {"constant": 0, "verbatim": 1}.get(sf.kind)
    if code is None:
        code = 8 + sf.order if sf.kind == "fixed" else 32 + sf.order - 1
    w.put((code << 1) | (wasted > 0), 8)
    if wasted:
        w.put(1, wasted)
        x = np.asarray(x, np.int64) >> wasted
        bps -= wasted
    if sf.kind == "constant":
        w.put_array(x[:1], bps)
        return
    if sf.kind == "verbatim":
        w.put_array(x, bps)
        return
    w.put_array(x[:sf.order], bps)
    if sf.kind == "lpc":
        w.put(prec - 1, 4)
        w.put(sf.shift, 5)
        w.put_array(np.asarray(sf.coefs, np.int64), prec)
    r = residual(x, sf.kind, sf.order, sf.coefs, sf.shift)
    plan = sf.plan
    w.put(plan.width - 4, 2)
    w.put(plan.porder, 4)
    psize = len(x) >> plan.porder
    lo = 0
    for i, (esc, k) in enumerate(plan.params):
        hi = (i + 1) * psize - sf.order
        part = r[lo:hi]
        lo = hi
        if esc:
            w.put((1 << plan.width) - 1, plan.width)
            w.put(k, 5)
            w.put_array(part, k)
        else:
            w.put(k, plan.width)
            w.put_rice(zigzag(part), k)


def write_frame(pcm: np.ndarray, fmt: Format, index: int, code: int,
                subframes: list, bs_code: int | None = None,
                rate_code: int = 0, size_code: int = 0,
                wasted: list | None = None) -> bytes:
    """A whole frame: header, subframes, zero padding, CRC-16."""
    w = BitWriter()
    w.put_bytes(header_bytes(fmt, index, code, bs_code, rate_code,
                             size_code))
    signals, widths = channel_signals(pcm, fmt, code)
    for c, (x, bps, sf) in enumerate(zip(signals, widths, subframes)):
        write_subframe(w, x, bps, sf, fmt.qlp_precision,
                       wasted[c] if wasted else 0)
    body = w.to_bytes()
    return body + crc16(body).to_bytes(2, "big")


def stream_bytes(frames, fmt: Format, total_samples: int) -> bytes:
    """``fLaC``, one STREAMINFO block (no MD5), then ``frames``."""
    frames = list(frames)
    sizes = [len(f) for f in frames] or [0]
    n = fmt.block_size
    info = bytearray()
    info += n.to_bytes(2, "big") + n.to_bytes(2, "big")
    info += min(sizes).to_bytes(3, "big") + max(sizes).to_bytes(3, "big")
    packed = ((fmt.sample_rate << 44) | ((fmt.channels - 1) << 41)
              | ((fmt.bps - 1) << 36) | total_samples)
    info += packed.to_bytes(8, "big") + bytes(16)
    return b"fLaC" + bytes([0x80, 0, 0, 34]) + bytes(info) + b"".join(frames)


# ----------------------------------------------------------- reading

@dataclass
class FrameFields:
    index: int
    code: int
    bs_code: int
    rate_code: int
    size_code: int
    subframes: list      # Subframe (with its plan) per channel
    wasted: list
    length: int          # bytes of the frame as its fields say


def _read_header(r: BitReader, fmt: Format):
    if r.read(16) != 0xFFF8:
        raise ValueError("no fixed-blocking sync code")
    bs_code, rate_code = r.read(4), r.read(4)
    code, size_code, reserved = r.read(4), r.read(3), r.read(1)
    first = r.read(8)
    ones = 0
    while ones < 8 and first & (0x80 >> ones):
        ones += 1
    if ones == 1 or ones == 8:
        raise ValueError("bad coded number")
    index = first & ((0x80 >> ones) - 1) if ones else first
    for _ in range(max(ones - 1, 0)):
        byte = r.read(8)
        if byte >> 6 != 2:
            raise ValueError("bad coded number")
        index = (index << 6) | (byte & 0x3F)
    if bs_code == 6:
        n = r.read(8) + 1
    elif bs_code == 7:
        n = r.read(16) + 1
    else:
        n = {v: k for k, v in BLOCK_CODES.items()}.get(bs_code)
    extra = {12: 8, 13: 16, 14: 16}.get(rate_code, 0)
    r.read(extra)
    head_len = r.pos >> 3
    if r.read(8) != crc8(r.data[:head_len]):
        raise ValueError("CRC-8 mismatch")
    if n != fmt.block_size or reserved or code > 10 or rate_code == 15 \
            or rate_code not in (0, RATE_CODES.get(fmt.sample_rate, 12),
                                 12, 13, 14) \
            or size_code not in (0, SIZE_CODES.get(fmt.bps, 0)):
        raise ValueError("frame header disagrees with the format")
    if (code < 8 and code + 1 != fmt.channels) or \
            (code >= 8 and fmt.channels != 2):
        raise ValueError("channel code disagrees with the format")
    return index, code, bs_code, rate_code, size_code


def _read_subframe_head(r: BitReader, bps: int, prec_cap: int = 15):
    if r.read(1):
        raise ValueError("subframe padding bit set")
    t = r.read(6)
    wasted = 0
    if r.read(1):
        wasted = 1
        while not r.read(1):
            wasted += 1
    bps -= wasted
    if t == 0:
        return Subframe("constant"), wasted, bps, [r.signed(bps)]
    if t == 1:
        return Subframe("verbatim"), wasted, bps, None
    if 8 <= t <= 12:
        o = t - 8
        warm = [r.signed(bps) for _ in range(o)]
        return Subframe("fixed", o), wasted, bps, warm
    if t >= 32:
        o = t - 31
        warm = [r.signed(bps) for _ in range(o)]
        prec = r.read(4) + 1
        if prec > prec_cap:
            raise ValueError("bad coefficient precision")
        shift = r.signed(5)
        if shift < 0:
            raise ValueError("negative LPC shift")
        coefs = tuple(r.signed(prec) for _ in range(o))
        sf = Subframe("lpc", o, coefs, shift)
        sf.precision = prec
        return sf, wasted, bps, warm
    raise ValueError(f"reserved subframe type {t}")


def read_fields(frame: bytes, fmt: Format, pcm: np.ndarray) -> FrameFields:
    """Every field of ``frame``, its residuals skipped by the lengths the
    input PCM's residuals give them (a frame that is not an encoding of
    ``pcm`` fails here or in :func:`check_frame`'s comparison)."""
    r = BitReader(frame)
    index, code, bs_code, rate_code, size_code = _read_header(r, fmt)
    signals, widths = channel_signals(pcm, fmt, code)
    subs, wasted = [], []
    n = fmt.block_size
    for x, bps in zip(signals, widths):
        sf, w, bps_w, _ = _read_subframe_head(r, bps)
        wasted.append(w)
        x = np.asarray(x, np.int64) >> w
        if sf.kind == "verbatim":
            r.pos += n * bps_w
        elif sf.kind in ("fixed", "lpc"):
            res = residual(x, sf.kind, sf.order, sf.coefs, sf.shift)
            start = r.pos
            width = 4 + r.read(2)
            if width > 5:
                raise ValueError("reserved residual coding method")
            porder = r.read(4)
            psize = n >> porder
            if psize << porder != n or psize < sf.order:
                raise ValueError("bad partition order")
            params, lo = [], 0
            for i in range(1 << porder):
                hi = (i + 1) * psize - sf.order
                part = res[lo:hi]
                lo = hi
                k = r.read(width)
                if k == (1 << width) - 1:
                    e = r.read(5)
                    params.append((True, e))
                    r.pos += e * len(part)
                else:
                    params.append((False, k))
                    r.pos += int(((zigzag(part) >> k) + 1 + k).sum())
            sf.plan = RicePlan(r.pos - start, porder, width, params)
        subs.append(sf)
    length = ((r.pos + 7) >> 3) + 2
    if length > len(frame):
        raise EOFError("frame shorter than its fields")
    return FrameFields(index, code, bs_code, rate_code, size_code, subs,
                       wasted, length)


def check_frame(frame: bytes, fmt: Format, pcm: np.ndarray, index: int):
    """Hold one frame against its input PCM ``[C, n]`` and frame number.

    Returns ``(fields or None, reason or None)``: the reason is set when
    the frame is not, byte for byte, the FLAC frame that its own choices
    make of ``pcm`` (header, CRC-8, every subframe, padding, CRC-16)."""
    try:
        f = read_fields(frame, fmt, pcm)
        prec = {getattr(s, "precision", fmt.qlp_precision)
                for s in f.subframes if s.kind == "lpc"}
        if prec - {fmt.qlp_precision}:
            return f, f"coefficient precision {sorted(prec)}"
        want = write_frame(pcm, fmt, f.index, f.code, f.subframes,
                           f.bs_code, f.rate_code, f.size_code, f.wasted)
    except (ValueError, EOFError, IndexError) as e:
        return None, f"unreadable: {e}"
    if f.index != index:
        return f, f"frame number {f.index}, expected {index}"
    if frame != want:
        if len(frame) != len(want):
            return f, f"{len(frame)} bytes, expected {len(want)}"
        at = next(i for i in range(len(want)) if frame[i] != want[i])
        return f, f"byte {at} of {len(want)} differs"
    return f, None


# ---------------------------------------------------------- decoding

def _narrow(kind: str | None):
    """The arithmetic of the decoder: exact (None), or wrapped to int16,
    or rounded to f32 (the controls)."""
    if kind is None:
        return None
    if kind == "int16":
        return lambda v: ((int(v) + 0x8000) & 0xFFFF) - 0x8000
    if kind == "f32":
        def f32(v):
            with np.errstate(over="ignore"):      # the IIR may diverge
                return float(np.float32(v))
        return f32
    raise ValueError(f"decoder arithmetic {kind!r}")


def _rice_decode(data: bytes, nxt: list, r: BitReader, count: int,
                 k: int) -> list:
    out = []
    pos = r.pos
    mask = (1 << k) - 1
    for _ in range(count):
        stop = nxt[pos]
        if stop < 0:
            raise EOFError("unterminated Rice code")
        q = stop - pos
        pos = stop + 1
        if k:
            b0, b1 = pos >> 3, (pos + k + 7) >> 3
            low = (int.from_bytes(data[b0:b1], "big")
                   >> ((b1 << 3) - pos - k)) & mask
            pos += k
        else:
            low = 0
        u = (q << k) | low
        out.append((u >> 1) ^ -(u & 1))
    r.pos = pos
    return out


def decode_frame(frame: bytes, fmt: Format, arithmetic: str | None = None,
                 ) -> np.ndarray:
    """Decode one frame to ``[C, n]`` int64 PCM, its CRC-16 checked.
    ``arithmetic`` narrows the prediction sums, samples and side channel
    (``"int16"``, ``"f32"``; the controls)."""
    narrow = _narrow(arithmetic)
    r = BitReader(frame)
    _, code, _, _, _ = _read_header(r, fmt)
    # the next set bit at or after each bit position, -1 past the last
    ones = np.flatnonzero(np.unpackbits(np.frombuffer(frame, np.uint8)))
    if len(ones):
        at = np.searchsorted(ones, np.arange(8 * len(frame) + 1))
        nxt = np.where(at < len(ones), ones[np.minimum(at, len(ones) - 1)],
                       -1).tolist()
    else:
        nxt = [-1] * (8 * len(frame) + 1)
    n = fmt.block_size
    widths = ([fmt.bps] * fmt.channels if code < 8 else
              {8: [fmt.bps, fmt.bps + 1], 9: [fmt.bps + 1, fmt.bps],
               10: [fmt.bps, fmt.bps + 1]}[code])
    chans = []
    for bps in widths:
        sf, w, bps_w, warm = _read_subframe_head(r, bps)
        if sf.kind == "constant":
            x = warm * n
        elif sf.kind == "verbatim":
            x = [r.signed(bps_w) for _ in range(n)]
        else:
            width = 4 + r.read(2)
            porder = r.read(4)
            psize = n >> porder
            res = []
            for i in range(1 << porder):
                cnt = psize - (sf.order if i == 0 else 0)
                k = r.read(width)
                if k == (1 << width) - 1:
                    e = r.read(5)
                    res += [r.signed(e) for _ in range(cnt)]
                else:
                    res += _rice_decode(frame, nxt, r, cnt, k)
            taps = FIXED_TAPS[sf.order] if sf.kind == "fixed" else sf.coefs
            x = _reconstruct(list(warm), res, taps, sf.shift, narrow)
        chans.append(np.asarray(x, np.int64) << w)
    r.pos = (r.pos + 7) & ~7
    body = r.pos >> 3
    if r.read(16) != crc16(frame[:body]):
        raise ValueError("CRC-16 mismatch")
    a, b = chans
    if narrow is not None and code >= 8:
        a = np.asarray([narrow(v) for v in a], np.int64)
        b = np.asarray([narrow(v) for v in b], np.int64)
    if code == 8:
        chans = [a, a - b]
    elif code == 9:
        chans = [a + b, b]
    elif code == 10:
        mid = (a << 1) | (b & 1)
        chans = [(mid + b) >> 1, (mid - b) >> 1]
    out = np.stack(chans)
    if narrow is not None:
        out = np.vectorize(narrow, otypes=[np.float64])(out).astype(np.int64)
    return out


def _reconstruct(x: list, res: list, taps, shift: int, narrow) -> list:
    """x[i] = res[i] + (sum_j taps[j] * x[i-1-j] >> shift), sequentially
    (``narrow`` applied to each partial sum and sample)."""
    o = len(taps)
    rev = list(taps)[::-1]
    if narrow is None:
        for e in res:
            x.append(e + (sum(map(operator.mul, rev, x[-o:])) >> shift)
                     if o else e)
        return x
    for e in res:
        acc = 0
        for c, v in zip(rev, x[-o:]):
            acc = narrow(acc + narrow(c * v))
        x.append(narrow(e + (math.floor(acc) >> shift)))
    return x
