"""Batched FLAC decoder on PyTorch and CUDA.

Three phases, the port of the JAX package's ``decoder.py``:

1. **Frame boundary scan** (host, C++): candidate frame starts are byte
   positions matching the 14-bit sync pattern whose header parses and
   whose CRC-8 matches, a ~2^-30 false-positive filter; candidates are
   chained by their coded frame numbers.  No residual decoding is needed
   to find boundaries.
2. **Structure walk** (host, C++, threaded across frames): every frame's
   headers, warm-up samples and coefficients, and a checkpoint of the
   residual bit cursor every 64 samples (``flacx_torch.native``).
3. **Device decode** (:func:`_device_decode`): the ``bit_unpack`` kernel
   decodes every 64-sample chunk's symbols in parallel, the
   ``reconstruct`` kernel rebuilds the samples (IIR, wasted bits, stereo
   undecorrelation, interleave) and the ``crc16_rows`` kernel checks every
   frame's CRC-16, with no host sync between them.

A batch whose device decode flags an error or a CRC mismatch takes the
host route (the C++ full parse, then ``reconstruct``), then the strict
sequential oracle; the short final frame and small variable-blocking
groups go through the oracle.  ``stats`` (a dict) counts every batch by
route: ``device``, ``host``, ``sequential`` (whole streams or windows
decoded by the oracle), and ``oracle_frames``.

``device`` is the torch device (the card by default, raising without
CUDA); ``oracle=True`` is the JAX package's ``device=False``.  Malformed
input of any shape raises :class:`FlacFormatError`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

import flacx_torch.coded_number as _cn
from flacx_torch import trace
from flacx_torch.bitio import BitReader
from flacx_torch.device import on_device
from flacx_torch.format import MAGIC, MetadataBlockType, Streaminfo
from flacx_torch.kernels.bit_unpack import bit_unpack
from flacx_torch.kernels.crc16_rows import crc16_rows
from flacx_torch.kernels.reconstruct import (reconstruct, residual_limit,
                                             tap_bucket)
from flacx_torch.native import crc16_rows as host_crc16_rows
from flacx_torch.native import scan_candidates, scan_frames, scatter_rows
from flacx_torch.oracle.decoder import (FlacFormatError, read_frame,
                                        read_metadata_header,
                                        read_streaminfo)
from flacx_torch.parallel.mesh import home_device

#: minimum host core count for the walker's inline-IIR sample state (the
#: chunk route of ``reconstruct``): the walker threads across rows, so
#: with enough cores the extra serial cost vanishes, while on a thin host
#: it would throttle the whole pipeline
CHUNK_STATE_MIN_CORES = 4

#: smallest same-block-size frame group worth a device batch in the
#: variable-blocking path; smaller groups go through the oracle
VAR_MIN_GROUP = 8


def _count(stats: dict | None, route: str, k: int = 1) -> None:
    if stats is not None:
        stats[route] = stats.get(route, 0) + k


def parse_stream_header(data: bytes) -> tuple[Streaminfo, int]:
    """Parse magic + metadata blocks; return (streaminfo, first frame byte)."""
    r = BitReader(data)
    if r.read_bytes(4) != MAGIC:
        raise FlacFormatError("not a FLAC stream")
    streaminfo = None
    while True:
        header = read_metadata_header(r)
        if header.type == MetadataBlockType.Streaminfo:
            streaminfo = read_streaminfo(r)
        else:
            r.read_bytes(header.length)
        if header.last:
            break
    if streaminfo is None:
        raise FlacFormatError("missing streaminfo")
    return streaminfo, r.bit_position // 8


#: coded-number continuation-byte count for each possible lead byte
_CN_EXTRA = np.array([_cn.following_bytes(b) for b in range(256)], np.int64)


def _span_crc16(arr: np.ndarray, lo: int, hi: int) -> int:
    """CRC-16 of ``arr[lo:hi]`` (the native table walk: candidate spans
    are whole frames, up to hundreds of KB)."""
    return int(host_crc16_rows(arr[lo:max(lo, hi)][None, :],
                               np.array([max(0, hi - lo)]))[0])


def _scan_frame_chain(data: bytes, first: int
                      ) -> tuple[np.ndarray, np.ndarray, bool]:
    """Find frame boundaries via sync + CRC-8 candidate filtering.

    Returns ``(offsets, block_sizes, ambiguous)``: byte offsets of
    validated frame headers in ascending order, each frame's block size
    (decoded from its own header), and whether any boundary had to be
    picked heuristically (a duplicated coded number that CRC-16 of the
    previous frame span could not uniquely resolve) — callers that skip
    CRC verification must re-enable it for such scans.

    Survivors of the candidate scan are chained by their coded
    frame/sample numbers: fixed blocking counts frames (+1), variable
    blocking counts samples (+ the frame's own block size).  The first
    frame may carry any starting number.
    """
    with trace.span("decode.scan"):
        arr = np.frombuffer(data, np.uint8)
        offs, nums, strats, bss = scan_candidates(arr, first)
        empty = np.asarray([], np.int64)
        if not offs.size:
            return empty, empty, False

        # one blocking strategy per stream (RFC 9639): the first (genuine)
        # frame's bit is authoritative and candidates carrying the other bit
        # are false syncs
        strategy = int(strats[0])
        keep = strats == strategy
        offs, nums, bss = offs[keep], nums[keep], bss[keep]
        step = bss if strategy == 1 else np.ones_like(bss)

        # fast path (the overwhelmingly common shape): every survivor is a
        # real boundary — numbers form exactly the stride chain
        if offs.size and bool(np.all(nums[1:] == nums[:-1] + step[:-1])):
            return offs, bss, False

        trace.count("decode.scan_ambiguous")
        by_num: dict[int, list[tuple[int, int]]] = {}
        for off, num, bs in zip(offs.tolist(), nums.tolist(), bss.tolist()):
            by_num.setdefault(num, []).append((off, bs))

        # A CRC-8-passing false sync whose junk coded number collides with a
        # real frame number is resolved locally: the true boundary is the
        # candidate that closes the PREVIOUS frame with a valid CRC-16 (first
        # frame: the stream's first payload byte).  A surviving wrong pick is
        # still caught by the batch CRC-16 check, which falls back to the
        # sequential decoder — exactness never depends on this scan.
        chain: list[int] = []
        chain_bs: list[int] = []
        ambiguous = False
        expected = int(nums[0])
        last_off = first - 1
        while True:
            alts = [ob for ob in by_num.get(expected, []) if ob[0] > last_off]
            if not alts:
                break
            if len(alts) > 1:
                if chain:
                    prev = chain[-1]
                    good = [(o, b) for o, b in alts
                            if _span_crc16(arr, prev, o - 2)
                            == int.from_bytes(data[o - 2:o], "big")]
                else:
                    good = [(o, b) for o, b in alts if o == first]
                if len(good) != 1:
                    ambiguous = True
                alts = good or alts
            off, bs = alts[0]
            chain.append(off)
            chain_bs.append(bs)
            last_off = off
            expected += bs if strategy == 1 else 1
        return (np.asarray(chain, np.int64), np.asarray(chain_bs, np.int64),
                ambiguous)


def _scan_frame_offsets(data: bytes, first: int) -> tuple[np.ndarray, bool]:
    """Offsets + ambiguity of :func:`_scan_frame_chain`."""
    offsets, _, ambiguous = _scan_frame_chain(data, first)
    return offsets, ambiguous


def scan_frame_offsets(data: bytes, first: int) -> np.ndarray:
    """Byte offsets of every frame of ``data`` from ``first`` on."""
    return _scan_frame_offsets(data, first)[0]


def _scan_frame_chain_full(data: bytes, first: int):
    """(offsets, numbers, strategies, block_sizes) of the resolved chain
    — chain offsets joined back to their candidate-scan fields."""
    arr = np.frombuffer(data, np.uint8)
    offs, nums, strats, _ = scan_candidates(arr, first)
    chain, chain_bs, _ = _scan_frame_chain(data, first)
    if not chain.size:
        e = np.asarray([], np.int64)
        return e, e, e, e
    idx = np.searchsorted(offs, chain)
    return chain, nums[idx], strats[idx], chain_bs


def frame_headers(data: bytes) -> dict:
    """Per-frame header metadata of a whole stream (vectorized).

    Returns a dict of equal-length numpy arrays: ``offset`` (byte
    position), ``number`` (coded frame/sample number),
    ``blocking_strategy`` (0 fixed / 1 variable), ``block_size``,
    ``sample_rate``, ``bps`` (streaminfo-resolved) and ``channel_code``
    (raw 4-bit field).
    """
    from flacx_torch.format import (SAMPLE_RATE_DECODING,
                                    SAMPLE_RATE_FROM_STREAMINFO,
                                    SAMPLE_RATE_UNCOMMON8_KHZ,
                                    SAMPLE_RATE_UNCOMMON16_DAHZ,
                                    SAMPLE_RATE_UNCOMMON16_HZ,
                                    SAMPLE_SIZE_DECODING)

    streaminfo, first = parse_stream_header(data)
    offsets, numbers, strategies, block_sizes = \
        _scan_frame_chain_full(data, first)
    arr = np.frombuffer(data, np.uint8)
    last = len(arr) - 1
    code = arr[np.minimum(offsets + 2, last)]
    sr_code = (code & 0xF).astype(np.int64)
    chsz = arr[np.minimum(offsets + 3, last)]
    ch_code = (chsz >> 4).astype(np.int64)
    sz_code = ((chsz >> 1) & 7).astype(np.int64)

    # uncommon-form rate bytes sit after the coded number and any
    # uncommon block-size bytes
    b0 = arr[np.minimum(offsets + 4, last)].astype(np.int64)
    extra = _CN_EXTRA[b0]
    bs_code = (code >> 4).astype(np.int64)
    bs_extra = np.where(bs_code == 0b0110, 1,
                        np.where(bs_code == 0b0111, 2, 0))
    rate_pos = offsets + 4 + extra + 1 + bs_extra
    r8 = arr[np.minimum(rate_pos, last)].astype(np.int64)
    r16 = (r8 << 8) | arr[np.minimum(rate_pos + 1, last)].astype(np.int64)

    rate_tab = np.zeros(16, np.int64)
    for k, v in SAMPLE_RATE_DECODING.items():
        rate_tab[k] = v
    rate = rate_tab[sr_code]
    rate = np.where(sr_code == SAMPLE_RATE_FROM_STREAMINFO,
                    streaminfo.sample_rate, rate)
    rate = np.where(sr_code == SAMPLE_RATE_UNCOMMON8_KHZ, r8 * 1000, rate)
    rate = np.where(sr_code == SAMPLE_RATE_UNCOMMON16_HZ, r16, rate)
    rate = np.where(sr_code == SAMPLE_RATE_UNCOMMON16_DAHZ, r16 * 10,
                    rate)

    size_tab = np.zeros(8, np.int64)
    for k, v in SAMPLE_SIZE_DECODING.items():
        size_tab[k] = v
    bps = size_tab[sz_code]
    bps = np.where(sz_code == 0, streaminfo.sample_size, bps)

    return {
        "offset": offsets,
        "number": numbers,
        "blocking_strategy": strategies,
        "block_size": block_sizes,
        "sample_rate": rate,
        "bps": bps,
        "channel_code": ch_code,
    }


def _upload(arrays: list[np.ndarray], dtype: torch.dtype,
            dev: torch.device) -> list[torch.Tensor]:
    """``arrays`` as tensors on ``dev``: for the card, one pinned staging
    buffer and one asynchronous copy (views of it come back)."""
    with trace.span("decode.upload"):
        if dev.type == "cpu":
            out = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
            trace.count("copy.h2d_bytes", sum(t.nbytes for t in out))
            return out
        sizes = [a.size for a in arrays]
        buf = torch.empty(sum(sizes), dtype=dtype, pin_memory=True)
        flat = buf.numpy()
        pos = 0
        for a, size in zip(arrays, sizes):
            flat[pos:pos + size] = a.reshape(-1)
            pos += size
        dbuf = buf.to(dev, non_blocking=True)
        trace.count("copy.h2d_bytes", buf.nbytes)
        out, pos = [], 0
        for a, size in zip(arrays, sizes):
            out.append(dbuf[pos:pos + size].view(a.shape))
            pos += size
        return out


#: the walker's int32 outputs the device decode takes, in upload order
_SCAN_I32 = ("channel_code", "kind", "order", "shift", "wasted", "po",
             "width", "taps", "ckpt_pos", "ckpt_param", "ckpt_esc",
             "ckpt_inesc")


def _device_decode(rows: torch.Tensor, lens: torch.Tensor, scan: dict,
                   n: int, bps: int, t: int, use_i32: bool,
                   verify_crc: bool, fixed_max: int | None, state_ss: int,
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rows → ``(pcm int32 [F, n, C], err, crc_ok)``, all on the rows'
    device, with no host sync: ``bit_unpack``, then ``reconstruct``, then
    ``crc16_rows``.  ``scan`` holds the walker's outputs as tensors."""
    with trace.span("decode.enqueue"):
        vals, err_a = bit_unpack(rows, scan["ckpt_pos"], scan["ckpt_param"],
                                 scan["ckpt_esc"], scan["ckpt_inesc"],
                                 scan["kind"], scan["order"], scan["po"],
                                 scan["width"], n)
        pcm, err_b = reconstruct(vals, scan["taps"], scan["shift"],
                                 scan["order"], scan["kind"], scan["wasted"],
                                 scan["warmup"], scan["const_val"],
                                 scan["channel_code"], scan.get("ckpt_state"),
                                 state_ss, t, use_i32,
                                 residual_limit(bps, use_i32), fixed_max)
        if verify_crc:
            crc_ok = crc16_rows(rows, lens)[1]
        else:
            crc_ok = torch.ones(1, dtype=torch.int32, device=rows.device)
        return pcm, err_a | err_b, crc_ok


def _state_interval(n: int) -> int:
    """The walker's sample-state interval (0: none, the serial route), at
    every sample width (int64 state past 31 bits): it pays only where host
    cores absorb the walker's inline IIR."""
    if (os.cpu_count() or 1) < CHUNK_STATE_MIN_CORES:
        return 0
    # 256 measured fastest on the JAX package's headline LPC-12 signal;
    # shorter blocks take an eighth of the block, at least 64
    ss = 256 if n >= 2048 else max(64, n // 8)
    return 0 if n <= ss else ss


def _decode_rows_device(rows: np.ndarray, lens: np.ndarray, n: int, c: int,
                        bps: int, verify_crc: bool, dev: torch.device,
                        rows_dev: torch.Tensor | None = None, sharding=None):
    """Device decode path: C++ structure walk + the three kernels.

    Returns ``(pcm, err, crc_ok)`` tensors (not synchronised), and raises
    ValueError on malformed streams.  ``rows_dev`` optionally supplies the
    row bytes already on the device.  Under ``sharding`` a batch whose
    frame count divides the mesh is split into one part a device, each
    part walked and launched in turn and the parts joined on the first
    part's device; any other batch decodes whole on ``dev`` (the mesh's
    first device), as in the JAX package.
    """
    f = rows.shape[0]
    if sharding is not None and f and sharding.divides(f):
        trips = []
        for part_dev, lo, hi in sharding.parts(f):
            with on_device(part_dev):
                trips.append(_decode_rows_device(
                    rows[lo:hi], lens[lo:hi], n, c, bps, verify_crc,
                    part_dev))
        home = trips[0][0].device
        return (torch.cat([t[0].to(home) for t in trips]),
                torch.cat([t[1].to(home) for t in trips]).amax(0, True),
                torch.cat([t[2].to(home) for t in trips]).amin(0, True))
    # start the rows' copy first: from pinned memory it is asynchronous,
    # so the bytes stream to the card while the walker runs
    if rows_dev is None:
        rows_dev, = _upload([rows], torch.uint8, dev)
    state_ss = _state_interval(n)
    with trace.span("decode.walk"):
        scan = scan_frames(rows, np.zeros(f, np.int64), n, c, bps,
                           state_interval=state_ss)

    # per-frame sample-size overrides (RFC 9639 frame headers): the walker
    # already parsed each frame at its own width; a uniform override
    # rekeys the batch on that width, a mixed batch decodes by width
    fb = scan.fbps
    if fb.size and not bool((fb == bps).all()):
        uniq = np.unique(fb)
        if uniq.size == 1:
            return _decode_rows_device(rows, lens, n, c, int(uniq[0]),
                                       verify_crc, dev, rows_dev)
        pcm_all = np.zeros((f, n, c), np.int32)
        for bval in uniq.tolist():
            idx = np.nonzero(fb == bval)[0]
            pcm, err, crc_ok = _decode_rows_device(
                np.ascontiguousarray(rows[idx]), lens[idx], n, c, int(bval),
                verify_crc, dev)
            if err.item() or not crc_ok.item():
                return pcm, err, crc_ok
            pcm_all[idx] = pcm.cpu().numpy()
        return (torch.from_numpy(pcm_all), torch.zeros(1, dtype=torch.int32),
                torch.ones(1, dtype=torch.int32))

    # batch-level routes (tiny host reductions over walker outputs): the
    # tap bucket, the int32 working type, and the all-fixed batch
    max_order = int(scan.order.max()) if scan.order.size else 0
    t = tap_bucket(max_order)
    sum_abs = int(np.abs(scan.taps).sum(-1).max()) if scan.taps.size else 0
    eff_max = bps + (1 if c == 2 else 0)
    use_i32 = eff_max + max(sum_abs, 1).bit_length() + 2 <= 31
    # all-fixed batches (constant, verbatim, fixed: shift 0, binomial
    # taps) take no sample state, as in the JAX package: the plain
    # version integrates them with cumsums, the kernel with block scans
    fixed_max = max_order if bool((scan.kind <= 2).all()) else None
    if fixed_max is not None:
        state_ss = 0

    # the sample state goes with the arrays of its width (int64 past 31
    # bits: native.wide_state), after the warm-up so that it starts on a
    # 256-byte boundary of the staging buffer
    state = ("ckpt_state",) if state_ss > 0 else ()
    wide = state_ss > 0 and scan.ckpt_state.dtype == np.int64
    names = _SCAN_I32 + (() if wide else state)
    names64 = ("warmup",) + (state if wide else ()) + ("const_val",)
    i32 = _upload([getattr(scan, k) for k in names]
                  + [lens.astype(np.int32)], torch.int32, dev)
    i64 = _upload([getattr(scan, k) for k in names64], torch.int64, dev)
    tensors = dict(zip(names, i32)) | dict(zip(names64, i64))
    # returned WITHOUT a sync: the caller reads the flags one batch later,
    # so the next batch's host walk overlaps this batch's device work
    return _device_decode(rows_dev, i32[-1], tensors, n, bps, t, use_i32,
                          verify_crc, fixed_max, state_ss)


def _decode_rows(rows: np.ndarray, n: int, c: int, bps: int,
                 dev: torch.device) -> np.ndarray:
    """Host route: the C++ full parse, then ``reconstruct`` (int64, the
    serial IIR over every tap) → int32 PCM ``[F, n, C]``."""
    from flacx_torch.hostdec import parse_frames

    f = rows.shape[0]
    p = parse_frames(rows, np.zeros(f, np.int64), n, c, bps)
    res = p.residual
    warm = np.zeros((f, c, 32), np.int64)
    warm[..., :min(32, n)] = res[..., :32]
    i32 = _upload([p.taps.astype(np.int32)]
                  + [a.astype(np.int32) for a in (p.shift, p.order, p.kind,
                                                  p.wasted)]
                  + [p.channel_code.astype(np.int32)], torch.int32, dev)
    vals, warm_t, const_t = _upload(
        [res, warm, np.ascontiguousarray(res[..., 0])], torch.int64, dev)
    taps, shift, order, kind, wasted, code = i32
    pcm, _ = reconstruct(vals, taps, shift, order, kind, wasted, warm_t,
                         const_t, code, None, 0, 32, False, -1)
    trace.count("copy.d2h_bytes", pcm.nbytes)
    return pcm.cpu().numpy()


def _ok(trip) -> bool:
    """Whether a device batch decoded cleanly (a sync: the flags' read)."""
    _, err, crc_ok = trip
    with trace.span("decode.fetch"):
        ok = (err == 0) & (crc_ok != 0)
        trace.count("copy.d2h_bytes", ok.nbytes)
        return bool(ok.item())


def _host_pcm(trip, c: int) -> np.ndarray:
    """A device batch's PCM on the host, ``[F·n, c]`` int32."""
    with trace.span("decode.fetch"):
        trace.count("copy.d2h_bytes", trip[0].nbytes)
        return trip[0].cpu().numpy().reshape(-1, c)


def _crc_rows_ok(rows: np.ndarray, lens: np.ndarray) -> bool:
    f = rows.shape[0]
    crcs = host_crc16_rows(rows, (lens - 2).astype(np.int32))
    stored = ((rows[np.arange(f), lens - 2].astype(np.uint16) << 8)
              | rows[np.arange(f), lens - 1])
    return bool(np.array_equal(crcs, stored.astype(np.uint16)))


def _decode_var_frames(data: bytes, streaminfo: Streaminfo,
                       offsets: np.ndarray, bsizes: np.ndarray,
                       ends_b: np.ndarray, batch_frames: int,
                       verify_crc: bool, dev: torch.device,
                       stats: dict | None, sharding=None,
                       ) -> np.ndarray | None:
    """Grouped batch decode of a chained set of variable-size frames.

    ``offsets``/``ends_b`` delimit each frame's bytes in ``data`` and
    ``bsizes`` carries each frame's block size.  Frames are grouped by
    block size; each group runs the device decode, its output scattered to
    each frame's sample position.  Small groups and sub-64-sample blocks
    go through the strict oracle frame decoder.  Returns int32 PCM
    ``[sum(bsizes), c]`` or ``None`` when a frame fails on every path.
    """
    c = streaminfo.channels
    bps = streaminfo.sample_size
    total = int(bsizes.sum())
    starts = np.concatenate([[0], np.cumsum(bsizes)[:-1]]).astype(np.int64)
    arr = np.frombuffer(data, np.uint8)
    out = np.zeros((total, c), np.int32)

    def oracle_frames(idx: np.ndarray) -> bool:
        for i in idx.tolist():
            r = BitReader(data[offsets[i]:ends_b[i]])
            try:
                _, planar = read_frame(r, bps, verify_crc=verify_crc)
            except (FlacFormatError, EOFError, ValueError):
                return False
            pcm = np.array(planar, np.int64).T
            if pcm.shape[0] != bsizes[i]:
                return False
            out[starts[i]: starts[i] + bsizes[i]] = pcm
            _count(stats, "oracle_frames")
        return True

    def resolve(entry) -> bool:
        sel, trip, bs = entry
        if trip is not None and _ok(trip):
            pos = starts[sel, None] + np.arange(bs)[None, :]
            out[pos.ravel()] = _host_pcm(trip, c)
            _count(stats, "device")
            return True
        return oracle_frames(sel)

    for bs in np.unique(bsizes).tolist():
        idx = np.nonzero(bsizes == bs)[0]
        if bs < 64 or idx.size < VAR_MIN_GROUP:
            if not oracle_frames(idx):
                return None
            continue
        pending = None
        for lo in range(0, idx.size, batch_frames):
            sel = idx[lo: lo + batch_frames]
            lens = (ends_b[sel] - offsets[sel]).astype(np.int64)
            width = (int(lens.max()) + 255) // 256 * 256
            with trace.span("decode.stage_rows"):
                rows = scatter_rows(arr, offsets[sel], ends_b[sel], width)
            try:
                trip = _decode_rows_device(rows, lens, bs, c, bps,
                                           verify_crc, dev,
                                           sharding=sharding)
            except ValueError:
                trip = None
            if pending is not None and not resolve(pending):
                return None
            pending = (sel, trip, bs)
        if pending is not None and not resolve(pending):
            return None
    return out


def _decode_variable(data: bytes, streaminfo: Streaminfo, first: int,
                     batch_frames: int, verify_crc: bool, dev: torch.device,
                     stats: dict | None, sharding=None) -> np.ndarray | None:
    """Batch decode of a whole variable-blocking / mixed-block-size stream:
    the frame chain, then :func:`_decode_var_frames`.  Returns ``None``
    when the scan cannot establish an exact frame tiling or a frame fails
    on every path (the caller decodes sequentially)."""
    try:
        offsets, bsizes, ambiguous = _scan_frame_chain(data, first)
    except FlacFormatError:
        return None
    if not offsets.size:
        return None
    if ambiguous:
        # heuristically picked boundaries must be CRC-verified even if the
        # caller opted out
        verify_crc = True
    total = int(bsizes.sum())
    if streaminfo.samples and total != streaminfo.samples:
        return None
    ends_b = np.append(offsets[1:], len(data))
    return _decode_var_frames(data, streaminfo, offsets, bsizes, ends_b,
                              batch_frames, verify_crc, dev, stats, sharding)


def decode_array(data: bytes, batch_frames: int = 256,
                 verify_crc: bool = True, oracle: bool = False,
                 device: str | torch.device = "cuda",
                 stats: dict | None = None,
                 sharding=None) -> tuple[Streaminfo, np.ndarray]:
    """Decode a whole FLAC stream to PCM ``[samples, channels]`` int32.

    ``stats`` (a dict) gathers the batches by route (module docstring).
    ``sharding`` (:func:`flacx_torch.parallel.frame_sharding`) splits each
    device batch whose frame count divides its mesh over the mesh's
    devices; other batches decode whole on the mesh's first device, on
    the device route all the same.  ``device`` must then name the mesh's
    device type.  Malformed input of any shape raises
    :class:`FlacFormatError` — never a bare ``EOFError``.
    """
    dev = home_device(device, sharding)
    try:
        return _decode_array(data, batch_frames, verify_crc, oracle, dev,
                             stats, sharding)
    except EOFError:
        raise FlacFormatError("truncated stream") from None


def _decode_array(data: bytes, batch_frames: int, verify_crc: bool,
                  oracle: bool, dev: torch.device, stats: dict | None,
                  sharding=None) -> tuple[Streaminfo, np.ndarray]:
    streaminfo, first = parse_stream_header(data)
    n = streaminfo.max_block_size
    c = streaminfo.channels
    total = streaminfo.samples

    def sequential():
        _count(stats, "sequential")
        return streaminfo, _decode_sequential(data, streaminfo)

    # tiny blocks are not worth a device batch: the sequential decoder
    if oracle or n < 64:
        return sequential()

    # variable blocking (or any mixed-block-size stream): grouped batch
    # decode, the strict sequential decoder where it cannot
    if streaminfo.min_block_size != streaminfo.max_block_size:
        pcm = _decode_variable(data, streaminfo, first, batch_frames,
                               verify_crc, dev, stats, sharding)
        if pcm is None:
            return sequential()
        return streaminfo, pcm

    try:
        offsets, ambiguous = _scan_frame_offsets(data, first)
    except FlacFormatError:
        return sequential()
    if ambiguous:
        # CRC-16 is the safety net of the ambiguity resolution, so it
        # cannot be opted out of here
        verify_crc = True

    n_full = total // n
    tail = total - n_full * n
    if len(offsets) != n_full + (1 if tail else 0):
        return sequential()

    out = np.zeros((total, c), np.int32)
    ends = np.append(offsets[1:], len(data))
    arr = np.frombuffer(data, np.uint8)

    # any inconsistency of a batch (CRC-16 mismatch from a displaced
    # boundary, parse error) means the offset scan was fooled, NOT that
    # the stream is bad: the host route, then the strict sequential
    # decoder, which re-validates everything
    def host_parse_batch(lo, hi, rows, lens) -> bool:
        _count(stats, "host")
        if verify_crc and not _crc_rows_ok(rows, lens):
            return False
        try:
            pcm = _decode_rows(rows, n, c, streaminfo.sample_size, dev)
        except ValueError:
            return False
        out[lo * n: hi * n] = pcm.reshape(-1, c)
        return True

    def resolve(entry) -> bool:
        """Read one pending device batch (or run its host route)."""
        lo, hi, trip, rows, lens = entry
        if trip is not None and _ok(trip):
            out[lo * n: hi * n] = _host_pcm(trip, c)
            _count(stats, "device")
            return True
        return host_parse_batch(lo, hi, rows, lens)

    pending = None
    for lo in range(0, n_full, batch_frames):
        hi = min(lo + batch_frames, n_full)
        lens = (ends[lo:hi] - offsets[lo:hi]).astype(np.int64)
        # row width bucketed to 256 bytes
        width = (int(lens.max()) + 255) // 256 * 256
        with trace.span("decode.stage_rows"):
            rows = scatter_rows(arr, offsets[lo:hi], ends[lo:hi], width)
        try:
            trip = _decode_rows_device(rows, lens, n, c,
                                       streaminfo.sample_size, verify_crc,
                                       dev, sharding=sharding)
        except ValueError:
            return sequential()
        if pending is not None and not resolve(pending):
            return sequential()
        pending = (lo, hi, trip, rows, lens)
    if pending is not None and not resolve(pending):
        return sequential()

    # short final frame via the oracle
    if tail:
        r = BitReader(data)
        r.read_bytes(int(offsets[-1]))
        _, planar = read_frame(r, streaminfo.sample_size,
                               verify_crc=verify_crc)
        out[n_full * n:] = np.array(planar, np.int64).T
        _count(stats, "oracle_frames")
    return streaminfo, out


def _decode_sequential(data: bytes, streaminfo: Streaminfo) -> np.ndarray:
    """Oracle route: strict sequential decode."""
    r = BitReader(data)
    r.read_bytes(4)
    while True:
        header = read_metadata_header(r)
        if header.type == MetadataBlockType.Streaminfo:
            read_streaminfo(r)
        else:
            r.read_bytes(header.length)
        if header.last:
            break
    chunks = []
    while not r.at_eof():
        _, planar = read_frame(r, streaminfo.sample_size)
        chunks.append(np.array(planar, np.int64).T)
    return np.concatenate(chunks, axis=0).astype(np.int32)


class _RowBatchDecoder:
    """Decode ``[F, width]`` byte-row batches of full-size frames to PCM.

    Wraps the two batched routes of :func:`decode_array` — the device
    decode and the host parse — behind submit/resolve so the streaming
    decoder can keep one batch in flight.  ``try_resolve`` returns
    ``None`` when both routes reject the batch (a fooled boundary scan,
    not necessarily a bad stream): the caller re-decodes that byte range
    sequentially.
    """

    def __init__(self, streaminfo: Streaminfo, verify_crc: bool,
                 dev: torch.device, stats: dict | None, sharding=None):
        self.si = streaminfo
        self.verify_crc = verify_crc
        self.dev = dev
        self.stats = stats
        self.sharding = sharding

    def submit(self, rows: np.ndarray, lens: np.ndarray):
        """Start the device decode; returns an entry."""
        try:
            trip = _decode_rows_device(rows, lens, self.si.max_block_size,
                                       self.si.channels,
                                       self.si.sample_size, self.verify_crc,
                                       self.dev, sharding=self.sharding)
        except ValueError:
            trip = None
        return (trip, rows, lens)

    def try_resolve(self, entry) -> np.ndarray | None:
        """One entry → int32 PCM ``[F·n, channels]`` (or ``None``)."""
        trip, rows, lens = entry
        n, c = self.si.max_block_size, self.si.channels
        if trip is not None and _ok(trip):
            _count(self.stats, "device")
            return _host_pcm(trip, c)
        _count(self.stats, "host")
        if self.verify_crc and not _crc_rows_ok(rows, lens):
            return None
        try:
            pcm = _decode_rows(rows, n, c, self.si.sample_size, self.dev)
        except ValueError:
            return None
        return pcm.reshape(-1, c)


def decode_stream(f, batch_frames: int = 256, verify_crc: bool = True,
                  oracle: bool = False, device: str | torch.device = "cuda",
                  readahead: int = 4 << 20, stats: dict | None = None,
                  sharding=None):
    """Constant-memory streaming decode of a FLAC byte stream.

    Returns ``(streaminfo, chunks)`` where ``chunks`` is a generator of
    int32 ``[n_i, channels]`` PCM arrays in stream order.  Peak memory is
    O(``readahead`` + one decoded window) whatever the file's length.

    Each buffered window is boundary-scanned and batch-decoded on the
    device; windows the scan or batch routes reject (scan ambiguity,
    displaced boundaries) are re-decoded sequentially by the strict
    oracle.  ``f`` only needs ``read()``; the stream may be unseekable (a
    pipe).  ``stats`` and ``sharding`` as in :func:`decode_array`
    (``sequential`` counts windows).
    """
    dev = home_device(device, sharding)
    head = b""
    while True:
        piece = f.read(1 << 16)
        if piece:
            head += piece
        try:
            streaminfo, first = parse_stream_header(head)
            break
        except EOFError:
            if not piece:
                raise FlacFormatError("truncated stream header") from None
    n = streaminfo.max_block_size
    bps = streaminfo.sample_size
    fixed_blocking = streaminfo.min_block_size == streaminfo.max_block_size
    batched = not oracle
    bdec = (_RowBatchDecoder(streaminfo, verify_crc, dev, stats, sharding)
            if batched and fixed_blocking else None)
    # windows whose boundary scan resolved duplicates heuristically must
    # verify CRC-16 even when the caller opted out
    bdec_strict = (_RowBatchDecoder(streaminfo, True, dev, stats, sharding)
                   if bdec is not None and not verify_crc else bdec)

    def sequential_window(buf: bytes, eof: bool):
        """Strict frame-by-frame decode of a window prefix: returns
        ``(pcm_chunks, consumed_bytes)``, stopping at the first frame that
        runs past the window (it needs a refill)."""
        r = BitReader(buf)
        outs, pos = [], 0
        while pos < len(buf):
            try:
                _, planar = read_frame(r, bps, verify_crc=verify_crc)
            except EOFError:
                if eof:
                    raise FlacFormatError(
                        "truncated stream (incomplete final frame)"
                    ) from None
                break
            pos = r.bit_position // 8
            outs.append(np.array(planar, np.int64).T)
        return outs, pos

    def drain_tail(window: bytes, pos: int):
        """Strictly decode every frame from ``pos`` to the stream end:
        normally one (possibly short) final frame, but a mid-window chain
        break can leave several."""
        tr = BitReader(window[pos:])
        while not tr.at_eof():
            try:
                _, planar = read_frame(tr, bps, verify_crc=verify_crc)
            except EOFError:
                raise FlacFormatError(
                    "truncated stream (incomplete final frame)") from None
            _count(stats, "oracle_frames")
            yield np.array(planar, np.int64).T.astype(np.int32)

    def gen():
        buf = bytearray(head[first:])
        eof = False
        target = readahead
        while True:
            while not eof and len(buf) < target:
                piece = f.read(max(target - len(buf), 1 << 16))
                if not piece:
                    eof = True
                    break
                buf += piece
            if not buf:
                return
            window = bytes(buf)

            # variable-blocking windows: grouped batch decode of every
            # boundary-delimited frame, sequential below where it cannot
            if batched and not fixed_blocking:
                try:
                    voffs, vbs, vamb = _scan_frame_chain(window, 0)
                except FlacFormatError:
                    voffs = np.asarray([], np.int64)
                # the window starts at a known frame boundary; a scan
                # that does not see it cannot be trusted
                if voffs.size > 1 and int(voffs[0]) == 0:
                    pcm = _decode_var_frames(
                        window, streaminfo, voffs[:-1], vbs[:-1],
                        voffs[1:], batch_frames, verify_crc or vamb, dev,
                        stats, sharding)
                    if pcm is not None:
                        yield pcm
                        if eof:
                            yield from drain_tail(window, int(voffs[-1]))
                            return
                        del buf[: int(voffs[-1])]
                        target = readahead
                        continue

            offsets = np.asarray([], np.int64)
            wdec = bdec
            if bdec is not None:
                try:
                    offsets, ambiguous = _scan_frame_offsets(window, 0)
                    if ambiguous:
                        wdec = bdec_strict
                except FlacFormatError:
                    pass
            # the window starts at a known frame boundary; a scan that
            # does not see it cannot be trusted
            if offsets.size > 0 and int(offsets[0]) == 0:
                # full frames = all boundary-delimited ones; at EOF the
                # final (possibly short) frame goes through the oracle
                full = offsets[:-1]
                ends = offsets[1:]
                arr = np.frombuffer(window, np.uint8)
                results: list[np.ndarray] = []
                pending = None
                failed = False
                for lo in range(0, len(full), batch_frames):
                    hi = min(lo + batch_frames, len(full))
                    lens = (ends[lo:hi] - full[lo:hi]).astype(np.int64)
                    width = (int(lens.max()) + 255) // 256 * 256
                    with trace.span("decode.stage_rows"):
                        rows = scatter_rows(arr, full[lo:hi], ends[lo:hi],
                                            width)
                    entry = wdec.submit(rows, lens)
                    if pending is not None:
                        pcm = wdec.try_resolve(pending)
                        if pcm is None:
                            failed = True
                            break
                        results.append(pcm)
                    pending = entry
                if not failed and pending is not None:
                    pcm = wdec.try_resolve(pending)
                    if pcm is None:
                        failed = True
                    else:
                        results.append(pcm)
                if not failed:
                    yield from results
                    if eof:
                        yield from drain_tail(window, int(offsets[-1]))
                        return
                    consumed = int(offsets[-1])
                    if consumed == 0:
                        target *= 2           # one frame wider than window
                        continue
                    del buf[:consumed]
                    target = readahead
                    continue

            # strict sequential window decode (scan rejected / displaced
            # boundaries / host-route mismatch / non-batchable stream)
            outs, pos = sequential_window(window, eof)
            if pos == 0:
                target *= 2                   # one frame wider than window
                continue
            _count(stats, "sequential")
            if outs:
                yield np.concatenate(outs, axis=0).astype(np.int32)
            del buf[:pos]
            target = readahead
            if eof and not buf:
                return

    def safe_gen():
        # clean-error contract: malformed windows surface as
        # FlacFormatError, never a bare EOFError from a bit reader
        try:
            yield from gen()
        except EOFError:
            raise FlacFormatError("truncated stream") from None

    return streaminfo, safe_gen()
