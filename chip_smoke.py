#!/usr/bin/env python3
"""Smoke run of flacx_torch on one NVIDIA card.

    python3 chip_smoke.py

Builds the ten CUDA kernel libraries from ``flacx_torch/kernels/csrc``
and runs these paths on the card, the encodes through ``BatchEncoder``:

* the headline encode, 16-bit stereo: one 1024-frame batch at block
  4608, LPC order 12;
* conformance mode (``conformance``): the same batch with
  ``EncoderConfig(conformance=True)`` (the reference encoder's choices;
  ``reference_lpc``, ``abs_residual_sums``, ``lpc_residual`` zz mode,
  ``frame_pack``): every CRC-16, the first 256 frames byte-equal to the
  plain CPU path, 16 sampled frames equal to the oracle encoder's, two
  crafted batches on the overflow route (a spike in low noise, full-scale
  noise past the frame buffer), the timing, and the CD rip of the file
  phase through ``pipeline.encode_to_file(conformance=True)``; then
  (``conformance_hires``) 64 frames of the hi-res stereo PCM at block
  16384, LPC order 32, precision 15 (the wide MAC, three sample limbs,
  hi tap limbs, 33 lags): both kernels against their plain versions,
  every CRC-16, the frames decoded on the card bit-exactly;
* the best-compression encode (``encode --best``): the same PCM cut into
  blocks of 4608, 2304 and 1152 (1024, 2048 and 4096 frames), each
  encoded with the exact order search over the windows Tukey(0.5), Hann
  and flattop (f64 analysis), 1024 frames per batch; then one 64-frame
  batch with wasted bits;
* the hi-res encode (``BASELINE.json`` configs[2]: 24-bit/96 kHz, block
  16384, LPC order 32, partition orders 0..15, estimate search): one
  128-frame stereo batch (``hires``) and one 64-frame 5.1 batch
  (``hires6``, frames of up to 295,168 bytes, past a block's shared
  memory);
* the 25- to 32-bit encode (``hibps``): the headline settings on 1024
  frames of 28-bit stereo (a 29-bit side channel) and of 32-bit stereo
  (independent), every kernel on its int64 route (``analysis``'s int64
  differences, ``lpc_residual``'s wide MAC with int64 zz, ``rice_stats``
  on int64 zz, ``frame_pack`` reading int64 zz), the first 256 frames
  against the plain CPU path; ``--best``'s block-4608 pass at 32 bits on
  256 frames (``lpc_allorder``, four sample limbs); the CLI at the
  defaults on a 30 s 32-bit stereo WAV, decoded back;
* the file encode (``file``): ``python -m flacx_torch encode`` in process
  on WAV files written from the seed, a 3-minute 16-bit CD rip at the
  defaults and at ``-b 1152`` (the ``lpc_residual`` res mode) and a 60 s
  24-bit master with ``--best`` (the wide ``lpc_allorder``).  Each file's
  STREAMINFO, MD5, CRCs and sampled frames are checked, each file is
  decoded with ``python -m flacx_torch decode`` in process (the defaults'
  file also with ``--stream``) back to its PCM, and a 20 s excerpt is
  encoded on the card and with ``--device cpu``;
* the decode (``decode``): ``decoder.decode_array`` on the card over the
  streams of the headline batch (at 256 and 1024 frames a batch), of the
  same PCM with fixed predictors only, of the two hi-res batches and of
  the two 25- to 32-bit batches (``reconstruct``'s int64 chunk route at
  both widths, from the walker's int32 state at 28 bits and its int64
  state at 32), each
  bit-exact against its PCM with every batch on the device route (the
  ``bit_unpack``, ``reconstruct`` and ``crc16_rows`` kernels), then the
  headline stream forced down the host parse (``reconstruct``'s serial
  route, row ``reconstruct_serial@headline``) and the serial route at 32
  bits (row ``reconstruct_serial_wide@hibps32``: the first batch with
  its state dropped, its launches from the 32-bit stream forced down the
  host parse);
* the corpus encode (``corpus``, ``BASELINE.json`` configs[3]):
  ``python -m flacx_torch encode-corpus`` in process at its defaults over
  1000 WAVs of 1-8 s drawn from the seed (16-bit/44.1 kHz stereo and
  mono, 24-bit/48 kHz and 96 kHz stereo) and one unreadable file: every
  output decoded on the card bit-exactly with every batch on the device
  route, its STREAMINFO and MD5 checked; 8 files byte-equal to
  ``encode_to_file`` on the card; the bad file ``FAILED``; a ``--resume``
  run after one output is deleted and one input touched re-encodes
  exactly those two; the wall, files/s, samples/s, x realtime, batches
  per bucket and the oracle tails' share printed;
* sequence sharding (``seqshard``, ``BASELINE.json`` configs[2]'s long
  blocks): the hi-res stereo PCM as 256 rows of 16384 and 128 rows of
  32768 samples (24-bit), windowed by Tukey(0.5) in f32, with order-1..32
  taps from the port's Levinson and quantization; each mode of the
  ``seqshard`` kernel held against its plain version (rows
  ``seq_<mode>@seq16k`` / ``@seq32k``, the autocorrelation beside a
  grouped f64 ``conv1d``), then ``autocorrelate_sharded``,
  ``fixed_order_zz_sums_sharded`` and ``lpc_zz_stats_sharded`` on
  ``seq_mesh(1, 2)``, ``(1, 8)`` and ``(2, 4)`` over repeated ``cuda:0``
  (counted), equal to ``analysis``'s fixed sums and the wide
  ``lpc_residual_stats`` exactly and to ``analysis``'s autocorrelation
  within 1e-12, their walls beside the unsharded kernels';
* the multi-process corpus (``distributed``): two fresh interpreters
  (``chip_smoke.py --distributed-worker``) join a gloo group on
  ``127.0.0.1`` and each runs ``encode_corpus_distributed`` of the
  sharded phase's 20-file corpus on ``cuda:0`` into one output directory:
  disjoint stripes that make up the corpus, both ranks' totals equal to a
  one-process ``encode_corpus`` on the card, every file byte-equal to it,
  a resumed run that reads both manifest shards and skips every file,
  every output decoded bit-exactly on the card; the two-process wall
  beside the one-process wall;
* the dry run (``dryrun``): ``parallel.dryrun.dryrun_multichip`` on four
  ``cuda:0`` entries, counted, with its summary line;
* frame sharding (``sharded``), last: meshes of every visible card and of
  two ``cuda:0`` entries; the headline batch through
  ``BatchEncoder(sharding=...)``, a 20 s excerpt through
  ``encode_to_file``, the headline stream's ``decode_array`` at 256 and
  255 frames a batch and a 20-file corpus, each equal to the unsharded
  card path, with the walls beside the unsharded ones.

Each kernel is held against its plain PyTorch version on the card at the
shapes its path gives it, those of the best path at each block size.  For
each encode: every kernel of the path was launched, every frame's CRC-16
holds, frames decode bit-exactly under the port's oracle decoder (16 of
each 16-bit encode, 4 and 2 of the hi-res ones), and they match the
plain CPU path byte for byte wherever both chose the same coefficients.

The decode kernels are held against their plain versions on the
arguments of their first launch in each stream's decode (rows
``<kernel>@<stream>``, ``reconstruct_<route>@<stream>``).

Prints one line per phase, the run's seconds, then the kernels' JSON line
(one row per kernel mode and path, named ``<mode>@<block>`` on the best
path, ``<kernel>@conformance`` and ``<kernel>@conformance_hires`` in
conformance mode, ``<mode>@hibps28``
/ ``<mode>@hibps32`` and ``lpc_allorder@best32`` past 24 bits,
``<mode>@file_<run>_<block>`` on the file path and ``<mode>@hires`` /
``<mode>@hires6`` on the hi-res ones, ``<mode>@corpus96k`` and
``<mode>@corpus_mono`` on the corpus's 24-bit/96 kHz and mono batches,
``seq_<mode>@seq16k`` / ``@seq32k`` on the sequence-sharding rows;
``launches`` counts the launches of that path's counted encode, in
the ``batches`` of its batches that launch (on the card a stream's
eager batches and its graph's capture; a replay launches nothing, and
each counted stream's captures and replays are checked); for the
``seq_`` rows the launches of the
three sharded functions on the three meshes), the card's name and power
limit, and as its
last line ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero; without CUDA it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N, B, SEED = 4608, 1024, 0xF1AC
#: the best-compression path: block sizes and windows of ``encode --best``
BEST_BLOCKS = (4608, 2304, 1152)
BEST_WINDOWS = ("tukey(0.5)", "hann", "flattop")
WASTED_FRAMES = 64
#: H100 SXM data-sheet peaks (NVIDIA, dense, 700 W): HBM bytes/s, the
#: int8 tensor-core rate, and the non-tensor f32 rate, used for every
#: scalar ALU operation of the kernels; f64 instructions (a multiply, an
#: add or a fused multiply-add) issue at 64 per clock per SM (132 SMs,
#: 1.98 GHz), f64 tensor-core multiply-adds at 128 (67 against 34 TFLOP/s
#: on the data sheet).
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
SCALAR_OPS_PER_S = 67e12
F64_OPS_PER_S = 64 * 132 * 1.98e9
F64_TENSOR_OPS_PER_S = 128 * 132 * 1.98e9
#: small launches that open each profiler trace (:func:`kernel_times`)
TRACE_PRELUDE = 512


def synth_pcm(rng: np.random.Generator, frames: int,
              bps: int = 16) -> np.ndarray:
    """Two-tone stereo test signal with a little noise, ``[frames, 2]``
    int32 (the headline benchmark's input); past 16 bits the same signal
    at that width (its noise reaching the low bits)."""
    t = np.arange(frames, dtype=np.float64)
    left = (0.6 * np.sin(2 * np.pi * 220.0 / 44100.0 * t)
            + 0.25 * np.sin(2 * np.pi * 587.3 / 44100.0 * t + 0.3)
            + 0.02 * rng.standard_normal(frames))
    right = (0.55 * np.sin(2 * np.pi * 329.6 / 44100.0 * t + 0.1)
             + 0.2 * np.sin(2 * np.pi * 880.0 / 44100.0 * t)
             + 0.02 * rng.standard_normal(frames))
    pcm = np.stack([left, right], axis=1) * (22000 * 2.0 ** (bps - 16))
    top = 1 << (bps - 1)
    return np.clip(pcm, -top, top - 1).astype(np.int64).astype(np.int32)


def ptxas_resources(log: str) -> list[tuple]:
    """``(kernel, registers, spill store bytes, spill load bytes)`` of each
    entry function in an ``nvcc -Xptxas -v`` log."""
    import re

    out, entry, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.append((entry, int(m.group(1)), *spills))
            entry = None
    return out


#: the kernel libraries whose registers and spills the run prints
#: (redesigned last)
REPORTED_LIBRARIES = ("seqshard", "crc16_rows")


def print_resources() -> None:
    """Each kernel of :data:`REPORTED_LIBRARIES`: its registers and spills
    from the build's ``-Xptxas -v`` report."""
    from flacx_torch.kernels.build import build_dir

    for name in REPORTED_LIBRARIES:
        for entry, regs, st, ld in ptxas_resources(
                (build_dir() / f"{name}.log").read_text()):
            print(f"ptxas {name} {entry}: {regs} registers, {st} bytes "
                  f"spill stores, {ld} bytes spill loads", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps: int) -> float:
    """Median time of ``fn()`` over ``reps`` calls between two CUDA events,
    after one warm-up call.  Where the host issues the work slower than the
    card runs it, this is the host's time."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def kernel_times(torch, calls: dict, reps: int) -> dict:
    """Median device ms of each kernel in ``calls`` (a symbol its name
    contains → a function that launches it), from one profiler trace in
    which each function runs ``reps`` times: free of the wrappers' host
    time.  Where one call launches several kernels whose names contain
    the symbol, their medians add up.  The profiler drops a launch's
    record now and then, the more often the more traces a process has
    taken; a trace that holds fewer than half of some kernel's launches
    is taken again, up to three times.  The records it drops are the
    trace's first ones, more of them the more the process has launched
    since its last trace: each trace opens with :data:`TRACE_PRELUDE`
    small launches that take the loss."""
    assert not any(a != b and a in b for a in calls for b in calls), calls
    for fn in calls.values():
        fn()
    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    seen = []
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(TRACE_PRELUDE):
                pad.add_(1)
            torch.cuda.synchronize()
            for fn in calls.values():
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
        times = {symbol: {} for symbol in calls}
        for e in prof.events():
            if "CUDA" in str(e.device_type):
                for symbol, by_name in times.items():
                    if symbol in e.name:
                        by_name.setdefault(e.name, []).append(
                            e.time_range.elapsed_us() / 1e3)
        seen.append({symbol: [len(ts) for ts in by_name.values()]
                     for symbol, by_name in times.items()})
        if all(by_name and all(reps <= 2 * len(ts) <= 2 * reps
                               for ts in by_name.values())
               for by_name in times.values()):
            return {symbol: sum(float(np.median(ts))
                                for ts in by_name.values())
                    for symbol, by_name in times.items()}
    raise RuntimeError(f"profiler saw {seen} launches in three traces of "
                       f"{reps} each")


def nbytes(*items) -> int:
    """Bytes of every tensor in ``items`` (nested tuples and dicts too)."""
    total = 0
    for it in items:
        if isinstance(it, dict):
            total += nbytes(*it.values())
        elif isinstance(it, (tuple, list)):
            total += nbytes(*it)
        elif hasattr(it, "element_size"):
            total += it.numel() * it.element_size()
    return total


HEADLINE_SPIES = ("analysis", "lpc_residual_stats", "lpc_residual_zz",
                  "rice_stats", "frame_pack")


def capture_main_path_inputs(names=HEADLINE_SPIES, per_block=False,
                             module=None):
    """Wrap each named kernel wrapper where the encoder calls it (or
    ``module``, for every kernel but ``frame_pack``), so one run of the
    path records the arguments of every kernel's first launch (positional
    arguments, keywords folded in by name order), under its name, or with
    ``per_block`` under ``(name, block size)``; returns ``(captured,
    restore)``."""
    import flacx_torch.encoder as encoder
    import flacx_torch.ops.framepack as framepack
    if module is not None:
        encoder = module

    captured = {}
    originals = []

    def spy(module, attr):
        fn = getattr(module, attr)
        originals.append((module, attr, fn))

        def wrapped(*args, **kwargs):
            # frame_pack's first argument is the header; its x the 8th
            block = args[7 if attr == "frame_pack" else 0].shape[-1]
            key = (attr, block) if per_block else attr
            captured.setdefault(key, args + tuple(kwargs.values()))
            return fn(*args, **kwargs)
        setattr(module, attr, wrapped)

    for name in names:
        spy(framepack if name == "frame_pack" else encoder, name)

    def restore():
        for module, attr, fn in originals:
            setattr(module, attr, fn)
    return captured, restore


def kernel_row(torch, name, symbol, kernel, plain, args, compare, work,
               source, replaces, moved=None) -> dict:
    """Hold ``kernel`` against ``plain`` on ``args``, time the plain
    version, and return the kernel's JSON row (``ms`` filled in by
    :func:`time_rows`, ``launches`` and ``batches`` later).  ``work`` lists
    ``(operations, rate)`` pairs, one per operation type; their times add
    up.  ``moved`` is the bytes the function must move, by default every
    argument read once and every output written once."""
    out_k = kernel(*args)
    out_p = plain(*args)
    torch.cuda.synchronize()
    err = compare(torch, out_k, out_p)
    wrapper_ms = median_ms(torch, lambda: kernel(*args), 20)
    plain_ms = median_ms(torch, lambda: plain(*args), 5)
    moved = nbytes(args, out_k) if moved is None else moved
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = sum(ops / rate for ops, rate in work) * 1e3
    ops_text = " + ".join(f"{ops} ops at {rate:.3e}/s" for ops, rate in work)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "batches": 0,
            "max_abs_err": err, "ms": None, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "_launch": (symbol, lambda: kernel(*args)),
            "_text": (f"(wrapper call {wrapper_ms:.4f}) plain_ms "
                      f"{plain_ms:.4f} bound_ms {max(t_bytes, t_ops):.4f} "
                      f"({moved} bytes, {ops_text})")}


def time_rows(torch, rows: list[dict], reps: int = 20,
              extra: dict | None = None) -> dict:
    """Fill in every row's ``ms`` from one profiler trace of all their
    kernels (``reps`` launches each) and print the rows; ``extra`` (symbol
    → launch) is timed in the same trace, its medians returned."""
    launches = dict(row["_launch"] for row in rows)
    assert len(launches) == len(rows), "two rows share a kernel symbol"
    ms = kernel_times(torch, {**launches, **(extra or {})}, reps)
    for row in rows:
        row["ms"] = ms[row.pop("_launch")[0]]
        print(f"kernel {row['name']}: max_abs_err {row['max_abs_err']} ms "
              f"{row['ms']:.4f} {row.pop('_text')}", flush=True)
    return {k: ms[k] for k in extra or {}}


def exact(torch, a, b):
    for u, v in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        if (u is None) != (v is None):
            raise AssertionError("kernel and plain differ in their outputs")
        if u is not None and not torch.equal(u, v):
            diff = (u.long() - v.long()).abs().max().item()
            raise AssertionError(f"kernel differs from plain: {diff}")
    return 0


def autoc_close(rtol: float, atol0: float):
    """Fixed sums exact; autocorrelation within ``rtol``, or ``atol0``
    times the lag-0 sum (which bounds the sum of |products|) near zero."""
    def compare(torch, a, b):
        (ac_k, fs_k), (ac_p, fs_p) = a, b
        exact(torch, fs_k, fs_p)
        err = (ac_k - ac_p).abs()
        tol = rtol * ac_p.abs() + atol0 * ac_p[..., :1].abs()
        if not bool((err <= tol).all()):
            raise AssertionError("analysis autocorrelation out of tolerance:"
                                 f" max err {err.max().item()}")
        return float(err.max().item())
    return compare


def rice_equal(torch, a, b):
    for po in b:
        exact(torch, tuple(a[po]), tuple(b[po]))
    return 0


def mac_lengths(taps) -> dict:
    """Rows of ``lpc_residual`` by the length of their MAC loop: their
    taps up to the last nonzero one."""
    t = taps.cpu().numpy()
    last = ((t != 0) * np.arange(1, t.shape[-1] + 1)).max(-1)
    keys, counts = np.unique(last, return_counts=True)
    return dict(zip(keys.tolist(), counts.tolist()))


def limb_ops(n: int, taps, limbs: int) -> int:
    """Operations of an exact integer MAC done as 8-bit limb products on
    the tensor cores (the card's fastest exact route): each row's nonzero
    taps (``taps [..., K]``) times its ``n`` samples, times ``limbs``
    sample limbs and two tap limbs in a row whose taps pass [-128, 127],
    two operations a multiply-add."""
    nonzero = (taps != 0).sum(-1)
    two = ((taps < -128) | (taps > 127)).any(-1)
    return 2 * int((nonzero * (1 + two.long())).sum()) * n * limbs


def allorder_work(x, qcoefs, limbs: int, wide: bool) -> list:
    """``lpc_allorder``'s least work on this run's data, as ``(operations,
    rate)`` pairs: the limb products of every order's nonzero taps
    (:func:`limb_ops`) at the int8 tensor rate; and the epilogue of every
    (sample, order) at the scalar rate: 8 operations (shift, subtract,
    abs, max, zigzag two, 64-bit sum two), 16 in the wide mode's int64."""
    epilogue = x.numel() * qcoefs.shape[-2] * (16 if wide else 8)
    return [(limb_ops(x.shape[-1], qcoefs.flatten(-2), limbs),
             INT8_TENSOR_OPS_PER_S), (epilogue, SCALAR_OPS_PER_S)]


def frame_pack_bytes(args) -> int:
    """The bytes ``frame_pack`` must move on this run's data: each symbol's
    value and length at 4 B each (the values are int64 of which the kernel
    reads the low 32 bits); per channel the samples its subframe codes
    (``x`` of a verbatim one; ``zz`` past the warm-up at its own width,
    ``kesc`` and the partition parameters of a fixed or LPC one; none of a
    constant one) and its kind, order and width; the frame bytes and
    lengths written once."""
    from flacx_torch.ops.emit import KIND_FIXED, KIND_VERBATIM
    hdr_v, sh_v, pv, zz, kesc, kind, order = (args[i] for i in
                                              (0, 2, 4, 6, 8, 9, 10))
    max_frame_bytes = args[13]
    n = zz.shape[-1]
    coded = (zz.element_size() * (n - order.long())
             + 4 * (kesc.shape[-1] + 2 * pv.shape[-1]))
    per_channel = ((kind == KIND_VERBATIM) * 4 * n
                   + (kind >= KIND_FIXED) * coded)
    return (8 * (hdr_v.numel() + sh_v.numel()) + int(per_channel.sum())
            + 12 * kind.numel() + hdr_v.shape[0] * (max_frame_bytes + 4))


def autocorr_library_ms(torch, x, window, max_lag: int) -> float | None:
    """The f64 autocorrelation of every window as one grouped
    ``conv1d`` (a yardstick, never on the main path): ``u`` the windowed
    f64 rows without their last sample, ``u_pad`` those padded with
    ``max_lag`` zeros on the right; ``autoc[l] = Σ_j u[j]·u[j+l]`` up to
    summation order.  Held against the plain version within rtol 1e-12
    (or 1e-12 of autoc[0] near zero); returns its median ms, or None where
    cuDNN refuses the shape (printed)."""
    from flacx_torch.ops.lpc import autocorrelate

    wins = window.reshape(-1, x.shape[-1])
    u = (x.double()[..., None, :-1] * wins[:, :-1]).reshape(-1, 1,
                                                            x.shape[-1] - 1)
    u_pad = torch.nn.functional.pad(u, (0, max_lag)).reshape(1, len(u), -1)

    def conv():
        return torch.nn.functional.conv1d(u_pad, u, groups=len(u))
    try:
        got = conv().reshape(-1, max_lag + 1)
    except RuntimeError as e:
        print(f"conv1d yardstick refused at {tuple(u.shape)}: {e}",
              flush=True)
        return None
    ref = torch.stack([autocorrelate(x, max_lag, window=w) for w in wins],
                      dim=-2).reshape(-1, max_lag + 1)
    err = (got - ref).abs()
    if not bool((err <= 1e-12 * (ref.abs() + ref[:, :1].abs())).all()):
        raise AssertionError("conv1d yardstick out of tolerance: max err "
                             f"{err.max().item()}")
    ms = median_ms(torch, conv, 10)
    print(f"conv1d yardstick {tuple(u.shape)}: {ms:.4f} ms, max err "
          f"{err.max().item()}", flush=True)
    return ms


def hold(torch, name: str, wrapper: str, args: tuple,
         replaces: str | None = None, add_s: float | None = None) -> dict:
    """The JSON row of the kernel behind ``wrapper`` (one of
    :data:`WRAPPERS`), held against its plain version on ``args``,
    the arguments the path gave its first launch; ``replaces`` names the
    TPU kernels where the path, not the shapes, decides them.  ``add_s``:
    one f64 add's latency on the card, for ``reference_lpc``'s bound."""
    if wrapper in CONF_KERNELS:
        return conformance_row(torch, name, wrapper, args, add_s)
    from flacx_torch.kernels import analysis as k_an
    from flacx_torch.kernels import frame_pack as k_fp
    from flacx_torch.kernels import lpc_allorder as k_la
    from flacx_torch.kernels import lpc_residual as k_lr
    from flacx_torch.kernels import rice_stats as k_rs
    from flacx_torch.ops import rice
    from flacx_torch.ops.emit import blocked_layout_ok

    csrc = "flacx_torch/kernels/csrc/"
    if wrapper == "analysis":
        x, window, max_lag = args[:3]
        # the integer work of the fixed-order sums, doubled where the
        # differences are int64 (each a pair of 32-bit operations)
        fixed_ops = 26 * (2 if k_an.diff_width(args[3]) == "int64" else 1)
        n = x.shape[-1]
        rows = x[..., 0].numel()
        # every window's work: W windows of [W, n], one of [n]
        windowed = rows * n * (window.shape[0] if window.dim() > 1 else 1)
        adds = windowed * (max_lag + 1)
        if window.dtype == torch.float64:
            # the same f64 products summed in another order: rtol 1e-12,
            # or 1e-12 of autoc[0] (n·eps64·autoc[0] bounds the error) near
            # zero; operations: the window multiply, one product and one
            # add per lag.  The JAX package runs this f64 analysis as XLA
            # (flacx/ops/lpc.py:143-150); the f64 mode belongs to the port
            # of the f32 TPU kernel.
            row = kernel_row(
                torch, name, "analysis_kernel", k_an.analysis,
                k_an.analysis_plain, args, autoc_close(1e-12, 1e-12),
                [(2 * adds + windowed, F64_OPS_PER_S)],
                csrc + "analysis.cu", "flacx/kernels/autocorr_tile.py:124")
            row["library_ms"] = autocorr_library_ms(torch, x, window,
                                                    max_lag)
            return row
        # f64 sums of the same f32 products in another order: within rtol
        # 1e-9, or n·eps64·autoc[0] (bounds Σ|products|) near zero; the
        # f64 adds at the f64 rate, the f32 products and integer work at
        # the scalar rate
        return kernel_row(
            torch, name, "analysis_kernel", k_an.analysis,
            k_an.analysis_plain, args, autoc_close(1e-9, 1e-12),
            [(adds, F64_OPS_PER_S),
             (adds + windowed + rows * n * fixed_ops, SCALAR_OPS_PER_S)],
            csrc + "analysis.cu",
            "flacx/kernels/autocorr_tile.py:124 + "
            "flacx/kernels/zzsum_tile.py:115")
    if wrapper in ("lpc_residual_stats", "lpc_residual_zz",
                   "lpc_residual_res"):
        mode = ("lpc_residual_stats", "lpc_residual_zz",
                "lpc_residual_res").index(wrapper)
        xs, taps = args[0], args[1]
        # the zz mode's int64 output is the kernel's mode 3
        zz64 = mode == 1 and len(args) > 6 and args[6] == torch.int64
        wide = k_lr.mac_width(args[4], args[5]) == "wide"
        # one multiply-add per sample and nonzero tap of its row: the int32
        # MAC's as two scalar operations and six a sample besides; the wide
        # MAC's as limb products at the int8 tensor rate, as
        # lpc_allorder's, and twelve scalar operations a sample (the six
        # in int64)
        work = ([(limb_ops(xs.shape[-1], taps, k_la.sample_limbs(args[4])),
                  INT8_TENSOR_OPS_PER_S),
                 (xs.numel() * 12, SCALAR_OPS_PER_S)] if wide else
                [(2 * int((taps != 0).sum()) * xs.shape[-1]
                  + xs.numel() * 6, SCALAR_OPS_PER_S)])
        return kernel_row(
            torch, name,
            f"lpc_residual_kernel<{3 if zz64 else mode}, "
            f"{str(wide).lower()}>",
            getattr(k_lr, wrapper), getattr(k_lr, wrapper + "_plain"), args,
            exact, work, csrc + "lpc_residual.cu",
            "flacx/kernels/lpcres_tile.py:" + ("392", "225" if xs.shape[-1]
                                               > 8192 else "199",
                                               "479")[mode])
    if wrapper == "lpc_allorder":
        x, qcoefs = args[0], args[1]
        p = qcoefs.shape[-2]
        wide = k_lr.mac_width(args[3], args[4]) == "wide"
        # the instantiation: MAC width, order tiles held, sample limbs
        limbs = k_la.sample_limbs(args[3])
        symbol = (f"lpc_allorder_kernel<{str(wide).lower()}, "
                  f"{2 if p <= 16 else 4}, {limbs}>")
        return kernel_row(
            torch, name, symbol,
            k_la.lpc_allorder, k_la.lpc_allorder_plain, args, exact,
            allorder_work(x, qcoefs, limbs, wide),
            csrc + "lpc_allorder.cu",
            "flacx/kernels/lpcres_tile.py:612" + (
                " + flacx/encoder.py:432-438 (its int64 XLA route)"
                if wide else ""))
    if wrapper == "rice_stats":
        zz, _, porders, kmax = args
        n = zz.shape[-1]
        # the least work: every k's sum once at the finest level (the
        # coarser levels add those up); flacx's whole-row form takes rows
        # up to 8192, its chunked form the longer ones
        return kernel_row(
            torch, name, "rice_stats_kernel", k_rs.rice_stats,
            rice.rice_stats, args, rice_equal,
            [(zz.numel() * (2 * (kmax + 1) + 1), SCALAR_OPS_PER_S)],
            csrc + "rice_stats.cu",
            "flacx/kernels/rice_tile.py:"
            + ("266" if n <= 8192 and n % 128 == 0 else "293"))
    if wrapper in DECODE_PATH:
        return decode_row(torch, name, wrapper, args)
    assert wrapper == "frame_pack"
    xs, psize = args[7], args[12]
    if replaces is None:
        replaces = (
            "flacx/kernels/emit_tile.py:203 + bitpack_tile.py:363 + "
            "bitpack_tile.py:529 + crc_tile.py:84"
            if blocked_layout_ok(xs.shape[-1], psize) else
            "flacx/kernels/bitpack_tile.py:316 + bitpack_tile.py:268")
    return kernel_row(
        torch, name, "frame_pack_kernel", k_fp.frame_pack,
        k_fp.frame_pack_plain, args, exact,
        [(xs.numel() * 30 + xs.shape[0] * args[13] * 4, SCALAR_OPS_PER_S)],
        csrc + "frame_pack.cu", replaces,
        frame_pack_bytes(args))


#: the hand kernels' wrappers whose launches the phases count
WRAPPERS = ("seq_autocorr", "seq_fixed", "seq_lpc", "reference_lpc",
            "abs_residual_sums", "bit_unpack", "reconstruct", "crc16_rows",
            "analysis", "lpc_residual_stats", "lpc_residual_zz",
            "lpc_residual_res", "lpc_allorder", "rice_stats", "frame_pack")


def launch_counts() -> dict:
    """Launches of each of :data:`WRAPPERS` counted so far by
    ``flacx_torch.trace`` (which counts while it records)."""
    from flacx_torch import trace
    got = trace.snapshot()["counters"]
    return {k: got.get("launch." + k, 0) for k in WRAPPERS}


def graph_counts() -> dict:
    """What the encode streams did so far, by ``flacx_torch.trace``:
    ``runs`` of the pipeline that launch its kernels (its ``encode.emit``
    spans: eager batches and graph captures), graph ``captures`` and
    ``replays``."""
    from flacx_torch import trace
    got = trace.snapshot()
    return {"runs": len(got["spans"].get("encode.emit", ())),
            "captures": got["counters"].get("encode.graph_captures", 0),
            "replays": got["counters"].get("encode.graph_replays", 0)}


#: what an eager encode path does: no graph captured, none replayed
EAGER = {"captures": 0, "replays": 0}


def stream_graph(batches: int, seen: bool = False) -> dict:
    """:func:`graph_counts` of an ``encode_frame_stream`` of ``batches``
    batches of one shape on the card, unsharded and outside conformance
    mode, on an encoder without the shape's graph: the shape's first
    batch (none where ``seen``, the shape having run before) runs
    eagerly; a later batch that another follows captures the graph, which
    it and every later batch replay; a last batch with no graph runs
    eagerly."""
    runs = captures = replays = 0
    for i in range(batches):
        if captures:
            replays += 1
        elif not seen:
            runs, seen = runs + 1, True
        elif i + 1 < batches:
            runs, captures, replays = runs + 1, 1, 1
        else:
            runs += 1
    return {"runs": runs, "captures": captures, "replays": replays}


def counted_run(fn, needed, graph: dict | None = None) -> tuple:
    """``fn()`` with every launch counted; returns its result and the
    counts, and fails if a kernel in ``needed`` was launched no time, or
    where ``graph`` is given, if a key of it is not what
    :func:`graph_counts` counted in the run."""
    from flacx_torch import trace
    with trace.recording():
        before, graph_before = launch_counts(), graph_counts()
        out = fn()
        counts = {k: v - before[k] for k, v in launch_counts().items()}
        ran = {k: v - graph_before[k] for k, v in graph_counts().items()}
    missing = [k for k in needed if counts[k] < 1]
    if missing:
        raise AssertionError(f"path did not launch {missing}: {counts}")
    if graph is not None and any(ran[k] != v for k, v in graph.items()):
        raise AssertionError(f"encode stream ran {ran}, expected {graph}")
    return out, counts


def counted_frames(torch, enc, planar: np.ndarray, needed,
                   seen: bool = False) -> tuple:
    """``enc.encode_frames(planar, 0)`` with every launch counted, on an
    encoder without the shape's graph (``seen`` where the shape ran in an
    earlier stream): its eager batches and its capture launch every
    kernel, its replays none, as :func:`stream_graph` counts, or this
    fails.  Then, outside the count and the time, the same batches run
    eagerly (``encode_batch_device`` and the drain) must give the same
    bytes.  Returns the frames, the counts, the runs that launched (eager
    batches and captures) and the counted run's seconds."""
    b = enc.batch_frames
    graph = stream_graph(-(-len(planar) // b), seen)
    t0 = time.perf_counter()
    frames, counts = counted_run(lambda: enc.encode_frames(planar, 0),
                                 needed, graph)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    if counts["analysis"] != graph["runs"]:    # one launch a pipeline run
        raise AssertionError(f"launches {counts}, runs {graph}")
    same = []
    for s in range(0, len(planar), b):
        part = planar[s:s + b]
        same += enc._drain(enc.encode_batch_device(part, s), len(part), None)
    if same != frames:
        raise AssertionError("the stream's frames differ from the eager "
                             "path's")
    return frames, counts, graph["runs"], first_s


def subframe_params(frame) -> tuple:
    return (frame.header.channels,
            tuple((sf.kind, sf.order, sf.shift, sf.coefficients,
                   sf.wasted_bits) for sf in frame.subframes))


def blocks_of(pcm: np.ndarray, n: int, dtype=np.int16) -> np.ndarray:
    """Interleaved ``[samples, C]`` PCM as ``[frames, C, n]``."""
    return np.ascontiguousarray(
        pcm.reshape(-1, n, pcm.shape[1]).transpose(0, 2, 1).astype(dtype))


def check_frames(frames: list, planar: np.ndarray, cfg, what: str,
                 decode: int = 16, cpu: int = 16) -> tuple:
    """Every CRC-16 holds, the first ``decode`` frames decode bit-exactly
    at ``cfg.bps``, and the plain CPU path writes the same bytes on the
    first ``cpu`` of them wherever both chose the same coefficients;
    returns ``(decoded, frames that chose other coefficients)``."""
    from flacx_torch.crc import crc16
    from flacx_torch.encoder import BatchEncoder
    from flacx_torch.oracle.decoder import read_frame

    if len(frames) != len(planar):
        raise AssertionError(f"{what}: {len(frames)} frames, expected "
                             f"{len(planar)}")
    for i, fr in enumerate(frames):
        if crc16(fr[:-2]) != int.from_bytes(fr[-2:], "big"):
            raise AssertionError(f"{what} frame {i}: CRC-16 mismatch")
    decoded = [read_frame(fr, cfg.bps) for fr in frames[:decode]]
    for i, (_, planes) in enumerate(decoded):
        if not np.array_equal(np.asarray(planes), planar[i]):
            raise AssertionError(f"{what} frame {i} does not decode "
                                 "bit-exactly")
    cpu_frames = BatchEncoder(cfg, batch_frames=cpu, device="cpu") \
        .encode_frames(planar[:cpu], 0)
    differ = 0
    for i, (gpu_fr, cpu_fr) in enumerate(zip(frames, cpu_frames)):
        if gpu_fr == cpu_fr:
            continue
        if subframe_params(decoded[i][0]) == subframe_params(
                read_frame(cpu_fr, cfg.bps)[0]):
            raise AssertionError(f"{what} frame {i}: same coefficients on "
                                 "cuda and cpu but different bytes")
        differ += 1
    return decoded, differ


def time_path(torch, enc, planar: np.ndarray, reps: int) -> tuple:
    """``encode_frames`` ms per batch of ``enc.batch_frames`` over the
    whole input (host transfer and drain included), and the device
    pipeline's ms per batch (``encode_batch_device`` on one
    device-resident batch)."""
    batches = -(-len(planar) // enc.batch_frames)
    t0 = time.perf_counter()
    for _ in range(reps):
        enc.encode_frames(planar, 0)
    e2e_ms = (time.perf_counter() - t0) / reps / batches * 1e3
    dev_pcm = torch.from_numpy(planar[:enc.batch_frames]).cuda()
    dev_ms = median_ms(torch, lambda: enc.encode_batch_device(dev_pcm, 0),
                       reps)
    return e2e_ms, dev_ms


def headline_phase(torch, pcm: np.ndarray, streams: dict) -> list[dict]:
    """The headline batch: kernels against their plain versions, then the
    counted run, the frame checks and the timing; its frames go into
    ``streams`` for the decode phase."""
    from flacx_torch.encoder import BatchEncoder, EncoderConfig

    cfg = EncoderConfig(block_size=N, max_lpc_order=12)
    enc = BatchEncoder(cfg, batch_frames=B)
    planar = blocks_of(pcm, N)

    captured, restore = capture_main_path_inputs()
    try:
        enc.encode_frames(planar, 0)
    finally:
        restore()
    torch.cuda.synchronize()
    rows = [hold(torch, name, name, captured[name])
            for name in HEADLINE_SPIES]
    time_rows(torch, rows)
    del captured

    frames, counts, runs, first_s = counted_frames(
        torch, enc, planar, HEADLINE_SPIES, seen=True)
    print(f"main path launches {counts}", flush=True)
    for row in rows:
        row["launches"], row["batches"] = counts[row["name"]], runs

    _, differ = check_frames(frames, planar, cfg, "headline")
    streams["headline"] = (frames, pcm, 44100, 16, N)
    total_bytes = sum(map(len, frames))
    print(f"e2e frames {B}: all CRC-16 valid, 16 decoded bit-exact; "
          f"cpu plain path byte-equal on {16 - differ}/16 "
          f"({differ} chose other coefficients); "
          f"{total_bytes} bytes, ratio {total_bytes / planar.nbytes:.4f}",
          flush=True)

    reps = 5
    e2e_ms, dev_ms = time_path(torch, enc, planar, reps)
    sps = B * N * 2 / (e2e_ms / 1e3)
    print(f"e2e encode_frames: {e2e_ms:.3f} ms per {B}-frame batch, "
          f"{sps:.1f} samples/s; device pipeline {dev_ms:.3f} ms per batch "
          f"({B * N * 2 / (dev_ms / 1e3):.1f} samples/s); first call "
          f"{first_s * 1e3:.1f} ms", flush=True)
    return rows


def best_config(block_size: int, wasted_bits: bool = False):
    from flacx_torch.encoder import EncoderConfig
    return EncoderConfig(block_size=block_size, order_search="exact",
                         windows=BEST_WINDOWS, wasted_bits=wasted_bits)


BEST_PATH = ("analysis", "lpc_allorder", "lpc_residual_zz", "rice_stats",
             "frame_pack")


def best_rows(torch, bs: int, enc, planar: np.ndarray) -> list[dict]:
    """Every kernel of the best path at block ``bs`` against its plain
    version, on the arguments of its first launch in one batch: the f64
    analysis of the three windows (with the grouped ``conv1d`` yardstick),
    the first window's every-order statistics, the zigzag
    residual and Rice statistics of the four virtual channels, and the
    frame packing (the general layout at 1152)."""
    captured, restore = capture_main_path_inputs(BEST_PATH)
    try:
        enc.encode_batch_device(planar[:B], 0)
    finally:
        restore()
    torch.cuda.synchronize()
    rows = []
    for wrapper in BEST_PATH:
        name = {"analysis": "analysis_f64",
                "frame_pack": "frame_pack_general" if bs == 1152
                else "frame_pack"}.get(wrapper, wrapper)
        args = captured.pop(wrapper)
        if wrapper == "analysis":
            assert args[1].shape == (len(BEST_WINDOWS), bs), args[1].shape
            assert args[1].dtype == torch.float64
        if wrapper in ("lpc_allorder", "lpc_residual_zz", "rice_stats"):
            assert args[0].shape == (B, 4, bs), args[0].shape
        row = hold(torch, f"{name}@{bs}", wrapper, args)
        row["wrapper"] = wrapper
        rows.append(row)
    time_rows(torch, rows)
    return rows


def best_phase(torch, pcm: np.ndarray) -> list[dict]:
    """The best-compression encode of the same PCM at every block size:
    its kernels against their plain versions at each block size, then per
    block size the counted run, the frame checks and the timing; prints
    which block size ``encode --best`` would keep."""
    from flacx_torch.encoder import BatchEncoder

    rows, size_by_bs = [], {}
    for bs in BEST_BLOCKS:
        enc = BatchEncoder(best_config(bs), batch_frames=B)
        planar = blocks_of(pcm, bs)
        bs_rows = best_rows(torch, bs, enc, planar)
        # every window in one launch of analysis a run
        frames, counts, runs, _ = counted_frames(torch, enc, planar,
                                                 BEST_PATH)
        batches = -(-len(planar) // B)
        for row in bs_rows:
            row["launches"] = counts[row.pop("wrapper")]
            row["batches"] = runs
        rows += bs_rows
        _, differ = check_frames(frames, planar, enc.config, f"best {bs}")
        size_by_bs[bs] = sum(map(len, frames))
        e2e_ms, dev_ms = time_path(torch, enc, planar, 3)
        print(f"best {bs}: {len(frames)} frames in {batches} batches "
              f"({runs} launching), launches {counts}; all CRC-16 valid, "
              f"16 decoded bit-exact; "
              f"cpu plain path byte-equal on {16 - differ}/16 ({differ} "
              f"chose other coefficients); {size_by_bs[bs]} bytes, ratio "
              f"{size_by_bs[bs] / planar.nbytes:.4f}; encode_frames "
              f"{e2e_ms:.3f} ms per {B}-frame batch, device pipeline "
              f"{dev_ms:.3f} ms per batch", flush=True)
        del enc, planar, frames
    keep = min(BEST_BLOCKS, key=lambda bs: size_by_bs[bs])
    print(f"best: encode --best would keep block {keep} "
          f"({size_by_bs[keep]} bytes of {pcm.size * 2} PCM bytes)",
          flush=True)
    return rows


def wasted_phase(pcm: np.ndarray) -> None:
    """One 64-frame best-compression batch at block 4608 with wasted bits
    on PCM whose two low bits are clear (the 14-bit signal shifted left by
    2); in every odd frame the right channel is the left plus a little
    noise (again times 4), so a side-channel stereo mode wins there.  Every
    frame decodes bit-exactly, and every subframe strips the shared low
    zeros of the channel it codes: 2 for left, right and side, mid's own
    count for mid; side subframes must occur."""
    from flacx_torch.encoder import BatchEncoder
    from flacx_torch.format import Channels

    planar = blocks_of((pcm[:WASTED_FRAMES * N] >> 2) << 2, N)
    rng = np.random.default_rng(SEED + 1)
    noise = rng.integers(-3, 4, (WASTED_FRAMES // 2, N)) * 4
    planar[1::2, 1] = np.clip(planar[1::2, 0] + noise, -32768, 32764)
    cfg = best_config(N, wasted_bits=True)
    import torch
    frames, counts, _, _ = counted_frames(
        torch, BatchEncoder(cfg, batch_frames=WASTED_FRAMES), planar,
        BEST_PATH)
    decoded, differ = check_frames(frames, planar, cfg, "wasted bits",
                                   decode=WASTED_FRAMES)
    virtual = {Channels.L_R: ("L", "R"), Channels.L_S: ("L", "S"),
               Channels.S_R: ("S", "R"), Channels.M_S: ("M", "S")}
    seen = {}
    for i, (frame, _) in enumerate(decoded):
        left, right = (planar[i].astype(np.int64))
        chans = {"L": left, "R": right, "M": (left + right) >> 1,
                 "S": left - right}
        for name, sf in zip(virtual[frame.header.channels], frame.subframes):
            v = int(np.bitwise_or.reduce(chans[name]))
            bps = 17 if name == "S" else 16
            want = min((v & -v).bit_length() - 1 if v else 63, bps - 1)
            if sf.wasted_bits != want or (name != "M" and want != 2):
                raise AssertionError(f"wasted bits frame {i} channel {name}:"
                                     f" {sf.wasted_bits}, expected {want}")
            seen[name] = seen.get(name, 0) + 1
    if not seen.get("S"):
        raise AssertionError(f"wasted bits: no side subframe: {seen}")
    print(f"wasted bits: {WASTED_FRAMES} frames decoded bit-exact, every "
          f"subframe strips its channel's shared low zeros (subframes per "
          f"channel {seen}); launches {counts}; cpu plain path byte-equal on "
          f"{16 - differ}/16", flush=True)


HIRES_N = 16384
#: the hi-res batches: (channels, frames, frames decoded)
HIRES = {"hires": (2, 128, 4), "hires6": (6, 64, 2)}
HIRES_PATH = HEADLINE_SPIES


def hires_config(channels: int):
    """``BASELINE.json`` configs[2] (``bench.py``'s tracked hi-res entry):
    24-bit/96 kHz, block 16384, LPC order 32, partition orders 0..15,
    estimate order search."""
    from flacx_torch.encoder import EncoderConfig
    return EncoderConfig(block_size=HIRES_N, max_lpc_order=32, bps=24,
                         sample_rate=96000, channels=channels,
                         partition_orders=tuple(range(16)))


def hires_pcm(channels: int, frames: int) -> np.ndarray:
    """Interleaved 24-bit ``[frames * 16384, channels]`` int32 PCM: for
    stereo the two-tone signal times 256, clipped (as ``bench.py`` makes
    it); for 5.1 six distinct two-tone signals (LFE low) with a little
    noise, from the seed."""
    rng = np.random.default_rng(SEED)
    samples = frames * HIRES_N
    if channels == 2:
        pcm = synth_pcm(rng, samples).astype(np.float64) * 256
    else:
        t = np.arange(samples, dtype=np.float64) / 96000.0
        tones = ((261.6, 659.3), (329.6, 987.8), (196.0, 523.3),
                 (41.2, 82.4), (440.0, 1174.7), (349.2, 880.0))
        pcm = np.stack([
            (0.55 * np.sin(2 * np.pi * f1 * t + c)
             + 0.2 * np.sin(2 * np.pi * f2 * t + 0.5 * c)
             + 0.02 * rng.standard_normal(samples)) * (1 << 22)
            for c, (f1, f2) in enumerate(tones[:channels])], axis=1)
    return np.clip(pcm, -(1 << 23), (1 << 23) - 1).astype(np.int32)


def hires_phase(torch, label: str, streams: dict) -> list[dict]:
    """One hi-res batch (a key of :data:`HIRES`): every kernel mode of the
    path against its plain version on the arguments of its first launch,
    then the counted run, the frame checks and the timing; its frames go
    into ``streams`` for the decode phase."""
    from flacx_torch.encoder import BatchEncoder
    from flacx_torch.kernels import frame_pack as k_fp
    from flacx_torch.kernels import lpc_residual as k_lr
    from flacx_torch.kernels import rice_stats as k_rs
    from flacx_torch.ops.emit import param_slot_positions

    channels, frames, decode = HIRES[label]
    cfg = hires_config(channels)
    enc = BatchEncoder(cfg, batch_frames=frames)
    interleaved = hires_pcm(channels, frames)
    planar = blocks_of(interleaved, HIRES_N, np.int32)

    captured, restore = capture_main_path_inputs(HIRES_PATH)
    try:
        enc.encode_batch_device(planar, 0)
    finally:
        restore()
    torch.cuda.synchronize()
    names = {"analysis": "analysis",
             "lpc_residual_stats": "lpc_residual_stats_wide",
             "lpc_residual_zz": "lpc_residual_zz_wide",
             "rice_stats": "rice_stats",
             "frame_pack": "frame_pack"}
    for wrapper in ("lpc_residual_stats", "lpc_residual_zz"):
        args = captured[wrapper]
        assert k_lr.mac_width(args[4], args[5]) == "wide", wrapper
    zz, _, porders, kmax = captured["rice_stats"]
    assert k_rs.segment_log2(zz.shape[-1], max(porders), kmax) > 0
    assert zz.shape[-1] >> max(porders) == 1
    args = captured["frame_pack"]
    # psize 1: one param slot before every sample, none off the grid
    assert args[12] == 1 and args[4].shape[-1] == HIRES_N
    assert len(param_slot_positions(HIRES_N, 1)) == HIRES_N
    slots = args[0].shape[-1] + channels * (args[2].shape[-1] + 2 * HIRES_N)
    chunks = -(-slots // k_fp.CHUNK_SLOTS)
    stats_taps, stats_order = captured["lpc_residual_stats"][1:4:2]
    orders = np.unique(stats_order.cpu().numpy(), return_counts=True)
    print(f"{label}: lpc_residual rows by chosen LPC order (stats) "
          f"{dict(zip(*(a.tolist() for a in orders)))}; by MAC length: stats "
          f"{mac_lengths(stats_taps)}, zz "
          f"{mac_lengths(captured['lpc_residual_zz'][1])}", flush=True)
    rows = []
    for wrapper in HIRES_PATH:
        rows.append(hold(
            torch, f"{names[wrapper]}@{label}", wrapper, captured[wrapper],
            # flacx's segmented emit at one-sample partitions and, its
            # tile-string stack past 80 MiB, the leveled merge
            "flacx/kernels/emit_tile.py:298 + bitpack_tile.py:363 + "
            "bitpack_tile.py:444 + crc_tile.py:84"
            if wrapper == "frame_pack" else None))
        rows[-1]["wrapper"] = wrapper
    time_rows(torch, rows)
    del captured, zz, args, stats_taps, stats_order

    out, counts, runs, first_s = counted_frames(torch, enc, planar,
                                                HIRES_PATH)
    for row in rows:
        row["launches"], row["batches"] = counts[row.pop("wrapper")], runs
    _, differ = check_frames(out, planar, cfg, label, decode=decode,
                             cpu=decode)
    streams[label] = (out, interleaved, 96000, 24, HIRES_N)
    total = sum(map(len, out))
    pcm_bytes = planar.size * 3
    e2e_ms, dev_ms = time_path(torch, enc, planar, 3)
    samples = frames * HIRES_N * channels
    print(f"{label}: {frames} frames x {channels} channels x {HIRES_N}, "
          f"frame_pack {chunks} chunks of {k_fp.CHUNK_SLOTS} slots a frame "
          f"({cfg.max_frame_bytes} bytes a frame at most); launches "
          f"{counts}; all CRC-16 valid, {decode} "
          f"decoded bit-exact at 24-bit; cpu plain path byte-equal on "
          f"{decode - differ}/{decode} ({differ} chose other coefficients); "
          f"{total} bytes, ratio {total / pcm_bytes:.4f} of 24-bit PCM; "
          f"encode_frames {e2e_ms:.3f} ms per {frames}-frame batch "
          f"({samples / (e2e_ms / 1e3):.1f} samples/s), device pipeline "
          f"{dev_ms:.3f} ms per batch ({samples / (dev_ms / 1e3):.1f} "
          f"samples/s); first call {first_s * 1e3:.1f} ms", flush=True)
    return rows


#: the 25- to 32-bit batches at the headline settings: label -> width
#: (28-bit stereo has a 29-bit side channel; 32-bit stereo is independent)
HIBPS = {"hibps28": 28, "hibps32": 32}
HIBPS_NAMES = {"analysis": "analysis",
               "lpc_residual_stats": "lpc_residual_stats_wide",
               "lpc_residual_zz": "lpc_residual_zz_wide_i64",
               "rice_stats": "rice_stats_i64", "frame_pack": "frame_pack"}
#: frames of the 32-bit --best batch, of each batch held against the plain
#: CPU path, and decoded by the oracle; seconds of the 32-bit WAV
HIBPS_BEST, HIBPS_CPU, HIBPS_DECODE, HIBPS_WAV_SECONDS = 256, 256, 16, 30


def hibps_phase(torch, streams: dict) -> list[dict]:
    """The 25- to 32-bit encode at the headline settings (block 4608, LPC
    order 12, precision 5, partition orders 0..5, one Tukey(0.5) window)
    on 1024 frames of 28-bit and of 32-bit stereo (the working type
    int64): every kernel of the path on its int64 route held against its
    plain version on the arguments of its first launch, the counted run,
    every CRC-16, the first 256 frames against the plain CPU path, 16
    decoded by the oracle, the timing; the frames go into ``streams`` for
    the decode phase.  Then ``--best``'s block-4608 pass at 32 bits on 256
    frames (``lpc_allorder``, four sample limbs, int64 combine), and the
    CLI at the defaults on a 30 s 32-bit stereo WAV, decoded back."""
    import tempfile
    from pathlib import Path

    from flacx_torch import cli
    from flacx_torch.encoder import BatchEncoder, EncoderConfig
    from flacx_torch.kernels import analysis as k_an
    from flacx_torch.kernels import lpc_allorder as k_la
    from flacx_torch.kernels import lpc_residual as k_lr
    from flacx_torch.wavio import write_wav

    rows = []
    pcm32 = None
    for label, bps in HIBPS.items():
        cfg = EncoderConfig(block_size=N, max_lpc_order=12, bps=bps)
        enc = BatchEncoder(cfg, batch_frames=B)
        pcm = synth_pcm(np.random.default_rng(SEED + bps), N * B, bps)
        planar = blocks_of(pcm, N, np.int32)
        captured, restore = capture_main_path_inputs()
        try:
            enc.encode_batch_device(planar, 0)
        finally:
            restore()
        torch.cuda.synchronize()
        # every kernel on its int64 route
        assert cfg.work_dtype == torch.int64
        assert k_an.diff_width(captured["analysis"][3]) == "int64"
        for wrapper in ("lpc_residual_stats", "lpc_residual_zz"):
            args = captured[wrapper]
            assert k_lr.mac_width(args[4], args[5]) == "wide", wrapper
        assert captured["lpc_residual_zz"][6] == torch.int64
        assert captured["rice_stats"][0].dtype == torch.int64
        assert captured["frame_pack"][6].dtype == torch.int64
        group = []
        for wrapper in HEADLINE_SPIES:
            group.append(hold(torch, f"{HIBPS_NAMES[wrapper]}@{label}",
                              wrapper, captured[wrapper]))
            group[-1]["wrapper"] = wrapper
        time_rows(torch, group)
        del captured

        frames, counts, runs, first_s = counted_frames(torch, enc, planar,
                                                       HEADLINE_SPIES)
        for row in group:
            row["launches"], row["batches"] = counts[row.pop("wrapper")], runs
        rows += group
        _, differ = check_frames(frames, planar, cfg, label,
                                 decode=HIBPS_DECODE, cpu=HIBPS_CPU)
        streams[label] = (frames, pcm, 44100, bps, N)
        total = sum(map(len, frames))
        e2e_ms, dev_ms = time_path(torch, enc, planar, 3)
        print(f"{label}: {B} frames of {bps}-bit stereo ("
              f"{'side channel' if cfg.use_stereo_modes else 'independent'}"
              f", eff_bps {cfg.eff_bps}); launches {counts}; all CRC-16 "
              f"valid, {HIBPS_DECODE} decoded bit-exact; cpu plain path "
              f"byte-equal on {HIBPS_CPU - differ}/{HIBPS_CPU} ({differ} "
              f"chose other coefficients); {total} bytes, ratio "
              f"{total / (planar.size * 4):.4f} of 32-bit containers; "
              f"encode_frames {e2e_ms:.3f} ms per {B}-frame batch "
              f"({B * N * 2 / (e2e_ms / 1e3):.1f} samples/s), device "
              f"pipeline {dev_ms:.3f} ms per batch; first call "
              f"{first_s * 1e3:.1f} ms", flush=True)
        if bps == 32:
            pcm32 = pcm
        del enc, planar, frames

    # encode --best's block-4608 pass at 32 bits
    cfg = EncoderConfig(block_size=N, bps=32, order_search="exact",
                        windows=BEST_WINDOWS)
    enc = BatchEncoder(cfg, batch_frames=HIBPS_BEST)
    planar = blocks_of(pcm32[:HIBPS_BEST * N], N, np.int32)
    captured, restore = capture_main_path_inputs(("lpc_allorder",))
    try:
        enc.encode_batch_device(planar, 0)
    finally:
        restore()
    torch.cuda.synchronize()
    args = captured.pop("lpc_allorder")
    assert k_la.sample_limbs(args[3]) == 4
    assert k_lr.mac_width(args[3], args[4]) == "wide"
    row = hold(torch, "lpc_allorder@best32", "lpc_allorder", args)
    time_rows(torch, [row])
    frames, counts, runs, _ = counted_frames(torch, enc, planar, BEST_PATH)
    row["launches"], row["batches"] = counts["lpc_allorder"], runs
    rows.append(row)
    _, differ = check_frames(frames, planar, cfg, "best32",
                             decode=HIBPS_DECODE)
    e2e_ms, dev_ms = time_path(torch, enc, planar, 3)
    print(f"best32: {HIBPS_BEST} frames of 32-bit stereo, exact search, "
          f"three windows; launches {counts}; all CRC-16 valid, "
          f"{HIBPS_DECODE} decoded bit-exact; cpu plain path byte-equal on "
          f"{16 - differ}/16; encode_frames {e2e_ms:.3f} ms per batch, "
          f"device pipeline {dev_ms:.3f} ms", flush=True)
    del enc, planar, frames

    # the CLI at the defaults on a 32-bit stereo WAV, decoded back
    rate = 44100
    pcm = synth_pcm(np.random.default_rng(SEED + 33),
                    rate * HIBPS_WAV_SECONDS, 32)
    with tempfile.TemporaryDirectory() as tmp:
        wav, out = Path(tmp, "in32.wav"), Path(tmp, "out32.flac")
        write_wav(wav, rate, 32, pcm)
        t0 = time.perf_counter()
        # the CLI's batches of 256 frames
        _, counts = counted_run(lambda: cli.main(
            ["encode", str(wav), str(out)]), HEADLINE_SPIES,
            stream_graph(-(-(len(pcm) // N) // 256)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        data = out.read_bytes()
        info = check_flac(data, pcm, rate, 32, (N,), "hibps file")
        print(f"hibps file ({HIBPS_WAV_SECONDS} s of 32-bit stereo, the "
              f"CLI's defaults): wall {wall:.3f} s, "
              f"{HIBPS_WAV_SECONDS / wall:.1f}x realtime; {info['frames']} "
              f"frames, {len(data)} bytes; launches {counts}; STREAMINFO, "
              f"MD5, every CRC right, {FILE_DECODE} sampled frames and the "
              "last decoded bit-exact", flush=True)
        decode_file(cli, out, pcm, "hibps", HIBPS_WAV_SECONDS, tmp)
    return rows


DECODE_PATH = ("bit_unpack", "reconstruct", "crc16_rows")
#: the decode phase's streams and the batch sizes each is decoded at (the
#: CLI's default 256 first: its counted run gives the rows' launches)
DECODE_BATCHES = {"headline": (256, 1024), "fixed": (256,), "hires": (256,),
                  "hires6": (256,), "hibps28": (256,), "hibps32": (256,)}


def decode_row(torch, name: str, wrapper: str, args: tuple) -> dict:
    """The JSON row of a decode kernel, held against its plain version on
    ``args``, the arguments of its first launch on the decode path.  The
    JAX package runs these steps as XLA (no ``pallas_call``); ``replaces``
    names its functions."""
    from flacx_torch.kernels import bit_unpack as k_bu
    from flacx_torch.kernels import crc16_rows as k_crc
    from flacx_torch.kernels import reconstruct as k_rec

    csrc = "flacx_torch/kernels/csrc/"
    if wrapper == "bit_unpack":
        kind, order, n = args[5].long(), args[6].long(), args[9]
        symbols = int(torch.where(kind == 1, n, torch.where(
            kind >= 2, n - order, 0)).sum())
        # about 40 integer operations a symbol: the window from three
        # words, the parameter field, clz, remainder, zigzag, cursor
        return kernel_row(
            torch, name, "bit_unpack_kernel", k_bu.bit_unpack,
            k_bu.bit_unpack_plain, args, exact,
            [(40 * symbols, SCALAR_OPS_PER_S)], csrc + "bit_unpack.cu",
            "flacx/ops/bitunpack.py:146 + :42 (XLA)")
    if wrapper == "reconstruct":
        vals, order, kind, use_i32 = args[0], args[3], args[4], args[12]
        # a multiply-add a tap up to each subframe's order and sample, two
        # operations (four in the int64 MAC; on the all-fixed route the
        # add and the carry of an integration level), and 8 a sample
        # besides (merge, shift, wasted bits, undecorrelation, store)
        macs = int((order.long() * (kind >= 2)).sum()) * vals.shape[-1]
        return kernel_row(
            torch, name, "reconstruct_kernel", k_rec.reconstruct,
            k_rec.reconstruct_plain, args, exact,
            [(macs * (2 if use_i32 else 4) + vals.numel() * 8,
              SCALAR_OPS_PER_S)], csrc + "reconstruct.cu",
            "flacx/ops/reconstruct.py:18 + :73 + :141 + :184, "
            "flacx/decoder.py:399-427 (XLA)")
    rows, lens = args
    # the frame bytes themselves (not the row padding), a lookup, a shift
    # and an XOR a byte of each body
    body = int(lens.long().sum())
    return kernel_row(
        torch, name, "crc16_rows_kernel", k_crc.crc16_rows,
        k_crc.crc16_rows_plain, args, exact,
        [(3 * body, SCALAR_OPS_PER_S)], csrc + "crc16_rows.cu",
        "flacx/ops/crcfold.py:142, flacx/decoder.py:428-437 (XLA)",
        moved=body + 8 * lens.numel() + 4)


def flac_stream(frames: list, pcm: np.ndarray, rate: int, bps: int,
                n: int) -> bytes:
    """A FLAC stream of ``frames`` (fixed blocks of ``n``) with the MD5 of
    the interleaved ``pcm`` they code."""
    import io

    from flacx_torch.stream import StreamWriter

    f = io.BytesIO()
    w = StreamWriter(f, rate, bps, pcm.shape[1], len(pcm), n)
    w.add_pcm(pcm)
    w.write_frames(frames)
    w.finalize()
    return f.getvalue()


def spy_decoder(names) -> tuple:
    """Wrap functions of ``flacx_torch.decoder``: records the arguments of
    each one's first call and counts its calls; returns ``(captured,
    calls, restore)``."""
    import flacx_torch.decoder as dec

    captured, calls, originals = {}, {}, []
    for name in names:
        fn = getattr(dec, name)
        originals.append((name, fn))

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            captured.setdefault(_name, args)
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kwargs)
        setattr(dec, name, wrapped)

    def restore():
        for name, fn in originals:
            setattr(dec, name, fn)
    return captured, calls, restore


def fixed_frames(pcm: np.ndarray) -> list:
    """The headline PCM encoded with fixed predictors only
    (``max_lpc_order=0``), one 1024-frame batch on the card."""
    from flacx_torch.encoder import BatchEncoder, EncoderConfig

    cfg = EncoderConfig(block_size=N, max_lpc_order=0)
    return BatchEncoder(cfg, batch_frames=B).encode_frames(blocks_of(pcm, N),
                                                          0)


def decode_times(torch, data: bytes, bf: int, batches: int, samples: int,
                 dd_args: tuple) -> str:
    """The decode's times at ``bf`` frames a batch, as text: the wall of
    ``decode_array`` (three runs) and its walker time a batch, decoded
    samples/s, and for the first batch (``dd_args``, the arguments of its
    ``_device_decode``) the device pipeline and the copies: H2D of its
    rows and walker output from pinned memory, D2H of its PCM."""
    import flacx_torch.decoder as dec

    walker = []
    scan_frames = dec.scan_frames

    def timed_scan(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return scan_frames(*args, **kwargs)
        finally:
            walker.append(time.perf_counter() - t0)
    dec.scan_frames = timed_scan
    reps = 3
    try:
        t0 = time.perf_counter()
        for _ in range(reps):
            dec.decode_array(data, batch_frames=bf, device="cuda")
        wall = (time.perf_counter() - t0) / reps
    finally:
        dec.scan_frames = scan_frames
    dev_ms = median_ms(torch, lambda: dec._device_decode(*dd_args), 10)
    pcm = dec._device_decode(*dd_args)[0]
    moved = nbytes(dd_args[0], dd_args[1], dd_args[2])
    staged = torch.empty(moved, dtype=torch.uint8, pin_memory=True)
    h2d_ms = median_ms(torch, lambda: staged.to("cuda", non_blocking=True),
                       10)
    d2h_ms = median_ms(torch, lambda: pcm.cpu(), 10)
    if min(wall, dev_ms, h2d_ms, d2h_ms) <= 0:
        raise AssertionError(f"non-positive decode timing: wall {wall} s, "
                             f"device {dev_ms}, H2D {h2d_ms}, D2H {d2h_ms}")
    return (f"wall {wall / batches * 1e3:.3f} ms a batch, "
            f"{samples / wall:.1f} decoded samples/s; walker "
            f"{sum(walker) / reps / batches * 1e3:.3f} ms a batch; first "
            f"batch ({dd_args[0].shape[0]} frames): device {dev_ms:.3f} ms "
            f"(_device_decode), copy {h2d_ms + d2h_ms:.3f} ms (H2D "
            f"{h2d_ms:.3f} of {moved} pinned bytes, D2H {d2h_ms:.3f} of "
            f"{pcm.numel() * 4} PCM bytes)")


def decode_phase(torch, streams: dict) -> list[dict]:
    """``decode_array`` on the card over the streams the encode phases
    wrote (label → frames, interleaved PCM, rate, width, block): each
    kernel held against its plain version on its first launch's
    arguments, then counted decodes at each batch size of
    :data:`DECODE_BATCHES` (bit-exact against the source PCM, every kernel
    launched, every batch on the device route: no host parse, no
    sequential decode) and the timing: wall, walker, copy and device ms a
    batch, decoded samples/s."""
    import flacx_torch.decoder as dec
    from flacx_torch.kernels import crc16_rows as k_crc
    from flacx_torch.native import wide_state

    card = card_line()
    rows = []
    for label, (frames, pcm, rate, bps, n) in streams.items():
        data = flac_stream(frames, pcm, rate, bps, n)
        captured, _, restore = spy_decoder(DECODE_PATH + ("_device_decode",))
        try:
            dec.decode_array(data, device="cuda")
        finally:
            restore()
        torch.cuda.synchronize()
        rec = captured["reconstruct"]
        route = ("fixed" if rec[14] is not None else
                 "chunk" if rec[9] is not None else "serial")
        route += "" if rec[12] else "_wide"
        if (label == "fixed") != route.startswith("fixed"):
            raise AssertionError(f"decode {label}: route {route}")
        # past 24 bits the chunk route at every width, the walker's state
        # int64 past 31 bits
        if label in HIBPS:
            want = torch.int64 if wide_state(bps, pcm.shape[1]) \
                else torch.int32
            got = None if rec[9] is None else rec[9].dtype
            if route != "chunk_wide" or got != want:
                raise AssertionError(f"decode {label}: route {route}, "
                                     f"state {got}, expected {want}")
        # the serial route at 32 bits: this batch with the state dropped
        serial_args = (rec[:9] + (None, 0) + rec[11:]
                       if label == "hibps32" else None)
        group = []
        for wrapper in DECODE_PATH:
            mode = f"_{route}" if wrapper == "reconstruct" else ""
            group.append(hold(torch, f"{wrapper}{mode}@{label}", wrapper,
                              captured[wrapper]))
        # the launch floor: an empty kernel on crc16_rows' grid (clusters
        # included), in the same trace
        crc_f, crc_w = captured["crc16_rows"][0].shape
        floor = time_rows(torch, group, extra={
            "flacx_empty_kernel": lambda: k_crc.empty(
                torch.device("cuda"), crc_f, crc_w)})["flacx_empty_kernel"]
        print(f"launch floor @{label}: empty kernel on crc16_rows' grid for "
              f"{crc_f} rows of {crc_w} bytes {floor:.4f} ms "
              f"(crc16_rows@{label} "
              f"{group[-1]['ms']:.4f} ms, bound {group[-1]['bound_ms']:.4f})",
              flush=True)

        del captured, rec
        for bf in DECODE_BATCHES[label]:
            stats = {}
            captured, _, restore = spy_decoder(("_device_decode",))
            try:
                (_, got), counts = counted_run(
                    lambda: dec.decode_array(data, batch_frames=bf,
                                             device="cuda", stats=stats),
                    DECODE_PATH)
            finally:
                restore()
            batches = -(-(len(pcm) // n) // bf)
            if not np.array_equal(got, pcm):
                raise AssertionError(f"decode {label} at {bf}: not "
                                     "bit-exact")
            if (stats.get("host") or stats.get("sequential")
                    or stats.get("device") != batches):
                raise AssertionError(f"decode {label} at {bf}: routes "
                                     f"{stats}, {batches} batches")
            if bf == DECODE_BATCHES[label][0]:
                for row, wrapper in zip(group, DECODE_PATH):
                    row["launches"], row["batches"] = counts[wrapper], batches
            print(f"decode {label} ({len(pcm) // n} frames x "
                  f"{pcm.shape[1]} channels x {n}, {bps}-bit, reconstruct "
                  f"{route}) batch {bf}: {batches} batches, bit-exact, "
                  f"routes {stats}, launches {counts}; "
                  + decode_times(torch, data, bf, batches, pcm.size,
                                 captured["_device_decode"])
                  + f"; card {card}", flush=True)
            del captured
        rows += group
        if label == "headline":
            rows.append(serial_row(torch, data, pcm))
        if serial_args is not None:
            rows.append(serial_wide_row(torch, label, data, pcm, n,
                                        serial_args))
            del serial_args
    return rows


#: conformance mode's own kernels (the JAX package runs their work as XLA,
#: flacx/conformance.py), and every kernel its encode launches
CONF_KERNELS = ("reference_lpc", "abs_residual_sums")
CONF_PATH = CONF_KERNELS + ("lpc_residual_zz", "frame_pack")
#: the conformance phase's frames compared with the plain CPU path, and
#: frames drawn from the seed compared with the oracle encoder
CONF_CPU, CONF_ORACLE = 256, 16


def bits_equal(torch, a, b):
    """Every output equal, f64 ones as bits."""
    for u, v in zip(a, b):
        if u.dtype == torch.float64:
            u, v = u.view(torch.int64), v.view(torch.int64)
        if not torch.equal(u, v):
            diff = (u.long() - v.long()).abs().max().item()
            raise AssertionError(f"kernel differs from plain: {diff}")
    return 0


def conformance_row(torch, name: str, wrapper: str, args: tuple,
                    add_s: float) -> dict:
    """The JSON row of a ``reference_analysis`` kernel held against its
    plain version on ``args``, exactly (f64 as bits).  ``reference_lpc``'s
    bound: the larger of its bytes and its chain of n - 1 dependent f64
    adds at ``add_s`` each (every row's chain runs in parallel); counted as
    operations at one add a latency.  ``abs_residual_sums``', on both MACs:
    the LPC multiply-adds as 8-bit limb products (:func:`limb_ops`, the
    sample limbs of ``eff_bps``) at the int8 tensor rate; the fixed-order
    differences (four a sample) and the epilogue's four operations a
    residual (shift, subtract, abs, add; 5 + P residuals a sample) at the
    scalar rate."""
    from flacx_torch.kernels import reference_analysis as k_ra

    csrc = "flacx_torch/kernels/csrc/reference_analysis.cu"
    x = args[0]
    n = x.shape[-1]
    if wrapper == "reference_lpc":
        return kernel_row(
            torch, name, "reference_lpc_kernel", k_ra.reference_lpc,
            k_ra.reference_lpc_plain, args, bits_equal,
            [(n - 1, 1.0 / add_s)], csrc, "flacx/conformance.py:325-329 "
            "(XLA: window, ordered_autocorr, levinson_reference, "
            "quantize_reference)")
    qcoefs, eff_bps = args[1], args[3]
    residuals = x.numel() * (5 + qcoefs.shape[-1])
    work = [(limb_ops(n, qcoefs.flatten(-2), k_ra.sample_limbs(eff_bps)),
             INT8_TENSOR_OPS_PER_S),
            (4 * x.numel() + 4 * residuals, SCALAR_OPS_PER_S)]
    return kernel_row(
        torch, name, "abs_residual_sums_kernel", k_ra.abs_residual_sums,
        k_ra.abs_residual_sums_plain, args, exact, work, csrc,
        "flacx/conformance.py:307-319 + :330-333 (XLA)")


#: conformance mode at the hi-res shape: the hi-res stereo PCM at block
#: 16384, LPC order 32, precision 15 (the wide MAC, three sample limbs, hi
#: tap limbs, 33 lags)
CONF_HIRES_FRAMES = 64


def conformance_hires(torch, add_s: float) -> list[dict]:
    """``EncoderConfig(conformance=True)`` on :data:`CONF_HIRES_FRAMES`
    frames of the hi-res stereo PCM (``hires_config(2)`` at precision 15):
    both ``reference_analysis`` kernels against their plain versions on the
    arguments of their first launch (rows ``<kernel>@conformance_hires``),
    the counted run, every CRC-16, and the frames decoded on the card bit-
    exactly against the PCM."""
    import dataclasses

    import flacx_torch.conformance as conf
    from flacx_torch import decoder
    from flacx_torch.crc import crc16
    from flacx_torch.encoder import BatchEncoder

    cfg = dataclasses.replace(hires_config(2), qlp_precision=15,
                              conformance=True)
    pcm = hires_pcm(2, CONF_HIRES_FRAMES)
    planar = blocks_of(pcm, HIRES_N, np.int32)
    enc = BatchEncoder(cfg, batch_frames=CONF_HIRES_FRAMES)
    captured, restore = capture_main_path_inputs(CONF_KERNELS, module=conf)
    try:
        enc.encode_frames(planar, 0)
    finally:
        restore()
    torch.cuda.synchronize()
    rows = [hold(torch, f"{name}@conformance_hires", name, captured[name],
                 add_s=add_s) for name in CONF_KERNELS]
    time_rows(torch, rows)
    del captured
    frames, counts = counted_run(lambda: enc.encode_frames(planar, 0),
                                 CONF_KERNELS, EAGER)
    for row in rows:
        row["launches"] = counts[row["name"].split("@")[0]]
        row["batches"] = 1
    if len(frames) != CONF_HIRES_FRAMES:
        raise AssertionError(f"conformance_hires: {len(frames)} frames")
    for i, fr in enumerate(frames):
        if crc16(fr[:-2]) != int.from_bytes(fr[-2:], "big"):
            raise AssertionError(f"conformance_hires frame {i}: CRC-16 "
                                 "mismatch")
    routes = {}
    _, got = decoder.decode_array(flac_stream(frames, pcm, 96000, 24,
                                              HIRES_N), device="cuda",
                                  stats=routes)
    if not np.array_equal(got, pcm):
        raise AssertionError("conformance_hires: decode not bit-exact")
    print(f"conformance_hires frames {CONF_HIRES_FRAMES} (block {HIRES_N}, "
          f"order 32, precision 15): launches {counts}; all CRC-16 valid; "
          f"decoded on the card bit-exactly ({routes}); "
          f"{sum(map(len, frames))} bytes", flush=True)
    return rows


def crafted_overflow() -> list:
    """Batches that take the overflow route: ``(label, config, [F, 2, n]
    blocks, overflow flags)``.  A spike in low noise (a Rice quotient past
    32 bits under the reference's mean-estimate parameter) at block 256,
    LPC order 4, partition order 0; full-scale white noise at the headline
    block (about 16.5 bits a sample, past the verbatim-sized buffer)."""
    from flacx_torch.encoder import EncoderConfig

    rng = np.random.default_rng(SEED + 3)
    spikes = rng.integers(-2, 3, size=(4, 2, 256)).astype(np.int16)
    spikes[0, 0, 40] = 30000
    spikes[2, 1, 100] = -30000
    loud = rng.integers(-32768, 32768, size=(2, 2, N)).astype(np.int16)
    loud[1] = blocks_of(synth_pcm(rng, N), N)[0]
    return [("spike", EncoderConfig(block_size=256, max_lpc_order=4,
                                    partition_orders=(0,), conformance=True),
             spikes, [True, False, True, False]),
            ("buffer", EncoderConfig(block_size=N, max_lpc_order=12,
                                     conformance=True), loud, [True, False])]


def conformance_phase(torch, pcm: np.ndarray) -> list[dict]:
    """Conformance mode (``EncoderConfig(conformance=True)``: the reference
    encoder's choices) on the headline batch through ``BatchEncoder``: its
    kernels held against their plain versions (rows
    ``<kernel>@conformance``), the counted run, every CRC-16, the first
    :data:`CONF_CPU` frames byte-equal to the plain CPU path,
    :data:`CONF_ORACLE` sampled frames equal to the oracle encoder's and
    decoded bit-exactly, the crafted overflow batches on the oracle route,
    the timing, and the CD rip through ``pipeline.encode_to_file``."""
    import io

    import flacx_torch.conformance as conf
    from flacx_torch import pipeline
    from flacx_torch.crc import crc16
    from flacx_torch.encoder import BatchEncoder, EncoderConfig
    from flacx_torch.kernels.reference_analysis import dadd_latency_probe
    from flacx_torch.oracle.decoder import read_frame

    dev = torch.device("cuda")
    cfg = EncoderConfig(block_size=N, max_lpc_order=12, conformance=True)
    enc = BatchEncoder(cfg, batch_frames=B)
    planar = blocks_of(pcm, N)

    def oracle(blocks, first, c):
        return [pipeline._oracle_frame(blk.T, first + i, c.bps,
                                       c.block_size, c.max_lpc_order,
                                       c.qlp_precision, c.partition_orders)
                for i, blk in enumerate(blocks)]

    captured, restore = capture_main_path_inputs(CONF_PATH, module=conf)
    try:
        enc.encode_frames(planar, 0)
    finally:
        restore()
    torch.cuda.synchronize()
    steps = 1 << 22
    add_s = median_ms(torch, lambda: dadd_latency_probe(steps, dev),
                      5) / steps / 1e3
    print(f"conformance: f64 add latency {add_s * 1e9:.4f} ns (one thread, "
          f"a chain of {steps} adds)", flush=True)
    rows = [hold(torch, f"{name}@conformance", name, captured[name],
                 replaces=("flacx/kernels/bitpack_tile.py:316 + "
                           "bitpack_tile.py:268 (via flacx/conformance.py"
                           ":412 pack_symbols_words)"), add_s=add_s)
            for name in CONF_PATH]
    rows[2]["replaces"] = ("flacx/conformance.py:366-369 + :380 (XLA: the "
                           "chosen residual's zigzag)")
    time_rows(torch, rows)
    del captured

    t0 = time.perf_counter()
    frames, counts = counted_run(lambda: enc.encode_frames(planar, 0),
                                 CONF_PATH, EAGER)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    for row in rows:
        row["launches"] = counts[row["name"].split("@")[0]]
        row["batches"] = 1
    overflow = int(enc.encode_batch_device(planar, 0)["overflow"].sum())
    if len(frames) != B:
        raise AssertionError(f"conformance: {len(frames)} frames")
    for i, fr in enumerate(frames):
        if crc16(fr[:-2]) != int.from_bytes(fr[-2:], "big"):
            raise AssertionError(f"conformance frame {i}: CRC-16 mismatch")
    cpu = BatchEncoder(cfg, batch_frames=CONF_CPU, device="cpu") \
        .encode_frames(planar[:CONF_CPU], 0)
    differ = [i for i in range(CONF_CPU) if cpu[i] != frames[i]]
    if differ:
        raise AssertionError(f"conformance: frames {differ[:8]} differ from "
                             "the plain CPU path")
    pick = sorted(np.random.default_rng(SEED).choice(
        B, CONF_ORACLE, replace=False).tolist())
    for i in pick:
        if frames[i] != oracle(planar[i:i + 1], i, cfg)[0]:
            raise AssertionError(f"conformance frame {i}: not the oracle's")
        if not np.array_equal(np.asarray(read_frame(frames[i], 16)[1]),
                              planar[i]):
            raise AssertionError(f"conformance frame {i}: not bit-exact")
    total = sum(map(len, frames))
    print(f"conformance e2e frames {B}: launches {counts}; all CRC-16 "
          f"valid; the first {CONF_CPU} byte-equal to the plain CPU path; "
          f"{CONF_ORACLE} sampled frames the oracle's and bit-exact; "
          f"{overflow} overflow frames; {total} bytes, ratio "
          f"{total / planar.nbytes:.4f}", flush=True)

    for label, ocfg, blocks, want in crafted_overflow():
        oenc = BatchEncoder(ocfg, batch_frames=len(blocks))
        got = oenc.encode_batch_device(blocks, 0)["overflow"].tolist()
        if got != want:
            raise AssertionError(f"conformance {label}: overflow {got}")
        if oenc.encode_frames(blocks, 0) != oracle(blocks, 0, ocfg):
            raise AssertionError(f"conformance {label}: not the oracle's")
        print(f"conformance overflow batch {label}: flags {got}, frames the "
              "oracle's", flush=True)

    e2e_ms, dev_ms = time_path(torch, enc, planar, 3)
    print(f"conformance e2e encode_frames: {e2e_ms:.3f} ms per {B}-frame "
          f"batch, {B * N * 2 / (e2e_ms / 1e3):.1f} samples/s; device "
          f"pipeline {dev_ms:.3f} ms per batch; first call "
          f"{first_s * 1e3:.1f} ms", flush=True)

    cd, rate, bps = file_inputs()["cd"]
    buf = io.BytesIO()
    t0 = time.perf_counter()
    stats, counts = counted_run(lambda: pipeline.encode_to_file(
        buf, cd, sample_rate=rate, bps=bps, channels=2, block_size=N,
        max_lpc_order=12, qlp_precision=5,
        partition_orders=(0, 1, 2, 3, 4, 5), batch_frames=FILE_BATCH,
        conformance=True), CONF_PATH, EAGER)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    info = check_flac(buf.getvalue(), cd, rate, bps, (N,), "conformance file")
    print(f"conformance file ({CD_SECONDS} s of 16-bit stereo, "
          f"encode_to_file(conformance=True)): wall {wall:.3f} s, "
          f"{CD_SECONDS / wall:.1f}x realtime; {info['frames']} frames, "
          f"{stats['bytes_out']} bytes; launches {counts}; STREAMINFO, MD5, "
          "every CRC right, sampled frames bit-exact", flush=True)
    return rows + conformance_hires(torch, add_s)


def serial_row(torch, data: bytes, pcm: np.ndarray) -> dict:
    """``reconstruct``'s serial route (``decoder._decode_rows``, the host
    parse: int64, the IIR over every tap) on the headline stream forced
    down it (every batch's device decode refused, so each takes the host
    route): bit-exact, its launches counted, the kernel held against its
    plain version on the first batch's arguments."""
    import flacx_torch.decoder as dec

    bf = DECODE_BATCHES["headline"][0]
    device_rows = dec._decode_rows_device
    dec._decode_rows_device = lambda *args, **kwargs: None
    captured, _, restore = spy_decoder(("reconstruct",))
    stats = {}
    try:
        (_, got), counts = counted_run(
            lambda: dec.decode_array(data, batch_frames=bf, device="cuda",
                                     stats=stats), ("reconstruct",))
    finally:
        restore()
        dec._decode_rows_device = device_rows
    batches = -(-(len(pcm) // N) // bf)
    if not np.array_equal(got, pcm) or stats.get("host") != batches:
        raise AssertionError(f"serial decode: routes {stats}")
    row = hold(torch, "reconstruct_serial@headline", "reconstruct",
               captured["reconstruct"])
    row["launches"], row["batches"] = counts["reconstruct"], batches
    time_rows(torch, [row])
    print(f"decode headline forced down _decode_rows: {batches} batches, "
          f"bit-exact, routes {stats}, launches {counts}", flush=True)
    return row



def serial_wide_row(torch, label: str, data: bytes, pcm: np.ndarray, n: int,
                    args: tuple) -> dict:
    """``reconstruct``'s serial route at 32 bits, the route the device
    decode of ``label`` took before the walker's int64 sample state: held
    against its plain version and timed on ``args`` (the stream's first
    batch with the state dropped); its launches are those of the stream
    forced down the host parse (``_decode_rows``, the serial route; none
    on the device route), bit-exact."""
    import flacx_torch.decoder as dec

    bf = DECODE_BATCHES[label][0]
    device_rows = dec._decode_rows_device
    dec._decode_rows_device = lambda *args, **kwargs: None
    stats = {}
    try:
        (_, got), counts = counted_run(
            lambda: dec.decode_array(data, batch_frames=bf, device="cuda",
                                     stats=stats), ("reconstruct",))
    finally:
        dec._decode_rows_device = device_rows
    batches = -(-(len(pcm) // n) // bf)
    if not np.array_equal(got, pcm) or stats.get("host") != batches:
        raise AssertionError(f"serial decode {label}: routes {stats}")
    row = hold(torch, f"reconstruct_serial_wide@{label}", "reconstruct",
               args)
    row["launches"], row["batches"] = counts["reconstruct"], batches
    time_rows(torch, [row])
    print(f"decode {label} forced down _decode_rows: {batches} batches, "
          f"bit-exact, routes {stats}, launches {counts}", flush=True)
    return row


#: the file phase: a CD rip (3 minutes of 16-bit stereo at 44.1 kHz) and a
#: 24-bit stereo master (60 s at 48 kHz), the CLI's default --batch-frames
CD_RATE, CD_SECONDS = 44100, 180
MASTER_RATE, MASTER_SECONDS = 48000, 60
EXCERPT_SECONDS = 20
FILE_BATCH = 256
FILE_DECODE = 16
RES_PATH = ("analysis", "lpc_residual_res", "lpc_residual_zz", "rice_stats",
            "frame_pack")
#: label -> (input, CLI flags, kernels its encode must launch)
FILE_RUNS = {
    "default": ("cd", (), HEADLINE_SPIES),
    "b1152": ("cd", ("-b", "1152"), RES_PATH),
    "best": ("master", ("--best",), BEST_PATH),
}


def file_inputs() -> dict:
    """The file phase's PCM, interleaved ``[samples, 2]`` int32, with its
    rate and width: the headline's two-tone signal, and for the master
    that signal at 48 kHz times 256, clipped to 24 bits."""
    rng = np.random.default_rng(SEED + 2)
    cd = synth_pcm(rng, CD_RATE * CD_SECONDS)
    master = np.clip(synth_pcm(rng, MASTER_RATE * MASTER_SECONDS)
                     .astype(np.int64) * 256, -(1 << 23), (1 << 23) - 1)
    return {"cd": (cd, CD_RATE, 16),
            "master": (master.astype(np.int32), MASTER_RATE, 24)}


def frame_starts(data: bytes, first: int, n: int, samples: int,
                 ) -> np.ndarray:
    """Byte offsets of the frames of a fixed-blocksize stream of
    ``samples`` samples a channel in blocks of ``n`` whose first frame
    starts at ``first``: each the next sync code whose header parses, with
    a valid CRC-8, as the next frame's (its number, its block size, rate
    and width from STREAMINFO, as this encoder writes them).  Random
    residual bytes pass that now and then; a false start would fail the
    CRC-16 check, not pass it."""
    from flacx_torch.bitio import BitReader
    from flacx_torch.oracle.decoder import read_frame_header

    d = np.frombuffer(data, np.uint8)
    cand = np.nonzero((d[:-1] == 0xFF) & (d[1:] == 0xF8))[0]
    cand = iter(cand[cand >= first].tolist())
    count = -(-samples // n)
    starts = []
    for k in range(count):
        want = (k, min(n, samples - k * n), None, None)
        for c in cand:
            try:
                h = read_frame_header(BitReader(data[c:c + 16]))
            except (ValueError, EOFError):
                continue
            if (h.coded_number, h.block_size, h.sample_rate,
                    h.sample_size) == want:
                starts.append(c)
                break
        else:
            raise AssertionError(f"frame {k} of {count} not found")
    if starts[0] != first:
        raise AssertionError(f"first frame at {starts[0]}, not {first}")
    return np.asarray(starts)


def crc16_ok(data: bytes, starts: np.ndarray) -> None:
    """Every frame's CRC-16 holds: the CRC of a frame with its stored CRC
    appended is 0 (rows of frames advance together, a column a byte)."""
    from flacx_torch.crc import crc_table
    from flacx_torch.format import CRC16_POLYNOMIAL

    table = crc_table(16, CRC16_POLYNOMIAL).astype(np.int64)
    d = np.frombuffer(data, np.uint8)
    ends = np.append(starts[1:], len(d))
    for a in range(0, len(starts), 512):
        s, e = starts[a:a + 512], ends[a:a + 512]
        crc = np.zeros(len(s), np.int64)
        for j in range(int((e - s).max())):
            on = s + j < e
            byte = d[np.minimum(s + j, len(d) - 1)]
            nxt = table[(crc >> 8) ^ byte] ^ ((crc << 8) & 0xFFFF)
            crc = np.where(on, nxt, crc)
        bad = np.nonzero(crc)[0]
        if len(bad):
            raise AssertionError(f"frame {a + bad[0]}: CRC-16 mismatch")


def check_flac(data: bytes, pcm: np.ndarray, rate: int, bps: int,
               blocks: tuple, what: str) -> dict:
    """STREAMINFO's sample count, block size (one of ``blocks``), min/max
    frame sizes and MD5 are right; every frame's CRC-8 and CRC-16 hold;
    :data:`FILE_DECODE` frames drawn from the seed and the last frame
    decode bit-exactly.  Returns the block size, frame count and sizes."""
    import hashlib

    from flacx_torch.bitio import BitReader
    from flacx_torch.format import MetadataBlockType
    from flacx_torch.oracle.decoder import (read_frame, read_metadata_header,
                                            read_streaminfo)
    from flacx_torch.wavio import pcm_to_le_bytes

    r = BitReader(data)
    head = r.read_bytes(4)
    meta = read_metadata_header(r)
    si = read_streaminfo(r)
    n = si.min_block_size
    want = (b"fLaC", True, MetadataBlockType.Streaminfo, 34, n, rate, 2, bps,
            len(pcm))
    got = (head, meta.last, meta.type, meta.length, si.max_block_size,
           si.sample_rate, si.channels, si.sample_size, si.samples)
    if got != want or n not in blocks:
        raise AssertionError(f"{what}: STREAMINFO {si}")
    if si.md5 != hashlib.md5(pcm_to_le_bytes(pcm, bps)).digest():
        raise AssertionError(f"{what}: STREAMINFO MD5 is not the PCM's")
    count = -(-len(pcm) // n)
    starts = frame_starts(data, 42, n, len(pcm))
    sizes = np.diff(np.append(starts, len(data)))
    if (si.min_frame_size, si.max_frame_size) != (sizes.min(), sizes.max()):
        raise AssertionError(f"{what}: frame sizes {sizes.min()}.."
                             f"{sizes.max()}, STREAMINFO {si}")
    crc16_ok(data, starts)
    rng = np.random.default_rng(SEED + len(pcm))
    pick = sorted(set(rng.choice(count - 1, FILE_DECODE, replace=False)
                      .tolist()) | {count - 1})
    for i in pick:
        _, planes = read_frame(data[starts[i]:starts[i] + sizes[i]], bps)
        if not np.array_equal(np.asarray(planes).T, pcm[i * n:(i + 1) * n]):
            raise AssertionError(f"{what} frame {i} does not decode "
                                 "bit-exactly")
    return {"block": n, "frames": count, "starts": starts, "sizes": sizes}


def same_file(card: bytes, cpu: bytes, bps: int, what: str) -> int:
    """The card's and the CPU's files of one input are byte-equal wherever
    both chose the same coefficients: returns the frames that chose
    others (STREAMINFO may differ only in its frame sizes then)."""
    from flacx_torch.oracle.decoder import read_frame

    if card == cpu:
        return 0
    # STREAMINFO at bytes 8..41: block sizes, frame sizes (12..17), then
    # rate, channels, width, sample count and MD5
    if card[:12] != cpu[:12] or card[18:42] != cpu[18:42]:
        raise AssertionError(f"{what}: STREAMINFO differs beyond frame sizes")
    n = int.from_bytes(card[8:10], "big")
    samples = int.from_bytes(card[18:26], "big") & ((1 << 36) - 1)
    spans = []
    for data in (card, cpu):
        starts = frame_starts(data, 42, n, samples)
        spans.append(list(zip(starts, np.append(starts[1:], len(data)))))
    differ = 0
    for i, ((a0, a1), (b0, b1)) in enumerate(zip(*spans)):
        fa, fb = card[a0:a1], cpu[b0:b1]
        if fa != fb:
            if subframe_params(read_frame(fa, bps)[0]) == subframe_params(
                    read_frame(fb, bps)[0]):
                raise AssertionError(f"{what} frame {i}: same coefficients "
                                     "on cuda and cpu but different bytes")
            differ += 1
    return differ


def decode_file(cli, path, pcm: np.ndarray, label: str, seconds: float,
                tmp: str) -> None:
    """``python -m flacx_torch decode`` in process on the file at ``path``
    (and with ``--stream`` on the defaults' file), counted: every decode
    kernel launched, no batch on the host route, no frame through the
    oracle but the short last one, and the WAV's PCM the source's."""
    from pathlib import Path

    from flacx_torch.wavio import read_wav

    wav = Path(tmp, "decoded.wav")
    for flags in ((), ("--stream",)) if label == "default" else ((),):
        _, calls, restore = spy_decoder(("_decode_rows", "read_frame"))
        try:
            t0 = time.perf_counter()
            _, counts = counted_run(
                lambda: cli.main(["decode", *flags, str(path), str(wav)]),
                DECODE_PATH)
            wall = time.perf_counter() - t0
        finally:
            restore()
        if calls.get("_decode_rows") or calls.get("read_frame", 0) > 1:
            raise AssertionError(f"file {label} decode {flags}: host route "
                                 f"or oracle frames {calls}")
        if not np.array_equal(read_wav(wav)[3], pcm):
            raise AssertionError(f"file {label} decode {flags}: not "
                                 "bit-exact")
        print(f"file {label} decode{' --stream' if flags else ''}: wall "
              f"{wall:.3f} s, {seconds / wall:.1f}x realtime, "
              f"{pcm.size / wall:.1f} decoded samples/s; launches {counts}; "
              f"oracle frames {calls.get('read_frame', 0)} (the short last "
              "frame), no host-route batch; WAV PCM bit-exact", flush=True)


def file_phase(torch) -> list[dict]:
    """``python -m flacx_torch encode`` in process on the card, on WAV
    files written from the seed: the CD rip at the defaults and at
    ``-b 1152`` (where the estimate search writes the chosen residual,
    ``lpc_residual`` res mode), the 24-bit master with ``--best`` (the
    wide ``lpc_allorder`` at each block size).  Each encode is counted
    and its file checked (:func:`check_flac`); a 20 s excerpt of each is
    encoded on the card and with ``--device cpu``.  The kernels are held
    against their plain versions at the file paths' shapes (rows
    ``<mode>@file_<label>_<block>``; ``lpc_residual_res@1152`` and
    ``lpc_allorder_wide@<block>`` as before), and the two routes of the
    ``-b 1152`` estimate batch are timed."""
    import tempfile
    from pathlib import Path

    import flacx_torch.ops.emit as emit
    from flacx_torch import cli, pipeline
    from flacx_torch.encoder import BatchEncoder, EncoderConfig
    from flacx_torch.kernels import lpc_residual as k_lr
    from flacx_torch.wavio import write_wav

    inputs = file_inputs()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        wavs = {}
        for key, (pcm, rate, bps) in inputs.items():
            wavs[key] = Path(tmp, f"{key}.wav")
            write_wav(wavs[key], rate, bps, pcm)
            wavs[key + "-excerpt"] = Path(tmp, f"{key}-excerpt.wav")
            write_wav(wavs[key + "-excerpt"], rate, bps,
                      pcm[:EXCERPT_SECONDS * rate])
        out = Path(tmp, "out.flac")

        def encode(wav, flags, device="cuda"):
            cli.main(["encode", "--device", device, *flags, str(wav),
                      str(out)])
            return out.read_bytes()

        oracle_s = []
        oracle_frame = pipeline._oracle_frame

        def timed_oracle(*args):
            t0 = time.perf_counter()
            try:
                return oracle_frame(*args)
            finally:
                oracle_s.append(time.perf_counter() - t0)

        per_block = {}
        encode_to_file = pipeline.encode_to_file

        def counted_blocks(f, pcm, **kw):
            before, graph_before = launch_counts(), graph_counts()
            stats = encode_to_file(f, pcm, **kw)
            b = kw["block_size"]
            per_block[b] = {
                k: v - before[k] for k, v in launch_counts().items()}
            graph = stream_graph(-(-(len(pcm) // b) // FILE_BATCH))
            got = {k: v - graph_before[k] for k, v in graph_counts().items()}
            if got != graph:
                raise AssertionError(f"--best {b}: stream ran {got}, "
                                     f"expected {graph}")
            return stats

        captured, launched = {}, {}
        for label, (key, flags, needed) in FILE_RUNS.items():
            pcm, rate, bps = inputs[key]
            blocks = BEST_BLOCKS if label == "best" else (
                int(flags[1]) if flags else N,)
            batches = {b: -(-(len(pcm) // b) // FILE_BATCH) for b in blocks}
            # each block size's stream on an encoder of its own: its eager
            # batches and its capture launch the kernels, replays do not
            graphs = {b: stream_graph(n) for b, n in batches.items()}
            graph = {k: sum(g[k] for g in graphs.values())
                     for k in ("runs", "captures", "replays")}
            runs = {b: g["runs"] for b, g in graphs.items()}
            spies, restore = capture_main_path_inputs(
                ("analysis", "lpc_residual_res", "lpc_residual_zz",
                 "lpc_allorder", "rice_stats", "frame_pack"), per_block=True)
            pipeline._oracle_frame = timed_oracle
            pipeline.encode_to_file = counted_blocks
            oracle_s.clear()
            per_block.clear()
            try:
                t0 = time.perf_counter()
                data, counts = counted_run(lambda: encode(wavs[key], flags),
                                           needed, graph)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                restore()
                pipeline._oracle_frame = oracle_frame
                pipeline.encode_to_file = encode_to_file
            captured[label] = spies
            info = check_flac(data, pcm, rate, bps, blocks, label)
            decode_file(cli, out, pcm, label, len(pcm) / rate, tmp)
            tails = sum(len(pcm) % b != 0 for b in blocks)
            if len(oracle_s) != tails:
                raise AssertionError(f"{label}: {len(oracle_s)} oracle "
                                     f"frames, expected {tails} (the tails)")
            launched[label] = (counts, dict(per_block), runs)
            if label == "b1152":
                if (counts["lpc_residual_res"] != runs[1152]
                        or counts["lpc_residual_stats"]):
                    raise AssertionError(f"b1152: launches {counts}, "
                                         f"{runs[1152]} runs")
            if label == "best":
                cfg = EncoderConfig(bps=24, sample_rate=MASTER_RATE,
                                    order_search="exact",
                                    windows=BEST_WINDOWS)
                if k_lr.mac_width(cfg.eff_bps, cfg.sum_taps_max) != "wide":
                    raise AssertionError("best: not the wide MAC")
                for b in blocks:
                    if (per_block[b]["lpc_allorder"] != 3 * runs[b]
                            or per_block[b]["analysis"] != runs[b]):
                        raise AssertionError(f"best {b}: launches "
                                             f"{per_block[b]}")
            seconds = len(pcm) / rate
            total = int(info["sizes"].sum())
            print(f"file {label} ({seconds:.0f} s of {bps}-bit stereo at "
                  f"{rate} Hz, flags {' '.join(flags) or '(defaults)'}): "
                  f"wall {wall:.3f} s, {seconds / wall:.1f}x realtime, "
                  f"{len(pcm) / wall:.1f} samples/s a channel; oracle tail "
                  f"{sum(oracle_s):.3f} s ({sum(oracle_s) / wall:.3f} of the "
                  f"wall); block {info['block']}, {info['frames']} frames, "
                  f"{total} frame bytes, ratio "
                  f"{total / (pcm.size * bps // 8):.4f}; launches {counts}"
                  + (f" by block {per_block}" if label == "best" else "")
                  + f"; batches {batches}, {runs} launching; STREAMINFO, "
                  f"MD5, every CRC-8 and CRC-16 right, {FILE_DECODE} "
                  "sampled frames and the last decoded bit-exact",
                  flush=True)

            excerpt = wavs[key + "-excerpt"]
            t0 = time.perf_counter()
            card = encode(excerpt, flags)
            t1 = time.perf_counter()
            cpu = encode(excerpt, flags, "cpu")
            differ = same_file(card, cpu, bps, f"{label} excerpt")
            print(f"file {label}: {EXCERPT_SECONDS} s excerpt, card "
                  f"{t1 - t0:.3f} s, cpu {time.perf_counter() - t1:.3f} s; "
                  f"files {'byte-equal' if card == cpu else 'differ'} "
                  f"({differ} frames chose other coefficients)", flush=True)

    res_args = captured["b1152"][("lpc_residual_res", 1152)]
    zz_fix_args = captured["b1152"][("lpc_residual_zz", 1152)]
    assert res_args[0].shape == (FILE_BATCH, 4, 1152), res_args[0].shape
    assert zz_fix_args[1].shape[-1] == 4

    def file_row(name, label, wrapper, b, args):
        counts, per_block, runs = launched[label]
        row = hold(torch, name, wrapper, args)
        row["launches"] = (per_block[b] if label == "best" else
                           counts)[wrapper]
        row["batches"] = runs[b]
        return row

    def pack_row(label, b):
        args = captured[label][("frame_pack", b)]
        assert args[7].shape[:2] == (FILE_BATCH, 2), args[7].shape
        mode = ("frame_pack" if emit.blocked_layout_ok(b, args[12])
                else "frame_pack_general")
        return file_row(f"{mode}@file_{label}_{b}", label, "frame_pack", b,
                        args)

    # one trace per group: rows that share a kernel symbol apart
    groups = [[file_row("lpc_residual_res@1152", "b1152", "lpc_residual_res",
                        1152, res_args), pack_row("b1152", 1152)],
              [pack_row("default", N)]]
    best = captured["best"]
    for b in BEST_BLOCKS:
        args = best[("lpc_allorder", b)]
        assert args[0].shape == (FILE_BATCH, 4, b) and args[1].shape[-2] == 12
        group = [file_row(f"lpc_allorder_wide@{b}", "best", "lpc_allorder", b,
                          args)]
        args = best[("analysis", b)]
        assert args[1].shape == (len(BEST_WINDOWS), b), args[1].shape
        assert args[1].dtype == torch.float64
        group.append(file_row(f"analysis_f64@file_best_{b}", "best",
                              "analysis", b, args))
        args = best[("lpc_residual_zz", b)]
        assert args[0].shape == (FILE_BATCH, 4, b), args[0].shape
        wide = "_wide" if k_lr.mac_width(args[4], args[5]) == "wide" else ""
        group.append(file_row(f"lpc_residual_zz{wide}@file_best_{b}", "best",
                              "lpc_residual_zz", b, args))
        group.append(file_row(f"rice_stats@file_best_{b}", "best",
                              "rice_stats", b, best[("rice_stats", b)]))
        group.append(pack_row("best", b))
        groups.append(group)
    for group in groups:
        time_rows(torch, group)
        rows += group

    # the -b 1152 estimate batch on its other route: the chosen order's
    # stats (stats mode) and the merged taps' residual (zz mode), as where
    # the JAX package's tiled emit applies; the same frames either way
    cfg = EncoderConfig(block_size=1152)
    enc = BatchEncoder(cfg, batch_frames=FILE_BATCH)
    planar = blocks_of(inputs["cd"][0][:FILE_BATCH * 1152], 1152)
    keep = enc.encode_batch_device(planar, 0)
    spies, restore = capture_main_path_inputs(("lpc_residual_stats",
                                               "lpc_residual_zz"))
    tile_layout_ok = emit.tile_layout_ok
    emit.tile_layout_ok = lambda n, psize_min: True
    try:
        other = enc.encode_batch_device(planar, 0)
    finally:
        emit.tile_layout_ok = tile_layout_ok
        restore()
    if not (torch.equal(keep["length"], other["length"])
            and torch.equal(keep["bytes"], other["bytes"])):
        raise AssertionError("b1152: the two residual routes differ")
    k_res = {"lpc_residual_kernel<2, false>":
             lambda: k_lr.lpc_residual_res(*res_args),
             "lpc_residual_kernel<1, false>":
             lambda: k_lr.lpc_residual_zz(*zz_fix_args)}
    k_old = {"lpc_residual_kernel<0, false>":
             lambda: k_lr.lpc_residual_stats(*spies["lpc_residual_stats"]),
             "lpc_residual_kernel<1, false>":
             lambda: k_lr.lpc_residual_zz(*spies["lpc_residual_zz"])}
    t_res, t_old = kernel_times(torch, k_res, 20), kernel_times(torch, k_old,
                                                                20)
    print(f"file b1152 routes, one {FILE_BATCH}-frame batch, device ms: res "
          f"mode {sum(t_res.values()):.4f} ({t_res}) against stats + zz "
          f"{sum(t_old.values()):.4f} ({t_old}); the same frames", flush=True)
    return rows


#: the corpus phase (BASELINE.json configs[3]): WAVs of 1-8 s drawn from
#: the seed in four buckets of (width, rate, channels, share), and one
#: unreadable file, through ``encode-corpus`` at its defaults
CORPUS_FILES = 1000
CORPUS_BUCKETS = ((16, 44100, 2, 0.5), (16, 44100, 1, 0.2),
                  (24, 48000, 2, 0.2), (24, 96000, 2, 0.1))
CORPUS_SECONDS = (1.0, 8.0)
CORPUS_BATCH = 512
#: files of the corpus compared with ``encode_to_file`` (per bucket), and
#: the sharded phase's corpus
CORPUS_SAME, SHARDED_FILES = 2, 20


def corpus_inputs(files: int, seed: int) -> list:
    """``files`` WAV inputs, ``(width, rate, channels, interleaved PCM)``:
    each bucket its share of the files (in an order drawn from the seed),
    each file a window of a two-tone signal of that bucket's width and
    rate, its length uniform in :data:`CORPUS_SECONDS`."""
    rng = np.random.default_rng(seed)
    counts = [int(round(share * files)) for *_, share in CORPUS_BUCKETS]
    counts[0] += files - sum(counts)
    kinds = rng.permutation(np.repeat(np.arange(len(CORPUS_BUCKETS)),
                                      counts))
    longest = int(CORPUS_SECONDS[1] * max(b[1] for b in CORPUS_BUCKETS))
    base = {bps: synth_pcm(rng, 4 * longest, bps) for bps in (16, 24)}
    out = []
    for k in kinds.tolist():
        bps, rate, ch, _ = CORPUS_BUCKETS[k]
        n = int(rng.uniform(*CORPUS_SECONDS) * rate)
        at = int(rng.integers(0, len(base[bps]) - n))
        out.append((bps, rate, ch, np.ascontiguousarray(
            base[bps][at:at + n, :ch])))
    return out


def write_corpus(root, inputs: list) -> list:
    """The inputs as WAV files ``f<i>.wav`` under ``root``."""
    from pathlib import Path

    from flacx_torch.wavio import write_wav

    Path(root).mkdir(parents=True, exist_ok=True)
    paths = []
    for i, (bps, rate, _, pcm) in enumerate(inputs):
        paths.append(Path(root, f"f{i:04d}.wav"))
        write_wav(paths[-1], rate, bps, pcm)
    return paths


def used(counts: dict) -> dict:
    """The launch counts of the kernels that were launched."""
    return {k: v for k, v in counts.items() if v}


def check_corpus_file(data: bytes, bps: int, rate: int, pcm: np.ndarray,
                      what: str) -> dict:
    """``decoder.decode_array`` on the card: the PCM bit-exact, every
    batch on the device route (no host parse, no sequential decode), the
    STREAMINFO's parameters and MD5 the input's; returns the routes."""
    import hashlib

    from flacx_torch import decoder
    from flacx_torch.wavio import pcm_to_le_bytes

    stats = {}
    si, got = decoder.decode_array(data, device="cuda", stats=stats)
    if not np.array_equal(got, pcm):
        raise AssertionError(f"{what}: not bit-exact")
    if set(stats) - {"device", "oracle_frames"} or not stats.get("device"):
        raise AssertionError(f"{what}: decode routes {stats}")
    want = (N, N, rate, pcm.shape[1], bps, len(pcm),
            hashlib.md5(pcm_to_le_bytes(pcm, bps)).digest())
    got_si = (si.min_block_size, si.max_block_size, si.sample_rate,
              si.channels, si.sample_size, si.samples, si.md5)
    if got_si != want:
        raise AssertionError(f"{what}: STREAMINFO {si}")
    return stats


def corpus_phase(torch) -> list[dict]:
    """``python -m flacx_torch encode-corpus`` in process on the card at
    its defaults (block 4608, LPC order <= 12, ``--batch-frames 512``) over
    :data:`CORPUS_FILES` WAVs and one unreadable file, counted: every
    output decoded on the card bit-exactly on the device route, with its
    STREAMINFO and MD5; :data:`CORPUS_SAME` files a bucket byte-equal to
    ``encode_to_file`` on the card (a frame does not depend on its batch
    neighbours); the bad file reported ``FAILED``; a ``--resume`` run
    after one output is deleted and one input touched re-encodes exactly
    those two.  The kernels are held against their plain versions on the
    first batch of the 24-bit/96 kHz bucket (the wide MAC) and of the mono
    bucket (rows ``<mode>@corpus96k``, ``<mode>@corpus_mono``)."""
    import contextlib
    import io
    import os
    import tempfile
    from pathlib import Path

    import flacx_torch.parallel.corpus as corpus
    from flacx_torch import cli, pipeline
    from flacx_torch.encoder import BatchEncoder, EncoderConfig
    from flacx_torch.kernels import lpc_residual as k_lr

    t_phase = time.perf_counter()
    inputs = corpus_inputs(CORPUS_FILES, SEED + 12)
    # the kernels at the corpus path's shapes, before the corpus run (the
    # profiler drops more records the more the process has launched): the
    # first batch of the 24-bit/96 kHz bucket (the wide MAC) and of the
    # mono bucket
    rows = []
    for label, key in (("corpus96k", (24, 96000, 2)),
                       ("corpus_mono", (16, 44100, 1))):
        bps, rate, ch = key
        picks = [pcm for b, r, c, pcm in inputs if (b, r, c) == key]
        planar = np.concatenate([blocks_of(pcm[:len(pcm) // N * N], N,
                                           np.int32) for pcm in picks])
        planar = planar[:CORPUS_BATCH]
        cfg = EncoderConfig(sample_rate=rate, bps=bps, channels=ch,
                            block_size=N, max_lpc_order=12)
        enc = BatchEncoder(cfg, batch_frames=CORPUS_BATCH)
        captured, restore = capture_main_path_inputs()
        try:
            enc.encode_batch_indexed(planar, np.arange(len(planar)))
        finally:
            restore()
        torch.cuda.synchronize()
        names = {w: w for w in HEADLINE_SPIES}
        for w in ("lpc_residual_stats", "lpc_residual_zz"):
            args = captured[w]
            wide = k_lr.mac_width(args[4], args[5]) == "wide"
            assert wide == (bps == 24), (label, w)
            names[w] += "_wide" if wide else ""
        group = [hold(torch, f"{names[w]}@{label}", w, captured[w])
                 for w in HEADLINE_SPIES]
        time_rows(torch, group)
        for row, w in zip(group, HEADLINE_SPIES):
            row["wrapper"] = w
        rows += group
        del captured
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = write_corpus(Path(tmp, "in"), inputs)
        bad = Path(tmp, "in", "bad.wav")
        bad.write_bytes(b"RIFF\x04\x00\x00\x00WAVEjunk")
        out = Path(tmp, "out")
        setup_s = time.perf_counter() - t0

        tails, batches = [], {}
        oracle_frame = corpus._oracle_frame
        indexed = BatchEncoder.encode_batch_indexed

        def timed_tail(*args):
            t0 = time.perf_counter()
            try:
                return oracle_frame(*args)
            finally:
                tails.append(time.perf_counter() - t0)

        def counted_batch(self, pcm, idx):
            key = (self.config.bps, self.config.sample_rate,
                   self.config.channels)
            batches[key] = batches.get(key, 0) + 1
            return indexed(self, pcm, idx)

        def run(*flags) -> tuple:
            text = io.StringIO()
            corpus._oracle_frame = timed_tail
            BatchEncoder.encode_batch_indexed = counted_batch
            try:
                with contextlib.redirect_stdout(text):
                    t0 = time.perf_counter()
                    _, counts = counted_run(lambda: cli.main(
                        ["encode-corpus", *flags, str(out),
                         *map(str, paths), str(bad)]), HEADLINE_SPIES,
                        EAGER)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            finally:
                corpus._oracle_frame = oracle_frame
                BatchEncoder.encode_batch_indexed = indexed
            return wall, counts, text.getvalue()

        wall, counts, text = run()
        n_batches = sum(batches.values())
        print(text, end="", flush=True)
        lines = text.splitlines()
        if (len(lines) != 2
                or not lines[0].startswith(f"Encoded {CORPUS_FILES} files")
                or not lines[1].startswith(f"  FAILED {bad}: read: ")):
            raise AssertionError(f"corpus: completion print {lines}")
        samples = sum(len(pcm) for *_, pcm in inputs)
        seconds = sum(len(pcm) / rate for _, rate, _, pcm in inputs)
        want = {}
        for bps, rate, ch, pcm in inputs:
            key = (bps, rate, ch)
            want[key] = want.get(key, 0) + len(pcm) // N
        want = {k: -(-v // CORPUS_BATCH) for k, v in want.items()}
        if batches != want:
            raise AssertionError(f"corpus: batches {batches}, expected "
                                 f"{want}")
        tails_expected = sum(len(pcm) % N != 0 for *_, pcm in inputs)
        if len(tails) != tails_expected:
            raise AssertionError(f"corpus: {len(tails)} oracle tails, "
                                 f"expected {tails_expected}")
        print(f"corpus ({CORPUS_FILES} WAVs of {CORPUS_SECONDS[0]:.0f}-"
              f"{CORPUS_SECONDS[1]:.0f} s and one unreadable; buckets "
              f"(bps, rate, channels) -> batches of {CORPUS_BATCH}: "
              f"{batches}): wall {wall:.3f} s, {CORPUS_FILES / wall:.1f} "
              f"files/s, {samples / wall:.1f} samples/s a channel, "
              f"{seconds / wall:.1f}x realtime ({seconds:.1f} s of audio); "
              f"oracle tails {sum(tails):.3f} s ({sum(tails) / wall:.3f} of "
              f"the wall, {len(tails)} tails); launches {used(counts)}; WAV "
              f"writing {setup_s:.1f} s", flush=True)

        # every output decoded on the card
        t0 = time.perf_counter()
        routes = {}

        def decode_all():
            for i, (bps, rate, _, pcm) in enumerate(inputs):
                data = (out / f"f{i:04d}.flac").read_bytes()
                for k, v in check_corpus_file(data, bps, rate, pcm,
                                              f"corpus file {i}").items():
                    routes[k] = routes.get(k, 0) + v
        _, dcounts = counted_run(decode_all, DECODE_PATH)
        print(f"corpus decode: {CORPUS_FILES} files bit-exact on the card "
              f"in {time.perf_counter() - t0:.3f} s, routes {routes}, "
              f"launches {used(dcounts)}; STREAMINFO and MD5 right", flush=True)

        # files of each bucket against encode_to_file on the card
        same = []
        for bps, rate, ch, _ in CORPUS_BUCKETS:
            picks = [i for i, f in enumerate(inputs)
                     if f[:3] == (bps, rate, ch)][:CORPUS_SAME]
            for i in picks:
                pcm = inputs[i][3]
                f = io.BytesIO()
                pipeline.encode_to_file(
                    f, pcm, sample_rate=rate, bps=bps, channels=ch,
                    block_size=N, max_lpc_order=12, qlp_precision=5,
                    partition_orders=tuple(range(6)))
                if f.getvalue() != (out / f"f{i:04d}.flac").read_bytes():
                    raise AssertionError(f"corpus file {i}: not the bytes "
                                         "of encode_to_file")
                same.append(i)
        print(f"corpus: files {same} byte-equal to encode_to_file on the "
              "card", flush=True)

        # --resume after one output is deleted and one input touched
        gone, touched = paths[same[0]], paths[same[-1]]
        before = {p: (out / (p.stem + ".flac")).read_bytes()
                  for p in (gone, touched)}
        (out / (gone.stem + ".flac")).unlink()
        st = os.stat(touched)
        os.utime(touched, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
        read, read_wav = [], corpus.read_wav

        def spied_read(path):
            read.append(Path(path))
            return read_wav(path)
        corpus.read_wav = spied_read
        try:
            rwall, rcounts, text = run("--resume")
        finally:
            corpus.read_wav = read_wav
        if sorted(read) != sorted([gone, touched, bad]) or not \
                text.startswith(f"Encoded 2 files") or \
                f"{CORPUS_FILES - 2} resumed" not in text:
            raise AssertionError(f"corpus resume: read {read}, {text!r}")
        for p, data in before.items():
            if (out / (p.stem + ".flac")).read_bytes() != data:
                raise AssertionError(f"corpus resume: {p.name} differs")
        print(f"corpus --resume: wall {rwall:.3f} s, re-encoded exactly "
              f"{gone.name} (output deleted) and {touched.name} (input "
              f"touched), the same bytes; launches {used(rcounts)}; "
              f"{text.splitlines()[0]}", flush=True)

    for row in rows:
        row["launches"] = counts[row.pop("wrapper")]
        row["batches"] = n_batches
    print(f"corpus phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


#: the sequence-sharding phase (``seqshard``): the hi-res stereo PCM of
#: :data:`SEQ_FRAMES` frames of 16384 cut into blocks of each size (two
#: rows a block: 256 x 16384 and 128 x 32768), lags and taps up to 32, the
#: meshes ``(n_data, n_seq)`` of repeated ``cuda:0`` entries the sharded
#: functions run on, and the shards of the kernels' held launch (that of
#: ``seq_mesh(1, 8)``)
SEQ_BLOCKS = {"seq16k": 16384, "seq32k": 32768}
SEQ_FRAMES, SEQ_LAGS, SEQ_HOLD_SHARDS = 128, 32, 8
SEQ_MESHES = ((1, 2), (1, 8), (2, 4))
SEQ_PATH = ("seq_autocorr", "seq_fixed", "seq_lpc")
SEQ_SOURCE = "flacx_torch/kernels/csrc/seqshard.cu"


def seq_autoc_close(torch, a, b):
    """Autocorrelation sums ``[..., lags]`` (a shard's partials or a
    row's): f64 sums of the same products in another order, within rtol
    1e-12 or 1e-12 of the lag-0 sum near zero (the error is under
    n·eps64 of the sum of |products|, which the lag-0 sum bounds)."""
    err = (a - b).abs()
    tol = 1e-12 * b.abs() + 1e-12 * b[..., :1].abs()
    if not bool((err <= tol).all()):
        raise AssertionError("seq_autocorr out of tolerance: max err "
                             f"{err.max().item()}")
    return float(err.max().item())


def seq_autocorr_library_ms(torch, xw, max_lag: int, want) -> float | None:
    """One grouped f64 ``conv1d`` of the windowed rows (a yardstick, never
    on the path): ``autoc[l] = Σ_j u[j]·u[j+l]``, ``u`` the rows without
    their last sample, padded with ``max_lag`` zeros for the input.  Its
    products are exact in f64 where the kernel's round to f32: held
    against ``want`` (the kernel's sums) within 1e-6 of (|want| +
    |autoc[0]|).  Returns its median ms, or None where cuDNN refuses the
    shape (printed)."""
    rows = xw.shape[0]
    u = xw.double()[:, :-1].reshape(rows, 1, -1)
    u_pad = torch.nn.functional.pad(u, (0, max_lag)).reshape(1, rows, -1)

    def conv():
        return torch.nn.functional.conv1d(u_pad, u, groups=rows)
    try:
        got = conv().reshape(rows, max_lag + 1)
    except RuntimeError as e:
        print(f"conv1d yardstick refused at {tuple(u.shape)}: {e}",
              flush=True)
        return None
    err = (got - want).abs()
    if not bool((err <= 1e-6 * (want.abs() + want[:, :1].abs())).all()):
        raise AssertionError("conv1d yardstick out of tolerance: max err "
                             f"{err.max().item()}")
    ms = median_ms(torch, conv, 10)
    print(f"conv1d yardstick {tuple(u.shape)}: {ms:.4f} ms, max err "
          f"{err.max().item()}", flush=True)
    return ms


def seq_inputs(torch, pcm: np.ndarray, n: int) -> dict:
    """The rows of block ``n`` on the card: int32 ``x [rows, n]``, the
    Tukey(0.5) window and the windowed rows in f32, and each row's
    order-``1 + row % 32`` taps and shift from the port's Levinson and
    quantization of its ``analysis`` autocorrelation (the hi-res
    configuration's precision)."""
    from flacx_torch.kernels import analysis as k_an
    from flacx_torch.ops.lpc import (levinson_all_orders,
                                     quantize_all_orders, tukey_window_np)

    cfg = hires_config(2)
    x = torch.from_numpy(blocks_of(pcm, n, np.int32).reshape(-1, n)).cuda()
    window = torch.from_numpy(tukey_window_np(n).astype(np.float32)).cuda()
    autoc, fsums = k_an.analysis(x, window, SEQ_LAGS, cfg.eff_bps)
    taps_f, _, _ = levinson_all_orders(autoc, SEQ_LAGS)
    qcoefs, shifts, _ = quantize_all_orders(-taps_f, cfg.qlp_precision)
    rows = torch.arange(len(x), device=x.device)
    order = 1 + rows % SEQ_LAGS
    return {"x": x, "window": window, "xw": x.float() * window,
            "taps": qcoefs[rows, order - 1].contiguous(),
            "shift": shifts[rows, order - 1].contiguous(),
            "order": order.to(torch.int32), "autoc": autoc, "fsums": fsums,
            "eff_bps": cfg.eff_bps, "sum_taps_max": cfg.sum_taps_max}


def seq_block(torch, label: str, inp: dict) -> list[dict]:
    """One block size: each kernel mode held against its plain version at
    ``seq_mesh(1, 8)``'s launch, then the sharded functions on every mesh
    of :data:`SEQ_MESHES` (counted) against the main path's kernels on the
    same unsharded rows, and their walls."""
    from flacx_torch.kernels import analysis as k_an
    from flacx_torch.kernels import lpc_allorder as k_la
    from flacx_torch.kernels import lpc_residual as k_lr
    from flacx_torch.kernels import seqshard as k_seq
    from flacx_torch.parallel import seqshard

    x, window, xw, taps, shift, order = (
        inp[k] for k in ("x", "window", "xw", "taps", "shift", "order"))
    rows_n, n = x.shape
    s, lags = SEQ_HOLD_SHARDS, SEQ_LAGS
    products = rows_n * sum(n - 1 - lag for lag in range(lags + 1))
    # f32 rows: the f32 products, and their exact f64 sums as multiply-adds
    # at the f64 tensor rate (f64 rows keep them at the f64 rate)
    f64_rate = (F64_OPS_PER_S if xw.dtype == torch.float64 else
                F64_TENSOR_OPS_PER_S)
    rows = [
        kernel_row(torch, f"seq_autocorr@{label}", "seq_autocorr_kernel",
                   k_seq.seq_autocorr, k_seq.seq_autocorr_plain,
                   (xw, lags, s), seq_autoc_close,
                   [(products, f64_rate), (products, SCALAR_OPS_PER_S)],
                   SEQ_SOURCE, "flacx/parallel/seqshard.py:47-67"),
        # about 35 integer operations a sample: 10 differences, 5 zigzags
        # of 3, 5 masked 64-bit adds of 2
        kernel_row(torch, f"seq_fixed@{label}", "seq_fixed_kernel",
                   k_seq.seq_fixed, k_seq.seq_fixed_plain, (x, s), exact,
                   [(x.numel() * 35, SCALAR_OPS_PER_S)], SEQ_SOURCE,
                   "flacx/parallel/seqshard.py:110-121"),
        # the int64 MAC counted as lpc_residual's wide MAC: 8-bit limb
        # products of the nonzero taps at the int8 tensor rate, and twelve
        # scalar operations a sample
        kernel_row(torch, f"seq_lpc@{label}", "seq_lpc_kernel",
                   k_seq.seq_lpc, k_seq.seq_lpc_plain,
                   (x, taps, shift, order, s), exact,
                   [(limb_ops(n, taps, k_la.sample_limbs(inp["eff_bps"])),
                     INT8_TENSOR_OPS_PER_S),
                    (x.numel() * 12, SCALAR_OPS_PER_S)], SEQ_SOURCE,
                   "flacx/parallel/seqshard.py:152-167")]
    rows[0]["library_ms"] = seq_autocorr_library_ms(
        torch, xw, lags, k_seq.seq_autocorr(xw, lags, s).sum(1))
    time_rows(torch, rows)

    # the main path's kernels on the unsharded rows
    want_ac, want_fs = inp["autoc"], inp["fsums"]
    want_zz, want_mx = k_lr.lpc_residual_stats(
        x, taps, shift, order, inp["eff_bps"], inp["sum_taps_max"])
    assert k_lr.mac_width(inp["eff_bps"], inp["sum_taps_max"]) == "wide"
    below = want_mx < (1 << 31) - 1
    meshes = {m: seqshard.seq_mesh(*m, devices=("cuda:0",) * (m[0] * m[1]))
              for m in SEQ_MESHES}
    calls = {
        "autocorrelate_sharded": lambda mesh: seqshard.autocorrelate_sharded(
            xw, lags, mesh),
        "fixed_order_zz_sums_sharded":
            lambda mesh: seqshard.fixed_order_zz_sums_sharded(x, mesh),
        "lpc_zz_stats_sharded": lambda mesh: seqshard.lpc_zz_stats_sharded(
            x, taps, shift, order, mesh)}

    def run_all():
        return {(m, name): fn(mesh) for m, mesh in meshes.items()
                for name, fn in calls.items()}
    outs, counts = counted_run(run_all, SEQ_PATH)
    torch.cuda.synchronize()
    for m in SEQ_MESHES:
        # the same f32 products as analysis, f64 sums in another order
        seq_autoc_close(torch, outs[m, "autocorrelate_sharded"], want_ac)
        exact(torch, outs[m, "fixed_order_zz_sums_sharded"], want_fs)
        zz, mx = outs[m, "lpc_zz_stats_sharded"]
        exact(torch, zz, want_zz)
        exact(torch, mx[below], want_mx[below].long())
        if not bool((mx[~below] >= (1 << 31) - 1).all()):
            raise AssertionError(f"{label} {m}: max |res| under the clamp")

    def wall_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 5 * 1e3

    eff, stm = inp["eff_bps"], inp["sum_taps_max"]
    an_ms = wall_ms(lambda: k_an.analysis(x, window, lags, eff))
    lr_ms = wall_ms(lambda: k_lr.lpc_residual_stats(x, taps, shift, order,
                                                    eff, stm))
    text = [f"unsharded analysis {an_ms:.3f} ms, lpc_residual_stats "
            f"{lr_ms:.3f} ms"]
    for m, mesh in meshes.items():
        text.append(f"seq_mesh{m}: " + ", ".join(
            f"{name} {wall_ms(lambda: fn(mesh)):.3f} ms"
            for name, fn in calls.items()))
    print(f"{label}: {rows_n} rows x {n}; sharded on seq_mesh {SEQ_MESHES} "
          f"over cuda:0 equal to analysis (fixed sums exact, "
          f"autocorrelation within 1e-12) and lpc_residual_stats (exact; "
          f"{int((~below).sum())} rows past its clamp); launches "
          f"{used(counts)}; walls: {'; '.join(text)}", flush=True)
    for row, name in zip(rows, SEQ_PATH):
        row["launches"], row["batches"] = counts[name], 1
    return rows


def seqshard_phase(torch) -> list[dict]:
    """Sequence sharding at the hi-res sizes (:data:`SEQ_BLOCKS`)."""
    pcm = hires_pcm(2, SEQ_FRAMES)
    rows = []
    for label, n in SEQ_BLOCKS.items():
        rows += seq_block(torch, label, seq_inputs(torch, pcm, n))
    return rows


#: seconds a rank of the ``distributed`` phase may take
WORKER_TIMEOUT = 300


def distributed_worker(port: str, rank: str, root: str) -> int:
    """One rank of the ``distributed`` phase (``chip_smoke.py
    --distributed-worker <port> <rank> <dir>``): joins the two-process
    group on the card, encodes its stripe of ``<dir>/in`` into
    ``<dir>/two`` and writes what the parent checks to
    ``<dir>/rank<rank>.json``."""
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from flacx_torch.parallel import (encode_corpus_distributed,
                                      global_data_mesh, init_distributed,
                                      shard_corpus)

    rank_i = int(rank)
    assert init_distributed(f"127.0.0.1:{port}", 2, rank_i,
                            device="cuda") == (rank_i, 2)
    try:
        mesh = global_data_mesh()
        paths = sorted(Path(root, "in").glob("*.wav"))
        t0 = time.perf_counter()
        result, totals = encode_corpus_distributed(
            paths, Path(root, "two"), batch_frames=CORPUS_BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        Path(root, f"rank{rank}.json").write_text(json.dumps({
            "mine": [p.name for p in shard_corpus(paths)],
            "encoded": sorted(p.name for p in result.encoded),
            "failed": result.failed, "totals": totals, "wall": wall,
            "mesh": [[r, str(d)] for r, d in mesh.devices]}))
    finally:
        dist.destroy_process_group()
    return 0


def run_ranks(root) -> tuple[float, list[str]]:
    """The two ranks as fresh interpreters (never a fork of this process,
    which holds a CUDA context), each killed past :data:`WORKER_TIMEOUT`;
    a port taken between its probe and the group's bind is retried once.
    Returns their wall and outputs; a rank that fails raises."""
    import os
    import socket
    from pathlib import Path

    here = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(here))
    for attempt in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(here / "chip_smoke.py"),
             "--distributed-worker", str(port), str(rank), str(root)],
            cwd=here, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for rank in (0, 1)]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                outs.append(p.communicate()[0])
        wall = time.perf_counter() - t0
        codes = [p.returncode for p in procs]
        if codes == [0, 0]:
            return wall, outs
        if attempt == 0 and any("EADDRINUSE" in o or "in use" in o
                                for o in outs):
            continue
        raise AssertionError(f"distributed: ranks exited {codes}:\n"
                             + "\n".join(outs))
    raise AssertionError("unreachable")


def distributed_phase(torch) -> None:
    """``encode_corpus_distributed`` across two processes on the one card
    over the sharded phase's corpus, into one output directory: disjoint
    stripes whose union is the corpus, both ranks' totals equal to a
    one-process ``encode_corpus`` on the card, every file byte-equal to
    it, a resumed run that reads both manifest shards and skips every
    file, every output decoded bit-exactly on the device route."""
    import tempfile
    from pathlib import Path

    from flacx_torch.parallel.corpus import encode_corpus

    t_phase = time.perf_counter()
    inputs = corpus_inputs(SHARDED_FILES, SEED + 21)
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_corpus(Path(tmp, "in"), inputs)
        t0 = time.perf_counter()
        one = encode_corpus(paths, Path(tmp, "one"), batch_frames=CORPUS_BATCH)
        torch.cuda.synchronize()
        one_wall = time.perf_counter() - t0
        wall, _ = run_ranks(tmp)
        ranks = [json.loads(Path(tmp, f"rank{k}.json").read_text())
                 for k in (0, 1)]
        names = [p.name for p in paths]
        mine = [r["mine"] for r in ranks]
        if set(mine[0]) & set(mine[1]) or sorted(sum(mine, [])) != names:
            raise AssertionError(f"distributed: stripes {mine}")
        want = {"bytes_in": float(one.bytes_in),
                "bytes_out": float(one.bytes_out),
                "failed": float(len(one.failed)),
                "files": float(len(one.encoded)),
                "samples": float(one.samples)}
        if any(r["totals"] != want or r["failed"] for r in ranks):
            raise AssertionError(f"distributed: totals {ranks}, one "
                                 f"process {want}")
        two = Path(tmp, "two")
        shards = sorted(p.name for p in two.glob(".flacx_manifest*.json"))
        if shards != [".flacx_manifest.p0.json", ".flacx_manifest.p1.json"]:
            raise AssertionError(f"distributed: manifest shards {shards}")
        for p in one.encoded:
            if (two / p.name).read_bytes() != p.read_bytes():
                raise AssertionError(f"distributed: {p.name} differs from "
                                     "the one-process encode")
        t0 = time.perf_counter()
        again = encode_corpus(paths, two, batch_frames=CORPUS_BATCH,
                              resume=True)
        resume_wall = time.perf_counter() - t0
        if again.encoded or len(again.skipped) != len(paths):
            raise AssertionError(f"distributed: resume encoded "
                                 f"{again.encoded}")
        routes = {}
        for i, (bps, rate, _, pcm) in enumerate(inputs):
            for k, v in check_corpus_file(
                    (two / f"f{i:04d}.flac").read_bytes(), bps, rate, pcm,
                    f"distributed file {i}").items():
                routes[k] = routes.get(k, 0) + v
    print(f"distributed: {SHARDED_FILES} WAVs over 2 processes (gloo, both "
          f"on cuda:0, global mesh {ranks[0]['mesh']}), stripes of "
          f"{len(mine[0])} / {len(mine[1])} files, totals {want} on both "
          f"ranks and equal to one process; every file byte-equal to the "
          f"one-process encode; resume skipped {len(again.skipped)} files "
          f"in {resume_wall:.3f} s; every output decoded bit-exactly on the "
          f"card, routes {routes}; walls: one process {one_wall:.3f} s, two "
          f"processes {wall:.3f} s from launch (encode in the ranks "
          f"{ranks[0]['wall']:.3f} / {ranks[1]['wall']:.3f} s); phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def dryrun_phase() -> None:
    """``dryrun_multichip`` on a mesh of four ``cuda:0`` entries, counted."""
    from flacx_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    _, counts = counted_run(
        lambda: dryrun_multichip(4, devices=("cuda:0",) * 4),
        HEADLINE_SPIES + DECODE_PATH + ("seq_autocorr",), EAGER)
    print(f"dryrun phase: {time.perf_counter() - t0:.1f} s, launches "
          f"{used(counts)}", flush=True)


def sharded_phase(torch, pcm: np.ndarray, headline: tuple) -> None:
    """``sharding=`` on a mesh of every visible card and on one of two
    ``cuda:0`` entries: the headline batch through ``BatchEncoder``
    (counted) and a 20 s excerpt through ``encode_to_file``, byte-equal
    to the unsharded card path; ``decode_array`` of the headline stream at
    256 frames a batch (divides the meshes) and 255 (does not), bit-exact
    on the device route; a 20-file corpus byte-equal to the unsharded
    one.  Walls beside the unsharded ones."""
    import io
    import tempfile
    from pathlib import Path

    import flacx_torch.decoder as dec
    from flacx_torch import pipeline
    from flacx_torch.encoder import BatchEncoder, EncoderConfig
    from flacx_torch.parallel import data_mesh, frame_sharding
    from flacx_torch.parallel.corpus import encode_corpus

    t_phase = time.perf_counter()
    meshes = {"cards": data_mesh(),
              "cuda0x2": data_mesh(devices=("cuda:0", "cuda:0"))}
    shardings = {None: None, **{k: frame_sharding(m)
                                for k, m in meshes.items()}}
    cfg = EncoderConfig(block_size=N, max_lpc_order=12)
    planar = blocks_of(pcm, N)

    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / reps

    want, wall = timed(lambda: BatchEncoder(cfg, B).encode_frames(planar, 0))
    text = [f"unsharded {wall * 1e3:.3f} ms"]
    for label, sh in list(shardings.items())[1:]:
        enc = BatchEncoder(cfg, B, sharding=sh)
        frames, counts = counted_run(lambda: enc.encode_frames(planar, 0),
                                     HEADLINE_SPIES, EAGER)
        if frames != want:
            raise AssertionError(f"sharded {label}: headline frames differ")
        _, wall = timed(lambda: enc.encode_frames(planar, 0))
        text.append(f"{label} ({sh.mesh.size} parts) {wall * 1e3:.3f} ms, "
                    f"launches {used(counts)}")
    print(f"sharded headline batch ({B} frames) byte-equal on every mesh; "
          f"encode_frames: {'; '.join(text)}", flush=True)

    excerpt = synth_pcm(np.random.default_rng(SEED + 20), 20 * 44100)
    kw = dict(sample_rate=44100, bps=16, channels=2, block_size=N,
              max_lpc_order=12, qlp_precision=5,
              partition_orders=tuple(range(6)))
    files, text = {}, []
    for label, sh in shardings.items():
        def encode():
            f = io.BytesIO()
            pipeline.encode_to_file(f, excerpt, sharding=sh, **kw)
            return f.getvalue()
        files[label], wall = timed(encode)
        text.append(f"{label or 'unsharded'} {wall:.3f} s")
    if len(set(files.values())) != 1:
        raise AssertionError("sharded excerpt: files differ")
    print(f"sharded 20 s excerpt through encode_to_file byte-equal on "
          f"every mesh: {'; '.join(text)}", flush=True)

    frames, hpcm, rate, bps, n = headline
    data = flac_stream(frames, hpcm, rate, bps, n)
    for bf in (256, 255):
        text = []
        for label, sh in shardings.items():
            stats = {}
            (_, got), dcounts = counted_run(
                lambda: dec.decode_array(data, batch_frames=bf, stats=stats,
                                         sharding=sh), DECODE_PATH)
            batches = -(-(len(hpcm) // n) // bf)
            if not np.array_equal(got, hpcm) or stats != {"device": batches}:
                raise AssertionError(f"sharded decode {label} at {bf}: "
                                     f"routes {stats}")
            _, wall = timed(lambda: dec.decode_array(
                data, batch_frames=bf, sharding=sh))
            text.append(f"{label or 'unsharded'} {wall * 1e3:.3f} ms, "
                        f"routes {stats}, launches {used(dcounts)}")
        print(f"sharded decode_array of the headline stream at {bf} frames a "
              f"batch, bit-exact: {'; '.join(text)}", flush=True)

    inputs = corpus_inputs(SHARDED_FILES, SEED + 21)
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_corpus(Path(tmp, "in"), inputs)
        outs, text = {}, []
        for label, sh in shardings.items():
            out = Path(tmp, str(label))
            t0 = time.perf_counter()
            encode_corpus(paths, out, batch_frames=CORPUS_BATCH, sharding=sh)
            text.append(f"{label or 'unsharded'} "
                        f"{time.perf_counter() - t0:.3f} s")
            outs[label] = [(out / (p.stem + ".flac")).read_bytes()
                           for p in paths]
        if any(v != outs[None] for v in outs.values()):
            raise AssertionError("sharded corpus: files differ")
    print(f"sharded corpus ({SHARDED_FILES} files) byte-equal on every mesh: "
          f"{'; '.join(text)}; sharded phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def main() -> int:
    import torch
    if sys.argv[1:2] == ["--distributed-worker"]:
        return distributed_worker(*sys.argv[2:5])
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    from flacx_torch.kernels.build import build_all

    t_start = time.perf_counter()
    card = card_line()
    build_s = build_all()
    print(f"card {card}; torch {torch.__version__} cuda {torch.version.cuda};"
          f" kernel build {build_s:.2f} s", flush=True)
    print_resources()

    pcm = synth_pcm(np.random.default_rng(SEED), N * B)
    streams = {}
    rows = headline_phase(torch, pcm, streams)
    t0 = time.perf_counter()
    rows += conformance_phase(torch, pcm)
    print(f"conformance phase: {time.perf_counter() - t0:.1f} s", flush=True)
    rows += best_phase(torch, pcm)
    wasted_phase(pcm)
    streams["fixed"] = (fixed_frames(pcm), pcm, 44100, 16, N)
    for label in HIRES:
        rows += hires_phase(torch, label, streams)
    t0 = time.perf_counter()
    rows += hibps_phase(torch, streams)
    print(f"hibps phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rows += decode_phase(torch, streams)
    print(f"decode phase: {time.perf_counter() - t0:.1f} s", flush=True)
    headline = streams["headline"]
    del streams
    rows += file_phase(torch)
    rows += corpus_phase(torch)
    t0 = time.perf_counter()
    rows += seqshard_phase(torch)
    print(f"seqshard phase: {time.perf_counter() - t0:.1f} s", flush=True)
    distributed_phase(torch)
    dryrun_phase()
    # last: it takes no profiler trace
    sharded_phase(torch, pcm, headline)

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all",
          flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
