#!/usr/bin/env python3
"""Smoke run of flacx_torch on one NVIDIA card.

    python3 chip_smoke.py

Builds the five CUDA kernels from ``flacx_torch/kernels/csrc`` and runs
two paths through ``BatchEncoder`` on the card, 16-bit stereo:

* the headline encode: one 1024-frame batch at block 4608, LPC order 12;
* the best-compression encode (``encode --best``): the same PCM cut into
  blocks of 4608, 2304 and 1152 (1024, 2048 and 4096 frames), each
  encoded with the exact order search over the windows Tukey(0.5), Hann
  and flattop (f64 analysis), 1024 frames per batch; then one 64-frame
  batch with wasted bits.

Each kernel is held against its plain PyTorch version on the card at the
shapes its path gives it, those of the best path at each block size.  For
each encode: every kernel of the path was launched, every frame's CRC-16
holds, 16 frames decode bit-exactly under the port's oracle decoder, and
they match the plain CPU path byte for byte wherever both chose the same
coefficients.

Prints one line per phase, the run's seconds, then the kernels' JSON line
(one row per kernel mode and path, named ``<mode>@<block>`` on the best
path; ``launches`` counts the launches of that path's counted encode,
which runs ``batches`` batches of 1024 frames), the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Any
failure raises and exits non-zero; without CUDA it exits 1 and prints no
result.
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
#: H100 SXM data-sheet peaks (NVIDIA, dense, 700 W): HBM bytes/s and
#: the non-tensor f32 rate, used for every scalar ALU operation of the
#: headline kernels; int32 multiply-adds and f64 multiplies or adds issue
#: at 64 per clock per SM (132 SMs, 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
INT32_MAD_PER_S = F64_OPS_PER_S = 64 * 132 * 1.98e9


def synth_pcm(rng: np.random.Generator, frames: int) -> np.ndarray:
    """Two-tone stereo test signal with a little noise, ``[frames, 2]``
    int32 (the headline benchmark's input)."""
    t = np.arange(frames, dtype=np.float64)
    left = (0.6 * np.sin(2 * np.pi * 220.0 / 44100.0 * t)
            + 0.25 * np.sin(2 * np.pi * 587.3 / 44100.0 * t + 0.3)
            + 0.02 * rng.standard_normal(frames))
    right = (0.55 * np.sin(2 * np.pi * 329.6 / 44100.0 * t + 0.1)
             + 0.2 * np.sin(2 * np.pi * 880.0 / 44100.0 * t)
             + 0.02 * rng.standard_normal(frames))
    pcm = np.stack([left, right], axis=1)
    return np.clip(pcm * 22000, -32768, 32767).astype(np.int32)


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


def kernel_ms(torch, fn, reps: int, symbol: str) -> float:
    """Median device time of the kernel whose name contains ``symbol`` over
    ``reps`` calls of ``fn`` (profiler trace), free of the wrapper's host
    time.  The trace drops a launch's record now and then; a trace that
    holds fewer than half of them is taken again, up to three times."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    seen = []
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if symbol in e.name and "CUDA" in str(e.device_type)]
        seen.append(len(times))
        if 2 * len(times) >= reps and len(times) <= reps:
            return float(np.median(times))
    raise RuntimeError(f"profiler saw {seen} launches of {symbol} in three "
                       f"traces of {reps}")


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


def capture_main_path_inputs(names=HEADLINE_SPIES):
    """Wrap each named kernel wrapper where the encoder calls it, so one
    run of the path records the arguments of every kernel's first launch
    (positional arguments, keywords folded in by name order); returns
    ``(captured, restore)``."""
    import flacx_torch.encoder as encoder
    import flacx_torch.ops.framepack as framepack

    captured = {}
    originals = []

    def spy(module, attr):
        fn = getattr(module, attr)
        originals.append((module, attr, fn))

        def wrapped(*args, **kwargs):
            captured.setdefault(attr, args + tuple(kwargs.values()))
            return fn(*args, **kwargs)
        setattr(module, attr, wrapped)

    for name in names:
        spy(framepack if name == "frame_pack" else encoder, name)

    def restore():
        for module, attr, fn in originals:
            setattr(module, attr, fn)
    return captured, restore


def kernel_row(torch, name, symbol, kernel, plain, args, compare, ops,
               ops_per_s, source, replaces) -> dict:
    """Hold ``kernel`` against ``plain`` on ``args``, time both, and
    return the kernel's JSON row (``launches`` and ``batches`` filled in
    later)."""
    out_k = kernel(*args)
    out_p = plain(*args)
    torch.cuda.synchronize()
    err = compare(torch, out_k, out_p)
    ms = kernel_ms(torch, lambda: kernel(*args), 20, symbol)
    wrapper_ms = median_ms(torch, lambda: kernel(*args), 20)
    plain_ms = median_ms(torch, lambda: plain(*args), 5)
    moved = nbytes(args, out_k)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    print(f"kernel {name}: max_abs_err {err} ms {ms:.4f} (wrapper call "
          f"{wrapper_ms:.4f}) plain_ms {plain_ms:.4f} bound_ms "
          f"{max(t_bytes, t_ops):.4f} ({moved} bytes, {ops} ops at "
          f"{ops_per_s:.3e}/s)", flush=True)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "batches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


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


def hold(torch, name: str, wrapper: str, args: tuple) -> dict:
    """The JSON row of the kernel behind ``wrapper`` (a key of
    :func:`launch_counts`), held against its plain version on ``args``,
    the arguments the path gave its first launch."""
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
        n = x.shape[-1]
        rows = x[..., 0].numel()
        if window.dtype == torch.float64:
            # the same f64 products summed in another order: rtol 1e-12,
            # or 1e-12 of autoc[0] (n·eps64·autoc[0] bounds the error) near
            # zero; operations: the window multiply, one product and one
            # add per lag.  The JAX package runs this f64 analysis as XLA
            # (flacx/ops/lpc.py:143-150); the f64 mode belongs to the port
            # of the f32 TPU kernel.
            return kernel_row(
                torch, name, "analysis_kernel", k_an.analysis,
                k_an.analysis_plain, args, autoc_close(1e-12, 1e-12),
                rows * n * (2 * (max_lag + 1) + 1), F64_OPS_PER_S,
                csrc + "analysis.cu", "flacx/kernels/autocorr_tile.py:124")
        # f64 sums of the same f32 products in another order: within rtol
        # 1e-9, or n·eps64·autoc[0] (bounds Σ|products|) near zero
        return kernel_row(
            torch, name, "analysis_kernel", k_an.analysis,
            k_an.analysis_plain, args, autoc_close(1e-9, 1e-12),
            rows * n * (2 * (max_lag + 1) + 1 + 25), SCALAR_OPS_PER_S,
            csrc + "analysis.cu",
            "flacx/kernels/autocorr_tile.py:124 + "
            "flacx/kernels/zzsum_tile.py:115")
    if wrapper in ("lpc_residual_stats", "lpc_residual_zz"):
        zz_mode = wrapper == "lpc_residual_zz"
        xs, taps = args[0], args[1]
        return kernel_row(
            torch, name, f"lpc_residual_kernel<{str(zz_mode).lower()}>",
            getattr(k_lr, wrapper), getattr(k_lr, wrapper + "_plain"), args,
            exact, xs.numel() * (2 * taps.shape[-1] + 6), SCALAR_OPS_PER_S,
            csrc + "lpc_residual.cu",
            f"flacx/kernels/lpcres_tile.py:{225 if zz_mode else 392}")
    if wrapper == "lpc_allorder":
        x, qcoefs = args[0], args[1]
        p = qcoefs.shape[-2]
        return kernel_row(
            torch, name, "lpc_allorder_kernel", k_la.lpc_allorder,
            k_la.lpc_allorder_plain, args, exact,
            x.numel() * p * (p + 1) // 2, INT32_MAD_PER_S,
            csrc + "lpc_allorder.cu", "flacx/kernels/lpcres_tile.py:612")
    if wrapper == "rice_stats":
        zz, _, _, kmax = args
        return kernel_row(
            torch, name, "rice_stats_kernel", k_rs.rice_stats,
            rice.rice_stats, args, rice_equal,
            zz.numel() * (2 * (kmax + 1) + 1), SCALAR_OPS_PER_S,
            csrc + "rice_stats.cu", "flacx/kernels/rice_tile.py:266")
    assert wrapper == "frame_pack"
    xs, psize = args[7], args[12]
    general = not blocked_layout_ok(xs.shape[-1], psize)
    return kernel_row(
        torch, name, "frame_pack_kernel", k_fp.frame_pack,
        k_fp.frame_pack_plain, args, exact,
        xs.numel() * 30 + xs.shape[0] * args[13] * 4, SCALAR_OPS_PER_S,
        csrc + "frame_pack.cu",
        "flacx/kernels/bitpack_tile.py:316 + bitpack_tile.py:268" if general
        else ("flacx/kernels/emit_tile.py:203 + bitpack_tile.py:363 + "
              "bitpack_tile.py:529 + crc_tile.py:84"))


def launch_counts() -> dict:
    from flacx_torch.kernels import (analysis, frame_pack, lpc_allorder,
                                     lpc_residual, rice_stats)
    return {
        "analysis": analysis.analysis,
        "lpc_residual_stats": lpc_residual.lpc_residual_stats,
        "lpc_residual_zz": lpc_residual.lpc_residual_zz,
        "lpc_allorder": lpc_allorder.lpc_allorder,
        "rice_stats": rice_stats.rice_stats,
        "frame_pack": frame_pack.frame_pack,
    }


def counted_run(fn, needed) -> tuple:
    """``fn()`` with every launch counter set to 0 just before; returns
    its result and the counts, and fails if a kernel in ``needed`` was
    launched no time."""
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    counts = {k: w.launches for k, w in wrappers.items()}
    missing = [k for k in needed if counts[k] < 1]
    if missing:
        raise AssertionError(f"path did not launch {missing}: {counts}")
    return out, counts


def subframe_params(frame) -> tuple:
    return (frame.header.channels,
            tuple((sf.kind, sf.order, sf.shift, sf.coefficients,
                   sf.wasted_bits) for sf in frame.subframes))


def blocks_of(pcm: np.ndarray, n: int) -> np.ndarray:
    """Interleaved ``[samples, 2]`` PCM as int16 ``[frames, 2, n]``."""
    return np.ascontiguousarray(
        pcm.reshape(-1, n, 2).transpose(0, 2, 1).astype(np.int16))


def check_frames(frames: list, planar: np.ndarray, cfg, what: str,
                 decode: int = 16) -> tuple:
    """Every CRC-16 holds, the first ``decode`` frames decode bit-exactly,
    and the plain CPU path writes the same bytes on them wherever both
    chose the same coefficients; returns ``(decoded, frames that chose
    other coefficients)``."""
    from flacx_torch.crc import crc16
    from flacx_torch.encoder import BatchEncoder
    from flacx_torch.oracle.decoder import read_frame

    if len(frames) != len(planar):
        raise AssertionError(f"{what}: {len(frames)} frames, expected "
                             f"{len(planar)}")
    for i, fr in enumerate(frames):
        if crc16(fr[:-2]) != int.from_bytes(fr[-2:], "big"):
            raise AssertionError(f"{what} frame {i}: CRC-16 mismatch")
    decoded = [read_frame(fr, 16) for fr in frames[:decode]]
    for i, (_, planes) in enumerate(decoded):
        if not np.array_equal(np.asarray(planes), planar[i]):
            raise AssertionError(f"{what} frame {i} does not decode "
                                 "bit-exactly")
    cpu_frames = BatchEncoder(cfg, batch_frames=16, device="cpu") \
        .encode_frames(planar[:16], 0)
    differ = 0
    for i, (gpu_fr, cpu_fr) in enumerate(zip(frames, cpu_frames)):
        if gpu_fr == cpu_fr:
            continue
        if subframe_params(decoded[i][0]) == subframe_params(
                read_frame(cpu_fr, 16)[0]):
            raise AssertionError(f"{what} frame {i}: same coefficients on "
                                 "cuda and cpu but different bytes")
        differ += 1
    return decoded, differ


def time_path(torch, enc, planar: np.ndarray, reps: int) -> tuple:
    """``encode_frames`` ms per 1024-frame batch over the whole input
    (host transfer and drain included), and the device pipeline's ms per
    batch (``encode_batch_device`` on one device-resident batch)."""
    batches = -(-len(planar) // enc.batch_frames)
    t0 = time.perf_counter()
    for _ in range(reps):
        enc.encode_frames(planar, 0)
    e2e_ms = (time.perf_counter() - t0) / reps / batches * 1e3
    dev_pcm = torch.from_numpy(planar[:enc.batch_frames]).cuda()
    dev_ms = median_ms(torch, lambda: enc.encode_batch_device(dev_pcm, 0),
                       reps)
    return e2e_ms, dev_ms


def headline_phase(torch, pcm: np.ndarray) -> list[dict]:
    """The headline batch: kernels against their plain versions, then the
    counted run, the frame checks and the timing."""
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
    del captured

    t0 = time.perf_counter()
    frames, counts = counted_run(
        lambda: enc.encode_frames(planar, 0),
        [k for k in launch_counts() if k != "lpc_allorder"])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    print(f"main path launches {counts}", flush=True)
    for row in rows:
        row["launches"], row["batches"] = counts[row["name"]], 1

    _, differ = check_frames(frames, planar, cfg, "headline")
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
    analysis of the first window, its every-order statistics, the zigzag
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
            assert args[1].dtype == torch.float64 and args[3]
        if wrapper in ("lpc_allorder", "lpc_residual_zz", "rice_stats"):
            assert args[0].shape == (B, 4, bs), args[0].shape
        row = hold(torch, f"{name}@{bs}", wrapper, args)
        row["wrapper"] = wrapper
        rows.append(row)
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
        frames, counts = counted_run(lambda: enc.encode_frames(planar, 0),
                                     BEST_PATH)
        torch.cuda.synchronize()
        batches = -(-len(planar) // B)
        for row in bs_rows:
            row["launches"] = counts[row.pop("wrapper")]
            row["batches"] = batches
        rows += bs_rows
        _, differ = check_frames(frames, planar, enc.config, f"best {bs}")
        size_by_bs[bs] = sum(map(len, frames))
        e2e_ms, dev_ms = time_path(torch, enc, planar, 3)
        print(f"best {bs}: {len(frames)} frames in {batches} batches, "
              f"launches {counts}; all CRC-16 valid, 16 decoded bit-exact; "
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
    frames, counts = counted_run(
        lambda: BatchEncoder(cfg, batch_frames=WASTED_FRAMES)
        .encode_frames(planar, 0), BEST_PATH)
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    from flacx_torch.kernels.build import build_all

    t_start = time.perf_counter()
    card = card_line()
    build_s = build_all()
    print(f"card {card}; torch {torch.__version__} cuda {torch.version.cuda};"
          f" kernel build {build_s:.2f} s", flush=True)

    pcm = synth_pcm(np.random.default_rng(SEED), N * B)
    rows = headline_phase(torch, pcm)
    rows += best_phase(torch, pcm)
    wasted_phase(pcm)

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
