#!/usr/bin/env python3
"""Smoke run of flacx_torch on one NVIDIA card.

    python3 chip_smoke.py

Builds the four CUDA kernels from ``flacx_torch/kernels/csrc``, holds each
against its plain PyTorch version on the card at the shapes the headline
encode gives it, then encodes one 1024-frame batch of the headline
configuration (block 4608, LPC order 12, 16-bit stereo) through
``BatchEncoder`` on the card and checks the frames: every launch counter
rose, every frame's CRC-16 holds, 16 frames decode bit-exactly under the
port's oracle decoder, and they match the plain CPU path byte for byte
wherever both chose the same coefficients.

Prints one line per phase, then the kernels' JSON line, the card's name and
power limit, and as its last line ``{"ok": true, "device": {...}}``.  Any
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
#: H100 SXM data-sheet peaks (NVIDIA, dense, 700 W): HBM bytes/s and
#: the non-tensor f32 rate, used for every scalar ALU operation.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


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
    time."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if symbol in e.name and "CUDA" in str(e.device_type)]
    if len(times) != reps:
        raise RuntimeError(f"profiler saw {len(times)} launches of {symbol}, "
                           f"expected {reps}")
    return float(np.median(times))


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


def capture_main_path_inputs():
    """Wrap each kernel wrapper where the encoder calls it, so one run of
    the main path records the arguments of every kernel's first launch;
    returns ``(captured, restore)``."""
    import flacx_torch.encoder as encoder
    import flacx_torch.ops.framepack as framepack

    captured = {}
    originals = []

    def spy(module, attr, key):
        fn = getattr(module, attr)
        originals.append((module, attr, fn))

        def wrapped(*args):
            captured.setdefault(key, args)
            return fn(*args)
        setattr(module, attr, wrapped)

    spy(encoder, "analysis", "analysis")
    spy(encoder, "lpc_residual_stats", "lpc_residual_stats")
    spy(encoder, "lpc_residual_zz", "lpc_residual_zz")
    spy(encoder, "rice_stats", "rice_stats")
    spy(framepack, "frame_pack", "frame_pack")

    def restore():
        for module, attr, fn in originals:
            setattr(module, attr, fn)
    return captured, restore


def check_kernels(torch, captured: dict) -> list[dict]:
    """Each kernel against its plain version on the captured inputs."""
    from flacx_torch.kernels import analysis as k_an
    from flacx_torch.kernels import frame_pack as k_fp
    from flacx_torch.kernels import lpc_residual as k_lr
    from flacx_torch.kernels import rice_stats as k_rs
    from flacx_torch.ops import rice

    rows = []

    def run(name, symbol, kernel, plain, args, compare, ops, source,
            replaces):
        out_k = kernel(*args)
        out_p = plain(*args)
        torch.cuda.synchronize()
        err = compare(out_k, out_p)
        ms = kernel_ms(torch, lambda: kernel(*args), 20, symbol)
        wrapper_ms = median_ms(torch, lambda: kernel(*args), 20)
        plain_ms = median_ms(torch, lambda: plain(*args), 5)
        moved = nbytes(args, out_k)
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = ops / SCALAR_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
        print(f"kernel {name}: max_abs_err {err} ms {ms:.4f} (wrapper call "
              f"{wrapper_ms:.4f}) plain_ms {plain_ms:.4f} bound_ms "
              f"{max(t_bytes, t_ops):.4f} ({moved} bytes, {ops} ops)",
              flush=True)

    def exact(a, b):
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            if not torch.equal(u, v):
                diff = (u.long() - v.long()).abs().max().item()
                raise AssertionError(f"kernel differs from plain: {diff}")
        return 0

    def autoc_close(a, b):
        (ac_k, fs_k), (ac_p, fs_p) = a, b
        exact(fs_k, fs_p)
        # f64 sums of the same f32 products in another order: within
        # rtol 1e-9, or n·eps64·autoc[0] (bounds Σ|products|) near zero
        err = (ac_k - ac_p).abs()
        tol = 1e-9 * ac_p.abs() + 1e-12 * ac_p[..., :1].abs()
        if not bool((err <= tol).all()):
            raise AssertionError("analysis autocorrelation out of tolerance:"
                                 f" max err {err.max().item()}")
        return float(err.max().item())

    def rice_equal(a, b):
        for po in b:
            exact(tuple(a[po]), tuple(b[po]))
        return 0

    x, window, max_lag = captured["analysis"]
    rows_an, n = x[..., 0].numel(), x.shape[-1]
    run("analysis", "analysis_kernel", k_an.analysis, k_an.analysis_plain,
        (x, window, max_lag),
        autoc_close, rows_an * n * (2 * (max_lag + 1) + 1 + 25),
        "flacx_torch/kernels/csrc/analysis.cu",
        "flacx/kernels/autocorr_tile.py:124 + flacx/kernels/zzsum_tile.py:115")

    for mode, zz_mode, kernel, plain, line in (
            ("stats", "false", k_lr.lpc_residual_stats,
             k_lr.lpc_residual_stats_plain, 392),
            ("zz", "true", k_lr.lpc_residual_zz, k_lr.lpc_residual_zz_plain,
             225)):
        args = captured[f"lpc_residual_{mode}"]
        xs, taps = args[0], args[1]
        run(f"lpc_residual_{mode}", f"lpc_residual_kernel<{zz_mode}>",
            kernel, plain, args, exact,
            xs.numel() * (2 * taps.shape[-1] + 6),
            "flacx_torch/kernels/csrc/lpc_residual.cu",
            f"flacx/kernels/lpcres_tile.py:{line}")

    zz, order, porders, kmax = captured["rice_stats"]
    run("rice_stats", "rice_stats_kernel", k_rs.rice_stats, rice.rice_stats,
        (zz, order, porders, kmax), rice_equal,
        zz.numel() * (2 * (kmax + 1) + 1),
        "flacx_torch/kernels/csrc/rice_stats.cu",
        "flacx/kernels/rice_tile.py:266")

    fp_args = captured["frame_pack"]
    xs = fp_args[7]
    run("frame_pack", "frame_pack_kernel", k_fp.frame_pack,
        k_fp.frame_pack_plain, fp_args, exact,
        xs.numel() * 30 + xs.shape[0] * fp_args[-1] * 4,
        "flacx_torch/kernels/csrc/frame_pack.cu",
        "flacx/kernels/emit_tile.py:203 + bitpack_tile.py:363 + "
        "bitpack_tile.py:529 + crc_tile.py:84")
    return rows


def launch_counts() -> dict:
    from flacx_torch.kernels import (analysis, frame_pack, lpc_residual,
                                     rice_stats)
    return {
        "analysis": analysis.analysis,
        "lpc_residual_stats": lpc_residual.lpc_residual_stats,
        "lpc_residual_zz": lpc_residual.lpc_residual_zz,
        "rice_stats": rice_stats.rice_stats,
        "frame_pack": frame_pack.frame_pack,
    }


def subframe_params(frame) -> tuple:
    return (frame.header.channels,
            tuple((sf.kind, sf.order, sf.shift, sf.coefficients)
                  for sf in frame.subframes))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    from flacx_torch.crc import crc16
    from flacx_torch.encoder import BatchEncoder, EncoderConfig
    from flacx_torch.kernels.build import build_all
    from flacx_torch.oracle.decoder import read_frame

    card = card_line()
    build_s = build_all()
    print(f"card {card}; torch {torch.__version__} cuda {torch.version.cuda};"
          f" kernel build {build_s:.2f} s", flush=True)

    cfg = EncoderConfig(block_size=N, max_lpc_order=12)
    enc = BatchEncoder(cfg, batch_frames=B)
    pcm = synth_pcm(np.random.default_rng(SEED), N * B)
    planar = np.ascontiguousarray(
        pcm.reshape(B, N, 2).transpose(0, 2, 1).astype(np.int16))

    # ---- phase 2: kernels against their plain versions on the card
    captured, restore = capture_main_path_inputs()
    try:
        enc.encode_frames(planar, 0)
    finally:
        restore()
    torch.cuda.synchronize()
    rows = check_kernels(torch, captured)
    del captured

    # ---- phase 3: the headline batch through BatchEncoder on the card
    wrappers = launch_counts()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    frames = enc.encode_frames(planar, 0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in wrappers.items()}
    print(f"main path launches {counts}", flush=True)
    missing = [k for k, v in counts.items() if v < 1]
    if missing:
        raise AssertionError(f"main path did not launch {missing}")
    for row in rows:
        row["launches"] = counts[row["name"]]

    if len(frames) != B:
        raise AssertionError(f"{len(frames)} frames, expected {B}")
    for i, fr in enumerate(frames):
        if crc16(fr[:-2]) != int.from_bytes(fr[-2:], "big"):
            raise AssertionError(f"frame {i}: CRC-16 mismatch")
    total_bytes = sum(map(len, frames))

    decoded = [read_frame(fr, 16) for fr in frames[:16]]
    for i, (_, planes) in enumerate(decoded):
        if not np.array_equal(np.asarray(planes), planar[i]):
            raise AssertionError(f"frame {i} does not decode bit-exactly")

    cpu_frames = BatchEncoder(cfg, batch_frames=16, device="cpu") \
        .encode_frames(planar[:16], 0)
    differ = 0
    for i, (gpu_fr, cpu_fr) in enumerate(zip(frames, cpu_frames)):
        if gpu_fr == cpu_fr:
            continue
        if subframe_params(decoded[i][0]) == subframe_params(
                read_frame(cpu_fr, 16)[0]):
            raise AssertionError(f"frame {i}: same coefficients on cuda and "
                                 "cpu but different bytes")
        differ += 1
    print(f"e2e frames {B}: all CRC-16 valid, 16 decoded bit-exact; "
          f"cpu plain path byte-equal on {16 - differ}/16 "
          f"({differ} chose other coefficients); "
          f"{total_bytes} bytes, ratio {total_bytes / planar.nbytes:.4f}",
          flush=True)

    # ---- timing: whole entry point (host transfer and drain included)
    # and the device pipeline alone
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        enc.encode_frames(planar, 0)
    e2e_ms = (time.perf_counter() - t0) / reps * 1e3
    dev_pcm = torch.from_numpy(planar).cuda()
    dev_ms = median_ms(torch, lambda: enc.encode_batch_device(dev_pcm, 0),
                       reps)
    sps = B * N * 2 / (e2e_ms / 1e3)
    print(f"e2e encode_frames: {e2e_ms:.3f} ms per {B}-frame batch, "
          f"{sps:.1f} samples/s; device pipeline {dev_ms:.3f} ms per batch "
          f"({B * N * 2 / (dev_ms / 1e3):.1f} samples/s); first call "
          f"{first_s * 1e3:.1f} ms", flush=True)

    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
