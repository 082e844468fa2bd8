#!/usr/bin/env python3
"""Where the time of a flacx_torch encode or decode goes, on one card.

    python3 tools/profile_torch.py [--config headline|best|hires|hires6|
                                    conformance|decode] [--block N]
                                   [--batches 3]
                                   [--batch-frames 256]
                                   [--stream headline|hibps28|hibps32]
                                   [--tree DIR] [--out profile_out]

Encodes one batch with ``BatchEncoder.encode_batch_device`` under
``torch.profiler``.  ``--config headline`` (the default) is 1024 frames
of 16-bit stereo (the two-tone test signal from seed 0xF1AC) at block
4608, LPC order 12, estimate order search; ``--config best`` is the
best-compression encode of the same PCM (``encode --best``: exact order
search over the windows Tukey(0.5), Hann and flattop, f64 analysis) at
``--block`` 4608, 2304 or 1152; ``--config hires`` is the hi-res encode
(24-bit, block 16384, LPC order 32, partition orders 0..15) of 128
stereo frames, ``--config hires6`` of 64 5.1 frames, the PCM of
``chip_smoke.py``'s hi-res phases, ``--config conformance`` the headline
batch with ``conformance=True`` (the reference encoder's choices).
``--config decode`` decodes the
1024 frames of ``--stream`` (the headline batch, or the 28- or 32-bit
stereo batch of ``chip_smoke.py``'s ``hibps`` phase at the headline
settings), encoded on the card into a FLAC stream, with
``decoder.decode_array`` at ``--batch-frames`` frames a batch (the
CLI's default 256), ``--batches`` times; its numbers are a decode batch's
and its host stages the decoder's (frame scan, row staging, the C++
walker, the H2D copies, the kernels' enqueue, the flags' read, the D2H
copy).  ``--tree DIR`` profiles the ``flacx_torch`` package of another
checkout (e.g. the parent commit's) with this checkout's data.  Prints:
the wall time per batch, the device time per batch (sum of kernel times)
and the device's idle share of the window, the kernel time and host time
of each pipeline stage (profiler ranges around the stage functions), and
the top device kernels, and the device's idle time in the window by the
span of the program's own (``flacx_torch.trace``, on the profiler's
clock) open in each idle gap: the stage the device waits on (skipped for
a ``--tree`` checkout without ``flacx_torch/trace.py``).  Times are
taken under the profiler, whose own host cost inflates the wall time.
The full kernel table goes to ``<out>/profile_torch.txt``.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import bisect
import functools
import importlib.util
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

#: stage name → (module, attribute) of the function the stage runs
STAGES = {
    "analysis kernel": ("flacx_torch.encoder", "analysis"),
    "levinson": ("flacx_torch.encoder", "levinson_all_orders"),
    "quantize": ("flacx_torch.encoder", "quantize_all_orders"),
    "lpc_allorder kernel": ("flacx_torch.encoder", "lpc_allorder"),
    "lpc_residual stats kernel": ("flacx_torch.encoder",
                                  "lpc_residual_stats"),
    "lpc_residual zz kernel": ("flacx_torch.encoder", "lpc_residual_zz"),
    "rice_stats kernel": ("flacx_torch.encoder", "rice_stats"),
    "rice plan": ("flacx_torch.ops.rice", "exact_plan"),
    "frame header": ("flacx_torch.encoder", "frame_header_symbols"),
    "emit symbols + frame_pack": ("flacx_torch.encoder", "pack_frames"),
    "frame_pack kernel": ("flacx_torch.ops.framepack", "frame_pack"),
}
#: the conformance encode's stages, as STAGES
CONF_STAGES = {
    "reference_lpc kernel": ("flacx_torch.conformance", "reference_lpc"),
    "abs_residual_sums kernel": ("flacx_torch.conformance",
                                 "abs_residual_sums"),
    "lpc_residual zz kernel": ("flacx_torch.conformance", "lpc_residual_zz"),
    "reference rice plan": ("flacx_torch.conformance",
                            "reference_rice_plan"),
    "frame header": ("flacx_torch.conformance", "frame_header_symbols"),
    "emit symbols + frame_pack": ("flacx_torch.conformance", "pack_frames"),
    "frame_pack kernel": ("flacx_torch.ops.framepack", "frame_pack"),
}
#: stages that run inside another stage (not added to the staged total)
NESTED = {"frame_pack kernel"}
#: the decode's stages, as STAGES
DECODE_STAGES = {
    "frame scan": ("flacx_torch.decoder", "_scan_frame_offsets"),
    "row staging": ("flacx_torch.decoder", "scatter_rows"),
    "walker": ("flacx_torch.decoder", "scan_frames"),
    "copy H2D": ("flacx_torch.decoder", "_upload"),
    "kernels (enqueue)": ("flacx_torch.decoder", "_device_decode"),
    "flags (sync)": ("flacx_torch.decoder", "_ok"),
    "copy D2H": ("flacx_torch.decoder", "_host_pcm"),
}


def annotate_stages(torch, stages: dict) -> None:
    """Wrap each stage function in a profiler range of the stage's name."""
    import importlib

    for label, (mod_name, attr) in stages.items():
        module = importlib.import_module(mod_name)
        fn = getattr(module, attr)

        @functools.wraps(fn)
        def wrapped(*args, _fn=fn, _label=label, **kwargs):
            with torch.profiler.record_function(f"stage: {_label}"):
                return _fn(*args, **kwargs)
        setattr(module, attr, wrapped)


def device_us(evt) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("headline", "best", "hires",
                                         "hires6", "conformance", "decode"),
                    default="headline")
    ap.add_argument("--batch-frames", type=int, default=256,
                    help="frames a decode batch of --config decode")
    ap.add_argument("--block", type=int, default=4608,
                    help="block size of --config best")
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--stream", choices=("headline", "hibps28", "hibps32"),
                    default="headline", help="the stream of --config decode")
    ap.add_argument("--tree", default=str(ROOT),
                    help="checkout whose flacx_torch to profile")
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()
    # the package from --tree, chip_smoke.py's data from this checkout
    sys.path.insert(0, str(Path(args.tree).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules["chip_smoke"])

    import torch
    if not torch.cuda.is_available():
        print("profile_torch: CUDA is not available", file=sys.stderr)
        return 1
    from chip_smoke import (B, HIRES, HIRES_N, SEED, best_config,
                            blocks_of, card_line, hires_config, hires_pcm,
                            synth_pcm)
    from flacx_torch.encoder import BatchEncoder, EncoderConfig

    if args.config == "decode":
        return profile_decode(torch, args)
    annotate_stages(torch, CONF_STAGES if args.config == "conformance"
                    else STAGES)
    if args.config.startswith("hires"):
        n = HIRES_N
        channels, frames, _ = HIRES[args.config]
        cfg = hires_config(channels)
        planar = blocks_of(hires_pcm(channels, frames), n, np.int32)
    else:
        n, frames = (args.block if args.config == "best" else 4608), B
        cfg = (best_config(n) if args.config == "best"
               else EncoderConfig(block_size=n, max_lpc_order=12,
                                  conformance=args.config == "conformance"))
        planar = blocks_of(synth_pcm(np.random.default_rng(SEED), n * B), n)
    enc = BatchEncoder(cfg, batch_frames=frames)
    planar = torch.from_numpy(planar).cuda()
    for _ in range(2):                                   # warm-up, build
        enc.encode_batch_device(planar, 0)
    torch.cuda.synchronize()

    print(f"card {card_line()}; torch {torch.__version__}; config "
          f"{args.config}, block {n}, {frames} frames x {cfg.channels} "
          f"channels per batch")
    report(torch, lambda: enc.encode_batch_device(planar, 0), args.batches,
           args.batches, "_encode_batch", args.out)
    return 0


def profile_decode(torch, args) -> int:
    """``--config decode``: the frames of ``args.stream`` as a FLAC
    stream, decoded ``args.batches`` times under the profiler."""
    from chip_smoke import B, HIBPS, N, SEED, blocks_of, card_line, \
        flac_stream, synth_pcm
    from flacx_torch import decoder
    from flacx_torch.encoder import BatchEncoder, EncoderConfig

    bps = HIBPS.get(args.stream, 16)
    pcm = synth_pcm(np.random.default_rng(SEED + (bps if bps > 16 else 0)),
                    N * B, bps)
    cfg = EncoderConfig(block_size=N, max_lpc_order=12, bps=bps)
    frames = BatchEncoder(cfg, batch_frames=B).encode_frames(
        blocks_of(pcm, N, np.int16 if bps == 16 else np.int32), 0)
    data = flac_stream(frames, pcm, 44100, bps, N)
    annotate_stages(torch, DECODE_STAGES)
    for _ in range(2):                                   # warm-up, build
        _, got = decoder.decode_array(data, batch_frames=args.batch_frames)
    if not np.array_equal(got, pcm):
        raise AssertionError("decode is not bit-exact")
    batches = -(-B // args.batch_frames)
    print(f"card {card_line()}; torch {torch.__version__}; package "
          f"{decoder.__file__}; config decode, stream {args.stream} "
          f"({bps}-bit), block {N}, {B} frames x 2 channels in {batches} "
          f"batches of {args.batch_frames}, {args.batches} decodes")
    report(torch, lambda: decoder.decode_array(
        data, batch_frames=args.batch_frames), args.batches,
        args.batches * batches, "decode_array", args.out)
    return 0


def program_trace():
    """The profiled package's ``flacx_torch.trace``, or None where the
    checkout has none."""
    try:
        from flacx_torch import trace
    except ImportError:
        return None
    return trace


def idle_by_span(prof, lo: int, hi: int, spans: dict) -> dict:
    """Seconds of the device's idle gaps in ``[lo, hi]`` (ns) by the
    program span open at each gap's middle (``none`` where none is; the
    program's spans do not nest).  Device work is every CUDA-side event
    but the echoes of the stage ranges."""
    busy = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" in str(e.device_type()) and \
                not e.name().startswith("stage: "):
            start = e.start_ns()
            busy.append((start, start + e.duration_ns()))
    gaps, at = [], lo
    for a, b in sorted(busy):
        a, b = max(a, lo), min(b, hi)
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    flat = sorted((s, e, name) for name, iv in spans.items() for s, e in iv)
    starts = [s for s, _, _ in flat]
    out: dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = flat[i][2] if i >= 0 and flat[i][1] >= mid else "none"
        out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return out


def report(torch, fn, runs: int, batches: int, rest: str, out: str) -> None:
    """Run ``fn`` ``runs`` times under the profiler and print the numbers
    per batch (``batches`` in all)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    trace = program_trace()
    if trace is not None:
        trace.reset()
    with torch.profiler.profile(activities=acts) as prof:
        lo = time.time_ns()
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / batches
        hi = time.time_ns()
    events = prof.key_averages()
    kernels = [e for e in events if self_device_us(e) > 0
               and "CUDA" in str(getattr(e, "device_type", "CUDA"))
               and not e.key.startswith("stage: ")]
    dev_ms = sum(self_device_us(e) for e in kernels) / 1e3 / batches
    n_kernels = sum(e.count for e in kernels) / batches

    print(f"wall {wall_ms:.3f} ms per batch; device busy {dev_ms:.3f} ms "
          f"per batch ({n_kernels:.0f} kernel launches); device idle share "
          f"{max(0.0, 1 - dev_ms / wall_ms):.4f}")
    print("per batch by stage: kernel ms (device time of the stage's "
          "kernels), host ms (host time inside the stage)")
    k_staged = h_staged = 0.0
    stages = [e for e in events if e.key.startswith("stage: ")
              and "CUDA" not in str(getattr(e, "device_type", "CPU"))]
    for e in sorted(stages, key=lambda e: e.cpu_time_total, reverse=True):
        k_ms = device_us(e) / 1e3 / batches
        h_ms = e.cpu_time_total / 1e3 / batches
        if e.key[7:] not in NESTED:
            k_staged += k_ms
            h_staged += h_ms
        print(f"  {e.key[7:]:<28} kernel {k_ms:8.3f}  host {h_ms:8.3f}")
    print(f"  {'rest of ' + rest:<28} kernel {dev_ms - k_staged:8.3f}"
          f"  host {wall_ms - h_staged:8.3f}")
    print("top device kernels (ms per batch):")
    for e in sorted(kernels, key=self_device_us, reverse=True)[:15]:
        print(f"  {self_device_us(e) / 1e3 / batches:8.3f}  "
              f"x{e.count / batches:<5.4g} {e.key[:90]}")
    if trace is None:
        print("device idle by program span: skipped (the package has no "
              "flacx_torch.trace)")
    else:
        idle = idle_by_span(prof, lo, hi, trace.snapshot()["spans"])
        total = sum(idle.values())
        print(f"device idle by program span (ms per batch; {total:.3f} s "
              f"idle of {(hi - lo) / 1e9:.3f} s):")
        for name, secs in sorted(idle.items(), key=lambda kv: -kv[1]):
            print(f"  {name:<28} {secs * 1e3 / batches:8.3f}  "
                  f"({secs / max(total, 1e-12):.1%})")

    path = Path(out)
    path.mkdir(parents=True, exist_ok=True)
    sort = ("self_device_time_total"
            if hasattr(kernels[0], "self_device_time_total")
            else "self_cuda_time_total")
    (path / "profile_torch.txt").write_text(
        events.table(sort_by=sort, row_limit=80))


if __name__ == "__main__":
    sys.exit(main())
