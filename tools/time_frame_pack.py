#!/usr/bin/env python3
"""Device time of one or more flacx_torch kernels at the shapes of one or
more paths of ``chip_smoke.py``, from any checkout of flacx_torch.

    python3 tools/time_frame_pack.py [--tree DIR] [--reps 50]
        [--kernel {analysis,frame_pack,lpc_allorder,lpc_residual_res,
                   lpc_residual_stats,lpc_residual_zz,rice_stats,
                   reference_lpc,abs_residual_sums,bit_unpack,
                   reconstruct,crc16_rows,seq_autocorr,seq_fixed,
                   seq_lpc} ...]
        [--path {headline,best4608,best2304,best1152,hires,hires6,
                 file_default,file_b1152,file_best24,conformance,
                 conformance_hires,decode_headline,decode_fixed,
                 decode_hires,decode_hires6,decode_hibps28,
                 decode_hibps32,seq16k,seq32k} ...]

Encodes one batch of each encode path (the data of ``chip_smoke.py``:
the 1024-frame headline batch at block 4608; the best-compression batch
at block 4608, 2304 or 1152; the hi-res stereo or 5.1 batch;
``file_default`` and ``file_b1152`` a 256-frame batch of the CD rip at
the defaults and at ``-b 1152``; ``file_best24`` the 256-frame ``--best``
batches of the 24-bit master at blocks 4608, 2304 and 1152;
``conformance`` the headline batch with ``EncoderConfig(conformance=True)``
and ``conformance_hires`` the 64 hi-res stereo frames of ``chip_smoke.py``'s
conformance phase at block 16384, LPC order 32, precision 15) with the
``flacx_torch`` package found in ``DIR`` (default: this checkout), keeps
the arguments of each kernel's first launch, checks the kernel against
its plain version, and prints one JSON line per batch: the tree, the
median kernel time of ``--reps`` launches under the profiler for each
kernel (the kernels of one wrapper summed), and the card's name and
power limit.  ``analysis`` is timed over ALL of a batch's launches,
summed (a checkout that launches once per window and one that launches
once for every window time the same work).  The decode paths
(``decode_<stream>``) decode the first 256-frame batch of a stream of
``chip_smoke.py``'s ``decode`` phase (the headline PCM with its LPC
frames or with fixed predictors only, the hi-res stereo or 5.1 frames,
the 28- or 32-bit stereo frames of its ``hibps`` phase) with ``decoder.decode_array`` at 256 frames a batch and time
``bit_unpack``, ``reconstruct`` and ``crc16_rows`` on the arguments of
their first launch.  The sequence-sharding paths (``seq16k``,
``seq32k``) time the ``seqshard`` kernel's modes on the rows of
``chip_smoke.py``'s ``seqshard`` phase at ``seq_mesh(1, 8)``'s launch.
A kernel the path does not run gets ``null``.  Where the tree's
``crc16_rows`` module has ``empty``, the decode and sequence-sharding
lines add ``floor``: the median ms of an empty kernel in the same trace
(on ``crc16_rows``' grid for its batch, clusters included, on the
decode paths; one block of its size on the others).  Run it on two checkouts in one
call (A, B, B, A) to compare two versions of a kernel at these shapes.
Defaults: ``frame_pack`` at the headline.

    python3 tools/time_frame_pack.py --tree DIR --step0 [--path ...]

(Step 0) builds variants of the tree's ``seqshard.cu`` and
``crc16_rows.cu`` outside the package (``nvcc`` into a temporary
directory, the package's flags), each with one phase stripped by a text
patch (:data:`STEP0`; a patch that does not apply to the tree's source
is reported and skipped), prints each kernel's registers and spills from
``-Xptxas -v``, and times each variant with CUDA events (20 launches back
to back, the median of 5 rounds) and as the median of 20 launches in one
profiler trace a path (where the host's launch time cannot hide a short
kernel), on the arguments of the held launch of each ``--path``
(``seq16k`` / ``seq32k``: the three modes; ``decode_*``:
``crc16_rows``).  Stripped variants compute wrong results by design; the
full one is checked against the plain version.
Needs CUDA.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PATHS = ("headline", "best4608", "best2304", "best1152", "hires", "hires6",
         "file_default", "file_b1152", "file_best24", "conformance",
         "conformance_hires", "decode_headline", "decode_fixed",
         "decode_hires", "decode_hires6", "decode_hibps28",
         "decode_hibps32", "seq16k", "seq32k")
#: the decode kernels: (a substring of the CUDA symbol in every version,
#: wrapper, plain version), all in ``flacx_torch.kernels.<wrapper>``
DECODE_KERNELS = {
    "bit_unpack": ("bit_unpack_kernel", "bit_unpack", "bit_unpack_plain"),
    "reconstruct": ("reconstruct_kernel", "reconstruct",
                    "reconstruct_plain"),
    "crc16_rows": ("crc16_rows_kernel", "crc16_rows", "crc16_rows_plain"),
}
#: the sequence-sharding kernel's modes: a substring of each one's CUDA
#: symbol, all in ``flacx_torch.kernels.seqshard``
SEQ_KERNELS = {"seq_autocorr": "seq_autocorr_kernel",
               "seq_fixed": "seq_fixed_kernel", "seq_lpc": "seq_lpc_kernel"}
#: kernel -> (a substring of its CUDA symbol in every version, module,
#: wrapper, plain version)
KERNELS = {
    "frame_pack": ("frame_pack_kernel", "frame_pack", "frame_pack",
                   "frame_pack_plain"),
    "lpc_allorder": ("lpc_allorder_kernel", "lpc_allorder", "lpc_allorder",
                     "lpc_allorder_plain"),
    "rice_stats": ("rice_stats", "rice_stats", "rice_stats", None),
    "analysis": ("analysis_kernel", "analysis", "analysis",
                 "analysis_plain"),
    "lpc_residual_stats": ("lpc_residual_kernel<0", "lpc_residual",
                           "lpc_residual_stats", "lpc_residual_stats_plain"),
    "lpc_residual_zz": ("lpc_residual_kernel<1", "lpc_residual",
                        "lpc_residual_zz", "lpc_residual_zz_plain"),
    "lpc_residual_res": ("lpc_residual_kernel<2", "lpc_residual",
                         "lpc_residual_res", "lpc_residual_res_plain"),
    "reference_lpc": ("reference_lpc_kernel", "reference_analysis",
                      "reference_lpc", "reference_lpc_plain"),
    "abs_residual_sums": ("abs_residual_sums_kernel", "reference_analysis",
                          "abs_residual_sums", "abs_residual_sums_plain"),
}


#: Step 0's variants of the redesigned sources: source -> variant -> text
#: patches (old, new) of the source (``full``: none); a variant applies to
#: the sources its patches match.  ``minblocks`` asks for 4 blocks an SM
#: (at most 128 registers), ``nosplit`` drops the f32 error sums,
#: ``nodmma`` the tensor cores' exact products, ``onebucket`` runs every
#: LPC row at 32 taps, ``nomac`` drops the LPC MAC, ``parts2`` gives a
#: warp about two tiles; crc16_rows ``nofold`` XORs the words in place of
#: the table fold, ``noshift`` drops the GF(2) shift of a run,
#: ``onecluster`` takes one block a row.
STEP0 = {
    "seqshard": {
        "full": [],
        "minblocks": [("__launch_bounds__(32 * MAXWARPS)\nseq_autocorr",
                       "__launch_bounds__(32 * MAXWARPS, 4)\nseq_autocorr"),
                      ("__launch_bounds__(32 * MAXWARPS)\nseq_lpc",
                       "__launch_bounds__(32 * MAXWARPS, 4)\nseq_lpc")],
        "nosplit": [("        err[l] = __fadd_rn(err[l], __fmaf_rn(av[r], b, "
                     "-__fmul_rn(av[r], b)));", "        (void)0;")],
        "nodmma": [("      dmma(m[n0], av, sw.w[slot(k0 + k, 8 * n0 + a)]);",
                    "      (void)0;")],
        "onebucket": [("    if (ntaps <= 4)\n", "    if (ntaps < 0)\n"),
                      ("    else if (ntaps <= 8)\n", "    else if (0)\n"),
                      ("    else if (ntaps <= 12)\n", "    else if (0)\n"),
                      ("    else if (ntaps <= 16)\n", "    else if (0)\n"),
                      ("    else if (ntaps <= 24)\n", "    else if (0)\n")],
        "nomac": [("acc[r] = mad_wide(tp[k], v, acc[r]);",
                   "acc[r] += v;")],
        "parts2": [("max(1, (local + 4 * TILE - 1) / (4 * TILE))",
                    "max(1, (local + 2 * TILE - 1) / (2 * TILE))")],
    },
    "crc16_rows": {
        "full": [],
        "nofold": [("crc = fold_word(crc, wd, tab);", "crc ^= wd;")],
        "noshift": [("total ^= pw.times(crc, tab);", "total ^= crc;")],
        "onecluster": [("  return max(1, min(MAX_CLUSTER, (pieces + 8 * "
                        "WARPS - 1) / (8 * WARPS)));", "  return 1;")],
    },
}


def step0_build(cs, tree: Path, out: Path) -> dict:
    """Build every variant of :data:`STEP0` that applies to ``tree``'s
    sources into ``out``; returns ``{(source, variant): library path}`` and
    prints the registers and spills of each kernel."""
    import subprocess

    from flacx_torch.kernels import build

    csrc = tree / "flacx_torch/kernels/csrc"
    jobs = {}
    for source, variants in STEP0.items():
        text = (csrc / f"{source}.cu").read_text()
        for name, patches in variants.items():
            if not all(old in text for old, _ in patches):
                print(f"step0 {source}/{name}: patch does not apply to "
                      f"{csrc}", flush=True)
                continue
            body = text
            for old, new in patches:
                body = body.replace(old, new)
            src = out / f"{source}_{name}.cu"
            src.write_text(body)
            lib = out / f"lib{source}_{name}.so"
            jobs[source, name] = (lib, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-o",
                 str(lib), str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"step0 {key}: build failed\n{log}")
        for entry, regs, st, ld in cs.ptxas_resources(log):
            print(f"step0 {key[0]}/{key[1]} {entry}: {regs} registers, "
                  f"{st} bytes spill stores, {ld} bytes spill loads",
                  flush=True)
        libs[key] = lib
    return libs


def event_ms(torch, fn, launches: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the CUDA-event time of ``launches``
    back-to-back ``fn()`` calls, per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / launches)
    return float(sorted(times)[rounds // 2])


def trace_ms(torch, cs, runs: list, reps: int) -> list[float]:
    """Median device ms of each ``(symbol, fn)`` of ``runs``, from one
    profiler trace in which each ``fn`` runs ``reps`` times in turn: the
    kernels whose names contain a symbol are taken in launch order, so
    variants of one kernel (the same name) are told apart by their turn.
    A trace that misses a record is taken again, up to three times."""
    pad = torch.zeros(1, device="cuda")
    for _, fn in runs:
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(cs.TRACE_PRELUDE):
                pad.add_(1)
            torch.cuda.synchronize()
            for _, fn in runs:
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if "CUDA" in str(e.device_type)),
                        key=lambda e: e.time_range.start)
        by_symbol = {}
        for symbol, _ in runs:
            by_symbol.setdefault(symbol, [e.time_range.elapsed_us() / 1e3
                                          for e in events
                                          if symbol in e.name])
        wanted = {}
        for symbol, _ in runs:
            wanted[symbol] = wanted.get(symbol, 0) + reps
        if all(len(by_symbol[k]) == n for k, n in wanted.items()):
            out, seen = [], {}
            for symbol, _ in runs:
                i = seen.get(symbol, 0)
                seen[symbol] = i + reps
                ts = sorted(by_symbol[symbol][i:i + reps])
                out.append(ts[reps // 2])
            return out
    raise RuntimeError("profiler dropped records in three traces")



def step0_calls(torch, cs, path: str) -> dict:
    """``{(source, symbol): (tensors, ints, outputs, plain outputs)}``: the
    held launches of ``path`` as the C entry points take them, the
    outputs' buffers and the plain version's results."""
    calls = {}
    if path.startswith("seq"):
        from flacx_torch.kernels import seqshard as k_seq

        inp = cs.seq_inputs(torch, cs.hires_pcm(2, cs.SEQ_FRAMES),
                            cs.SEQ_BLOCKS[path])
        x, xw = inp["x"], inp["xw"]
        rows, m = x.shape
        s, lags = cs.SEQ_HOLD_SHARDS, cs.SEQ_LAGS
        ac = torch.empty((rows, s, lags + 1), dtype=torch.float64,
                         device=x.device)
        fx = torch.empty((rows, s, 5), dtype=torch.int64, device=x.device)
        lp = torch.empty((rows, s, 2), dtype=torch.int64, device=x.device)
        t = inp["taps"].shape[-1]
        calls["seqshard", "flacx_seq_autocorr"] = (
            [xw, None, ac], [rows, m, s, 0, m, lags, 0], ac,
            k_seq.seq_autocorr_plain(xw, lags, s))
        calls["seqshard", "flacx_seq_fixed"] = (
            [x, None, fx], [rows, m, s, 0, 0], fx, k_seq.seq_fixed_plain(x, s))
        calls["seqshard", "flacx_seq_lpc"] = (
            [x, None, inp["taps"], inp["shift"], inp["order"], lp],
            [rows, m, s, 0, t], lp,
            torch.stack(k_seq.seq_lpc_plain(x, inp["taps"], inp["shift"],
                                            inp["order"], s), -1))
    else:
        import flacx_torch.decoder as dec
        from flacx_torch.kernels import crc16_rows as k_crc

        data = decode_stream(cs, path[len("decode_"):])
        captured, _, restore = cs.spy_decoder(["crc16_rows"])
        try:
            dec.decode_array(data, device="cuda")
        finally:
            restore()
        rows_t, lens = captured["crc16_rows"]
        ok = torch.empty(rows_t.shape[0], dtype=torch.int32,
                         device=rows_t.device)
        all_ok = torch.ones(1, dtype=torch.int32, device=rows_t.device)
        calls["crc16_rows", "flacx_crc16_rows"] = (
            [rows_t, lens, k_crc._consts(rows_t.device), ok, all_ok],
            list(rows_t.shape), ok, k_crc.crc16_rows_plain(rows_t, lens)[0])
    return calls


def step0(torch, cs, tree: Path, paths: list) -> None:
    """Build, check and time Step 0's variants at each path's launches."""
    import ctypes
    import tempfile

    card = cs.card_line()
    with tempfile.TemporaryDirectory() as tmp:
        libs = step0_build(cs, tree, Path(tmp))
        for path in paths:
            calls = step0_calls(torch, cs, path)
            stream = torch.cuda.current_stream().cuda_stream
            ms, runs = {}, []
            for (source, variant), lib in libs.items():
                dll = ctypes.CDLL(str(lib))
                for (src, symbol), (tens, ints, out, want) in calls.items():
                    if src != source:
                        continue
                    fn = getattr(dll, symbol)
                    fn.argtypes = ([ctypes.c_void_p] * len(tens)
                                   + [ctypes.c_int] * len(ints)
                                   + [ctypes.c_void_p])
                    fn.restype = ctypes.c_int
                    ptrs = [None if t is None else t.data_ptr()
                            for t in tens]

                    def run(fn=fn, ptrs=ptrs, ints=ints):
                        rc = fn(*ptrs, *ints, stream)
                        if rc:
                            raise RuntimeError(f"{symbol}: CUDA error {rc}")
                    run()
                    torch.cuda.synchronize()
                    if variant == "full":
                        if symbol == "flacx_seq_autocorr":
                            cs.seq_autoc_close(torch, out, want)
                        else:
                            cs.exact(torch, out, want)
                    label = f"{symbol[6:]}/{variant}"
                    ms[label] = event_ms(torch, run)
                    runs.append((label, symbol[6:] + "_kernel", run))
            prof = trace_ms(torch, cs, [(sym, fn) for _, sym, fn in runs], 20)
            print(json.dumps({
                "tree": str(tree), "path": path, "step0": ms,
                "step0_profiler": {label: v for (label, _, _), v
                                   in zip(runs, prof)},
                "card": card}), flush=True)


def capture_every_call(name: str):
    """Record the arguments of every call the encoder makes to kernel
    wrapper ``name`` (a list); returns ``(calls, restore)``."""
    import flacx_torch.encoder as encoder

    fn = getattr(encoder, name)
    calls = []

    def wrapped(*args, **kwargs):
        calls.append(args + tuple(kwargs.values()))
        return fn(*args, **kwargs)
    setattr(encoder, name, wrapped)
    return calls, lambda: setattr(encoder, name, fn)


def total_ms(torch, symbol: str, fn, launches: int, reps: int) -> float:
    """Device ms of one ``fn()`` that launches ``launches`` kernels whose
    names contain ``symbol``: the sum of their times over ``reps`` calls in
    one profiler trace, divided by ``reps``; a trace that holds under half
    the launches is taken again, up to three times."""
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
                 if "CUDA" in str(e.device_type) and symbol in e.name]
        seen.append(len(times))
        if launches * reps <= 2 * len(times) <= 2 * launches * reps:
            return sum(times) / len(times) * launches
    raise RuntimeError(f"profiler saw {seen} of {launches * reps} launches")


def batches(cs, path: str):
    """``(label, encoder, planar batch)`` of each batch of ``path``."""
    import numpy as np

    from flacx_torch.encoder import BatchEncoder, EncoderConfig

    if path == "headline":
        enc = BatchEncoder(EncoderConfig(block_size=cs.N, max_lpc_order=12),
                           batch_frames=cs.B)
        pcm = cs.synth_pcm(np.random.default_rng(cs.SEED), cs.N * cs.B)
        yield path, enc, cs.blocks_of(pcm, cs.N)
    elif path.startswith("best"):
        bs = int(path[4:])
        pcm = cs.synth_pcm(np.random.default_rng(cs.SEED), cs.N * cs.B)
        enc = BatchEncoder(cs.best_config(bs), batch_frames=cs.B)
        yield path, enc, cs.blocks_of(pcm, bs)[:cs.B]
    elif path.startswith("hires"):
        channels, frames, _ = cs.HIRES[path]
        enc = BatchEncoder(cs.hires_config(channels), batch_frames=frames)
        yield path, enc, cs.blocks_of(cs.hires_pcm(channels, frames),
                                      cs.HIRES_N, np.int32)
    elif path == "conformance":
        cfg = EncoderConfig(block_size=cs.N, max_lpc_order=12,
                            conformance=True)
        pcm = cs.synth_pcm(np.random.default_rng(cs.SEED), cs.N * cs.B)
        yield path, BatchEncoder(cfg, batch_frames=cs.B), cs.blocks_of(pcm,
                                                                      cs.N)
    elif path == "conformance_hires":
        import dataclasses

        cfg = dataclasses.replace(cs.hires_config(2), qlp_precision=15,
                                  conformance=True)
        frames = cs.CONF_HIRES_FRAMES
        yield path, BatchEncoder(cfg, batch_frames=frames), cs.blocks_of(
            cs.hires_pcm(2, frames), cs.HIRES_N, np.int32)
    elif path in ("file_default", "file_b1152"):
        bs = cs.N if path == "file_default" else 1152
        cd = cs.file_inputs()["cd"][0]
        enc = BatchEncoder(EncoderConfig(block_size=bs),
                           batch_frames=cs.FILE_BATCH)
        yield path, enc, cs.blocks_of(cd[:bs * cs.FILE_BATCH], bs)
    else:
        assert path == "file_best24", path
        master = cs.file_inputs()["master"][0]
        for bs in cs.BEST_BLOCKS:
            cfg = EncoderConfig(block_size=bs, bps=24,
                                sample_rate=cs.MASTER_RATE,
                                order_search="exact", windows=cs.BEST_WINDOWS)
            enc = BatchEncoder(cfg, batch_frames=cs.FILE_BATCH)
            yield (f"{path}@{bs}", enc,
                   cs.blocks_of(master, bs, np.int32)[:cs.FILE_BATCH])


def decode_stream(cs, label: str) -> bytes:
    """The first 256 frames of the decode phase's stream ``label`` of
    ``chip_smoke.py`` (one batch at the CLI's default) as a FLAC stream."""
    import numpy as np

    from flacx_torch.encoder import BatchEncoder, EncoderConfig

    bf = cs.DECODE_BATCHES[label][0]
    if label in ("headline", "fixed"):
        pcm = cs.synth_pcm(np.random.default_rng(cs.SEED), cs.N * cs.B)
        pcm = pcm[:cs.N * bf]
        cfg = EncoderConfig(block_size=cs.N,
                            max_lpc_order=12 if label == "headline" else 0)
        frames = BatchEncoder(cfg, batch_frames=bf).encode_frames(
            cs.blocks_of(pcm, cs.N), 0)
        return cs.flac_stream(frames, pcm, 44100, 16, cs.N)
    if label in cs.HIBPS:
        bps = cs.HIBPS[label]
        pcm = cs.synth_pcm(np.random.default_rng(cs.SEED + bps), cs.N * cs.B,
                           bps)[:cs.N * bf]
        cfg = EncoderConfig(block_size=cs.N, max_lpc_order=12, bps=bps)
        frames = BatchEncoder(cfg, batch_frames=bf).encode_frames(
            cs.blocks_of(pcm, cs.N, np.int32), 0)
        return cs.flac_stream(frames, pcm, 44100, bps, cs.N)
    channels, count, _ = cs.HIRES[label]
    pcm = cs.hires_pcm(channels, count)
    enc = BatchEncoder(cs.hires_config(channels), batch_frames=count)
    frames = enc.encode_frames(cs.blocks_of(pcm, cs.HIRES_N, np.int32), 0)
    return cs.flac_stream(frames, pcm, 96000, 24, cs.HIRES_N)


def decode_ms(torch, cs, path: str, kernels: list, reps: int) -> dict:
    """Each decode kernel's median ms (``None`` for an encode kernel) on
    the arguments of its first launch in the decode of ``path``, after
    checking it against its plain version on them."""
    import importlib

    import flacx_torch.decoder as dec

    data = decode_stream(cs, path[len("decode_"):])
    names = [k for k in kernels if k in DECODE_KERNELS]
    captured, _, restore = cs.spy_decoder(names)
    try:
        dec.decode_array(data, device="cuda")
    finally:
        restore()
    torch.cuda.synchronize()
    launches = {}
    for k in names:
        symbol, wrapper, plain = DECODE_KERNELS[k]
        mod = importlib.import_module(f"flacx_torch.kernels.{wrapper}")
        fn, args = getattr(mod, wrapper), captured[k]
        cs.exact(torch, fn(*args), getattr(mod, plain)(*args))
        launches[symbol] = (lambda f=fn, a=args: f(*a))
    floor_launch(launches, captured.get("crc16_rows"))
    ms = cs.kernel_times(torch, launches, reps) if launches else {}
    out = {k: ms[DECODE_KERNELS[k][0]] if k in names else None
           for k in kernels}
    if FLOOR in ms:
        out["floor"] = ms[FLOOR]
    return out


#: the empty kernel's symbol (``crc16_rows.empty``)
FLOOR = "flacx_empty_kernel"


def floor_launch(launches: dict, crc_args) -> None:
    """Add the empty kernel on ``crc16_rows``' grid (for the rows of
    ``crc_args``, else one block) to a trace's ``launches``, where the
    tree has it."""
    from flacx_torch.kernels import crc16_rows as k_crc

    if not launches or not hasattr(k_crc, "empty"):
        return
    import torch

    f, w = crc_args[0].shape if crc_args else (1, 4)
    launches[FLOOR] = lambda: k_crc.empty(torch.device("cuda"), f, w)


def seq_ms(torch, cs, path: str, kernels: list, reps: int) -> dict:
    """Each ``seqshard`` mode's median ms (``None`` for another kernel) on
    the rows of the ``seqshard`` phase's block ``path``, after checking it
    against its plain version on them."""
    from flacx_torch.kernels import seqshard as k_seq

    inp = cs.seq_inputs(torch, cs.hires_pcm(2, cs.SEQ_FRAMES),
                        cs.SEQ_BLOCKS[path])
    s = cs.SEQ_HOLD_SHARDS
    args = {"seq_autocorr": (inp["xw"], cs.SEQ_LAGS, s),
            "seq_fixed": (inp["x"], s),
            "seq_lpc": (inp["x"], inp["taps"], inp["shift"], inp["order"],
                        s)}
    launches = {}
    for k in kernels:
        if k in SEQ_KERNELS:
            fn, plain = getattr(k_seq, k), getattr(k_seq, k + "_plain")
            compare = cs.seq_autoc_close if k == "seq_autocorr" else cs.exact
            compare(torch, fn(*args[k]), plain(*args[k]))
            launches[SEQ_KERNELS[k]] = (lambda f=fn, a=args[k]: f(*a))
    floor_launch(launches, None)
    ms = cs.kernel_times(torch, launches, reps) if launches else {}
    out = {k: ms[SEQ_KERNELS[k]] if k in SEQ_KERNELS else None
           for k in kernels}
    if FLOOR in ms:
        out["floor"] = ms[FLOOR]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT),
                    help="checkout whose flacx_torch to time")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--kernel", nargs="+",
                    choices=sorted(KERNELS) + sorted(DECODE_KERNELS)
                    + sorted(SEQ_KERNELS),
                    default=["frame_pack"])
    ap.add_argument("--path", nargs="+", choices=PATHS, default=["headline"])
    ap.add_argument("--step0", action="store_true",
                    help="time the tree's seqshard and crc16_rows sources "
                    "with phases stripped (the docstring's Step 0)")
    args = ap.parse_args()
    tree = str(Path(args.tree).resolve())
    sys.path.insert(0, tree)

    import importlib

    import torch

    # this checkout's helpers, whatever tree the package comes from
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    if not torch.cuda.is_available():
        print("time_frame_pack: CUDA is not available", file=sys.stderr)
        return 1
    import flacx_torch
    from flacx_torch.ops import rice

    if not Path(flacx_torch.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"flacx_torch came from {flacx_torch.__file__}")
    if args.step0:
        step0(torch, cs, Path(tree), [p for p in args.path
                                      if p.startswith(("seq", "decode_"))])
        return 0
    card = cs.card_line()
    for path in args.path:
        if path.startswith(("decode_", "seq")):
            timer = decode_ms if path.startswith("decode_") else seq_ms
            print(json.dumps({
                "tree": args.tree, "path": path,
                "ms": timer(torch, cs, path, args.kernel, args.reps),
                "reps": args.reps, "card": card}), flush=True)
            continue
        for label, enc, planar in batches(cs, path):
            # the wrappers the path's module calls (conformance mode's
            # module calls its own kernels and lpc_residual_zz)
            module = (importlib.import_module("flacx_torch.conformance")
                      if path.startswith("conformance") else
                      importlib.import_module("flacx_torch.encoder"))
            others = [k for k in args.kernel
                      if k != "analysis" and k in KERNELS
                      and (k == "frame_pack" or hasattr(module, k))]
            captured, restore = cs.capture_main_path_inputs(others,
                                                            module=module)
            calls, restore_an = capture_every_call("analysis")
            try:
                enc.encode_batch_device(planar, 0)
            finally:
                restore()
                restore_an()
            torch.cuda.synchronize()
            launches, out = {}, {}
            for kernel in args.kernel:
                if kernel not in KERNELS:
                    out[kernel] = None
                    continue
                symbol, module, wrapper, plain = KERNELS[kernel]
                mod = importlib.import_module(f"flacx_torch.kernels.{module}")
                fn = getattr(mod, wrapper)
                ref = getattr(mod, plain) if plain else None
                if kernel == "analysis":
                    if not calls:
                        out[kernel] = None
                        continue
                    close = cs.autoc_close(
                        1e-12 if calls[0][1].dtype == torch.float64 else 1e-9,
                        1e-12)
                    for a in calls:
                        close(torch, fn(*a), ref(*a))
                    # one launch a wrapper call, in every checkout
                    out[kernel] = total_ms(
                        torch, symbol, lambda f=fn: [f(*a) for a in calls],
                        len(calls), args.reps)
                    continue
                if kernel not in captured:
                    out[kernel] = None
                    continue
                kargs = captured[kernel]
                if plain is None:
                    cs.rice_equal(torch, fn(*kargs), rice.rice_stats(*kargs))
                elif kernel == "reference_lpc":
                    cs.bits_equal(torch, fn(*kargs), ref(*kargs))
                else:
                    cs.exact(torch, fn(*kargs), ref(*kargs))
                launches[symbol] = (lambda f=fn, a=kargs: f(*a))
            if launches:
                ms = cs.kernel_times(torch, launches, args.reps)
                out.update({k: ms[KERNELS[k][0]] for k in args.kernel
                            if k in KERNELS and KERNELS[k][0] in ms})
            print(json.dumps({
                "tree": args.tree, "path": label,
                "ms": {k: out[k] for k in args.kernel},
                "analysis_launches": len(calls), "reps": args.reps,
                "card": card}), flush=True)
            del captured, calls, launches, enc, planar
    return 0


if __name__ == "__main__":
    sys.exit(main())
