#!/usr/bin/env python3
"""One run of one cell of the flacx_torch benchmark, on one card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  Loads the cell named in
``BENCHMARK.json`` (its configuration and traffic files), makes the
inputs from the seed, warms up every shape the cell uses (set-up,
``setup_s``), measures for ``--seconds``, and prints one JSON line: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (host spans over the window, then a profiled window of
the traffic's ``trace_seconds``).  After the window it holds what the
window produced against the plain reference (``portbench/reference.py``,
or the one the configuration names under ``portbench/references/``)
and prints each number compared beside its limit, last on standard error
and last in the JSON line.

``--control 1`` (never in a timed run) puts the reference, in the
precision below the configuration's, in the program's place for the
frames the comparison samples, after a short window of the program:
``correct`` must come out false.

Exits non-zero without a result when CUDA is missing or has fewer cards
than the cell asks for, or when ``jax``, ``jaxlib``, ``flax`` or
``flacx`` is loaded after the window.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path.pop(0)           # the folder's modules are portbench.<name>
sys.path.insert(0, str(ROOT))

from portbench import harness, tracing  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "flacx")
TRACE_PRELUDE = 512


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def traced_window(torch, entry, spans, seconds: float, dev) -> dict:
    """A window of ``seconds`` under ``torch.profiler`` (CPU and CUDA
    activities), every span a profiler range; returns its trace reduced
    to what the readers take."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    stats: dict = {}
    pad = torch.zeros(1, device=dev)
    with torch.profiler.profile(activities=acts) as prof:
        # the profiler drops records at a trace's start: small launches
        # outside the window take the loss
        for _ in range(TRACE_PRELUDE):
            pad.add_(1)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        spans.ranges = torch.profiler.record_function
        with torch.profiler.record_function(tracing.PREFIX + "window"):
            res = entry.run_window(seconds, stats=stats)
            if dev.type == "cuda":
                torch.cuda.synchronize()
        spans.ranges = None
    ev = tracing.profile_events(prof)
    (lo, hi), = ev["ranges"]["window"]
    busy = tracing.union([(a, b) for _, a, b in ev["kernels"] + ev["copies"]],
                         lo, hi)
    by_name: dict[str, float] = {}
    launches = 0
    for name, a, b in ev["kernels"] + ev["copies"]:
        if lo <= a < hi:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
            launches += not name.lower().startswith(("memcpy", "memset"))
    gaps = tracing.attribute(tracing.idle_gaps(busy, lo, hi), ev["ranges"])
    return {"window_s": (hi - lo) / 1e9,
            "busy_s": sum(b - a for a, b in busy) / 1e9,
            "launches": launches, "kernel_s": by_name, "idle_s": gaps,
            "result": res, "stats": stats}


def top(d: dict, k: int = 10) -> list:
    return [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:k]]


def run(workload: str, seed: int, seconds: float, trace: bool, device: str,
        control: bool = False, overrides: dict | None = None,
        log=print, spec: dict | None = None) -> dict:
    """One run; returns the result object (``checks`` last)."""
    import torch

    ctx = harness.context(ROOT, workload, seed, torch.device(device), spec)
    ctx.traffic.update(overrides or {})
    dev = ctx.device
    entry = harness.entry_class(ctx.traffic["entry"])(ctx)
    entry.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    spans = tracing.Spans()
    if trace:
        entry.spans(spans)
    window_s = min(seconds, 3.0) if control else seconds
    res = entry.run_window(window_s)
    if len(res["unit_s"]) >= 10:
        q = statistics.quantiles(res["unit_s"], n=10)
        log(f"window: {res['units']} {entry.unit}s, ms a {entry.unit} "
            f"p10 {q[0] * 1e3:.3f} p50 {q[4] * 1e3:.3f} p90 "
            f"{q[-1] * 1e3:.3f}", file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    bench, name = ctx.bench, ctx.cell["name"]
    metrics, out = {}, {}
    if trace:
        host = {k: list(v) for k, v in spans.times.items()}
        spans.clear()
        tw = traced_window(torch, entry, spans, float(
            ctx.traffic.get("trace_seconds", seconds)), dev)
        spans.restore()
        log(entry.histogram(tw["stats"]), file=sys.stderr)
        record = {"entry": ctx.traffic["entry"], "window": res,
                  "spans": host, "trace": {
                      **{k: tw[k] for k in ("window_s", "busy_s",
                                            "launches", "kernel_s")},
                      "units": tw["result"]["units"],
                      "batches": tw["result"].get("batches",
                                                  tw["result"]["units"]),
                      "bounds": entry.kernel_bounds(
                          tw["result"]["items"])}}
        for m in bench["per_layer"]:
            if harness.reports(m, name):
                v = harness.reader(m["name"])(record)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["breakdown"] = {"device_ops": top(tw["kernel_s"]),
                            "idle_gaps": top(tw["idle_s"])}
        busy = {"busy_s": tw["busy_s"], "window_s": tw["window_s"]}
    else:
        busy = {}
        measured = {"setup_s": setup_s, **res["metrics"]}
        for m in bench["end_to_end"]:
            if harness.reports(m, name) and m["name"] in measured:
                metrics[m["name"]] = {"value": measured[m["name"]],
                                      "unit": m["unit"]}
    frames = None
    if control:
        arith = ctx.config["control"][ctx.traffic["entry"]]
        frames = entry.control(arith)
        log(f"control: the reference at {arith} in the program's place",
            file=sys.stderr)
    t_check = time.perf_counter()
    checks, notes = entry.checks(frames)
    log(f"timing: set-up {setup_s:.3f} s, window {res['seconds']:.3f} s, "
        f"comparison {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    limits = harness.limits(ctx)
    for note in notes:
        log(f"note: {note}", file=sys.stderr)
    verdict = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    correct = all(limits[k] is not None and v <= limits[k]
                  for k, v in checks.items())
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return {"correct": correct, "attempted": res["due"],
            "failed": res["due"] - res.get("done", res["due"])
            + checks.get("frames_bad", 0) + checks.get("calls_failed", 0),
            "metrics": metrics,
            "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                       "kind": kind, "count": 1, "memory_peak_bytes": peak,
                       **busy},
            **out, "checks": verdict}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch
    chips = harness.cell(harness.load_benchmark(ROOT),
                         args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s); found "
              f"{found}", file=sys.stderr)
        return 2
    print(f"card {card_line()}; torch {torch.__version__}",
          file=sys.stderr)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 "cuda", bool(args.control))
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: {', '.join(bad)} loaded in the run's process",
              file=sys.stderr)
        return 3
    checks = result["checks"]
    print(json.dumps(result))
    for k, v in checks.items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
