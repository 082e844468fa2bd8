"""Fixtures of the benchmark's tests: tiny cells on the CPU's plain path."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: each entry's traffic cut to a size a CPU test run holds
TINY = {
    "encode_frame_stream": dict(batch_frames=4, pool=2, warmup_batches=1,
                                trace_seconds=0.5,
                                check={"frames": 8, "decode_frames": 2}),
    "decode_array": dict(frames_per_stream=4, streams=2,
                         encode_batch_frames=4, batch_frames=2,
                         warmup_streams=1,
                         trace_seconds=0.5, check={"calls": 2, "frames": 2}),
}


#: cells whose files the benchmark holds but ``BENCHMARK.json`` does not
#: list yet (their runs spread past any bound the contract allows)
LATER = {
    "cd16_default.decode": {"name": "cd16_default.decode",
                            "config": "cd16_default",
                            "traffic": "decode.s2048", "chips": 1},
    "hires24_96.decode": {"name": "hires24_96.decode",
                          "config": "hires24_96",
                          "traffic": "decode.s512", "chips": 1},
}


@pytest.fixture
def tiny():
    """``tiny(workload, **kwargs)``: one CPU run of the cell at
    :data:`TINY` size (``portbench.run.run``'s result)."""
    from portbench import harness, run

    def go(workload, seconds=1.0, trace=False, control=False,
           device="cpu", **over):
        spec = LATER.get(workload)
        w = spec or harness.cell(harness.load_benchmark(ROOT), workload)
        entry = harness.traffic_file(w["traffic"])["entry"]
        return run.run(workload, 20260001, seconds, trace, device, control,
                       {**TINY[entry], **over}, log=lambda *a, **k: None,
                       spec=spec)
    return go
