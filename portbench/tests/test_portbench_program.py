"""The per-layer metrics that read the program's own spans and counters
(``portbench/program.py``): a traced dry run of each encode cell reports
every one of them, and a registry that does not match the profiled
window reads as nothing."""

import json
import math
from pathlib import Path

import pytest

from portbench import harness, readers

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
#: the per-layer metrics whose readers read the program's registry
PROGRAM = [m["name"] for m in BENCH["per_layer"]
           if "from portbench import program" in (
               ROOT / "portbench" / "metrics" / f"{m['name']}.py").read_text()]
ENCODE = [w["name"] for w in BENCH["workloads"]
          if w["name"].endswith(".encode")]


def test_the_eight_program_metrics_are_listed():
    assert PROGRAM == ["encode_upload_ms", "encode_analysis_ms",
                       "encode_select_ms", "encode_plan_ms",
                       "encode_emit_ms", "encode_fetch_ms", "encode_cut_ms",
                       "encode_copy_mb_per_batch"]


@pytest.mark.parametrize("cell", ENCODE)
def test_traced_dry_run_reports_every_program_metric(tiny, cell):
    from flacx_torch import trace

    trace.reset()
    res = tiny(cell, trace=True)
    assert res["correct"]
    for name in PROGRAM:
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, name
    assert res["metrics"]["encode_copy_mb_per_batch"]["value"] > 0
    assert res["metrics"]["encode_emit_ms"]["value"] > 0


def test_a_registry_that_does_not_match_the_window_reads_nothing():
    import numpy as np

    from flacx_torch import trace
    from flacx_torch.encoder import BatchEncoder, EncoderConfig

    trace.reset()
    enc = BatchEncoder(EncoderConfig(block_size=1152, max_lpc_order=8),
                       batch_frames=2, device="cpu")
    pcm = np.zeros((2, 2, 1152), np.int16)
    with trace.recording():
        list(enc.encode_frame_stream([pcm, pcm], 0))

    def record(batches, entry=readers.ENCODE):
        return {"entry": entry, "trace": {"batches": batches}}
    try:
        for name in PROGRAM:
            read = harness.reader(name)
            assert read(record(2)) is not None, name
            assert read(record(3)) is None, name
            assert read(record(1)) is None, name
            assert read(record(2, readers.DECODE)) is None, name
    finally:
        trace.reset()
