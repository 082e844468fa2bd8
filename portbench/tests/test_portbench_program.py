"""The per-layer metrics that read the program's own spans and counters
(``portbench/program.py``): a traced dry run of each encode cell reports
every one of them, on the CPU's eager path and on the card's graphed
path, a registry of the graphed path's spans reads numbers, and a
registry that does not match the profiled window reads as nothing."""

import json
import math
from pathlib import Path

import pytest

from portbench import harness, readers
from portbench.tests.conftest import listed_on

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
#: the per-layer metrics whose readers read the program's registry
PROGRAM = [m["name"] for m in BENCH["per_layer"]
           if "from portbench import program" in (
               ROOT / "portbench" / "metrics" / f"{m['name']}.py").read_text()]
#: the four of them that read the encode pipeline's spans and copies
FOUR = ["encode_upload_ms", "encode_fetch_ms", "encode_cut_ms",
        "encode_copy_mb_per_batch"]
ENCODE = listed_on(readers.ENCODE)


def reported(cell):
    """The program metrics that ``cell`` reports."""
    return [m["name"] for m in BENCH["per_layer"]
            if m["name"] in PROGRAM and harness.reports(m, cell)]


def test_the_four_program_metrics_are_listed():
    """The four are among the metrics that read the program, each with
    its source and for every encode cell; a metric added beside them
    changes nothing here."""
    got = {m["name"]: m for m in BENCH["per_layer"] if m["name"] in PROGRAM}
    assert set(FOUR) <= set(got)
    assert [got[n]["source"] for n in FOUR] == ["program_span"] * 3 + [
        "program_counter"]
    for cell in ENCODE:
        assert set(FOUR) <= set(reported(cell)), cell


@pytest.mark.parametrize("cell", ENCODE)
def test_traced_dry_run_reports_every_program_metric(tiny, cell):
    from flacx_torch import trace

    trace.reset()
    res = tiny(cell, trace=True)
    assert res["correct"]
    for name in reported(cell):
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, name
    assert res["metrics"]["encode_copy_mb_per_batch"]["value"] > 0
    assert res["metrics"]["encode_cut_ms"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ENCODE)
def test_card_traced_dry_run_reports_every_program_metric(tiny, cell):
    """On the card every batch of the profiled window replays the graph,
    which enters no stage span of the pipeline."""
    import torch

    from flacx_torch import trace

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode")
    trace.reset()
    try:
        res = tiny(cell, trace=True, device="cuda")
        assert "encode.emit" not in trace.snapshot()["spans"]
    finally:
        trace.reset()
    assert res["correct"], res["checks"]
    assert res["metrics"]["encode_graph_replay_share"]["value"] == 1.0
    for name in reported(cell):
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, name
    for name in FOUR:
        assert res["metrics"][name]["value"] > 0, name


def test_a_registry_of_the_graphed_path_reads_numbers(monkeypatch):
    """The spans a replayed batch enters, and no ``encode.emit``: times in
    ms a batch, the copies in MB a batch."""
    from flacx_torch import trace

    trace.reset()
    clock = iter(range(0, 10 ** 9, 1_000_000))
    monkeypatch.setattr(trace.time, "time_ns", lambda: next(clock))
    with trace.recording():
        for _ in range(2):
            for name in ("encode.upload", "encode.replay", "encode.fetch",
                         "encode.fetch", "encode.cut"):
                with trace.span(name):
                    pass
            trace.count("copy.h2d_bytes", 3_000_000)
            trace.count("copy.d2h_bytes", 1_000_000)
    record = {"entry": readers.ENCODE, "trace": {"batches": 2}}
    try:
        assert "encode.emit" not in trace.snapshot()["spans"]
        got = {name: harness.reader(name)(record) for name in FOUR}
    finally:
        trace.reset()
    assert got == {"encode_upload_ms": pytest.approx(1.0),
                   "encode_fetch_ms": pytest.approx(2.0),
                   "encode_cut_ms": pytest.approx(1.0),
                   "encode_copy_mb_per_batch": pytest.approx(4.0)}


def test_a_registry_that_does_not_match_the_window_reads_nothing():
    """The window's batches are counted by ``encode.cut`` spans, one a
    batch's ``_drain``."""
    import numpy as np

    from flacx_torch import trace
    from flacx_torch.encoder import BatchEncoder, EncoderConfig

    trace.reset()
    enc = BatchEncoder(EncoderConfig(block_size=1152, max_lpc_order=8),
                       batch_frames=2, device="cpu")
    pcm = np.zeros((2, 2, 1152), np.int16)
    with trace.recording():
        list(enc.encode_frame_stream([pcm, pcm], 0))
    assert len(trace.snapshot()["spans"]["encode.cut"]) == 2

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
