"""Fixtures of the benchmark's tests: tiny cells on the CPU's plain path."""

import importlib
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

#: each entry's traffic cut to a size a CPU test run holds; an entry not
#: named here carries its own as the module attribute ``TINY``
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
#: list (their runs spread past any bound the contract allows)
LATER = {
    "cd16_default.encode": {"name": "cd16_default.encode",
                            "config": "cd16_default",
                            "traffic": "encode.b1024", "chips": 1},
    "cd16_default.decode": {"name": "cd16_default.decode",
                            "config": "cd16_default",
                            "traffic": "decode.s2048", "chips": 1},
    "hires24_96.decode": {"name": "hires24_96.decode",
                          "config": "hires24_96",
                          "traffic": "decode.s512", "chips": 1},
}


def listed() -> list:
    """The cells of ``BENCHMARK.json``."""
    return [w["name"] for w in harness.load_benchmark(ROOT)["workloads"]]


def traffic_of(cell: str) -> dict:
    """The cell's traffic file, the cell found in ``BENCHMARK.json`` or in
    :data:`LATER`."""
    w = LATER.get(cell) or harness.cell(harness.load_benchmark(ROOT), cell)
    return harness.traffic_file(w["traffic"])


def entry_of(cell: str) -> str:
    """The entry that drives the cell's traffic: what a test classifies a
    cell by, whatever the cell's name."""
    return traffic_of(cell)["entry"]


def listed_on(entry: str) -> list:
    """The cells of ``BENCHMARK.json`` whose traffic ``entry`` drives."""
    return [c for c in listed() if entry_of(c) == entry]


def tiny_sizes(entry: str) -> dict:
    """The traffic keys that cut a cell of ``entry`` to a CPU test run."""
    if entry in TINY:
        return TINY[entry]
    module = importlib.import_module(f"portbench.entries.{entry}")
    sizes = getattr(module, "TINY", None)
    if sizes is None:
        pytest.fail(f"portbench/entries/{entry}.py defines no TINY: the "
                    "traffic keys that cut its cells to a CPU test run",
                    pytrace=False)
    return sizes


@pytest.fixture
def tiny():
    """``tiny(workload, **kwargs)``: one CPU run of the cell at
    :func:`tiny_sizes` (``portbench.run.run``'s result)."""
    from portbench import run

    def go(workload, seconds=1.0, trace=False, control=False,
           device="cpu", **over):
        return run.run(workload, 20260001, seconds, trace, device, control,
                       {**tiny_sizes(entry_of(workload)), **over},
                       log=lambda *a, **k: None, spec=LATER.get(workload))
    return go
