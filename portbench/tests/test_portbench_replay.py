"""The two per-layer metrics of the graphed encode, ``encode_replay_ms``
and ``encode_graph_replay_share``: read from a registry filled by hand,
nothing where the program records no replay (the CPU's eager path,
another entry, a window of no batches), and on the card a positive time
and a share of 1.0 in a traced run of each encode cell."""

import json
import math
from pathlib import Path

import pytest

from portbench import harness, readers
from portbench.tests.conftest import listed_on

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
ENCODE = listed_on(readers.ENCODE)
NAMES = ("encode_replay_ms", "encode_graph_replay_share")


@pytest.fixture
def registry():
    from flacx_torch import trace

    trace.reset()
    yield trace
    trace.reset()


def record(batches, entry=readers.ENCODE):
    return {"entry": entry, "trace": {"batches": batches}}


def test_both_are_listed_for_every_encode_cell():
    got = {m["name"]: m for m in BENCH["per_layer"] if m["name"] in NAMES}
    assert set(got) == set(NAMES)
    for m in got.values():
        assert m["layer"] == "encode pipeline"
        assert m["moves"] == "encode_msamples_per_s"
        assert m["workloads"] == ENCODE
    assert got["encode_replay_ms"]["source"] == "program_span"
    assert got["encode_graph_replay_share"]["source"] == "program_counter"


def test_read_from_a_registry_filled_by_hand(registry, monkeypatch):
    clock = iter([0, 2_000_000, 5_000_000, 6_000_000])
    monkeypatch.setattr(registry.time, "time_ns", lambda: next(clock))
    with registry.recording():
        for _ in range(2):
            with registry.span("encode.replay"):
                pass
        registry.count("encode.graph_replays", 3)
    replay_ms = harness.reader("encode_replay_ms")
    share = harness.reader("encode_graph_replay_share")
    assert replay_ms(record(3)) == pytest.approx(1.0)
    assert share(record(3)) == 1.0
    assert share(record(4)) == 0.75
    for name in NAMES:
        read = harness.reader(name)
        assert read(record(0)) is None, name
        assert read(record(3, readers.DECODE)) is None, name


def test_an_empty_registry_reads_nothing(registry):
    for name in NAMES:
        assert harness.reader(name)(record(3)) is None, name


@pytest.mark.parametrize("cell", ENCODE)
def test_the_cpus_eager_encode_reports_neither(tiny, registry, cell):
    res = tiny(cell, trace=True)
    assert res["correct"]
    assert "encode_cut_ms" in res["metrics"]
    for name in NAMES:
        assert name not in res["metrics"], name


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ENCODE)
def test_card_run_replays_every_batch(tiny, registry, cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode")
    res = tiny(cell, trace=True, device="cuda")
    assert res["correct"], res["checks"]
    assert res["metrics"]["encode_graph_replay_share"]["value"] == 1.0
    ms = res["metrics"]["encode_replay_ms"]["value"]
    assert math.isfinite(ms) and ms > 0
