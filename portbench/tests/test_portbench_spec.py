"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TEXT = re.compile(r"[^\t\n\r]{1,200}")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in BENCH[group]:
            yield group, item


@pytest.mark.parametrize("group,item", list(names()),
                         ids=lambda v: v if isinstance(v, str)
                         else v["name"])
def test_names_units_and_texts(group, item):
    assert NAME.fullmatch(item["name"])
    for key in ("config", "traffic"):
        if key in item:
            assert NAME.fullmatch(item[key])
    for key in ("why", "layer", "source"):
        if key in item:
            assert TEXT.fullmatch(item[key])
    if "unit" in item:
        assert UNIT.fullmatch(item["unit"])
        assert item["better"] in ("lower", "higher")
    if group == "configs":
        assert set(item) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.fullmatch(k) for k in item["reduced"])
    if group == "workloads":
        assert set(item) == {"name", "config", "traffic", "chips", "why"}
        assert item["chips"] == 1
    if group == "end_to_end":
        assert set(item) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert item["source"] in ("host_clock", "device_trace")
        assert 0.01 <= item["bound"] <= 0.25
    if group == "per_layer":
        assert set(item) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert item["source"] in ("device_trace", "program_span",
                                  "program_counter", "host_clock")


def test_names_unique_and_every_cell_reports_enough():
    for group in ("configs", "workloads"):
        got = [i["name"] for i in BENCH[group]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert "setup_s" in metrics
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        own = [m for m in BENCH["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in [m["name"] for m in own] and len(own) >= 2
        layer = [m for m in BENCH["per_layer"]
                 if w["name"] in m.get("workloads", [])]
        assert layer
        for m in layer:
            moved = e2e[m["moves"]]
            assert w["name"] in moved.get("workloads", [w["name"]])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_every_named_file_loads_by_name():
    from portbench import harness

    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/configs/")
        cfg = harness.config_file(BENCH, c["name"], ROOT)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        harness.reference_module(cfg).Format.from_config(cfg)
    for w in BENCH["workloads"]:
        traffic = harness.traffic_file(w["traffic"])
        assert callable(harness.entry_class(traffic["entry"]))
        cfg = harness.config_file(BENCH, w["config"], ROOT)
        assert traffic["entry"] in cfg["limits"]
        assert traffic["entry"] in cfg["control"]
    for m in BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_every_reader_finds_nothing_in_an_empty_record():
    """Every metric file, those of the decode cells kept for later too."""
    from portbench import harness

    record = {"entry": "none", "window": {"unit_s": [], "units": 0},
              "spans": {}, "trace": {"window_s": 0, "busy_s": 0,
                                     "launches": 0, "kernel_s": {},
                                     "units": 0, "batches": 0,
                                     "bounds": {}}}
    files = sorted((ROOT / "portbench" / "metrics").glob("*.py"))
    assert {m["name"] for m in BENCH["per_layer"]} <= {f.stem for f in files}
    for f in files:
        assert harness.reader(f.stem)(record) is None
