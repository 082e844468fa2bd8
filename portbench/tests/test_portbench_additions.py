"""What ``portbench/README.md`` promises to take as new files and new
entries in ``BENCHMARK.json`` only: a configuration that names its own
reference, a cell of any name, a per-layer metric that reads the program,
and an entry.  A copy of the benchmark gets one of each, and the
benchmark's own tests, run in that copy, take them without an edit."""

import copy
import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests.conftest import TINY

ROOT = Path(__file__).resolve().parents[2]
CONFIG = "cd16_judged"
REFERENCE = "stand_in"
ENTRY = "encode_stand_in"
TRAFFIC = "encode.stand_in"
METRIC = "h2d_mb_per_batch"
#: the added cells: names that end in neither ``.encode`` nor ``.decode``,
#: one on the encode entry and one on the added entry
ON_ENCODE, ON_ENTRY = f"{CONFIG}.frames", f"{CONFIG}.other_entry"
#: the added entry's CPU sizes: the encode entry's, with the sample that
#: the encode control test takes, since no test gives this entry another
ENTRY_TINY = {**TINY["encode_frame_stream"],
              "check": {"frames": 16, "decode_frames": 1}}

FILES = {
    f"references/{REFERENCE}.py": '''\
"""A reference of its own that judges as ``portbench.reference`` does."""

from portbench import reference
from portbench.reference import (  # noqa: F401
    channel_signals, check_frame, choose, decode_frame, residual,
    rice_optimum, stream_bytes, write_frame, zigzag)


class Format(reference.Format):
    pass
''',
    f"entries/{ENTRY}.py": f'''\
"""The encode entry under another name, with its own CPU test sizes."""

from portbench.entries.encode_frame_stream import Entry  # noqa: F401

TINY = {ENTRY_TINY!r}
''',
    f"metrics/{METRIC}.py": f'''\
"""MB a batch copied from host to device, the program's counter
copy.h2d_bytes, in the encode entry's cells and the added entry's."""

from portbench import program, readers


def read(record):
    if record.get("entry") == {ENTRY!r}:
        record = {{**record, "entry": readers.ENCODE}}
    v = program.encode_counter_per_batch(record, ("copy.h2d_bytes",))
    return None if v is None else v / 1e6
''',
}


def add_files(root: Path) -> None:
    """The additions, as new files under ``root / "portbench"``."""
    bench_dir = root / "portbench"
    for name, text in FILES.items():
        path = bench_dir / name
        assert not path.exists(), name
        path.write_text(text)
    traffic = json.loads((bench_dir / "traffic/encode.b1024.json")
                         .read_text())
    (bench_dir / f"traffic/{TRAFFIC}.json").write_text(
        json.dumps({**traffic, "entry": ENTRY}))
    cfg = json.loads((bench_dir / "configs/cd16_default.json").read_text())
    cfg.update(name=CONFIG, reference=REFERENCE)
    cfg["limits"][ENTRY] = cfg["limits"]["encode_frame_stream"]
    cfg["control"][ENTRY] = cfg["control"]["encode_frame_stream"]
    (bench_dir / f"configs/{CONFIG}.json").write_text(json.dumps(cfg))


def add_entries(bench: dict) -> dict:
    """``bench`` with the added configuration, cells and metric, each cell
    in every metric list that it reports."""
    bench = copy.deepcopy(bench)
    cd = next(c for c in bench["configs"] if c["name"] == "cd16_default")
    base = next(w["name"] for w in bench["workloads"]
                if w["config"] == "cd16_default"
                and harness.traffic_file(w["traffic"])["entry"]
                == "encode_frame_stream")
    bench["configs"].append({**cd, "name": CONFIG,
                             "file": f"portbench/configs/{CONFIG}.json"})
    why = "a cell added as new files only"
    bench["workloads"] += [
        {"name": ON_ENCODE, "config": CONFIG, "traffic": "encode.b1024",
         "chips": 1, "why": why},
        {"name": ON_ENTRY, "config": CONFIG, "traffic": TRAFFIC,
         "chips": 1, "why": why}]
    for m in bench["end_to_end"]:
        if base in m.get("workloads", ()):
            m["workloads"] += [ON_ENCODE, ON_ENTRY]
    for m in bench["per_layer"]:
        if base in m.get("workloads", ()):
            m["workloads"].append(ON_ENCODE)
    bench["per_layer"].append({
        "name": METRIC, "unit": "MB", "better": "lower",
        "source": "program_counter", "layer": "encode entry",
        "moves": "encode_msamples_per_s", "workloads": [ON_ENCODE, ON_ENTRY]})
    return bench


#: the benchmark's test files that an addition reaches, and in them the
#: tests that the run selects: two files whole, the two listings of the
#: program's metrics, and every test of the added cells
RUN = ["test_portbench_spec.py", "test_portbench_references.py",
       "test_portbench_replay.py", "test_portbench_program.py",
       "test_portbench_control.py"]
SELECT = " or ".join(["test_portbench_spec", "test_portbench_references",
                      "test_both_are_listed_for_every_encode_cell",
                      "test_the_four_program_metrics_are_listed", CONFIG])
#: what has to pass among them, beside the two files
MUST_PASS = [
    "test_portbench_replay.py::test_both_are_listed_for_every_encode_cell",
    "test_portbench_program.py::test_the_four_program_metrics_are_listed",
    "test_portbench_program.py"
    f"::test_traced_dry_run_reports_every_program_metric[{ON_ENCODE}]",
    f"test_portbench_references.py"
    f"::test_every_configuration_is_judged_by_its_reference[{CONFIG}]",
] + [f"test_portbench_control.py::{test}[{cell}]"
     for test in ("test_dry_run_is_correct", "test_control_is_not_correct")
     for cell in (ON_ENCODE, ON_ENTRY)]


def test_the_tests_take_an_addition_of_each_kind_as_new_files(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "BENCHMARK.json").write_text(
        json.dumps(add_entries(bench), indent=1))
    add_files(tmp_path)
    (tmp_path / "flacx_torch").symlink_to(ROOT / "flacx_torch")
    (tmp_path / "pytest.ini").write_text(
        "[pytest]\nmarkers =\n    cuda: needs an NVIDIA card\n")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p",
         "no:cacheprovider", "-m", "not cuda", "-k", SELECT,
         *(f"portbench/tests/{f}" for f in RUN)],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    summary = out.stdout[max(out.stdout.find("short test summary"), 0):]
    assert out.returncode == 0, summary[-6000:] + out.stderr[-2000:]
    missing = [t for t in MUST_PASS
               if f"PASSED portbench/tests/{t}" not in summary]
    assert not missing, summary[-6000:]


def test_an_entry_brings_its_own_cpu_sizes(monkeypatch):
    from portbench.tests.conftest import tiny_sizes

    mod = types.ModuleType("portbench.entries.sized")
    mod.TINY = {"batch_frames": 2}
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    assert tiny_sizes("sized") == {"batch_frames": 2}
    assert tiny_sizes("encode_frame_stream") is TINY["encode_frame_stream"]


def test_an_entry_without_cpu_sizes_fails_by_name(monkeypatch):
    from portbench.tests.conftest import tiny_sizes

    mod = types.ModuleType("portbench.entries.unsized")
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    with pytest.raises(pytest.fail.Exception,
                       match="entries/unsized.py defines no TINY"):
        tiny_sizes("unsized")
