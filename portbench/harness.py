"""Everything ``run.py`` finds by name: the cell in ``BENCHMARK.json``,
its configuration file, the plain reference that judges it
(``portbench/references/<name>.py``, or ``portbench/reference.py``), its
traffic file, the entry that drives the traffic
(``portbench/entries/<entry>.py``) and each per-layer metric's reader
(``portbench/metrics/<name>.py``)."""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import SimpleNamespace

from portbench import reference

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_file(bench: dict, name: str, root: Path) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def reference_module(cfg: dict):
    """The plain reference that judges configuration ``cfg``: the module
    ``portbench.references.<name>`` that its ``reference`` key names,
    else ``portbench.reference`` (interface: ``portbench.references``)."""
    name = cfg.get("reference")
    if name is None:
        return reference
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"bad reference name {name!r}")
    return importlib.import_module(f"portbench.references.{name}")


def traffic_file(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def entry_class(name: str):
    if not NAME.fullmatch(name):
        raise ValueError(f"bad entry name {name!r}")
    return importlib.import_module(f"portbench.entries.{name}").Entry


def reader(name: str):
    """The ``read(record)`` function of per-layer metric ``name``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def context(root: Path, workload: str, seed: int, device,
            spec: dict | None = None) -> SimpleNamespace:
    """The run's context; ``spec`` stands for a workload entry that
    ``BENCHMARK.json`` does not hold (a cell kept for a later PR)."""
    bench = load_benchmark(root)
    w = spec or cell(bench, workload)
    cfg = config_file(bench, w["config"], root)
    traffic = traffic_file(w["traffic"])
    ref = reference_module(cfg)
    return SimpleNamespace(bench=bench, cell=w, config=cfg, traffic=traffic,
                           ref=ref, fmt=ref.Format.from_config(cfg),
                           seed=seed, device=device)


def limits(ctx) -> dict:
    return ctx.config["limits"][ctx.traffic["entry"]]
