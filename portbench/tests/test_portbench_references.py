"""A configuration that names its own plain reference
(``"reference": "<name>"``, the module ``portbench.references.<name>``):
it reaches the run's context and judges the encode entry's frames and
control; without the key the judge is ``portbench.reference``, as
before; a bad or unknown name fails at set-up."""

import copy
import dataclasses
import json
import re
import sys
import types
from pathlib import Path

import pytest

from portbench import harness, reference, references

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
STUB = "stub_exact"
#: what the reference needs beside ``Format`` and ``choose``, taken from
#: ``portbench.reference`` as ``portbench.references`` allows
SHARED = ("check_frame", "channel_signals", "residual", "zigzag",
          "rice_optimum", "write_frame", "decode_frame", "stream_bytes")


def exact_config(**encoder) -> dict:
    """``cd16_default`` under ``encode --best``'s search: exact order
    search, f64 analysis, three windows."""
    cfg = json.loads((ROOT / "portbench/configs/cd16_default.json")
                     .read_text())
    cfg["name"] = STUB
    cfg["encoder"].update(order_search="exact", analysis_dtype="f64",
                          windows=["tukey(0.5)", "hann", "flattop"],
                          **encoder)
    return cfg


def stub_module(calls: list) -> types.ModuleType:
    """A reference module that accepts the exact search and records each
    ``choose``; it works the choices out by the estimate algorithm under
    the first window in f32, which is enough to see who is called."""
    mod = types.ModuleType(f"portbench.references.{STUB}")

    @dataclasses.dataclass(frozen=True)
    class Format(reference.Format):
        windows: tuple = ("tukey(0.5)",)

        @classmethod
        def from_config(cls, cfg):
            enc = cfg["encoder"]
            base = reference.Format.from_config({"encoder": {
                **enc, "order_search": "estimate",
                "windows": enc["windows"][:1]}})
            return cls(**{**dataclasses.asdict(base),
                          "order_search": enc["order_search"],
                          "windows": tuple(enc["windows"])})

    def choose(pcm, fmt, precision=None):
        calls.append((type(fmt), precision))
        return reference.choose(pcm, fmt, precision or "f32")

    mod.Format, mod.choose = Format, choose
    for name in SHARED:
        setattr(mod, name, getattr(reference, name))
    return mod


@pytest.fixture
def named(monkeypatch, tmp_path):
    """The stub's ``choose`` calls: the stub placed under
    ``portbench.references`` and a ``BENCHMARK.json`` whose extra
    configuration names it, its file ``cfg.json`` in ``tmp_path``."""
    calls = []
    monkeypatch.setitem(sys.modules, f"portbench.references.{STUB}",
                        stub_module(calls))
    bench = copy.deepcopy(BENCH)
    bench["configs"].append({"name": STUB, "source": "test",
                             "file": str(tmp_path / "cfg.json"),
                             "reduced": [], "why": "test"})
    monkeypatch.setattr(harness, "load_benchmark", lambda root: bench)
    write_config(tmp_path, {**exact_config(), "reference": STUB})
    return calls


def write_config(tmp_path, cfg: dict) -> None:
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))


SPEC = {"name": f"{STUB}.encode", "config": STUB, "traffic": "encode.b1024",
        "chips": 1}


def test_a_named_reference_reaches_the_context(named):
    ctx = harness.context(ROOT, SPEC["name"], 1, "cpu", SPEC)
    assert ctx.ref is sys.modules[f"portbench.references.{STUB}"]
    assert isinstance(ctx.fmt, ctx.ref.Format)
    assert ctx.fmt.order_search == "exact"
    assert ctx.fmt.windows == ("tukey(0.5)", "hann", "flattop")
    assert ctx.fmt.analysis == "f64"


def test_the_encode_entry_checks_and_control_call_the_named_choose(named):
    """A whole tiny control run (``portbench.run.run``): the control's
    frames and then the checks are the stub's; the program runs the exact
    search on the CPU."""
    from portbench import run
    from portbench.tests.conftest import TINY

    calls = named
    res = run.run(SPEC["name"], 20260001, 1.0, False, "cpu", True,
                  dict(TINY["encode_frame_stream"]),
                  log=lambda *a, **k: None, spec=SPEC)
    fmt_type = sys.modules[f"portbench.references.{STUB}"].Format
    assert calls and all(t is fmt_type for t, _ in calls)
    control = [c for c in calls if c[1] == "bf16"]
    checks = [c for c in calls if c[1] is None]
    assert control and len(checks) == len(control)
    assert len(calls) == len(control) + len(checks)
    assert res["checks"]["frames_bad"]["value"] == 0


#: the format each benchmark configuration gave before it could name a
#: reference
FORMATS = {
    "cd16_default": reference.Format(
        sample_rate=44100, bps=16, channels=2, block_size=4608,
        max_lpc_order=12, qlp_precision=5, partition_orders=tuple(range(6)),
        stereo="auto", order_search="estimate", analysis="f32",
        escapes=True, window="tukey(0.5)"),
    "hires24_96": reference.Format(
        sample_rate=96000, bps=24, channels=2, block_size=16384,
        max_lpc_order=32, qlp_precision=5,
        partition_orders=tuple(range(16)), stereo="auto",
        order_search="estimate", analysis="f32", escapes=True,
        window="tukey(0.5)"),
}


@pytest.mark.parametrize("name", FORMATS)
def test_without_the_key_the_judge_is_the_default_reference(name):
    assert name in [c["name"] for c in BENCH["configs"]]
    cfg = harness.config_file(BENCH, name, ROOT)
    assert "reference" not in cfg
    assert harness.reference_module(cfg) is reference
    ctx = harness.context(ROOT, None, 1, "cpu", {
        "name": name, "config": name, "traffic": "encode.b128",
        "chips": 1})
    assert ctx.ref is reference
    assert ctx.fmt == FORMATS[name]


#: what a reference module defines beside ``Format``, as the bullets of
#: ``portbench.references``' docstring list it
INTERFACE = re.findall(r"^- ``(\w+)\(", references.__doc__, re.M)


def test_the_interface_lists_choose_and_the_shared_functions():
    assert INTERFACE[0] == "choose" and set(SHARED) <= set(INTERFACE)


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_every_configuration_is_judged_by_its_reference(name):
    """Without the key the judge is ``portbench.reference`` and the format
    its own; with it, a module under ``portbench.references`` whose
    ``Format`` extends the default one, accepts the configuration and
    whose module holds the whole interface."""
    cfg = harness.config_file(BENCH, name, ROOT)
    traffic = next(w["traffic"] for w in BENCH["workloads"]
                   if w["config"] == name)
    ctx = harness.context(ROOT, None, 1, "cpu", {
        "name": name, "config": name, "traffic": traffic, "chips": 1})
    if "reference" not in cfg:
        assert ctx.ref is reference
        assert ctx.fmt == reference.Format.from_config(cfg)
        return
    assert ctx.ref.__name__ == f"portbench.references.{cfg['reference']}"
    assert issubclass(ctx.ref.Format, reference.Format)
    assert isinstance(ctx.fmt, ctx.ref.Format)
    for fn in INTERFACE:
        assert callable(getattr(ctx.ref, fn, None)), fn


@pytest.mark.parametrize("name,error", [
    ("no_such_reference", ModuleNotFoundError),
    ("../reference", ValueError),
    ("a b", ValueError),
    ("", ValueError),
    (7, ValueError),
])
def test_a_bad_or_unknown_name_raises_at_context(named, tmp_path, name,
                                                 error):
    write_config(tmp_path, {**exact_config(), "reference": name})
    with pytest.raises(error):
        harness.context(ROOT, SPEC["name"], 1, "cpu", SPEC)


def test_a_configuration_that_forgets_its_reference_fails_at_context(
        named, tmp_path):
    write_config(tmp_path, exact_config())
    with pytest.raises(ValueError, match="portbench.references"):
        harness.context(ROOT, SPEC["name"], 1, "cpu", SPEC)


@pytest.mark.parametrize("encoder", [
    {"order_search": "exact"},
    {"windows": ["tukey(0.5)", "hann", "flattop"]},
    {"wasted_bits": True},
    {"conformance": True},
], ids=["exact", "three_windows", "wasted_bits", "conformance"])
def test_the_default_reference_refuses_what_it_cannot_judge(encoder):
    cfg = json.loads((ROOT / "portbench/configs/cd16_default.json")
                     .read_text())
    cfg["encoder"].update(encoder)
    with pytest.raises(ValueError):
        reference.Format.from_config(cfg)
