"""Dry runs of every cell on the CPU's plain path, the control that has to
come out not correct, the faults a run has to catch, and the import
check."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import readers
from portbench.tests.conftest import LATER, entry_of, listed, traffic_of

ROOT = Path(__file__).resolve().parents[2]
CELLS = listed() + list(LATER)
ENCODE = [c for c in CELLS if entry_of(c) == readers.ENCODE]
DECODE = [c for c in CELLS if entry_of(c) == readers.DECODE]


@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_is_correct(tiny, cell):
    res = tiny(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert "setup_s" in res["metrics"]
    assert len(res["metrics"]) >= 2 or cell in LATER


@pytest.mark.parametrize("cell", [ENCODE[0], DECODE[0]])
def test_traced_dry_run(tiny, cell):
    """A traced run reads the trace and the host spans (a decode cell's
    per-layer metrics are not listed yet, so it reports none)."""
    res = tiny(cell, trace=True)
    assert res["correct"]
    assert res["device"]["window_s"] > 0
    assert "breakdown" in res and list(res)[-1] == "checks"
    assert cell in DECODE or any(k.endswith("_ms") or k.endswith("_p95")
                                 for k in res["metrics"])


def loud_only(cell):
    """The cell's signal cut to its loud passages: a tiny decode run
    samples a frame or two, which quiet passages would leave exact in the
    control's narrower arithmetic."""
    signal = traffic_of(cell)["signal"]
    return {**signal, "passages": [p for p in signal["passages"]
                                   if p["kind"] == "loud"]}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    """The encode and decode entries' controls fail the one number that
    can catch them; another entry's has to fail at least one, at the
    sizes its ``TINY`` gives."""
    if cell in ENCODE:
        extra, want = ({"check": {"frames": 16, "decode_frames": 1}},
                       ["analysis_mismatch_pct"])
    elif cell in DECODE:
        extra, want = {"signal": loud_only(cell)}, ["pcm_mismatch"]
    else:
        extra, want = {}, None
    res = tiny(cell, control=True, **extra)
    assert not res["correct"]
    failed = [k for k, v in res["checks"].items()
              if v["value"] > v["limit"]]
    assert failed == want if want else failed, res["checks"]


@pytest.fixture
def broken(monkeypatch):
    """Faults planted where the timed path produces its answers."""
    import flacx_torch.decoder as decoder
    import flacx_torch.encoder as encoder

    def plant(fault, cell):
        drain = encoder.BatchEncoder._drain
        decode = decoder.decode_array

        def drain_half(self, result, valid, *a, **k):
            return drain(self, result, valid, *a, **k)[:valid // 2]

        def drain_altered(self, result, valid, *a, **k):
            out = drain(self, result, valid, *a, **k)
            return [f[:-3] + bytes([f[-3] ^ 1]) + f[-2:] for f in out]

        def decode_half(data, *a, **k):
            info, pcm = decode(data, *a, **k)
            return info, pcm[:len(pcm) // 2]

        def decode_altered(data, *a, **k):
            info, pcm = decode(data, *a, **k)
            pcm = pcm.copy()
            pcm[len(pcm) // 3, 0] ^= 1
            return info, pcm
        if cell in ENCODE:
            monkeypatch.setattr(encoder.BatchEncoder, "_drain",
                                drain_half if fault == "half"
                                else drain_altered)
        else:
            monkeypatch.setattr(decoder, "decode_array",
                                decode_half if fault == "half"
                                else decode_altered)
    return plant


@pytest.mark.parametrize("fault", ["half", "altered"])
@pytest.mark.parametrize("cell", [ENCODE[0], DECODE[0]])
def test_faults_are_not_correct(tiny, broken, cell, fault):
    """Half of each batch left out, or an answer altered where it is
    produced (one bit of each frame's residual, one decoded sample): the
    run sees it.  (No training state and no exchange between cards in
    these cells: those faults do not apply.)"""
    broken(fault, cell)
    res = tiny(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_card_run_is_correct(tiny, cell):
    """The same tiny run on the card, its kernels, trace and all."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode")
    res = tiny(cell, trace=True, device="cuda")
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0


def test_reference_control_differs_from_configured_precision():
    from portbench import reference

    x = np.arange(1, 4097, dtype=np.float32) * 7.3
    assert not np.array_equal(reference.bf16(x), x)
    assert np.array_equal(reference.bf16(reference.bf16(x)),
                          reference.bf16(x))


def test_no_jax_or_flacx_after_a_dry_run():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import run\n"
        "from portbench.tests.conftest import TINY\n"
        "r = run.run(%r, 5, 0.5, False, 'cpu', False,"
        " TINY['encode_frame_stream'], log=lambda *a, **k: None)\n"
        "print(r['correct'], run.loaded_forbidden())\n"
        % (str(ROOT), ENCODE[0]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "[]", out.stdout
