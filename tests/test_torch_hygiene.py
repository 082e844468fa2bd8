"""flacx_torch stands alone: no jax, no flacx, no hidden CPU fallback, and
its own copies of the host helpers agree with flacx's."""

import dataclasses
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import flacx.coded_number as fx_coded_number
import flacx.format as fx_format
from flacx.encoder import EncoderConfig as FxConfig
from flacx.oracle.decoder import decode_stream as fx_decode_stream
from flacx.oracle.encoder import EncoderParameters
from flacx.oracle.encoder import encode_stream as fx_encode_stream

from flacx_torch import coded_number, format as fmt
from flacx_torch.bitio import BitReader
from flacx_torch.device import resolve_device
from flacx_torch.encoder import EncoderConfig, config_from_flacx
from flacx_torch.oracle.decoder import decode_stream

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "flacx_torch").rglob("*.py")) + sorted(
    (ROOT / "flacx_torch").rglob("*.cu*")) + sorted(
    (ROOT / "flacx_torch").rglob("*.cc")) + [ROOT / "chip_smoke.py",
                                            ROOT / "tools/profile_torch.py"]


def test_port_imports_with_jax_and_flacx_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['flacx'] = None\n"
            "import pkgutil, importlib, flacx_torch\n"
            "for m in pkgutil.walk_packages(flacx_torch.__path__, "
            "'flacx_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import flacx_torch.encoder, flacx_torch.cli, "
            "flacx_torch.pipeline, flacx_torch.stream, chip_smoke\n"
            "import flacx_torch.parallel.corpus, flacx_torch.parallel.mesh\n"
            "import flacx_torch.parallel.distributed\n"
            "import flacx_torch.parallel.seqshard\n"
            "import flacx_torch.parallel.dryrun\n"
            "import flacx_torch.kernels.seqshard\n"
            "assert 'flacx_torch.parallel.corpus' in sys.modules\n"
            "assert 'jax' not in {k.split('.')[0] for k, v in "
            "sys.modules.items() if v is not None}\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=env, timeout=120)


def test_source_scan_covers_the_parallel_package():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"flacx_torch/parallel/__init__.py",
            "flacx_torch/parallel/mesh.py",
            "flacx_torch/parallel/corpus.py",
            "flacx_torch/parallel/distributed.py",
            "flacx_torch/parallel/seqshard.py",
            "flacx_torch/parallel/dryrun.py",
            "flacx_torch/kernels/seqshard.py",
            "flacx_torch/kernels/csrc/seqshard.cu"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_names_no_flacx_module(path):
    text = path.read_text()
    assert not re.search(r"\bflacx\.|\bimport flacx\b|\bfrom flacx\b",
                         text), path


CSRC = ROOT / "flacx_torch/kernels/csrc"


@pytest.mark.parametrize("path", sorted(CSRC.glob("*.cu*")),
                         ids=lambda p: p.name)
def test_shared_memory_opt_in_is_per_device_and_checked(path):
    """Past 48 KB, dynamic shared memory is opt-in and the opt-in holds for
    the current device only: no launcher keeps a process-wide ``static``
    flag or size (a ``static`` is an array over ``MAX_DEVICES``, indexed
    by ``cudaGetDevice``), and every ``cudaFuncSetAttribute`` call's
    result is assigned and checked at once, so a refused opt-in reaches
    the wrapper, which raises."""
    text = re.sub(r"//[^\n]*|/\*.*?\*/", "", path.read_text(), flags=re.S)
    for m in re.finditer(r"\bstatic\s+(?!assert|constexpr|_)([^;(]*);",
                         text):
        assert "MAX_DEVICES]" in m.group(1), (path.name, m.group(0))
    calls = list(re.finditer(r"cudaFuncSetAttribute\s*\(", text))
    checked = list(re.finditer(
        r"\b(\w+)\s*=\s*cudaFuncSetAttribute\s*\([^;]*\);\s*"
        r"if\s*\(\s*(\w+)\s*!=\s*cudaSuccess\s*\)\s*return\b", text))
    assert len(checked) == len(calls), path.name
    assert all(c.group(1) == c.group(2) for c in checked), path.name
    if calls:
        assert "cudaGetDevice(" in text, path.name


def test_opt_in_scan_covers_every_launcher_that_opts_in():
    """The launchers past 48 KB (``analysis``, ``reconstruct``,
    ``reference_lpc``) opt in through ``flacx::allow_smem``, one array of
    sizes a kernel."""
    for name in ("analysis", "reconstruct", "reference_analysis"):
        text = (CSRC / f"{name}.cu").read_text()
        assert "flacx::allow_smem(" in text, name
        assert re.search(r"static int \w+\[(?:\d\]\[)?flacx::MAX_DEVICES\]",
                         text), name
    assert "cudaFuncSetAttribute" in (CSRC / "common.cuh").read_text()


def test_device_is_explicit():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()


def test_config_from_flacx_covers_every_field():
    fx_fields = {f.name for f in dataclasses.fields(FxConfig)}
    assert fx_fields == {f.name for f in dataclasses.fields(EncoderConfig)}
    for fx_cfg in (FxConfig(), FxConfig(block_size=1152, max_lpc_order=8,
                                        stereo="independent",
                                        partition_orders=(2, 3),
                                        windows=("hann", "welch")),
                   FxConfig(channels=1, bps=24), FxConfig(conformance=True)):
        cfg = config_from_flacx(dataclasses.asdict(fx_cfg))
        for name in fx_fields:
            assert getattr(cfg, name) == getattr(fx_cfg, name), name
        for prop in ("use_stereo_modes", "max_taps", "kmax", "porders",
                     "preferred_porders", "eff_bps", "max_frame_bytes"):
            assert getattr(cfg, prop) == getattr(fx_cfg, prop), prop
    with pytest.raises(ValueError, match="unknown"):
        config_from_flacx({**dataclasses.asdict(FxConfig()), "extra": 1})


@pytest.mark.parametrize("bad", [
    {"order_search": "best"}, {"analysis_dtype": "f16"}, {"channels": 9},
    {"max_lpc_order": 33}, {"qlp_precision": 4}, {"block_size": 16},
    {"windows": ()}, {"windows": ("hann(3)",)}])
def test_config_validation_matches_flacx(bad):
    with pytest.raises(ValueError):
        FxConfig(**bad)
    with pytest.raises(ValueError):
        EncoderConfig(**bad)


def test_format_tables_match_flacx():
    np.testing.assert_array_equal(fmt.FIXED_PREDICTOR_TAPS,
                                  fx_format.FIXED_PREDICTOR_TAPS)
    assert fmt.MAGIC == fx_format.MAGIC
    assert fmt.CRC8_POLYNOMIAL == fx_format.CRC8_POLYNOMIAL
    assert fmt.CRC16_POLYNOMIAL == fx_format.CRC16_POLYNOMIAL
    assert {c.name: int(c) for c in fmt.Channels} == \
        {c.name: int(c) for c in fx_format.Channels}
    for c in fmt.Channels:
        assert c.count == fx_format.Channels[c.name].count
        assert c.decorrelation_bit == \
            fx_format.Channels[c.name].decorrelation_bit
    assert fmt.BLOCK_SIZE_ENCODING == fx_format.BLOCK_SIZE_ENCODING
    assert fmt.SAMPLE_RATE_ENCODING == fx_format.SAMPLE_RATE_ENCODING
    assert fmt.SAMPLE_SIZE_ENCODING == fx_format.SAMPLE_SIZE_ENCODING
    for size in (192, 4096, 4608, 100, 256, 257, 65536):
        assert fmt.encode_block_size_bits(size) == \
            fx_format.encode_block_size_bits(size)


def test_coded_numbers_and_bit_reader():
    for x in (0, 1, 127, 128, 2047, 2048, 70000, (1 << 36) - 1):
        enc = coded_number.encode(x)
        assert enc == fx_coded_number.encode(x)
        assert coded_number.decode(enc) == x
    r = BitReader(bytes([0b10110000, 0xFF, 0x01]))
    assert (r.read_uint(3), r.read_sint(2), r.read_unary()) == (0b101, -2, 3)


def test_oracle_decoder_reads_flacx_streams():
    rng = np.random.default_rng(8)
    pcm = (rng.standard_normal((3000, 2)) * 3000).astype(np.int64)
    stream = b"".join(fx_encode_stream(
        44100, 16, 2, len(pcm), pcm.tolist(),
        EncoderParameters(block_size=1024, lpc_order=range(0, 9),
                          use_escapes=True)))
    got = decode_stream(io.BytesIO(stream))
    ref = fx_decode_stream(io.BytesIO(stream))
    assert got[:4] == ref[:4]
    assert list(got[4]) == list(ref[4]) == pcm.tolist()
