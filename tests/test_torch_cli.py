"""``python -m flacx_torch encode`` against flacx's encode on the CPU.

The port's ``encode`` parser has every option, default and metavar of
flacx's, and ``--device`` besides.  ``main(["encode", "--device", "cpu",
...])`` writes the bytes ``flacx.pipeline.encode_chunks_to_file`` writes
from the same WAV at the same settings (the pipeline, not ``flacx.cli``,
so no test touches flacx's persistent compile cache); at block 1152 and
with ``--best`` on 24-bit input it writes the bytes of the port's own
pipeline, which ``test_torch_pipeline.py`` holds against flacx's.
"""

import io
import os

import numpy as np
import pytest
import torch

import flacx.pipeline as fx_pipeline
import flacx.wavio as fx_wavio

from flacx_torch import cli, pipeline
from flacx_torch.wavio import read_wav, write_wav

from conftest import make_pcm

torch.set_num_threads(1)

SETTINGS = dict(max_lpc_order=12, qlp_precision=5,
                partition_orders=tuple(range(6)))


@pytest.fixture(scope="module")
def fx_parser():
    """flacx's parser (importing ``flacx.cli`` sets JAX's compile-cache
    variables in the environment: put them back)."""
    keys = ("JAX_COMPILATION_CACHE_DIR",
            "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS")
    saved = {k: os.environ.get(k) for k in keys}
    from flacx.cli import make_argument_parser
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return make_argument_parser()


def encode_options(parser) -> dict:
    sub = next(a for a in parser._actions if a.dest == "action")
    return {tuple(a.option_strings) or a.dest:
            (a.dest, a.default, a.metavar, a.choices,
             getattr(a.type, "__name__", a.type), a.nargs)
            for a in sub.choices["encode"]._actions if a.dest != "help"}


def test_encode_parser_has_flacx_options(fx_parser):
    port, fx = encode_options(cli.make_argument_parser()), \
        encode_options(fx_parser)
    extra = set(port) - set(fx)
    assert extra == {("--device",)}
    assert port[("--device",)][1:4] == ("cuda", None, ("cuda", "cpu"))
    assert {k: v for k, v in port.items() if k in fx} == fx
    subs = next(a for a in cli.make_argument_parser()._actions
                if a.dest == "action").choices
    assert set(subs) == {"encode", "decode", "encode-corpus"}


def wav_of(tmp_path, seed: int, samples: int, bps: int = 16,
           rate: int = 44100):
    pcm = make_pcm(np.random.default_rng(seed), samples, 2, bps, "tonal")
    path = tmp_path / f"in{seed}.wav"
    write_wav(path, rate, bps, pcm)
    return path, pcm


def run_cli(tmp_path, wav, *flags) -> bytes:
    out = tmp_path / "out.flac"
    cli.main(["encode", "--device", "cpu", *flags, str(wav), str(out)])
    return out.read_bytes()


@pytest.mark.parametrize("flags,block,batch", [
    (("--batch-frames", "2", "--stats"), 4608, 2),
    (("-b", "16"), 16, 256),                 # under device_min_block_size
    (("--no-device", "-b", "1152"), 1152, 256),
])
def test_cli_writes_flacx_pipeline_bytes(tmp_path, capsys, flags, block,
                                         batch):
    wav, pcm = wav_of(tmp_path, 1, 3 * 4608 + 1000 if block == 4608
                      else 2 * 1152 + 300)
    got = run_cli(tmp_path, wav, *flags)
    want = io.BytesIO()
    fx_pipeline.encode_chunks_to_file(
        want, fx_wavio.read_wav_chunks(wav, batch * block),
        sample_rate=44100, bps=16, channels=2, block_size=block,
        total_samples=len(pcm), batch_frames=batch,
        device="--no-device" not in flags, **SETTINGS)
    assert got == want.getvalue()
    printed = capsys.readouterr().out
    assert printed.startswith("Encoding completed in ")
    assert "x realtime" in printed
    assert ("subframe_kinds" in printed) == ("--stats" in flags)


def test_cli_block_1152_and_best_write_the_pipeline_bytes(tmp_path):
    """The port's pipeline at the same settings (``test_torch_pipeline``
    holds it against flacx's)."""
    wav, pcm = wav_of(tmp_path, 2, 5 * 1152 + 1000)
    want = io.BytesIO()
    pipeline.encode_to_file(want, pcm, sample_rate=44100, bps=16,
                            channels=2, block_size=1152, batch_frames=4,
                            device="cpu", **SETTINGS)
    assert run_cli(tmp_path, wav, "-b", "1152", "--batch-frames", "4") \
        == want.getvalue()

    wav, pcm = wav_of(tmp_path, 5, 3 * 1152 + 300, bps=24, rate=48000)
    assert read_wav(wav)[:3] == (48000, 24, 2)
    want = io.BytesIO()
    pipeline.encode_best(want, pcm, sample_rate=48000, bps=24, channels=2,
                         block_sizes=(1152, 2304, 4608), batch_frames=4,
                         device="cpu", **SETTINGS)
    assert run_cli(tmp_path, wav, "--best", "--batch-frames", "4") \
        == want.getvalue()


def test_cli_subset_check(tmp_path):
    wav, _ = wav_of(tmp_path, 3, 100)
    with pytest.raises(SystemExit, match="LPC order <= 12"):
        run_cli(tmp_path, wav, "-l", "13")


def test_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    wav, _ = wav_of(tmp_path, 4, 100)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["encode", str(wav), str(tmp_path / "x.flac")])
