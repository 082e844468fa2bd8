"""``python -m flacx_torch decode`` against flacx's decode on the CPU.

The port's ``decode`` parser has every option, default and metavar of
flacx's, and ``--device`` besides.  ``main(["decode", "--device", "cpu",
...])`` writes the WAV bytes flacx's ``cmd_decode`` writes from the same
FLAC file (``cmd_decode``, not ``flacx.cli.main``, so no test touches
flacx's persistent compile cache), whole-file and with ``--stream``, on
the batched route and with ``--no-device``; both refuse a file whose
STREAMINFO MD5 is not its audio's.
"""

import os

import numpy as np
import pytest
import torch

from flacx_torch import cli
from flacx_torch.pipeline import encode_to_file
from flacx_torch.wavio import read_wav

from conftest import make_pcm

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fx_cli():
    """flacx's ``cli`` module (importing it sets JAX's compile-cache
    variables in the environment: put them back)."""
    keys = ("JAX_COMPILATION_CACHE_DIR",
            "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS")
    saved = {k: os.environ.get(k) for k in keys}
    import flacx.cli
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return flacx.cli


def options(parser, action: str) -> dict:
    sub = next(a for a in parser._actions if a.dest == "action")
    return {tuple(a.option_strings) or a.dest:
            (a.dest, a.default, a.metavar, a.choices,
             getattr(a.type, "__name__", a.type), a.nargs)
            for a in sub.choices[action]._actions if a.dest != "help"}


def test_decode_parser_has_flacx_options(fx_cli):
    port = options(cli.make_argument_parser(), "decode")
    fx = options(fx_cli.make_argument_parser(), "decode")
    assert set(port) - set(fx) == {("--device",)}
    assert port[("--device",)][1:4] == ("cuda", None, ("cuda", "cpu"))
    assert {k: v for k, v in port.items() if k in fx} == fx


@pytest.fixture(scope="module")
def flac_files(tmp_path_factory):
    """A 16-bit stereo file (five blocks of 1152 and a short last one) and
    a 24-bit one, from the port's CPU encoder."""
    out = {}
    tmp = tmp_path_factory.mktemp("flac")
    for name, bps, samples in (("cd", 16, 5 * 1152 + 300),
                               ("master", 24, 3 * 1152)):
        pcm = make_pcm(np.random.default_rng(bps), samples, 2, bps, "tonal")
        path = tmp / f"{name}.flac"
        with path.open("wb") as f:
            encode_to_file(f, pcm, sample_rate=48000, bps=bps, channels=2,
                           block_size=1152, max_lpc_order=8,
                           qlp_precision=12,
                           partition_orders=tuple(range(6)), device="cpu")
        out[name] = (path, pcm)
    return out


@pytest.mark.parametrize("name,flags", [
    ("cd", ()), ("cd", ("--stream",)), ("master", ("--no-device",)),
    ("master", ("--batch-frames", "2", "--stream"))])
def test_cli_decode_writes_flacx_wav(fx_cli, flac_files, tmp_path, capsys,
                                     name, flags):
    path, pcm = flac_files[name]
    ours, theirs = tmp_path / "ours.wav", tmp_path / "theirs.wav"
    cli.main(["decode", "--device", "cpu", *flags, str(path), str(ours)])
    assert capsys.readouterr().out.startswith("Decoding completed in ")
    batch = int(flags[flags.index("--batch-frames") + 1]) \
        if "--batch-frames" in flags else 256
    fx_cli.cmd_decode(path, theirs, device="--no-device" not in flags,
                      batch_frames=batch, stream="--stream" in flags)
    assert ours.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(read_wav(ours)[3], pcm)


def test_cli_decode_refuses_a_wrong_md5(fx_cli, flac_files, tmp_path):
    path, _ = flac_files["cd"]
    data = bytearray(path.read_bytes())
    data[26 + 4] ^= 1                    # STREAMINFO's MD5 starts at 26
    bad = tmp_path / "bad.flac"
    bad.write_bytes(bytes(data))
    for flags in ((), ("--stream",)):
        with pytest.raises(SystemExit, match="MD5 mismatch"):
            cli.main(["decode", "--device", "cpu", *flags, str(bad),
                      str(tmp_path / "out.wav")])
        with pytest.raises(SystemExit, match="MD5 mismatch"):
            fx_cli.cmd_decode(bad, tmp_path / "fx.wav", device=False,
                              stream="--stream" in flags)


def test_cli_decode_defaults_to_the_card(flac_files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["decode", str(flac_files["cd"][0]),
                  str(tmp_path / "out.wav")])
