"""flacx_torch's corpus encode against flacx's on the CPU.

``flacx_torch.parallel.corpus.encode_corpus`` with ``device="cpu"`` (each
kernel's plain version) and ``flacx.parallel.corpus.encode_corpus`` (JAX
on the CPU) encode the same WAVs at block 256: two buckets (16-bit stereo
and mono), a same-stem pair (``a/x.wav``, ``b/x.wav``), an unreadable
file, a file shorter than a block and a 0-sample file.  Every output file,
the ``CorpusResult`` and the manifest must be equal; so must a resumed run
after one input is touched and one output deleted, the tiny-block oracle
route, a corpus with no full block at all and the files of ``python -m
flacx_torch encode-corpus --device cpu`` against flacx's ``encode-corpus``
(its ``cmd_encode_corpus``, not ``flacx.cli.main``, so no test touches
flacx's persistent compile cache).  ``encode_batch_indexed`` with shuffled
per-frame indices equals flacx's on the estimate route and in conformance
mode.  Every flacx run here shares one of two XLA:CPU compiles (the
stereo bucket's and the mono bucket's configuration at ``batch_frames``
frames), and one more for conformance.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import flacx.parallel.corpus as fx_corpus
from flacx.encoder import BatchEncoder as FxBatchEncoder
from flacx.encoder import EncoderConfig as FxConfig

from flacx_torch import cli
from flacx_torch.encoder import BatchEncoder, _encode_batch, config_from_flacx
from flacx_torch.parallel import corpus
from flacx_torch.wavio import write_wav

from conftest import make_pcm

torch.set_num_threads(1)

BLOCK = 256
#: the corpus settings (``-b 256 -l 8 -r 3 --batch-frames 3`` on the CLI);
#: the stereo bucket's 8 full blocks take batches of 3, 3 and 2
SETTINGS = dict(block_size=BLOCK, max_lpc_order=8,
                partition_orders=(0, 1, 2, 3), batch_frames=3)
CLI_FLAGS = ["-b", "256", "-l", "8", "-r", "3", "--batch-frames", "3"]

#: relative path -> (channels, samples, signal); None writes an unreadable
#: file
INPUTS = {
    "a/x.wav": (2, 5 * BLOCK + 17, "tonal"),
    "b/x.wav": (2, 3 * BLOCK, "noise"),
    "mono.wav": (1, 4 * BLOCK + 100, "tonal"),
    "short.wav": (1, 90, "noise"),
    "empty.wav": (2, 0, "silence"),
    "bad.wav": None,
}


def write_inputs(root, inputs=INPUTS, seed: int = 12) -> list:
    rng = np.random.default_rng(seed)
    paths = []
    for rel, spec in inputs.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        if spec is None:
            path.write_bytes(b"RIFF\x04\x00\x00\x00WAVEjunk")
        else:
            ch, samples, kind = spec
            write_wav(path, 44100, 16, make_pcm(rng, samples, ch, 16, kind))
        paths.append(path)
    return paths


def result_fields(result, out_dir) -> dict:
    """A ``CorpusResult``'s fields with its paths relative to ``out_dir``
    (the two packages write into directories of their own)."""
    d = dataclasses.asdict(result)
    for key in ("encoded", "skipped"):
        d[key] = [str(p.relative_to(out_dir)) for p in d[key]]
    return d


def manifest(out_dir) -> dict:
    return json.loads((out_dir / ".flacx_manifest.json").read_text())


def outputs(out_dir) -> dict:
    return {p.name: p.read_bytes() for p in sorted(out_dir.glob("*.flac"))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """flacx's and the port's corpus encodes of the inputs."""
    root = tmp_path_factory.mktemp("corpus")
    paths = write_inputs(root / "in")
    fx = fx_corpus.encode_corpus(paths, root / "fx", **SETTINGS)
    port = corpus.encode_corpus(paths, root / "port", device="cpu",
                                **SETTINGS)
    return root, paths, fx, port


def test_corpus_files_equal_flacx(runs):
    root, _, _, _ = runs
    want = outputs(root / "fx")
    assert sorted(want) == ["empty.flac", "mono.flac", "short.flac",
                            "x-1.flac", "x.flac"]
    assert outputs(root / "port") == want


def test_corpus_result_and_manifest_equal_flacx(runs):
    root, paths, fx, port = runs
    assert result_fields(port, root / "port") == \
        result_fields(fx, root / "fx")
    assert list(port.failed) == [str(paths[-1])]
    assert port.failed[str(paths[-1])].startswith("read: ")
    assert manifest(root / "port") == manifest(root / "fx")
    assert not list((root / "port").glob("*.tmp"))


def test_resume_equals_flacx(tmp_path):
    """A resumed run after one input is touched and one output deleted
    re-encodes exactly those two, as flacx's does."""
    paths = write_inputs(tmp_path / "in")
    fx_corpus.encode_corpus(paths, tmp_path / "fx", **SETTINGS)
    corpus.encode_corpus(paths, tmp_path / "port", device="cpu", **SETTINGS)
    first = outputs(tmp_path / "fx")
    for name in ("fx", "port"):
        (tmp_path / name / "x-1.flac").unlink()
    st = os.stat(paths[2])
    os.utime(paths[2], ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    fx = fx_corpus.encode_corpus(paths, tmp_path / "fx", resume=True,
                                 **SETTINGS)
    port = corpus.encode_corpus(paths, tmp_path / "port", resume=True,
                                device="cpu", **SETTINGS)
    got = result_fields(port, tmp_path / "port")
    assert got == result_fields(fx, tmp_path / "fx")
    assert got["encoded"] == ["x-1.flac", "mono.flac"]
    assert sorted(got["skipped"]) == ["empty.flac", "short.flac", "x.flac"]
    assert outputs(tmp_path / "port") == outputs(tmp_path / "fx") == first
    assert manifest(tmp_path / "port") == manifest(tmp_path / "fx")


def test_tiny_block_oracle_route_equals_flacx(tmp_path):
    """Block 16 is under ``device_min_block_size(12)``: every frame from
    the oracle encoder."""
    paths = write_inputs(tmp_path / "in", {"t0.wav": (2, 100, "tonal"),
                                           "t1.wav": (1, 37, "noise")})
    kw = dict(block_size=16, max_lpc_order=12, partition_orders=(0, 1))
    fx = fx_corpus.encode_corpus(paths, tmp_path / "fx", **kw)
    port = corpus.encode_corpus(paths, tmp_path / "port", device="cpu", **kw)
    assert result_fields(port, tmp_path / "port") == \
        result_fields(fx, tmp_path / "fx")
    assert outputs(tmp_path / "port") == outputs(tmp_path / "fx")
    assert len(outputs(tmp_path / "fx")) == 2


def test_corpus_without_a_full_block_equals_flacx(tmp_path):
    """An empty work list: every file shorter than one block."""
    paths = write_inputs(tmp_path / "in", {"s0.wav": (2, 200, "tonal"),
                                           "s1.wav": (2, 0, "silence")})
    fx = fx_corpus.encode_corpus(paths, tmp_path / "fx", **SETTINGS)
    port = corpus.encode_corpus(paths, tmp_path / "port", device="cpu",
                                **SETTINGS)
    assert result_fields(port, tmp_path / "port") == \
        result_fields(fx, tmp_path / "fx")
    assert outputs(tmp_path / "port") == outputs(tmp_path / "fx")


# ---------------------------------------------------------------------------
# per-frame indices


def shuffled_batch(channels: int) -> tuple[np.ndarray, np.ndarray]:
    """Three blocks and per-frame indices out of order, with four-, one-
    and five-byte coded numbers."""
    pcm = make_pcm(np.random.default_rng(channels), 3 * BLOCK, channels, 16,
                   "tonal")
    planar = np.ascontiguousarray(
        pcm.reshape(3, BLOCK, channels).transpose(0, 2, 1))
    return planar, np.array([70_000, 5, (1 << 21) + 3], np.int64)


def rows(out: dict) -> list[bytes]:
    data, lens = np.asarray(out["bytes"]), np.asarray(out["length"])
    return [bytes(data[i, :lens[i]]) for i in range(len(lens))]


@pytest.mark.parametrize("conformance", [False, True],
                         ids=["estimate", "conformance"])
def test_encode_batch_indexed_equals_flacx(conformance):
    fx_cfg = FxConfig(channels=2, block_size=BLOCK, max_lpc_order=8,
                      partition_orders=(0, 1, 2, 3), conformance=conformance)
    planar, idx = shuffled_batch(2)
    ref = FxBatchEncoder(fx_cfg, batch_frames=3).encode_batch_indexed(
        planar, idx)
    cfg = config_from_flacx(dataclasses.asdict(fx_cfg))
    enc = BatchEncoder(cfg, batch_frames=3, device="cpu")
    got = enc.encode_batch_indexed(planar, idx)
    assert rows(got) == rows({k: np.asarray(v) for k, v in ref.items()})
    assert rows(got) == rows(enc.encode_batch_indexed(
        planar, torch.from_numpy(idx)))
    keys = ("kind", "channel_code") + (("overflow",) if conformance else ())
    for key in keys:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    # each frame as the first of a contiguous batch of one
    for i in range(3):
        one = enc.encode_batch_device(planar[i:i + 1], int(idx[i]))
        assert rows(one) == [rows(got)[i]]


def test_wrongly_shaped_frame_index_raises():
    cfg = config_from_flacx(dataclasses.asdict(FxConfig(
        block_size=BLOCK, max_lpc_order=8, partition_orders=(0, 1, 2, 3))))
    planar, idx = shuffled_batch(2)
    enc = BatchEncoder(cfg, batch_frames=3, device="cpu")
    for bad in (idx[:2], np.zeros((3, 1), np.int64), np.zeros(4, np.int64)):
        with pytest.raises(ValueError, match="frame indices"):
            enc.encode_batch_indexed(planar, bad)
        with pytest.raises(ValueError, match="frame indices"):
            _encode_batch(cfg, torch.from_numpy(planar), torch.as_tensor(bad))
    with pytest.raises(ValueError, match="frame indices"):
        _encode_batch(dataclasses.replace(cfg, conformance=True),
                      torch.from_numpy(planar), torch.as_tensor(idx[:2]))


# ---------------------------------------------------------------------------
# the CLI


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


def corpus_options(parser) -> dict:
    sub = next(a for a in parser._actions if a.dest == "action")
    return {tuple(a.option_strings) or a.dest:
            (a.dest, a.default, a.metavar, a.choices,
             getattr(a.type, "__name__", a.type), a.nargs)
            for a in sub.choices["encode-corpus"]._actions
            if a.dest != "help"}


def test_encode_corpus_parser_has_flacx_options(fx_cli):
    port = corpus_options(cli.make_argument_parser())
    fx = corpus_options(fx_cli.make_argument_parser())
    assert set(port) - set(fx) == {("--device",)}
    assert port[("--device",)][1:4] == ("cuda", None, ("cuda", "cpu"))
    assert {k: v for k, v in port.items() if k in fx} == fx
    assert fx[("--batch-frames",)][1] == 512


def test_cli_encode_corpus_equals_flacx(runs, fx_cli, tmp_path, capsys):
    _, paths, _, _ = runs
    args = [str(p) for p in paths]
    fx_cli.cmd_encode_corpus(fx_cli.make_argument_parser().parse_args(
        ["encode-corpus", *CLI_FLAGS, str(tmp_path / "fx"), *args]))
    want = capsys.readouterr().out
    cli.main(["encode-corpus", "--device", "cpu", *CLI_FLAGS,
              str(tmp_path / "port"), *args])
    got = capsys.readouterr().out
    assert outputs(tmp_path / "port") == outputs(tmp_path / "fx")
    assert len(outputs(tmp_path / "fx")) == 5
    assert manifest(tmp_path / "port") == manifest(tmp_path / "fx")
    # the completion prints differ only in the seconds
    head = "Encoded 5 files (3279 samples)"
    assert got.splitlines()[0].split(" in ")[0] == \
        want.splitlines()[0].split(" in ")[0] == head
    assert got.splitlines()[1:] == want.splitlines()[1:] == \
        [f"  FAILED {paths[-1]}: " + runs[2].failed[str(paths[-1])]]


def test_cuda_without_cuda_raises(runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device runs")
    _, paths, _, _ = runs
    with pytest.raises(RuntimeError, match="device='cpu'"):
        corpus.encode_corpus(paths[:1], tmp_path / "out", **SETTINGS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["encode-corpus", *CLI_FLAGS, str(tmp_path / "out"),
                  str(paths[0])])
    assert not (tmp_path / "out").exists()
