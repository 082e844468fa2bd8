"""flacx_torch under ``sharding=`` on CPU meshes.

The counterpart of ``tests/test_sharded_paths.py``: meshes of two and of
three ``cpu`` entries split every batch into contiguous parts, each run on
its own mesh device, so the split, the launches and the assembly are
those of a mesh of distinct cards.  The sharded ``encode_to_file`` must
write the unsharded file and flacx's sharded file (on its 8-device CPU
mesh, one XLA:CPU compile); ``decode_array`` at a batch that divides the
mesh and at one that does not, and ``decode_stream``, must give the PCM
bit for bit on the device route; the sharded corpus must write the
unsharded corpus's files.
"""

import io

import numpy as np
import pytest
import torch

from flacx import pipeline as fx_pipeline
from flacx.parallel import data_mesh as fx_data_mesh
from flacx.parallel import frame_sharding as fx_frame_sharding

import flacx_torch.decoder as decoder
import flacx_torch.parallel as parallel
from flacx_torch import pipeline
from flacx_torch.encoder import BatchEncoder, EncoderConfig
from flacx_torch.parallel import corpus, data_mesh, frame_sharding
from flacx_torch.parallel.mesh import Mesh, replicated
from flacx_torch.wavio import read_wav, write_wav

from conftest import make_pcm

torch.set_num_threads(1)

#: the settings of ``tests/test_sharded_paths.py``
KW = dict(sample_rate=44100, bps=16, channels=2, block_size=256,
          max_lpc_order=6, qlp_precision=5, partition_orders=(0, 1, 2),
          batch_frames=8)
MESHES = {"cpu2": 2, "cpu3": 3}


def sharding_of(name: str):
    return frame_sharding(data_mesh(devices=("cpu",) * MESHES[name]))


@pytest.fixture(scope="module")
def tonal():
    """Tonal PCM of 16 blocks and a 50-sample tail, and flacx's sharded
    file of it."""
    pcm = make_pcm(np.random.default_rng(3), 256 * 16 + 50, 2, 16, "tonal")
    f = io.BytesIO()
    fx_pipeline.encode_to_file(
        f, pcm, sharding=fx_frame_sharding(fx_data_mesh(8)), **KW)
    return pcm, f.getvalue()


@pytest.fixture(scope="module")
def noise_file():
    """Noise PCM of 16 full blocks and its file (the port's unsharded
    encode)."""
    pcm = make_pcm(np.random.default_rng(4), 256 * 16, 2, 16, "noise")
    f = io.BytesIO()
    pipeline.encode_to_file(f, pcm, device="cpu", **KW)
    return pcm, f.getvalue()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_encode_equals_unsharded_and_flacx(tonal, mesh, monkeypatch):
    pcm, want = tonal
    parts = []
    run = BatchEncoder._run

    def spy(self, arr, index):
        out = run(self, arr, index)
        parts.append([len(p["length"]) for p in out])
        return out

    monkeypatch.setattr(BatchEncoder, "_run", spy)
    a = io.BytesIO()
    pipeline.encode_to_file(a, pcm, device="cpu", sharding=sharding_of(mesh),
                            **KW)
    monkeypatch.undo()
    b = io.BytesIO()
    pipeline.encode_to_file(b, pcm, device="cpu", **KW)
    assert a.getvalue() == b.getvalue() == want
    assert parts == ([[4, 4]] * 2 if mesh == "cpu2" else [[3, 3, 2]] * 2)


def test_sharded_batch_encoder_stats_and_short_batches(tonal):
    """A short last group splits too (3 frames over 3 devices, 2 over
    3: an empty part is left out), with the same frames and stats."""
    pcm, _ = tonal
    cfg = EncoderConfig(**{k: v for k, v in KW.items()
                           if k != "batch_frames"})
    planar = np.ascontiguousarray(
        pcm[:256 * 14].reshape(14, 256, 2).transpose(0, 2, 1))
    want_stats, got_stats = {}, {}
    want = BatchEncoder(cfg, 6, device="cpu").encode_frames(planar, 3,
                                                             want_stats)
    enc = BatchEncoder(cfg, 6, device="cpu", sharding=sharding_of("cpu3"))
    assert enc.encode_frames(planar, 3, got_stats) == want
    assert got_stats == want_stats
    assert [len(p["length"]) for p in
            enc.encode_batch_device(planar[:2], 0)] == [1, 1]


def decode_calls(monkeypatch) -> list:
    """The frame counts of the walker's calls."""
    calls = []
    scan = decoder.scan_frames

    def spy(rows, *args, **kw):
        calls.append(rows.shape[0])
        return scan(rows, *args, **kw)

    monkeypatch.setattr(decoder, "scan_frames", spy)
    return calls


@pytest.mark.parametrize("mesh,batch,walks", [
    ("cpu2", 8, [4, 4, 4, 4]),          # every batch divides the mesh
    ("cpu2", 6, [3, 3, 3, 3, 2, 2]),    # 6, 6 and 4 divide it
    ("cpu3", 6, [2, 2, 2, 2, 2, 2, 4]),  # the last batch of 4 does not
    ("cpu3", 5, [5, 5, 5, 1]),          # no batch divides
])
def test_sharded_decode_array_bit_exact(noise_file, mesh, batch, walks,
                                        monkeypatch):
    pcm, data = noise_file
    calls = decode_calls(monkeypatch)
    stats = {}
    _, got = decoder.decode_array(data, batch_frames=batch, device="cpu",
                                  stats=stats, sharding=sharding_of(mesh))
    assert np.array_equal(got, pcm)
    assert calls == walks
    assert stats == {"device": -(-16 // batch)}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_decode_stream_bit_exact(noise_file, mesh):
    pcm, data = noise_file
    stats = {}
    _, chunks = decoder.decode_stream(io.BytesIO(data), batch_frames=6,
                                      device="cpu", stats=stats,
                                      sharding=sharding_of(mesh))
    assert np.array_equal(np.concatenate(list(chunks)), pcm)
    assert set(stats) == {"device", "oracle_frames"}


def test_sharded_corpus_equals_unsharded(tmp_path):
    rng = np.random.default_rng(5)
    paths = []
    for i in range(3):
        p = tmp_path / f"c{i}.wav"
        write_wav(p, 44100, 16, make_pcm(rng, 900 + 300 * i, 2, 16,
                                         ("tonal", "noise", "impulse")[i]))
        paths.append(p)
    kw = dict(block_size=256, max_lpc_order=4, partition_orders=(0, 1),
              batch_frames=8, device="cpu")
    corpus.encode_corpus(paths, tmp_path / "one", **kw)
    result = corpus.encode_corpus(paths, tmp_path / "mesh",
                                  sharding=sharding_of("cpu3"), **kw)
    assert len(result.encoded) == 3 and not result.failed
    for p in paths:
        name = p.stem + ".flac"
        got = (tmp_path / "mesh" / name).read_bytes()
        assert got == (tmp_path / "one" / name).read_bytes()
        _, pcm = decoder.decode_array(got, device="cpu")
        assert np.array_equal(pcm, read_wav(p)[3])


# ---------------------------------------------------------------------------
# the mesh


def test_frame_sharding_parts():
    sh = sharding_of("cpu3")
    cpu = torch.device("cpu")
    assert sh.parts(8) == [(cpu, 0, 3), (cpu, 3, 6), (cpu, 6, 8)]
    assert sh.parts(1) == [(cpu, 0, 1)]
    assert (sh.divides(6), sh.divides(8)) == (True, False)
    assert sh.mesh.size == 3 and sh.mesh.axis_names == ("frames",)
    assert Mesh(["cpu", torch.device("cpu")]).devices == (cpu, cpu)
    assert data_mesh(2, devices=("cpu",) * 3).size == 2
    t = torch.arange(3)
    assert all(torch.equal(x, t) for x in replicated(sh.mesh).place(t))


def test_mesh_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError):
        Mesh([])
    with pytest.raises(ValueError):
        data_mesh(3, devices=("cpu", "cpu"))
    with pytest.raises(ValueError):
        Mesh(["cpu", "meta"])
    if not torch.cuda.is_available():
        for make in (data_mesh, lambda: data_mesh(1),
                     lambda: Mesh(["cuda:0", "cuda:0"])):
            with pytest.raises(RuntimeError):
                make()
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="visible"):
        data_mesh(visible + 1)


def test_device_conflicting_with_the_mesh_raises(noise_file):
    sh = sharding_of("cpu2")
    cfg = EncoderConfig(block_size=256, max_lpc_order=6)
    with pytest.raises((ValueError, RuntimeError)):
        BatchEncoder(cfg, 4, sharding=sh)                 # device="cuda"
    assert BatchEncoder(cfg, 4, device="cpu", sharding=sh).device == \
        torch.device("cpu")
    with pytest.raises((ValueError, RuntimeError)):
        decoder.decode_array(noise_file[1], sharding=sh)


def test_distributed_names_are_not_ported_yet():
    """Named before the multi-process layer was ported: the five names now
    resolve to :mod:`flacx_torch.parallel.distributed`'s functions."""
    from flacx_torch.parallel import distributed
    assert parallel.data_mesh is data_mesh
    for name in ("init_distributed", "global_data_mesh", "shard_corpus",
                 "allreduce_stats", "encode_corpus_distributed"):
        assert name in parallel.__all__
        assert getattr(parallel, name) is getattr(distributed, name)
    with pytest.raises(AttributeError):
        parallel.not_a_name
