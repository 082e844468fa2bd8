"""flacx_torch's multi-process layer against flacx's on the CPU.

``flacx_torch.parallel.distributed`` on ``torch.distributed`` (gloo) and
``flacx.parallel.distributed`` take the same corpus settings as
``tests/test_distributed_multiproc.py``: block 128, LPC order 4,
partition orders (0, 1), 4 frames a batch, over three WAVs.  The stripes
must equal flacx's; without a process group ``allreduce_stats`` and
``encode_corpus_distributed`` equal flacx's single-process results (files
and totals).  A real two-process group: this file itself, run as a
script, is the worker (``python tests/test_torch_distributed.py <port>
<rank> <workdir>``); two workers join over ``tcp://127.0.0.1`` with
``device="cpu"`` and encode the corpus into one shared output directory.
Their stripes, totals, manifest shards and files are held against
``flacx.parallel.corpus.encode_corpus`` of the same WAVs, and a resumed
run skips every file.  Each flacx encode here shares one XLA:CPU compile.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
#: the corpus settings of ``tests/test_distributed_multiproc.py``
SETTINGS = dict(block_size=128, max_lpc_order=4, qlp_precision=5,
                partition_orders=(0, 1), batch_frames=4)
#: seconds a worker may take
WORKER_TIMEOUT = 120


def worker(port: int, rank: int, workdir: Path) -> None:
    """One rank of the two-process group: join it on the CPU, check the
    collectives, encode this rank's stripe into the shared output
    directory and write what the parent checks as JSON."""
    import torch.distributed as dist

    from flacx_torch.parallel import (allreduce_stats,
                                      encode_corpus_distributed,
                                      global_data_mesh, init_distributed,
                                      shard_corpus)

    torch.set_num_threads(1)
    assert init_distributed(f"127.0.0.1:{port}", 2, rank,
                            device="cpu") == (rank, 2)
    try:
        mesh = global_data_mesh()
        assert mesh.size == 2 and [r for r, _ in mesh.devices] == [0, 1]
        assert mesh.local.devices == (torch.device("cpu"),)
        assert allreduce_stats({"x": rank + 1, "y": 10}) == {"x": 3.0,
                                                             "y": 20.0}
        wavs = sorted((workdir / "wavs").glob("*.wav"))
        mine = shard_corpus(wavs)
        result, totals = encode_corpus_distributed(wavs, workdir / "out",
                                                   **SETTINGS)
        (workdir / f"result{rank}.json").write_text(json.dumps({
            "mine": [p.name for p in mine],
            "encoded": sorted(p.name for p in result.encoded),
            "failed": result.failed, "samples": result.samples,
            "bytes_in": result.bytes_in, "bytes_out": result.bytes_out,
            "totals": totals}))
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(workdir: Path) -> list[str]:
    """Run the two ranks to their end (each killed past its timeout) and
    return their outputs; a port taken between its probe and the group's
    bind is retried once with another."""
    env = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR", "LANG")
           if k in os.environ}
    env["PYTHONPATH"] = str(ROOT)
    for attempt in range(2):
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, __file__, str(port), str(rank), str(workdir)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for rank in (0, 1)]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                outs.append(p.communicate()[0])
        codes = [p.returncode for p in procs]
        if codes == [0, 0]:
            return outs
        if attempt == 0 and any("EADDRINUSE" in o or "in use" in o
                                for o in outs):
            continue
        raise AssertionError(f"workers exited {codes}:\n" + "\n".join(outs))
    raise AssertionError("unreachable")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three WAVs (those of ``tests/test_distributed_multiproc.py``) and
    flacx's single-process encode of them."""
    from flacx.parallel.corpus import encode_corpus as fx_encode_corpus

    from flacx_torch.wavio import write_wav

    from conftest import make_pcm

    root = tmp_path_factory.mktemp("corpus")
    (root / "wavs").mkdir()
    rng = np.random.default_rng(0xF1AC)
    for i, frames in enumerate([128 * 3 + 40, 128 * 2, 128 * 5 + 7]):
        write_wav(root / "wavs" / f"in{i}.wav", 44100, 16,
                  make_pcm(rng, frames, 2, 16,
                           ["tonal", "noise", "impulse"][i]))
    wavs = sorted((root / "wavs").glob("*.wav"))
    single = fx_encode_corpus(wavs, root / "flacx", **SETTINGS)
    return root, wavs, single


@pytest.mark.parametrize("process", range(4))
def test_shard_corpus_equals_flacx(process):
    from flacx.parallel.distributed import shard_corpus as fx_shard_corpus

    from flacx_torch.parallel import shard_corpus
    names = [f"dir{i % 3}/f{(7 * i) % 13:02d}.wav" for i in range(13)]
    assert shard_corpus(names, process, 4) == fx_shard_corpus(names,
                                                              process, 4)
    assert shard_corpus(names) == fx_shard_corpus(names) == sorted(
        Path(p) for p in names)


def test_allreduce_stats_without_group_equals_flacx():
    from flacx.parallel.distributed import allreduce_stats as fx_allreduce

    from flacx_torch.parallel import allreduce_stats
    values = {"samples": 123456789, "files": 3, "bytes_out": 2 ** 52 + 1,
              "ratio": 0.25}
    got = allreduce_stats(values)
    assert got == fx_allreduce(values)
    assert list(got) == list(values)
    assert all(type(v) is float for v in got.values())


def test_encode_corpus_distributed_one_process_equals_flacx(corpus,
                                                            tmp_path):
    from flacx.parallel.distributed import (encode_corpus_distributed as
                                            fx_encode_distributed)

    from flacx_torch.parallel import encode_corpus_distributed
    _, wavs, _ = corpus
    fx_result, fx_totals = fx_encode_distributed(wavs, tmp_path / "flacx",
                                                 **SETTINGS)
    result, totals = encode_corpus_distributed(wavs, tmp_path / "port",
                                               device="cpu", **SETTINGS)
    assert totals == fx_totals
    assert [p.name for p in result.encoded] == [p.name for p in
                                                fx_result.encoded]
    for p in fx_result.encoded:
        assert (tmp_path / "port" / p.name).read_bytes() == p.read_bytes()
    # one process: the manifest is the unsuffixed one, as flacx's
    assert sorted(q.name for q in (tmp_path / "port").glob(".flacx_*")) == \
        sorted(q.name for q in (tmp_path / "flacx").glob(".flacx_*"))


def test_two_process_gloo_corpus_equals_flacx(corpus):
    from flacx_torch.parallel.corpus import encode_corpus

    root, wavs, single = corpus
    run_workers(root)
    r0, r1 = (json.loads((root / f"result{k}.json").read_text())
              for k in (0, 1))
    # disjoint stripes whose union is the corpus, each encoded by its rank
    assert not set(r0["mine"]) & set(r1["mine"])
    assert sorted(r0["mine"] + r1["mine"]) == [p.name for p in wavs]
    for r in (r0, r1):
        assert r["encoded"] == sorted(Path(m).stem + ".flac"
                                      for m in r["mine"])
        assert not r["failed"]
    # both ranks hold the same totals: flacx's single-process encode's
    assert r0["totals"] == r1["totals"] == {
        "bytes_in": float(single.bytes_in),
        "bytes_out": float(single.bytes_out), "failed": 0.0,
        "files": 3.0, "samples": float(single.samples)}
    assert r0["samples"] + r1["samples"] == single.samples
    # one manifest shard a rank, side by side, each naming its stripe
    out = root / "out"
    shards = sorted(p.name for p in out.glob(".flacx_manifest*.json"))
    assert shards == [".flacx_manifest.p0.json", ".flacx_manifest.p1.json"]
    for k, r in enumerate((r0, r1)):
        entries = json.loads((out / shards[k]).read_text())
        assert sorted(Path(p).name for p in entries) == sorted(r["mine"])
    # every file equal to flacx's
    for p in single.encoded:
        assert (out / p.name).read_bytes() == p.read_bytes(), p.name
    # a resumed run reads both shards and skips every file
    again = encode_corpus(wavs, out, resume=True, device="cpu", **SETTINGS)
    assert not again.encoded and len(again.skipped) == 3


def test_init_distributed_needs_its_device_and_its_group(monkeypatch):
    from flacx_torch.parallel import init_distributed
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_distributed("127.0.0.1:1", 1, 0)
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        init_distributed(device="cpu")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        init_distributed("127.0.0.1:1", device="cpu")


def test_global_data_mesh_of_one_process(monkeypatch):
    from flacx_torch.parallel import distributed, frame_sharding
    monkeypatch.setattr(distributed, "_local", (torch.device("cpu"),))
    mesh = distributed.global_data_mesh()
    assert mesh.size == 1 and mesh.devices == ((0, torch.device("cpu")),)
    assert frame_sharding(mesh.local).mesh.devices == (torch.device("cpu"),)
    with pytest.raises(TypeError, match="another process's card"):
        frame_sharding(mesh)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
