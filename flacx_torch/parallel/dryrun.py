"""A dry run of every scale-out layer on a mesh of ``n`` devices.

:func:`dryrun_multichip` is the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``, check for check: the sharded batch
encode with its byte total summed over the parts and the frames decoded
by the oracle, the sharded file encode against the unsharded one, the
sharded decode, the corpus stripes, the sequence-sharded autocorrelation
on a ``frames`` × ``seq`` mesh, a batch that does not divide the mesh,
the hi-res configuration sharded, and the corpus encode through the
multi-process layer.  Any mismatch raises; it prints one summary line.
"""

from __future__ import annotations

import io
import tempfile
from pathlib import Path

import numpy as np
import torch


def dryrun_multichip(n_devices: int, devices=None,
                     device: str | torch.device = "cuda") -> None:
    """Run one sharded step of every layer on a 1-D mesh of ``n_devices``
    devices: the first ``n_devices`` visible cards (raising when fewer
    are visible), or the first ``n_devices`` of ``devices``, in which a
    device may repeat (``("cuda:0",) * 4`` on a one-card host,
    ``("cpu",) * 4`` with ``device="cpu"``)."""
    from flacx_torch import decoder, pipeline
    from flacx_torch.encoder import BatchEncoder, EncoderConfig, _fetch
    from flacx_torch.ops.lpc import autocorrelate
    from flacx_torch.oracle import decode_stream
    from flacx_torch.parallel.distributed import (encode_corpus_distributed,
                                                  shard_corpus)
    from flacx_torch.parallel.mesh import data_mesh, frame_sharding
    from flacx_torch.parallel.seqshard import autocorrelate_sharded, seq_mesh
    from flacx_torch.stream import StreamWriter
    from flacx_torch.wavio import write_wav

    mesh = data_mesh(n_devices, devices=devices)
    sharding = frame_sharding(mesh)
    home = mesh.home(device)

    cfg = EncoderConfig(block_size=512, max_lpc_order=8, channels=2, bps=16,
                        partition_orders=(0, 1, 2, 3))
    b = 2 * n_devices
    rng = np.random.default_rng(1)
    pcm = rng.integers(-20000, 20000, size=(b, 2, cfg.block_size)
                       ).astype(np.int32)
    enc = BatchEncoder(cfg, b, device=device, sharding=sharding)
    parts = enc.encode_batch_device(pcm, 0)
    # the aggregate statistic: each part's byte total, summed on the
    # mesh's first device (the all-reduce over the frames axis)
    total = int(sum(p["length"].sum().to(home) for p in parts))
    lengths = _fetch(parts, b, "length")
    if not ((lengths > 0).all() and total == lengths.sum()):
        raise AssertionError("sharded encode: byte total")

    # one sharded batch's frames decoded on the host by the oracle
    frames = enc._drain(parts, b, None)
    interleaved = pcm.transpose(0, 2, 1).reshape(-1, 2)
    f = io.BytesIO()
    writer = StreamWriter(f, cfg.sample_rate, 16, 2, len(interleaved),
                          cfg.block_size)
    writer.add_pcm(interleaved)
    writer.write_frames(frames)
    writer.finalize()
    *_, rows = decode_stream(io.BytesIO(f.getvalue()))
    if not np.array_equal(np.array(list(rows), dtype=np.int64),
                          interleaved):
        raise AssertionError("sharded encode round-trip mismatch")

    # the whole file pipeline sharded: bytes equal to the unsharded path
    pcm_file = rng.integers(-20000, 20000,
                            size=(cfg.block_size * (2 * n_devices) + 100, 2)
                            ).astype(np.int32)
    kw = dict(sample_rate=44100, bps=16, channels=2,
              block_size=cfg.block_size, max_lpc_order=cfg.max_lpc_order,
              qlp_precision=5, partition_orders=cfg.partition_orders,
              batch_frames=n_devices, device=device)

    def encode_file(pcm_in, sh, **over):
        out = io.BytesIO()
        pipeline.encode_to_file(out, pcm_in, sharding=sh, **{**kw, **over})
        return out.getvalue()

    data = encode_file(pcm_file, sharding)
    if data != encode_file(pcm_file, None):
        raise AssertionError("sharded encode_to_file bytes differ from "
                             "unsharded")

    # the sharded decode reproduces the PCM bit for bit
    def decode(data_in, sh=sharding):
        return decoder.decode_array(data_in, batch_frames=n_devices,
                                    device=device, sharding=sh)[1]

    if not np.array_equal(decode(data), pcm_file):
        raise AssertionError("sharded decode mismatch")

    # corpus stripes: disjoint, their union the corpus
    names = [f"f{i:02d}.wav" for i in range(11)]
    stripes = [shard_corpus(names, p, 4) for p in range(4)]
    flat = sorted(str(p) for s in stripes for p in s)
    if flat != sorted(names) or any(
            set(map(str, s)) & set(map(str, t))
            for i, s in enumerate(stripes) for t in stripes[i + 1:]):
        raise AssertionError("corpus stripes")

    # sequence sharding: the sample axis over a frames x seq mesh, halo
    # exchange and the sum over the shards
    sp_note = ""
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh2 = seq_mesh(n_devices // 2, 2, devices=mesh.devices)
        xw = torch.from_numpy(rng.standard_normal((n_devices,
                                                   cfg.block_size)) * 1000.0)
        want_ac = autocorrelate(xw, 8)
        got_ac = autocorrelate_sharded(xw.to(home), 8, mesh2).cpu()
        if not torch.allclose(got_ac, want_ac, rtol=1e-9):
            raise AssertionError("seq-sharded autocorr mismatch")
        sp_note = ", seq-parallel autocorr OK (halo exchange + shard sum)"

    # a batch that does not divide the mesh: the same bytes and PCM
    pcm_odd = rng.integers(-20000, 20000,
                           size=(cfg.block_size * (n_devices + 1) + 37, 2)
                           ).astype(np.int32)
    data_odd = encode_file(pcm_odd, sharding)
    if data_odd != encode_file(pcm_odd, None):
        raise AssertionError("uneven-batch sharded encode bytes differ from "
                             "unsharded")
    if not np.array_equal(decode(data_odd), pcm_odd):
        raise AssertionError("uneven-batch decode mismatch")

    # the hi-res configuration sharded: 24-bit/96 kHz, LPC order 32, the
    # full partition range
    hi = dict(sample_rate=96000, bps=24, block_size=1024, max_lpc_order=32,
              partition_orders=tuple(range(16)))
    pcm_h = np.clip(rng.integers(-20000, 20000,
                                 size=(hi["block_size"] * n_devices, 2))
                    * 256, -(1 << 23), (1 << 23) - 1).astype(np.int32)
    data_h = encode_file(pcm_h, sharding, **hi)
    if data_h != encode_file(pcm_h, None, **hi):
        raise AssertionError("hi-res sharded encode bytes differ from "
                             "unsharded")
    if not np.array_equal(decode(data_h), pcm_h):
        raise AssertionError("hi-res sharded decode mismatch")

    # the corpus through the multi-process layer (one process here), each
    # output decoding bit-exactly
    with tempfile.TemporaryDirectory() as td:
        in_dir, out_dir = Path(td) / "in", Path(td) / "out"
        in_dir.mkdir()
        corpus_pcm = {}
        for i in range(3):
            p = in_dir / f"c{i}.wav"
            pc = rng.integers(-20000, 20000,
                              size=(cfg.block_size * (i + n_devices) + 17 * i,
                                    2)).astype(np.int32)
            write_wav(p, 44100, 16, pc)
            corpus_pcm[p.stem] = pc
        result, totals = encode_corpus_distributed(
            sorted(in_dir.glob("*.wav")), out_dir,
            block_size=cfg.block_size, max_lpc_order=cfg.max_lpc_order,
            partition_orders=cfg.partition_orders, batch_frames=n_devices,
            sharding=sharding, device=device)
        if result.failed or int(totals["files"]) != 3:
            raise AssertionError(f"distributed corpus: {result.failed}, "
                                 f"{totals}")
        for stem, pc in corpus_pcm.items():
            if not np.array_equal(
                    decode((out_dir / f"{stem}.flac").read_bytes(), None),
                    pc):
                raise AssertionError(f"corpus {stem} mismatch")

    print(f"dryrun_multichip({n_devices}): OK — {total} bytes, "
          f"bit-exact round-trip, uneven-batch OK, hi-res sharded OK, "
          f"distributed corpus OK (3 files){sp_note}", flush=True)
