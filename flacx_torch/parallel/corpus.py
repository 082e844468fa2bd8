"""Corpus-scale encode: many WAV files in each device batch.

The JAX package's ``parallel/corpus.py``, function for function
(``BASELINE.json`` configs[3]): WAVs are bucketed by stream parameters;
every FULL block of every file in a bucket joins one global work list of
``[B, channels, block_size]`` batches (frames are self-contained, so files
mix freely within a batch, each frame carrying its own coded number
through :meth:`flacx_torch.encoder.BatchEncoder.encode_batch_indexed`).
Host assembly returns the frames to their files; each short final block
goes through the oracle.  A file that cannot be read fails alone.  Blocks
too small for the batched pipeline take the oracle route
(``encode_to_file(oracle=True)``).

Checkpoint and resume, at file granularity: every finished file rewrites
a manifest sidecar in the output directory (``.flacx_manifest*.json``,
written atomically: a temporary file, then a rename), and ``resume=True``
skips each input whose entry matches its current (size, mtime) signature
and whose output still has the recorded size.  ``manifest_suffix`` names
one process's shard of the manifest; resume reads the union of all
shards.

``device`` is the torch device (the card by default; ``"cpu"`` runs each
kernel's plain version), ``sharding`` splits every batch over a mesh's
devices (:mod:`flacx_torch.parallel.mesh`).  The last batch of a bucket
is not padded to ``batch_frames``: no frame depends on its batch.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from flacx_torch.encoder import (BatchEncoder, EncoderConfig,
                                 device_min_block_size)
from flacx_torch.parallel.mesh import home_device
from flacx_torch.pipeline import _oracle_frame, encode_to_file
from flacx_torch.stream import StreamWriter
from flacx_torch.wavio import read_wav


@dataclass
class CorpusResult:
    encoded: list[Path] = field(default_factory=list)
    skipped: list[Path] = field(default_factory=list)
    failed: dict[str, str] = field(default_factory=dict)
    samples: int = 0
    bytes_in: int = 0
    bytes_out: int = 0


_MANIFEST_STEM = ".flacx_manifest"


def _input_signature(path: Path) -> list[int]:
    st = path.stat()
    return [st.st_size, st.st_mtime_ns]


class _Manifest:
    """File-granular checkpoint log of a corpus encode.

    One JSON object per input path: output name, input signature and
    output size, and the stats that aggregate across restarts.
    ``record`` rewrites this process's shard atomically after every
    finished file, so a crash loses at most the file in flight.
    """

    def __init__(self, out_dir: Path, suffix: str = ""):
        self.path = out_dir / f"{_MANIFEST_STEM}{suffix}.json"
        self.entries: dict[str, dict] = {}

    @staticmethod
    def load_all(out_dir: Path) -> dict[str, dict]:
        """The union of every manifest shard in ``out_dir``."""
        merged: dict[str, dict] = {}
        for p in sorted(out_dir.glob(f"{_MANIFEST_STEM}*.json")):
            try:
                merged.update(json.loads(p.read_text()))
            except (OSError, json.JSONDecodeError):
                continue  # a corrupt shard only costs re-encoding
        return merged

    def record(self, in_path: Path, out_path: Path, samples: int,
               bytes_in: int, bytes_out: int) -> None:
        self.entries[str(in_path)] = {
            "out": out_path.name,
            "sig": _input_signature(in_path),
            "out_bytes": bytes_out,
            "samples": samples,
            "bytes_in": bytes_in,
        }
        tmp = self.path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(self.entries, indent=0))
        os.replace(tmp, self.path)

    @staticmethod
    def is_done(entry: dict | None, in_path: Path, out_path: Path) -> bool:
        """Whether a file can be skipped: its input is unchanged since the
        recorded encode and the recorded output is still whole."""
        if not entry or entry.get("out") != out_path.name:
            return False
        try:
            if entry.get("sig") != _input_signature(in_path):
                return False
            return out_path.stat().st_size == entry.get("out_bytes")
        except OSError:
            return False


def encode_corpus(paths: Sequence[Path | str], out_dir: Path | str, *,
                  block_size: int = 4608, max_lpc_order: int = 12,
                  qlp_precision: int = 5,
                  partition_orders: tuple[int, ...] = (0, 1, 2, 3, 4, 5),
                  batch_frames: int = 128, stereo: str = "auto",
                  windows: tuple[str, ...] = ("tukey(0.5)",),
                  sharding=None, resume: bool = False,
                  manifest_suffix: str = "",
                  device: str | torch.device = "cuda") -> CorpusResult:
    """Encode many WAV files with globally batched device launches.

    ``resume=True`` skips inputs a previous run into ``out_dir`` already
    finished (module docstring); ``manifest_suffix`` names this process's
    manifest shard.
    """
    dev = home_device(device, sharding)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    result = CorpusResult()
    manifest = _Manifest(out_dir, manifest_suffix)
    prior = _Manifest.load_all(out_dir) if resume else {}

    # ---- output names up front; same-stem inputs from different
    # directories (a/x.wav, b/x.wav) are told apart rather than overwrite
    # each other
    out_paths: dict[Path, Path] = {}
    used_names: set[str] = set()
    for path in map(Path, paths):
        name = path.stem + ".flac"
        k = 1
        while name in used_names:
            name = f"{path.stem}-{k}.flac"
            k += 1
        used_names.add(name)
        out_paths[path] = out_dir / name

    # ---- load and bucket by stream parameters ---------------------------
    buckets: dict[tuple, list[tuple[Path, np.ndarray]]] = {}
    for path in map(Path, paths):
        if resume and _Manifest.is_done(prior.get(str(path)), path,
                                        out_paths[path]):
            result.skipped.append(out_paths[path])
            continue
        try:
            sr, bps, ch, pcm = read_wav(path)
        except Exception as exc:  # noqa: BLE001 — per-file isolation
            result.failed[str(path)] = f"read: {exc}"
            continue
        buckets.setdefault((sr, bps, ch), []).append((path, pcm))

    def finish(path: Path, pcm: np.ndarray, ch: int, bps: int,
               nbytes: int) -> None:
        result.bytes_out += nbytes
        result.encoded.append(out_paths[path])
        result.samples += pcm.shape[0]
        bin_ = pcm.shape[0] * ch * ((bps + 7) // 8)
        result.bytes_in += bin_
        manifest.record(path, out_paths[path], pcm.shape[0], bin_, nbytes)

    for (sr, bps, ch), files in buckets.items():
        eff_order = (min(max_lpc_order, 12) if sr <= 48_000
                     else max_lpc_order)
        if block_size < device_min_block_size(eff_order):
            # tiny blocks take the oracle route (see flacx_torch.pipeline)
            for path, pcm in files:
                with out_paths[path].open("wb") as f:
                    encode_to_file(
                        f, pcm, sample_rate=sr, bps=bps, channels=ch,
                        block_size=block_size, max_lpc_order=eff_order,
                        qlp_precision=qlp_precision,
                        partition_orders=partition_orders, device=dev,
                        oracle=True)
                    nbytes = f.tell()
                finish(path, pcm, ch, bps, nbytes)
            continue
        cfg = EncoderConfig(
            sample_rate=sr, bps=bps, channels=ch, block_size=block_size,
            max_lpc_order=eff_order,
            qlp_precision=qlp_precision, partition_orders=partition_orders,
            stereo=stereo, windows=windows)
        enc = BatchEncoder(cfg, batch_frames=batch_frames, device=dev,
                           sharding=sharding)

        # the global (file, frame) work list over FULL blocks, as one
        # planar array (≤ 16-bit content crosses to the device as int16)
        stage_dt = np.int16 if bps <= 16 else np.int32
        n_full = [pcm.shape[0] // block_size for _, pcm in files]
        planar = np.concatenate(
            [pcm[: k * block_size].reshape(k, block_size, ch)
             .transpose(0, 2, 1).astype(stage_dt)
             for k, (_, pcm) in zip(n_full, files)]
            + [np.zeros((0, ch, block_size), stage_dt)])
        index = np.concatenate([np.arange(k, dtype=np.int64)
                                for k in n_full] + [np.zeros(0, np.int64)])
        frames: list[bytes] = []
        pending = None
        for lo in range(0, len(index), batch_frames):
            hi = min(lo + batch_frames, len(index))
            launched = (enc.encode_batch_indexed(planar[lo:hi],
                                                 index[lo:hi]), hi - lo)
            # the next batch is launched before this one is read back
            if pending is not None:
                frames += enc._drain(*pending, None)
            pending = launched
        if pending is not None:
            frames += enc._drain(*pending, None)

        # ---- per-file assembly --------------------------------------------
        start = 0
        for k, (path, pcm) in zip(n_full, files):
            total = pcm.shape[0]
            tail = total - k * block_size
            with out_paths[path].open("wb") as f:
                writer = StreamWriter(f, sr, bps, ch, total, block_size)
                writer.add_pcm(pcm)
                writer.write_frames(frames[start:start + k])
                if tail:
                    writer.write_frame(_oracle_frame(
                        pcm[k * block_size:], k, bps, block_size,
                        cfg.max_lpc_order, qlp_precision, partition_orders))
                writer.finalize()
                nbytes = f.tell()
            start += k
            finish(path, pcm, ch, bps, nbytes)
    return result
