"""Multi-process scale-out on ``torch.distributed``.

The JAX package's ``parallel/distributed.py``, function for function.
The codec's frames are independent, so the multi-process design has
three thin layers:

1. **Process bootstrap**: :func:`init_distributed` joins a process group
   (one call per process, before any encode) and names this process's
   devices.
2. **Global mesh**: :func:`global_data_mesh` gathers every process's
   devices in rank order.  One eager process cannot launch on another
   process's card, so the process-spanning object is a description
   (:class:`GlobalDataMesh`); what ``sharding=`` takes is its ``local``
   mesh.
3. **Corpus partitioning**: :func:`shard_corpus` stripes the files over
   the processes; each runs the ordinary corpus encoder on its stripe
   (:func:`encode_corpus_distributed`), writing its own manifest shard,
   and the only global communication is a sum of five scalars
   (:func:`allreduce_stats`).

**Backend: gloo.**  No device tensor crosses a process: the codec's whole
cross-process traffic is those scalars (a float64 CPU tensor) and the
device lists (Python objects).  gloo carries both on every host, with or
without a card, and lets several processes share one card; NCCL reduces
only device tensors and refuses two ranks on one card ("Duplicate GPU
detected").
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Sequence

import torch
import torch.distributed as dist

from flacx_torch.device import resolve_device
from flacx_torch.parallel.mesh import Mesh, data_mesh

#: this process's devices, as :func:`init_distributed` named them
_local: tuple[torch.device, ...] | None = None


def _from_env(value, what: str, *names: str):
    """``value``, else the environment variables ``names`` joined by
    ``:``; raises where neither gives it."""
    if value is not None:
        return value
    missing = [k for k in names if k not in os.environ]
    if missing:
        raise ValueError(f"init_distributed: {what} not given and "
                         f"{', '.join('$' + k for k in missing)} not set")
    return ":".join(os.environ[k] for k in names)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids: Sequence[int] | None = None,
                     device: str | torch.device = "cuda",
                     ) -> tuple[int, int]:
    """Join (or bootstrap) a process group of ``num_processes`` processes
    over TCP at ``coordinator_address`` (``host:port``, the rank-0
    process's); returns ``(rank, world_size)``.

    Call once per process, before any encode.  An argument left None is
    taken from the environment ``torchrun`` sets (``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); where neither gives it,
    this raises.  ``local_device_ids`` names this process's cards: by
    default ``LOCAL_RANK``'s card under ``torchrun``, else every visible
    card.  ``device="cpu"`` makes the process's one device the CPU; a
    ``cuda`` device without CUDA raises.
    """
    global _local
    dev = resolve_device(device)
    address = _from_env(coordinator_address, "coordinator_address",
                        "MASTER_ADDR", "MASTER_PORT")
    world = int(_from_env(num_processes, "num_processes", "WORLD_SIZE"))
    rank = int(_from_env(process_id, "process_id", "RANK"))
    if dev.type == "cpu":
        local = (torch.device("cpu"),)
    else:
        if local_device_ids is None and "LOCAL_RANK" in os.environ:
            local_device_ids = [int(os.environ["LOCAL_RANK"])]
        local = (data_mesh().devices if local_device_ids is None else
                 Mesh(tuple(f"cuda:{i}" for i in local_device_ids)).devices)
        torch.cuda.set_device(local[0])
    dist.init_process_group("gloo", init_method=f"tcp://{address}",
                            world_size=world, rank=rank)
    _local = local
    return dist.get_rank(), dist.get_world_size()


def _live() -> tuple[int, int]:
    """``(rank, world size)`` of the live process group, ``(0, 1)``
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass(frozen=True)
class GlobalDataMesh:
    """Every device of every process, in rank order: ``devices`` holds
    ``(rank, device)`` pairs; ``local`` is this process's
    :class:`~flacx_torch.parallel.mesh.Mesh`, the one ``sharding=``
    takes."""
    devices: tuple[tuple[int, torch.device], ...]
    local: Mesh

    @property
    def size(self) -> int:
        return len(self.devices)


def global_data_mesh() -> GlobalDataMesh:
    """The 1-D ``frames`` mesh over every device of every process (this
    process's: those :func:`init_distributed` named, else every visible
    card)."""
    mine = [str(d) for d in (_local or data_mesh().devices)]
    rank, world = _live()
    gathered = [mine]
    if world > 1:
        gathered = [None] * world
        dist.all_gather_object(gathered, mine)
    return GlobalDataMesh(tuple((r, torch.device(d))
                                for r, devs in enumerate(gathered)
                                for d in devs), Mesh(tuple(mine)))


def shard_corpus(paths: Iterable[Path | str],
                 process_index: int | None = None,
                 process_count: int | None = None) -> list[Path]:
    """This process's stripe of a corpus: every process sorts the same
    paths and takes the indices ``i ≡ process_index (mod
    process_count)``, so the stripes are disjoint and their union is the
    corpus.  Defaults to the live rank and world size."""
    if process_index is None or process_count is None:
        process_index, process_count = _live()
    ordered = sorted(Path(p) for p in paths)
    return [p for i, p in enumerate(ordered)
            if i % process_count == process_index]


def encode_corpus_distributed(paths: Iterable[Path | str],
                              out_dir: Path | str, **encode_kwargs):
    """The corpus encode across every process of the group: each encodes
    its :func:`shard_corpus` stripe with
    :func:`flacx_torch.parallel.corpus.encode_corpus` (``device=``,
    ``sharding=`` and the rest pass through ``encode_kwargs``; the device
    defaults to this process's first), writing its own manifest shard
    (``.p<rank>`` in a group of several) so that resume needs no
    cross-process writes; then the stats are summed over the group.
    Returns ``(local_result, global_stats)``."""
    from flacx_torch.parallel.corpus import encode_corpus

    rank, world = _live()
    mine = shard_corpus(paths)
    encode_kwargs.setdefault("manifest_suffix",
                             f".p{rank}" if world > 1 else "")
    if _local is not None and encode_kwargs.get("sharding") is None:
        encode_kwargs.setdefault("device", _local[0])
    result = encode_corpus(mine, out_dir, **encode_kwargs)
    totals = allreduce_stats({
        "files": len(result.encoded), "failed": len(result.failed),
        "samples": result.samples, "bytes_in": result.bytes_in,
        "bytes_out": result.bytes_out,
    })
    return result, totals


def allreduce_stats(values: dict[str, float | int]) -> dict[str, float]:
    """The sum over every process of scalar per-process stats, as floats:
    one ``all_reduce`` of a float64 CPU tensor over the sorted keys (every
    value an integer below 2^53, or a float).  Without a group, or in a
    group of one, the inputs as floats."""
    if _live()[1] == 1:
        return {k: float(v) for k, v in values.items()}
    keys = sorted(values)
    t = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return dict(zip(keys, t.tolist()))
