"""Device meshes and frame shardings.

A :class:`Mesh` is a 1-D list of torch devices along the ``frames`` axis.
:func:`frame_sharding` splits a batch's leading frame axis into
contiguous parts, one a device of the mesh, in mesh order; every part runs
the whole pipeline on its own device (frames are self-contained, so no
part waits on another).  The same device may stand in a mesh more than
once, as ``("cuda:0", "cuda:0")`` on a one-card host or ``("cpu", "cpu")``
in the tests: the split, the launches and the assembly are those of a
mesh of distinct cards.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch

from flacx_torch.device import resolve_device


def _pinned(dev: torch.device) -> torch.device:
    """``dev`` as a mesh holds it: a bare ``cuda`` is the current card, and
    the CPU has no index."""
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over ``devices`` (names or torch devices, all of one
    type), axis ``frames``."""
    devices: tuple[torch.device, ...]
    axis_names: ClassVar[tuple[str, ...]] = ("frames",)

    def __post_init__(self):
        devs = tuple(_pinned(resolve_device(d)) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"mesh devices of mixed types: {devs}")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    def home(self, device: str | torch.device) -> torch.device:
        """The mesh's first device, after checking that ``device`` (the
        caller's ``device=``) names the mesh's device type and, with an
        index, one of its devices; a conflict raises."""
        dev = resolve_device(device)
        first = self.devices[0]
        if dev.type != first.type or (dev.type == "cuda"
                                      and dev.index is not None
                                      and dev not in self.devices):
            raise ValueError(f"device {str(dev)!r} conflicts with the mesh "
                             f"{[str(d) for d in self.devices]}")
        return first


def home_device(device: str | torch.device, sharding) -> torch.device:
    """An entry point's device: ``device``, or under ``sharding`` its
    mesh's first device (``device`` must name the mesh's device type)."""
    return (resolve_device(device) if sharding is None
            else sharding.mesh.home(device))


def data_mesh(n_devices: int | None = None, *,
              devices=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` CUDA cards (every visible
    one by default), or over an explicit ``devices`` list.  Raises when
    fewer cards are visible than asked for, rather than shrink."""
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        want = visible if n_devices is None else n_devices
        if want < 1 or want > visible:
            raise RuntimeError(f"flacx_torch: a mesh of {want} CUDA devices "
                               f"asked for, {visible} visible")
        devices = [f"cuda:{i}" for i in range(want)]
    elif n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"{n_devices} devices asked for, "
                             f"{len(devices)} given")
        devices = list(devices)[:n_devices]
    return Mesh(devices)


@dataclass(frozen=True)
class FrameSharding:
    """The leading (frame) axis split over ``mesh`` in contiguous parts."""
    mesh: Mesh

    def __post_init__(self):
        if not isinstance(self.mesh, Mesh):
            raise TypeError(
                f"sharding= takes a Mesh of this process's devices, not a "
                f"{type(self.mesh).__name__}: one process cannot launch on "
                f"another process's card (a process-spanning mesh's "
                f".local is this process's Mesh)")

    def divides(self, frames: int) -> bool:
        return frames % self.mesh.size == 0

    def parts(self, frames: int) -> list[tuple[torch.device, int, int]]:
        """``(device, lo, hi)`` of each non-empty part of a batch of
        ``frames`` frames, in frame order: parts differ by at most one
        frame, the larger ones first."""
        q, r = divmod(frames, self.mesh.size)
        out, lo = [], 0
        for i, dev in enumerate(self.mesh.devices):
            hi = lo + q + (1 if i < r else 0)
            if hi > lo:
                out.append((dev, lo, hi))
            lo = hi
        return out


@dataclass(frozen=True)
class Replicated:
    """Every device of ``mesh`` holds the whole tensor."""
    mesh: Mesh

    def place(self, t: torch.Tensor) -> list[torch.Tensor]:
        return [t.to(d) for d in self.mesh.devices]


def frame_sharding(mesh: Mesh) -> FrameSharding:
    """Shard the leading (frame batch) axis across the mesh."""
    return FrameSharding(mesh)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)
