"""Sample-axis (sequence) sharding with halo exchange.

The JAX package's ``parallel/seqshard.py``, function for function.  For
the codec's long blocks (16384 and 32768 samples, the hi-res
configuration) the sample axis itself is cut over devices: a
:class:`SeqMesh` is a 2-D grid, axes ``("frames", "seq")``; the leading
(frame) axis splits into ``n_data`` contiguous parts, one a mesh row, and
each part's sample axis into ``n_seq`` contiguous shards, one a device of
its row.  The statistics that couple samples (the autocorrelation, the
fixed and LPC predictors) need a few samples of the neighbouring shard: a
halo of ``max_lag`` samples ahead, or of 4 or ``t`` behind, whatever the
block size.

Every function runs in three steps, as ``shard_map`` does in the JAX
package:

1. **place**: each data part's shards go to their devices;
2. **halo exchange** (``ppermute``): a device takes, from the device that
   holds its neighbouring shard, just the halo samples (a copy between
   devices, a peer copy on distinct cards); shards that sit side by side
   on one device read their halos in place;
3. **shard-local work and reduction** (``psum`` / ``pmax``): the
   ``seqshard`` kernel (:mod:`flacx_torch.kernels.seqshard`) computes the
   partial sums of every shard a device holds in one launch; the partials
   move to the part's first device and add up in shard order there.

The result lands on the mesh's first device with the JAX package's shapes
and types.  A device may stand in a mesh more than once, as
``("cuda:0",) * 8`` on a one-card host or ``("cpu",) * 8`` in the tests:
a run of equal devices in a mesh row holds its shards side by side and
takes them in one launch.  On the CPU the kernel's plain versions do the
shard-local work.  Nothing is padded: a sample axis that ``n_seq`` does
not divide, a leading axis that ``n_data`` does not divide, or shards
shorter than the halo raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch

from flacx_torch.device import on_device
from flacx_torch.kernels.seqshard import (FIXED_HALO, seq_autocorr,
                                          seq_fixed, seq_lpc)
from flacx_torch.parallel.mesh import Mesh, data_mesh


@dataclass(frozen=True)
class SeqMesh:
    """A 2-D mesh, axes ``("frames", "seq")``: ``devices[i][j]`` holds shard
    ``j`` of data part ``i``."""
    devices: tuple[tuple[torch.device, ...], ...]
    axis_names: ClassVar[tuple[str, ...]] = ("frames", "seq")

    def __post_init__(self):
        rows = tuple(Mesh(tuple(r)).devices for r in self.devices)
        if not rows or len({len(r) for r in rows}) != 1:
            raise ValueError("a mesh's rows must be non-empty and of one "
                             "length")
        Mesh(tuple(d for r in rows for d in r))  # one device type
        object.__setattr__(self, "devices", rows)

    @property
    def shape(self) -> dict[str, int]:
        return {"frames": len(self.devices), "seq": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def grid(self, seq_axis: str, batch_axis: str | None,
             ) -> tuple[tuple[torch.device, ...], ...]:
        """The devices as ``[data part][shard]``: the mesh rows, or only
        the first where ``batch_axis`` is None (the leading axis is then
        not split, and every row would compute the same)."""
        if seq_axis != "seq" or batch_axis not in ("frames", None):
            raise ValueError(f"axes seq={seq_axis!r}, batch={batch_axis!r} "
                             f"of a mesh over {self.axis_names}")
        return self.devices if batch_axis is not None else self.devices[:1]


def seq_mesh(n_data: int, n_seq: int, *, devices=None) -> SeqMesh:
    """2-D mesh: ``n_data`` data parts × ``n_seq`` sample shards, over the
    first ``n_data * n_seq`` visible cards (raising when fewer are
    visible) or over an explicit ``devices`` list, in which a device may
    repeat."""
    want = n_data * n_seq
    if n_data < 1 or n_seq < 1:
        raise ValueError(f"a {n_data} x {n_seq} mesh")
    flat = data_mesh(want, devices=devices).devices
    return SeqMesh(tuple(flat[i * n_seq:(i + 1) * n_seq]
                         for i in range(n_data)))


def _runs(row: tuple[torch.device, ...]) -> list[tuple[torch.device, int,
                                                       int]]:
    """``(device, a, b)``: the runs of equal devices along a mesh row,
    shards ``a..b-1`` on ``device``."""
    out = []
    for j, dev in enumerate(row):
        if out and out[-1][0] == dev:
            out[-1] = (dev, out[-1][1], j + 1)
        else:
            out.append((dev, j, j + 1))
    return out


def _sharded(x: torch.Tensor, mesh: SeqMesh, seq_axis: str,
             batch_axis: str | None, width: int, ahead: bool, local_fn,
             reduce_fns, replicated=()) -> tuple:
    """Run ``local_fn(span, *replicated, n_seq=, halo=, shard0=, n=)`` on
    every run of shards, each run on its device, and fold each of its
    outputs (``[..., k, c]``, one row of partials a shard) over the shards
    with the matching ``reduce_fns`` entry on the part's first device;
    returns the folded outputs on the mesh's first device, the parts
    joined on the leading axis."""
    grid = mesh.grid(seq_axis, batch_axis)
    n_data, n_seq = len(grid), len(grid[0])
    if x.dim() < 2:
        raise ValueError(f"x of shape {tuple(x.shape)}: a leading axis and "
                         "a sample axis are needed")
    n = x.shape[-1]
    if n % n_seq:
        raise ValueError(f"{n_seq} shards do not divide {n} samples")
    local = n // n_seq
    if local < width:
        raise ValueError(f"shards of {local} samples are shorter than the "
                         f"halo of {width}")
    if x.shape[0] % n_data:
        raise ValueError(f"{n_data} data parts do not divide a leading "
                         f"axis of {x.shape[0]}")
    rows = x.shape[0] // n_data
    home = grid[0][0]
    parts = []
    for p, row in enumerate(grid):
        lo, hi = p * rows, (p + 1) * rows
        runs = _runs(row)
        # 1. place each run's shards (and the replicated inputs) on its
        # device
        spans = [x[lo:hi, ..., a * local:b * local].to(dev).contiguous()
                 for dev, a, b in runs]
        reps = [[r[lo:hi].to(dev).contiguous() for r in replicated]
                for dev, _, _ in runs]
        outs = []
        for i, (dev, a, b) in enumerate(runs):
            # 2. the halo from the device of the neighbouring run
            # (ppermute); none past the row's ends
            halo = None
            if ahead and i + 1 < len(runs):
                halo = spans[i + 1][..., :width].to(dev).contiguous()
            elif not ahead and i:
                prev = spans[i - 1]
                halo = prev[..., prev.shape[-1] - width:].to(dev).contiguous()
            # 3. every shard of the run in one launch
            with on_device(dev):
                outs.append(local_fn(spans[i], *reps[i], n_seq=b - a,
                                     halo=halo, shard0=a, n=n))
        # the fold over the shards on the part's first device, in shard
        # order (psum / pmax)
        parts.append([fold(torch.cat([o[k].to(row[0]) for o in outs],
                                     dim=-2)).to(home)
                      for k, fold in enumerate(reduce_fns)])
    return tuple(torch.cat(col, dim=0) for col in zip(*parts))


def _sum_shards(partials: torch.Tensor) -> torch.Tensor:
    """``[..., n_seq, c]`` summed over the shards, in shard order."""
    acc = partials[..., 0, :]
    for s in range(1, partials.shape[-2]):
        acc = acc + partials[..., s, :]
    return acc


def _max_shards(partials: torch.Tensor) -> torch.Tensor:
    return partials.amax(-2)


def autocorrelate_sharded(xw: torch.Tensor, max_lag: int, mesh: SeqMesh,
                          seq_axis: str = "seq",
                          batch_axis: str | None = "frames") -> torch.Tensor:
    """Autocorrelation over a sample-sharded batch.

    Args:
      xw: ``[..., n]`` windowed samples (f32 or f64), the leading axis
        split over ``batch_axis``, the last over ``seq_axis``.
      max_lag: lags ``0..max_lag`` (at most 32, at most a shard).
    Returns:
      ``[..., max_lag+1]`` f64 on the mesh's first device: the unsharded
      :func:`flacx_torch.ops.lpc.autocorrelate` (the last sample dropped)
      up to the order of the f64 sums.
    """
    def local(span, n_seq, halo, shard0, n):
        return (seq_autocorr(span, max_lag, n_seq, halo, shard0, n),)
    return _sharded(xw, mesh, seq_axis, batch_axis, max_lag, True, local,
                    (_sum_shards,))[0]


def fixed_order_zz_sums_sharded(x: torch.Tensor, mesh: SeqMesh,
                                seq_axis: str = "seq",
                                batch_axis: str | None = "frames",
                                ) -> torch.Tensor:
    """Sample-sharded zigzag sums of the five fixed-order residuals,
    ``[..., 5]`` int64: :func:`flacx_torch.ops.fixedpred.
    fixed_order_zz_sums` bit for bit (integer adds associate).  Each shard
    takes a 4-sample lookbehind halo; shard 0's zeros are the unsharded
    zero padding."""
    def local(span, n_seq, halo, shard0, n):
        return (seq_fixed(span, n_seq, halo, shard0),)
    return _sharded(x, mesh, seq_axis, batch_axis, FIXED_HALO, False, local,
                    (_sum_shards,))[0]


def lpc_zz_stats_sharded(x: torch.Tensor, taps: torch.Tensor,
                         shift: torch.Tensor, order: torch.Tensor,
                         mesh: SeqMesh, seq_axis: str = "seq",
                         batch_axis: str | None = "frames",
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample-sharded LPC residual selection statistics.

    Returns ``(zz_sum [...], maxabs [...])``, int64: the sum of
    ``(res << 1) ^ (res >> 63)`` and the max ``|res|``, unclamped, of
    ``res[i] = x[i] − (Σ_j taps_j·x[i−1−j] >> shift)`` masked to ``i ≥
    order`` (an int64 MAC), bit-identical to the unsharded residual's
    statistics.  Each shard takes a ``t``-sample lookbehind halo; the sums
    add over the shards and the max is their max.

    Args:
      x: int32 ``[..., n]``; taps int32 ``[..., t]`` (1 ≤ t ≤ 32);
        shift and order int32 ``[...]``.
    """
    t = taps.shape[-1]
    if t < 1:
        raise ValueError("lpc_zz_stats_sharded: no taps")

    def local(span, tp, sh, od, n_seq, halo, shard0, n):
        return tuple(v[..., None] for v in seq_lpc(span, tp, sh, od, n_seq,
                                                     halo, shard0))
    zz, maxabs = _sharded(x, mesh, seq_axis, batch_axis, t, False, local,
                          (_sum_shards, _max_shards), (taps, shift, order))
    return zz[..., 0], maxabs[..., 0]
