"""Readers of what ``flacx_torch`` records itself: its spans and counters
(``flacx_torch.trace``), shared by the per-layer metrics that read them.

The program records only while a profiler session runs (or inside its
``trace.recording()``), and ``run.py`` runs a profiler only over the
profiled window of a ``--trace 1`` run: set-up and the timed window run
without one, and the kernel bounds are counted after it.  So in a run of
``run.py`` the program's registry holds exactly the profiled window, and
a reader divides by that window's batches (``record["trace"]
["batches"]``).  Its host times are taken under ``torch.profiler``'s CPU
activity, which adds host cost to every op: compare a stage with the
other stages, or with the same metric in another commit.

Each reader returns None, and never raises, where there is nothing to
read: another entry than the encode's, a program without
``flacx_torch.trace`` (an older checkout), or a registry that does not
match the window (its count of ``encode.cut`` spans is not the window's
batches: ``BatchEncoder._drain`` enters it once a batch, whether the
batch ran eagerly or replayed a captured graph, and the window drains
every batch it pulls).
"""

from __future__ import annotations

from portbench import readers


def _encode_snapshot(record: dict):
    """The program's registry and the profiled window's batches, or
    ``(None, 0)`` where the record gives nothing to read."""
    batches = record.get("trace", {}).get("batches") or 0
    if record.get("entry") != readers.ENCODE or batches <= 0:
        return None, 0
    try:
        from flacx_torch import trace
    except ImportError:
        return None, 0
    snap = trace.snapshot()
    if len(snap["spans"].get("encode.cut", ())) != batches:
        return None, 0
    return snap, batches


def encode_span_ms(record: dict, name: str):
    """Host ms a batch inside the program's span ``name``."""
    snap, batches = _encode_snapshot(record)
    if snap is None:
        return None
    total = sum(e - s for s, e in snap["spans"].get(name, ()))
    return total / 1e6 / batches


def encode_counter_per_batch(record: dict, names):
    """The program's counters ``names`` summed, a batch."""
    snap, batches = _encode_snapshot(record)
    if snap is None:
        return None
    return sum(snap["counters"].get(n, 0) for n in names) / batches
