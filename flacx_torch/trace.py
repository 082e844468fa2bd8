"""The port's own spans and counters.

``span(name)`` times a piece of host work and ``count(name, k)`` adds to
a counter, both only while tracing is on: inside :func:`recording`, or
while a ``torch.profiler`` session records.  Off, ``span`` hands back one
shared no-op context and reads no clock, and ``count`` returns at once.

Spans are stamped with ``time.time_ns()``, the clock the profiler stamps
its events with, so a span lies on a device trace's time axis; no
profiler range is emitted, so the device trace holds no echo of them.
:func:`snapshot` returns what was recorded since :func:`reset`::

    {"spans": {name: [(start_ns, end_ns), ...]}, "counters": {name: n}}

Names are dotted by layer (``encode.analysis``, ``decode.walk``,
``copy.h2d_bytes``, ``launch.<kernel>``); the places that record them
say what each covers.  Spans of one layer do not nest, so their sums add
up.
"""

from __future__ import annotations

import contextlib
import time

import torch

_OFF = contextlib.nullcontext()
_spans: dict[str, list] = {}
_counters: dict[str, int] = {}
_depth = 0


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


def enabled() -> bool:
    """Whether spans and counters record now."""
    return _depth > 0 or _profiling()


class _Span:
    __slots__ = ("times", "start")

    def __init__(self, times: list):
        self.times = times

    def __enter__(self):
        self.start = time.time_ns()

    def __exit__(self, *exc):
        self.times.append((self.start, time.time_ns()))


def span(name: str):
    """A context that records its host interval under ``name`` when
    tracing is on."""
    if _depth <= 0 and not _profiling():
        return _OFF
    times = _spans.get(name)
    if times is None:
        times = _spans[name] = []
    return _Span(times)


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to counter ``name`` when tracing is on."""
    if _depth > 0 or _profiling():
        _counters[name] = _counters.get(name, 0) + int(k)


@contextlib.contextmanager
def recording():
    """Turn tracing on inside the block (without a profiler)."""
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


def snapshot() -> dict:
    """Copies of every span and counter recorded since :func:`reset`."""
    return {"spans": {k: list(v) for k, v in _spans.items()},
            "counters": dict(_counters)}


def reset() -> None:
    """Forget every span and counter recorded."""
    _spans.clear()
    _counters.clear()
