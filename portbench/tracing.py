"""Spans wrapped around the program's functions from outside, and the
reduction of a profiler trace to intervals.

:class:`Spans` replaces a module's or a class's attribute with a wrapper
that records each call's host interval under a name (and, inside a
profiled window, a ``torch.profiler.record_function`` range of the same
name, ``portbench.<name>``), and puts every original back on
:meth:`Spans.restore`.  No span is added inside the program.
"""

from __future__ import annotations

import functools
import time

import numpy as np

PREFIX = "portbench."


class Spans:
    def __init__(self):
        self.times: dict[str, list] = {}
        self.ranges = None           # torch.profiler.record_function
        self._originals = []

    def wrap(self, owner, attr: str, name: str) -> None:
        fn = getattr(owner, attr)
        self._originals.append((owner, attr, fn))
        times = self.times.setdefault(name, [])

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            ranges = self.ranges
            t0 = time.perf_counter()
            try:
                if ranges is None:
                    return fn(*args, **kwargs)
                with ranges(PREFIX + name):
                    return fn(*args, **kwargs)
            finally:
                times.append((t0, time.perf_counter()))
        setattr(owner, attr, wrapped)

    def clear(self) -> None:
        for v in self.times.values():
            v.clear()

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._originals):
            setattr(owner, attr, fn)
        self._originals.clear()


def _ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{what}_us")() * 1000)


def profile_events(prof) -> dict:
    """From a finished ``torch.profiler.profile``: the device's kernel
    intervals ``[(name, start_ns, end_ns)]``, its copy and memset
    intervals, and the ``portbench.`` ranges by name, on one clock."""
    kernels, copies, ranges = [], [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        if name.startswith(PREFIX):
            # a range's host side; its device-side echo is no device work
            if "CUDA" not in str(e.device_type()):
                ranges.setdefault(name[len(PREFIX):], []).append((start,
                                                                  end))
        elif "CUDA" in str(e.device_type()):
            low = name.lower()
            if low.startswith("memcpy") or low.startswith("memset"):
                copies.append((name, start, end))
            else:
                kernels.append((name, start, end))
    return {"kernels": kernels, "copies": copies, "ranges": ranges}


def union(intervals, lo: int, hi: int) -> list:
    """Merged ``[(start, end)]`` of ``intervals``, clipped to
    ``[lo, hi]``."""
    out = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(busy: list, lo: int, hi: int) -> list:
    """The gaps ``[(start, end)]`` of ``[lo, hi]`` that ``busy`` (merged)
    leaves."""
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def attribute(gaps: list, ranges: dict, skip=("window",)) -> dict:
    """Seconds of ``gaps`` by the innermost host range open at each gap's
    middle (``"other"`` where none is), the shortest range being the
    innermost."""
    if not gaps:
        return {}
    g = np.asarray(gaps, np.int64)
    mid = (g[:, 0] + g[:, 1]) // 2
    names = ["other"]
    best = np.full(len(g), np.iinfo(np.int64).max)
    who = np.zeros(len(g), np.int64)
    for name, iv in ranges.items():
        if name in skip or not iv:
            continue
        s = np.asarray(sorted(iv), np.int64)
        at = np.searchsorted(s[:, 0], mid, side="right") - 1
        ok = at >= 0
        span = s[np.maximum(at, 0)]
        ok &= span[:, 1] >= mid
        dur = span[:, 1] - span[:, 0]
        take = ok & (dur < best)
        names.append(name)
        best = np.where(take, dur, best)
        who = np.where(take, len(names) - 1, who)
    secs = np.bincount(who, weights=(g[:, 1] - g[:, 0]) / 1e9,
                       minlength=len(names))
    return {names[i]: float(secs[i]) for i in range(len(names)) if secs[i]}
