"""Arithmetic shared by the per-layer metric readers
(``portbench/metrics/<name>.py``).

A reader takes the run's record and returns a number, or None where the
cell gives it nothing to read.  The record holds ``entry`` (the traffic's
entry), ``window`` (the measured window: ``seconds``, ``units`` done,
``unit_s`` each unit's host seconds, ``batches``), ``spans`` (host
intervals of the wrapped program functions over that window, by name)
and ``trace`` (the profiled window: ``window_s``, ``busy_s``,
``launches``, ``kernel_s`` device seconds by kernel name, ``units``,
``batches``, ``bounds`` the least seconds of its hand-kernel calls by
wrapper, from :mod:`portbench.roofline`).
"""

from __future__ import annotations

import statistics

from portbench import roofline

ENCODE = "encode_frame_stream"
DECODE = "decode_array"


def p95_ms(record: dict, entry: str):
    if record["entry"] != entry or len(record["window"]["unit_s"]) < 2:
        return None
    return statistics.quantiles(record["window"]["unit_s"], n=20)[-1] * 1e3


def span_ms(record: dict, entry: str, names, per: str = "units"):
    """Host ms inside the spans ``names`` a unit (or ``batches``) of the
    measured window."""
    if record["entry"] != entry or not record["window"].get(per):
        return None
    total = sum(b - a for n in names for a, b in record["spans"].get(n, ()))
    return total * 1e3 / record["window"][per]


def roofline_pct(record: dict, entry: str, wrappers):
    """Σ least seconds over Σ device seconds of the wrappers' kernels in
    the profiled window, in %."""
    if record["entry"] != entry:
        return None
    t = record["trace"]
    spent = sum(s for name, s in t["kernel_s"].items()
                if roofline.is_hand_kernel(name, wrappers))
    bound = sum(t["bounds"].get(w, 0.0) for w in wrappers)
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent


def idle_pct(record: dict, entry: str):
    t = record["trace"]
    if record["entry"] != entry or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def launches_per_unit(record: dict, entry: str):
    t = record["trace"]
    if record["entry"] != entry or not t["launches"] or not t["units"]:
        return None
    return t["launches"] / t["units"]
