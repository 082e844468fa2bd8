"""The rice_stats kernel's least time over its device time in the profiled
window of an encode cell, in % (layer: kernels)."""

from portbench import readers


def read(record):
    return readers.roofline_pct(record, readers.ENCODE, ("rice_stats",))
