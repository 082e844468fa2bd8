"""The frame_pack kernel's least time over its device time in the profiled
window of an encode cell, in % (layer: kernels)."""

from portbench import readers


def read(record):
    return readers.roofline_pct(record, readers.ENCODE, ("frame_pack",))
