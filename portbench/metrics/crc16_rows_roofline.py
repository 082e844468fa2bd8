"""The crc16_rows kernel's least time over its device time in the profiled
window of a decode cell, in % (layer: kernels)."""

from portbench import readers


def read(record):
    return readers.roofline_pct(record, readers.DECODE, ("crc16_rows",))
