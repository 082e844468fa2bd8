"""The decode path's hand kernels' least time over their device time in
the profiled window, in % (layer: kernels)."""

from portbench import readers


def read(record):
    return readers.roofline_pct(record, readers.DECODE,
                                readers.roofline.DECODE)
