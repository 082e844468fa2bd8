"""The lpc_residual kernel's least time (every mode) over its device time
in the profiled window of an encode cell, in % (layer: kernels)."""

from portbench import readers


def read(record):
    return readers.roofline_pct(record, readers.ENCODE, (
        "lpc_residual_stats", "lpc_residual_zz", "lpc_residual_res"))
