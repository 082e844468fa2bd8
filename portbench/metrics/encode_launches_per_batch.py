"""Device kernel launches of the profiled window (hand and plain-torch
kernels, no copies) over its batches (layer: encode pipeline)."""

from portbench import readers


def read(record):
    return readers.launches_per_unit(record, readers.ENCODE)
