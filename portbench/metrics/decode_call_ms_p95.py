"""95th percentile of the host ms of a decode_array call, over every call
of the window (layer: decode entry and host)."""

from portbench import readers


def read(record):
    return readers.p95_ms(record, readers.DECODE)
