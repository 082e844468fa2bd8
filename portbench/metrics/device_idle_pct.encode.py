"""Share of the profiled window in which no kernel or copy ran on the
card, in % (layer: device)."""

from portbench import readers


def read(record):
    return readers.idle_pct(record, readers.ENCODE)
