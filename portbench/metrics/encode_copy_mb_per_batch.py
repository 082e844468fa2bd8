"""MB a batch copied between host and device: the program's counters
copy.h2d_bytes (the batch's PCM) and copy.d2h_bytes (lengths, frame
bytes, the histograms' kinds and channel codes) over the profiled
window, in 1e6 bytes (layer: encode entry)."""

from portbench import program


def read(record):
    v = program.encode_counter_per_batch(
        record, ("copy.h2d_bytes", "copy.d2h_bytes"))
    return None if v is None else v / 1e6
