"""95th percentile of the host ms from when encode_frame_stream pulls a
batch to when it yields the batch's last frame, over every batch of the
window (layer: encode entry)."""

from portbench import readers


def read(record):
    return readers.p95_ms(record, readers.ENCODE)
