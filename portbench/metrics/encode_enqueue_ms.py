"""Host ms a batch inside encoder._encode_batch (the pipeline's enqueue),
the window's total over its batches (layer: encode pipeline)."""

from portbench import readers


def read(record):
    return readers.span_ms(record, readers.ENCODE, ("encode_batch",))
