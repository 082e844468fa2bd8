"""Host ms a batch inside BatchEncoder._drain (fetch and cut of the frame
bytes), the window's total over its batches (layer: encode entry)."""

from portbench import readers


def read(record):
    return readers.span_ms(record, readers.ENCODE, ("drain",))
