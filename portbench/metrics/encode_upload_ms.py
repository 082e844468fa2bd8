"""Host ms a batch in the upload of the batch's PCM (the pageable H2D
copy, encoder._upload), on the eager and the graphed path alike. Read
from the program's own span encode.upload (flacx_torch.trace) over the
profiled window, whose host times carry torch.profiler's CPU activity
cost: compare with the other stages, or with this metric in another
commit (layer: encode entry)."""

from portbench import program


def read(record):
    return program.encode_span_ms(record, "encode.upload")
