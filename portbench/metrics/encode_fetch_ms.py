"""Host ms a batch in BatchEncoder._drain's fetches: blocked on the device
(on the graphed path behind the next batch's replay) and the D2H copies.
Read from the program's own span encode.fetch (flacx_torch.trace) over
the profiled window, whose host times carry torch.profiler's CPU activity
cost: compare with the other stages, or with this metric in another
commit (layer: encode entry)."""

from portbench import program


def read(record):
    return program.encode_span_ms(record, "encode.fetch")
