"""Host ms a batch in the rest of BatchEncoder._drain: rows cut into frame
bytes and the histograms. Read from the program's own span encode.cut
(flacx_torch.trace) over the profiled window, whose host times carry
torch.profiler's CPU activity cost: compare with the other stages, or
with this metric in another commit (layer: encode entry)."""

from portbench import program


def read(record):
    return program.encode_span_ms(record, "encode.cut")
