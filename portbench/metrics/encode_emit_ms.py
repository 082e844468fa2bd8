"""Host ms a batch in _encode_batch's emission: frame headers, the symbols
and frame_pack. Read from the program's own span encode.emit
(flacx_torch.trace) over the profiled window, whose host times carry
torch.profiler's CPU activity cost: compare with the other stages, or
with this metric in another commit, not with encode_enqueue_ms (layer:
encode pipeline)."""

from portbench import program


def read(record):
    return program.encode_span_ms(record, "encode.emit")
