"""Host ms a batch in _encode_batch's analysis: virtual channels, wasted
bits, the analysis kernel, Levinson and quantization of every order, the
window merge, the fixed estimates. Read from the program's own span
encode.analysis (flacx_torch.trace) over the profiled window, whose host
times carry torch.profiler's CPU activity cost: compare with the other
stages, or with this metric in another commit, not with
encode_enqueue_ms (layer: encode pipeline)."""

from portbench import program


def read(record):
    return program.encode_span_ms(record, "encode.analysis")
