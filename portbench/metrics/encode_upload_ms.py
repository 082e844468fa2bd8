"""Host ms a batch in BatchEncoder._run's upload of the batch's PCM
(the pageable H2D copy). Read from the program's own
span encode.upload (flacx_torch.trace) over the profiled window, whose
host times carry torch.profiler's CPU activity cost: compare with the
other stages, or with this metric in another commit, not with
encode_enqueue_ms (layer: encode entry)."""

from portbench import program


def read(record):
    return program.encode_span_ms(record, "encode.upload")
