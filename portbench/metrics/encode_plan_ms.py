"""Host ms a batch in _encode_batch's chosen residual and its Rice plan
(residual_zz, rice_stats, exact_plan) and the final subframe kind. Read
from the program's own span encode.plan (flacx_torch.trace) over the
profiled window, whose host times carry torch.profiler's CPU activity
cost: compare with the other stages, or with this metric in another
commit, not with encode_enqueue_ms (layer: encode pipeline)."""

from portbench import program


def read(record):
    return program.encode_span_ms(record, "encode.plan")
