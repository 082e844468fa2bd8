"""Host ms a batch in the program's span encode.replay
(flacx_torch.trace): the graphed encode's index write, CUDA graph replay
and output copies, over the profiled window's batches, whose host times
carry torch.profiler's CPU activity cost (layer: encode pipeline).  None
where the program records no such span: another entry, an eager encode,
or a checkout without the graphed encode."""

from portbench import readers


def read(record):
    batches = record.get("trace", {}).get("batches") or 0
    if record.get("entry") != readers.ENCODE or batches <= 0:
        return None
    try:
        from flacx_torch import trace
    except ImportError:
        return None
    spans = trace.snapshot()["spans"].get("encode.replay")
    if not spans:
        return None
    return sum(end - start for start, end in spans) / 1e6 / batches
