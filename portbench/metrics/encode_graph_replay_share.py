"""The share of the profiled window's batches that replayed a captured
CUDA graph of the encode pipeline: the program's counter
encode.graph_replays (flacx_torch.trace) over the window's batches; 1.0
where every batch replays (layer: encode pipeline).  None where the
program counts no replay: another entry, an eager encode, or a checkout
without the graphed encode."""

from portbench import readers


def read(record):
    batches = record.get("trace", {}).get("batches") or 0
    if record.get("entry") != readers.ENCODE or batches <= 0:
        return None
    try:
        from flacx_torch import trace
    except ImportError:
        return None
    replays = trace.snapshot()["counters"].get("encode.graph_replays", 0)
    if not replays:
        return None
    return replays / batches
