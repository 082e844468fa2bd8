"""Host ms a decode batch spent in the frame scan (_scan_frame_offsets),
the native walker (scan_frames) and row staging (scatter_rows), the
window's totals over its batches (layer: decode entry and host)."""

from portbench import readers


def read(record):
    return readers.span_ms(record, readers.DECODE,
                           ("frame_scan", "walker", "row_staging"),
                           "batches")
