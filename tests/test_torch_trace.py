"""flacx_torch's own spans and counters (``flacx_torch.trace``) on the CPU.

Off, nothing is recorded and a span reads no clock; ``recording()`` and a
profiler session each turn it on, and ``reset()`` clears it.  A span's
stamps share the profiler's clock.  The encoder records each of its
stages once a batch, the drain's fetches and cut, and its copies' bytes
as the shapes give them; the decoder records its frame scan (and counts
the scan's ambiguity walk on a stream with a planted false sync), row
staging, walker, uploads, the kernels' enqueue and fetches.
"""

import io

import numpy as np
import pytest
import torch

from flacx_torch import decoder, trace
from flacx_torch.crc import crc16
from flacx_torch.encoder import BatchEncoder, EncoderConfig
from flacx_torch.pipeline import encode_to_file

from conftest import make_pcm

torch.set_num_threads(1)

ENCODE_SPANS = ("encode.upload", "encode.analysis", "encode.select",
                "encode.plan", "encode.emit", "encode.fetch", "encode.cut")
N, B = 1152, 4


@pytest.fixture(autouse=True)
def fresh():
    trace.reset()
    yield
    trace.reset()


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    assert not trace.enabled()

    def no_clock():
        raise AssertionError("a span read the clock while off")
    monkeypatch.setattr(trace.time, "time_ns", no_clock)
    first = trace.span("x")
    with first:
        trace.count("c", 3)
    assert trace.span("y") is first
    assert trace.snapshot() == {"spans": {}, "counters": {}}


def test_recording_and_profiler_each_record_and_reset_clears():
    with trace.recording():
        assert trace.enabled()
        with trace.span("a"):
            pass
        trace.count("c")
        trace.count("c", 4)
    assert not trace.enabled()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert trace.enabled()
        with trace.span("a"):
            pass
        trace.count("c", 2)
    snap = trace.snapshot()
    assert len(snap["spans"]["a"]) == 2 and snap["counters"] == {"c": 7}
    s, e = snap["spans"]["a"][0]
    assert 0 < s <= e
    snap["spans"]["a"].clear()                 # a copy
    assert len(trace.snapshot()["spans"]["a"]) == 2
    trace.reset()
    assert trace.snapshot() == {"spans": {}, "counters": {}}


def test_spans_share_the_profilers_clock():
    """A span inside a ``record_function`` range lies within the range's
    interval in the profiler's events, to 20 us."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with torch.profiler.record_function(f"clock_probe_{i}"):
                with trace.span("probe"):
                    torch.ones(64).sum()
    spans = trace.snapshot()["spans"]["probe"]
    ranges = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("clock_probe_"):
            start = ev.start_ns()
            ranges[int(ev.name()[12:])] = (start, start + ev.duration_ns())
    assert sorted(ranges) == list(range(5))
    slack = 20_000
    for i, (s, e) in enumerate(spans):
        lo, hi = ranges[i]
        assert lo - slack <= s <= e <= hi + slack, (i, s - lo, hi - e)


def blocks(seed: int, frames: int) -> np.ndarray:
    pcm = make_pcm(np.random.default_rng(seed), frames * N, 2, 16)
    return np.ascontiguousarray(
        pcm.reshape(frames, N, 2).transpose(0, 2, 1)).astype(np.int16)


@pytest.mark.parametrize("with_stats", [False, True])
def test_encoder_records_each_stage_once_a_batch(with_stats):
    enc = BatchEncoder(EncoderConfig(block_size=N, max_lpc_order=8),
                       batch_frames=B, device="cpu")
    batches = [blocks(s, B) for s in range(3)]
    stats = {} if with_stats else None
    with trace.recording():
        frames = list(enc.encode_frame_stream(batches, 0, stats))
    snap = trace.snapshot()
    counts = {k: len(v) for k, v in snap["spans"].items()}
    fetches = 4 if with_stats else 2     # lengths, bytes (+ histograms)
    assert counts == {**{k: len(batches) for k in ENCODE_SPANS},
                      "encode.fetch": fetches * len(batches)}
    for times in snap["spans"].values():
        assert all(s <= e for s, e in times)
    assert len(frames) == B * len(batches)
    h2d = sum(b.nbytes for b in batches)
    widths = [max(map(len, frames[i:i + B]))
              for i in range(0, len(frames), B)]
    d2h = sum(4 * B + B * w + (4 * B * 2 + 4 * B if with_stats else 0)
              for w in widths)
    assert snap["counters"] == {"copy.h2d_bytes": h2d,
                                "copy.d2h_bytes": d2h}


def test_encoder_spans_do_not_nest():
    """Each piece of host time falls under at most one span."""
    enc = BatchEncoder(EncoderConfig(block_size=N, max_lpc_order=8),
                       batch_frames=B, device="cpu")
    with trace.recording():
        list(enc.encode_frame_stream([blocks(7, B), blocks(8, B)], 0, {}))
    spans = sorted(iv for times in trace.snapshot()["spans"].values()
                   for iv in times)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def stream(seed: int, frames: int) -> bytes:
    pcm = make_pcm(np.random.default_rng(seed), frames * N, 2, 16)
    f = io.BytesIO()
    encode_to_file(f, pcm, sample_rate=44100, bps=16, channels=2,
                   block_size=N, max_lpc_order=8, qlp_precision=12,
                   partition_orders=tuple(range(5)), device="cpu")
    return f.getvalue()


def planted_false_sync(data: bytes) -> bytes:
    """``data`` with frame 3's header (sync to CRC-8) copied into frame
    2's body, frame 2's CRC-16 fixed up: a false sync candidate whose
    coded number collides with a real one."""
    first = decoder.parse_stream_header(data)[1]
    offs = decoder.scan_frame_offsets(data, first)
    b = bytearray(data)
    b[offs[2] + 100:offs[2] + 107] = b[offs[3]:offs[3] + 7]
    b[offs[3] - 2:offs[3]] = crc16(bytes(b[offs[2]:offs[3] - 2])) \
        .to_bytes(2, "big")
    return bytes(b)


def test_decoder_records_its_stages_and_the_scans_ambiguity_walk():
    data = stream(11, 6)
    with trace.recording():
        _, clean = decoder.decode_array(data, batch_frames=4, device="cpu")
    snap = trace.snapshot()
    assert {k: len(v) for k, v in snap["spans"].items()} == {
        "decode.scan": 1, "decode.stage_rows": 2, "decode.walk": 2,
        "decode.upload": 6, "decode.enqueue": 2, "decode.fetch": 4}
    assert "decode.scan_ambiguous" not in snap["counters"]
    assert snap["counters"]["copy.d2h_bytes"] >= clean.nbytes
    assert snap["counters"]["copy.h2d_bytes"] > 0

    trace.reset()
    planted = planted_false_sync(data)
    first = decoder.parse_stream_header(planted)[1]
    with trace.recording():
        offsets, _ = decoder._scan_frame_offsets(planted, first)
    assert np.array_equal(offsets,
                          decoder.scan_frame_offsets(data, first))
    assert trace.snapshot()["counters"] == {"decode.scan_ambiguous": 1}
