"""The graphed encode: ``BatchEncoder.encode_frame_stream`` replays
``_encode_batch`` as one captured CUDA graph a batch on the card.

On the CPU: the frame index as a device scalar (the graph's input) gives
the coded numbers of the int route; the per-configuration constants are
built once; the CPU's stream stays eager, records its four stage spans
once a batch and no replay; and, with a stand-in for the graph that runs
the pipeline eagerly, a stream captures only where another batch of its
shape follows, losing and reordering no batch. On the card (marked
``cuda``; they skip without one): the graphed stream's frames byte-equal
to the eager ``encode_batch_device`` on the same PCM and indices for the
benchmark's CD and hi-res configurations, the exact search with f64
analysis and two windows, wasted bits, 32-bit samples (int64 ``zz``),
the residual written with its stats (``keep_res``), a short last batch,
coded numbers that grow a byte within a stream, and the histograms; a
second stream reuses the graph; a stream of two batches stays eager;
``encode_batch_device``, ``encode_batch_indexed``, sharded and
conformance encoders stay eager. Run them on the card with

    python -m pytest tests/test_torch_graph.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from flacx_torch import encoder, trace
from flacx_torch.encoder import BatchEncoder, EncoderConfig
from flacx_torch.ops.headers import frame_indices

torch.set_num_threads(1)

STAGES = ("encode.analysis", "encode.select", "encode.plan", "encode.emit")
GRAPH_COUNTERS = ("encode.graph_captures", "encode.graph_replays")

#: the benchmark's two configurations (portbench/configs)
CD = dict(block_size=4608, max_lpc_order=12, qlp_precision=5,
          partition_orders=tuple(range(6)), analysis_dtype="f32")
HIRES = dict(sample_rate=96000, bps=24, block_size=16384, max_lpc_order=32,
             qlp_precision=5, partition_orders=tuple(range(16)),
             analysis_dtype="f32")
#: name: (config, frames a batch, frames in all)
CASES = {
    "cd16_default": (CD, 6, 23),
    "hires24_96": (HIRES, 3, 11),
    "exact_f64_two_windows": (dict(block_size=2304, order_search="exact",
                                   analysis_dtype="f64",
                                   windows=("tukey(0.5)", "hann")), 5, 18),
    "wasted_bits": (dict(block_size=4608, order_search="exact",
                         wasted_bits=True), 5, 17),
    "bps32": (dict(bps=32, block_size=4608), 4, 15),
    "keep_res_b1152": (dict(block_size=1152), 8, 29),
}


@pytest.fixture(autouse=True)
def fresh():
    trace.reset()
    yield
    trace.reset()


def pcm_for(cfg: EncoderConfig, frames: int, seed: int) -> np.ndarray:
    """``[frames, channels, block_size]`` PCM: tones of varied pitch and
    level with noise, a silent frame, a full-scale one, and with
    ``wasted_bits`` two clear low bits in every other frame."""
    rng = np.random.default_rng(seed)
    n, c = cfg.block_size, cfg.channels
    top = (1 << (cfg.bps - 1)) - 1
    t = np.arange(n)[None, None]
    x = (np.sin(t * rng.uniform(0.002, 0.3, (frames, c, 1))
                + rng.uniform(0, 6, (frames, c, 1)))
         * rng.uniform(0.01, 0.6, (frames, 1, 1)) * top
         + rng.standard_normal((frames, c, n))
         * rng.uniform(0, top / 2000.0, (frames, 1, 1)))
    x[1] = 0
    x[2] = np.where(t[0] % 3, top, -top - 1)
    x = np.clip(np.round(x), -top - 1, top).astype(np.int64)
    if cfg.wasted_bits:
        x[::2] = (x[::2] >> 2) << 2
    return x.astype(np.int16 if cfg.bps <= 16 else np.int32)


def batches_of(pcm: np.ndarray, b: int) -> list:
    return [pcm[s:s + b] for s in range(0, len(pcm), b)]


def counters() -> dict:
    return trace.snapshot()["counters"]


# ----- CPU ----------------------------------------------------------------

@pytest.mark.parametrize("first", [0, 5, 127, 2046, (1 << 31) - 3,
                                   (1 << 36) - 1])
def test_frame_indices_from_a_device_scalar_equal_the_int_route(first):
    b = 6
    want = frame_indices(first, b, torch.device("cpu"))
    scalar = torch.tensor(first, dtype=torch.int64)
    assert torch.equal(frame_indices(scalar, b, torch.device("cpu")), want)
    assert torch.equal(want, first + torch.arange(b))


def test_constants_are_built_once_a_configuration_and_device():
    cfg = EncoderConfig(block_size=1152, windows=("tukey(0.5)", "hann"))
    dev = torch.device("cpu")
    a, b = encoder._constants(cfg, dev), encoder._constants(cfg, dev)
    assert a is b
    assert a.bps_v.tolist() == [16, 16, 16, 17]
    assert len(a.win_pow) == 2 and a.win_pow[0] != a.win_pow[1]
    mono = encoder._constants(EncoderConfig(block_size=1152, channels=1),
                              dev)
    assert mono.bps_v.tolist() == [16] and mono.pairs is None


def test_cpu_stream_stays_eager_and_records_its_stages():
    cfg = EncoderConfig(block_size=1152, max_lpc_order=8)
    pcm = pcm_for(cfg, 7, 3)
    enc = BatchEncoder(cfg, 3, device="cpu")
    with trace.recording():
        got = list(enc.encode_frame_stream(batches_of(pcm, 3), 9))
    snap = trace.snapshot()
    assert "encode.replay" not in snap["spans"]
    for name in GRAPH_COUNTERS:
        assert name not in snap["counters"], name
    for name in STAGES:
        assert len(snap["spans"][name]) == 3, name
    want = []
    for i, chunk in enumerate(batches_of(pcm, 3)):
        want += enc._drain(enc.encode_batch_device(chunk, 9 + 3 * i),
                           len(chunk), None)
    assert got == want


class StandIn:
    """``encoder._Graph``'s interface, run eagerly on the CPU."""

    def __init__(self, cfg, shape, dtype, dev, windows):
        self.pcm = torch.empty(shape, dtype=dtype, device=dev)
        self.cfg, self.windows = cfg, windows

    def replay(self, index: int) -> dict:
        return encoder._encode_batch(self.cfg, self.pcm, index, self.windows)


def graph_runs(batches: int, seen: bool) -> tuple:
    """(eager batches, captures, replays) of a stream of ``batches``
    batches of one shape on an encoder without its graph: the shape's
    first batch (none where ``seen``) eager, a later one that another
    follows captures, it and every later one replay, a last batch with
    no graph eager."""
    eager = captures = replays = 0
    for i in range(batches):
        if captures:
            replays += 1
        elif not seen:
            eager, seen = eager + 1, True
        elif i + 1 < batches:
            captures, replays = 1, 1
        else:
            eager += 1
    return eager, captures, replays


@pytest.mark.parametrize("batches", [1, 2, 3, 5])
def test_stream_captures_only_where_another_batch_follows(monkeypatch,
                                                          batches):
    monkeypatch.setattr(encoder, "_Graph", StandIn)
    cfg = EncoderConfig(block_size=1152, max_lpc_order=8)
    # a short last batch
    pcm = pcm_for(cfg, 3 * batches, batches)[:3 * batches - 1]
    enc = BatchEncoder(cfg, 3, device="cpu")
    enc._graphed = True
    want = []
    for i, chunk in enumerate(batches_of(pcm, 3)):
        want += enc._drain(enc.encode_batch_device(chunk, 40 + 3 * i),
                           len(chunk), None)
    key = encoder._shape_key(pcm[:3])
    for stream in range(3):                 # later streams reuse the graph
        if enc._graphs.get(key) is not None:
            expected = (0, 0, batches)
        else:
            expected = graph_runs(batches, seen=stream > 0)
        trace.reset()
        with trace.recording():
            got = list(enc.encode_frame_stream(iter(batches_of(pcm, 3)),
                                               40))
        assert got == want
        eager, captures, replays = expected
        assert {k: counters().get(k, 0) for k in GRAPH_COUNTERS} == {
            "encode.graph_captures": captures,
            "encode.graph_replays": replays}
        spans = trace.snapshot()["spans"]
        assert len(spans.get("encode.replay", ())) == replays
        # the stand-in runs the pipeline at each replay, not at capture
        assert len(spans["encode.emit"]) == eager + replays


def test_a_batch_of_another_dtype_ahead_captures_nothing(monkeypatch):
    monkeypatch.setattr(encoder, "_Graph", StandIn)
    cfg = EncoderConfig(block_size=1152, max_lpc_order=8)
    pcm = pcm_for(cfg, 9, 4)
    enc = BatchEncoder(cfg, 3, device="cpu")
    enc._graphed = True
    chunks = [pcm[:3], pcm[3:6], pcm[6:].astype(np.int32)]
    want = []
    for i, chunk in enumerate(chunks):
        want += enc._drain(enc.encode_batch_device(chunk, 3 * i), 3, None)
    with trace.recording():
        assert list(enc.encode_frame_stream(iter(chunks), 0)) == want
    assert not any(name in counters() for name in GRAPH_COUNTERS)
    assert len(trace.snapshot()["spans"]["encode.emit"]) == 3


# ----- on the card ----------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def eager(enc: BatchEncoder, batches: list, first: int, stats: dict):
    """The stream's frames from ``encode_batch_device`` and the drain, a
    batch at a time."""
    out, index = [], first
    for chunk in batches:
        out += enc._drain(enc.encode_batch_device(chunk, index), len(chunk),
                          stats)
        index += len(chunk)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_graphed_stream_equals_eager(dev, case):
    kw, b, frames = CASES[case]
    cfg = EncoderConfig(**kw)
    pcm = pcm_for(cfg, frames, len(case))
    assert frames % b                               # a short last batch
    # coded numbers from 1 byte to 2 within the stream (127 → 128)
    first = 128 - 2 * b
    batches = batches_of(pcm, b)
    assert len(batches) >= 4

    enc = BatchEncoder(cfg, b)
    with trace.recording():
        want_stats: dict = {}
        want = eager(enc, batches, first, want_stats)
        eager_counts = counters()
        got_stats: dict = {}
        got = list(enc.encode_frame_stream(iter(batches), first, got_stats))
        torch.cuda.synchronize()
        first_counts = counters()
        again = list(enc.encode_frame_stream(iter(batches), first))
        torch.cuda.synchronize()
        second_counts = counters()
    assert len(want) == frames
    assert got == want
    assert again == want
    assert got_stats == want_stats
    # the first batch eager, the second captured, every later one replayed
    assert first_counts["encode.graph_captures"] == 1
    assert first_counts["encode.graph_replays"] == len(batches) - 1
    for k in ("launch.analysis", "launch.frame_pack"):
        assert first_counts[k] == eager_counts[k] + 2, k
    assert second_counts["encode.graph_captures"] == 1
    assert (second_counts["encode.graph_replays"]
            == first_counts["encode.graph_replays"] + len(batches))
    for k, v in first_counts.items():
        if k.startswith("launch."):
            assert second_counts[k] == v, k
    if case == "keep_res_b1152":
        assert eager_counts["launch.lpc_residual_res"] == len(batches)
    if case == "bps32":
        assert cfg.work_dtype == torch.int64
    spans = trace.snapshot()["spans"]
    assert len(spans["encode.replay"]) == 2 * len(batches) - 1
    assert len(spans["encode.emit"]) == len(batches) + 2


@pytest.mark.cuda
def test_batch_device_and_indexed_stay_eager(dev):
    cfg = EncoderConfig(block_size=1152)
    pcm = pcm_for(cfg, 12, 11)
    enc = BatchEncoder(cfg, 4)
    with trace.recording():
        list(enc.encode_frame_stream(batches_of(pcm, 4), 0))
        before = counters()
        assert before["encode.graph_captures"] == 1
        a = enc._drain(enc.encode_batch_device(pcm[:4], 100), 4, None)
        b = enc._drain(enc.encode_batch_indexed(
            pcm[:4], np.arange(100, 104)), 4, None)
        after = counters()
    assert a == b
    assert after["launch.frame_pack"] == before["launch.frame_pack"] + 2
    for name in GRAPH_COUNTERS:
        assert after[name] == before[name], name


@pytest.mark.cuda
def test_sharded_and_conformance_streams_stay_eager(dev):
    from flacx_torch.parallel import data_mesh, frame_sharding

    cfg = EncoderConfig(block_size=1152)
    pcm = pcm_for(cfg, 8, 12)
    with trace.recording():
        plain = list(BatchEncoder(cfg, 4).encode_frame_stream(
            batches_of(pcm, 4), 0))
        trace.reset()
        sharded = BatchEncoder(cfg, 4, sharding=frame_sharding(
            data_mesh(devices=("cuda:0", "cuda:0"))))
        assert list(sharded.encode_frame_stream(batches_of(pcm, 4),
                                                0)) == plain
        assert counters()["launch.frame_pack"] == 4     # 2 batches x 2
        conf = BatchEncoder(EncoderConfig(block_size=1152, conformance=True),
                            4)
        list(conf.encode_frame_stream(batches_of(pcm, 4), 0))
        got = counters()
    for name in GRAPH_COUNTERS:
        assert name not in got, name
    assert got["launch.frame_pack"] == 6


@pytest.mark.cuda
def test_two_batch_stream_stays_eager(dev):
    cfg = EncoderConfig(block_size=1152)
    pcm = pcm_for(cfg, 7, 13)
    enc = BatchEncoder(cfg, 4)
    want = eager(enc, batches_of(pcm, 4), 0, {})
    with trace.recording():
        got = list(enc.encode_frame_stream(iter(batches_of(pcm, 4)), 0))
        torch.cuda.synchronize()
        two = counters()
        again = list(enc.encode_frame_stream(iter(batches_of(pcm, 4)), 0))
        torch.cuda.synchronize()
        after = counters()
    assert got == want and again == want
    for name in GRAPH_COUNTERS:
        assert name not in two, name
    assert two["launch.frame_pack"] == 2
    # the shape ran eagerly before, so the next stream's first batch
    # captures (a second follows) and both replay
    assert after["encode.graph_captures"] == 1
    assert after["encode.graph_replays"] == 2
    assert after["launch.frame_pack"] == 3
