"""The walker's int64 sample state past 31 bits, on the CPU.

Where a sample may not fit int32 (``bps`` plus a stereo side channel past
31 bits), the C++ walker keeps its inline IIR's history in int64 and
emits int64 windows, so the decoder takes ``reconstruct``'s chunk route
at every width.  flacx's own streams at 31-bit stereo (a 32-bit side
channel), 32-bit stereo and 32-bit mono (LPC order 32, wasted bits,
escapes of 31 bits over state boundaries, verbatim full-scale noise, a
block under 2048 whose interval is ``n // 8``), and a stream written here
whose 32-bit stereo frames carry a 33-bit side channel near ±2^32 in
each stereo mode, decode through ``decode_array`` and ``decode_stream``
on ``device="cpu"`` on the chunk route with int64 state: equal to the
source, to flacx's sequential decoder and to the port's serial route.
The walker's int64 windows equal the serial IIR's samples.  flacx
encodes each of its three streams once (one XLA:CPU compile each).
"""

import io

import numpy as np
import pytest
import torch

import flacx.decoder as fx_dec
import flacx.pipeline as fx_pipeline

from flacx_torch import decoder, native
from flacx_torch.format import Channels, Subframe, SubframeKind
from flacx_torch.hostdec import parse_frames
from flacx_torch.kernels import reconstruct as k_rec
from flacx_torch.ops.reconstruct import (reconstruct_predicted,
                                         reconstruct_predicted_chunks)
from flacx_torch.oracle.analyze import (SubframePlan, plan_residual,
                                        predict_residual)
from flacx_torch.oracle.encoder import serialize_frame
from flacx_torch.stream import StreamWriter

from conftest import make_pcm

torch.set_num_threads(1)

RATE, BATCH, TAIL = 96000, 3, 300


def tones(seed: int, frames: int, n: int, channels: int, bps: int,
          ) -> np.ndarray:
    return make_pcm(np.random.default_rng(seed), frames * n, channels, bps)


def loud(n: int, bits: int) -> np.ndarray:
    """Two stereo frames: full-scale 32-bit white noise (verbatim), then
    left white noise of ``bits`` bits (escaped partitions over every state
    boundary) beside a tone."""
    rng = np.random.default_rng(bits)
    noise = rng.integers(-(1 << 31), 1 << 31, (n, 2))
    esc = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), (n, 2))
    esc[:, 1] = tones(bits, 1, n, 1, 32)[:, 0]
    return np.concatenate([noise, esc]).astype(np.int32)


def with_tail(*parts) -> np.ndarray:
    pcm = np.concatenate(parts)
    return np.concatenate([pcm, pcm[:TAIL]])


#: flacx's streams: name -> (interleaved PCM, encode_to_file arguments)
FLACX = {
    # a 32-bit side channel; 29-bit tones shifted by 2 (wasted bits)
    "stereo31": (lambda: with_tail(tones(1, 3, 1152, 2, 31),
                                   tones(2, 2, 1152, 2, 29) << 2),
                 dict(bps=31, channels=2, block_size=1152, max_lpc_order=32,
                      qlp_precision=15, partition_orders=tuple(range(6)),
                      wasted_bits=True)),
    "stereo32": (lambda: with_tail(tones(3, 2, 4608, 2, 32), loud(4608, 31)),
                 dict(bps=32, channels=2, block_size=4608, max_lpc_order=12,
                      qlp_precision=5, partition_orders=tuple(range(6)))),
    "mono32": (lambda: with_tail(tones(4, 3, 1152, 1, 32),
                                 tones(5, 2, 1152, 1, 29) << 3),
               dict(bps=32, channels=1, block_size=1152, max_lpc_order=32,
                    qlp_precision=15, partition_orders=tuple(range(6)),
                    wasted_bits=True)),
}


#: the 33-bit side channel's tone, radians a sample
TONE = 1.3


def tone_plan(samples: list[int], n: int) -> SubframePlan:
    """An order-2 LPC subframe of ``samples``: the tone's recurrence
    x[i] = 2 cos(TONE) x[i-1] - x[i-2] at precision 15, shift 14."""
    shift = 14
    coefs = (round(2 * np.cos(TONE) * (1 << shift)), -(1 << shift))
    res = tuple(predict_residual(samples, coefs, shift))
    sf = Subframe(kind=SubframeKind.LPC, order=2, warmup=tuple(samples[:2]),
                  precision=15, shift=shift, coefficients=coefs,
                  residual=res)
    return SubframePlan(sf, plan_residual(res, n, 2, range(0, 4)))


def side33_stream() -> tuple[bytes, np.ndarray]:
    """32-bit stereo frames of 576 samples whose side channel spans 33
    bits (left and right a tone near opposite full scale), one in each of
    left/side, side/right and mid/side and one independent, every
    subframe an order-2 LPC (:func:`tone_plan`)."""
    n, frames = 576, 4
    t = np.arange(n * frames)
    rng = np.random.default_rng(33)
    left = (np.sin(t * TONE) * 0.95 * 2 ** 31).astype(np.int64)
    left += rng.integers(-4, 5, t.size)
    right = np.clip(-left + rng.integers(-1000, 1001, t.size),
                    -2 ** 31, 2 ** 31 - 1)
    left = np.clip(left, -2 ** 31, 2 ** 31 - 1)
    pcm = np.stack([left, right], axis=1)
    out = io.BytesIO()
    w = StreamWriter(out, RATE, 32, 2, len(pcm), n)
    w.add_pcm(pcm.astype(np.int32))
    for i, layout in enumerate((Channels.L_S, Channels.S_R, Channels.M_S,
                                Channels.L_R)):
        lf = [int(v) for v in left[i * n:(i + 1) * n]]
        rt = [int(v) for v in right[i * n:(i + 1) * n]]
        side = [a - b for a, b in zip(lf, rt)]
        chans = {Channels.L_S: (lf, side), Channels.S_R: (side, rt),
                 Channels.M_S: ([(a + b) >> 1 for a, b in zip(lf, rt)],
                                side),
                 Channels.L_R: (lf, rt)}[layout]
        plans = [tone_plan(ch, n) for ch in chans]
        w.write_frames([serialize_frame(plans, layout, i, n, 32)])
    w.finalize()
    return out.getvalue(), pcm.astype(np.int32)


STREAMS = list(FLACX) + ["side33"]


@pytest.fixture(scope="module")
def streams():
    """name -> (stream bytes, interleaved PCM), encoded once a module."""
    return {}


@pytest.fixture
def stream(streams, request):
    name = request.param
    if name not in streams:
        if name == "side33":
            streams[name] = side33_stream()
        else:
            make, kw = FLACX[name]
            pcm = make()
            f = io.BytesIO()
            fx_pipeline.encode_to_file(f, pcm, sample_rate=RATE,
                                       batch_frames=BATCH, **kw)
            streams[name] = (f.getvalue(), pcm)
    return (name,) + streams[name]


def spy_routes(monkeypatch) -> list:
    """Records each ``reconstruct`` call's route and state dtype (an
    all-fixed batch takes the ``fixed`` route, with no state, at every
    width)."""
    routes = []
    original = decoder.reconstruct

    def spy(*args):
        state = args[9]
        routes.append("fixed" if args[14:] and args[14] is not None else
                      "serial" if state is None else
                      f"chunk {str(state.dtype).split('.')[-1]}")
        return original(*args)
    monkeypatch.setattr(decoder, "reconstruct", spy)
    return routes


def port_decode(monkeypatch, data: bytes, route: str) -> np.ndarray:
    """``decode_array`` on the CPU on ``route`` (``chunk``: state on any
    host; ``serial``: none), every batch on the device route."""
    monkeypatch.setattr(decoder, "CHUNK_STATE_MIN_CORES",
                        1 if route == "chunk" else 10 ** 6)
    stats = {}
    _, got = decoder.decode_array(data, batch_frames=BATCH, device="cpu",
                                  stats=stats)
    assert stats.get("device") and not stats.get("host") \
        and not stats.get("sequential"), stats
    return got


@pytest.mark.parametrize("stream", STREAMS, indirect=True)
def test_decode_array_on_the_chunk_route(stream, monkeypatch):
    """Every batch on the chunk route with int64 state, bit-exact against
    the source, flacx's sequential decoder and the serial route."""
    name, data, pcm = stream
    routes = spy_routes(monkeypatch)
    got = port_decode(monkeypatch, data, "chunk")
    assert set(routes) - {"fixed"} == {"chunk int64"}, routes
    np.testing.assert_array_equal(got, pcm)
    np.testing.assert_array_equal(fx_dec.decode_array(data, device=False)[1],
                                  pcm)
    routes.clear()
    np.testing.assert_array_equal(port_decode(monkeypatch, data, "serial"),
                                  got)
    assert set(routes) - {"fixed"} == {"serial"}, routes


@pytest.mark.parametrize("stream", STREAMS, indirect=True)
def test_decode_stream_on_the_chunk_route(stream, monkeypatch):
    name, data, pcm = stream
    monkeypatch.setattr(decoder, "CHUNK_STATE_MIN_CORES", 1)
    routes = spy_routes(monkeypatch)
    _, chunks = decoder.decode_stream(io.BytesIO(data), batch_frames=2,
                                      device="cpu")
    np.testing.assert_array_equal(np.concatenate(list(chunks)), pcm)
    assert set(routes) - {"fixed"} == {"chunk int64"}, routes


def rows_of(data: bytes):
    """Streaminfo and the padded rows of every full frame."""
    si, first = decoder.parse_stream_header(data)
    offs = decoder.scan_frame_offsets(data, first)
    ends = np.append(offs[1:], len(data))
    full = si.samples // si.max_block_size
    offs, ends = offs[:full], ends[:full]
    width = (int((ends - offs).max()) + 255) // 256 * 256
    return si, native.scatter_rows(np.frombuffer(data, np.uint8), offs, ends,
                                   width)


@pytest.mark.parametrize("stream", STREAMS, indirect=True)
def test_walker_windows_equal_the_serial_iir(stream, monkeypatch):
    """Window m of every coded subframe is the serial IIR's samples
    ``x[m·SS - 32 + i]`` (zero before the block), at the decoder's own
    interval, in int64; on the 33-bit side channel past int32."""
    name, data, _ = stream
    monkeypatch.setattr(decoder, "CHUNK_STATE_MIN_CORES", 1)
    si, rows = rows_of(data)
    n, c, bps = si.max_block_size, si.channels, si.sample_size
    ss = decoder._state_interval(n)
    assert ss == (256 if n >= 2048 else n // 8)
    start = np.zeros(len(rows), np.int64)
    state = native.scan_frames(rows, start, n, c, bps,
                               state_interval=ss).ckpt_state
    assert state.dtype == np.int64 and state.shape[2] == -(-n // ss)
    p = parse_frames(rows, start, n, c, bps)
    x = reconstruct_predicted(
        torch.from_numpy(p.residual), torch.from_numpy(p.taps.astype(
            np.int32)), torch.from_numpy(p.shift.astype(np.int32)),
        torch.from_numpy(p.order.astype(np.int32))).numpy()
    lead = np.pad(x, ((0, 0), (0, 0), (32, 0)))
    want = np.stack([lead[..., m * ss:m * ss + 32]
                     for m in range(state.shape[2])], axis=2)
    coded = p.kind >= 2
    assert coded.any()
    np.testing.assert_array_equal(state[coded], want[coded])
    if name == "side33":
        assert np.abs(state).max() >= 2 ** 32 - 2 ** 30


@pytest.mark.parametrize("bps,c,wide", [(30, 2, False), (31, 2, True),
                                        (31, 1, False), (32, 1, True),
                                        (32, 2, True), (32, 6, True)])
def test_state_width_follows_the_side_channel(bps, c, wide):
    assert native.wide_state(bps, c) == wide


@pytest.mark.parametrize("n,cores,ss", [(1152, 1, 144), (4608, 1, 256),
                                        (192, 1, 64), (64, 1, 0),
                                        (4608, 10 ** 6, 0)])
def test_state_interval_at_every_width(monkeypatch, n, cores, ss):
    """The interval depends on the block and the host's cores only."""
    monkeypatch.setattr(decoder, "CHUNK_STATE_MIN_CORES", cores)
    assert decoder._state_interval(n) == ss


def integrators(f: int, c: int, n: int, ss: int):
    """Order-1 and order-2 integrator subframes (taps 1 and 2, -1, shift
    0) and an order-3 LPC at shift 2, whose samples run near ±2^32: the
    residuals, taps, shifts, orders and the serial IIR's int64 windows
    every ``ss`` samples."""
    rng = np.random.default_rng(f * c + n)
    order = rng.choice([1, 2, 3], (f, c)).astype(np.int32)
    taps = np.zeros((f, c, 32), np.int32)
    taps[order == 1, 0] = 1
    taps[order == 2, :2] = (2, -1)
    taps[order == 3, :3] = (4, -2, 1)
    shift = np.where(order == 3, 2, 0).astype(np.int32)
    res = rng.integers(-8, 9, (f, c, n))
    res[..., 0] = rng.choice([-1, 1], (f, c)) * (2 ** 32 - 2 ** 20)
    res[..., 1:3] = res[..., :1]
    res = torch.from_numpy(res)
    args = (torch.from_numpy(taps), torch.from_numpy(shift),
            torch.from_numpy(order))
    x = reconstruct_predicted(res, *args).numpy()
    lead = np.pad(x, ((0, 0), (0, 0), (32, 0)))
    ks = -(-n // ss)
    state = np.stack([lead[..., m * ss:m * ss + 32] for m in range(ks)], 2)
    return res, args, x, torch.from_numpy(state)


def test_plain_chunks_take_int64_state_past_int32():
    """The chunk IIR from int64 windows past ±2^31 equals the serial IIR,
    which overflows int32."""
    res, args, x, state = integrators(4, 2, 1152, 144)
    assert np.abs(state.numpy()).max() > 2 ** 31
    got = reconstruct_predicted_chunks(res, args[0], *args[1:], state, 144)
    np.testing.assert_array_equal(got.numpy(), x)


def test_int64_state_needs_the_int64_working_type():
    """The int32 route refuses int64 state (wrapper and plain version);
    it never truncates it."""
    f, c, n, ss = 2, 2, 576, 72
    res, (taps, shift, order), _, state = integrators(f, c, n, ss)
    with pytest.raises(ValueError, match="int64"):
        reconstruct_predicted_chunks(res, taps, shift, order, state, ss,
                                     dtype=torch.int32)
    kind = torch.full((f, c), 3, dtype=torch.int32)
    zeros = torch.zeros((f, c), dtype=torch.int32)
    warm = res[..., :32].clone()
    code = torch.ones(f, dtype=torch.int32)
    with pytest.raises(ValueError, match="int64 state"):
        k_rec.reconstruct(res, taps, shift, order, kind, zeros, warm,
                          res[..., 0].clone(), code, state, ss, 4, True, 29)
    args = (res, taps, shift, order, kind, zeros, warm, res[..., 0].clone(),
            code)
    pcm, err = k_rec.reconstruct(*args, state, ss, 4, False, -1)
    serial, _ = k_rec.reconstruct(*args, None, 0, 4, False, -1)
    assert err.item() == 0 and torch.equal(pcm, serial)
