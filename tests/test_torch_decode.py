"""flacx_torch's batched decoder against flacx's on the CPU.

The port's host runtime (``flacx_torch.native``: frame scan, structure
walker, full parse) must equal flacx's field for field; each plain twin of
the decode kernels (``ops.bitunpack``, ``ops.reconstruct``,
``ops.crcfold.crc16_over_rows``) must equal its flacx function on the same
walker output; and ``decode_array`` / ``decode_stream`` with
``device="cpu"`` must return flacx's PCM (or raise its error) on every
stream: mono, stereo with a short last frame, 24-bit at order 32, 5.1,
all-fixed, verbatim and constant subframes, per-frame sample sizes,
variable blocking, a long unary code and a corrupted CRC, on the serial
and the chunk route.  Everything compares exactly.  flacx decodes three of
the streams on its device route (one XLA:CPU compile each), the rest with
its sequential oracle.
"""

import io

import numpy as np
import pytest
import torch

import flacx.decoder as fx_dec
import flacx.native as fx_native
from flacx.bitio import BitWriter
from flacx.crc import crc8 as fx_crc8
from flacx.crc import crc16 as fx_crc16
from flacx.format import Channels as FxChannels
from flacx.format import MAGIC, MetadataBlockType, Streaminfo
from flacx.oracle.decoder import FlacFormatError as FxFormatError
from flacx.hostdec import parse_frames as fx_parse_frames
from flacx.ops import bitunpack as fx_bitunpack
from flacx.ops import crcfold as fx_crcfold
from flacx.ops import reconstruct as fx_reconstruct
from flacx.oracle.encoder import EncoderParameters as FxParams
from flacx.oracle.encoder import (encode_frame, encode_stream_variable,
                                  serialize_metadata_header,
                                  serialize_streaminfo)

from flacx_torch import decoder, native
from flacx_torch.hostdec import parse_frames
from flacx_torch.kernels import bit_unpack as k_bu
from flacx_torch.kernels import crc16_rows as k_crc
from flacx_torch.ops import bitunpack, crcfold, reconstruct
from flacx_torch.oracle.decoder import FlacFormatError
from flacx_torch.pipeline import encode_to_file

from conftest import make_pcm

torch.set_num_threads(1)


def encoded(seed: int, samples: int, channels: int, bps: int,
            block_size: int, max_lpc_order: int, qlp_precision: int = 12,
            kind: str = "tonal", rate: int = 44100,
            bursts: bool = False) -> tuple[bytes, np.ndarray]:
    """A stream from the port's CPU encoder and its PCM; ``bursts`` puts
    full-scale noise in, which the encoder codes as escaped partitions."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":       # full-scale white noise: verbatim frames
        pcm = rng.integers(-(1 << (bps - 1)), 1 << (bps - 1),
                           (samples, channels)).astype(np.int32)
    else:
        pcm = make_pcm(rng, samples, channels, bps, kind)
    if bursts:
        amp = 1 << (bps - 1)
        for at in range(block_size // 3, samples, 2 * block_size):
            pcm[at:at + 40] = rng.integers(-amp, amp, (40, channels))
    f = io.BytesIO()
    encode_to_file(f, pcm, sample_rate=rate, bps=bps, channels=channels,
                   block_size=block_size, max_lpc_order=max_lpc_order,
                   qlp_precision=qlp_precision,
                   partition_orders=tuple(range(7)), device="cpu")
    return f.getvalue(), pcm


def assembled(frames: list[bytes], n: int, channels: int, bps: int,
              samples: int, min_block: int | None = None) -> bytes:
    return (MAGIC
            + serialize_metadata_header(True, MetadataBlockType.Streaminfo,
                                        34)
            + serialize_streaminfo(Streaminfo(min_block or n, n, 0, 0, 44100,
                                              channels, bps, samples,
                                              bytes(16)))
            + b"".join(frames))


def patch_sample_size(frame: bytes, ss_code: int) -> bytes:
    """A frame header's sample-size code rewritten (explicit override),
    its CRC-8 and CRC-16 fixed up."""
    b = bytearray(frame)
    b[3] = (b[3] & 0xF1) | (ss_code << 1)
    extra = fx_dec._CN_EXTRA[b[4]]
    bs_code, sr_code = b[2] >> 4, b[2] & 0xF
    hdr = (5 + extra + (1 if bs_code == 6 else 2 if bs_code == 7 else 0)
           + (1 if sr_code == 12 else 2 if sr_code in (13, 14) else 0))
    b[hdr] = fx_crc8(bytes(b[:hdr]))
    b[-2:] = fx_crc16(bytes(b[:-2])).to_bytes(2, "big")
    return bytes(b)


def override_stream() -> tuple[bytes, np.ndarray]:
    """Stereo frames of 256 samples, every other one 12-bit with an
    explicit sample-size code: a mixed batch."""
    rng = np.random.default_rng(11)
    n, count = 256, 10
    frames, pcm_all = [], np.zeros((count * n, 2), np.int32)
    for i in range(count):
        bpsf = 16 if i % 2 == 0 else 12
        pcm = make_pcm(rng, n, 2, bpsf, "tonal")
        pcm_all[i * n:(i + 1) * n] = pcm
        fr = encode_frame([list(map(int, pcm[:, c])) for c in range(2)],
                          FxChannels.L_R, i, bpsf, FxParams(block_size=n))
        frames.append(fr if bpsf == 16 else patch_sample_size(fr, 2))
    return assembled(frames, n, 2, 16, count * n), pcm_all


def variable_stream() -> tuple[bytes, np.ndarray]:
    """Variable blocking: groups of 512 and 256 (device batches), odd
    sizes 1000 and 200 (uncommon header forms, the oracle)."""
    sizes = [512] * 9 + [1000] + [256] * 8 + [200] + [512] * 2
    rng = np.random.default_rng(12)
    pcm = make_pcm(rng, sum(sizes), 2, 16, "tonal").astype(np.int64)
    data = b"".join(encode_stream_variable(44100, 16, 2, pcm.tolist(),
                                           FxParams(), sizes))
    return data, pcm.astype(np.int32)


def long_unary_stream() -> tuple[bytes, np.ndarray]:
    """One mono frame whose first Rice code has a 70-bit quotient: past
    one 64-bit window, so the device route flags the batch."""
    n = 256
    w = BitWriter()
    for value, bits in ((0xFFF8, 16), (8, 4), (9, 4), (0, 4), (4, 3),
                        (0, 1), (0, 8)):
        w.write_uint(value, bits)
    hdr = w.getvalue()
    w2 = BitWriter()
    w2.write_bytes(hdr)
    w2.write_uint(fx_crc8(hdr), 8)
    for value, bits in ((0, 1), (8, 6), (0, 1), (0, 2), (0, 4), (0, 4)):
        w2.write_uint(value, bits)         # fixed order 0, k = 0
    w2.write_unary(70)
    for _ in range(n - 1):
        w2.write_unary(0)
    w2.pad_to_byte()
    body = w2.getvalue()
    want = np.zeros((n, 1), np.int32)
    want[0, 0] = 35
    return assembled([body + fx_crc16(body).to_bytes(2, "big")], n, 1, 16,
                     n), want


def collision_stream(data: bytes) -> bytes:
    """``data`` with frame 3's header (sync to CRC-8) copied into frame
    2's body, frame 2's CRC-16 fixed up: a false sync whose coded number
    collides with a real one, which the chain resolves by CRC-16."""
    offs = fx_dec.scan_frame_offsets(data, 42)
    b = bytearray(data)
    head = bytes(b[offs[3]:offs[3] + 7])     # 6 header bytes + CRC-8
    b[offs[2] + 100:offs[2] + 107] = head
    b[offs[3] - 2:offs[3]] = fx_crc16(bytes(b[offs[2]:offs[3] - 2])) \
        .to_bytes(2, "big")
    return bytes(b)


def corrupt(data: bytes, at: int) -> bytes:
    b = bytearray(data)
    b[at] ^= 0x10
    return bytes(b)


@pytest.fixture(scope="module")
def streams() -> dict:
    """name → (stream bytes, interleaved PCM or None for a bad stream)."""
    out = {
        # six full blocks and a short last one; escapes from noise bursts
        "stereo": encoded(1, 6 * 1152 + 500, 2, 16, 1152, 8, bursts=True),
        "mono": encoded(2, 4 * 1024, 1, 16, 1024, 12),
        # 24-bit at order 32, precision 15: the int64 working type
        "hires": encoded(3, 3 * 2048, 2, 24, 2048, 32, qlp_precision=15,
                         rate=96000),
        "six": encoded(4, 2 * 1152, 6, 24, 1152, 8),
        "fixed": encoded(5, 4 * 1152, 2, 16, 1152, 0),
        # verbatim frames of full-scale noise
        "verbatim": encoded(6, 2 * 576, 2, 24, 576, 8, kind="uniform"),
        "override": override_stream(),
        "variable": variable_stream(),
        "long-unary": long_unary_stream(),
    }
    # silence: constant subframes
    silent, _ = encoded(7, 2 * 576, 2, 24, 576, 8, kind="silence")
    out["constant"] = (silent, np.zeros((2 * 576, 2), np.int32))
    data = out["stereo"][0]
    out["corrupt"] = (corrupt(data, len(data) // 2), None)
    out["collision"] = (collision_stream(data), None)
    return out


def rows_of(data: bytes):
    """Streaminfo and the padded rows and lengths of every full frame."""
    si, first = decoder.parse_stream_header(data)
    offs = decoder.scan_frame_offsets(data, first)
    ends = np.append(offs[1:], len(data))
    full = si.samples // si.max_block_size
    offs, ends = offs[:full], ends[:full]
    lens = ends - offs
    width = (int(lens.max()) + 255) // 256 * 256
    rows = native.scatter_rows(np.frombuffer(data, np.uint8), offs, ends,
                               width)
    return si, rows, lens


SCAN_FIELDS = ("channel_code", "kind", "order", "shift", "wasted", "po",
               "width", "taps", "warmup", "const_val", "ckpt_pos",
               "ckpt_param", "ckpt_esc", "ckpt_inesc", "ckpt_state",
               "end_bits", "fbps")


@pytest.mark.parametrize("name", ["stereo", "hires", "verbatim"])
@pytest.mark.parametrize("state_interval", [0, 256])
def test_walker_matches_flacx(streams, name, state_interval):
    si, rows, lens = rows_of(streams[name][0])
    n, c, bps = si.max_block_size, si.channels, si.sample_size
    start = np.zeros(len(rows), np.int64)
    got = native.scan_frames(rows, start, n, c, bps,
                             state_interval=state_interval)
    ref = fx_native.scan_frames(rows, start, n, c, bps,
                                state_interval=state_interval)
    for field in SCAN_FIELDS + ("ckpt_interval", "state_interval"):
        a, b = getattr(got, field), getattr(ref, field)
        if a is None or b is None:
            assert a is None and b is None, field
        else:
            np.testing.assert_array_equal(a, b, err_msg=field)
    p, q = parse_frames(rows, start, n, c, bps), \
        fx_parse_frames(rows, start, n, c, bps)
    for a, b in zip(p, q):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        native.crc16_rows(rows, lens - 2),
        fx_native.crc16_rows(rows, (lens - 2).astype(np.int32)))


@pytest.mark.parametrize("name", ["stereo", "variable", "corrupt",
                                  "collision"])
def test_frame_scan_matches_flacx(streams, name):
    data = streams[name][0]
    arr = np.frombuffer(data, np.uint8)
    if name == "collision":     # the chain's CRC-16 resolves a duplicate
        nums = native.scan_candidates(arr, 42)[1]
        assert len(nums) > len(np.unique(nums))
    for a, b in zip(native.scan_candidates(arr, 0),
                    fx_native.scan_candidates(arr, 0)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(decoder._scan_frame_chain(data, 42),
                    fx_dec._scan_frame_chain(data, 42)):
        np.testing.assert_array_equal(a, b)
    got, ref = decoder.frame_headers(data), fx_dec.frame_headers(data)
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def walked(data: bytes):
    si, rows, lens = rows_of(data)
    scan = native.scan_frames(rows, np.zeros(len(rows), np.int64),
                              si.max_block_size, si.channels,
                              si.sample_size, state_interval=64)
    return si, rows, lens, scan


@pytest.mark.parametrize("name", ["stereo", "verbatim", "long-unary"])
def test_parse_residual_chunks_matches_flacx(streams, name):
    import jax.numpy as jnp

    si, rows, _, scan = walked(streams[name][0])
    n = si.max_block_size
    if name == "stereo":   # escaped partitions are in the test
        assert (scan.ckpt_inesc * (scan.kind[..., None] >= 2)).any()
    if name == "verbatim":
        assert (scan.kind == 1).any()
    args = [scan.ckpt_pos, scan.ckpt_param, scan.ckpt_esc, scan.ckpt_inesc,
            scan.kind, scan.order, scan.po, scan.width]
    span = 64 + int(np.diff(scan.ckpt_pos, axis=-1).max(initial=0))
    vals_f, err_f = fx_bitunpack.parse_residual_chunks(
        fx_bitunpack.bytes_to_words(jnp.asarray(rows)),
        *map(jnp.asarray, args), n, scan.ckpt_interval,
        span_words=span // 32 + 4)
    vals, err = bitunpack.parse_residual_chunks(
        bitunpack.bytes_to_words(torch.from_numpy(rows)),
        *map(torch.from_numpy, args), n, scan.ckpt_interval)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(vals_f))
    assert bool(err) == bool(err_f) == (name == "long-unary")
    got, got_err = k_bu.bit_unpack(torch.from_numpy(rows),
                                   *map(torch.from_numpy, args), n)
    assert torch.equal(got, vals) and got_err.tolist() == [int(bool(err))]


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("name", ["stereo", "hires", "fixed"])
def test_reconstruct_twins_match_flacx(streams, name, dtype):
    import jax.numpy as jnp

    si, rows, _, scan = walked(streams[name][0])
    n = si.max_block_size
    p = parse_frames(rows, np.zeros(len(rows), np.int64), n, si.channels,
                     si.sample_size)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    taps = p.taps.astype(np.int32)
    shift, order = p.shift.astype(np.int32), p.order.astype(np.int32)
    got = reconstruct.reconstruct_predicted(
        torch.from_numpy(p.residual), torch.from_numpy(taps),
        torch.from_numpy(shift), torch.from_numpy(order), dtype=tdt)
    ref = fx_reconstruct.reconstruct_predicted(
        jnp.asarray(p.residual), jnp.asarray(taps), jnp.asarray(shift),
        jnp.asarray(order), dtype=jdt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ss = 256 if n > 256 else 64
    state = native.scan_frames(rows, np.zeros(len(rows), np.int64), n,
                               si.channels, si.sample_size,
                               state_interval=ss).ckpt_state
    got = reconstruct.reconstruct_predicted_chunks(
        torch.from_numpy(p.residual), torch.from_numpy(taps),
        torch.from_numpy(shift), torch.from_numpy(order),
        torch.from_numpy(state), ss, dtype=tdt)
    ref = fx_reconstruct.reconstruct_predicted_chunks(
        jnp.asarray(p.residual), jnp.asarray(taps), jnp.asarray(shift),
        jnp.asarray(order), jnp.asarray(state), ss, dtype=jdt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if name == "fixed":
        got = reconstruct.reconstruct_fixed_parallel(
            torch.from_numpy(p.residual), torch.from_numpy(order), 4,
            dtype=tdt)
        ref = fx_reconstruct.reconstruct_fixed_parallel(
            jnp.asarray(p.residual), jnp.asarray(order), 4, dtype=jdt)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_undo_decorrelation_matches_flacx(dtype):
    import jax.numpy as jnp

    rng = np.random.default_rng(13)
    ch0 = rng.integers(-2 ** 20, 2 ** 20, (8, 64))
    ch1 = rng.integers(-2 ** 20, 2 ** 20, (8, 64))
    mode = np.array([1, 8, 9, 10, 10, 9, 8, 1], np.int32)
    got = reconstruct.undo_decorrelation(
        torch.from_numpy(ch0).to(getattr(torch, dtype)),
        torch.from_numpy(ch1).to(getattr(torch, dtype)),
        torch.from_numpy(mode))
    ref = fx_reconstruct.undo_decorrelation(
        jnp.asarray(ch0, getattr(jnp, dtype)),
        jnp.asarray(ch1, getattr(jnp, dtype)), jnp.asarray(mode))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_crc16_over_rows_matches_flacx(streams):
    import jax.numpy as jnp

    _, rows, lens = rows_of(streams["stereo"][0])
    rows = rows.copy()
    body = np.where(np.arange(rows.shape[1]) >= (lens - 2)[:, None], 0,
                    rows).astype(np.uint8)
    got = crcfold.crc16_over_rows(torch.from_numpy(body),
                                  torch.from_numpy(lens - 2))
    ref = fx_crcfold.crc16_over_rows(jnp.asarray(body),
                                     jnp.asarray(lens - 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    rows[1, 7] ^= 1
    ok, all_ok = k_crc.crc16_rows(torch.from_numpy(rows),
                                  torch.from_numpy(lens.astype(np.int32)))
    assert ok.tolist() == [int(i != 1) for i in range(len(rows))]
    assert all_ok.tolist() == [0]


def fx_decode(data: bytes, device: bool = False):
    try:
        return fx_dec.decode_array(data, device=device)[1]
    except FxFormatError as e:
        return ("raise", str(e))


def port_decode(data: bytes, stats=None, **kw):
    try:
        return decoder.decode_array(data, device="cpu", stats=stats, **kw)[1]
    except FlacFormatError as e:
        return ("raise", str(e))


def same(a, b) -> bool:
    if isinstance(a, tuple) or isinstance(b, tuple):
        return a == b
    return a.dtype == b.dtype and np.array_equal(a, b)


#: routes each stream's decode takes (beside its oracle tail)
ROUTES = {"long-unary": "host", "corrupt": "sequential",
          "collision": "sequential", "variable": "device"}


@pytest.mark.parametrize("route", ["serial", "chunk"])
@pytest.mark.parametrize("name", [
    "stereo", "mono", "hires", "six", "fixed", "verbatim", "constant",
    "override", "variable", "long-unary", "corrupt", "collision"])
def test_decode_array_matches_flacx(streams, monkeypatch, name, route):
    data, pcm = streams[name]
    monkeypatch.setattr(decoder, "CHUNK_STATE_MIN_CORES",
                        10 ** 6 if route == "serial" else 1)
    stats = {}
    got = port_decode(data, stats)
    assert same(got, fx_decode(data))
    if pcm is not None:
        np.testing.assert_array_equal(got, pcm)
    want = ROUTES.get(name, "device")
    assert stats.get(want, 0) >= 1, stats
    if want == "device":
        assert not stats.get("host") and not stats.get("sequential"), stats


@pytest.mark.parametrize("name", ["stereo", "fixed", "hires"])
def test_decode_array_matches_flacx_device_route(streams, name):
    """flacx's own device route (one XLA:CPU compile a stream) against
    the port's, whose route counts show no fallback."""
    data, pcm = streams[name]
    stats = {}
    got = port_decode(data, stats, batch_frames=2)
    ref = fx_dec.decode_array(data, batch_frames=2)[1]
    assert same(got, ref)
    np.testing.assert_array_equal(got, pcm)
    assert stats["device"] >= 2 and "host" not in stats, stats


@pytest.mark.parametrize("name", ["stereo", "six", "variable", "corrupt",
                                  "long-unary"])
def test_decode_stream_matches_flacx(streams, name):
    data, pcm = streams[name]

    def run(fn, **kw):
        try:
            si, chunks = fn(io.BytesIO(data), readahead=4096, **kw)
            return np.concatenate(list(chunks))
        except (FlacFormatError, FxFormatError) as e:
            return ("raise", str(e))

    stats = {}
    got = run(decoder.decode_stream, device="cpu", stats=stats,
              batch_frames=3)
    assert same(got, run(fx_dec.decode_stream, device=False))
    if pcm is not None:
        np.testing.assert_array_equal(got, pcm)
        assert sum(stats.values()) >= 1, stats


def test_oracle_route_and_device_resolution(streams):
    data, pcm = streams["stereo"]
    stats = {}
    np.testing.assert_array_equal(
        decoder.decode_array(data, oracle=True, device="cpu",
                             stats=stats)[1], pcm)
    assert stats == {"sequential": 1}
    with pytest.raises(FlacFormatError):
        decoder.decode_array(data[:100], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            decoder.decode_array(data)


def test_native_library_is_required(monkeypatch):
    """A failed build raises with the compiler's output: there is no
    numpy route."""
    import flacx_torch.native as nat
    import flacx_torch.native.build as nb

    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nb, "FLAGS", nb.FLAGS + ("-include", "/nonexistent"))
    with pytest.raises(RuntimeError, match="build failed"):
        nat.crc16_rows(np.zeros((1, 8), np.uint8), np.ones(1, np.int32))
