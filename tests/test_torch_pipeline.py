"""flacx_torch's file encode against flacx's on the CPU.

``flacx_torch.pipeline`` with ``device="cpu"`` (each kernel's plain
version) and ``flacx.pipeline`` (JAX on the CPU) encode the same PCM into
whole FLAC streams, STREAMINFO, MD5 and the oracle's short last frame
included: the files must be byte-identical.  The cases are the default
configuration with ragged batches, block 1152 (where the estimate search
keeps the written LPC residual, the ``lpc_residual`` res mode), a block
under ``device_min_block_size`` (every frame from the oracle), the oracle
path of ``--no-device`` and ``encode --best`` on 24-bit stereo.
"""

import hashlib
import io

import numpy as np
import pytest
import torch

import flacx.pipeline as fx_pipeline
from flacx.encoder import device_min_block_size as fx_min_block
from flacx.oracle.encoder import EncoderParameters
from flacx.oracle.encoder import encode_stream as fx_encode_stream

from flacx_torch import encoder, pipeline
from flacx_torch.encoder import device_min_block_size
from flacx_torch.kernels.lpc_residual import mac_width
from flacx_torch.oracle.decoder import decode_stream
from flacx_torch.oracle.encoder import EncoderParameters as Params
from flacx_torch.oracle.encoder import encode_stream
from flacx_torch.ops import emit
from flacx_torch.ops.lpc import fused_int32_ok
from flacx_torch.wavio import pcm_to_le_bytes

from conftest import make_pcm

torch.set_num_threads(1)

SETTINGS = dict(sample_rate=44100, bps=16, channels=2, max_lpc_order=12,
                qlp_precision=5, partition_orders=tuple(range(6)))


def pcm_of(seed: int, samples: int, bps: int = 16) -> np.ndarray:
    return make_pcm(np.random.default_rng(seed), samples, 2, bps, "tonal")


#: name -> (interleaved PCM, keyword arguments of ``encode_to_file``); each
#: batched case is one fresh XLA:CPU compile of flacx's pipeline
CASES = {
    # three full blocks and a 1000-sample tail, batches of 2 (one padded)
    "default": (pcm_of(1, 3 * 4608 + 1000),
                dict(SETTINGS, block_size=4608, batch_frames=2)),
    # finest partitions of 36 samples: neither tiled layout of the JAX
    # package applies, so the estimate search keeps the written residual
    "block1152": (pcm_of(2, 5 * 1152 + 1000),
                  dict(SETTINGS, block_size=1152, batch_frames=4)),
    # under device_min_block_size(12) = 26: every frame from the oracle
    "tiny-block": (pcm_of(3, 7 * 16 + 5), dict(SETTINGS, block_size=16)),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """A case's PCM, settings and flacx's file."""
    pcm, kw = CASES[request.param]
    f = io.BytesIO()
    fx_pipeline.encode_to_file(f, pcm, **kw)
    return request.param, pcm, kw, f.getvalue()


def port_file(pcm, **kw) -> tuple[bytes, dict]:
    f = io.BytesIO()
    stats = pipeline.encode_to_file(f, pcm, device="cpu", **kw)
    return f.getvalue(), stats


def test_file_equals_flacx(case, monkeypatch):
    name, pcm, kw, want = case
    calls = {"res": 0, "stats": 0}

    def counted(key, fn):
        def wrapped(*args):
            calls[key] += 1
            return fn(*args)
        return wrapped
    monkeypatch.setattr(encoder, "lpc_residual_res",
                        counted("res", encoder.lpc_residual_res))
    monkeypatch.setattr(encoder, "lpc_residual_stats",
                        counted("stats", encoder.lpc_residual_stats))
    got, stats = port_file(pcm, **kw)
    assert got == want
    n = kw["block_size"]
    assert stats == {"samples": len(pcm), "frames": -(-len(pcm) // n),
                     "bytes_in": pcm.size * 2, "bytes_out": len(want)}
    batches = -(-(len(pcm) // n) // kw.get("batch_frames", 256))
    if name == "tiny-block":
        assert n < device_min_block_size(12) == fx_min_block(12)
        assert calls == {"res": 0, "stats": 0}
    else:
        route = not emit.tile_layout_ok(n, n >> 5)
        assert route == (name == "block1152") and fused_int32_ok(17, 192)
        assert calls == ({"res": batches, "stats": 0} if route
                         else {"res": 0, "stats": batches})
    # the stream decodes to the PCM, and its MD5 is the PCM's
    rate, bps, channels, samples, rows = decode_stream(io.BytesIO(got))
    assert (rate, bps, channels, samples) == (44100, 16, 2, len(pcm))
    np.testing.assert_array_equal(np.asarray(list(rows)), pcm)
    assert got[26:42] == hashlib.md5(pcm_to_le_bytes(pcm, 16)).digest()


def test_uneven_chunks_of_unknown_length_equal_the_whole(case):
    """``encode_chunks_to_file`` on chunks of uneven sizes, the length
    unknown up front: the same bytes as :func:`encode_to_file`."""
    _, pcm, kw, want = case
    cuts = [min(c, len(pcm)) for c in (0, 1, 777, 5000, 5001, 9999)]
    cuts.append(len(pcm))
    chunks = [pcm[a:b] for a, b in zip(cuts, cuts[1:])]
    f = io.BytesIO()
    pipeline.encode_chunks_to_file(f, chunks, total_samples=None,
                                   device="cpu", **kw)
    assert f.getvalue() == want


def test_oracle_path_equals_flacx_host_path():
    """``oracle=True`` (``encode --no-device``) against flacx's
    ``device=False``: every frame from the oracle encoder."""
    pcm = pcm_of(4, 2 * 1152 + 300)
    kw = dict(SETTINGS, block_size=1152)
    want = io.BytesIO()
    fx_pipeline.encode_to_file(want, pcm, device=False, **kw)
    got = io.BytesIO()
    stats = pipeline.encode_to_file(got, pcm, device="cpu", oracle=True,
                                    collect_stats=True, **kw)
    assert got.getvalue() == want.getvalue()
    assert "stats" not in stats


def test_oracle_encoder_equals_flacx_oracle():
    pcm = (np.random.default_rng(8).standard_normal((1500, 2)) * 3000) \
        .astype(np.int64)
    params = dict(block_size=512, lpc_order=range(0, 9), use_escapes=True)
    got = b"".join(encode_stream(44100, 16, 2, len(pcm), pcm.tolist(),
                                 Params(**params)))
    want = b"".join(fx_encode_stream(44100, 16, 2, len(pcm), pcm.tolist(),
                                     EncoderParameters(**params)))
    assert got == want


def test_encode_best_24_bit_equals_flacx():
    """``encode --best`` (exact search over three windows, the wide
    all-orders MAC at eff_bps 25) on 24-bit stereo at two block sizes."""
    pcm = pcm_of(5, 3 * 1152 + 300, bps=24)
    kw = dict(SETTINGS, bps=24, block_sizes=(576, 1152), batch_frames=4)
    assert mac_width(25, 12 << 4) == "wide"
    want = io.BytesIO()
    fx_stats = fx_pipeline.encode_best(want, pcm, **kw)
    got = io.BytesIO()
    stats = pipeline.encode_best(got, pcm, device="cpu", **kw)
    assert got.getvalue() == want.getvalue()
    assert stats == fx_stats
    _, bps, _, samples, rows = decode_stream(io.BytesIO(got.getvalue()))
    assert (bps, samples) == (24, len(pcm))
    np.testing.assert_array_equal(np.asarray(list(rows)), pcm)


def test_pipeline_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.encode_to_file(io.BytesIO(), pcm_of(6, 100), block_size=16,
                                **SETTINGS)
