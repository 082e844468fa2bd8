"""flacx_torch's plain path against flacx on configurations beside the
headline one that this slice also encodes: independent stereo without
escapes, mono, three channels without LPC, and 12-bit samples at the
widest coefficient precision.  Frames must be byte-identical and decode
bit-exactly under flacx's oracle decoder."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import flacx.ops  # noqa: F401  (x64)
import jax
import jax.numpy as jnp
from flacx.bitio import BitReader
from flacx.encoder import EncoderConfig as FxConfig
from flacx.encoder import _encode_batch as fx_encode_batch
from flacx.format import Streaminfo
from flacx.oracle.decoder import read_frame

from flacx_torch.encoder import _encode_batch, config_from_flacx
from flacx_torch.ops.lpc import apodization_window_np, window_from_numpy

from conftest import make_pcm

torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [
    dict(block_size=1152, max_lpc_order=8, stereo="independent",
         escapes=False, partition_orders=(0, 1, 2, 3, 4)),
    dict(block_size=4096, channels=1, partition_orders=(0, 1, 2, 3)),
    dict(block_size=4608, channels=3, max_lpc_order=0),
    dict(block_size=2304, bps=12, qlp_precision=12),
], ids=["independent", "mono", "three-channel-fixed", "12-bit"])
def test_config_matches_flacx(kw):
    fx_cfg = FxConfig(**kw)
    cfg = config_from_flacx(dataclasses.asdict(fx_cfg))
    n, c, b = cfg.block_size, cfg.channels, 4
    pcm = make_pcm(np.random.default_rng(3), n * b, c, cfg.bps, "tonal")
    planar = np.ascontiguousarray(pcm.reshape(b, n, c).transpose(0, 2, 1))
    planar[1] = make_pcm(np.random.default_rng(4), n, c, cfg.bps, "noise").T
    planar[2] = 0
    ref = jax.jit(functools.partial(fx_encode_batch, fx_cfg))(
        jnp.asarray(planar), jnp.int64(0))
    window = window_from_numpy(
        apodization_window_np(cfg.windows[0], n).astype(np.float32))
    out = _encode_batch(cfg, torch.from_numpy(planar), 0, window)
    np.testing.assert_array_equal(out["length"].numpy(),
                                  np.asarray(ref["length"]))
    np.testing.assert_array_equal(out["bytes"].numpy(),
                                  np.asarray(ref["bytes"]))
    si = Streaminfo(n, n, 0, 0, 44100, c, cfg.bps, 0, bytes(16))
    for i in range(b):
        frame = bytes(out["bytes"][i, :out["length"][i]].numpy())
        _, planes = read_frame(BitReader(frame), si)
        np.testing.assert_array_equal(np.asarray(planes), planar[i])
