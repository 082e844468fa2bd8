"""The plain reference against flacx_torch's CPU path on a few frames of
each configuration, and the reference's writer and decoder against each
other and against the program's decoder."""

import json
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ("cd16_default", "hires24_96")
TRAFFIC = {"cd16_default": "encode.b1024", "hires24_96": "encode.b128"}


def setting(name, frames):
    from portbench import pcmgen, reference

    cfg = json.loads((ROOT / f"portbench/configs/{name}.json").read_text())
    fmt = reference.Format.from_config(cfg)
    signal = json.loads((ROOT / f"portbench/traffic/{TRAFFIC[name]}.json")
                        .read_text())["signal"]
    pcm = pcmgen.make_pcm(signal, fmt.sample_rate, fmt.bps, fmt.channels,
                          frames * fmt.block_size, 7, 0)
    return cfg, fmt, pcm


def program_frames(cfg, pcm, n):
    from flacx_torch.encoder import BatchEncoder, EncoderConfig
    from portbench import pcmgen

    kw = dict(cfg["encoder"])
    kw["partition_orders"] = tuple(kw["partition_orders"])
    kw["windows"] = tuple(kw["windows"])
    enc = BatchEncoder(EncoderConfig(**kw), batch_frames=8, device="cpu")
    return enc.encode_frames(pcmgen.blocks(pcm, n), 0)


@pytest.mark.parametrize("name", CONFIGS)
def test_program_frames_pass_the_reference(name):
    from portbench import reference

    cfg, fmt, pcm = setting(name, 6)
    n = fmt.block_size
    frames = program_frames(cfg, pcm, n)
    kinds = set()
    for i, frame in enumerate(frames):
        block = pcm[:, i * n:(i + 1) * n]
        fields, why = reference.check_frame(frame, fmt, block, i)
        assert why is None, why
        code, subs = reference.choose(block, fmt)
        assert fields.code == code
        assert [s.key() for s in fields.subframes] == [s.key() for s in subs]
        for sf, mine in zip(fields.subframes, subs):
            kinds.add(sf.kind)
            if sf.plan is not None:
                assert sf.plan.bits == mine.plan.bits
        assert np.array_equal(reference.decode_frame(frame, fmt), block)
    assert {"lpc", "fixed"} <= kinds


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_stream_decodes_in_the_program(name):
    from flacx_torch.decoder import decode_array
    from portbench import reference

    _, fmt, pcm = setting(name, 3)
    n = fmt.block_size
    blocks = [pcm[:, i * n:(i + 1) * n] for i in range(3)]
    frames = [reference.write_frame(b, fmt, i, *reference.choose(b, fmt))
              for i, b in enumerate(blocks)]
    for i, frame in enumerate(frames):
        assert np.array_equal(reference.decode_frame(frame, fmt),
                              pcm[:, i * n:(i + 1) * n])
    data = reference.stream_bytes(frames, fmt, 3 * n)
    _, out = decode_array(data, batch_frames=2, device="cpu")
    assert np.array_equal(out, pcm.T)


def test_checker_refuses_an_altered_frame():
    from portbench import reference

    cfg, fmt, pcm = setting("cd16_default", 1)
    frame = program_frames(cfg, pcm, fmt.block_size)[0]
    for at in (3, len(frame) // 2, len(frame) - 1):
        bad = bytearray(frame)
        bad[at] ^= 0x10
        assert reference.check_frame(bytes(bad), fmt, pcm, 0)[1] is not None
    assert reference.check_frame(frame, fmt, pcm, 1)[1] is not None
    assert reference.check_frame(frame[:-1], fmt, pcm, 0)[1] is not None


def test_rice_optimum_beats_every_single_parameter():
    from portbench import reference

    _, fmt, pcm = setting("cd16_default", 1)
    x = pcm[0].astype(np.int64)
    zz = np.concatenate([[0, 0], reference.zigzag(np.diff(x, n=2))])
    best = reference.rice_optimum(zz, 2, fmt)
    for k in range(fmt.kmax + 1):
        whole = 6 + 5 + int(((zz[2:] >> k) + 1 + k).sum())
        assert best.bits <= whole
