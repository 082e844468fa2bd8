"""Seeded PCM of varied passages: the benchmark's one signal generator.

A traffic file's ``signal`` block is its recipe (``portbench/README.md``
lists the keys).  Every seed gets the same set of pieces: each passage
kind takes its weight's share of the samples, cut into pieces of
``piece_seconds`` (the last one shorter), so the amount of tonal music,
noise, digital silence, loud and percussive material is the same for
every seed; the seed shuffles the pieces and draws their details
(fundamentals, partial amplitudes and phases, envelopes, hit times, the
noise itself).  The heavy work runs on the given torch device, the few
parameters come from NumPy.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def rng_for(seed: int, *keys: int) -> np.random.Generator:
    """A NumPy generator for ``seed`` (any whole number) and ``keys``."""
    return np.random.default_rng(
        np.random.SeedSequence([seed % (1 << 64), *keys]))


def _pieces(recipe: dict, samples: int, rate: int,
            rng: np.random.Generator) -> list:
    """``(passage, length)`` pieces covering ``samples``, shuffled."""
    passages = recipe["passages"]
    weights = np.asarray([p["weight"] for p in passages], np.float64)
    exact = weights / weights.sum() * samples
    share = np.floor(exact).astype(np.int64)
    rest = samples - int(share.sum())
    share[np.argsort(share - exact, kind="stable")[:rest]] += 1
    piece = max(1, int(recipe["piece_seconds"] * rate))
    out = []
    for p, total in zip(passages, share.tolist()):
        out += [(p, min(piece, total - lo)) for lo in range(0, total, piece)]
    order = rng.permutation(len(out))
    return [out[i] for i in order]


def _tonal(p: dict, t: torch.Tensor, channels: int, rate: int,
           rng: np.random.Generator) -> torch.Tensor:
    """Sum of inharmonic partials under an envelope, ``[channels, L]``."""
    fmax = min(p.get("freq_max_hz", 16000.0), 0.45 * rate)
    n_part = int(p["partials"])
    stereo = p.get("stereo", "spread")
    env = _envelope(p.get("envelope", "sustain"), t, rng)
    rows = []
    f0 = math.exp(rng.uniform(math.log(55.0), math.log(880.0)))
    for c in range(channels):
        if stereo == "wide" or c == 0:
            if stereo == "wide":
                f0 = math.exp(rng.uniform(math.log(55.0), math.log(880.0)))
            k = np.arange(1, n_part + 1, dtype=np.float64)
            stretch = rng.uniform(0.0, 3e-4)
            freqs = f0 * k * np.sqrt(1.0 + stretch * k * k)
            amps = k ** -rng.uniform(0.8, 1.6) * (freqs < fmax)
            phases = rng.uniform(0.0, 1.0, n_part)
        gains = np.ones(n_part)
        shifts = np.zeros(n_part)
        if stereo == "spread" and c:
            gains = rng.uniform(0.6, 1.0, n_part)
            shifts = rng.uniform(-0.05, 0.05, n_part)
        if stereo == "mono" and c:
            rows.append(rows[0])
            continue
        f = torch.as_tensor(freqs, dtype=torch.float64, device=t.device)
        ph = torch.as_tensor(phases + shifts, dtype=torch.float64,
                             device=t.device)
        a = torch.as_tensor(amps * gains, dtype=torch.float32,
                            device=t.device)
        cyc = torch.remainder(f[:, None] * t[None, :] + ph[:, None], 1.0)
        rows.append((a[:, None] * torch.sin(2 * math.pi * cyc.float()))
                    .sum(0) * env)
    return torch.stack(rows)


def _envelope(kind: str, t: torch.Tensor, rng: np.random.Generator):
    if kind == "sustain":
        rate = rng.uniform(3.0, 6.0)
        return 1.0 + 0.1 * torch.sin(2 * math.pi * rate * t).float()
    if kind == "decay":
        note = rng.uniform(0.25, 1.0)
        tau = rng.uniform(0.15, 0.6)
        local = torch.remainder(t, note).float()
        return torch.exp(-local / tau) * torch.clamp(local / 0.005, max=1.0)
    if kind == "swell":
        span = float(t[-1] - t[0]) + 1e-9
        return torch.sin(math.pi * (t - t[0]) / span).float() ** 2
    raise ValueError(f"envelope {kind!r}")


def _noise(p: dict, shape: tuple, rate: int, gen: torch.Generator,
           device) -> torch.Tensor:
    """Gaussian noise of a spectral tilt (dB an octave), the channels
    correlated by ``correlation``; unit RMS."""
    w = torch.randn(shape, generator=gen, device=device)
    tilt = float(p.get("tilt_db_per_octave", 0.0))
    if tilt and shape[-1] > 1:
        spec = torch.fft.rfft(w)
        f = torch.fft.rfftfreq(shape[-1], 1.0 / rate).to(device)
        spec = spec * (torch.clamp(f, min=20.0) / 1000.0) ** (tilt / 6.0206)
        w = torch.fft.irfft(spec, n=shape[-1])
    a = float(p.get("correlation", 0.0))
    if shape[0] > 1 and a:
        w = torch.cat([w[:1], a * w[:1] + math.sqrt(1 - a * a) * w[1:]])
    return w / torch.clamp(w.pow(2).mean(-1, keepdim=True).sqrt(), min=1e-9)


def _peak(x: torch.Tensor, level_db: float) -> torch.Tensor:
    return x * (10 ** (level_db / 20) / torch.clamp(x.abs().max(), min=1e-9))


def _piece(p: dict, length: int, channels: int, rate: int,
           rng: np.random.Generator, gen: torch.Generator, device):
    kind = p["kind"]
    shape = (channels, length)
    if kind == "silence":
        return torch.zeros(shape, device=device)
    t = torch.arange(length, dtype=torch.float64, device=device) / rate
    if kind == "noise":
        x = _noise(p, shape, rate, gen, device) * 10 ** (p["level_db"] / 20)
        return torch.clamp(x, -1.0, 1.0)
    if kind == "tonal":
        x = _peak(_tonal(p, t, channels, rate, rng), p["level_db"])
    elif kind == "loud":
        drive = float(p.get("drive", 2.5))
        x = _peak(_tonal(p, t, channels, rate, rng), 0.0)
        x = torch.tanh(drive * x) / math.tanh(drive)
        x = x * 10 ** (p["level_db"] / 20)
    elif kind == "percussive":
        hits = max(1, int(p["hits_per_second"] * length / rate))
        x = torch.zeros(shape, device=device)
        for at in np.sort(rng.integers(0, length, hits)).tolist():
            n = length - at
            tau = rng.uniform(0.02, 0.12)
            tt = t[:n] - t[0]
            body = _noise({"correlation": 0.7}, (channels, n), rate, gen,
                          device) * torch.exp(-tt / tau).float()
            thump = torch.sin(2 * math.pi * rng.uniform(50.0, 120.0) * tt) \
                .float() * torch.exp(-tt / (2 * tau)).float()
            x[:, at:] += rng.uniform(0.3, 1.0) * (0.5 * body + thump)
        x = _peak(x, p["level_db"])
    else:
        raise ValueError(f"passage kind {kind!r}")
    noise_db = p.get("noise_db")
    if noise_db is not None:
        x = x + _noise({}, shape, rate, gen, device) * 10 ** (noise_db / 20)
    return torch.clamp(x, -1.0, 1.0)


def make_pcm(recipe: dict, rate: int, bps: int, channels: int,
             samples: int, seed: int, item: int, device="cpu") -> np.ndarray:
    """``[channels, samples]`` PCM of ``bps`` bits (int16 up to 16 bits,
    else int32) for ``seed`` and pool item ``item``."""
    rng = rng_for(seed, item)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 1 << 63)))
    out = torch.empty((channels, samples), dtype=torch.float32,
                      device=device)
    pos = 0
    for p, length in _pieces(recipe, samples, rate, rng):
        out[:, pos:pos + length] = _piece(p, length, channels, rate, rng,
                                          gen, device)
        pos += length
    top = 1 << (bps - 1)
    q = torch.clamp(torch.round(out.double() * top), -top, top - 1)
    dtype = torch.int16 if bps <= 16 else torch.int32
    return q.to(dtype).cpu().numpy()


def blocks(pcm: np.ndarray, n: int) -> np.ndarray:
    """``[C, F*n]`` PCM as ``[F, C, n]`` blocks (C-contiguous)."""
    c, total = pcm.shape
    return np.ascontiguousarray(pcm.reshape(c, total // n, n)
                                .transpose(1, 0, 2))
