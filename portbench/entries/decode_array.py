"""Decode cells: ``decoder.decode_array`` over a pool of seeded streams,
one call a whole stream, back to back (closed loop).

Traffic keys: ``batch_frames`` (``decode_array``'s), ``streams``,
``frames_per_stream``, ``encode_batch_frames`` (the program encodes the
streams in set-up), ``warmup_streams`` (decoded once in set-up),
``trace_seconds``, ``check`` (``calls``: outputs of
the window kept and compared whole with the seeded PCM, drawn from the
seed; ``frames``: frames the reference decodes), ``signal``.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from portbench import pcmgen, roofline

WRAPPERS = ("bit_unpack", "reconstruct", "crc16_rows")
#: chance that a call of the window is kept for the comparison
KEEP_P = 0.1


class Entry:
    unit = "call"

    def __init__(self, ctx):
        self.ctx = ctx
        self.ref, self.fmt = ctx.ref, ctx.fmt
        t = ctx.traffic
        self.bf = int(t["batch_frames"])
        self.check = t["check"]
        self.rng = pcmgen.rng_for(ctx.seed, 0xDEC0)
        self.next_item = 0
        self.kept = {}           # stream → its decoded PCM
        self.failed = 0

    def setup(self) -> None:
        import flacx_torch.decoder as decoder
        import flacx_torch.encoder as encoder

        ctx, fmt, t = self.ctx, self.fmt, self.ctx.traffic
        self.decoder = decoder
        kw = dict(ctx.config["encoder"])
        kw["partition_orders"] = tuple(kw["partition_orders"])
        kw["windows"] = tuple(kw["windows"])
        enc = encoder.BatchEncoder(encoder.EncoderConfig(**kw),
                                   batch_frames=int(t["encode_batch_frames"]),
                                   device=ctx.device)
        n, f = fmt.block_size, int(t["frames_per_stream"])
        self.pcm, self.frames, self.streams = [], [], []
        for s in range(int(t["streams"])):
            pcm = pcmgen.make_pcm(t["signal"], fmt.sample_rate, fmt.bps,
                                  fmt.channels, f * n, ctx.seed, s,
                                  ctx.device)
            frames = enc.encode_frames(pcmgen.blocks(pcm, n), 0)
            self.pcm.append(pcm)
            self.frames.append(frames)
            self.streams.append(self.ref.stream_bytes(frames, fmt, f * n))
        del enc
        for data in self.streams[:int(t.get("warmup_streams", 1))]:
            self._call(data)

    def _call(self, data: bytes, stats: dict | None = None):
        return self.decoder.decode_array(data, batch_frames=self.bf,
                                         device=self.ctx.device,
                                         stats=stats)[1]

    def spans(self, spans) -> None:
        d = self.decoder
        for attr, name in (("_scan_frame_offsets", "frame_scan"),
                           ("scan_frames", "walker"),
                           ("scatter_rows", "row_staging"),
                           ("_upload", "upload"),
                           ("_device_decode", "device_decode"),
                           ("_ok", "flags"), ("_host_pcm", "d2h")):
            spans.wrap(d, attr, name)

    def batches(self, calls: int) -> int:
        per = -(-int(self.ctx.traffic["frames_per_stream"]) // self.bf)
        return calls * per

    def run_window(self, seconds: float, stats: dict | None = None,
                   ) -> dict:
        n_streams = len(self.streams)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        unit_s, items = [], []
        samples = 0
        while time.perf_counter() < deadline:
            s = self.next_item % n_streams
            self.next_item += 1
            items.append(s)
            a = time.perf_counter()
            try:
                out = self._call(self.streams[s], stats)
            except Exception as e:        # counted, and shown
                self.failed += 1
                print(f"decode_array raised {type(e).__name__}: {e}",
                      file=sys.stderr)
                unit_s.append(time.perf_counter() - a)
                continue
            unit_s.append(time.perf_counter() - a)
            samples += out.size
            if s not in self.kept and (
                    not self.kept or self.rng.random() < KEEP_P) \
                    and len(self.kept) < int(self.check["calls"]):
                self.kept[s] = out
        elapsed = time.perf_counter() - t0
        return {"seconds": elapsed, "units": len(items), "items": items,
                "unit_s": unit_s, "due": len(items),
                "batches": self.batches(len(items)),
                "metrics": {"decode_msamples_per_s":
                            samples / elapsed / 1e6}}

    def kernel_bounds(self, items: list) -> dict:
        """Σ least seconds of the decode kernels by wrapper over the calls
        of ``items`` (each distinct stream decoded once more, counted)."""
        d = self.decoder
        per_item = {}
        for s in sorted(set(items)):
            got: dict[str, float] = {}
            undo = []
            for name in WRAPPERS:
                fn = getattr(d, name)
                undo.append((name, fn))

                def counted(*args, _fn=fn, _name=name, **kwargs):
                    out = _fn(*args, **kwargs)
                    full = args + tuple(kwargs.values())
                    got[_name] = got.get(_name, 0.0) \
                        + roofline.bound_s(_name, full, out)
                    return out
                setattr(d, name, counted)
            try:
                self._call(self.streams[s])
            finally:
                for name, fn in undo:
                    setattr(d, name, fn)
            per_item[s] = got
        total: dict[str, float] = {}
        for s in items:
            for name, sec in per_item[s].items():
                total[name] = total.get(name, 0.0) + sec
        return total

    def sample_frames(self) -> list:
        """``(stream, frame)`` pairs the reference decodes, from the
        seed."""
        f = int(self.ctx.traffic["frames_per_stream"])
        rng = pcmgen.rng_for(self.ctx.seed, 0xF4A3)
        return [(int(rng.integers(0, len(self.streams))),
                 int(rng.integers(0, f)))
                for _ in range(int(self.check["frames"]))]

    def checks(self, frames=None) -> tuple[dict, list]:
        """The numbers compared.  ``frames`` (the control) replaces the
        program's output at the sampled frames by its own decode."""
        n, notes = self.fmt.block_size, []
        pcm_bad = ref_bad = 0
        for s, out in self.kept.items():
            want = self.pcm[s].T
            if out.shape != want.shape:
                pcm_bad += want.size
                notes.append(f"stream {s}: shape {out.shape}")
            else:
                pcm_bad += int((out != want).sum())
        for i, (s, f) in enumerate(self.sample_frames()):
            want = self.pcm[s][:, f * n:(f + 1) * n]
            try:
                got = self.ref.decode_frame(self.frames[s][f], self.fmt)
            except (ValueError, EOFError, IndexError, KeyError,
                    OverflowError) as e:
                ref_bad += want.size
                notes.append(f"stream {s} frame {f}: reference: {e}")
                continue
            ref_bad += int((got != want).sum())
            if frames is not None:
                pcm_bad += int((frames[i] != want).sum())
            elif s in self.kept:
                prog = self.kept[s][f * n:(f + 1) * n].T
                ref_bad += (int((prog != got).sum())
                            if prog.shape == got.shape else got.size)
        return {"calls_failed": self.failed, "pcm_mismatch": pcm_bad,
                "reference_mismatch": ref_bad}, notes

    def control(self, arithmetic: str) -> list:
        """The reference decoder at ``arithmetic`` in the program's place:
        its PCM of the sampled frames; the window's kept outputs are
        dropped, so only the control's output is judged."""
        self.kept = {}
        out = []
        for s, f in self.sample_frames():
            try:
                out.append(self.ref.decode_frame(self.frames[s][f],
                                                 self.fmt, arithmetic))
            except (ValueError, EOFError, IndexError, KeyError,
                    OverflowError):
                out.append(np.full((self.fmt.channels, self.fmt.block_size),
                                   -1, np.int64))
        return out

    def histogram(self, stats: dict) -> str:
        return f"decode routes {stats}"
