"""Encode cells: ``BatchEncoder.encode_frame_stream`` over a host pool of
seeded batches, taken round robin, closed loop.

Traffic keys: ``batch_frames`` (frames a batch), ``pool`` (distinct
seeded batches), ``warmup_batches``, ``trace_seconds`` (the profiled
window of a ``--trace 1`` run), ``check`` (``frames``: frames of the
window held against the reference, drawn from the seed; ``decode_frames``:
how many of them the reference also decodes), ``signal`` (the recipe of
:mod:`portbench.pcmgen`).
"""

from __future__ import annotations

import time

import numpy as np

from portbench import pcmgen, roofline

#: kernel wrappers of the encode path, by the module that calls them
WRAPPERS = {"flacx_torch.encoder": ("analysis", "lpc_residual_stats",
                                    "lpc_residual_zz", "lpc_residual_res",
                                    "lpc_allorder", "rice_stats"),
            "flacx_torch.ops.framepack": ("frame_pack",)}
#: frames kept from each batch a sample draws
PER_BATCH = 2


class Entry:
    unit = "batch"

    def __init__(self, ctx):
        self.ctx = ctx
        self.ref, self.fmt = ctx.ref, ctx.fmt
        t = ctx.traffic
        self.b = int(t["batch_frames"])
        self.check = t["check"]
        self.next_item = 0
        self.index = 0
        self.rng = pcmgen.rng_for(ctx.seed, 0x5A3F)
        self.kept = []           # (frame bytes, item, position, index)
        self.kept_batches = 0
        self.missing = 0         # frames due in a window and not yielded

    def setup(self) -> None:
        import flacx_torch.encoder as encoder

        ctx, fmt = self.ctx, self.fmt
        kw = dict(ctx.config["encoder"])
        kw["partition_orders"] = tuple(kw["partition_orders"])
        kw["windows"] = tuple(kw["windows"])
        self.encoder = encoder
        n = fmt.block_size
        self.pool = [pcmgen.blocks(pcmgen.make_pcm(
            ctx.traffic["signal"], fmt.sample_rate, fmt.bps, fmt.channels,
            self.b * n, ctx.seed, j, ctx.device), n)
            for j in range(int(ctx.traffic["pool"]))]
        self.enc = encoder.BatchEncoder(encoder.EncoderConfig(**kw),
                                        batch_frames=self.b,
                                        device=ctx.device)
        warm = int(ctx.traffic.get("warmup_batches", 2))
        for _ in self.enc.encode_frame_stream(
                (self.pool[i % len(self.pool)] for i in range(warm)),
                self.index):
            pass
        self.index += warm * self.b

    def spans(self, spans) -> None:
        spans.wrap(self.encoder.BatchEncoder, "_drain", "drain")

    def run_window(self, seconds: float, stats: dict | None = None,
                   ) -> dict:
        """Encode batches until ``seconds`` have passed, then drain."""
        b, pool = self.b, self.pool
        pulled, done, items = [], [], []
        t0 = time.perf_counter()
        deadline = t0 + seconds

        def chunks():
            while time.perf_counter() < deadline:
                item = self.next_item % len(pool)
                self.next_item += 1
                items.append(item)
                pulled.append(time.perf_counter())
                yield pool[item]

        frames = nbytes = 0
        batch = []
        for frame in self.enc.encode_frame_stream(chunks(), self.index,
                                                  stats):
            frames += 1
            nbytes += len(frame)
            batch.append(frame)
            if len(batch) == b:
                done.append(time.perf_counter())
                self._keep(batch, items[len(done) - 1],
                           self.index + (len(done) - 1) * b)
                batch = []
        elapsed = time.perf_counter() - t0
        if batch:
            done.append(time.perf_counter())
        self.index += len(pulled) * b
        self.missing += len(pulled) * b - frames
        fmt = self.fmt
        samples = frames * fmt.block_size * fmt.channels
        return {"seconds": elapsed, "units": len(pulled), "items": items,
                "unit_s": [d - p for p, d in zip(pulled, done)],
                "due": len(pulled) * b, "done": frames,
                "metrics": {
                    "encode_msamples_per_s": samples / elapsed / 1e6,
                    "encoded_size_pct": 100.0 * nbytes
                    / max(samples * fmt.pcm_bytes, 1)}}

    def _keep(self, batch: list, item: int, index0: int) -> None:
        """Reservoir sampling over batches, a few frames of each."""
        cap = -(-int(self.check["frames"]) // PER_BATCH)
        self.kept_batches += 1
        slot = (self.kept_batches - 1 if self.kept_batches <= cap
                else int(self.rng.integers(0, self.kept_batches)))
        if slot >= cap:
            return
        pos = self.rng.choice(self.b, PER_BATCH, replace=False).tolist()
        new = [(batch[p], item, p, index0 + p) for p in pos]
        at = slot * PER_BATCH
        self.kept[at:at + PER_BATCH] = new

    def kernel_bounds(self, items: list) -> dict:
        """Σ least seconds of the hand kernels by wrapper, over the work
        of ``items`` (the pool items the window encoded): each distinct
        item encoded once more with its kernel calls counted."""
        import importlib

        per_item = {}
        for item in sorted(set(items)):
            got: dict[str, float] = {}
            undo = []
            for mod_name, names in WRAPPERS.items():
                mod = importlib.import_module(mod_name)
                for name in names:
                    fn = getattr(mod, name)
                    undo.append((mod, name, fn))

                    def counted(*args, _fn=fn, _name=name, **kwargs):
                        out = _fn(*args, **kwargs)
                        full = args + tuple(kwargs.values())
                        got[_name] = got.get(_name, 0.0) \
                            + roofline.bound_s(_name, full, out)
                        return out
                    setattr(mod, name, counted)
            try:
                self.enc.encode_batch_device(self.pool[item], 0)
            finally:
                for mod, name, fn in undo:
                    setattr(mod, name, fn)
            per_item[item] = got
        total: dict[str, float] = {}
        for item in items:
            for name, s in per_item[item].items():
                total[name] = total.get(name, 0.0) + s
        return total

    def checks(self, frames=None) -> tuple[dict, list]:
        """The numbers compared, and notes for standard error.
        ``frames`` replaces the kept frames' bytes (the control)."""
        ref, fmt = self.ref, self.fmt
        kept = self.kept if frames is None else [
            (f,) + k[1:] for f, k in zip(frames, self.kept)]
        bad = excess = mismatch = compared = dec_bad = 0
        notes = []
        for i, (frame, item, pos, index) in enumerate(kept):
            pcm = self.pool[item][pos]
            fields, why = ref.check_frame(frame, fmt, pcm, index)
            if why is not None:
                bad += 1
                if len(notes) < 5:
                    notes.append(f"frame {index} (pool {item}:{pos}): {why}")
            if fields is None:
                continue
            code, subs = ref.choose(pcm, fmt)
            signals, _ = ref.channel_signals(pcm, fmt, fields.code)
            for c, sf in enumerate(fields.subframes):
                compared += 1
                if fields.code != code or sf.key() != subs[c].key():
                    mismatch += 1
                if sf.plan is not None:
                    r = ref.residual(signals[c] >> fields.wasted[c],
                                     sf.kind, sf.order, sf.coefs, sf.shift)
                    zz = np.concatenate([np.zeros(sf.order, np.int64),
                                         ref.zigzag(r)])
                    best = ref.rice_optimum(zz, sf.order, fmt)
                    excess += max(sf.plan.bits - best.bits, 0)
            if i < int(self.check["decode_frames"]):
                try:
                    got = ref.decode_frame(frame, fmt)
                    dec_bad += int((got != pcm).sum())
                except (ValueError, EOFError, IndexError, KeyError,
                    OverflowError):
                    dec_bad += pcm.size
        return {"frames_missing": self.missing, "frames_bad": bad,
                "rice_excess_bits": excess,
                "decode_mismatch": dec_bad,
                "analysis_mismatch_pct": 100.0 * mismatch / max(compared, 1),
                }, notes

    def control(self, arithmetic: str) -> list:
        """The reference encoder at ``arithmetic`` in the program's place:
        its frames for the kept positions."""
        ref, fmt = self.ref, self.fmt
        out = []
        for _, item, pos, index in self.kept:
            pcm = self.pool[item][pos]
            out.append(ref.write_frame(pcm, fmt, index,
                                       *ref.choose(pcm, fmt, arithmetic)))
        return out

    def histogram(self, stats: dict) -> str:
        return (f"subframe kinds {stats.get('subframe_kinds')}, stereo "
                f"modes {stats.get('stereo_modes')}")
