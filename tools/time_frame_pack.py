#!/usr/bin/env python3
"""Device time of the ``frame_pack`` kernel on the headline batch, from any
checkout of flacx_torch.

    python3 tools/time_frame_pack.py [--tree DIR] [--reps 50]

Encodes one headline batch (block 4608, LPC order 12, the 1024-frame
two-tone PCM of ``chip_smoke.py``) with the ``flacx_torch`` package found
in ``DIR`` (default: this checkout), keeps the arguments of its
``frame_pack`` launch, checks the kernel's bytes against the plain
version, and prints one JSON line: the tree, the median kernel time of
``--reps`` launches under the profiler, and the card's name and power
limit.  Run it on two checkouts in one call (A, B, B, A) to compare two
versions of the kernel at this shape.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT),
                    help="checkout whose flacx_torch to time")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    tree = str(Path(args.tree).resolve())
    sys.path.insert(0, tree)

    import numpy as np
    import torch

    # this checkout's helpers, whatever tree the package comes from
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    if not torch.cuda.is_available():
        print("time_frame_pack: CUDA is not available", file=sys.stderr)
        return 1
    import flacx_torch
    from flacx_torch.encoder import BatchEncoder, EncoderConfig
    from flacx_torch.kernels import frame_pack as k_fp

    if not Path(flacx_torch.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"flacx_torch came from {flacx_torch.__file__}")
    enc = BatchEncoder(EncoderConfig(block_size=cs.N, max_lpc_order=12),
                       batch_frames=cs.B)
    planar = cs.blocks_of(
        cs.synth_pcm(np.random.default_rng(cs.SEED), cs.N * cs.B), cs.N)
    captured, restore = cs.capture_main_path_inputs(("frame_pack",))
    try:
        enc.encode_batch_device(planar, 0)
    finally:
        restore()
    fp_args = captured["frame_pack"]
    cs.exact(torch, k_fp.frame_pack(*fp_args), k_fp.frame_pack_plain(*fp_args))
    ms = cs.kernel_times(torch, {"frame_pack_kernel": lambda: k_fp.frame_pack(
        *fp_args)}, args.reps)["frame_pack_kernel"]
    print(json.dumps({"tree": args.tree, "frame_pack_ms": ms,
                      "reps": args.reps, "psize": fp_args[12],
                      "card": cs.card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
