#!/usr/bin/env python3
"""The readings a cell's limits are set from, in one process.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--seconds 3]

For each of ``--seeds``: set-up from that seed, a window of ``--seconds``
through the timed path at the cell's own sizes, and the comparison; for
each of ``--control-seeds`` the same with the control in the program's
place (``run.py --control 1``).  Prints one JSON line a seed with the
numbers compared, then the largest program reading and the smallest
control reading of each.  Needs CUDA; never part of a timed run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def reading(workload: str, seed: int, seconds: float, control: bool,
            device) -> dict:
    ctx = harness.context(ROOT, workload, seed, device)
    entry = harness.entry_class(ctx.traffic["entry"])(ctx)
    entry.setup()
    entry.run_window(seconds)
    frames = (entry.control(ctx.config["control"][ctx.traffic["entry"]])
              if control else None)
    checks, notes = entry.checks(frames)
    return {"seed": seed, "control": control, "checks": checks,
            "notes": notes}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("readings: needs CUDA", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    rows = []
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for s in filter(None, seeds.split(",")):
            row = reading(args.workload, int(s), args.seconds, control, dev)
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {}
    for row in rows:
        for k, v in row["checks"].items():
            side = summary.setdefault(k, {"program_max": None,
                                          "control_min": None})
            key = "control_min" if row["control"] else "program_max"
            pick = min if row["control"] else max
            side[key] = v if side[key] is None else pick(side[key], v)
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
