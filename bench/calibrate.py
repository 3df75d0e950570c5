#!/usr/bin/env python3
"""Readings that the check's limits are set from: the program's and the control's, over seeds.

    python3 bench/calibrate.py --workload <name> --seeds 101 102 ... --seconds 2 [--check-share 0.25]

For each seed, one run of the cell at its own sizes and load (a short window, a larger share of
its calls compared), in one process: the check's numbers for the program, and for the control,
the plain reference computed in TF32 (the next precision below the configuration's float32) and
put in the program's place, held against the reference on the same items.  One JSON line a seed.
The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--check-share", type=float, default=0.25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.harness import session

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    for seed in args.seeds:
        out = session.run(args.workload, seed, args.seconds, False, args.device, time.perf_counter(), ROOT,
                          overrides={"check_share": args.check_share}, control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": out["correct"],
                          "attempted": out["attempted"], "program": out["check"], "control": out["control"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
