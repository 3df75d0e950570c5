#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the repository root.  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (the window, then a stretch under ``torch.profiler``).  The numbers the check
compared are the last lines on standard error and the last key of the JSON line.  It exits
nonzero, printing no result, on a machine with fewer CUDA devices than the cell asks for, when
the program is not beside it, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # whole top-level module names


def forbidden_modules():
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["USE_FLAX"] = "0"
    os.environ["REPRO_DISPATCH_PROFILE"] = "default"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.harness import session, spec

    cell = spec.cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s), found {n}; nothing was run",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (the program must be beside the benchmark)

    out = session.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START, ROOT)
    found = forbidden_modules()
    if found:
        print(f"bench: the run loaded {found}; the port must not load JAX or the JAX package", file=sys.stderr)
        return 1
    out["device"] = dict({"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "power_limit": power_limit()}, **out["device"])
    check = out.pop("check")
    out["check"] = check  # the numbers compared, last
    print(f"check calls {check['calls']} answers {check['answers']} correct {out['correct']}", file=sys.stderr)
    for name, v in check.items():
        if isinstance(v, dict):
            print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
