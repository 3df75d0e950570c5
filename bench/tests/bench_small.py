"""The cells at sizes a CPU test run holds (the harness's CPU path: the program's plain PyTorch
versions of its kernels), and the repository root and ``src`` on ``sys.path``."""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = ("synthetic.estimate", "dspbench.score", "synthetic.estimate-many", "synthetic.score")
#: per-cell traffic sizes for the CPU (the mixes' own files hold the chip's)
SMALL = {
    "synthetic.estimate": {"pool_graphs": 48, "batch_graphs": 16, "check_share": 0.5},
    "synthetic.estimate-many": {"pool_graphs": 48, "batch_graphs": 8, "batches_per_call": 2, "check_share": 0.5},
    "dspbench.score": {"structures": 8, "group_size": 4, "pool_candidates": 24, "rows_per_structure": 8,
                       "check_share": 0.5},
    "synthetic.score": {"structures": 12, "group_size": 4, "pool_candidates": 24, "rows_per_structure": 8,
                        "check_share": 0.5},
}
SEED = 2**31 + 12345  # above 32 signed bits, as the benchmark's seeds may be


def run_small(cell, trace=False, seed=SEED, seconds=0.3, control=False, root=ROOT, overrides=None):
    from bench.harness import session

    return session.run(cell, seed, seconds, trace, "cpu", time.perf_counter(), root,
                       overrides=dict(SMALL[cell], **(overrides or {})), control=control)
