"""The card's peaks, and the least time a piece of work can take on it.

NVIDIA H100 SXM data sheet, dense rates at the full 700 W.  Float32 work is held against the
fastest route to fp32-accurate products, the TF32 tensor cores with the 3xTF32 split (495e12 / 3
FLOP/s), as ``chip_smoke.py`` holds it; a card set below 700 W reaches less, so every reading
states the power limit beside it.
"""

from __future__ import annotations

from bench.harness import spec

PEAK_FP32_FLOPS = 495e12 / 3
PEAK_HBM_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """Least seconds for ``flops`` operations and ``nbytes`` bytes: the larger of the two terms."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)


def roofline(run, kernel: str, entries=None):
    """A kernel's share of its roofline in the traced stretch, in %: the least time of its launches
    there (``bench/counts/<kernel>.py``, each launch ``bound_s`` of its operations and bytes) over
    their device time.  None (the metric left out) without a trace, for another entry, or when the
    launches the profiler saw are not the ones counted, so that a share is never read against work
    that the kernel did not do."""
    if run.trace is None or (entries is not None and run.entry not in entries):
        return None
    launches = [l for i in run.trace.calls for l in spec.count(kernel).launches(run.work(i))]
    n, seconds = run.trace.kernel(kernel)
    if not launches or n != len(launches) or seconds <= 0:
        return None
    return 100.0 * sum(bound_s(f, b) for f, b in launches) / seconds
