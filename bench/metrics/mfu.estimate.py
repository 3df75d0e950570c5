"""``mfu.estimate``: the model's FLOPs for the window's calls (``bench/counts/model.py``, real rows
only), over the window's seconds, as a share of the card's fp32-accurate peak (3xTF32)."""

from bench.harness import peaks, spec

ENTRIES = ("estimate", "estimate_many")


def read(run):
    if run.entry not in ENTRIES or not run.calls:
        return None
    model = spec.count("model")
    flops = sum(model.flops(run.work(c.index)) for c in run.calls)
    return 100.0 * flops / run.window_s / peaks.PEAK_FP32_FLOPS
