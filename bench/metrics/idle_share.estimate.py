"""``idle_share.estimate``: the share of the traced stretch in which the device ran no kernel, copy
or set (``torch.profiler``'s device events, their union)."""

ENTRIES = ("estimate", "estimate_many")


def read(run):
    if run.entry not in ENTRIES or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
