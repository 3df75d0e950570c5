"""``estimate_graphs_per_s``: every graph answered on every metric in the window, over the window's
seconds (from the first call's dispatch to the last call's answers in hand)."""

ENTRIES = ("estimate", "estimate_many")


def read(run):
    if run.entry not in ENTRIES:
        return None
    return sum(c.items for c in run.calls) / run.window_s
