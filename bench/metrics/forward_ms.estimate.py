"""``forward_ms.estimate``: the eager launch of the forward: mean per call of the self time of the
``gnn.forward`` spans (their nested ``h2d.stage`` left out), over the traced stretch's ``estimate``
/ ``estimate_many`` calls (``harness/spans.py``)."""

from bench.harness import spans

ENTRIES = ("estimate", "estimate_many")


def read(run):
    if run.entry not in ENTRIES:
        return None
    return spans.per_call_ms(("gnn.forward",))
