"""``vote_ms.estimate``: the vote and the split per metric and per request: mean per call of the
``host.vote`` spans, over the traced stretch's ``estimate`` / ``estimate_many`` calls
(``harness/spans.py``)."""

from bench.harness import spans

ENTRIES = ("estimate", "estimate_many")


def read(run):
    if run.entry not in ENTRIES:
        return None
    return spans.per_call_ms(("host.vote",), own=False)
